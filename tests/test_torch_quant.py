"""Int8 W8A8 serving in the port (``ops/quant.py``, the int8 dispatch of
``models/vit.py``, the engine's, the export's and the tools' ``--int8``)
against the JAX package's ``ops/quant.py`` on the CPU, float32.

Tolerances: the int8 codes and scales equal JAX's exactly (the same fp32
weights quantized on both sides); ``int8_linear`` and the int8 encoder
(``VIT_INT8_DEFAULT_KEYS`` and all six linears) 1e-5; the int8 export's
detections equal the live int8 engine's bit for bit; the int8 encoder
within JAX's 0.03 relative Frobenius budget of the float one."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from layoutdit_tpu.models import vit as jax_vit
from layoutdit_tpu.ops import quant as jax_quant
from layoutdit_tpu_torch.config import load_run_config
from layoutdit_tpu_torch.models import lora as port_lora
from layoutdit_tpu_torch.models import vit as port_vit
from layoutdit_tpu_torch.models.detection import detector as port_det
from layoutdit_tpu_torch.models.weights_io import tree_leaves, vit_params_from_jax
from layoutdit_tpu_torch.ops import quant as port_quant

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

TOL = 1e-5
VIT = dict(hidden_size=64, num_hidden_layers=3, num_attention_heads=4, intermediate_size=128,
           image_size=64)
ALL = jax_quant._VIT_LINEAR_KEYS


def test_codes_and_scales_equal_jax():
    """JAX's per-column codes of a [K, N] kernel are the port's per-row
    codes of the [N, K] weight; the activations' codes and row scales
    too, ties at .5 included (both round half to even)."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((64, 48)).astype(np.float32)
    w[:, 3] = 0.0  # an all-zero channel takes the 1e-8 floor
    b = rng.standard_normal(48).astype(np.float32)
    want = jax_quant.quantize_linear({"kernel": jnp.asarray(w), "bias": jnp.asarray(b)})
    got = port_quant.quantize_linear({"weight": torch.from_numpy(w.T.copy()),
                                      "bias": torch.from_numpy(b)})
    assert got["weight_q"].dtype == torch.int8 and got["weight_q"].shape == (48, 64)
    np.testing.assert_array_equal(got["weight_q"].numpy().T, np.asarray(want["kernel_q"]))
    np.testing.assert_array_equal(got["weight_scale"].numpy(), np.asarray(want["kernel_scale"]))
    x = rng.standard_normal((5, 7, 64)).astype(np.float32)
    x[0, 0, :4] = [127.0, 0.5, 1.5, -2.5]  # absmax 127: codes at exact .5 ties
    xq, xs = jax_quant.quantize_activations(jnp.asarray(x))
    pq, ps = port_quant.quantize_activations(torch.from_numpy(x))
    np.testing.assert_array_equal(pq.numpy(), np.asarray(xq))
    np.testing.assert_array_equal(ps.numpy(), np.asarray(xs))
    assert list(pq[0, 0, :4]) == [127, 0, 2, -2]


def test_int8_linear_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 64, 64)).astype(np.float32)
    w = (rng.standard_normal((64, 32)) * 0.05).astype(np.float32)
    b = (rng.standard_normal(32) * 0.01).astype(np.float32)
    want = jax_quant.int8_linear(jnp.asarray(x), jax_quant.quantize_linear(
        {"kernel": jnp.asarray(w), "bias": jnp.asarray(b)}))
    p = port_quant.quantize_linear({"weight": torch.from_numpy(w.T.copy()),
                                    "bias": torch.from_numpy(b)})
    got = port_quant.int8_linear(torch.from_numpy(x), p)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    with pytest.raises(RuntimeError, match="serving only"):
        port_quant.int8_linear(torch.from_numpy(x).requires_grad_(True), p)


def _jax_vit():
    cfg = jax_vit.ViTConfig(**VIT)
    key = jax.random.PRNGKey(0)
    params = jax_vit.init_vit_params(key, cfg)
    params["pos_embed"] = jax.random.normal(key, params["pos_embed"].shape) * 0.02
    return jax.tree_util.tree_map(np.asarray, params), cfg


@pytest.mark.parametrize("keys", [None, ALL])
def test_int8_encoder_matches_jax(keys):
    """The same fp32 weights quantized on both sides: the quantized trees'
    codes equal (the fused qkv's row scales are q's, k's and v's), and the
    int8 encoders' outputs at 1e-5, within JAX's 0.03 of the float one."""
    jparams, jcfg = _jax_vit()
    pixels = np.array(jax.random.uniform(jax.random.PRNGKey(1), (2, 3, 64, 64)))
    jq = jax_quant.quantize_vit_params(jparams, keys=keys)
    pq = port_quant.quantize_vit_params(vit_params_from_jax(jparams), keys=keys)
    for jl, pl in zip(jq["layers"], pq["layers"]):
        codes = np.concatenate([np.asarray(jl[n]["kernel_q"]) for n in "qkv"], axis=1)
        np.testing.assert_array_equal(pl["qkv"]["weight_q"].numpy().T, codes)
        scales = np.concatenate([np.asarray(jl[n]["kernel_scale"]) for n in "qkv"])
        np.testing.assert_array_equal(pl["qkv"]["weight_scale"].numpy(), scales)
        for n in ("attn_out", "mlp_in", "mlp_out"):
            assert ("weight_q" in pl[n]) == ("kernel_q" in jl[n]), n
    want = jax_vit.vit_forward(jq, jnp.asarray(pixels), jcfg, taps=(1, 3))
    pcfg = port_vit.ViTConfig(**VIT)
    got = port_vit.vit_forward(pq, torch.from_numpy(pixels), pcfg, taps=(1, 3))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL, atol=TOL)
    ref = port_vit.vit_forward(vit_params_from_jax(jparams), torch.from_numpy(pixels), pcfg)[0]
    rel = float(torch.linalg.norm(got[-1] - ref) / torch.linalg.norm(ref))
    assert rel < 0.03, rel


def test_refusals():
    jparams, _ = _jax_vit()
    params = vit_params_from_jax(jparams)
    with pytest.raises(ValueError, match="together"):
        port_quant.quantize_vit_params(params, keys=("q", "mlp_in"))
    lcfg = port_vit.ViTConfig(**VIT, lora_rank=4, lora_targets=("q", "v", "mlp_in"))
    adapted = port_lora.add_lora_params(params, lcfg, torch.Generator().manual_seed(0))
    for keys in (None, ("mlp_in",)):
        with pytest.raises(ValueError, match="unmerged LoRA"):
            port_quant.quantize_vit_params(adapted, keys=keys)
    merged = port_quant.quantize_vit_params(port_lora.merge_lora(adapted, lcfg))
    assert "weight_q" in merged["layers"][0]["qkv"]
    # the inference cast leaves the codes, their scales and bias alone
    cast = port_det.params_for_inference({"backbone": {"vit": merged}}, torch.bfloat16)
    qkv = cast["backbone"]["vit"]["layers"][0]["qkv"]
    assert (qkv["weight_q"].dtype, qkv["weight_scale"].dtype, qkv["bias"].dtype) == (
        torch.int8, torch.float32, torch.float32)
    assert cast["backbone"]["vit"]["layers"][0]["attn_out"]["weight"].dtype == torch.bfloat16


def _tiny(root):
    from layoutdit_tpu_torch.tools.make_fixture import make_fixture, write_fixture_config

    make_fixture(root, n_images=4, split="samples", seed=2, image_size=64)
    path = write_fixture_config(root, epochs=1, batch_size=2, tiny_model=True)
    with open(path) as f:
        raw = json.load(f)
    raw["detection_model_config"].update(image_size=64, lora_rank=4, lora_alpha=8.0)
    raw["detection_model_config"]["detection_budget"]["box_score_thresh"] = 0.0
    with open(path, "w") as f:
        json.dump(raw, f)
    return path


@pytest.fixture(scope="module")
def lora_model(tmp_path_factory):
    """The tiny fixture model with active LoRA adapters (q and v), saved."""
    from layoutdit_tpu_torch.models.model import build_model

    root = str(tmp_path_factory.mktemp("quant"))
    path = _tiny(root)
    rc = load_run_config(path)
    model = build_model(rc, device="cpu", warm_start=False)
    rnd = np.random.default_rng(4)
    for layer in model.params["backbone"]["vit"]["layers"]:
        for n in ("q", "v"):
            layer[n]["lora_b"] = torch.from_numpy(
                0.1 * rnd.standard_normal(layer[n]["lora_b"].shape).astype(np.float32))
    ckpt = model.save_checkpoint(root, "run", 1)
    return root, path, model, ckpt


def test_engine_merges_then_quantizes_and_export_equals_it(lora_model, tmp_path):
    """The int8 engine merges the adapters, then quantizes (JAX's order):
    its detections keep the float engine's count of valid detections
    (JAX's ``test_detector_predict_int8_close``); the int8 export holds
    int8 leaves and gives the live int8 engine's detections bit for bit."""
    from layoutdit_tpu_torch.eval.serving import BatchInferenceEngine
    from layoutdit_tpu_torch.export import ExportedDetector, export_detector
    from layoutdit_tpu_torch.ops.quant import quantize_detector_params

    _, _, model, _ = lora_model
    dm = port_det.DetectorModel(model.params, model.cfg)
    images = torch.from_numpy(np.random.default_rng(1).uniform(0, 1, (2, 3, 64, 64))
                              .astype(np.float32))
    engines = {int8: BatchInferenceEngine(dm, image_sizes=(64,), batch_size=2, device="cpu",
                                          int8=int8) for int8 in (False, True)}
    assert "weight_q" in engines[True].params["backbone"]["vit"]["layers"][0]["qkv"]
    assert "weight_q" not in engines[False].params["backbone"]["vit"]["layers"][0]["qkv"]
    assert not port_lora.has_lora(engines[True].params["backbone"]["vit"])
    with torch.no_grad():
        dets = {k: port_det.detector_predict(e.params, images, model.cfg)
                for k, e in engines.items()}
    assert int(dets[True].valid.sum()) == int(dets[False].valid.sum()) > 0
    np.testing.assert_allclose(dets[True].boxes[:, 0].numpy(), dets[False].boxes[:, 0].numpy(),
                               atol=2.0)
    q = quantize_detector_params(port_lora.merge_lora_detector(model.params,
                                                               model.cfg.backbone.vit))
    manifest = export_detector(q, model.cfg, str(tmp_path), image_sizes=(64,), batch_size=2,
                               device="cpu")
    assert "int8" in manifest["leaf_dtypes"]
    out = ExportedDetector(str(tmp_path), device="cpu").predict(images, torch.full((2, 2), 64.0))
    live = port_det.rescale_detections(dets[True], torch.full((2, 2), 64.0), 64)
    for k in ("boxes", "scores", "labels", "valid"):
        np.testing.assert_array_equal(out[k], getattr(live, k).numpy(), err_msg=k)
    engine = BatchInferenceEngine(dm, image_sizes=(64,), batch_size=2, device="cpu", int8=True)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(engine.params),
                                                  tree_leaves(engines[True].params)))


def test_tools_take_int8(lora_model, tmp_path, monkeypatch):
    """``--int8`` in ``tools/{export_model,predict,serve}.py`` (JAX's
    behaviour); ``--export-dir`` with ``--int8`` is still refused."""
    from layoutdit_tpu_torch.export import ExportedDetector
    from layoutdit_tpu_torch.tools import export_model, predict, serve

    root, path, _, ckpt = lora_model
    monkeypatch.setenv("LAYOUTDIT_CONFIG", path)
    out = str(tmp_path / "art")
    manifest = export_model.main(["--out", out, "--checkpoint", ckpt, "--sizes", "64",
                                  "--batch-size", "2", "--device", "cpu", "--int8"])
    assert "int8" in manifest["leaf_dtypes"]
    inputs = ["--checkpoint", ckpt, "--input", os.path.join(root, "samples"), "--sizes", "64",
              "--batch-size", "2", "--device", "cpu", "--score-thresh", "0"]
    recs = predict.main(inputs + ["--int8"])
    assert len(recs) == 4 and all(len(r["boxes"]) > 0 for r in recs)
    images = torch.from_numpy(np.random.default_rng(1).uniform(0, 1, (2, 3, 64, 64))
                              .astype(np.float32))
    assert ExportedDetector(out, device="cpu").predict(images, torch.full((2, 2), 64.0))[
        "valid"].any()
    _, model = predict.load_model(ckpt, "cpu")
    httpd, batcher = serve.make_server(model, "127.0.0.1", 0, image_sizes=(64,), batch_size=2,
                                       device="cpu", int8=True)
    try:
        assert "weight_q" in batcher.engine.params["backbone"]["vit"]["layers"][0]["qkv"]
    finally:
        httpd.server_close()
        batcher.stop()
    with pytest.raises(ValueError, match="int8"):
        serve.make_server(None, "127.0.0.1", 0, export_dir=out, device="cpu", int8=True)
    with pytest.raises(SystemExit, match="--int8"):
        serve.main(["--export-dir", out, "--int8", "--device", "cpu"])


def test_int8_has_no_training_path():
    jparams, _ = _jax_vit()
    q = port_quant.quantize_vit_params(vit_params_from_jax(jparams))
    pixels = torch.rand(1, 3, 64, 64, requires_grad=True)
    with pytest.raises(RuntimeError, match="serving only"):
        port_vit.vit_forward(q, pixels, port_vit.ViTConfig(**VIT))
    with torch.no_grad():
        assert torch.isfinite(port_vit.vit_forward(q, pixels, port_vit.ViTConfig(**VIT))[0]).all()
    assert all(not t.is_floating_point() or t.dtype == torch.float32 for t in tree_leaves(q))
