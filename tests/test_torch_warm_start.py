"""Warm-starting the port from pretrained DiT/BEiT and reference
checkpoints (``models/weights_io.py``, ``tools/convert_hf_checkpoint.py``,
``tools/convert_reference_checkpoint.py``, ``models/model.py``) against
the JAX package on the CPU.

Every input is built locally: randomly initialised HF ``BeitModel``s
(``transformers``, imported by the tests only) and the synthetic
torchvision-layout detector state_dict of ``tests/test_convert_reference.py``.
Tolerances: the converted trees equal JAX's exactly; the port's encoder
on converted weights matches HF's hidden states at 2e-4 (JAX's test's
tolerance)."""

import dataclasses
import filecmp
import json
import os

import jax
import numpy as np
import pytest
import torch
from flax import serialization

from layoutdit_tpu.config.constructs import ModelConfig as JaxModelConfig
from layoutdit_tpu.models import vit as jax_vit
from layoutdit_tpu.models import weights_io as jax_wio
from layoutdit_tpu.models.model import LayoutDetectionModel as JaxModel
from layoutdit_tpu.tools import convert_hf_checkpoint as jax_conv
from layoutdit_tpu_torch.config import ModelConfig, run_config_from_dict
from layoutdit_tpu_torch.models import model as port_model
from layoutdit_tpu_torch.models import vit as port_vit
from layoutdit_tpu_torch.models import weights_io as port_wio
from layoutdit_tpu_torch.models.detection import detector as port_det
from layoutdit_tpu_torch.tools import convert_hf_checkpoint as port_conv
from layoutdit_tpu_torch.tools import convert_reference_checkpoint as port_ref_cli

transformers = pytest.importorskip("transformers")

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

REPO = os.path.join(os.path.dirname(__file__), os.pardir)
HF_TOL = 2e-4
TINY = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=2, intermediate_size=64,
            image_size=64, patch_size=16)
ENV = ("LAYOUTDIT_DIT_BASE_PTH", "LAYOUTDIT_DIT_BASE_CKPT", "LAYOUTDIT_DIT_LARGE_PTH")


def _hf(seed=0, **kw):
    from transformers import BeitConfig, BeitModel

    cfg = BeitConfig(**{"use_absolute_position_embeddings": True,
                        "use_relative_position_bias": False,
                        "use_shared_relative_position_bias": False,
                        "layer_scale_init_value": 0.1, "use_mask_token": True,
                        "attn_implementation": "eager", **kw})
    torch.manual_seed(seed)
    return BeitModel(cfg, add_pooling_layer=True).eval()


def _jax_tree_equal(a, b):
    fa, ta = jax.tree_util.tree_flatten_with_path(a)
    fb, tb = jax.tree_util.tree_flatten_with_path(b)
    assert ta == tb
    for (path, x), (_, y) in zip(fa, fb):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                      err_msg=jax.tree_util.keystr(path))


@pytest.fixture(autouse=True)
def _no_env(monkeypatch):
    for name in ENV:
        monkeypatch.delenv(name, raising=False)


@pytest.mark.parametrize("tables", ["absolute", "relative", "shared"])
def test_beit_state_dict_matches_jax_and_hf(tables):
    """A tiny random HF BeitModel: the port's tree equals JAX's (exact,
    through ``vit_params_to_jax``) and its encoder gives HF's hidden
    states at every layer."""
    kw = {"absolute": {}, "relative": {"use_relative_position_bias": True},
          "shared": {"use_shared_relative_position_bias": True}}[tables]
    hf = _hf(**TINY, **kw, use_absolute_position_embeddings=tables == "absolute")
    with torch.no_grad():  # nonzero tables, so that they matter
        for name, p in hf.named_parameters():
            if "relative_position_bias_table" in name:
                p.normal_(0.0, 0.5)
    sd = hf.state_dict()
    cfg = port_vit.ViTConfig(**TINY, use_absolute_position_embeddings=tables == "absolute",
                             use_relative_position_bias=tables == "relative",
                             use_shared_relative_position_bias=tables == "shared")
    jcfg = jax_vit.ViTConfig(**TINY)
    params = port_wio.beit_state_dict_to_params(sd, cfg)
    _jax_tree_equal(port_wio.vit_params_to_jax(params), jax_wio.beit_state_dict_to_params(sd, jcfg))
    template = port_vit.init_vit_params(cfg, torch.Generator(), "cpu")
    assert port_wio.tree_paths(params) == port_wio.tree_paths(template)
    pixels = torch.from_numpy(np.random.default_rng(0).uniform(-1, 1, (2, 3, 64, 64))
                              .astype(np.float32))
    with torch.no_grad():
        want = hf(pixels, output_hidden_states=True).hidden_states
    got = port_vit.vit_forward(params, pixels, cfg, taps=(1, 2))
    for tap, g in zip((1, 2), got):
        np.testing.assert_allclose(g.numpy(), want[tap].numpy(), rtol=HF_TOL, atol=HF_TOL)


@pytest.fixture(scope="module")
def dit_base(tmp_path_factory):
    """A random dit-base BeitModel's state_dict as ``.bin``, converted by
    both packages' converters."""
    root = tmp_path_factory.mktemp("hf")
    src = str(root / "pytorch_model.bin")
    sd = _hf(seed=1).state_dict()
    torch.save(sd, src)
    out_j, out_p = str(root / "jax.msgpack"), str(root / "port.msgpack")
    prov_j = jax_conv.convert(src, "dit-base", out_j)
    prov_p = port_conv.convert(src, "dit-base", out_p)
    return src, sd, out_j, out_p, prov_j, prov_p


def test_both_converters_write_the_same_tree(dit_base):
    src, sd, out_j, out_p, prov_j, prov_p = dit_base
    with open(out_j, "rb") as f:
        want = serialization.msgpack_restore(f.read()[len(b"LDTPU1\n"):])
    with open(out_p, "rb") as f:
        got = serialization.msgpack_restore(f.read()[len(b"LDTPU1\n"):])
    _jax_tree_equal(got["params"], want["params"])
    assert json.loads(got["meta"]["extra"]) == json.loads(want["meta"]["extra"]) == {
        "preset": "dit-base", "kind": "vit_encoder"}
    assert got["meta"]["has_opt_state"] is False
    for key in ("source_sha256", "n_source_keys", "ignored_keys", "preset"):
        assert prov_p[key] == prov_j[key], key
    with open(out_p + ".provenance.json") as f:
        assert json.load(f)["output_sha256"] == prov_p["output_sha256"]


@pytest.mark.parametrize("preset", ["dit-base", "dit-large"])
def test_manifest_copies_and_oracle(preset):
    """The package's manifests are the repository's, byte for byte, and
    equal the preset's architecture (the port's oracle and JAX's)."""
    assert filecmp.cmp(port_conv.manifest_path(preset),
                       os.path.join(REPO, "manifests", f"{preset}_hf_manifest.json"),
                       shallow=False)
    with open(port_conv.manifest_path(preset)) as f:
        committed = json.load(f)["keys"]
    assert committed == port_conv.expected_manifest(preset) == jax_conv.expected_manifest(preset)


def test_validation_rejects_as_jax_does(dit_base, tmp_path, monkeypatch):
    sd = dit_base[1]
    assert sorted(port_conv.validate_state_dict(sd, "dit-base")) == sorted(
        jax_conv.validate_state_dict(sd, "dit-base"))
    cases = [({**sd, "embeddings.cls_token": torch.zeros(1, 1, 17)}, "shape"),
             ({k: v for k, v in sd.items() if "layer.7." not in k}, "missing"),
             ({**sd, "encoder.layer.0.extra.weight": torch.zeros(2)}, "unexpected")]
    for bad, match in cases:
        for conv in (port_conv, jax_conv):
            with pytest.raises(ValueError, match=match):
                conv.validate_state_dict(bad, "dit-base")
    # a .safetensors input reads where the package is installed, and
    # raises a clear error where it is not
    st = pytest.importorskip("safetensors.torch")
    path = str(tmp_path / "model.safetensors")
    small = {k: v.contiguous() for k, v in sd.items() if "layer.0." in k}
    st.save_file(small, path)
    assert all(torch.equal(v, small[k]) for k, v in port_conv.read_state_dict(path).items())
    monkeypatch.setitem(__import__("sys").modules, "safetensors", None)
    monkeypatch.setitem(__import__("sys").modules, "safetensors.torch", None)
    with pytest.raises(ImportError, match="safetensors package"):
        port_conv.read_state_dict(path)


def test_converted_files_warm_start_the_other_package(dit_base):
    """JAX's file warm-starts the port's model and the port's file JAX's
    model: the encoders equal the state_dict's tensors, bit for bit."""
    src, sd, out_j, out_p, _, _ = dit_base
    want = port_wio.beit_state_dict_to_params(sd, port_vit.DIT_BASE)
    for path in (out_j, out_p, src):
        model = port_model.LayoutDetectionModel(ModelConfig(), compute_dtype="float32",
                                                device="cpu",
                                                previous_layout_dit_checkpoint=path)
        got = model.params["backbone"]["vit"]
        for a, b in zip(port_wio.tree_leaves(got), port_wio.tree_leaves(want)):
            assert torch.equal(a, b), path
    jmodel = JaxModel(JaxModelConfig(), compute_dtype="float32",
                      previous_layout_dit_checkpoint=out_p)
    _jax_tree_equal(jmodel.params["backbone"]["vit"], port_wio.vit_params_to_jax(want))


def test_env_resolution_and_warm_start_false(dit_base, tmp_path, monkeypatch):
    """``LAYOUTDIT_DIT_BASE_PTH`` (and the legacy alias) resolve as in
    JAX; the model warm-starts from it by default, at 1024 px too (the
    checkpoint's 197 position embeddings kept, resampled by the forward),
    not with ``warm_start=False``, and not for another architecture."""
    src, sd = dit_base[:2]
    assert port_conv.local_checkpoint("dit-base") is None
    monkeypatch.setenv("LAYOUTDIT_DIT_BASE_PTH", str(tmp_path / "missing.bin"))
    assert port_conv.local_checkpoint("dit-base") is None
    monkeypatch.setenv("LAYOUTDIT_DIT_BASE_PTH", src)
    assert port_conv.local_checkpoint("dit-base") == src == jax_conv.local_checkpoint("dit-base")
    monkeypatch.delenv("LAYOUTDIT_DIT_BASE_PTH")
    monkeypatch.setenv("LAYOUTDIT_DIT_BASE_CKPT", src)
    assert port_conv.local_checkpoint("dit-base") == src
    want = sd["encoder.layer.0.attention.attention.query.weight"]

    def q0(m):
        return m.params["backbone"]["vit"]["layers"][0]["qkv"]["weight"][:768]

    for size in (224, 1024):
        model = port_model.LayoutDetectionModel(ModelConfig(image_size=size),
                                                compute_dtype="float32", device="cpu")
        vit = model.params["backbone"]["vit"]
        assert torch.equal(q0(model), want)
        assert vit["pos_embed"].shape == (197, 768)
    calls = []
    monkeypatch.setattr(port_model, "local_checkpoint", lambda preset: calls.append(preset))
    model = port_model.LayoutDetectionModel(ModelConfig(), compute_dtype="float32", device="cpu",
                                            warm_start=False)
    assert not calls and not torch.equal(q0(model), want)
    monkeypatch.undo()
    monkeypatch.setenv("LAYOUTDIT_DIT_BASE_PTH", src)
    tiny = ModelConfig(vit_overrides={"hidden_size": 32, "num_hidden_layers": 2,
                                      "num_attention_heads": 2, "intermediate_size": 64})
    model = port_model.LayoutDetectionModel(tiny, compute_dtype="float32", device="cpu")
    assert model.params["backbone"]["vit"]["cls_token"].shape == (32,)
    # the config field warm-starts too; resnet50 has no encoder to warm-start
    rc = run_config_from_dict({"detection_model_config": {
        "previous_layout_dit_checkpoint": src}})
    assert rc.model.previous_layout_dit_checkpoint == src
    model = port_model.build_model(rc, device="cpu", warm_start=False)
    assert torch.equal(q0(model), want)


def test_warm_started_1024_model_predicts_and_restores(dit_base, tmp_path, monkeypatch):
    """A warm-started model at another image size keeps the checkpoint's
    position embeddings; its checkpoint restores into a fresh model (which
    takes the checkpoint's tensors) and predicts the same detections."""
    src = dit_base[0]
    mc = ModelConfig(image_size=128, previous_layout_dit_checkpoint=src)
    model = port_model.LayoutDetectionModel(mc, compute_dtype="float32", device="cpu")
    path = model.save_checkpoint(str(tmp_path), "run", 1)
    fresh = port_model.LayoutDetectionModel(ModelConfig(image_size=128),
                                            compute_dtype="float32", device="cpu", seed=3,
                                            warm_start=False)
    assert fresh.params["backbone"]["vit"]["pos_embed"].shape == (65, 768)
    fresh.restore_checkpoint(path)
    assert fresh.params["backbone"]["vit"]["pos_embed"].shape == (197, 768)
    images = torch.from_numpy(np.random.default_rng(1).uniform(0, 1, (1, 3, 128, 128))
                              .astype(np.float32))
    for a, b in zip(model.predict(images), fresh.predict(images)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("change", [{"num_classes": 7}, {"fpn_out_channels": 64}])
def test_restore_refuses_other_shapes(tmp_path, change):
    """Only the encoder's position embeddings and relative-position tables
    may differ in shape on restore: a checkpoint with another
    ``num_classes`` or FPN width is refused, and the model keeps its own
    tensors, the same objects with the same bits."""
    tiny = {"hidden_size": 32, "num_hidden_layers": 1, "num_attention_heads": 2,
            "intermediate_size": 64}
    mc = ModelConfig(image_size=64, fpn_out_channels=32, vit_overrides=tiny)
    other = port_model.LayoutDetectionModel(dataclasses.replace(mc, **change),
                                            compute_dtype="float32", device="cpu", seed=1,
                                            warm_start=False)
    path = other.save_checkpoint(str(tmp_path), "run", 1)
    model = port_model.LayoutDetectionModel(mc, compute_dtype="float32", device="cpu",
                                            warm_start=False)
    before = [(t, t.clone()) for t in port_wio.tree_leaves(model.params)]
    with pytest.raises(ValueError, match="parameter shapes differ"):
        model.restore_checkpoint(path)
    for (t, bits), now in zip(before, port_wio.tree_leaves(model.params), strict=True):
        assert now is t and torch.equal(now, bits)


def test_lora_model_warm_starts_from_msgpack(dit_base):
    """A LoRA model warm-starts from a converted ``.msgpack``: the base
    weights are the checkpoint's, fresh adapters sit beside them (B = 0).
    JAX's ``load_beit_checkpoint`` raises here: its template carries the
    adapters the file lacks (ROADMAP queue 3)."""
    sd, out_j = dit_base[1], dit_base[2]
    mc = ModelConfig(lora_rank=8, lora_alpha=16.0)
    model = port_model.LayoutDetectionModel(mc, compute_dtype="float32", device="cpu",
                                            previous_layout_dit_checkpoint=out_j)
    vit = model.params["backbone"]["vit"]
    q = sd["encoder.layer.3.attention.attention.query.weight"]
    assert torch.equal(vit["layers"][3]["qkv"]["weight"][:768], q)
    assert vit["layers"][3]["q"]["lora_a"].shape == (768, 8)
    assert not vit["layers"][3]["v"]["lora_b"].any()
    with pytest.raises(ValueError, match="lora"):
        jax_wio.load_beit_checkpoint(out_j, dataclasses.replace(jax_vit.DIT_BASE, lora_rank=8))


# ------------------------------------------------------ reference checkpoints


def _ref():
    from test_convert_reference import _cfg, _reference_state_dict

    jcfg = _cfg()
    vit = jcfg.backbone.vit
    pcfg = port_det.DetectorConfig(
        backbone=port_det.BackboneConfig(
            vit=port_vit.ViTConfig(hidden_size=vit.hidden_size,
                                   num_hidden_layers=vit.num_hidden_layers,
                                   num_attention_heads=vit.num_attention_heads,
                                   intermediate_size=vit.intermediate_size, image_size=64),
            fpn_out_channels=32),
        image_size=64, num_classes=5)
    return jcfg, pcfg, _reference_state_dict(jcfg)


def test_reference_conversion_matches_jax(tmp_path, monkeypatch):
    """The synthetic reference state_dict converts to JAX's tree exactly,
    a cascade config is refused, and the CLI's ``.msgpack`` restores in
    the port as parameters only."""
    jcfg, pcfg, sd = _ref()
    params = port_wio.detector_state_dict_to_params(sd, pcfg)
    _jax_tree_equal(port_wio.params_to_jax(params), jax_wio.detector_state_dict_to_params(sd, jcfg))
    template = port_det.init_detector(pcfg, torch.Generator(), "cpu")
    assert port_wio.tree_paths(params) == port_wio.tree_paths(template)
    with pytest.raises(ValueError, match="cascade"):
        port_wio.detector_state_dict_to_params(
            sd, dataclasses.replace(pcfg, cascade_iou_threshs=(0.5, 0.6)))
    with pytest.raises(ValueError, match="no DiT encoder"):
        port_wio.detector_state_dict_to_params({k: v for k, v in sd.items() if ".dit." not in k},
                                               pcfg)
    with pytest.raises(KeyError):
        port_wio.detector_state_dict_to_params({k: v for k, v in sd.items() if "fc7" not in k},
                                               pcfg)
    pth = str(tmp_path / "epoch_3_cpu.pth")
    torch.save(sd, pth)
    cfg = {"detection_model_config": {
        "image_size": 64, "fpn_out_channels": 32,
        "vit_overrides": {"hidden_size": 64, "num_hidden_layers": 4, "num_attention_heads": 4,
                          "intermediate_size": 128}}}
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(cfg))
    monkeypatch.delenv("LAYOUTDIT_CONFIG", raising=False)
    out = port_ref_cli.main(["--torch", pth, "--out", str(tmp_path / "converted.msgpack"),
                             "--config", str(cfg_path)])
    model = port_model.build_model(run_config_from_dict(cfg), device="cpu", warm_start=False)
    state = model.restore_checkpoint(out)
    assert state["opt_state"] is None and state["extra"] == {"source": pth}
    for a, b in zip(port_wio.tree_leaves(model.params), port_wio.tree_leaves(params)):
        assert torch.equal(a, b)


def test_package_needs_no_hf_package():
    """The card's machine has no ``transformers``, ``safetensors`` or
    ``torchvision``: the package imports none of the first and last, and
    ``safetensors`` only inside the function that reads such a file; every
    module imports with the three blocked."""
    import ast
    import subprocess
    import sys

    root = os.path.join(REPO, "layoutdit_tpu_torch")
    found = []
    for dirpath, _, files in os.walk(root):
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(dirpath, name)
            tree = ast.parse(open(path).read(), path)
            top = set(map(id, tree.body))
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    mods = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    mods = [node.module or ""]
                else:
                    continue
                for m in mods:
                    base = m.split(".")[0]
                    if base in ("transformers", "torchvision") or (
                            base == "safetensors" and id(node) in top):
                        found.append(f"{name}: {m}")
    assert not found, found
    code = ("import importlib, pkgutil, sys\n"
            "class Block:\n"
            "    def find_spec(self, name, path=None, target=None):\n"
            "        if name.split('.')[0] in ('transformers', 'safetensors', 'torchvision'):\n"
            "            raise ImportError('blocked ' + name)\n"
            "sys.meta_path.insert(0, Block())\n"
            "import layoutdit_tpu_torch\n"
            "for m in pkgutil.walk_packages(layoutdit_tpu_torch.__path__, "
            "'layoutdit_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-2000:]
