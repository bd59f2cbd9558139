"""The rest of the port's encoder, config and data options against the
JAX package on the CPU: ``score_dtype: "bfloat16"`` (the plain attention
against JAX's XLA branch), ``precision.param_dtype``, the trainer's
``enable_profile`` / ``trace_log_dir``, the DocLayNet / DocBank adapters
(``data/adapters.py``) with an 11-class fine-tune end to end,
``tools/show_config.py`` and ``tools/doctor.py``.

Tolerances: bf16 scores, the encoder's taps within max |JAX| / 64 of
JAX's (both bf16, the same roundings in another order), while the fp32-
score taps differ from them; the DocBank JSON byte for byte; show_config's
values equal."""

import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from layoutdit_tpu.config import set_layout_dit_config
from layoutdit_tpu.config.constructs import LayoutDitConfig
from layoutdit_tpu.data import adapters as jax_adapters
from layoutdit_tpu.models import vit as jax_vit
from layoutdit_tpu.tools import show_config as jax_show
from layoutdit_tpu_torch.config import get_run_config, load_run_config, run_config_from_dict
from layoutdit_tpu_torch.data import adapters
from layoutdit_tpu_torch.models import vit as port_vit
from layoutdit_tpu_torch.models.model import build_model
from layoutdit_tpu_torch.models.weights_io import tree_leaves, vit_params_from_jax
from layoutdit_tpu_torch.tools import doctor, show_config
from layoutdit_tpu_torch.tools.make_fixture import make_fixture, write_fixture_config
from layoutdit_tpu_torch.train.trainer import Trainer

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
VIT = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=2, intermediate_size=64,
           image_size=64)
BF16_SHARE = 1 / 64
SCORE_LAYOUTS = {
    "dense": dict(patch_size=16),
    "windowed": dict(patch_size=8, window_size=3, global_attn_layers=(2,)),
    "relpos": dict(patch_size=16, use_absolute_position_embeddings=False,
                   use_relative_position_bias=True),
}


@pytest.mark.parametrize("layout", sorted(SCORE_LAYOUTS))
def test_bf16_scores_match_jax_xla_branch(layout):
    """The encoder in bf16 with bf16 scores (key-masked padded windows,
    a relative-position bias) against JAX's ``attention_impl="xla"`` with
    ``score_dtype="bfloat16"``; the fp32-score port differs."""
    jcfg = jax_vit.ViTConfig(**VIT, **SCORE_LAYOUTS[layout], score_dtype="bfloat16")
    jparams = jax.tree_util.tree_map(np.asarray,
                                     jax_vit.init_vit_params(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(1)
    for layer in jparams["layers"]:
        if "rel_pos_table" in layer:
            layer["rel_pos_table"] = (0.5 * rng.standard_normal(layer["rel_pos_table"].shape)
                                      ).astype(np.float32)
    x = np.random.default_rng(2).standard_normal((2, 3, 64, 64)).astype(np.float32)
    want = jax_vit.vit_forward(jparams, jnp.asarray(x), jcfg, taps=(1, 2),
                               compute_dtype=jnp.bfloat16, attention_impl="xla")
    cfg = port_vit.ViTConfig(**VIT, **SCORE_LAYOUTS[layout], score_dtype="bfloat16")
    params = vit_params_from_jax(jparams)
    got = port_vit.vit_forward(params, torch.from_numpy(x), cfg, taps=(1, 2),
                               compute_dtype=torch.bfloat16)
    fp32 = port_vit.vit_forward(params, torch.from_numpy(x),
                                port_vit.ViTConfig(**VIT, **SCORE_LAYOUTS[layout]), taps=(1, 2),
                                compute_dtype=torch.bfloat16)
    for g, w, f in zip(got, want, fp32):
        w = np.asarray(w.astype(jnp.float32))
        err = np.abs(g.float().numpy() - w).max()
        assert err <= BF16_SHARE * np.abs(w).max(), err
        assert not torch.equal(g, f)


def test_bf16_score_attention_follows_jax_branch():
    """``bf16_score_attention_plain`` step by step: bf16 scores scaled in
    bf16, an fp32 denominator, gradients through all but the row max;
    ``attention_core`` takes it on the CPU only for "bfloat16"."""
    g = torch.Generator().manual_seed(0)
    qkv = torch.randn(2, 9, 3 * 2 * 16, generator=g).to(torch.bfloat16).requires_grad_(True)
    out = port_vit.bf16_score_attention_plain(qkv, 2)
    assert out.dtype == torch.bfloat16
    out.float().sum().backward()
    assert torch.isfinite(qkv.grad.float()).all() and qkv.grad.abs().max() > 0
    with torch.no_grad():
        assert torch.equal(port_vit.attention_core(qkv, 2, score_dtype="bfloat16"), out)
        ref = port_vit.attention_core(qkv, 2)
        assert not torch.equal(ref, out)
        np.testing.assert_allclose(out.float().numpy(), ref.float().numpy(), atol=0.05)


def test_param_dtype_keeps_fp32_parameters_in_both_packages(tmp_path):
    """``precision.param_dtype: "bfloat16"`` loads in both packages (JAX
    reads it nowhere): every parameter leaf stays float32."""
    make_fixture(str(tmp_path), n_images=2, image_size=64)
    cfg_path = write_fixture_config(str(tmp_path), tiny_model=True)
    raw = json.load(open(cfg_path))
    raw["precision"]["param_dtype"] = "bfloat16"
    from layoutdit_tpu.models.model import build_model as jax_build

    jmodel = jax_build(LayoutDitConfig(**raw), warm_start=False)
    assert {np.asarray(x).dtype for x in jax.tree_util.tree_leaves(jmodel.params)} == {
        np.dtype(np.float32)}
    rc = run_config_from_dict(raw)
    assert rc.param_dtype == "bfloat16"
    model = build_model(rc, device="cpu", warm_start=False)
    assert {t.dtype for t in tree_leaves(model.params)} == {torch.float32}


@pytest.fixture
def fixture_cfg(tmp_path):
    make_fixture(str(tmp_path), n_images=4, image_size=64)
    return tmp_path, json.load(open(write_fixture_config(str(tmp_path), epochs=1,
                                                         tiny_model=True)))


def test_enable_profile_writes_and_uploads_traces(fixture_cfg):
    """``enable_profile``: ``train()`` runs under ``torch.profiler``, a
    chrome trace lands under ``trace_log_dir``, and the tree is uploaded
    to ``{artifacts}/{run}/profiler/`` on fsspec ``memory://``, keeping
    relative paths (as JAX's ``tests/test_profiler.py``)."""
    import fsspec

    root, raw = fixture_cfg
    traces = root / "traces"
    (traces / "earlier").mkdir(parents=True)
    (traces / "earlier" / "note.txt").write_text("kept")
    raw["train_config"].update(enable_profile=True, trace_log_dir=str(traces),
                               tensorboard=False)
    raw["eval_config"]["eval_base_path"] = "memory://profile_test"
    rc = run_config_from_dict(raw)
    trainer = Trainer(rc, build_model(rc, device="cpu", warm_start=False), device="cpu")
    trainer.train()
    local = sorted(p.relative_to(traces).as_posix() for p in traces.rglob("*") if p.is_file())
    assert "earlier/note.txt" in local
    (trace,) = [p for p in local if p.endswith(".pt.trace.json")]
    assert json.load(open(traces / trace))["traceEvents"]
    fs = fsspec.filesystem("memory")
    try:
        remote = f"memory://profile_test/{rc.run_name}/profiler"
        uploaded = sorted(p.split("/profiler/", 1)[1] for p in fs.find(remote))
        assert uploaded == local
        assert fs.cat(f"{remote}/earlier/note.txt") == b"kept"
    finally:
        fs.rm("memory://profile_test", recursive=True)
    assert np.isfinite(trainer.loss_history[0])


DOCBANK_LINES = [
    "hello\t100\t50\t200\t80\t0\t0\t0\tArial\tparagraph",
    "world\t100\t90\t220\t120\t0\t0\t0\tArial\ttitle",
    "bad\t10\t10\t10\t30\t0\t0\t0\tArial\tparagraph",  # zero width
    "skip\t10\t10\t30\t30\t0\t0\t0\tArial\tunknown_label",
    "short\t1\t2",
]


@pytest.mark.parametrize("where", ["local", "memory"])
def test_docbank_conversion_equals_jax(tmp_path, where):
    """``convert_docbank_to_coco`` writes JAX's bytes for the same txt
    files (listed through fsspec for a URL), and the result loads through
    ``load_coco_dataset``: degenerate tokens and unknown labels dropped,
    ``_ori.jpg`` names, DocBank's category ids."""
    import fsspec
    from PIL import Image

    pages = {"page_1.txt": DOCBANK_LINES, "page_0.txt": DOCBANK_LINES[:2],
             "notes.md": ["ignored"]}
    local_dir = str(tmp_path / "txt")
    txt_dir = local_dir if where == "local" else f"memory://docbank_{os.getpid()}/txt"
    for d in {local_dir, txt_dir}:
        for name, lines in pages.items():
            with fsspec.open(f"{d}/{name}", "w", auto_mkdir=True) as f:
                f.write("\n".join(lines))
    want = jax_adapters.convert_docbank_to_coco(local_dir, "", str(tmp_path / "jax.json"))
    try:
        got = adapters.convert_docbank_to_coco(txt_dir, "", str(tmp_path / "port.json"))
        if where == "memory":
            # JAX's converter takes fs.ls() for names, which a memory://
            # filesystem gives as dicts (ROADMAP queue 3)
            with pytest.raises(AttributeError):
                jax_adapters.convert_docbank_to_coco(txt_dir, "", str(tmp_path / "x.json"))
    finally:
        if where == "memory":
            fsspec.filesystem("memory").rm(txt_dir.rsplit("/", 1)[0], recursive=True)
    assert open(got, "rb").read() == open(want, "rb").read()
    coco = json.load(open(got))
    assert [im["file_name"] for im in coco["images"]] == ["page_0_ori.jpg", "page_1_ori.jpg"]
    assert len(coco["annotations"]) == 4 and len(coco["categories"]) == 13
    img_dir = tmp_path / "img"
    img_dir.mkdir()
    for im in coco["images"]:
        Image.new("RGB", (1000, 1000), "white").save(img_dir / im["file_name"])
    ds = adapters.load_coco_dataset(str(img_dir), got)
    target = ds.load_target(ds.ids[1])
    assert len(target["boxes"]) == 2
    para = adapters.DOCBANK.class_names.index("paragraph") + 1
    title = adapters.DOCBANK.class_names.index("title") + 1
    assert set(np.asarray(target["labels"]).tolist()) == {
        ds.cat_id_to_label[para], ds.cat_id_to_label[title]}
    assert ds.load_image(ds.ids[0]).shape == (1000, 1000, 3)


def test_dataset_specs_match_jax():
    assert adapters.SPECS == {k: adapters.DatasetSpec(s.name, s.num_classes, s.class_names)
                              for k, s in jax_adapters.SPECS.items()}
    rc = adapters.apply_dataset_spec(run_config_from_dict({}), "doclaynet")
    assert rc.model.num_classes == 11 and run_config_from_dict({}).model.num_classes == 5


def test_transfer_finetune_doclaynet_shaped(tmp_path):
    """The 11-class transfer fine-tune end to end (JAX's
    ``tests/test_adapters.py:59``): a DocLayNet-shaped fixture ->
    ``apply_dataset_spec`` -> one epoch -> ``score()``, heads sized for 11
    classes + background."""
    from layoutdit_tpu_torch.eval.evaluator import Evaluator

    root = str(tmp_path / "dln")
    make_fixture(root, n_images=6, image_size=64, seed=5, num_classes=11)
    coco = json.load(open(os.path.join(root, "samples.json")))
    assert len(coco["categories"]) == 11
    assert max(a["category_id"] for a in coco["annotations"]) > 5
    rc = load_run_config(write_fixture_config(root, epochs=1, batch_size=3, tiny_model=True))
    rc = adapters.apply_dataset_spec(rc, "doclaynet")
    model = build_model(rc, device="cpu", warm_start=False)
    assert tuple(model.params["box_predictor"]["cls"]["bias"].shape) == (12,)
    trainer = Trainer(rc, model, device="cpu")
    trainer.train()
    assert np.isfinite(trainer.loss_history[0])
    metrics = Evaluator(model, rc, device="cpu").score()
    assert metrics is not None and np.isfinite(metrics["mAP"])


ITEM_7 = ("train_tp_sp.json", "train_multislice.json")


def _jax_view(path, monkeypatch, capsys, argv):
    monkeypatch.setenv("LAYOUTDIT_SKIP_REMOTE_CONFIG", "1")
    set_layout_dit_config(None)
    try:
        jax_show.main(argv)
        return json.loads(capsys.readouterr().out)
    finally:
        set_layout_dit_config(None)


@pytest.mark.parametrize("name", sorted(p.name for p in (REPO / "configs").glob("*.json")))
def test_show_config_agrees_with_jax(name, monkeypatch, capsys):
    """Every ``configs/*.json``: the port's ``show_config`` (and
    ``--diff``) gives JAX's value for every field the two share, or, for
    the item 7 meshes, the port refuses the file. JAX's ``local_mode`` is
    None when unset where the port's is False."""
    monkeypatch.setenv("LAYOUTDIT_CONFIG", str(REPO / "configs" / name))
    if name in ITEM_7:
        with pytest.raises(ValueError, match="queue 1 item 7"):
            get_run_config()
        return
    want = jax_show._flatten(_jax_view(name, monkeypatch, capsys, []))
    want["local_mode"] = bool(want["local_mode"])
    show_config.main([])
    got = show_config.flatten(json.loads(capsys.readouterr().out))
    assert set(got) <= set(want)
    assert {k: v for k, v in got.items() if want[k] != v} == {}
    jdiff = _jax_view(name, monkeypatch, capsys, ["--diff"])
    show_config.main(["--diff"])
    pdiff = json.loads(capsys.readouterr().out)
    assert pdiff == {k: v for k, v in jdiff.items() if k in got and k != "local_mode"} | (
        {"local_mode": True} if got["local_mode"] else {})


def test_show_config_defaults_and_diff(tmp_path, monkeypatch, capsys):
    cfg = tmp_path / "c.json"
    cfg.write_text(json.dumps({"train_config": {"num_epochs": 3},
                               "data_loader_config": {"batch_size": 7},
                               "precision": {"param_dtype": "bfloat16"}}))
    monkeypatch.setenv("LAYOUTDIT_CONFIG", str(cfg))
    show_config.main(["--diff"])
    assert json.loads(capsys.readouterr().out) == {
        "data_loader_config.batch_size": 7, "precision.param_dtype": "bfloat16",
        "train_config.num_epochs": 3}
    monkeypatch.delenv("LAYOUTDIT_CONFIG")
    show_config.main([])
    full = json.loads(capsys.readouterr().out)
    assert full["data_loader_config"]["batch_size"] == 16
    assert full["detection_model_config"]["detection_budget"]["rpn_nms_thresh"] == 0.7


def test_doctor_on_a_fixture_tree(fixture_cfg, monkeypatch, capsys):
    """``--skip-backend --json`` on a ``make_fixture`` tree: no FAIL, exit
    0, every check present; with the backend and no GPU the backend check
    FAILs (exit 1), the kernels are not built, and the CPU is never
    reported as a device."""
    root, _ = fixture_cfg
    monkeypatch.setenv("LAYOUTDIT_CONFIG", str(root / "cfg.json"))
    for name in ("LAYOUTDIT_DIT_BASE_PTH", "LAYOUTDIT_DIT_BASE_CKPT", "LAYOUTDIT_DIT_LARGE_PTH"):
        monkeypatch.delenv(name, raising=False)
    assert doctor.main(["--skip-backend", "--json"]) == 0
    results = json.loads(capsys.readouterr().out)
    status = {r["check"]: r["status"] for r in results}
    assert list(status) == ["config", "native", "pretrained", "kernel-build-dir",
                            "io:train-data", "io:eval-base", "checkpoints"]
    assert "FAIL" not in status.values()
    assert status["config"] == status["io:train-data"] == status["checkpoints"] == "OK"
    assert status["pretrained"] == "WARN"
    if torch.cuda.is_available():
        return
    assert doctor.main(["--json"]) == 1
    results = {r["check"]: r for r in json.loads(capsys.readouterr().out)}
    assert results["backend"]["status"] == "FAIL"
    assert "no CUDA device" in results["backend"]["detail"]
    assert results["kernels"]["status"] == "WARN" and results["mesh"]["status"] == "OK"
    monkeypatch.setenv("LAYOUTDIT_CONFIG", str(REPO / "configs" / "train_tp_sp.json"))
    assert doctor.check_mesh()["status"] == "FAIL"
    assert "item 7" in doctor.check_mesh()["detail"]


def test_doctor_watchdog():
    """A check that blocks is reported, not waited for."""
    import threading

    gate = threading.Event()
    assert doctor._with_timeout(gate.wait, 0.05) == (False, None)
    gate.set()
    assert doctor._with_timeout(lambda: 3, 1.0) == (True, 3)
    with pytest.raises(ZeroDivisionError):
        doctor._with_timeout(lambda: 1 / 0, 1.0)
