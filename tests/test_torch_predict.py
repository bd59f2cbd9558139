"""The port's predict tool (``tools/predict.py``) on the CPU at tiny widths:
the same records as JAX's tool over the same fixture JPEGs and the same
JAX ``.msgpack`` checkpoint (labels equal, boxes 1e-3, scores 1e-4,
matched as sets: the NMS may break float32 ties either way), ``--shards``
with a member filter, ``--auto-buckets`` (the planner's buckets, the
engine's records), ``--visualize``, the label inventories, the refused
``--int8``, and the card as the default device."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from layoutdit_tpu.config import LayoutDitConfig, set_layout_dit_config
from layoutdit_tpu.models.model import build_model as jax_build_model
from layoutdit_tpu.tools import predict as jax_predict
from layoutdit_tpu_torch.config import get_run_config
from layoutdit_tpu_torch.eval.buckets import plan_buckets
from layoutdit_tpu_torch.eval.serving import BatchInferenceEngine
from layoutdit_tpu_torch.models.model import build_model
from layoutdit_tpu_torch.tools import predict as port_predict
from layoutdit_tpu_torch.tools.make_fixture import make_fixture, write_fixture_config
from layoutdit_tpu_torch.tools.make_shards import main as make_shards_main
from layoutdit_tpu_torch.tools.serve import detections_to_json

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

BOX_TOL, SCORE_TOL = 1e-3, 1e-4


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    """Fixture pages of two sizes, the tiny config, and a JAX ``.msgpack``
    checkpoint of the tiny detector with drawn position embeddings and
    class weights (JAX's zeros leave near-ties that either NMS may break)."""
    root = str(tmp_path_factory.mktemp("predict"))
    make_fixture(root, n_images=4, split="samples", seed=2, image_size=64)
    make_fixture(os.path.join(root, "large"), n_images=2, split="samples", seed=3,
                 image_size=320)
    for f in os.listdir(os.path.join(root, "large", "samples")):
        os.replace(os.path.join(root, "large", "samples", f),
                   os.path.join(root, "samples", "large_" + f))
    path = write_fixture_config(root, epochs=1, batch_size=2, tiny_model=True)
    with open(path) as f:
        cfg = LayoutDitConfig(**json.load(f))
    set_layout_dit_config(cfg)
    try:
        model = jax_build_model(cfg, seed=0, warm_start=False)
        gen = np.random.default_rng(0)
        vit = model.params["backbone"]["vit"]
        vit["pos_embed"] = jax.numpy.asarray(gen.normal(0, 0.02, vit["pos_embed"].shape),
                                             np.float32)
        pred = model.params["box_predictor"]["cls"]
        pred["kernel"] = jax.numpy.asarray(gen.normal(0, 0.1, pred["kernel"].shape), np.float32)
        ckpt = model.save_checkpoint(root, "run", 1)
    finally:
        set_layout_dit_config(None)
    return root, path, cfg, ckpt


def _jax_records(fixture, args):
    root, _, cfg, ckpt = fixture
    set_layout_dit_config(cfg)
    try:
        out = os.path.join(root, "jax.json")
        jax_predict.main(["--checkpoint", ckpt, "--output", out, *args])
        with open(out) as f:
            return json.load(f)
    finally:
        set_layout_dit_config(None)


def _port_records(fixture, args, monkeypatch):
    root, path, _, ckpt = fixture
    monkeypatch.setenv("LAYOUTDIT_CONFIG", path)
    return port_predict.main(["--checkpoint", ckpt, "--device", "cpu", *args])


def _assert_same_records(want, got):
    assert [r["file"] for r in got] == [r["file"] for r in want]
    assert sum(len(r["labels"]) for r in want) > 0
    for w, g in zip(want, got):
        assert sorted(g["labels"]) == sorted(w["labels"])
        gb, gs, gl = (np.asarray(g[k]) for k in ("boxes", "scores", "labels"))
        used = np.zeros(len(gb), bool)
        for box, score, label in zip(w["boxes"], w["scores"], w["labels"]):
            # the records round boxes to 0.01 and scores to 1e-4 on both sides
            cand = np.nonzero((gl == label) & ~used
                              & (np.abs(gb - box).max(axis=1) <= BOX_TOL + 0.01)
                              & (np.abs(gs - score) <= SCORE_TOL + 1e-4))[0]
            assert len(cand), f"{w['file']}: no match for {label} {box} {score}"
            used[cand[0]] = True
        assert [g["label_names"][i] for i in range(len(gl))] == [
            port_predict._label_names(5, None)[int(x)] for x in gl]


@pytest.mark.parametrize("args", [
    ["--sizes", "64", "--batch-size", "2", "--score-thresh", "0.0"],
    ["--sizes", "64", "112", "--batch-size", "4", "--score-thresh", "0.2"],
], ids=["one_bucket", "two_buckets"])
def test_records_equal_jax_on_its_checkpoint(fixture, args, monkeypatch):
    inputs = ["--input", os.path.join(fixture[0], "samples")]
    _assert_same_records(_jax_records(fixture, inputs + args),
                         _port_records(fixture, inputs + args, monkeypatch))


def test_auto_buckets_and_visualize(fixture, monkeypatch, tmp_path):
    root, path, _, ckpt = fixture
    viz = str(tmp_path / "viz")
    records = _port_records(fixture, [
        "--input", os.path.join(root, "samples"), "--auto-buckets", "2", "--batch-size", "2",
        "--score-thresh", "0.0", "--visualize", viz, "--output", str(tmp_path / "d.json")],
        monkeypatch)
    with open(tmp_path / "d.json") as f:
        assert json.load(f) == records
    assert sorted(os.listdir(viz)) == sorted(
        os.path.basename(r["file"]) + ".pred.jpg" for r in records)
    # the planner's buckets for the pages' sizes, and the engine's records
    paths = port_predict.collect_inputs(os.path.join(root, "samples"))
    sizes = [(320, 320) if "large_" in p else (64, 64) for p in paths]
    assert plan_buckets(sizes, k=2) == [224, 320]  # 64 px pages snap up to the 224 floor
    model = build_model(get_run_config(), device="cpu")
    model.restore_checkpoint(ckpt)
    engine = BatchInferenceEngine.from_corpus(model, sizes, max_buckets=2, batch_size=2,
                                              score_thresh=0.0, device="cpu")
    pages = [open(p, "rb").read() for p in paths]
    want = [{"file": p, **detections_to_json(d, port_predict._label_names(5, None))}
            for p, d in zip(paths, engine.predict_pages(pages))]
    assert records == want
    assert port_predict._page_sizes(paths, lambda p, n: open(p, "rb").read(n or -1)) == sizes


def test_shards_and_member_filter(fixture, monkeypatch):
    root = fixture[0]
    shards = os.path.join(root, "shards")
    if not os.path.isdir(shards):
        make_shards_main(["--images", os.path.join(root, "samples"),
                          "--annotations", os.path.join(root, "samples.json"),
                          "--out", shards])
    args = ["--shards", shards, "--sizes", "64", "--batch-size", "2", "--score-thresh", "0.0"]
    records = _port_records(fixture, args, monkeypatch)
    assert len(records) == 4 and all(r["boxes"] for r in records)  # the COCO file's pages
    # the same pages read from files give the same records
    files = _port_records(fixture, ["--input", os.path.join(root, "samples", "page_*"),
                                    "--sizes", "64", "--batch-size", "2",
                                    "--score-thresh", "0.0"], monkeypatch)
    assert [r["boxes"] for r in records] == [r["boxes"] for r in files]
    only = _port_records(fixture, args + ["--input", "*0001*", "--auto-buckets", "1"],
                         monkeypatch)
    assert [r["file"] for r in only] == ["page_0001.jpg"]


def test_label_names_inventories():
    for n, dataset in ((5, None), (11, None), (13, "docbank"), (7, None), (7, "docbank"),
                       (11, "publaynet")):
        assert port_predict._label_names(n, dataset) == jax_predict._label_names(n, dataset)
    assert port_predict._label_names(11, None)[11] == "Title"


def test_collect_inputs_modes(tmp_path):
    for name in ("a.jpg", "b.png", "c.txt"):
        (tmp_path / name).write_bytes(b"x")
    for pattern in (str(tmp_path), str(tmp_path / "*.jpg")):
        assert port_predict.collect_inputs(pattern) == jax_predict.collect_inputs(pattern)
    with pytest.raises(FileNotFoundError):
        port_predict.collect_inputs(str(tmp_path / "*.gif"))


def test_refusals_and_default_device(fixture, monkeypatch):
    root, path, _, ckpt = fixture
    monkeypatch.setenv("LAYOUTDIT_CONFIG", path)
    inputs = ["--checkpoint", ckpt, "--input", os.path.join(root, "samples")]
    # --int8 serves the W8A8 encoder (no longer refused)
    records = port_predict.main(inputs + ["--int8", "--device", "cpu"])
    assert len(records) == len(port_predict.collect_inputs(inputs[3]))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_predict.main(inputs)
