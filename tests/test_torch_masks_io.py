"""The Mask R-CNN slice's host side and plumbing against the JAX package
on the CPU: ``data/masks.py`` (compressed and uncompressed RLE, polygons,
the padded gt block) and ``eval/masks.py`` (paste, windows, RLE export,
mask IoU) to the same bits; the loader's ``gt_masks`` block equal to
JAX's, with horizontal flips; the trainer taking a mask model through an
epoch (and refusing tar shards, as JAX's does); the serving engine's
masks and their JSON payload; the two configs of the slice in both
packages, and the families still refused."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from layoutdit_tpu.config.constructs import LayoutDitConfig
from layoutdit_tpu.data import masks as jax_dmasks
from layoutdit_tpu.data.dataset import PubLayNetDataset as JaxDataset
from layoutdit_tpu.data.pipeline import DetectionLoader as JaxLoader
from layoutdit_tpu.eval import masks as jax_emasks
from layoutdit_tpu_torch.config import load_config, load_run_config, run_config_from_dict
from layoutdit_tpu_torch.data import masks as port_dmasks
from layoutdit_tpu_torch.data.dataset import PubLayNetDataset
from layoutdit_tpu_torch.data.pipeline import DetectionLoader
from layoutdit_tpu_torch.eval import masks as port_emasks
from layoutdit_tpu_torch.eval.serving import BatchInferenceEngine
from layoutdit_tpu_torch.models.detection.detector import DetectorConfig, DetectorModel
from layoutdit_tpu_torch.models.model import build_model
from layoutdit_tpu_torch.tools.make_fixture import make_fixture, write_fixture_config
from layoutdit_tpu_torch.tools.serve import detections_to_json
from layoutdit_tpu_torch.train.trainer import Trainer
from test_torch_mask import _rle_string, _runs

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _random_mask(rng, h, w):
    m = np.zeros((h, w), np.uint8)
    for _ in range(3):
        y, x = rng.integers(0, h - 2), rng.integers(0, w - 2)
        m[y:y + rng.integers(1, h // 2), x:x + rng.integers(1, w // 2)] = 1
    return m


# ------------------------------------------------------------ data/masks.py


@pytest.mark.parametrize("seed", range(4))
def test_rle_decode_matches_jax(seed):
    rng = np.random.default_rng(seed)
    h, w = int(rng.integers(5, 60)), int(rng.integers(5, 60))
    m = _random_mask(rng, h, w)
    m[0, 0] = seed % 2  # a mask starting with a 1-run (a leading 0-run of length 0)
    runs = _runs(m)
    s = _rle_string(runs)
    assert port_dmasks.decode_compressed_rle(s) == jax_dmasks.decode_compressed_rle(s) == runs
    for counts in (runs, s, s.encode("ascii")):
        got = port_dmasks.rle_to_mask(counts, [h, w])
        np.testing.assert_array_equal(got, jax_dmasks.rle_to_mask(counts, [h, w]))
        np.testing.assert_array_equal(got, m)


def test_rasterisation_matches_jax():
    rng = np.random.default_rng(7)
    polys = [[[10.5, 3.0, 90.0, 12.0, 70.0, 80.25, 5.0, 60.0]],
             [[0.0, 0.0, 100.0, 0.0, 100.0, 75.0, 0.0, 75.0], [1.0, 2.0]],  # a short ring skipped
             [[30, 30, 60, 30, 45, 70], [70, 5, 95, 5, 95, 20, 70, 20]]]
    m = _random_mask(rng, 75, 100)
    rles = [{"size": [75, 100], "counts": _runs(m)},
            {"size": [75, 100], "counts": _rle_string(_runs(m))},
            {"size": [30, 40], "counts": _runs(_random_mask(rng, 30, 40))}]  # another size
    for seg in polys + rles:
        for out in (16, 32, 112):
            np.testing.assert_array_equal(port_dmasks.rasterize_instance(seg, 75, 100, out),
                                          jax_dmasks.rasterize_instance(seg, 75, 100, out))
        np.testing.assert_array_equal(port_dmasks.rasterize_fullsize(seg, 75, 100),
                                      jax_dmasks.rasterize_fullsize(seg, 75, 100))
    segs = polys + [None, []] + rles
    got = port_dmasks.rasterize_target_masks(segs, 75.0, 100.0, 32, 6)
    np.testing.assert_array_equal(got, jax_dmasks.rasterize_target_masks(segs, 75.0, 100.0, 32, 6))
    assert got.shape == (6, 32, 32) and got[0].any() and not got[3].any()


# ------------------------------------------------------------ eval/masks.py


def test_paste_windows_rle_and_iou_match_jax():
    rng = np.random.default_rng(3)
    im_h, im_w = 90, 120
    wins_p, wins_j = [], []
    for _ in range(12):
        prob = rng.uniform(0, 1, (28, 28)).astype(np.float32)
        xy = rng.uniform(-20, 110, 2)
        box = np.concatenate([xy, xy + rng.uniform(0.3, 60, 2)])
        wp = port_emasks.paste_mask_in_box(prob, box, im_h, im_w)
        wj = jax_emasks.paste_mask_in_box(prob, box, im_h, im_w)
        assert wp[:2] == wj[:2]
        np.testing.assert_array_equal(wp[2], wj[2])
        full = port_emasks.window_to_full(wp, im_h, im_w)
        np.testing.assert_array_equal(full, jax_emasks.window_to_full(wj, im_h, im_w))
        tight = port_emasks.full_to_window(full)
        jt = jax_emasks.full_to_window(full)
        assert tight[:2] == jt[:2]
        np.testing.assert_array_equal(tight[2], jt[2])
        assert port_emasks.encode_rle(wp, im_h, im_w) == jax_emasks.encode_rle(wj, im_h, im_w)
        wins_p.append(wp)
        wins_j.append(wj)
    crowd = np.array([False, True, False, False])
    np.testing.assert_array_equal(port_emasks.mask_iou(wins_p[:8], wins_p[8:], crowd),
                                  jax_emasks.mask_iou(wins_j[:8], wins_j[8:], crowd))
    empty = port_emasks.full_to_window(np.zeros((4, 4), np.uint8))
    assert empty[2].size == 0 and port_emasks.encode_rle(empty, 4, 4)["counts"] == [16]


# -------------------------------------------------------- loader and trainer


@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mask_fixture"))
    make_fixture(root, n_images=8, split="samples", seed=2)
    write_fixture_config(root, epochs=1, batch_size=4, tiny_model=True)
    return root


@pytest.mark.parametrize("hflip", [0.0, 0.5])
def test_loader_gt_masks_match_jax(fixture_dir, hflip):
    root, ann = os.path.join(fixture_dir, "samples") + "/", fixture_dir + "/samples.json"
    kw = dict(batch_size=3, shuffle=True, num_workers=2, image_size=64, max_gt=16, seed=4,
              augment_hflip=hflip, load_masks=True)
    jl = JaxLoader(JaxDataset(root, ann, with_segmentation=True), device_put=False,
                   use_native=False, **kw)
    pl = DetectionLoader(PubLayNetDataset(root, ann, with_segmentation=True), device="cpu", **kw)
    assert not pl.dataset.native  # the segmentations need the json.loads parse
    with pytest.raises(ValueError, match="with_segmentation"):
        DetectionLoader(PubLayNetDataset(root, ann), device="cpu", **kw)
    plain = DetectionLoader(PubLayNetDataset(root, ann, with_segmentation=True), device="cpu",
                            **dict(kw, augment_hflip=0.0))
    flipped = 0
    for epoch in range(2):
        jl.set_epoch(epoch)
        pl.set_epoch(epoch)
        plain.set_epoch(epoch)
        for j, p, q in zip(list(jl), list(pl), list(plain), strict=True):
            np.testing.assert_array_equal(p.image_ids, j.image_ids)
            assert p.gt_masks.dtype == torch.uint8 and p.gt_masks.shape == (3, 16, 32, 32)
            np.testing.assert_array_equal(p.gt_masks.numpy(), j.gt_masks)
            np.testing.assert_array_equal(p.gt_boxes.numpy(), j.gt_boxes)
            assert p.gt_masks.numpy()[p.gt_valid.numpy()].any(axis=(1, 2)).all()
            flipped += int((p.gt_masks != q.gt_masks).any(dim=(1, 2, 3)).sum())
    assert (flipped > 0) == (hflip > 0)
    for loader in (jl, pl, plain):
        loader.close()


def _mask_run_config(fixture_dir, tmp_path, **data):
    with open(os.path.join(fixture_dir, "cfg.json")) as f:
        raw = json.load(f)
    raw["detection_model_config"]["with_mask"] = True
    raw["eval_config"]["eval_base_path"] = str(tmp_path)
    raw["train_config"].update(tensorboard=False)
    raw["data_loader_config"].update(data)
    return run_config_from_dict(raw)


def test_trainer_runs_a_mask_model(fixture_dir, tmp_path):
    rc = _mask_run_config(fixture_dir, tmp_path)
    model = build_model(rc, device="cpu")
    trainer = Trainer(rc, model, device="cpu")
    batch = next(iter(trainer.dataloader))
    m = model.cfg.gt_mask_size
    assert m == model.cfg.image_size // 2
    assert batch.gt_masks.shape == (4, rc.data.max_gt_boxes, m, m)
    loss, parts = trainer.train_step(batch)
    assert "loss_mask" in parts and float(parts["loss_mask"]) > 0
    assert np.isfinite(float(loss))
    trainer.train()
    assert len(trainer.loss_history) == 1 and np.isfinite(trainer.loss_history[0])
    with pytest.raises(ValueError, match="tar-shard"):
        Trainer(_mask_run_config(fixture_dir, tmp_path, image_shards_dir=str(tmp_path)), model,
                device="cpu")


def test_engine_serves_masks(fixture_dir, tmp_path):
    from PIL import Image

    from layoutdit_tpu_torch.tools.predict import _visualize

    rc = _mask_run_config(fixture_dir, tmp_path)
    model = build_model(rc, device="cpu")
    engine = BatchInferenceEngine(DetectorModel(model.params, model.cfg), image_sizes=(64,),
                                  batch_size=2, score_thresh=0.0, device="cpu")
    names = sorted(os.listdir(os.path.join(fixture_dir, "samples")))[:3]
    pages = [open(os.path.join(fixture_dir, "samples", n), "rb").read() for n in names]
    results = engine.predict_pages(pages)
    assert sum(len(r.boxes) for r in results) > 0
    for page, r in zip(pages, results):
        assert len(r.masks) == len(r.boxes)
        with Image.open(__import__("io").BytesIO(page)) as im:
            w, h = im.size
        payload = detections_to_json(r, {})
        assert len(payload["masks"]) == len(r.boxes)
        for (x0, y0, bm), m in zip(r.masks, payload["masks"]):
            assert 0 <= x0 < w and 0 <= y0 < h and m["offset"] == [x0, y0]
            np.testing.assert_array_equal(port_dmasks.rle_to_mask(m["counts"], m["size"]), bm)
    out = str(tmp_path / "viz" / "p.jpg")
    _visualize(pages[0], results[0], out, {})
    assert os.path.getsize(out) > 0


# ------------------------------------------------------------------ configs


def test_slice_configs_load_in_both_packages():
    for name, check in (("cascade_dp.json", lambda mc: mc.cascade_iou_threshs == (0.5, 0.6, 0.7)),
                        ("mask_rcnn.json", lambda mc: mc.with_mask and mc.image_size == 224)):
        path = os.path.join(REPO, "configs", name)
        with open(path) as f:
            raw = json.load(f)
        jmc = LayoutDitConfig(**raw).detection_model_config
        rc = load_run_config(path)
        assert check(rc.model), name
        assert tuple(jmc.cascade_iou_threshs) == rc.model.cascade_iou_threshs
        assert jmc.with_mask == rc.model.with_mask
        assert load_config(path)[0] == rc.model
        cfg = DetectorConfig.from_model_config(rc.model)
        assert cfg.cascade_iou_threshs == rc.model.cascade_iou_threshs
        assert cfg.with_mask == rc.model.with_mask
    large = DetectorConfig.from_model_config(load_run_config(
        os.path.join(REPO, "configs", "cascade_dp.json")).model)
    assert large.backbone.vit.hidden_size == 1024 and large.cascade_loss_weights == (1.0, 0.5, 0.25)


@pytest.mark.parametrize("family", ["retinanet", "fcos", "detr"])
def test_other_families_are_refused(family):
    """RetinaNet, FCOS and DETR load, with their levels (DETR its
    ``detr_*`` fields) and their budget at JAX's defaults,
    ``detr_score_thresh`` included."""
    from layoutdit_tpu.config.constructs import DetectionBudget as JaxBudget
    from layoutdit_tpu.config.constructs import ModelConfig as JaxModelConfig

    rc = load_run_config(os.path.join(REPO, "configs", f"{family}.json"))
    mc = rc.model
    assert mc.detector == family
    jb = JaxBudget()
    for k in (f.name for f in dataclasses.fields(mc.detection_budget)):
        assert getattr(mc.detection_budget, k) == getattr(jb, k), k
    cfg = DetectorConfig.from_model_config(mc)
    assert cfg.detector_kind == family
    if family == "detr":
        jm = JaxModelConfig()
        for k in (f.name for f in dataclasses.fields(mc) if f.name.startswith("detr_")):
            assert getattr(mc, k) == getattr(jm, k), k
            assert getattr(cfg, k) == getattr(jm, k), k
        assert mc.detection_budget.detr_score_thresh == 0.0 and rc.data.max_gt_boxes == 32
        return
    assert getattr(mc, f"{family}_levels") == (1, 2, 3, 4)
    assert cfg.num_anchors_per_cell == (9 if family == "retinanet" else 3)


def test_convergence_family_floors(tmp_path, monkeypatch):
    """``tools/convergence.py --family``: the family's overrides reach the
    recipe's config, and a modifier family is held to the mAP and AP50
    floors (the mask family to segm's too), not to the flagship's
    per-class and loss-ratio ones; a single-stage family to JAX's own
    floors (RetinaNet 0.22 / 0.45, FCOS 0.55 / 0.75) and a last-4 loss
    under 0.6 x the first 4."""
    from layoutdit_tpu_torch.tools import convergence

    monkeypatch.setattr("layoutdit_tpu_torch.tools.make_fixture.make_fixture",
                        lambda *a, **k: None)
    for family, check in (("cascade", lambda mc: mc.cascade_iou_threshs == (0.5, 0.6, 0.7)),
                          ("mask", lambda mc: mc.with_mask),
                          ("retinanet", lambda mc: mc.detector == "retinanet"),
                          ("fcos", lambda mc: mc.detector == "fcos")):
        os.makedirs(tmp_path / family)
        rc = convergence.recipe_config(str(tmp_path / family), "float32", family=family)
        assert check(rc.model), family
    losses = [1.0] * convergence.EPOCHS  # no fall: the flagship's ratio floor misses
    metrics = {"mAP": 0.5, "AP50": 0.8, "segm_mAP": 0.3, "segm_AP50": 0.9,
               **{f"AP50-{c}": 0.1 for c in convergence.FLOOR_CLASSES}}
    got = {fam: convergence.floor_failures({"family": fam, "loss": losses, "metrics": metrics})
           for fam in ("faster_rcnn", "cascade", "mask", "retinanet", "fcos")}
    assert got["cascade"] == []
    assert len(got["mask"]) == 1 and got["mask"][0].startswith("segm_mAP")
    assert got["retinanet"] == ["last-4 loss 1.0000 not under 0.6 x first-4 1.0000"]
    assert got["fcos"] == [got["retinanet"][0], "mAP 0.5000 < 0.55"]
    falling = [1.0] * 4 + [0.8] * (convergence.EPOCHS - 8) + [0.55] * 4  # under 0.6, not 0.4
    for fam, m in (("retinanet", {"mAP": 0.22, "AP50": 0.45}), ("fcos", {"mAP": 0.55,
                                                                         "AP50": 0.75})):
        assert convergence.floor_failures({"family": fam, "loss": falling, "metrics": m}) == []
        low = {"mAP": m["mAP"] - 0.01, "AP50": m["AP50"] - 0.01}
        assert len(convergence.floor_failures({"family": fam, "loss": falling,
                                               "metrics": low})) == 2
    assert len(got["faster_rcnn"]) == 1 + len(convergence.FLOOR_CLASSES)
