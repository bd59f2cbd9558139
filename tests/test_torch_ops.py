"""PyTorch port vs the JAX package: box ops, resizes, anchors, NMS and the
config loader (CPU, float32)."""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from layoutdit_tpu.config.constructs import DetectionBudget as JaxBudget
from layoutdit_tpu.config.constructs import LayoutDitConfig
from layoutdit_tpu.models.detection import anchors as jax_anchors
from layoutdit_tpu.ops import boxes as jax_boxes
from layoutdit_tpu.ops import interpolate as jax_interp
from layoutdit_tpu.ops import nms as jax_nms
from layoutdit_tpu_torch import config as port_config
from layoutdit_tpu_torch.models.detection import anchors as port_anchors
from layoutdit_tpu_torch.ops import boxes as port_boxes
from layoutdit_tpu_torch.ops import interpolate as port_interp
from layoutdit_tpu_torch.ops import nms as port_nms

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

REPO = os.path.join(os.path.dirname(__file__), os.pardir)


def _rand_boxes(rng, n, lo=0.0, hi=200.0, min_wh=1.0, max_wh=80.0):
    b = rng.uniform(lo, hi, (n, 4)).astype(np.float32)
    b[:, 2:] = b[:, :2] + rng.uniform(min_wh, max_wh, (n, 2)).astype(np.float32)
    return b


def test_box_ops_match_jax(rng):
    anchors = _rand_boxes(rng, 500)
    deltas = rng.normal(0, 2.0, (500, 4)).astype(np.float32)
    deltas[:7, 2:] = 9.0  # exercise the log(1000/16) clamp
    w = (10.0, 10.0, 5.0, 5.0)
    got = port_boxes.decode_boxes(torch.from_numpy(deltas), torch.from_numpy(anchors), w)
    want = jax_boxes.decode_boxes(jnp.asarray(deltas), jnp.asarray(anchors), w)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-4)

    clipped = port_boxes.clip_boxes_to_image(got, 150.0, 120.0)
    np.testing.assert_allclose(
        clipped.numpy(),
        np.asarray(jax_boxes.clip_boxes_to_image(jnp.asarray(got.numpy()), 150.0, 120.0)),
    )
    np.testing.assert_array_equal(
        port_boxes.small_box_mask(clipped, 1.0).numpy(),
        np.asarray(jax_boxes.small_box_mask(jnp.asarray(clipped.numpy()), 1.0)),
    )
    np.testing.assert_allclose(
        port_boxes.box_area(clipped).numpy(),
        np.asarray(jax_boxes.box_area(jnp.asarray(clipped.numpy()))), rtol=1e-6,
    )


@pytest.mark.parametrize("mode", ["bilinear", "bicubic"])
@pytest.mark.parametrize("size", [(7, 7), (28, 28), (20, 13), (64, 64)])
def test_resize_matches_jax(rng, mode, size):
    x = rng.standard_normal((3, 14, 14)).astype(np.float32)
    port_fn = getattr(port_interp, f"resize_{mode}")
    jax_fn = getattr(jax_interp, f"resize_{mode}")
    got = port_fn(torch.from_numpy(x), *size).numpy()
    want = np.asarray(jax_fn(jnp.asarray(x), *size))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize(
    "shape,size", [((3, 90, 70), 64), ((3, 300, 231), 1024), ((120, 100), 128)]
)
def test_resize_bilinear_matches_jax_host_resize(rng, shape, size):
    # the port's engine resizes pages on the device with resize_bilinear
    # where the JAX engine runs its numpy resize_bilinear_np on the host
    x = rng.uniform(0, 1, shape).astype(np.float32)
    got = port_interp.resize_bilinear(torch.from_numpy(x), size, size).numpy()
    np.testing.assert_allclose(got, jax_interp.resize_bilinear_np(x, size, size), atol=1e-6)


@pytest.mark.parametrize("image_size", [64, 224, 1024])
def test_anchors_match_jax(image_size):
    g = image_size // 16
    grids = tuple((s, s) for s in (4 * g, 2 * g, g, g // 2, (g // 2 + 1) // 2))
    sizes = ((32.0,), (64.0,), (128.0,), (256.0,), (512.0,))
    ratios = ((0.5, 1.0, 2.0),) * 5
    got, got_counts = port_anchors.grid_anchors((image_size,) * 2, grids, sizes, ratios)
    want, want_counts = jax_anchors.grid_anchors((image_size,) * 2, grids, sizes, ratios)
    assert got_counts == want_counts
    np.testing.assert_array_equal(got, want)


def _clustered(rng, n, centers=12):
    """Boxes in overlapping clusters so suppression chains are long."""
    c = rng.uniform(0, 300, (centers, 2)).astype(np.float32)
    idx = rng.integers(0, centers, n)
    xy = c[idx] + rng.normal(0, 6, (n, 2)).astype(np.float32)
    wh = rng.uniform(20, 60, (n, 2)).astype(np.float32)
    return np.concatenate([xy, xy + wh], axis=1)


@pytest.mark.parametrize("n", [7, 300, 700])
@pytest.mark.parametrize("thr", [0.5, 0.7])
def test_nms_matches_jax(rng, n, thr):
    boxes = _clustered(rng, n)
    scores = rng.uniform(0, 1, n).astype(np.float32)
    valid = rng.uniform(size=n) > 0.15  # invalid rows never keep/suppress
    want = np.asarray(jax_nms.nms_mask(
        jnp.asarray(boxes), jnp.asarray(scores), thr, valid=jnp.asarray(valid)
    ))
    got = port_nms.nms_mask(
        torch.from_numpy(boxes), torch.from_numpy(scores), thr,
        valid=torch.from_numpy(valid),
    ).numpy()
    np.testing.assert_array_equal(got, want)
    assert not got[~valid].any()


def test_nms_ties_at_threshold():
    # IoU exactly 0.5 does NOT suppress (strict >); IoU just above does
    boxes = np.array(
        [
            [0, 0, 10, 10],    # kept
            [0, 0, 10, 5],     # IoU 0.5 with box 0 -> kept
            [0, 0, 10, 5.2],   # IoU 0.52 with box 0 -> suppressed
            [50, 50, 60, 60],  # kept (equal score to box 4: stable order)
            [50, 50, 60, 60],  # duplicate, same score -> suppressed
            [0, 0, 1, 1],      # padding row (-inf score)
        ],
        np.float32,
    )
    scores = np.array([0.9, 0.8, 0.7, 0.6, 0.6, -np.inf], np.float32)
    want = np.asarray(jax_nms.nms_mask(jnp.asarray(boxes), jnp.asarray(scores), 0.5))
    got = port_nms.nms_mask(torch.from_numpy(boxes), torch.from_numpy(scores), 0.5).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [True, True, False, True, False, False])


def test_batched_nms_matches_jax(rng):
    n = 400
    boxes = _clustered(rng, n)
    scores = rng.uniform(0, 1, n).astype(np.float32)
    labels = rng.integers(1, 6, n).astype(np.int32)
    valid = rng.uniform(size=n) > 0.1
    want = np.asarray(jax_nms.batched_nms_mask(
        jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(labels), 0.5,
        valid=jnp.asarray(valid),
    ))
    got = port_nms.batched_nms_mask(
        torch.from_numpy(boxes), torch.from_numpy(scores), torch.from_numpy(labels), 0.5,
        valid=torch.from_numpy(valid),
    ).numpy()
    np.testing.assert_array_equal(got, want)


def test_nms_batch_equals_per_problem_and_counts_syncs(rng):
    g, n = 5, 200
    boxes = np.stack([_clustered(rng, n) for _ in range(g)])
    scores = rng.uniform(0, 1, (g, n)).astype(np.float32)
    before = port_nms.nms_mask.host_syncs
    batched = port_nms.nms_mask(torch.from_numpy(boxes), torch.from_numpy(scores), 0.7)
    syncs = port_nms.nms_mask.host_syncs - before
    assert 1 <= syncs <= n
    for i in range(g):
        one = port_nms.nms_mask(
            torch.from_numpy(boxes[i]), torch.from_numpy(scores[i]), 0.7
        )
        np.testing.assert_array_equal(batched[i].numpy(), one.numpy())


def test_config_defaults_match_jax():
    port_budget = dataclasses.asdict(port_config.DetectionBudget())
    jax_budget = JaxBudget().model_dump()
    for key, value in port_budget.items():
        want = jax_budget[key]
        assert (tuple(want) if isinstance(want, (list, tuple)) else want) == value, key
    jax_model = LayoutDitConfig().detection_model_config.model_dump()
    for f in dataclasses.fields(port_config.ModelConfig):
        if f.name == "detection_budget":
            continue
        want = jax_model[f.name]
        got = getattr(port_config.ModelConfig(), f.name)
        if isinstance(want, list):  # lists of rows (anchor_sizes) or of ints (levels)
            want = tuple(tuple(w) if isinstance(w, (list, tuple)) else w for w in want)
        assert got == want, f.name


def test_load_serving_config(tmp_path):
    path = os.path.join(REPO, "configs", "serving_1024.json")
    mc, dl = port_config.load_config(path)
    with open(path) as f:
        raw = json.load(f)
    jax_cfg = LayoutDitConfig(**raw)
    assert mc.image_size == jax_cfg.detection_model_config.image_size == 1024
    assert mc.detection_budget.rpn_post_nms_top_n_test == 512
    assert mc.detection_budget.rpn_pre_nms_top_n_test == 1000
    assert dl.batch_size == jax_cfg.data_loader_config.batch_size == 4

    bad = tmp_path / "bad.json"
    # the mask and cascade modifiers, RetinaNet, FCOS and DETR are ported
    bad.write_text(json.dumps({"detection_model_config": {"with_mask": True}}))
    assert port_config.load_config(str(bad))[0].with_mask
    bad.write_text(json.dumps({"detection_model_config": {"detector": "fcos"}}))
    assert port_config.load_config(str(bad))[0].detector == "fcos"
    bad.write_text(json.dumps({"detection_model_config": {"detector": "detr",
                                                          "detr_shared_matching": True}}))
    mc = port_config.load_config(str(bad))[0]
    assert mc.detector == "detr" and mc.detr_shared_matching
    # windows are ported: the field loads
    bad.write_text(json.dumps({"detection_model_config": {"window_size": 16}}))
    assert port_config.load_config(str(bad))[0].window_size == 16
    # dit-large is ported; resnet50 waits
    bad.write_text(json.dumps({"detection_model_config": {"backbone_type": "dit-large"}}))
    assert port_config.load_config(str(bad))[0].backbone_type == "dit-large"
    bad.write_text(json.dumps({"detection_model_config": {"backbone_type": "resnet50"}}))
    with pytest.raises(ValueError, match="resnet50.*queue 1 item 6"):
        port_config.load_config(str(bad))
