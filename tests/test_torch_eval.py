"""The ported evaluation vs the JAX package on the CPU: ``CocoEvaluator``
on random ground truth and predictions (both float64 numpy, so equal to
1e-12), the vectorised matcher against its scalar oracle,
``Evaluator.score()`` on JAX-carried weights against JAX's
``Evaluator.score()``, and the overlays; plus the flagship convergence
recipe through the port (marked ``slow``)."""

import json
import os
import tempfile

import jax
import numpy as np
import pytest
import torch

from layoutdit_tpu.config.constructs import LayoutDitConfig
from layoutdit_tpu.eval.coco_eval import CocoEvaluator as JaxCocoEvaluator
from layoutdit_tpu_torch.config import load_run_config
from layoutdit_tpu_torch.eval import coco_eval
from layoutdit_tpu_torch.eval.coco_eval import COCO_KEYS, CocoEvaluator
from layoutdit_tpu_torch.eval.evaluator import Evaluator
from layoutdit_tpu_torch.models.model import build_model
from layoutdit_tpu_torch.models.weights_io import params_from_jax, tree_leaves
from layoutdit_tpu_torch.tools import convergence
from layoutdit_tpu_torch.tools.make_fixture import make_fixture, write_fixture_config
from test_torch_detector import _assert_same_detections

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

COCO_TOL = 1e-12  # both evaluators are float64 numpy
METRIC_TOL = 1e-4  # Evaluator.score(): JAX and the port's float32 detections
CATS = [{"id": 1, "name": "text"}, {"id": 3, "name": "title"}, {"id": 7, "name": "figure"}]


# ------------------------------------------------------------ CocoEvaluator


def _random_coco(rng, n_images=6):
    """Random GT over three categories and all three area ranges (crowd
    boxes among them, 'area' sometimes absent, the last image with no
    GT), and predictions: jittered copies of the GT, exact duplicates,
    random boxes, a prediction on the empty image and one of an unknown
    category."""
    images = [{"id": i + 1, "width": 400, "height": 400, "file_name": f"{i + 1}.jpg"}
              for i in range(n_images)]
    anns, preds = [], []
    for img in images[:-1]:
        for _ in range(int(rng.integers(2, 9))):
            side = float(rng.choice([12.0, 50.0, 150.0])) * rng.uniform(0.6, 1.4, 2)
            xy = rng.uniform(0, 400 - side)
            bbox = [float(xy[0]), float(xy[1]), float(side[0]), float(side[1])]
            ann = {"id": len(anns) + 1, "image_id": img["id"],
                   "category_id": int(rng.choice([1, 3, 7])), "bbox": bbox,
                   "iscrowd": int(rng.uniform() < 0.1)}
            if rng.uniform() < 0.8:
                ann["area"] = bbox[2] * bbox[3]
            anns.append(ann)
            if rng.uniform() < 0.75:
                jit = rng.normal(0, 0.08 * side.min(), 4)
                p = {"image_id": img["id"], "category_id": ann["category_id"],
                     "bbox": [bbox[0] + jit[0], bbox[1] + jit[1], max(1.0, bbox[2] + jit[2]),
                              max(1.0, bbox[3] + jit[3])],
                     "score": float(rng.uniform())}
                preds.append(p)
                if rng.uniform() < 0.2:  # a duplicate, lower score
                    preds.append({**p, "score": p["score"] * 0.5})
        for _ in range(int(rng.integers(0, 4))):
            preds.append({"image_id": img["id"], "category_id": int(rng.choice([1, 3, 7])),
                          "bbox": [float(v) for v in rng.uniform(0, 200, 4)],
                          "score": round(float(rng.uniform()), 1)})  # ties
    preds.append({"image_id": images[-1]["id"], "category_id": 1,
                  "bbox": [10.0, 10.0, 40.0, 40.0], "score": 0.9})
    preds.append({"image_id": 1, "category_id": 99, "bbox": [0.0, 0.0, 5.0, 5.0], "score": 0.5})
    return {"images": images, "annotations": anns, "categories": CATS}, preds


def _assert_metrics_equal(got: dict, want: dict, tol: float) -> None:
    assert list(got) == list(want)
    for k, w in want.items():
        assert abs(got[k] - w) <= tol, (k, got[k], w)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("no_predictions", [False, True])
def test_coco_evaluator_matches_jax(seed, no_predictions):
    coco, preds = _random_coco(np.random.default_rng(seed))
    if no_predictions:
        preds = []
    got = CocoEvaluator(coco).evaluate(preds, per_category=True)
    want = JaxCocoEvaluator(coco).evaluate(preds, per_category=True)
    assert set(COCO_KEYS) <= set(got)
    assert {f"AP50-{c['name']}" for c in CATS} <= set(got)
    _assert_metrics_equal(got, want, COCO_TOL)
    if not no_predictions:
        assert got["mAP"] > 0 and got["AP_s"] != -1 and got["AP_l"] != -1


def test_coco_evaluator_refuses_segm():
    coco, _ = _random_coco(np.random.default_rng(0))
    with pytest.raises(ValueError, match="mask head"):
        CocoEvaluator(coco, iou_type="segm")
    with pytest.raises(ValueError, match="bbox"):
        CocoEvaluator(coco, iou_type="keypoints")


def _random_pair(rng, n_gt, n_dt):
    """Boxes on a coarse grid, so overlaps (and exact IoU ties) are common;
    crowd GT; quantised scores, so the stable sorts see ties."""
    def boxes(n):
        xy = rng.integers(0, 6, (n, 2)) * 10.0
        wh = rng.integers(1, 5, (n, 2)) * 10.0
        return np.concatenate([xy, wh], axis=1)

    gt = [{"id": i + 1, "bbox": list(b), "area": b[2] * b[3],
           "iscrowd": int(rng.uniform() < 0.15)} for i, b in enumerate(boxes(n_gt))]
    dt = [{"bbox": list(b), "score": round(float(rng.uniform()), 1)} for b in boxes(n_dt)]
    return gt, dt


@pytest.mark.parametrize("seed", [0, 1])
def test_vectorized_matcher_matches_scalar_oracle(seed):
    rng = np.random.default_rng(seed)
    shapes = [(0, 5), (5, 0), (1, 1), (4, 8), (12, 25), (30, 130), (0, 0)]
    cases = [_random_pair(rng, g, d) for g, d in shapes for _ in range(6)]
    pairs = [coco_eval._Pair(gt, dt, max_det=100) for gt, dt in cases]
    for area, rng_range in coco_eval.AREA_RNGS.items():
        for (gt, dt), got in zip(cases, CocoEvaluator._match_pairs(pairs, rng_range)):
            want = CocoEvaluator._match_img_ref(gt, dt, rng_range, 100)
            for k in ("dtm", "dt_ig", "scores"):
                np.testing.assert_array_equal(got[k], want[k], err_msg=f"{k} {area}")
            assert got["n_gt"] == want["n_gt"]


# --------------------------------------------------------------- Evaluator


@pytest.fixture(scope="module")
def scored(tmp_path_factory):
    """The tiny detector on an 8-page fixture, scored by both evaluators.
    Random JAX weights, with random position embeddings (zero at init)
    and a larger box-predictor scale: the pages' uniform regions would
    otherwise give anchors a few pixels apart scores equal to float32
    rounding, and NMS would keep either one."""
    from layoutdit_tpu.eval.evaluator import Evaluator as JaxEvaluator
    from layoutdit_tpu.models.model import build_model as jax_build_model

    root = str(tmp_path_factory.mktemp("eval_fixture"))
    make_fixture(root, n_images=8, split="samples", seed=5)
    path = write_fixture_config(root, epochs=1, batch_size=3, tiny_model=True)
    with open(path) as f:
        raw = json.load(f)
    raw["eval_config"].update(num_images=3, max_per_image=4)
    runs = {}
    for side in ("jax", "port"):
        raw["eval_config"]["eval_base_path"] = os.path.join(root, side)
        with open(path, "w") as f:
            json.dump(raw, f)
        runs[side] = path if side == "port" else LayoutDitConfig(**raw)
    rc = load_run_config(runs["port"])

    jmodel = jax_build_model(runs["jax"], seed=0, warm_start=False)
    gen = np.random.default_rng(0)
    vit = jmodel.params["backbone"]["vit"]
    vit["pos_embed"] = jax.numpy.asarray(gen.normal(0, 0.02, vit["pos_embed"].shape), np.float32)
    pred = jmodel.params["box_predictor"]["cls"]
    pred["kernel"] = jax.numpy.asarray(gen.normal(0, 0.1, pred["kernel"].shape), np.float32)
    pmodel = build_model(rc, device="cpu")
    carried = params_from_jax(jax.tree_util.tree_map(np.asarray, jmodel.params))
    with torch.no_grad():
        for dst, src in zip(tree_leaves(pmodel.params), tree_leaves(carried), strict=True):
            dst.copy_(src)
    want = JaxEvaluator(model=jmodel, layout_dit_config=runs["jax"]).score()
    evaluator = Evaluator(pmodel, rc, device="cpu")
    got = evaluator.score()
    return {"root": root, "rc": rc, "evaluator": evaluator, "got": got, "want": want,
            "jax_dir": os.path.join(root, "jax", "fixture"),
            "port_dir": os.path.join(root, "port", "fixture")}


def _by_image(path):
    with open(path) as f:
        preds = json.load(f)
    out = {}
    for p in preds:
        out.setdefault(p["image_id"], []).append(p)
    return preds, out


def test_evaluator_score_matches_jax(scored):
    jax_preds, jax_by = _by_image(os.path.join(scored["jax_dir"], "predictions.json"))
    port_preds, port_by = _by_image(os.path.join(scored["port_dir"], "predictions.json"))
    assert len(port_preds) == len(jax_preds) > 0
    assert {tuple(sorted(p)) for p in port_preds} == {tuple(sorted(p)) for p in jax_preds}
    assert set(port_by) == set(jax_by)

    def unpack(preds):
        xywh = np.array([p["bbox"] for p in preds], np.float64)
        xyxy = np.concatenate([xywh[:, :2], xywh[:, :2] + xywh[:, 2:]], axis=1)
        return (xyxy, np.array([p["score"] for p in preds]),
                np.array([p["category_id"] for p in preds]))

    for img_id, jp in jax_by.items():
        _assert_same_detections(*unpack(jp), *unpack(port_by[img_id]))
    _assert_metrics_equal(scored["got"], scored["want"], METRIC_TOL)
    assert set(COCO_KEYS) <= set(scored["got"])


@pytest.mark.parametrize("kind", ["preds", "gt"])
def test_visualizations_written(scored, kind):
    from PIL import Image

    ev = scored["evaluator"]
    getattr(ev, f"visualize_{kind}")()
    out_dir = ev.visualization_preds_path if kind == "preds" else ev.visualization_gt_path
    assert out_dir == os.path.join(scored["port_dir"], f"visualizations_{kind}") + "/"
    files = sorted(os.listdir(out_dir))
    # num_images=3 caps the 8 pages, in file order
    assert files == ["1.jpg", "2.jpg", "3.jpg"]
    page = os.path.join(scored["root"], "samples", "page_0000.jpg")
    with Image.open(page) as im:
        original = np.asarray(im.convert("RGB"), np.int16)
    with Image.open(os.path.join(out_dir, "1.jpg")) as im:
        drawn = np.asarray(im.convert("RGB"), np.int16)
    assert drawn.shape == original.shape
    red = (drawn[..., 0] - drawn[..., 1] > 100) & (drawn[..., 0] - drawn[..., 2] > 100)
    green = (drawn[..., 1] - drawn[..., 0] > 60) & (drawn[..., 1] - drawn[..., 2] > 60)
    assert (red if kind == "preds" else green).sum() > 50


def test_score_threshold_follows_jax_rule(scored):
    """``score_thresh`` keeps scores >= it (and > 0 when it is above 0)."""
    import dataclasses

    rc = scored["rc"]
    ev = scored["evaluator"]
    all_preds = ev.predictions()
    thresh = float(np.median([p["score"] for p in all_preds]))
    strict = Evaluator(ev.model, dataclasses.replace(
        rc, eval=dataclasses.replace(rc.eval, score_thresh=thresh)), device="cpu")
    kept = strict.predictions()
    assert kept == [p for p in all_preds if p["score"] >= thresh]


# ------------------------------------------------------- convergence recipe


@pytest.mark.slow
def test_recipe_converges_float32():
    """The counterpart of tests/test_convergence.py::
    test_synthetic_fixture_multiepoch_convergence through the port, on
    the CPU's plain path in float32: the same recipe and floors."""
    with tempfile.TemporaryDirectory() as root:
        result = convergence.run_recipe(root, "float32", device="cpu")
    assert not convergence.floor_failures(result), result
