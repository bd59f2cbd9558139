"""The ported serving path vs the JAX package on the same weights and
inputs (CPU, float32, tiny widths): parameter bridge, encoder and
backbone, detector_predict + rescale_detections, the bucketed engine;
and the port's isolation from JAX and layoutdit_tpu."""

import ast
import dataclasses
import io
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from layoutdit_tpu.config.constructs import DetectionBudget as JaxBudget
from layoutdit_tpu.eval.serving import BatchInferenceEngine as JaxEngine
from layoutdit_tpu.models import backbone as jax_backbone
from layoutdit_tpu.models import vit as jax_vit
from layoutdit_tpu.models.detection import detector as jax_det
from layoutdit_tpu.models.detection import heads as jax_heads
from layoutdit_tpu.models.detection import rpn as jax_rpn
from layoutdit_tpu_torch.config import DetectionBudget
from layoutdit_tpu_torch.eval.serving import BatchInferenceEngine
from layoutdit_tpu_torch.models import backbone as port_backbone
from layoutdit_tpu_torch.models import vit as port_vit
from layoutdit_tpu_torch.models.detection import detector as port_det
from layoutdit_tpu_torch.models.detection import heads as port_heads
from layoutdit_tpu_torch.models.detection import rpn as port_rpn
from layoutdit_tpu_torch.models.weights_io import params_from_jax

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
VIT = dict(hidden_size=64, num_hidden_layers=4, num_attention_heads=4,
           intermediate_size=128, image_size=64)
BUDGET = dict(rpn_pre_nms_top_n_test=200, rpn_post_nms_top_n_test=100,
              box_detections_per_img=20)
BOX_TOL = 1e-3
SCORE_TOL = 1e-4


class _Model:
    def __init__(self, params, cfg):
        self.params, self.cfg = params, cfg


@pytest.fixture(scope="module")
def models():
    jcfg = jax_det.DetectorConfig(
        backbone=jax_backbone.BackboneConfig(vit=jax_vit.ViTConfig(**VIT), fpn_out_channels=32),
        image_size=64, budget=JaxBudget(**BUDGET),
    )
    pcfg = port_det.DetectorConfig(
        backbone=port_backbone.BackboneConfig(vit=port_vit.ViTConfig(**VIT), fpn_out_channels=32),
        image_size=64, budget=DetectionBudget(**BUDGET),
    )
    jparams = jax.jit(jax_det.init_detector_params, static_argnums=1)(
        jax.random.PRNGKey(0), jcfg
    )
    # random (not zero) position embeddings, so their resampling counts
    jparams["backbone"]["vit"]["pos_embed"] = 0.02 * jax.random.normal(
        jax.random.PRNGKey(1), jparams["backbone"]["vit"]["pos_embed"].shape
    )
    pparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
    return _Model(jparams, jcfg), port_det.DetectorModel(pparams, pcfg)


def _images(seed, size, b=2):
    return np.random.default_rng(seed).uniform(0, 1, (b, 3, size, size)).astype(np.float32)


def _assert_same_detections(jb, js, jl, tb, ts, tl):
    """Valid detections of one image as matched sets (label, box, score)."""
    assert len(jb) == len(tb)
    used = np.zeros(len(tb), bool)
    for box, score, label in zip(jb, js, jl):
        cand = np.nonzero(
            (tl == label) & ~used & (np.abs(tb - box).max(axis=1) <= BOX_TOL)
            & (np.abs(ts - score) <= SCORE_TOL)
        )[0]
        assert len(cand), f"no match for label {label} box {box} score {score}"
        used[cand[0]] = True


def test_params_from_jax(models, rng):
    jm, pm = models
    layer = pm.params["backbone"]["vit"]["layers"][0]
    assert layer["qkv"]["weight"].shape == (3 * 64, 64)
    assert not layer["qkv"]["bias"][64:128].any()  # BEiT K has no bias
    fc6 = pm.params["box_head"]["fc6"]["weight"]
    assert fc6.shape == (1024, 7 * 7 * 32)
    # fc6 contracts the native pooled layout [K, Px, Py, C] identically
    pooled = rng.standard_normal((9, 7, 7, 32)).astype(np.float32)
    want = jax_heads.box_head_forward(jm.params["box_head"], jnp.asarray(pooled))
    got = port_heads.box_head_forward(pm.params["box_head"], torch.from_numpy(pooled))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("size", [64, 128])
def test_vit_and_backbone_match_jax(models, size):
    jm, pm = models
    x = _images(1, size)
    taps = (0, 1, 2, 4)
    want = jax_vit.vit_forward(jm.params["backbone"]["vit"], jnp.asarray(x),
                               jm.cfg.backbone.vit, taps=taps)
    got = port_vit.vit_forward(pm.params["backbone"]["vit"], torch.from_numpy(x),
                               pm.cfg.backbone.vit, taps=taps)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=1e-4)

    want = jax_backbone.backbone_forward(jm.params["backbone"], jnp.asarray(x), jm.cfg.backbone)
    got = port_backbone.backbone_forward(pm.params["backbone"], torch.from_numpy(x),
                                         pm.cfg.backbone)
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    # five levels in channels-last memory, the layout the RoIAlign kernels read
    assert len(got) == 5 and all(g.stride(1) == 1 for g in got)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("size", [64, 128])
def test_detector_predict_matches_jax(models, size):
    jm, pm = models
    jcfg = dataclasses.replace(jm.cfg, image_size=size)
    pcfg = dataclasses.replace(pm.cfg, image_size=size)
    x = _images(2, size)
    orig = np.array([[90.0, 70.0], [size, 1.5 * size]], np.float32)

    def jax_stages(params, images):
        feats, obj, dl = jax_det._run_trunk(params, images, jcfg)
        anchors, counts = jax_det._anchors(jcfg)
        props = jax_rpn.filter_proposals(obj, dl, anchors, counts, (size, size),
                                          jcfg.budget, training=False)
        logits, _ = jax_det._pool_and_predict(
            jax_det._base_head(params), feats, props.boxes, props.valid, jcfg
        )
        dets = jax_det.rescale_detections(
            jax_det.detector_predict(params, images, jcfg), jnp.asarray(orig), size
        )
        return props, logits, dets

    props_j, want_logits, want = jax.tree_util.tree_map(
        np.asarray, jax.jit(jax_stages)(jm.params, jnp.asarray(x))
    )

    # proposals
    xt = port_det._normalize(torch.from_numpy(x), pcfg)
    feats_t = port_backbone.backbone_forward(pm.params["backbone"], xt, pcfg.backbone)
    obj_t, dl_t = port_heads.rpn_head_forward(pm.params["rpn_head"], feats_t, 3)
    anchors_t, counts = port_det._anchors(pcfg, torch.device("cpu"))
    props_t = port_rpn.filter_proposals(obj_t, dl_t, anchors_t, counts, (size, size), pcfg.budget)
    for i in range(2):
        jv, tv = props_j.valid[i], props_t.valid[i].numpy()
        _assert_same_detections(
            props_j.boxes[i][jv], props_j.scores[i][jv], np.zeros(jv.sum()),
            props_t.boxes[i].numpy()[tv], props_t.scores[i].numpy()[tv], np.zeros(tv.sum()),
        )

    # class logits on the same (JAX) proposals
    pooled = port_det.multiscale_roi_align(
        feats_t, torch.from_numpy(props_j.boxes.copy()),
        list(pcfg.backbone.spatial_scales), canonical_scale=float(size),
        roi_mask=torch.from_numpy(props_j.valid.copy()), native_layout=True,
    )
    rep = port_heads.box_head_forward(pm.params["box_head"], pooled.flatten(0, 1))
    logits, _ = port_heads.predictor_forward(pm.params["box_predictor"], rep)
    np.testing.assert_allclose(
        logits.reshape(want_logits.shape).numpy(), want_logits, atol=1e-4, rtol=1e-4
    )

    # detections end to end, rescaled to page coordinates
    got = port_det.rescale_detections(
        port_det.detector_predict(pm.params, torch.from_numpy(x), pcfg),
        torch.from_numpy(orig), size,
    )
    assert got.boxes.shape == want.boxes.shape
    for i in range(2):
        jv, tv = np.asarray(want.valid[i]), got.valid[i].numpy()
        assert jv.sum() > 0
        _assert_same_detections(
            np.asarray(want.boxes[i])[jv], np.asarray(want.scores[i])[jv],
            np.asarray(want.labels[i])[jv], got.boxes[i].numpy()[tv],
            got.scores[i].numpy()[tv], got.labels[i].numpy()[tv],
        )


def test_engine_two_buckets_matches_jax(models):
    jm, pm = models
    rng = np.random.default_rng(4)
    pages = [rng.integers(0, 256, (60, 50, 3), dtype=np.uint8) for _ in range(3)]
    pages += [rng.integers(0, 256, (120, 100, 3), dtype=np.uint8) for _ in range(2)]
    kw = dict(image_sizes=(64, 128), batch_size=2, score_thresh=0.0)
    got = BatchInferenceEngine(pm, device="cpu", **kw).predict_pages(pages)
    want = JaxEngine(jm, **kw).predict_pages([p.astype(np.float32) for p in pages])
    assert len(got) == len(want) == 5
    for (h, w), g, r in zip([(60, 50)] * 3 + [(120, 100)] * 2, got, want):
        assert len(g.boxes) > 0
        assert np.isfinite(g.boxes).all()
        assert g.boxes[:, 2].max() <= w + 1e-3 and g.boxes[:, 3].max() <= h + 1e-3
        _assert_same_detections(r.boxes, r.scores, r.labels, g.boxes, g.scores, g.labels)


def test_engine_page_decode_matches_jax(models):
    from PIL import Image

    jm, pm = models
    rng = np.random.default_rng(7)
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (90, 70, 3), dtype=np.uint8)).save(buf, format="JPEG")
    pages = [
        rng.integers(0, 256, (60, 50, 3), dtype=np.uint8),  # uint8 HWC
        rng.uniform(0, 1, (3, 40, 64)).astype(np.float32),  # float CHW in [0, 1]
        rng.uniform(0, 255, (64, 33)).astype(np.float32),  # grayscale in [0, 255]
        buf.getvalue(),  # JPEG bytes
        b"not a jpeg",  # fails to decode: zero image, invalid slot
    ]
    engine = BatchInferenceEngine(pm, image_sizes=(64,), batch_size=6, device="cpu")
    images, orig = engine._upload_batch([engine._decode_page(p) for p in pages], 64)
    want_images, want_orig = JaxEngine(jm, image_sizes=(64,), batch_size=6)._decode_padded(
        pages, 64
    )
    np.testing.assert_array_equal(orig, want_orig)
    np.testing.assert_allclose(images.numpy(), want_images, atol=1e-6)


def test_engine_refuses_cuda_without_gpu(models, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchInferenceEngine(models[1], device="cuda")


def _port_sources():
    return sorted((REPO / "layoutdit_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_port_imports_neither_jax_nor_layoutdit_tpu():
    # msgpack too: the port reads and writes flax's format with its own
    # codec; and orbax's stack: it reads JAX's .orbax directories itself
    banned = {"jax", "jaxlib", "flax", "optax", "layoutdit_tpu", "msgpack", "orbax",
              "tensorstore", "zstandard"}
    found = []
    for path in _port_sources():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            found += [f"{path.name}: {n}" for n in names if n.split(".")[0] in banned]
    assert not found, found


def test_port_imports_with_jax_blocked():
    # the port must import on a machine without JAX, pydantic, PIL, msgpack
    # or fsspec (fsspec is imported only for a scheme:// path)
    code = (
        "import importlib, pkgutil, sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'layoutdit_tpu',\n"
        "                                  'pydantic', 'PIL', 'msgpack', 'fsspec', 'orbax',\n"
        "                                  'tensorstore', 'zstandard'):\n"
        "            raise ImportError('blocked ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import layoutdit_tpu_torch\n"
        "for m in pkgutil.walk_packages(layoutdit_tpu_torch.__path__, 'layoutdit_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "print('imported', len(sys.modules))\n"
        # and runs: a windowed encoder (layer 1: padded 4 x 4 windows and
        # the CLS token; layer 2: global over 290 tokens, the flash route)
        # forward and backward on the CPU
        "import torch\n"
        "from layoutdit_tpu_torch.models import vit, weights_io\n"
        "cfg = vit.ViTConfig(hidden_size=32, num_hidden_layers=2, num_attention_heads=2,\n"
        "                    intermediate_size=64, image_size=272, window_size=4,\n"
        "                    global_attn_layers=(2,))\n"
        "p = vit.init_vit_params(cfg, torch.Generator().manual_seed(0), 'cpu')\n"
        "leaves = weights_io.tree_leaves(p)\n"
        "for t in leaves:\n"
        "    t.requires_grad_(True)\n"
        "(out,) = vit.vit_forward(p, torch.randn(1, 3, 272, 272), cfg)\n"
        "assert out.shape == (1, 290, 32)\n"
        "out.square().sum().backward()\n"
        "assert all(t.grad is not None and torch.isfinite(t.grad).all() for t in leaves)\n"
        "print('trained')\n"
    )
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "imported" in out.stdout and "trained" in out.stdout
