"""The ResNet-50 + FPN backbone in the port (``models/resnet.py`` and the
``backbone_kind`` branch of ``models/detection/detector.py``) against the
JAX package's ``models/resnet.py`` on the CPU, float32, at 64 px.

Tolerances: the trunk's taps C2-C5 and the FPN pyramid 1e-4 (rtol and
atol) in float64, and in float32 within 1.5x JAX's own float32 error
against float64; the torchvision-key importer exact; a tiny-head ResNet detector's
losses 1e-4, every gradient leaf 1e-3 relative Frobenius, one AdamW
update 1e-5 (BN statistics included: JAX trains them as weights), its
detections as ``tests/test_torch_detector.py`` matches them (boxes 1e-3,
scores 1e-4)."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from layoutdit_tpu.config.constructs import ModelConfig as JaxModelConfig
from layoutdit_tpu.models import fpn as jax_fpn
from layoutdit_tpu.models import resnet as jax_resnet
from layoutdit_tpu.models.detection import detector as jax_det
from layoutdit_tpu_torch.config import run_config_from_dict
from layoutdit_tpu_torch.models import resnet as port_resnet
from layoutdit_tpu_torch.models.detection import detector as port_det
from layoutdit_tpu_torch.models.weights_io import (
    _resnet_to_jax,
    params_from_jax,
    params_to_jax,
    tree_leaves,
    tree_map,
    tree_paths,
)
from test_torch_detector import _assert_same_detections
from test_torch_train import fixture_dir  # noqa: F401

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

TOL = 1e-4
MODEL = dict(backbone_type="resnet50", num_classes=5, image_size=64, fpn_out_channels=32,
             detection_budget={"rpn_pre_nms_top_n_train": 200, "rpn_pre_nms_top_n_test": 100,
                               "rpn_post_nms_top_n_train": 100, "rpn_post_nms_top_n_test": 100,
                               "box_batch_size_per_image": 32, "box_detections_per_img": 20,
                               "box_score_thresh": 0.0})


def _calibrated(tree, seed=1):
    """The trunk with BN statistics as a trained network has them: each
    BN's ``mean`` / ``var`` its input's batch statistics over a
    calibration batch (JAX's forward, layer by layer), its affine drawn
    near identity, but a residual branch's last BN (``bn3``) at a fifth
    of that, as trained ResNets' are small; the activations then stay
    O(1) through the 16 blocks, as in a pretrained ResNet-50."""
    rng = np.random.default_rng(seed)
    tree = jax.tree_util.tree_map(np.array, tree)

    def bn(y, p, gain=1.0):
        y = np.asarray(y)
        p["mean"] = y.mean((0, 2, 3)).astype(np.float32)
        p["var"] = y.var((0, 2, 3)).astype(np.float32)
        p["weight"] = (gain * rng.uniform(0.5, 1.5, p["weight"].shape)).astype(np.float32)
        p["bias"] = (0.1 * rng.standard_normal(p["bias"].shape)).astype(np.float32)
        return jax_resnet._frozen_bn(jnp.asarray(y), p)

    conv = jax_resnet._conv
    x = jnp.asarray(rng.standard_normal((4, 3, 64, 64)).astype(np.float32))
    x = jax.nn.relu(bn(conv(x, tree["stem"]["conv"], stride=2, padding=3), tree["stem"]["bn"]))
    x = jax.lax.reduce_window(x, -jnp.inf, jax.lax.max, (1, 1, 3, 3), (1, 1, 2, 2),
                              ((0, 0), (0, 0), (1, 1), (1, 1)))
    for si, stage in enumerate(tree["stages"]):
        for bi, p in enumerate(stage):
            stride = 2 if (bi == 0 and si > 0) else 1
            out = jax.nn.relu(bn(conv(x, p["conv1"]), p["bn1"]))
            out = jax.nn.relu(bn(conv(out, p["conv2"], stride=stride, padding=1), p["bn2"]))
            out = bn(conv(out, p["conv3"]), p["bn3"], gain=0.2)
            if "downsample" in p:
                x = bn(conv(x, p["downsample"]["conv"], stride=stride), p["downsample"]["bn"])
            x = jax.nn.relu(out + x)
    return tree


@pytest.fixture(scope="module")
def models():
    mc = dict(MODEL)
    jcfg = jax_det.DetectorConfig.from_model_config(JaxModelConfig(**mc))
    pcfg = port_det.DetectorConfig.from_model_config(
        run_config_from_dict({"detection_model_config": mc}).model)
    assert (jcfg.backbone_kind, pcfg.backbone_kind) == ("resnet50", "resnet50")
    jparams = jax.jit(jax_det.init_detector_params, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    jparams = jax.tree_util.tree_map(np.asarray, jparams)
    jparams["backbone"]["resnet"] = _calibrated(jparams["backbone"]["resnet"])
    return jparams, jcfg, pcfg


def _images(seed=0, b=2, size=64):
    return np.random.default_rng(seed).uniform(0, 1, (b, 3, size, size)).astype(np.float32)


@jax.jit
def _trunk_and_pyramid(tree, x):
    """JAX's C2-C5 and ``resnet_fpn_forward``'s pyramid over them, jitted."""
    taps = jax_resnet.resnet50_forward(tree["resnet"], x)
    return list(taps) + list(jax_fpn.fpn_forward(tree["fpn"], taps, extra_max_pool=True))


def test_taps_and_pyramid_match_jax(models):
    """The function: the taps C2-C5 and the pyramid against JAX's in
    float64 at 1e-4. In float32 both packages carry the rounding of 53
    convolutions (about 1e-3 at C5's scale, against float64, either way);
    there the port's error against JAX's float64 result is held within
    1.5x JAX's own. The pyramid comes out channels-last."""
    jparams, _, _ = models
    params = params_from_jax(jparams)
    assert "resnet" in params["backbone"] and "vit" not in params["backbone"]
    x = np.random.default_rng(2).standard_normal((2, 3, 64, 64)).astype(np.float32)
    with jax.enable_x64(True):
        tree64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), jparams["backbone"])
        want = [np.asarray(t) for t in _trunk_and_pyramid(tree64, jnp.asarray(x, jnp.float64))]
    x64 = torch.from_numpy(x).double()
    p64 = tree_map(lambda t: t.double(), params["backbone"])
    got = port_resnet.resnet50_forward(p64["resnet"], x64)
    assert [tuple(t.shape) for t in got] == [(2, 256, 16, 16), (2, 512, 8, 8), (2, 1024, 4, 4),
                                             (2, 2048, 2, 2)]
    got += port_resnet.resnet_fpn_forward(p64, x64, compute_dtype=torch.float64)
    assert len(got) == 9
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=TOL, atol=TOL)
    jax32 = _trunk_and_pyramid(jparams["backbone"], jnp.asarray(x))
    x32 = torch.from_numpy(x)
    got32 = port_resnet.resnet50_forward(params["backbone"]["resnet"], x32)
    got32 += port_resnet.resnet_fpn_forward(params["backbone"], x32)
    for g, j, w in zip(got32, jax32, want):
        assert g.dtype == torch.float32 and g.stride(1) == 1  # channels-last
        assert np.abs(g.numpy() - w).max() <= 1.5 * np.abs(np.asarray(j) - w).max() + 1e-6
    bf = port_resnet.resnet_fpn_forward(params["backbone"], x32, compute_dtype=torch.bfloat16)
    assert all(t.dtype == torch.bfloat16 and t.stride(1) == 1 for t in bf)


def test_carrier_round_trip(models):
    jparams, _, pcfg = models
    params = params_from_jax(jparams)
    template = port_det.init_detector(pcfg, torch.Generator(), "cpu")
    assert tree_paths(params) == tree_paths(template)
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(jparams)[0],
                            jax.tree_util.tree_leaves(params_to_jax(params))):
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=jax.tree_util.keystr(path))


def _torchvision_state_dict(tree):
    """A torchvision ``resnet50`` state_dict facsimile from a JAX trunk."""
    sd = {"conv1.weight": tree["stem"]["conv"]["kernel"]}

    def bn(prefix, p):
        sd.update({prefix + ".weight": p["weight"], prefix + ".bias": p["bias"],
                   prefix + ".running_mean": p["mean"], prefix + ".running_var": p["var"],
                   prefix + ".num_batches_tracked": np.zeros((), np.int64)})

    bn("bn1", tree["stem"]["bn"])
    for si, stage in enumerate(tree["stages"], start=1):
        for bi, block in enumerate(stage):
            pre = f"layer{si}.{bi}"
            for i in (1, 2, 3):
                sd[f"{pre}.conv{i}.weight"] = block[f"conv{i}"]["kernel"]
                bn(f"{pre}.bn{i}", block[f"bn{i}"])
            if "downsample" in block:
                sd[f"{pre}.downsample.0.weight"] = block["downsample"]["conv"]["kernel"]
                bn(f"{pre}.downsample.1", block["downsample"]["bn"])
    sd["fc.weight"], sd["fc.bias"] = np.zeros((1000, 2048), np.float32), np.zeros(1000, np.float32)
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def test_torchvision_importer_matches_jax(models):
    jparams = models[0]
    sd = _torchvision_state_dict(jparams["backbone"]["resnet"])
    want = jax_resnet.resnet50_state_dict_to_params(sd)
    got = port_resnet.resnet50_state_dict_to_params(sd)
    assert tree_paths(got) == tree_paths(params_from_jax(jparams)["backbone"]["resnet"])
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(want)[0],
                            jax.tree_util.tree_leaves(_resnet_to_jax(got))):
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=jax.tree_util.keystr(path))


def test_loss_gradients_and_update_match_jax(models):
    """The resnet detector's ``detector_loss`` against JAX's: the losses
    1e-4; every gradient leaf outside the trunk 1e-3 relative Frobenius,
    the trunk's 53 convolutions' and BN leaves 1e-3 together (per leaf,
    float32 rounding through the trunk reaches a few percent in both
    packages against float64; ``test_trunk_gradients_match_jax_in_float64``
    holds each leaf); one AdamW update 1e-5 on every leaf (in the trunk,
    off the elements whose gradient is within the float32 noise), the BN
    ``mean`` and ``var`` moving as JAX's do."""
    import optax

    from layoutdit_tpu.config.constructs import TrainingConfig as JaxTrainingConfig
    from layoutdit_tpu_torch.config import TrainingConfig
    from layoutdit_tpu_torch.train.optim import AdamW
    from test_torch_train import (
        GRAD_RTOL,
        LOSS_RTOL,
        PARAM_TOL,
        _jax_loss_and_grads,
        _jax_priorities,
        _jax_trainer,
        _rel_frob,
        _t,
    )

    jparams, jcfg, pcfg = models
    rng = np.random.default_rng(3)
    images = rng.uniform(0, 1, (2, 3, 64, 64)).astype(np.float32)
    gt_boxes = np.array([[[5, 5, 30, 40], [20, 10, 60, 50]], [[10, 10, 50, 60], [2, 40, 20, 62]]],
                        np.float32)
    gt_labels = np.array([[1, 3], [2, 4]], np.int32)
    gt_valid = np.ones((2, 2), bool)
    key = jax.random.PRNGKey(7)
    (_, want), jgrads = _jax_loss_and_grads(jcfg)(jparams, key, images, gt_boxes, gt_labels,
                                                  gt_valid)
    params = params_from_jax(jparams)
    leaves = tree_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    n_anchors = sum(h * w for h, w in pcfg.grid_sizes) * pcfg.num_anchors_per_cell
    pri = _jax_priorities(key, 2, n_anchors, pcfg.budget.rpn_post_nms_top_n_train + 2)
    got = port_det.detector_loss(params, _t(images), _t(gt_boxes), _t(gt_labels), _t(gt_valid),
                                 pcfg, pri)
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(float(got[name].detach()), float(want[name]), rtol=LOSS_RTOL,
                                   err_msg=name)
    sum(got.values()).backward()
    grads = params_to_jax(tree_map(lambda t: t.grad, params))
    trunk_g, trunk_w = [], []
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(jgrads)[0],
                            jax.tree_util.tree_leaves(grads)):
        w = np.asarray(w)
        assert g.shape == w.shape
        if "'resnet'" in jax.tree_util.keystr(path):
            trunk_g.append(g.ravel())
            trunk_w.append(w.ravel())
        else:
            assert _rel_frob(g, w) <= GRAD_RTOL, jax.tree_util.keystr(path)
    assert len(trunk_g) == 53 * 5  # 53 convolutions, each with a BN of 4 leaves
    assert _rel_frob(np.concatenate(trunk_g), np.concatenate(trunk_w)) <= GRAD_RTOL

    tc = dict(weight_decay=0.01, grad_clip_norm=1.0)
    tx = _jax_trainer().make_optimizer(JaxTrainingConfig(**tc), steps_per_epoch=4)

    @jax.jit
    def step(p, g):
        updates, _ = tx.update(g, tx.init(p), p)
        return optax.apply_updates(p, updates)

    jnew = jax.tree_util.tree_map(np.asarray, step(jparams, jgrads))
    opt = AdamW(TrainingConfig(**tc), steps_per_epoch=4)
    opt.update(opt.init(leaves), leaves, [t.grad for t in leaves])
    flat_g = jax.tree_util.tree_leaves(jgrads)
    for (path, w), g, jg in zip(jax.tree_util.tree_flatten_with_path(jnew)[0],
                                jax.tree_util.tree_leaves(params_to_jax(params)), flat_g):
        close = np.abs(g - w) <= PARAM_TOL + PARAM_TOL * np.abs(w)
        if "'resnet'" in jax.tree_util.keystr(path):
            # Adam's first step is lr * sign(g) off zero: a trunk element
            # whose gradient sits inside the float32 noise may flip
            jg = np.abs(np.asarray(jg))
            close |= jg <= 1e-3 * jg.max()
        assert close.all(), (jax.tree_util.keystr(path), np.abs(g - w).max())
    bn = params["backbone"]["resnet"]["stages"][1][0]["bn2"]
    old = jparams["backbone"]["resnet"]["stages"][1][0]["bn2"]
    assert not np.array_equal(bn["var"].detach().numpy(), old["var"])
    assert not np.array_equal(bn["mean"].detach().numpy(), old["mean"])


def test_trunk_gradients_match_jax_in_float64(models):
    """Each trunk and FPN leaf's gradient (a random cotangent on every
    pyramid level) against JAX's, both in float64: 1e-6 relative
    Frobenius per leaf."""
    jparams = models[0]
    x = np.random.default_rng(8).uniform(-1, 1, (2, 3, 64, 64))
    shapes = [(2, 32, 16, 16), (2, 32, 8, 8), (2, 32, 4, 4), (2, 32, 2, 2), (2, 32, 1, 1)]
    cots = [np.random.default_rng(i).standard_normal(s) for i, s in enumerate(shapes)]

    def f(p, x):
        out = jax_resnet.resnet_fpn_forward(p, x, compute_dtype=jnp.float64)
        return sum((o * c).sum() for o, c in zip(out, cots))

    with jax.enable_x64(True):
        tree = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), jparams["backbone"])
        want = jax.tree_util.tree_map(np.asarray, jax.jit(jax.grad(f))(tree, jnp.asarray(x)))
    params = tree_map(lambda t: t.double().requires_grad_(True),
                      params_from_jax(jparams)["backbone"])
    out = port_resnet.resnet_fpn_forward(params, torch.from_numpy(x), compute_dtype=torch.float64)
    assert [tuple(o.shape) for o in out] == shapes
    sum((o * torch.from_numpy(c)).sum() for o, c in zip(out, cots)).backward()
    got = tree_map(lambda t: t.grad, params)
    pairs = list(zip(jax.tree_util.tree_leaves(want["resnet"]),
                     jax.tree_util.tree_leaves(_resnet_to_jax(got["resnet"]))))
    pairs += [(w["kernel"], g["weight"]) for part in ("inner", "layer")
              for w, g in zip(want["fpn"][part], got["fpn"][part])]
    pairs += [(w["bias"], g["bias"]) for part in ("inner", "layer")
              for w, g in zip(want["fpn"][part], got["fpn"][part])]
    assert len(pairs) == 53 * 5 + 16
    for w, g in pairs:
        g = np.asarray(g)
        assert np.linalg.norm(g - w) <= 1e-6 * max(np.linalg.norm(w), 1e-30)


def test_predictions_match_jax(models):
    jparams, jcfg, pcfg = models
    images = _images(4)
    want = jax.jit(lambda p, im: jax_det.detector_predict(p, im, jcfg))(jparams,
                                                                       jnp.asarray(images))
    got = port_det.detector_predict(params_from_jax(jparams), torch.from_numpy(images), pcfg)
    for i in range(2):
        jv, tv = np.asarray(want.valid[i]), got.valid[i].numpy()
        assert jv.sum() > 0
        _assert_same_detections(np.asarray(want.boxes[i])[jv], np.asarray(want.scores[i])[jv],
                                np.asarray(want.labels[i])[jv], got.boxes[i].numpy()[tv],
                                got.scores[i].numpy()[tv], got.labels[i].numpy()[tv])


def test_bn_variance_below_zero_stays_finite():
    """JAX trains the BN statistics as weights: one AdamW step (lr 1e-3)
    takes a small ``var`` (1e-5, as pretrained ImageNet statistics have)
    below zero, where JAX's sqrt(var + eps) is NaN. The port clamps ``var``
    at zero inside the root: finite there, the same bits wherever
    ``var`` >= 0."""
    from layoutdit_tpu_torch.config import TrainingConfig
    from layoutdit_tpu_torch.train.optim import AdamW

    var = torch.full((4,), 1e-5, requires_grad=True)
    opt = AdamW(TrainingConfig(learning_rate=1e-3), steps_per_epoch=1)
    state = opt.init([var])
    opt.update(state, [var], [torch.ones(4)])
    assert (var < 0).all()
    x = np.random.default_rng(0).standard_normal((1, 4, 3, 3)).astype(np.float32)
    p = {"weight": np.ones(4, np.float32), "bias": np.zeros(4, np.float32),
         "mean": np.zeros(4, np.float32), "var": var.detach().numpy()}
    assert np.isnan(np.asarray(jax_resnet._frozen_bn(jnp.asarray(x), p))).all()
    tp = {k: torch.from_numpy(np.array(v)) for k, v in p.items()}
    assert torch.isfinite(port_resnet._frozen_bn(torch.from_numpy(x), tp)).all()
    p["var"] = np.array([0.0, 1e-5, 0.5, 2.0], np.float32)
    tp["var"] = torch.from_numpy(p["var"])
    np.testing.assert_array_equal(port_resnet._frozen_bn(torch.from_numpy(x), tp).numpy(),
                                  np.asarray(jax_resnet._frozen_bn(jnp.asarray(x), p)))


def test_resnet_model_trains_scores_serves_and_exports(fixture_dir, tmp_path):  # noqa: F811
    """The tiny fixture config with ``backbone_type: resnet50`` at 64 px:
    ``Trainer`` (the BN statistics move), ``Evaluator.score()``,
    ``BatchInferenceEngine`` (bf16 and int8 alike: int8 quantizes no
    ResNet layer) and an export equal to the live engine."""
    from layoutdit_tpu_torch.eval.evaluator import Evaluator
    from layoutdit_tpu_torch.eval.serving import BatchInferenceEngine
    from layoutdit_tpu_torch.export import ExportedDetector, export_detector
    from layoutdit_tpu_torch.models.model import build_model
    from layoutdit_tpu_torch.train.trainer import Trainer

    with open(os.path.join(fixture_dir, "cfg.json")) as f:
        raw = json.load(f)
    raw["detection_model_config"] = {**MODEL, "detection_budget": {
        **MODEL["detection_budget"], "box_score_thresh": 0.0}}
    raw["eval_config"]["eval_base_path"] = str(tmp_path)
    raw["train_config"].update(tensorboard=False, num_epochs=1)
    rc = run_config_from_dict(raw)
    model = build_model(rc, device="cpu")
    var0 = model.params["backbone"]["resnet"]["stem"]["bn"]["var"].clone()
    trainer = Trainer(rc, model, device="cpu")
    trainer.train()
    assert np.isfinite(trainer.loss_history[0])
    assert not torch.equal(model.params["backbone"]["resnet"]["stem"]["bn"]["var"], var0)
    metrics = Evaluator(model, rc, device="cpu").score()
    assert metrics is not None and all(np.isfinite(v) for v in metrics.values())
    dm = port_det.DetectorModel(model.params, model.cfg)
    names = sorted(os.listdir(os.path.join(fixture_dir, "samples")))[:3]
    pages = [open(os.path.join(fixture_dir, "samples", n), "rb").read() for n in names]
    results = []
    for int8 in (False, True):
        engine = BatchInferenceEngine(dm, image_sizes=(64,), batch_size=2, score_thresh=0.0,
                                      device="cpu", int8=int8)
        results.append(engine.predict_pages(pages))
        assert all(0 < len(r.boxes) <= 20 for r in results[-1])
    for a, b in zip(*results):
        np.testing.assert_array_equal(a.boxes, b.boxes)
    export_detector(model.params, model.cfg, str(tmp_path / "art"), image_sizes=(64,),
                    batch_size=2, device="cpu")
    images = torch.from_numpy(_images(5))
    out = ExportedDetector(str(tmp_path / "art"), device="cpu").predict(images,
                                                                       torch.full((2, 2), 64.0))
    with torch.no_grad():
        live = port_det.rescale_detections(
            port_det.detector_predict(port_det.params_for_inference(model.params, torch.float32),
                                      images, model.cfg), torch.full((2, 2), 64.0), 64)
    np.testing.assert_array_equal(out["valid"], live.valid.numpy())
    np.testing.assert_allclose(out["boxes"], live.boxes.numpy(), atol=1e-5)
    np.testing.assert_allclose(out["scores"], live.scores.numpy(), atol=1e-6)


def test_resnet_config_loads():
    rc = run_config_from_dict({"detection_model_config": {"backbone_type": "resnet50"}})
    cfg = port_det.DetectorConfig.from_model_config(rc.model)
    assert (cfg.backbone_kind, cfg.roi_levels) == ("resnet50", 4)
    assert port_det.DetectorConfig().roi_levels == 5
