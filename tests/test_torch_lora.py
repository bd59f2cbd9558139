"""LoRA in the port (``models/lora.py``, the adapters in ``models/vit.py``,
the masked optimizer in ``train/optim.py`` and ``train/trainer.py``, the
masked run state in ``models/weights_io.py``, ``tools/merge_lora.py``)
against the JAX package on the CPU, float32, tiny widths.

Tolerances: at step 0 the adapted model's output is bit-equal to the
model without adapters; with active adapters the encoder matches JAX's at
1e-5; ``merge_lora`` is exact to one float32 rounding (2 ulp); one masked
AdamW update with clipping matches JAX's at ``PARAM_TOL`` (1e-5), the
frozen leaves keeping their bits; the masked optimizer state crosses
msgpack both ways exactly."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from layoutdit_tpu.config.constructs import ModelConfig as JaxModelConfig
from layoutdit_tpu.config.constructs import TrainingConfig as JaxTrainingConfig
from layoutdit_tpu.models import lora as jax_lora
from layoutdit_tpu.models import vit as jax_vit
from layoutdit_tpu.models.detection import detector as jax_det
from layoutdit_tpu.train.checkpoint import load_checkpoint as jax_load
from layoutdit_tpu.train.checkpoint import save_checkpoint as jax_save
from layoutdit_tpu_torch.config import TrainingConfig, load_run_config, run_config_from_dict
from layoutdit_tpu_torch.models import lora as port_lora
from layoutdit_tpu_torch.models import vit as port_vit
from layoutdit_tpu_torch.models.detection import detector as port_det
from layoutdit_tpu_torch.models.weights_io import (
    params_from_jax,
    params_to_jax,
    train_state_to_jax,
    tree_leaves,
    tree_map,
    tree_paths,
    vit_params_from_jax,
    vit_params_to_jax,
)
from layoutdit_tpu_torch.train import checkpoint as ckpt
from layoutdit_tpu_torch.train import trainer as port_trainer
from test_torch_train import PARAM_TOL, _jax_priorities, _jax_trainer, _t

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

REPO = os.path.join(os.path.dirname(__file__), os.pardir)
FWD_TOL = 1e-5
VIT = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=2, intermediate_size=64,
           patch_size=16, image_size=64)
ALL = ("q", "v", "mlp_in", "mlp_out", "attn_out", "k")
MODEL = dict(num_classes=3, image_size=64, lora_rank=4, lora_alpha=8.0, lora_targets=["q", "v"],
             vit_overrides={"hidden_size": 32, "num_hidden_layers": 2,
                            "num_attention_heads": 2, "intermediate_size": 64},
             fpn_out_channels=32,
             detection_budget={"rpn_pre_nms_top_n_train": 200, "rpn_pre_nms_top_n_test": 100,
                               "rpn_post_nms_top_n_train": 100, "rpn_post_nms_top_n_test": 100,
                               "box_batch_size_per_image": 32, "box_detections_per_img": 20})


def _pixels(b=2, size=64, seed=0):
    return np.random.default_rng(seed).standard_normal((b, 3, size, size)).astype(np.float32)


def _randomize(tree, seed=1):
    """A JAX tree with every adapter drawn at 0.1 (B nonzero: an active delta)."""
    rng = np.random.default_rng(seed)

    def go(path, x):
        if getattr(path[-1], "key", None) in ("lora_a", "lora_b"):
            return np.asarray(0.1 * rng.standard_normal(x.shape), np.float32)
        return np.asarray(x)

    return jax.tree_util.tree_map_with_path(go, tree)


def _cfgs(**model):
    mc = {**MODEL, **model}
    jcfg = jax_det.DetectorConfig.from_model_config(JaxModelConfig(**mc))
    pcfg = port_det.DetectorConfig.from_model_config(
        run_config_from_dict({"detection_model_config": mc}).model)
    return jcfg, pcfg


def test_step0_is_bit_equal_to_the_model_without_adapters():
    """Adapters at init (B = 0) leave the encoder's output and the whole
    detector's predictions bit for bit as they are without them, and the
    base weights are the same draws."""
    cfg = port_vit.ViTConfig(**VIT)
    lcfg = dataclasses.replace(cfg, lora_rank=4, lora_alpha=8.0, lora_targets=ALL)
    base = port_vit.init_vit_params(cfg, torch.Generator().manual_seed(0), "cpu")
    adapted = port_vit.init_vit_params(lcfg, torch.Generator().manual_seed(0), "cpu")
    assert port_lora.has_lora(adapted) and not port_lora.has_lora(base)
    for layer, ad in zip(base["layers"], adapted["layers"]):
        assert torch.equal(layer["qkv"]["weight"], ad["qkv"]["weight"])
        assert not ad["q"]["lora_b"].any() and ad["q"]["lora_a"].shape == (32, 4)
        assert ad["mlp_in"]["lora_a"].shape == (32, 4) and ad["mlp_in"]["lora_b"].shape == (4, 64)
    x = torch.from_numpy(_pixels())
    for dtype in (torch.float32, torch.bfloat16):
        want = port_vit.vit_forward(base, x, cfg, taps=(1, 2), compute_dtype=dtype)
        got = port_vit.vit_forward(adapted, x, lcfg, taps=(1, 2), compute_dtype=dtype)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    _, pcfg0 = _cfgs(lora_rank=0)
    _, pcfg = _cfgs()
    p0 = port_det.init_detector(pcfg0, torch.Generator().manual_seed(3), "cpu")
    p1 = port_det.init_detector(pcfg, torch.Generator().manual_seed(3), "cpu")
    images = torch.from_numpy(np.random.default_rng(2).uniform(0, 1, (2, 3, 64, 64))
                              .astype(np.float32))
    for a, b in zip(port_det.detector_predict(p0, images, pcfg0),
                    port_det.detector_predict(p1, images, pcfg)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("targets", [("q", "v"), ALL])
def test_active_adapters_match_jax(targets):
    jcfg = jax_vit.ViTConfig(**VIT, lora_rank=4, lora_alpha=8.0, lora_targets=targets)
    pcfg = port_vit.ViTConfig(**VIT, lora_rank=4, lora_alpha=8.0, lora_targets=targets)
    jparams = _randomize(jax_vit.init_vit_params(jax.random.PRNGKey(0), jcfg))
    params = vit_params_from_jax(jparams)
    assert sorted(k for k in params["layers"][0] if k in port_lora.LORA_TARGETS) == sorted(
        {"attn_out", "mlp_in", "mlp_out"} | set(targets))
    x = _pixels()
    want = jax_vit.vit_forward(jparams, jnp.asarray(x), jcfg, taps=(1, 2))
    got = port_vit.vit_forward(params, torch.from_numpy(x), pcfg, taps=(1, 2))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=FWD_TOL, atol=FWD_TOL)
    # the carrier round-trips the adapters
    back = vit_params_to_jax(params)
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(jparams)[0],
                            jax.tree_util.tree_leaves(back)):
        if getattr(path[-1], "key", None) in ("lora_a", "lora_b"):
            np.testing.assert_array_equal(g, w)


def test_lora_delta_rounds_as_jax_in_bf16():
    """h = x A is rounded to bf16 before h B (JAX ``lora_delta``)."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 7, 32)).astype(np.float32)
    a = rng.standard_normal((32, 4)).astype(np.float32)
    b = rng.standard_normal((4, 48)).astype(np.float32)
    want = jax_lora.lora_delta(jnp.asarray(x, jnp.bfloat16), {"lora_a": a, "lora_b": b}, 2.0)
    got = port_lora.lora_delta(torch.from_numpy(x).bfloat16(),
                               {"lora_a": torch.from_numpy(a), "lora_b": torch.from_numpy(b)},
                               2.0)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=8e-3,
                               atol=1e-2)


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_adapters_under_remat(policy):
    """remat full / dots give the adapters the same gradients as no remat."""
    cfg = port_vit.ViTConfig(**VIT, lora_rank=4, lora_alpha=8.0, lora_targets=ALL)
    jparams = _randomize(jax_vit.init_vit_params(
        jax.random.PRNGKey(0), jax_vit.ViTConfig(**VIT, lora_rank=4, lora_alpha=8.0,
                                                  lora_targets=ALL)))
    x = torch.from_numpy(_pixels())
    grads = []
    for remat in (False, True):
        params = vit_params_from_jax(jparams)
        for t in tree_leaves(params):
            t.requires_grad_(True)
        (h,) = port_vit.vit_forward(params, x, cfg, remat=remat, remat_policy=policy)
        h.square().sum().backward()
        grads.append([params["layers"][i][n][k].grad for i in range(2) for n in ALL
                      for k in ("lora_a", "lora_b")])
    for g, w in zip(*grads):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-7)


def test_merge_is_exact_to_one_rounding():
    jcfg = jax_vit.ViTConfig(**VIT, lora_rank=4, lora_alpha=8.0, lora_targets=ALL)
    pcfg = port_vit.ViTConfig(**VIT, lora_rank=4, lora_alpha=8.0, lora_targets=ALL)
    jparams = _randomize(jax_vit.init_vit_params(jax.random.PRNGKey(0), jcfg))
    jmerged = jax_lora.merge_lora(jparams, jcfg)
    merged = port_lora.merge_lora(vit_params_from_jax(jparams), pcfg)
    assert not port_lora.has_lora(merged)
    assert set(merged["layers"][0]) == set(port_vit.init_vit_params(
        port_vit.ViTConfig(**VIT), torch.Generator(), "cpu")["layers"][0])
    for w, g in zip(jax.tree_util.tree_leaves(jmerged),
                    jax.tree_util.tree_leaves(vit_params_to_jax(merged))):
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=0, atol=2 * float(np.spacing(np.abs(w).max())))
    x = torch.from_numpy(_pixels())
    unmerged = port_vit.vit_forward(vit_params_from_jax(jparams), x, pcfg)
    np.testing.assert_allclose(port_vit.vit_forward(merged, x, port_vit.ViTConfig(**VIT))[0],
                               unmerged[0], rtol=1e-4, atol=1e-4)


def test_mask_and_counts_equal_jax():
    jcfg, pcfg = _cfgs()
    jparams = jax.tree_util.tree_map(np.asarray, jax_det.init_detector_params(
        jax.random.PRNGKey(0), jcfg))
    params = params_from_jax(jparams)
    assert port_lora.num_trainable(params) == jax_lora.num_trainable(jparams)
    mask = port_lora.trainable_mask(params)
    # the port's mask, as JAX's: True exactly on the adapters and off the encoder
    jmask = jax_lora.trainable_mask(jparams)
    want = {jax.tree_util.keystr(p): m
            for p, m in jax.tree_util.tree_flatten_with_path(jmask)[0]}
    assert sum(want.values()) == sum(
        1 for p, m in zip(tree_paths(params), mask) if m and "qkv/bias" not in p)
    for path, m in zip(tree_paths(params), mask):
        assert m == (not path.startswith("backbone/vit") or path.endswith(("lora_a", "lora_b")))


def _jax_masked_step(jparams, jcfg, tc, images, gt_boxes, gt_labels, gt_valid, rng):
    trainer = _jax_trainer()
    tx = trainer.make_optimizer(JaxTrainingConfig(**tc), 4,
                                trainable_mask_fn=jax_lora.trainable_mask)
    mask = jax_lora.trainable_mask(jparams)

    def total(p):
        p = jax.tree_util.tree_map(lambda m, x: x if m else jax.lax.stop_gradient(x), mask, p)
        return sum(jax_det.detector_loss(p, rng, images, gt_boxes, gt_labels, gt_valid,
                                         jcfg).values())

    grads = jax.jit(jax.grad(total))(jparams)
    opt_state = tx.init(jparams)
    import optax

    updates, opt_state = tx.update(grads, opt_state, jparams)
    return (jax.tree_util.tree_map(np.asarray, optax.apply_updates(jparams, updates)),
            opt_state)


def _batch():
    rng = np.random.default_rng(3)
    images = rng.uniform(0, 1, (2, 3, 64, 64)).astype(np.float32)
    gt_boxes = np.array([[[5, 5, 30, 40], [20, 10, 60, 50]], [[10, 10, 50, 60], [2, 40, 20, 62]]],
                        np.float32)
    return images, gt_boxes, np.array([[1, 3], [2, 1]], np.int32), np.ones((2, 2), bool)


@pytest.fixture(scope="module")
def lora_models():
    jcfg, pcfg = _cfgs()
    jparams = _randomize(jax.tree_util.tree_map(np.asarray, jax_det.init_detector_params(
        jax.random.PRNGKey(0), jcfg)))
    return jparams, jcfg, pcfg


def test_masked_update_with_clipping_matches_jax(lora_models):
    """One masked AdamW update (clip 1.0, weight decay 0.01) through each
    package: the trainable leaves within PARAM_TOL, the frozen ones with
    the same bits; the port's state has moments for trainable leaves
    only."""
    jparams, jcfg, pcfg = lora_models
    tc = dict(weight_decay=0.01, grad_clip_norm=1.0)  # lr: the default 1e-4
    images, gt_boxes, gt_labels, gt_valid = _batch()
    rng = jax.random.PRNGKey(7)
    jnew, _ = _jax_masked_step(jparams, jcfg, tc, images, gt_boxes, gt_labels, gt_valid, rng)

    params = params_from_jax(jparams)
    before = [t.clone() for t in tree_leaves(params)]
    mask = port_lora.trainable_mask(params)
    leaves = tree_leaves(params)
    for t, m in zip(leaves, mask):
        t.requires_grad_(m)
    n_anchors = sum(h * w for h, w in pcfg.grid_sizes) * pcfg.num_anchors_per_cell
    pri = _jax_priorities(rng, 2, n_anchors, pcfg.budget.rpn_post_nms_top_n_train + 2)
    losses = port_det.detector_loss(params, _t(images), _t(gt_boxes), _t(gt_labels),
                                    _t(gt_valid), pcfg, pri)
    sum(losses.values()).backward()
    assert all(t.grad is None for t, m in zip(leaves, mask) if not m)
    opt = port_trainer.AdamW(TrainingConfig(**tc), steps_per_epoch=4)
    state = opt.init(leaves, mask)
    train = [t for t, m in zip(leaves, mask) if m]
    assert len(state["mu"]) == len(train) < len(leaves)
    opt.update(state, train, [t.grad for t in train])
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(jnew)[0],
                            jax.tree_util.tree_leaves(params_to_jax(params))):
        np.testing.assert_allclose(g, w, rtol=PARAM_TOL, atol=PARAM_TOL,
                                   err_msg=jax.tree_util.keystr(path))
    for t, b, m in zip(leaves, before, mask):
        if not m:
            assert torch.equal(t, b)
    assert any(not torch.equal(t, b) for t, b, m in zip(leaves, before, mask)
               if m and t.shape[0] == 4)  # an adapter moved


def test_masked_state_crosses_msgpack_both_ways(lora_models, tmp_path):
    """A JAX LoRA run's masked state, written by JAX's ``save_checkpoint``,
    reads into the port's (trainable moments only); the port's, written
    by ``save_as_jax``, restores in JAX under its masked template."""
    jparams, jcfg, pcfg = lora_models
    tc = dict(weight_decay=0.01, grad_clip_norm=1.0, skip_nonfinite_updates=2)
    jnew, jstate = _jax_masked_step(jparams, jcfg, tc, *_batch(), jax.random.PRNGKey(7))
    path = str(tmp_path / "epoch_1.msgpack")
    jax_save(path, jnew, jstate, epoch=1, extra={"updates": 1})
    state = ckpt.load_checkpoint(path, map_location="cpu")
    params = state["params"]
    tx = state["opt_state"]
    mask = port_lora.trainable_mask(params)
    assert tx["trainable"].tolist() == mask
    assert len(tx["mu"]) == sum(mask)
    # the moments are JAX's, leaf for leaf, on the trainable leaves
    adam = next(s for s in jax.tree_util.tree_leaves(
        jstate, is_leaf=lambda s: type(s).__name__ == "ScaleByAdamState")
        if type(s).__name__ == "ScaleByAdamState")
    jmu = jax.tree_util.tree_map(lambda m: np.asarray(m) if hasattr(m, "shape") else None,
                                 adam.mu, is_leaf=lambda m: type(m).__name__ == "MaskedNode")
    it = iter(tx["mu"])
    full = [next(it) if m else torch.zeros_like(p) for p, m in zip(tree_leaves(params), mask)]
    back = params_to_jax(_unflat(params, full))
    flat = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    for p, w in jax.tree_util.tree_flatten_with_path(jmu)[0]:
        if w is not None:
            np.testing.assert_array_equal(flat[p], w)
    assert int(tx["notfinite_count"]) == 0 and int(tx["count"]) == 1
    # back to JAX: the port's state under JAX's masked template
    out = str(tmp_path / "port.msgpack")
    ckpt.save_as_jax(out, params, tx, 1, {}, clip=True)
    tmpl_tx = _jax_trainer().make_optimizer(JaxTrainingConfig(**tc), 4,
                                           trainable_mask_fn=jax_lora.trainable_mask)
    restored = jax_load(out, jnew, tmpl_tx.init(jnew))
    for a, b in zip(jax.tree_util.tree_leaves(restored["opt_state"]),
                    jax.tree_util.tree_leaves(jstate)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert train_state_to_jax(tx, params, clip=True)["inner_state"][0] == {"inner_state": {}}


def _unflat(template, leaves):
    it = iter(leaves)
    return tree_map(lambda _: next(it), template)


@pytest.fixture(scope="module")
def lora_fixture(tmp_path_factory):
    from layoutdit_tpu_torch.tools.make_fixture import make_fixture, write_fixture_config

    root = str(tmp_path_factory.mktemp("lora_fx"))
    make_fixture(root, n_images=4, split="samples", seed=0)
    path = write_fixture_config(root, epochs=1, batch_size=2, tiny_model=True)
    with open(path) as f:
        raw = json.load(f)
    raw["detection_model_config"].update(lora_rank=4, lora_alpha=8.0)
    raw["train_config"].update(tensorboard=False, checkpoint_interval=1, grad_clip_norm=1.0)
    with open(os.path.join(root, "lora.json"), "w") as f:
        json.dump(raw, f)
    return root, path, os.path.join(root, "lora.json")


def test_trainer_freezes_the_encoder_and_resumes(lora_fixture, tmp_path):
    """A LoRA fine-tune through ``Trainer``: the frozen encoder keeps its
    bits, every adapter moves, the optimizer holds moments for the
    trainable leaves only, and its checkpoint resumes them exactly, from
    ``.pt`` and from the JAX-format ``.msgpack``."""
    from layoutdit_tpu_torch.models.model import LayoutDetectionModel

    root, _, lora_cfg = lora_fixture
    rc = load_run_config(lora_cfg)
    rc = dataclasses.replace(rc, eval_base_path=str(tmp_path))
    model = LayoutDetectionModel(rc.model, compute_dtype="float32", device="cpu")
    mask = port_lora.trainable_mask(model.params)
    before = [t.detach().clone() for t in tree_leaves(model.params)]
    trainer = port_trainer.Trainer(rc, model, device="cpu")
    trainer.train()
    after = tree_leaves(model.params)
    for path, b, a, m in zip(tree_paths(model.params), before, after, mask):
        if not m:
            assert torch.equal(a, b), path
        elif path.endswith(("lora_a", "lora_b")):
            assert not torch.equal(a, b), path
    assert len(trainer.opt_state["mu"]) == sum(mask) < len(mask)
    assert all(not t.requires_grad for t, m in zip(after, mask) if not m)
    pt = trainer.checkpoint_path(1)
    msgpack = pt.replace(".pt", ".msgpack")
    ckpt.save_as_jax(msgpack, trainer.params, trainer._opt_state_for_checkpoint(), 1,
                     trainer.checkpoint_extra(), clip=True)
    for path in (pt, msgpack):
        model2 = LayoutDetectionModel(rc.model, compute_dtype="float32", device="cpu", seed=5)
        trainer2 = port_trainer.Trainer(rc, model2, device="cpu")
        trainer2.resume(path)
        assert set(trainer.opt_state) == set(trainer2.opt_state)
        for key, a in trainer.opt_state.items():
            b = trainer2.opt_state[key]
            pairs = zip(a, b, strict=True) if isinstance(a, (list, tuple)) else [(a, b)]
            for x, y in pairs:
                assert torch.equal(x, y), (path, key)
        for a, b in zip(after, tree_leaves(model2.params)):
            assert torch.equal(a, b), path


def test_merge_lora_cli_round_trip(lora_fixture, tmp_path, monkeypatch):
    """``tools/merge_lora.py``: a LoRA checkpoint -> a merged params-only
    ``.msgpack`` that loads under the rank-0 config (in the port and in
    JAX) and predicts as the adapted model does."""
    from layoutdit_tpu_torch.models.model import build_model
    from layoutdit_tpu_torch.tools import merge_lora as cli

    root, cfg0_path, lora_cfg = lora_fixture
    monkeypatch.setenv("LAYOUTDIT_CONFIG", lora_cfg)
    rc = load_run_config(lora_cfg)
    model = build_model(rc, device="cpu", warm_start=False)
    rnd = np.random.default_rng(4)
    for layer in model.params["backbone"]["vit"]["layers"]:
        for n in ("q", "v"):
            layer[n]["lora_b"] = torch.from_numpy(
                0.1 * rnd.standard_normal(layer[n]["lora_b"].shape).astype(np.float32))
    src = model.save_checkpoint(str(tmp_path), "run", 1)
    out = str(tmp_path / "merged.msgpack")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["--checkpoint", src, "--out", out])  # the card is the default
    cli.main(["--checkpoint", src, "--out", out, "--device", "cpu"])
    images = torch.from_numpy(np.random.default_rng(0).uniform(0, 1, (1, 3, 224, 224))
                              .astype(np.float32))
    want = model.predict(images)
    model0 = build_model(load_run_config(cfg0_path), device="cpu", warm_start=False)
    model0.restore_checkpoint(out)
    assert not port_lora.has_lora(model0.params["backbone"]["vit"])
    for g, w in zip(model0.predict(images), want):
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
    from layoutdit_tpu.config import LayoutDitConfig

    with open(cfg0_path) as f:
        jcfg = LayoutDitConfig(**json.load(f))
    template = jax_det.init_detector_params(jax.random.PRNGKey(0), jax_det.DetectorConfig
                                            .from_model_config(jcfg.detection_model_config))
    jstate = jax_load(out, template)
    assert json.loads(json.dumps(jstate["extra"])) == {"merged_lora": True}
    with pytest.raises(SystemExit, match="lora_rank=0"):
        monkeypatch.setenv("LAYOUTDIT_CONFIG", cfg0_path)
        cli.main(["--checkpoint", src, "--out", out, "--device", "cpu"])


def test_lora_configs_load_and_resnet_lora_is_refused():
    rc = load_run_config(os.path.join(REPO, "configs", "lora.json"))
    assert (rc.model.lora_rank, rc.model.lora_alpha, rc.model.lora_targets) == (16, 16.0,
                                                                                ("q", "v"))
    assert rc.train.lora_freeze_base
    vit = port_det.DetectorConfig.from_model_config(rc.model).backbone.vit
    assert (vit.lora_rank, vit.lora_scaling, vit.lora_targets) == (16, 1.0, ("q", "v"))
    rc = run_config_from_dict({"train_config": {"lora_freeze_base": False}})
    assert not rc.train.lora_freeze_base
    with pytest.raises(ValueError, match="resnet50 backbone has no LoRA"):
        port_det.DetectorConfig.from_model_config(run_config_from_dict(
            {"detection_model_config": {"backbone_type": "resnet50", "lora_rank": 4}}).model)
    with pytest.raises(ValueError, match="unknown lora_targets"):
        port_vit.init_vit_params(port_vit.ViTConfig(**VIT, lora_rank=2, lora_targets=("x",)),
                                 torch.Generator(), "cpu")


def test_lora_quality_tool_runs_its_three_trainings(tmp_path, monkeypatch):
    """``tools/lora_quality.py`` at a tiny size on the CPU (8 pages a split,
    one epoch): the pretrain, the full fine-tune and LoRA r8 from the same
    weights, each scored; LoRA's optimizer state a fraction of the full
    fine-tune's; the floors checked as JAX's test checks them."""
    from layoutdit_tpu_torch.tools import lora_quality

    monkeypatch.setattr(lora_quality, "PRETRAIN_PAGES", 8)
    monkeypatch.setattr(lora_quality, "TRAIN_PAGES", 8)
    monkeypatch.setattr(lora_quality, "VAL_PAGES", 4)
    result = lora_quality.run(str(tmp_path), device="cpu", compute_dtype="float32", epochs=1)
    assert set(result) == {"pretrain", "full_ft", "lora_r8"}
    assert all(r["steps"] == 1 and np.isfinite(r["mAP"]) for r in result.values())
    full, r8 = result["full_ft"], result["lora_r8"]
    assert r8["trainable_params"] < full["trainable_params"]
    assert r8["opt_state_bytes"] < full["opt_state_bytes"]
    fails = lora_quality.floor_failures({**result, "full_ft": {**full, "mAP": 0.5},
                                         "pretrain": {"mAP": 0.4},
                                         "lora_r8": {**r8, "mAP": 0.42}})
    assert fails == ["LoRA r8 mAP 0.4200 < 0.85 x 0.5000"]
