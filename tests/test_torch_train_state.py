"""The trainer's run state in the port against the JAX package on the
CPU, at tiny widths: optax's AdamW chain (clip, warmup, weight decay,
bf16 first moments, non-finite skipping), gradient accumulation, the EMA
of the parameters (mid-training eval and ``main`` score it),
``steps_per_dispatch``, and the loader's stacking and skipping; plus one
accumulated step on the card launching the kernels."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from layoutdit_tpu.config.constructs import TrainingConfig as JaxTrainingConfig
from layoutdit_tpu.data.dataset import PubLayNetDataset as JaxDataset
from layoutdit_tpu.data.pipeline import DetectionLoader as JaxLoader
from layoutdit_tpu_torch import main as port_main
from layoutdit_tpu_torch.config import TrainingConfig, load_run_config, run_config_from_dict
from layoutdit_tpu_torch.data.dataset import PubLayNetDataset
from layoutdit_tpu_torch.data.pipeline import DetectionBatch, DetectionLoader
from layoutdit_tpu_torch.models.detection import detector as port_det
from layoutdit_tpu_torch.models.model import build_model
from layoutdit_tpu_torch.models.weights_io import params_from_jax, params_to_jax, tree_leaves, \
    tree_map
from layoutdit_tpu_torch.tools.make_fixture import make_fixture, write_fixture_config
from layoutdit_tpu_torch.train import trainer as port_trainer
from layoutdit_tpu_torch.train.checkpoint import load_checkpoint
from layoutdit_tpu_torch.train.optim import AdamW
from test_torch_train import (  # noqa: F401 (fixtures)
    GRAD_RTOL,
    LOSS_RTOL,
    PARAM_TOL,
    _batch,
    _jax_loss_and_grads,
    _jax_priorities,
    _jax_trainer,
    _rel_frob,
    _t,
    fixture_dir,
    models,
)

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

OPT_TOL = 1e-6
IMAGE_SIZE = 64  # the tiny detector on 64 px pages: a fraction of a second a step


def _fixture(root, n_images=8, epochs=1, batch_size=4, seed=1, **train) -> str:
    """Pages and a tiny-model config under ``root`` -> the config path."""
    make_fixture(root, n_images=n_images, split="samples", seed=seed)
    path = write_fixture_config(root, epochs=epochs, batch_size=batch_size, tiny_model=True)
    with open(path) as f:
        raw = json.load(f)
    raw["detection_model_config"]["image_size"] = IMAGE_SIZE
    raw["train_config"].update(train)
    with open(path, "w") as f:
        json.dump(raw, f)
    return path


def _trainer(path, **train):
    rc = load_run_config(path)
    if train:
        rc = dataclasses.replace(rc, train=dataclasses.replace(rc.train, **train))
    return port_trainer.Trainer(rc, build_model(rc, device="cpu"), device="cpu")


def _equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b), strict=True))


# ------------------------------------------------------------ optimizer


def _optax_parts(state) -> dict:
    """The adam, schedule and apply_if_finite states of an optax state."""
    found = {}

    def walk(s):
        name = type(s).__name__
        if name == "ScaleByAdamState":
            found["adam"] = s
        elif name == "ScaleByScheduleState":
            found["schedule"] = s
        elif name == "ApplyIfFiniteState":
            found["finite"] = s
            walk(s.inner_state)
        elif isinstance(s, tuple):
            for x in s:
                walk(x)

    walk(state)
    return found


@pytest.mark.parametrize("mu_dtype", ["float32", "bfloat16"])
def test_optimizer_chain_matches_optax(mu_dtype):
    """The port's AdamW against ``make_optimizer`` of the JAX trainer,
    jitted as its train step is, over 8 updates: clipped and unclipped
    steps, warmup, cosine decay, weight decay; a NaN gradient skipped,
    then three in a row, the third of which goes through
    (skip_nonfinite_updates 2)."""
    kw = dict(learning_rate=1e-2, weight_decay=0.05, grad_clip_norm=1.0, warmup_steps=3,
              lr_schedule="cosine", num_epochs=2, skip_nonfinite_updates=2,
              adam_mu_dtype=mu_dtype)
    rng = np.random.default_rng(0)
    shapes = {"a": (5, 3), "b": (7,), "c": (2, 2, 2)}
    jparams = {k: jnp.asarray(rng.standard_normal(s).astype(np.float32))
               for k, s in shapes.items()}
    tx = _jax_trainer().make_optimizer(JaxTrainingConfig(**kw), steps_per_epoch=4)
    jstate = tx.init(jparams)
    update = jax.jit(tx.update)  # compiled, as in the JAX train step
    opt = AdamW(TrainingConfig(**kw), steps_per_epoch=4)
    params = [torch.from_numpy(np.array(jparams[k])) for k in sorted(shapes)]
    state = opt.init(params)
    assert state["mu"][0].dtype == getattr(torch, mu_dtype)

    import optax

    for i, scale in enumerate([0.1, 3.0, None, 0.05, 2.0, None, None, None]):
        grads = {k: rng.standard_normal(s).astype(np.float32) * (scale or 1.0)
                 for k, s in shapes.items()}
        if scale is None:
            grads["b"][3] = np.nan
        updates, jstate = update({k: jnp.asarray(v) for k, v in grads.items()}, jstate,
                                 jparams)
        jparams = optax.apply_updates(jparams, updates)
        opt.update(state, params, [torch.from_numpy(grads[k]) for k in sorted(shapes)])

        parts = _optax_parts(jstate)
        msg = f"update {i + 1}"
        for k, p, m, n in zip(sorted(shapes), params, state["mu"], state["nu"]):
            np.testing.assert_allclose(p.numpy(), np.asarray(jparams[k]), rtol=OPT_TOL,
                                       atol=OPT_TOL, err_msg=f"{msg} param {k}")
            assert m.dtype == getattr(torch, mu_dtype) and n.dtype == torch.float32
            np.testing.assert_allclose(m.float().numpy(),
                                       np.asarray(parts["adam"].mu[k], np.float32),
                                       rtol=OPT_TOL, atol=OPT_TOL, err_msg=f"{msg} mu {k}")
            np.testing.assert_allclose(n.numpy(), np.asarray(parts["adam"].nu[k]),
                                       rtol=OPT_TOL, atol=OPT_TOL, err_msg=f"{msg} nu {k}")
        assert int(state["count"]) == int(parts["adam"].count), msg
        assert int(state["schedule_count"]) == int(parts["schedule"].count), msg
        assert int(state["notfinite_count"]) == int(parts["finite"].notfinite_count), msg
        assert int(state["total_notfinite"]) == int(parts["finite"].total_notfinite), msg
    # the skipped NaN left the counts behind; the last one went through
    assert int(state["count"]) == 5 and int(state["total_notfinite"]) == 4
    assert all(torch.isnan(p).any() for p in params)


# ------------------------------------------------------- accumulation


def _batch4():
    images, gt_boxes, gt_labels, gt_valid = _batch()
    return (np.concatenate([images, images[:, :, ::-1].copy()]),
            np.concatenate([gt_boxes, gt_boxes[:, ::-1].copy()]),
            np.concatenate([gt_labels, gt_labels[:, ::-1].copy()]),
            np.concatenate([gt_valid, gt_valid[:, ::-1].copy()]))


def test_accumulation_matches_jax(models, fixture_dir, tmp_path, monkeypatch):
    """A=2 on a batch of 4: the step's averaged micro-batch gradients,
    losses and the update equal the JAX step's (``trainer.py``: a scan
    over [A, B/A] slices with priorities from split(rng, A), summed
    float32 gradients / A, then ``make_optimizer``)."""
    jparams, jcfg, pcfg = models
    batch = _batch4()
    rng = jax.random.PRNGKey(7)
    keys = jax.random.split(rng, 2)
    g_sum, losses = None, []
    for a, key in enumerate(keys):
        micro = [x[2 * a:2 * a + 2] for x in batch]
        (_, ls), g = _jax_loss_and_grads(jcfg)(jparams, key, *micro)
        losses.append({k: float(v) for k, v in ls.items()})
        g_sum = g if g_sum is None else jax.tree_util.tree_map(jnp.add, g_sum, g)
    jgrads = jax.tree_util.tree_map(lambda x: np.asarray(x / 2), g_sum)
    tc = dict(weight_decay=0.01, grad_clip_norm=1.0)
    tx = _jax_trainer().make_optimizer(JaxTrainingConfig(**tc), steps_per_epoch=2)
    import optax

    updates, _ = tx.update(jgrads, tx.init(jparams), jparams)
    jnew = jax.tree_util.tree_map(np.asarray, optax.apply_updates(jparams, updates))

    with open(os.path.join(fixture_dir, "cfg.json")) as f:
        raw = json.load(f)
    raw["eval_config"]["eval_base_path"] = str(tmp_path)
    raw["train_config"].update(grad_accumulation_steps=2, tensorboard=False, **tc)
    trainer = port_trainer.Trainer(run_config_from_dict(raw),
                                   port_det.DetectorModel(params_from_jax(jparams), pcfg),
                                   device="cpu")
    n_anchors = sum(h * w for h, w in pcfg.grid_sizes) * pcfg.num_anchors_per_cell
    draws = [_jax_priorities(k, 2, n_anchors, pcfg.budget.rpn_post_nms_top_n_train + 4)
             for k in keys]
    monkeypatch.setattr(port_trainer, "draw_priorities", lambda *a: draws.pop(0))
    seen = {}
    update = trainer.optimizer.update

    def spy(state, params, grads):
        seen["grads"] = [g.clone() for g in grads]
        update(state, params, grads)

    monkeypatch.setattr(trainer.optimizer, "update", spy)
    images, gt_boxes, gt_labels, gt_valid = batch
    loss, parts = trainer.train_step(DetectionBatch(
        images=_t(images), gt_boxes=_t(gt_boxes), gt_labels=_t(gt_labels),
        gt_valid=_t(gt_valid), image_ids=np.arange(4), orig_sizes=np.ones((4, 2), np.float32),
        image_valid=np.ones(4, bool)))
    assert not draws  # one draw per micro-batch
    for name in parts:
        want = np.mean([ls[name] for ls in losses], dtype=np.float32)
        np.testing.assert_allclose(float(parts[name]), want, rtol=LOSS_RTOL, err_msg=name)
    np.testing.assert_allclose(float(loss), np.mean([sum(ls.values()) for ls in losses]),
                               rtol=LOSS_RTOL)

    it = iter(seen["grads"])
    grads = params_to_jax(tree_map(lambda _: next(it), trainer.params))
    flat_j = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    for (path, w), g in zip(flat_j, jax.tree_util.tree_leaves(grads), strict=True):
        assert _rel_frob(g, w) <= GRAD_RTOL, (jax.tree_util.keystr(path), _rel_frob(g, w))
    new = params_to_jax(trainer.params)
    for (path, w), g in zip(jax.tree_util.tree_flatten_with_path(jnew)[0],
                            jax.tree_util.tree_leaves(new), strict=True):
        np.testing.assert_allclose(g, w, rtol=PARAM_TOL, atol=PARAM_TOL,
                                   err_msg=jax.tree_util.keystr(path))


def test_accumulation_needs_a_divisible_batch(tmp_path):
    path = _fixture(str(tmp_path), batch_size=4, grad_accumulation_steps=3)
    with pytest.raises(ValueError, match="not divisible by.*grad_accumulation_steps 3"):
        _trainer(path)


# ----------------------------------------------------------------- EMA


def test_ema_decay_one_keeps_initial_and_round_trips(tmp_path):
    """d = 1.0: the EMA stays the initial parameters bit for bit while
    training moves them, and a checkpoint round trip restores it
    (``tests/test_ema.py``)."""
    path = _fixture(str(tmp_path), ema_decay=1.0, checkpoint_interval=1)
    trainer = _trainer(path)
    initial = tree_map(lambda t: t.detach().clone(), trainer.params)
    assert not any(e.data_ptr() == p.data_ptr()
                   for e, p in zip(tree_leaves(trainer.ema_params), trainer._leaves))
    trainer.train()
    assert _equal(trainer.ema_params, initial)
    assert not _equal(trainer.params, initial)
    other = _trainer(path)
    other.resume(trainer.checkpoint_path(1))
    assert other.epoch == 1 and _equal(other.ema_params, trainer.ema_params)
    assert _equal(other.params, trainer.params)


def test_ema_does_not_perturb_training(tmp_path):
    """Training is bit-identical with the EMA on and off, and a tiny decay
    makes the EMA follow the parameters."""
    path = _fixture(str(tmp_path))
    on, off = _trainer(path, ema_decay=1e-12), _trainer(path)
    on.train()
    off.train()
    assert off.ema_params is None
    assert _equal(on.params, off.params)
    for e, p in zip(tree_leaves(on.ema_params), on._leaves):
        torch.testing.assert_close(e, p.detach(), rtol=1e-5, atol=1e-7)


class _Recorder:
    """A stand-in evaluator that records the parameters it is given."""

    def __init__(self, model, *args, **kwargs):
        self.model, self.seen = model, []

    def score(self):
        self.seen.append([t.detach().clone() for t in tree_leaves(self.model.params)])
        return {"mAP": 0.5}

    def visualize_preds(self):
        pass

    def visualize_gt(self):
        pass


def test_mid_eval_and_main_score_the_ema_weights(tmp_path, monkeypatch):
    path = _fixture(str(tmp_path), ema_decay=0.5, eval_interval=1)
    trainer = _trainer(path)
    trainer._evaluator = rec = _Recorder(trainer.model)
    trainer.train()
    ema = tree_leaves(trainer.ema_params)
    assert len(rec.seen) == 1
    assert all(torch.equal(a, b) for a, b in zip(rec.seen[0], ema))
    assert not all(torch.equal(a, b) for a, b in zip(ema, trainer._leaves))
    # the model holds its own tensors again, and best.pt the EMA
    assert all(a is b for a, b in zip(tree_leaves(trainer.model.params), trainer._leaves))
    best = load_checkpoint(trainer.best_checkpoint_path, map_location="cpu")
    assert best["extra"]["ema"] is True
    assert _equal(best["params"], trainer.ema_params)

    trainers, evaluators = [], []

    class Trainer(port_trainer.Trainer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            trainers.append(self)

    def evaluator(model, *a, **kw):
        evaluators.append(_Recorder(model))
        return evaluators[-1]

    monkeypatch.setattr(port_main, "Trainer", Trainer)
    monkeypatch.setattr(port_main, "Evaluator", evaluator)
    with open(path) as f:
        raw = json.load(f)
    raw["train_config"]["eval_interval"] = 0
    raw["run_name"] = "main"
    with open(path, "w") as f:
        json.dump(raw, f)
    monkeypatch.setenv("LAYOUTDIT_CONFIG", path)
    port_main.main(["--device", "cpu"])
    (t,), (e,) = trainers, evaluators
    assert all(torch.equal(a, b) for a, b in zip(e.seen[0], tree_leaves(t.ema_params)))


# ------------------------------------------------- multi-step dispatch


def test_steps_per_dispatch_equals_single_steps(tmp_path):
    """S = 3 over 4 steps an epoch (one stacked dispatch of 3, then the
    remainder as one plain step) gives the bits of single steps."""
    path = _fixture(str(tmp_path), batch_size=2)
    stacked, single = _trainer(path, steps_per_dispatch=3), _trainer(path, steps_per_dispatch=1)
    sizes = []
    dispatch = stacked._dispatch
    stacked._dispatch = lambda batch, steps: sizes.append(steps) or dispatch(batch, steps)
    stacked.train()
    single.train()
    assert sizes == [3, 1] and stacked.updates == single.updates == 4
    assert stacked.loss_history == single.loss_history
    assert _equal(stacked.params, single.params)
    assert all(torch.equal(a, b) for a, b in zip(stacked.opt_state["nu"], single.opt_state["nu"]))
    assert _trainer(path).steps_per_dispatch == 1  # auto


def test_loader_stack_and_skip_match_jax(fixture_dir):
    """``stack_batches`` and ``skip_batches`` (mid-epoch resume, past the
    end included) give the JAX loader's batches: 8 pages, batch 3, S = 2."""
    root = os.path.join(fixture_dir, "samples")
    ann = os.path.join(fixture_dir, "samples.json")
    kw = dict(batch_size=3, shuffle=True, num_workers=2, image_size=64, max_gt=16, seed=4,
              stack_batches=2)
    jl = JaxLoader(JaxDataset(root + "/", ann), device_put=False, use_native=False, **kw)
    pl = DetectionLoader(PubLayNetDataset(root + "/", ann), device="cpu", **kw)
    for skip, want in ((0, [2, 1]), (1, [2]), (2, [1]), (3, []), (4, [])):
        for ld in (jl, pl):
            ld.set_epoch(1)
            ld.skip_batches(skip)
        jb, pb = list(jl), list(pl)
        assert [j.images.shape[0] if j.images.ndim == 5 else 1 for j in jb] == want, skip
        assert len(pb) == len(jb)
        for j, p in zip(jb, pb):
            assert p.images.dim() == j.images.ndim
            np.testing.assert_array_equal(p.image_ids, j.image_ids.reshape(-1))
            np.testing.assert_array_equal(p.image_valid, j.image_valid.reshape(-1))
            np.testing.assert_array_equal(p.gt_boxes.numpy(), j.gt_boxes)
            np.testing.assert_array_equal(p.gt_valid.numpy(), j.gt_valid)
            np.testing.assert_allclose(p.images.numpy(), j.images, atol=1e-5)
    # one-shot: the next epoch starts at its first batch again
    pl.set_epoch(1)
    assert len(list(pl)) == 2
    pl.close()
    jl.close()


# --------------------------------------------------------------- config


def test_run_state_fields_load_and_mu_dtype_is_checked():
    fields = dict(ema_decay=0.999, grad_accumulation_steps=2, steps_per_dispatch=2,
                  skip_nonfinite_updates=3, adam_mu_dtype="bfloat16", keep_checkpoints=2,
                  async_checkpoint=False, tensorboard=False)
    rc = run_config_from_dict({"train_config": fields})
    assert {k: getattr(rc.train, k) for k in fields} == fields
    jax_defaults = JaxTrainingConfig()
    assert all(getattr(TrainingConfig(), k) == getattr(jax_defaults, k) for k in fields)
    with pytest.raises(ValueError, match="adam_mu_dtype must be 'float32' or 'bfloat16'"):
        run_config_from_dict({"train_config": {"adam_mu_dtype": "float16"}})


# ------------------------------------------------------------ the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_accumulated_step_launches_the_kernels(cuda, tmp_path):
    """A=2 in bf16 on the card: per micro-batch, one short attention
    forward and backward per layer and one RoIAlign forward and backward."""
    from layoutdit_tpu_torch.ops import roi_align as ra
    from layoutdit_tpu_torch.ops import short_attention as sa

    path = _fixture(str(tmp_path), grad_accumulation_steps=2, ema_decay=0.9,
                    adam_mu_dtype="bfloat16", skip_nonfinite_updates=1)
    with open(path) as f:
        raw = json.load(f)
    raw["precision"] = {"compute_dtype": "bfloat16"}
    rc = run_config_from_dict(raw)
    trainer = port_trainer.Trainer(rc, build_model(rc, device=cuda))
    counters = (sa.short_attention, sa.short_attention_bwd, ra.roi_align_fwd, ra.roi_align_bwd)
    before = [c.launches for c in counters]
    it = iter(trainer.dataloader)
    batch = next(it)
    it.close()
    loss, _ = trainer.train_step(batch)
    torch.cuda.synchronize()
    assert np.isfinite(float(loss)) and int(trainer.opt_state["count"]) == 1
    layers = trainer.cfg.backbone.vit.num_hidden_layers
    assert [c.launches - n for c, n in zip(counters, before)] == [2 * layers] * 2 + [2, 2]
