"""The port reads and writes the JAX trainer's msgpack checkpoints
(``train/checkpoint.py``, ``utils/flax_msgpack.py``,
``models/weights_io.py``): JAX's ``save_checkpoint`` writes the tiny
detector (hidden 64, 2 layers) with its AdamW chain (clipping, bf16
``mu``, ``apply_if_finite``) and an EMA; the port's reader must give
``params_from_jax`` of the same trees exactly, and one train step after
the port's resume must match JAX's step after JAX's resume (losses 1e-4,
parameters 1e-5: one AdamW update's tolerance). The port's encoder's
bytes must read back through flax to the same tree."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from layoutdit_tpu.config.constructs import TrainingConfig as JaxTrainingConfig
from layoutdit_tpu.data.dataset import PubLayNetDataset as JaxDataset
from layoutdit_tpu.data.pipeline import DetectionLoader as JaxLoader
from layoutdit_tpu.train.checkpoint import load_checkpoint as jax_load
from layoutdit_tpu.train.checkpoint import save_checkpoint as jax_save
from layoutdit_tpu_torch.config import run_config_from_dict
from layoutdit_tpu_torch.data.pipeline import DetectionBatch
from layoutdit_tpu_torch.models.detection import detector as port_det
from layoutdit_tpu_torch.models.model import LayoutDetectionModel
from layoutdit_tpu_torch.models.weights_io import (
    k_bias_slots,
    params_from_jax,
    params_to_jax,
    train_state_from_jax,
    train_state_to_jax,
    tree_leaves,
)
from layoutdit_tpu_torch.train import checkpoint as ckpt
from layoutdit_tpu_torch.train import trainer as port_trainer
from layoutdit_tpu_torch.utils import flax_msgpack
from test_torch_train import (  # noqa: F401 (fixtures)
    LOSS_RTOL,
    PARAM_TOL,
    _batch,
    _jax_loss_and_grads,
    _jax_priorities,
    _jax_trainer,
    _t,
    fixture_dir,
    models,
)

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

# the run state under test: clipping, bf16 mu, apply_if_finite, EMA
TRAIN = dict(weight_decay=0.01, grad_clip_norm=1.0, adam_mu_dtype="bfloat16",
             skip_nonfinite_updates=2, ema_decay=0.9)
EXTRA = {"loss_history": [1.5, 1.25], "metrics_history": [{"epoch": 1, "loss": 1.5}],
         "best_map": 0.25, "best_checkpoint_path": "runs/x/model_checkpoints/best.msgpack",
         "evals_since_best": 1, "steps_per_dispatch": 1}
STEPS_PER_EPOCH = 2  # fixture_dir: 8 pages, batch 4


def _tx():
    tc = {k: v for k, v in TRAIN.items() if k != "ema_decay"}
    return _jax_trainer().make_optimizer(JaxTrainingConfig(**tc),
                                         steps_per_epoch=STEPS_PER_EPOCH)


def _jax_state(jparams, jcfg):
    """Two updates of the JAX chain on the test batch, and an EMA that
    followed them -> (params, opt_state, ema), numpy leaves."""
    import optax

    tx = _tx()
    update = jax.jit(tx.update)  # compiled, as in the JAX train step
    opt_state = tx.init(jparams)
    params, ema = jparams, jparams
    batch = _batch()
    for i in range(2):
        (_, _), grads = _jax_loss_and_grads(jcfg)(params, jax.random.PRNGKey(i), *batch)
        updates, opt_state = update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        ema = jax.tree_util.tree_map(lambda e, p: e * 0.9 + p * 0.1, ema, params)
    host = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return host(params), host(opt_state), host(ema)


@pytest.fixture(scope="module")
def jax_file(models, tmp_path_factory):
    """JAX's ``save_checkpoint`` of the state -> (path, params, opt_state, ema)."""
    jparams, jcfg, _ = models
    params, opt_state, ema = _jax_state(jparams, jcfg)
    path = str(tmp_path_factory.mktemp("jax_ckpt") / "epoch_1.msgpack")
    jax_save(path, params, {"tx": opt_state, "ema": ema}, epoch=1, extra=EXTRA)
    return path, params, opt_state, ema


def _parts(state) -> dict:
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


def _moment_leaves(tree) -> list[torch.Tensor]:
    return tree_leaves(params_from_jax(jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), tree)))


def _equal(a: list, b: list) -> bool:
    return len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def test_reader_gives_the_jax_trees_exactly(jax_file):
    path, params, opt_state, ema = jax_file
    state = ckpt.load_checkpoint(path, map_location="cpu")
    assert state["epoch"] == 1 and state["extra"] == EXTRA
    assert _equal(tree_leaves(state["params"]), tree_leaves(params_from_jax(params)))
    assert _equal(tree_leaves(state["opt_state"]["ema"]), tree_leaves(params_from_jax(ema)))
    tx, parts = state["opt_state"]["tx"], _parts(opt_state)
    assert set(tx) == {"mu", "nu", "count", "schedule_count", "notfinite_count",
                       "total_notfinite"}
    assert all(m.dtype == torch.bfloat16 for m in tx["mu"])
    assert _equal([m.float() for m in tx["mu"]], _moment_leaves(parts["adam"].mu))
    assert _equal(tx["nu"], _moment_leaves(parts["adam"].nu))
    for name, want in (("count", parts["adam"].count), ("schedule_count",
                                                         parts["schedule"].count),
                       ("notfinite_count", parts["finite"].notfinite_count),
                       ("total_notfinite", parts["finite"].total_notfinite)):
        assert tx[name].dtype == torch.int32 and int(tx[name]) == int(want), name
    assert int(tx["count"]) == 2
    # the fused qkv's K-bias slot is zero in the parameters and both moments
    for leaves in (tx["mu"], tx["nu"]):
        it = iter(leaves)
        tree = port_trainer.tree_map(lambda _: next(it), state["params"])
        assert all(not b[s].any() for b, s in k_bias_slots(tree))


def test_model_restore_takes_msgpack(jax_file):
    path, params, _, _ = jax_file
    model = object.__new__(LayoutDetectionModel)  # the shell without a config
    model.device = torch.device("cpu")
    model.params = params_from_jax(jax.tree_util.tree_map(np.zeros_like, params))
    state = model.restore_checkpoint(path)
    assert state["epoch"] == 1
    assert _equal(tree_leaves(model.params), tree_leaves(params_from_jax(params)))


def _trainer(fixture_dir, tmp_path, jparams, pcfg, **train):
    with open(os.path.join(fixture_dir, "cfg.json")) as f:
        raw = json.load(f)
    raw["eval_config"]["eval_base_path"] = str(tmp_path)
    raw["train_config"].update(tensorboard=False, **TRAIN, **train)
    return port_trainer.Trainer(run_config_from_dict(raw),
                                port_det.DetectorModel(params_from_jax(jparams), pcfg),
                                device="cpu")


def test_step_after_resume_matches_jax(models, fixture_dir, jax_file, tmp_path, monkeypatch):
    """JAX resumes its own file and takes one step; the port resumes the
    same file and takes the same step (JAX's sampler draws injected)."""
    import optax

    jparams, jcfg, pcfg = models
    path, params, opt_state, ema = jax_file
    batch = _batch()
    rng = jax.random.PRNGKey(11)

    # JAX: its loader of the same file, then one update
    restored = jax_load(path, params, {"tx": opt_state, "ema": ema})
    jp, jstate, jema = restored["params"], restored["opt_state"]["tx"], \
        restored["opt_state"]["ema"]
    (_, want), grads = _jax_loss_and_grads(jcfg)(jp, rng, *batch)
    updates, _ = jax.jit(_tx().update)(grads, jstate, jp)
    jnew = jax.tree_util.tree_map(np.asarray, optax.apply_updates(jp, updates))
    jema = jax.tree_util.tree_map(lambda e, p: np.asarray(e * 0.9 + p * 0.1), jema, jnew)

    # the port: a fresh trainer from other weights, resumed from the file
    trainer = _trainer(fixture_dir, tmp_path, jparams, pcfg)
    trainer.resume(path)
    assert trainer.epoch == 1 and trainer.updates == STEPS_PER_EPOCH
    assert trainer.loss_history == EXTRA["loss_history"] and trainer.best_map == 0.25
    b, g = batch[2].shape
    n_anchors = sum(h * w for h, w in pcfg.grid_sizes) * pcfg.num_anchors_per_cell
    draws = [_jax_priorities(rng, b, n_anchors, pcfg.budget.rpn_post_nms_top_n_train + g)]
    monkeypatch.setattr(port_trainer, "draw_priorities", lambda *a: draws.pop(0))
    images, gt_boxes, gt_labels, gt_valid = batch
    loss, parts = trainer.train_step(DetectionBatch(
        images=_t(images), gt_boxes=_t(gt_boxes), gt_labels=_t(gt_labels),
        gt_valid=_t(gt_valid), image_ids=np.arange(b), orig_sizes=np.ones((b, 2), np.float32),
        image_valid=np.ones(b, bool)))
    assert not draws
    for name in want:
        np.testing.assert_allclose(float(parts[name]), float(want[name]), rtol=LOSS_RTOL,
                                   err_msg=name)
    for got_tree, want_tree in ((trainer.params, jnew), (trainer.ema_params, jema)):
        got = params_to_jax(got_tree)
        for (p, w), x in zip(jax.tree_util.tree_flatten_with_path(want_tree)[0],
                             jax.tree_util.tree_leaves(got), strict=True):
            np.testing.assert_allclose(x, w, rtol=PARAM_TOL, atol=PARAM_TOL,
                                       err_msg=jax.tree_util.keystr(p))
    assert int(trainer.opt_state["count"]) == 3


def test_preempt_checkpoint_resumes_at_jax_page_order(models, fixture_dir, jax_file,
                                                      tmp_path):
    """A JAX ``epoch_<n>_preempt`` file with ``step_in_epoch`` resumes at
    that step, and the rest of the epoch goes through JAX's pages, in
    JAX's order."""
    jparams, _, pcfg = models
    path, params, opt_state, ema = jax_file
    pre = str(tmp_path / "model_checkpoints" / "epoch_1_preempt.msgpack")
    jax_save(pre, params, {"tx": opt_state, "ema": ema}, epoch=1,
             extra={**EXTRA, "step_in_epoch": 1})
    trainer = _trainer(fixture_dir, tmp_path, jparams, pcfg, num_epochs=2)
    trainer.resume(pre)
    assert trainer._start_step == 1 and trainer.updates == STEPS_PER_EPOCH + 1
    seen = []

    def dispatch(batch, steps):
        seen.append(batch.image_ids.copy())
        return [torch.zeros(())]

    trainer._dispatch = dispatch
    trainer.train()
    root = os.path.join(fixture_dir, "samples")
    jl = JaxLoader(JaxDataset(root + "/", os.path.join(fixture_dir, "samples.json")),
                   batch_size=4, shuffle=True, image_size=64, max_gt=128,
                   seed=trainer.config.train.seed, drop_last=True, device_put=False,
                   use_native=False)
    jl.set_epoch(1)
    jl.skip_batches(1)
    want = [j.image_ids for j in jl]
    jl.close()
    assert len(seen) == len(want) == 1
    np.testing.assert_array_equal(seen[0], want[0])


def _port_state(models, fixture_dir, tmp_path, jax_file):
    jparams, _, pcfg = models
    trainer = _trainer(fixture_dir, tmp_path, jparams, pcfg)
    trainer.resume(jax_file[0])
    return trainer


def test_encoder_reads_back_through_flax(models, fixture_dir, jax_file, tmp_path):
    """The port's ``save_as_jax`` of a resumed state: flax's own
    ``msgpack_restore`` gives the tree JAX wrote (the same leaves, dtypes
    and values), JAX's ``load_checkpoint`` takes it under its templates,
    and the port reads it back to the same bits."""
    path, params, opt_state, ema = jax_file
    trainer = _port_state(models, fixture_dir, tmp_path, jax_file)
    torch.rand(3, generator=trainer.generator)  # a state the seed does not give
    out = str(tmp_path / "port" / "epoch_1.msgpack")
    ckpt.save_as_jax(out, trainer.params, trainer._opt_state_for_checkpoint(), 1,
                     {**EXTRA, "generator_state": trainer.generator.get_state()}, clip=True)
    with open(out, "rb") as f:
        data = f.read()
    assert data.startswith(ckpt.JAX_MAGIC)
    got = serialization.msgpack_restore(data[len(ckpt.JAX_MAGIC):])
    with open(path, "rb") as f:
        want = serialization.msgpack_restore(f.read()[len(ckpt.JAX_MAGIC):])
    got_leaves = jax.tree_util.tree_flatten_with_path(got["params"])[0] + \
        jax.tree_util.tree_flatten_with_path(got["opt_state"])[0]
    want_leaves = jax.tree_util.tree_flatten_with_path(want["params"])[0] + \
        jax.tree_util.tree_flatten_with_path(want["opt_state"])[0]
    assert [p for p, _ in got_leaves] == [p for p, _ in want_leaves]
    for (p, g), (_, w) in zip(got_leaves, want_leaves):
        assert g.dtype == w.dtype and g.shape == w.shape, jax.tree_util.keystr(p)
        np.testing.assert_array_equal(g, w, err_msg=jax.tree_util.keystr(p))
    assert got["meta"]["epoch"] == 1 and got["meta"]["has_opt_state"]
    assert json.loads(got["meta"]["extra"])["loss_history"] == EXTRA["loss_history"]
    restored = jax_load(out, params, {"tx": opt_state, "ema": ema})
    assert int(_parts(restored["opt_state"]["tx"])["adam"].count) == 2

    back = ckpt.load_checkpoint(out, map_location="cpu")
    assert _equal(tree_leaves(back["params"]), tree_leaves(trainer.params))
    mine = trainer._opt_state_for_checkpoint()
    assert _equal(tree_leaves(back["opt_state"]["ema"]), tree_leaves(mine["ema"]))
    for key, value in mine["tx"].items():
        got_v = back["opt_state"]["tx"][key]
        assert _equal(got_v, value) if isinstance(value, list) else torch.equal(got_v, value)
    other = _port_state(models, fixture_dir, tmp_path, jax_file)
    other.resume(out)  # the generator rides the extras as numbers
    assert torch.equal(other.generator.get_state(), trainer.generator.get_state())


def test_codec_matches_flax_bytes_and_chunks(monkeypatch):
    """``dump_parts`` gives flax's bytes for the types a checkpoint holds; a
    chunked leaf (flax's ``MAX_CHUNK_SIZE`` lowered) decodes whole."""
    rng = np.random.default_rng(0)
    tree = {"w": rng.standard_normal((3, 5)).astype(np.float32),
            "m": np.asarray(jnp.arange(6, dtype=jnp.bfloat16)),
            "c": np.asarray(7, np.int32), "s": np.int32(3), "b": np.asarray(True),
            "meta": {"epoch": 4, "extra": json.dumps({"a": [1.5]}), "ok": False, "n": None,
                     "big": 2**40, "neg": -70000, "f": 0.25, "long": "x" * 300},
            "layers": [{"k": np.zeros((0, 2), np.float64)}, {"k": np.ones(2, np.uint8)}]}
    want = serialization.to_bytes(tree)
    mine = {**tree, "m": torch.arange(6, dtype=torch.bfloat16)}
    assert b"".join(flax_msgpack.dump_parts(flax_msgpack.state_dict(mine))) == want
    back = flax_msgpack.lists_from_state_dict(flax_msgpack.loads(bytearray(want)))
    assert back["m"].dtype == torch.bfloat16 and torch.equal(back["m"], mine["m"])
    np.testing.assert_array_equal(back["w"], tree["w"])
    assert back["w"].flags.writeable  # views of a writable buffer
    assert back["meta"] == tree["meta"] and isinstance(back["layers"], list)
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(flax_msgpack, "MAX_CHUNK_SIZE", 64)
    # (msgpack_serialize copies the tree with jax's tree_map: keys sorted)
    big = {"m": np.asarray(jnp.arange(40, dtype=jnp.bfloat16)),
           "w": np.arange(100, dtype=np.float32)}
    data = serialization.msgpack_serialize(big)
    assert b"".join(flax_msgpack.dump_parts(
        {"m": torch.arange(40, dtype=torch.bfloat16), "w": big["w"]})) == data
    back = flax_msgpack.loads(bytearray(data))
    np.testing.assert_array_equal(back["w"], big["w"])
    assert torch.equal(back["m"], torch.arange(40, dtype=torch.bfloat16))


def test_train_state_round_trip_and_k_bias_check(models, jax_file):
    path, params, opt_state, ema = jax_file
    port = train_state_from_jax(serialization.to_state_dict({"tx": opt_state, "ema": ema}))
    pparams = params_from_jax(params)
    back = train_state_from_jax(train_state_to_jax(port, pparams, clip=True))
    assert _equal(tree_leaves(back["ema"]), tree_leaves(port["ema"]))
    for key, value in port["tx"].items():
        assert _equal(back["tx"][key], value) if isinstance(value, list) \
            else torch.equal(back["tx"][key], value)
    # a K bias the port cannot hold
    sd = serialization.to_state_dict({"tx": opt_state, "ema": ema})
    layer = sd["ema"]["backbone"]["vit"]["layers"]["0"]
    layer["k"]["bias"] = np.ones(layer["q"]["bias"].shape, np.float32)
    with pytest.raises(ValueError, match="K bias"):
        train_state_from_jax(sd)
    # and a port state whose K-bias slot moved cannot be written as JAX's
    port["tx"]["nu"][[i for i, t in enumerate(tree_leaves(pparams))
                      if t is k_bias_slots(pparams)[0][0]][0]][70] = 1.0
    with pytest.raises(ValueError, match="K-bias slot"):
        train_state_to_jax(port, pparams, clip=True)


def test_resume_auto_takes_the_newest_of_pt_and_msgpack(models, fixture_dir, jax_file,
                                                       tmp_path):
    jparams, _, pcfg = models
    path, params, opt_state, ema = jax_file
    trainer = _trainer(fixture_dir, tmp_path, jparams, pcfg)
    root = trainer.checkpoint_dir()
    trainer.save_checkpoint(1)  # epoch_1.pt
    jax_save(f"{root}/epoch_2.msgpack", params, {"tx": opt_state, "ema": ema}, epoch=2,
             extra=EXTRA)
    names = [os.path.basename(p) for p in trainer.resume_candidates()]
    assert names == ["epoch_2.msgpack", "epoch_1.pt"]
    trainer.resume("auto")
    assert trainer.epoch == 2
    trainer.save_checkpoint(3)
    assert os.path.basename(trainer.resume_candidates()[0]) == "epoch_3.pt"
    with pytest.raises(NotImplementedError, match="queue 1 item 7"):
        ckpt.load_checkpoint(f"{root}/epoch_4.orbax", map_location="cpu")
    open(f"{root}/epoch_5.msgpack", "wb").close()  # truncated: auto skips it
    trainer.resume("auto")
    assert trainer.epoch == 3
