"""Preemption, mid-epoch resume and the checkpoint helpers of the port's
trainer on the CPU, at tiny widths: a SIGTERM mid-epoch and one after a
completed epoch, then ``resume("auto")``, equal the uninterrupted run
bit for bit (``tests/test_resume_midepoch.py``, ``tests/test_e2e.py``);
retention and the resume candidates against the JAX package's on the
same names; the asynchronous writer; old checkpoints refused."""

import dataclasses
import json
import os
import signal

import pytest
import torch

from layoutdit_tpu.train.checkpoint import list_resume_candidates as jax_candidates
from layoutdit_tpu.train.checkpoint import prune_checkpoints as jax_prune
from layoutdit_tpu_torch.config import load_run_config
from layoutdit_tpu_torch.models.model import build_model
from layoutdit_tpu_torch.models.weights_io import tree_leaves
from layoutdit_tpu_torch.tools.make_fixture import make_fixture, write_fixture_config
from layoutdit_tpu_torch.train import checkpoint as ckpt
from layoutdit_tpu_torch.train.trainer import Trainer

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

IMAGE_SIZE = 64
# every piece of run state at once: EMA, bf16 moments, non-finite
# skipping, async periodic saves with retention
RUN_STATE = dict(ema_decay=0.9, adam_mu_dtype="bfloat16", skip_nonfinite_updates=2,
                 checkpoint_interval=1, keep_checkpoints=2, async_checkpoint=True)


def _fixture(root, epochs, seed=5, **train) -> str:
    make_fixture(root, n_images=8, split="samples", seed=seed)
    path = write_fixture_config(root, epochs=epochs, batch_size=4, tiny_model=True)
    with open(path) as f:
        raw = json.load(f)
    raw["detection_model_config"]["image_size"] = IMAGE_SIZE
    raw["train_config"].update(train)
    with open(path, "w") as f:
        json.dump(raw, f)
    return path


def _trainer(path, run_name="fixture"):
    rc = dataclasses.replace(load_run_config(path), run_name=run_name)
    return Trainer(rc, build_model(rc, device="cpu"), device="cpu")


def _state(trainer) -> list[torch.Tensor]:
    """Parameters, EMA, moments and counts."""
    st = trainer.opt_state
    return (tree_leaves(trainer.params) + tree_leaves(trainer.ema_params) + st["mu"] + st["nu"]
            + [st["count"], st["schedule_count"], st["notfinite_count"],
               st["total_notfinite"]])


def _assert_same_state(a, b):
    for x, y in zip(_state(a), _state(b), strict=True):
        assert torch.equal(x, y)
    assert a.updates == b.updates and a.epoch == b.epoch


def _sigterm_after(trainer, method: str, when):
    """Send this process SIGTERM from inside ``method`` once ``when(n)``
    holds for its n-th call (the handler runs in the main thread at the
    next bytecode boundary: deterministic, no timers)."""
    real = getattr(trainer, method)
    calls = {"n": 0}

    def wrapped(*a, **kw):
        out = real(*a, **kw)
        calls["n"] += 1
        if when(calls["n"], *a):
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    setattr(trainer, method, wrapped)


def test_midepoch_preempt_and_resume_match_uninterrupted_run(tmp_path):
    """SIGTERM in step 1 of epoch 2 (2 steps an epoch, 3 epochs): the
    in-flight step finishes, ``epoch_1_preempt.pt`` records step 1, and a
    fresh trainer's ``resume("auto")`` prefers it to ``epoch_1.pt``, runs
    the remaining 3 steps and ends with the uninterrupted run's
    parameters, EMA, moments and counts."""
    path = _fixture(str(tmp_path), epochs=3, **RUN_STATE)
    uninterrupted = _trainer(path, run_name="a")
    uninterrupted.train()

    preempted = _trainer(path)
    previous = signal.getsignal(signal.SIGTERM)
    _sigterm_after(preempted, "_dispatch", lambda n, *a: n == 3)
    preempted.train()
    assert signal.getsignal(signal.SIGTERM) == previous
    assert preempted.epoch == 1 and preempted._partial_steps == 1 and preempted.updates == 3
    run = os.path.join(str(tmp_path), "fixture", "model_checkpoints")
    assert sorted(os.listdir(run)) == ["epoch_1.pt", "epoch_1_preempt.pt"]
    saved = ckpt.load_checkpoint(os.path.join(run, "epoch_1_preempt.pt"), "cpu")
    assert saved["epoch"] == 1 and saved["extra"]["step_in_epoch"] == 1

    resumed = _trainer(path)
    resumed.resume("auto")
    assert resumed.epoch == 1 and resumed._start_step == 1 and resumed.updates == 3
    resumed.train()
    _assert_same_state(resumed, uninterrupted)
    # retention: the two newest periodic saves; the preemption's stays
    assert sorted(os.listdir(run)) == ["epoch_1_preempt.pt", "epoch_2.pt", "epoch_3.pt"]


def test_preempt_after_a_completed_epoch_resumes_at_the_next(tmp_path):
    """A SIGTERM after an epoch's last step saves ``epoch_1_preempt.pt``
    at step 0 of the next epoch, which the resume does not train again."""
    path = _fixture(str(tmp_path), epochs=2, seed=31, ema_decay=0.9, checkpoint_interval=100)
    uninterrupted = _trainer(path, run_name="a")
    uninterrupted.train()

    preempted = _trainer(path)
    _sigterm_after(preempted, "_run_epoch", lambda n, epoch: epoch == 0)
    preempted.train()
    assert preempted._partial_steps == 0 and preempted.epoch == 1
    run = os.path.join(str(tmp_path), "fixture", "model_checkpoints")
    assert os.listdir(run) == ["epoch_1_preempt.pt"]

    resumed = _trainer(path)
    resumed.resume("auto")
    assert resumed.epoch == 1 and resumed._start_step == 0
    resumed.train()
    for a, b in zip(tree_leaves(resumed.params) + tree_leaves(resumed.ema_params),
                    tree_leaves(uninterrupted.params) + tree_leaves(uninterrupted.ema_params),
                    strict=True):
        assert torch.equal(a, b)
    assert resumed.loss_history == uninterrupted.loss_history


def test_resume_adopts_the_checkpoints_steps_per_dispatch(tmp_path):
    path = _fixture(str(tmp_path), epochs=1, steps_per_dispatch=2, checkpoint_interval=1)
    first = _trainer(path)
    first.train()
    rc = load_run_config(path)
    rc = dataclasses.replace(rc, train=dataclasses.replace(rc.train, steps_per_dispatch=0))
    other = Trainer(rc, build_model(rc, device="cpu"), device="cpu")
    assert other.steps_per_dispatch == 1
    other.resume("auto")
    assert other.steps_per_dispatch == other.dataloader.stack_batches == 2


_NAMES = ("epoch_1", "epoch_2", "epoch_3", "epoch_10", "epoch_2_preempt", "epoch_3_preempt",
          "epoch_3_other", "best")


@pytest.mark.parametrize("keep,current", [(2, 4), (1, 3), (3, 10), (0, 5)])
def test_retention_and_resume_candidates_match_jax(tmp_path, keep, current):
    """``prune_checkpoints`` deletes the same files as JAX's, and
    ``list_resume_candidates`` lists the rest in JAX's order."""
    roots = {}
    for ext in ("msgpack", "pt"):
        roots[ext] = str(tmp_path / ext)
        os.makedirs(roots[ext])
        for name in _NAMES + ("epoch_4.tmp",):
            open(os.path.join(roots[ext], f"{name}.{ext}"), "w").close()

    def stems(paths):
        return sorted(os.path.basename(p).rsplit(".", 1)[0] for p in paths)

    assert stems(ckpt.prune_checkpoints(roots["pt"], keep, current)) == \
        stems(jax_prune(roots["msgpack"], keep, current))
    assert stems(os.listdir(roots["pt"])) == stems(os.listdir(roots["msgpack"]))
    got = [(e, r, os.path.basename(p)[:-3]) for e, r, p in ckpt.list_resume_candidates(roots["pt"])]
    want = [(e, r, os.path.basename(p)[:-8]) for e, r, p in jax_candidates(roots["msgpack"])]
    assert got == want and got
    assert ckpt.list_resume_candidates(str(tmp_path / "missing")) == []


def test_async_writer_snapshots_before_save_returns(tmp_path, monkeypatch):
    """The async file equals the sync one although the parameters, the
    moments and the extras change right after ``save`` returns; a write's
    error surfaces at ``wait``."""
    params = {"w": torch.arange(6.0).reshape(2, 3), "b": [torch.ones(2)]}
    opt = {"mu": [torch.zeros(2, 3, dtype=torch.bfloat16)], "count": torch.tensor(3)}
    extra = {"loss_history": [1.0], "generator_state": torch.Generator().get_state()}
    sync = ckpt.save_checkpoint(str(tmp_path / "sync.pt"), params, opt, 2, extra)

    import threading

    release = threading.Event()
    real = ckpt.save_checkpoint

    def held(*a):
        release.wait(timeout=30)
        return real(*a)

    monkeypatch.setattr(ckpt, "save_checkpoint", held)
    writer = ckpt.AsyncCheckpointWriter()
    try:
        writer.save(str(tmp_path / "async.pt"), params, opt, 2, extra)
        params["w"].add_(1.0)
        params["b"][0].zero_()
        opt["mu"][0].fill_(5)
        extra["loss_history"].append(2.0)
        release.set()
        writer.wait()
        a, b = ckpt.load_checkpoint(sync, "cpu"), ckpt.load_checkpoint(
            str(tmp_path / "async.pt"), "cpu")
        assert a["epoch"] == b["epoch"] == 2 and a["extra"]["loss_history"] == [1.0]
        assert b["extra"]["loss_history"] == [1.0]
        for x, y in zip(tree_leaves(a["params"]) + a["opt_state"]["mu"],
                        tree_leaves(b["params"]) + b["opt_state"]["mu"], strict=True):
            assert torch.equal(x, y) and x.dtype == y.dtype
        assert torch.equal(a["extra"]["generator_state"], b["extra"]["generator_state"])

        open(tmp_path / "file", "w").close()
        writer.save(str(tmp_path / "file" / "x.pt"), params, opt, 3, extra)  # parent is a file
        with pytest.raises(OSError):
            writer.wait()
    finally:
        release.set()
        writer.close()


def test_resume_refuses_a_foreign_optimizer_state(tmp_path):
    """A checkpoint whose optimizer state is a ``torch.optim`` state_dict
    raises, naming the format, though its weights still load into a
    model; so does one whose moments another ``adam_mu_dtype`` wrote."""
    path = _fixture(str(tmp_path), epochs=1)
    trainer = _trainer(path)
    old = ckpt.checkpoint_file(trainer.config.artifact_dir, 1)
    ckpt.save_checkpoint(old, {k: v for k, v in trainer.params.items()},
                         {"state": {}, "param_groups": [{"lr": 1e-4}]}, 1, {})
    with pytest.raises(ValueError, match="torch.optim.AdamW state_dict"):
        trainer.resume(old)
    build_model(trainer.config, device="cpu").restore_checkpoint(old)
    # a run whose optimizer settings differ from the checkpoint's
    trainer.save_checkpoint(1)
    other = _trainer(_fixture(str(tmp_path), epochs=1, adam_mu_dtype="bfloat16"))
    with pytest.raises(ValueError, match="does not match this run's"):
        other.resume(trainer.checkpoint_path(1))
