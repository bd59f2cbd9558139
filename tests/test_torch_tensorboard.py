"""The port's TensorBoard event files (``utils/tensorboard.py``) against
the JAX package's writer, byte for byte, and in the trainer: each
epoch's record as ``train/{key}`` scalars equal to ``metrics.jsonl``,
and the loss curve at the end of ``train()``."""

import json
import os
import time

import pytest
import torch

from layoutdit_tpu.utils import tensorboard as jax_tb
from layoutdit_tpu_torch.config import load_run_config
from layoutdit_tpu_torch.models.model import build_model
from layoutdit_tpu_torch.tools.make_fixture import make_fixture, write_fixture_config
from layoutdit_tpu_torch.train.trainer import Trainer
from layoutdit_tpu_torch.utils import tensorboard as tb

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)


@pytest.mark.parametrize("data,crc", [(b"", 0), (b"123456789", 0xE3069283),
                                      (b"\x00" * 32, 0x8A9136AA)])
def test_crc32c_known_vectors(data, crc):
    assert tb.crc32c(data) == crc == jax_tb.crc32c(data)


def test_writer_bytes_equal_jax_writers(tmp_path, monkeypatch):
    """The same scalars at the same (injected) wall times give the same
    file name and bytes, which ``read_events`` parses back."""
    clock = iter(1700000000.25 + 0.5 * i for i in range(100))
    now = {"t": 0.0}

    def fake_time():
        return now["t"]

    monkeypatch.setattr(time, "time", fake_time)
    writers = []
    for mod, sub in ((jax_tb, "jax"), (tb, "port")):
        now["t"] = 1700000000.0
        kw = {"fs_open": lambda p, m, auto_mkdir: _open(p, m)} if mod is jax_tb else {}
        writers.append(mod.TensorBoardWriter(str(tmp_path / sub), **kw))
    values = [({"train/loss": 2.5, "train/images_per_sec": 31.25, "train/name": "x"}, 1),
              ({"train/loss": 1.125, "train/learning_rate": 1e-4, "train/mAP": 0.5}, 2)]
    for step_values, step in values:
        t = next(clock)
        for w in writers:
            now["t"] = t
            w.scalars(step_values, step=step)
    now["t"] = 1700000009.0
    for w in writers:
        w.scalar("train/extra", 7.0, step=3, wall_time=1700000010.5)
        w.close()
    jw, pw = writers
    assert os.path.basename(jw.path) == os.path.basename(pw.path)
    with open(jw.path, "rb") as f, open(pw.path, "rb") as g:
        assert f.read() == g.read()
    events = tb.read_events(pw.path)
    assert events[0]["file_version"] == "brain.Event:2"
    assert [(e["step"], e["wall_time"]) for e in events[1:]] == \
        [(1, 1700000000.25), (2, 1700000000.75), (3, 1700000010.5)]
    assert events[1]["scalars"] == {"train/loss": 2.5, "train/images_per_sec": 31.25}
    assert events[2]["scalars"]["train/learning_rate"] == pytest.approx(1e-4, rel=1e-7)


def _open(path, mode):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    return open(path, mode)


def test_read_events_checks_the_crcs(tmp_path):
    w = tb.TensorBoardWriter(str(tmp_path))
    w.scalar("train/loss", 1.0, step=1)
    w.close()
    with open(w.path, "rb") as f:
        data = bytearray(f.read())
    data[-6] ^= 0x01  # a bit of the last record's payload
    with open(w.path, "wb") as f:
        f.write(bytes(data))
    with pytest.raises(ValueError, match="bad data CRC"):
        tb.read_events(w.path)


def test_trainer_writes_events_and_the_loss_curve(tmp_path):
    """With the default ``tensorboard`` true, ``{run}/tb`` holds one event
    per epoch whose ``train/{key}`` scalars equal ``metrics.jsonl``'s
    record (as float32), and ``train()`` ends with the loss curve."""
    root = str(tmp_path)
    make_fixture(root, n_images=4, split="samples", seed=6)
    path = write_fixture_config(root, epochs=2, batch_size=4, tiny_model=True)
    with open(path) as f:
        raw = json.load(f)
    raw["detection_model_config"]["image_size"] = 64
    raw["train_config"]["skip_nonfinite_updates"] = 1
    with open(path, "w") as f:
        json.dump(raw, f)
    rc = load_run_config(path)
    assert rc.train.tensorboard
    Trainer(rc, build_model(rc, device="cpu"), device="cpu").train()
    run = os.path.join(root, "fixture")
    (name,) = os.listdir(os.path.join(run, "tb"))
    events = tb.read_events(os.path.join(run, "tb", name))[1:]
    with open(os.path.join(run, "metrics", "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    assert [e["step"] for e in events] == [r["epoch"] for r in records] == [1, 2]
    for e, r in zip(events, records):
        assert set(e["scalars"]) == {f"train/{k}" for k in r if k != "epoch"}
        assert "train/skipped_nonfinite_steps" in e["scalars"]
        for k, v in r.items():
            if k != "epoch":
                assert e["scalars"][f"train/{k}"] == pytest.approx(v, rel=1e-6, abs=1e-30)
    assert os.path.getsize(os.path.join(run, "loss_history", "loss_curve.png")) > 0
