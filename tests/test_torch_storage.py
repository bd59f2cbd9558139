"""Storage paths in the port (``utils/paths.py``, ``utils/retry.py``) over
a filesystem that is not local disk: the cases of
``tests/test_memory_fs.py`` on fsspec's ``memory://`` (config probe,
checkpoint round trip, and ``main``'s artifacts with JAX's names), the
asynchronous checkpoint writer there, ``join_path`` against JAX's, and
``retry_io``'s attempts and backoff against JAX's."""

import json
import os
import threading

import fsspec
import numpy as np
import pytest
import torch

from layoutdit_tpu.utils import retry as jax_retry
from layoutdit_tpu.utils.paths import join_path as jax_join_path
from layoutdit_tpu_torch import main as port_main
from layoutdit_tpu_torch.config import get_run_config, load_run_config
from layoutdit_tpu_torch.tools.make_fixture import make_fixture, write_fixture_config
from layoutdit_tpu_torch.train import checkpoint as ckpt
from layoutdit_tpu_torch.utils import paths
from layoutdit_tpu_torch.utils import retry as port_retry

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

BUCKET = "memory://ldtpu-port-bucket"


@pytest.fixture
def memfs():
    fs = fsspec.filesystem("memory")
    yield fs
    try:
        fs.rm("/ldtpu-port-bucket", recursive=True)
    except FileNotFoundError:
        pass


def test_config_probe_over_memory(memfs, monkeypatch):
    path = BUCKET + "/cfg/layout_dit_config.json"
    with fsspec.open(path, "w") as f:
        json.dump({"run_name": "from-mem"}, f)
    assert load_run_config(path).run_name == "from-mem"
    monkeypatch.setenv("LAYOUTDIT_CONFIG", path)
    assert get_run_config().run_name == "from-mem"
    monkeypatch.setenv("LAYOUTDIT_CONFIG", BUCKET + "/cfg/absent.json")
    with pytest.raises(FileNotFoundError, match="absent.json"):
        get_run_config()


def test_checkpoint_roundtrip_over_memory(memfs):
    params = {"w": torch.arange(12.0).reshape(3, 4), "b": {"x": torch.ones(5)}}
    opt = {"mu": [torch.zeros(3, dtype=torch.bfloat16)], "count": torch.tensor(3)}
    path = BUCKET + "/ckpt/model_checkpoints/epoch_3.pt"
    ckpt.save_checkpoint(path, params, opt, epoch=3, extra={"note": "mem"})
    state = ckpt.load_checkpoint(path, map_location="cpu")
    assert torch.equal(state["params"]["w"], params["w"])
    assert state["epoch"] == 3 and state["extra"]["note"] == "mem"
    assert memfs.exists("/ldtpu-port-bucket/ckpt/model_checkpoints/epoch_3.pt")
    assert not [p for p in memfs.ls("/ldtpu-port-bucket/ckpt/model_checkpoints", detail=False)
                if p.endswith(".tmp")]
    # the asynchronous writer, whose worker thread opens its own filesystem
    writer = ckpt.AsyncCheckpointWriter()
    try:
        writer.save(BUCKET + "/ckpt/model_checkpoints/epoch_4.pt", params, opt, 4, {})
        writer.save(BUCKET + "/ckpt/model_checkpoints/epoch_5_preempt.pt", params, opt, 5, {})
    finally:
        writer.close()
    root = BUCKET + "/ckpt/model_checkpoints"
    assert [os.path.basename(p) for _, _, p in ckpt.list_resume_candidates(root)] == \
        ["epoch_5_preempt.pt", "epoch_4.pt", "epoch_3.pt"]
    assert [os.path.basename(p) for p in ckpt.prune_checkpoints(root, 1, 4)] == ["epoch_3.pt"]
    assert ckpt.list_resume_candidates(BUCKET + "/absent") == []


@pytest.mark.parametrize("ext", ["pt", "msgpack"])
def test_local_checkpoints_take_pathlib_paths(tmp_path, ext):
    """Local checkpoint paths may be ``pathlib.Path``s, as for ``torch.load``."""
    from layoutdit_tpu_torch.models.backbone import BackboneConfig
    from layoutdit_tpu_torch.models.detection.detector import DetectorConfig, init_detector
    from layoutdit_tpu_torch.models.vit import ViTConfig
    from layoutdit_tpu_torch.models.weights_io import tree_leaves

    cfg = DetectorConfig(backbone=BackboneConfig(
        vit=ViTConfig(hidden_size=32, num_hidden_layers=1, num_attention_heads=2,
                      intermediate_size=64, image_size=64), fpn_out_channels=16), image_size=64)
    params = init_detector(cfg, torch.Generator().manual_seed(0), device="cpu")
    path = tmp_path / "model_checkpoints" / f"epoch_2.{ext}"
    if ext == "pt":
        ckpt.save_checkpoint(path, params, None, 2, {"a": 1})
    else:
        ckpt.save_as_jax(path, params, None, 2, {"a": 1}, clip=False)
    state = ckpt.load_checkpoint(path, map_location="cpu")
    assert state["epoch"] == 2 and state["extra"] == {"a": 1} and state["opt_state"] is None
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(state["params"]), tree_leaves(params), strict=True))


def test_e2e_artifacts_over_memory(tmp_path, memfs, monkeypatch):
    """``main`` trains, checkpoints, scores and draws with every run
    artifact on memory:// (the pages stay local; the config is read from
    memory://), then resumes from the memory:// checkpoint."""
    root = str(tmp_path / "fix")
    os.makedirs(root)
    make_fixture(root, n_images=8, split="samples", seed=2)
    with open(write_fixture_config(root, epochs=1, batch_size=4, tiny_model=True)) as f:
        raw = json.load(f)
    raw["detection_model_config"]["image_size"] = 64
    raw["run_name"] = "memrun"
    raw["eval_config"]["eval_base_path"] = BUCKET
    cfg_url = BUCKET + "/cfg.json"
    with fsspec.open(cfg_url, "w") as f:
        json.dump(raw, f)
    monkeypatch.setenv("LAYOUTDIT_CONFIG", cfg_url)
    port_main.main(["--device", "cpu", "--local_mode"])
    run = "/ldtpu-port-bucket/memrun"
    for name in ("model_checkpoints/epoch_1.pt", "loss_history/loss_curve.png",
                 "predictions.json", "visualizations_preds/1.jpg", "visualizations_gt/1.jpg",
                 "metrics/metrics.jsonl"):
        assert memfs.exists(f"{run}/{name}"), name
    assert memfs.ls(f"{run}/tb", detail=False)
    with fsspec.open(f"memory://{run}/metrics/metrics.jsonl") as f:
        assert np.isfinite(json.loads(f.readline())["loss"])

    # resume straight from the memory:// checkpoint, one more epoch
    raw["train_config"]["num_epochs"] = 2
    with fsspec.open(cfg_url, "w") as f:
        json.dump(raw, f)
    port_main.main(["--device", "cpu", "--local_mode", "--skip-eval", "--resume",
                    f"memory://{run}/model_checkpoints/epoch_1.pt"])
    state = ckpt.load_checkpoint(f"memory://{run}/model_checkpoints/epoch_2.pt", "cpu")
    assert state["epoch"] == 2 and len(state["extra"]["loss_history"]) == 2


@pytest.mark.parametrize("root,parts", [
    ("gs://bucket/data/", ("val/", "x.jpg")),
    ("memory://b", ("/a/", "/b.json")),
    ("/tmp/local", ("val", "x.jpg")),
    ("relative/dir/", ("x.jpg",)),
])
def test_join_path_matches_jax(root, parts):
    assert paths.join_path(root, *parts) == jax_join_path(root, *parts)


def test_local_paths_need_no_fsspec(tmp_path, monkeypatch):
    """With fsspec unimportable, local paths work and a URL raises an
    error that names it (in a fresh thread: filesystems are per thread)."""
    monkeypatch.setitem(__import__("sys").modules, "fsspec", None)
    local = str(tmp_path / "a" / "b.bin")
    with paths.open_path(local, "wb") as f:
        f.write(b"xyz")
    assert bytes(paths.read_bytearray(local)) == b"xyz"
    assert paths.fs_for(str(tmp_path / "a")).listdir(str(tmp_path / "a")) == ["b.bin"]
    errors = []

    def probe():
        try:
            paths.open_path("gs://no-bucket/x.json", "rb")
        except ImportError as e:
            errors.append(str(e))

    t = threading.Thread(target=probe)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive() and errors and "gs://no-bucket/x.json" in errors[0]


def _flaky(fail_times, exc):
    calls = []

    def fn(x):
        calls.append(x)
        if len(calls) <= fail_times:
            raise exc
        return x * 2
    return fn, calls


@pytest.mark.parametrize("fail_times,exc", [(0, OSError("x")), (2, OSError("5xx")),
                                            (3, ConnectionError("reset")),
                                            (4, OSError("down")), (1, ValueError("bad"))])
def test_retry_io_matches_jax(monkeypatch, fail_times, exc):
    """The same attempts (4), delays (0.5 doubling) and outcome as JAX's
    ``retry_io``; a non-I/O error is not retried."""
    outcome = {}
    for name, mod in (("jax", jax_retry), ("port", port_retry)):
        sleeps = []
        monkeypatch.setattr(mod.time, "sleep", sleeps.append)
        fn, calls = _flaky(fail_times, exc)
        try:
            result = mod.retry_io(fn)(21)
        except Exception as e:  # noqa: BLE001 (the outcome is compared)
            result = type(e).__name__
        outcome[name] = (result, len(calls), list(sleeps))
    assert outcome["port"] == outcome["jax"]
    result, n_calls, sleeps = outcome["port"]
    if isinstance(exc, OSError):
        assert n_calls == min(fail_times + 1, 4) and sleeps == [0.5, 1.0, 2.0][:n_calls - 1]
    else:
        assert n_calls == 1 and sleeps == [] and result == "ValueError"
