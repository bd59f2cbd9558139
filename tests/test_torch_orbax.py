"""The port's reader of JAX's sharded ``.orbax`` checkpoints
(``train/orbax_read.py``, ``train/checkpoint.py``), on the CPU:

  * the OCDBT store's keys and bytes equal tensorstore's, on the committed
    fixture and on a store whose B-tree has interior nodes and whose
    manifest has version-tree nodes;
  * JAX-written states load to the bits of JAX's ``load_checkpoint_sharded``
    (as numpy), from three writers: one process on a 4 x 2 TP mesh, FSDP
    over 8 devices, and two JAX processes (a small tree, as
    ``tests/test_distributed.py:220`` runs them);
  * a port ``resume`` of an ``.orbax`` directory equals its resume of the
    ``.msgpack`` of the same state; ``.orbax`` names rank and prune as
    JAX's;
  * the committed fixture (``tests/fixtures/orbax_fixture.py``) still equals
    a fresh JAX write's load, leaf hashes included;
  * the reader imports and reads with jax, orbax, tensorstore and
    zstandard blocked.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from flax import serialization

from layoutdit_tpu.train.checkpoint import load_checkpoint_sharded
from layoutdit_tpu.train.checkpoint import save_checkpoint as jax_save
from layoutdit_tpu_torch.config import run_config_from_dict
from layoutdit_tpu_torch.models.detection import detector as port_det
from layoutdit_tpu_torch.models.weights_io import params_from_jax, train_state_from_jax
from layoutdit_tpu_torch.train import checkpoint as ckpt
from layoutdit_tpu_torch.train import orbax_read
from layoutdit_tpu_torch.train import trainer as port_trainer
from layoutdit_tpu_torch.utils.flax_msgpack import lists_from_state_dict
from test_torch_tensor_parallel import _full_state

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tests" / "fixtures"))
import orbax_fixture  # noqa: E402

ts = pytest.importorskip("tensorstore")


def _np_bits(x) -> np.ndarray:
    """A leaf as numpy, a bf16 one as its uint16 bits."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    a = np.asarray(x)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _assert_same_tree(got, want, where=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), where
        for k in want:
            _assert_same_tree(got[k], want[k], f"{where}/{k}")
        return
    g, w = _np_bits(got), _np_bits(want)
    assert g.shape == w.shape and g.dtype == w.dtype, (where, g.dtype, w.dtype)
    np.testing.assert_array_equal(g, w, err_msg=where)


def _assert_same_store(root: Path) -> int:
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{root}/"}).result()
    keys = sorted(kv.list().result())
    store = orbax_read.OcdbtStore(str(root))
    assert store.keys() == keys
    for k in keys:
        assert store.read(k) == bytes(kv.read(k).result().value), k
    return len(keys)


def test_store_keys_and_bytes_equal_tensorstore(tmp_path):
    assert _assert_same_store(orbax_fixture.FIXTURE) > 50
    # interior B-tree nodes (300-byte nodes), out-of-line values (inline
    # up to 16 bytes) and version-tree nodes (arity 2, 5 commits)
    root = tmp_path / "store"
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{root}/",
                          "config": {"max_decoded_node_bytes": 300,
                                     "version_tree_arity_log2": 1,
                                     "max_inline_value_bytes": 16}}).result()
    for c in range(5):
        with ts.Transaction() as txn:
            for i in range(40):
                kv.with_transaction(txn).write(f"key{c}_{i:03d}",
                                               f"value {c} {i} " * (1 + i % 5)).result()
    assert _assert_same_store(root) == 200
    assert len(list((root / "d").iterdir())) > 1


@pytest.fixture(scope="module")
def tp_written(tmp_path_factory):
    """The fixture's state written by JAX from a 4 x 2 TP mesh -> (path,
    the placed params and opt_state)."""
    path = str(tmp_path_factory.mktemp("orbax") / "epoch_2.orbax")
    return (path, *orbax_fixture.write(path))


def _host(a):
    """A JAX leaf as the msgpack reader gives it: numpy, bf16 as a
    ``torch.bfloat16`` tensor."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    return a


def _jax_loaded(path, params_t, opt_t):
    state = load_checkpoint_sharded(path, params_t, opt_t)
    host = lambda t: serialization.to_state_dict(jax.tree_util.tree_map(_host, t))  # noqa
    return host(state["params"]), host(state["opt_state"]), state


@pytest.mark.parametrize("fsdp", [False, True], ids=["tp_4x2", "fsdp_8"])
def test_loads_the_bits_of_jax_load(tmp_path, tp_written, fsdp):
    if fsdp:
        path = str(tmp_path / "epoch_2.orbax")
        params_t, opt_t = orbax_fixture.write(path, fsdp=True)
    else:
        path, params_t, opt_t = tp_written
    jparams, jopt, jstate = _jax_loaded(path, params_t, opt_t)
    raw = orbax_read.read_tree(path)
    _assert_same_tree(raw["params"], jparams, "params")
    _assert_same_tree(raw["opt_state"]["ema"], jopt["ema"], "ema")
    _assert_same_tree(raw["opt_state"]["tx"]["inner_state"], jopt["tx"]["inner_state"], "tx")
    # mapped: the port's state of JAX's trees, to the bits
    got = ckpt.load_checkpoint(path, map_location="cpu")
    want_p = params_from_jax(lists_from_state_dict(jparams))
    want_o = train_state_from_jax(jopt, "cpu", jparams)
    assert orbax_fixture.leaf_hashes(got) == orbax_fixture.leaf_hashes(
        {"params": want_p, "opt_state": want_o})
    assert (got["epoch"], got["extra"]) == (jstate["epoch"], jstate["extra"])
    assert got["extra"] == orbax_fixture.EXTRA


_TWO_PROCESS_WRITER = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_cpu_collectives_implementation", "gloo")
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from layoutdit_tpu.config.constructs import MeshConfig
from layoutdit_tpu.parallel.mesh import build_mesh, maybe_distributed_init
from layoutdit_tpu.train.checkpoint import save_checkpoint_sharded

pid, port, path = int(sys.argv[1]), sys.argv[2], sys.argv[3]
maybe_distributed_init(MeshConfig(enable_distributed_init=True,
                                  coordinator_address=f"localhost:{port}", num_processes=2,
                                  process_id=pid, heartbeat_timeout_s=300,
                                  shutdown_timeout_s=300))
assert jax.process_count() == 2 and jax.device_count() == 4
mesh = build_mesh(MeshConfig(data_parallel=2, model_parallel=2))
tree = {"w": np.arange(8 * 12, dtype=np.float32).reshape(8, 12) / 7,
        "b": np.arange(6, dtype=np.int32),
        "m": (np.arange(16 * 4, dtype=np.float32).reshape(16, 4) / 3).astype(jax.numpy.bfloat16)}
specs = {"w": P("data", "model"), "b": P(), "m": P("model", None)}
placed = {k: jax.make_array_from_callback(v.shape, NamedSharding(mesh, specs[k]),
                                          lambda idx, v=v: v[idx]) for k, v in tree.items()}
save_checkpoint_sharded(path, placed, None, epoch=3, extra={"who": "two processes"})
print("WROTE", pid, flush=True)
"""


def test_two_jax_processes_write_what_the_port_reads(tmp_path):
    from layoutdit_tpu_torch.parallel.mesh import free_port

    script = tmp_path / "writer.py"
    script.write_text(_TWO_PROCESS_WRITER)
    path = str(tmp_path / "epoch_3.orbax")
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = str(REPO)
    port = free_port()
    procs = [subprocess.Popen([sys.executable, str(script), str(i), str(port), path],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env, cwd=REPO) for i in range(2)]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    assert (Path(path) / "ocdbt.process_1").is_dir()
    raw = orbax_read.read_tree(path)["params"]
    tree = {"w": np.arange(8 * 12, dtype=np.float32).reshape(8, 12) / 7,
            "b": np.arange(6, dtype=np.int32),
            "m": (np.arange(16 * 4, dtype=np.float32).reshape(16, 4) / 3)
            .astype(jax.numpy.bfloat16)}
    # JAX's own load of the same directory, in this (one) process
    one = jax.sharding.SingleDeviceSharding(jax.devices()[0])
    templates = {k: jax.ShapeDtypeStruct(v.shape, v.dtype, sharding=one)
                 for k, v in tree.items()}
    jparams = jax.tree_util.tree_map(_host, load_checkpoint_sharded(path, templates)["params"])
    want = {k: _host(v) for k, v in tree.items()}
    _assert_same_tree(raw, jparams)
    _assert_same_tree(raw, want)
    assert orbax_read.read_meta(path) == {"epoch": 3, "extra": {"who": "two processes"},
                                          "has_opt_state": False}
    # without the merged root manifest, from the two process stores
    os.remove(Path(path) / "manifest.ocdbt")
    _assert_same_tree(orbax_read.read_tree(path)["params"], want)


def _trainer(fixture_dir_path: Path, tmp_path: Path):
    """A port trainer of the fixture's RetinaNet and its run state."""
    from layoutdit_tpu_torch.tools.make_fixture import make_fixture, write_fixture_config

    make_fixture(str(fixture_dir_path), n_images=4, split="samples", seed=1)
    with open(write_fixture_config(str(fixture_dir_path), epochs=2, batch_size=2)) as f:
        raw = json.load(f)
    raw["eval_config"]["eval_base_path"] = str(tmp_path)
    raw["detection_model_config"] = {
        "detector": "retinanet", "num_classes": 3, "image_size": 64, "fpn_out_channels": 8,
        "vit_overrides": {"hidden_size": 16, "num_hidden_layers": 2, "num_attention_heads": 2,
                          "intermediate_size": 32, "patch_size": 8}}
    raw["precision"] = {"compute_dtype": "float32"}
    raw["train_config"].update(weight_decay=0.01, grad_clip_norm=1.0,
                               adam_mu_dtype="bfloat16", skip_nonfinite_updates=2,
                               ema_decay=0.9, tensorboard=False)
    rc = run_config_from_dict(raw)
    cfg = port_det.DetectorConfig.from_model_config(rc.model, rc.compute_dtype)
    model = port_det.DetectorModel(port_det.init_detector(cfg, torch.Generator().manual_seed(3),
                                                          device="cpu"), cfg)
    return port_trainer.Trainer(rc, model, device="cpu")


def test_resume_from_orbax_equals_resume_from_msgpack(tmp_path, tp_written):
    """The fixture's state, written by JAX as ``.orbax`` and as
    ``.msgpack``: the port's two resumes give the same bits, epoch and
    extras; ``resume("auto")`` ranks the directory as JAX does, and
    ``prune_checkpoints`` removes it with its ``.meta.json``."""
    params, opt = orbax_fixture.state()
    runs = {}
    for kind in ("orbax", "msgpack"):
        trainer = _trainer(tmp_path / f"data_{kind}", tmp_path / kind)
        root = Path(trainer.checkpoint_dir())
        root.mkdir(parents=True, exist_ok=True)
        path = root / f"epoch_2.{kind}"
        if kind == "orbax":
            shutil.copytree(tp_written[0], path)
            shutil.copy(f"{tp_written[0]}.meta.json", f"{path}.meta.json")
        else:
            jax_save(str(path), params, opt, epoch=2, extra=orbax_fixture.EXTRA)
        assert [os.path.basename(p) for p in trainer.resume_candidates()] == [path.name]
        trainer.resume("auto")
        runs[kind] = (_full_state(trainer), trainer.epoch, trainer.loss_history, trainer.updates)
        trainer.dataloader.close()
    (a, *ra), (b, *rb) = runs["orbax"], runs["msgpack"]
    assert ra == rb == [2, [1.5], 2]
    assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
    # JAX's names and retention: a preemption save outranks its epoch's,
    # pruning deletes a directory and its sidecar
    root = tmp_path / "prune"
    for name in ("epoch_1.orbax", "epoch_3.orbax", "epoch_3_preempt.orbax"):
        shutil.copytree(tp_written[0], root / name)
        shutil.copy(f"{tp_written[0]}.meta.json", root / f"{name}.meta.json")
    cands = [os.path.basename(p) for _, _, p in ckpt.list_resume_candidates(str(root))]
    assert cands == ["epoch_3_preempt.orbax", "epoch_3.orbax", "epoch_1.orbax"]
    deleted = ckpt.prune_checkpoints(str(root), keep=1, current_epoch=3)
    assert [os.path.basename(p) for p in deleted] == ["epoch_1.orbax"]
    assert not (root / "epoch_1.orbax").exists()
    assert not (root / "epoch_1.orbax.meta.json").exists()
    assert (root / "epoch_3.orbax.meta.json").exists()


def test_model_restore_takes_orbax(tp_written):
    """``LayoutDetectionModel.restore_checkpoint`` (what ``predict``,
    ``export_model`` and ``serve`` call) copies an ``.orbax`` directory's
    parameters in place."""
    from layoutdit_tpu_torch.models.model import LayoutDetectionModel
    from layoutdit_tpu_torch.models.weights_io import tree_leaves, tree_map

    want = ckpt.load_checkpoint(tp_written[0], map_location="cpu")
    model = object.__new__(LayoutDetectionModel)  # the shell without a config
    model.device = torch.device("cpu")
    model.params = tree_map(torch.zeros_like, want["params"])
    state = model.restore_checkpoint(tp_written[0])
    assert state["epoch"] == 2
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(model.params),
                                                 tree_leaves(want["params"])))


def test_committed_fixture_equals_a_fresh_write(tp_written):
    fresh = ckpt.load_checkpoint(tp_written[0], map_location="cpu")
    committed = ckpt.load_checkpoint(str(orbax_fixture.FIXTURE), map_location="cpu")
    hashes = orbax_fixture.leaf_hashes(committed)
    assert hashes == orbax_fixture.leaf_hashes(fresh)
    assert hashes == json.loads(orbax_fixture.HASHES.read_text())
    assert committed["epoch"] == 2 and committed["extra"] == orbax_fixture.EXTRA
    size = sum(p.stat().st_size for p in orbax_fixture.HERE.rglob("*") if p.is_file())
    assert size < 2 ** 20


def test_reader_runs_with_jax_orbax_tensorstore_zstandard_blocked():
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'orbax',\n"
        "                                  'tensorstore', 'zstandard', 'layoutdit_tpu',\n"
        "                                  'msgpack', 'pydantic', 'fsspec'):\n"
        "            raise ImportError('blocked ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import json\n"
        "from layoutdit_tpu_torch.train.checkpoint import load_checkpoint\n"
        f"state = load_checkpoint({str(orbax_fixture.FIXTURE)!r}, map_location='cpu')\n"
        "print('epoch', state['epoch'], len(state['opt_state']['tx']['mu']))\n"
    )
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "epoch 2" in out.stdout
