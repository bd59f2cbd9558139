"""Tar-sharded page storage in the port (``data/shards.py``,
``tools/make_shards.py``): the cases of ``tests/test_shards.py``, the
two packages reading each other's shards byte for byte, and a sharded
train epoch equal, bit for bit, to the same epoch over plain files."""

import dataclasses
import json
import os
import tarfile

import numpy as np
import pytest
import torch

from layoutdit_tpu.data.shards import ShardIndex as JaxShardIndex
from layoutdit_tpu.data.shards import build_shards as jax_build_shards
from layoutdit_tpu.tools.make_shards import main as jax_make_shards
from layoutdit_tpu_torch.config import load_run_config
from layoutdit_tpu_torch.data.dataset import PubLayNetDataset
from layoutdit_tpu_torch.data.pipeline import DetectionLoader
from layoutdit_tpu_torch.data.shards import ShardIndex, build_shards, make_sharded_dataset
from layoutdit_tpu_torch.models.model import build_model
from layoutdit_tpu_torch.models.weights_io import tree_leaves
from layoutdit_tpu_torch.tools.make_fixture import make_fixture, write_fixture_config
from layoutdit_tpu_torch.tools.make_shards import main as make_shards_main
from layoutdit_tpu_torch.train.trainer import Trainer

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)


def _fixture(tmp_path, n=6):
    root = str(tmp_path)
    make_fixture(root, n_images=n, split="samples", seed=8)
    return root, os.path.join(root, "samples"), os.path.join(root, "samples.json")


def _names(ann):
    with open(ann) as f:
        return [img["file_name"] for img in json.load(f)["images"]]


def _read(images):
    def read(name):
        with open(os.path.join(images, name), "rb") as f:
            return f.read()
    return read


def test_build_and_ranged_reads(tmp_path):
    root, images, ann = _fixture(tmp_path)
    out = os.path.join(root, "shards")
    names, read = _names(ann), _read(images)
    index = build_shards(names, read, out, shard_size_bytes=2 * len(read(names[0])))
    assert len(index["shards"]) > 1 and sorted(index["entries"]) == sorted(names)
    with tarfile.open(os.path.join(out, index["shards"][0])) as t:  # real tar files
        members = t.getnames()
    assert members and all(m in index["entries"] for m in members)
    si = ShardIndex(out)
    try:
        assert len(si) == len(names)
        for n in names:
            assert si.read(n) == read(n)
        assert names[0] in si and "nope.jpg" not in si
    finally:
        si.close()


def test_sharded_dataset_matches_plain(tmp_path):
    root, images, ann = _fixture(tmp_path)
    out = os.path.join(root, "shards")
    make_shards_main(["--images", images, "--annotations", ann, "--out", out, "--shard-mb", "1"])
    plain, sharded = PubLayNetDataset(images, ann), make_sharded_dataset(out, ann)
    assert sharded.ids == plain.ids
    for img_id in plain.ids:
        assert sharded.load_image_bytes(img_id) == plain.load_image_bytes(img_id)
        np.testing.assert_array_equal(sharded.load_image(img_id), plain.load_image(img_id))
        np.testing.assert_array_equal(sharded.load_target(img_id)["boxes"],
                                      plain.load_target(img_id)["boxes"])
    sharded.shard_index.close()


def test_sharded_loader_batch(tmp_path):
    root, images, ann = _fixture(tmp_path, n=4)
    out = os.path.join(root, "shards")
    make_shards_main(["--images", images, "--annotations", ann, "--out", out])
    loader = DetectionLoader(make_sharded_dataset(out, ann), batch_size=4, shuffle=False,
                             image_size=64, device="cpu")
    batches = list(loader)
    loader.close()
    assert len(batches) == 1
    b = batches[0]
    assert b.images.shape[0] == 4 and torch.isfinite(b.images).all() and b.gt_valid.any()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_packages_read_each_others_shards(tmp_path, writer):
    """One package's ``make_shards`` output, read by the other's
    ``ShardIndex``: the same bytes per page; both writers give the same
    files."""
    root, images, ann = _fixture(tmp_path)
    out = {w: os.path.join(root, f"shards_{w}") for w in ("jax", "port")}
    for w, main in (("jax", jax_make_shards), ("port", make_shards_main)):
        main(["--images", images, "--annotations", ann, "--out", out[w], "--shard-mb", "1"])
    reader = ShardIndex if writer == "jax" else JaxShardIndex
    si = reader(out[writer])
    try:
        for name in _names(ann):
            assert si.read(name) == _read(images)(name)
    finally:
        si.close()
    assert sorted(os.listdir(out["jax"])) == sorted(os.listdir(out["port"]))
    for name in os.listdir(out["jax"]):
        with open(os.path.join(out["jax"], name), "rb") as a, \
                open(os.path.join(out["port"], name), "rb") as b:
            assert a.read() == b.read(), name


def test_shards_over_memory_filesystem():
    """``build_shards`` and ``ShardIndex`` on fsspec's memory filesystem
    (a stand-in for gs://), and JAX's reader on the port's shards there."""
    import fsspec

    fs = fsspec.filesystem("memory")
    try:
        blobs = {f"img_{i}.jpg": bytes([i]) * (100 + i) for i in range(5)}
        out = "memory://ldtpu-port-shards/train"
        index = build_shards(list(blobs), lambda n: blobs[n], out, shard_size_bytes=300)
        assert len(index["shards"]) >= 2
        for reader in (ShardIndex, JaxShardIndex):
            si = reader(out)
            try:
                for name, data in blobs.items():
                    assert si.read(name) == data
            finally:
                si.close()
        jax_build_shards(list(blobs), lambda n: blobs[n], out + "_jax", shard_size_bytes=300)
        si = ShardIndex(out + "_jax")
        assert all(si.read(n) == d for n, d in blobs.items())
        si.close()
    finally:
        try:
            fs.rm("/ldtpu-port-shards", recursive=True)
        except FileNotFoundError:
            pass


def _run_config(root, shards=None):
    path = write_fixture_config(root, epochs=1, batch_size=4, tiny_model=True)
    with open(path) as f:
        raw = json.load(f)
    raw["detection_model_config"]["image_size"] = 64
    raw["train_config"].update(tensorboard=False, checkpoint_interval=10)
    raw["data_loader_config"]["image_shards_dir"] = shards
    with open(path, "w") as f:
        json.dump(raw, f)
    return load_run_config(path)


def test_sharded_epoch_equals_plain_epoch(tmp_path):
    """``image_shards_dir`` routes the trainer through the shard reader,
    and its epoch ends with the plain-file epoch's bits: the same pages in
    the same order make the same steps."""
    root, images, ann = _fixture(tmp_path, n=8)
    shards = os.path.join(root, "shards")
    build_shards(_names(ann), _read(images), shards, shard_size_bytes=50 * 1024)
    with open(os.path.join(shards, "index.json")) as f:
        assert len(json.load(f)["shards"]) >= 2
    runs = {}
    for name, shard_dir in (("files", None), ("shards", shards)):
        rc = _run_config(root, shard_dir)
        rc = dataclasses.replace(rc, run_name=name)
        trainer = Trainer(rc, build_model(rc, seed=0, device="cpu"), device="cpu")
        assert hasattr(trainer.dataloader.dataset, "shard_index") == (shard_dir is not None)
        trainer.train()
        runs[name] = trainer
    assert np.isfinite(runs["shards"].loss_history[0])
    assert runs["shards"].loss_history == runs["files"].loss_history
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(runs["shards"].params),
                                                 tree_leaves(runs["files"].params), strict=True))
