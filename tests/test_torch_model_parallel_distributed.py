"""The port's tensor and sequence parallelism over a real
``torch.distributed`` group: spawned gloo processes on the CPU.

  * ``main`` started as two ranks by its launcher on a tiny
    ``configs/train_tp_sp.json``-shaped config (``model_parallel`` 2,
    ``sequence_parallel``, one data rank) against ``main`` in one process:
    one step's checkpoint (written by rank 0 in the one-card layout), the
    epoch's loss and the pages the eval scored;
  * ``tools/serve.py --model-parallel 2 --device cpu`` in a process of its
    own (rank 0, which starts rank 1), through HTTP, against one engine
    on the same checkpoint;
  * its refusals: ``--int8``, ``--export-dir``, and more ranks than cards.

This file imports no JAX: the spawned ranks import it.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import threading
import urllib.request
from pathlib import Path

import pytest
import torch

from layoutdit_tpu_torch.config import get_run_config
from layoutdit_tpu_torch.eval.serving import BatchInferenceEngine
from layoutdit_tpu_torch.main import main, spawn_ranks
from layoutdit_tpu_torch.models.model import build_model
from layoutdit_tpu_torch.models.weights_io import tree_leaves
from layoutdit_tpu_torch.tools import serve as serve_tool
from layoutdit_tpu_torch.tools.make_fixture import make_fixture, write_fixture_config
from layoutdit_tpu_torch.train.checkpoint import load_checkpoint

REPO = Path(__file__).resolve().parents[1]
# the two ranks' first moment (the gradient) against one process's,
# relative Frobenius a leaf, float32: the row-parallel partial sums and
# the SP-partial gradients' sums reorder the last bits, and on this
# random model one box-head unit's pre-activation sits within them of 0
# for one RoI (fc6's unit 842 on rank 1: its ReLU opens on one side
# only), which moves every gradient upstream of it by up to 2.2e-4
TP_RTOL = 5e-4


@pytest.fixture(scope="module")
def fixture_cfg(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tp_main"))
    make_fixture(root, n_images=4, split="samples", seed=2, image_size=64)
    path = write_fixture_config(root, epochs=1, batch_size=4, tiny_model=True)
    with open(path) as f:
        return root, path, json.load(f)


def _run_main(tmp_path, raw, name, ranks, **mesh):
    raw = json.loads(json.dumps(raw))
    # 64 px pages (17 tokens): at 224 px this random model's objectness
    # scores tie so closely that the last bits the row-parallel sums move
    # pick other proposals, and the RoI losses differ by design
    raw["detection_model_config"]["image_size"] = 64
    raw["eval_config"]["eval_base_path"] = str(tmp_path / name)
    raw["mesh_config"] = {"data_parallel": -1, **mesh}
    cfg = tmp_path / f"{name}.json"
    cfg.write_text(json.dumps(raw))
    env = {"LAYOUTDIT_CONFIG": str(cfg), "OMP_NUM_THREADS": "1"}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        if ranks > 1:
            spawn_ranks(["--device", "cpu"], ranks)
        else:
            main(["--device", "cpu"])
    finally:
        torch.set_num_threads(threads)
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    run = tmp_path / name / raw["run_name"]
    state = load_checkpoint(str(run / "model_checkpoints" / "epoch_1.pt"), "cpu")
    with open(run / "metrics" / "metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    with open(run / "predictions.json") as f:
        preds = json.load(f)
    return state, recs, preds


def test_main_tp_sp_two_ranks_matches_one_process(fixture_cfg, tmp_path):
    """``main`` over a 1 x 2 mesh with sequence parallelism (the tiny
    encoder's 2 heads, MLP and box head split over the ranks, 17 tokens
    as 9 + 8), one step and the final eval: rank 0's checkpoint holds the
    whole tree, its gradient (the first moment) within ``TP_RTOL`` a leaf
    of one process's and its parameters within 2 lr (Adam's first update
    is about lr x sign(g)); the same loss and the same pages scored."""
    _, _, raw = fixture_cfg
    one, one_recs, one_preds = _run_main(tmp_path, raw, "one", 1)
    two, two_recs, two_preds = _run_main(tmp_path, raw, "two", 2, model_parallel=2,
                                         sequence_parallel=True)
    for a, b in zip(two["opt_state"]["mu"], one["opt_state"]["mu"], strict=True):
        assert a.shape == b.shape
        assert float((a - b).norm()) <= TP_RTOL * float(b.norm()) + 1e-12
    lr = raw["train_config"].get("learning_rate", 1e-4)
    for a, b in zip(tree_leaves(two["params"]), tree_leaves(one["params"]), strict=True):
        assert a.shape == b.shape
        assert float((a - b).abs().max()) <= 2 * lr * (1 + 1e-3)
    assert two["extra"]["updates"] == one["extra"]["updates"] == 1
    assert two_recs[0]["loss"] == pytest.approx(one_recs[0]["loss"], rel=TP_RTOL)
    assert {p["image_id"] for p in two_preds} == {p["image_id"] for p in one_preds}


def _post(url, body, timeout=300):
    req = urllib.request.Request(url + "/predict", data=body,
                                 headers={"Content-Type": "image/jpeg"}, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def test_serve_model_parallel_through_http(fixture_cfg, tmp_path):
    """``--model-parallel 2 --device cpu``: this process's child is rank 0
    (the HTTP server) and starts rank 1; every page's detections equal
    one engine's on the same checkpoint (labels exactly; boxes and scores
    to the server's JSON rounding, 0.01 px and 1e-4, and 1e-4 more for
    the ranks' row-parallel sums). SIGTERM releases rank 1 and both
    exit."""
    root, cfg_path, _ = fixture_cfg
    os.environ["LAYOUTDIT_CONFIG"] = cfg_path
    try:
        model = build_model(get_run_config(), device="cpu")
    finally:
        del os.environ["LAYOUTDIT_CONFIG"]
    ckpt = model.save_checkpoint(str(tmp_path), "run", 1)
    pages = [Path(root, "samples", f).read_bytes()
             for f in sorted(os.listdir(os.path.join(root, "samples"))) if f.endswith(".jpg")]
    one = BatchInferenceEngine(model, image_sizes=(64,), batch_size=2, score_thresh=0.0,
                               device="cpu")
    want = one.predict_pages(pages)
    code = ("import torch; torch.set_num_threads(1);"
            "from layoutdit_tpu_torch.tools.serve import main;"
            f"main(['--checkpoint', {ckpt!r}, '--port', '0', '--sizes', '64',"
            "'--batch-size', '2', '--score-thresh', '0', '--device', 'cpu',"
            "'--model-parallel', '2'])")
    env = {**os.environ, "LAYOUTDIT_CONFIG": cfg_path, "PYTHONPATH": str(REPO),
           "OMP_NUM_THREADS": "1"}
    proc = subprocess.Popen([sys.executable, "-c", code], env=env, cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    lines, up, url = [], threading.Event(), []

    def pump():
        for line in proc.stderr:
            lines.append(line)
            if "Serving on" in line:
                url.append(line.split("Serving on ")[1].split()[0])
                up.set()

    reader = threading.Thread(target=pump, daemon=True)
    reader.start()
    try:
        assert up.wait(timeout=240), "".join(lines)[-3000:]
        for page, w in zip(pages, want):
            got = _post(url[0], page)
            assert got["labels"] == w.labels.tolist()
            assert torch.allclose(torch.tensor(got["boxes"]).reshape(-1, 4),
                                  torch.from_numpy(w.boxes).float().reshape(-1, 4),
                                  rtol=0, atol=0.005 + 1e-4)
            assert torch.allclose(torch.tensor(got["scores"]), torch.from_numpy(w.scores).float(),
                                  rtol=0, atol=5e-5 + 1e-5)
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=120)
        reader.join(timeout=30)
        err = "".join(lines)
        assert proc.returncode == 0, err[-3000:]
        assert "Server stopped cleanly" in err
    finally:
        if proc.poll() is None:
            proc.kill()


@pytest.mark.parametrize("argv,match", [
    (["--checkpoint", "/nonexistent.pt", "--model-parallel", "2", "--int8"],
     "int8 kernels are not model-sharded"),
    (["--export-dir", "/nonexistent", "--model-parallel", "2"], "export-dir with --model"),
    (["--checkpoint", "/nonexistent.pt", "--model-parallel", "0"], ">= 1"),
])
def test_serve_model_parallel_refusals(argv, match):
    with pytest.raises(SystemExit, match=match):
        serve_tool.main(argv + ["--device", "cpu"])


def test_serve_model_parallel_needs_the_cards(monkeypatch):
    """On the card one rank a card: more than exist raise (JAX's ``need >
    len(devices)``); on the CPU any number of gloo ranks."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert serve_tool.model_parallel_ranks(2, 0) == 2
    with pytest.raises(SystemExit, match="needs 4 cards, but only 2"):
        serve_tool.model_parallel_ranks(2, 2)
    assert serve_tool.model_parallel_ranks(2, 2, "cpu") == 4
