"""The port's serving surface on the CPU at tiny widths: the bucket planner
(``eval/buckets.py``) against JAX's, exactly; the engine's native JPEG
path against its PIL path and ``from_corpus`` against JAX's engine;
``ExportedInferenceEngine`` against ``BatchInferenceEngine`` (boxes 1e-5,
scores 1e-6, labels exact) with a corrupt page among the pages; and the
HTTP server (``tools/serve.py``), the cases of ``tests/test_serve_http.py``:
coalescing, errors to every waiter, /healthz, /info, /metrics, concurrent
pages, 422 and 404, the SIGTERM drain in a process, ``--export-dir``
serving and the flags it and the port refuse."""

import io
import itertools
import json
import os
import signal
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from layoutdit_tpu.config.constructs import DetectionBudget as JaxBudget
from layoutdit_tpu.eval import buckets as jax_buckets
from layoutdit_tpu.eval.serving import BatchInferenceEngine as JaxEngine
from layoutdit_tpu.models import backbone as jax_backbone
from layoutdit_tpu.models import vit as jax_vit
from layoutdit_tpu.models.detection import detector as jax_det
from layoutdit_tpu_torch.config import get_run_config
from layoutdit_tpu_torch.eval import buckets as port_buckets
from layoutdit_tpu_torch.eval import serving as port_serving
from layoutdit_tpu_torch.eval.serving import BatchInferenceEngine, ExportedInferenceEngine
from layoutdit_tpu_torch.export import export_detector
from layoutdit_tpu_torch.models.model import build_model
from layoutdit_tpu_torch.native import loader as native_loader
from layoutdit_tpu_torch.tools.make_fixture import make_fixture, write_fixture_config
from layoutdit_tpu_torch.tools.serve import DynamicBatcher, main as serve_main, make_server

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


# ----------------------------------------------------------------- buckets

def _corpus(seed: int, n: int = 40):
    rng = np.random.default_rng(seed)
    return [(int(rng.integers(100, 1200)), int(rng.integers(100, 1200))) for _ in range(n)]


@pytest.mark.parametrize("k", [1, 2, 3, 4])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_planner_equals_jax(k, seed):
    pages = _corpus(seed)
    got = port_buckets.plan_buckets(pages, k)
    assert got == jax_buckets.plan_buckets(pages, k)
    assert len(got) <= k and got == sorted(got)
    for plan in (got, [224, 512], [1200]):
        assert port_buckets.corpus_cost(pages, plan) == jax_buckets.corpus_cost(pages, plan)
    # the plan is the optimum over every choice of buckets (brute force)
    needs = sorted({max(224, -(-max(h, w) // 16) * 16) for h, w in pages})
    best = min(port_buckets.corpus_cost(pages, c) for r in range(1, k + 1)
               for c in itertools.combinations(needs, r) if c[-1] == needs[-1])
    assert port_buckets.corpus_cost(pages, got) == pytest.approx(best)


@pytest.mark.parametrize("case", [
    dict(page_sizes=[(100, 90), (1000, 400)], k=2, patch=16, min_size=224),
    dict(page_sizes=[(4000, 4000)], k=1, max_size=1024),
    dict(page_sizes=[(500, 300)], k=4),
    dict(page_sizes=[], k=2),
    dict(page_sizes=[(300, 300)] * 10 + [(900, 900)], k=1, cost_fn=lambda s: 1.0),
    dict(page_sizes=[(300, 300)] * 10 + [(900, 900)], k=2),
    dict(page_sizes=[(37, 1000), (1000, 37), (511, 513)], k=2, patch=8, min_size=64),
])
def test_planner_edge_cases_equal_jax(case):
    assert port_buckets.plan_buckets(**case) == jax_buckets.plan_buckets(**case)


def test_planner_refuses_no_buckets():
    with pytest.raises(ValueError, match="at least one bucket"):
        port_buckets.plan_buckets([(100, 100)], 0)


VIT = dict(hidden_size=32, num_hidden_layers=1, num_attention_heads=2,
           intermediate_size=64, image_size=64)
BUDGET = dict(rpn_pre_nms_top_n_test=50, rpn_post_nms_top_n_test=50, box_detections_per_img=10)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """The tiny detector of ``write_fixture_config`` (port), its config
    file and fixture pages (JPEG bytes, 64 px)."""
    root = str(tmp_path_factory.mktemp("serve"))
    make_fixture(root, n_images=4, split="samples", seed=3, image_size=64)
    path = write_fixture_config(root, epochs=1, batch_size=4, tiny_model=True)
    os.environ["LAYOUTDIT_CONFIG"] = path
    try:
        model = build_model(get_run_config(), device="cpu")
    finally:
        del os.environ["LAYOUTDIT_CONFIG"]
    pages = [Path(root, "samples", f).read_bytes()
             for f in sorted(os.listdir(os.path.join(root, "samples"))) if f.endswith(".jpg")]
    return root, path, model, pages


def test_from_corpus_equals_jax(tiny):
    class JaxModel:
        cfg = jax_det.DetectorConfig(
            backbone=jax_backbone.BackboneConfig(vit=jax_vit.ViTConfig(**VIT),
                                                 fpn_out_channels=32),
            image_size=64, budget=JaxBudget(**BUDGET))
        params = None

    model = tiny[2]
    for pages, k in (([(230, 200)] * 5 + [(600, 400)] * 2, 2), (_corpus(4, 12), 3)):
        want = JaxEngine.from_corpus(JaxModel, pages, max_buckets=k, batch_size=2).image_sizes
        got = BatchInferenceEngine.from_corpus(model, pages, max_buckets=k, batch_size=2,
                                               device="cpu")
        assert got.image_sizes == want and got.batch_size == 2


# ------------------------------------------------------------------ engines

def _jpeg(rng, h, w) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(buf, "JPEG")
    return buf.getvalue()


def _same(got, want, box_tol=0.0, score_tol=0.0):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.labels, w.labels)
        np.testing.assert_allclose(g.boxes, w.boxes, atol=box_tol, rtol=0)
        np.testing.assert_allclose(g.scores, w.scores, atol=score_tol, rtol=0)


def test_native_jpeg_path_equals_the_pil_path(tiny, monkeypatch):
    _, _, model, pages = tiny
    rng = np.random.default_rng(0)
    jpegs = pages + [_jpeg(rng, 90, 70), _jpeg(rng, 120, 100), b"\xff\xd8 corrupt"]
    engine = BatchInferenceEngine(model, image_sizes=(64, 128), batch_size=2,
                                  score_thresh=0.0, device="cpu")
    assert native_loader.available()
    before = native_loader.decode_batch.pages
    native = engine.predict_pages(jpegs)
    assert native_loader.decode_batch.pages - before == len(jpegs)
    assert len(native[-1].boxes) == 0 and all(len(r.boxes) for r in native[:-1])
    monkeypatch.setattr(native_loader, "available", lambda: False)
    monkeypatch.setattr(port_serving._warn_pil_once, "done", False)
    pil = engine.predict_pages(jpegs)
    assert native_loader.decode_batch.pages - before == len(jpegs)  # PIL decoded these
    assert port_serving._warn_pil_once.done  # and the engine said so
    _same(native, pil)


@pytest.fixture(scope="module")
def artifact(tiny, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("artifact") / "a")
    export_detector(tiny[2].params, tiny[2].cfg, path, image_sizes=(64, 96), batch_size=2,
                    device="cpu")
    return path


def test_exported_engine_equals_the_live_engine(tiny, artifact):
    _, _, model, pages = tiny
    rng = np.random.default_rng(1)
    mixed = pages[:3] + [b"not a page", _jpeg(rng, 90, 80),
                         rng.integers(0, 256, (70, 60, 3), dtype=np.uint8)]
    exported = ExportedInferenceEngine(artifact, score_thresh=0.0)
    assert exported.image_sizes == [64, 96] and exported.batch_size == 2
    assert exported.model is None and exported.device.type == "cpu"
    live = BatchInferenceEngine(model, image_sizes=(64, 96), batch_size=2, score_thresh=0.0,
                                device="cpu")
    got, want = exported.predict_pages(mixed), live.predict_document(mixed)
    assert len(got[3].boxes) == 0 and all(len(r.boxes) for i, r in enumerate(got) if i != 3)
    _same(got, want, box_tol=1e-5, score_tol=1e-6)
    with pytest.raises(ValueError, match="runs on cpu"):
        ExportedInferenceEngine(exported.exported, device="cuda")


# -------------------------------------------------------------------- HTTP

class _EchoEngine:
    """Engine stub recording batch sizes; one token per page."""

    batch_size = 4

    def __init__(self):
        self.batches = []
        self.lock = threading.Lock()

    def predict_pages(self, pages):
        with self.lock:
            self.batches.append(len(pages))
        return [f"det:{p.decode()}" for p in pages]


def test_dynamic_batcher_coalesces_concurrent_requests():
    eng = _EchoEngine()
    b = DynamicBatcher(eng, flush_ms=50.0)
    b.start()
    try:
        results = [None] * 6
        threads = [threading.Thread(target=lambda i=i: results.__setitem__(
            i, b.submit(f"p{i}".encode()))) for i in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert results == [f"det:p{i}" for i in range(6)]
        assert sum(eng.batches) == 6 and len(eng.batches) < 6 and max(eng.batches) <= 4
    finally:
        b.stop()


def test_dynamic_batcher_error_propagates_to_every_waiter():
    class Boom(_EchoEngine):
        def predict_pages(self, pages):
            raise RuntimeError("device gone")

    b = DynamicBatcher(Boom(), flush_ms=50.0)
    b.start()
    try:
        errors = []

        def go(i):
            try:
                b.submit(f"p{i}".encode())
            except RuntimeError as e:
                errors.append(str(e))

        threads = [threading.Thread(target=go, args=(i,)) for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert errors == ["device gone"] * 3
    finally:
        b.stop()


def _serve(httpd):
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{httpd.server_address[1]}"


@pytest.fixture(scope="module")
def server(tiny):
    _, _, model, pages = tiny
    httpd, batcher = make_server(model, "127.0.0.1", 0, image_sizes=(64,), batch_size=4,
                                 score_thresh=0.0, flush_ms=10.0, device="cpu")
    try:
        yield _serve(httpd), pages, httpd
    finally:
        httpd.shutdown()
        httpd.server_close()
        batcher.stop()


def _post(url, body, timeout=300):
    req = urllib.request.Request(url + "/predict", data=body,
                                 headers={"Content-Type": "image/jpeg"}, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def test_healthz_and_info(server):
    url, _, _ = server
    with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
        assert json.loads(r.read()) == {"status": "ok"}
    with urllib.request.urlopen(url + "/info", timeout=60) as r:
        info = json.loads(r.read())
    assert info["image_sizes"] == [64] and info["batch_size"] == info["max_batch"] == 4
    assert info["num_classes"] == 5 and info["device"] == "cpu"
    assert info["label_names"]["1"] == "text"  # JSON keys are strings


def test_predict_single_page_equals_the_engine(server, tiny):
    url, pages, _ = server
    rec = _post(url, pages[0])
    assert len(rec["boxes"]) == len(rec["scores"]) == len(rec["labels"]) > 0
    assert rec["label_names"][0] in {"text", "title", "list", "table", "figure"}
    want = BatchInferenceEngine(tiny[2], image_sizes=(64,), batch_size=4, score_thresh=0.0,
                                device="cpu").predict_pages([pages[0]])[0]
    assert rec["labels"] == [int(x) for x in want.labels]
    np.testing.assert_allclose(rec["boxes"], want.boxes, atol=0.005 + 1e-6)


def test_predict_concurrent_pages_batch(server):
    url, pages, httpd = server
    results, errs = [None] * 8, []
    before = httpd.metrics.batches

    def go(i):
        try:
            results[i] = _post(url, pages[i % len(pages)])
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    threads = [threading.Thread(target=go, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    assert not errs and all(r is not None and r["boxes"] for r in results)
    assert results[0] == results[4]  # the same page, the same answer in any batch
    assert httpd.metrics.batches - before < 8


def test_corrupt_page_is_422_and_bad_route_404(server):
    url, _, _ = server
    for body in (b"not a jpeg", b"\xff\xd8\xff" + b"\x00" * 64):
        req = urllib.request.Request(url + "/predict", data=body, method="POST")
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(req, timeout=300)
        assert exc.value.code == 422
    with pytest.raises(urllib.error.HTTPError) as exc:
        urllib.request.urlopen(url + "/nope", timeout=60)
    assert exc.value.code == 404


def test_metrics_endpoint(server):
    url, pages, _ = server
    _post(url, pages[0])
    with urllib.request.urlopen(url + "/metrics", timeout=60) as r:
        assert r.headers["Content-Type"].startswith("text/plain")
        text = r.read().decode()
    assert 'layoutdit_requests_total{method="POST",code="200"}' in text
    for name in ("layoutdit_pages_total", "layoutdit_batches_total",
                 'layoutdit_request_seconds_bucket{le="+Inf"}'):
        assert name in text
    count = int(text.split("layoutdit_request_seconds_count ")[1].split()[0])
    inf = int(text.split('le="+Inf"} ')[1].split()[0])
    assert count == inf >= 1


def test_sigterm_graceful_shutdown(tiny, tmp_path):
    """The entry point in a process of its own: SIGTERM drains, exits 0."""
    root, cfg_path, model, _ = tiny
    ckpt = model.save_checkpoint(str(tmp_path), "run", 1)
    code = ("from layoutdit_tpu_torch.tools.serve import main;"
            f"main(['--checkpoint', {ckpt!r}, '--port', '0', '--sizes', '64',"
            "'--batch-size', '2', '--device', 'cpu'])")
    env = {**os.environ, "LAYOUTDIT_CONFIG": cfg_path, "PYTHONPATH": str(REPO)}
    proc = subprocess.Popen([sys.executable, "-c", code], env=env, cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    lines, up = [], threading.Event()

    def pump():
        for line in proc.stderr:
            lines.append(line)
            if "Serving on" in line:
                up.set()

    reader = threading.Thread(target=pump, daemon=True)
    reader.start()
    try:
        assert up.wait(timeout=180), "".join(lines)[-2000:]
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=120)
        reader.join(timeout=30)
        err = "".join(lines)
        assert proc.returncode == 0, err[-2000:]
        assert "SIGTERM: draining" in err and "Server stopped cleanly" in err
    finally:
        if proc.poll() is None:
            proc.kill()


def test_serve_from_export_artifact(tiny, artifact):
    _, _, model, pages = tiny
    with pytest.raises(ValueError, match="frozen artifact"):
        make_server(model, "127.0.0.1", 0, export_dir=artifact, device="cpu")
    httpd, batcher = make_server(None, "127.0.0.1", 0, score_thresh=0.0, export_dir=artifact,
                                 device="cpu")
    url = _serve(httpd)
    try:
        with urllib.request.urlopen(url + "/info", timeout=60) as r:
            info = json.loads(r.read())
        assert info["image_sizes"] == [64, 96]
        assert info["batch_size"] == 2  # the manifest's, not the default 8
        assert info["num_classes"] == 5
        rng = np.random.default_rng(5)
        got = _post(url, _jpeg(rng, 60, 40))
        assert set(got) == {"boxes", "scores", "labels", "label_names"}
        for b in got["boxes"]:  # page coordinates
            assert 0 <= b[0] <= 40 and 0 <= b[1] <= 60
        assert _post(url, pages[1])["boxes"]
    finally:
        httpd.shutdown()
        httpd.server_close()
        batcher.stop()


@pytest.mark.parametrize("extra", [["--sizes", "1024"], ["--batch-size", "16"], ["--int8"]])
def test_export_dir_rejects_sizes_and_batch_flags(extra):
    with pytest.raises(SystemExit, match="come from its manifest"):
        serve_main(["--export-dir", "/nonexistent", "--device", "cpu"] + extra)


@pytest.mark.parametrize("flags,item", [
    (["--int8", "--data-parallel", "2"], "queue 1 item 7"),
    (["--data-parallel", "2"], "queue 1 item 7"),
    (["--data-parallel", "-1"], "queue 1 item 7"),
    (["--model-parallel", "2"], "queue 1 item 7"),
])
def test_refused_flags_name_their_queue_items(flags, item):
    with pytest.raises(SystemExit, match=item):
        serve_main(["--checkpoint", "/nonexistent.pt", "--device", "cpu"] + flags)


def test_serving_defaults_to_the_card(tiny, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_server(tiny[2], "127.0.0.1", 0, image_sizes=(64,))
