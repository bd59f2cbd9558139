"""HTTP inference server: a dynamic-batching REST front end over the
bucketed serving engine (port of ``layoutdit_tpu/tools/serve.py``).

Standard library only (``http.server``): concurrent POSTs land in a
queue, one dispatcher thread coalesces them into engine-sized batches (up
to ``--max-batch`` pages or a ``--flush-ms`` window, whichever comes
first) and runs one ``predict_pages`` call per batch, which keeps the
engine's static batches full under ragged request arrival.

Endpoints:
  GET  /healthz   -> {"status": "ok"}
  GET  /info      -> buckets, batch size, class inventory
  GET  /metrics   -> Prometheus text: requests, pages, batches, latency
  POST /predict   -> body = image bytes (JPEG/PNG) ->
                     {"boxes": [[x1,y1,x2,y2]..], "scores": [..],
                      "labels": [..], "label_names": [..]}
                     (boxes in page coordinates; a mask model adds
                     "masks", each a COCO uncompressed RLE over the
                     detection's window with its "offset" [x0, y0]);
                     422 for a page that does not decode

Usage:
  LAYOUTDIT_CONFIG=cfg.json python -m layoutdit_tpu_torch.tools.serve \\
      --checkpoint ckpt.pt --port 8000 --sizes 224 1024 [--batch-size 8] \\
      [--flush-ms 5] [--device cuda|cpu]
  python -m layoutdit_tpu_torch.tools.serve --export-dir artifact/ --port 8000

SIGTERM stops accepting, lets the requests in flight finish and drains
the batcher. ``--int8`` serves the encoder in W8A8 int8 (``ops/quant.py``,
LoRA adapters merged first); with ``--export-dir`` it raises, as in the
JAX server (bake int8 in at export time). ``--data-parallel N`` serves
N replicas of the model on cards 0..N-1 in this one process (-1: every
card), the batcher's batches split over them (``eval/serving.py``); more
cards than exist raise and fewer warn, as in the JAX server; on the CPU
(``--device cpu``) it makes N CPU replicas.

``--model-parallel M`` serves the model tensor-parallel (JAX
``tools/serve.py:410-455``): this process and M - 1 (or D x M - 1 with
``--data-parallel D``) rank processes it starts form a data x model
mesh, one rank a card (gloo ranks on the CPU with ``--device cpu``).
This process, rank 0, runs the HTTP server and the batcher; each padded
bucket batch goes to every rank, each model group predicts its rows on
its shards of the weights, and rank 0 answers (``eval/serving.py``).
More ranks than cards raise; ``--int8`` and ``--export-dir`` with it
raise, as in the JAX server. ``--model-parallel 1`` is the plain engine.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import queue
import signal
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import torch

from layoutdit_tpu_torch.log import get_logger

logger = get_logger(__name__)

def serving_devices(data_parallel: int, device: str = "cuda") -> list[torch.device]:
    """The devices of ``--data-parallel`` replicas (JAX ``tools/serve.py``):
    on the card, N of them from card 0 (-1: every card); more than exist
    raises ``SystemExit``, fewer warn that the rest are left idle. On the
    CPU, N replicas of the CPU; -1 (every card) raises there."""
    dev = torch.device(device)
    if dev.type != "cuda":
        if data_parallel < 1:
            raise SystemExit("--data-parallel -1 means every card; on the CPU give the number "
                             "of replicas")
        return [dev] * data_parallel
    have = torch.cuda.device_count()
    n = data_parallel if data_parallel > 0 else have
    if n > have or n < 1:
        raise SystemExit(f"requested data_parallel={data_parallel}: {n} cards, but only {have} "
                         "available")
    if n < have:
        logger.warning("serving uses %d of %d cards", n, have)
    return [torch.device("cuda", i) for i in range(n)]


class _Waiter:
    """One request in flight: the handler thread blocks on ``event``
    until the dispatcher fills ``result`` (or ``error``)."""

    __slots__ = ("page", "event", "result", "error", "cancelled")

    def __init__(self, page: bytes):
        self.page = page
        self.event = threading.Event()
        self.result = None
        self.error: Exception | None = None
        self.cancelled = False  # set when the submitter gave up waiting


class DynamicBatcher:
    """Coalesce concurrent single-page requests into engine batches.

    A request thread calls ``submit(page)`` and blocks; the dispatcher
    thread drains the queue up to ``max_batch`` pages, waiting at most
    ``flush_ms`` after the first arrival for a batch to fill, then runs
    ``engine.predict_pages`` once for the whole batch.
    """

    def __init__(self, engine, max_batch: int | None = None,
                 flush_ms: float = 5.0, metrics=None):
        self.engine = engine
        self.metrics = metrics
        self.max_batch = max_batch or engine.batch_size
        self.flush_s = flush_ms / 1000.0
        self._q: queue.Queue[_Waiter | None] = queue.Queue()
        self._thread: threading.Thread | None = None

    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop, name="batcher", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        if self._thread is not None:
            self._q.put(None)
            self._thread.join(timeout=30)
            self._thread = None

    def submit(self, page: bytes, timeout: float = 300.0):
        """Blocking: the ``PageDetections`` of one page."""
        w = _Waiter(page)
        self._q.put(w)
        if not w.event.wait(timeout):
            # marked, so that the dispatcher skips it instead of spending a
            # batch slot on a result nobody reads
            w.cancelled = True
            raise TimeoutError("inference timed out")
        if w.error is not None:
            raise w.error
        return w.result

    def _collect(self) -> list[_Waiter] | None:
        """One batch: block for the first request, then fill until
        max_batch or the flush window closes. None = shutdown."""
        first = self._q.get()
        while first is not None and first.cancelled:
            first = self._q.get()
        if first is None:
            return None
        batch = [first]
        deadline = time.monotonic() + self.flush_s
        while len(batch) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                nxt = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is None:  # shutdown: put it back for the outer loop
                self._q.put(None)
                break
            if not nxt.cancelled:
                batch.append(nxt)
        return batch

    def _loop(self) -> None:
        while True:
            batch = self._collect()
            if batch is None:
                return
            try:
                dets = self.engine.predict_pages([w.page for w in batch])
                for w, d in zip(batch, dets):
                    w.result = d
                if self.metrics is not None:
                    self.metrics.observe_batch(len(batch))
            except Exception as e:  # noqa: BLE001 (every waiter gets the error)
                logger.exception("batch of %d failed", len(batch))
                for w in batch:
                    w.error = e
            finally:
                for w in batch:
                    w.event.set()


class ServerMetrics:
    """Prometheus text-exposition counters and latency histogram for the
    server (GET /metrics); lock-guarded."""

    BUCKETS = (0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

    def __init__(self):
        self._lock = threading.Lock()
        self.requests = {}  # (method, code) -> count
        self.pages = 0
        self.batches = 0
        self.batch_pages = 0
        self.lat_sum = 0.0
        self.lat_count = 0
        self.lat_buckets = [0] * (len(self.BUCKETS) + 1)

    def observe_request(self, method: str, code: int, seconds: float) -> None:
        with self._lock:
            key = (method, code)
            self.requests[key] = self.requests.get(key, 0) + 1
            self.lat_sum += seconds
            self.lat_count += 1
            for i, b in enumerate(self.BUCKETS):
                if seconds <= b:
                    self.lat_buckets[i] += 1
                    break
            else:
                self.lat_buckets[-1] += 1

    def observe_batch(self, n_pages: int) -> None:
        with self._lock:
            self.batches += 1
            self.batch_pages += n_pages
            self.pages += n_pages

    def render(self) -> str:
        with self._lock:
            lines = ["# TYPE layoutdit_requests_total counter"]
            for (method, code), n in sorted(self.requests.items()):
                lines.append(f'layoutdit_requests_total{{method="{method}",code="{code}"}} {n}')
            lines += [
                "# TYPE layoutdit_pages_total counter",
                f"layoutdit_pages_total {self.pages}",
                "# TYPE layoutdit_batches_total counter",
                f"layoutdit_batches_total {self.batches}",
                "# TYPE layoutdit_batch_pages_total counter",
                f"layoutdit_batch_pages_total {self.batch_pages}",
                "# TYPE layoutdit_request_seconds histogram",
            ]
            acc = 0
            for b, n in zip(self.BUCKETS, self.lat_buckets):
                acc += n
                lines.append(f'layoutdit_request_seconds_bucket{{le="{b}"}} {acc}')
            acc += self.lat_buckets[-1]
            lines.append(f'layoutdit_request_seconds_bucket{{le="+Inf"}} {acc}')
            lines.append(f"layoutdit_request_seconds_sum {self.lat_sum}")
            lines.append(f"layoutdit_request_seconds_count {self.lat_count}")
            return "\n".join(lines) + "\n"


def detections_to_json(dets, names: dict) -> dict:
    """One page's detections as the /predict payload (and the predict
    tool's record); a mask model's add ``masks``, each COCO uncompressed
    RLE over the detection's local window, ``{"offset": [x0, y0],
    "size": [h, w], "counts": [...]}``."""
    out = {
        "boxes": [[round(float(v), 2) for v in b] for b in dets.boxes],
        "scores": [round(float(s), 4) for s in dets.scores],
        "labels": [int(lb) for lb in dets.labels],
        "label_names": [names.get(int(lb), str(int(lb))) for lb in dets.labels],
    }
    if getattr(dets, "masks", None) is not None:
        from layoutdit_tpu_torch.eval.masks import encode_rle

        out["masks"] = [{"offset": [int(x0), int(y0)], **encode_rle((0, 0, bm), *bm.shape)}
                        for x0, y0, bm in dets.masks]
    return out


def make_handler(batcher: DynamicBatcher, names: dict, info: dict,
                 metrics: ServerMetrics | None = None):
    from layoutdit_tpu_torch.eval.serving import header_size

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def _json(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 (http.server's name)
            if self.path == "/healthz":
                self._json(200, {"status": "ok"})
            elif self.path == "/info":
                self._json(200, info)
            elif self.path == "/metrics" and metrics is not None:
                body = metrics.render().encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._json(404, {"error": f"no route {self.path}"})

        def do_POST(self):  # noqa: N802
            if self.path != "/predict":
                self._json(404, {"error": f"no route {self.path}"})
                return
            length = int(self.headers.get("Content-Length", 0))
            if length <= 0:
                self._json(400, {"error": "empty body; POST image bytes"})
                return
            page = self.rfile.read(length)
            t0 = time.monotonic()

            def done(code, payload):
                if metrics is not None:
                    metrics.observe_request("POST", code, time.monotonic() - t0)
                self._json(code, payload)

            try:
                dets = batcher.submit(page)
            except Exception as e:  # noqa: BLE001 (surfaced as a 500)
                done(500, {"error": str(e)})
                return
            payload = detections_to_json(dets, names)
            # an undecodable page: the engine zeroes its slot, so no boxes
            if not payload["boxes"] and header_size(page) is None:
                done(422, {"error": "page failed to decode"})
                return
            done(200, payload)

        def log_message(self, fmt, *args):  # through the package's logger
            logger.info("%s %s", self.address_string(), fmt % args)

    return Handler


def make_server(model, host: str, port: int, *, image_sizes=(224,), batch_size: int = 8,
                score_thresh: float = 0.05, flush_ms: float = 5.0,
                max_batch: int | None = None, dataset: str | None = None,
                export_dir: str | None = None, device: str = "cuda", int8: bool = False,
                devices: list | None = None, mesh=None):
    """(ThreadingHTTPServer, DynamicBatcher), the batcher started; split
    from ``main`` so that tests and scripts run the server in-process.
    ``model``: anything with ``.params`` and ``.cfg`` (a live model), or
    None with ``export_dir``: then an exported artifact (``export.py``) is
    served, its buckets and batch size from its manifest, and ``int8``
    does not apply. ``int8``: the live engine's W8A8 encoder. ``devices``:
    one replica of the live model on each (``serving_devices``).
    ``mesh``: tensor-parallel serving over a data x model mesh, this rank
    0 (``eval/serving.py``); the engine's ``close()`` releases the other
    ranks."""
    from layoutdit_tpu_torch.tools.predict import _label_names

    if export_dir is not None:
        if model is not None or int8 or devices or mesh is not None:
            raise ValueError("--export-dir serves a frozen artifact: model/int8/devices do not "
                             "apply (bake them in at export time)")
        from layoutdit_tpu_torch.eval.serving import ExportedInferenceEngine

        engine = ExportedInferenceEngine(export_dir, score_thresh=score_thresh, device=device)
        batch_size = engine.batch_size
        n_classes = engine.exported.manifest["num_classes"]
    else:
        from layoutdit_tpu_torch.eval.serving import BatchInferenceEngine

        engine = BatchInferenceEngine(model, image_sizes=tuple(image_sizes),
                                      batch_size=batch_size, score_thresh=score_thresh,
                                      device=device, int8=int8, devices=devices, mesh=mesh)
        n_classes = model.cfg.num_classes
    names = _label_names(n_classes, dataset)
    info = {
        "image_sizes": list(engine.image_sizes),
        "batch_size": batch_size,
        "max_batch": max_batch or batch_size,
        "num_classes": n_classes,
        "label_names": names,
        "device": str(engine.device),
    }
    metrics = ServerMetrics()
    batcher = DynamicBatcher(engine, max_batch=max_batch, flush_ms=flush_ms, metrics=metrics)
    batcher.start()

    class _Server(ThreadingHTTPServer):
        # non-daemon handlers + block_on_close: server_close() joins the
        # handler threads in flight, so a SIGTERM drain lets their
        # responses finish before the process exits
        daemon_threads = False

    httpd = _Server((host, port), make_handler(batcher, names, info, metrics))
    httpd.metrics = metrics
    httpd.info = info
    httpd.engine = engine
    return httpd, batcher


def model_parallel_ranks(model_parallel: int, data_parallel: int, device: str = "cuda") -> int:
    """The ranks of ``--model-parallel`` M (x ``--data-parallel`` D):
    D x M, one a card; more than the cards raise ``SystemExit`` (JAX's
    ``need > len(devices)``), except on the CPU."""
    if model_parallel < 1:
        raise SystemExit("--model-parallel must be >= 1")
    if data_parallel < 0:
        raise SystemExit("--data-parallel -1 with --model-parallel: give the number of "
                         "model groups")
    need = max(1, data_parallel) * model_parallel
    if torch.device(device).type == "cuda" and need > torch.cuda.device_count():
        raise SystemExit(f"--model-parallel {model_parallel} x --data-parallel "
                         f"{max(1, data_parallel)} needs {need} cards, but only "
                         f"{torch.cuda.device_count()} available")
    return need


def _serving_mesh(args, rank: int, world: int, port: int):
    """Join the serving ranks' process group (gloo on the CPU, NCCL on
    the card, one card a rank) -> the data x model mesh."""
    import torch.distributed as dist

    from layoutdit_tpu_torch.config import MeshConfig
    from layoutdit_tpu_torch.parallel.mesh import build_mesh_for_batch

    device = torch.device(args.device)
    if device.type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=f"tcp://127.0.0.1:{port}", world_size=world, rank=rank)
    mp = args.model_parallel
    return build_mesh_for_batch(MeshConfig(data_parallel=world // mp, model_parallel=mp),
                                args.batch_size or 8)


def _follower(argv: list[str], rank: int, world: int, port: int) -> None:
    """A rank other than 0: its engine runs rank 0's batches."""
    import torch.distributed as dist

    from layoutdit_tpu_torch.eval.serving import BatchInferenceEngine
    from layoutdit_tpu_torch.tools.predict import load_model

    args = _parser().parse_args(argv)
    mesh = _serving_mesh(args, rank, world, port)
    try:
        device = f"cuda:{torch.cuda.current_device()}" if args.device != "cpu" else "cpu"
        _, model = load_model(args.checkpoint, device)
        engine = BatchInferenceEngine(model, image_sizes=tuple(args.sizes or [224]),
                                      batch_size=args.batch_size or 8,
                                      score_thresh=args.score_thresh, device=device, mesh=mesh)
        engine.serve_follower()
    finally:
        dist.destroy_process_group()


def _start_followers(argv: list[str], world: int, port: int) -> list:
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_follower, args=(argv, r, world, port)) for r in range(1, world)]
    for p in procs:
        p.start()
    return procs


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Layout detection HTTP server")
    src = parser.add_mutually_exclusive_group(required=True)
    src.add_argument("--checkpoint",
                     help="checkpoint to serve (the port's .pt, or a JAX .msgpack or .orbax), into "
                          "the model of LAYOUTDIT_CONFIG")
    src.add_argument("--export-dir",
                     help="serve an exported artifact (tools/export_model.py); buckets and "
                          "batch size come from its manifest")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8000)
    # defaults resolved below: live serving takes 224 / 8; with --export-dir
    # the manifest decides and passing either is an error
    parser.add_argument("--sizes", type=int, nargs="+", default=None)
    parser.add_argument("--batch-size", type=int, default=None)
    parser.add_argument("--max-batch", type=int, default=None,
                        help="dynamic-batch cap (default: --batch-size)")
    parser.add_argument("--flush-ms", type=float, default=5.0,
                        help="longest wait for a batch to fill")
    parser.add_argument("--score-thresh", type=float, default=0.05)
    parser.add_argument("--dataset", default=None,
                        choices=["publaynet", "doclaynet", "docbank"])
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--int8", action="store_true",
                        help="int8 W8A8 encoder (ops/quant.py); not with --export-dir")
    parser.add_argument("--data-parallel", type=int, default=0,
                        help="replicas on cards 0..N-1 (-1: every card); the batches split "
                             "over them")
    parser.add_argument("--model-parallel", type=int, default=1,
                        help="tensor-parallel ranks a model group (with --data-parallel D: "
                             "D groups), one a card; this process is rank 0")
    return parser


def main(argv=None) -> None:
    import sys

    argv = sys.argv[1:] if argv is None else list(argv)
    args = _parser().parse_args(argv)

    from layoutdit_tpu_torch.tools.predict import load_model

    model = devices = mesh = None
    followers: list = []
    if args.model_parallel != 1:
        if args.export_dir is not None:
            raise SystemExit("--export-dir with --model-parallel: an exported artifact is "
                             "one program on one device; serve the checkpoint instead")
        if args.int8:
            raise SystemExit("--int8 with --model-parallel: the int8 kernels are not "
                             "model-sharded (as in the JAX server)")
        world = model_parallel_ranks(args.model_parallel, args.data_parallel, args.device)
        from layoutdit_tpu_torch.parallel.mesh import free_port

        port = free_port()
        followers = _start_followers(argv, world, port)
        try:
            mesh = _serving_mesh(args, 0, world, port)
            if args.device != "cpu":
                args.device = f"cuda:{torch.cuda.current_device()}"
            _, model = load_model(args.checkpoint, args.device)
        except BaseException:
            for p in followers:
                p.terminate()
            raise
    elif args.checkpoint is not None:
        if args.data_parallel:
            devices = serving_devices(args.data_parallel, args.device)
        _, model = load_model(args.checkpoint, args.device)
    elif (args.int8 or args.data_parallel or args.sizes is not None
          or args.batch_size is not None):
        raise SystemExit("--export-dir serves a frozen artifact: --int8 / --data-parallel / "
                         "--sizes / --batch-size do not apply (bake int8 in at export time; "
                         "buckets and batch size come from its manifest)")
    httpd, batcher = make_server(
        model, args.host, args.port, image_sizes=args.sizes or [224],
        batch_size=args.batch_size or 8, score_thresh=args.score_thresh,
        flush_ms=args.flush_ms, max_batch=args.max_batch, dataset=args.dataset,
        export_dir=args.export_dir, device=args.device, int8=args.int8, devices=devices,
        mesh=mesh,
    )

    # SIGTERM stops accepting, lets the requests in flight finish and
    # drains the batcher; shutdown() must run off the serve_forever thread.
    # Installed before the "Serving on" line, which orchestrators take for
    # readiness.
    def _term(signum, frame):
        logger.warning("SIGTERM: draining and shutting down")
        threading.Thread(target=httpd.shutdown, daemon=True).start()

    try:
        signal.signal(signal.SIGTERM, _term)
    except ValueError:
        # handlers are main-thread-only; embedded callers drive
        # httpd.shutdown() themselves
        logger.warning("not in the main thread; SIGTERM handler not installed")
    logger.info("Serving on http://%s:%d (buckets %s)", args.host, httpd.server_address[1],
                httpd.info["image_sizes"])
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.shutdown()  # stop accepting
        httpd.server_close()  # join the handler threads in flight
        batcher.stop()  # then drain the dispatcher
        if mesh is not None:  # release the other ranks, then wait for them
            import torch.distributed as dist

            httpd.engine.close()
            for p in followers:
                p.join(timeout=60)
                if p.is_alive():
                    p.terminate()
            dist.destroy_process_group()
        logger.info("Server stopped cleanly")


if __name__ == "__main__":
    main()
