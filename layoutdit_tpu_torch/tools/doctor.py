"""Preflight diagnostics for a training or serving host (port of
``layoutdit_tpu/tools/doctor.py``).

    python -m layoutdit_tpu_torch.tools.doctor [--json] [--skip-backend]

One line per check, OK / WARN / FAIL, or with ``--json`` one JSON list;
exit code 1 iff a check FAILs. Every check that can block (device
initialisation, the kernels' build, a remote path's listing) runs under a
watchdog (``_with_timeout``), so the doctor always ends. The checks:

  * config: the run config (``LAYOUTDIT_CONFIG`` or the defaults) loads;
  * backend: a CUDA device is present, answers one matmul, and is a
    Hopper card (compute capability 9.0, the kernels' ``sm_90a``); no
    device FAILs, and the CPU is never reported as one;
  * kernels: nvcc is found and ``ops/_build.py`` builds and loads every
    ``csrc/*.cu`` into ``build/kernels``;
  * mesh: the config's ``mesh_config`` resolves to one device (the port
    trains on one card; other meshes wait for ROADMAP queue 1 item 7);
  * native: the JPEG loader and the COCO parser build and load;
  * pretrained: ``LAYOUTDIT_DIT_{BASE,LARGE}_PTH`` name a local checkpoint;
  * kernel-build-dir: ``build/kernels`` is writable (the JAX doctor's
    compile-cache check);
  * io: the training data and artifact roots exist;
  * checkpoints: the run's resumable checkpoints.

``--skip-backend`` touches neither the card nor its toolchain: no backend,
kernels or mesh check.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

BACKEND_CAPABILITY = (9, 0)


def _result(name: str, status: str, detail: str) -> dict:
    return {"check": name, "status": status, "detail": detail}


def _with_timeout(fn, timeout_s: float):
    """(finished, value) of ``fn()`` run on a daemon thread, re-raising
    its exception; (False, None) when it has not returned after
    ``timeout_s`` (the thread is left behind, the doctor goes on)."""
    import threading

    done = threading.Event()
    box: dict = {}

    def run():
        try:
            box["value"] = fn()
        except BaseException as e:  # reported by the caller, never lost in the thread
            box["error"] = e
        finally:
            done.set()

    threading.Thread(target=run, daemon=True).start()
    if not done.wait(timeout_s):
        return False, None
    if "error" in box:
        raise box["error"]
    return True, box.get("value")


def _raw_config() -> dict:
    """The JSON that ``LAYOUTDIT_CONFIG`` names, or {}."""
    from layoutdit_tpu_torch.utils.paths import open_path

    path = os.getenv("LAYOUTDIT_CONFIG")
    if not path:
        return {}
    with open_path(path, "r") as f:
        return json.load(f)


def check_config() -> dict:
    try:
        from layoutdit_tpu_torch.config import get_run_config

        rc = get_run_config()
    except Exception as e:
        return _result("config", "FAIL", f"{type(e).__name__}: {e}")
    src = os.getenv("LAYOUTDIT_CONFIG") or "defaults (no LAYOUTDIT_CONFIG)"
    return _result("config", "OK", f"run_name={rc.run_name} source={src} "
                   f"bs={rc.data.batch_size} epochs={rc.train.num_epochs} "
                   f"image_size={rc.model.image_size}")


def check_backend(timeout_s: float) -> dict:
    def probe():
        import torch

        if not torch.cuda.is_available():
            return None
        x = torch.ones((64, 64), device="cuda")
        float((x @ x).sum())  # one real launch, not just enumeration
        return {"n": torch.cuda.device_count(), "name": torch.cuda.get_device_name(0),
                "capability": torch.cuda.get_device_capability(0)}

    try:
        finished, out = _with_timeout(probe, timeout_s)
    except Exception as e:
        return _result("backend", "FAIL", f"{type(e).__name__}: {e}")
    if not finished:
        return _result("backend", "FAIL", f"device init + one launch did not finish in "
                       f"{timeout_s:.0f}s (driver wedged?)")
    if out is None:
        return _result("backend", "FAIL", "no CUDA device: torch.cuda.is_available() is false")
    major, minor = out["capability"]
    detail = f"{out['n']} x {out['name']} (sm_{major}{minor})"
    if (major, minor) != BACKEND_CAPABILITY:
        return _result("backend", "WARN", detail + " — the kernels are built for sm_90a")
    return _result("backend", "OK", detail)


def check_kernels(timeout_s: float) -> dict:
    def probe():
        from layoutdit_tpu_torch.ops import _build

        _build.build_all()
        return _build.KERNELS, _build.BUILD_DIR

    try:
        finished, out = _with_timeout(probe, timeout_s)
    except Exception as e:
        return _result("kernels", "FAIL", f"{type(e).__name__}: {str(e).splitlines()[0]}")
    if not finished:
        return _result("kernels", "FAIL", f"nvcc did not finish in {timeout_s:.0f}s")
    names, build_dir = out
    return _result("kernels", "OK", f"{len(names)} built and loaded ({', '.join(names)}) "
                   f"in {build_dir}")


def check_mesh() -> dict:
    try:
        from layoutdit_tpu_torch.config import _check_one_device_mesh

        mesh = _raw_config().get("mesh_config") or {}
        _check_one_device_mesh(mesh)
    except Exception as e:
        return _result("mesh", "FAIL", f"{type(e).__name__}: {e}")
    return _result("mesh", "OK", f"one device ({mesh or 'no mesh_config'})")


def check_native() -> dict:
    try:
        from layoutdit_tpu_torch.native import cocojson, loader

        have = {"loader": loader.available(), "coco-parser": cocojson.available()}
    except Exception as e:
        return _result("native", "FAIL", f"{type(e).__name__}: {e}")
    if all(have.values()):
        return _result("native", "OK", "C++ JPEG loader + COCO parser")
    missing = "+".join(n for n, up in have.items() if not up)
    return _result("native", "WARN", f"{missing} unavailable — the PIL / json paths work but "
                   "are slower (needs g++; see layoutdit_tpu_torch/native/)")


def check_pretrained() -> dict:
    try:
        from layoutdit_tpu_torch.tools.convert_hf_checkpoint import CKPT_ENV, local_checkpoint
    except Exception as e:
        return _result("pretrained", "FAIL", f"{type(e).__name__}: {e}")
    found = {p: local_checkpoint(p) for p in CKPT_ENV}
    if any(found.values()):
        return _result("pretrained", "OK",
                       ", ".join(f"{p}={path}" for p, path in found.items() if path))
    return _result("pretrained", "WARN",
                   "no pretrained DiT checkpoint — training starts from random init. To "
                   f"warm-start: export {CKPT_ENV['dit-base']}=/path/to/pytorch_model.bin "
                   "(microsoft/dit-base), or set previous_layout_dit_checkpoint")


def check_build_dir() -> dict:
    from layoutdit_tpu_torch.ops._build import BUILD_DIR

    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        probe = BUILD_DIR / ".doctor_probe"
        probe.write_text("x")
        probe.unlink()
        n = sum(1 for e in BUILD_DIR.iterdir() if e.suffix == ".so")
    except OSError as e:
        return _result("kernel-build-dir", "FAIL", f"{BUILD_DIR}: {e}")
    return _result("kernel-build-dir", "OK", f"{BUILD_DIR} writable, {n} libraries")


def _probe_path(kind: str, path: str | None, timeout_s: float = 15.0) -> dict:
    if not path:
        return _result(f"io:{kind}", "WARN", "not configured")

    def probe():
        from layoutdit_tpu_torch.utils.paths import fs_for

        return fs_for(path).exists(path)

    try:
        finished, exists = _with_timeout(probe, timeout_s)
    except Exception as e:
        return _result(f"io:{kind}", "WARN", f"{path}: {type(e).__name__}: {e}")
    if not finished:
        return _result(f"io:{kind}", "WARN",
                       f"{path}: still hanging after {timeout_s:.0f}s (endpoint unreachable?)")
    if not exists:
        return _result(f"io:{kind}", "WARN", f"{path} does not exist (yet)")
    return _result(f"io:{kind}", "OK", path)


def check_io() -> list[dict]:
    try:
        from layoutdit_tpu_torch.config import get_run_config

        rc = get_run_config()
    except Exception:
        return []  # the config check has FAILed
    return [_probe_path("train-data", rc.train.train_base_path),
            _probe_path("eval-base", rc.eval_base_path)]


def check_checkpoints(timeout_s: float = 15.0) -> dict:
    def probe():
        from layoutdit_tpu_torch.config import get_run_config
        from layoutdit_tpu_torch.train.checkpoint import CHECKPOINT_DIR, list_resume_candidates

        return list_resume_candidates(f"{get_run_config().artifact_dir}/{CHECKPOINT_DIR}")

    try:
        finished, cands = _with_timeout(probe, timeout_s)
    except Exception as e:
        return _result("checkpoints", "WARN", f"{type(e).__name__}: {e}")
    if not finished:
        return _result("checkpoints", "WARN", f"listing still hanging after {timeout_s:.0f}s")
    if not cands:
        return _result("checkpoints", "OK", "none yet (fresh run)")
    epoch, _, path = cands[0]  # best first: what --resume auto loads
    return _result("checkpoints", "OK",
                   f"{len(cands)} resumable, --resume auto picks epoch {epoch} at {path}")


def run(skip_backend: bool = False, backend_timeout: float = 120.0,
        build_timeout: float = 900.0) -> list[dict]:
    results = [check_config()]
    if not skip_backend:
        backend = check_backend(backend_timeout)
        results.append(backend)
        if backend["status"] == "FAIL":
            results.append(_result("kernels", "WARN", "skipped: backend FAILed"))
        else:
            results.append(check_kernels(build_timeout))
        results.append(check_mesh())
    results += [check_native(), check_pretrained(), check_build_dir(), *check_io(),
                check_checkpoints()]
    return results


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="layoutdit-torch-doctor",
                                     description=__doc__.splitlines()[0])
    parser.add_argument("--backend-timeout", type=float, default=120.0,
                        help="seconds before declaring the device wedged")
    parser.add_argument("--build-timeout", type=float, default=900.0,
                        help="seconds for nvcc to build every kernel")
    parser.add_argument("--skip-backend", action="store_true",
                        help="touch neither the card nor nvcc (no backend, kernels, mesh)")
    parser.add_argument("--json", action="store_true", help="machine output")
    args = parser.parse_args(argv)
    results = run(args.skip_backend, args.backend_timeout, args.build_timeout)
    if args.json:
        print(json.dumps(results))
    else:
        for r in results:
            print(f"{r['status']:<4} {r['check']:<16} {r['detail']}")
    failed = [r for r in results if r["status"] == "FAIL"]
    if failed and not args.json:
        print(f"\n{len(failed)} check(s) FAILED")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
