"""ASan + UBSan over the port's copy of the native COCO parser
(``layoutdit_tpu_torch/native/coco_parse.cc``), driven by its harness
``native/sanitize_coco.cc`` over the hostile COCO corpus of
``tests/test_sanitizers.py`` (truncations at every 37th byte, byte
flips, garbage, deep nesting, escape bombs, a lone surrogate). The JPEG
loader is not ported yet (ROADMAP queue 1 item 4), so there is no TSan
run. Skips only when g++ cannot build with the sanitizers."""

import importlib.util
import os
import subprocess

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE = os.path.join(REPO, "layoutdit_tpu_torch", "native")


def _jax_corpus(tmp: str) -> list[str]:
    spec = importlib.util.spec_from_file_location(
        "jax_sanitizers", os.path.join(REPO, "tests", "test_sanitizers.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod._corpus_coco(tmp)


def test_asan_ubsan_coco_corpus(tmp_path):
    binary = str(tmp_path / "sanitize_coco")
    cmd = ["g++", "-O1", "-g", "-fno-omit-frame-pointer", "-fsanitize=address,undefined",
           "-fno-sanitize-recover=all", "-o", binary,
           os.path.join(NATIVE, "sanitize_coco.cc"), os.path.join(NATIVE, "coco_parse.cc")]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=180)
    if r.returncode != 0:
        pytest.skip(f"g++ cannot build with the sanitizers: {r.stderr[-300:]}")
    corpus = _jax_corpus(str(tmp_path))
    r = subprocess.run([binary, *corpus], capture_output=True, text=True, timeout=300,
                       env={**os.environ, "ASAN_OPTIONS": "detect_leaks=1"})
    assert r.returncode == 0, r.stderr[-2000:]
    parsed, total = r.stdout.split("coco:")[1].split()[0].split("/")
    # the valid file (at least) parses; most of the corpus is hostile
    assert int(total) == len(corpus) > 50 and int(parsed) >= 1
