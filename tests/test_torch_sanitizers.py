"""The sanitizers over the port's native code.

ASan + UBSan over the port's copy of the native COCO parser
(``layoutdit_tpu_torch/native/coco_parse.cc``), driven by its harness
``native/sanitize_coco.cc`` over the hostile COCO corpus of
``tests/test_sanitizers.py`` (truncations at every 37th byte, byte
flips, garbage, deep nesting, escape bombs, a lone surrogate); and over
the port's JPEG loader (``native/loader.cc``), driven by
``native/sanitize_jpeg.cc`` over that file's JPEG corpus (truncations, a
flipped byte, an empty file, a bare SOI marker), through both batch
entries (``ld_decode_resize_batch``, and ``ld_jpeg_dims`` +
``ld_decode_batch``); TSan over both threaded entries. Each skips only
when g++ cannot build with the sanitizers."""

import importlib.util
import os
import subprocess

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE = os.path.join(REPO, "layoutdit_tpu_torch", "native")


def _jax_sanitizers():
    spec = importlib.util.spec_from_file_location(
        "jax_sanitizers", os.path.join(REPO, "tests", "test_sanitizers.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_corpus(tmp: str) -> list[str]:
    return _jax_sanitizers()._corpus_coco(tmp)


def _jpeg_binary(tmp_path, flags: list[str]) -> str:
    binary = str(tmp_path / "sanitize_jpeg")
    cmd = ["g++", "-O1", "-g", "-fno-omit-frame-pointer", *flags, "-o", binary,
           f"-I{os.path.join(NATIVE, 'libjpeg')}",
           os.path.join(NATIVE, "sanitize_jpeg.cc"), os.path.join(NATIVE, "loader.cc"),
           "-ljpeg", "-pthread"]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=180)
    if r.returncode != 0:
        pytest.skip(f"g++ cannot build with the sanitizers: {r.stderr[-300:]}")
    return binary


# each batch entry of the loader: the JAX loader's decode + resize, and the
# port's header read + decode into caller buffers
JPEG_MODES = {"resize": ["resize", "32"], "decode": ["decode"]}


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


@pytest.mark.parametrize("mode", sorted(JPEG_MODES))
def test_asan_ubsan_jpeg_corpus(tmp_path, mode):
    binary = _jpeg_binary(tmp_path, ["-fsanitize=address,undefined",
                                     "-fno-sanitize-recover=all"])
    corpus = _jax_sanitizers()._corpus_jpeg(str(tmp_path))
    r = subprocess.run([binary, *JPEG_MODES[mode], *corpus], capture_output=True, text=True,
                       timeout=300, env={**os.environ, "ASAN_OPTIONS": "detect_leaks=1"})
    assert r.returncode == 0, r.stderr[-2000:]
    failed, total = r.stdout.rsplit(" failed", 1)[0].split()[-1].split("/")
    # the two valid pages decode; the hostile ones may not
    assert int(total) == len(corpus) and int(failed) <= len(corpus) - 2


@pytest.mark.parametrize("mode", sorted(JPEG_MODES))
def test_tsan_threaded_jpeg_decode(tmp_path, mode):
    binary = _jpeg_binary(tmp_path, ["-fsanitize=thread"])
    corpus = _jax_sanitizers()._corpus_jpeg(str(tmp_path)) * 4  # work for all 4 threads
    r = subprocess.run([binary, *JPEG_MODES[mode], *corpus], capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "WARNING: ThreadSanitizer" not in r.stderr
