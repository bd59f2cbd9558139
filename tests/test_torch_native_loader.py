"""The port's native JPEG loader (``layoutdit_tpu_torch/native/loader.py``,
``loader.cc``) against the JAX package's: ``decode_resize_batch`` equal
bit for bit (both built by g++ here, failed pages zero with orig (0, 0));
the decode-only entry followed by the port's device-side resize against
it, within one float32 rounding of the source coordinate on each axis
(below); header sizes against PIL; decoded pixels against PIL (within one
level: PIL may carry its own libjpeg build); threads; a failed build."""

import io

import numpy as np
import pytest
import torch
from PIL import Image

from layoutdit_tpu import native as jax_native
from layoutdit_tpu_torch.native import loader
from layoutdit_tpu_torch.ops.interpolate import resize_bilinear


def _encode(arr: np.ndarray, fmt: str = "JPEG", **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, fmt, **kw)
    return buf.getvalue()


@pytest.fixture(scope="module")
def pages():
    rng = np.random.default_rng(0)
    out = [_encode(rng.integers(0, 256, (90 + 7 * i, 70 + 5 * i, 3), dtype=np.uint8),
                   quality=60 + 5 * i) for i in range(5)]
    out.append(_encode(rng.integers(0, 256, (41, 300), dtype=np.uint8)))  # grayscale
    out.append(_encode(rng.integers(0, 256, (500, 23, 3), dtype=np.uint8), subsampling=0))
    return out


CORRUPT = [b"not a jpeg", b"", b"\xff\xd8\xff" + b"\x00" * 100]


@pytest.mark.parametrize("size", [32, 64, 224])
def test_decode_resize_batch_equals_jax_bit_for_bit(pages, size):
    assert loader.available() and jax_native.available()
    batch = pages + CORRUPT + [pages[0][: len(pages[0]) // 2]]
    got, got_orig, got_fail = loader.decode_resize_batch(batch, size)
    want, want_orig, want_fail = jax_native.decode_resize_batch(batch, size)
    assert got.dtype == np.float32 and got.shape == (len(batch), 3, size, size)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_orig, want_orig)
    assert got_fail == want_fail >= len(CORRUPT)
    failed = (got_orig == 0).all(axis=1)
    assert failed[len(pages):len(pages) + len(CORRUPT)].all() and not failed[:len(pages)].any()
    assert not got[failed].any()


@pytest.mark.parametrize("size", [32, 224, 1024])
def test_decode_then_device_resize_matches_decode_resize(pages, size):
    """The loader takes each output pixel's source coordinate
    ``(dst + 0.5) * in / out - 0.5`` in double precision, torch's resize in
    float32, whose rounding at a coordinate near ``in`` is up to
    ``in * 2**-24``; a pixel in [0, 1] moves by at most that per axis and
    rounding step, so the bound is ``2 * in * 2**-23`` for a page of
    ``in`` pixels along its longer side (measured on pages of 90-2200 px:
    at most 0.25x the bound; 1e-5 holds only for pages under about 40 px)."""
    dims = [loader.jpeg_dims(p) for p in pages]
    decoded = loader.decode_batch(pages, dims)
    want, want_orig, _ = loader.decode_resize_batch(pages, size)
    for i, arr in enumerate(decoded):
        assert arr.dtype == np.uint8 and arr.shape == (*dims[i], 3)
        assert tuple(want_orig[i]) == dims[i]
        # as the serving engine does it: the uint8 page /255, then the resize
        x = torch.from_numpy(arr).float().permute(2, 0, 1) / 255.0
        tol = 2 * max(dims[i]) * 2.0 ** -23
        np.testing.assert_allclose(resize_bilinear(x, size, size).numpy(), want[i], atol=tol,
                                   rtol=0)


def test_header_sizes_and_pixels_against_pil(pages):
    dims = [loader.jpeg_dims(p) for p in pages]
    for page, hw, arr in zip(pages, dims, loader.decode_batch(pages, dims)):
        with Image.open(io.BytesIO(page)) as im:
            assert hw == im.size[::-1]
            ref = np.asarray(im.convert("RGB"))
        assert np.abs(arr.astype(np.int16) - ref.astype(np.int16)).max() <= 1
    png = _encode(np.zeros((8, 8, 3), np.uint8), "PNG")
    for bad in CORRUPT[:2] + [png]:
        assert loader.jpeg_dims(bad) is None
    # a truncated page still has its header
    assert loader.jpeg_dims(pages[0][:len(pages[0]) // 2]) == dims[0]


def test_decode_batch_failures_and_threads(pages):
    dims = [loader.jpeg_dims(p) for p in pages]
    one = loader.decode_batch(pages, dims, n_threads=1)
    four = loader.decode_batch(pages, dims, n_threads=4)
    assert all(np.array_equal(a, b) for a, b in zip(one, four))
    # the wrong size (a buffer too small or too large), a corrupt page, no header
    wrong = [(dims[0][0] - 1, dims[0][1]), (dims[1][0] + 1, dims[1][1])]
    got = loader.decode_batch(pages[:2] + CORRUPT[:1], wrong + [(0, 0)])
    assert got == [None, None, None]
    before = loader.decode_batch.pages
    loader.decode_batch(pages[:3], dims[:3])
    assert loader.decode_batch.pages == before + 3


def test_library_is_keyed_on_source_flags_and_host(monkeypatch):
    path = loader.library_path()
    assert path.parent == loader.BUILD_DIR and path.name.startswith("loader-")
    monkeypatch.setattr(loader.platform, "node", lambda: "another-host")
    assert loader.library_path() != path


def test_failed_build_leaves_the_loader_unavailable(monkeypatch, tmp_path):
    monkeypatch.setattr(loader, "_lib", None)
    monkeypatch.setattr(loader, "_build_failed", False)
    monkeypatch.setattr(loader, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(loader, "CXX_FLAGS", loader.CXX_FLAGS + ("-DNOT_BUILT_HERE",))
    monkeypatch.setattr(loader, "_build", lambda out: False)
    assert not loader.available()
    with pytest.raises(RuntimeError, match="native loader unavailable"):
        loader.decode_resize_batch([b""], 8)


def test_builds_against_pillows_bundled_libjpeg(pages, monkeypatch, tmp_path):
    """Where the linker finds no libjpeg (the machine with the card has no
    development files), the loader links the copy the Pillow wheel
    bundles, through the headers in ``native/libjpeg``: the same pages."""
    bundled = loader.bundled_libjpeg()
    if bundled is None:
        pytest.skip("this Pillow bundles no libjpeg")
    dims = [loader.jpeg_dims(p) for p in pages]
    want = loader.decode_batch(pages, dims)
    monkeypatch.setattr(loader, "_lib", None)
    monkeypatch.setattr(loader, "_build_failed", False)
    monkeypatch.setattr(loader, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(loader, "_link_choices", lambda: [
        (str(bundled), f"-Wl,-rpath,{bundled.parent}")])
    assert loader.available()
    got = loader.decode_batch(pages, dims)
    assert all(np.abs(a.astype(np.int16) - b.astype(np.int16)).max() <= 1
               for a, b in zip(got, want))
    assert loader.jpeg_dims(CORRUPT[0]) is None
