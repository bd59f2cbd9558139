"""Multiscale RoIAlign: the port's plain version vs the JAX package
(XLA atlas path and the Pallas kernel in interpret mode), float32 on the
CPU, the footprints the backward kernel's tile test uses against the
support of the separable weights, the same values and gradients for
NCHW and channels-last pyramids, and the CUDA kernels vs the plain
version on the card (channels-last, as the detector makes the pyramid)."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from layoutdit_tpu.ops.roi_align import multiscale_roi_align as jax_roi_align
from layoutdit_tpu_torch.ops import roi_align as port_roi

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

TOL = 1e-5  # float32, same function; only the summation order differs
SIZES = (56, 28, 14, 7, 4)  # the 224 px pyramid p2..p5 + pool
SIZES_1024 = (256, 128, 64, 32, 16)
SCALES = [1 / 4, 1 / 8, 1 / 16, 1 / 32, 1 / 64]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _setup(rng, b=2, k=96, c=16, sizes=SIZES, image=224.0):
    feats = [rng.standard_normal((b, c, s, s)).astype(np.float32) for s in sizes]
    boxes = rng.uniform(-10, image, (b, k, 4)).astype(np.float32)
    boxes[..., 2:] = boxes[..., :2] + rng.uniform(0.2, image / 2, (b, k, 2))
    boxes[:, :4] = [[0, 0, 0, 0], [5, 5, 5.5, 5.5], [200, 200, 260, 300], [-30, -30, -5, -5]]
    mask = rng.uniform(size=(b, k)) < 0.8
    return feats, boxes, mask


def _detector_layout(feats: list[torch.Tensor]) -> list[torch.Tensor]:
    """The pyramid as the detector makes it: p2..p5 channels-last, the
    fifth level the strided view p5[..., ::2, ::2] (its values replace
    ``feats[4]``, whose shape it has)."""
    out = [f.contiguous(memory_format=torch.channels_last) for f in feats[:4]]
    out.append(out[3][..., ::2, ::2])
    assert out[4].shape == feats[4].shape and all(f.stride(1) == 1 for f in out)
    return out


@pytest.mark.parametrize("p,g", [(7, 2), (14, 2)])
@pytest.mark.parametrize("image,sizes", [(224, SIZES), (1024, SIZES_1024)])
def test_footprints_match_weight_support(rng, image, sizes, p, g):
    """roi_footprints, the spec of the backward kernel's tile test, is the
    row and column span of the non-zero separable weights of each RoI on
    its level, edge RoIs included (zero size, outside the image, larger
    than the image), and empty for masked RoIs."""
    _, boxes, mask = _setup(rng, k=128, sizes=(), image=float(image))
    boxes[:, 4:7] = [[-40, -30, image + 50, image + 20], [0, 0, image, image],
                     [image - 1, image - 1, image + 300, image + 300]]
    rois, m = torch.from_numpy(boxes), torch.from_numpy(mask)
    levels = port_roi.roi_levels(rois, 5, float(image), roi_mask=m)
    hw = [(s, s) for s in sizes]
    got = port_roi.roi_footprints(rois, levels, hw, SCALES, p, g)
    assert got.dtype == torch.int32 and got.shape == (2, 128, 4)
    want = torch.tensor([0, -1, 0, -1], dtype=torch.int32).repeat(2 * 128, 1)
    flat = rois.reshape(-1, 4)
    for li, (size, scale) in enumerate(zip(sizes, SCALES)):
        sel = levels.reshape(-1) == li
        if not sel.any():
            continue
        wy, wx = port_roi.build_roi_weights(flat[sel], scale, (size, size), p, g)
        rows, cols = (wy > 0).any(dim=1), (wx > 0).any(dim=1)  # [M, size]
        ix = torch.arange(size)
        span = torch.stack([
            torch.where(rows, ix, size).amin(1), torch.where(rows, ix, -1).amax(1),
            torch.where(cols, ix, size).amin(1), torch.where(cols, ix, -1).amax(1),
        ], dim=1).to(torch.int32)
        empty = ~(rows.any(1) & cols.any(1))
        span[empty] = torch.tensor([0, -1, 0, -1], dtype=torch.int32)
        want[sel] = span
    torch.testing.assert_close(got.reshape(-1, 4), want, rtol=0, atol=0)
    assert (got[~m] == torch.tensor([0, -1, 0, -1], dtype=torch.int32)).all()
    assert (got[..., 1] >= got[..., 0]).any() and (got[..., 1] < got[..., 0]).any()


@pytest.mark.parametrize("p,g", [(7, 2), (14, 2)])
def test_layouts_give_same_values_and_gradients(rng, p, g):
    """multiscale_roi_align gives the same values and feature gradients for
    an NCHW pyramid and the detector's channels-last one with its strided
    fifth level; the gradients keep their feature's shape."""
    feats, boxes, mask = _setup(rng, k=48)
    boxes[:, 4:7] = [[10, 10, 150, 130], [0, 0, 224, 224], [-10, -10, 250, 240]]  # p3, p4
    mask[:, 4:7] = True
    cl = _detector_layout([torch.from_numpy(f) for f in feats])
    nchw = [f.contiguous() for f in cl]
    dout = torch.from_numpy(rng.standard_normal((2, 48, p, p, 16)).astype(np.float32))
    rois, m = torch.from_numpy(boxes), torch.from_numpy(mask)
    results = []
    for pyramid in (nchw, cl):
        leaves = [f.detach().requires_grad_(True) for f in pyramid]
        out = port_roi.multiscale_roi_align(leaves, rois, SCALES, output_size=p,
                                            sampling_ratio=g, roi_mask=m, native_layout=True)
        results.append((out, torch.autograd.grad(out, leaves, dout)))
    (out_a, grads_a), (out_b, grads_b) = results
    assert out_a.shape == (2, 48, p, p, 16) and torch.equal(out_a, out_b)
    for ga, gb, f in zip(grads_a, grads_b, feats):
        assert ga.shape == gb.shape == f.shape and torch.equal(ga, gb)
    assert all(float(ga.abs().sum()) > 0 for ga in grads_a[:3])


@pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
def test_plain_matches_jax(rng, impl):
    feats, boxes, mask = _setup(rng)
    got = port_roi.multiscale_roi_align(
        [torch.from_numpy(f) for f in feats], torch.from_numpy(boxes), SCALES,
        canonical_scale=224.0, roi_mask=torch.from_numpy(mask), native_layout=True,
    )
    assert got.shape == (2, 96, 7, 7, 16)
    jax_fn = jax.jit(functools.partial(
        jax_roi_align, spatial_scales=SCALES, canonical_scale=224.0, impl=impl,
        native_layout=True,
    ))
    for i in range(2):
        want = jax_fn([jnp.asarray(f[i]) for f in feats], jnp.asarray(boxes[i]),
                      roi_mask=jnp.asarray(mask[i]))
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    assert not got[torch.from_numpy(~mask)].any()  # masked RoIs give zeros


def test_torchvision_layout_and_levels(rng):
    feats, boxes, mask = _setup(rng, b=1, k=40)
    tf = [torch.from_numpy(f) for f in feats]
    native = port_roi.multiscale_roi_align(tf, torch.from_numpy(boxes), SCALES, native_layout=True)
    tv = port_roi.multiscale_roi_align(tf, torch.from_numpy(boxes), SCALES)
    torch.testing.assert_close(tv, native.permute(0, 1, 4, 3, 2))
    want = jax.jit(functools.partial(jax_roi_align, spatial_scales=SCALES))(
        [jnp.asarray(f[0]) for f in feats], jnp.asarray(boxes[0])
    )
    np.testing.assert_allclose(tv[0].numpy(), np.asarray(want), atol=TOL, rtol=TOL)

    lv = port_roi.roi_levels(torch.from_numpy(boxes), 5, 224.0, roi_mask=torch.from_numpy(mask))
    assert lv.dtype == torch.int32
    assert ((lv >= -1) & (lv < 5)).all()
    assert (lv[torch.from_numpy(~mask)] == -1).all()


def _cuda_case(rng, cuda, p=7, b=4, k=512, c=256):
    """Channels-last bf16 features (the fifth level a strided view), RoIs
    and levels on the card, and a bf16 dout of the pooled shape."""
    feats, boxes, mask = _setup(rng, b=b, k=k, c=c)
    tf = _detector_layout([torch.from_numpy(f).to(cuda, torch.bfloat16) for f in feats])
    rois, m = torch.from_numpy(boxes).to(cuda), torch.from_numpy(mask).to(cuda)
    levels = port_roi.roi_levels(rois, 5, 224.0, roi_mask=m)
    dout = torch.from_numpy(rng.standard_normal((b, k, p, p, c)).astype(np.float32)).to(
        cuda, torch.bfloat16)
    return tf, rois, levels, dout


@pytest.mark.cuda
def test_kernel_matches_plain(cuda, rng):
    tf, rois, levels, _ = _cuda_case(rng, cuda)
    got = port_roi.roi_align_fwd(tf, rois, levels, SCALES)
    want = port_roi.roi_align_plain(tf, rois, levels, SCALES)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max() <= want.float().abs().max() / 64


@pytest.mark.cuda
def test_kernels_match_plain_mask_head_size(cuda, rng):
    """The (14, 2) instantiation, forward and backward, as a mask head
    would call it."""
    tf, rois, levels, dout = _cuda_case(rng, cuda, p=14, b=2, k=128)
    got = port_roi.roi_align_fwd(tf, rois, levels, SCALES, output_size=14)
    want = port_roi.roi_align_plain(tf, rois, levels, SCALES, output_size=14)
    assert (got.float() - want.float()).abs().max() <= want.float().abs().max() / 64
    got = port_roi.roi_align_bwd(dout, rois, levels, tf, SCALES, output_size=14)
    want = port_roi.roi_align_bwd_plain(dout, rois, levels, tf, SCALES, output_size=14)
    for gl, wl in zip(got, want):
        assert (gl.float() - wl.float()).abs().max() <= wl.float().abs().max() / 64


@pytest.mark.cuda
def test_kernels_refuse_nchw_and_other_sizes(cuda, rng):
    """A CUDA feature whose channel stride is not 1 raises in both
    wrappers (no quiet copy), and so does a size with no instantiation."""
    tf, rois, levels, dout = _cuda_case(rng, cuda, b=2, k=64)
    nchw = [f.contiguous() for f in tf]
    with pytest.raises(ValueError, match="channel stride 1"):
        port_roi.roi_align_fwd(nchw, rois, levels, SCALES)
    with pytest.raises(ValueError, match="channel stride 1"):
        port_roi.roi_align_bwd(dout, rois, levels, nchw, SCALES)
    with pytest.raises(ValueError, match="instantiated"):
        port_roi.roi_align_fwd(tf, rois, levels, SCALES, output_size=5)


@pytest.mark.cuda
def test_footprint_kernel_matches_spec(cuda, rng):
    tf, rois, levels, _ = _cuda_case(rng, cuda)
    hw = [tuple(f.shape[-2:]) for f in tf]
    for p in (7, 14):
        got = port_roi.roi_footprints_kernel(rois, levels, hw, SCALES, p, 2)
        assert torch.equal(got, port_roi.roi_footprints(rois, levels, hw, SCALES, p, 2))


@pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
def test_bwd_plain_matches_jax(rng, impl):
    feats, boxes, mask = _setup(rng, k=48)
    # RoIs on every level the 224 px mapper reaches (p2..p4), one of them
    # larger than the image
    boxes[:, 4:7] = [[10, 10, 150, 130], [0, 0, 224, 224], [-10, -10, 250, 240]]
    mask[:, 4:7] = True
    assert set(port_roi.roi_levels(torch.from_numpy(boxes), 5, 224.0).unique().tolist()) >= {0, 1, 2}
    dout = rng.standard_normal((2, 48, 7, 7, 16)).astype(np.float32)
    tf = [torch.from_numpy(f).requires_grad_(True) for f in feats]
    rois = torch.from_numpy(boxes).requires_grad_(True)
    out = port_roi.multiscale_roi_align(
        tf, rois, SCALES, canonical_scale=224.0, roi_mask=torch.from_numpy(mask),
        native_layout=True,
    )
    got = torch.autograd.grad(out, tf, torch.from_numpy(dout))
    assert rois.grad is None and all(not t.grad_fn for t in got)
    lv = port_roi.roi_levels(torch.from_numpy(boxes), 5, 224.0, roi_mask=torch.from_numpy(mask))
    plain = port_roi.roi_align_bwd_plain(torch.from_numpy(dout), torch.from_numpy(boxes), lv,
                                         tf, SCALES)
    for i in range(2):
        fn = functools.partial(jax_roi_align, spatial_scales=SCALES, canonical_scale=224.0,
                               impl=impl, native_layout=True, roi_mask=jnp.asarray(mask[i]))
        _, vjp = jax.vjp(lambda fs: fn(fs, jnp.asarray(boxes[i])), [jnp.asarray(f[i]) for f in feats])
        (want,) = vjp(jnp.asarray(dout[i]))
        for g, p, w in zip(got, plain, want):
            np.testing.assert_allclose(g[i].numpy(), np.asarray(w), atol=TOL, rtol=TOL)
            np.testing.assert_allclose(p[i].numpy(), np.asarray(w), atol=TOL, rtol=TOL)
    assert all(float(g.abs().sum()) > 0 for g in got[:3])


@pytest.mark.cuda
def test_bwd_kernel_matches_plain(cuda, rng):
    tf, rois, levels, dout = _cuda_case(rng, cuda)
    got = port_roi.roi_align_bwd(dout, rois, levels, tf, SCALES)
    again = port_roi.roi_align_bwd(dout, rois, levels, tf, SCALES)
    want = port_roi.roi_align_bwd_plain(dout, rois, levels, tf, SCALES)
    torch.cuda.synchronize()
    for g, a, w, f in zip(got, again, want, tf):
        assert g.dtype == f.dtype and g.shape == f.shape and g.stride(1) == 1
        assert torch.equal(g, a)  # a fixed summation order: the same bits every run
        # bf16 output; fp32 sums in another order than the plain version's
        assert (g.float() - w.float()).abs().max() <= w.float().abs().max() / 64
