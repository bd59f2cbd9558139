"""Multiscale RoIAlign: the port's plain version vs the JAX package
(XLA atlas path and the Pallas kernel in interpret mode), float32 on the
CPU, and the CUDA kernel vs the plain version on the card."""

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


@pytest.mark.cuda
def test_kernel_matches_plain(cuda, rng):
    feats, boxes, mask = _setup(rng, b=4, k=512, c=256)
    tf = [torch.from_numpy(f).to(cuda, torch.bfloat16) for f in feats]
    rois, m = torch.from_numpy(boxes).to(cuda), torch.from_numpy(mask).to(cuda)
    levels = port_roi.roi_levels(rois, 5, 224.0, roi_mask=m)
    got = port_roi.roi_align_fwd(tf, rois, levels, SCALES)
    want = port_roi.roi_align_plain(tf, rois, levels, SCALES)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max() <= want.float().abs().max() / 64


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
    feats, boxes, mask = _setup(rng, b=4, k=512, c=256)
    tf = [torch.from_numpy(f).to(cuda, torch.bfloat16) for f in feats]
    rois, m = torch.from_numpy(boxes).to(cuda), torch.from_numpy(mask).to(cuda)
    levels = port_roi.roi_levels(rois, 5, 224.0, roi_mask=m)
    dout = torch.from_numpy(rng.standard_normal((4, 512, 7, 7, 256)).astype(np.float32)).to(
        cuda, torch.bfloat16)
    got = port_roi.roi_align_bwd(dout, rois, levels, tf, SCALES)
    want = port_roi.roi_align_bwd_plain(dout, rois, levels, tf, SCALES)
    torch.cuda.synchronize()
    for g, w, f in zip(got, want, tf):
        assert g.dtype == f.dtype and g.stride() == f.stride()
        # bf16 output; fp32 atomics reorder the sum from run to run
        assert (g.float() - w.float()).abs().max() <= w.float().abs().max() / 64
