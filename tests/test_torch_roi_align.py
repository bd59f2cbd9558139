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
