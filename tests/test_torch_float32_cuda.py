"""The float32 forms of kernel-table rows 1, 3 and 7 on the card against
their plain versions, at small shapes (marked ``cuda``: they skip where
there is no GPU). No JAX here, so that the card's machine collects the
file; the plain versions are held to JAX's on the CPU in
``tests/test_torch_float32_serving.py``. TF32 is off for the plain
versions' products, as in ``chip_smoke.py``. Tolerances as phase
``serve_f32``'s: o within 2e-5 of max |plain| and the lse within 1e-5
(fp32 on both sides, another summation order and IEEE expf), RoIAlign
within 1e-5 of max |plain|."""

import numpy as np
import pytest
import torch

from layoutdit_tpu_torch.models.vit import _window_key_mask
from layoutdit_tpu_torch.ops import flash_attention as port_flash
from layoutdit_tpu_torch.ops import roi_align as port_roi
from layoutdit_tpu_torch.ops import short_attention as port_short

O_TOL = 2e-5
LSE_TOL = 1e-5
ROI_TOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def _qkv(rng, device, b, n, h, d):
    """q, k, v as strided views of one fused fp32 [B, N, 3*H*D] projection."""
    qkv = torch.from_numpy(rng.standard_normal((b, n, 3 * h * d)).astype(np.float32))
    return port_short.split_qkv(qkv.to(device), h)


def _close(got, want, rel):
    assert got.dtype == want.dtype == torch.float32
    assert (got - want).abs().max() <= rel * want.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("d", port_short.HEAD_DIMS)
@pytest.mark.parametrize("n,masked", [(1, False), (65, False), (197, False), (196, True)])
def test_short_f32_matches_plain(cuda, rng, n, d, masked):
    """Row 1's float32 form, inference and training forms (one launch
    each, counted as float32 launches), against the plain version."""
    b, h = 4, 2
    q, k, v = _qkv(rng, cuda, b, n, h, d)
    mask = _window_key_mask(26, 26, 14).to(cuda) if masked else None  # [4, 196], padded
    before = (port_short.short_attention.launches, port_short.short_attention.f32_launches)
    o = port_short.short_attention(q, k, v, key_mask=mask)
    o2, lse = port_short.short_attention(q, k, v, key_mask=mask, return_lse=True)
    after = (port_short.short_attention.launches, port_short.short_attention.f32_launches)
    assert after == (before[0] + 2, before[1] + 2)
    want, want_lse = port_short.short_attention_plain(q, k, v, key_mask=mask, return_lse=True)
    torch.cuda.synchronize()
    _close(o, want, O_TOL)
    assert torch.equal(o, o2) and (lse - want_lse).abs().max() <= LSE_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("n,bias,masked,n_keys", [
    (65, False, False, None), (65, True, False, None), (300, True, False, None),
    (196, True, True, None), (300, False, False, 150), (4097, False, False, None)])
def test_flash_f32_matches_plain(cuda, rng, n, bias, masked, n_keys):
    """Row 3's float32 form (a bias, a key mask, ``n_keys``, the ragged
    edge, 1024 px's N = 4097) against the plain version, o and lse; a
    second launch gives the same bits."""
    b, h = (1, 2) if n > 1000 else (4, 2)
    q, k, v = _qkv(rng, cuda, b, n, h, 64)
    bias = torch.randn(h, n, n, device=cuda) if bias else None
    mask = _window_key_mask(26, 26, 14).to(cuda) if masked else None
    before = port_flash.flash_attention_fwd.f32_launches
    o, lse = port_flash.flash_attention_fwd(q, k, v, bias, n_keys=n_keys, key_mask=mask)
    again = port_flash.flash_attention_fwd(q, k, v, bias, n_keys=n_keys, key_mask=mask)
    assert port_flash.flash_attention_fwd.f32_launches == before + 2
    want, want_lse = port_flash.flash_attention_plain(q, k, v, bias, n_keys=n_keys, key_mask=mask)
    torch.cuda.synchronize()
    _close(o, want, O_TOL)
    assert (lse - want_lse).abs().max() <= LSE_TOL
    assert torch.equal(o, again[0]) and torch.equal(lse, again[1])


@pytest.mark.cuda
@pytest.mark.parametrize("p", [7, 14])
def test_roi_f32_matches_plain(cuda, rng, p):
    """Row 7's float32 form on a channels-last fp32 pyramid whose fifth
    level is a strided view, as the detector makes it, RoIs over every
    level and some masked, against the plain version."""
    b, k, c = 2, 48, 16
    feats = [torch.from_numpy(rng.standard_normal((b, c, s, s)).astype(np.float32)).to(cuda)
             .contiguous(memory_format=torch.channels_last) for s in (56, 28, 14, 7)]
    feats.append(feats[-1][..., ::2, ::2])
    boxes = rng.uniform(-10, 224, (b, k, 4)).astype(np.float32)
    boxes[..., 2:] = boxes[..., :2] + rng.uniform(0.5, 120, (b, k, 2))
    rois = torch.from_numpy(boxes).to(cuda)
    mask = torch.from_numpy(rng.uniform(size=(b, k)) < 0.8).to(cuda)
    levels = port_roi.roi_levels(rois, 5, 224.0, roi_mask=mask)
    scales = [1 / 4, 1 / 8, 1 / 16, 1 / 32, 1 / 64]
    before = port_roi.roi_align_fwd.f32_launches
    got = port_roi.roi_align_fwd(feats, rois, levels, scales, p, 2)
    assert port_roi.roi_align_fwd.f32_launches == before + 1
    want = port_roi.roi_align_plain(feats, rois, levels, scales, p, 2)
    torch.cuda.synchronize()
    _close(got, want, ROI_TOL)


@pytest.mark.cuda
def test_f32_backward_refused_on_the_card(cuda):
    """A gradient through float32 attention on the card raises the
    float32-training message (the backward kernels take bf16 only)."""
    qkv = torch.randn(2, 65, 3 * 2 * 64, device=cuda, requires_grad=True)
    o = port_short.short_attention_qkv(qkv, 2)
    with pytest.raises(ValueError, match="float32 training on the card"):
        o.sum().backward()
