"""The card's side of this slice: the flash kernels' valid-key count (rows
3-5, ``n_keys``) that ring attention's blocks take, and ring attention
itself on the card (marked ``cuda``; they skip without a GPU). No JAX
here: the card's machine has none, and each test compares with the
port's plain versions.

    python -m pytest tests/test_torch_tp_cuda.py -q -m cuda

Tolerances: bf16 kernels against their plain versions (fp32 math on the
same bf16 inputs), max |err| <= max |plain| / 64, as ``chip_smoke.py``
holds them; ``n_keys == N`` the same bits as the call without it.
"""

import math

import pytest
import torch

from layoutdit_tpu_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda
REL = 1.0 / 64


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _qkv(b, n, h, seed=0):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn(b, n, h, 64, generator=g, device="cuda").to(torch.bfloat16)
            for _ in range(4)]


def _close(got, want):
    ref = float(want.detach().float().abs().max())
    assert float((got.float() - want.float()).abs().max()) <= REL * ref + 1e-6


@pytest.mark.parametrize("n,nk", [(65, 40), (2049, 2048), (2049, 1024), (300, 37)])
def test_flash_kernels_with_n_keys(cuda, n, nk):
    """The forward, dq and dkdv kernels with ``n_keys`` against their
    plain versions; the masked keys' dk and dv are exactly 0. 37 keys:
    part of the first 64-key tile valid, every later tile masked (one
    valid key: ``test_flash_kernels_with_one_valid_key``)."""
    q, k, v, do = _qkv(2, n, 4)
    scale = 1.0 / math.sqrt(64)
    o, lse = fa.flash_attention_fwd(q, k, v, None, scale, nk)
    o_ref, lse_ref = fa.flash_attention_plain(q, k, v, None, scale, nk)
    _close(o, o_ref)
    assert float((lse - lse_ref).abs().max()) <= 1e-2
    dq, dk, dv, _ = fa.flash_attention_bwd(q, k, v, o, lse, do, None, scale, n_keys=nk)
    want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, None, scale, nk)
    for got, ref in zip((dq, dk, dv), want):
        _close(got, ref)
    assert not dk[:, nk:].any() and not dv[:, nk:].any()


@pytest.mark.parametrize("n", [65, 2049])
def test_flash_kernels_with_one_valid_key(cuda, n):
    """``n_keys=1``: every query attends to key 0 alone, so o is v's first
    row and dv's first row the column sum of do (relative rule); dq and dk
    are 0 in exact arithmetic, the rounding noise of dP - delta on the
    card, held to an absolute floor of four bf16 ulps of the scores'
    scale (a key that leaked past the mask moves them by O(1)); the
    masked keys' dk and dv exactly 0."""
    q, k, v, do = _qkv(2, n, 4, seed=3)
    scale = 1.0 / math.sqrt(64)
    o, lse = fa.flash_attention_fwd(q, k, v, None, scale, 1)
    _close(o, v[:, :1].expand_as(o))
    dq, dk, dv, _ = fa.flash_attention_bwd(q, k, v, o, lse, do, None, scale, n_keys=1)
    want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, None, scale, 1)
    _close(dv, want[2])
    floor = 2.0**-6 * scale * float(q.float().abs().max()) * float(k.float().abs().max())
    for got in (dq, dk):
        assert float(got.float().abs().max()) <= floor
    assert not dk[:, 1:].any() and not dv[:, 1:].any()


@pytest.mark.parametrize("b,n,h", [(2, 197, 8), (4, 4097, 16)])
def test_n_keys_equal_to_n_is_the_unmasked_call(cuda, b, n, h):
    q, k, v, do = _qkv(b, n, h, seed=1)
    o, lse = fa.flash_attention_fwd(q, k, v)
    o2, lse2 = fa.flash_attention_fwd(q, k, v, n_keys=n)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    g1 = fa.flash_attention_bwd(q, k, v, o, lse, do)
    g2 = fa.flash_attention_bwd(q, k, v, o, lse, do, n_keys=n)
    assert all(torch.equal(a, c) for a, c in zip(g1[:3], g2[:3]))


def test_ring_attention_on_the_card_one_rank_group(cuda):
    """The ring's autograd over a group of one (a single block with its
    padding masked) against the flash path on the valid tokens."""
    from layoutdit_tpu_torch.ops.ring_attention import ring_attention
    from layoutdit_tpu_torch.parallel.mesh import ModelGroup

    class One:
        world, rank = 1, 0

        def ppermute(self, t, shift=1):
            return t

    q, k, v, do = _qkv(2, 130, 4, seed=2)
    q, k, v = (t.clone().requires_grad_(True) for t in (q, k, v))
    out = ring_attention(q, k, v, ModelGroup(1, 0, One()), 100, 1 / 8)
    (out[:, :100].float() * do[:, :100].float()).sum().backward()
    qq, kk, vv = (t.detach()[:, :100].clone().requires_grad_(True) for t in (q, k, v))
    ref = fa.flash_attention(qq, kk, vv, scale=1 / 8)
    (ref.float() * do[:, :100].float()).sum().backward()
    _close(out[:, :100], ref)
    for got, want in ((q.grad, qq.grad), (k.grad, kk.grad), (v.grad, vv.grad)):
        _close(got[:, :100], want)
    assert float(k.grad[:, 100:].float().abs().max()) == 0.0
