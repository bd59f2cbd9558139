"""The card's side of the flash kernels' key mask (kernel-table rows 3-6;
marked ``cuda``; they skip without a GPU). No JAX here: the card's
machine needs none, and each test holds a masked kernel to its plain
version on the same bf16 inputs.

    python -m pytest tests/test_torch_flash_mask_cuda.py -q -m cuda

Tolerances: o, dq, dk, dv max |kernel - plain| <= max |plain| / 64 (a few
bf16 roundings: the kernels round P to bf16 before its products); lse
1e-2; dbias 1e-4 max |plain| (fp32 throughout, another summation order).
Exactly: the dropped keys' dk and dv rows 0, the same bits on a second
run, an all-True mask the unmasked kernels' bits."""

import math

import pytest
import torch

from layoutdit_tpu_torch.models import vit as port_vit
from layoutdit_tpu_torch.ops import flash_attention as fa
from layoutdit_tpu_torch.ops import short_attention as sa

pytestmark = pytest.mark.cuda
H, D = 2, 64


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _case(name, gen):
    """(B, N, key mask [rows, N] on the card, with a bias)."""
    if name == "window":  # grid 10 in windows of 3: padded to 12, 16 windows of 9
        mask = port_vit._window_key_mask(10, 10, 3)
        return 2 * mask.shape[0], 9, mask.cuda(), True
    if name == "prefix":  # pad_tokens_to=256 over 197 tokens
        return 2, 256, (torch.arange(256, device="cuda") < 197)[None], True
    mask = torch.rand(3, 300, generator=gen, device="cuda") > 1 / 3  # scattered, over 256
    mask[:, 0] = True
    return 3, 300, mask, name == "scattered_bias"


def _close(got, want, rel=1 / 64):
    err = (got.float() - want.float()).abs().max().item()
    assert err <= rel * want.float().abs().max().item(), err


@pytest.mark.parametrize("name", ["window", "prefix", "scattered", "scattered_bias"])
def test_masked_flash_kernels_match_plain(cuda, name):
    """Rows 3-6 with a key mask against their plain versions: o and lse,
    then dq, dk, dv written into one fused gradient and dbias; each
    masked kernel counted once a call."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    b, n, mask, with_bias = _case(name, gen)
    qkv = torch.randn(b, n, 3 * H * D, generator=gen, device="cuda").to(torch.bfloat16)
    q, k, v = sa.split_qkv(qkv, H)
    do = torch.randn(b, n, H, D, generator=gen, device="cuda").to(torch.bfloat16)
    bias = 0.5 * torch.randn(H, n, n, generator=gen, device="cuda") if with_bias else None
    counters = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq, fa.flash_attention_bwd_dkdv,
                fa.flash_attention_bwd_dbias)
    before = [c.masked_launches for c in counters]
    o, lse = fa.flash_attention_fwd(q, k, v, bias, key_mask=mask)
    o_ref, lse_ref = fa.flash_attention_plain(q, k, v, bias, key_mask=mask)
    _close(o, o_ref)
    assert (lse - lse_ref).abs().max().item() <= 1e-2
    dqkv = torch.empty_like(qkv)
    dbias = fa.flash_attention_bwd(q, k, v, o, lse, do, bias, out=tuple(sa.split_qkv(dqkv, H)),
                                   bias_grad=with_bias, key_mask=mask)[3]
    want = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, bias, key_mask=mask)
    for g, w in zip(sa.split_qkv(dqkv, H), want[:3]):
        _close(g, w)
    if with_bias:
        _close(dbias, want[3], rel=1e-4)
    assert [c.masked_launches - x for c, x in zip(counters, before)] == [1, 1, 1, int(with_bias)]


@pytest.mark.parametrize("name", ["window", "prefix", "scattered_bias"])
def test_masked_flash_kernels_exact_properties(cuda, name):
    """The dropped keys' dk and dv rows are exactly 0, two runs give the
    same bits, and an all-True mask gives the unmasked kernels' bits,
    forward and backward."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    b, n, mask, with_bias = _case(name, gen)
    q, k, v, do = (torch.randn(b, n, H, D, generator=gen, device="cuda").to(torch.bfloat16)
                   for _ in range(4))
    bias = 0.5 * torch.randn(H, n, n, generator=gen, device="cuda") if with_bias else None
    scale = 1.0 / math.sqrt(D)
    o, lse = fa.flash_attention_fwd(q, k, v, bias, scale, key_mask=mask)
    grads = fa.flash_attention_bwd(q, k, v, o, lse, do, bias, scale, bias_grad=with_bias,
                                   key_mask=mask)
    again = fa.flash_attention_bwd(q, k, v, o, lse, do, bias, scale, bias_grad=with_bias,
                                   key_mask=mask)
    assert all(x is y or torch.equal(x, y) for x, y in zip(grads, again))
    dropped = ~sa.key_mask_rows(mask, b)
    assert not grads[1][dropped].any() and not grads[2][dropped].any()
    everything = torch.ones_like(mask)
    unmasked = fa.flash_attention_fwd(q, k, v, bias, scale)
    assert all(torch.equal(x, y) for x, y in zip(
        unmasked, fa.flash_attention_fwd(q, k, v, bias, scale, key_mask=everything)))
    want = fa.flash_attention_bwd(q, k, v, *unmasked, do, bias, scale, bias_grad=with_bias)
    got = fa.flash_attention_bwd(q, k, v, *unmasked, do, bias, scale, bias_grad=with_bias,
                                 key_mask=everything)
    assert all(x is y or torch.equal(x, y) for x, y in zip(want, got))


def test_masked_attention_core_through_autograd(cuda):
    """``attention_core`` with a padded window grid's mask and a bias on
    the card: the masked flash kernels, forward and backward through
    autograd (the bias's gradient too), against the plain versions (the
    backward at the kernel's o)."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    mask = port_vit._window_key_mask(10, 10, 3).cuda()
    b, n = 2 * mask.shape[0], 9
    qkv = torch.randn(b, n, 3 * H * D, generator=gen, device="cuda").to(torch.bfloat16)
    bias = 0.5 * torch.randn(H, n, n, generator=gen, device="cuda")
    cot = torch.randn(b, n, H, D, generator=gen, device="cuda").to(torch.bfloat16)
    launched = fa.flash_attention_bwd_dbias.masked_launches
    x, bb = qkv.clone().requires_grad_(), bias.clone().requires_grad_()
    out = port_vit.attention_core(x, H, key_mask=mask, bias=bb)
    out.backward(cot)
    assert fa.flash_attention_bwd_dbias.masked_launches == launched + 1
    q, k, v = sa.split_qkv(qkv, H)
    o, lse = fa.flash_attention_plain(q, k, v, bias, key_mask=mask)
    _close(out, o)
    # the plain backward at the kernel's o, which delta = rowsum(dO o O) reads
    dq, dk, dv, dbias = fa.flash_attention_bwd_plain(q, k, v, out.detach(), lse, cot, bias,
                                                     key_mask=mask)
    _close(x.grad, torch.cat([t.reshape(b, n, -1) for t in (dq, dk, dv)], dim=-1))
    _close(bb.grad, dbias, rel=1e-4)
