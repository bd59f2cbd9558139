"""Attention: the port's plain versions vs the JAX Pallas kernels (run in
interpret mode, as the JAX package's own tests run them), in float32 on
the CPU, and the CUDA kernels vs the plain versions on the card."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from layoutdit_tpu.ops import flash_attention as jax_flash
from layoutdit_tpu.ops.short_attention import short_attention as jax_short
from layoutdit_tpu_torch.ops import flash_attention as port_flash
from layoutdit_tpu_torch.ops import short_attention as port_short

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

TOL = 1e-5  # float32, same math; only the summation order differs


def _qkv(rng, b, n, h, d):
    return [rng.standard_normal((b, n, h, d)).astype(np.float32) for _ in range(3)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("n", [7, 197])
def test_short_plain_matches_pallas(rng, n):
    q, k, v = _qkv(rng, 2, n, 3, 64)
    want = np.asarray(jax_short(*map(jnp.asarray, (q, k, v)), interpret=True))
    got = port_short.short_attention_plain(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("n", [130, 300])
@pytest.mark.parametrize("with_bias", [False, True])
def test_flash_plain_matches_pallas(rng, n, with_bias):
    b, h, d = 2, 3, 32
    q, k, v = _qkv(rng, b, n, h, d)
    bias = rng.standard_normal((h, n, n)).astype(np.float32) if with_bias else None
    jb = None if bias is None else jnp.asarray(bias)
    want = np.asarray(jax_flash.flash_attention(
        *map(jnp.asarray, (q, k, v)), bias=jb, interpret=True
    ))
    tb = None if bias is None else torch.from_numpy(bias)
    got, lse = port_flash.flash_attention_plain(*map(torch.from_numpy, (q, k, v)), bias=tb)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)

    # the per-row log-sum-exp the kernel also emits (one lane of the
    # TPU kernel's lane-replicated copy)
    to_bh = lambda x: jnp.asarray(x).transpose(0, 2, 1, 3).reshape(b * h, n, d)  # noqa: E731
    _, jax_lse = jax_flash._flash_fwd(
        to_bh(q), to_bh(k), to_bh(v), jb, 1.0 / np.sqrt(d), *jax_flash._auto_blocks(n, None, None),
        True,
    )
    np.testing.assert_allclose(lse.numpy(), np.asarray(jax_lse)[:, :n, 0], atol=TOL, rtol=TOL)


def test_cpu_wrappers_take_the_plain_version(rng):
    q, k, v = map(torch.from_numpy, _qkv(rng, 1, 20, 2, 16))
    before = (port_short.short_attention.launches, port_flash.flash_attention_fwd.launches)
    torch.testing.assert_close(
        port_short.short_attention(q, k, v), port_short.short_attention_plain(q, k, v)
    )
    torch.testing.assert_close(
        port_flash.flash_attention(q, k, v), port_flash.flash_attention_plain(q, k, v)[0]
    )
    after = (port_short.short_attention.launches, port_flash.flash_attention_fwd.launches)
    assert after == before  # nothing launched on the CPU


def test_other_devices_raise():
    q = torch.empty(1, 8, 2, 16, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        port_short.short_attention(q, q, q)
    with pytest.raises(ValueError, match="unsupported device"):
        port_flash.flash_attention(q, q, q)


@pytest.mark.cuda
def test_short_kernel_matches_plain(cuda, rng):
    q, k, v = (torch.from_numpy(x).to(cuda, torch.bfloat16) for x in _qkv(rng, 4, 197, 12, 64))
    got = port_short.short_attention(q, k, v)
    want = port_short.short_attention_plain(q, k, v)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max() <= want.float().abs().max() / 64


@pytest.mark.cuda
@pytest.mark.parametrize("with_bias", [False, True])
def test_flash_kernel_matches_plain(cuda, rng, with_bias):
    n, h = 600, 4
    q, k, v = (torch.from_numpy(x).to(cuda, torch.bfloat16) for x in _qkv(rng, 2, n, h, 64))
    bias = torch.randn(h, n, n, device=cuda) if with_bias else None
    got, lse = port_flash.flash_attention_fwd(q, k, v, bias)
    want, want_lse = port_flash.flash_attention_plain(q, k, v, bias)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max() <= want.float().abs().max() / 64
    assert (lse - want_lse).abs().max() <= 1e-2


@pytest.mark.parametrize("n", [7, 197])  # below and above 128: both pad in the Pallas kernel
def test_short_bwd_plain_and_function_match_pallas(rng, n):
    import jax

    b, h, d = 2, 3, 64
    q, k, v = _qkv(rng, b, n, h, d)
    do = rng.standard_normal((b, n, h, d)).astype(np.float32)
    o, vjp = jax.vjp(lambda *x: jax_short(*x, interpret=True), *map(jnp.asarray, (q, k, v)))
    want = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    np.testing.assert_allclose(
        port_short.short_attention_plain(*map(torch.from_numpy, (q, k, v))).numpy(),
        np.asarray(o), atol=TOL, rtol=TOL)
    got = port_short.short_attention_bwd_plain(
        *map(torch.from_numpy, (q, k, v, np.array(o), do)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=TOL, rtol=TOL)

    # the autograd Function from the fused projection: its gradient is the
    # three slices of one [B, N, 3*H*D] tensor
    qkv = torch.from_numpy(np.concatenate([x.reshape(b, n, h * d) for x in (q, k, v)], -1))
    qkv.requires_grad_(True)
    ctx = port_short.short_attention_qkv(qkv, h)
    (dqkv,) = torch.autograd.grad(ctx, qkv, torch.from_numpy(do))
    for i, w in enumerate(want):
        np.testing.assert_allclose(dqkv[..., i * h * d:(i + 1) * h * d].reshape(b, n, h, d)
                                   .numpy(), w, atol=TOL, rtol=TOL)


def _fused(b, n, h, d, *xs):
    """[B, N, H, D] arrays -> one fused [B, N, 3*H*D] projection."""
    return torch.from_numpy(np.concatenate([x.reshape(b, n, h * d) for x in xs], -1))


@pytest.mark.parametrize("n", [130, 300])
@pytest.mark.parametrize("with_bias", [False, True])
def test_flash_bwd_plain_matches_pallas(rng, n, with_bias):
    import jax

    b, h, d = 2, 3, 32
    q, k, v = _qkv(rng, b, n, h, d)
    do = rng.standard_normal((b, n, h, d)).astype(np.float32)
    bias = rng.standard_normal((h, n, n)).astype(np.float32) if with_bias else None
    jb = None if bias is None else jnp.asarray(bias)
    o, vjp = jax.vjp(lambda *x: jax_flash.flash_attention(*x, bias=jb, interpret=True),
                     *map(jnp.asarray, (q, k, v)))
    want = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    tb = None if bias is None else torch.from_numpy(bias)
    po, lse = port_flash.flash_attention_plain(*map(torch.from_numpy, (q, k, v)), bias=tb)
    got = port_flash.flash_attention_bwd_plain(
        *map(torch.from_numpy, (q, k, v)), po, lse, torch.from_numpy(do), tb)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=TOL, rtol=TOL)

    # the oracle of the Pallas backward, on [B*H, N, D] slices
    to_bh = lambda x: jnp.asarray(x).transpose(0, 2, 1, 3).reshape(b * h, n, d)  # noqa: E731
    ref = jax_flash._bwd_reference(to_bh(q), to_bh(k), to_bh(v), jb, 1.0 / np.sqrt(d),
                                   to_bh(np.asarray(o)), to_bh(do), n)
    for g, w in zip(got, ref[:3]):
        w = np.asarray(w).reshape(b, h, n, d).transpose(0, 2, 1, 3)
        np.testing.assert_allclose(g.numpy(), w, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("n", [130, 300])
@pytest.mark.parametrize("with_bias", [False, True])
def test_flash_qkv_gradient_matches_pallas(rng, n, with_bias):
    """The autograd Function from the fused projection: its gradient is
    the three slices of one [B, N, 3*H*D] tensor."""
    import jax

    b, h, d = 2, 3, 32
    q, k, v = _qkv(rng, b, n, h, d)
    do = rng.standard_normal((b, n, h, d)).astype(np.float32)
    bias = rng.standard_normal((h, n, n)).astype(np.float32) if with_bias else None
    jb = None if bias is None else jnp.asarray(bias)
    o, vjp = jax.vjp(lambda *x: jax_flash.flash_attention(*x, bias=jb, interpret=True),
                     *map(jnp.asarray, (q, k, v)))
    want = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    tb = None if bias is None else torch.from_numpy(bias)
    qkv = _fused(b, n, h, d, q, k, v).requires_grad_(True)
    ctx = port_flash.flash_attention_qkv(qkv, h, bias=tb)
    np.testing.assert_allclose(ctx.detach().numpy(), np.asarray(o), atol=TOL, rtol=TOL)
    (dqkv,) = torch.autograd.grad(ctx, qkv, torch.from_numpy(do))
    for i, w in enumerate(want):
        np.testing.assert_allclose(dqkv[..., i * h * d:(i + 1) * h * d].reshape(b, n, h, d)
                                   .numpy(), w, atol=TOL, rtol=TOL)
    # the same function over separate q, k, v
    qt, kt, vt = (torch.from_numpy(x).requires_grad_(True) for x in (q, k, v))
    grads = torch.autograd.grad(port_flash.flash_attention(qt, kt, vt, bias=tb), (qt, kt, vt),
                                torch.from_numpy(do))
    for g, w in zip(grads, want):
        np.testing.assert_allclose(g.numpy(), w, atol=TOL, rtol=TOL)


def test_gradient_through_flash_path_raises(rng):
    """attention_core gives gradients past 256 tokens (the flash route);
    what still raises is a gradient asked of the bias, whose kernel
    (dbias, kernel-table row 6) is not ported."""
    from layoutdit_tpu_torch.models.vit import attention_core

    qkv = torch.from_numpy(rng.standard_normal((1, 300, 3 * 32)).astype(np.float32))
    with torch.no_grad():
        assert attention_core(qkv, 2).shape == (1, 300, 2, 16)  # forward only is fine
    qkv.requires_grad_(True)
    ctx = attention_core(qkv, 2)
    (g,) = torch.autograd.grad(ctx.sum(), qkv)
    assert torch.isfinite(g).all() and g.abs().sum() > 0
    assert attention_core(qkv[:, :200], 2).requires_grad  # the short kernels have one too
    q = qkv.detach()[..., :32].reshape(1, 300, 2, 16)
    bias = torch.zeros(2, 300, 300, requires_grad=True)
    with pytest.raises(NotImplementedError, match="row 6"):
        port_flash.flash_attention(q, q, q, bias)
    with pytest.raises(NotImplementedError, match="row 6"):
        port_flash.flash_attention_qkv(qkv, 2, bias=bias)
    with torch.no_grad():  # no gradient asked: the bias is a constant
        port_flash.flash_attention(q, q, q, bias)


def test_cpu_bwd_wrapper_takes_the_plain_version_and_fills_out(rng):
    b, n, h, d = 1, 70, 2, 16
    q, k, v, do = (torch.from_numpy(x) for x in _qkv(rng, b, n, h, d) + [
        rng.standard_normal((b, n, h, d)).astype(np.float32)])
    o, lse = port_flash.flash_attention_plain(q, k, v)
    counters = (port_flash.flash_attention_bwd_dq, port_flash.flash_attention_bwd_dkdv)
    before = [c.launches for c in counters]
    dqkv = torch.empty(b, n, 3 * h * d)
    out = tuple(port_short.split_qkv(dqkv, h))
    got = port_flash.flash_attention_bwd(q, k, v, o, lse, do, out=out)
    assert all(g is t for g, t in zip(got, out))
    for g, w in zip(out, port_flash.flash_attention_bwd_plain(q, k, v, o, lse, do)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert [c.launches for c in counters] == before
    with pytest.raises(ValueError, match="unsupported device"):
        m = torch.empty(1, 8, 2, 16, device="meta")
        port_flash.flash_attention_bwd(m, m, m, m, m, m)


@pytest.mark.cuda
def test_short_bwd_kernel_matches_plain(cuda, rng):
    b, n, h, d = 4, 197, 12, 64
    qkv = torch.from_numpy(rng.standard_normal((b, n, 3 * h * d)).astype(np.float32))
    qkv = qkv.to(cuda, torch.bfloat16).requires_grad_(True)
    do = torch.from_numpy(rng.standard_normal((b, n, h, d)).astype(np.float32)).to(
        cuda, torch.bfloat16)
    ctx = port_short.short_attention_qkv(qkv, h)
    before = port_short.short_attention_bwd.launches
    (dqkv,) = torch.autograd.grad(ctx, qkv, do)
    assert port_short.short_attention_bwd.launches == before + 1
    q, k, v = port_short.split_qkv(qkv.detach(), h)
    want = port_short.short_attention_bwd_plain(q, k, v, ctx.detach(), do)
    torch.cuda.synchronize()
    for got, w in zip(port_short.split_qkv(dqkv, h), want):
        assert (got.float() - w.float()).abs().max() <= w.float().abs().max() / 64


@pytest.mark.cuda
@pytest.mark.parametrize("with_bias", [False, True])
def test_flash_bwd_kernel_matches_plain(cuda, rng, with_bias):
    """Both backward kernels against the plain version at a ragged N, q/k/v
    and dq/dk/dv strided in fused [B, N, 3*H*D] tensors, through the
    autograd Function; the gradients are the same bits on a second run
    (no atomics)."""
    b, n, h, d = 2, 600, 4, 64
    qkv = torch.from_numpy(rng.standard_normal((b, n, 3 * h * d)).astype(np.float32))
    qkv = qkv.to(cuda, torch.bfloat16).requires_grad_(True)
    do = torch.from_numpy(rng.standard_normal((b, n, h, d)).astype(np.float32)).to(
        cuda, torch.bfloat16)
    bias = torch.randn(h, n, n, device=cuda) if with_bias else None
    ctx = port_flash.flash_attention_qkv(qkv, h, bias=bias)
    counters = (port_flash.flash_attention_bwd_dq, port_flash.flash_attention_bwd_dkdv)
    before = [c.launches for c in counters]
    (dqkv,) = torch.autograd.grad(ctx, qkv, do, retain_graph=True)
    (again,) = torch.autograd.grad(ctx, qkv, do)
    assert [c.launches - c0 for c, c0 in zip(counters, before)] == [2, 2]
    q, k, v = port_short.split_qkv(qkv.detach(), h)
    _, lse = port_flash.flash_attention_plain(q, k, v, bias)
    want = port_flash.flash_attention_bwd_plain(q, k, v, ctx.detach(), lse, do, bias)
    # the same kernels over separate q, k, v (the views' strides) give the same bits
    views = [x.requires_grad_(True) for x in port_short.split_qkv(qkv.detach(), h)]
    grads = torch.autograd.grad(port_flash.flash_attention(*views, bias), views, do)
    torch.cuda.synchronize()
    assert torch.equal(dqkv, again)
    assert all(torch.equal(g, s) for g, s in zip(grads, port_short.split_qkv(dqkv, h)))
    for got, w in zip(port_short.split_qkv(dqkv, h), want):
        assert (got.float() - w.float()).abs().max() <= w.float().abs().max() / 64


@pytest.mark.cuda
@pytest.mark.parametrize("b,n", [(64, 256), (4, 1)])  # 1024 px windows of 16x16; the CLS token
def test_short_kernels_at_window_shapes(cuda, rng, b, n):
    h, d = 12, 64
    qkv = torch.from_numpy(rng.standard_normal((b, n, 3 * h * d)).astype(np.float32))
    qkv = qkv.to(cuda, torch.bfloat16).requires_grad_(True)
    do = torch.from_numpy(rng.standard_normal((b, n, h, d)).astype(np.float32)).to(
        cuda, torch.bfloat16)
    ctx = port_short.short_attention_qkv(qkv, h)
    (dqkv,) = torch.autograd.grad(ctx, qkv, do)
    q, k, v = port_short.split_qkv(qkv.detach(), h)
    want_o = port_short.short_attention_plain(q, k, v)
    want = port_short.short_attention_bwd_plain(q, k, v, ctx.detach(), do)
    torch.cuda.synchronize()
    assert (ctx.float() - want_o.float()).abs().max() <= want_o.float().abs().max() / 64
    # at N=1 dq and dk are 0 in exact arithmetic (fp32 rounding noise of
    # dO.v - dO.o on both sides): an absolute floor far below a bf16 ulp of dv
    floor = 1e-4 if n == 1 else 0.0
    for got, w in zip(port_short.split_qkv(dqkv, h), want):
        assert (got.float() - w.float()).abs().max() <= max(w.float().abs().max() / 64, floor)
