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


# 1: the CLS token of a windowed layer; 197: 224 px; 256: a 16 x 16 window
@pytest.mark.parametrize("n", [1, 7, 197, 256])
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
@pytest.mark.parametrize("d", port_short.HEAD_DIMS)
@pytest.mark.parametrize("n", [1, 197, 256])
def test_short_kernel_matches_plain(cuda, rng, n, d):
    """q, k, v as strided views of one fused projection, as the encoder
    makes them; the training form (o and the rows' lse, one launch too)
    gives the inference form's bits and the plain lse within 1e-2."""
    b, h = 4, 12
    qkv = torch.from_numpy(rng.standard_normal((b, n, 3 * h * d)).astype(np.float32))
    q, k, v = port_short.split_qkv(qkv.to(cuda, torch.bfloat16), h)
    before = port_short.short_attention.launches
    got = port_short.short_attention(q, k, v)
    assert port_short.short_attention.launches == before + 1
    again, lse = port_short.short_attention(q, k, v, return_lse=True)
    assert port_short.short_attention.launches == before + 2
    want, want_lse = port_short.short_attention_plain(q, k, v, return_lse=True)
    torch.cuda.synchronize()
    assert (got.float() - want.float()).abs().max() <= want.float().abs().max() / 64
    assert torch.equal(again, got) and lse.shape == (b, h, n)
    assert (lse - want_lse).abs().max() <= 1e-2


@pytest.mark.cuda
def test_short_kernels_refuse_other_head_dims(cuda):
    q = torch.zeros(1, 8, 2, 48, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim one of"):
        port_short.short_attention(q, q, q)
    with pytest.raises(ValueError, match="head dim one of"):
        port_short.short_attention(q, q, q, return_lse=True)
    lse = torch.zeros(1, 2, 8, device=cuda)
    with pytest.raises(ValueError, match="head dim one of"):
        port_short.short_attention_bwd(q, q, q, q, q, lse=lse)
    with pytest.raises(ValueError, match="lse"):  # the kernels read the forward's lse
        port_short.short_attention_bwd(q, q, q, q, q)


# (B, N, H, bias, fused): ragged N (65: one valid row in the second 64-row
# tile; 600) over separate q, k, v and over strided slices of one fused
# [B, N, 3*H*D] projection, the 1024 px shapes and the rel-pos windows
FLASH_FWD_CASES = [
    *[(2, n, 4, with_bias, fused) for n in (65, 600) for with_bias in (False, True)
      for fused in (False, True)],
    (4, 4097, 12, False, True), (4, 4097, 12, True, True), (64, 256, 12, True, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,h,with_bias,fused", FLASH_FWD_CASES)
def test_flash_kernel_matches_plain(cuda, rng, b, n, h, with_bias, fused):
    """The forward kernel against its plain version (o within max |plain|
    / 64, lse within 1e-2), one launch a call, and a second launch gives
    the same bits."""
    d = 64
    if fused:
        qkv = torch.from_numpy(rng.standard_normal((b, n, 3 * h * d)).astype(np.float32))
        q, k, v = port_short.split_qkv(qkv.to(cuda, torch.bfloat16), h)
    else:
        q, k, v = (torch.from_numpy(x).to(cuda, torch.bfloat16) for x in _qkv(rng, b, n, h, d))
    bias = torch.randn(h, n, n, device=cuda) if with_bias else None
    before = port_flash.flash_attention_fwd.launches
    got, lse = port_flash.flash_attention_fwd(q, k, v, bias)
    again, lse_again = port_flash.flash_attention_fwd(q, k, v, bias)
    assert port_flash.flash_attention_fwd.launches == before + 2
    want, want_lse = port_flash.flash_attention_plain(q, k, v, bias)
    torch.cuda.synchronize()
    assert torch.equal(got, again) and torch.equal(lse, lse_again)
    assert (got.float() - want.float()).abs().max() <= want.float().abs().max() / 64
    assert (lse - want_lse).abs().max() <= 1e-2


# 7 and 197, below and above 128: both pad in the Pallas kernel; 1 and 256,
# the CLS token and a full window
@pytest.mark.parametrize("n", [1, 7, 197, 256])
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
    """attention_core gives gradients past 256 tokens (the flash route),
    and a bias that requires a gradient gets one (dbias, kernel-table row
    6), at any N: with a bias attention_core takes the flash route even
    where the short kernels would serve. The bias gradient is the plain
    backward's dbias, through both autograd Functions."""
    from layoutdit_tpu_torch.models.vit import attention_core

    b, n, h, d = 2, 300, 2, 16
    qkv = torch.from_numpy(rng.standard_normal((b, n, 3 * h * d)).astype(np.float32))
    with torch.no_grad():
        assert attention_core(qkv, h).shape == (b, n, h, d)  # forward only is fine
    qkv.requires_grad_(True)
    ctx = attention_core(qkv, h)
    (g,) = torch.autograd.grad(ctx.sum(), qkv)
    assert torch.isfinite(g).all() and g.abs().sum() > 0
    assert attention_core(qkv[:, :200], h).requires_grad  # the short kernels have one too

    do = torch.from_numpy(rng.standard_normal((b, n, h, d)).astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal((h, n, n)).astype(np.float32))
    q, k, v = (x.detach() for x in port_short.split_qkv(qkv, h))
    o, lse = port_flash.flash_attention_plain(q, k, v, bias)
    *want, want_dbias = port_flash.flash_attention_bwd_plain(q, k, v, o, lse, do, bias)
    assert want_dbias.shape == (h, n, n) and want_dbias.abs().sum() > 0
    torch.testing.assert_close(want_dbias, port_flash.flash_attention_bwd_plain(
        q, k, v, o, lse, do, bias)[3], rtol=0, atol=0)
    for nn in (n, 40):  # 40 tokens: the flash route all the same
        bb = bias[:, :nn, :nn].clone().requires_grad_(True)
        ctx = attention_core(qkv[:, :nn], h, bias=bb)
        dqkv, dbias = torch.autograd.grad(ctx, (qkv, bb), do[:, :nn])
        if nn == n:
            torch.testing.assert_close(dbias, want_dbias, rtol=0, atol=0)
            for i, w in enumerate(want):
                torch.testing.assert_close(dqkv[..., i * h * d:(i + 1) * h * d]
                                           .reshape(b, n, h, d), w, rtol=TOL, atol=TOL)
        assert dbias.shape == (h, nn, nn) and dbias.abs().sum() > 0
    bb = bias.clone().requires_grad_(True)
    qs = [x.clone().requires_grad_(True) for x in (q, k, v)]
    *grads, dbias = torch.autograd.grad(port_flash.flash_attention(*qs, bb), (*qs, bb), do)
    torch.testing.assert_close(dbias, want_dbias, rtol=0, atol=0)
    for got, w in zip(grads, want):
        torch.testing.assert_close(got, w, rtol=0, atol=0)
    with torch.no_grad():  # no gradient asked: the bias is a constant
        port_flash.flash_attention(q, k, v, bb)


@pytest.mark.parametrize("n", [130, 197])  # ragged: both pad to the Pallas blocks
def test_flash_bwd_plain_dbias_matches_pallas(rng, n):
    """The plain backward's dbias against the JAX flash attention's bias
    gradient under ``jax.grad``, which runs ``_dbias_kernel`` in interpret
    mode; dq, dk and dv beside it."""
    import jax

    b, h, d = 2, 3, 32
    q, k, v = _qkv(rng, b, n, h, d)
    do = rng.standard_normal((b, n, h, d)).astype(np.float32)
    bias = rng.standard_normal((h, n, n)).astype(np.float32)

    def total(q, k, v, bias):
        return (jax_flash.flash_attention(q, k, v, bias=bias, interpret=True) * do).sum()

    want = jax.grad(total, argnums=(0, 1, 2, 3))(*map(jnp.asarray, (q, k, v, bias)))
    tq, tk, tv, tdo, tb = map(torch.from_numpy, (q, k, v, do, bias))
    o, lse = port_flash.flash_attention_plain(tq, tk, tv, tb)
    got = port_flash.flash_attention_bwd_plain(tq, tk, tv, o, lse, tdo, tb)
    assert got[3].dtype == torch.float32 and got[3].shape == (h, n, n)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL, rtol=TOL)
    # and the oracle of the Pallas backward: dbias = sum over the batch of dS
    to_bh = lambda x: jnp.asarray(x).transpose(0, 2, 1, 3).reshape(b * h, n, d)  # noqa: E731
    ref = jax_flash._bwd_reference(to_bh(q), to_bh(k), to_bh(v), jnp.asarray(bias),
                                   1.0 / np.sqrt(d), to_bh(o.numpy()), to_bh(do), n)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(ref[3]), atol=TOL, rtol=TOL)


def test_cpu_bwd_wrapper_takes_the_plain_version_and_fills_out(rng):
    b, n, h, d = 1, 70, 2, 16
    q, k, v, do = (torch.from_numpy(x) for x in _qkv(rng, b, n, h, d) + [
        rng.standard_normal((b, n, h, d)).astype(np.float32)])
    o, lse = port_flash.flash_attention_plain(q, k, v)
    counters = (port_flash.flash_attention_bwd_dq, port_flash.flash_attention_bwd_dkdv,
                port_flash.flash_attention_bwd_dbias)
    before = [c.launches for c in counters]
    dqkv = torch.empty(b, n, 3 * h * d)
    out = tuple(port_short.split_qkv(dqkv, h))
    got = port_flash.flash_attention_bwd(q, k, v, o, lse, do, out=out)
    assert all(g is t for g, t in zip(got, out)) and got[3] is None
    for g, w in zip(out, port_flash.flash_attention_bwd_plain(q, k, v, o, lse, do)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    bias = torch.from_numpy(rng.standard_normal((h, n, n)).astype(np.float32))
    o, lse = port_flash.flash_attention_plain(q, k, v, bias)
    dbias = port_flash.flash_attention_bwd(q, k, v, o, lse, do, bias, bias_grad=True)[3]
    torch.testing.assert_close(
        dbias, port_flash.flash_attention_bwd_plain(q, k, v, o, lse, do, bias)[3], rtol=0, atol=0)
    with pytest.raises(ValueError, match="needs a bias"):
        port_flash.flash_attention_bwd(q, k, v, o, lse, do, bias_grad=True)
    assert [c.launches for c in counters] == before
    with pytest.raises(ValueError, match="unsupported device"):
        m = torch.empty(1, 8, 2, 16, device="meta")
        port_flash.flash_attention_bwd(m, m, m, m, m, m)


def _launch_args(which, n=8, h=2, bias=None, q=None):
    """CPU arguments of one launcher (the forward's or a backward one),
    valid but for what the caller passes: bf16 [1, n, h, 64] rows, fp32
    lse/delta [h, n]. -> (launcher, its arguments, the function that
    counts its launches)."""
    b, d = 1, port_flash.HEAD_DIM
    q = torch.zeros(b, n, h, d, dtype=torch.bfloat16) if q is None else q
    t = lambda: torch.zeros(b, n, h, d, dtype=torch.bfloat16)  # noqa: E731
    vec = lambda: torch.zeros(b * h, n)  # noqa: E731
    if which == "fwd":
        return (port_flash.flash_attention_fwd_launch, (q, t(), t(), bias, 0.125, t(), vec()),
                port_flash.flash_attention_fwd)
    if which == "dq":
        fn, args = port_flash.flash_attention_bwd_dq, (q, t(), t(), t(), vec(), t(), bias, 0.125,
                                                       t(), vec())
    elif which == "dkdv":
        fn, args = port_flash.flash_attention_bwd_dkdv, (q, t(), t(), vec(), t(), vec(), bias,
                                                         0.125, t(), t())
    else:
        fn, args = port_flash.flash_attention_bwd_dbias, (q, t(), t(), vec(), t(), vec(), bias,
                                                          0.125, torch.zeros(h, n, n))
    return fn, args, fn


@pytest.fixture
def no_library(monkeypatch):
    """A launcher that gets past its checks reaches the library: here it
    raises instead (there is none on the CPU)."""
    def reached():
        raise LookupError("reached the library")

    monkeypatch.setattr(port_flash, "_lib", reached)


@pytest.mark.parametrize("which", ["fwd", "dq", "dkdv", "dbias"])
@pytest.mark.parametrize("bad", ["shape", "dtype", "layout", "none", "good"])
def test_bwd_launchers_check_the_bias_before_the_library(no_library, which, bad):
    """The forward, dq, dkdv and dbias launchers take the bias as the
    kernels read it, fp32 [H, N, N] contiguous, and refuse anything else
    with a message before they touch the library; all but dbias also take
    no bias."""
    n, h = 8, 2
    bias = {
        "shape": torch.zeros(h, n, n + 1),
        "dtype": torch.zeros(h, n, n, dtype=torch.bfloat16),
        "layout": torch.zeros(h, n, n).transpose(1, 2),
        "none": None,
        "good": torch.zeros(h, n, n),
    }[bad]
    fn, args, counter = _launch_args(which, n, h, bias)
    before = counter.launches
    if bad == "good" or (bad == "none" and which != "dbias"):
        with pytest.raises(LookupError, match="reached the library"):
            fn(*args)
    else:
        with pytest.raises(ValueError, match="bias"):
            fn(*args)
    assert counter.launches == before


@pytest.mark.parametrize("which", ["fwd", "dq", "dkdv", "dbias"])
@pytest.mark.parametrize("where", ["row stride", "base", "head dim stride"])
def test_bwd_launchers_refuse_rows_tma_cannot_read(no_library, which, where):
    """The kernels read q, k, v (and the backward dO) by TMA, whose tensor
    maps need a 16-byte-aligned base and byte strides that are multiples
    of 16; the launchers refuse other rows with a message before they
    touch the library. The fused projection's slices pass (row pitch 3 *
    H * 128 bytes, head offset 128)."""
    n, h, d = 8, 2, port_flash.HEAD_DIM
    if where == "row stride":  # a row pitch of h * 64 + 4 elements
        q = torch.zeros(1, n, h * d + 4, dtype=torch.bfloat16)[..., :h * d].view(1, n, h, d)
    elif where == "base":  # one element past an aligned base
        q = torch.zeros(1 + n * h * d, dtype=torch.bfloat16)[1:].view(1, n, h, d)
    else:  # d not contiguous
        q = torch.zeros(1, n, d, h, dtype=torch.bfloat16).transpose(2, 3)
    fn, args, _ = _launch_args(which, n, h, torch.zeros(h, n, n), q)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fn(*args)
    fused = torch.zeros(1, n, 3 * h * d, dtype=torch.bfloat16)
    q, _, _ = port_short.split_qkv(fused, h)
    fn, args, _ = _launch_args(which, n, h, torch.zeros(h, n, n), q)
    with pytest.raises(LookupError, match="reached the library"):
        fn(*args)


@pytest.mark.cuda
@pytest.mark.parametrize("d", port_short.HEAD_DIMS)
@pytest.mark.parametrize("n", [1, 197, 256])
def test_short_bwd_kernel_matches_plain(cuda, rng, n, d):
    """Through the autograd Function (dq, dk, dv written into one fused
    gradient), against the plain version; a second run gives the same
    bits (no atomics). At N=1 dq and dk are 0 in exact arithmetic and both
    sides give fp32 rounding noise, so the tolerance there has the floor
    chip_smoke.py gives it (SINGLE_TOKEN_FLOOR, 1e-4)."""
    b, h = 4, 12
    qkv = torch.from_numpy(rng.standard_normal((b, n, 3 * h * d)).astype(np.float32))
    qkv = qkv.to(cuda, torch.bfloat16).requires_grad_(True)
    do = torch.from_numpy(rng.standard_normal((b, n, h, d)).astype(np.float32)).to(
        cuda, torch.bfloat16)
    ctx = port_short.short_attention_qkv(qkv, h)
    before = port_short.short_attention_bwd.launches
    (dqkv,) = torch.autograd.grad(ctx, qkv, do)
    assert port_short.short_attention_bwd.launches == before + 1
    q, k, v = port_short.split_qkv(qkv.detach(), h)
    _, lse = port_short.short_attention(q, k, v, return_lse=True)
    again = torch.empty_like(dqkv)
    port_short.short_attention_bwd(q, k, v, ctx.detach(), do,
                                   out=tuple(port_short.split_qkv(again, h)), lse=lse)
    want = port_short.short_attention_bwd_plain(q, k, v, ctx.detach(), do)
    torch.cuda.synchronize()
    assert torch.equal(dqkv, again)
    floor = 1e-4 if n == 1 else 0.0
    for got, w in zip(port_short.split_qkv(dqkv, h), want):
        tol = max(w.float().abs().max().item() / 64, floor)
        assert (got.float() - w.float()).abs().max() <= tol


# (B, N, H, bias): ragged N (65: one valid row in the second 64-row
# tile; 600), the 1024 px train steps' global layers, and the rel-pos
# step's 16 x 16 windows
FLASH_BWD_CASES = [
    *[(2, n, 4, with_bias) for n in (65, 600) for with_bias in (False, True)],
    (4, 4097, 12, False), (4, 4097, 12, True), (64, 256, 12, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,h,with_bias", FLASH_BWD_CASES)
def test_flash_bwd_kernel_matches_plain(cuda, rng, b, n, h, with_bias):
    """Both backward kernels against the plain version, q/k/v and dq/dk/dv
    strided in fused [B, N, 3*H*D] tensors, through the autograd Function;
    the gradients are the same bits on a second run (no atomics)."""
    d = 64
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


# 1024 px: global layers (Q and dO rows held for the sweep); 16 x 16
# windows (streamed); ragged N = 65 and 600 (several key tiles a block)
@pytest.mark.cuda
@pytest.mark.parametrize("b,n", [(4, 4097), (64, 256), (2, 65), (2, 600)])
def test_flash_dbias_kernel_matches_plain(cuda, b, n):
    """The dbias kernel through the autograd Function at the rel-pos
    train step's shapes and at ragged N against the plain backward's
    dbias, the same bits on a second run (no atomics), one launch per
    backward. Both compute S, dP and dS in fp32 from the same bf16
    inputs, so they differ by fp32 summation order only: max |err| <=
    1e-4 max |plain| (dbias is heavy-tailed, so the bf16 outputs' max / 64
    would pass a tile wrong by a typical value)."""
    h, d = 12, 64
    gen = torch.Generator(device=cuda).manual_seed(0)
    qkv = torch.randn(b, n, 3 * h * d, generator=gen, device=cuda).to(torch.bfloat16)
    qkv.requires_grad_(True)
    do = torch.randn(b, n, h, d, generator=gen, device=cuda).to(torch.bfloat16)
    bias = (0.5 * torch.randn(h, n, n, generator=gen, device=cuda)).requires_grad_(True)
    ctx = port_flash.flash_attention_qkv(qkv, h, bias=bias)
    before = port_flash.flash_attention_bwd_dbias.launches
    _, dbias = torch.autograd.grad(ctx, (qkv, bias), do, retain_graph=True)
    _, again = torch.autograd.grad(ctx, (qkv, bias), do)
    assert port_flash.flash_attention_bwd_dbias.launches == before + 2
    q, k, v = port_short.split_qkv(qkv.detach(), h)
    _, lse = port_flash.flash_attention_fwd(q, k, v, bias.detach())  # the lse the backward read
    want = port_flash.flash_attention_bwd_plain(q, k, v, ctx.detach(), lse, do, bias.detach())[3]
    torch.cuda.synchronize()
    assert dbias.dtype == torch.float32 and dbias.shape == (h, n, n)
    assert torch.equal(dbias, again)
    assert (dbias - want).abs().max() <= 1e-4 * want.abs().max()


@pytest.mark.cuda
@pytest.mark.parametrize("b,n", [(64, 256), (4, 1)])  # 1024 px windows of 16x16; the CLS token
def test_short_kernels_at_window_shapes(cuda, rng, b, n):
    h, d = 12, 64
    qkv = torch.from_numpy(rng.standard_normal((b, n, 3 * h * d)).astype(np.float32))
    qkv = qkv.to(cuda, torch.bfloat16).requires_grad_(True)
    do = torch.from_numpy(rng.standard_normal((b, n, h, d)).astype(np.float32)).to(
        cuda, torch.bfloat16)
    counters = (port_short.short_attention, port_short.short_attention_bwd)
    before = [c.launches for c in counters]
    ctx = port_short.short_attention_qkv(qkv, h)
    (dqkv,) = torch.autograd.grad(ctx, qkv, do, retain_graph=True)
    (again,) = torch.autograd.grad(ctx, qkv, do)
    assert [c.launches - c0 for c, c0 in zip(counters, before)] == [1, 2]
    q, k, v = port_short.split_qkv(qkv.detach(), h)
    want_o = port_short.short_attention_plain(q, k, v)
    want = port_short.short_attention_bwd_plain(q, k, v, ctx.detach(), do)
    torch.cuda.synchronize()
    assert torch.equal(dqkv, again)
    assert (ctx.float() - want_o.float()).abs().max() <= want_o.float().abs().max() / 64
    # at N=1 dq and dk are 0 in exact arithmetic (fp32 rounding noise of
    # dO.v - dO.o on both sides): an absolute floor far below a bf16 ulp of dv
    floor = 1e-4 if n == 1 else 0.0
    for got, w in zip(port_short.split_qkv(dqkv, h), want):
        assert (got.float() - w.float()).abs().max() <= max(w.float().abs().max() / 64, floor)
