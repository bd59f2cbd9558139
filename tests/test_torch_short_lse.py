"""The short-attention pair's log-sum-exp (kernel-table rows 1-2).

The forward writes the rows' lse on request and the backward forms
P = exp(S - lse) from it. On the CPU, in float32: the plain forward's lse
against JAX's log-sum-exp of the same scaled scores, and the lse-based
plain backward against the Pallas ``_short_bwd`` in interpret mode (as
the JAX package's own tests run it) or, with a key mask, which the
Pallas kernel does not take, against ``jax.vjp`` of the JAX encoder's
masked XLA attention (``layoutdit_tpu/models/vit.py``); the autograd
Function, which carries the lse from its forward to its backward; and
the launchers' checks of what the kernels read, refused before the
library loads."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from layoutdit_tpu.ops.short_attention import short_attention as jax_short
from layoutdit_tpu_torch.ops import short_attention as port_short

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

TOL = 1e-5  # float32, same math; only the summation order differs
# 1: the CLS token of a windowed layer; 7: below one tile; 197: 224 px;
# 256: a 16 x 16 window
NS = [1, 7, 197, 256]


def _inputs(rng, b, n, h, d, masked):
    """q, k, v, dO [B, N, H, D] float32 and, masked, a bool [3, N] key mask
    (row b % 3 for batch b) that keeps key 0 of every row and drops about
    a third of the others."""
    q, k, v, do = (rng.standard_normal((b, n, h, d)).astype(np.float32) for _ in range(4))
    mask = None
    if masked:
        mask = rng.random((3, n)) > 0.35
        mask[:, 0] = True
    return q, k, v, do, mask


def _jax_scores(q, k, mask):
    """The JAX encoder's masked XLA scores [B, H, N, N]: q k^T / sqrt(D),
    the keys the mask drops at -inf."""
    s = jnp.einsum("bnhd,bmhd->bhnm", q, k, precision=jax.lax.Precision.HIGHEST)
    s = s / np.sqrt(q.shape[-1])
    if mask is not None:
        rows = jnp.asarray(mask)[np.arange(q.shape[0]) % mask.shape[0]]
        s = jnp.where(rows[:, None, None, :], s, -jnp.inf)
    return s


def _jax_masked_attention(q, k, v, mask):
    """softmax(scores) v as the JAX encoder's XLA path computes it."""
    p = jax.nn.softmax(_jax_scores(q, k, mask), axis=-1)
    return jnp.einsum("bhnm,bmhd->bnhd", p, v, precision=jax.lax.Precision.HIGHEST)


def _torch(*xs):
    return [None if x is None else torch.from_numpy(np.asarray(x)) for x in xs]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n", NS)
def test_plain_lse_matches_jax_logsumexp(rng, n, masked):
    """The plain forward's lse, fp32 [B, H, N] in the natural log, is
    JAX's log-sum-exp of the same scaled (and masked) scores, and asking
    for it leaves o as it was."""
    b, h, d = 2, 3, 64
    q, k, v, _, mask = _inputs(rng, b, n, h, d, masked)
    tq, tk, tv, tm = _torch(q, k, v, mask)
    o, lse = port_short.short_attention_plain(tq, tk, tv, key_mask=tm, return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (b, h, n)
    want = jax.nn.logsumexp(_jax_scores(jnp.asarray(q), jnp.asarray(k), mask), axis=-1)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    assert torch.equal(o, port_short.short_attention_plain(tq, tk, tv, key_mask=tm))
    # the CPU wrapper gives the same pair
    o2, lse2 = port_short.short_attention(tq, tk, tv, key_mask=tm, return_lse=True)
    assert torch.equal(o2, o) and torch.equal(lse2, lse)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n", NS)
def test_lse_plain_bwd_matches_jax(rng, n, masked):
    """dq, dk, dv of the plain backward from the forward's lse against the
    Pallas backward (interpret mode) or, with a key mask, ``jax.vjp`` of
    the encoder's masked XLA attention; the lse form and the softmax form
    of the plain backward agree."""
    b, h, d = 2, 3, 64
    q, k, v, do, mask = _inputs(rng, b, n, h, d, masked)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    if masked:
        _, vjp = jax.vjp(lambda *x: _jax_masked_attention(*x, mask), jq, jk, jv)
    else:
        _, vjp = jax.vjp(lambda *x: jax_short(*x, interpret=True), jq, jk, jv)
    want = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    tq, tk, tv, tdo, tm = _torch(q, k, v, do, mask)
    o, lse = port_short.short_attention_plain(tq, tk, tv, key_mask=tm, return_lse=True)
    got = port_short.short_attention_bwd_plain(tq, tk, tv, o, tdo, key_mask=tm, lse=lse)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=TOL, rtol=TOL)
    softmax_form = port_short.short_attention_bwd_plain(tq, tk, tv, o, tdo, key_mask=tm)
    for g, w in zip(got, softmax_form):
        torch.testing.assert_close(g, w, atol=TOL, rtol=TOL)
    if masked:  # a dropped key's dk and dv rows are exactly 0
        dropped = ~port_short.key_mask_rows(tm, b)
        assert not got[1][dropped].any() and not got[2][dropped].any()


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n", [7, 197])
def test_qkv_function_carries_the_lse(rng, n, masked):
    """The autograd Function from the fused projection keeps the forward's
    lse for its backward: its gradient is JAX's, and the CPU wrapper's
    backward got the lse (a spy on ``short_attention_bwd``)."""
    b, h, d = 2, 3, 32
    q, k, v, do, mask = _inputs(rng, b, n, h, d, masked)
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    _, vjp = jax.vjp(lambda *x: _jax_masked_attention(*x, mask), jq, jk, jv)
    want = [np.asarray(g) for g in vjp(jnp.asarray(do))]
    qkv = torch.from_numpy(np.concatenate([x.reshape(b, n, h * d) for x in (q, k, v)], -1))
    qkv.requires_grad_(True)
    tm = None if mask is None else torch.from_numpy(mask)
    seen = []
    original = port_short.short_attention_bwd

    def spy(*args, **kwargs):
        seen.append(kwargs.get("lse"))
        return original(*args, **kwargs)

    port_short.short_attention_bwd = spy
    try:
        ctx = port_short.short_attention_qkv(qkv, h, key_mask=tm)
        (dqkv,) = torch.autograd.grad(ctx, qkv, torch.from_numpy(do))
    finally:
        port_short.short_attention_bwd = original
    assert len(seen) == 1 and seen[0] is not None and seen[0].shape == (b, h, n)
    _, lse = port_short.short_attention_plain(*port_short.split_qkv(qkv.detach(), h),
                                              key_mask=tm, return_lse=True)
    assert torch.equal(seen[0], lse)
    for i, w in enumerate(want):
        np.testing.assert_allclose(dqkv[..., i * h * d:(i + 1) * h * d].reshape(b, n, h, d)
                                   .numpy(), w, atol=TOL, rtol=TOL)
    # no gradient asked: the inference form, the same o
    with torch.no_grad():
        torch.testing.assert_close(port_short.short_attention_qkv(qkv, h, key_mask=tm), ctx,
                                   rtol=0, atol=0)


@pytest.fixture
def no_library(monkeypatch):
    """A launcher that gets past its checks reaches the library: here it
    raises instead (there is none on the CPU)."""
    def reached():
        raise LookupError("reached the library")

    monkeypatch.setattr(port_short, "_lib", reached)


def _heads(n=8, h=2, d=64, fused=True):
    """bf16 [1, n, h, d] q, k, v: slices of one fused projection (row pitch
    3 * h * d elements), or three contiguous tensors."""
    if fused:
        return port_short.split_qkv(torch.zeros(1, n, 3 * h * d, dtype=torch.bfloat16), h)
    return [torch.zeros(1, n, h, d, dtype=torch.bfloat16) for _ in range(3)]


def _bwd_args(q, k, v, lse):
    like = lambda: torch.zeros_like(q)  # noqa: E731
    return (q, k, v, like(), like(), lse, 0.125, None, like(), like(), like())


@pytest.mark.parametrize("d", port_short.HEAD_DIMS)
@pytest.mark.parametrize("fused", [True, False])
def test_launchers_take_the_fused_projection(no_library, d, fused):
    """The fused projection's slices (the tensor maps' row pitch 3 * H * D
    * 2 bytes, a multiple of 16) and contiguous heads pass every check and
    reach the library, forward and backward, at each compiled head dim."""
    n, h = 8, 2
    q, k, v = _heads(n, h, d, fused)
    sn = q.stride(1)
    assert sn == (3 * h * d if fused else h * d) and (sn * 2) % 16 == 0
    with pytest.raises(LookupError, match="reached the library"):
        port_short.short_attention_launch(q, k, v, 0.125, None, with_lse=True)
    with pytest.raises(LookupError, match="reached the library"):
        port_short.short_attention_bwd_launch(*_bwd_args(q, k, v, torch.zeros(1, h, n)))


@pytest.mark.parametrize("which", ["fwd", "bwd"])
@pytest.mark.parametrize("where", ["row stride", "base", "head dim stride"])
def test_launchers_refuse_rows_tma_cannot_read(no_library, which, where):
    """A tensor map needs a 16-byte-aligned base and byte strides that are
    multiples of 16, with the head dim contiguous: other rows are refused
    with a message before the library loads."""
    n, h, d = 8, 2, 64
    if where == "row stride":  # a row pitch of h * 64 + 4 elements: 8 bytes past 16
        q = torch.zeros(1, n, h * d + 4, dtype=torch.bfloat16)[..., :h * d].view(1, n, h, d)
    elif where == "base":  # one element past an aligned base
        q = torch.zeros(1 + n * h * d, dtype=torch.bfloat16)[1:].view(1, n, h, d)
    else:  # d not contiguous
        q = torch.zeros(1, n, d, h, dtype=torch.bfloat16).transpose(2, 3)
    _, k, v = _heads(n, h, d, fused=False)
    with pytest.raises(ValueError, match="16-byte aligned"):
        if which == "fwd":
            port_short.short_attention_launch(q, k, v, 0.125, None)
        else:
            port_short.short_attention_bwd_launch(*_bwd_args(q, k, v, torch.zeros(1, h, n)))


@pytest.mark.parametrize("bad", ["none", "shape", "dtype", "layout"])
def test_bwd_launcher_refuses_an_lse_it_cannot_read(no_library, bad):
    """The backward reads the forward's lse, fp32 [B, H, N] contiguous;
    anything else is refused before the library loads."""
    n, h = 8, 2
    q, k, v = _heads(n, h)
    lse = {
        "none": None,
        "shape": torch.zeros(1, n, h),
        "dtype": torch.zeros(1, h, n, dtype=torch.bfloat16),
        "layout": torch.zeros(1, n, h).transpose(1, 2),
    }[bad]
    with pytest.raises(ValueError, match="lse"):
        port_short.short_attention_bwd_launch(*_bwd_args(q, k, v, lse))
