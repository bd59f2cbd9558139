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
