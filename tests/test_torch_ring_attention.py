"""Ring attention (``ops/ring_attention.py``) on the CPU: the ranks are
threads over ``ThreadComm`` groups with the ring's ``ppermute``
(``test_torch_tensor_parallel``), each block through the flash wrappers'
plain versions with its valid-key count.

  * The op over 2, 3 and 4 ranks with N not divisible by P: forward and
    the gradients of q, k and v against plain attention (``RING_TOL``) and
    against JAX's ``ring_attention_sharded`` on a CPU mesh of P devices.
  * The encoder and ``detector_loss`` with ``attention_impl="ring"`` under
    sequence parallelism against one process (JAX
    ``tests/test_ring_attention.py:79-145``); ring under remat; the
    relative-position refusal.
  * The flash plain versions' ``n_keys`` against the dropped keys.
"""

from __future__ import annotations

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from layoutdit_tpu.ops.ring_attention import ring_attention_sharded
from layoutdit_tpu_torch.ops import flash_attention as fa
from layoutdit_tpu_torch.ops.ring_attention import block_keys, ring_attention
from layoutdit_tpu_torch.parallel.tensor import shard_len
from test_torch_cascade import _jax_priorities
from test_torch_parallel import _batch, _family, _port_step, _rel
from test_torch_tensor_parallel import (
    TP_RTOL,
    _assert_close_to_one,
    _assert_encoder_close,
    _encoder,
    _tp_step,
    encoder_step,
    run_group,
    run_mesh,
)

# the ring's online-softmax merge against one softmax over every key,
# float32: a few ulps of the outputs and gradients (max abs, values of
# order 1)
RING_TOL = 1e-5
# against JAX's ring (float32 on the CPU): JAX's own test holds its ring
# to plain attention at 2e-6 / 3e-6; the two rings each sit that close
JAX_TOL = 1e-5


def _qkv(b, n, h, d, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn((b, n, h, d), generator=g) for _ in range(3)]


def _plain(q, k, v, scale):
    s = torch.einsum("bnhd,bmhd->bhnm", q, k) * scale
    return torch.einsum("bhnm,bmhd->bnhd", torch.softmax(s, -1), v)


def _ring_on(group, q, k, v, ct, scale):
    """This rank's shards of the whole q, k, v (zero-padded to P shards)
    through the ring -> (its output rows, their gradients' shards)."""
    n = q.shape[1]
    kl = shard_len(n, group.size)

    def mine(t):
        t = torch.nn.functional.pad(t, (0, 0, 0, 0, 0, kl * group.size - n))
        return t[:, group.rank * kl:(group.rank + 1) * kl].clone().requires_grad_(True)

    qs, ks, vs = mine(q), mine(k), mine(v)
    o = ring_attention(qs, ks, vs, group, n, scale)
    (o * mine(ct).detach()).sum().backward()
    return o.detach(), qs.grad, ks.grad, vs.grad


def _unshard(parts, n):
    return torch.cat(parts, 1)[:, :n]


@pytest.mark.parametrize("p,n", [(2, 33), (3, 50), (4, 65), (4, 197)])
def test_ring_matches_plain_and_jax(p, n):
    """Forward and the q, k, v gradients over P ranks, N = 33, 50, 65, 197
    (the last rank's block padded), against plain attention over every
    key and against JAX's ``ring_attention_sharded`` on P CPU devices."""
    b, h, d = 2, 3, 8
    q, k, v = _qkv(b, n, h, d)
    ct = torch.randn((b, n, h, d), generator=torch.Generator().manual_seed(9))
    scale = 1.0 / math.sqrt(d)
    qq, kk, vv = (t.clone().requires_grad_(True) for t in (q, k, v))
    want = _plain(qq, kk, vv, scale)
    (want * ct).sum().backward()
    want = want.detach()
    got = run_group(lambda g: _ring_on(g, q, k, v, ct, scale), mp=p, sp=True)
    out = _unshard([r[0] for r in got], n)
    assert float((out - want).abs().max()) <= RING_TOL
    for i, ref in enumerate((qq.grad, kk.grad, vv.grad), start=1):
        assert float((_unshard([r[i] for r in got], n) - ref).abs().max()) <= RING_TOL
    # keys past n (the padding) get zero gradients
    kl = shard_len(n, p)
    if kl * p > n:
        assert float(got[-1][2][:, n - (p - 1) * kl:].abs().max()) == 0.0

    mesh = Mesh(np.asarray(jax.devices()[:p]), ("model",))
    seq = NamedSharding(mesh, P(None, "model", None))
    jq, jk, jv, jct = (jnp.asarray(t.numpy()) for t in (q, k, v, ct))
    jout = jax.jit(lambda a, b_, c: ring_attention_sharded(a, b_, c, seq, scale))(jq, jk, jv)
    assert float(np.abs(np.asarray(jout) - out.numpy()).max()) <= JAX_TOL
    jgrads = jax.jit(jax.grad(lambda a, b_, c: (ring_attention_sharded(a, b_, c, seq, scale)
                                                * jct).sum(), argnums=(0, 1, 2)))(jq, jk, jv)
    for i, jg in enumerate(jgrads, start=1):
        assert float(np.abs(np.asarray(jg) - _unshard([r[i] for r in got], n).numpy()).max()
                     ) <= JAX_TOL


def test_block_keys_and_flash_n_keys():
    """``block_keys`` per block; the flash plain versions with ``n_keys``
    equal the unmasked ones over the first ``n_keys`` keys, and the
    masked keys' dk and dv are 0."""
    assert [block_keys(65, 17, j) for j in range(4)] == [17, 17, 17, 14]
    assert [block_keys(5, 2, j) for j in range(4)] == [2, 2, 1, 0]
    q, k, v = _qkv(2, 24, 2, 8, seed=3)
    do = torch.randn_like(q)
    o, lse = fa.flash_attention_fwd(q, k, v, n_keys=19)
    o_ref, lse_ref = fa.flash_attention_plain(q, k[:, :19], v[:, :19])
    assert torch.allclose(o, o_ref, atol=1e-6) and torch.allclose(lse, lse_ref, atol=1e-6)
    dq, dk, dv, _ = fa.flash_attention_bwd(q, k, v, o, lse, do, n_keys=19)
    rq, rk, rv, _ = fa.flash_attention_bwd_plain(q, k[:, :19], v[:, :19], o_ref, lse_ref, do)
    assert torch.allclose(dq, rq, atol=1e-6)
    assert torch.allclose(dk[:, :19], rk, atol=1e-6) and torch.allclose(dv[:, :19], rv, atol=1e-6)
    assert float(dk[:, 19:].abs().max()) == float(dv[:, 19:].abs().max()) == 0.0
    full = fa.flash_attention_fwd(q, k, v)
    assert all(torch.equal(a, b) for a, b in zip(full, fa.flash_attention_fwd(q, k, v, n_keys=24)))
    with pytest.raises(ValueError, match="n_keys=0"):
        fa.flash_attention_fwd(q, k, v, n_keys=0)


@pytest.mark.parametrize("mp", [2, 3, 4])
def test_encoder_ring_matches_one_process(mp):
    """The encoder with ``attention_impl="ring"`` under sequence
    parallelism (65 tokens over 2, 3 and 4 ranks): taps and every
    gradient leaf against one process's flash / short routes."""
    cfg, params = _encoder(8, heads=4)
    if mp == 3:  # hidden 48: the projections split three ways
        cfg = dataclasses.replace(cfg, hidden_size=48, num_attention_heads=3,
                                  intermediate_size=96)
        params = _encoder_params(cfg)
    pixels = torch.rand((2, 3, 64, 64), generator=torch.Generator().manual_seed(6))
    want = encoder_step(cfg, params, pixels)
    got = run_group(lambda g: encoder_step(cfg, params, pixels, g, impl="ring"), mp, True)
    for rank in got:
        _assert_encoder_close(rank, want)


def _encoder_params(cfg):
    from layoutdit_tpu_torch.models import vit as port_vit
    from layoutdit_tpu_torch.models.weights_io import tree_leaves

    params = port_vit.init_vit_params(cfg, torch.Generator().manual_seed(0), "cpu")
    gen = torch.Generator().manual_seed(1)
    for t in tree_leaves(params):
        t.data += 0.05 * torch.randn(t.shape, generator=gen)
    return params


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_ring_under_remat(policy):
    """Ring attention inside a checkpointed layer: the ring runs again in
    the recompute, every rank in step; the same bits as without remat."""
    cfg, params = _encoder(8)
    pixels = torch.rand((1, 3, 64, 64), generator=torch.Generator().manual_seed(7))
    plain = run_group(lambda g: encoder_step(cfg, params, pixels, g, impl="ring"), 2, True)
    remat = run_group(lambda g: encoder_step(cfg, params, pixels, g, impl="ring", remat=True,
                                             policy=policy), 2, True)
    for a, b in zip(plain, remat):
        assert all(torch.equal(x, y) for x, y in zip(a[0], b[0]))
        assert all(torch.equal(x, y) for x, y in zip(a[2], b[2]))


def test_ring_refuses_a_relative_position_bias():
    cfg, params = _encoder(8, use_relative_position_bias=True,
                           use_absolute_position_embeddings=False)
    with pytest.raises(ValueError, match="ring attention supports absolute-pos models only"):
        run_group(lambda g: encoder_step(cfg, params, torch.rand(1, 3, 64, 64), g,
                                         impl="ring"), 2, True)


@pytest.mark.parametrize("dp,mp", [(1, 2), (2, 2)])
def test_detector_loss_ring_sp_matches_one_process(dp, mp):
    """Faster R-CNN's ``detector_loss`` with ``attention_impl="ring"`` on a
    dp x mp mesh with sequence parallelism (17 tokens: 9 + 8 and a padded
    key) against one process's loss and gradients."""
    jparams, _, pcfg = _family("faster_rcnn")
    pcfg = dataclasses.replace(pcfg, attention_impl="ring")
    batch = _batch()
    pri = _jax_priorities(jax.random.PRNGKey(7), pcfg, *batch[2].shape)
    one, one_grads = _port_step(jparams, pcfg, batch, None, pri)
    got = run_mesh(lambda m: _tp_step(jparams, pcfg, batch, None, pri, m), dp, mp, True)
    _assert_close_to_one(got[0], one, one_grads, TP_RTOL)
    assert _rel(got[0][1][0], got[-1][1][0]) == 0.0
