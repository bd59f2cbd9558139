"""The flash kernels' key mask (kernel-table rows 3-6) in the port vs the
JAX package on the CPU, float32, tiny widths: the masked plain forward
and backward against JAX's masked XLA attention (a window mask with a
bias, a prefix mask with a bias, a scattered mask over more than 256
keys), an all-True mask giving the unmasked bits, the dropped keys' dk,
dv and dbias columns exactly 0, the launchers' mask checks, the routing
of masked attention to the flash wrappers, and the encoder with
relative-position tables over a padded window grid and with
``pad_tokens_to``, taps and gradients.

Tolerances: the attention core 1e-5 (forward) and 1e-4 (gradients), fp32
on both sides in another summation order; the attention sub-block and
the encoder 1e-4 (taps) and 1e-3 relative Frobenius a gradient leaf, as
``tests/test_torch_relpos.py``."""

import contextlib
import inspect
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from layoutdit_tpu.models import vit as jax_vit
from layoutdit_tpu_torch.models import vit as port_vit
from layoutdit_tpu_torch.models import weights_io
from layoutdit_tpu_torch.ops import flash_attention as port_flash

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

CORE_FWD_TOL = 1e-5
CORE_GRAD_TOL = 1e-4
TAP_TOL = 1e-4
GRAD_RTOL = 1e-3  # relative Frobenius, per leaf
H, HD = 2, 8  # heads and head dim of the core cases


def _rel_frob(got, want):
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12))


def _case(name: str, rng):
    """(B, N, key mask [rows, N] bool, bias [H, N, N] or None) of a case."""
    if name == "window":  # grid 5 in windows of 3: padded to 6, 4 windows of 9 slots
        mask = port_vit._window_key_mask(5, 5, 3).numpy()
        return 2 * mask.shape[0], 9, mask, rng.standard_normal((H, 9, 9)).astype(np.float32)
    if name == "prefix":  # pad_tokens_to: 13 real tokens of 20, the bias zero on the padding
        n, real = 20, 13
        mask = (np.arange(n) < real)[None]
        bias = rng.standard_normal((H, n, n)).astype(np.float32)
        bias[:, real:] = 0
        bias[:, :, real:] = 0
        return 3, n, mask, bias
    # scattered, over the short kernels' 256: a third of the keys dropped,
    # each row keeping its first
    n = 300
    mask = rng.uniform(size=(3, n)) > 1 / 3
    mask[:, 0] = True
    return 3, n, mask, None


def _jax_masked_attention(q, k, v, bias, mask):
    """JAX's masked XLA attention on [B, N, H, D] (``layoutdit_tpu/models
    /vit.py:552-564``): scores in fp32 over sqrt(D), the bias added, the
    dropped keys at -inf, softmax, then p v; ``mask`` [B, N]."""
    s = jnp.einsum("bnhd,bmhd->bhnm", q, k) / np.sqrt(q.shape[-1])
    if bias is not None:
        s = s + bias
    s = jnp.where(mask[:, None, None, :], s, -jnp.inf)
    return jnp.einsum("bhnm,bmhd->bnhd", jax.nn.softmax(s, axis=-1), v)


@contextlib.contextmanager
def _masked_flash_calls():
    """Within the block, the flash forward's plain version records for
    each call whether it was given a key mask (the list yielded)."""
    calls = []
    plain = port_flash.flash_attention_plain
    sig = inspect.signature(plain)

    def spy(*args, **kwargs):
        calls.append(sig.bind(*args, **kwargs).arguments.get("key_mask") is not None)
        return plain(*args, **kwargs)

    port_flash.flash_attention_plain = spy
    try:
        yield calls
    finally:
        port_flash.flash_attention_plain = plain


@pytest.mark.parametrize("name", ["window", "prefix", "scattered"])
def test_masked_flash_plain_matches_jax(rng, name):
    """Rows 3-6's plain versions with a key mask read modulo its rows:
    o against JAX's masked attention, then dq, dk, dv and dbias against
    its ``jax.vjp`` at the forward's o and lse."""
    b, n, mask, bias = _case(name, rng)
    q, k, v, do = (rng.standard_normal((b, n, H, HD)).astype(np.float32) for _ in range(4))
    tiled = np.tile(mask, (b // mask.shape[0], 1))
    want, vjp = jax.vjp(lambda *a: _jax_masked_attention(*a, tiled), *map(jnp.asarray, (
        q, k, v, np.zeros((H, n, n), np.float32) if bias is None else bias)))
    jgrads = vjp(jnp.asarray(do))

    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    tbias = None if bias is None else torch.from_numpy(bias)
    key_mask = torch.from_numpy(mask)
    o, lse = port_flash.flash_attention_plain(tq, tk, tv, tbias, key_mask=key_mask)
    np.testing.assert_allclose(o.numpy(), np.asarray(want), atol=CORE_FWD_TOL, rtol=CORE_FWD_TOL)
    grads = port_flash.flash_attention_bwd_plain(tq, tk, tv, o, lse, tdo, tbias,
                                                 key_mask=key_mask)
    for g, w in zip(grads[:3], jgrads[:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=CORE_GRAD_TOL,
                                   rtol=CORE_GRAD_TOL)
    if bias is None:
        assert grads[3] is None
    else:
        np.testing.assert_allclose(grads[3].numpy(), np.asarray(jgrads[3]), atol=CORE_GRAD_TOL,
                                   rtol=CORE_GRAD_TOL)


@pytest.mark.parametrize("name", ["window", "prefix", "scattered"])
def test_masked_attention_block_matches_jax(rng, name):
    """The attention sub-block (projections, core, output projection) with
    a key mask: the port's ``_attention``, which routes a masked call with
    a bias, or over 256 tokens, to ``flash_attention_qkv``, against JAX's
    ``_attention`` on its XLA path; output, then the gradients of the input,
    every layer leaf and the bias."""
    b, n, mask, bias = _case(name, rng)
    width = H * HD
    jcfg = jax_vit.ViTConfig(hidden_size=width, num_hidden_layers=1, num_attention_heads=H,
                             intermediate_size=2 * width)
    pcfg = port_vit.ViTConfig(hidden_size=width, num_hidden_layers=1, num_attention_heads=H,
                              intermediate_size=2 * width)
    jlayer = jax.tree_util.tree_map(
        np.asarray, jax_vit.init_vit_params(jax.random.PRNGKey(0), jcfg)["layers"][0])
    x = rng.standard_normal((b, n, width)).astype(np.float32)
    cot = rng.standard_normal(x.shape).astype(np.float32)
    jbias = np.zeros((H, n, n), np.float32) if bias is None else bias
    tiled = jnp.asarray(np.tile(mask, (b // mask.shape[0], 1)))

    def jax_block(xx, lay, bb):
        return jax_vit._attention(xx, lay, jcfg, None if bias is None else bb, impl="xla",
                                  key_mask=tiled)

    out, (jdx, jdlayer, jdbias) = jax.jit(lambda *a: (
        lambda o, f: (o, f(jnp.asarray(cot))))(*jax.vjp(jax_block, *a)))(
            jnp.asarray(x), jlayer, jnp.asarray(jbias))

    layer = weights_io._vit_layer(jlayer, "cpu")
    leaves = [layer["qkv"]["weight"], layer["qkv"]["bias"], layer["attn_out"]["weight"],
              layer["attn_out"]["bias"]]
    for t in leaves:
        t.requires_grad_(True)
    tx = torch.from_numpy(x).requires_grad_(True)
    tbias = None if bias is None else torch.from_numpy(bias).requires_grad_(True)
    with _masked_flash_calls() as calls:
        got = port_vit._attention(tx, layer, pcfg, torch.from_numpy(mask), tbias)
    assert calls == [True]  # the masked flash route
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), atol=TAP_TOL, rtol=TAP_TOL)
    (got * torch.from_numpy(cot)).sum().backward()
    assert _rel_frob(tx.grad.numpy(), np.asarray(jdx)) <= GRAD_RTOL
    if bias is not None:
        assert _rel_frob(tbias.grad.numpy(), np.asarray(jdbias)) <= GRAD_RTOL
    dw, db, dow, dob = (t.grad.numpy() for t in leaves)
    want = {  # the fused projection's rows [q | k | v]; K has no bias in BEiT
        "qkv weight": (dw, np.concatenate([np.asarray(jdlayer[m]["kernel"]).T
                                           for m in ("q", "k", "v")])),
        "q bias": (db[:width], np.asarray(jdlayer["q"]["bias"])),
        "v bias": (db[2 * width:], np.asarray(jdlayer["v"]["bias"])),
        "attn_out weight": (dow, np.asarray(jdlayer["attn_out"]["kernel"]).T),
        "attn_out bias": (dob, np.asarray(jdlayer["attn_out"]["bias"])),
    }
    for leaf, (g, w) in want.items():
        assert _rel_frob(g, w) <= GRAD_RTOL, (leaf, _rel_frob(g, w))


def test_all_true_mask_gives_the_unmasked_bits(rng):
    """A mask that keeps every key leaves the plain forward and backward
    bit for bit as without one, with and without a bias."""
    b, n = 2, 12
    q, k, v, do = (torch.from_numpy(rng.standard_normal((b, n, H, HD)).astype(np.float32))
                   for _ in range(4))
    everything = torch.ones(1, n, dtype=torch.bool)
    for bias in (None, torch.from_numpy(rng.standard_normal((H, n, n)).astype(np.float32))):
        o, lse = port_flash.flash_attention_plain(q, k, v, bias)
        o2, lse2 = port_flash.flash_attention_plain(q, k, v, bias, key_mask=everything)
        assert torch.equal(o, o2) and torch.equal(lse, lse2)
        want = port_flash.flash_attention_bwd(q, k, v, o, lse, do, bias,
                                              bias_grad=bias is not None)
        got = port_flash.flash_attention_bwd(q, k, v, o, lse, do, bias,
                                             bias_grad=bias is not None, key_mask=everything)
        assert all(w is g or torch.equal(w, g) for w, g in zip(want, got))


def test_dropped_keys_get_no_gradient(rng):
    """A dropped key's dk and dv rows are exactly 0, and a key every row
    drops gets nothing in dbias; a uint8 mask is a bool one."""
    b, n = 4, 10
    q, k, v, do = (torch.from_numpy(rng.standard_normal((b, n, H, HD)).astype(np.float32))
                   for _ in range(4))
    bias = torch.from_numpy(rng.standard_normal((H, n, n)).astype(np.float32))
    mask = torch.ones(2, n, dtype=torch.bool)
    mask[0, [2, 7]] = False
    mask[1, [7, 9]] = False  # key 7 dropped by every row
    o, lse = port_flash.flash_attention_plain(q, k, v, bias, key_mask=mask)
    dq, dk, dv, dbias = port_flash.flash_attention_bwd(q, k, v, o, lse, do, bias,
                                                       bias_grad=True, key_mask=mask)
    dropped = ~mask[torch.arange(b) % 2]  # [B, N]
    assert not dk[dropped].any() and not dv[dropped].any()
    assert dk[~dropped].abs().min() > 0 and dv[~dropped].abs().min() > 0
    assert not dbias[:, :, 7].any() and dbias[:, :, 2].abs().min() > 0
    again = port_flash.flash_attention_bwd(q, k, v, o, lse, do, bias, bias_grad=True,
                                           key_mask=mask.to(torch.uint8))
    assert all(torch.equal(x, y) for x, y in zip((dq, dk, dv, dbias), again))


@pytest.fixture
def no_library(monkeypatch):
    """A launcher that gets past its checks reaches the library: here it
    raises instead (there is none on the CPU)."""
    def reached():
        raise LookupError("reached the library")

    monkeypatch.setattr(port_flash, "_lib", reached)


def _launch(which, key_mask, n=8, h=2, n_keys=-1):
    """One launcher of rows 3-6 on valid CPU arguments (bf16 [1, n, h, 64]
    rows, fp32 lse / delta, a bias), with ``key_mask`` (and ``n_keys``,
    but for the dbias kernel)."""
    t = lambda: torch.zeros(1, n, h, port_flash.HEAD_DIM, dtype=torch.bfloat16)  # noqa: E731
    vec = lambda: torch.zeros(h, n)  # noqa: E731
    bias = torch.zeros(h, n, n)
    if which == "fwd":
        port_flash.flash_attention_fwd_launch(t(), t(), t(), bias, 0.125, t(), vec(), n_keys,
                                              key_mask)
    elif which == "dq":
        port_flash.flash_attention_bwd_dq(t(), t(), t(), t(), vec(), t(), bias, 0.125, t(), vec(),
                                          n_keys, key_mask)
    elif which == "dkdv":
        port_flash.flash_attention_bwd_dkdv(t(), t(), t(), vec(), t(), vec(), bias, 0.125, t(),
                                            t(), n_keys, key_mask)
    else:
        port_flash.flash_attention_bwd_dbias(t(), t(), t(), vec(), t(), vec(), bias, 0.125,
                                             torch.zeros(h, n, n), key_mask)


@pytest.mark.parametrize("which", ["fwd", "dq", "dkdv", "dbias"])
@pytest.mark.parametrize("bad", ["length", "dtype", "layout", "rank", "device", "good_bool",
                                 "good_uint8"])
def test_launchers_check_the_mask_before_the_library(no_library, which, bad):
    """Each of the four launchers takes the mask as the kernels read it,
    bool or uint8 [rows, N] contiguous on the rows' device, and refuses
    anything else with a message before it touches the library."""
    n = 8
    mask = {
        "length": torch.ones(3, n + 1, dtype=torch.bool),
        "dtype": torch.ones(3, n),
        "layout": torch.ones(n, 3, dtype=torch.bool).t(),
        "rank": torch.ones(n, dtype=torch.bool),
        "device": torch.ones(3, n, dtype=torch.bool, device="meta"),
        "good_bool": torch.ones(3, n, dtype=torch.bool),
        "good_uint8": torch.ones(3, n, dtype=torch.uint8),
    }[bad]
    if bad.startswith("good"):
        with pytest.raises(LookupError, match="reached the library"):
            _launch(which, mask, n)
    else:
        with pytest.raises(ValueError, match="key_mask must be a contiguous bool or uint8"):
            _launch(which, mask, n)


@pytest.mark.parametrize("which", ["fwd", "dq", "dkdv", "plain_fwd", "plain_bwd"])
@pytest.mark.parametrize("n_keys", [5, 8])
def test_a_key_mask_excludes_n_keys_below_n(no_library, which, n_keys):
    """A key mask and a valid-key count below N exclude each other: the
    launchers and the plain versions refuse both together, before the
    library; with n_keys == N the mask goes through."""
    n = 8
    mask = torch.ones(3, n, dtype=torch.bool)
    q = torch.zeros(3, n, 2, 4)
    if which == "plain_fwd":
        call = lambda: port_flash.flash_attention_plain(  # noqa: E731
            q, q, q, n_keys=n_keys, key_mask=mask)
    elif which == "plain_bwd":
        call = lambda: port_flash.flash_attention_bwd_plain(  # noqa: E731
            q, q, q, q, torch.zeros(6, n), q, n_keys=n_keys, key_mask=mask)
    else:
        call = lambda: _launch(which, mask, n, n_keys=n_keys)  # noqa: E731
    if n_keys < n:
        with pytest.raises(ValueError, match="with a key mask"):
            call()
    elif which.startswith("plain"):
        call()
    else:
        with pytest.raises(LookupError, match="reached the library"):
            call()


@pytest.mark.parametrize("n,with_bias", [(9, True), (256, True), (300, False), (300, True)])
def test_masked_attention_reaches_the_flash_wrappers(n, with_bias):
    """Off the CPU, attention with a key mask and a bias (any N), or with
    a mask over more than 256 tokens, goes to the flash kernels' wrapper
    and never to a plain version: on a device that is not CUDA the wrapper
    refuses it."""
    qkv = torch.empty(2, n, 3 * 64, device="meta")
    mask = torch.ones(1, n, dtype=torch.bool, device="meta")
    bias = torch.empty(4, n, n, device="meta") if with_bias else None
    with pytest.raises(ValueError, match="flash_attention: unsupported device meta"):
        port_vit.attention_core(qkv, 4, key_mask=mask, bias=bias)


VIT = dict(hidden_size=32, num_hidden_layers=2, num_attention_heads=2, intermediate_size=64,
           use_relative_position_bias=True, use_absolute_position_embeddings=False,
           global_attn_layers=(2,))


@pytest.mark.parametrize("size,ws,pad", [
    (80, 3, 0),  # 3 x 3 windows on the 5 x 5 grid, padded to 6 x 6; layer 1 windowed
    (64, 0, 24),  # no windows, 17 tokens padded to 24 (pad_tokens_to with a bias)
])
def test_vit_forward_relpos_masked_matches_jax(rng, size, ws, pad):
    """The encoder with a relative-position table per layer where a key
    mask meets the bias (a padded window grid; ``pad_tokens_to``): taps
    and every gradient, the tables' included, against JAX's ``vit_forward``
    on its XLA path; the masked attention took the flash route."""
    kw = dict(VIT, image_size=size, window_size=ws, pad_tokens_to=pad)
    jcfg, pcfg = jax_vit.ViTConfig(**kw), port_vit.ViTConfig(**kw)
    jparams = jax.tree_util.tree_map(np.asarray,
                                     jax_vit.init_vit_params(jax.random.PRNGKey(0), jcfg))
    jparams["cls_token"] = (0.02 * rng.standard_normal(jparams["cls_token"].shape)).astype(
        np.float32)
    for layer in jparams["layers"]:
        layer["rel_pos_table"] = (0.5 * rng.standard_normal(layer["rel_pos_table"].shape)
                                  ).astype(np.float32)
    x = rng.uniform(-1, 1, (2, 3, size, size)).astype(np.float32)
    taps = (1, 2)
    g = size // 16
    cots = [rng.standard_normal((2, 1 + g * g, 32)).astype(np.float32) for _ in taps]

    def total(p):
        outs = jax_vit.vit_forward(p, jnp.asarray(x), jcfg, taps=taps)
        return sum((o * c).sum() for o, c in zip(outs, cots)), outs

    (_, want), jgrads = jax.jit(jax.value_and_grad(total, has_aux=True))(jparams)

    params = weights_io.vit_params_from_jax(jparams)
    for t in weights_io.tree_leaves(params):
        t.requires_grad_(True)
    with _masked_flash_calls() as masked:
        got = port_vit.vit_forward(params, torch.from_numpy(x), pcfg, taps=taps)
    # windows: layer 1 windowed (masked), layer 2 global; padding: both layers
    assert masked == ([True, False] if ws else [True, True])
    for w, t in zip(want, got):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(w), atol=TAP_TOL, rtol=TAP_TOL)
    sum((t * torch.from_numpy(c)).sum() for t, c in zip(got, cots)).backward()
    grads = weights_io.vit_params_to_jax(weights_io.tree_map(lambda t: t.grad, params))
    flat_j = jax.tree_util.tree_flatten_with_path(jax.tree_util.tree_map(np.asarray, jgrads))[0]
    flat_p = jax.tree_util.tree_leaves(grads)
    assert len(flat_j) == len(flat_p)
    tables = 0
    for (path, w), gp in zip(flat_j, flat_p):
        name = jax.tree_util.keystr(path)
        assert gp.shape == w.shape, name
        assert _rel_frob(gp, w) <= GRAD_RTOL, (name, _rel_frob(gp, w))
        tables += "rel_pos_table" in name
    assert tables == 2
