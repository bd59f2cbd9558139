"""Fused RoIAlign probes and the level-atlas RoIAlign: the port's plain
versions against the JAX probe (``scripts/probe_roi_fused.py``, its
Pallas kernels run in interpret mode) and against the JAX package's
``multiscale_roi_align`` on the CPU; the CUDA kernels against their plain
versions on the card."""

import functools
import importlib.util
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from layoutdit_tpu.ops import roi_align as jax_ra
from layoutdit_tpu_torch.ops import roi_align as port_ra
from layoutdit_tpu_torch.ops import roi_fused as rf
from layoutdit_tpu_torch.tools import probe_roi_fused as tool

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("probe_roi_fused",
                                               REPO / "scripts" / "probe_roi_fused.py")
probe = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(probe)

C, H, W = probe.C, probe.H, probe.W  # 256, 109, 56: the probe's shapes
K = 32
TOL = 1e-5  # float32, same function; only the summation order differs
SIZES = (56, 28, 14, 7, 4)  # the 224 px pyramid: atlas H = 109, W = 56
SCALES = [1 / 4, 1 / 8, 1 / 16, 1 / 32, 1 / 64]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _probe_inputs(k=K):
    """The probe's own inputs (0/1 weights), as numpy arrays."""
    f, wy, wx = tool.probe_inputs(k, "cpu")
    return f.float().numpy(), wy.numpy(), wx.numpy()


def _interpret(fn, *args, **kw):
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(fn(*(jnp.asarray(a) for a in args), **kw).astype(jnp.float32))


def _jax_f(f):
    return jnp.asarray(f, jnp.bfloat16)


def _ulp_tol(ref):
    """One bf16 ulp at the top of the output's range."""
    return float(np.abs(ref).max()) * 2.0**-7


def _pyramid(rng, b=1, k=K, c=C, image=224.0):
    feats = [rng.standard_normal((b, c, s, s)).astype(np.float32) for s in SIZES]
    wh = np.exp(np.log(4.0) + rng.uniform(size=(b, k, 2)) * np.log(image / 4.0))
    xy = rng.uniform(size=(b, k, 2)) * image - wh / 2
    boxes = np.concatenate([xy, xy + wh], axis=-1).astype(np.float32)
    mask = rng.uniform(size=(b, k)) > 0.2
    return feats, boxes, mask


def _atlas(feats, boxes, mask):
    return port_ra.roi_atlas([torch.from_numpy(f) for f in feats], torch.from_numpy(boxes),
                             SCALES, roi_mask=torch.from_numpy(mask))


# --------------------------------------------- the probe's functions, 0/1 weights


def test_two_gemm_matches_probe_yardstick():
    f, wy, wx = _probe_inputs()
    want = np.asarray(probe.xla_two_gemm(_jax_f(f), jnp.asarray(wy), jnp.asarray(wx))
                      .astype(jnp.float32))
    got = rf.two_gemm(torch.from_numpy(f), torch.from_numpy(wy), torch.from_numpy(wx))
    assert got.dtype == torch.bfloat16 and got.shape == (K, 7, 7, C)
    assert np.abs(got.float().numpy() - want).max() <= _ulp_tol(want)


@pytest.mark.parametrize("kb", [8, 16])
def test_variant_a_matches_probe(kb):
    f, wy, wx = _probe_inputs()
    want = _interpret(functools.partial(probe.variant_a, kb=kb), _jax_f(f), wy, wx)
    got = rf.variant_a(torch.from_numpy(f), torch.from_numpy(wy), torch.from_numpy(wx), kb=kb)
    assert got.dtype == torch.bfloat16 and got.shape == (K, 7, 7, C)
    assert np.abs(got.float().numpy() - want).max() <= _ulp_tol(want)


@pytest.mark.parametrize("kb", [8, 16])
@pytest.mark.parametrize("relayout", [False, True])
def test_variant_a0_matches_probe(kb, relayout):
    f, wy, _ = _probe_inputs()
    want = _interpret(functools.partial(probe.variant_a0, kb=kb, relayout=relayout),
                      _jax_f(f), wy)
    got = rf.variant_a0(torch.from_numpy(f), torch.from_numpy(wy), kb=kb, relayout=relayout)
    assert got.shape == (K * 7 * W, C)
    assert np.abs(got.float().numpy() - want).max() <= _ulp_tol(want)


def test_variant_e_matches_probe():
    f, wy, wx = _probe_inputs()
    want = _interpret(functools.partial(probe.variant_e, kb=8), _jax_f(f), wy, wx)
    tf, twy, twx = (torch.from_numpy(a) for a in (f, wy, wx))
    got = rf.variant_e(tf, twy, twx, kb=8)
    assert got.shape == (K, 7, 7, C)
    assert np.abs(got.float().numpy() - want).max() <= _ulp_tol(want)
    # the kernel layout [K / kb, C, kb * Px, Py] relaid out by the wrapper
    raw = rf.variant_e(tf, twy, twx, kb=8, kernel_layout=True)
    assert raw.shape == (K // 8, C, 8 * 7, 7)
    torch.testing.assert_close(raw[1, 5, 7 * 3 + 2, 4], got[8 + 3, 2, 4, 5])


# ------------------------------------------ fractional weights from roi_atlas


@pytest.mark.parametrize("variant,kb", [("a", 8), ("a", 16), ("e", 8)])
def test_fused_on_atlas_weights_matches_probe(rng, variant, kb):
    feats, boxes, mask = _pyramid(rng)
    f_cat, wy, wx = (t[0] for t in _atlas(feats, boxes, mask))
    assert f_cat.shape == (C, H, W)
    jax_fn = {"a": probe.variant_a, "e": probe.variant_e}[variant]
    want = _interpret(functools.partial(jax_fn, kb=kb), _jax_f(f_cat.numpy()), wy.numpy(),
                      wx.numpy())
    got = getattr(rf, f"variant_{variant}")(f_cat, wy, wx, kb=kb).float().numpy()
    # the bf16 rounding of t may fall on either side of a boundary
    assert np.abs(got - want).max() <= np.abs(want).max() / 64
    assert np.abs(want).max() > 0.1


# --------------------------------------------------- the level-atlas RoIAlign


@pytest.mark.parametrize("impl", ["xla", "xla_per_level"])
def test_atlas_matches_jax_multiscale(rng, impl):
    feats, boxes, mask = _pyramid(rng, b=2, k=40, c=16)
    f_cat, wy, wx = _atlas(feats, boxes, mask)
    assert f_cat.shape == (2, 16, H, W) and wy.shape == (2, 40, 7, H)
    native = port_ra.pooled_from_weights_native(f_cat, wy, wx)
    tv = port_ra.pooled_from_weights(f_cat, wy, wx)
    torch.testing.assert_close(tv, native.permute(0, 1, 4, 3, 2))
    fn = jax.jit(functools.partial(jax_ra.multiscale_roi_align, spatial_scales=SCALES,
                                   impl=impl, native_layout=impl == "xla"))
    for i in range(2):
        want = fn([jnp.asarray(f[i]) for f in feats], jnp.asarray(boxes[i]),
                  roi_mask=jnp.asarray(mask[i]))
        got = native[i] if impl == "xla" else tv[i]
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


def test_atlas_matches_port_multiscale(rng):
    feats, boxes, mask = _pyramid(rng, b=2, k=40, c=16)
    got = port_ra.pooled_from_weights_native(*_atlas(feats, boxes, mask))
    want = port_ra.multiscale_roi_align([torch.from_numpy(f) for f in feats],
                                        torch.from_numpy(boxes), SCALES,
                                        roi_mask=torch.from_numpy(mask), native_layout=True)
    torch.testing.assert_close(got, want, atol=TOL, rtol=TOL)
    assert not got[torch.from_numpy(~mask)].any()


def test_single_level_roi_align_matches_jax(rng):
    feats, boxes, mask = _pyramid(rng, k=24, c=8)
    f = feats[1][0]
    got = port_ra.roi_align(torch.from_numpy(f), torch.from_numpy(boxes[0]), 1 / 8,
                            roi_mask=torch.from_numpy(mask[0]))
    want = jax_ra.roi_align(jnp.asarray(f), jnp.asarray(boxes[0]), 1 / 8,
                            roi_mask=jnp.asarray(mask[0]))
    assert got.shape == (24, 8, 7, 7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pooled_grad_matches_jax_vjp(rng, dtype):
    feats, boxes, mask = _pyramid(rng, k=24, c=16)
    f_cat, wy, wx = (t[0] for t in _atlas(feats, boxes, mask))
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    f = f_cat.clone().to(tdt).requires_grad_(True)
    ds = rng.standard_normal((24, 7, 7, 16)).astype(np.float32)
    tds = torch.from_numpy(ds).to(tdt)
    out = port_ra.pooled_from_weights_native(f, wy, wx)
    assert out.dtype == tdt
    got = torch.autograd.grad(out, f, tds)[0]
    _, vjp = jax.vjp(lambda x: jax_ra.pooled_from_weights_native(x, jnp.asarray(wy.numpy()),
                                                                 jnp.asarray(wx.numpy())),
                     jnp.asarray(f_cat.numpy(), jdt))
    want = np.asarray(vjp(jnp.asarray(ds, jdt))[0].astype(jnp.float32))
    assert got.dtype == tdt and got.shape == f_cat.shape
    err = np.abs(got.float().numpy() - want).max()
    if dtype == "float32":
        assert err <= TOL * max(1.0, np.abs(want).max())
    else:
        assert err <= np.abs(want).max() / 64
    assert np.abs(want).max() > 0.1


# ------------------------------------------------------ wrappers and the tool


@pytest.mark.parametrize("name", ["variant_a", "variant_a0", "variant_e"])
def test_k_not_multiple_of_kb_raises(name):
    f, wy, wx = (torch.from_numpy(a) for a in _probe_inputs(12))
    args = (f, wy) if name == "variant_a0" else (f, wy, wx)
    with pytest.raises(ValueError, match="not a multiple of kb=8"):
        getattr(rf, name)(*args, kb=8)


def test_kernel_operands_hold_the_same_function():
    # the padded layouts the kernels read give the plain version's t
    f, wy, _ = (torch.from_numpy(a) for a in _probe_inputs(8))
    fk, wyk, _ = rf.kernel_operands(f, wy, None)
    assert fk.shape == (C, W, rf.H_PAD) and wyk.shape == (8 * 7, rf.H_PAD)
    assert not fk[..., H:].any() and not wyk[:, H:].any()
    t = torch.einsum("mh,cwh->mcw", wyk.float(), fk.float()).to(torch.bfloat16)
    torch.testing.assert_close(t.reshape(8, 7, C, W), rf.t_plain(f, wy), atol=0, rtol=0)


def test_probe_tool_runs_on_cpu(capsys):
    assert tool.main(["--device", "cpu", "--k", "16", "--iters", "1"]) == 0
    out = capsys.readouterr().out
    assert "device: cpu" in out and " ms" not in out
    errs = [float(line.rsplit("=", 1)[1]) for line in out.splitlines() if "max|err|" in line]
    assert len(errs) == 5 and max(errs) == 0.0


def test_probe_tool_refuses_cuda_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        tool.main(["--k", "16"])
    assert e.value.code not in (0, None)


# ---------------------------------------------------------------- on the card


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["variant_a", "variant_a0", "variant_e"])
def test_kernel_matches_plain(cuda, name):
    f, wy, wx = tool.probe_inputs(8192, "cuda")
    for kb in (8, 16):
        if name == "variant_a0":
            for relayout in (False, True):
                got = rf.variant_a0(f, wy, kb=kb, relayout=relayout)
                want = rf.variant_a0_plain(f, wy, relayout)
                assert (got.float() - want.float()).abs().max() <= want.float().abs().max() / 64
            continue
        got = getattr(rf, name)(f, wy, wx, kb=kb)
        want = rf.variant_a_plain(f, wy, wx)
        torch.cuda.synchronize()
        assert (got.float() - want.float()).abs().max() <= want.float().abs().max() / 64


@pytest.mark.cuda
def test_launch_counters(cuda):
    f, wy, wx = tool.probe_inputs(64, "cuda")
    fns = (rf.variant_a, rf.variant_a0, rf.variant_e)
    before = [fn.launches for fn in fns]
    rf.variant_a(f, wy, wx)
    rf.variant_a0(f, wy)
    rf.variant_e(f, wy, wx)
    rf.two_gemm(f, wy, wx)
    assert [fn.launches - b for fn, b in zip(fns, before)] == [1, 1, 1]


@pytest.mark.cuda
def test_fused_matches_roi_align_kernel_on_real_rois(cuda, rng):
    feats, boxes, mask = _pyramid(rng, k=2048, c=256)
    tf = [torch.from_numpy(f).to(cuda, torch.bfloat16) for f in feats]
    rois, m = torch.from_numpy(boxes).to(cuda), torch.from_numpy(mask).to(cuda)
    f_cat, wy, wx = port_ra.roi_atlas(tf, rois, SCALES, roi_mask=m)
    got = rf.variant_a(f_cat[0], wy[0], wx[0], kb=16)
    want = port_ra.multiscale_roi_align(tf, rois, SCALES, roi_mask=m, native_layout=True)[0]
    assert (got.float() - want.float()).abs().max() <= want.float().abs().max() / 64
