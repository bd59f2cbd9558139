"""Float32 serving on the card (the float32 forms of kernel-table rows 1,
3 and 7), what the CPU can check: the three forward launchers take bf16
and fp32 and refuse other types, with a 16-byte stride rule per type (8
bf16 or 4 fp32 elements); the backward kernels' launchers, and the
trainer, refuse float32 on the card with one message (the trainer only
where its model's backward reaches a kernel); the operators'
fake functions give the inputs' dtypes; and the plain versions the
kernels are held to on the card, at the float32 cases the existing files
lack (head dims 32 and 128, ``n_keys``, P = 14), against the JAX
package's Pallas kernels in interpret mode or its XLA path, 1e-5 (fp32
on both sides, another summation order). The float32 engine against
JAX's is ``tests/test_torch_detector.py::test_engine_two_buckets_matches_jax``
(float32 is the detector config's default); the key-masked plain
versions against JAX's masked XLA attention are in
``tests/test_torch_flash_mask.py`` and ``tests/test_torch_encoder_large.py``."""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from layoutdit_tpu.ops import flash_attention as jax_flash
from layoutdit_tpu.ops.roi_align import multiscale_roi_align as jax_roi_align
from layoutdit_tpu.ops.short_attention import short_attention as jax_short
from layoutdit_tpu_torch.models.detection.detector import DetectorConfig
from layoutdit_tpu_torch.ops import _library, matching, nms, roi_fused  # noqa: F401 (operators)
from layoutdit_tpu_torch.ops import flash_attention as port_flash
from layoutdit_tpu_torch.ops import roi_align as port_roi
from layoutdit_tpu_torch.ops import short_attention as port_short
from layoutdit_tpu_torch.tools import kernel_swap
from layoutdit_tpu_torch.train.trainer import refuse_float32_on_card

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

TOL = 1e-5
OPS = torch.ops.layoutdit_torch
DTYPES = {"bf16": torch.bfloat16, "fp32": torch.float32, "fp16": torch.float16,
          "fp64": torch.float64}


@pytest.fixture
def no_library(monkeypatch):
    """A launcher that gets past its checks reaches the library: here it
    raises instead (there is none on the CPU)."""
    def reached():
        raise LookupError("reached the library")

    for mod in (port_short, port_flash, port_roi):
        monkeypatch.setattr(mod, "_lib", reached)


def _heads(dtype, n=8, h=2, d=64, pad=0):
    """q, k, v [1, N, H, D] as slices of one [1, N, 3 * H * D + pad]
    projection (a row pitch ``pad`` elements past the fused one's)."""
    fused = torch.zeros(1, n, 3 * h * d + pad, dtype=dtype)
    return [fused[..., i * h * d:(i + 1) * h * d].view(1, n, h, d) for i in range(3)]


def _launch(which: str, dtype, pad: int = 0, c: int = 8):
    """The direct forward launch of a row on CPU tensors of ``dtype``."""
    if which == "short":
        q, k, v = _heads(dtype, pad=pad)
        return port_short.short_attention_launch(q, k, v, 0.125, None)
    if which == "flash":
        q, k, v = _heads(dtype, pad=pad)
        o = torch.empty_like(q, memory_format=torch.contiguous_format)
        lse = torch.empty(2, 8)
        return port_flash.flash_attention_fwd_launch(q, k, v, None, 0.125, o, lse)
    feats = [torch.zeros(1, c, s, s, dtype=dtype).contiguous(memory_format=torch.channels_last)
             for s in (8, 4)]
    rois = torch.tensor([[[0.0, 0.0, 16.0, 16.0]]])
    return port_roi.roi_align_launch(feats, rois, torch.zeros(1, 1, dtype=torch.int32),
                                     [0.5, 0.25])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("which", ["short", "flash", "roi"])
def test_forward_launchers_take_bf16_and_fp32(no_library, which, dtype):
    """Rows 1, 3 and 7's launchers reach the library for bf16 and fp32
    inputs and refuse fp16 and fp64 with a message naming both types."""
    if dtype in ("bf16", "fp32"):
        with pytest.raises(LookupError, match="reached the library"):
            _launch(which, DTYPES[dtype])
    else:
        with pytest.raises(ValueError, match="bf16|fp32"):
            _launch(which, DTYPES[dtype])


@pytest.mark.parametrize("dtype,pad,ok", [("bf16", 8, True), ("bf16", 4, False),
                                          ("fp32", 4, True), ("fp32", 2, False)])
@pytest.mark.parametrize("which", ["short", "flash"])
def test_attention_launchers_hold_16_bytes_per_dtype(no_library, which, dtype, pad, ok):
    """A row pitch 16 bytes past the fused projection's passes (8 bf16 or
    4 fp32 elements); 8 bytes past it is refused: the fp32 kernel's float4
    loads, like the bf16 kernels' TMA and cp.async, need 16-byte rows."""
    if ok:
        with pytest.raises(LookupError, match="reached the library"):
            _launch(which, DTYPES[dtype], pad=pad)
    else:
        with pytest.raises(ValueError, match="16-byte aligned"):
            _launch(which, DTYPES[dtype], pad=pad)


@pytest.mark.parametrize("dtype,c,ok", [("bf16", 8, True), ("bf16", 4, False),
                                        ("fp32", 4, True), ("fp32", 6, False)])
def test_roi_launcher_holds_16_bytes_per_dtype(no_library, dtype, c, ok):
    """Channels-last levels whose C (the channel-last strides' unit) is a
    multiple of 8 bf16 or 4 fp32 elements pass; others are refused."""
    if ok:
        with pytest.raises(LookupError, match="reached the library"):
            _launch("roi", DTYPES[dtype], c=c)
    else:
        with pytest.raises(ValueError, match="16-byte aligned"):
            _launch("roi", DTYPES[dtype], c=c)


def test_backward_launchers_refuse_float32():
    """Each backward kernel's launcher, which the wrappers' operators call
    on the card, raises the one float32-training message before anything
    launches, on any device."""
    b, n, h, d = 1, 8, 2, 64
    msg = "float32 training on the card waits for the fp32 backward kernels"
    q, k, v, o, do = (torch.zeros(b, n, h, d) for _ in range(5))
    lse, delta = torch.zeros(b * h, n), torch.zeros(b * h, n)
    with pytest.raises(ValueError, match=msg):
        port_short.short_attention_bwd_launch(q, k, v, o, do, lse.view(b, h, n), 0.125, None,
                                              q, k, v)
    with pytest.raises(ValueError, match=msg):
        port_flash.flash_attention_bwd_dq(q, k, v, o, lse, do, None, 0.125, q, delta)
    with pytest.raises(ValueError, match=msg):
        port_flash.flash_attention_bwd_dkdv(q, k, v, lse, do, delta, None, 0.125, k, v)
    with pytest.raises(ValueError, match=msg):
        port_flash.flash_attention_bwd_dbias(q, k, v, lse, do, delta, torch.zeros(h, n, n),
                                             0.125, torch.zeros(h, n, n))
    feats = [torch.zeros(b, 8, s, s).contiguous(memory_format=torch.channels_last)
             for s in (8, 4)]
    with pytest.raises(ValueError, match=msg):
        port_roi._bwd_cuda(torch.zeros(b, 3, 7, 7, 8), torch.zeros(b, 3, 4),
                           torch.zeros(b, 3, dtype=torch.int32), feats, [0.5, 0.25], 7, 2)
    assert _library.FLOAT32_TRAINING.startswith(msg)


def test_trainer_refuses_float32_on_the_card():
    """``refuse_float32_on_card`` (the trainer's first check): a float32
    model whose backward reaches a kernel raises the same message on a
    CUDA device, the DiT Faster R-CNN through rows 2, 4-6 and 8, a DiT
    RetinaNet through the attention's, a ResNet Faster R-CNN through row
    8's; a ResNet RetinaNet reaches none and passes, as do bf16 on the
    card and float32 on the CPU; a float32 control passes once every
    wrapper it reaches is swapped for its plain version, not before."""
    cuda = torch.device("cuda")
    dit = DetectorConfig(compute_dtype="float32")
    dit_retina = dataclasses.replace(dit, detector_kind="retinanet")
    resnet = dataclasses.replace(dit, backbone_kind="resnet50")
    resnet_retina = dataclasses.replace(resnet, detector_kind="retinanet")
    refused = functools.partial(pytest.raises, ValueError, match="float32 training on the card")
    for cfg in (dit, dit_retina, resnet):
        with refused():
            refuse_float32_on_card(cuda, cfg)
    refuse_float32_on_card(cuda, resnet_retina)
    refuse_float32_on_card(cuda, dataclasses.replace(dit, compute_dtype="bfloat16"))
    refuse_float32_on_card(torch.device("cpu"), dit)
    with kernel_swap.swapped("plain_attention"):
        refuse_float32_on_card(cuda, dit_retina)
        for cfg in (dit, resnet):
            with refused():
                refuse_float32_on_card(cuda, cfg)
        with kernel_swap.swapped("plain_roi"):
            refuse_float32_on_card(cuda, dit)
        with refused():
            refuse_float32_on_card(cuda, dit)
    with kernel_swap.swapped("plain_roi"):
        refuse_float32_on_card(cuda, resnet)
    with refused():
        refuse_float32_on_card(cuda, dit)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fake_functions_follow_the_inputs_dtype(dtype):
    """Every operator's fake function under ``FakeTensorMode`` on fake
    CUDA tensors: the forwards' outputs in the inputs' dtype (the lse
    fp32), the RoIAlign backward's in the levels'; the operators whose
    kernels write a fixed type give it (footprints int32, the fused
    RoIAlign probes bf16, the matcher int64 and int32, the NMS fixpoint
    its mask's)."""
    b, n, h, d = 2, 8, 2, 64
    with FakeTensorMode(allow_non_fake_inputs=True):
        t = functools.partial(torch.empty, device="cuda", dtype=dtype)
        q = t(b, n, h, d)
        assert OPS.short_attention(q, q, q, 0.125, None).dtype == dtype
        o, lse = OPS.short_attention_lse(q, q, q, 0.125, None)
        assert (o.dtype, lse.dtype, lse.shape) == (dtype, torch.float32, (b, h, n))
        o, lse = OPS.flash_attention_fwd(q, q, q, None, 0.125)
        assert (o.dtype, lse.dtype, lse.shape) == (dtype, torch.float32, (b * h, n))
        feats = [t(b, 8, 8, 8), t(b, 8, 4, 4)]
        rois = torch.empty(b, 3, 4, device="cuda")
        levels = torch.empty(b, 3, device="cuda", dtype=torch.int32)
        pooled = OPS.roi_align_fwd(feats, rois, levels, [0.5, 0.25], 7, 2)
        assert (pooled.dtype, pooled.shape) == (dtype, (b, 3, 7, 7, 8))
        grads = OPS.roi_align_bwd(pooled, rois, levels, feats, [0.5, 0.25], 7, 2)
        assert [g.dtype for g in grads] == [dtype, dtype]
        assert OPS.roi_align_footprints(rois, levels, [8, 8, 4, 4], [0.5, 0.25], 7,
                                        2).dtype == torch.int32
        f = t(16, 64)
        assert OPS.roi_fused_a(f, f, f, 8, 8, 8, 8).dtype == torch.bfloat16
        cost = t(3, 4, 5)
        assert [x.dtype for x in OPS.linear_sum_assignment(cost)] == [torch.int64, torch.int32]
        alive = torch.empty(2, 5, dtype=torch.bool, device="cuda")
        assert OPS.nms_fixpoint(t(2, 5, 5), alive).dtype == torch.bool


def _f32(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("d", [32, 128])
def test_short_plain_matches_pallas_at_head_dims(rng, d):
    """Row 1's plain version at the float32 forward's other head dims
    against JAX's Pallas kernel in interpret mode (65 tokens: one padded
    tile), o and the lse form's o."""
    q, k, v = (_f32(rng, 1, 65, 2, d) for _ in range(3))
    want = np.asarray(jax_short(*map(jnp.asarray, (q, k, v)), interpret=True))
    got, lse = port_short.short_attention_plain(*map(torch.from_numpy, (q, k, v)),
                                                return_lse=True)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
    assert lse.shape == (1, 2, 65) and torch.isfinite(lse).all()


def test_flash_plain_n_keys_matches_pallas(rng):
    """Row 3's plain version with ``n_keys`` (keys at index >= n_keys out
    of every row) and a bias, o and lse, against JAX's Pallas kernel in
    interpret mode given the same bias with -1e30 (its finite NEG_INF)
    on the dropped keys' columns."""
    b, n, h, d, nk = 1, 130, 2, 64, 70
    q, k, v = (_f32(rng, b, n, h, d) for _ in range(3))
    bias = _f32(rng, h, n, n)
    jbias = np.where(np.arange(n) < nk, bias, np.float32(-1e30))
    want = np.asarray(jax_flash.flash_attention(*map(jnp.asarray, (q, k, v)),
                                                bias=jnp.asarray(jbias), interpret=True))
    to_bh = lambda x: jnp.asarray(x).transpose(0, 2, 1, 3).reshape(b * h, n, d)  # noqa: E731
    _, jax_lse = jax_flash._flash_fwd(to_bh(q), to_bh(k), to_bh(v), jnp.asarray(jbias),
                                      1.0 / np.sqrt(d), *jax_flash._auto_blocks(n, None, None),
                                      True)
    got, lse = port_flash.flash_attention_plain(*map(torch.from_numpy, (q, k, v)),
                                                bias=torch.from_numpy(bias), n_keys=nk)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jax_lse)[:, :n, 0], atol=TOL, rtol=TOL)


@pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
def test_roi_plain_matches_jax_at_p14(rng, impl):
    """Row 7's plain version at the mask head's P = 14 against JAX's
    ``multiscale_roi_align`` (its XLA atlas path and its Pallas kernel in
    interpret mode), RoIs over every level, some masked."""
    sizes, scales = (56, 28, 14, 7, 4), [1 / 4, 1 / 8, 1 / 16, 1 / 32, 1 / 64]
    feats = [_f32(rng, 1, 8, s, s) for s in sizes]
    boxes = rng.uniform(-10, 224, (1, 24, 4)).astype(np.float32)
    boxes[..., 2:] = boxes[..., :2] + rng.uniform(0.5, 120, (1, 24, 2))
    mask = rng.uniform(size=(1, 24)) < 0.8
    got = port_roi.multiscale_roi_align(
        [torch.from_numpy(f) for f in feats], torch.from_numpy(boxes), scales, output_size=14,
        roi_mask=torch.from_numpy(mask), native_layout=True)
    want = jax.jit(functools.partial(jax_roi_align, spatial_scales=scales, output_size=14,
                                     impl=impl, native_layout=True))(
        [jnp.asarray(f[0]) for f in feats], jnp.asarray(boxes[0]),
        roi_mask=jnp.asarray(mask[0]))
    assert got.shape == (1, 24, 14, 14, 8)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), atol=TOL, rtol=TOL)
