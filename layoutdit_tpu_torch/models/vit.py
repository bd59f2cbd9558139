"""DiT/BEiT ViT encoder, dense path (port of ``layoutdit_tpu/models/vit.py``).

Plain functions over a parameter dictionary, as in the JAX package:
patchify with (c, kh, kw) flattening and a linear over it, a CLS token,
absolute position embeddings (bicubically resampled for grids other
than the trained one) and/or BEiT relative-position bias tables, per
layer and/or shared (bilinearly resampled), pre-LN blocks with eps 1e-12
and fp32 statistics, a fused QKV projection whose K part has no bias,
layer scale, and ``hidden_states`` taps (0 = embedding output, i =
output of layer i).

Attention goes to the port's kernels: without a bias, N <= 256 to the
short kernel and longer sequences to the flash kernel; with a bias, the
flash kernel at any N (the short kernels are bias-free, as the JAX
package's is). A key mask (padded window slots, ``pad_tokens_to``'s
padding) goes to the short kernels, which take one; the flash kernels
take none, so on the card a mask with a bias, or over more than 256
tokens, raises. All are differentiable, the bias too (on the CPU the
wrappers run their plain versions). That departs on purpose from the JAX
package's XLA-below-2048-tokens routing, which was measured on a TPU.
The projection and MLP matmuls stay ``torch`` matmuls, as the JAX
package leaves them to XLA.

``remat`` (JAX ``vit.py:876-896``) runs each layer under
``torch.utils.checkpoint`` while grad is enabled: "full" keeps the
layer's input only, "dots" also the outputs of its projection matmuls
(``aten.mm`` / ``aten.addmm``, JAX's ``dots_with_no_batch_dims_saveable``);
the rest, attention kernels included, runs again in the backward.

The relative-position bias is gathered from its [entries, heads] table
into a contiguous fp32 [H, N, N] tensor per layer (the flash kernels'
layout). Its gradient, the scatter-add of dbias into the table, is
computed from the index's structure as sums over diagonal bands
(``_rel_table_grad``): the same bits on every run, as a sorted
``index_put_`` would give, without sorting the N^2 indices each step.

ViTDet windows (``window_size`` > 0, ``vit.py:69-108, 192-293`` of the
JAX package): layers other than the global ones attend within
``window_size`` x ``window_size`` patch windows (ws^2 tokens each, the
short kernel's range at ws 16) and the CLS token attends to itself alone;
the global layers (by default the tap layers) attend over the whole
grid.

Precision policy as in the JAX package: parameters fp32, matmul inputs
cast to ``compute_dtype``, LayerNorm/softmax/GELU statistics in fp32.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch.profiler import record_function
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from layoutdit_tpu_torch.ops.flash_attention import flash_attention_qkv
from layoutdit_tpu_torch.ops.interpolate import resize_bicubic, resize_bilinear
from layoutdit_tpu_torch.ops.short_attention import MAX_N as SHORT_MAX_N
from layoutdit_tpu_torch.ops.short_attention import (
    key_mask_rows,
    short_attention_qkv,
    split_qkv,
)
from layoutdit_tpu_torch.utils.cache import cached_unless_traced


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    patch_size: int = 16
    image_size: int = 224
    num_channels: int = 3
    layer_norm_eps: float = 1e-12
    layer_scale_init_value: float = 0.1
    initializer_range: float = 0.02
    # microsoft/dit-base: absolute position embeddings, no relative
    # position bias; BEiT checkpoints: a bias table per layer and/or shared
    use_absolute_position_embeddings: bool = True
    use_relative_position_bias: bool = False
    use_shared_relative_position_bias: bool = False
    # ViTDet windows: 0 = full attention in every layer; W > 0 = W x W
    # patch windows in the layers that are not global. global_attn_layers
    # are 1-based; empty = the tap layers [L/3, L/2, 2L/3, L].
    window_size: int = 0
    global_attn_layers: tuple[int, ...] = ()
    # pad the token axis once at the embedding to this length (0 = off),
    # the padding masked out of every softmax row and cropped at the taps;
    # only without windows (JAX vit.py:829-846)
    pad_tokens_to: int = 0

    def is_global_layer(self, layer_idx_1based: int) -> bool:
        if self.window_size <= 0:
            return True
        n = self.num_hidden_layers
        return layer_idx_1based in (self.global_attn_layers or (n // 3, n // 2, 2 * n // 3, n))

    @property
    def grid_size(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid_size * self.grid_size

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads


DIT_BASE = ViTConfig()
DIT_LARGE = ViTConfig(
    hidden_size=1024, num_hidden_layers=24, num_attention_heads=16, intermediate_size=4096,
)


def _trunc_normal(shape, std, generator, device) -> torch.Tensor:
    t = torch.empty(shape, dtype=torch.float32, device=device)
    return torch.nn.init.trunc_normal_(
        t, std=std, a=-2.0 * std, b=2.0 * std, generator=generator
    )


def _zeros(shape, device) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.float32, device=device)


def _rel_pos_num_entries(cfg: ViTConfig) -> int:
    """(2g-1)^2 pairwise offsets of the trained grid g + 3 CLS entries
    (cls->token, token->cls, cls->cls)."""
    return (2 * cfg.grid_size - 1) ** 2 + 3


def relative_position_index(grid: int) -> np.ndarray:
    """BEiT's relative_position_index for a (grid, grid) patch grid + CLS
    (HF BeitRelativePositionBias): [1+g^2, 1+g^2] indices into the bias
    table (JAX ``vit.py:147``)."""
    num_rel = (2 * grid - 1) ** 2 + 3
    coords = np.stack(np.meshgrid(np.arange(grid), np.arange(grid), indexing="ij"))
    coords = coords.reshape(2, -1)  # [2, g^2]
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0).astype(np.int64)
    rel[:, :, 0] += grid - 1
    rel[:, :, 1] += grid - 1
    rel[:, :, 0] *= 2 * grid - 1
    n = grid * grid
    index = np.zeros((n + 1, n + 1), dtype=np.int64)
    index[1:, 1:] = rel.sum(-1)
    index[0, 0:] = num_rel - 3
    index[0:, 0] = num_rel - 2
    index[0, 0] = num_rel - 1
    return index


def window_relative_position_index(ws: int, grid: int) -> np.ndarray:
    """[ws^2, ws^2] indices into the full grid's table for one (ws, ws)
    window, no CLS entries (JAX ``vit.py:170``): within-window offsets
    are a subset of the grid's, encoded with the grid's stride 2*grid-1,
    so windowed layers gather from the same table as the global ones."""
    if ws > grid:
        raise ValueError(f"window {ws} larger than grid {grid}")
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    coords = coords.reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).astype(np.int64)
    return (rel[0] + grid - 1) * (2 * grid - 1) + (rel[1] + grid - 1)


@cached_unless_traced(maxsize=16)
def _rel_index(device: torch.device, grid: int, ws: int) -> torch.Tensor:
    """``relative_position_index(grid)`` (ws 0) or
    ``window_relative_position_index(ws, grid)`` on ``device``, built
    once per grid (outside inference mode, so that a first call under
    ``torch.inference_mode`` does not cache a tensor autograd refuses)."""
    idx = relative_position_index(grid) if ws == 0 else window_relative_position_index(ws, grid)
    with torch.inference_mode(False):
        return torch.from_numpy(idx).to(device)


def _diagonal_sums(m: torch.Tensor) -> torch.Tensor:
    """[..., w, w] -> [..., 2w-1]: out[..., i - j + w - 1] is the sum of
    m[..., i, j] over the diagonal i - j. Row i of the flipped matrix,
    zero-padded to 2w-1, is shifted right by i through a view whose rows
    step 2w-2 elements (the elements it reads twice or out of place are
    padding zeros), then summed over the rows: a copy and a reduction, no
    scatter."""
    w = m.shape[-1]
    lead = m.shape[:-2]
    p = F.pad(m.flip(-1), (0, w - 1)).contiguous()  # [..., w, 2w-1]
    strides = p.stride()[:-2]
    sheared = p.as_strided((*lead, w, 2 * w - 1), (*strides, 2 * w - 2, 1))
    return sheared.sum(-2)


def _rel_table_grad(dbias: torch.Tensor, grid: int, ws: int, entries: int) -> torch.Tensor:
    """The gradient [entries, H] of ``table.t()[:, _rel_index(grid, ws)]``
    from its cotangent dbias [H, n, n]: per table entry the sum of dbias
    over the (query, key) pairs at that offset. The index's structure
    makes each sum a band of diagonals: over the (x_q, x_k) pairs, then the
    (y_q, y_k) pairs (``_diagonal_sums``); the grid's 3 CLS entries are
    dbias's row 0, column 0 and corner. Deterministic (reductions in a
    fixed order), with no sort of the N^2 indices."""
    h, w, off = dbias.shape[0], ws or grid, 2 * grid - 1
    patch = dbias[:, 1:, 1:] if ws == 0 else dbias
    d = patch.reshape(h, w, w, w, w).transpose(2, 3)  # [H, y_q, y_k, x_q, x_k]
    d = _diagonal_sums(d).movedim(-1, 1)  # [H, dx, y_q, y_k]
    d = _diagonal_sums(d).transpose(1, 2)  # [H, dy, dx]
    grad = dbias.new_zeros(h, entries)
    c = grid - w  # a window's offsets are the middle of the grid's
    grad[:, :off * off].view(h, off, off)[:, c:c + 2 * w - 1, c:c + 2 * w - 1] = d
    if ws == 0:
        grad[:, -3] = dbias[:, 0, 1:].sum(-1)  # CLS query -> patch keys
        grad[:, -2] = dbias[:, 1:, 0].sum(-1)  # patch queries -> CLS key
        grad[:, -1] = dbias[:, 0, 0]
    return grad.t()


class _RelBiasGather(torch.autograd.Function):
    """bias = table.t()[:, index] for the index of a grid (ws 0) or of one
    window, contiguous fp32 [H, n, n]; its backward is
    ``_rel_table_grad``, under the profiler range ``rel_pos_table_grad``."""

    @staticmethod
    def forward(ctx, table, grid, ws):
        ctx.grid, ctx.ws, ctx.entries = grid, ws, table.shape[0]
        return table.t()[:, _rel_index(table.device, grid, ws)]

    @staticmethod
    def backward(ctx, dbias):
        with record_function("rel_pos_table_grad"):
            return _rel_table_grad(dbias, ctx.grid, ctx.ws, ctx.entries), None, None


def init_vit_params(cfg: ViTConfig, generator: torch.Generator, device) -> dict:
    """Random init with the JAX package's distributions (trunc-normal
    0.02 weights, zero biases, zero CLS and position embeddings, zero
    relative-position tables, layer scale ``layer_scale_init_value``).
    Linear weights are [out, in]; a table is [entries, heads], as in the
    JAX package."""
    d, i = cfg.hidden_size, cfg.intermediate_size
    patch_in = cfg.num_channels * cfg.patch_size * cfg.patch_size
    std = cfg.initializer_range
    table = (_rel_pos_num_entries(cfg), cfg.num_attention_heads)

    def lin(n_in, n_out, bias=True):
        p = {"weight": _trunc_normal((n_out, n_in), std, generator, device)}
        if bias:
            p["bias"] = _zeros((n_out,), device)
        return p

    layers = []
    for _ in range(cfg.num_hidden_layers):
        layer = {
            "ln1": {"weight": torch.ones(d, device=device), "bias": _zeros((d,), device)},
            "ln2": {"weight": torch.ones(d, device=device), "bias": _zeros((d,), device)},
            # rows [q; k; v]; the k third of the bias stays zero (BEiT K
            # has no bias)
            "qkv": lin(d, 3 * d),
            "attn_out": lin(d, d),
            "mlp_in": lin(d, i),
            "mlp_out": lin(i, d),
            "lambda_1": torch.full((d,), cfg.layer_scale_init_value, device=device),
            "lambda_2": torch.full((d,), cfg.layer_scale_init_value, device=device),
        }
        if cfg.use_relative_position_bias:
            layer["rel_pos_table"] = _zeros(table, device)
        layers.append(layer)
    params = {"cls_token": _zeros((d,), device), "patch_embed": lin(patch_in, d)}
    if cfg.use_absolute_position_embeddings:
        params["pos_embed"] = _zeros((cfg.num_patches + 1, d), device)
    if cfg.use_shared_relative_position_bias:
        params["shared_rel_pos_table"] = _zeros(table, device)
    params["layers"] = layers
    return params


def _layer_norm(x: torch.Tensor, p: dict, eps: float) -> torch.Tensor:
    """LayerNorm with fp32 statistics and fp32 affine, cast back."""
    return F.layer_norm(x.float(), x.shape[-1:], p["weight"], p["bias"], eps).to(x.dtype)


def _linear(x: torch.Tensor, p: dict) -> torch.Tensor:
    bias = p.get("bias")
    return F.linear(x, p["weight"].to(x.dtype), None if bias is None else bias.to(x.dtype))


def patchify(pixels: torch.Tensor, patch: int) -> torch.Tensor:
    """[B, C, H, W] -> [B, (H/p)*(W/p), C*p*p] with (c, kh, kw) flattening
    (torch Conv2d weight.reshape(out, -1) layout)."""
    b, c, h, w = pixels.shape
    gh, gw = h // patch, w // patch
    x = pixels.reshape(b, c, gh, patch, gw, patch)
    x = x.permute(0, 2, 4, 1, 3, 5)  # [B, gh, gw, C, p, p]
    return x.reshape(b, gh * gw, c * patch * patch)


def _masked_attention_plain(
    qkv: torch.Tensor, heads: int, scale: float, key_mask: torch.Tensor,
    bias: torch.Tensor | None,
) -> torch.Tensor:
    """softmax(q k^T * scale + bias) v in fp32 with the False keys of
    ``key_mask`` [rows, N] (row b % rows for batch b) out of every row
    (-inf scores), as the JAX encoder's XLA path does for padded window
    slots (``vit.py:552``)."""
    q, k, v = split_qkv(qkv, heads)
    s = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * scale
    if bias is not None:
        s = s + bias.float()
    s = s.masked_fill(~key_mask_rows(key_mask, qkv.shape[0])[:, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhnm,bmhd->bnhd", p, v.float()).to(qkv.dtype)


def attention_core(
    qkv: torch.Tensor, heads: int, key_mask: torch.Tensor | None = None,
    bias: torch.Tensor | None = None,
) -> torch.Tensor:
    """softmax(q k^T / sqrt(D) + bias) v from the fused projection
    [B, N, 3*H*D] -> [B, N, H, D], differentiable in qkv and the bias
    [H, N, N] (shared by the batch): without a bias the short kernels for
    N <= 256 and the flash kernels beyond; with one, the flash kernels at
    any N. ``key_mask`` [rows, N] bool (row b % rows for batch b) drops
    the False keys from every softmax row (padded window slots,
    ``pad_tokens_to``'s padding); the short kernels take it. The flash
    kernels take no mask, so on a CUDA tensor a mask with a bias, or over
    more than 256 tokens, raises; on the CPU the plain version runs."""
    scale = 1.0 / math.sqrt(qkv.shape[-1] // (3 * heads))
    short = bias is None and qkv.shape[1] <= SHORT_MAX_N
    if key_mask is not None and not short:
        if qkv.device.type != "cpu":
            raise NotImplementedError(
                "a key mask with a relative-position bias, or over more than "
                f"{SHORT_MAX_N} tokens, needs a key mask in the flash-attention kernels, "
                "which they do not take yet (ROADMAP.md queue 2: rows 3-6 take no key "
                "mask); use a window size that divides the patch grid, or no "
                "pad_tokens_to, with a relative-position bias"
            )
        return _masked_attention_plain(qkv, heads, scale, key_mask, bias)
    if short:
        return short_attention_qkv(qkv, heads, scale=scale, key_mask=key_mask)
    return flash_attention_qkv(qkv, heads, scale=scale, bias=bias)


def _attention(
    x: torch.Tensor, layer: dict, cfg: ViTConfig, key_mask: torch.Tensor | None = None,
    bias: torch.Tensor | None = None,
) -> torch.Tensor:
    b, n, d = x.shape
    qkv = _linear(x, layer["qkv"])  # [B, N, 3D]
    ctx = attention_core(qkv, cfg.num_attention_heads, key_mask, bias)
    return _linear(ctx.reshape(b, n, d), layer["attn_out"])


def _window_partition(
    tokens: torch.Tensor, gh: int, gw: int, ws: int
) -> tuple[torch.Tensor, tuple[int, int, int, int]]:
    """[B, gh*gw, D] -> [B*nh*nw, ws*ws, D], the grid zero-padded up to a
    multiple of ws (JAX ``vit.py:192``)."""
    b, _, d = tokens.shape
    ph, pw = (-gh) % ws, (-gw) % ws
    hp, wp = gh + ph, gw + pw
    nh, nw = hp // ws, wp // ws
    x = tokens.reshape(b, gh, gw, d)
    if ph or pw:
        x = F.pad(x, (0, 0, 0, pw, 0, ph))
    x = x.reshape(b, nh, ws, nw, ws, d).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b * nh * nw, ws * ws, d), (hp, wp, nh, nw)


def _window_merge(
    xw: torch.Tensor, b: int, gh: int, gw: int, ws: int, dims: tuple[int, int, int, int]
) -> torch.Tensor:
    """Inverse of ``_window_partition``; crops the padding back off (JAX
    ``vit.py:210``)."""
    hp, wp, nh, nw = dims
    d = xw.shape[-1]
    x = xw.reshape(b, nh, nw, ws, ws, d).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, hp, wp, d)[:, :gh, :gw].reshape(b, gh * gw, d)


def _window_key_mask(gh: int, gw: int, ws: int) -> torch.Tensor | None:
    """[nh*nw, ws*ws] bool, True where a window slot holds a real token;
    None when ws divides the grid (JAX ``vit.py:222``)."""
    ph, pw = (-gh) % ws, (-gw) % ws
    if not (ph or pw):
        return None
    valid = torch.zeros((gh + ph, gw + pw), dtype=torch.bool)
    valid[:gh, :gw] = True
    nh, nw = (gh + ph) // ws, (gw + pw) // ws
    return valid.reshape(nh, ws, nw, ws).permute(0, 2, 1, 3).reshape(nh * nw, ws * ws)


@cached_unless_traced(maxsize=16)
def _window_key_mask_on(device: torch.device, gh: int, gw: int, ws: int) -> torch.Tensor | None:
    """``_window_key_mask`` on ``device``, copied once per grid (outside
    inference mode, as ``_rel_index``)."""
    mask = _window_key_mask(gh, gw, ws)
    with torch.inference_mode(False):
        return None if mask is None else mask.to(device)


def _windowed_attention(
    x: torch.Tensor, layer: dict, cfg: ViTConfig, gh: int, gw: int,
    bias: torch.Tensor | None = None,
) -> torch.Tensor:
    """Attention restricted to ws x ws patch windows (JAX ``vit.py:238``).
    x is the post-LN [B, 1+gh*gw, D] stream. The CLS token is in no
    window: it attends to itself alone (a 1-token sequence through the
    same projections, no bias), and patch tokens do not see it. Padded
    window slots are masked out of the softmax (one mask row per window,
    read modulo the window count). ``bias`` [H, ws^2, ws^2] (the
    relative-position bias at within-window offsets) is the same for
    every window."""
    b = x.shape[0]
    ws = cfg.window_size
    xw, dims = _window_partition(x[:, 1:], gh, gw, ws)
    key_mask = _window_key_mask_on(x.device, gh, gw, ws)
    merged = _window_merge(_attention(xw, layer, cfg, key_mask, bias), b, gh, gw, ws, dims)
    return torch.cat([_attention(x[:, :1], layer, cfg), merged], dim=1)


def _pos_embed_for_grid(pos_embed: torch.Tensor, gh: int, gw: int) -> torch.Tensor:
    """Absolute position embeddings for a (gh, gw) patch grid: patch
    entries bicubically resampled (HF BeitEmbeddings.interpolate_pos_encoding),
    the CLS entry unchanged."""
    n_pos = pos_embed.shape[0] - 1
    if n_pos == gh * gw:
        return pos_embed
    g0 = int(math.isqrt(n_pos))
    d = pos_embed.shape[1]
    patch = pos_embed[1:].reshape(g0, g0, d).permute(2, 0, 1)
    patch = resize_bicubic(patch, gh, gw)
    patch = patch.permute(1, 2, 0).reshape(gh * gw, d)
    return torch.cat([pos_embed[:1], patch], dim=0)


def _gather_rel_bias(table: torch.Tensor, grid: int, ws: int) -> torch.Tensor:
    """Contiguous fp32 bias [heads, n, n] from a table [entries, heads] at
    the index of a (grid, grid) patch grid + CLS (ws 0) or of one ws x ws
    window (the flash kernels' layout, so they copy nothing; JAX
    ``vit.py:595``), differentiable in the table."""
    return _RelBiasGather.apply(table, grid, ws)


def _rel_table_for_grid(table: torch.Tensor, g0: int, g: int) -> torch.Tensor:
    """A relative-position bias table trained at grid g0 for a (g, g)
    grid (HF BeitRelativePositionBias interpolation, JAX ``vit.py:601``):
    the (2g0-1)^2 offset entries bilinearly resized on their
    (2g0-1, 2g0-1) grid, the 3 CLS entries passed through. The resize
    runs in float64: ``F.interpolate`` computes its weights in the input's
    type, and fp32 source coordinates cost up to some 20 ulps of the
    table (the JAX package builds its weights in float64)."""
    if g == g0:
        return table
    heads = table.shape[1]
    old, new = 2 * g0 - 1, 2 * g - 1
    patch = table[:-3].reshape(old, old, heads).permute(2, 0, 1).double()
    patch = resize_bilinear(patch, new, new).to(table.dtype)
    patch = patch.permute(1, 2, 0).reshape(new * new, heads)
    return torch.cat([patch, table[-3:]], dim=0)


def _layer_rel_bias(
    layer: dict, cfg: ViTConfig, grid: int, ws: int, shared_bias: torch.Tensor | None,
) -> torch.Tensor | None:
    """A layer's attention bias over the whole grid (ws 0) or one window:
    its own table, resampled to the grid and gathered, added onto the
    shared bias, if any (JAX ``vit.py:621``)."""
    bias = shared_bias
    if "rel_pos_table" in layer:
        own = _gather_rel_bias(
            _rel_table_for_grid(layer["rel_pos_table"], cfg.grid_size, grid), grid, ws)
        bias = own if bias is None else own + bias
    return bias


def encoder_block(
    x: torch.Tensor, layer: dict, cfg: ViTConfig, window: tuple[int, int] | None = None,
    bias: torch.Tensor | None = None, key_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """One pre-LN block: attention + MLP with BEiT layer scale.
    ``window`` = the patch grid (gh, gw) restricts the attention to
    ``cfg.window_size`` windows; None = full attention. ``bias``: the
    layer's relative-position bias [H, n, n] over the grid + CLS, or over
    one window, or None. ``key_mask`` [rows, n]: the keys full attention
    drops (``pad_tokens_to``'s padding)."""
    x_ln = _layer_norm(x, layer["ln1"], cfg.layer_norm_eps)
    if window is None:
        attn = _attention(x_ln, layer, cfg, key_mask, bias)
    else:
        attn = _windowed_attention(x_ln, layer, cfg, *window, bias=bias)
    x = x + attn * layer["lambda_1"].to(attn.dtype)
    y = _layer_norm(x, layer["ln2"], cfg.layer_norm_eps)
    y = _linear(y, layer["mlp_in"])
    y = F.gelu(y.float()).to(y.dtype)
    y = _linear(y, layer["mlp_out"])
    return x + y * layer["lambda_2"].to(y.dtype)


_SAVED_BY_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """"dots": the outputs of the non-batched matmuls (the layer's qkv,
    attn_out, mlp_in and mlp_out projections) are saved for the backward;
    everything else runs again (JAX ``dots_with_no_batch_dims_saveable``)."""
    if op in _SAVED_BY_DOTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def vit_forward(
    params: dict,
    pixels: torch.Tensor,
    cfg: ViTConfig,
    taps: Sequence[int] = (),
    compute_dtype: torch.dtype = torch.float32,
    remat: bool = False,
    remat_policy: str = "full",
) -> list[torch.Tensor]:
    """Run the encoder on normalized pixels [B, C, H, W] (H, W multiples
    of the patch size); return hidden states [B, 1+P, D] at ``taps``
    (empty -> [final]). Windows apply only where they are smaller than
    the grid, so a window that covers it changes nothing. Relative-
    position tables (``rel_pos_table`` per layer, ``shared_rel_pos_table``)
    need a square grid; the windowed layers gather them at within-window
    offsets. ``remat``: each layer under ``torch.utils.checkpoint`` while
    grad is enabled, by ``remat_policy`` ("full" or "dots"); a layer's own
    bias is gathered inside it, the shared table's outside, as in JAX."""
    if remat_policy not in ("full", "dots"):  # JAX vit.py:893-896
        raise ValueError(f"unknown remat_policy {remat_policy!r}; use 'full' or 'dots'")
    taps = tuple(taps) or (cfg.num_hidden_layers,)
    _, _, img_h, img_w = pixels.shape
    gh, gw = img_h // cfg.patch_size, img_w // cfg.patch_size
    x = _linear(patchify(pixels, cfg.patch_size).to(compute_dtype), params["patch_embed"])
    b = x.shape[0]
    cls = params["cls_token"].to(compute_dtype).expand(b, 1, cfg.hidden_size)
    x = torch.cat([cls, x], dim=1)
    if "pos_embed" in params:
        x = x + _pos_embed_for_grid(params["pos_embed"], gh, gw).to(compute_dtype)

    win_active = 0 < cfg.window_size < max(gh, gw)
    # the window size per layer kind: 0 for the global layers
    kinds = {li: cfg.window_size if win_active and not cfg.is_global_layer(li) else 0
             for li in range(1, len(params["layers"]) + 1)}
    rel_pos = "shared_rel_pos_table" in params or any(
        "rel_pos_table" in layer for layer in params["layers"])
    if rel_pos and gh != gw:
        raise ValueError("relative position bias requires a square patch grid "
                         f"(got {gh}x{gw}); absolute-pos models handle any grid")
    shared = {}
    if "shared_rel_pos_table" in params:  # gathered once per layer kind
        table = _rel_table_for_grid(params["shared_rel_pos_table"], cfg.grid_size, gh)
        shared = {ws: _gather_rel_bias(table, gh, ws) for ws in set(kinds.values())}

    # pad_tokens_to (JAX vit.py:829-846): the token axis padded once, the
    # padding dropped from every softmax row by a key mask [1, n]
    n_real = x.shape[1]
    key_mask = None
    if cfg.pad_tokens_to > n_real and not win_active:
        x = F.pad(x, (0, 0, 0, cfg.pad_tokens_to - n_real))
        key_mask = (torch.arange(cfg.pad_tokens_to, device=x.device) < n_real)[None]

    def run_layer(x, layer, ws):
        bias = None
        if rel_pos:
            bias = _layer_rel_bias(layer, cfg, gh, ws, shared.get(ws))
            if bias is not None and key_mask is not None:  # zeros on the padding
                pad = key_mask.shape[1] - bias.shape[-1]
                bias = F.pad(bias, (0, pad, 0, pad))
        return encoder_block(x, layer, cfg, (gh, gw) if ws else None, bias, key_mask)

    if remat and torch.is_grad_enabled():
        context = {}
        if remat_policy == "dots":
            context["context_fn"] = functools.partial(
                create_selective_checkpoint_contexts, _dots_policy)
        layer_fn = functools.partial(checkpoint, run_layer, use_reentrant=False, **context)
    else:
        layer_fn = run_layer

    collected: dict[int, torch.Tensor] = {}
    if 0 in taps:
        collected[0] = x
    for li, layer in enumerate(params["layers"], start=1):
        x = layer_fn(x, layer, kinds[li])
        if li in taps:
            collected[li] = x
    if key_mask is not None:  # crop pad_tokens_to's padding
        return [collected[t][:, :n_real] for t in taps]
    return [collected[t] for t in taps]
