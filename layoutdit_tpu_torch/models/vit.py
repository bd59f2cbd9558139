"""DiT/BEiT ViT encoder, dense path (port of ``layoutdit_tpu/models/vit.py``).

Plain functions over a parameter dictionary, as in the JAX package:
patchify with (c, kh, kw) flattening and a linear over it, a CLS token,
absolute position embeddings (bicubically resampled for grids other
than the trained one), pre-LN blocks with eps 1e-12 and fp32 statistics,
a fused QKV projection whose K part has no bias, layer scale, and
``hidden_states`` taps (0 = embedding output, i = output of layer i).

Attention goes to the port's kernels: N <= 256 to the short kernel,
longer sequences to the flash kernel, both differentiable (on the CPU
both wrappers run their plain versions). That departs on purpose from
the JAX package's XLA-below-2048-tokens routing, which was measured on a
TPU. The projection and MLP matmuls stay ``torch`` matmuls, as the JAX
package leaves them to XLA.

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
import math
from typing import Sequence

import torch
import torch.nn.functional as F

from layoutdit_tpu_torch.ops.flash_attention import flash_attention_qkv
from layoutdit_tpu_torch.ops.interpolate import resize_bicubic
from layoutdit_tpu_torch.ops.short_attention import MAX_N as SHORT_MAX_N
from layoutdit_tpu_torch.ops.short_attention import (
    short_attention_plain,
    short_attention_qkv,
    split_qkv,
)


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
    # ViTDet windows: 0 = full attention in every layer; W > 0 = W x W
    # patch windows in the layers that are not global. global_attn_layers
    # are 1-based; empty = the tap layers [L/3, L/2, 2L/3, L].
    window_size: int = 0
    global_attn_layers: tuple[int, ...] = ()

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


def _trunc_normal(shape, std, generator, device) -> torch.Tensor:
    t = torch.empty(shape, dtype=torch.float32, device=device)
    return torch.nn.init.trunc_normal_(
        t, std=std, a=-2.0 * std, b=2.0 * std, generator=generator
    )


def _zeros(shape, device) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.float32, device=device)


def init_vit_params(cfg: ViTConfig, generator: torch.Generator, device) -> dict:
    """Random init with the JAX package's distributions (trunc-normal
    0.02 weights, zero biases, zero CLS and position embeddings, layer
    scale ``layer_scale_init_value``). Linear weights are [out, in]."""
    d, i = cfg.hidden_size, cfg.intermediate_size
    patch_in = cfg.num_channels * cfg.patch_size * cfg.patch_size
    std = cfg.initializer_range

    def lin(n_in, n_out, bias=True):
        p = {"weight": _trunc_normal((n_out, n_in), std, generator, device)}
        if bias:
            p["bias"] = _zeros((n_out,), device)
        return p

    layers = []
    for _ in range(cfg.num_hidden_layers):
        layers.append({
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
        })
    return {
        "cls_token": _zeros((d,), device),
        "patch_embed": lin(patch_in, d),
        "pos_embed": _zeros((cfg.num_patches + 1, d), device),
        "layers": layers,
    }


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


def attention_core(
    qkv: torch.Tensor, heads: int, key_mask: torch.Tensor | None = None
) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v from the fused projection [B, N, 3*H*D]
    -> [B, N, H, D], differentiable: the short kernels for N <= 256, the
    flash kernels beyond. ``key_mask`` [B, N] bool drops the False keys
    from every softmax row (padded window slots); only the plain version
    takes one, so a CUDA tensor with a mask raises."""
    scale = 1.0 / math.sqrt(qkv.shape[-1] // (3 * heads))
    if key_mask is not None:
        if qkv.device.type != "cpu":
            raise NotImplementedError(
                "windows over a grid the window size does not divide need a key mask in "
                "the short-attention kernels, which they do not take yet (ROADMAP.md, "
                "queue 1: a key mask in the short kernels); use a window size that "
                "divides the patch grid"
            )
        return short_attention_plain(*split_qkv(qkv, heads), scale=scale, key_mask=key_mask)
    if qkv.shape[1] <= SHORT_MAX_N:
        return short_attention_qkv(qkv, heads, scale=scale)
    return flash_attention_qkv(qkv, heads, scale=scale)


def _attention(
    x: torch.Tensor, layer: dict, cfg: ViTConfig, key_mask: torch.Tensor | None = None
) -> torch.Tensor:
    b, n, d = x.shape
    qkv = _linear(x, layer["qkv"])  # [B, N, 3D]
    ctx = attention_core(qkv, cfg.num_attention_heads, key_mask)
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


def _windowed_attention(
    x: torch.Tensor, layer: dict, cfg: ViTConfig, gh: int, gw: int
) -> torch.Tensor:
    """Attention restricted to ws x ws patch windows (JAX ``vit.py:238``).
    x is the post-LN [B, 1+gh*gw, D] stream. The CLS token is in no
    window: it attends to itself alone (a 1-token sequence through the
    same projections), and patch tokens do not see it. Padded window
    slots are masked out of the softmax."""
    b = x.shape[0]
    ws = cfg.window_size
    xw, dims = _window_partition(x[:, 1:], gh, gw, ws)
    key_mask = _window_key_mask(gh, gw, ws)
    if key_mask is not None:
        key_mask = key_mask.to(x.device).repeat(b, 1)
    merged = _window_merge(_attention(xw, layer, cfg, key_mask), b, gh, gw, ws, dims)
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


def encoder_block(
    x: torch.Tensor, layer: dict, cfg: ViTConfig, window: tuple[int, int] | None = None
) -> torch.Tensor:
    """One pre-LN block: attention + MLP with BEiT layer scale.
    ``window`` = the patch grid (gh, gw) restricts the attention to
    ``cfg.window_size`` windows; None = full attention."""
    x_ln = _layer_norm(x, layer["ln1"], cfg.layer_norm_eps)
    if window is None:
        attn = _attention(x_ln, layer, cfg)
    else:
        attn = _windowed_attention(x_ln, layer, cfg, *window)
    x = x + attn * layer["lambda_1"].to(attn.dtype)
    y = _layer_norm(x, layer["ln2"], cfg.layer_norm_eps)
    y = _linear(y, layer["mlp_in"])
    y = F.gelu(y.float()).to(y.dtype)
    y = _linear(y, layer["mlp_out"])
    return x + y * layer["lambda_2"].to(y.dtype)


def vit_forward(
    params: dict,
    pixels: torch.Tensor,
    cfg: ViTConfig,
    taps: Sequence[int] = (),
    compute_dtype: torch.dtype = torch.float32,
) -> list[torch.Tensor]:
    """Run the encoder on normalized pixels [B, C, H, W] (H, W multiples
    of the patch size); return hidden states [B, 1+P, D] at ``taps``
    (empty -> [final]). Windows apply only where they are smaller than
    the grid, so a window that covers it changes nothing."""
    taps = tuple(taps) or (cfg.num_hidden_layers,)
    _, _, img_h, img_w = pixels.shape
    gh, gw = img_h // cfg.patch_size, img_w // cfg.patch_size
    x = _linear(patchify(pixels, cfg.patch_size).to(compute_dtype), params["patch_embed"])
    b = x.shape[0]
    cls = params["cls_token"].to(compute_dtype).expand(b, 1, cfg.hidden_size)
    x = torch.cat([cls, x], dim=1)
    x = x + _pos_embed_for_grid(params["pos_embed"], gh, gw).to(compute_dtype)

    win_active = 0 < cfg.window_size < max(gh, gw)
    collected: dict[int, torch.Tensor] = {}
    if 0 in taps:
        collected[0] = x
    for li, layer in enumerate(params["layers"], start=1):
        windowed = win_active and not cfg.is_global_layer(li)
        x = encoder_block(x, layer, cfg, (gh, gw) if windowed else None)
        if li in taps:
            collected[li] = x
    return [collected[t] for t in taps]
