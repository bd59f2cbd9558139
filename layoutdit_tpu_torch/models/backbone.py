"""DiT backbone -> multi-scale pyramid -> FPN (port of
``layoutdit_tpu/models/backbone.py``).

Taps hidden states at layers [d//3, d//2, 2d//3, d], drops CLS, reshapes
to [B, D, H/16, W/16], applies each level's 1x1 lateral conv and THEN
the bilinear resample by [4x, 2x, 1x, 0.5x] (a 1x1 conv commutes with a
channelwise bilinear resize, and running it at the native grid is ~16x
cheaper for p2), then the FPN top-down path and LastLevelMaxPool.
"""

from __future__ import annotations

import dataclasses

import torch

from layoutdit_tpu_torch.models import vit as vit_mod
from layoutdit_tpu_torch.models.fpn import conv2d, fpn_forward_from_laterals, init_fpn_params
from layoutdit_tpu_torch.models.vit import ViTConfig, init_vit_params, vit_forward
from layoutdit_tpu_torch.ops.interpolate import resize_bilinear_matmul


@dataclasses.dataclass(frozen=True)
class BackboneConfig:
    vit: ViTConfig = vit_mod.DIT_BASE
    fpn_out_channels: int = 256
    scales: tuple[float, ...] = (4.0, 2.0, 1.0, 0.5)

    @property
    def taps(self) -> tuple[int, ...]:
        d = self.vit.num_hidden_layers
        return (d // 3, d // 2, 2 * d // 3, d)

    @property
    def feature_strides(self) -> tuple[int, ...]:
        """Image-pixel stride of each output level p2..p5 + pool."""
        p = self.vit.patch_size
        return tuple(int(p / s) for s in self.scales) + (int(p / self.scales[-1]) * 2,)

    @property
    def spatial_scales(self) -> tuple[float, ...]:
        return tuple(1.0 / s for s in self.feature_strides)


def init_backbone_params(cfg: BackboneConfig, generator: torch.Generator, device) -> dict:
    return {
        "vit": init_vit_params(cfg.vit, generator, device),
        "fpn": init_fpn_params(
            [cfg.vit.hidden_size] * 4, cfg.fpn_out_channels, generator, device
        ),
    }


def backbone_forward(
    params: dict,
    pixels: torch.Tensor,
    cfg: BackboneConfig,
    compute_dtype: torch.dtype = torch.float32,
    remat: bool = False,
    remat_policy: str = "full",
    aux_out: dict | None = None,
    tp=None,
    attention_impl: str = "auto",
    pipeline=None,
) -> list[torch.Tensor]:
    """[B, 3, H, W] normalized pixels -> [p2, p3, p4, p5, pool], each
    [B, C, H_l, W_l] in channels-last memory (channel stride 1; ``pool``
    a strided view of p5), the layout the RoIAlign kernels read.
    ``remat``/``remat_policy``: the encoder's activation checkpointing
    (``vit_forward``); ``aux_out`` receives the encoder's ``"moe_aux"``;
    ``tp`` (a model group), ``attention_impl`` and ``pipeline`` (GPipe
    stages): ``vit_forward``'s, the pyramid replicated over the groups.""" 
    b, _, h, w = pixels.shape
    patch = cfg.vit.patch_size
    gh, gw = h // patch, w // patch
    hidden = vit_forward(
        params["vit"], pixels, cfg.vit, taps=cfg.taps, compute_dtype=compute_dtype,
        remat=remat, remat_policy=remat_policy, aux_out=aux_out, tp=tp,
        attention_impl=attention_impl, pipeline=pipeline,
    )
    laterals = []
    for t, scale, inner in zip(hidden, cfg.scales, params["fpn"]["inner"]):
        # [B, D, gh, gw] as a view of the tokens: channel stride 1, so the
        # convolutions, the resizes and the whole pyramid stay channels-last
        x = t[:, 1:, :].reshape(b, gh, gw, cfg.vit.hidden_size).permute(0, 3, 1, 2)
        x = conv2d(x, inner)
        if scale != 1.0:
            x = resize_bilinear_matmul(x, int(gh * scale), int(gw * scale))
        laterals.append(x)
    return fpn_forward_from_laterals(params["fpn"], laterals, extra_max_pool=True)
