"""Offline conversion of an HF DiT/BEiT checkpoint to the converted
``.msgpack`` format (port of ``layoutdit_tpu/tools/convert_hf_checkpoint.py``).

    python -m layoutdit_tpu_torch.tools.convert_hf_checkpoint \\
        /path/to/pytorch_model.bin --preset dit-base --out dit-base.msgpack

The source state_dict (``.bin`` / ``.pth`` through
``torch.load(weights_only=True)``; ``.safetensors`` when the
``safetensors`` package is installed) is checked key for key, names and
shapes, against the preset's manifest, of which the package keeps its
own copy (``layoutdit_tpu_torch/manifests/``). The output is the JAX
converter's format: the JAX encoder tree in a ``.msgpack`` checkpoint
with ``extra={"preset", "kind": "vit_encoder"}``, so a file converted by
either package warm-starts the other, plus a ``.provenance.json`` with
the SHA-256 of source and output. ``LAYOUTDIT_DIT_{BASE,LARGE}_PTH``
(legacy alias ``LAYOUTDIT_DIT_BASE_CKPT``) names a local checkpoint
used when no source is given, and by the model's warm start
(``models/model.py``).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os

from layoutdit_tpu_torch.log import get_logger

logger = get_logger(__name__)

# keys of the HF checkpoint outside the backbone's tap path
IGNORABLE = ("pooler.", "embeddings.mask_token", "layernorm.")
PRESETS = {"dit-base", "dit-large"}
CKPT_ENV = {"dit-base": "LAYOUTDIT_DIT_BASE_PTH", "dit-large": "LAYOUTDIT_DIT_LARGE_PTH"}
MANIFEST_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                            "manifests")


def local_checkpoint(preset: str = "dit-base") -> str | None:
    """The local HF checkpoint of ``preset`` that
    ``LAYOUTDIT_DIT_{BASE,LARGE}_PTH`` (or, for dit-base, the legacy
    ``LAYOUTDIT_DIT_BASE_CKPT``) names, if that file exists."""
    names = [CKPT_ENV[preset]] + (["LAYOUTDIT_DIT_BASE_CKPT"] if preset == "dit-base" else [])
    for name in names:
        path = os.environ.get(name)
        if path and os.path.exists(path):
            return path
    return None


def preset_config(preset: str):
    from layoutdit_tpu_torch.models import vit as vit_mod

    return vit_mod.DIT_LARGE if preset == "dit-large" else vit_mod.DIT_BASE


def expected_manifest(preset: str) -> dict[str, list[int]]:
    """The HF ``BeitModel`` state_dict (names and shapes) that the preset's
    architecture implies: the structural oracle for the manifests."""
    cfg = preset_config(preset)
    d, m = cfg.hidden_size, cfg.intermediate_size
    p, c = cfg.patch_size, cfg.num_channels
    keys: dict[str, list[int]] = {
        "embeddings.cls_token": [1, 1, d],
        "embeddings.mask_token": [1, 1, d],
        "embeddings.patch_embeddings.projection.weight": [d, c, p, p],
        "embeddings.patch_embeddings.projection.bias": [d],
        "embeddings.position_embeddings": [1, 1 + (cfg.image_size // p) ** 2, d],
        "pooler.layernorm.weight": [d],
        "pooler.layernorm.bias": [d],
    }
    for i in range(cfg.num_hidden_layers):
        pre = f"encoder.layer.{i}."
        att = pre + "attention.attention."
        keys.update({
            att + "query.weight": [d, d], att + "query.bias": [d],
            att + "key.weight": [d, d],  # BEiT's key has no bias
            att + "value.weight": [d, d], att + "value.bias": [d],
            pre + "attention.output.dense.weight": [d, d],
            pre + "attention.output.dense.bias": [d],
            pre + "intermediate.dense.weight": [m, d], pre + "intermediate.dense.bias": [m],
            pre + "output.dense.weight": [d, m], pre + "output.dense.bias": [d],
            pre + "layernorm_before.weight": [d], pre + "layernorm_before.bias": [d],
            pre + "layernorm_after.weight": [d], pre + "layernorm_after.bias": [d],
            pre + "lambda_1": [d], pre + "lambda_2": [d],
        })
    return keys


def manifest_path(preset: str) -> str:
    return os.path.join(MANIFEST_DIR, f"{preset}_hf_manifest.json")


def _strip(k: str) -> str:
    for pre in ("beit.", "dit.", "model."):
        if k.startswith(pre):
            return k[len(pre):]
    return k


def validate_state_dict(sd: dict, preset: str) -> list[str]:
    """Check names and shapes against the preset's manifest. Returns the
    ignored (non-backbone) keys; raises ValueError on a missing key, an
    unexpected one or a shape mismatch."""
    with open(manifest_path(preset)) as f:
        manifest = json.load(f)["keys"]
    got = {_strip(k): tuple(v.shape) for k, v in sd.items()}
    problems, ignored = [], []
    for key, shape in manifest.items():
        if any(s in key for s in IGNORABLE):
            if key in got:
                ignored.append(key)
            continue
        if key not in got:
            problems.append(f"missing: {key}")
        elif got[key] != tuple(shape):
            problems.append(f"shape {key}: got {got[key]}, want {tuple(shape)}")
    for key in got:
        if key not in manifest:
            if any(s in key for s in IGNORABLE):
                ignored.append(key)
            else:
                problems.append(f"unexpected: {key}")
    if problems:
        raise ValueError(f"state_dict does not match the {preset} manifest "
                         f"({len(problems)} problems):\n  " + "\n  ".join(problems[:20]))
    return ignored


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def read_state_dict(src: str) -> dict:
    """An HF state_dict from ``.bin`` / ``.pth`` (weights only) or
    ``.safetensors`` (needs the safetensors package)."""
    import torch

    if src.endswith(".safetensors"):
        try:
            from safetensors.torch import load_file
        except ImportError as e:
            raise ImportError(f"{src}: reading .safetensors needs the safetensors package; "
                              "save the state_dict as .pth elsewhere") from e
        return load_file(src)
    return torch.load(src, map_location="cpu", weights_only=True)


def convert(src: str, preset: str, out: str) -> dict:
    """Validate ``src`` against the manifest, write ``out`` (+
    ``.provenance.json``) and return the provenance record."""
    from layoutdit_tpu_torch.models.weights_io import (
        beit_state_dict_to_params,
        vit_params_to_jax,
    )
    from layoutdit_tpu_torch.train.checkpoint import save_jax_params

    sd = read_state_dict(src)
    ignored = validate_state_dict(sd, preset)
    logger.info("Validated %d keys against the %s manifest (%d non-backbone keys ignored)",
                len(sd), preset, len(ignored))
    params = vit_params_to_jax(beit_state_dict_to_params(sd, preset_config(preset)))
    save_jax_params(out, params, extra={"preset": preset, "kind": "vit_encoder"})
    prov = {
        "preset": preset,
        "source": os.path.abspath(src),
        "source_sha256": _sha256(src),
        "output_sha256": _sha256(out),
        "n_source_keys": len(sd),
        "ignored_keys": sorted(ignored),
    }
    with open(out + ".provenance.json", "w") as f:
        json.dump(prov, f, indent=1)
    logger.info("Wrote %s (+.provenance.json)", out)
    return prov


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="Convert an HF DiT/BEiT checkpoint")
    ap.add_argument("src", nargs="?", default=None,
                    help="HF state_dict (.bin/.pth/.safetensors); defaults to "
                         "$LAYOUTDIT_DIT_{BASE,LARGE}_PTH for the chosen preset")
    ap.add_argument("--preset", choices=sorted(PRESETS), default="dit-base")
    ap.add_argument("--out", required=True, help="output .msgpack path")
    args = ap.parse_args(argv)
    src = args.src or local_checkpoint(args.preset)
    if not src:
        ap.error(f"no source checkpoint: pass a path or set {CKPT_ENV[args.preset]}")
    return convert(src, args.preset, args.out)


if __name__ == "__main__":
    main()
