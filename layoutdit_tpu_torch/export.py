"""Export a detector to a self-contained serving artifact, and load one
(port of ``layoutdit_tpu/export.py``).

``export_detector`` traces ``detector_predict`` + ``rescale_detections``
per serving bucket with ``torch.export`` (under ``torch.no_grad()``) and
saves each program with ``torch.export.save``; the weights ride along as
a flat ``.npz``. ``ExportedDetector`` loads the artifact with torch,
numpy and ``layoutdit_tpu_torch.ops`` alone (the registered operators
the programs name), no model, config or eval code.

Artifact layout (one directory, local or a ``scheme://`` URL)::

    manifest.json        format, image_sizes, batch_size, num_leaves,
                         num_classes, device, compute_dtype, leaf_dtypes,
                         torch_version, export_seconds
    params.npz           flat parameter leaves, insertion order: float32,
                         and an int8 model's int8 codes
    predict_<size>.pt2   one exported program per serving bucket

Each program's signature is ``(leaves: list[Tensor], images:
f32[B, 3, S, S], orig: f32[B, 2]) -> {"boxes", "scores", "labels",
"valid"}``, boxes rescaled to page coordinates (``eval/serving.py``). The
leaves enter in the dtypes the live engine gives them
(``params_for_inference``: the compute dtype, LayerNorm and position
tables in float32, an int8 linear's codes in int8 with its scales and
bias in float32), listed as ``leaf_dtypes``. An int8 model
(``ops/quant.py``, quantized before the trace) exports its W8A8 linears
as ``aten._int_mm`` calls on those int8 leaves.

Where the JAX package writes StableHLO with ``platforms``, a program
here is traced for one ``device``: a ``cuda`` artifact is traced on the
card and calls the kernels' operators (``layoutdit_torch::short_attention``,
``::flash_attention_fwd``, ``::roi_align_fwd``), a ``cpu`` artifact holds
their plain versions; both call ``layoutdit_torch::nms_fixpoint``. An
artifact loads only on the device it was traced for.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import time
from typing import Sequence

import numpy as np
import torch

# the registered operators the programs name (imported for registration)
from layoutdit_tpu_torch.ops import flash_attention as _flash  # noqa: F401
from layoutdit_tpu_torch.ops import nms as _nms  # noqa: F401
from layoutdit_tpu_torch.ops import roi_align as _roi  # noqa: F401
from layoutdit_tpu_torch.ops import short_attention as _short  # noqa: F401
from layoutdit_tpu_torch.utils.paths import join_path, open_path

FORMAT = "layoutdit_tpu_torch.export.v1"
OUTPUTS = ("boxes", "scores", "labels", "valid")


class _Predict(torch.nn.Module):
    """One bucket's function of the flat leaves (what is exported)."""

    def __init__(self, template: dict, cfg, size: int):
        super().__init__()
        self.template, self.cfg, self.size = template, cfg, size

    def forward(self, leaves: list[torch.Tensor], images: torch.Tensor,
                orig: torch.Tensor) -> dict[str, torch.Tensor]:
        from layoutdit_tpu_torch.models.detection.detector import (
            detector_predict,
            rescale_detections,
        )
        from layoutdit_tpu_torch.models.weights_io import tree_map

        it = iter(leaves)
        params = tree_map(lambda _: next(it), self.template)
        dets = rescale_detections(detector_predict(params, images, self.cfg), orig, self.size)
        return {k: getattr(dets, k) for k in OUTPUTS}


def _device(device: str | torch.device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' for a CPU artifact")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


def export_detector(
    params: dict,
    cfg,
    path: str,
    image_sizes: Sequence[int] = (224,),
    batch_size: int = 8,
    device: str | torch.device = "cuda",
) -> dict:
    """Export ``detector_predict`` buckets of ``cfg`` (a ``DetectorConfig``)
    with ``params`` to ``path``, traced on ``device``; returns the
    manifest. The programs hold the compute dtype of ``cfg``."""
    from layoutdit_tpu_torch.models.detection.detector import params_for_inference
    from layoutdit_tpu_torch.models.weights_io import tree_leaves, tree_map

    device = _device(device)
    host = tree_map(lambda t: t.detach().to("cpu", torch.float32 if t.is_floating_point()
                                            else t.dtype), params)
    live = params_for_inference(tree_map(lambda t: t.to(device), host), cfg.dtype)
    leaves = tree_leaves(live)
    seconds = {}
    for size in image_sizes:
        t0 = time.perf_counter()
        program = _Predict(live, dataclasses.replace(cfg, image_size=size), size)
        example = (leaves, torch.zeros(batch_size, 3, size, size, device=device),
                   torch.ones(batch_size, 2, device=device))
        with torch.no_grad():
            exported = torch.export.export(program, example)
        exported.example_inputs = None  # else every program would carry the weights again
        with open_path(join_path(path, f"predict_{size}.pt2"), "wb") as f:
            torch.export.save(exported, f)
        seconds[str(size)] = time.perf_counter() - t0
    with open_path(join_path(path, "params.npz"), "wb") as f:
        np.savez(f, **{str(i): t.numpy() for i, t in enumerate(tree_leaves(host))})
    manifest = {
        "format": FORMAT,
        "image_sizes": [int(s) for s in image_sizes],
        "batch_size": int(batch_size),
        "num_leaves": len(leaves),
        "num_classes": int(cfg.num_classes),
        "device": device.type,
        "compute_dtype": cfg.compute_dtype,
        "leaf_dtypes": [str(t.dtype).removeprefix("torch.") for t in leaves],
        "torch_version": torch.__version__,
        "export_seconds": seconds,  # trace and save, per bucket
    }
    with open_path(join_path(path, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)
    return manifest


def constants_on(module: torch.fx.GraphModule, device: torch.device) -> torch.fx.GraphModule:
    """``module`` (an exported program's runnable module) with its lifted
    constants (the anchors, the pyramid's resize matrices, the
    normalisation) moved to ``device`` once. The traced program keeps them
    on the host and copies each to the device on every call; a copy from
    pageable memory first waits for the stream to drain, so each one
    stalls the host's launches (PERF.md §6). What the graph does
    with them stays: its per-call copy becomes a device-to-device one. The
    checks of their host placement go."""
    for node in list(module.graph.nodes):
        if node.op != "get_attr":
            continue
        value = getattr(module, node.target)
        if not isinstance(value, torch.Tensor) or value.device == device:
            continue
        setattr(module, node.target, value.to(device))
        for copy in list(node.users):
            for user in list(copy.users):
                if user.target is torch.ops.aten._assert_tensor_metadata.default:
                    module.graph.erase_node(user)
    module.graph.lint()
    module.recompile()
    return module


class ExportedDetector:
    """Loads and runs an exported artifact; no model code involved.

    ``predict(images, orig_sizes)`` routes on the image size and returns
    numpy ``{"boxes", "scores", "labels", "valid"}``; inputs must have the
    exported ``batch_size`` (pad the tail batch). ``device`` defaults to
    the artifact's; another device raises, as does a directory of another
    format.
    """

    def __init__(self, path: str, device: str | torch.device | None = None):
        with open_path(join_path(path, "manifest.json"), "r") as f:
            manifest = json.load(f)
        if manifest.get("format") != FORMAT:
            raise ValueError(f"{path} is not a {FORMAT} artifact "
                             f"(format {manifest.get('format')!r})")
        traced = torch.device(manifest["device"])
        self.device = _device(traced if device is None else device)
        if self.device.type != traced.type:
            raise ValueError(f"{path} was exported for {traced.type}; it cannot run on "
                             f"{self.device.type} (export it again with that device)")
        self.manifest = manifest
        with open_path(join_path(path, "params.npz"), "rb") as f:
            npz = np.load(f)
            # moved and cast once here, never per call
            self._leaves = [
                torch.from_numpy(npz[str(i)]).to(self.device, getattr(torch, dtype))
                for i, dtype in enumerate(manifest["leaf_dtypes"])
            ]
        if len(self._leaves) != manifest["num_leaves"]:
            raise ValueError(f"{path}: {len(self._leaves)} leaves, the manifest says "
                             f"{manifest['num_leaves']}")
        self._fns = {}
        for size in manifest["image_sizes"]:
            with open_path(join_path(path, f"predict_{size}.pt2"), "rb") as f:
                self._fns[int(size)] = constants_on(torch.export.load(f).module(), self.device)
        # A loaded dit-base program is some 150k Python objects (its graph's
        # nodes), which each full collection of the cyclic garbage collector
        # walks: about 200 ms a program, a stall in whatever request the
        # collection lands in (PERF.md §6). Freezing moves every
        # object alive now, the programs included, out of the collector's
        # reach; they stay alive, as a server's programs do.
        gc.freeze()

    @property
    def image_sizes(self) -> list[int]:
        return list(self._fns)

    def predict_async(self, images, orig_sizes) -> dict[str, torch.Tensor]:
        """Like ``predict`` but returns the device tensors without waiting
        for them (the serving engine fetches its batches behind)."""
        size = int(images.shape[-1])
        if size not in self._fns:
            raise ValueError(f"no exported bucket for size {size}; have {self.image_sizes}")
        images = torch.as_tensor(images).to(self.device, torch.float32)
        orig = torch.as_tensor(orig_sizes).to(self.device, torch.float32)
        with torch.no_grad():
            return self._fns[size](self._leaves, images, orig)

    def predict(self, images, orig_sizes) -> dict[str, np.ndarray]:
        out = self.predict_async(images, orig_sizes)
        return {k: v.cpu().numpy() for k, v in out.items()}
