"""Activation checkpointing of the port's encoder (``remat``, "full" and
"dots") against the encoder without it, on the CPU: the same taps and
gradients bit for bit (windows over a padded grid, relative-position
tables per layer and shared, ``pad_tokens_to``), the bytes the forward
leaves alive for the backward ordered full < dots < off, nothing changed
under ``no_grad``, and the detector's loss taking ``remat`` from its
config."""

import os

import numpy as np
import pytest
import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as pytree_leaves

from layoutdit_tpu_torch.config import DetectionBudget, ModelConfig
from layoutdit_tpu_torch.models import vit as port_vit
from layoutdit_tpu_torch.models.weights_io import tree_leaves, tree_map

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

SMALL = dict(hidden_size=64, num_attention_heads=4, intermediate_size=128)
ARMS = [(False, "full"), (True, "full"), (True, "dots")]
CONFIGS = {
    # an 8 x 8 grid in windows of 3 (padded to 9 x 9: the masked short
    # path), layers 1 and 3 windowed, 2 and 4 global
    "windows_padded": dict(SMALL, num_hidden_layers=4, patch_size=8, image_size=64,
                           window_size=3, global_attn_layers=(2, 4)),
    # per-layer and shared tables over windows that divide the grid: each
    # layer's own bias gathered inside its checkpointed region
    "rel_pos_windows": dict(SMALL, num_hidden_layers=3, patch_size=8, image_size=64,
                            window_size=4, global_attn_layers=(2,),
                            use_absolute_position_embeddings=False,
                            use_relative_position_bias=True,
                            use_shared_relative_position_bias=True),
    "pad_tokens_to": dict(SMALL, num_hidden_layers=2, patch_size=8, image_size=64,
                          pad_tokens_to=72),
}


def _params(cfg, seed=0):
    gen = torch.Generator().manual_seed(seed)
    params = port_vit.init_vit_params(cfg, gen, "cpu")
    with torch.no_grad():  # random (not zero) embeddings and tables, so that they count
        for t in [params.get("pos_embed"), params.get("shared_rel_pos_table")] + [
                layer.get("rel_pos_table") for layer in params["layers"]]:
            if t is not None:
                t.copy_(0.5 * torch.randn(t.shape, generator=gen))
    return params


def _pixels(cfg, b=2, seed=1):
    rng = np.random.default_rng(seed)
    size = cfg.image_size
    return torch.from_numpy(rng.uniform(-1, 1, (b, 3, size, size)).astype(np.float32))


def _taps_and_grads(params, x, cfg, remat, policy):
    p = tree_map(lambda t: t.detach().clone().requires_grad_(True), params)
    taps = tuple(range(1, cfg.num_hidden_layers + 1))
    outs = port_vit.vit_forward(p, x, cfg, taps=taps, remat=remat, remat_policy=policy)
    gen = torch.Generator().manual_seed(2)
    loss = sum((o * torch.randn(o.shape, generator=gen)).sum() for o in outs)
    return [o.detach() for o in outs], torch.autograd.grad(loss, tree_leaves(p))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_remat_arms_give_equal_gradients(name):
    """Off, "full" and "dots" run the same operations on the same inputs,
    so the taps and every gradient leaf are the same bits."""
    cfg = port_vit.ViTConfig(**CONFIGS[name])
    params, x = _params(cfg), _pixels(cfg)
    want_taps, want_grads = _taps_and_grads(params, x, cfg, False, "full")
    for remat, policy in ARMS[1:]:
        taps, grads = _taps_and_grads(params, x, cfg, remat, policy)
        assert all(torch.equal(a, b) for a, b in zip(taps, want_taps)), policy
        assert len(grads) == len(want_grads)
        for i, (a, b) in enumerate(zip(grads, want_grads)):
            assert torch.equal(a, b), (policy, i)


class _LiveBytes(TorchDispatchMode):
    """Records the storage of every tensor an operation makes; ``live()``
    is the bytes of those still alive (the inputs' own storages apart):
    after a forward whose outputs were reduced to a scalar, what the
    autograd graph (the checkpoints' and selective checkpointing's own
    stores included) holds for the backward. ``saved_tensors_hooks`` cannot count it: inside a
    checkpointed region the checkpoint's own hooks take the saved tensors,
    and selective checkpointing keeps its saves in a store of its own."""

    def __init__(self, inputs):
        super().__init__()
        self.inputs = {t.untyped_storage()._cdata for t in inputs}  # views of them are free
        self.storages = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in pytree_leaves(out):
            if isinstance(t, torch.Tensor):
                st = t.untyped_storage()
                if st._cdata not in self.inputs:
                    self.storages.setdefault(st._cdata, (StorageWeakRef(st), st.nbytes()))
        return out

    def live(self) -> int:
        return sum(n for ref, n in self.storages.values() if not ref.expired())


def _saved_bytes(params, x, cfg, remat, policy) -> int:
    p = tree_map(lambda t: t.detach().clone().requires_grad_(True), params)
    taps = tuple(range(1, cfg.num_hidden_layers + 1))
    with _LiveBytes(tree_leaves(p) + [x]) as mode:
        outs = port_vit.vit_forward(p, x, cfg, taps=taps, remat=remat, remat_policy=policy)
        loss = sum(o.float().sum() for o in outs)
    del outs
    live = mode.live()
    torch.autograd.grad(loss, tree_leaves(p))  # the graph was whole
    return live


def test_saved_bytes_are_ordered():
    """What the forward keeps for the backward: "full" keeps each layer's
    input, "dots" also its four projections' outputs, off everything."""
    cfg = port_vit.ViTConfig(**CONFIGS["windows_padded"])
    params, x = _params(cfg), _pixels(cfg)
    off, full, dots = (_saved_bytes(params, x, cfg, r, p) for r, p in ARMS)
    assert 0 < full < dots < off, (full, dots, off)
    # "full": the 4 layers' [2, 65, 64] fp32 inputs and little else
    assert full < 8 * 2 * 65 * 64 * 4


def test_remat_changes_nothing_without_grad(monkeypatch):
    """Under ``no_grad`` and ``inference_mode`` (serving, eval) remat is
    off: no checkpoint runs, the taps are the same bits, nothing is kept."""
    cfg = port_vit.ViTConfig(**CONFIGS["windows_padded"])
    params, x = _params(cfg), _pixels(cfg)
    with torch.no_grad():
        want = port_vit.vit_forward(params, x, cfg, taps=(1, 2, 3, 4))

    def refuse(*args, **kwargs):
        raise AssertionError("a checkpoint ran without grad")

    monkeypatch.setattr(port_vit, "checkpoint", refuse)
    for context in (torch.no_grad, torch.inference_mode):
        for policy in ("full", "dots"):
            with context():
                got = port_vit.vit_forward(params, x, cfg, taps=(1, 2, 3, 4), remat=True,
                                           remat_policy=policy)
            assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_detector_loss_takes_remat_from_its_config(monkeypatch):
    """``remat``/``remat_policy`` ride from ``ModelConfig`` on
    ``DetectorConfig`` into ``backbone_forward`` and ``vit_forward``: one
    checkpoint a layer, and the loss's gradients the same bits."""
    from layoutdit_tpu_torch.models.detection.detector import (
        DetectorConfig,
        detector_loss,
        draw_priorities,
        init_detector,
    )

    overrides = dict(hidden_size=32, num_hidden_layers=3, num_attention_heads=2,
                     intermediate_size=64)
    calls = []
    real = port_vit.checkpoint

    def counting(*args, **kwargs):
        calls.append(kwargs.get("context_fn") is not None)
        return real(*args, **kwargs)

    monkeypatch.setattr(port_vit, "checkpoint", counting)
    grads = {}
    for remat, policy in ARMS:
        mc = ModelConfig(image_size=64, fpn_out_channels=16, remat=remat, remat_policy=policy,
                         vit_overrides=overrides, detection_budget=DetectionBudget(
                             rpn_pre_nms_top_n_train=200, rpn_post_nms_top_n_train=100,
                             box_batch_size_per_image=32))
        cfg = DetectorConfig.from_model_config(mc)
        assert (cfg.remat, cfg.remat_policy) == (remat, policy)
        params = init_detector(cfg, torch.Generator().manual_seed(0), device="cpu")
        leaves = tree_leaves(params)
        for t in leaves:
            t.requires_grad_(True)
        rng = np.random.default_rng(0)
        images = torch.from_numpy(rng.uniform(0, 1, (2, 3, 64, 64)).astype(np.float32))
        gt_boxes = torch.tensor([[[4.0, 4.0, 40.0, 30.0]], [[10.0, 12.0, 60.0, 50.0]]])
        gt_labels = torch.tensor([[1], [3]])
        gt_valid = torch.ones(2, 1, dtype=torch.bool)
        prio = draw_priorities(cfg, 2, 1, torch.Generator().manual_seed(3))
        calls.clear()
        losses = detector_loss(params, images, gt_boxes, gt_labels, gt_valid, cfg, prio)
        grads[(remat, policy)] = torch.autograd.grad(sum(losses.values()), leaves,
                                                     allow_unused=True)
        assert calls == ([policy == "dots"] * 3 if remat else [])
    want = grads[ARMS[0]]
    for arm in ARMS[1:]:
        for a, b in zip(grads[arm], want):
            assert (a is None and b is None) or torch.equal(a, b), arm
