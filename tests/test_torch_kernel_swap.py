"""``tools/kernel_swap.py``, the diagnosis of the card's ``table`` gap: its
swap reaches the autograd functions' lookups and is undone, a swapped
wrapper is the one a traced program calls (fake CUDA inputs: no kernel
operator of the swapped rows in the graph), and its rule gives the
verdicts recorded in ``PERF.md`` §7 on the thirty recorded runs."""

import importlib.util
from pathlib import Path

import pytest
import torch

from layoutdit_tpu_torch.ops import roi_align as roi_mod
from layoutdit_tpu_torch.ops import short_attention as short_mod
from layoutdit_tpu_torch.tools import kernel_swap

# held-out table AP50 of the thirty card runs (train.seed 0-9)
TABLE_AP50 = {
    "kernels": (
        0.6883505200336882, 0.6996033531924623, 0.7720243517564428, 0.812901207703188,
        0.7671499292786422, 0.8319086463302199, 0.8006348003221376, 0.8084992322761688,
        0.8181179607384094, 0.7210114919054932,
    ),
    "plain_short": (
        0.7510492135801016, 0.7196669808118986, 0.8136554544483112, 0.8674030156052043,
        0.6364365007929366, 0.7554565033613558, 0.7676456721302382, 0.8121534842559888,
        0.8152404526166903, 0.6753877974004298,
    ),
    "plain_roi": (
        0.7385549189517618, 0.6976935070354328, 0.8028362571228036, 0.8080967305872508,
        0.7613475633277614, 0.7797829884202994, 0.8059982188695061, 0.8363497063992112,
        0.8384518316085002, 0.7223903106175749,
    ),
}


def test_swap_patches_the_wrappers_and_restores_them():
    originals = (short_mod.short_attention, short_mod.short_attention_bwd,
                 roi_mod.roi_align_fwd, roi_mod.roi_align_bwd)
    with kernel_swap.swapped("plain_short"):
        assert short_mod.short_attention is short_mod.short_attention_plain
        qkv = torch.randn(2, 5, 3 * 2 * 32, requires_grad=True)
        short_mod.short_attention_qkv(qkv, 2).square().sum().backward()
        want = torch.autograd.grad(
            short_mod.short_attention_plain(*short_mod.split_qkv(qkv, 2)).square().sum(), qkv)[0]
        assert torch.allclose(qkv.grad, want, atol=1e-5)
        assert roi_mod.roi_align_fwd is originals[2]
    with kernel_swap.swapped("plain_roi"):
        assert roi_mod.roi_align_fwd is roi_mod.roi_align_plain
        assert short_mod.short_attention is originals[0]
    assert (short_mod.short_attention, short_mod.short_attention_bwd, roi_mod.roi_align_fwd,
            roi_mod.roi_align_bwd) == originals


def _export_tests():
    """``tests/test_torch_export.py``, for its tiny detector and its fake
    CUDA trace."""
    spec = importlib.util.spec_from_file_location(
        "port_export_tests", Path(__file__).with_name("test_torch_export.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# the operators each arm leaves in a 224 px trace on the card (the short
# route), and the ones its swap removes
ARM_OPS = {
    "kernels": ({"short", "roi"}, set()),
    "plain_short": ({"roi"}, {"short"}),
    "plain_roi": ({"short"}, {"roi"}),
    "plain_attention": ({"roi"}, {"short", "flash"}),
}


@pytest.mark.parametrize("arm", sorted(ARM_OPS))
def test_swapped_wrapper_is_the_one_a_traced_program_calls(arm):
    mod = _export_tests()
    cfg = mod.port_det.DetectorConfig(
        backbone=mod.port_backbone.BackboneConfig(vit=mod.port_vit.ViTConfig(**mod.VIT),
                                                  fpn_out_channels=32),
        image_size=64, budget=mod.DetectionBudget(**mod.BUDGET))
    params = mod.port_det.init_detector(cfg, torch.Generator().manual_seed(0), device="cpu")
    kept, removed = ARM_OPS[arm]
    with kernel_swap.swapped(arm):
        targets = mod.fake_cuda_graph_targets(params, cfg, 224)
    assert {mod.OPS[k] for k in kept} | {mod.OPS["nms"]} <= targets
    assert not {mod.OPS[k] for k in removed} & targets
    # the plain versions ran in their place (their einsums are in the graph)
    assert ("aten.einsum.default" in targets) == bool(removed)


def test_rule_on_the_recorded_runs_convicts_no_kernel():
    runs = [{"arm": arm, "seed": seed, "AP50-table": v}
            for arm, vals in TABLE_AP50.items() for seed, v in enumerate(vals)]
    # seeds 0-2 alone: plain rows 1-2 ahead on all three, convicted by neither rule
    first = kernel_swap.verdict([r for r in runs if r["seed"] < 3])["plain_short"]
    assert not first["unpaired"]["kernels_at_fault"]
    assert abs(first["unpaired"]["spread"] - 0.0939884736364126) < 1e-12
    assert first["paired"]["plain_ahead"] == 3 and first["paired"]["t_crit"] == 4.303
    assert 0 < first["paired"]["t"] < 4.303 and not first["paired"]["kernels_at_fault"]
    # seeds 0-9: plain ahead on 5 and 6 of 10, |t| under 1
    verdict = kernel_swap.verdict(runs)
    for arm, ahead in (("plain_short", 5), ("plain_roi", 6)):
        got = verdict[arm]
        assert not got["unpaired"]["kernels_at_fault"] and not got["paired"]["kernels_at_fault"]
        assert got["paired"]["plain_ahead"] == ahead and abs(got["paired"]["t"]) < 1
        assert got["paired"]["t_crit"] == 2.262
    # a plain arm ahead by more than the larger spread would convict under both
    shifted = [{**r, "AP50-table": r["AP50-table"] + 0.3} if r["arm"] == "plain_short" else r
               for r in runs]
    got = kernel_swap.verdict(shifted)["plain_short"]
    assert got["unpaired"]["kernels_at_fault"] and got["paired"]["kernels_at_fault"]
