"""The card's side of the pipeline stages: a pipelined encoder on the
card (two stages, two gloo processes sharing the card,
``parallel/pipeline.py``) launches rows 3-5 in every stage and gives,
forward and backward, the taps and gradients of the same stages run with
the plain versions swapped in (``tools/kernel_swap.py``), within
max |plain| / 64, as ``chip_smoke.py`` holds the kernels (marked
``cuda``; it skips without a GPU). No JAX here.

    python -m pytest tests/test_torch_pipeline_cuda.py -q -m cuda

The stages are processes, not threads: autograd runs every CUDA backward
of a process on one device thread, where one stage's backward would wait
on a send that the other's, queued behind it, never makes.
"""

import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from layoutdit_tpu_torch.models import vit, weights_io
from layoutdit_tpu_torch.ops import flash_attention as fa
from layoutdit_tpu_torch.parallel.mesh import Comm, PipeGroup, free_port
from layoutdit_tpu_torch.parallel.pipeline import PipelineConfig, reduce_pipe_grads
from layoutdit_tpu_torch.tools.kernel_swap import swapped

pytestmark = pytest.mark.cuda
REL = 1.0 / 64
CFG = dict(hidden_size=128, num_hidden_layers=4, num_attention_heads=2, intermediate_size=256,
           image_size=272)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _step(params, pixels, cfg, pcfg):
    """The pipelined encoder's taps and stage-summed gradients."""
    tree = weights_io.tree_map(lambda t: t.detach().clone().requires_grad_(), params)
    outs = vit.vit_forward(tree, pixels, cfg, taps=(2, 4), compute_dtype=torch.bfloat16,
                           pipeline=pcfg)
    sum(o.float().square().sum() for o in outs).backward()
    grads = [t.grad if t.grad is not None else torch.zeros_like(t)
             for t in weights_io.tree_leaves(tree)]
    reduce_pipe_grads(grads, [f"vit/{p}" for p in weights_io.tree_paths(tree)], pcfg)
    return [o.detach().cpu() for o in outs] + [g.cpu() for g in grads]


def _stage(rank: int, port: int, path: str) -> None:
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2,
                            rank=rank)
    try:
        cfg = vit.ViTConfig(**CFG)
        params = weights_io.tree_map(lambda t: t.cuda(), vit.init_vit_params(
            cfg, torch.Generator().manual_seed(0), "cpu"))
        pixels = torch.randn(2, 3, 272, 272, generator=torch.Generator().manual_seed(1)).cuda()
        pcfg = PipelineConfig(PipeGroup(2, rank, Comm()), 2)
        counters = (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
                    fa.flash_attention_bwd_dkdv)
        for fn in counters:
            fn.launches = 0
        got = _step(params, pixels, cfg, pcfg)
        launches = [fn.launches for fn in counters]
        with swapped("plain_attention"):
            want = _step(params, pixels, cfg, pcfg)
        torch.save({"got": got, "want": want, "launches": launches}, f"{path}.{rank}")
    finally:
        dist.destroy_process_group()


def test_pipelined_encoder_rows_3_5_against_plain(cuda, tmp_path):
    """4 layers (head dim 64, 290 tokens: the flash route) as two stages of
    two over 2 microbatches, bf16 on the card: rows 3-5 launched in each
    stage, the taps and every gradient leaf within 1/64 of max |plain| of
    the plain run."""
    path = str(tmp_path / "stage")
    mp.spawn(_stage, args=(free_port(), path), nprocs=2, join=True)
    for rank in range(2):
        res = torch.load(f"{path}.{rank}")
        # 2 layers a stage x 2 microbatches, forward and backward
        assert res["launches"] == [4, 4, 4]
        for g, w in zip(res["got"], res["want"], strict=True):
            ref = float(w.float().abs().max())
            assert float((g.float() - w.float()).abs().max()) <= REL * ref + 1e-6
