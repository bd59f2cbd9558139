"""The port's command line (port of ``layoutdit_tpu/main.py``): config,
then model, then train, then score, then visualize.

    LAYOUTDIT_CONFIG=cfg.json python -m layoutdit_tpu_torch.main [--local_mode]
        [--resume PATH|auto] [--skip-train] [--skip-eval] [--device cuda|cpu]

  * ``LAYOUTDIT_CONFIG`` names a JSON config (the JAX package's
    layout), local or at a ``scheme://`` URL; without it the defaults
    hold. The data and the artifact base (``eval_base_path``) may be
    URLs too (``utils/paths.py``; fsspec is imported only for them).
  * ``--local_mode`` trains on the eval split, as in the JAX package.
  * ``--resume`` applies when training: a checkpoint path (the port's
    ``.pt``, or the JAX trainer's ``.msgpack`` or ``.orbax``, local or a URL), or
    ``auto`` for the newest one of the run (a fresh start when there is
    none).
  * ``--skip-train`` scores the freshly built model; ``--skip-eval``
    trains only.
  * ``--device``: "cuda" (the default) or "cpu"; the config's
    ``train_config.device`` and ``eval_config.device`` ("auto" keeps it,
    "cpu", "gpu" / "cuda") choose the trainer's and the final
    evaluation's (``config.resolve_device``).

The JAX flag ``--read_config`` (a probe of the fixed remote config
``gs://layoutdit/layout_dit_config.json``) is refused: name the config
in ``LAYOUTDIT_CONFIG`` instead.

Data parallelism (``mesh_config``, ``parallel/mesh.py``), one process
per card, started before the model is built (JAX ``main.py``):

  * under torchrun the environment decides:
    ``torchrun --nproc_per_node N -m layoutdit_tpu_torch.main ...``;
  * with ``enable_distributed_init`` and ``coordinator_address``, one
    process per card started by the caller, each with its
    ``process_id`` (multi-host);
  * otherwise, when ``data_parallel`` resolves to more than one of this
    host's cards (the default -1 takes every card), ``main`` starts one
    worker per card itself, as torchrun would, so that the JAX command
    line trains on every card as JAX does; it exits non-zero if a
    worker fails, and stops the others then.

With ``model_parallel`` M > 1 or ``pipeline_parallel`` P > 1 the mesh is
data x model x pipe: ``main`` starts D x M x P ranks, one a card (D from
``data_parallel`` over the host's cards / (M P)); each rank's model group
trains and scores its rows on its shards (``parallel/tensor.py``), and
each pipe group trains them through the encoder's GPipe stages
(``parallel/pipeline.py``); under torchrun the environment decides the
world, which must be D x M x P. With ``dcn_data_parallel`` the hosts'
torchrun ranks form the hybrid mesh (``parallel/mesh.py``).
"""

from __future__ import annotations

import argparse
import dataclasses
import multiprocessing
import os
import sys
import time

import torch
import torch.distributed as dist

from layoutdit_tpu_torch.config import RunConfig, get_run_config, resolve_device
from layoutdit_tpu_torch.eval.evaluator import Evaluator
from layoutdit_tpu_torch.log import get_logger
from layoutdit_tpu_torch.models.model import build_model
from layoutdit_tpu_torch.parallel.mesh import (
    build_mesh_for_batch,
    free_port,
    maybe_distributed_init,
    resolve_degree,
)
from layoutdit_tpu_torch.train.trainer import Trainer, shard_model_

logger = get_logger(__name__)


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description="LayoutDit training and evaluation (PyTorch)")
    parser.add_argument("--local_mode", action="store_true",
                        help="Train on the eval split (the local samples)")
    parser.add_argument("--read_config", action="store_true",
                        help="Not supported by the port: set LAYOUTDIT_CONFIG to the config file")
    parser.add_argument("--resume", default=None,
                        help="Checkpoint to resume from (.pt, or a JAX .msgpack or .orbax; local "
                             "or a URL), or 'auto' for the newest checkpoint of the run (a fresh "
                             "start when there is none)")
    parser.add_argument("--skip-train", action="store_true", help="Evaluate only")
    parser.add_argument("--skip-eval", action="store_true", help="Train only")
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    if args.read_config:
        parser.error("--read_config: the port probes no fixed remote config; point "
                     "LAYOUTDIT_CONFIG at the JSON file (local or a URL) instead")

    config = get_run_config()
    if args.local_mode:
        config = dataclasses.replace(config, local_mode=True)
    device = resolve_device(config.train.device, args.device)
    ranks = _ranks_to_spawn(config, device)
    if ranks > 1:
        spawn_ranks(sys.argv[1:] if argv is None else list(argv), ranks)
        return
    started = maybe_distributed_init(config.mesh, device)
    try:
        _run(config, args)
    finally:
        if started:
            dist.destroy_process_group()


def _run(config: RunConfig, args) -> None:
    logger.info("Starting LayoutDit training (args=%s)", vars(args))

    device = resolve_device(config.train.device, args.device)
    model = build_model(config, seed=config.train.seed, device=device)
    logger.info("Initialized model (%.1fM params)", model.num_params() / 1e6)
    mesh = None
    if dist.is_initialized():
        mesh = build_mesh_for_batch(config.mesh, config.data.batch_size,
                                    max(1, config.train.grad_accumulation_steps))
    tp = mesh.model if mesh is not None else None

    if not args.skip_train:
        trainer = Trainer(config, model, device=device, mesh=mesh)
        if args.resume:
            trainer.resume(args.resume)
        trainer.train()  # model.params is the trained tree
        if trainer.ema_params is not None:
            # the raw weights stay in the checkpoints' params slot
            logger.info("Evaluating with EMA parameters (decay=%s)", config.train.ema_decay)
            model.params = trainer.ema_params

    elif tp is not None and tp.size > 1:
        shard_model_(model, tp)  # the ranks of a model group score on their shards

    if not args.skip_eval:
        evaluator = Evaluator(model, config, device=resolve_device(config.eval.device, device),
                              comm=mesh.comm if mesh is not None else None, tp=tp)
        metrics = evaluator.score()
        if metrics is not None:
            logger.info("Final metrics: %s", metrics)
        evaluator.visualize_preds()
        evaluator.visualize_gt()


def _ranks_to_spawn(config: RunConfig, device: str) -> int:
    """The ranks ``main`` starts itself: the data degree of
    ``data_parallel`` over this host's cards / (``model_parallel`` x
    ``pipeline_parallel``), times both; 1 on the CPU (or with no card),
    under torchrun, inside a group, and with a coordinator (the caller
    starts the processes). More model x pipe ranks than cards raise."""
    mesh = config.mesh
    if (torch.device(device).type != "cuda" or not torch.cuda.is_available()
            or "WORLD_SIZE" in os.environ or dist.is_initialized()
            or (mesh.enable_distributed_init and mesh.coordinator_address)):
        return 1
    cards = torch.cuda.device_count()
    mp = max(1, mesh.model_parallel) * max(1, mesh.pipeline_parallel)
    if mp > cards:
        raise ValueError(f"mesh_config.model_parallel={mesh.model_parallel} x "
                         f"pipeline_parallel={mesh.pipeline_parallel} needs {mp} cards, but "
                         f"only {cards} are available")
    return mp * resolve_degree(mesh.data_parallel, cards // mp, config.data.batch_size)


def _rank_main(argv: list[str], rank: int, world: int, port: int) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    main(argv)


def spawn_ranks(argv: list[str], world: int) -> None:
    """Run ``main(argv)`` in ``world`` spawned processes, one per card,
    with torchrun's environment; raises ``SystemExit`` naming the ranks
    that failed, after stopping the rest (which would wait in a
    collective for the failed one)."""
    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=_rank_main, args=(argv, r, world, port)) for r in range(world)]
    for p in procs:
        p.start()
    logger.info("started %d data-parallel ranks on 127.0.0.1:%d", world, port)
    try:
        while any(p.is_alive() for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs):
                break
            time.sleep(0.5)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
            p.join()
    failed = [r for r, p in enumerate(procs) if p.exitcode != 0]
    if failed:
        raise SystemExit(f"ranks {failed} failed (exit codes "
                         f"{[procs[r].exitcode for r in failed]})")


if __name__ == "__main__":
    main()
