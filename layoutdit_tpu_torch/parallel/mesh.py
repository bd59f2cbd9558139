"""Process groups and the data x model x pipe mesh (port of
``layoutdit_tpu/parallel/mesh.py``'s ``build_mesh``,
``build_mesh_for_batch``, the hybrid DCN layout and
``pipeline_config``).

The JAX package shards the batch over a mesh's ``data`` axis and lets
``jit`` insert the gradient all-reduce: every loss is then the loss of
the whole global batch, as if it ran on one device. The port runs one
process per card under ``torch.distributed`` (NCCL on the card, gloo on
the CPU) and writes those collectives out:

  * ``maybe_distributed_init`` starts the process group from torchrun's
    environment or from the config's coordinator fields;
  * ``build_mesh_for_batch`` resolves ``mesh_config.data_parallel``,
    ``model_parallel`` and ``pipeline_parallel`` into a ``DataMesh``: the
    data degree, this rank's data index, the rows of every global batch
    that it loads (``DataMesh.rows``), with ``model_parallel`` > 1 its
    model group (``ModelGroup``) and with ``pipeline_parallel`` > 1 its
    pipe group (``PipeGroup``). Ranks are laid out as JAX lays out the
    devices of a [data, model, pipe] mesh: rank = (d x mp + m) x pp + p,
    the pipe axis innermost (``rank_layout``; with ``dcn_data_parallel``
    the hosts outermost on the data axis); the ranks of a model or pipe
    group share their data index and so load the same rows;
  * ``Comm`` holds the collectives the ranks use, over the world or over
    one of its groups, and the ring's point-to-point ``ppermute``;
  * ``losses_over(mesh)`` makes every batch-wide normalizer of the
    losses global (``global_count``, ``rank_share``, ``global_mean``).

The convention: rank r's loss L_r is chosen so that the mean of the
ranks' L_r is the global batch's loss and the mean of their gradients is
its gradient; the trainer averages the gradients. A loss that divides a
sum over the batch by a count over the batch becomes
``rank_share(local_sum) / global_count(local_count)`` = W * S_r / C, so
that mean_r L_r = sum_r S_r / C. A function of batch means (the MoE
load-balance loss) takes ``global_mean`` of each: the global value, with
the local mean's own gradient, whose average over the ranks is the
global mean's. A mean over images (RetinaNet) needs nothing: equal
shards average to the global mean.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import datetime
import os
import socket
from typing import Iterator

import numpy as np
import torch
import torch.distributed as dist

from layoutdit_tpu_torch.config import MeshConfig
from layoutdit_tpu_torch.log import get_logger

logger = get_logger(__name__)


def maybe_distributed_init(cfg: MeshConfig, device: str | torch.device = "cuda",
                           backend: str | None = None) -> bool:
    """Start ``torch.distributed`` for this process; call it before the
    model is built. True when this call started the group: the caller
    then ends it with ``torch.distributed.destroy_process_group()``.

    The sources, in order:
      * a group already started: nothing;
      * torchrun's environment (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``,
        ``MASTER_ADDR``, ``MASTER_PORT``): ``init_method="env://"``, with
        or without ``enable_distributed_init``;
      * ``enable_distributed_init`` with ``coordinator_address``:
        ``init_method="tcp://{coordinator_address}"``, ``num_processes``
        ranks, this one ``process_id``;
      * ``enable_distributed_init`` with neither: JAX's ``initialize()``
        would look for a TPU pod, find none and leave one process; the
        port has nothing to look for, warns and runs as one process.

    The backend is NCCL on a CUDA ``device`` and gloo on the CPU;
    ``backend`` names another (gloo for ranks that share one card, which
    NCCL refuses). On the card, the process takes card ``LOCAL_RANK``
    (torchrun) or ``process_id`` modulo the visible cards (one process
    per card, the ranks of a host numbered together).

    The timeouts: JAX's ``heartbeat_timeout_s`` (how long a silent peer
    may go before it is declared dead) and ``shutdown_timeout_s`` (how
    long the exit barrier waits) have one counterpart here, the process
    group's ``timeout``, how long any collective waits for its peers
    before it raises. It is the larger of the two when either is set,
    else torch's default.

    A failed start raises, where JAX warns and goes on: N processes that
    each train alone would each write the run's artifacts."""
    if dist.is_initialized():
        return False
    env = "WORLD_SIZE" in os.environ
    if not (env or cfg.enable_distributed_init):
        return False
    if not env and not cfg.coordinator_address:
        logger.warning("enable_distributed_init: no torchrun environment and no "
                       "coordinator_address; running as one process")
        return False
    device = torch.device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    kwargs = {}
    timeouts = [t for t in (cfg.heartbeat_timeout_s, cfg.shutdown_timeout_s) if t is not None]
    if timeouts:
        kwargs["timeout"] = datetime.timedelta(seconds=max(timeouts))
    if env:
        kwargs["init_method"] = "env://"
        local = int(os.environ.get("LOCAL_RANK", 0))
    else:
        if cfg.num_processes is None or cfg.process_id is None:
            raise ValueError("mesh_config.coordinator_address needs num_processes and "
                             "process_id")
        kwargs.update(init_method=f"tcp://{cfg.coordinator_address}",
                      world_size=cfg.num_processes, rank=cfg.process_id)
        local = cfg.process_id
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", local % torch.cuda.device_count())
        torch.cuda.set_device(device)
        if backend == "nccl":
            kwargs["device_id"] = device
    dist.init_process_group(backend, **kwargs)
    logger.info("torch.distributed up: rank %d of %d, backend %s, %s", dist.get_rank(),
                dist.get_world_size(), backend, device)
    return True


def free_port() -> int:
    """A free TCP port on 127.0.0.1, for a coordinator on this host."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def is_lead_host() -> bool:
    """Rank 0 writes every artifact of the run (checkpoints, metrics,
    TensorBoard events, predictions, overlays, traces): two ranks writing
    one path race."""
    return not dist.is_initialized() or dist.get_rank() == 0


def resolve_degree(data_parallel: int, available: int, batch_size: int) -> int:
    """JAX's rules for the data degree (``build_mesh_for_batch``): -1 (or
    0) means every one of ``available``; more than ``available`` raises;
    the degree is clamped, loudly, to the largest that divides
    ``batch_size``."""
    dp_max = data_parallel if data_parallel > 0 else max(available, 1)
    if dp_max > available:
        raise ValueError(f"mesh_config.data_parallel={data_parallel} asks for {dp_max} ranks, "
                         f"but only {available} are available")
    dp = max(d for d in range(1, dp_max + 1) if batch_size % d == 0)
    if dp != dp_max:
        logger.warning("data_parallel clamped %d -> %d to divide batch_size=%d",
                       dp_max, dp, batch_size)
    return dp


class Comm:
    """The collectives of the data-parallel ranks over a
    ``torch.distributed`` group (the default one unless ``group``).

    NCCL runs them on the card. Gloo runs them on the CPU: a CUDA tensor
    is staged through host memory (gloo's CUDA support varies between
    builds, and some lack the tensor forms of all-gather and
    reduce-scatter), which it says once. Python objects and flags go
    over the same group, on the current card under NCCL."""

    def __init__(self, group=None):
        self.group = group
        self.world = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.backend = dist.get_backend(group)
        self.device = (torch.device("cuda", torch.cuda.current_device())
                       if self.backend == "nccl" else torch.device("cpu"))
        self._said_staging = False

    def _staged(self, t: torch.Tensor) -> bool:
        if self.backend == "gloo" and t.is_cuda:
            if not self._said_staging:
                logger.warning("gloo: collectives of CUDA tensors staged through host memory")
                self._said_staging = True
            return True
        return False

    def all_reduce_(self, t: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
        """``t`` summed (or ``op``) over the ranks, in place."""
        if self._staged(t):
            return t.copy_(self.all_reduce_(t.cpu(), op))
        dist.all_reduce(t, op=op, group=self.group)
        return t

    def _global(self, rank: int) -> int:
        """The world rank of this group's ``rank`` (torch's collectives
        and point-to-point ops name peers by world rank)."""
        return rank if self.group is None else dist.get_global_rank(self.group, rank)

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """``t`` of this group's rank ``src`` on every rank, in place."""
        if self._staged(t):
            return t.copy_(self.broadcast_(t.cpu(), src))
        dist.broadcast(t, self._global(src), group=self.group)
        return t

    def ppermute(self, t: torch.Tensor, shift: int = 1) -> torch.Tensor:
        """The ring step (JAX's ``lax.ppermute`` over [(i, i + shift)]):
        ``t`` goes to rank + shift, and the tensor of rank - shift (its
        shape and dtype) comes back, new. One ``batch_isend_irecv`` of a
        send and a receive, on gloo and NCCL alike."""
        if self.world == 1:
            return t
        if self._staged(t):
            return self.ppermute(t.cpu(), shift).to(t.device)
        t = t.contiguous()
        out = torch.empty_like(t)
        ops = [dist.P2POp(dist.isend, t, self._global((self.rank + shift) % self.world),
                          self.group),
               dist.P2POp(dist.irecv, out, self._global((self.rank - shift) % self.world),
                          self.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return out

    def all_gather(self, shard: torch.Tensor, dim: int) -> torch.Tensor:
        """The ranks' ``shard``s concatenated along ``dim``, in rank order."""
        if self._staged(shard):
            return self.all_gather(shard.cpu(), dim).to(shard.device)
        rows = shard.movedim(dim, 0).contiguous()
        out = rows.new_empty((self.world * rows.shape[0], *rows.shape[1:]))
        dist.all_gather_into_tensor(out, rows, group=self.group)
        return out.movedim(0, dim).contiguous()

    def reduce_scatter(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The sum of the ranks' ``t``, cut along ``dim`` into ``world``
        equal parts: this rank's part."""
        if self._staged(t):
            return self.reduce_scatter(t.cpu(), dim).to(t.device)
        rows = t.movedim(dim, 0).contiguous()
        out = rows.new_empty((rows.shape[0] // self.world, *rows.shape[1:]))
        dist.reduce_scatter_tensor(out, rows, group=self.group)
        return out.movedim(0, dim).contiguous()

    def all_gather_object(self, obj) -> list:
        out = [None] * self.world
        dist.all_gather_object(out, obj, group=self.group)
        return out

    def broadcast_object(self, obj, src: int = 0):
        box = [obj]
        dist.broadcast_object_list(box, self._global(src), group=self.group)
        return box[0]

    def any(self, flag: bool) -> bool:
        """True on every rank when ``flag`` is True on any."""
        t = torch.tensor([int(flag)], dtype=torch.int32, device=self.device)
        self.all_reduce_(t, op=dist.ReduceOp.MAX)
        return bool(t.item())


@dataclasses.dataclass(frozen=True)
class ModelGroup:
    """The ``size`` model-parallel ranks that share one data index, this
    one ``rank`` among them, ``comm`` their collectives: the model axis
    that tensor, sequence and expert parallelism (``parallel/tensor.py``,
    ``parallel/sharding.py``) work over, and that ring attention rotates
    K and V around. ``sequence_parallel``: the encoder's residual stream
    stays token-sharded over the group between blocks."""

    size: int
    rank: int
    comm: Comm
    sequence_parallel: bool = False


@dataclasses.dataclass(frozen=True)
class PipeGroup:
    """The ``size`` pipeline stages that share one (data, model) index,
    this one ``rank`` (its stage) among them, ``comm`` their collectives
    and point-to-point sends (``parallel/pipeline.py``)."""

    size: int
    rank: int
    comm: Comm


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """``degree`` data-parallel ranks, this one's data index ``rank``;
    ``comm`` their collectives (None for one process outside a group);
    ``fsdp`` shards the parameters and moments over them
    (``parallel/sharding.py``). With a model axis, ``model`` is this
    rank's ``ModelGroup`` (None: no tensor parallelism); with a pipe
    axis, ``pipe`` its ``PipeGroup``; ``comm`` is then the data group of
    its (model, pipe) index, and ``world`` the collectives of every rank
    (the agreed stop, the start from one state)."""

    degree: int = 1
    rank: int = 0
    comm: Comm | None = None
    fsdp: bool = False
    model: ModelGroup | None = None
    world: Comm | None = None
    pipe: PipeGroup | None = None

    @property
    def everyone(self) -> Comm | None:
        """The collectives of every rank of the mesh."""
        return self.world if self.world is not None else self.comm

    @property
    def size(self) -> int:
        """Every rank of the mesh: data x model x pipe degrees."""
        return (self.degree * (self.model.size if self.model is not None else 1)
                * (self.pipe.size if self.pipe is not None else 1))

    def rows(self, batch_size: int, accum: int = 1) -> np.ndarray:
        """The rows of a global batch this rank loads, in order. With
        ``accum`` micro-batches (JAX splits the global batch into
        [accum, batch / accum] and shards each micro-batch over the
        ranks) they are this rank's rows of each micro-batch in turn, so
        that its local micro-batch a is its part of the global one."""
        micro = batch_size // accum
        m = micro // self.degree
        return np.concatenate([np.arange(a * micro + self.rank * m, a * micro + (self.rank + 1) * m)
                               for a in range(accum)])

    @property
    def lead(self) -> bool:
        return (self.rank == 0 and (self.model is None or self.model.rank == 0)
                and (self.pipe is None or self.pipe.rank == 0))


def granule_keys(comm: Comm) -> list:
    """Each rank's DCN granule, its host: torchrun's node index
    (``GROUP_RANK``) where every rank has one, else its host name,
    gathered over ``comm`` (collective)."""
    mine = (os.environ.get("GROUP_RANK"), socket.gethostname())
    keys = comm.all_gather_object(mine)
    if all(k[0] is not None for k in keys):
        return [int(k[0]) for k in keys]
    return [k[1] for k in keys]


def _granules(keys: list, dcn: int, min_size: int) -> list[list[int]]:
    """The ranks grouped by granule key into exactly ``dcn`` granules of
    at least ``min_size`` ranks each, ordered by key (JAX ``_granules``)."""
    groups: dict = {}
    for rank, key in enumerate(keys):
        groups.setdefault(key, []).append(rank)
    if len(groups) != dcn:
        raise ValueError(f"dcn_data_parallel={dcn} but the ranks form {len(groups)} granules "
                         f"({sorted(groups)}) - one granule per host")
    sizes = {k: len(v) for k, v in groups.items()}
    if any(n < min_size for n in sizes.values()):
        raise ValueError(f"hybrid mesh needs >= {min_size} ranks per granule, got {sizes}")
    return [groups[k] for k in sorted(groups)]


def rank_layout(world: int, dp: int, mp: int, pp: int, dcn: int = 1,
                keys: list | None = None) -> np.ndarray:
    """The world rank at each (data, model, pipe) coordinate, [dp, mp, pp].
    Flat: rank = (d * mp + m) * pp + p, the pipe axis innermost, as JAX
    reshapes its devices. Hybrid (``dcn`` > 1, ``keys`` each rank's
    granule): a granule's ranks, in order, fill a [dp / dcn, mp, pp] block
    and the blocks stack on the data axis by granule key (JAX
    ``_hybrid_device_array``), so every model and pipe group lies inside
    one granule and only the data axis crosses hosts."""
    if dcn <= 1:
        return np.arange(world).reshape(dp, mp, pp)
    if dp % dcn:
        raise ValueError(f"dcn_data_parallel={dcn} must divide data_parallel={dp}")
    per = dp // dcn * mp * pp
    groups = _granules(keys, dcn, per)
    if any(len(g) != per for g in groups):
        raise ValueError(f"hybrid mesh needs exactly {per} ranks per granule (dp_ici="
                         f"{dp // dcn} x mp={mp} x pp={pp}), got {[len(g) for g in groups]}")
    return np.concatenate([np.asarray(g).reshape(dp // dcn, mp, pp) for g in groups])


def build_mesh_for_batch(cfg: MeshConfig, batch_size: int, accum: int = 1,
                         comm: Comm | None = None, granule_fn=None) -> DataMesh:
    """The ``DataMesh`` of ``cfg`` over the running processes (``comm``'s,
    else the default group's, else this one). The model degree mp is
    ``model_parallel``, the pipe degree pp ``pipeline_parallel``;
    ``resolve_degree``'s rules give the data degree over the world /
    (mp x pp) ranks (-1 takes them all, the batch clamps it, in whole
    granules on a hybrid mesh); a layout that does not use every process
    raises, as JAX's ``build_mesh(strict=True)`` does (start data x model
    x pipe ranks; the launcher in ``main`` does). Each micro-batch of
    ``accum`` must split evenly over the data ranks.

    ``dcn_data_parallel`` > 1 lays the ranks out as JAX's hybrid mesh
    (``rank_layout``): one granule a host (``granule_keys``, or
    ``granule_fn(rank)``, the test hook), the granule outermost on the
    data axis. The gradient reduction stays one all-reduce over each data
    group: NCCL's own topology detection runs it as rings or trees inside
    each host and across the hosts, so no second, hand-rolled hierarchy
    is written here.

    With mp or pp > 1 every rank creates every group (``mesh_groups``), in
    one order, as ``new_group`` requires."""
    if comm is None and dist.is_initialized():
        comm = Comm()
    world = comm.world if comm is not None else 1
    mp, pp = max(1, cfg.model_parallel), max(1, cfg.pipeline_parallel)
    dcn = max(1, cfg.dcn_data_parallel)
    if world % (mp * pp):
        raise ValueError(f"mesh_config.model_parallel={mp} x pipeline_parallel={pp} does not "
                         f"divide the {world} running processes")
    available = world // (mp * pp)
    if dcn == 1:
        dp = resolve_degree(cfg.data_parallel, available, batch_size)
    else:
        dp_max = cfg.data_parallel if cfg.data_parallel > 0 else available
        if cfg.data_parallel > 0 and dp_max % dcn:  # JAX build_mesh's check
            raise ValueError(f"dcn_data_parallel={dcn} must divide data_parallel={dp_max}")
        if dp_max > available:
            raise ValueError(f"mesh_config.data_parallel={cfg.data_parallel} asks for {dp_max} "
                             f"ranks, but only {available} are available")
        candidates = [d for d in range(dcn, dp_max + 1, dcn) if batch_size % d == 0]
        if not candidates:
            raise ValueError(f"batch_size={batch_size} has no data-parallel degree that is a "
                             f"multiple of dcn_data_parallel={dcn} (<= {dp_max})")
        dp = max(candidates)
        if dp != dp_max:
            logger.warning("data_parallel clamped %d -> %d to divide batch_size=%d", dp_max, dp,
                           batch_size)
    if dp * mp * pp != world:
        raise ValueError(f"mesh {dp}x{mp}x{pp} (data x model x pipe) for batch_size "
                         f"{batch_size} needs {dp * mp * pp} processes, but {world} processes "
                         f"are running; start {dp * mp * pp}")
    if (batch_size // accum) % dp:
        raise ValueError(f"the micro-batch of {batch_size // accum} rows (batch_size "
                         f"{batch_size} / grad_accumulation_steps {accum}) does not split "
                         f"over {dp} data-parallel ranks")
    rank = comm.rank if comm is not None else 0
    fsdp = cfg.fsdp and dp > 1
    keys = None
    if dcn > 1:
        keys = ([granule_fn(r) for r in range(world)] if granule_fn is not None
                else granule_keys(comm) if comm is not None else [0])
    layout = rank_layout(world, dp, mp, pp, dcn, keys)
    if mp == 1 and pp == 1 and dcn == 1:
        return DataMesh(degree=dp, rank=rank, comm=comm, fsdp=fsdp)
    groups = mesh_groups(layout, comm)
    d, m, p = (int(i[0]) for i in np.nonzero(layout == rank))
    model = (ModelGroup(mp, m, groups["model"], sequence_parallel=cfg.sequence_parallel)
             if mp > 1 else None)
    pipe = PipeGroup(pp, p, groups["pipe"]) if pp > 1 else None
    return DataMesh(degree=dp, rank=d, comm=groups["data"], fsdp=fsdp, model=model,
                    world=comm, pipe=pipe)


def pipeline_config(mesh: DataMesh, cfg: MeshConfig):
    """The encoder's ``parallel.pipeline.PipelineConfig`` on a mesh with a
    pipe group of more than one stage, else None (JAX ``pipeline_config``);
    callers pass it straight to ``detector_loss``'s ``pipeline``."""
    if mesh.pipe is None or mesh.pipe.size <= 1:
        return None
    from layoutdit_tpu_torch.parallel.pipeline import PipelineConfig

    return PipelineConfig(group=mesh.pipe, n_microbatches=max(1, cfg.pipeline_microbatches))


def mesh_groups(layout: np.ndarray, comm: Comm) -> dict[str, Comm]:
    """This rank's ``Comm`` of each axis of the [dp, mp, pp] ``layout``
    (world ranks of ``comm``): ``"model"``, the ranks of its (data, pipe)
    index; ``"data"``, of its (model, pipe) index; ``"pipe"``, of its
    (data, model) index. Every rank makes every group of every axis, in
    one order, as ``new_group`` requires; a model or pipe axis of size 1
    makes none (the data groups are made at any size)."""
    dp, mp, pp = layout.shape
    me = comm.rank
    out: dict[str, Comm] = {}
    axes = {"model": layout.transpose(0, 2, 1).reshape(-1, mp),
            "data": layout.transpose(1, 2, 0).reshape(-1, dp),
            "pipe": layout.reshape(-1, pp)}
    for name, rows in axes.items():
        if rows.shape[1] == 1 and name != "data":
            continue
        for row in rows:
            g = dist.new_group([comm._global(int(r)) for r in row])
            if me in row:
                out[name] = Comm(g)
    return out


def replicate_tree(leaves: list[torch.Tensor], mesh: DataMesh) -> None:
    """Every rank takes rank 0's ``leaves`` (in place), so that all start
    from one state."""
    comm = mesh.everyone
    if comm is not None and mesh.size > 1:
        with torch.no_grad():
            for t in leaves:
                comm.broadcast_(t.data)


# ------------------------------------------------------------ losses

_LOSS_MESH: contextvars.ContextVar[DataMesh | None] = contextvars.ContextVar(
    "layoutdit_loss_mesh", default=None)


@contextlib.contextmanager
def losses_over(mesh: DataMesh) -> Iterator[None]:
    """Inside, the losses' batch-wide normalizers are taken over the
    whole global batch of ``mesh`` (a context variable: each thread and
    task has its own). Outside, or for one process outside a group, they
    are the local batch's, as before."""
    token = _LOSS_MESH.set(mesh if mesh.comm is not None else None)
    try:
        yield
    finally:
        _LOSS_MESH.reset(token)


def global_count(count: torch.Tensor) -> torch.Tensor:
    """``count`` (a count or weight summed over the local batch) summed
    over the ranks, float32, no gradient."""
    mesh = _LOSS_MESH.get()
    if mesh is None:
        return count
    return mesh.comm.all_reduce_(count.detach().to(torch.float32).clone())


def rank_share(total: torch.Tensor) -> torch.Tensor:
    """A sum over the local batch, scaled by the degree: over
    ``global_count``, its mean over the ranks is the global ratio."""
    mesh = _LOSS_MESH.get()
    return total if mesh is None else total * mesh.degree


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """A mean over the local batch -> the global batch's mean in value,
    with the local mean's gradient (whose average over the ranks is the
    global mean's)."""
    mesh = _LOSS_MESH.get()
    if mesh is None:
        return x
    g = mesh.comm.all_reduce_(x.detach().clone()) / mesh.degree
    return x + (g - x).detach()
