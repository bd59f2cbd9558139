"""Exact linear-sum assignment (Hungarian / Jonker-Volgenant), batched:
a CUDA kernel and its plain version.

Port of ``layoutdit_tpu/ops/matching.py``, which DETR's loss calls on the
device for every (decoder layer, image) problem: the e-maxx potentials
and shortest-augmenting-path algorithm, O(R * C^2), each row insertion a
``lax.while_loop`` of Dijkstra steps inside a ``fori_loop`` over the rows,
vmapped over the problems. It has no Pallas kernel; its loops are serial
and its vector work is O(C) a step, so a plain PyTorch version costs a
dozen small launches and a host read per step. ``csrc/matching.cu`` runs
the whole solve of each problem in one warp, all problems in one launch.

Both keep JAX's float32 order of operations, so they return JAX's
assignment bit for bit on the same float32 costs, ties included:
``cur = (a[i0] - u[i0]) - v``; on the used columns ``u[p[j]] += delta``
and ``v[j] -= delta``, on the others ``minv -= delta``; the virtual
column 0 never relaxes; ``BIG = FLT_MAX / 4``; the argmin takes the
lowest column index among equal values.

``linear_sum_assignment(cost)`` launches the kernel for a CUDA tensor,
through the registered operator ``layoutdit_torch::linear_sum_assignment``
(``ops/_library.py``), and takes the plain version only for a CPU tensor.
"""

from __future__ import annotations

import ctypes

import torch

from layoutdit_tpu_torch.ops import _build, _library

# the kernel keeps u, v, minv, way, p and used of a problem in shared
# memory: 20 * (C + 1) + 4 * (R + 1) bytes, under the 48 KB a block has
# without opting in at C = 1024
MAX_COLS = 1024
BIG = torch.finfo(torch.float32).max / 4


def _check_shape(cost: torch.Tensor) -> tuple[int, int, int]:
    if cost.dim() != 3:
        raise ValueError(f"linear_sum_assignment: cost must be [P, R, C], got {tuple(cost.shape)}")
    p, r, c = cost.shape
    if r > c:
        raise ValueError(f"linear_sum_assignment: need rows <= columns, got R={r} C={c}")
    return p, r, c


def linear_sum_assignment_plain(
    cost: torch.Tensor, return_steps: bool = False
) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """Minimum-cost assignment of every row to a distinct column, for each
    of P problems: cost [P, R, C] (R <= C, finite) -> the column of each
    row [P, R] int64; with ``return_steps`` also each problem's Dijkstra
    steps [P] int32 (its serial depth; -1 where a row reached no column,
    which happens only for costs that are not finite, and where JAX's
    loop never ends: that problem's rows then get columns 0..R-1).

    JAX's solver as vmap runs it: one loop over the rows for all
    problems, and in each row a loop of Dijkstra steps that runs until
    every problem's path has reached a free column, a problem whose path
    has ended masked out of the updates (one host read a step)."""
    n, r, c = _check_shape(cost)
    dev = cost.device
    steps = torch.zeros(n, dtype=torch.int32, device=dev)
    if r == 0 or n == 0:
        out = torch.zeros((n, r), dtype=torch.int64, device=dev)
        return (out, steps) if return_steps else out
    big = torch.tensor(BIG, dtype=torch.float32, device=dev)
    # 1-indexed rows; column 0 is the virtual start column (e-maxx)
    a1 = torch.zeros((n, r + 1, c + 1), dtype=torch.float32, device=dev)
    a1[:, 1:, 1:] = cost.float()
    u = torch.zeros((n, r + 1), dtype=torch.float32, device=dev)
    v = torch.zeros((n, c + 1), dtype=torch.float32, device=dev)
    p = torch.zeros((n, c + 1), dtype=torch.int64, device=dev)  # column -> row, 0 = free
    lanes = torch.arange(n, device=dev)
    failed = torch.zeros(n, dtype=torch.bool, device=dev)
    col0 = torch.arange(c + 1, device=dev) == 0
    for i in range(1, r + 1):
        p[:, 0] = i
        minv = big.expand(n, c + 1).clone()
        way = torch.zeros((n, c + 1), dtype=torch.int64, device=dev)
        used = torch.zeros((n, c + 1), dtype=torch.bool, device=dev)
        j0 = torch.zeros(n, dtype=torch.int64, device=dev)
        active = torch.ones(n, dtype=torch.bool, device=dev)
        while True:
            steps += active.int()
            on = active[:, None]
            used = used | (on & (torch.arange(c + 1, device=dev) == j0[:, None]))
            i0 = torch.where(j0 == 0, i, p[lanes, j0])
            cur = (a1[lanes, i0] - u[lanes, i0][:, None]) - v
            upd = on & ~used & ~col0 & (cur < minv)  # the virtual column never relaxes
            minv = torch.where(upd, cur, minv)
            way = torch.where(upd, j0[:, None], way)
            masked = torch.where(used | col0, big, minv)
            j1 = torch.argmin(masked, dim=1)  # the first of equal minima
            # no free column reachable (costs not finite; JAX's loop never
            # ends): the problem stops, its rows get columns 0..R-1
            failed = failed | (active & (j1 == 0))
            active = active & ~failed
            on = active[:, None]
            delta = masked[lanes, j1][:, None]
            moved = on & used
            rows = torch.where(col0, i, p)
            u = u.scatter_add(1, torch.where(moved, rows, 0),
                              torch.where(moved, delta, torch.zeros_like(delta)))
            v = torch.where(moved, v - delta, v)
            minv = torch.where(on & ~used, minv - delta, minv)
            j0 = torch.where(active, j1, j0)
            active = active & (p[lanes, j0] != 0)
            if not bool(active.any()):
                break
        # augment along the path back to the virtual column
        walking = (j0 != 0) & ~failed
        while bool(walking.any()):
            j1 = way[lanes, j0]
            p_new = torch.where(j1 == 0, i, p[lanes, j1])
            p[lanes[walking], j0[walking]] = p_new[walking]
            j0 = torch.where(walking, j1, j0)
            walking = j0 != 0
    # p[:, j] = 1-indexed row of column j -> the column of each row
    col_for_row = torch.zeros((n, r + 1), dtype=torch.int64, device=dev)
    assigned = p[:, 1:] != 0
    cols = torch.arange(c, device=dev).expand(n, c)
    col_for_row[lanes[:, None].expand(n, c)[assigned], p[:, 1:][assigned]] = cols[assigned]
    out = torch.where(failed[:, None], torch.arange(r, device=dev), col_for_row[:, 1:])
    steps = torch.where(failed, -1, steps)
    return (out, steps) if return_steps else out


_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def _lib() -> ctypes.CDLL:
    lib = _build.load("matching")
    if lib.linear_sum_assignment.argtypes is None:
        lib.linear_sum_assignment.argtypes = _ARGTYPES
        lib.linear_sum_assignment.restype = ctypes.c_int
    return lib


def _lsa_cuda(cost: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    n, r, c = _check_shape(cost)
    if c > MAX_COLS:
        raise ValueError(f"linear_sum_assignment: C={c} above the kernel's {MAX_COLS} columns")
    if cost.dtype != torch.float32 or not cost.is_contiguous():
        raise ValueError("linear_sum_assignment: cost must be contiguous float32, got "
                         f"{cost.dtype} with strides {cost.stride()}")
    out = torch.empty((n, r), dtype=torch.int64, device=cost.device)
    steps = torch.zeros(n, dtype=torch.int32, device=cost.device)
    if n == 0 or r == 0:
        return out, steps
    lib = _lib()
    code = lib.linear_sum_assignment(cost.data_ptr(), out.data_ptr(), steps.data_ptr(),
                                     n, r, c, _build.stream_ptr(cost))
    _build.check(lib, code, "linear_sum_assignment")
    linear_sum_assignment.launches += 1
    return out, steps


_lsa_op = _library.define(
    "linear_sum_assignment(Tensor cost) -> (Tensor, Tensor)",
    fake=lambda cost: (cost.new_empty(cost.shape[:2], dtype=torch.int64),
                       cost.new_empty(cost.shape[:1], dtype=torch.int32)),
    cuda=_lsa_cuda,
)


def linear_sum_assignment(
    cost: torch.Tensor, return_steps: bool = False
) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """The optimal assignment of each problem of cost [P, R, C] (R <= C;
    float32 math, as JAX casts): [P, R] int64 column indices, and with
    ``return_steps`` each problem's Dijkstra steps [P] int32. One kernel
    launch for all P problems on the card (C <= MAX_COLS), the plain
    version on the CPU."""
    if cost.device.type == "cpu":
        return linear_sum_assignment_plain(cost, return_steps)
    if cost.device.type != "cuda":
        raise ValueError(f"linear_sum_assignment: unsupported device {cost.device}")
    out, steps = _lsa_op(cost.float().contiguous())
    return (out, steps) if return_steps else out


linear_sum_assignment.launches = 0
