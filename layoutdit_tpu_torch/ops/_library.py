"""The port's kernels as registered PyTorch operators, namespace
``layoutdit_torch``.

Each CUDA launch of ``ops/`` is an operator defined here with a CUDA
implementation (its launcher: checks, allocation, the ctypes call, the
launch count) and a fake implementation that gives only the outputs'
shapes and dtypes. A traced program (``torch.export``) therefore names
the kernels as ``torch.ops.layoutdit_torch.<name>`` nodes, and running
it launches them through the same implementation, counted as on the live
path. The kernels' operators have no CPU implementation: on the CPU the
module wrappers take their plain versions before any operator is
reached, and a CPU tensor given to one raises in the dispatcher. The NMS
fixpoint (``ops/nms.py``), a loop that reads the host, is an operator on
both devices so that a traced program can hold it.

``torch.library.Library`` with ``define``/``impl`` is used, not
``torch.library.custom_op``: its per-call host cost is a dispatcher hop
(about 5 us on a CPU core), where ``custom_op``'s Python layers cost
about 20x more, and 224 px serving is host-bound (``PERF.md`` §5).
Defining an operator does nothing CUDA-related, so importing the modules
stays safe on a machine without a GPU.
"""

from __future__ import annotations

from typing import Callable

import torch

NAMESPACE = "layoutdit_torch"
_LIB = torch.library.Library(NAMESPACE, "FRAGMENT")

# the forward kernels' element types (the backward kernels': bf16), each
# with its name and its elements in one 16-byte access
KERNEL_DTYPES = {torch.bfloat16: ("bf16", 8), torch.float32: ("fp32", 4)}


def kernel_dtype(t: torch.Tensor) -> torch.dtype:
    """The type a forward kernel reads ``t`` in: its own where a kernel
    takes it, else bf16, whose check then refuses ``t``."""
    return t.dtype if t.dtype in KERNEL_DTYPES else torch.bfloat16


# the refusal of the backward kernels' launchers, and of the trainer, on a
# float32 CUDA tensor: the forward kernels of rows 1, 3 and 7 have float32
# forms (serving), the backward kernels take bf16 only
FLOAT32_TRAINING = (
    "float32 training on the card waits for the fp32 backward kernels (kernel-table rows 2, "
    "4-6 and 8, PERF.md); on the card float32 serves only: train in bfloat16 there, or in "
    "float32 on the CPU"
)


def refuse_float32_backward(what: str, *tensors: torch.Tensor) -> None:
    """Raise ``FLOAT32_TRAINING`` where a backward kernel would be given a
    float32 tensor of ``tensors``."""
    if any(t.dtype == torch.float32 for t in tensors):
        raise ValueError(f"{what}: {FLOAT32_TRAINING}")


def define(schema: str, fake: Callable, cuda: Callable | None = None,
           cpu: Callable | None = None) -> torch._ops.OpOverload:
    """Define ``layoutdit_torch::<schema>`` with its fake implementation
    and its CUDA (and, for a host-side operator, CPU) implementation ->
    the operator's default overload, which the wrappers call."""
    name = schema.split("(", 1)[0]
    _LIB.define(schema)
    if cuda is not None:
        _LIB.impl(name, cuda, "CUDA")
    if cpu is not None:
        _LIB.impl(name, cpu, "CPU")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=_LIB)
    return getattr(getattr(torch.ops, NAMESPACE), name).default
