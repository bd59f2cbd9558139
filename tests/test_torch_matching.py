"""The port's linear-sum assignment (``ops/matching.py``) against the JAX
package's solver (``layoutdit_tpu/ops/matching.py``), scipy and a brute
force, on the CPU (the plain version), and on the card the kernel
(``csrc/matching.cu``) against the plain version.

The plain version keeps JAX's float32 order of operations and its
lowest-index argmin, so its indices equal JAX's exactly on the same
float32 costs, ties included (JAX's solver is vmapped over the problems,
as DETR's loss runs it)."""

import itertools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment as scipy_lsa

from layoutdit_tpu.ops.matching import linear_sum_assignment as jax_lsa
from layoutdit_tpu_torch.ops import matching

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)

_jax_batched = jax.jit(jax.vmap(jax_lsa))
# problems a shape
P = 4
# optimality against scipy: totals in float32 summed in two orders
TOTAL_TOL = 1e-5


def _jax(cost: np.ndarray) -> np.ndarray:
    if cost.shape[1] == 0:
        return np.zeros(cost.shape[:2], np.int64)
    return np.asarray(_jax_batched(jnp.asarray(cost))).astype(np.int64)


def _plain(cost: np.ndarray, **kw):
    return matching.linear_sum_assignment_plain(torch.from_numpy(cost), **kw)


def _total(cost, cols):
    return float(cost[np.arange(len(cols)), cols].sum())


GRID = [(0, 5), (1, 1), (1, 7), (3, 3), (5, 12), (8, 8), (16, 30), (32, 100)]


@pytest.mark.parametrize("r,c", GRID)
def test_plain_equals_jax_on_float_costs(r, c):
    cost = np.random.default_rng(r * 1000 + c).normal(size=(P, r, c)).astype(np.float32)
    got = _plain(cost)
    assert got.dtype == torch.int64 and got.shape == (P, r)
    np.testing.assert_array_equal(got.numpy(), _jax(cost))


@pytest.mark.parametrize("r,c", [(4, 4), (8, 8), (6, 10), (16, 30), (32, 100)])
def test_plain_equals_jax_on_ties_and_constant_padded_rows(r, c):
    """Integer costs in 0..3 (ties everywhere) with the last third of the
    rows a constant, as DETR's padded gt slots are (0 there, 7 here)."""
    rng = np.random.default_rng(r + c)
    cost = rng.integers(0, 4, size=(P, r, c)).astype(np.float32)
    pad = r - r // 3
    cost[:2, pad:] = 0.0
    cost[2:, pad:] = 7.0
    got = _plain(cost).numpy()
    np.testing.assert_array_equal(got, _jax(cost))
    for k in range(P):  # the real rows win what they win alone
        ri, ci = scipy_lsa(cost[k, :pad])
        assert _total(cost[k, :pad], got[k, :pad]) == cost[k, :pad][ri, ci].sum()


def test_batched_equals_per_problem():
    cost = np.random.default_rng(5).normal(size=(6, 12, 40)).astype(np.float32)
    got, steps = _plain(cost, return_steps=True)
    for k in range(6):
        one, one_steps = _plain(cost[k:k + 1], return_steps=True)
        np.testing.assert_array_equal(got[k].numpy(), one[0].numpy())
        assert int(steps[k]) == int(one_steps[0]) >= 12  # a step per row at least


@pytest.mark.parametrize("r,c,seed", [(10, 10, 0), (20, 100, 1), (64, 100, 2), (100, 100, 3),
                                      (128, 300, 4)])
def test_optimal_against_scipy(r, c, seed):
    cost = (np.random.default_rng(seed).normal(size=(2, r, c)) * 10).astype(np.float32)
    got = _plain(cost).numpy()
    for k in range(2):
        assert len(set(got[k].tolist())) == r  # distinct columns
        ri, ci = scipy_lsa(cost[k])
        want = float(cost[k][ri, ci].sum())
        assert abs(_total(cost[k], got[k]) - want) <= TOTAL_TOL * max(1.0, abs(want))


@pytest.mark.parametrize("r,c,seed", [(1, 1, 0), (2, 5, 1), (3, 3, 2), (4, 4, 3), (4, 6, 4)])
def test_optimal_against_brute_force(r, c, seed):
    cost = np.random.default_rng(seed).normal(size=(3, r, c)).astype(np.float32)
    got = _plain(cost).numpy()
    for k in range(3):
        best = min(_total(cost[k], np.asarray(p)) for p in itertools.permutations(range(c), r))
        assert abs(_total(cost[k], got[k]) - best) <= 1e-5


def test_refusals():
    with pytest.raises(ValueError, match="rows <= columns"):
        _plain(np.zeros((2, 5, 4), np.float32))
    with pytest.raises(ValueError, match="rows <= columns"):
        matching.linear_sum_assignment(torch.zeros(1, 3, 2))
    with pytest.raises(ValueError, match=r"\[P, R, C\]"):
        matching.linear_sum_assignment(torch.zeros(3, 2))
    with pytest.raises(ValueError, match="unsupported device"):
        matching.linear_sum_assignment(torch.zeros(1, 2, 3, device="meta"))


def test_wrapper_takes_the_plain_version_on_the_cpu():
    cost = torch.from_numpy(np.random.default_rng(7).normal(size=(3, 5, 9)).astype(np.float32))
    before = matching.linear_sum_assignment.launches
    got, steps = matching.linear_sum_assignment(cost.double(), return_steps=True)
    want, want_steps = matching.linear_sum_assignment_plain(cost, return_steps=True)
    assert torch.equal(got, want) and torch.equal(steps, want_steps)
    assert matching.linear_sum_assignment.launches == before  # no kernel on the CPU
    empty = matching.linear_sum_assignment(torch.zeros(2, 0, 4))
    assert empty.shape == (2, 0) and empty.dtype == torch.int64


def test_non_finite_costs_end_with_a_flag():
    """A problem whose costs are not finite may reach no free column (JAX's
    loop never ends there): it stops with steps -1 and rows 0..R-1, the
    other problems solved as ever."""
    cost = np.random.default_rng(8).normal(size=(3, 4, 6)).astype(np.float32)
    cost[1, 2] = np.nan
    cost[2] = np.inf
    got, steps = _plain(cost, return_steps=True)
    assert steps[0] > 0 and steps[1] == steps[2] == -1
    np.testing.assert_array_equal(got[1:].numpy(), [[0, 1, 2, 3]] * 2)
    np.testing.assert_array_equal(got[0].numpy(), _jax(cost[:1])[0])


def test_operator_is_registered_with_its_shapes():
    from torch._subclasses.fake_tensor import FakeTensorMode

    op = torch.ops.layoutdit_torch.linear_sum_assignment.default
    with FakeTensorMode():
        out, steps = op(torch.empty(5, 3, 7))
    assert out.shape == (5, 3) and out.dtype == torch.int64
    assert steps.shape == (5,) and steps.dtype == torch.int32


# ------------------------------------------------------------------ card


@pytest.mark.cuda
def test_kernel_equals_the_plain_version_on_the_card():
    """Row M1 on the card: one launch for all problems, the plain
    version's indices and step counts exactly, at DETR's shapes, with ties
    and constant padded rows, at C = MAX_COLS, and on non-finite costs
    (steps -1, rows 0..R-1, no hang)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    rng = np.random.default_rng(0)
    ties = rng.integers(0, 4, size=(16, 32, 100)).astype(np.float32)
    ties[:, 20:] = 0.0
    bad = rng.normal(size=(3, 8, 10)).astype(np.float32)
    bad[1] = np.nan
    cases = [rng.normal(size=(96, 32, 100)), rng.normal(size=(16, 64, 100)), ties,
             rng.normal(size=(4, 1, 1)), rng.normal(size=(2, 30, matching.MAX_COLS)),
             rng.normal(size=(2, 20, 20)), bad]
    for cost in cases:
        c = torch.from_numpy(np.asarray(cost, np.float32)).cuda()
        before = matching.linear_sum_assignment.launches
        got, steps = matching.linear_sum_assignment(c, return_steps=True)
        assert matching.linear_sum_assignment.launches == before + 1
        want, want_steps = matching.linear_sum_assignment_plain(c, return_steps=True)
        assert torch.equal(got, want), tuple(c.shape)
        assert torch.equal(steps, want_steps), tuple(c.shape)
    with pytest.raises(ValueError, match="columns"):
        matching.linear_sum_assignment(torch.zeros(1, 2, matching.MAX_COLS + 1, device="cuda"))
