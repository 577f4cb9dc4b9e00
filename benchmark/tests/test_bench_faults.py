"""``correct`` against the faults a cell can have, at tiny sizes on the CPU.

Each test drives a whole run (set-up, window, judge) with the look for a
card skipped and the timed path broken underneath ``NMPC.next_batch``:
a re-plan that returns its state unchanged, one that leaves half of the
fleet unsolved, one whose plans are altered where they are produced.
Every one must read as not correct, and the sound run as correct.  (A
one-chip cell has no exchange between chips to leave out.)
"""

import time

import pytest
import torch

from benchmark.harness import driver
from benchmark.harness.layout import Layout

from conftest import CELLS, ROOT, TINY


class _Broken:
    """Wraps the controller: the real re-plan, then ``fault`` breaks its
    carry and result."""

    def __init__(self, mpc, fault):
        self.mpc, self.fault = mpc, fault

    def next_batch(self, x0s, p=None, tvp=None, params=None, carry=None):
        out_carry, res = self.mpc.next_batch(x0s, p=p, tvp=tvp,
                                             params=params, carry=carry)
        if carry is None:          # the cold solve in set-up stays sound
            return out_carry, res
        return self.fault(self.mpc, carry, out_carry, res)


def _result(mpc, carry, res, keep=None):
    """``res`` with its plan read from ``carry`` and every member called
    converged (``keep`` (B,) picks ``res``'s own plan where true)."""
    X, U, _ = mpc.nlp.unpack(carry.w)
    if keep is not None:
        k = keep[:, None, None]
        X, U = torch.where(k, res.x, X), torch.where(k, res.u, U)
    ones = torch.ones_like(res.converged)
    return res._replace(x=X, u=U, converged=ones,
                        kkt_error=torch.zeros_like(res.kkt_error))


def unchanged(mpc, carry_in, carry_out, res):
    return carry_in, _result(mpc, carry_in, res)


def half_left_out(mpc, carry_in, carry_out, res):
    B = carry_out.w.shape[0]
    keep = torch.arange(B, device=carry_out.w.device) < B // 2
    mixed = type(carry_out)(*[
        torch.where(keep.reshape((B,) + (1,) * (a.dim() - 1)), a, b)
        if isinstance(a, torch.Tensor) and a.dim() and a.shape[0] == B
        else a for a, b in zip(carry_out, carry_in)])
    return mixed, _result(mpc, mixed, res, keep=keep)


def altered(mpc, carry_in, carry_out, res):
    """Every control of every plan moved by 0.01 (a third of a percent of
    the quadrotor's thrust range)."""
    X, U, s = mpc.nlp.unpack(carry_out.w)
    w = mpc.nlp.pack(X, U + 1e-2, s)
    return carry_out._replace(w=w), res._replace(u=U + 1e-2)


def _run(workload, wrap=None, control=False, trace=False):
    return driver.run(Layout(ROOT), workload, 2 ** 31 + 7, 0.5, trace,
                      t_start=time.perf_counter(), device="cpu",
                      overrides=TINY[workload], wrap=wrap, control=control)


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    res = _run(workload)
    assert res["correct"], res["checks"]
    assert res["checks"]["compared"]["value"] >= 1
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("fault", [unchanged, half_left_out, altered],
                         ids=lambda f: f.__name__)
@pytest.mark.parametrize("workload", CELLS)
def test_fault_is_not_correct(workload, fault):
    def wrap(cell):
        cell.mpc = _Broken(cell.mpc, fault)
    res = _run(workload, wrap=wrap)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(workload):
    """The configuration's control, its model computed in bf16 in the
    program's place, comes out as not correct."""
    res = _run(workload, control=True)
    assert not res["correct"], res["checks"]
