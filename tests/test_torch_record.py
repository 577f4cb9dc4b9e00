"""The solver's per-iteration trace (ROADMAP Queue 1 #15):
``IPConfig(record=True)`` and ``debug=True`` in the port against the JAX
package's on the CPU.

* ``make_solver(record=True)`` returns ``(result, trace)``: ``kkt_error``,
  ``mu``, ``objective``, ``theta`` and ``done``, each (B, max_iter), equal
  to the JAX package's vmapped trace (``done`` exactly, the rest to
  1e-4·max(1, |ref|) before each member's exit and frozen after it), with
  the same result as the solve without record.
* Through the controller: ``next``, a warm ``next``, ``next_batch`` and
  ``next_multi_start`` (the winner's trace); ``record`` with
  ``differentiable`` raises ValueError.
* ``debug=True`` prints the JAX package's line, one a member an iteration,
  and the polish line.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyneuralempc_tpu as J
import pyneuralempc_tpu_torch as T

import _torch_threads  # noqa: F401  (one torch thread)
from _torch_lv import BENCH_CFG, BOX, REG, lv_true_jax, lv_true_torch

MAX_ITER = 25
TRACE_TOL = 1e-4
FIELDS = ("kkt_error", "mu", "objective", "theta", "done")
X0S = np.array([[0.9, -0.5], [0.8, -0.6], [0.3, -0.7]], np.float32)


def _pair(H=10, **cfg):
    cfg = dict(dict(BENCH_CFG, max_iter=MAX_ITER, record=True), **cfg)
    jm = J.NMPC(J.jax_dynamics(lv_true_jax, 2, 1),
                lambda x, u: 1.1 * jnp.sum(u) + REG * jnp.sum(u * u),
                [J.DomainConstraint(**BOX)], H=H, DT=0.1, integrator="rk4",
                config=J.IPConfig(**cfg))
    tm = T.NMPC(T.torch_dynamics(lv_true_torch, 2, 1),
                lambda x, u: 1.1 * torch.sum(u) + REG * torch.sum(u * u),
                [T.DomainConstraint(**BOX)], H=H, DT=0.1, integrator="rk4",
                config=T.IPConfig(**cfg), device="cpu")
    return jm, tm


def _compare_traces(jt, tt, iterations):
    for k in FIELDS:
        assert tuple(tt[k].shape) == tuple(np.shape(jt[k])), k
    np.testing.assert_array_equal(tt["done"].numpy(), np.asarray(jt["done"]))
    for k in ("kkt_error", "mu", "objective", "theta"):
        ref = np.asarray(jt[k], np.float64)
        got = tt[k].numpy().astype(np.float64)
        err = np.abs(got - ref) / np.maximum(1.0, np.abs(ref))
        assert err.max() <= TRACE_TOL, (k, err.max())
    # frozen after each member's exit
    for b, n in enumerate(iterations):
        for k in ("kkt_error", "mu", "objective", "theta"):
            tail = tt[k][b, n - 1:]
            assert bool((tail == tail[0]).all()), (k, b)


def test_solver_trace_matches_jax():
    jm, tm = _pair()
    rt = T.runtime(torch.as_tensor(X0S))
    rt["_per_member"] = ()
    w0 = tm.cold_start(torch.as_tensor(X0S)).w
    tsolve = T.make_solver(tm.nlp, tm.config)
    tres, tt = tsolve(rt, w0)
    jsolve = J.make_solver(jm.nlp, jm.config)
    jw0 = jax.vmap(lambda x: jm.cold_start(x).w)(jnp.asarray(X0S))
    jres, jt = jax.jit(jax.vmap(lambda x, w: jsolve(J.runtime(x), w)))(
        jnp.asarray(X0S), jw0)
    it = tres.iterations.tolist()
    assert it == np.asarray(jres.iterations).tolist()
    assert max(it) < MAX_ITER and min(it) > 1
    _compare_traces(jt, tt, it)
    # done turns true at each member's own iteration count
    for b, n in enumerate(it):
        assert not bool(tt["done"][b, n - 2]) and bool(tt["done"][b, n - 1])
    # the same result as the solve without record
    plain = T.make_solver(tm.nlp, T.IPConfig(**dict(BENCH_CFG,
                                                    max_iter=MAX_ITER)))
    pres = plain(rt, w0)
    assert torch.equal(pres.w, tres.w)
    assert torch.equal(pres.iterations, tres.iterations)


def test_record_through_the_controller():
    jm, tm = _pair()
    res = tm.next(torch.tensor(X0S[0]))
    assert bool(res.converged)
    assert tuple(res.trace["kkt_error"].shape) == (MAX_ITER,)
    first = float(res.trace["kkt_error"][0])
    done_idx = int(torch.argmax(res.trace["done"].int()))
    assert float(res.trace["kkt_error"][done_idx]) < first
    assert float(res.trace["mu"][done_idx]) <= float(res.trace["mu"][0])
    res2 = tm.next(torch.tensor(X0S[0] + np.float32(0.01)))
    assert tuple(res2.trace["mu"].shape) == (MAX_ITER,)
    carry, bres = tm.next_batch(torch.as_tensor(X0S))
    _, jbres = jm.next_batch(jnp.asarray(X0S))
    assert tuple(bres.trace["kkt_error"].shape) == (3, MAX_ITER)
    _compare_traces(jbres.trace, bres.trace, bres.iterations.tolist())
    # a warm re-plan's trace too
    _, w = tm.next_batch(bres.x[:, 0], carry=carry)
    assert tuple(w.trace["done"].shape) == (3, MAX_ITER)
    assert w.trace["done"][:, -1].tolist() == w.converged.tolist()


def test_multi_start_returns_the_winners_trace():
    _, tm = _pair(polish_iters=0)     # the objective is the last traced
    best, idx = tm.next_multi_start(torch.tensor(X0S[0]), n_starts=3,
                                    return_index=True)
    assert tuple(best.trace["objective"].shape) == (MAX_ITER,)
    n = int(best.iterations)
    assert float(best.trace["objective"][n - 1]) == pytest.approx(
        float(best.objective), rel=1e-6)


def test_record_rejects_differentiable():
    with pytest.raises(ValueError, match="record"):
        T.NMPC(T.torch_dynamics(lv_true_torch, 2, 1),
               lambda x, u: torch.sum(u), [], H=4, DT=0.1,
               config=T.IPConfig(record=True), differentiable=True,
               device="cpu")


def test_debug_prints_each_member_each_iteration(capsys):
    _, tm = _pair(H=6, record=False, debug=True)
    _, res = tm.next_batch(torch.as_tensor(X0S[:2]))
    lines = capsys.readouterr().out.splitlines()
    its = [ln for ln in lines if ln.startswith("it=")]
    # one line a member for every lockstep iteration
    assert len(its) == 2 * int(res.iterations.max())
    assert all(" mu=" in ln and " obj=" in ln and " |dw|=" in ln
               for ln in its)
    polish = [ln for ln in lines if ln.startswith("polish:")]
    assert len(polish) == 2 and "take=" in polish[0]
