"""Path and stage constraints in the port's problem IR and transcription,
against the JAX package on the CPU: the constraint classes and their row
types, ``expand_constraint``, and ``transcribe``'s sizes, bounds, C(w),
``init_slacks`` and ``shift_slacks`` on an LV spec with a stage interval
row, a stage EQ row and a trajectory border row.  Same numpy inputs through
both packages, atol 1e-6."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyneuralempc_tpu as J
import pyneuralempc_tpu_torch as T
from pyneuralempc_tpu.core.problem import expand_constraint as j_expand
from pyneuralempc_tpu_torch.core.problem import expand_constraint as t_expand

import _torch_threads  # noqa: F401  (one torch thread)

ATOL = 1e-6
H = 5
INF = float("inf")


def _lv(lib):
    cat = jnp.concatenate if lib is jnp else torch.cat

    def f(x, u):
        return cat([0.5 * x[:, :1] - 0.025 * x[:, :1] * x[:, 1:],
                    -0.5 * x[:, 1:] + u + 0.005 * x[:, :1] * x[:, 1:]], 1)
    return f


def _constraints(P, lib):
    """Stage interval row, stage EQ row (lb 0.1) with an INEQ row beside
    it, and a two-row border (one EQ, one upper-bounded)."""
    s = lib.stack if lib is jnp else torch.stack
    interval = P.stage_interval(lambda x, u: (x[0] ** 2 + x[1] ** 2)[None],
                                dim=1, lb=-INF, ub=1.2)
    mixed = P.StageConstraint(stage=lambda x, u: s([u[0] - 0.2 * x[1],
                                                    x[0] + u[0]]),
                              dim=2, lb=(0.1, 0.0), ub=(0.1, INF))
    border = P.PathConstraint(fn=lambda x, u: s([x[-1, 0], u.sum()]),
                              dim=2, lb=(0.4, -INF), ub=(0.4, 3.0))
    return [interval, mixed, border]


def _specs():
    jbox = J.DomainConstraint(states_constraint=[[-2.0, 2.0]] * 2,
                              control_constraint=[[-1.0, 1.0]])
    tbox = T.DomainConstraint(states_constraint=[[-2.0, 2.0]] * 2,
                              control_constraint=[[-1.0, 1.0]])
    jcost = J.StageCost(stage=lambda x, u: jnp.sum(u))
    tcost = T.StageCost(stage=lambda x, u: torch.sum(u))
    js = J.MPCSpec(model=J.jax_dynamics(_lv(jnp), 2, 1), integrator="rk4",
                   objective=jcost, box=jbox,
                   path_constraints=tuple(_constraints(J, jnp)), H=H, DT=0.1)
    ts = T.MPCSpec(model=T.torch_dynamics(_lv(torch), 2, 1),
                   integrator="rk4", objective=tcost, box=tbox, H=H, DT=0.1,
                   path_constraints=tuple(_constraints(T, torch)))
    return js, ts


def test_row_types_and_helpers_match_jax():
    for jc, tc in zip(_constraints(J, jnp), _constraints(T, torch)):
        np.testing.assert_array_equal(tc.row_types(), jc.row_types())
        assert (tc.lb, tc.ub, tc.dim) == (jc.lb, jc.ub, jc.dim)
    pairs = [(J.stage_inequality(None, 2), T.stage_inequality(None, 2)),
             (J.equality_constraint(None, 3), T.equality_constraint(None, 3)),
             (J.inequality_constraint(None, 1),
              T.inequality_constraint(None, 1)),
             (J.interval_constraint(None, 2, [0, -1], 5),
              T.interval_constraint(None, 2, [0, -1], 5))]
    for jc, tc in pairs:
        assert type(tc).__name__ == type(jc).__name__
        assert (tc.lb, tc.ub) == (jc.lb, jc.ub)
        np.testing.assert_array_equal(tc.row_types(), jc.row_types())
        if hasattr(jc, "get_type"):
            assert tc.get_type() == jc.get_type()
    with pytest.raises(ValueError, match="lower > upper"):
        T.StageConstraint(stage=None, dim=1, lb=(1.0,), ub=(0.0,))
    with pytest.raises(ValueError, match="length == dim"):
        T.PathConstraint(fn=None, dim=2, lb=(0.0,), ub=(1.0,))


def test_expand_and_stage_call_match_jax():
    rng = np.random.default_rng(0)
    X = rng.uniform(-1, 1, (H, 2)).astype(np.float32)
    U = rng.uniform(-1, 1, (H, 1)).astype(np.float32)
    for jc, tc in zip(_constraints(J, jnp), _constraints(T, torch)):
        jf, jn, jt, jlb, jub = j_expand(jc, H)
        tf, tn, tt, tlb, tub = t_expand(tc, H)
        assert tn == jn
        for a, b in ((tt, jt), (tlb, jlb), (tub, jub)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(
            tf(torch.as_tensor(X), torch.as_tensor(U), None, None).numpy(),
            np.asarray(jf(jnp.asarray(X), jnp.asarray(U), None, None)),
            atol=ATOL, rtol=0)
    st = _constraints(T, torch)[1]
    assert st(torch.as_tensor(X), torch.as_tensor(U)).shape == (H, 2)


def test_transcription_matches_jax():
    js, ts = _specs()
    jn, tn = J.transcribe(js), T.transcribe(ts, device="cpu")
    # slacks: the interval rows (H), the INEQ rows of the mixed constraint
    # (H) and the border's upper-bounded row (1)
    assert ts.n_slack == js.n_slack == 2 * H + 1
    assert (tn.n, tn.m) == (jn.n, jn.m) == (3 * H + 2 * H + 1,
                                            2 * H + 3 * H + 2)
    np.testing.assert_array_equal(tn.lower.numpy(), np.asarray(jn.lower))
    np.testing.assert_array_equal(tn.upper.numpy(), np.asarray(jn.upper))

    rng = np.random.default_rng(1)
    x0 = np.asarray([0.4, -0.6], np.float32)
    jrt, trt = J.runtime(jnp.asarray(x0)), T.runtime(torch.as_tensor(x0))
    for _ in range(3):
        w = rng.uniform(-0.9, 0.9, jn.n).astype(np.float32)
        jw, tw = jnp.asarray(w), torch.as_tensor(w)
        np.testing.assert_allclose(tn.constraints(tw, trt).numpy(),
                                   np.asarray(jn.constraints(jw, jrt)),
                                   atol=ATOL, rtol=0)
        jX, jU, js_ = jn.unpack(jw)
        tX, tU, ts_ = tn.unpack(tw)
        np.testing.assert_array_equal(ts_.numpy(), np.asarray(js_))
        np.testing.assert_array_equal(tn.pack(tX, tU, ts_).numpy(), w)
        np.testing.assert_allclose(tn.init_slacks(tX, tU, trt).numpy(),
                                   np.asarray(jn.init_slacks(jX, jU, jrt)),
                                   atol=ATOL, rtol=0)
        np.testing.assert_array_equal(tn.shift_slacks(ts_).numpy(),
                                      np.asarray(jn.shift_slacks(js_)))


def test_batched_slacks():
    """init_slacks and shift_slacks act on batches as on single problems,
    and pack without slacks pads zeros as the JAX package's does."""
    _, ts = _specs()
    tn = T.transcribe(ts, device="cpu")
    rng = np.random.default_rng(2)
    w = torch.as_tensor(rng.uniform(-0.9, 0.9, (3, tn.n)).astype(np.float32))
    X, U, s = tn.unpack(w)
    rt = T.runtime(torch.zeros(2))
    batched = tn.init_slacks(X, U, rt)
    assert batched.shape == (3, ts.n_slack)
    for b in range(3):
        assert torch.equal(batched[b], tn.init_slacks(X[b], U[b], rt))
        assert torch.equal(tn.shift_slacks(s)[b], tn.shift_slacks(s[b]))
    assert torch.equal(tn.pack(X, U)[:, ts.n_primal:],
                       torch.zeros(3, ts.n_slack))


def test_controller_takes_constraints():
    _, ts = _specs()
    mpc = T.NMPC(ts.model, ts.objective, [ts.box, *ts.path_constraints],
                 H=H, DT=0.1, device="cpu")
    assert mpc.spec.path_constraints == ts.path_constraints
    assert mpc.kkt_backend == "riccati"
    with pytest.raises(TypeError, match="unknown constraint"):
        T.NMPC(ts.model, ts.objective, [ts.box, object()], H=H, DT=0.1,
               device="cpu")
