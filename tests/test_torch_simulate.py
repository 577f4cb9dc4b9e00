"""The port's closed-loop harness (``api/simulate.py``) against the JAX
package's on tests/test_simulate_batch.py's problem (raw Lotka-Volterra,
1.1·Σu + 0.05·Σx², box bounds, H=8, RK4), on the CPU, the same numpy
starts in both: ``closed_loop`` and ``closed_loop_batch`` with and without
a horizon feed floor Σu ≥ FLOOR (one trajectory-level row with a slack, the
general sweep at R=2, r=0), x and u within 1e-4, converged flags and
iteration counts equal; the cadence and ``tvp_seq`` errors; the failure
policy under a forced non-convergence; the ``tvp_seq`` windows; per-member
``params`` refused.

With the floor active, moving feed between stages at constant Σu is
tie-broken only by the state cost, so the floor problem weighs the states
0.5 (not 0.05), as tests/test_riccati_eq_border.py's budget test does: at
0.05 the plans still agree to 3e-5, but the last iterations follow rounding
and one re-plan's iteration count differs by one."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyneuralempc_tpu as J
import pyneuralempc_tpu_torch as T
from pyneuralempc_tpu.api import simulate as jsim
from pyneuralempc_tpu_torch.api import simulate as tsim

import _torch_threads  # noqa: F401  (one torch thread)

TOL = 1e-4
H = 8
# binds: the unconstrained plans drive u to its lower bound -1 (Σu = -8)
FLOOR = -4.0
X0S = np.asarray([[0.4, -0.5], [0.6, -0.7], [0.25, -0.4]], np.float32)


def _lv(lib):
    cat = jnp.concatenate if lib is jnp else torch.cat

    def f(x, u):
        return cat([0.5 * x[:, :1] - 0.025 * x[:, :1] * x[:, 1:],
                    -0.5 * x[:, 1:] + u + 0.005 * x[:, :1] * x[:, 1:]], 1)
    return f


def _mpc(P, lib, floor=False, **cfg):
    ssum = jnp.sum if lib is jnp else torch.sum
    model = (J.jax_dynamics(_lv(jnp), 2, 1) if lib is jnp
             else T.torch_dynamics(_lv(torch), 2, 1))
    w_x = 0.5 if floor else 0.05
    cost = P.StageCost(stage=lambda x, u: 1.1 * ssum(u)
                       + w_x * ssum(x ** 2))
    cons = [P.DomainConstraint(states_constraint=[[-2.0, 2.0]] * 2,
                               control_constraint=[[-1.0, 1.0]])]
    if floor:
        fn = ((lambda x, u: jnp.sum(u, keepdims=True)) if lib is jnp
              else (lambda x, u: u.sum(dim=0)))
        cons.append(P.PathConstraint(fn=fn, dim=1, lb=(FLOOR,),
                                     ub=(float("inf"),)))
    kw = {} if lib is jnp else {"device": "cpu"}
    return P.NMPC(model, cost, cons, H=H, DT=0.1, integrator="rk4",
                  config=P.IPConfig(**(cfg or {"tol": 1e-6})), **kw)


def _both(floor=False, **cfg):
    jm, tm = _mpc(J, jnp, floor, **cfg), _mpc(T, torch, floor, **cfg)
    return (jm, jsim.plant_from_model(jm.model, "rk4", 0.1),
            tm, tsim.plant_from_model(tm.model, "rk4", 0.1))


def _close(port, ref):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), atol=TOL,
                               rtol=0)


@pytest.mark.parametrize("floor,replan_every", [(False, 1), (True, 2)])
def test_closed_loop_batch_matches_jax(floor, replan_every):
    jm, jplant, tm, tplant = _both(floor)
    ref = jsim.closed_loop_batch(jm, jplant, jnp.asarray(X0S), steps=4,
                                 replan_every=replan_every)
    out = tsim.closed_loop_batch(tm, tplant, torch.as_tensor(X0S), steps=4,
                                 replan_every=replan_every)
    n_solves = 4 // replan_every + 1
    assert out.x.shape == (5, 3, 2) and out.u.shape == (4, 3, 1)
    for f in ("converged", "iterations", "objective", "theta"):
        assert getattr(out, f).shape == (n_solves, 3)
    np.testing.assert_array_equal(out.converged.numpy(),
                                  np.asarray(ref.converged))
    np.testing.assert_array_equal(out.iterations.numpy(),
                                  np.asarray(ref.iterations))
    assert bool(out.converged.all())
    _close(out.x, ref.x)
    _close(out.u, ref.u)
    if floor:     # the floor binds on the played plans' first solve
        _, res = tm.next_batch(torch.as_tensor(X0S))
        total = res.u.sum(dim=(1, 2))
        assert float(total.min()) >= FLOOR - 1e-5
        assert float((total - FLOOR).abs().max()) < 1e-4


@pytest.mark.parametrize("floor,replan_every", [(False, 2), (True, 1)])
def test_closed_loop_matches_jax(floor, replan_every):
    jm, jplant, tm, tplant = _both(floor)
    ref = jsim.closed_loop(jm, jplant, jnp.asarray(X0S[0]), steps=4,
                           replan_every=replan_every)
    out = tsim.closed_loop(tm, tplant, torch.as_tensor(X0S[0]), steps=4,
                           replan_every=replan_every)
    assert out.x.shape == (5, 2) and out.u.shape == (4, 1)
    np.testing.assert_array_equal(out.converged, ref.converged)
    np.testing.assert_array_equal(out.iterations, ref.iterations)
    assert out.converged.all() and len(out.converged) == 4 // replan_every
    _close(out.x, ref.x)
    _close(out.u, ref.u)
    np.testing.assert_allclose(out.objective, ref.objective, atol=TOL)


def test_cadence_and_tvp_seq_errors():
    tm = _mpc(T, torch)
    plant = tsim.plant_from_model(tm.model, "rk4", 0.1)
    x0s = torch.as_tensor(X0S)
    with pytest.raises(ValueError, match="multiple of replan_every"):
        tsim.closed_loop_batch(tm, plant, x0s, steps=5, replan_every=2)
    with pytest.raises(ValueError, match="cannot exceed the horizon"):
        tsim.closed_loop_batch(tm, plant, x0s, steps=16, replan_every=16)
    with pytest.raises(ValueError, match="n_replans"):
        tsim.closed_loop_batch(tm, plant, x0s, steps=2, replan_every=1,
                               tvp_seq=torch.zeros(2, H, 1))


def test_failure_policy_keeps_previous_plan():
    """A member whose re-plan fails keeps playing its shifted old plan:
    failure forced by a 1-iteration cap at a 1e-10 tolerance (the JAX
    package's test_failure_policy_keeps_previous_plan).  Every played
    control is the cold plan's, in order, and the plant follows it."""
    tm = _mpc(T, torch, max_iter=1, tol=1e-10)
    plant = tsim.plant_from_model(tm.model, "rk4", 0.1)
    out = tsim.closed_loop_batch(tm, plant, torch.as_tensor(X0S), steps=4)
    assert not bool(out.converged.any())
    assert bool(torch.isfinite(out.x).all())
    assert bool((out.iterations == 1).all())
    _, cold = tm.next_batch(torch.as_tensor(X0S))
    assert torch.equal(out.u.transpose(0, 1), cold.u[:, :4])
    x = torch.as_tensor(X0S)
    for t in range(4):
        x = torch.func.vmap(plant)(x, cold.u[:, t])
        assert torch.equal(out.x[t + 1], x)


def test_tvp_seq_windows_reach_each_solve():
    """A price tvp that flips sign between windows flips the planned
    controls with it: each solve saw its own window."""
    model = T.torch_dynamics(lambda x, u, p=None, tvp=None: _lv(torch)(x, u),
                             x_dim=2, u_dim=1, tvp_dim=1)
    cost = T.StageCost(stage=lambda x, u, p, tvp: torch.sum(tvp[0] * u)
                       + 0.05 * torch.sum(x ** 2))
    box = T.DomainConstraint(states_constraint=[[-2.0, 2.0]] * 2,
                             control_constraint=[[-1.0, 1.0]])
    Hs = 6
    mpc = T.NMPC(model, cost, [box], H=Hs, DT=0.1, integrator="rk4",
                 config=T.IPConfig(tol=1e-5), device="cpu")
    plant = tsim.plant_from_model(mpc.model, "rk4", 0.1)
    tvp_seq = torch.stack([torch.full((Hs, 1), 1.0), torch.full((Hs, 1), 1.0),
                           torch.full((Hs, 1), -1.0)])
    out = tsim.closed_loop_batch(mpc, plant, torch.as_tensor(X0S[:2]),
                                 steps=2, replan_every=1, tvp_seq=tvp_seq)
    assert bool(out.converged.all())
    assert float(out.u[0].max()) < 0.0 and float(out.u[1].max()) < 0.0
    # the last window (price -1) pushes the last, unplayed plan up
    _, last = mpc.next_batch(out.x[-1], tvp=tvp_seq[-1])
    assert float(last.u[:, 0].min()) > 0.0


def test_per_member_params_raise():
    """Per-member params in closed_loop_batch (one surrogate per plant, the
    JAX package's rule): the JAX package's closed loop on the same stacked
    weights, and, with every member's weights the shared set's, the shared
    run.  (They raised, naming ROADMAP Queue 1 #6b, until the port took
    them.)"""
    from pyneuralempc_tpu.models.mlp import MLPDynamics as JMLP
    import jax
    sur = T.MLPDynamics.make(x_dim=2, u_dim=1, hidden=[8])
    p0 = sur.init_params(torch.Generator().manual_seed(0), device="cpu")
    p1 = sur.init_params(torch.Generator().manual_seed(1), device="cpu")
    stacked = [{k: torch.stack([a[k], b[k]]) for k in a}
               for a, b in zip(p0, p1)]
    cost = T.StageCost(stage=lambda x, u: torch.sum(u ** 2)
                       + torch.sum((x - 0.2) ** 2))
    box = T.DomainConstraint(states_constraint=[[-2.0, 2.0]] * 2,
                             control_constraint=[[-1.0, 1.0]])
    mpc = T.NMPC(sur, cost, [box], H=5, DT=0.1, integrator="rk4",
                 config=T.IPConfig(tol=1e-5), device="cpu")
    plant = tsim.plant_from_model(sur, "rk4", 0.1, params=p0)
    x0s = torch.full((2, 2), 0.1)
    out = tsim.closed_loop_batch(mpc, plant, x0s, steps=2, params=stacked)
    assert bool(out.converged.all()) and out.x.shape == (3, 2, 2)
    assert float((out.u[:, 0] - out.u[:, 1]).abs().max()) > 1e-4

    def jx(tree):
        return jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), tree)
    jsur = JMLP.make(x_dim=2, u_dim=1, hidden=[8])
    jmpc = J.NMPC(jsur, J.StageCost(stage=lambda x, u: jnp.sum(u ** 2)
                                    + jnp.sum((x - 0.2) ** 2)),
                  [J.DomainConstraint(states_constraint=[[-2.0, 2.0]] * 2,
                                      control_constraint=[[-1.0, 1.0]])],
                  H=5, DT=0.1, integrator="rk4", config=J.IPConfig(tol=1e-5))
    ref = jsim.closed_loop_batch(
        jmpc, jsim.plant_from_model(jsur, "rk4", 0.1, params=jx(p0)),
        jnp.asarray(x0s.numpy()), steps=2, params=jx(stacked))
    np.testing.assert_array_equal(out.converged.numpy(),
                                  np.asarray(ref.converged))
    np.testing.assert_array_equal(out.iterations.numpy(),
                                  np.asarray(ref.iterations))
    _close(out.x, ref.x)
    _close(out.u, ref.u)
    # every member the shared set: the shared run
    same = [{k: torch.stack([v, v]) for k, v in layer.items()}
            for layer in p0]
    a = tsim.closed_loop_batch(mpc, plant, x0s, steps=2, params=same)
    b = tsim.closed_loop_batch(mpc, plant, x0s, steps=2, params=p0)
    assert torch.equal(a.converged, b.converged)
    assert float((a.u - b.u).abs().max()) <= 1e-5
