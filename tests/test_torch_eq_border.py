"""Stage-equality rows, trajectory-level border rows and stage inequality
rows through the port's NMPC (``device="cpu"``, ``kkt="riccati"``) against
the JAX package's NMPC on the same problems: the LV problems of
tests/test_riccati_eq_border.py (stage EQ, trajectory budget, trajectory
EQ, the mixed problem) and the double integrator of
tests/test_stage_constraints.py, each on a batch of starts, cold and one
warm re-plan (the trajectory EQ problem cold only).  Converged masks and per-member iteration counts equal,
|u_port − u_jax|∞ ≤ 1e-4 (bench.py's control criterion); the trajectory
EQ problem's iteration counts are not compared (its f32 dual-residual
floor, ~2.4e-5 on both JAX backends, sits near its tol of 1e-4, so the
last iterations follow rounding; the JAX tests pin no count for it).
Then the eligibility caps."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyneuralempc_tpu as J
import pyneuralempc_tpu_torch as T

import _torch_threads  # noqa: F401  (one torch thread)

DU_TOL = 1e-4
INF = float("inf")
LV_X0S = np.asarray([[0.3, 0.2], [0.25, 0.1], [0.35, 0.3]], np.float32)
# starts from which the terminal-EQ target is reachable (the control moves
# the prey only through the predator, weakly)
TERMINAL_X0S = np.asarray([[0.3, 0.2], [0.3, 0.22], [0.3, 0.17]],
                          np.float32)


def _lv(lib):
    cat = jnp.concatenate if lib is jnp else torch.cat

    def f(x, u):
        return cat([0.5 * x[:, :1] - 0.025 * x[:, :1] * x[:, 1:],
                    -0.5 * x[:, 1:] + u + 0.005 * x[:, :1] * x[:, 1:]], 1)
    return f


def _di(lib):
    cat = jnp.concatenate if lib is jnp else torch.cat

    def f(x, u):
        return cat([x[:, 1:2], u], 1)
    return f


def _model(P, lib, f):
    return (J.jax_dynamics(f(jnp), 2, 1) if lib is jnp
            else T.torch_dynamics(f(torch), 2, 1))


def _one(lib, v):
    """A scalar as a 1-row vector."""
    return jnp.atleast_1d(v) if lib is jnp else v.reshape(1)


def _lv_problem(P, lib, kind):
    """(cost, constraints, tol, max_iter) of one LV problem of
    tests/test_riccati_eq_border.py."""
    ssum = jnp.sum if lib is jnp else torch.sum
    box = P.DomainConstraint(states_constraint=[[-2.0, 2.0]] * 2,
                             control_constraint=[[-1.0, 1.0]])
    w_x = 0.5 if kind == "budget" else 0.1
    cost = P.StageCost(stage=lambda x, u: ssum(u * 1.1) + w_x * ssum(x ** 2))
    eqc = P.StageConstraint(stage=lambda x, u: u[0] - 0.2 * x[1], dim=1,
                            lb=(0.1,), ub=(0.1,))
    if kind == "stage_eq":
        return cost, [box, eqc], 1e-6, 80
    if kind == "budget":
        tc = P.PathConstraint(fn=lambda x, u: _one(lib, ssum(u)), dim=1,
                              lb=(-1.5,), ub=(INF,))
        return cost, [box, tc], 1e-6, 80
    if kind == "terminal_eq":
        # the terminal prey value of the u = 0.4 rollout from (0.3, 0.2)
        target = 0.4448198974132538
        tc = P.PathConstraint(fn=lambda x, u: x[-1:, 0], dim=1,
                              lb=(target,), ub=(target,))
        return cost, [box, tc], 1e-4, 80
    ineq = P.StageConstraint(stage=lambda x, u: x[0] + x[1], dim=1,
                             lb=(-1.5,), ub=(1.5,))
    tc = P.PathConstraint(fn=lambda x, u: _one(lib, ssum(x[:, 1])), dim=1,
                          lb=(-INF,), ub=(3.0,))
    return cost, [box, ineq, eqc, tc], 1e-6, 100


def _solve_both(make, x0s, iterations=True, warm=True):
    """Cold solve and one warm re-plan from the JAX plan's first states
    through both packages; compares them and returns the port's results."""
    jm, tm = make(J, jnp), make(T, torch)
    assert jm.kkt_backend == tm.kkt_backend == "riccati"
    jc, jres = jm.next_batch(jnp.asarray(x0s))
    tc, tres = tm.next_batch(torch.as_tensor(x0s))
    out = [_compare(jres, tres, iterations)]
    if warm:
        xs = np.asarray(jres.x[:, 0], np.float32)
        jc, jres = jm.next_batch(jnp.asarray(xs), carry=jc)
        tc, tres = tm.next_batch(torch.as_tensor(xs), carry=tc)
        out.append(_compare(jres, tres, iterations))
    return out


def _compare(jres, tres, iterations=True):
    np.testing.assert_array_equal(tres.converged.numpy(),
                                  np.asarray(jres.converged))
    if iterations:
        np.testing.assert_array_equal(tres.iterations.numpy(),
                                      np.asarray(jres.iterations))
    du = np.abs(tres.u.numpy() - np.asarray(jres.u)).max()
    assert du <= DU_TOL, du
    assert bool(tres.converged.all())
    return tres


def _lv_mpc(kind):
    def make(P, lib):
        cost, cons, tol, max_iter = _lv_problem(P, lib, kind)
        kw = {} if lib is jnp else {"device": "cpu"}
        return P.NMPC(_model(P, lib, _lv), cost, cons, H=8, DT=0.1,
                      integrator="rk4",
                      config=P.IPConfig(tol=tol, max_iter=max_iter,
                                        kkt="riccati"), **kw)
    return make


@pytest.mark.parametrize("kind", ["stage_eq", "budget", "terminal_eq",
                                  "mixed"])
def test_lv_problems_match_jax(kind):
    # the terminal target is fixed, so a re-plan one step later cannot reach
    # it within the shifted horizon: that problem is solved cold only
    terminal = kind == "terminal_eq"
    results = _solve_both(_lv_mpc(kind), TERMINAL_X0S if terminal
                          else LV_X0S, iterations=not terminal,
                          warm=not terminal)
    cold = results[0]
    for res in results:
        if kind in ("stage_eq", "mixed"):
            g = res.u[..., 0] - 0.2 * res.x[..., 1]
            np.testing.assert_allclose(g.numpy(), 0.1, atol=5e-6)
        if kind == "budget":
            assert float(res.u.sum(dim=(1, 2)).min()) >= -1.5 - 1e-5
        if kind == "terminal_eq":
            np.testing.assert_allclose(res.x[:, -1, 0].numpy(), 0.44481990,
                                       atol=1e-5)
    if kind == "budget":      # active at the optimum
        assert float((cold.u.sum(dim=(1, 2)) + 1.5).abs().min()) < 1e-5


def test_stage_inequality_problem_matches_jax():
    """The double integrator pushed rightward with pos² ≤ 0.25 binding:
    stage interval rows fold into the plain sweep (no general path)."""
    def make(P, lib):
        ssum = jnp.sum if lib is jnp else torch.sum
        cost = P.StageCost(stage=lambda x, u: -x[0] + 0.1 * ssum(u ** 2))
        box = P.DomainConstraint(states_constraint=[[-2.0, 2.0],
                                                    [-3.0, 3.0]],
                                 control_constraint=[[-3.0, 3.0]])
        pc = P.stage_interval(lambda x, u: _one(lib, x[0] ** 2), dim=1,
                              lb=-np.inf, ub=0.25)
        kw = {} if lib is jnp else {"device": "cpu"}
        return P.NMPC(_model(P, lib, _di), cost, [box, pc], H=10, DT=0.1,
                      integrator="rk4",
                      config=P.IPConfig(max_iter=80, kkt="riccati"), **kw)

    from pyneuralempc_tpu_torch.solve.riccati import make_riccati_direction
    tm = make(T, torch)
    assert not make_riccati_direction(tm.nlp, tm.config).general
    x0s = np.asarray([[0.0, 1.0], [-0.3, 0.5], [0.2, -0.4], [0.3, 0.8]],
                     np.float32)
    for res in _solve_both(make, x0s):
        assert float((res.x[..., 0] ** 2).max()) <= 0.25 + 1e-3


def test_constraint_order_does_not_matter():
    """A border row listed before a stage row gives the same plans as the
    other order.  (The JAX package's Riccati path assembles the step with
    every stage constraint before every border row whatever the spec order,
    and with the border first fails to converge; its dense backend does
    not.  The port assembles in spec order.)"""
    def make(order):
        box = T.DomainConstraint(states_constraint=[[-2.0, 2.0]] * 2,
                                 control_constraint=[[-1.0, 1.0]])
        cost = T.StageCost(stage=lambda x, u: torch.sum(u * 1.1)
                           + 0.5 * torch.sum(x ** 2))
        ineq = T.StageConstraint(stage=lambda x, u: x[0] + x[1], dim=1,
                                 lb=(-1.5,), ub=(1.5,))
        tc = T.PathConstraint(fn=lambda x, u: torch.sum(u).reshape(1),
                              dim=1, lb=(-1.5,), ub=(INF,))
        cons = [box, ineq, tc] if order else [box, tc, ineq]
        return T.NMPC(_model(T, torch, _lv), cost, cons, H=8, DT=0.1,
                      config=T.IPConfig(tol=1e-6, kkt="riccati"),
                      device="cpu")

    x0s = torch.as_tensor(LV_X0S)
    _, a = make(True).next_batch(x0s)
    _, b = make(False).next_batch(x0s)
    assert bool(a.converged.all()) and bool(b.converged.all())
    assert torch.equal(a.iterations, b.iterations)
    assert float((a.u - b.u).abs().max()) <= 1e-6
    # the slacks come back in spec order too
    assert torch.equal(a.slack[:, :8], b.slack[:, 1:])


def test_ineligible_specs_raise():
    """More equality rows a stage than controls, or more than 64 border
    rows, need the dense backend: NMPC takes it under kkt="auto", and the
    Riccati direction factory refuses under kkt="riccati"."""
    box = T.DomainConstraint(states_constraint=[[-2.0, 2.0]] * 2,
                             control_constraint=[[-1.0, 1.0]])
    cost = T.StageCost(stage=lambda x, u: torch.sum(u))
    eq2 = T.StageConstraint(stage=lambda x, u: torch.stack([u[0] - x[0],
                                                            u[0] - x[1]]),
                            dim=2, lb=(0.0, 0.0), ub=(0.0, 0.0))
    big = T.PathConstraint(fn=lambda x, u: u.reshape(-1).repeat(9)[:65],
                           dim=65, lb=(0.0,) * 65, ub=(INF,) * 65)
    model = _model(T, torch, _lv)
    for pc, H in ((eq2, 4), (big, 8)):
        assert T.NMPC(model, cost, [box, pc], H=H, DT=0.1,
                      device="cpu").kkt_backend == "dense"
        with pytest.raises(ValueError, match="at most 64"):
            T.NMPC(model, cost, [box, pc], H=H, DT=0.1, device="cpu",
                   config=T.IPConfig(kkt="riccati"))
    ok = T.PathConstraint(fn=lambda x, u: torch.sum(u).reshape(1), dim=1,
                          lb=(-1.0,), ub=(INF,))
    assert T.NMPC(model, cost, [box, ok], H=8, DT=0.1,
                  device="cpu").kkt_backend == "riccati"
