"""The augmented-Lagrangian solver (ROADMAP Queue 1 #10): the port's
``ALMConfig`` / ``make_alm_solver`` against the JAX package's on the CPU.

The JAX package's own ``tests/test_alm.py`` cases (raw Lotka-Volterra,
H=10, RK4, a linear cost, box bounds) run on both packages: ALM against
the interior point (plans to 1e-4, and to 2e-4 in the Gauss-Newton mode,
the JAX tests' bounds), a batch of four, the bound duals of the last inner
solve, ``record``'s ValueError and an infeasible problem.  Then bench.py's
LV problem on the plant's own dynamics from starts near the prey bound
(every plan feeds, so the outer loop has work): the port's ALM and the JAX
package's give equal masks and outer iteration counts and plans within
1e-4; each member's multipliers and penalty are its own (a batch of three
gives each member's plan solved alone, to 1e-5).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyneuralempc_tpu as J
import pyneuralempc_tpu_torch as T

import _torch_threads  # noqa: F401  (one torch thread)
from _torch_lv import BOX, REG, lv_true_jax, lv_true_torch

DU_TOL = 1e-4
X0 = [0.3, 0.2]
X0S = np.array([[0.3, 0.2], [0.1, -0.1], [0.2, 0.4], [0.15, 0.05]],
               np.float32)
RAW_BOX = dict(states_constraint=[[-2.0, 2.0]] * 2,
               control_constraint=[[-1.0, 1.0]])
GN = dict(max_iter=40, tol=1e-5, hessian="gauss_newton")


def _lv_j(x, u):
    return jnp.concatenate(
        [0.5 * x[:, :1] - 0.025 * x[:, :1] * x[:, 1:],
         -0.5 * x[:, 1:] + u + 0.005 * x[:, :1] * x[:, 1:]], axis=1)


def _lv_t(x, u):
    return torch.cat([0.5 * x[:, :1] - 0.025 * x[:, :1] * x[:, 1:],
                      -0.5 * x[:, 1:] + u + 0.005 * x[:, :1] * x[:, 1:]],
                     dim=1)


def build_jax(config, box=RAW_BOX):
    return J.NMPC(J.jax_dynamics(_lv_j, x_dim=2, u_dim=1),
                  lambda x, u: jnp.sum(u * 1.1), [J.DomainConstraint(**box)],
                  H=10, DT=0.1, integrator="rk4", config=config)


def build_torch(config, box=RAW_BOX):
    return T.NMPC(T.torch_dynamics(_lv_t, x_dim=2, u_dim=1),
                  lambda x, u: torch.sum(u * 1.1), [T.DomainConstraint(**box)],
                  H=10, DT=0.1, integrator="rk4", config=config, device="cpu")


def _compare(jres, tres, tol=DU_TOL):
    np.testing.assert_array_equal(np.asarray(tres.converged.numpy()),
                                  np.asarray(jres.converged))
    np.testing.assert_array_equal(np.asarray(tres.iterations.numpy()),
                                  np.asarray(jres.iterations))
    du = np.abs(tres.u.numpy() - np.asarray(jres.u)).max()
    assert du <= tol, du


def test_alm_config_matches_jax():
    jc, tc = J.ALMConfig(), T.ALMConfig()
    for name in ("outer_iter", "rho_init", "rho_factor", "rho_max",
                 "tol_feas", "contraction"):
        assert getattr(jc, name) == getattr(tc, name), name
    assert (tc.ip.max_iter, tc.ip.tol) == (jc.ip.max_iter, jc.ip.tol)


@pytest.mark.parametrize("ip", [None, GN], ids=["newton", "gauss_newton"])
def test_alm_matches_ip_and_jax(ip):
    """ALM's plan is the interior point's (1e-4 Newton, 2e-4 Gauss-Newton,
    as the JAX tests hold theirs), and the JAX package's ALM's."""
    tcfg = T.ALMConfig() if ip is None else T.ALMConfig(ip=T.IPConfig(**ip))
    jcfg = J.ALMConfig() if ip is None else J.ALMConfig(ip=J.IPConfig(**ip))
    tm = build_torch(tcfg)
    assert tm.kkt_backend == "alm"
    res = tm.next(torch.tensor(X0))
    assert bool(res.converged)
    ip_res = build_torch(T.IPConfig()).next(torch.tensor(X0))
    assert float((res.u - ip_res.u).abs().max()) <= (
        DU_TOL if ip is None else 2e-4)
    jres = build_jax(jcfg).next(jnp.asarray(X0))
    _compare(jres, res)


def test_alm_batched_matches_jax():
    _, tres = build_torch(T.ALMConfig()).next_batch(torch.as_tensor(X0S))
    _, jres = build_jax(J.ALMConfig()).next_batch(jnp.asarray(X0S))
    assert int(tres.converged.sum()) == 4
    _compare(jres, tres)


def test_alm_returns_real_bound_duals():
    """The last inner solve's bound duals and μ ride in the warm carry: at
    the active lower control bound zl is substantial, as in the JAX
    package."""
    tm = build_torch(T.ALMConfig())
    tm.next(torch.tensor(X0))
    carry = tm._carry
    zl, zu = carry.zl.numpy(), carry.zu.numpy()
    assert float(np.abs(zl).sum() + np.abs(zu).sum()) > 0.0
    assert float(carry.mu) > 0.0
    _, U, _ = tm.nlp.unpack(carry.w)
    u_active = U.numpy().ravel() < -0.999
    assert u_active.any()
    zl_u = zl[0, tm.H * 2:]
    assert (zl_u[u_active] > 1e-3).all()
    jm = build_jax(J.ALMConfig())
    jm.next(jnp.asarray(X0))
    np.testing.assert_allclose(zl[0], np.asarray(jm._carry.zl), rtol=1e-3,
                               atol=1e-6)


def test_alm_rejects_record():
    with pytest.raises(ValueError, match="record"):
        build_torch(T.ALMConfig(ip=T.IPConfig(record=True)))


def test_alm_infeasible_reports_failure():
    box = dict(states_constraint=[[-2.0, 0.25], [-2.0, 2.0]],
               control_constraint=[[-1.0, 1.0]])
    res = build_torch(T.ALMConfig(outer_iter=6), box).next(torch.tensor(X0))
    assert not bool(res.converged)
    jres = build_jax(J.ALMConfig(outer_iter=6), box).next(jnp.asarray(X0))
    assert int(res.iterations) == int(jres.iterations) == 6


LV_X0S = np.array([[0.9, -0.5], [0.8, -0.6], [0.7, -0.4]], np.float32)


def _feed_mpcs(H=10):
    cost_j = lambda x, u: 1.1 * jnp.sum(u) + REG * jnp.sum(u * u)  # noqa
    cost_t = lambda x, u: 1.1 * torch.sum(u) + REG * torch.sum(u * u)  # noqa
    jm = J.NMPC(J.jax_dynamics(lv_true_jax, 2, 1), cost_j,
                [J.DomainConstraint(**BOX)], H=H, DT=0.1, integrator="rk4",
                config=J.ALMConfig())
    tm = T.NMPC(T.torch_dynamics(lv_true_torch, 2, 1), cost_t,
                [T.DomainConstraint(**BOX)], H=H, DT=0.1, integrator="rk4",
                config=T.ALMConfig(), device="cpu")
    return jm, tm


def test_alm_feeding_plans_match_jax():
    jm, tm = _feed_mpcs()
    _, jres = jm.next_batch(jnp.asarray(LV_X0S))
    _, tres = tm.next_batch(torch.as_tensor(LV_X0S))
    _compare(jres, tres)
    assert bool(tres.converged.all())
    assert float(tres.u.max()) > 0.1           # the plans feed
    np.testing.assert_allclose(tres.objective.numpy(),
                               np.asarray(jres.objective), rtol=1e-5)


def test_alm_members_are_their_own():
    """y and ρ are per member: each member of a batch of three gives the
    plan and outer iterations it gives alone."""
    _, tm = _feed_mpcs()
    _, both = tm.next_batch(torch.as_tensor(LV_X0S))
    for i in range(len(LV_X0S)):
        _, alone = tm.next_batch(torch.as_tensor(LV_X0S[i:i + 1]))
        assert int(both.iterations[i]) == int(alone.iterations[0])
        assert float((both.u[i] - alone.u[0]).abs().max()) <= 1e-5
