"""The EQ/border quadrotor fleet (the quadrotor with a zero-net-yaw-torque
stage equality row and a horizon thrust-impulse budget row):
``pyneuralempc_tpu_torch.examples.fleet_eq`` on the CPU against the same
problem built with the JAX package (``tools/fleet_eq_tpu.py --border``'s),
``next_batch`` of 4 problems from the fleet draw, cold and one warm re-plan
from ``res.x[:, 0]``: converged masks and per-member iteration counts equal,
|u_port − u_jax|∞ ≤ 1e-4, the equality row held to the solver's tol and
the budget honoured."""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import torch

import pyneuralempc_tpu as J
from pyneuralempc_tpu_torch.examples import fleet_eq as FE
from pyneuralempc_tpu_torch.examples import quadrotor as TQ

import _torch_threads  # noqa: F401  (one torch thread)

ROOT = Path(__file__).resolve().parents[1]
H, DT, B = 50, 0.02, 4
DU_TOL = 1e-4


def _jax_quadrotor():
    spec = importlib.util.spec_from_file_location(
        "jax_quadrotor_example", ROOT / "examples" / "quadrotor.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_mpc():
    JQ = _jax_quadrotor()
    cost = J.StageCost(
        stage=lambda x, u: (jnp.sum(x[:3] ** 2) + 0.1 * jnp.sum(x[3:6] ** 2)
                            + 0.5 * jnp.sum(x[6:8] ** 2) + 0.1 * x[8] ** 2
                            + 0.02 * jnp.sum(x[9:] ** 2)
                            + 0.05 * jnp.sum((u - JQ.F_HOVER) ** 2)),
        terminal=lambda x: 5.0 * (jnp.sum(x[:3] ** 2)
                                  + jnp.sum(x[3:6] ** 2)))
    box = J.DomainConstraint(
        states_constraint=[[-5.0, 5.0]] * 3 + [[-8.0, 8.0]] * 3
        + [[-0.8, 0.8]] * 2 + [[-np.pi, np.pi]] + [[-8.0, 8.0]] * 3,
        control_constraint=[[0.0, 3.0]] * 4)
    yaw = J.StageConstraint(stage=lambda x, u: (u[0] - u[1] + u[2]
                                                - u[3])[None],
                            dim=1, lb=(0.0,), ub=(0.0,))
    budget = J.PathConstraint(fn=lambda X, U: jnp.sum(U)[None], dim=1,
                              lb=(0.0,), ub=(50 * 4 * JQ.F_HOVER * 1.15,))
    assert FE.BUDGET == 50 * 4 * JQ.F_HOVER * 1.15
    return J.NMPC(J.jax_dynamics(JQ.quad_f(), x_dim=12, u_dim=4), cost,
                  [box, yaw, budget], H=H, DT=DT, integrator="rk4",
                  config=J.IPConfig(max_iter=80))


def _check(jres, tres):
    np.testing.assert_array_equal(tres.converged.numpy(),
                                  np.asarray(jres.converged))
    np.testing.assert_array_equal(tres.iterations.numpy(),
                                  np.asarray(jres.iterations))
    du = np.abs(tres.u.numpy() - np.asarray(jres.u)).max()
    assert du <= DU_TOL, du
    assert bool(tres.converged.all())
    assert float(FE.yaw_residual(tres.u).max()) <= 1e-4
    assert float(tres.u.sum(dim=(1, 2)).max()) <= FE.BUDGET + 1e-3


def test_fleet_eq_cold_and_warm_match_jax():
    jm = _jax_mpc()
    tm = FE.make_fleet_eq_mpc("cpu", border=True, H=H)
    assert jm.kkt_backend == tm.kkt_backend == "riccati"
    assert tm.spec.n_slack == 1 and tm.nlp.m == H * 12 + H + 1
    xs = TQ.quad_x0s(np.random.default_rng(0), B)
    jc, jres = jm.next_batch(jnp.asarray(xs))
    tc, tres = tm.next_batch(torch.as_tensor(xs))
    _check(jres, tres)
    assert tres.x.shape == (B, H, 12) and tres.slack.shape == (B, 1)
    xs = np.array(jres.x[:, 0], np.float32)
    jc, jres = jm.next_batch(jnp.asarray(xs), carry=jc)
    tc, tres = tm.next_batch(torch.as_tensor(xs), carry=tc)
    _check(jres, tres)


def test_example_main_runs(capsys):
    FE.main(["--cpu", "--batch", "2", "--steps", "0"])
    out = capsys.readouterr().out
    assert "converged 2/2" in out and "border=False" in out
