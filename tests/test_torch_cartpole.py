"""The cartpole swing-up (BASELINE config 3): the port's
``pyneuralempc_tpu_torch.examples.cartpole`` against the JAX package's
``examples/cartpole.py`` and NMPC, on the CPU.

* The dynamics: values and forward-mode Jacobians of ``cartpole_f`` on 64
  seeded (x, u) pairs, within 1e-5·max(1, |ref|).
* The solver at the example's H=50 (RK4, the StageCost with its terminal
  term, the box, the nonlinear tip-clearance row):
  - the first re-plan from the hanging start, cut at 20 iterations: from
    there the swing-up's first re-plans run all 120 iterations unconverged
    in both packages (the JAX package's run converges 25 of its 30 re-plans,
    the first five not), and two unconverged nonconvex iterate paths part
    by f32 rounding after some 30 iterations; up to 20 they agree to
    ~1e-5.  Equal converged flags and iteration counts, |Δu|∞ ≤ 1e-4;
  - a re-plan that converges at the example's 120-iteration cap: 0.3 rad
    off upright, started from that state held over the horizon with zero
    forces (``init_x``/``init_u``; the zero-force rollout falls over, and
    from it neither package converges in 120 iterations): converged in
    both, equal iteration counts, |Δu|∞ ≤ 1e-4.
* The port's ``main()`` at a tiny size (H=10, 4 plant steps), with the
  true dynamics and with ``--mlp`` (a tiny normalised fit).
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyneuralempc_tpu as J
from pyneuralempc_tpu_torch.examples import cartpole as TC

import _torch_threads  # noqa: F401  (one torch thread)

ROOT = Path(__file__).resolve().parents[1]
F_TOL = 1e-5
DU_TOL = 1e-4
FIRST_REPLAN_ITERS = 20


def _jax_example():
    """The JAX package's example module, imported by path."""
    spec = importlib.util.spec_from_file_location(
        "jax_cartpole_example", ROOT / "examples" / "cartpole.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JC = _jax_example()


def _jax_mpc(max_iter):
    """The JAX example's controller (its cost, box and tip row)."""
    cost = J.StageCost(
        stage=lambda x, u: (3.0 * (1.0 - jnp.cos(x[2]))
                            + 0.1 * x[0] ** 2 + 0.05 * x[1] ** 2
                            + 0.05 * x[3] ** 2 + 0.01 * jnp.sum(u ** 2)),
        terminal=lambda x: 30.0 * (1.0 - jnp.cos(x[2])) + 5.0 * x[3] ** 2)
    box = J.DomainConstraint(states_constraint=TC.STATE_BOX,
                             control_constraint=[[-10.0, 10.0]])
    tip = J.stage_interval(
        lambda x, u: jnp.array([x[0] + JC.L * jnp.sin(x[2])]),
        dim=1, lb=-TC.TIP_MAX, ub=TC.TIP_MAX)
    truth = J.jax_dynamics(JC.cartpole_f(), x_dim=4, u_dim=1)
    return J.NMPC(truth, cost, [box, tip], H=TC.H, DT=TC.DT,
                  integrator="rk4", config=J.IPConfig(max_iter=max_iter))


def _close(got, ref, tol):
    ref = np.asarray(ref)
    err = np.abs(np.asarray(got) - ref) / np.maximum(1.0, np.abs(ref))
    assert err.max() <= tol, err.max()


def test_cartpole_f_matches_jax():
    assert (JC.MC, JC.MP, JC.L, JC.G) == (TC.MC, TC.MP, TC.L, TC.G)
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(-2.0, 2.0, (64, 2)),
                        rng.uniform(-np.pi, np.pi, (64, 1)),
                        rng.uniform(-8.0, 8.0, (64, 1))],
                       axis=1).astype(np.float32)
    u = rng.uniform(-10.0, 10.0, (64, 1)).astype(np.float32)
    jf, tf = JC.cartpole_f(), TC.cartpole_f()
    _close(tf(torch.as_tensor(x), torch.as_tensor(u)).numpy(),
           jf(jnp.asarray(x), jnp.asarray(u)), F_TOL)
    # per-row Jacobians in (x, u): one row at a time, both packages
    jj = jax.vmap(jax.jacfwd(lambda xu: jf(xu[None, :4], xu[None, 4:])[0]))(
        jnp.asarray(np.concatenate([x, u], 1)))
    tj = torch.func.vmap(torch.func.jacfwd(
        lambda xu: tf(xu[None, :4], xu[None, 4:])[0]))(
        torch.as_tensor(np.concatenate([x, u], 1)))
    _close(tj.numpy(), jj, F_TOL)


def _compare(jres, tres):
    assert bool(tres.converged) == bool(jres.converged)
    assert int(tres.iterations) == int(jres.iterations)
    du = np.abs(tres.u.numpy() - np.asarray(jres.u)).max()
    assert du <= DU_TOL, du


@pytest.mark.parametrize("case", ["first_replan", "converged"])
def test_replan_matches_jax(case):
    if case == "first_replan":
        x0, max_iter = np.array(TC.X_HANGING, np.float32), FIRST_REPLAN_ITERS
        init = {}
    else:
        x0, max_iter = np.array([0.1, 0.0, 0.3, 0.0], np.float32), 120
        init = {"init_x": np.tile(x0, (TC.H, 1)),
                "init_u": np.zeros((TC.H, 1), np.float32)}
    jres = _jax_mpc(max_iter).next(
        jnp.asarray(x0), **{k: jnp.asarray(v) for k, v in init.items()})
    tm = TC.make_cartpole_mpc("cpu", max_iter=max_iter)
    assert tm.kkt_backend == "riccati"
    tres = tm.next(torch.as_tensor(x0),
                   **{k: torch.as_tensor(v) for k, v in init.items()})
    _compare(jres, tres)
    assert tres.u.shape == (TC.H, 1) and tres.x.shape == (TC.H, 4)
    if case == "first_replan":
        assert not bool(tres.converged)
        assert int(tres.iterations) == FIRST_REPLAN_ITERS
    else:
        assert bool(tres.converged)
        # the plan keeps the tip inside its clearance and the forces in
        # their box
        X = tres.x.numpy()
        assert np.abs(X[:, 0] + TC.L * np.sin(X[:, 2])).max() <= \
            TC.TIP_MAX + 1e-4
        assert np.abs(tres.u.numpy()).max() <= TC.F_MAX + 1e-4


@pytest.mark.parametrize("mlp", [False, True])
def test_cartpole_main(capsys, mlp):
    argv = ["--cpu", "--steps", "4", "--H", "10", "--max-iter", "15"]
    if mlp:
        argv += ["--mlp", "--fit-n", "1024", "--fit-steps", "50"]
    TC.main(argv)
    out = capsys.readouterr().out
    assert "kkt backend: riccati" in out
    assert "solves converged:" in out and "tip clearance" in out
    assert ("surrogate fitted" in out) == mlp
