"""The wide fleet (a 10-rotor multirotor, 12 states, 10 thrusts, H=50,
RK4, a declared StageCost with a terminal term, box bounds): the port's
``pyneuralempc_tpu_torch.examples.fleet_wide`` against the JAX package's
``tools/fleet_wide_tpu.py`` and NMPC, on the CPU.

* The dynamics: values and forward-mode Jacobians of ``deca_f`` on 64
  seeded (x, u) pairs, pitch angles past ±π/2 among them (where the
  ``max(cos θ, 1e-3)`` kink bites), within 1e-5·max(1, |ref|), and each
  body-rate derivative (the torque rows) within 1e-5·max(1, |ref|, the
  scale of its summands): the ten arm products u_i·a_i of a torque sum
  cancel (the pitch arms cos 2πi/10 sum to zero), each package's BLAS
  rounds the sum on its own, and the division by the inertia (4e-3)
  multiplies that rounding by 55.
* The solver: ``next_batch`` of 8 problems from the tool's draw, cold and
  one warm re-plan from ``res.x[:, 0]``: converged masks and per-member
  iteration counts equal, |u_port − u_jax|∞ ≤ 1e-4.  The JAX package's
  NMPC at nu=10 sweeps through its scan reference (reference caveat 3:
  its kernel was never checked past nu=8).
* The plan on the card: ``kernel_plan(50, 12, 10, "cuda")`` names the
  run-time backward kernel and the forward instance, and the C entry's
  instance list matches ``_FORWARD_INSTANCES``.
"""

import importlib.util
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

import pyneuralempc_tpu as J
from pyneuralempc_tpu_torch.examples import fleet_wide as TW
from pyneuralempc_tpu_torch.ops.cuda import riccati_kernel as rk

import _torch_threads  # noqa: F401  (one torch thread)

ROOT = Path(__file__).resolve().parents[1]
H, DT, B = 50, 0.02, 8
F_TOL = 1e-5
DU_TOL = 1e-4


def _jax_tool():
    """The JAX package's tool module, imported by path."""
    spec = importlib.util.spec_from_file_location(
        "jax_fleet_wide_tool", ROOT / "tools" / "fleet_wide_tpu.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JW = _jax_tool()


def _pairs(n=64, seed=0):
    rng = np.random.default_rng(seed)
    x = np.concatenate([rng.uniform(-2.0, 2.0, (n, 6)),      # p, v
                        rng.uniform(-0.8, 0.8, (n, 1)),      # roll
                        rng.uniform(-2.0, 2.0, (n, 1)),      # pitch
                        rng.uniform(-np.pi, np.pi, (n, 1)),  # yaw
                        rng.uniform(-2.0, 2.0, (n, 3))],     # rates
                       axis=1).astype(np.float32)
    u = rng.uniform(0.0, 2.5, (n, TW.N_ROT)).astype(np.float32)
    return x, u


def _close(got, ref, tol):
    ref = np.asarray(ref)
    err = np.abs(np.asarray(got) - ref) / np.maximum(1.0, np.abs(ref))
    assert err.max() <= tol, err.max()


def _torque_scales(x, u):
    """The scale of each output's summands, (n, 12): 1, except the three
    body-rate rows, where it is ARM·Σ|u_i·sin a_i|/JX, ARM·Σ|u_i·cos
    a_i|/JY and KTAU·Σ|u_i|/JZ, the magnitudes of the arm products that the
    torque sums add (f64)."""
    ang = np.arange(TW.N_ROT) * 2 * np.pi / TW.N_ROT
    arms = np.stack([np.sin(ang).astype(np.float32),
                     np.cos(ang).astype(np.float32),
                     np.ones(TW.N_ROT, np.float32)], axis=1)
    terms = np.abs(u.astype(np.float64)) @ np.abs(arms.astype(np.float64))
    scale = np.ones((len(x), 12))
    scale[:, 9:] = terms * np.array([TW.ARM / TW.JX, TW.ARM / TW.JY,
                                     TW.KTAU / TW.JZ])
    return scale


def test_constants_match_the_tool():
    for name in ("M", "G", "JX", "JY", "JZ", "ARM", "KTAU", "N_ROT",
                 "F_HOVER"):
        assert getattr(TW, name) == getattr(JW, name), name


def test_deca_f_and_jacobians_match_jax():
    x, u = _pairs()
    assert (np.abs(x[:, 7]) > np.pi / 2).any()   # cos θ < 0: the kink
    jf, tf = JW.deca_f(), TW.deca_f()
    got = tf(torch.as_tensor(x), torch.as_tensor(u)).numpy()
    ref = np.asarray(jf(jnp.asarray(x), jnp.asarray(u)))
    # rows whose terms do not cancel: 1e-5·max(1, |ref|) as before
    _close(got[:, :9], ref[:, :9], F_TOL)
    # the torque rows: 1e-5 of the larger of max(1, |ref|) and the scale
    # of the summands they cancel
    err = np.abs(got - ref) / np.maximum(np.maximum(1.0, np.abs(ref)),
                                         _torque_scales(x, u))
    assert err.max() <= F_TOL, err.max()

    def j_one(x1, u1):
        return jf(x1[None], u1[None])[0]

    def t_one(x1, u1):
        return tf(x1[None], u1[None])[0]

    jx, ju = jax.vmap(jax.jacfwd(j_one, argnums=(0, 1)))(jnp.asarray(x),
                                                         jnp.asarray(u))
    tx, tu = torch.func.vmap(torch.func.jacfwd(t_one, argnums=(0, 1)))(
        torch.as_tensor(x), torch.as_tensor(u))
    assert tx.shape == (64, 12, 12) and tu.shape == (64, 12, 10)
    _close(tx.numpy(), jx, F_TOL)
    _close(tu.numpy(), ju, F_TOL)


def test_x0_draw_is_the_tools():
    x0 = TW.wide_x0s(np.random.default_rng(0), 5)
    rng = np.random.default_rng(0)
    ref = np.zeros((5, 12), np.float32)
    ref[:, 0:3] = rng.uniform(-1.0, 1.0, (5, 3))
    ref[:, 3:6] = rng.uniform(-0.5, 0.5, (5, 3))
    ref[:, 6:8] = rng.uniform(-0.3, 0.3, (5, 2))
    np.testing.assert_array_equal(x0, ref)


def _jax_mpc():
    cost = J.StageCost(
        stage=lambda x, u: (jnp.sum(x[:3] ** 2) + 0.1 * jnp.sum(x[3:6] ** 2)
                            + 0.5 * jnp.sum(x[6:8] ** 2) + 0.1 * x[8] ** 2
                            + 0.02 * jnp.sum(x[9:] ** 2)
                            + 0.05 * jnp.sum((u - JW.F_HOVER) ** 2)),
        terminal=lambda x: 5.0 * (jnp.sum(x[:3] ** 2)
                                  + jnp.sum(x[3:6] ** 2)))
    box = J.DomainConstraint(
        states_constraint=[[-5.0, 5.0]] * 3 + [[-8.0, 8.0]] * 3
        + [[-0.8, 0.8]] * 2 + [[-np.pi, np.pi]] + [[-8.0, 8.0]] * 3,
        control_constraint=[[0.0, 2.5]] * JW.N_ROT)
    return J.NMPC(J.jax_dynamics(JW.deca_f(), x_dim=12, u_dim=JW.N_ROT),
                  cost, [box], H=H, DT=DT, integrator="rk4",
                  config=J.IPConfig(max_iter=80))


def _compare(jres, tres):
    np.testing.assert_array_equal(tres.converged.numpy(),
                                  np.asarray(jres.converged))
    np.testing.assert_array_equal(tres.iterations.numpy(),
                                  np.asarray(jres.iterations))
    du = np.abs(tres.u.numpy() - np.asarray(jres.u)).max()
    assert du <= DU_TOL, du


def test_next_batch_cold_and_warm_match_jax():
    jm = _jax_mpc()
    tm = TW.make_fleet_wide_mpc("cpu", H=H, DT=DT, max_iter=80)
    assert jm.kkt_backend == tm.kkt_backend == "riccati"
    xs = TW.wide_x0s(np.random.default_rng(0), B)
    jc, jres = jm.next_batch(jnp.asarray(xs))
    tc, tres = tm.next_batch(torch.as_tensor(xs))
    _compare(jres, tres)
    assert bool(tres.converged.all())
    assert tres.x.shape == (B, H, 12) and tres.u.shape == (B, H, 10)
    xs = np.array(jres.x[:, 0], np.float32)
    jc, jres = jm.next_batch(jnp.asarray(xs), carry=jc)
    tc, tres = tm.next_batch(torch.as_tensor(xs), carry=tc)
    _compare(jres, tres)


def test_kernel_plan_at_the_wide_stage():
    plan = rk.kernel_plan(50, 12, 10, "cuda")
    assert plan["path"] == "cuda_streamed"
    # both templates take (12, 10): the backward one with Quu factored
    # one row a lane, in one stage buffer a warp
    assert plan["backward_kernel"] == (
        "riccati_general_backward_fixed<12, 10, 1, 0>")
    assert plan["forward_kernel"] == (
        f"riccati_general_forward_fixed<12, 10, 1, 0, "
        f"{rk._FORWARD_INSTANCES[12, 10]}>")
    assert (12, 10) in rk._BACKWARD_INSTANCES
    assert rk.backward_fixed_buffers(12, 10, 1, 0) == 1
    assert rk.kernel_plan(50, 12, 10, "cpu")["path"] == "plain"


def test_c_entry_lists_match_the_python_ones():
    src = (ROOT / "pyneuralempc_tpu_torch" / "csrc"
           / "riccati_streamed.cu").read_text()
    fwd = {(int(a), int(b)): int(d) for a, b, d in re.findall(
        r"^\s*RICCATI_FORWARD_CASE\((\d+), (\d+), (\d+)\)", src, re.M)}
    bwd = {(int(a), int(b)) for a, b in re.findall(
        r"^\s*RICCATI_BACKWARD_CASE\((\d+), (\d+)\)", src, re.M)}
    assert fwd == rk._FORWARD_INSTANCES
    assert bwd == rk._BACKWARD_INSTANCES


def test_example_main_flags(capsys):
    TW.main(["--cpu", "--batch", "4", "--H", "10", "--steps", "1"])
    out = capsys.readouterr().out
    assert "converged 4/4" in out and "warm fleet step" in out


def test_plain_halves_match_reference_at_the_wide_stage():
    """At (12, 10), H=50, riccati_backward_plain then riccati_forward_plain
    (what the card's kernels are held against) against the JAX package's
    scan reference on the seeded cases: ok flags equal, outputs of the ok
    problems within 2e-4·max(1, |ref|) (tests/test_pallas_kernel.py's
    quadrotor-width tolerance)."""
    from pyneuralempc_tpu.solve.riccati import riccati_sweep_ref
    from pyneuralempc_tpu_torch.ops.cuda.sweep_cases import sweep_case
    for kind in ("delta0", "delta_per_problem", "negative_curvature",
                 "local_bump"):
        args = sweep_case(kind, B=4, H=H, nx=12, nu=10, seed=10)
        t = [torch.as_tensor(a) for a in args]
        gains, ok = rk.riccati_backward_plain(*t)
        out = rk.riccati_forward_plain(t[0], t[1], t[6], gains)
        ref = jax.vmap(riccati_sweep_ref)(*[jnp.asarray(a) for a in args])
        np.testing.assert_array_equal(ok.numpy(), np.asarray(ref[3]))
        assert ok.any()
        m = ok.numpy()
        for o, r in zip(out, ref[:3]):
            _close(o.numpy()[m], np.asarray(r)[m], 2e-4)
