"""The quadrotor fleet (12 states, 4 thrusts, H=50, RK4, a declared
StageCost with a terminal term, box bounds): the port's
``pyneuralempc_tpu_torch.examples.quadrotor`` against the JAX package's
``examples/quadrotor.py`` and NMPC, on the CPU.

* The dynamics: values and forward-mode Jacobians of ``quad_f`` on 64
  seeded (x, u) pairs, within 1e-5·max(1, |ref|).
* The solver: ``next_batch`` of 8 problems from the fleet benchmark's draw,
  cold and one warm re-plan from ``res.x[:, 0]``, both packages fed the
  same numpy states: converged masks and per-member iteration counts equal,
  |u_port − u_jax|∞ ≤ 1e-4 (bench.py's control criterion).
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

import pyneuralempc_tpu as J
import pyneuralempc_tpu_torch as T
from pyneuralempc_tpu_torch.examples import quadrotor as TQ

import _torch_threads  # noqa: F401  (one torch thread)

ROOT = Path(__file__).resolve().parents[1]
H, DT, B = 50, 0.02, 8
F_TOL = 1e-5
DU_TOL = 1e-4


def _jax_example():
    """The JAX package's example module, imported by path."""
    spec = importlib.util.spec_from_file_location(
        "jax_quadrotor_example", ROOT / "examples" / "quadrotor.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JQ = _jax_example()


def _pairs(n=64, seed=0):
    rng = np.random.default_rng(seed)
    x = np.concatenate([rng.uniform(-2.0, 2.0, (n, 6)),      # p, v
                        rng.uniform(-0.8, 0.8, (n, 2)),      # roll, pitch
                        rng.uniform(-np.pi, np.pi, (n, 1)),  # yaw
                        rng.uniform(-2.0, 2.0, (n, 3))],     # rates
                       axis=1).astype(np.float32)
    u = rng.uniform(0.0, 3.0, (n, 4)).astype(np.float32)
    return x, u


def _close(got, ref, tol):
    ref = np.asarray(ref)
    err = np.abs(np.asarray(got) - ref) / np.maximum(1.0, np.abs(ref))
    assert err.max() <= tol, err.max()


def test_constants_match_the_example():
    for name in ("M", "G", "JX", "JY", "JZ", "ARM", "KTAU", "F_HOVER"):
        assert getattr(TQ, name) == getattr(JQ, name), name


def test_quad_f_and_jacobians_match_jax():
    x, u = _pairs()
    jf, tf = JQ.quad_f(), TQ.quad_f()
    _close(tf(torch.as_tensor(x), torch.as_tensor(u)).numpy(),
           jf(jnp.asarray(x), jnp.asarray(u)), F_TOL)

    def j_one(x1, u1):
        return jf(x1[None], u1[None])[0]

    def t_one(x1, u1):
        return tf(x1[None], u1[None])[0]

    jx, ju = jax.vmap(jax.jacfwd(j_one, argnums=(0, 1)))(jnp.asarray(x),
                                                         jnp.asarray(u))
    tx, tu = torch.func.vmap(torch.func.jacfwd(t_one, argnums=(0, 1)))(
        torch.as_tensor(x), torch.as_tensor(u))
    assert tx.shape == (64, 12, 12) and tu.shape == (64, 12, 4)
    _close(tx.numpy(), jx, F_TOL)
    _close(tu.numpy(), ju, F_TOL)


def test_x0_draw_is_the_benchmarks():
    x0 = TQ.quad_x0s(np.random.default_rng(3), 5)
    rng = np.random.default_rng(3)
    assert x0.dtype == np.float32 and x0.shape == (5, 12)
    np.testing.assert_array_equal(x0[:, 0:3], np.float32(
        rng.uniform(-1.0, 1.0, (5, 3))))
    np.testing.assert_array_equal(x0[:, 3:6], np.float32(
        rng.uniform(-0.5, 0.5, (5, 3))))
    np.testing.assert_array_equal(x0[:, 6:8], np.float32(
        rng.uniform(-0.3, 0.3, (5, 2))))
    assert not x0[:, 8:].any()
    assert TQ.quad_x0s(np.random.default_rng(3), 5, rates=True)[:, 9:].any()


def _jax_mpc():
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
    return J.NMPC(J.jax_dynamics(JQ.quad_f(), x_dim=12, u_dim=4), cost,
                  [box], H=H, DT=DT, integrator="rk4",
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
    tm = TQ.make_quadrotor_mpc("cpu", H=H, DT=DT, max_iter=80)
    assert jm.kkt_backend == tm.kkt_backend == "riccati"
    xs = TQ.quad_x0s(np.random.default_rng(0), B)
    jc, jres = jm.next_batch(jnp.asarray(xs))
    tc, tres = tm.next_batch(torch.as_tensor(xs))
    _compare(jres, tres)
    assert bool(tres.converged.all())
    assert tres.x.shape == (B, H, 12) and tres.u.shape == (B, H, 4)
    # the example's own check: plans steer towards hover
    p_start = np.linalg.norm(xs[:, :3], axis=1).mean()
    p_end = float(torch.linalg.norm(tres.x[:, -1, :3], dim=1).mean())
    assert p_end < max(0.3, 1.0 - 0.3 * H * DT) * p_start
    xs = np.array(jres.x[:, 0], np.float32)
    jc, jres = jm.next_batch(jnp.asarray(xs), carry=jc)
    tc, tres = tm.next_batch(torch.as_tensor(xs), carry=tc)
    _compare(jres, tres)


def test_example_main_flags():
    """``--mlp`` fits the JAX example's normalised surrogate (hidden [256,
    256], (sin, cos) attitude features), here on 2048 transitions for 200
    steps, and flies the fleet on it: the example's hover check passes at
    H=25.  (It raised, naming ROADMAP Queue 1 #6b, until the port had the
    normalised fit.)  The same surrogate (its weights, and its normalisation
    constants from the same draw) in the JAX package: |Δu|∞ ≤ 1e-4 with
    equal converged masks and iteration counts on a cold next_batch."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        TQ.main(["--cpu", "--mlp", "--batch", "2", "--H", "25", "--fit-n",
                 "2048", "--fit-steps", "200"])
    out = buf.getvalue()
    assert "surrogate fitted: normalized mse=" in out
    assert "converged 2/2" in out and "mean |position|" in out

    n, Hm = 512, 8
    model, params, _ = TQ.fit_quad_mlp("cpu", n=n, steps=20, batch=n)
    # the fit's data: the first draws of its generator
    X, U, Y = T.sample_transitions(
        TQ.quad_f(), torch.Generator().manual_seed(0), n, 12, 4,
        x_range=(-1.5, 1.5), u_range=(0.0, 3.0), device="cpu")
    F = TQ.quad_features(X)
    stats = [(t.mean(0).numpy(), (t.std(0, unbiased=False) + 1e-6).numpy())
             for t in (F, U, Y)]
    (f_mu, f_sd), (u_mu, u_sd), (y_mu, y_sd) = stats
    acts = ("tanh", "tanh", "linear")
    jprm = [{k: jnp.asarray(v.numpy()) for k, v in layer.items()}
            for layer in params]

    def jfn(x, u, p, tvp, prm):
        ang = x[:, 6:9]
        feats = jnp.concatenate([x[:, :6], jnp.sin(ang), jnp.cos(ang),
                                 x[:, 9:12]], axis=1)
        h = jnp.concatenate([(feats - f_mu) / f_sd, (u - u_mu) / u_sd], 1)
        return J.mlp_apply(prm, h, acts) * y_sd + y_mu

    jmodel = J.DynamicsModel(fn=jfn, dims=J.Dims(12, 4))
    xs = TQ.quad_x0s(np.random.default_rng(0), 2)
    np.testing.assert_allclose(
        model(torch.as_tensor(xs), torch.full((2, 4), 1.2),
              params=params).numpy(),
        np.asarray(jmodel(jnp.asarray(xs), jnp.full((2, 4), 1.2),
                          params=jprm)), rtol=1e-5, atol=1e-5)
    jm = J.NMPC(jmodel, _jax_mpc().spec.objective,
                [_jax_mpc().spec.box], H=Hm, DT=DT, integrator="rk4",
                config=J.IPConfig(max_iter=80))
    tm = TQ.make_quadrotor_mpc("cpu", H=Hm, model=model)
    _, jres = jm.next_batch(jnp.asarray(xs), params=jprm)
    _, tres = tm.next_batch(torch.as_tensor(xs), params=params)
    _compare(jres, tres)
