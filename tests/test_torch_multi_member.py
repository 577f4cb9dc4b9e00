"""Per-member fleet inputs, multi-start and the surrogate tools: the port
against the JAX package on the CPU.

* ``next_batch`` with per-member ``params`` (a different MLP per member,
  as ``tests/test_simulate_batch.py::test_per_member_params``), and with
  per-member ``p`` (B, p_dim) and ``tvp`` (B, H, tvp_dim) reaching the
  dynamics, the stage cost and its terminal term, a stage interval row
  and a trajectory-level border row: cold and one warm re-plan, |Δu|∞ ≤
  1e-4 with equal converged masks and iteration counts.  The same
  per-member ``params`` stacked from one shared set give the shared
  solve's plans.
* ``closed_loop_batch`` with per-member ``params`` against the JAX
  package's.
* ``next_multi_start``: each start equals the JAX package's ``next`` from
  the same initialisation (the port's numpy-drawn perturbations), and the
  winner is the JAX package's rule applied to those starts.
* ``fit_normalized_surrogate`` beats a raw fit on the JAX package's
  multiscale case and is seed-deterministic.
* ``MLPDynamics(compute_dtype=torch.bfloat16)`` within 2e-2 of float32 and
  of the JAX package's bf16 model.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyneuralempc_tpu as J
import pyneuralempc_tpu_torch as T
from pyneuralempc_tpu.api.simulate import closed_loop_batch as j_clb
from pyneuralempc_tpu.api.simulate import plant_from_model as j_plant
from pyneuralempc_tpu_torch.api import simulate as tsim
from pyneuralempc_tpu_torch.api.controller import (multi_start_winner,
                                                   per_member_keys)

from _torch_lv import glorot_params, jax_params
import _torch_threads  # noqa: F401  (one torch thread)

DU_TOL = 1e-4
BOX = dict(states_constraint=[[-2.0, 2.0]] * 2,
           control_constraint=[[-1.0, 1.0]])


def _tree_stack(trees):
    """Stack a list of numpy MLP layer lists on a leading member axis."""
    return [{k: np.stack([t[i][k] for t in trees]) for k in trees[0][i]}
            for i in range(len(trees[0]))]


def _compare(jres, tres):
    np.testing.assert_array_equal(tres.converged.numpy(),
                                  np.asarray(jres.converged))
    np.testing.assert_array_equal(tres.iterations.numpy(),
                                  np.asarray(jres.iterations))
    du = np.abs(tres.u.numpy() - np.asarray(jres.u)).max()
    assert du <= DU_TOL, du


def _mlp_mpcs(H=5):
    jsur = J.MLPDynamics.make(x_dim=2, u_dim=1, hidden=[8])
    tsur = T.MLPDynamics.make(x_dim=2, u_dim=1, hidden=[8])
    jm = J.NMPC(jsur, J.StageCost(stage=lambda x, u: jnp.sum(u ** 2)
                                  + jnp.sum((x - 0.2) ** 2)),
                [J.DomainConstraint(**BOX)], H=H, DT=0.1, integrator="rk4",
                config=J.IPConfig(tol=1e-5))
    tm = T.NMPC(tsur, T.StageCost(stage=lambda x, u: torch.sum(u ** 2)
                                  + torch.sum((x - 0.2) ** 2)),
                [T.DomainConstraint(**BOX)], H=H, DT=0.1, integrator="rk4",
                config=T.IPConfig(tol=1e-5), device="cpu")
    return jsur, tsur, jm, tm


def test_per_member_params_match_jax():
    """A different surrogate per member, equal starts: different plans,
    each the JAX package's."""
    B = 4
    jsur, tsur, jm, tm = _mlp_mpcs()
    sets = [glorot_params(s, (3, 8, 2)) for s in range(B)]
    stacked = _tree_stack(sets)
    jp, tp = jax_params(stacked), T.mlp_params_from_numpy(stacked,
                                                          device="cpu")
    assert per_member_keys(B, params=tp) == ("params",)
    xs = np.full((B, 2), 0.1, np.float32)
    jc, jres = jm.next_batch(jnp.asarray(xs), params=jp)
    tc, tres = tm.next_batch(torch.as_tensor(xs), params=tp)
    _compare(jres, tres)
    assert bool(tres.converged.all())
    assert float((tres.u[0] - tres.u[1]).abs().max()) > 1e-3
    xs = np.array(jres.x[:, 0], np.float32)
    jc, jres = jm.next_batch(jnp.asarray(xs), params=jp, carry=jc)
    tc, tres = tm.next_batch(torch.as_tensor(xs), params=tp, carry=tc)
    _compare(jres, tres)
    # one shared set stacked B times solves as the shared set does
    same = T.mlp_params_from_numpy(_tree_stack([sets[0]] * B), device="cpu")
    _, r_stacked = tm.next_batch(torch.as_tensor(xs), params=same)
    _, r_shared = tm.next_batch(torch.as_tensor(xs),
                                params=T.mlp_params_from_numpy(
                                    sets[0], device="cpu"))
    assert torch.equal(r_stacked.converged, r_shared.converged)
    assert float((r_stacked.u - r_shared.u).abs().max()) <= 1e-5


def _p_tvp_problem(pkg, lib):
    """x' = −p₀·x + u (RK4); stage cost Σ(x − 0.5)² + tvp·u², terminal
    p₀·Σx²; |u| ≤ p₁ a stage (a stage interval row); Σ_t u ≤ 4·p₁ over the
    horizon (a border row)."""
    def f(x, u, p, tvp):
        return -p[0] * x + u

    model = (pkg.jax_dynamics if pkg is J else pkg.torch_dynamics)(
        f, x_dim=2, u_dim=1, p_dim=2, tvp_dim=1)
    cost = pkg.StageCost(
        stage=lambda x, u, p, tvp: lib.sum((x - 0.5) ** 2)
        + tvp[0] * lib.sum(u ** 2),
        terminal=lambda x, p: p[0] * lib.sum(x ** 2))
    cap = pkg.stage_interval(lambda x, u, p, tvp: u / p[1], dim=1,
                             lb=-1.0, ub=1.0)
    budget = pkg.interval_constraint(
        lambda X, U, p, tvp: lib.sum(U).reshape(1) - 4.0 * p[1], dim=1,
        lb=-100.0, ub=0.0)
    kw = {} if pkg is J else {"device": "cpu"}
    return pkg.NMPC(model, cost, [pkg.DomainConstraint(**BOX), cap, budget],
                    H=6, DT=0.1, integrator="rk4",
                    config=pkg.IPConfig(tol=1e-5), **kw)


def test_per_member_p_and_tvp_match_jax():
    B, H = 4, 6
    jm, tm = _p_tvp_problem(J, jnp), _p_tvp_problem(T, torch)
    assert tm.kkt_backend == "riccati"
    rng = np.random.default_rng(3)
    p = np.stack([rng.uniform(0.5, 2.0, B), rng.uniform(0.3, 0.9, B)],
                 axis=1).astype(np.float32)
    tvp = rng.uniform(0.05, 0.5, (B, H, 1)).astype(np.float32)
    xs = rng.uniform(-1.0, 1.0, (B, 2)).astype(np.float32)
    assert per_member_keys(B, torch.as_tensor(p),
                           torch.as_tensor(tvp)) == ("p", "tvp")
    jc, jres = jm.next_batch(jnp.asarray(xs), p=jnp.asarray(p),
                             tvp=jnp.asarray(tvp))
    tc, tres = tm.next_batch(torch.as_tensor(xs), p=torch.as_tensor(p),
                             tvp=torch.as_tensor(tvp))
    _compare(jres, tres)
    assert bool(tres.converged.all())
    xs = np.array(jres.x[:, 0], np.float32)
    jc, jres = jm.next_batch(jnp.asarray(xs), p=jnp.asarray(p),
                             tvp=jnp.asarray(tvp), carry=jc)
    tc, tres = tm.next_batch(torch.as_tensor(xs), p=torch.as_tensor(p),
                             tvp=torch.as_tensor(tvp), carry=tc)
    _compare(jres, tres)
    # the caps hold per member
    cap = torch.as_tensor(p[:, 1])[:, None, None]
    assert bool((tres.u.abs() <= cap + 1e-4).all())
    # a per-member p that does not lead with the batch size is refused
    with pytest.raises(ValueError, match="batch size"):
        tm.next_batch(torch.as_tensor(xs), p=torch.ones(B + 1, 2),
                      tvp=torch.as_tensor(tvp))


def test_closed_loop_batch_per_member_params_match_jax():
    """The JAX package's per-member closed loop (same x0, a different
    model per member), steps=2: trajectories and per-solve stats."""
    jsur, tsur, jm, tm = _mlp_mpcs()
    sets = [glorot_params(s, (3, 8, 2)) for s in (0, 1)]
    stacked = _tree_stack(sets)
    xs = np.full((2, 2), 0.1, np.float32)
    jout = j_clb(jm, j_plant(jsur, "rk4", 0.1, params=jax_params(sets[0])),
                 jnp.asarray(xs), steps=2, params=jax_params(stacked))
    tout = tsim.closed_loop_batch(
        tm, tsim.plant_from_model(tsur, "rk4", 0.1,
                                  params=T.mlp_params_from_numpy(
                                      sets[0], device="cpu")),
        torch.as_tensor(xs), steps=2,
        params=T.mlp_params_from_numpy(stacked, device="cpu"))
    np.testing.assert_array_equal(tout.converged.numpy(),
                                  np.asarray(jout.converged))
    np.testing.assert_array_equal(tout.iterations.numpy(),
                                  np.asarray(jout.iterations))
    assert np.abs(tout.u.numpy() - np.asarray(jout.u)).max() <= DU_TOL
    assert np.abs(tout.x.numpy() - np.asarray(jout.x)).max() <= DU_TOL
    assert bool(tout.converged.all())
    assert float((tout.u[:, 0] - tout.u[:, 1]).abs().max()) > 1e-4


def _multi_start_models(max_iter):
    """The cartpole swing-up at H=10 (the multi-start's nonconvex case)."""
    from test_torch_cartpole import JC
    from pyneuralempc_tpu_torch.examples import cartpole as TC
    H = 10
    cost = J.StageCost(
        stage=lambda x, u: (3.0 * (1.0 - jnp.cos(x[2]))
                            + 0.1 * x[0] ** 2 + 0.05 * x[1] ** 2
                            + 0.05 * x[3] ** 2 + 0.01 * jnp.sum(u ** 2)),
        terminal=lambda x: 30.0 * (1.0 - jnp.cos(x[2])) + 5.0 * x[3] ** 2)
    box = J.DomainConstraint(states_constraint=TC.STATE_BOX,
                             control_constraint=[[-10.0, 10.0]])
    jm = J.NMPC(J.jax_dynamics(JC.cartpole_f(), 4, 1), cost, [box], H=H,
                DT=TC.DT, integrator="rk4",
                config=J.IPConfig(max_iter=max_iter))
    tm = T.NMPC(T.torch_dynamics(TC.cartpole_f(), 4, 1), TC.cartpole_cost(),
                [TC.cartpole_box()], H=H, DT=TC.DT, integrator="rk4",
                config=T.IPConfig(max_iter=max_iter), device="cpu")
    return jm, tm, H


def test_next_multi_start_matches_jax():
    n_starts, noise = 4, 0.3
    jm, tm, H = _multi_start_models(max_iter=40)
    x0 = np.array([0.0, 0.0, 0.6, 0.0], np.float32)
    du = T.multi_start_perturbations(torch.Generator().manual_seed(5),
                                     n_starts, H, 1, noise)
    assert du.shape == (n_starts, H, 1) and du.device.type == "cpu"
    again = T.multi_start_perturbations(torch.Generator().manual_seed(5),
                                        n_starts, H, 1, noise)
    assert torch.equal(du, again)
    best, idx = tm.next_multi_start(
        torch.as_tensor(x0), n_starts=n_starts, noise=noise,
        generator=torch.Generator().manual_seed(5), return_index=True)
    # every start: the JAX package's next from the same initialisation
    X0, U0, _ = jm.nlp.unpack(jm.cold_start(jnp.asarray(x0)).w)
    jstarts = []
    for k in range(n_starts):
        jstarts.append(jm.next(jnp.asarray(x0), init_x=X0,
                               init_u=U0 + jnp.asarray(du[k].numpy())))
    jst = jax.tree_util.tree_map(lambda *a: jnp.stack(a), *jstarts)
    carry = tm.cold_start(torch.as_tensor(x0).expand(n_starts, 4))
    X, U, s = tm.nlp.unpack(carry.w)
    _, tst = tm._step(carry._replace(w=tm.nlp.pack(X, U + du, s)),
                      tm._runtime(torch.as_tensor(x0).expand(n_starts, 4),
                                  None, None, None))
    _compare(jst, tst)
    # the winner rule, both packages' starts
    assert idx == int(multi_start_winner(tst))
    j_obj = np.where(np.asarray(jst.converged), np.asarray(jst.objective),
                     np.inf)
    j_idx = (int(np.argmin(j_obj)) if np.asarray(jst.converged).any()
             else int(np.argmin(np.asarray(jst.kkt_error))))
    if j_idx != idx:     # a tie inside f32 rounding
        assert abs(float(jst.objective[j_idx])
                   - float(tst.objective[idx])) <= 1e-5
    for field in ("u", "x", "objective", "iterations", "converged"):
        assert torch.equal(getattr(best, field), getattr(tst, field)[idx])


def _multiscale_truth(x, u):
    return torch.cat([x[:, 1:2], 30.0 * torch.sin(x[:, 0:1]) + 5.0 * u],
                     dim=1)


def _angle_features(x):
    return torch.cat([torch.sin(x[:, 0:1]), torch.cos(x[:, 0:1]),
                      x[:, 1:2]], dim=1)


def test_fit_normalized_surrogate_beats_raw_and_is_deterministic():
    """The JAX package's multiscale case (tests/test_models.py): the
    normalised fit's raw-unit error well under the plain fit's, its
    normalised mse < 1e-3; the same seed gives the same surrogate."""
    kw = dict(x_dim=2, u_dim=1, hidden=[32], n=4096, x_range=(-3.0, 3.0),
              u_range=(-1.0, 1.0), steps=1500, lr=3e-3, batch=1024,
              feature_map=_angle_features, feature_dim=3, device="cpu")
    model, params, rel_mse = T.fit_normalized_surrogate(
        _multiscale_truth, torch.Generator().manual_seed(0), **kw)
    assert rel_mse < 1e-3
    X = torch.as_tensor(np.random.default_rng(0).uniform(-3, 3, (64, 2)),
                        dtype=torch.float32)
    U = torch.as_tensor(np.random.default_rng(1).uniform(-1, 1, (64, 1)),
                        dtype=torch.float32)
    err = float((model(X, U, params=params)
                 - _multiscale_truth(X, U)).abs().max())
    assert err < 1.0                      # raw units (outputs ~±35)
    # the plain fit on the same data and budget
    raw = T.MLPDynamics.make(x_dim=2, u_dim=1, hidden=[32])
    Xs, Us, Ys = T.sample_transitions(
        _multiscale_truth, torch.Generator().manual_seed(0), 4096, 2, 1,
        x_range=(-3.0, 3.0), u_range=(-1.0, 1.0), device="cpu")
    raw_params, _ = T.fit_surrogate(raw, Xs, Us, Ys, steps=1500, lr=3e-3,
                                    batch=1024)
    raw_err = float((raw(X, U, params=raw_params)
                     - _multiscale_truth(X, U)).abs().max())
    assert err < 0.5 * raw_err, (err, raw_err)
    _, params2, rel2 = T.fit_normalized_surrogate(
        _multiscale_truth, torch.Generator().manual_seed(0), **kw)
    assert rel2 == rel_mse
    assert all(torch.equal(a[k], b[k]) for a, b in zip(params, params2)
               for k in a)


def test_mlp_bf16_compute_dtype():
    """bf16 matmuls with float32 weights and outputs (the JAX package's
    tests/test_models.py check), against float32 and against the JAX
    package's bf16 model, within 2e-2."""
    np_params = glorot_params(2, (3, 32, 2))
    m32 = T.MLPDynamics.make(x_dim=2, u_dim=1, hidden=[32])
    m16 = T.MLPDynamics.make(x_dim=2, u_dim=1, hidden=[32],
                             compute_dtype=torch.bfloat16)
    j16 = J.MLPDynamics.make(x_dim=2, u_dim=1, hidden=[32],
                             compute_dtype=jnp.bfloat16)
    rng = np.random.default_rng(3)
    x = rng.normal(size=(6, 2)).astype(np.float32)
    u = rng.normal(size=(6, 1)).astype(np.float32)
    tp = T.mlp_params_from_numpy(np_params, device="cpu")
    out16 = m16(torch.as_tensor(x), torch.as_tensor(u), params=tp)
    assert out16.dtype == torch.float32
    assert tp[0]["w"].dtype == torch.float32
    out32 = m32(torch.as_tensor(x), torch.as_tensor(u), params=tp)
    ref16 = np.asarray(j16(jnp.asarray(x), jnp.asarray(u),
                           params=jax_params(np_params)))
    np.testing.assert_allclose(out16.numpy(), out32.numpy(), atol=2e-2)
    np.testing.assert_allclose(out16.numpy(), ref16, atol=2e-2)
    assert float((out16 - out32).abs().max()) > 0.0   # bf16 did round
    # derivatives flow through the bf16 matmuls
    g = torch.func.jacrev(lambda xx: m16(xx, torch.as_tensor(u),
                                         params=tp).sum())(
        torch.as_tensor(x))
    assert bool(torch.isfinite(g).all())
