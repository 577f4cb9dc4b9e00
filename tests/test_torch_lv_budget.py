"""The budgeted LV MLP fleet on the CPU, the port against the JAX package:
bench.py's workload (normalised Lotka-Volterra, 2x32 tanh MLP surrogate
with the same numpy weights in both, RK4, box bounds, H=20, 1.1·Σu +
1e-4·Σu², bench.py's IPConfig) with the minimum feed delivery Σ_t u_t ≥
U_FLOOR (``examples/lotka_volterra.py``: one trajectory-level row with a
slack, the general sweep at R=2, r=0).  A cold ``next_batch`` of 4
problems and two warm re-plans, both packages fed the same numpy next
state: converged masks and per-member iteration counts equal, objectives
within 1e-5, the floor held, and |u_port − u_jax|∞ ≤ 1e-4 (bench.py's
control criterion) on every member whose JAX plan is fixed to that by f32.

With the floor binding, feed moved between stages at constant Σu is
tie-broken only by the 1e-4·Σu² term: a plan can then move by ~1e-3 when
its start moves by 1e-7 (the JAX package's own plans do).  The test finds
those members by re-solving the JAX problem from the start moved by ±1e-7
(same carry): a member whose JAX plan moves by more than 5e-5 is held to
1e-4 + 2× that move on u instead of 1e-4, and at most one of the four may
be such."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyneuralempc_tpu as J
import pyneuralempc_tpu_torch as T
from pyneuralempc_tpu.models.train import fit_surrogate, sample_transitions
from pyneuralempc_tpu.ops.integrators import step_fn
from pyneuralempc_tpu_torch.examples.lotka_volterra import (BENCH_BOX,
                                                            BENCH_CONFIG,
                                                            U_FLOOR,
                                                            bench_cost,
                                                            make_budget_mpc,
                                                            normalized_lv)

from _torch_lv import (BENCH_CFG, BOX, REG, jax_params, lv_true_jax,
                       x0_batch)
import _torch_threads  # noqa: F401  (one torch thread)

B = 4
DU_TOL = 1e-4
PERTURB, DETERMINED, SPREAD = 1e-7, 5e-5, 2.0


@pytest.fixture(scope="module")
def surrogate():
    """bench.py's surrogate, trained by the JAX package; both packages then
    use its weights."""
    model = J.MLPDynamics.make(x_dim=2, u_dim=1, hidden=[32, 32])
    X, U, Y = sample_transitions(lv_true_jax, jax.random.PRNGKey(0), 8192,
                                 2, 1, x_range=(-1.0, 1.2),
                                 u_range=(0.0, 1.2))
    params, _ = fit_surrogate(model, X, U, Y, steps=1500, lr=2e-3,
                              batch=1024)
    return [{k: np.asarray(v) for k, v in layer.items()} for layer in params]


def _jax_mpc():
    floor = J.PathConstraint(fn=lambda x, u: jnp.sum(u, keepdims=True),
                             dim=1, lb=(U_FLOOR,), ub=(float("inf"),))
    return J.NMPC(J.MLPDynamics.make(x_dim=2, u_dim=1, hidden=[32, 32]),
                  lambda x, u: 1.1 * jnp.sum(u) + REG * jnp.sum(u * u),
                  [J.DomainConstraint(**BOX), floor], H=20, DT=0.1,
                  integrator="rk4", config=J.IPConfig(**BENCH_CFG))


def _compare(jres, tres, moved):
    np.testing.assert_array_equal(tres.converged.numpy(),
                                  np.asarray(jres.converged))
    np.testing.assert_array_equal(tres.iterations.numpy(),
                                  np.asarray(jres.iterations))
    assert bool(tres.converged.all())
    np.testing.assert_allclose(tres.objective.numpy(),
                               np.asarray(jres.objective), atol=1e-5, rtol=0)
    assert float(tres.u.sum(dim=(1, 2)).min()) >= U_FLOOR - 1e-5
    determined = moved <= DETERMINED
    assert int(determined.sum()) >= B - 1, moved
    du = np.abs(tres.u.numpy() - np.asarray(jres.u)).max(axis=(1, 2))
    assert du[determined].max() <= DU_TOL, (du, moved)
    # the others within what f32 leaves open
    assert (du <= DU_TOL + SPREAD * moved).all(), (du, moved)


def test_budget_fleet_cold_and_warm_match_jax(surrogate):
    jm = _jax_mpc()
    tm = make_budget_mpc(T.MLPDynamics.make(x_dim=2, u_dim=1,
                                            hidden=[32, 32]), device="cpu")
    assert jm.kkt_backend == tm.kkt_backend == "riccati"
    jp = jax_params(surrogate)
    tp = T.mlp_params_from_numpy(surrogate, device="cpu")
    plant = step_fn(J.jax_dynamics(lv_true_jax, 2, 1), "rk4", 0.1)
    xs, jc, tc = x0_batch(B), None, None
    binding = []
    for step in range(3):       # cold, then two warm re-plans
        jc0, (jc, jres) = jc, jm.next_batch(jnp.asarray(xs), params=jp,
                                            carry=jc)
        tc, tres = tm.next_batch(torch.as_tensor(xs), params=tp, carry=tc)
        moved = np.zeros(B)
        for eps in (PERTURB, -PERTURB):
            _, alt = jm.next_batch(jnp.asarray(xs + np.float32(eps)),
                                   params=jp, carry=jc0)
            moved = np.maximum(moved, np.abs(np.asarray(alt.u)
                                             - np.asarray(jres.u))
                               .max(axis=(1, 2)))
        _compare(jres, tres, moved)
        binding.append(int((np.abs(tres.u.sum(dim=(1, 2)).numpy() - U_FLOOR)
                            < 1e-4).sum()))
        xs = np.array(plant(jnp.asarray(xs),
                            jnp.asarray(np.asarray(jres.u)[:, 0])),
                      np.float32)
    # the floor is active on most of these starts' plans
    assert min(binding) >= 2, binding


def test_u_floor_is_the_cold_plans_30th_percentile():
    """How U_FLOOR was chosen: the unbudgeted fleet (the true ODE as the
    model, bench.py's cost, box and IPConfig, H=20) solved cold by the port
    on the CPU from the first 256 of chip_smoke.py's B=4096 starts; the 30th
    percentile of the plans' Σu (0.460), rounded to one decimal."""
    mpc = T.NMPC(T.torch_dynamics(normalized_lv(), 2, 1), bench_cost,
                 [T.DomainConstraint(**BENCH_BOX)], H=20, DT=0.1,
                 integrator="rk4", config=T.IPConfig(**BENCH_CONFIG),
                 device="cpu")
    _, res = mpc.next_batch(torch.as_tensor(x0_batch(4096)[:256]))
    assert bool(res.converged.all())
    total = res.u.sum(dim=(1, 2)).numpy()
    p30 = float(np.percentile(total, 30))
    assert abs(p30 - 0.460) < 5e-3, p30
    assert round(p30, 1) == U_FLOOR
    # 16% of these plans feed nothing at all
    assert abs(float((total < 1e-3).mean()) - 0.164) < 0.01
