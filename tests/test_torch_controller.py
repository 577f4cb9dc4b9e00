"""End to end: the port's NMPC against the JAX package's on bench.py's
workload (LV, 2x32 tanh MLP surrogate with the same weights, RK4, box bounds,
H=20, bench.py's cost and IPConfig), on the CPU.  A cold ``next_batch`` of 8
problems and two warm re-plans, both packages fed the same numpy next state;
converged masks equal and |u_port − u_jax|∞ ≤ 1e-4 (bench.py's control
criterion).  ``NMPC.next`` on one problem runs at H=10, to keep the file
near a minute on the CPU (the JAX package compiles one program per entry
point)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyneuralempc_tpu as J
import pyneuralempc_tpu_torch as T
from pyneuralempc_tpu.models.train import fit_surrogate, sample_transitions
from pyneuralempc_tpu.ops.integrators import step_fn

from _torch_lv import (jax_mpc, jax_params, lv_true_jax, torch_mpc,
                       x0_batch)

H = 20
H_NEXT = 10
B = 8
DU_TOL = 1e-4


@pytest.fixture(scope="module")
def surrogate():
    """bench.py's surrogate, trained once by the JAX package; both packages
    then use its weights."""
    model = J.MLPDynamics.make(x_dim=2, u_dim=1, hidden=[32, 32])
    X, U, Y = sample_transitions(lv_true_jax, jax.random.PRNGKey(0), 8192,
                                 2, 1, x_range=(-1.0, 1.2),
                                 u_range=(0.0, 1.2))
    params, _ = fit_surrogate(model, X, U, Y, steps=1500, lr=2e-3,
                              batch=1024)
    return [{k: np.asarray(v) for k, v in layer.items()} for layer in params]


def _compare(jres, tres):
    np.testing.assert_array_equal(tres.converged.numpy(),
                                  np.asarray(jres.converged))
    du = np.abs(tres.u.numpy() - np.asarray(jres.u)).max()
    assert du <= DU_TOL, du


def test_next_batch_cold_and_warm_match_jax(surrogate):
    jm, tm = jax_mpc(H), torch_mpc(H)
    assert jm.kkt_backend == tm.kkt_backend == "riccati"
    jp = jax_params(surrogate)
    tp = T.mlp_params_from_numpy(surrogate, device="cpu")
    xs = x0_batch(B)
    jc, jres = jm.next_batch(jnp.asarray(xs), params=jp)
    tc, tres = tm.next_batch(torch.as_tensor(xs), params=tp)
    _compare(jres, tres)
    assert bool(tres.converged.all())
    assert tres.x.shape == (B, H, 2) and tres.u.shape == (B, H, 1)
    plant = step_fn(J.jax_dynamics(lv_true_jax, 2, 1), "rk4", 0.1)
    for _ in range(2):
        xs = np.asarray(plant(jnp.asarray(xs),
                              jnp.asarray(np.asarray(jres.u)[:, 0])),
                        np.float32)
        jc, jres = jm.next_batch(jnp.asarray(xs), params=jp, carry=jc)
        tc, tres = tm.next_batch(torch.tensor(xs), params=tp, carry=tc)
        _compare(jres, tres)
    # warm re-plans converge faster than the cold solve
    assert float(tres.iterations.float().mean()) < 10


def test_next_single_problem_matches_jax(surrogate):
    jm, tm = jax_mpc(H_NEXT), torch_mpc(H_NEXT)
    jp = jax_params(surrogate)
    tp = T.mlp_params_from_numpy(surrogate, device="cpu")
    x0 = x0_batch(1)[0]
    for _ in range(2):          # cold, then warm from the instance carry
        jres = jm.next(jnp.asarray(x0), params=jp)
        tres = tm.next(torch.as_tensor(x0), params=tp)
        assert tres.u.shape == (H_NEXT, 1)
        assert bool(tres.converged) == bool(jres.converged)
        assert np.abs(tres.u.numpy() - np.asarray(jres.u)).max() <= DU_TOL
    tm.reset()
    assert tm._carry is None
    # the pure single-problem step (shift + solve) reaches the same optimum
    carry = tm.cold_start(torch.as_tensor(x0), params=tp)
    carry, sres = tm.step(carry, torch.as_tensor(x0), params=tp)
    assert carry.w.shape == (tm.nlp.n,) and bool(sres.converged)
    assert np.abs(sres.u.numpy() - np.asarray(jres.u)).max() <= DU_TOL


def test_unported_features_raise():
    for kw in ({"mu_strategy": "adaptive"}, {"hessian": "gauss_newton"},
               {"record": True}, {"kkt": "dense"}, {"debug": True}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            T.IPConfig(**kw)
    with pytest.raises(ValueError):
        T.IPConfig(kkt="nope")
    model = T.MLPDynamics.make(x_dim=2, u_dim=1, hidden=[4])
    cost = lambda x, u: torch.sum(u)  # noqa: E731
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        T.NMPC(model, cost, [object()], H=4, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        T.NMPC(model, cost, H=4, differentiable=True, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        T.NMPC(model, lambda x, u: torch.sum(u) + x[0, 0] * x[-1, 0],
               H=4, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        torch_mpc(4).next_batch(torch.zeros(2, 2), p=torch.zeros(2, 3))


def test_input_checks():
    tm = torch_mpc(4)
    with pytest.raises(ValueError, match="x0"):
        tm.next(torch.zeros(3))
    with pytest.raises(ValueError, match="together"):
        tm.next(torch.zeros(2), init_x=torch.zeros(4, 2))
    with pytest.raises(ValueError, match="init_x"):
        tm.next(torch.zeros(2), init_x=torch.zeros(3, 2),
                init_u=torch.zeros(3, 1))
