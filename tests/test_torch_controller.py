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
from pyneuralempc_tpu_torch.parallel import make_horizon_mesh
from pyneuralempc_tpu.models.train import fit_surrogate, sample_transitions
from pyneuralempc_tpu.ops.integrators import step_fn

from _torch_lv import (jax_mpc, jax_params, lv_true_jax, torch_mpc,
                       x0_batch)
import _torch_threads  # noqa: F401  (one torch thread)

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
    """Nothing is left to port: the parallel-in-time and multi-device
    solves (#14), the dense backend, ALM, the differentiable solve and
    record/debug (#10, #15) build, each under its backend's name."""
    for kw in ({"record": True}, {"kkt": "dense"}, {"debug": True},
               {"kkt": "riccati_pscan"}):
        T.IPConfig(**kw)               # ported: no raise
    with pytest.raises(ValueError):
        T.IPConfig(kkt="nope")
    model = T.MLPDynamics.make(x_dim=2, u_dim=1, hidden=[4])
    cost = lambda x, u: torch.sum(u)  # noqa: E731
    stage = T.StageCost(stage=lambda x, u: torch.sum(u))
    assert T.NMPC(model, stage, H=4, config=T.IPConfig(kkt="riccati_pscan"),
                  device="cpu").kkt_backend == "riccati_pscan"
    mesh = make_horizon_mesh(1, 2, devices=["cpu"] * 2)
    assert T.NMPC(model, stage, H=4, mesh=mesh,
                  device="cpu").kkt_backend == "riccati_horizon"
    # a constraint the Riccati backend cannot take (more equality rows a
    # stage than controls) and a stage-coupled cost take the dense one
    two_eq = T.StageConstraint(stage=lambda x, u: torch.cat([u, u]), dim=2,
                               lb=(0.0, 0.0), ub=(0.0, 0.0))
    assert T.NMPC(model, cost, [two_eq], H=4,
                  device="cpu").kkt_backend == "dense"
    with pytest.raises(TypeError, match="unknown constraint"):
        T.NMPC(model, cost, [object()], H=4, device="cpu")
    assert T.NMPC(model, cost, H=4, differentiable=True,
                  device="cpu").kkt_backend == "riccati"
    assert T.NMPC(model, lambda x, u: torch.sum(u) + x[0, 0] * x[-1, 0],
                  H=4, device="cpu").kkt_backend == "dense"
    assert T.NMPC(model, cost, H=4, config=T.ALMConfig(),
                  device="cpu").kkt_backend == "alm"
    # per-member p must lead with the batch size
    with pytest.raises(ValueError, match="batch size"):
        torch_mpc(4).next_batch(torch.zeros(2, 2), p=torch.zeros(3, 3))


def test_input_checks():
    tm = torch_mpc(4)
    with pytest.raises(ValueError, match="x0"):
        tm.next(torch.zeros(3))
    with pytest.raises(ValueError, match="together"):
        tm.next(torch.zeros(2), init_x=torch.zeros(4, 2))
    with pytest.raises(ValueError, match="init_x"):
        tm.next(torch.zeros(2), init_x=torch.zeros(3, 2),
                init_u=torch.zeros(3, 1))


def _decay_models(H_=10):
    """A raw DynamicsModel ẋ = −params·x + u at (x_dim, u_dim) = (2, 1) in
    both packages, tracking x = 0.5 with a small control cost."""
    def jf(x, u, p, tvp, params):
        return -params * x + u

    def tf(x, u, p, tvp, params):
        return -params * x + u

    box = dict(states_constraint=[[-2.0, 2.0]] * 2,
               control_constraint=[[-1.0, 1.0]])
    jm = J.NMPC(J.DynamicsModel(fn=jf, dims=J.Dims(2, 1, 0, 0)),
                lambda x, u: jnp.sum((x - 0.5) ** 2) + 0.1 * jnp.sum(u * u),
                [J.DomainConstraint(**box)], H=H_, DT=0.1, integrator="rk4")
    tm = T.NMPC(T.DynamicsModel(fn=tf, dims=T.Dims(2, 1, 0, 0)),
                lambda x, u: torch.sum((x - 0.5) ** 2)
                + 0.1 * torch.sum(u * u),
                [T.DomainConstraint(**box)], H=H_, DT=0.1, integrator="rk4",
                device="cpu")
    return jm, tm


def test_next_batch_refuses_per_member_params():
    """params whose every tensor leads with the batch size are per member
    (the JAX package's ``_baxis_tree`` rule): the port solves them as the
    JAX package does, one model per member, and shared scalar params still
    solve as shared.  (Per-member params were refused, naming ROADMAP
    Queue 1 #6b, until the port took them.)"""
    jm, tm = _decay_models()
    xs = np.full((2, 2), 1.0, np.float32)
    _, jper = jm.next_batch(jnp.asarray(xs),
                            params=jnp.asarray([0.5, 2.0], jnp.float32))
    _, tper = tm.next_batch(torch.as_tensor(xs),
                            params=torch.tensor([0.5, 2.0]))
    u = tper.u.numpy()
    assert np.abs(u[0] - u[1]).max() > 1e-2    # equal starts, other plans
    _compare(jper, tper)
    np.testing.assert_array_equal(tper.iterations.numpy(),
                                  np.asarray(jper.iterations))
    assert bool(tper.converged.all())
    _, jres = jm.next_batch(jnp.asarray(xs), params=jnp.float32(0.5))
    _, tres = tm.next_batch(torch.as_tensor(xs), params=torch.tensor(0.5))
    _compare(jres, tres)
    assert bool(tres.converged.all())
    # the per-member solve's first member is the shared solve at its value
    assert np.abs(u[0] - tres.u.numpy()[0]).max() <= 1e-5