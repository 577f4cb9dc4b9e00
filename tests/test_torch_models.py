"""Models, integrators and rollouts: the port against the JAX package with
the same numpy weights and inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyneuralempc_tpu as J
import pyneuralempc_tpu_torch as T
from pyneuralempc_tpu.ops.integrators import step_fn as j_step_fn
from pyneuralempc_tpu.ops.rollout import simulate as j_simulate
from pyneuralempc_tpu_torch.ops.integrators import step_fn as t_step_fn
from pyneuralempc_tpu_torch.ops.rollout import defects as t_defects
from pyneuralempc_tpu_torch.ops.rollout import simulate as t_simulate

from _torch_lv import glorot_params, jax_params, lv_true_jax, lv_true_torch
import _torch_threads  # noqa: F401  (one torch thread)

RTOL, ATOL = 1e-5, 1e-6


def _models(np_params):
    jm = J.MLPDynamics.make(x_dim=2, u_dim=1, hidden=[32, 32])
    tm = T.MLPDynamics.make(x_dim=2, u_dim=1, hidden=[32, 32])
    tp = T.mlp_params_from_numpy(np_params, device="cpu")
    return (jm, jax_params(np_params)), (tm, tp)


def test_mlp_forward_matches_jax():
    (jm, jp), (tm, tp) = _models(glorot_params(0))
    assert jm.layer_sizes == tm.layer_sizes == (3, 32, 32, 2)
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (7, 2)).astype(np.float32)
    u = rng.uniform(0, 1.2, (7, 1)).astype(np.float32)
    np.testing.assert_allclose(
        tm(torch.as_tensor(x), torch.as_tensor(u), params=tp).numpy(),
        np.asarray(jm(jnp.asarray(x), jnp.asarray(u), params=jp)),
        rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("activation",
                         ["tanh", "relu", "gelu", "swish", "sigmoid"])
def test_mlp_activations_match_jax(activation):
    """Every hidden activation of the JAX package's MLP, on inputs wide
    enough to reach each one's tails.  (Port fault F4: "gelu" was torch's
    exact erf form, 4.7e-4 off jax.nn.gelu's default tanh approximation.)"""
    P = glorot_params(1)
    jm = J.MLPDynamics.make(x_dim=2, u_dim=1, hidden=[32, 32],
                            activation=activation)
    tm = T.MLPDynamics.make(x_dim=2, u_dim=1, hidden=[32, 32],
                            activation=activation)
    rng = np.random.default_rng(1)
    x = rng.uniform(-4, 4, (64, 2)).astype(np.float32)
    u = rng.uniform(-4, 4, (64, 1)).astype(np.float32)
    np.testing.assert_allclose(
        tm(torch.as_tensor(x), torch.as_tensor(u),
           params=T.mlp_params_from_numpy(P, device="cpu")).numpy(),
        np.asarray(jm(jnp.asarray(x), jnp.asarray(u),
                      params=jax_params(P))),
        rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("integrator", ["delta", "euler", "rk4", "direct"])
def test_step_fn_matches_jax(integrator):
    (jm, jp), (tm, tp) = _models(glorot_params(1))
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, (5, 2)).astype(np.float32)
    u = rng.uniform(0, 1.2, (5, 1)).astype(np.float32)
    jphi = j_step_fn(jm, integrator, 0.1)
    tphi = t_step_fn(tm, integrator, 0.1)
    np.testing.assert_allclose(
        tphi(torch.as_tensor(x), torch.as_tensor(u), params=tp).numpy(),
        np.asarray(jphi(jnp.asarray(x), jnp.asarray(u), params=jp)),
        rtol=RTOL, atol=ATOL)


def test_simulate_and_defects_match_jax():
    jtrue = J.jax_dynamics(lv_true_jax, 2, 1)
    ttrue = T.torch_dynamics(lv_true_torch, 2, 1)
    jphi, tphi = j_step_fn(jtrue, "rk4", 0.1), t_step_fn(ttrue, "rk4", 0.1)
    rng = np.random.default_rng(2)
    x0 = np.asarray([0.4, -0.6], np.float32)
    U = rng.uniform(0, 1.2, (10, 1)).astype(np.float32)
    jX = np.asarray(j_simulate(jphi, jnp.asarray(x0), jnp.asarray(U)))
    tX = t_simulate(tphi, torch.as_tensor(x0), torch.as_tensor(U)).numpy()
    np.testing.assert_allclose(tX, jX, rtol=RTOL, atol=ATOL)
    # the simulated trajectory is dynamically consistent: zero defects
    d = t_defects(tphi, torch.as_tensor(tX), torch.as_tensor(U),
                  torch.as_tensor(x0))
    assert float(d.abs().max()) < 1e-6
    # a batch of x0s rolls out as independent rows
    x0s = np.stack([x0, x0[::-1]]).astype(np.float32)
    Us = np.stack([U, U[::-1]])
    tXs = t_simulate(tphi, torch.as_tensor(x0s), torch.as_tensor(Us))
    for b in range(2):
        jXb = np.asarray(j_simulate(jphi, jnp.asarray(x0s[b]),
                                    jnp.asarray(Us[b])))
        np.testing.assert_allclose(tXs[b].numpy(), jXb, rtol=RTOL, atol=ATOL)


def test_mlp_init_is_glorot_and_seeded():
    g1, g2 = torch.Generator(), torch.Generator()
    g1.manual_seed(3)
    g2.manual_seed(3)
    p1 = T.mlp_init(g1, (3, 32, 2), device="cpu")
    p2 = T.mlp_init(g2, (3, 32, 2), device="cpu")
    assert [tuple(l["w"].shape) for l in p1] == [(3, 32), (32, 2)]
    for a, b in zip(p1, p2):
        assert torch.equal(a["w"], b["w"]) and torch.equal(a["b"], b["b"])
    assert float(p1[0]["w"].abs().max()) <= np.sqrt(6.0 / 35)
    assert float(p1[0]["b"].abs().max()) == 0.0


def test_fit_surrogate_learns_lv():
    gen = torch.Generator()
    gen.manual_seed(0)
    X, U, Y = T.sample_transitions(lv_true_torch, gen, 2048, 2, 1,
                                   x_range=(-1.0, 1.2), u_range=(0.0, 1.2),
                                   device="cpu")
    assert X.shape == (2048, 2) and U.shape == (2048, 1)
    assert float(X.min()) >= -1.0 and float(X.max()) <= 1.2
    model = T.MLPDynamics.make(x_dim=2, u_dim=1, hidden=[16, 16])
    params, mse = T.fit_surrogate(model, X, U, Y, steps=300, lr=5e-3,
                                  batch=256)
    assert mse < 0.1 * float(Y.var())
    assert not any(t.requires_grad for layer in params
                   for t in layer.values())


def test_torch_dynamics_safe_mode():
    m = T.torch_dynamics(lv_true_torch, 2, 1, safe_mode=True)
    assert m.x_dim == 2 and m.u_dim == 1
    with pytest.raises(ValueError, match="shape"):
        T.torch_dynamics(lambda x, u: x[:, :1], 2, 1, safe_mode=True)
