"""Shared problem constructors for the port's parity tests: the LV-MLP
problem of bench.py (normalised Lotka-Volterra, 2x32 tanh MLP surrogate,
RK4, box bounds, 1.1·Σu + 1e-4·Σu² cost), built in both packages from the
same numpy weights."""

import jax.numpy as jnp
import numpy as np
import torch

import pyneuralempc_tpu as J
import pyneuralempc_tpu_torch as T

REG = 1e-4
BOX = dict(states_constraint=[[-1.0, 1.0], [-1.0, 0.35]],
           control_constraint=[[0.0, 1.2]])
BENCH_CFG = dict(tol=1e-5, polish_iters=5, polish_mu=1e-9,
                 warm_z_corridor=1e2, warm_mu=3e-4)


def glorot_params(seed, sizes=(3, 32, 32, 2)):
    """MLP weights as numpy arrays (the layout both packages use)."""
    rng = np.random.default_rng(seed)
    out = []
    for fi, fo in zip(sizes[:-1], sizes[1:]):
        lim = np.sqrt(6.0 / (fi + fo))
        out.append({"w": rng.uniform(-lim, lim, (fi, fo)).astype(np.float32),
                    "b": rng.normal(0, 0.1, (fo,)).astype(np.float32)})
    return out


def jax_params(np_params):
    return [{k: jnp.asarray(v) for k, v in layer.items()}
            for layer in np_params]


def jax_mpc(H, config=None, cost=None):
    model = J.MLPDynamics.make(x_dim=2, u_dim=1, hidden=[32, 32])
    cost = cost or (lambda x, u: 1.1 * jnp.sum(u) + REG * jnp.sum(u * u))
    return J.NMPC(model, cost, [J.DomainConstraint(**BOX)], H=H, DT=0.1,
                  integrator="rk4",
                  config=J.IPConfig(**(config or BENCH_CFG)))


def torch_mpc(H, config=None, cost=None):
    model = T.MLPDynamics.make(x_dim=2, u_dim=1, hidden=[32, 32])
    cost = cost or (lambda x, u: 1.1 * torch.sum(u)
                    + REG * torch.sum(u * u))
    return T.NMPC(model, cost, [T.DomainConstraint(**BOX)], H=H, DT=0.1,
                  integrator="rk4",
                  config=T.IPConfig(**(config or BENCH_CFG)), device="cpu")


def lv_true_jax(x, u):
    xr = 30.0 * (x + 1.0)
    ur = 50.0 * u
    d1 = 0.5 * xr[:, :1] - 0.025 * xr[:, :1] * xr[:, 1:]
    d2 = -0.5 * xr[:, 1:] + ur + 0.005 * xr[:, :1] * xr[:, 1:]
    return jnp.concatenate([d1, d2], axis=1) / 30.0


def lv_true_torch(x, u):
    xr = 30.0 * (x + 1.0)
    ur = 50.0 * u
    d1 = 0.5 * xr[:, :1] - 0.025 * xr[:, :1] * xr[:, 1:]
    d2 = -0.5 * xr[:, 1:] + ur + 0.005 * xr[:, :1] * xr[:, 1:]
    return torch.cat([d1, d2], dim=1) / 30.0


def x0_batch(B, seed=0):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(0.2, 0.8, B), rng.uniform(-0.9, -0.3, B)],
                    axis=1).astype(np.float32)


def sweep_data(B=3, H=5, nx=2, nu=1, seed=0):
    """tests/test_pallas_kernel.py's sweep data, as float32 numpy arrays
    (G and M exactly symmetric)."""
    rng = np.random.default_rng(seed)
    ns = nx + nu
    A = np.eye(nx) + 0.1 * rng.normal(0, 0.3, (B, H, nx, nx))
    Bm = 0.1 * rng.normal(0, 1, (B, H, nx, nu))
    G = rng.normal(0, 0.05, (B, H, ns, ns)).astype(np.float32)
    G = 0.5 * (G + G.transpose(0, 1, 3, 2))
    M = rng.normal(0, 0.1, (B, H, ns, ns)).astype(np.float32)
    M = 0.5 * (M + M.transpose(0, 1, 3, 2)) + np.eye(ns, dtype=np.float32)
    mx = rng.normal(0, 1, (B, H, nx))
    mu_ = rng.normal(0, 1, (B, H, nu))
    c = rng.normal(0, 0.1, (B, H, nx))
    delta = np.zeros((B,))
    return [np.asarray(a, np.float32)
            for a in (A, Bm, G, M, mx, mu_, c, delta)]
