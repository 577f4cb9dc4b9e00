"""Tests of the port that need an NVIDIA card: the CUDA sweep against its
plain version, the wrapper's checks, and the main path on the card against
the CPU.  They skip without a CUDA device.  This file imports no JAX, so on
the card it runs without the JAX package's test configuration:

    python -m pytest --noconftest -o addopts="" tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

import pyneuralempc_tpu_torch as nempc
from pyneuralempc_tpu_torch.ops.cuda import riccati_kernel as rk

pytestmark = pytest.mark.cuda

SCALED_ATOL = 2e-5     # |kernel − plain| / max(1, |plain|), f32


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False


def _sweep_inputs(B, H, nx=2, nu=1, seed=0, device="cuda"):
    """Seeded sweep inputs; G and M exactly symmetric."""
    rng = np.random.default_rng(seed)
    ns = nx + nu
    A = np.eye(nx) + 0.03 * rng.normal(size=(B, H, nx, nx))
    Bm = 0.1 * rng.normal(size=(B, H, nx, nu))
    G = rng.normal(0, 0.05, (B, H, ns, ns)).astype(np.float32)
    M = rng.normal(0, 0.1, (B, H, ns, ns)).astype(np.float32)
    G = 0.5 * (G + G.transpose(0, 1, 3, 2))
    M = 0.5 * (M + M.transpose(0, 1, 3, 2)) + np.eye(ns, dtype=np.float32)
    mx = rng.normal(size=(B, H, nx))
    mu = rng.normal(size=(B, H, nu))
    c = 0.1 * rng.normal(size=(B, H, nx))
    delta = np.linspace(0.0, 1.0, B)
    return [torch.tensor(np.asarray(a, np.float32), device=device)
            for a in (A, Bm, G, M, mx, mu, c, delta)]


@pytest.mark.parametrize("B,H", [(257, 20), (4096, 1), (33, 50)])
def test_kernel_matches_plain_on_card(B, H):
    _card()
    args = _sweep_inputs(B, H, seed=B + H)
    out = rk.riccati_sweep_cuda(*args)
    ref = rk.riccati_sweep_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(out[3], ref[3]) and bool(ref[3].all())
    for o, r in zip(out[:3], ref[:3]):
        err = ((o - r).abs() / r.abs().clamp(min=1.0)).max()
        assert float(err) <= SCALED_ATOL


def test_dispatch_and_checks_on_card():
    _card()
    args = _sweep_inputs(64, 5)
    launches, plain = rk.LAUNCHES, rk.PLAIN_CALLS
    rk.riccati_sweep(*args)
    assert (rk.LAUNCHES, rk.PLAIN_CALLS) == (launches + 1, plain)
    with pytest.raises(NotImplementedError, match="nx=4, nu=2"):
        rk.riccati_sweep(*_sweep_inputs(8, 3, nx=4, nu=2))
    with pytest.raises(TypeError, match="float32"):
        rk.riccati_sweep_cuda(*[a.double() for a in args])
    bad = list(args)
    bad[0] = args[0].transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        rk.riccati_sweep_cuda(*bad)
    assert rk.LAUNCHES == launches + 1


def _lv(x, u):
    xr = 30.0 * (x + 1.0)
    d1 = 0.5 * xr[:, :1] - 0.025 * xr[:, :1] * xr[:, 1:]
    d2 = -0.5 * xr[:, 1:] + 50.0 * u + 0.005 * xr[:, :1] * xr[:, 1:]
    return torch.cat([d1, d2], dim=1) / 30.0


def test_main_path_on_card_matches_cpu():
    """NMPC.next_batch on the card goes through the kernel only and agrees
    with the CPU port (plain sweep) to bench.py's 1e-4 in u."""
    _card()
    rng = np.random.default_rng(0)
    x0s = np.stack([rng.uniform(0.2, 0.8, 64), rng.uniform(-0.9, -0.3, 64)],
                   axis=1).astype(np.float32)
    res = {}
    for dev in ("cuda", "cpu"):
        mpc = nempc.NMPC(
            nempc.torch_dynamics(_lv, 2, 1),
            lambda x, u: 1.1 * torch.sum(u) + 1e-4 * torch.sum(u * u),
            [nempc.DomainConstraint(states_constraint=[[-1.0, 1.0],
                                                       [-1.0, 0.35]],
                                    control_constraint=[[0.0, 1.2]])],
            H=10, DT=0.1, config=nempc.IPConfig(tol=1e-5, polish_iters=5),
            device=dev)
        launches, plain = rk.LAUNCHES, rk.PLAIN_CALLS
        carry, r = mpc.next_batch(torch.tensor(x0s, device=dev))
        carry, r = mpc.next_batch(torch.tensor(x0s, device=dev),
                                  carry=carry)
        if dev == "cuda":
            assert rk.LAUNCHES > launches and rk.PLAIN_CALLS == plain
        res[dev] = r
    assert torch.equal(res["cuda"].converged.cpu(), res["cpu"].converged)
    assert float((res["cuda"].u.cpu() - res["cpu"].u).abs().max()) <= 1e-4
