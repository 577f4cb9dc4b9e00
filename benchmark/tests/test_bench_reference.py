"""The benchmark's plain references against the package under test, at tiny
sizes on the CPU: the frozen copies equal what they copy, and the judge
reads a converged plan of the port as converged."""

import pytest
import torch

from benchmark.reference import quadrotor as ref_quad
from benchmark.reference import sweep_counts

from pyneuralempc_tpu_torch.examples import quadrotor
from pyneuralempc_tpu_torch.ops.cuda import riccati_kernel
from pyneuralempc_tpu_torch.ops.integrators import step_fn


def _states(n, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = (torch.rand((n, 12), generator=g) * 3.0 - 1.5)
    u = torch.rand((n, 4), generator=g) * 3.0
    return x, u


def test_rigid_body_and_features_equal_the_example():
    x, u = _states(64)
    assert torch.equal(ref_quad.rigid_body_f(x, u), quadrotor.quad_f()(x, u))
    assert torch.equal(ref_quad.features(x), quadrotor.quad_features(x))


def test_tracking_cost_at_zero_reference_is_the_example_cost():
    x, u = _states(8, seed=1)
    cost = quadrotor.quad_cost()
    for i in range(8):
        assert torch.allclose(ref_quad.stage_cost(x[i], u[i]),
                              cost.stage(x[i], u[i]), rtol=1e-6, atol=0)
        assert torch.allclose(ref_quad.terminal_cost(x[i]),
                              cost.terminal(x[i]), rtol=1e-6, atol=0)


def test_fit_equals_the_ports_normalised_fit():
    cfg = {"seed": 3, "n": 512, "steps": 12, "batch": 128, "lr": 1e-3,
           "hidden": [256, 256], "x_range": [-1.5, 1.5],
           "u_range": [0.0, 3.0]}
    fit = ref_quad.fit_surrogate(cfg, "cpu")
    model, params, mse = quadrotor.fit_quad_mlp("cpu", n=512, steps=12,
                                                batch=128, seed=3)
    assert fit["mse"] == mse
    for (w, b), layer in zip(fit["layers"], params):
        assert torch.equal(w, layer["w"]) and torch.equal(b, layer["b"])
    x, u = _states(32, seed=2)
    f32 = ref_quad.fit_to(fit, torch.float32, "cpu")
    assert torch.allclose(ref_quad.surrogate_f(f32, x, u),
                          model(x, u, params=params), rtol=1e-6, atol=1e-5)
    # RK4 of the surrogate as the port's integrator takes it
    phi = step_fn(model, "rk4", 0.02)
    assert torch.allclose(
        ref_quad.rk4(lambda a, b: ref_quad.surrogate_f(f32, a, b), x, u,
                     0.02),
        phi(x, u, params=params), rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("shape", [(1024, 50, 12, 4, 1, 0),
                                   (4096, 100, 18, 1, 1, 0),
                                   (4096, 50, 12, 4, 2, 1)])
def test_sweep_counts_equal_the_ports(shape):
    assert (sweep_counts.sweep_bytes(*shape)
            == riccati_kernel.sweep_bytes(*shape))
    assert (sweep_counts.sweep_flops(*shape)
            == riccati_kernel.sweep_flops(*shape))


def test_sweep_bounds_of_the_cells():
    """The least time of one sweep on an H100 (float32 67 TFLOP/s, 3.35
    TB/s): the quadrotor's sweeps, at 1,024 and the cell's 2,048 members,
    are bound by bytes."""
    q = sweep_counts.least_seconds(1024, 50, 12, 4, 67e12, 3.35e12)
    c = sweep_counts.least_seconds(2048, 50, 12, 4, 67e12, 3.35e12)
    assert q == pytest.approx(106.50112e6 / 3.35e12)
    assert c == pytest.approx(2 * 106.50112e6 / 3.35e12)
