"""Rolling-window models (``models/rolling.py``): the port against the JAX
package on the CPU.

* ``rolling_mlp`` (window 3, with and without tvp/p features) and
  ``rolling_window`` around a hand-written inner step, in both readout
  modes, through ``step_fn(..., "direct")`` on the same numpy weights and
  inputs, within rtol 1e-5; ``lift``, ``head`` and ``box`` alike.
* The JAX package's rolling-window MPC (``tests/test_models_io.py``: window
  2, direct integrator, setpoint 0.5) solved by both: ``next`` on one
  problem and ``next_batch`` on four, |Δu|∞ ≤ 1e-4 with equal converged
  flags and iteration counts.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyneuralempc_tpu as J
import pyneuralempc_tpu_torch as T
from pyneuralempc_tpu.ops.integrators import step_fn as j_step_fn
from pyneuralempc_tpu_torch.ops.integrators import step_fn as t_step_fn

from _torch_lv import glorot_params, jax_params
import _torch_threads  # noqa: F401  (one torch thread)

RTOL, ATOL = 1e-5, 1e-6
DU_TOL = 1e-4


def _close(got, ref):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("mode,p_dim,tvp_dim", [("delta", 0, 0),
                                                ("next", 2, 1)])
def test_rolling_mlp_matches_jax(mode, p_dim, tvp_dim):
    W, nx, nu = 3, 2, 1
    jrw, _ = J.rolling_mlp(nx, nu, W, hidden=[8], mode=mode, p_dim=p_dim,
                           tvp_dim=tvp_dim)
    trw, tinit = T.rolling_mlp(nx, nu, W, hidden=[8], mode=mode,
                               p_dim=p_dim, tvp_dim=tvp_dim)
    sizes = (W * nx + nu + tvp_dim + p_dim, 8, nx)
    prm = glorot_params(4, sizes)
    assert [tuple(layer["w"].shape) for layer in
            tinit(torch.Generator().manual_seed(0), device="cpu")] == [
        (sizes[0], 8), (8, nx)]
    rng = np.random.default_rng(5)
    z = rng.normal(size=(5, W * nx)).astype(np.float32)
    u = rng.normal(size=(5, nu)).astype(np.float32)
    p = rng.normal(size=(p_dim,)).astype(np.float32) if p_dim else None
    tvp = (rng.normal(size=(5, tvp_dim)).astype(np.float32) if tvp_dim
           else None)

    def j(a):
        return None if a is None else jnp.asarray(a)

    def t(a):
        return None if a is None else torch.as_tensor(a)
    jphi = j_step_fn(jrw.model, "direct", 1.0)
    tphi = t_step_fn(trw.model, "direct", 1.0)
    _close(tphi(t(z), t(u), t(p), t(tvp), T.mlp_params_from_numpy(
        prm, device="cpu")), jphi(j(z), j(u), j(p), j(tvp), jax_params(prm)))


def _inner_jax(z, u, p, tvp, params):
    return 0.8 * z[:, :1] + 0.15 * z[:, 1:2] + 0.3 * u - z[:, :1]


def _inner_torch(z, u, p, tvp, params):
    return 0.8 * z[:, :1] + 0.15 * z[:, 1:2] + 0.3 * u - z[:, :1]


@pytest.mark.parametrize("window", [1, 2, 4])
def test_rolling_window_shift_register_matches_jax(window):
    jrw = J.rolling_window(_inner_jax, x_dim=1, u_dim=1, window=window)
    trw = T.rolling_window(_inner_torch, x_dim=1, u_dim=1, window=window)
    rng = np.random.default_rng(window)
    hist = rng.normal(size=(window, 1)).astype(np.float32)
    z0j, z0t = jrw.lift(jnp.asarray(hist)), trw.lift(torch.as_tensor(hist))
    _close(z0t, z0j)
    u = np.array([[0.4]], np.float32)
    _close(trw.model(z0t[None], torch.as_tensor(u)),
           jrw.model(z0j[None], jnp.asarray(u)))
    jb = jrw.box([[-5.0, 5.0]], [[-2.0, 2.0]])
    tb = trw.box([[-5.0, 5.0]], [[-2.0, 2.0]])
    assert (tb.x_lb, tb.x_ub, tb.u_lb, tb.u_ub) == (jb.x_lb, jb.x_ub,
                                                    jb.u_lb, jb.u_ub)
    with pytest.raises(ValueError, match="history"):
        trw.lift(torch.zeros(window + 1, 1))


def test_rolling_window_refuses_bad_arguments():
    with pytest.raises(ValueError, match="window"):
        T.rolling_window(_inner_torch, 1, 1, window=0)
    with pytest.raises(ValueError, match="mode"):
        T.rolling_window(_inner_torch, 1, 1, window=2, mode="other")


def test_rolling_mpc_matches_jax():
    """The JAX package's rolling-window MPC: x_{t+1} = 0.8 x_t + 0.15
    x_{t-1} + 0.3 u_t lifted at window 2, setpoint 0.5, H=8."""
    W, H = 2, 8
    jrw = J.rolling_window(_inner_jax, x_dim=1, u_dim=1, window=W)
    trw = T.rolling_window(_inner_torch, x_dim=1, u_dim=1, window=W)
    jcost = jrw.head_objective(lambda x, u: jnp.sum((x - 0.5) ** 2)
                               + 0.01 * jnp.sum(u ** 2))
    tcost = trw.head_objective(lambda x, u: torch.sum((x - 0.5) ** 2)
                               + 0.01 * torch.sum(u ** 2))
    jm = J.NMPC(jrw.model, jcost, [jrw.box([[-5.0, 5.0]], [[-2.0, 2.0]])],
                H=H, DT=1.0, integrator="direct",
                config=J.IPConfig(max_iter=60))
    tm = T.NMPC(trw.model, tcost, [trw.box([[-5.0, 5.0]], [[-2.0, 2.0]])],
                H=H, DT=1.0, integrator="direct",
                config=T.IPConfig(max_iter=60), device="cpu")
    hist = np.array([[0.0], [0.1]], np.float32)
    jres = jm.next(jrw.lift(jnp.asarray(hist)))
    tres = tm.next(trw.lift(torch.as_tensor(hist)))
    assert bool(tres.converged) and bool(jres.converged)
    assert int(tres.iterations) == int(jres.iterations)
    assert np.abs(tres.u.numpy() - np.asarray(jres.u)).max() <= DU_TOL
    assert abs(float(trw.head(tres.x)[-1, 0]) - 0.5) < 0.1
    Z = tres.x.numpy()
    np.testing.assert_allclose(Z[1:, 1], Z[:-1, 0], atol=1e-4)

    rng = np.random.default_rng(7)
    z0s = rng.uniform(-0.5, 0.5, (4, W)).astype(np.float32)
    _, jb = jm.next_batch(jnp.asarray(z0s))
    _, tb = tm.next_batch(torch.as_tensor(z0s))
    np.testing.assert_array_equal(tb.converged.numpy(),
                                  np.asarray(jb.converged))
    np.testing.assert_array_equal(tb.iterations.numpy(),
                                  np.asarray(jb.iterations))
    assert np.abs(tb.u.numpy() - np.asarray(jb.u)).max() <= DU_TOL
    assert bool(tb.converged.all())
