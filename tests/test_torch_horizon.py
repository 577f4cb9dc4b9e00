"""The horizon-sharded (sequence-parallel) Riccati sweep
(``parallel/horizon.py``) and ``NMPC(mesh=...)``: the port against the JAX
package on the CPU.

The JAX package runs on its virtual 8-device CPU mesh
(``tests/conftest.py``); the port on a mesh that names the CPU 8 times.
The sweeps' inputs are ``tests/test_horizon_sharding.py``'s, held to the
JAX package's sharded sweep and to the port's plain sequential sweep
within that file's bounds: 2e-4 of max|·| + 1 for each output at H=32, and
1e-3 of max|dX| + 1 at H=128.  The controllers solve its two problems (a
box; a box and an active nonlinear stage interval row) in both packages,
held to 5e-4 in u (and in the slacks), its bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyneuralempc_tpu as J
import pyneuralempc_tpu_torch as T
from pyneuralempc_tpu.parallel.horizon import (
    make_horizon_mesh as j_horizon_mesh,
    make_sharded_sweep as j_sharded_sweep)
from pyneuralempc_tpu_torch.ops.cuda.riccati_kernel import riccati_sweep_plain
from pyneuralempc_tpu_torch.parallel import (make_horizon_mesh, make_mesh,
                                             make_sharded_sweep)

from test_pscan import make_data
import _torch_threads  # noqa: F401  (one torch thread)

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 (virtual) devices")

CPU8 = ["cpu"] * 8
U_TOL = 5e-4


def batch_args(B=8, H=32, nx=3, nu=2):
    """``test_horizon_sharding.py``'s inputs, numpy."""
    datas = [make_data(H=H, nx=nx, nu=nu, seed=s) for s in range(B)]
    return ([np.stack([np.asarray(d[i]) for d in datas]) for i in range(7)]
            + [np.zeros((B,), np.float32)])


def sweeps(args, n_scenario, n_horizon):
    t = [torch.as_tensor(a) for a in args]
    port = make_sharded_sweep(make_horizon_mesh(n_scenario, n_horizon,
                                                devices=CPU8))(*t)
    jx = j_sharded_sweep(j_horizon_mesh(n_scenario, n_horizon))(
        *[jnp.asarray(a) for a in args])
    plain = riccati_sweep_plain(*t)
    return ([o.numpy() for o in port], [np.asarray(o) for o in jx],
            [o.numpy() for o in plain])


@pytest.mark.parametrize("n_horizon", [2, 4, 8])
def test_sharded_sweep_matches_jax_and_plain(n_horizon):
    port, jx, plain = sweeps(batch_args(), 8 // n_horizon, n_horizon)
    assert port[3].all() and jx[3].all()
    for ref in (jx, plain):
        for r, o in zip(ref[:3], port[:3]):
            scale = float(np.abs(r).max()) + 1.0
            np.testing.assert_allclose(o, r, atol=2e-4 * scale)


def test_sharded_long_horizon():
    """H=128 over 4 horizon shards x 2 scenario shards."""
    port, jx, plain = sweeps(batch_args(B=4, H=128, nx=2, nu=1), 2, 4)
    assert port[3].all() and jx[3].all()
    for ref in (jx, plain):
        scale = float(np.abs(ref[0]).max()) + 1.0
        np.testing.assert_allclose(port[0], ref[0], atol=1e-3 * scale)


def test_sharded_sweep_failure_and_shapes():
    """A member that fails (negative control curvature at δ = 0) fails in
    the sharded sweep as in the plain one, whichever shard holds the bad
    stage; a batch or horizon the mesh does not divide raises."""
    args = batch_args(B=4, H=32, nx=2, nu=1)
    args[3][1, 20, 2, 2] = -30.0          # member 1, the third shard of 4
    args[3][2, 3, 2, 2] = -30.0           # member 2, the first
    t = [torch.as_tensor(a) for a in args]
    ok = make_sharded_sweep(make_horizon_mesh(2, 4, devices=CPU8))(*t)[3]
    assert ok.tolist() == riccati_sweep_plain(*t)[3].tolist() == [
        True, False, False, True]
    with pytest.raises(ValueError, match="divide"):
        make_sharded_sweep(make_horizon_mesh(4, 2, devices=CPU8))(
            *[a[:2] for a in t])
    with pytest.raises(ValueError, match="divide"):
        make_sharded_sweep(make_horizon_mesh(1, 8, devices=CPU8))(
            *[a[:, :28] if a.dim() > 1 else a for a in t])


def _f_t(x, u):
    return torch.cat([x[:, 1:], u - 0.2 * x[:, :1]], 1)


def _f_j(x, u):
    return jnp.concatenate([x[:, 1:], u - 0.2 * x[:, :1]], axis=1)


BOX = dict(states_constraint=[[-2.0, 2.0]] * 2,
           control_constraint=[[-1.0, 1.0]])


def _controllers(stage_row):
    """``test_horizon_sharding.py``'s two problems (H=8, B=4): the JAX
    package's on its (2, 4) mesh, and the port's plain and on a (2, 4)
    mesh of the CPU."""
    target = 0.5 if stage_row else 0.3
    tol = 1e-6 if stage_row else 1e-4
    out = []
    for lib, npx, f, kw in ((J, jnp, _f_j, {}), (T, torch, _f_t,
                                                 {"device": "cpu"})):
        cost = lib.StageCost(stage=lambda x, u, npx=npx, t=target: npx.sum(
            u ** 2) + npx.sum((x - t) ** 2))
        cons = [lib.DomainConstraint(**BOX)]
        if stage_row:
            cons.append(lib.stage_interval(
                lambda x, u, npx=npx: npx.stack([x[0] ** 2 + x[1] ** 2]),
                dim=1, lb=-np.inf, ub=0.09))
        model = (J.jax_dynamics(f, x_dim=2, u_dim=1) if lib is J
                 else T.torch_dynamics(f, x_dim=2, u_dim=1))
        mk = dict(H=8, DT=0.1, integrator="rk4",
                  config=lib.IPConfig(tol=tol), **kw)
        mesh = (j_horizon_mesh(2, 4) if lib is J
                else make_horizon_mesh(2, 4, devices=CPU8))
        out.append((lib.NMPC(model, cost, cons, **mk),
                    lib.NMPC(model, cost, cons, mesh=mesh, **mk)))
    return out


@pytest.mark.parametrize("stage_row", [False, True],
                         ids=["box", "stage_interval"])
def test_nmpc_mesh_matches_jax(stage_row):
    (_, j_sh), (t_ref, t_sh) = _controllers(stage_row)
    assert t_sh.kkt_backend == "riccati_horizon" == j_sh.kkt_backend
    assert t_ref.kkt_backend == "riccati"
    rng = np.random.default_rng(0)
    x0s = rng.uniform(-0.15, 0.15, (4, 2)) if stage_row else rng.uniform(
        -0.5, 0.5, (4, 2))
    x0s = x0s.astype(np.float32)
    _, r_sh = t_sh.next_batch(torch.as_tensor(x0s))
    _, r_ref = t_ref.next_batch(torch.as_tensor(x0s))
    _, j_res = j_sh.next_batch(jnp.asarray(x0s))
    assert bool(r_sh.converged.all()) and bool(r_ref.converged.all())
    assert bool(jnp.all(j_res.converged))
    for ref in (np.asarray(j_res.u), r_ref.u.numpy()):
        np.testing.assert_allclose(r_sh.u.numpy(), ref, atol=U_TOL)
    if stage_row:
        g = r_ref.x[..., 0] ** 2 + r_ref.x[..., 1] ** 2
        assert float(g.max()) > 0.09 - 1e-3           # the row is active
        np.testing.assert_allclose(r_sh.slack.numpy(),
                                   np.asarray(j_res.slack), atol=U_TOL)


def test_next_on_mesh_takes_pscan():
    """``NMPC.next`` on a mesh solves its one problem with the
    single-device parallel-in-time sweep: the plans of
    ``IPConfig(kkt="riccati_pscan")`` exactly, and the JAX package's
    ``next`` on its mesh within 5e-4."""
    (_, j_sh), (t_ref, t_sh) = _controllers(False)
    x0 = np.array([0.3, -0.2], np.float32)
    r = t_sh.next(torch.as_tensor(x0))
    pscan = T.NMPC(T.torch_dynamics(_f_t, x_dim=2, u_dim=1),
                   t_sh.spec.objective, [T.DomainConstraint(**BOX)], H=8,
                   DT=0.1, integrator="rk4",
                   config=T.IPConfig(kkt="riccati_pscan"), device="cpu")
    assert bool(r.converged)
    assert torch.equal(r.u, pscan.next(torch.as_tensor(x0)).u)
    j = j_sh.next(jnp.asarray(x0))
    np.testing.assert_allclose(r.u.numpy(), np.asarray(j.u), atol=U_TOL)


def test_mesh_validation():
    model = T.torch_dynamics(_f_t, x_dim=2, u_dim=1)
    cost = T.StageCost(stage=lambda x, u: torch.sum(u ** 2))
    with pytest.raises(ValueError, match="axes"):
        T.NMPC(model, cost, H=8, mesh=make_mesh(2, devices=CPU8),
               device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        T.NMPC(model, cost, H=10, mesh=make_horizon_mesh(1, 4, devices=CPU8),
               device="cpu")
    mesh = make_horizon_mesh(2, 4, devices=CPU8)
    assert mesh.shape == {"scenario": 2, "horizon": 4}
    assert mesh.axis_names == ("scenario", "horizon")
    assert mesh.devices.shape == (2, 4)
    with pytest.raises(ValueError, match="devices"):
        make_horizon_mesh(2, 4, devices=["cpu"] * 4)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError):    # the default: CUDA devices
            make_horizon_mesh(1, 2)
