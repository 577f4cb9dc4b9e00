"""Scenario sharding (``parallel/sharding.py``): the port's mesh,
``shard_leading``, ``replicate`` and ``ShardedNMPC`` on the CPU, against
the unsharded port and the JAX package's ``ShardedNMPC`` on its virtual
8-device CPU mesh (``tests/conftest.py``).

The problem is ``tests/test_parallel.py``'s (a hidden-8 MLP, H=6, RK4, a
box, max_iter=30), the JAX package's initial params carried across by
``models/convert.py``.  Sharded against unsharded: equal converged masks,
|Δu|∞ ≤ 1e-3 (``test_parallel.py``'s bound); the port's sharded solve
against the JAX package's: equal masks, |Δu|∞ ≤ 1e-4 (the port's bound
against the JAX package on the LV fleet).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pyneuralempc_tpu as J
import pyneuralempc_tpu_torch as T
from pyneuralempc_tpu.parallel.sharding import (ShardedNMPC as JShardedNMPC,
                                                make_mesh as j_make_mesh)
from pyneuralempc_tpu_torch.parallel import (Sharded, ShardedNMPC, make_mesh,
                                             replicate, shard_leading)

import _torch_threads  # noqa: F401  (one torch thread)

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 (virtual) devices")

CPU8 = ["cpu"] * 8
SHARDED_DU = 1e-3
JAX_DU = 1e-4
BOX = dict(states_constraint=[[-2.0, 2.0]] * 2,
           control_constraint=[[-1.0, 1.0]])


@pytest.fixture(scope="module")
def problem():
    """The port's controller, its params (the JAX package's initial ones)
    and the JAX package's controller and params."""
    jmodel = J.MLPDynamics.make(x_dim=2, u_dim=1, hidden=[8])
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    jmpc = J.NMPC(jmodel, lambda x, u: jnp.sum(u ** 2) + jnp.sum(x[:, 0] ** 2),
                  [J.DomainConstraint(**BOX)], H=6, DT=0.1, integrator="rk4",
                  config=J.IPConfig(max_iter=30))
    tmpc = T.NMPC(T.MLPDynamics.make(x_dim=2, u_dim=1, hidden=[8]),
                  lambda x, u: torch.sum(u ** 2) + torch.sum(x[:, 0] ** 2),
                  [T.DomainConstraint(**BOX)], H=6, DT=0.1, integrator="rk4",
                  config=T.IPConfig(max_iter=30), device="cpu")
    params = T.mlp_params_from_numpy(
        [{k: np.asarray(v) for k, v in layer.items()} for layer in jparams],
        device="cpu")
    return tmpc, params, jmpc, jparams


def _x0s(B):
    rng = np.random.default_rng(0)
    return rng.uniform(-0.5, 0.5, (B, 2)).astype(np.float32)


def test_mesh_creation():
    mesh = make_mesh(8, devices=CPU8)
    assert mesh.devices.size == 8 and mesh.axis_names == ("scenario",)
    assert mesh.shape == {"scenario": 8}
    assert make_mesh(devices=["cpu"] * 3).devices.size == 3
    assert make_mesh(2, axis_name="data", devices=CPU8).shape == {"data": 2}
    with pytest.raises(ValueError, match="devices"):
        make_mesh(4, devices=["cpu"] * 2)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError):    # the default: CUDA devices
            make_mesh()


def test_shard_leading_places_shards():
    """Shard i is the i-th slice of the batch, on device i ("meta" stands
    for a second device here); ``replicate`` puts one copy a device."""
    mesh = make_mesh(devices=["cpu", "meta", "cpu", "meta"])
    x = torch.arange(16.0).reshape(8, 2)
    tree = {"x": x, "s": torch.tensor(3.0), "n": None, "k": 5}
    parts = shard_leading(tree, mesh)
    assert [p["x"].device.type for p in parts] == ["cpu", "meta"] * 2
    assert all(p["x"].shape == (2, 2) and p["n"] is None and p["k"] == 5
               for p in parts)
    assert torch.equal(parts[2]["x"], x[4:6])
    assert parts[1]["s"].device.type == "meta" and parts[0]["s"] == 3.0
    copies = replicate([x], mesh)
    assert [c[0].device.type for c in copies] == ["cpu", "meta"] * 2
    with pytest.raises(ValueError, match="divisible"):
        shard_leading(torch.zeros(6, 2), mesh)


def test_sharded_matches_unsharded_and_jax(problem):
    tmpc, params, jmpc, jparams = problem
    x0s = _x0s(16)
    smpc = ShardedNMPC(tmpc, make_mesh(8, devices=CPU8))
    _, sharded = smpc.next_batch(torch.as_tensor(x0s), params=params)
    _, plain = tmpc.next_batch(torch.as_tensor(x0s), params=params)
    _, jres = JShardedNMPC(jmpc, j_make_mesh(8)).next_batch(
        jnp.asarray(x0s), params=jparams)
    assert isinstance(sharded, Sharded) and len(sharded.shards) == 8
    assert all(s.u.shape == (2, 6, 1) for s in sharded.shards)
    assert torch.equal(sharded.converged, plain.converged)
    assert float((sharded.u - plain.u).abs().max()) <= SHARDED_DU
    np.testing.assert_array_equal(sharded.converged.numpy(),
                                  np.asarray(jres.converged))
    assert np.abs(sharded.u.numpy() - np.asarray(jres.u)).max() <= JAX_DU
    whole = sharded.gather()
    assert isinstance(whole, T.NMPCResult) and whole.u.shape == (16, 6, 1)


def test_sharded_receding_horizon_carry(problem):
    tmpc, params, _, _ = problem
    x0s = torch.as_tensor(_x0s(16))
    smpc = ShardedNMPC(tmpc, make_mesh(8, devices=CPU8))
    carry, res1 = smpc.next_batch(x0s, params=params)
    assert isinstance(carry, Sharded) and len(carry.shards) == 8
    carry, res2 = smpc.next_batch(x0s, params=params, carry=carry)
    assert int(res2.converged.sum()) == 16
    # a warm-started second solve is no slower than the cold one
    assert int(res2.iterations.max()) <= int(res1.iterations.max())
    # a whole (unsharded) carry is sharded on the way in
    _, res3 = smpc.next_batch(x0s, params=params, carry=carry.gather())
    assert torch.equal(res3.u, smpc.next_batch(x0s, params=params,
                                               carry=carry)[1].u)


def test_indivisible_batch_rejected(problem):
    tmpc, params, _, _ = problem
    for independent in (True, False):
        smpc = ShardedNMPC(tmpc, make_mesh(8, devices=CPU8),
                           independent=independent)
        with pytest.raises(ValueError, match="divisible"):
            smpc.next_batch(torch.as_tensor(_x0s(12)), params=params)


def test_independent_false_is_the_unsharded_solve(problem):
    """One global convergence frontier: one ``next_batch`` over the whole
    batch, the unsharded results exactly, warm carry included."""
    tmpc, params, _, _ = problem
    x0s = torch.as_tensor(_x0s(16))
    smpc = ShardedNMPC(tmpc, make_mesh(8, devices=CPU8), independent=False)
    carry, res = smpc.next_batch(x0s, params=params)
    pc, plain = tmpc.next_batch(x0s, params=params)
    assert torch.equal(res.u, plain.u)
    assert torch.equal(res.iterations, plain.iterations)
    _, warm = smpc.next_batch(x0s, params=params, carry=carry)
    assert torch.equal(warm.u, tmpc.next_batch(x0s, params=params,
                                               carry=pc)[1].u)
