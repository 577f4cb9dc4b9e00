"""Scenario sharding over a grid of devices.

PyTorch counterpart of ``pyneuralempc_tpu/parallel/sharding.py``.  The
JAX package lays a batch of MPC problems along the ``scenario`` axis of a
``jax.sharding.Mesh`` in one process.  The port does the same in one
process over a :class:`Mesh` of its own: a grid of ``torch.device``s with
named axes.  A shard is a slice of the batch that lives, and is solved, on
its own device.  Because the batched solver has no cross-problem coupling,
the shards need no communication at all.

A mesh may name one device more than once.  That is how one card (or the
CPU) runs several shards, as the JAX tests run on a virtual 8-device CPU
mesh.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import numpy as np
import torch

__all__ = ["Mesh", "Sharded", "ShardedNMPC", "make_mesh", "replicate",
           "shard_leading"]


class Mesh:
    """A grid of ``torch.device``s with named axes: ``devices`` a numpy
    object array, ``axis_names`` a tuple, ``shape`` a dict (axis name ->
    size), as ``jax.sharding.Mesh``'s."""

    def __init__(self, devices, axis_names: Sequence[str]):
        devices = np.asarray(devices, dtype=object)
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-D device grid for axes "
                             f"{tuple(axis_names)}")
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def along(self, axis_name: str) -> list:
        """One device for each index of ``axis_name`` (the first along the
        other axes)."""
        ax = self.axis_names.index(axis_name)
        grid = np.moveaxis(self.devices, ax, 0)
        return list(grid.reshape(grid.shape[0], -1)[:, 0])


def mesh_devices(n: Optional[int], devices=None) -> list:
    """``devices`` (the CUDA devices when None), the first ``n`` of them;
    raises when there are fewer, as ``jax.devices()[:n]`` would leave the
    mesh short."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if n is not None:
        if len(devices) < n:
            raise ValueError(f"{n} devices asked for, {len(devices)} "
                             "available")
        devices = devices[:n]
    if not devices:
        raise ValueError("no devices for the mesh")
    return devices


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "scenario",
              devices=None) -> Mesh:
    """1-D mesh over the scenario axis: the first ``n_devices`` of
    ``devices`` (all the CUDA devices when None; a list may repeat a
    device)."""
    return Mesh(mesh_devices(n_devices, devices), (axis_name,))


def _tree_map(fn, tree):
    """``fn`` on every tensor of a tree of dicts, lists, tuples and named
    tuples; anything else passes as it is."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[_tree_map(fn, v) for v in tree])
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return tree


def shard_leading(tree: Any, mesh: Mesh, axis_name: str = "scenario"
                  ) -> list:
    """One tree a shard of ``axis_name``: every tensor's leading (batch)
    axis split into equal parts, part i on shard i's device; 0-d tensors
    copied to each device, anything else (None, scalars) passed."""
    devices = mesh.along(axis_name)
    n = len(devices)

    def part(i):
        def cut(x):
            if x.dim() == 0:
                return x.to(devices[i])
            if x.shape[0] % n:
                raise ValueError(f"leading axis {x.shape[0]} not divisible "
                                 f"by the {n} shards of {axis_name!r}")
            m = x.shape[0] // n
            return x[i * m:(i + 1) * m].to(devices[i])
        return _tree_map(cut, tree)

    return [part(i) for i in range(n)]


def replicate(tree: Any, mesh: Mesh) -> list:
    """One copy of ``tree`` a device of the mesh (in ``mesh.devices``'
    order)."""
    return [_tree_map(lambda x, d=d: x.to(d), tree)
            for d in mesh.devices.flat]


def _gather(values, device):
    """The shards' values of one field concatenated along the batch axis on
    ``device``; None stays None, dicts (a record trace) gather by key."""
    first = values[0]
    if isinstance(first, torch.Tensor):
        return torch.cat([v.to(device) for v in values])
    if isinstance(first, dict):
        return {k: _gather([v[k] for v in values], device) for k in first}
    return first


class Sharded:
    """A batched result (an ``NMPCResult`` or a ``WarmStart``) kept as one
    part a shard, each on its shard's device (``shards``).  A field read as
    an attribute is the whole batch's, gathered on the first shard's device
    (as a sharded JAX array reads whole); :meth:`gather` gives every
    field so."""

    def __init__(self, shards):
        self.shards = tuple(shards)

    def __getattr__(self, name):
        if name.startswith("__") or name == "shards":
            raise AttributeError(name)
        values = [getattr(s, name) for s in self.shards]
        return _gather(values, _device_of(self.shards[0]))

    def gather(self):
        first = self.shards[0]
        return type(first)(*[getattr(self, f) for f in first._fields])


def _device_of(tree):
    found = []
    _tree_map(lambda x: found.append(x.device), tree)
    return found[0] if found else torch.device("cpu")


class ShardedNMPC:
    """Scenario-sharded batched MPC stepping over a device mesh.

    Wraps an :class:`~pyneuralempc_tpu_torch.api.controller.NMPC`: the same
    ``next_batch``, with the batch split over the mesh's ``axis_name`` so
    that B problems run B/n a device.  Model parameters and shared p/tvp
    are replicated.

    * ``independent=True`` (default): each shard's ``next_batch`` runs on
      its own device with its own convergence frontier, so a shard whose
      members all converge in 3 iterations is done in 3, whatever a
      straggler on another shard needs (the JAX package's shard_map mode).
      One controller is built a distinct device, with the wrapped one's
      spec; a mesh that repeats a device solves its shards there one
      after another.  Results come back :class:`Sharded`: each shard's
      tensors on its device, a field read as an attribute gathered whole.
      Pass the returned carry back in for receding-horizon use.
    * ``independent=False``: one global convergence frontier, one
      ``next_batch`` over the whole batch on the wrapped controller's
      device: the unsharded program's results.

    Shards run one after another; running shards on distinct cards at
    once is not done yet.

    Usage::

        mesh = make_mesh()                      # all CUDA devices
        smpc = ShardedNMPC(mpc, mesh)
        carry, res = smpc.next_batch(x0s)       # x0s: (B, x_dim), B % n == 0
    """

    def __init__(self, mpc, mesh: Mesh, axis_name: str = "scenario",
                 independent: bool = True):
        self.mpc = mpc
        self.mesh = mesh
        self.axis_name = axis_name
        self.independent = independent
        self.devices = mesh.along(axis_name)
        self._controllers = {mpc.device: mpc}
        if independent:
            for d in self.devices:
                if d not in self._controllers:
                    self._controllers[d] = mpc.replica(d)

    def next_batch(self, x0s, p=None, tvp=None, params=None, carry=None):
        n = len(self.devices)
        B = torch.as_tensor(x0s).shape[0]
        if B % n != 0:
            raise ValueError(f"batch {B} not divisible by mesh size {n}")
        if not self.independent:
            if isinstance(carry, Sharded):
                carry = carry.gather()
            return self.mpc.next_batch(x0s, p=p, tvp=tvp, params=params,
                                       carry=carry)
        xs = shard_leading(torch.as_tensor(x0s), self.mesh, self.axis_name)
        if carry is None:
            carries = [None] * n
        elif isinstance(carry, Sharded):
            carries = [_tree_map(lambda x, d=d: x.to(d), c)
                       for c, d in zip(carry.shards, self.devices)]
        else:
            carries = shard_leading(carry, self.mesh, self.axis_name)
        shared = {d: _tree_map(lambda x, d=d: x.to(d),
                               {"p": p, "tvp": tvp, "params": params})
                  for d in set(self.devices)}
        out = [self._controllers[d].next_batch(x, carry=c, **shared[d])
               for d, x, c in zip(self.devices, xs, carries)]
        return Sharded(o[0] for o in out), Sharded(o[1] for o in out)
