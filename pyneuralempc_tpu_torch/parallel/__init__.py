"""Distribution: scenario and horizon sharding over a grid of devices.

PyTorch counterpart of ``pyneuralempc_tpu/parallel``: scenario sharding
with no communication in the solve (:class:`ShardedNMPC`), and the
sequence-parallel (horizon) Riccati sweep, whose shards exchange one
element each a solve (:func:`horizon_sweep`).  Both run in one process over
a :class:`Mesh` of ``torch.device``s.
"""

from .sharding import (Mesh, Sharded, ShardedNMPC, make_mesh, replicate,
                       shard_leading)
from .horizon import horizon_sweep, make_horizon_mesh, make_sharded_sweep

__all__ = [
    "Mesh", "Sharded", "ShardedNMPC", "make_mesh", "replicate",
    "shard_leading", "horizon_sweep", "make_horizon_mesh",
    "make_sharded_sweep",
]
