"""Feed-forward NN dynamics (the "neural" in neural EMPC).

PyTorch counterpart of ``pyneuralempc_tpu/models/mlp.py``: an MLP over the
concatenated ``[x, u, tvp, p]`` features whose weights are an explicit list
of ``{"w": (in, out), "b": (out,)}`` tensors threaded through the solver as
runtime data.  All H stages run as one batched matmul chain.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Tuple

import torch

from ..core.problem import Dims
from .base import DynamicsModel

_ACTIVATIONS = {
    "tanh": torch.tanh,
    "relu": torch.relu,
    "gelu": torch.nn.functional.gelu,
    "swish": torch.nn.functional.silu,
    "sigmoid": torch.sigmoid,
    "linear": lambda x: x,
}


def mlp_init(generator: torch.Generator, sizes: Sequence[int],
             dtype=torch.float32, device="cuda"):
    """Glorot-uniform init (Keras Dense defaults), drawn from ``generator``
    on its own device and then moved to ``device``."""
    params = []
    for fan_in, fan_out in zip(sizes[:-1], sizes[1:]):
        limit = math.sqrt(6.0 / (fan_in + fan_out))
        W = torch.rand((fan_in, fan_out), generator=generator, dtype=dtype,
                       device=generator.device) * (2.0 * limit) - limit
        params.append({"w": W.to(device),
                       "b": torch.zeros((fan_out,), dtype=dtype,
                                        device=device)})
    return params


def mlp_apply(params, feats, activations: Tuple[str, ...]):
    """Apply the MLP to (T, in_dim) features as one batched matmul chain."""
    h = feats
    for layer, act in zip(params, activations):
        h = _ACTIVATIONS[act](h @ layer["w"] + layer["b"])
    return h


@dataclasses.dataclass(frozen=True)
class MLPDynamics(DynamicsModel):
    """MLP over concatenated ``[x, u, tvp, p]`` features.

    ``hidden``: hidden layer widths; ``activation`` applies to all hidden
    layers, the output layer is linear.
    """

    hidden: Tuple[int, ...] = ()
    activation: str = "tanh"

    @staticmethod
    def make(x_dim: int, u_dim: int, hidden: Sequence[int],
             p_dim: int = 0, tvp_dim: int = 0, activation: str = "tanh",
             name: str = "mlp") -> "MLPDynamics":
        dims = Dims(x_dim, u_dim, p_dim, tvp_dim)
        hidden = tuple(int(h) for h in hidden)
        activations = tuple([activation] * len(hidden) + ["linear"])

        def fn(x, u, p, tvp, params):
            feats = [x, u]
            if tvp is not None and dims.tvp:
                feats.append(tvp)
            if p is not None and dims.p:
                feats.append(p.expand(x.shape[0], dims.p))
            return mlp_apply(params, torch.cat(feats, dim=-1), activations)

        return MLPDynamics(fn=fn, dims=dims, name=name, hidden=hidden,
                           activation=activation)

    @property
    def layer_sizes(self) -> Tuple[int, ...]:
        in_dim = self.dims.x + self.dims.u + self.dims.tvp + self.dims.p
        return (in_dim,) + self.hidden + (self.dims.x,)

    def init_params(self, generator, device="cuda"):
        return mlp_init(generator, self.layer_sizes, device=device)
