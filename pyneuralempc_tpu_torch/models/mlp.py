"""Feed-forward NN dynamics (the "neural" in neural EMPC).

PyTorch counterpart of ``pyneuralempc_tpu/models/mlp.py``: an MLP over the
concatenated ``[x, u, tvp, p]`` features whose weights are an explicit list
of ``{"w": (in, out), "b": (out,)}`` tensors threaded through the solver as
runtime data.  All H stages run as one batched matmul chain.

Compute dtype: weights are stored in float32; ``compute_dtype=torch.bfloat16``
runs each layer's matmul in bf16 (its input and weights rounded to bf16) and
hands float32 on to the activation and the next layer; the solver's own
linear algebra stays float32 regardless.
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
    # jax.nn.gelu's default, the tanh approximation (torch's default, the
    # exact erf form, differs by up to 4.7e-4)
    "gelu": lambda x: torch.nn.functional.gelu(x, approximate="tanh"),
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


def mlp_apply(params, feats, activations: Tuple[str, ...],
              compute_dtype=torch.float32):
    """Apply the MLP to (T, in_dim) features as one batched matmul chain,
    each matmul in ``compute_dtype`` with a float32 result."""
    if compute_dtype == torch.float32:
        h = feats
        for layer, act in zip(params, activations):
            h = _ACTIVATIONS[act](h @ layer["w"] + layer["b"])
        return h
    h = feats.to(torch.float32)
    for layer, act in zip(params, activations):
        z = torch.matmul(h.to(compute_dtype), layer["w"].to(compute_dtype))
        b = layer["b"].to(compute_dtype).to(torch.float32)
        h = _ACTIVATIONS[act](z.to(torch.float32) + b)
    return h.to(feats.dtype)


@dataclasses.dataclass(frozen=True)
class MLPDynamics(DynamicsModel):
    """MLP over concatenated ``[x, u, tvp, p]`` features.

    ``hidden``: hidden layer widths; ``activation`` applies to all hidden
    layers, the output layer is linear; ``compute_dtype`` is the matmuls'
    dtype (see the module docstring).
    """

    hidden: Tuple[int, ...] = ()
    activation: str = "tanh"
    compute_dtype: torch.dtype = torch.float32

    @staticmethod
    def make(x_dim: int, u_dim: int, hidden: Sequence[int],
             p_dim: int = 0, tvp_dim: int = 0, activation: str = "tanh",
             compute_dtype: torch.dtype = torch.float32,
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
            return mlp_apply(params, torch.cat(feats, dim=-1), activations,
                             compute_dtype)

        return MLPDynamics(fn=fn, dims=dims, name=name, hidden=hidden,
                           activation=activation, compute_dtype=compute_dtype)

    @property
    def layer_sizes(self) -> Tuple[int, ...]:
        in_dim = self.dims.x + self.dims.u + self.dims.tvp + self.dims.p
        return (in_dim,) + self.hidden + (self.dims.x,)

    def init_params(self, generator, device="cuda"):
        return mlp_init(generator, self.layer_sizes, device=device)
