"""Dynamics model contract.

PyTorch counterpart of ``pyneuralempc_tpu/models/base.py``.  A model is a
step function batched over time,

    f(x: (T, x_dim), u: (T, u_dim), p: (p_dim,)|None, tvp: (T, tvp_dim)|None,
      params) -> (T, x_dim)

whose output the integrator reads as a state delta, a state derivative or
the next state.  Rows are independent stages.  ``params`` carries NN weights
as explicit data, so ``torch.func`` differentiates with respect to the
inputs while the weights stay fixed.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from ..core.problem import Dims


@dataclasses.dataclass(frozen=True)
class DynamicsModel:
    """A dynamics model: dims metadata + a pure step function.

    ``fn(x, u, p, tvp, params) -> (T, x_dim)``; ``p``/``tvp``/``params`` may
    be None when the corresponding dim is zero / the model has no weights.
    """

    fn: Callable
    dims: Dims
    name: str = "dynamics"

    @property
    def x_dim(self) -> int:
        return self.dims.x

    @property
    def u_dim(self) -> int:
        return self.dims.u

    @property
    def p_dim(self) -> int:
        return self.dims.p

    @property
    def tvp_dim(self) -> int:
        return self.dims.tvp

    def __call__(self, x, u, p=None, tvp=None, params=None):
        return self.fn(x, u, p, tvp, params)

    def init_params(self, generator, device="cuda") -> Any:
        """Models with learnable parameters override this."""
        return None


def torch_dynamics(fn: Callable, x_dim: int, u_dim: int, p_dim: int = 0,
                   tvp_dim: int = 0, safe_mode: bool = False,
                   name: str = "torch_fn") -> DynamicsModel:
    """Wrap a user function ``f(x, u, p=None, tvp=None) -> (T, x_dim)``
    written with torch operations (the counterpart of ``jax_dynamics``).

    ``safe_mode`` probes the function at zeros and fails fast if it returns
    the wrong shape or a non-finite Jacobian.
    """

    def wrapped(x, u, p, tvp, params):
        del params
        return _call_user_fn(fn, x, u, p, tvp)

    model = DynamicsModel(fn=wrapped, dims=Dims(x_dim, u_dim, p_dim,
                                                tvp_dim), name=name)

    if safe_mode:
        T = 2
        x = torch.zeros((T, x_dim))
        u = torch.zeros((T, u_dim))
        p = torch.zeros((p_dim,)) if p_dim else None
        tvp = torch.zeros((T, tvp_dim)) if tvp_dim else None
        try:
            out = model(x, u, p, tvp)
        except Exception as e:
            raise ValueError(f"model function failed on zero probe: {e}")
        if tuple(out.shape) != (T, x_dim):
            raise ValueError(f"model function returned shape "
                             f"{tuple(out.shape)}, expected {(T, x_dim)}")
        jac = torch.func.jacrev(lambda xx: model(xx, u, p, tvp))(x)
        if not bool(torch.all(torch.isfinite(jac))):
            raise ValueError("model function is not differentiable at zeros "
                             "(non-finite jacobian)")
    return model


def _call_user_fn(fn, x, u, p, tvp):
    """Call a reference-style user function with only the args it needs."""
    if p is None and tvp is None:
        return fn(x, u)
    if tvp is None:
        return fn(x, u, p)
    return fn(x, u, p, tvp)
