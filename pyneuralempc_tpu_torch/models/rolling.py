"""Rolling-window (history-dependent) dynamics via lifted state.

PyTorch counterpart of ``pyneuralempc_tpu/models/rolling.py``.  A network
that reads a sliding window of the last W states (plus the current control)
becomes a first-order model by lifting the window into the state vector,
z_t = [x_t, x_{t-1}, …, x_{t-W+1}], with the transition

    z_{t+1} = [ step(g(z_t, u_t)),  z_t[:(W-1)·nx] ]     (a shift register)

so the problem stays a plain first-order MPC over z: stage-local defect
sparsity is preserved, the Riccati backend works unchanged, and
``torch.func`` gives every derivative.  ``lift`` stacks the measured
history into z₀.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch

from ..core.problem import Box, Dims
from .base import DynamicsModel, _call_user_fn
from .mlp import mlp_apply, mlp_init


@dataclasses.dataclass(frozen=True)
class RollingWindow:
    """Lifted rolling-window model bundle.

    ``inner_fn(feats, u, p, tvp, params) -> (T, x_dim)`` reads the window
    features ``feats: (T, W·x_dim)``, newest first (x_t first), and the
    current control, and returns the head update read per ``mode``:
    "delta" (x_{t+1} = x_t + out) or "next" (x_{t+1} = out).

    Use ``.model`` (with integrator="direct") in the controller; ``.lift``
    builds z₀ from measured history; ``.head`` takes the physical
    trajectory out of a lifted plan; ``.box`` tiles physical bounds over
    the window copies.
    """

    model: DynamicsModel
    window: int
    x_dim: int
    u_dim: int
    mode: str

    def lift(self, x_hist):
        """z₀ from history ``x_hist: (W, x_dim)``, oldest row first (the
        natural log order); z packs newest first."""
        x_hist = torch.as_tensor(x_hist, dtype=torch.float32)
        if tuple(x_hist.shape) != (self.window, self.x_dim):
            raise ValueError(
                f"history must be shape {(self.window, self.x_dim)}, "
                f"got {tuple(x_hist.shape)}")
        return torch.flip(x_hist, dims=(0,)).reshape(-1)

    def head(self, Z):
        """Physical states from a lifted trajectory (…, W·x_dim)."""
        return Z[..., : self.x_dim]

    def box(self, states_constraint: Sequence[Sequence[float]],
            control_constraint: Sequence[Sequence[float]]) -> Box:
        """Physical per-dim bounds tiled across the W window copies."""
        return Box.make(list(states_constraint) * self.window,
                        control_constraint)

    def head_objective(self, fn: Callable) -> Callable:
        """Wrap a physical-coordinates cost J(x, u, p, tvp) to accept the
        lifted trajectory."""
        def wrapped(Z, u, p=None, tvp=None):
            return _call_user_fn(fn, self.head(Z), u, p, tvp)
        return wrapped


def rolling_window(inner_fn: Callable, x_dim: int, u_dim: int, window: int,
                   mode: str = "delta", p_dim: int = 0, tvp_dim: int = 0,
                   name: str = "rolling") -> RollingWindow:
    """Build a lifted rolling-window model from a window-features step
    function ``inner_fn(feats, u, p, tvp, params)`` (feats (T, W·x_dim),
    newest first); see :class:`RollingWindow`."""
    if window < 1:
        raise ValueError("window must be >= 1")
    if mode not in ("delta", "next"):
        raise ValueError(f"mode must be 'delta' or 'next', got {mode!r}")
    nx = x_dim
    nz = window * nx

    def lifted_fn(z, u, p, tvp, params):
        head = z[:, :nx]
        out = inner_fn(z, u, p, tvp, params)
        new_head = head + out if mode == "delta" else out
        if window == 1:
            return new_head
        return torch.cat([new_head, z[:, : (window - 1) * nx]], dim=1)

    lifted = DynamicsModel(fn=lifted_fn, dims=Dims(nz, u_dim, p_dim, tvp_dim),
                           name=name)
    return RollingWindow(model=lifted, window=window, x_dim=x_dim,
                         u_dim=u_dim, mode=mode)


def rolling_mlp(x_dim: int, u_dim: int, window: int, hidden: Sequence[int],
                mode: str = "delta", p_dim: int = 0, tvp_dim: int = 0,
                activation: str = "tanh"):
    """Rolling-window MLP: window features + control -> head update.

    Returns ``(RollingWindow, init_params)``, ``init_params(generator,
    device="cuda")``; the MLP's input layout is [z (W·x_dim, newest first)
    | u | tvp | p].
    """
    sizes_hidden = tuple(int(h) for h in hidden)
    activations = tuple([activation] * len(sizes_hidden) + ["linear"])
    in_dim = window * x_dim + u_dim + tvp_dim + p_dim

    def inner_fn(z, u, p, tvp, params):
        feats = [z, u]
        if tvp is not None and tvp_dim:
            feats.append(tvp)
        if p is not None and p_dim:
            feats.append(p.expand(z.shape[0], p_dim))
        return mlp_apply(params, torch.cat(feats, dim=-1), activations)

    def init_params(generator: torch.Generator, device="cuda"):
        return mlp_init(generator, (in_dim,) + sizes_hidden + (x_dim,),
                        device=device)

    rw = rolling_window(inner_fn, x_dim, u_dim, window, mode=mode,
                        p_dim=p_dim, tvp_dim=tvp_dim, name="rolling_mlp")
    return rw, init_params
