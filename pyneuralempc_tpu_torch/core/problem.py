"""Problem IR: the static description of one economic-MPC problem.

PyTorch counterpart of ``pyneuralempc_tpu/core/problem.py``.  The spec only
records shapes and callables; the transcription layer
(:mod:`pyneuralempc_tpu_torch.core.transcription`) produces pure functions of
the flat decision vector, and every derivative is taken by ``torch.func`` at
solve time.  All *runtime* data (initial state, parameters, time-varying
parameters, NN weights) lives in the plain dict built by :func:`runtime`.

This slice covers box bounds and stage-separable costs.  General path and
stage constraints (``PathConstraint`` / ``StageConstraint``) are not ported
yet (ROADMAP Queue 1 #9); the controller raises ``NotImplementedError`` when
it is given one.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Dims:
    """Dimension metadata: state, control, parameter and time-varying
    parameter widths."""

    x: int
    u: int
    p: int = 0
    tvp: int = 0

    @property
    def stage(self) -> int:
        """Decision variables per stage (state + control)."""
        return self.x + self.u


def runtime(x0, p=None, tvp=None, params=None) -> dict:
    """Plain dict of runtime inputs for one solve (or a batch of solves,
    when ``x0`` carries a leading batch axis).

    Keys:
      - ``x0``:     (x_dim,) or (B, x_dim) initial state(s).
      - ``p``:      (p_dim,) constant parameters, or None.
      - ``tvp``:    (H, tvp_dim) time-varying parameters, or None.
      - ``params``: model parameters (NN weights), or None.
    """
    return {
        "x0": torch.as_tensor(x0),
        "p": None if p is None else torch.as_tensor(p),
        "tvp": None if tvp is None else torch.as_tensor(tvp),
        "params": params,
    }


@dataclasses.dataclass(frozen=True)
class Box:
    """Per-dimension box bounds (the reference ``DomainConstraint``).

    Bounds are tuples of floats so the spec stays hashable; ±inf means
    unbounded.  ``tile(H)`` gives the flat bound vectors in the canonical
    ``[x_0..x_{H-1} | u_0..u_{H-1}]`` layout.
    """

    x_lb: Tuple[float, ...]
    x_ub: Tuple[float, ...]
    u_lb: Tuple[float, ...]
    u_ub: Tuple[float, ...]

    @staticmethod
    def make(states_constraint: Sequence[Sequence[float]],
             control_constraint: Sequence[Sequence[float]]) -> "Box":
        """Build from the reference-style list-of-(lb, ub) pairs."""
        for name, c in (("states", states_constraint),
                        ("control", control_constraint)):
            if len(c) == 0:
                raise ValueError(f"{name} constraint list is empty")
            if any(len(e) != 2 for e in c):
                raise ValueError(
                    f"{name} constraints must be (lower, upper) pairs")
            if any(e[0] > e[1] for e in c):
                raise ValueError(f"{name} constraint has lower > upper")
        return Box(
            x_lb=tuple(float(e[0]) for e in states_constraint),
            x_ub=tuple(float(e[1]) for e in states_constraint),
            u_lb=tuple(float(e[0]) for e in control_constraint),
            u_ub=tuple(float(e[1]) for e in control_constraint),
        )

    @staticmethod
    def unbounded(x_dim: int, u_dim: int) -> "Box":
        inf = float("inf")
        return Box(x_lb=(-inf,) * x_dim, x_ub=(inf,) * x_dim,
                   u_lb=(-inf,) * u_dim, u_ub=(inf,) * u_dim)

    def tile(self, H: int, dtype=torch.float32, device="cuda"):
        """Flat (lb, ub) over the [X | U] decision block."""
        lb = np.concatenate([np.tile(self.x_lb, H), np.tile(self.u_lb, H)])
        ub = np.concatenate([np.tile(self.x_ub, H), np.tile(self.u_ub, H)])
        return (torch.as_tensor(lb, dtype=dtype, device=device),
                torch.as_tensor(ub, dtype=dtype, device=device))


@dataclasses.dataclass(frozen=True)
class StageCost:
    """A stage-separable economic cost: J = Σ_t ℓ(x_{t+1}, u_t, p, tvp_t)
    (+ optional terminal φ(x_H, p)).

    ``stage(x, u, p, tvp) -> scalar`` takes single-stage vectors
    ``x: (x_dim,)``, ``u: (u_dim,)``.  Instances are callable with full
    trajectories (batched-over-time contract), so they drop into any
    objective slot.
    """

    stage: Callable
    terminal: Optional[Callable] = None

    def __call__(self, x, u, p=None, tvp=None):
        from ..models.base import _call_user_fn

        if tvp is None:
            per = torch.func.vmap(
                lambda x_t, u_t: _call_user_fn(self.stage, x_t, u_t, p,
                                               None))(x, u)
        else:
            per = torch.func.vmap(
                lambda x_t, u_t, tvp_t: _call_user_fn(self.stage, x_t, u_t,
                                                      p, tvp_t))(x, u, tvp)
        total = torch.sum(per)
        if self.terminal is not None:
            total = total + (self.terminal(x[-1], p) if p is not None
                             else self.terminal(x[-1]))
        return total


@dataclasses.dataclass(frozen=True)
class MPCSpec:
    """The full static problem description: model + integrator, objective,
    box bounds, horizon and step size."""

    model: Any                       # DynamicsModel
    integrator: str                  # "delta" | "euler" | "rk4" | "direct"
    objective: Callable              # J(x:(H,nx), u:(H,nu), p, tvp) -> scalar
    box: Box
    H: int
    DT: float

    def __post_init__(self):
        from ..ops.integrators import INTEGRATORS
        if self.integrator not in INTEGRATORS:
            raise ValueError(
                f"unknown integrator {self.integrator!r}; "
                f"available: {sorted(INTEGRATORS)}")
        if self.H < 1:
            raise ValueError("horizon H must be >= 1")

    @property
    def dims(self) -> Dims:
        return self.model.dims

    @property
    def n_primal(self) -> int:
        """Number of X/U decision variables: H * (x_dim + u_dim)."""
        return self.H * self.dims.stage

    @property
    def n_defect(self) -> int:
        return self.H * self.dims.x
