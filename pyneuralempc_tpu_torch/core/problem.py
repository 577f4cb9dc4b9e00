"""Problem IR: the static description of one economic-MPC problem.

PyTorch counterpart of ``pyneuralempc_tpu/core/problem.py``.  The spec only
records shapes and callables; the transcription layer
(:mod:`pyneuralempc_tpu_torch.core.transcription`) produces pure functions of
the flat decision vector, and every derivative is taken by ``torch.func`` at
solve time.  All *runtime* data (initial state, parameters, time-varying
parameters, NN weights) lives in the plain dict built by :func:`runtime`.

Constraints: box bounds (:class:`Box`), stage-wise path constraints
(:class:`StageConstraint`, rows at every stage) and trajectory-level ones
(:class:`PathConstraint`).  Equality rows of either stay equalities; the
other rows are lifted with bounded slack variables by the transcription.
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


# Path constraint row classification (the reference's EQ/INEQ/INTER types).
EQ_TYPE = 0
INEQ_TYPE = 1
INTER_TYPE = 2


def _row_types(lb, ub) -> np.ndarray:
    """EQ where lb == ub, INEQ where (0, inf), INTER otherwise."""
    lb = np.asarray(lb)
    ub = np.asarray(ub)
    types = np.full(len(lb), INTER_TYPE)
    types[np.isclose(lb, ub)] = EQ_TYPE
    types[(lb == 0.0) & np.isinf(ub)] = INEQ_TYPE
    return types


@dataclasses.dataclass(frozen=True)
class PathConstraint:
    """A trajectory-level constraint ``lb <= g(x, u, p, tvp) <= ub``.

    ``fn(x:(H,x_dim), u:(H,u_dim), p, tvp) -> (dim,)``, the dynamics
    model's batched-in-time signature.  EQ rows (lb == ub) are handled as
    ``g - lb = 0``; the other rows get a slack ``s`` bounded by (lb, ub) and
    the equality ``g - s = 0``.  ``lb``/``ub`` are float tuples so the spec
    stays hashable.
    """

    fn: Callable
    dim: int
    lb: Tuple[float, ...]
    ub: Tuple[float, ...]

    def __post_init__(self):
        if len(self.lb) != self.dim or len(self.ub) != self.dim:
            raise ValueError("PathConstraint bounds must have length == dim")
        if any(l > u for l, u in zip(self.lb, self.ub)):
            raise ValueError("PathConstraint has lower > upper bound")

    def row_types(self) -> np.ndarray:
        return _row_types(self.lb, self.ub)

    def get_type(self) -> int:
        """Whole-constraint classification."""
        t = self.row_types()
        if (t == EQ_TYPE).all():
            return EQ_TYPE
        if (t == INEQ_TYPE).all():
            return INEQ_TYPE
        return INTER_TYPE


@dataclasses.dataclass(frozen=True)
class StageConstraint:
    """A stage-wise path constraint ``lb <= g(x_{t+1}, u_t, p, tvp_t) <= ub``
    at every stage t (H·dim rows in all).

    ``stage(x:(x_dim,), u:(u_dim,), p, tvp_t) -> (dim,)``, the signature of
    :class:`StageCost.stage` (x is the stage's post-step state).  Declaring
    the stage structure keeps the O(H) Riccati backend eligible: slack rows
    fold into the per-stage Hessian blocks and EQ rows ride the stage QP of
    the general sweep.  Instances are callable with full trajectories and
    return (H, dim).
    """

    stage: Callable
    dim: int
    lb: Tuple[float, ...]
    ub: Tuple[float, ...]

    def __post_init__(self):
        if len(self.lb) != self.dim or len(self.ub) != self.dim:
            raise ValueError("StageConstraint bounds must have length == dim")
        if any(l > u for l, u in zip(self.lb, self.ub)):
            raise ValueError("StageConstraint has lower > upper bound")

    def row_types(self) -> np.ndarray:
        """Per-stage-row classification (the PathConstraint rules)."""
        return _row_types(self.lb, self.ub)

    def __call__(self, x, u, p=None, tvp=None):
        from ..models.base import _call_user_fn

        def one(x_t, u_t, tvp_t):
            return torch.atleast_1d(_call_user_fn(self.stage, x_t, u_t, p,
                                                  tvp_t))

        if tvp is None:
            return torch.func.vmap(lambda x_t, u_t: one(x_t, u_t, None))(x, u)
        return torch.func.vmap(one)(x, u, tvp)


def _bounds(v, dim):
    return tuple(float(b) for b in
                 np.broadcast_to(np.asarray(v, float), (dim,)))


def stage_inequality(fn: Callable, dim: int = 1) -> StageConstraint:
    """g(x_t, u_t) >= 0 at every stage."""
    return StageConstraint(stage=fn, dim=dim, lb=(0.0,) * dim,
                           ub=(float("inf"),) * dim)


def stage_interval(fn: Callable, dim: int, lb, ub) -> StageConstraint:
    return StageConstraint(stage=fn, dim=dim, lb=_bounds(lb, dim),
                           ub=_bounds(ub, dim))


def equality_constraint(fn: Callable, dim: int) -> PathConstraint:
    """g(x, u, p, tvp) = 0."""
    return PathConstraint(fn=fn, dim=dim, lb=(0.0,) * dim, ub=(0.0,) * dim)


def inequality_constraint(fn: Callable, dim: int) -> PathConstraint:
    """g(x, u, p, tvp) >= 0."""
    return PathConstraint(fn=fn, dim=dim, lb=(0.0,) * dim,
                          ub=(float("inf"),) * dim)


def interval_constraint(fn: Callable, dim: int, lb, ub) -> PathConstraint:
    return PathConstraint(fn=fn, dim=dim, lb=_bounds(lb, dim),
                          ub=_bounds(ub, dim))


def expand_constraint(pc, H: int):
    """Normalise a Path/Stage constraint to trajectory-level rows.

    Returns ``(traj_fn, n_rows, row_types, lb, ub)`` where
    ``traj_fn(X, U, p, tvp) -> (n_rows,)`` and the bound/type arrays have
    length ``n_rows`` (a StageConstraint's per-stage rows tile ×H in
    stage-major order: rows [t·dim, (t+1)·dim) belong to stage t)."""
    if isinstance(pc, StageConstraint):
        def traj_fn(X, U, p, tvp, _pc=pc):
            return _pc(X, U, p, tvp).reshape(-1)
        return (traj_fn, H * pc.dim, np.tile(pc.row_types(), H),
                np.tile(np.asarray(pc.lb, np.float64), H),
                np.tile(np.asarray(pc.ub, np.float64), H))

    def traj_fn(X, U, p, tvp, _pc=pc):
        from ..models.base import _call_user_fn
        return _call_user_fn(_pc.fn, X, U, p, tvp).reshape(-1)
    return (traj_fn, pc.dim, pc.row_types(),
            np.asarray(pc.lb, np.float64), np.asarray(pc.ub, np.float64))


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
    box bounds, horizon and step size, and path constraints (keyword or
    last, so a spec without them needs no argument)."""

    model: Any                       # DynamicsModel
    integrator: str                  # "delta" | "euler" | "rk4" | "direct"
    objective: Callable              # J(x:(H,nx), u:(H,nu), p, tvp) -> scalar
    box: Box
    H: int
    DT: float
    path_constraints: Tuple[Any, ...] = ()   # PathConstraint/StageConstraint

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
    def n_slack(self) -> int:
        return sum(int((expand_constraint(pc, self.H)[2] != EQ_TYPE).sum())
                   for pc in self.path_constraints)

    @property
    def n_defect(self) -> int:
        return self.H * self.dims.x
