"""Receding-horizon NMPC controller facade.

PyTorch counterpart of ``pyneuralempc_tpu/api/controller.py``.  Results
come back as a named :class:`NMPCResult`; warm-start state is both instance
convenience state (``next``) and an explicit functional carry
(``next_batch``/``step``).  ``next_batch`` solves a whole batch of problems
as one batch-first solve.

The controller runs on ``device`` ("cuda" unless the caller asks for
"cpu").  On the card the KKT sweep is the hand-written CUDA kernel; on the
CPU it is its plain PyTorch version.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch

from ..core.problem import Box, MPCSpec, StageCost, runtime
from ..core.structure import SeparableObjective, probe_stage_separable
from ..core.transcription import NLP, transcribe
from ..ops.integrators import step_fn
from ..ops.rollout import simulate
from ..solve import riccati
from ..solve.interior_point import IPConfig, IPResult, make_solver


class NMPCResult(NamedTuple):
    """``converged=False, feasible=True`` — optimality stalled on a feasible
    plan; ``feasible=False`` — local-infeasibility certificate.  Batched
    results carry a leading batch axis on every field."""
    x: Any            # (H, x_dim) planned state trajectory
    u: Any            # (H, u_dim) planned controls
    converged: Any
    iterations: Any
    kkt_error: Any
    objective: Any
    slack: Any        # (n_slack,) path-constraint slacks
    theta: Any        # final max constraint violation ‖C‖∞
    feasible: Any     # theta <= tol
    restorations: Any = 0
    trace: Any = None


class WarmStart(NamedTuple):
    """Functional warm-start carry: primal plan plus the interior-point
    duals and barrier parameter, so receding-horizon re-solves resume."""
    w: Any
    lam: Any
    zl: Any
    zu: Any
    mu: Any
    valid: Any        # last solve converged


def _split_constraints(constraints):
    box = None
    for c in constraints or ():
        if isinstance(c, Box):
            if box is not None:
                raise ValueError("at most one Box/DomainConstraint allowed")
            box = c
        else:
            raise NotImplementedError(
                f"constraint {type(c).__name__}: path and stage constraints "
                "are ROADMAP Queue 1 #9; this port takes one Box")
    return box


def _to(tree, device):
    """Move a params tree (list of dicts of tensors) to ``device``."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return [_to(v, device) for v in tree]


def _shared(v, unbatched_ndim, name):
    """p/tvp must be shared across the batch in this slice."""
    if v is not None and torch.as_tensor(v).dim() == unbatched_ndim + 1:
        raise NotImplementedError(
            f"per-problem {name} in next_batch is ROADMAP Queue 1 #6b; "
            "pass one shared value")


class NMPC:
    """``NMPC(model, objective, constraints, H, DT).next(x0)`` — one MPC step.

    Parameters
    ----------
    model:       a :class:`~pyneuralempc_tpu_torch.models.base.DynamicsModel`.
    objective:   scalar economic cost ``J(x, u, p=None, tvp=None)``.
    constraints: iterable holding at most one :class:`Box`.
    H, DT:       horizon length and integrator step.
    integrator:  "delta" | "euler" | "rk4" | "direct".
    config:      :class:`IPConfig` solver settings (exact Hessian).
    device:      where the solver runs: "cuda" (default) or "cpu".
    """

    def __init__(self, model, objective, constraints=(), H: int = 10,
                 DT: float = 0.1, integrator: str = "rk4",
                 config: IPConfig = IPConfig(), differentiable: bool = False,
                 mesh=None, device="cuda"):
        if not isinstance(config, IPConfig):
            raise NotImplementedError(
                f"config {type(config).__name__}: only IPConfig is ported "
                "(ALM is ROADMAP Queue 1 #10)")
        if differentiable:
            raise NotImplementedError(
                "differentiable=True: the IFT-differentiable solve is "
                "ROADMAP Queue 1 #10")
        if mesh is not None:
            raise NotImplementedError(
                "mesh=: multi-device solves are ROADMAP Queue 1 #14")
        self.device = torch.device(device)
        box = _split_constraints(constraints)
        if box is None:
            box = Box.unbounded(model.dims.x, model.dims.u)
        # a plain-callable cost that probes stage-separable is certified,
        # so the O(H) Riccati backend stays eligible
        if (config.kkt == "auto"
                and not isinstance(objective, (StageCost,
                                               SeparableObjective))
                and probe_stage_separable(objective, model.dims, H)):
            objective = SeparableObjective(fn=objective)
        self.spec = MPCSpec(model=model, integrator=integrator,
                            objective=objective, box=box, H=H, DT=DT)
        self.nlp: NLP = transcribe(self.spec, device=self.device)
        self.config = config
        if config.kkt == "auto" and not riccati.eligible(self.nlp):
            raise NotImplementedError(
                "the objective probes stage-coupled, which needs the dense "
                "KKT backend (ROADMAP Queue 1 #10)")
        self.kkt_backend = "riccati"
        self._solve = make_solver(self.nlp, config,
                                  direction=riccati.make_riccati_direction)
        self.H, self.DT = H, DT
        self.model = model
        # instance warm-start state for next()
        self._carry: Optional[WarmStart] = None

    # ---- functional core (batch-first) ----

    def cold_start(self, x0, init_x=None, init_u=None, p=None, tvp=None,
                   params=None) -> WarmStart:
        """Cold initialiser: the zero-control rollout, simulated, so the
        initial point is dynamically feasible (up to box clipping).
        Explicit init values are honoured.  ``x0`` is (x_dim,) or
        (B, x_dim); the carry gets the same leading shape."""
        H, dims = self.H, self.spec.dims
        x0 = torch.as_tensor(x0, device=self.device)
        lead = x0.shape[:-1]
        U = (torch.zeros(lead + (H, dims.u), dtype=x0.dtype,
                         device=self.device)
             if init_u is None else torch.as_tensor(init_u,
                                                    device=self.device))
        if init_x is not None:
            X = torch.as_tensor(init_x, device=self.device)
        else:
            phi = step_fn(self.spec.model, self.spec.integrator,
                          self.spec.DT)
            X = simulate(phi, x0, U, p, tvp, _to(params, self.device))
            X = torch.nan_to_num(X, nan=0.0, posinf=0.0, neginf=0.0)
        s = self.nlp.init_slacks(X, U, {"p": p, "tvp": tvp})
        w = self.nlp.pack(X, U, s)
        return WarmStart(w=w, lam=torch.zeros(lead + (self.nlp.m,),
                                              dtype=w.dtype,
                                              device=self.device),
                         zl=None, zu=None,
                         mu=torch.full(lead, self.config.mu_init,
                                       dtype=w.dtype, device=self.device),
                         valid=torch.ones(lead, dtype=torch.bool,
                                          device=self.device))

    def shift(self, carry: WarmStart) -> WarmStart:
        """Receding-horizon shift: move the plan one step left, duplicate
        the last stage.  Duals and μ are carried as-is; μ is floored so a
        fully-converged barrier can re-open for the new problem."""
        X, U, s = self.nlp.unpack(carry.w)
        X = torch.cat([X[..., 1:, :], X[..., -1:, :]], dim=-2)
        U = torch.cat([U[..., 1:, :], U[..., -1:, :]], dim=-2)
        s = self.nlp.shift_slacks(s)
        mu = torch.clamp(carry.mu, min=self.config.warm_mu)
        return WarmStart(w=self.nlp.pack(X, U, s), lam=carry.lam,
                         zl=carry.zl, zu=carry.zu, mu=mu, valid=carry.valid)

    def _step(self, carry: WarmStart, rt) -> Tuple[WarmStart, NMPCResult]:
        res: IPResult = self._solve(rt, carry.w, carry.lam, carry.zl,
                                    carry.zu, carry.mu)
        X, U, s = self.nlp.unpack(res.w)
        out = NMPCResult(x=X, u=U, converged=res.converged,
                         iterations=res.iterations, kkt_error=res.kkt_error,
                         objective=res.objective, slack=s,
                         theta=res.theta, feasible=res.feasible,
                         restorations=res.restorations)
        # the warm carry resumes from the PRE-polish duals
        new_carry = WarmStart(w=res.w, lam=res.lam, zl=res.zl_warm,
                              zu=res.zu_warm, mu=res.mu,
                              valid=res.converged)
        return new_carry, out

    def _warm_step(self, carry: WarmStart, rt):
        return self._step(self.shift(carry), rt)

    def _runtime(self, x0s, p, tvp, params):
        return runtime(torch.as_tensor(x0s, device=self.device),
                       None if p is None else torch.as_tensor(
                           p, device=self.device),
                       None if tvp is None else torch.as_tensor(
                           tvp, device=self.device),
                       _to(params, self.device))

    def step(self, carry: WarmStart, x0, p=None, tvp=None,
             params=None) -> Tuple[WarmStart, NMPCResult]:
        """Pure MPC step for one problem: shift the carry, solve, return
        (carry', result)."""
        rt = self._runtime(torch.as_tensor(x0)[None], p, tvp, params)
        new, res = self._warm_step(_lead(carry), rt)
        return _unlead(new), _unlead(res)

    # ---- stateful convenience API (reference ``NMPC.next`` shape) ----

    def next(self, x0, p=None, tvp=None, init_x=None, init_u=None,
             params=None) -> NMPCResult:
        x0 = torch.as_tensor(x0, device=self.device)
        self._check(x0, p, tvp, init_x, init_u)
        rt = self._runtime(x0[None], p, tvp, params)
        if self._carry is None or init_x is not None:
            carry = self.cold_start(x0[None], None if init_x is None
                                    else torch.as_tensor(init_x)[None],
                                    None if init_u is None
                                    else torch.as_tensor(init_u)[None],
                                    p, tvp, params)
            self._carry, res = self._step(carry, rt)
        else:
            self._carry, res = self._warm_step(self._carry, rt)
        return _unlead(res)

    def reset(self):
        self._carry = None

    # ---- batched API ----

    def next_batch(self, x0s, p=None, tvp=None, params=None,
                   carry: Optional[WarmStart] = None
                   ) -> Tuple[WarmStart, NMPCResult]:
        """Solve a batch of MPC problems as one batch-first solve.

        ``x0s``: (B, x_dim).  ``p``/``tvp``/``params`` are shared across the
        batch.  Returns the batched warm-start carry (pass it back in for
        receding-horizon use) and a batched :class:`NMPCResult`.
        """
        _shared(p, 1, "p")
        _shared(tvp, 2, "tvp")
        rt = self._runtime(x0s, p, tvp, params)
        if carry is None:
            carry = self.cold_start(rt["x0"], p=rt["p"], tvp=rt["tvp"],
                                    params=rt["params"])
            return self._step(carry, rt)
        return self._warm_step(carry, rt)

    # ---- validation ----

    def _check(self, x0, p, tvp, init_x, init_u):
        dims = self.spec.dims
        if x0.dim() != 1 or x0.shape[0] != dims.x:
            raise ValueError(f"x0 must be shape ({dims.x},), got "
                             f"{tuple(x0.shape)}")
        if p is not None and tuple(torch.as_tensor(p).shape) != (dims.p,):
            raise ValueError(f"p must be shape ({dims.p},)")
        if tvp is not None and tuple(torch.as_tensor(tvp).shape) != (
                self.H, dims.tvp):
            raise ValueError(f"tvp must be shape ({self.H}, {dims.tvp})")
        if (init_x is None) != (init_u is None):
            raise ValueError("init_x and init_u must be given together")
        if init_x is not None:
            if tuple(torch.as_tensor(init_x).shape) != (self.H, dims.x):
                raise ValueError(f"init_x must be shape ({self.H}, "
                                 f"{dims.x})")
            if tuple(torch.as_tensor(init_u).shape) != (self.H, dims.u):
                raise ValueError(f"init_u must be shape ({self.H}, "
                                 f"{dims.u})")


def _lead(tup):
    """Add a leading batch axis of 1 to every tensor field."""
    return type(tup)(*[v[None] if isinstance(v, torch.Tensor) else v
                       for v in tup])


def _unlead(tup):
    """Drop the leading batch axis of 1 from every tensor field."""
    return type(tup)(*[v[0] if isinstance(v, torch.Tensor) else v
                       for v in tup])
