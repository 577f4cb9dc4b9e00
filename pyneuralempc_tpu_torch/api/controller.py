"""Receding-horizon NMPC controller facade.

PyTorch counterpart of ``pyneuralempc_tpu/api/controller.py``.  Results
come back as a named :class:`NMPCResult`; warm-start state is both instance
convenience state (``next``) and an explicit functional carry
(``next_batch``/``step``).  ``next_batch`` solves a whole batch of problems
as one batch-first solve.

The controller runs on ``device`` ("cuda" unless the caller asks for
"cpu").  On the card the KKT sweep runs as hand-written CUDA kernels; on the
CPU it is its plain PyTorch version.
"""

from __future__ import annotations

import functools
import warnings
from typing import Any, NamedTuple, Optional, Tuple

import torch
from torch.func import vmap

from ..core.problem import (Box, MPCSpec, PathConstraint, StageConstraint,
                            StageCost, runtime)
from ..core.structure import SeparableObjective, probe_stage_separable
from ..core.transcription import NLP, transcribe
from ..ops.integrators import step_fn
from ..ops.rollout import simulate
from ..parallel.horizon import horizon_sweep
from ..solve import riccati
from ..solve.alm import ALMConfig, make_alm_solver
from ..solve.diff import make_differentiable_solver
from ..solve.interior_point import IPConfig, IPResult, make_solver
from ..solve.pscan import riccati_sweep_pscan
from ..utils import tracing


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
    path = []
    for c in constraints or ():
        if isinstance(c, Box):
            if box is not None:
                raise ValueError("at most one Box/DomainConstraint allowed")
            box = c
        elif isinstance(c, (PathConstraint, StageConstraint)):
            path.append(c)
        else:
            raise TypeError(f"unknown constraint type: {type(c)!r}")
    return box, tuple(path)


def _to(tree, device):
    """Move a params tree (list of dicts of tensors) to ``device``."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return [_to(v, device) for v in tree]


def _per_member(params, B: int) -> bool:
    """The JAX package's ``_baxis_tree`` rule: every tensor of ``params``
    carries a leading axis of the batch size."""
    if params is None:
        return False
    leaves, stack = [], [params]
    while stack:
        v = stack.pop()
        if isinstance(v, dict):
            stack.extend(v.values())
        elif isinstance(v, (list, tuple)):
            stack.extend(v)
        else:
            leaves.append(v)
    return bool(leaves) and all(
        getattr(leaf, "ndim", 0) and leaf.shape[0] == B for leaf in leaves)


def per_member_keys(B: int, p=None, tvp=None, params=None) -> tuple:
    """Which of ``p``/``tvp``/``params`` a batch of B problems carries per
    member, by the JAX package's rule (``_baxis``/``_baxis_tree``): ``p``
    of shape (B, p_dim), ``tvp`` of shape (B, H, tvp_dim), ``params`` whose
    every tensor leads with B.  The others are shared across the batch."""
    keys = []
    for name, v, unbatched in (("p", p, 1), ("tvp", tvp, 2)):
        if v is not None and torch.as_tensor(v).dim() == unbatched + 1:
            if torch.as_tensor(v).shape[0] != B:
                raise ValueError(
                    f"per-member {name} must lead with the batch size {B}, "
                    f"got shape {tuple(torch.as_tensor(v).shape)}")
            keys.append(name)
    if _per_member(params, B):
        keys.append("params")
    return tuple(keys)


class NMPC:
    """``NMPC(model, objective, constraints, H, DT).next(x0)`` — one MPC step.

    Parameters
    ----------
    model:       a :class:`~pyneuralempc_tpu_torch.models.base.DynamicsModel`.
    objective:   scalar economic cost ``J(x, u, p=None, tvp=None)``.
    constraints: iterable of at most one :class:`Box` and any number of
                 :class:`StageConstraint` / :class:`PathConstraint`.
    H, DT:       horizon length and integrator step.
    integrator:  "delta" | "euler" | "rk4" | "direct".
    config:      :class:`IPConfig` solver settings (exact Hessian), or
                 :class:`~pyneuralempc_tpu_torch.solve.alm.ALMConfig` for
                 the augmented-Lagrangian solver.
    differentiable: results carry gradients with respect to x0, p, tvp
                 and params by the implicit function theorem.
    mesh:        a (scenario, horizon) :class:`~pyneuralempc_tpu_torch.
                 parallel.Mesh` (:func:`~pyneuralempc_tpu_torch.parallel.
                 make_horizon_mesh`): every batched solve's Riccati sweep
                 runs split over its devices (``kkt_backend`` is
                 "riccati_horizon"); ``next`` and ``step`` (one problem)
                 take the single-device parallel-in-time sweep.
    device:      where the solver runs: "cuda" (default) or "cpu".
    """

    def __init__(self, model, objective, constraints=(), H: int = 10,
                 DT: float = 0.1, integrator: str = "rk4",
                 config: IPConfig = IPConfig(), differentiable: bool = False,
                 mesh=None, device="cuda"):
        self._args = dict(model=model, objective=objective,
                          constraints=constraints, H=H, DT=DT,
                          integrator=integrator, config=config,
                          differentiable=differentiable, mesh=mesh)
        self.device = torch.device(device)
        box, path = _split_constraints(constraints)
        if box is None:
            box = Box.unbounded(model.dims.x, model.dims.u)
        # a plain-callable cost that probes stage-separable is certified,
        # so the O(H) Riccati backend stays eligible
        if (getattr(config, "kkt", None) == "auto"
                and not isinstance(objective, (StageCost,
                                               SeparableObjective))
                and probe_stage_separable(objective, model.dims, H)):
            objective = SeparableObjective(fn=objective)
        self.spec = MPCSpec(model=model, integrator=integrator,
                            objective=objective, box=box, H=H, DT=DT,
                            path_constraints=path)
        self.nlp: NLP = transcribe(self.spec, device=self.device)
        self.config = config
        # IPConfig(record=True): the solver returns (result, trace), and
        # the trace rides on NMPCResult.trace
        self._record = bool(getattr(config, "record", False))
        if self._record and differentiable:
            raise ValueError(
                "IPConfig(record=True) cannot be combined with "
                "differentiable=True (the IFT wrapper differentiates the "
                "solution map, not the iterate history)")
        if isinstance(config, ALMConfig):
            self.kkt_backend = "alm"
            self._ipcfg = config.ip
            self._solve = make_alm_solver(self.nlp, config)
            self._solve_one = self._solve
        else:
            self._ipcfg = config
            one = None         # the single-problem direction, where it differs
            if mesh is not None:
                # sequence-parallel solve: every batched IP iteration's
                # Riccati sweep runs split over the (scenario, horizon) mesh
                if set(mesh.shape) != {"scenario", "horizon"}:
                    raise ValueError(
                        "mesh must have axes ('scenario', 'horizon'); "
                        "use parallel.make_horizon_mesh")
                if H % mesh.shape["horizon"] != 0:
                    raise ValueError(
                        f"H={H} not divisible by horizon axis "
                        f"{mesh.shape['horizon']}")
                sweep = horizon_sweep(mesh)
                direction = functools.partial(riccati.make_riccati_direction,
                                              sweep_impl=sweep)
                one = functools.partial(riccati.make_riccati_direction,
                                        sweep_impl=sweep.unbatched)
                self.kkt_backend = "riccati_horizon"
            elif config.kkt == "riccati_pscan":
                direction = functools.partial(riccati.make_riccati_direction,
                                              sweep_impl=riccati_sweep_pscan)
                self.kkt_backend = "riccati_pscan"
            elif config.kkt == "riccati" or (config.kkt == "auto"
                                             and riccati.eligible(self.nlp)):
                direction = riccati.make_riccati_direction
                self.kkt_backend = "riccati"
            else:
                direction = None
                self.kkt_backend = "dense"
            if self.kkt_backend == "dense" and config.kkt == "auto" \
                    and H >= 30:
                warnings.warn(
                    f"H={H} falls to the dense O((H·(nx+nu))³) KKT backend "
                    "(objective probes stage-coupled, >nu equality rows "
                    "per stage, or >64 trajectory-level border rows). "
                    "Declare StageCost / StageConstraint structure to keep "
                    "the O(H) Riccati backend (trajectory-level "
                    "PathConstraints ride it as a low-rank border).",
                    stacklevel=2)
            # differentiable: gradients flow through next_batch()/step()
            # results by the implicit function theorem (solve/diff.py)
            make = (make_differentiable_solver if differentiable
                    else make_solver)
            self._solve = make(self.nlp, config, direction=direction)
            self._solve_one = (self._solve if one is None
                               else make(self.nlp, config, direction=one))
        self.H, self.DT = H, DT
        self.model = model
        # instance warm-start state for next()
        self._carry: Optional[WarmStart] = None

    def replica(self, device) -> "NMPC":
        """A controller with this one's spec and configuration on
        ``device`` (:class:`~pyneuralempc_tpu_torch.parallel.ShardedNMPC`
        builds one a device of its mesh)."""
        return NMPC(**self._args, device=device)

    # ---- functional core (batch-first) ----

    def cold_start(self, x0, init_x=None, init_u=None, p=None, tvp=None,
                   params=None, per_member: Optional[tuple] = None
                   ) -> WarmStart:
        """Cold initialiser: the zero-control rollout, simulated, so the
        initial point is dynamically feasible (up to box clipping).
        Explicit init values are honoured.  ``x0`` is (x_dim,) or
        (B, x_dim); the carry gets the same leading shape.  A batch's
        ``p``/``tvp``/``params`` may be per member: ``per_member`` names
        them (:func:`per_member_keys` decides when it is None), and each
        member's rollout and slacks then use its own."""
        H, dims = self.H, self.spec.dims
        x0 = torch.as_tensor(x0, device=self.device)
        lead = x0.shape[:-1]
        U = (torch.zeros(lead + (H, dims.u), dtype=x0.dtype,
                         device=self.device)
             if init_u is None else torch.as_tensor(init_u,
                                                    device=self.device))
        params = _to(params, self.device)
        per = per_member
        if per is None:
            per = per_member_keys(x0.shape[0], p, tvp, params) if lead else ()
        own = {k: v for k, v in (("p", p), ("tvp", tvp), ("params", params))
               if k in per}

        def each(fn, *args):
            """``fn(*args, p, tvp, params)``, per member where any of the
            three is."""
            if not per:
                return fn(*args, p, tvp, params)
            return vmap(lambda m, *a: fn(*a, m.get("p", p), m.get("tvp", tvp),
                                         m.get("params", params)))(own, *args)

        if init_x is not None:
            X = torch.as_tensor(init_x, device=self.device)
        else:
            phi = step_fn(self.spec.model, self.spec.integrator,
                          self.spec.DT)
            X = each(lambda x0_, U_, p_, tvp_, prm: simulate(
                phi, x0_, U_, p_, tvp_, prm), x0, U)
            X = torch.nan_to_num(X, nan=0.0, posinf=0.0, neginf=0.0)
        s = each(lambda X_, U_, p_, tvp_, _: self.nlp.init_slacks(
            X_, U_, {"p": p_, "tvp": tvp_}), X, U)
        w = self.nlp.pack(X, U, s)
        return WarmStart(w=w, lam=torch.zeros(lead + (self.nlp.m,),
                                              dtype=w.dtype,
                                              device=self.device),
                         zl=None, zu=None,
                         mu=torch.full(lead, self._ipcfg.mu_init,
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
        mu = torch.clamp(carry.mu, min=self._ipcfg.warm_mu)
        return WarmStart(w=self.nlp.pack(X, U, s), lam=carry.lam,
                         zl=carry.zl, zu=carry.zu, mu=mu, valid=carry.valid)

    def _step(self, carry: WarmStart, rt, one: bool = False
              ) -> Tuple[WarmStart, NMPCResult]:
        """Solve from ``carry``; ``one``: a single problem (``next``,
        ``step``), which a horizon mesh solves on one device."""
        solve = self._solve_one if one else self._solve
        out_ = solve(rt, carry.w, carry.lam, carry.zl, carry.zu, carry.mu)
        res, trace = out_ if self._record else (out_, None)
        res: IPResult
        X, U, s = self.nlp.unpack(res.w)
        out = NMPCResult(x=X, u=U, converged=res.converged,
                         iterations=res.iterations, kkt_error=res.kkt_error,
                         objective=res.objective, slack=s,
                         theta=res.theta, feasible=res.feasible,
                         restorations=res.restorations, trace=trace)
        # the warm carry resumes from the PRE-polish duals (ALM has none)
        new_carry = WarmStart(
            w=res.w, lam=res.lam,
            zl=res.zl if res.zl_warm is None else res.zl_warm,
            zu=res.zu if res.zu_warm is None else res.zu_warm,
            mu=res.mu, valid=res.converged)
        return new_carry, out

    def _warm_step(self, carry: WarmStart, rt, one: bool = False):
        return self._step(self.shift(carry), rt, one)

    def _runtime(self, x0s, p, tvp, params, batched=True):
        """The solver's runtime dict; ``_per_member`` names the inputs that
        lead with the batch size (:func:`per_member_keys`; none for the
        single-problem entry points)."""
        rt = runtime(torch.as_tensor(x0s, device=self.device),
                     None if p is None else torch.as_tensor(
                         p, device=self.device),
                     None if tvp is None else torch.as_tensor(
                         tvp, device=self.device),
                     _to(params, self.device))
        rt["_per_member"] = (per_member_keys(rt["x0"].shape[0], rt["p"],
                                             rt["tvp"], rt["params"])
                             if batched else ())
        return rt

    def step(self, carry: WarmStart, x0, p=None, tvp=None,
             params=None) -> Tuple[WarmStart, NMPCResult]:
        """Pure MPC step for one problem: shift the carry, solve, return
        (carry', result)."""
        rt = self._runtime(torch.as_tensor(x0)[None], p, tvp, params,
                           batched=False)
        new, res = self._warm_step(_lead(carry), rt, one=True)
        return _unlead(new), _unlead(res)

    # ---- stateful convenience API (reference ``NMPC.next`` shape) ----

    def next(self, x0, p=None, tvp=None, init_x=None, init_u=None,
             params=None) -> NMPCResult:
        with tracing.span("nmpc.replan", device=self.device, B=1):
            x0 = torch.as_tensor(x0, device=self.device)
            self._check(x0, p, tvp, init_x, init_u)
            rt = self._runtime(x0[None], p, tvp, params, batched=False)
            if self._carry is None or init_x is not None:
                carry = self.cold_start(x0[None], None if init_x is None
                                        else torch.as_tensor(init_x)[None],
                                        None if init_u is None
                                        else torch.as_tensor(init_u)[None],
                                        p, tvp, params, per_member=())
                self._carry, res = self._step(carry, rt, one=True)
            else:
                self._carry, res = self._warm_step(self._carry, rt,
                                                   one=True)
            return _unlead(res)

    def reset(self):
        self._carry = None

    # ---- batched API ----

    def next_batch(self, x0s, p=None, tvp=None, params=None,
                   carry: Optional[WarmStart] = None,
                   batch_chunk: Optional[int] = None, init_x=None,
                   init_u=None) -> Tuple[WarmStart, NMPCResult]:
        """Solve a batch of MPC problems as one batch-first solve.

        ``x0s``: (B, x_dim).  ``p``/``tvp``/``params`` are shared across the
        batch, or carry a leading batch axis of B: ``p`` (B, p_dim), ``tvp``
        (B, H, tvp_dim), ``params`` with every tensor leading with B (a
        different model per member).  Returns the batched warm-start carry
        (pass it back in for receding-horizon use) and a batched
        :class:`NMPCResult`.

        ``init_x`` (B, H, x_dim) and ``init_u`` (B, H, u_dim), given
        together, are the cold start's plan, as ``next`` takes them: they
        are used where there is no ``carry`` (a warm re-plan resumes from
        the carry and ignores them); without them the cold start is the
        model's rollout under zero control.

        ``batch_chunk``: solve the batch as B / batch_chunk slices of that
        many members, one after another, and concatenate every field of the
        carry and the result along the batch axis (the JAX package's
        semantics: ``None`` or ``0``, or a chunk of at least B, is one whole
        solve; a B that the chunk does not divide raises ``ValueError``).
        The x0s, the carry and every per-member ``p``/``tvp``/``params``
        are sliced; shared ones go to every slice whole.  Unlike the JAX
        package, ``None`` never picks a chunk by itself: its automatic
        choice works round a TPU's per-dispatch limit, which the card does
        not have.  While a profiler records, the call records the span
        ``nmpc.replan`` (:mod:`~pyneuralempc_tpu_torch.utils.tracing`), and
        each slice's span is a child of it.
        """
        B = torch.as_tensor(x0s).shape[0]
        if (init_x is None) != (init_u is None):
            raise ValueError("init_x and init_u must be given together")
        if init_x is not None:
            dims = self.spec.dims
            for name, v, n in (("init_x", init_x, dims.x),
                               ("init_u", init_u, dims.u)):
                if tuple(torch.as_tensor(v).shape) != (B, self.H, n):
                    raise ValueError(f"{name} must be shape ({B}, {self.H}, "
                                     f"{n})")
        with tracing.span("nmpc.replan", device=self.device, B=B):
            if batch_chunk and B > batch_chunk:
                if B % batch_chunk:
                    raise ValueError(f"batch {B} not divisible by "
                                     f"batch_chunk {batch_chunk}")
                return self._chunked_batch(x0s, p, tvp, params, carry,
                                           batch_chunk, init_x, init_u)
            rt = self._runtime(x0s, p, tvp, params)
            if carry is None:
                carry = self.cold_start(rt["x0"], init_x, init_u,
                                        p=rt["p"], tvp=rt["tvp"],
                                        params=rt["params"],
                                        per_member=rt["_per_member"])
                return self._step(carry, rt)
            return self._warm_step(carry, rt)

    def _chunked_batch(self, x0s, p, tvp, params, carry, chunk, init_x,
                       init_u):
        """``next_batch`` as B / chunk slices solved one after another, each
        field of the carries and results concatenated along the batch."""
        x0s = torch.as_tensor(x0s, device=self.device)
        B = x0s.shape[0]
        inputs = {"p": None if p is None else torch.as_tensor(p),
                  "tvp": None if tvp is None else torch.as_tensor(tvp),
                  "params": params}
        per = per_member_keys(B, **inputs)
        outs = []
        for i in range(0, B, chunk):
            sl = slice(i, i + chunk)
            own = {k: (_index(v, sl) if k in per else v)
                   for k, v in inputs.items()}
            if init_x is not None:
                own.update(init_x=init_x[sl], init_u=init_u[sl])
            outs.append(self.next_batch(
                x0s[sl], carry=None if carry is None else _pick(carry, sl),
                **own))
        return tuple(_concat([o[j] for o in outs]) for j in range(2))

    def next_multi_start(self, x0, n_starts: int = 8, noise: float = 0.3,
                         p=None, tvp=None, params=None,
                         generator: Optional[torch.Generator] = None,
                         return_index: bool = False):
        """Multi-start solve for nonconvex problems: ``n_starts`` copies of
        the problem from randomly perturbed control initialisations solve
        as one batch; the lowest objective among the converged starts wins
        (the lowest ``kkt_error`` when none converged), and every result
        field is the winner's.

        The perturbations are ``noise`` times standard normals drawn on the
        CPU from ``generator`` (seed 0 when None) by
        :func:`multi_start_perturbations`, so the card and the CPU start
        from the same numbers.  ``return_index`` also returns the winner's
        index.
        """
        with tracing.span("nmpc.replan", device=self.device, B=n_starts):
            x0 = torch.as_tensor(x0, device=self.device)
            dims = self.spec.dims
            x0s = x0.expand((n_starts,) + tuple(x0.shape)).contiguous()
            rt = self._runtime(x0s, p, tvp, params)
            base = self.cold_start(x0s, p=rt["p"], tvp=rt["tvp"],
                                   params=rt["params"],
                                   per_member=rt["_per_member"])
            X, U, s = self.nlp.unpack(base.w)
            du = multi_start_perturbations(generator, n_starts, self.H,
                                           dims.u, noise).to(
                device=self.device, dtype=U.dtype)
            carry = base._replace(w=self.nlp.pack(X, U + du, s))
            _, res = self._step(carry, rt)
            idx = multi_start_winner(res)
            best = _pick(res, idx)
            return (best, int(idx)) if return_index else best

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


def multi_start_perturbations(generator: Optional[torch.Generator],
                               n_starts: int, H: int, u_dim: int,
                               noise: float = 0.3) -> torch.Tensor:
    """(n_starts, H, u_dim) control perturbations for
    :meth:`NMPC.next_multi_start`: ``noise`` times standard normals drawn
    on the CPU from ``generator`` (a CPU generator seeded 0 when None)."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    return noise * torch.randn((n_starts, H, u_dim), generator=generator,
                               dtype=torch.float32)


def multi_start_winner(res: NMPCResult) -> torch.Tensor:
    """Index of the winning start: the lowest objective among the converged
    starts, else the lowest ``kkt_error``."""
    obj = torch.where(res.converged, res.objective,
                      torch.full_like(res.objective, torch.inf))
    return torch.where(res.converged.any(), torch.argmin(obj),
                       torch.argmin(res.kkt_error))


def _index(v, idx):
    """``v[idx]`` for a tensor and for each tensor of a dict (the record
    trace) or a list (per-member params); anything else passes."""
    if isinstance(v, torch.Tensor):
        return v[idx]
    if isinstance(v, dict):
        return {k: _index(t, idx) for k, t in v.items()}
    if isinstance(v, list):
        return [_index(t, idx) for t in v]
    return v


def _cat(vs):
    """The slices of one field joined along the batch axis: tensors (and
    the tensors of a params list or a record trace dict) concatenated;
    anything else (None, a shared scalar) is the first slice's."""
    v = vs[0]
    if isinstance(v, torch.Tensor) and v.dim():
        return torch.cat(vs)
    if isinstance(v, dict):
        return {k: _cat([d[k] for d in vs]) for k in v}
    if isinstance(v, list):
        return [_cat([d[i] for d in vs]) for i in range(len(v))]
    return v


def _concat(tups):
    """Field by field, the slices of a batched NamedTuple joined."""
    return type(tups[0])(*[_cat(list(vs)) for vs in zip(*tups)])


def _pick(tup, idx):
    """Member ``idx`` of every batched field (the trace's too)."""
    return type(tup)(*[_index(v, idx) for v in tup])


def _lead(tup):
    """Add a leading batch axis of 1 to every tensor field."""
    return _pick(tup, None)


def _unlead(tup):
    """Drop the leading batch axis of 1 from every tensor field."""
    return _pick(tup, 0)
