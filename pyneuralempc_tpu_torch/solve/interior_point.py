"""Batched primal-dual interior-point NLP solver.

PyTorch counterpart of ``pyneuralempc_tpu/solve/interior_point.py``, written
batch-first.  The JAX solver solves ONE problem in a ``lax.while_loop`` and
is ``vmap``-ed; JAX then runs every member until the whole batch is done,
freezing finished members with a select.  Here the whole (B, …) batch
advances in a Python loop, and the same per-member masks freeze finished
members with ``torch.where``:

* the outer loop stops when every member is done or out of iterations;
* the line search walks its fixed fan of step lengths until every member
  has taken a step;
* the δ ladder in the KKT backend re-sweeps until every member succeeded.

Each of those exits is a host sync (``bool(mask.all())``).  Because a frozen
member's state never changes, where the host checks alters only how much
work runs, never a member's result.  Per-problem results therefore follow
the JAX package's, up to f32 rounding.

Algorithm (monotone Fiacco–McCormick barrier, primal-dual steps):

  minimise J(w)  s.t.  C(w) = 0,  lb ≤ w ≤ ub

with the condensed Newton system

      [ W + Σ + δ_w I    Aᵀ ] [Δw]   [ −r̃  ]
      [ A                0  ] [Δλ] = [ −r_p ]

solved by the Riccati backend (:mod:`.riccati`) or by the dense backend
(:func:`make_dense_direction`: one equilibrated LU of the full system with
a refinement pass and a per-member δ_w ladder); Σ = z_l/(w−lb) +
z_u/(ub−w), W = ∇²_w L(w, λ) exact, r̃ = ∇J + Aᵀλ − μ/(w−lb) + μ/(ub−w).
Globalisation: fraction-to-boundary rule plus a backtracking line search on
the exact-penalty merit φ_μ(w) + ν‖C(w)‖₁, with a second-order correction
and a feasibility-restoration watchdog.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch
from torch.func import grad, hessian, jacrev, vjp, vmap

from ..core.transcription import NLP
from ..ops.cuda import tanh_dense
from ..utils import tracing

_BIG = 1e20


@dataclasses.dataclass(frozen=True)
class IPConfig:
    """Solver configuration.  Fields and defaults are the JAX package's
    (see its ``IPConfig`` for the measurements behind each default).

    ``mu_strategy``: "monotone" (Fiacco-McCormick), "adaptive" (the LOQO
    centrality rule: μ = σ · the average complementarity, σ set by the
    worst pair) or "mehrotra" (predictor-corrector: an affine predictor on
    the same stage blocks, σ = (μ_aff / avg)³, and the second-order Δs∘Δz
    terms in the corrector's right-hand side; one more sweep a Newton
    step).  ``hessian``: "exact", or "objective" / "gauss_newton", which
    drop the defect and stage-constraint curvature from the stage blocks
    (the Jacobians then take one forward-mode pass, no reverse pass); the
    dense backend takes W as the objective's Hessian, or as AᵀA + gn_reg·I.
    ``polish_fresh`` re-derives the stage blocks at the converged point
    before the polish steps instead of reusing the last iteration's.
    ``kkt``: "auto" (the controller takes Riccati where the problem is
    eligible, else dense), "riccati", "riccati_pscan" (the Riccati
    direction through the O(log H) parallel-in-time sweep,
    :mod:`.pscan`) or "dense".  ``record=True`` runs
    exactly ``max_iter`` iterations and ``solve`` returns ``(result,
    trace)``, the trace a dict of (B, max_iter) tensors; ``debug=True``
    prints one line a member an iteration.
    """

    max_iter: int = 60
    tol: float = 1e-4
    acceptable_tol: float = 1e-4   # acceptable-level exit (off when
                                   # acceptable_tol <= tol)
    acceptable_iter: int = 10
    mu_init: float = 1e-3
    warm_mu: float = 3e-4          # μ floor when resuming from a warm carry
    mu_strategy: str = "monotone"
    kappa_mu: float = 0.2          # linear μ decrease factor
    theta_mu: float = 1.5          # superlinear μ decrease exponent
    kappa_eps: float = 10.0        # μ-phase exit: E_μ <= kappa_eps · μ
    tau_min: float = 0.99          # fraction-to-boundary
    kappa_sigma: float = 1e10      # dual safeguard corridor
    bound_push: float = 1e-2       # κ₁: initial interior push
    ls_backtracks: int = 8         # line-search fan size
    ls_factor: float = 0.5         # candidate j uses α_max · ls_factor**j
    armijo_eta: float = 1e-4
    soc: bool = True               # second-order correction
    watchdog: int = 6              # restoration watchdog (0 disables)
    theta_noise_per_row: float = 3e-7
    polish_iters: int = 0          # fixed centering steps at polish_mu
    polish_mu: float = 1e-8
    warm_z_corridor: float = 1e2   # warm-start bound-dual re-centering
    polish_fresh: bool = False     # fresh stage blocks for the polish
    delta_c: float = 1e-8          # dual regularisation of the equality
                                   # rows of the Riccati general path
    nu_init: float = 1.0           # merit penalty initial value
    hessian: str = "exact"         # "exact" | "objective" | "gauss_newton"
    gn_reg: float = 1e-6           # curvature floor of the non-exact modes
                                   # (dense backend only)
    kkt: str = "auto"              # "auto" | "riccati" | "riccati_pscan"
                                   # | "dense"
    auto_scale: bool = True        # gradient-based objective scaling
    scale_gmax: float = 100.0
    debug: bool = False
    record: bool = False

    def __post_init__(self):
        if self.hessian not in ("exact", "objective", "gauss_newton"):
            raise ValueError(f"unknown hessian mode {self.hessian!r}")
        if self.mu_strategy not in ("monotone", "adaptive", "mehrotra"):
            raise ValueError(f"unknown mu_strategy {self.mu_strategy!r}")
        if self.kkt not in ("auto", "riccati", "dense", "riccati_pscan"):
            raise ValueError(f"unknown kkt backend {self.kkt!r}")


# Regularisation ladder of the dense backend's inertia correction (tried in
# order, per member).
_DELTAS = (0.0, 1e-8, 1e-6, 1e-4, 1e-2, 1.0, 1e2, 1e4)


class IPState(NamedTuple):
    """Per-member solver state; every field has a leading batch axis."""
    w: Any
    lam: Any
    zl: Any
    zu: Any
    mu: Any
    nu: Any
    it: Any
    done: Any          # converged or failed
    converged: Any
    kkt_error: Any
    th_best: Any       # best θ seen (restoration watchdog reference)
    stall: Any         # consecutive iterations without θ progress
    n_restore: Any     # iterations spent in restoration mode
    # residuals at (w, lam), evaluated at the END of the producing
    # iteration, so convergence is detected the moment the step lands
    g: Any             # ∇J(w) (scaled objective)
    c_res: Any         # C(w)
    ATlam: Any         # A(w)ᵀ λ
    ATc: Any           # A(w)ᵀ C(w) (restoration steepest-descent rhs)
    err: Any           # μ=0 KKT error at (w, λ, z)
    err_best: Any      # best μ=0 error seen (acceptable-exit reference)
    acc_stall: Any     # consecutive iterations without err progress
    blocks: Any        # KKT blocks from the producing iteration (() unless
                       # the cheap-polish phase consumes them)


class IPResult(NamedTuple):
    """Batched solve result.  ``converged=False, feasible=True``: optimality
    stalled at a feasible plan; ``feasible=False``: local-infeasibility
    certificate."""
    w: Any
    lam: Any
    zl: Any
    zu: Any
    mu: Any
    converged: Any
    iterations: Any
    kkt_error: Any
    objective: Any
    theta: Any         # final max constraint violation ‖C(w)‖∞
    feasible: Any      # theta <= tol
    restorations: Any = 0
    zl_warm: Any = None    # PRE-polish bound duals: the warm-start carry
    zu_warm: Any = None    # resumes from these, not the polished ones


def _col(x):
    """(B,) per-member scalar as a (B, 1) column; Python floats pass."""
    return x.unsqueeze(-1) if isinstance(x, torch.Tensor) else x


def _select(keep, old, new):
    """Per-member select over tensors (or tuples of tensors)."""
    if isinstance(old, tuple):
        return tuple(_select(keep, o, n) for o, n in zip(old, new))
    return torch.where(keep.reshape(keep.shape + (1,) * (old.dim() - 1)),
                       old, new)


def _prepare(prep_fn, w, lam, rt):
    """``prep_fn(w, lam, rt)`` in the ``kkt.prepare`` span, which notes the
    tanh layers' tangent-kernel launches the blocks made."""
    with tracing.span("kkt.prepare") as sp:
        before = tanh_dense.launch_counts()
        blocks = prep_fn(w, lam, rt)
        sp.note(**{k: n - before[k]
                   for k, n in tanh_dense.launch_counts().items()})
    return blocks


def _vm(fn, rt, *args):
    """``fn(*args_i, rt_i)`` for every member i.  The runtime dict splits
    into per-member entries (x0, _s_obj and whichever keys
    ``rt["_per_member"]`` names) and shared ones."""
    keys = ("x0", "_s_obj") + tuple(rt.get("_per_member", ()))
    own = {k: rt[k] for k in keys if rt.get(k) is not None}
    shared = {k: v for k, v in rt.items() if k not in own}

    def one(mine, *a):
        return fn(*a, dict(shared, **mine))
    return vmap(one)(own, *args)


def lu_solve_equilibrated(K, rhs):
    """Solve K x = rhs for a batch, K (B, N, N) and rhs (B, N): symmetric
    Jacobi equilibration (rows and columns scaled by 1/sqrt of each row's
    largest entry), one LU with partial pivoting, then one pass of
    iterative refinement against the unscaled K.  A singular K gives
    non-finite entries, not an error."""
    d = torch.rsqrt(torch.clamp(K.abs().amax(-1), min=1e-8))
    lu, piv, _ = torch.linalg.lu_factor_ex(K * d[..., :, None]
                                           * d[..., None, :])

    def solve_once(b):
        return d * torch.linalg.lu_solve(lu, piv, (d * b)[..., None])[..., 0]

    sol = solve_once(rhs)
    return sol + solve_once(rhs - (K @ sol[..., None])[..., 0])


def kkt_matrix(W, Sigma, A, delta_c: float):
    """The batch's condensed KKT matrices [[W + diag(Σ), Aᵀ], [A, −δ_c I]],
    (B, n + m, n + m)."""
    m = A.shape[-2]
    eye_m = torch.eye(m, dtype=W.dtype, device=W.device)
    return torch.cat([torch.cat([W + torch.diag_embed(Sigma), A.mT], dim=-1),
                      torch.cat([A, (-delta_c * eye_m).expand(
                          A.shape[:-2] + (m, m))], dim=-1)], dim=-2)


def kkt_step(W, Sigma, A, r_tilde, r_p, delta_c: float = 1e-8,
             retry: bool = True):
    """Full-space KKT solve of a batch with a per-member δ_w ladder: W
    (B, n, n), Σ (B, n), A (B, m, n), r̃ (B, n), r_p (B, m).

        [ W + Σ + δ_w I   Aᵀ      ] [Δw]   [ −r̃  ]
        [ A              −δ_c I   ] [Δλ] = [ −r_p ]

    by :func:`lu_solve_equilibrated`.  A member's step is accepted when it
    is finite and has positive curvature Δwᵀ(W + Σ + δ_w I)Δw ≥
    1e-10·‖Δw‖² (the proxy for the inertia test); a member that fails is
    solved again at the next δ_w of ``_DELTAS`` while the others keep their
    step, and one that fails them all keeps the last level's step with ok
    False.  ``retry=False`` solves once at δ_w = 0 (the second-order
    correction and polish re-solves).  Returns ``(dw, dlam, ok)``."""
    # active bounds can drive Σ toward inf in f32: a finite huge diagonal
    # pins those variables without poisoning the factor
    Sigma = torch.clamp(torch.nan_to_num(Sigma, posinf=1e10), 0.0, 1e10)
    W = torch.nan_to_num(W, posinf=1e10, neginf=-1e10)
    n, m = W.shape[-1], A.shape[-2]
    rhs = torch.cat([-r_tilde, -r_p], dim=-1)
    K0 = kkt_matrix(W, Sigma, A, delta_c)
    on_w = torch.cat([torch.ones(n, dtype=W.dtype, device=W.device),
                      torch.zeros(m, dtype=W.dtype, device=W.device)])

    def factor(delta, rows):
        K = K0[rows] + torch.diag_embed(delta * on_w)
        sol = lu_solve_equilibrated(K, rhs[rows])
        dw, dlam = sol[..., :n], sol[..., n:]
        curv = (dw * (K[..., :n, :n] @ dw[..., None])[..., 0]).sum(-1)
        ok = (torch.isfinite(sol).all(-1)
              & (curv >= 1e-10 * (dw * dw).sum(-1)))
        return dw, dlam, ok

    with tracing.span("kkt.sweep"):
        dw, dlam, ok = factor(_DELTAS[0], slice(None))
    if not retry:
        return dw, dlam, ok
    for delta in _DELTAS[1:]:
        with tracing.span("sync.ladder"):
            redo = torch.nonzero(~ok).flatten()
        if redo.numel() == 0:
            break
        with tracing.span("kkt.sweep"):
            dw[redo], dlam[redo], ok[redo] = factor(delta, redo)
    return dw, dlam, ok


def make_dense_direction(nlp: NLP, cfg: IPConfig,
                         hessian_fn=None) -> Callable:
    """Dense KKT backend factory, the split protocol of
    :func:`.riccati.make_riccati_direction`: ``prepare(w, lam, rt)`` gives
    the blocks (W, A), the Lagrangian Hessian (or the mode's curvature) and
    the constraint Jacobian of every member, by ``torch.func`` (the
    expensive part); ``solve_blocks(blocks, Σ, r̃, c, retry)`` is one
    :func:`kkt_step`.  ``hessian_fn(w, lam, rt_i)`` (one member's) replaces
    the mode's W, as the ALM solver's Gauss-Newton curvature does.  The
    objective is scaled by the member's ``_s_obj`` where ``rt`` has it."""
    n = nlp.n
    dtype = nlp.lower.dtype
    eye_n = torch.eye(n, dtype=dtype, device=nlp.lower.device)

    def obj1(w, rt1):
        return rt1.get("_s_obj", 1.0) * nlp.objective(w, rt1)

    def jac1(w, rt1):
        return jacrev(lambda ww: nlp.constraints(ww, rt1))(w)

    if hessian_fn is not None:
        hess1 = hessian_fn
    elif cfg.hessian == "exact":
        def hess1(w, lam, rt1):
            return hessian(lambda ww: obj1(ww, rt1) + torch.dot(
                lam, nlp.constraints(ww, rt1)))(w)
    elif cfg.hessian == "objective":
        def hess1(w, lam, rt1):
            return hessian(lambda ww: obj1(ww, rt1))(w)
    else:  # gauss_newton: JᵀJ curvature of the constraint residuals
        def hess1(w, lam, rt1):
            A = jac1(w, rt1)
            return A.T @ A + cfg.gn_reg * eye_n

    def prepare(w, lam, rt):
        """(W, A) of every member: (B, n, n) and (B, m, n)."""
        W = _vm(hess1, rt, w, lam)
        A = _vm(jac1, rt, w)
        return W.to(dtype).contiguous(), A.to(dtype).contiguous()

    def solve_blocks(blocks, Sigma, r_tilde2, c2, retry=True):
        W, A = blocks
        return kkt_step(W, Sigma, A, r_tilde2, c2, delta_c=cfg.delta_c,
                        retry=retry)

    def direction(w, lam, rt, Sigma, r_tilde, c):
        """``(dw, dlam, ok, resolve)``; ``resolve(r̃2, c2)`` re-solves with
        the same blocks."""
        blocks = prepare(w, lam, rt)

        def resolve(r_tilde2, c2, retry=True, Sigma2=None):
            return solve_blocks(blocks, Sigma if Sigma2 is None else Sigma2,
                                r_tilde2, c2, retry=retry)

        dw, dlam, ok = resolve(r_tilde, c)
        return dw, dlam, ok, resolve

    def zero_blocks(Bn, device):
        return (torch.zeros((Bn, n, n), dtype=dtype, device=device),
                torch.zeros((Bn, nlp.m, n), dtype=dtype, device=device))

    direction.prepare = prepare
    direction.solve_blocks = solve_blocks
    direction.zero_blocks = zero_blocks
    return direction


def make_solver(nlp: NLP, config: IPConfig = IPConfig(),
                direction=None, hessian_fn=None) -> Callable:
    """Build ``solve(rt, w0, lam0=None, zl0=None, zu0=None, mu0=None) ->
    IPResult`` for a BATCH of problems: ``w0`` is (B, n), ``rt["x0"]``
    (B, nx); ``p``/``tvp``/``params`` in ``rt`` are shared, except those
    that ``rt["_per_member"]`` names, which lead with B.

    ``direction``: KKT backend factory ``(nlp, cfg) -> fn`` with the split
    ``prepare``/``solve_blocks`` protocol (:func:`.riccati.
    make_riccati_direction`); None takes the dense backend
    (:func:`make_dense_direction`, with ``hessian_fn`` as its curvature
    when given).

    With ``config.record`` the solve runs exactly ``max_iter`` iterations
    (members that are done stay frozen) and returns ``(result, trace)``:
    ``kkt_error``, ``mu``, ``objective`` (unscaled), ``theta`` (‖C‖₁) and
    ``done`` after every iteration, each (B, max_iter).
    """
    cfg = config
    n, m = nlp.n, nlp.m
    lb, ub = nlp.lower, nlp.upper
    dtype = lb.dtype

    has_lb = torch.isfinite(lb)
    has_ub = torch.isfinite(ub)
    n_bounds = float(max(int(has_lb.sum()) + int(has_ub.sum()), 1))
    n_act = float(max(int((has_lb | has_ub).sum()), 1))   # bounded entries
    bl = torch.where(has_lb, lb, -torch.inf)
    bu = torch.where(has_ub, ub, torch.inf)

    direction_fn = (direction(nlp, cfg) if direction is not None
                    else make_dense_direction(nlp, cfg, hessian_fn))
    prep_fn = direction_fn.prepare
    solve_blocks_fn = direction_fn.solve_blocks
    # the polish phase re-solves with the last iteration's blocks, unless
    # it derives fresh ones at the converged point
    _carry_blocks = cfg.polish_iters > 0 and not cfg.polish_fresh

    # ---- per-member NLP functions, batched with vmap (_vm) ----
    def obj1(w, rt1):
        return rt1["_s_obj"] * nlp.objective(w, rt1)

    def residuals1(w, lam, rt1):
        g = grad(obj1)(w, rt1)
        c, cvjp = vjp(lambda ww: nlp.constraints(ww, rt1), w)
        return g, c, cvjp(lam)[0], cvjp(c)[0]

    def residuals_at(w, lam, rt):
        """(∇J, C, Aᵀλ, AᵀC) at (w, λ): one objective gradient and one
        constraint forward + two vjps."""
        return _vm(residuals1, rt, w, lam)

    def slacks(w):
        """Bound slacks floored at 1e-12: an exactly-active bound must read
        as a huge-but-finite barrier force, not as inf."""
        sl = torch.where(has_lb, torch.clamp(w - lb, min=1e-12), 1.0)
        su = torch.where(has_ub, torch.clamp(ub - w, min=1e-12), 1.0)
        return sl, su

    def barrier_value(w, rt, mu, strict=True):
        """φ_μ(w); _BIG outside the strict interior (raw slacks) unless
        ``strict=False`` (the current point, which may sit ON a bound)."""
        sl, su = slacks(w)
        logs = (torch.where(has_lb, torch.log(torch.clamp(sl, min=1e-30)),
                            0.0).sum(-1)
                + torch.where(has_ub, torch.log(torch.clamp(su, min=1e-30)),
                              0.0).sum(-1))
        val = _vm(obj1, rt, w) - mu * logs
        val = torch.where(torch.isfinite(val), val, _BIG)
        if not strict:
            return val
        ok = ((torch.where(has_lb, w - lb, 1.0) > 0).all(-1)
              & (torch.where(has_ub, ub - w, 1.0) > 0).all(-1))
        return torch.where(ok, val, _BIG)

    def theta_sum(c):
        """‖C‖₁ with non-finite values read as _BIG."""
        return torch.clamp(torch.nan_to_num(c.abs().sum(-1), nan=_BIG),
                           max=_BIG)

    def kkt_error(w, lam, zl, zu, g, ATlam, c, mu):
        sl, su = slacks(w)
        r_d = g + ATlam - zl + zu
        comp_l = torch.where(has_lb, zl * sl - _col(mu), 0.0)
        comp_u = torch.where(has_ub, zu * su - _col(mu), 0.0)
        s_max = 100.0
        z_sum = lam.abs().sum(-1) + zl.sum(-1) + zu.sum(-1)
        s_d = torch.clamp(z_sum / (m + n_bounds), min=s_max) / s_max
        s_c = torch.clamp((zl.sum(-1) + zu.sum(-1)) / n_bounds,
                          min=s_max) / s_max
        err = torch.maximum(
            r_d.abs().amax(-1) / s_d,
            torch.maximum(
                c.abs().amax(-1),
                torch.maximum(comp_l.abs().amax(-1),
                              comp_u.abs().amax(-1)) / s_c))
        return torch.where(torch.isfinite(err), err, _BIG)

    def init_state(rt, w0, lam0, zl0, zu0, mu0):
        # warm-carry hygiene: a non-finite carried entry is scrubbed to the
        # cold value instead of poisoning every later re-plan
        def scrub(v):
            return None if v is None else torch.nan_to_num(
                v, nan=0.0, posinf=0.0, neginf=0.0)
        w0, lam0, zl0, zu0 = scrub(w0), scrub(lam0), scrub(zl0), scrub(zu0)
        Bn = w0.shape[0]
        # interior push (Ipopt κ₁ rule); a tight two-sided box falls back
        # to its midpoint
        pl = torch.where(has_lb, lb + cfg.bound_push
                         * torch.clamp(lb.abs(), min=1.0), -torch.inf)
        pu = torch.where(has_ub, ub - cfg.bound_push
                         * torch.clamp(ub.abs(), min=1.0), torch.inf)
        both = has_lb & has_ub
        mid = torch.where(both, 0.5 * (lb + ub), 0.0)
        lo = torch.where(both, torch.minimum(pl, mid), pl)
        hi = torch.where(both, torch.maximum(pu, mid), pu)
        w = torch.clamp(w0.to(dtype), lo, hi)
        sl, su = slacks(w)
        if mu0 is None:
            mu = torch.full((Bn,), cfg.mu_init, dtype=dtype, device=w.device)
        else:
            mu = torch.clamp(mu0.to(dtype), cfg.tol / 10.0, cfg.mu_init)
        if cfg.warm_z_corridor > 0:
            kz = cfg.warm_z_corridor

            def recenter(z, s):
                return torch.clamp(z, _col(mu) / (kz * s), kz * _col(mu) / s)
        else:
            def recenter(z, s):
                return z
        if zl0 is None:
            zl = torch.where(has_lb, torch.clamp(_col(mu) / sl, 1e-6, 1e6),
                             0.0)
        else:
            zl = torch.where(has_lb, torch.clamp(
                recenter(zl0.to(dtype), sl), 1e-8, 1e8), 0.0)
        if zu0 is None:
            zu = torch.where(has_ub, torch.clamp(_col(mu) / su, 1e-6, 1e6),
                             0.0)
        else:
            zu = torch.where(has_ub, torch.clamp(
                recenter(zu0.to(dtype), su), 1e-8, 1e8), 0.0)
        lam = (torch.zeros((Bn, m), dtype=dtype, device=w.device)
               if lam0 is None else lam0.to(dtype))
        g, c, ATlam, ATc = residuals_at(w, lam, rt)
        err0 = kkt_error(w, lam, zl, zu, g, ATlam, c, 0.0)
        conv0 = err0 <= cfg.tol
        # zero blocks of the right structure: members that converge at init
        # never produce real ones (the polish rollback guard rejects their
        # sweep)
        blocks0 = (direction_fn.zero_blocks(Bn, w.device) if _carry_blocks
                   else ())
        zi = torch.zeros((Bn,), dtype=torch.int32, device=w.device)
        return IPState(w=w, lam=lam, zl=zl, zu=zu, mu=mu,
                       nu=torch.full((Bn,), cfg.nu_init, dtype=dtype,
                                     device=w.device),
                       it=zi, done=conv0, converged=conv0, kkt_error=err0,
                       th_best=torch.full((Bn,), torch.inf, dtype=dtype,
                                          device=w.device),
                       stall=zi, n_restore=zi,
                       g=g, c_res=c, ATlam=ATlam, ATc=ATc, err=err0,
                       err_best=err0, acc_stall=zi, blocks=blocks0)

    def ftb_tau(sl, su, d, tau_):
        """Largest α ≤ 1 keeping w + α·d a fraction tau_ inside its box."""
        a_l = torch.where(has_lb & (d < 0),
                          -_col(tau_) * sl / torch.where(d < 0, d, -1.0),
                          torch.inf)
        a_u = torch.where(has_ub & (d > 0),
                          _col(tau_) * su / torch.where(d > 0, d, 1.0),
                          torch.inf)
        return torch.clamp(torch.minimum(a_l.amin(-1), a_u.amin(-1)),
                           max=1.0)

    def dual_cap(z, dz, tau_):
        """Largest α ≤ 1 keeping z + α·dz a fraction tau_ above zero."""
        a = torch.where(dz < 0, -_col(tau_) * z / torch.where(dz < 0, dz,
                                                              -1.0),
                        torch.inf)
        return a.amin(-1)

    def iteration(state: IPState, rt) -> IPState:
        w, lam, zl, zu, mu, nu = (state.w, state.lam, state.zl, state.zu,
                                  state.mu, state.nu)
        sl, su = slacks(w)
        g, c, ATlam = state.g, state.c_res, state.ATlam

        # μ rule; every reduction runs over a member's own entries (dim
        # -1), never over the batch
        if cfg.mu_strategy == "adaptive":
            # LOQO centrality rule: μ = σ · the average complementarity,
            # σ set by how far the worst pair is off centre
            comp = (torch.where(has_lb, zl * sl, 0.0)
                    + torch.where(has_ub, zu * su, 0.0))
            avg = comp.sum(-1) / n_act
            min_c = torch.where(has_lb | has_ub, comp, torch.inf).amin(-1)
            xi = torch.clamp(min_c / torch.clamp(avg, min=1e-12), 1e-6, 1.0)
            sigma = 0.1 * torch.clamp(0.05 * (1.0 - xi) / xi, max=2.0) ** 3
            mu = torch.clamp(sigma * avg, cfg.tol / 10.0, cfg.mu_init)
        elif cfg.mu_strategy == "monotone":
            err_mu = kkt_error(w, lam, zl, zu, g, ATlam, c, mu)
            shrink = err_mu <= cfg.kappa_eps * mu
            mu = torch.where(
                shrink,
                torch.clamp(torch.minimum(cfg.kappa_mu * mu,
                                          mu ** cfg.theta_mu),
                            min=cfg.tol / 10.0),
                mu)
        # "mehrotra": μ comes from the predictor below

        # feasibility-restoration watchdog: no relative θ progress for
        # cfg.watchdog iterations while infeasible -> this iteration's
        # dual-gradient rhs is masked to zero (min-curvature step onto the
        # linearised constraints), accepted on pure θ descent
        th0 = theta_sum(c)
        slack = (cfg.theta_noise_per_row * float(max(m, 1))
                 * (1.0 + w.abs().amax(-1)))
        th_ok = th0 <= torch.clamp(slack, min=cfg.tol)
        if cfg.watchdog > 0:
            progress = th0 <= 0.95 * state.th_best
            restore = (state.stall >= cfg.watchdog) & ~th_ok
            stall_new = torch.where(progress | th_ok | restore, 0,
                                    state.stall + 1).to(torch.int32)
        else:
            restore = torch.zeros_like(th_ok)
            stall_new = state.stall
        th_best_new = torch.minimum(state.th_best, th0)

        # --- Newton direction on the condensed KKT system ---
        Sigma = (torch.where(has_lb, zl / sl, 0.0)
                 + torch.where(has_ub, zu / su, 0.0))
        blocks = _prepare(prep_fn, w, lam, rt)

        def resolve_kkt(r2, c2, retry=True):
            with tracing.span("kkt.solve"):
                return solve_blocks_fn(blocks, Sigma, r2, c2, retry=retry)

        # the barrier terms μ (less Mehrotra's second-order Δs∘Δz
        # corrections) over each bound's slack
        mu_l = mu_u = _col(mu)
        if cfg.mu_strategy == "mehrotra":
            # affine predictor: the same blocks, a μ = 0 right-hand side
            dw_a, _, ok_a = resolve_kkt(g + ATlam, c)
            dzl_a = torch.where(has_lb, -zl - (zl / sl) * dw_a, 0.0)
            dzu_a = torch.where(has_ub, (zu / su) * dw_a - zu, 0.0)
            a_p = _col(ftb_tau(sl, su, dw_a, 1.0))
            a_d = _col(torch.clamp(torch.minimum(dual_cap(zl, dzl_a, 1.0),
                                                 dual_cap(zu, dzu_a, 1.0)),
                                   max=1.0))
            comp_now = (torch.where(has_lb, sl * zl, 0.0)
                        + torch.where(has_ub, su * zu, 0.0))
            comp_aff = (torch.where(has_lb, (sl + a_p * dw_a)
                                    * (zl + a_d * dzl_a), 0.0)
                        + torch.where(has_ub, (su - a_p * dw_a)
                                      * (zu + a_d * dzu_a), 0.0))
            avg = comp_now.sum(-1) / n_bounds
            mu_aff = comp_aff.sum(-1) / n_bounds
            sigma = torch.clamp((mu_aff / torch.clamp(avg, min=1e-12)) ** 3,
                                0.0, 1.0)
            mu = torch.clamp(sigma * avg, cfg.tol / 10.0, cfg.mu_init)
            # the corrections apply where the predictor's solve succeeded
            mu_l = _col(mu) - torch.where(_col(ok_a), dw_a * dzl_a, 0.0)
            mu_u = _col(mu) - torch.where(_col(ok_a), -dw_a * dzu_a, 0.0)
        r_tilde = (g + ATlam - torch.where(has_lb, mu_l / sl, 0.0)
                   + torch.where(has_ub, mu_u / su, 0.0))
        r_tilde = torch.where(_col(restore), 0.0, r_tilde)
        dw, dlam, ok = resolve_kkt(r_tilde, c)
        # when even the top δ fails: scaled steepest descent on the barrier
        # merit (restoration members on ½‖C‖², via the carried −AᵀC)
        r_safe = torch.where(_col(restore), torch.nan_to_num(state.ATc),
                             torch.nan_to_num(r_tilde))
        dw_sd = -r_safe / (1.0 + r_safe.abs().amax(-1, keepdim=True))
        dw = torch.where(_col(ok), dw, dw_sd)
        dlam = torch.where(_col(ok), dlam, 0.0)
        # trust-region cap on restoration steps; restoration leaves the
        # equality duals untouched
        cap = 10.0 * (1.0 + w.abs().amax(-1))
        scale_r = torch.clamp(cap / torch.clamp(dw.abs().amax(-1),
                                                min=1e-30), max=1.0)
        dw = torch.where(_col(restore), dw * _col(scale_r), dw)
        dlam = torch.where(_col(restore), 0.0, dlam)

        dzl = torch.where(has_lb, mu_l / sl - zl - (zl / sl) * dw, 0.0)
        dzu = torch.where(has_ub, (zu / su) * dw - zu + mu_u / su, 0.0)

        # --- fraction-to-boundary step caps ---
        tau = torch.clamp(1.0 - mu, min=cfg.tau_min)
        alpha_pri_max = ftb_tau(sl, su, dw, tau)
        alpha_dual = torch.clamp(torch.minimum(dual_cap(zl, dzl, tau),
                                               dual_cap(zu, dzu, tau)),
                                 max=1.0)

        # --- merit line search on a fixed fan of step lengths ---
        with tracing.span("ip.line_search"):
            # penalty with decay toward the live multiplier estimate
            nu_target = 1.1 * (lam + dlam).abs().amax(-1) + 1.0
            nu = torch.clamp(torch.maximum(nu_target, 0.7 * nu), cfg.nu_init,
                             1e5)
            phi0 = barrier_value(w, rt, mu, strict=False)
            merit0 = phi0 + nu * th0
            grad_phi = (g - torch.where(has_lb, _col(mu) / sl, 0.0)
                        + torch.where(has_ub, _col(mu) / su, 0.0))
            D_phi = (grad_phi * dw).sum(-1)
            D = D_phi - nu * th0
            # f-type acceptance where θ is at its f32 noise floor
            ftype = (th0 <= slack) & (D_phi < 0)
            eps_m = 1.2e-6 * (1.0 + merit0.abs())
            eps_f = 1.2e-6 * (1.0 + phi0.abs())

            # Sequential backtracking with an embedded second-order correction
            # on pass 1.  Every member still searching sits at the same pass j;
            # a member that has taken its step is frozen.  bt counts a member's
            # failed plain backtracks; th1/c1 keep the pass-0 trial for the
            # SOC right-hand side α_max·c + c(w + α_max·dw).
            n_pass = cfg.ls_backtracks + (1 if cfg.soc else 0)
            Bn = w.shape[0]
            acc = torch.zeros((Bn,), dtype=torch.bool, device=w.device)
            bt = torch.zeros((Bn,), dtype=torch.int32, device=w.device)
            step_w = torch.zeros_like(w)
            step_lam = torch.zeros_like(lam)
            th1 = torch.zeros_like(th0)
            c1 = torch.zeros_like(c)
            for j in range(n_pass):
                if cfg.soc and j == 1:
                    # single δ=0 sweep with the same blocks
                    dw_s, dlam_s, ok_s = resolve_kkt(
                        r_tilde, _col(alpha_pri_max) * c + c1, retry=False)
                    use_soc = (th1 >= th0) & ok_s & ~restore
                else:
                    dw_s, dlam_s = dw, dlam
                    use_soc = torch.zeros_like(acc)
                a_plain = alpha_pri_max * cfg.ls_factor ** bt.to(dtype)
                a_j = torch.where(use_soc, ftb_tau(sl, su, dw_s, tau), a_plain)
                d_j = torch.where(_col(use_soc), dw_s, dw)
                dl_j = torch.where(_col(use_soc), dlam_s, dlam)
                w_t = w + _col(a_j) * d_j
                c_j = _vm(lambda ww, rt1: nlp.constraints(ww, rt1), rt, w_t)
                phi_j = barrier_value(w_t, rt, mu)
                th_j = theta_sum(c_j)
                m_j = phi_j + nu * th_j
                # SOC steps are judged against the α_max Armijo budget
                a_ref = torch.where(use_soc, alpha_pri_max, a_j)
                ok_std = (m_j <= merit0 + cfg.armijo_eta * a_ref
                          * torch.clamp(D, max=0.0) + eps_m)
                ok_f = (ftype & (th_j <= slack)
                        & (phi_j <= phi0 + cfg.armijo_eta * a_j * D_phi
                           + eps_f))
                ok_rest = th_j <= (1.0 - cfg.armijo_eta * a_ref) * th0
                ok_j = torch.where(restore, ok_rest, ok_std | ok_f)
                # last pass: take the smallest step if it is at least finite
                finite_j = (th_j < _BIG) & (phi_j < _BIG)
                take = ok_j | ((j == n_pass - 1) & finite_j)
                live = ~acc
                if j == 0:
                    th1, c1 = th_j, c_j
                bt = torch.where(live & ~(use_soc | ok_j), bt + 1, bt)
                step_w = torch.where(_col(live & take), _col(a_j) * d_j,
                                     step_w)
                step_lam = torch.where(_col(live & take), _col(a_j) * dl_j,
                                       step_lam)
                acc = acc | take
                if tracing.read_bool("sync.ls", acc.all()):
                    break

        w_new = w + step_w
        lam_new = lam + step_lam
        zl_new = zl + _col(alpha_dual) * dzl
        zu_new = zu + _col(alpha_dual) * dzu

        # clip to the bounds EXACTLY (the floored slacks price an
        # on-bound landing correctly)
        w_new = torch.clamp(w_new, bl, bu)

        # κΣ dual safeguard: keep z within a corridor of μ/slack
        sl_n, su_n = slacks(w_new)
        zl_new = torch.where(has_lb, torch.clamp(
            zl_new, _col(mu) / (cfg.kappa_sigma * sl_n),
            cfg.kappa_sigma * _col(mu) / sl_n), 0.0)
        zu_new = torch.where(has_ub, torch.clamp(
            zu_new, _col(mu) / (cfg.kappa_sigma * su_n),
            cfg.kappa_sigma * _col(mu) / su_n), 0.0)

        bad = ~torch.isfinite(w_new).all(-1) | ~torch.isfinite(lam_new).all(-1)
        w_new = torch.where(_col(bad), w, w_new)
        lam_new = torch.where(_col(bad), lam, lam_new)

        if cfg.debug:
            alpha = step_w.abs().amax(-1) / torch.clamp(dw.abs().amax(-1),
                                                        min=1e-30)
            _debug_lines(
                "it={it} mu={mu:.2e} err0={e:.2e} alpha={a:.2e} amax={am:.2e} "
                "adual={ad:.2e} ok={ok} D={D:.2e} th={th:.2e} nu={nu:.1e} "
                "|dw|={dw:.2e} obj={o:.4f}",
                it=state.it, mu=mu, e=state.err, a=alpha, am=alpha_pri_max,
                ad=alpha_dual, ok=ok, D=D, th=th0, nu=nu,
                dw=dw.abs().amax(-1), o=_vm(obj1, rt, w))

        # end-of-step residuals: the next iteration's carry and the
        # convergence check for the point just produced
        with tracing.span("ip.residuals"):
            g_n, c_n, ATlam_n, ATc_n = residuals_at(w_new, lam_new, rt)
            err_n = kkt_error(w_new, lam_new, zl_new, zu_new, g_n, ATlam_n,
                              c_n, 0.0)
        conv_n = err_n <= cfg.tol
        # acceptable-level exit: no relative err progress for
        # acceptable_iter iterations while at or below acceptable_tol
        if cfg.acceptable_tol > cfg.tol:
            err_progress = err_n <= 0.9 * state.err_best
            acc_stall_n = torch.where(err_progress | conv_n, 0,
                                      state.acc_stall + 1).to(torch.int32)
            conv_n = conv_n | ((err_n <= cfg.acceptable_tol)
                               & (acc_stall_n >= cfg.acceptable_iter))
        else:
            acc_stall_n = state.acc_stall
        err_best_n = torch.minimum(err_n, state.err_best)

        keep = state.done | (state.it >= cfg.max_iter)
        new = IPState(w=w_new, lam=lam_new, zl=zl_new, zu=zu_new, mu=mu,
                      nu=nu, it=state.it + 1,
                      done=state.done | conv_n,
                      converged=state.converged | conv_n,
                      kkt_error=torch.minimum(err_n, state.kkt_error),
                      th_best=th_best_new, stall=stall_new,
                      n_restore=state.n_restore + restore.to(torch.int32),
                      g=g_n, c_res=c_n, ATlam=ATlam_n, ATc=ATc_n,
                      err=err_n, err_best=err_best_n,
                      acc_stall=acc_stall_n,
                      blocks=blocks if _carry_blocks else ())
        return IPState(*[_select(keep, f, nn) for f, nn in zip(state, new)])

    def polish(state: IPState, rt) -> IPState:
        """Fixed extra centering at μ = polish_mu: strips the O(μ_floor)
        barrier bias from the converged point.  Each step is an rhs-only
        re-solve with the carried (one step stale) stage blocks, or with
        blocks derived at the converged point (``polish_fresh``), full steps
        under the fraction-to-boundary cap; a final rollback guard keeps
        the polished point only where the μ=0 KKT error did not degrade."""
        mu_p = cfg.polish_mu
        if _carry_blocks:
            blocks = state.blocks
        else:
            blocks = _prepare(prep_fn, state.w, state.lam, rt)
        tau = torch.full_like(state.mu, cfg.tau_min)
        # f32-representable slack floor: lb + 1e-10 rounds to lb in f32
        fl = torch.where(has_lb, lb + 2e-7 * torch.clamp(lb.abs(), min=1.0),
                         -torch.inf)
        fu = torch.where(has_ub, ub - 2e-7 * torch.clamp(ub.abs(), min=1.0),
                         torch.inf)
        lo, hi = torch.minimum(fl, fu), torch.maximum(fl, fu)
        w, lam, zl, zu = state.w, state.lam, state.zl, state.zu
        g, c, ATl = state.g, state.c_res, state.ATlam
        for _ in range(cfg.polish_iters):
            sl, su = slacks(w)
            bterm = (torch.where(has_lb, mu_p / sl, 0.0)
                     - torch.where(has_ub, mu_p / su, 0.0))
            Sig = (torch.where(has_lb, zl / sl, 0.0)
                   + torch.where(has_ub, zu / su, 0.0))
            with tracing.span("kkt.solve"):
                dw, dlam, okp = solve_blocks_fn(blocks, Sig, g + ATl - bterm,
                                                c, retry=False)
            dzl = torch.where(has_lb, mu_p / sl - zl - (zl / sl) * dw, 0.0)
            dzu = torch.where(has_ub, (zu / su) * dw - zu + mu_p / su, 0.0)
            a_p = ftb_tau(sl, su, dw, tau)
            a_d = torch.clamp(torch.minimum(dual_cap(zl, dzl, tau),
                                            dual_cap(zu, dzu, tau)), max=1.0)
            w2 = torch.clamp(w + _col(a_p) * dw, lo, hi)
            lam2 = lam + _col(a_p) * dlam
            zl2 = zl + _col(a_d) * dzl
            zu2 = zu + _col(a_d) * dzu
            sl2, su2 = slacks(w2)
            zl2 = torch.where(has_lb, torch.clamp(
                zl2, mu_p / (cfg.kappa_sigma * sl2),
                cfg.kappa_sigma * mu_p / sl2), 0.0)
            zu2 = torch.where(has_ub, torch.clamp(
                zu2, mu_p / (cfg.kappa_sigma * su2),
                cfg.kappa_sigma * mu_p / su2), 0.0)
            good = (okp & torch.isfinite(w2).all(-1)
                    & torch.isfinite(lam2).all(-1))
            g2, c2, ATl2, _ = residuals_at(w2, lam2, rt)
            bad = ~good
            w, lam, zl, zu, g, c, ATl = (
                _select(bad, old, new) for old, new in
                ((w, w2), (lam, lam2), (zl, zl2), (zu, zu2), (g, g2),
                 (c, c2), (ATl, ATl2)))
        err_post = kkt_error(w, lam, zl, zu, g, ATl, c, 0.0)
        take = err_post <= torch.clamp(state.err, min=cfg.tol)
        if cfg.debug:
            _debug_lines("polish: err_pre={a:.2e} err_post={b:.2e} take={t} "
                         "|dw_total|={d:.2e}", a=state.err, b=err_post,
                         t=take, d=(w - state.w).abs().amax(-1))
        # a rolled-back member keeps its pre-polish μ
        return state._replace(
            w=_select(take, w, state.w), lam=_select(take, lam, state.lam),
            zl=_select(take, zl, state.zl), zu=_select(take, zu, state.zu),
            mu=torch.where(take, torch.full_like(state.mu, mu_p), state.mu),
            c_res=_select(take, c, state.c_res),
            err=torch.where(take, err_post, state.err))

    def solve(rt, w0, lam0=None, zl0=None, zu0=None, mu0=None) -> IPResult:
        """Solve a batch of NLPs.  ``lam0/zl0/zu0/mu0`` warm-start the duals
        and barrier parameter.  Matmuls run in full f32 (TF32 off) for the
        whole solve, and the caller's setting comes back on exit."""
        tf32 = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            with tracing.span("ip.solve", device=w0.device):
                return _solve(rt, w0, lam0, zl0, zu0, mu0)
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = tf32

    def _solve(rt, w0, lam0, zl0, zu0, mu0):
        w0 = w0.to(dtype)
        rt = dict(rt)
        with tracing.span("ip.init"):
            if cfg.auto_scale:
                # Ipopt gradient-based objective scaling: J scaled so its
                # initial gradient has max magnitude <= scale_gmax
                g0 = _vm(lambda w, rt1: grad(nlp.objective)(w, rt1), rt, w0)
                rt["_s_obj"] = cfg.scale_gmax / torch.clamp(
                    g0.abs().amax(-1), min=cfg.scale_gmax)
            else:
                rt["_s_obj"] = torch.ones((w0.shape[0],), dtype=dtype,
                                          device=w0.device)
            state = init_state(rt, w0, lam0, zl0, zu0, mu0)
        # record: exactly max_iter iterations, no early exit (the members
        # that are done stay frozen), each iteration's values kept
        rec = []
        for _ in range(cfg.max_iter):
            live = ~state.done & (state.it < cfg.max_iter)
            if not (cfg.record or tracing.read_bool("sync.live",
                                                    live.any())):
                break
            with tracing.span("ip.iteration"):
                state = iteration(state, rt)
            if cfg.record:
                rec.append({"kkt_error": state.kkt_error, "mu": state.mu,
                            "objective": _vm(nlp.objective, rt, state.w),
                            "theta": theta_sum(state.c_res),
                            "done": state.done})
        zl_warm, zu_warm = state.zl, state.zu       # pre-polish duals
        if cfg.polish_iters > 0:
            with tracing.span("ip.polish"):
                state = polish(state, rt)
        err, c = state.err, state.c_res
        converged = state.converged | (err <= cfg.tol)
        theta_inf = c.abs().amax(-1)
        objective = _vm(nlp.objective, rt, state.w)
        result = IPResult(w=state.w, lam=state.lam, zl=state.zl,
                          zu=state.zu, mu=state.mu, converged=converged,
                          iterations=state.it,
                          kkt_error=torch.minimum(err, state.kkt_error),
                          objective=objective, theta=theta_inf,
                          feasible=theta_inf <= cfg.tol,
                          restorations=state.n_restore,
                          zl_warm=zl_warm, zu_warm=zu_warm)
        if not cfg.record:
            return result
        return result, {k: torch.stack([r[k] for r in rec], dim=1)
                        for k in rec[0]}

    return solve


def _debug_lines(fmt, **values):
    """``IPConfig(debug=True)``'s trace: one line a member, ``fmt``
    formatted with each member's entry of the (B,) ``values``."""
    cols = {k: v.detach().cpu().tolist() for k, v in values.items()}
    for i in range(len(next(iter(cols.values())))):
        print(fmt.format(**{k: v[i] for k, v in cols.items()}))
