"""Parallel-in-time Riccati sweep: an associative-scan formulation, O(log H)
sequential depth.

PyTorch counterpart of ``pyneuralempc_tpu/solve/pscan.py``, its
matrix-last form, written batch-first: every tensor carries a leading
batch axis, and the scans run along the horizon axis (dim 1).

Backward pass.  The one-stage value-function map

    T_e : (P, p) ->  ( J + Aᵀ P (I + C P)⁻¹ A,
                       η + Aᵀ (I + P C)⁻¹ (p + P b) )

is a linear-fractional transformation with element e = (A, b, C, η, J),
and these maps are closed under composition (e₁ earlier in time):

    A₁₂ = A₂ Γ A₁                Γ  = (I + C₁ J₂)⁻¹
    b₁₂ = A₂ Γ (b₁ − C₁ η₂) + b₂
    C₁₂ = A₂ Γ C₁ A₂ᵀ + C₂
    η₁₂ = η₁ + A₁ᵀ Γ̃ (η₂ + J₂ b₁)   Γ̃ = (I + J₂ C₁)⁻¹
    J₁₂ = J₁ + A₁ᵀ Γ̃ J₂ A₁

A reverse associative scan of the stage elements gives every value
function (P_t, p_t).  The stage data (cost on (x_{t+1}, u_t) plus defect
curvature on (x_t, u_t)) is first rewritten as canonical LQT data with cost
on (x_t, u_t), and the control cross term eliminated by u = v − Û⁻¹(Ŝx +
û), giving the elements e_t = (Ā, c̄, B Û⁻¹Bᵀ, x̄, X̄).

Forward pass.  With every (P_{t+1}, p_{t+1}) known, the gains K_t, k_t come
stage-parallel, and the closed-loop rollout Δx_{t+1} = (A+BK)Δx_t + (Bk + c)
is a composition of affine maps: a second associative scan.

Failure semantics.  JAX's ``cholesky`` and ``solve`` return NaN on a
matrix that is not positive definite or is singular, where PyTorch's raise
(and sync the host); so the factorisations here are ``cholesky_ex`` and
``solve_ex``, and a failed one is set to NaN as JAX's is.  The stronger
stage-wise condition Û ≻ 0 (against the sequential sweep's Quu ≻ 0) joins
``ok`` with the finiteness of the result, so the solver's δ ladder
regularises exactly as it does for the sequential sweep.

The JAX package's time-last form (packed (rows, H) leaves that the TPU's
tiles pad nothing of) is TPU tile arithmetic and is not ported.

All of it is PyTorch ops (batched matmuls, ``torch.linalg``), as the JAX
package's are XLA ops outside any Pallas kernel.
"""

from __future__ import annotations

import torch

from ..ops.scan import associative_scan

__all__ = ["riccati_sweep_pscan", "compose", "canonical_elems", "gains",
           "affine_compose", "with_delta"]


def _mv(M, v):
    return (M @ v.unsqueeze(-1)).squeeze(-1)


def _chol(Q):
    """Cholesky factor of the symmetrised Q (``jnp.linalg.cholesky``
    symmetrises its input); NaN where the factorisation fails.  Returns
    (L, ok) with ok over the leading dims."""
    L, info = torch.linalg.cholesky_ex(0.5 * (Q + Q.mT))
    ok = (info == 0) & torch.isfinite(L).all(dim=(-2, -1))
    return torch.where(ok[..., None, None], L, torch.nan), ok


def _solve(Q, R):
    """Q⁻¹R by one LU; NaN where Q is singular."""
    X, info = torch.linalg.solve_ex(Q, R)
    return torch.where((info == 0)[..., None, None], X, torch.nan)


def with_delta(M, delta):
    """M + δ I on every stage, δ (B,) per problem."""
    Bn, _, ns, _ = M.shape
    return M + torch.diag_embed(delta.reshape(Bn, 1).expand(Bn, ns))[:, None]


def canonical_elems(A, B, G, M, mx, mu, c, delta):
    """Canonical LQT stage data and the cross-eliminated value-map
    elements.  Returns ``(elems, (Uh, Sh, uh), ok)``: elems = (Ā, c̄, C, x̄,
    X̄), each (B, H, ...); ok (B,).  Shared by the single-device sweep and
    the horizon-sharded one (:mod:`..parallel.horizon`)."""
    nx = c.shape[-1]
    Md = with_delta(M, delta)
    Mxx, Mxu, Muu = Md[..., :nx, :nx], Md[..., :nx, nx:], Md[..., nx:, nx:]
    Gxx, Gux, Guu = G[..., :nx, :nx], G[..., nx:, :nx], G[..., nx:, nx:]

    # ---- canonical LQT stage data (cost on (x_t, u_t)) ----
    AtM = A.mT @ Mxx
    Xh = Gxx + AtM @ A
    BtM = B.mT @ Mxx
    BtMxu = B.mT @ Mxu
    Uh = Muu + BtMxu + BtMxu.mT + Guu + BtM @ B
    Sh = Gux + Mxu.mT @ A + BtM @ A
    Mc_mx = _mv(Mxx, c) + mx
    xh = _mv(A.mT, Mc_mx)
    uh = _mv(B.mT, Mc_mx) + _mv(Mxu.mT, c) + mu

    # ---- eliminate the control cross term: u = v − Û⁻¹(Ŝ x + û) ----
    L, ok = _chol(Uh)
    sol = torch.cholesky_solve(torch.cat([Sh, uh.unsqueeze(-1), B.mT], -1),
                               L)
    UinvS, Uinvu, UinvBt = sol[..., :nx], sol[..., nx], sol[..., nx + 1:]
    Abar = A - B @ UinvS
    cbar = c - _mv(B, Uinvu)
    Cmat = B @ UinvBt
    Xbar = Xh - Sh.mT @ UinvS
    xbar = xh - _mv(Sh.mT, Uinvu)
    return (Abar, cbar, Cmat, xbar, Xbar), (Uh, Sh, uh), ok.all(dim=1)


def gains(Uh, Sh, uh, A, B, c, Pn, pn):
    """Stage gains given the next-state value (P_{t+1}, p_{t+1}): K, k and
    ok over the leading dims but the stage."""
    Quu = Uh + B.mT @ Pn @ B
    Qux = Sh + B.mT @ Pn @ A
    qu = uh + _mv(B.mT, _mv(Pn, c) + pn)
    L, ok = _chol(Quu)
    sol = torch.cholesky_solve(torch.cat([Qux, qu.unsqueeze(-1)], -1), L)
    return -sol[..., :-1], -sol[..., -1], ok.all(dim=-1)


def compose(e1, e2):
    """Compose two value-map elements, e1 earlier in time."""
    A1, b1, C1, n1, J1 = e1
    A2, b2, C2, n2, J2 = e2
    nx = A1.shape[-1]
    eye = torch.eye(nx, dtype=A1.dtype, device=A1.device)
    # Γ = (I + C1 J2)⁻¹ and Γ̃ = (I + J2 C1)⁻¹, each one LU for all its
    # right-hand sides
    G1 = _solve(eye + C1 @ J2, torch.cat(
        [A1, (b1 - _mv(C1, n2)).unsqueeze(-1), C1], -1))
    GA1, Gb, GC1 = G1[..., :nx], G1[..., nx], G1[..., nx + 1:]
    G2 = _solve(eye + J2 @ C1, torch.cat(
        [(n2 + _mv(J2, b1)).unsqueeze(-1), J2], -1))
    Gn, GJ2 = G2[..., 0], G2[..., 1:]
    return (A2 @ GA1,
            _mv(A2, Gb) + b2,
            A2 @ GC1 @ A2.mT + C2,
            n1 + _mv(A1.mT, Gn),
            J1 + A1.mT @ GJ2 @ A1)


def affine_compose(m1, m2):
    """Compose two affine maps x -> F x + v, m1 applied first."""
    F1, v1 = m1
    F2, v2 = m2
    return F2 @ F1, _mv(F2, v1) + v2


def riccati_sweep_pscan(A, B, G, M, mx, mu, c, delta):
    """The Riccati sweep with O(log H) sequential depth: the contract of
    :func:`..ops.cuda.riccati_kernel.riccati_sweep`.  Inputs (B, H, ...)
    and δ (B,) per problem; returns (dX, dU, dLam, ok (B,)).  G and M are
    read whole (the kernels read their upper triangles), so they must be
    symmetric."""
    Bn, H, nx = c.shape
    Md = with_delta(M, delta)
    Mxx, Mxu = Md[..., :nx, :nx], Md[..., :nx, nx:]

    elems, (Uh, Sh, uh), ok = canonical_elems(A, B, G, M, mx, mu, c, delta)

    # ---- backward associative scan over value-map elements ----
    # reverse=True calls fn(a, b) with a at the HIGHER index; compose takes
    # (earlier, later)
    suffix = associative_scan(lambda a, b: compose(b, a), elems, dim=1,
                              reverse=True)
    P_all, p_all = suffix[4], suffix[3]      # P_t, p_t for t = 0..H-1
    # value at x_{t+1}: shift left, terminal (P_H, p_H) = 0
    P_next = torch.cat([P_all[:, 1:], P_all.new_zeros((Bn, 1, nx, nx))], 1)
    p_next = torch.cat([p_all[:, 1:], p_all.new_zeros((Bn, 1, nx))], 1)

    # ---- stage-parallel gains from the original (with-cross) data ----
    K, k, ok_g = gains(Uh, Sh, uh, A, B, c, P_next, p_next)

    # ---- forward associative scan of affine closed-loop maps ----
    _, dX = associative_scan(affine_compose, (A + B @ K, _mv(B, k) + c),
                             dim=1)
    dx_prev = torch.cat([dX.new_zeros((Bn, 1, nx)), dX[:, :-1]], 1)
    dU = _mv(K, dx_prev) + k
    # multipliers: λ̂_t = (P_{t+1}+Mxx)Δx_{t+1} + MxuΔu_t + p_{t+1} + mx_t
    dLam = _mv(P_next + Mxx, dX) + _mv(Mxu, dU) + p_next + mx
    ok = (ok & ok_g & torch.isfinite(dX).all(dim=(1, 2))
          & torch.isfinite(dU).all(dim=(1, 2)))
    return dX, dU, dLam, ok
