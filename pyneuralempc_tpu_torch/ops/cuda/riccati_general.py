"""The general Riccati sweep: CUDA kernels, plain PyTorch versions, dispatch.

The general sweep extends the plain one (:mod:`.riccati_kernel`) two ways:

* **R right-hand sides.**  The linear terms mx, mu, c (and h) carry an rhs
  axis, while the factorisation (Quu's Cholesky, K, P) is computed once a
  stage.  The Riccati backend's trajectory-level border rows ride these
  extra right-hand sides.
* **r stage equality rows** ``E Δu = h − F Δx`` a stage, solved by a Schur
  complement S = E Quu⁻¹ Eᵀ + δ_c I on Quu's factor; their multipliers Δν
  come back beside Δx, Δu, Δλ, and ``Jx`` adds Jxᵀ Δν to Δλ.

Replaces ``pyneuralempc_tpu/ops/pallas/riccati_kernel.py``
``_riccati_general_pallas_call``'s three kernels, bodies
``_bwd_general_body`` (:610-787) and ``_fwd_general_body`` (:790-847):

* its resident branch (:890-970, ``pallas_call`` :953), both bodies in one
  program: ``csrc/riccati_general_fused.cu``, one thread per problem,
  backward then forward in one launch, instantiated for the (nx, nu, R, r)
  of ``riccati_kernel._GENERAL_INSTANCES`` (the LV stage (2, 1) with
  R <= 3, r <= 1).  Its staged kernel brings each block's inputs into
  shared memory with bulk copies and keeps the gains there; its direct
  kernel (the first design) reads every stage from device memory and
  takes the horizons at which not one problem fits in shared memory
  (``riccati_kernel.staged_block_problems``);
* its streamed pair, the backward kernel (:991) and the forward kernel
  (:1024): ``csrc/riccati_general.cu``, one warp per problem, any
  nx <= 32, nu <= 16, R <= 65, r <= nu at run time; every other general
  shape takes it.  The backward entry launches a compile-time instance of
  the backward kernel for the (nx, nu, R, r) in
  ``riccati_kernel._GENERAL_BACKWARD_INSTANCES`` (the EQ/border quadrotor
  fleet's (12, 4, 2, 1)) and the run-time kernel for every other shape;
  the forward entry likewise its compile-time instance, which streams each
  warp's stage inputs through a ring of stage slots in shared memory, for
  the shapes in ``riccati_kernel._GENERAL_FORWARD_INSTANCES`` (the same
  (12, 4, 2, 1)).

Beside them:

* :func:`riccati_general_backward_plain`,
  :func:`riccati_general_forward_plain` — the plain PyTorch versions of the
  two halves, a port of ``solve/riccati.py`` ``riccati_sweep_general_ref``
  with the per-stage ``_LOCAL_DELTAS`` retry on both Cholesky factors;
  :func:`riccati_sweep_general_plain` is their composition.  CPU tensors
  take them; ``chip_smoke.py`` holds the kernels against them on the card.
  Each call adds one to ``riccati_kernel.PLAIN_CALLS``.
* :func:`riccati_sweep_general_fused_cuda`,
  :func:`riccati_general_backward_cuda`, :func:`riccati_general_forward_cuda`,
  :func:`riccati_sweep_general_streamed_cuda` — check their inputs,
  allocate outputs (and a gains buffer where a kernel needs one or the
  caller asks for it), launch on PyTorch's current stream.
* :func:`riccati_general_backward_runtime_cuda` and
  :func:`riccati_general_forward_runtime_cuda` — the run-time backward
  and forward kernels at any shape, the instances' shape too, and
  :func:`riccati_sweep_general_fused_direct_cuda` — the fused direct
  kernel at any horizon, so that ``chip_smoke.py`` and the card tests can
  hold the two designs of each against each other.  The solver never
  calls them.
* :func:`riccati_sweep_general` — the dispatch the solver calls, on
  :func:`~.riccati_kernel.kernel_plan`.  A CUDA tensor takes its kernel
  wherever the plan names one; only a shape outside every general kernel's
  envelope runs the plain version on the card, as a CUDA graph replay (one
  warning a shape).  A kernel that fails to build or launch raises.

``FUSED_LAUNCHES`` counts the fused kernels' launches, of which
``FUSED_STAGED_LAUNCHES`` took the staged kernel and
``FUSED_DIRECT_LAUNCHES`` the direct one; ``BACKWARD_LAUNCHES`` and
``FORWARD_LAUNCHES`` count the pair's; ``BACKWARD_INSTANCE_LAUNCHES`` and
``FORWARD_INSTANCE_LAUNCHES`` count the launches of each that took the
compile-time instance, ``BACKWARD_RUNTIME_LAUNCHES`` and
``FORWARD_RUNTIME_LAUNCHES`` those of
:func:`riccati_general_backward_runtime_cuda` and
:func:`riccati_general_forward_runtime_cuda`.

Layouts are batch-first and stage-major, so a stage's R right-hand sides
are contiguous: A (B,H,nx,nx), B (B,H,nx,nu), G and M (B,H,ns,ns)
symmetric, mx and c (B,H,R,nx), mu (B,H,R,nu), delta and delta_c (B,),
E (B,H,r,nu), F and Jx (B,H,r,nx), h (B,H,R,r).  A sweep returns dX and
dLam (B,H,R,nx), dU (B,H,R,nu), dNu (B,H,R,r) and ok (B,).  The gains
between the halves (the fused kernels' too, when asked for) are
(B,H,gain_width(nx, nu, R, r)), each stage laid out
``[K (nu,nx) | k (R,nu) | Pbar (nx,nx) | pbar (R,nx) | Mxu (nx,nu) |
Knu (r,nx) | knu (R,r)]``, all row-major.
"""

from __future__ import annotations

import torch

from . import riccati_kernel as _rk
from .riccati_kernel import (GENERAL_FUSED_SOURCE, GENERAL_MAX_R,
                             GENERAL_SOURCE, STREAMED_MAX_NU,
                             STREAMED_MAX_NX, _GENERAL_BACKWARD_INSTANCES,
                             _GENERAL_FORWARD_INSTANCES, _GENERAL_INSTANCES,
                             _aligned_mask, _check, _chol_local_retry,
                             _entry, _general_fits, cho_solve, _stream, backward_bytes,
                             backward_flops, forward_bytes, forward_flops,
                             gain_width, kernel_plan, staged_block_problems,
                             sweep_bytes, sweep_flops)

__all__ = ["riccati_general_backward_plain", "riccati_general_forward_plain",
           "riccati_sweep_general_plain", "riccati_sweep_general_fused_cuda",
           "riccati_sweep_general_fused_direct_cuda", "staged_block_problems",
           "fused_phase_stamps",
           "riccati_general_backward_cuda",
           "riccati_general_backward_runtime_cuda",
           "riccati_general_forward_cuda",
           "riccati_general_forward_runtime_cuda",
           "riccati_sweep_general_streamed_cuda", "riccati_sweep_general",
           "general_fused_bytes", "general_fused_flops",
           "general_backward_bytes", "general_backward_flops",
           "general_forward_bytes", "general_forward_flops"]

FUSED_LAUNCHES = 0      # fused general launches
FUSED_STAGED_LAUNCHES = 0   # of them, the staged kernel's
FUSED_DIRECT_LAUNCHES = 0   # of them, the direct kernel's
BACKWARD_LAUNCHES = 0   # general backward launches
BACKWARD_INSTANCE_LAUNCHES = 0   # of them, the compile-time instance's
BACKWARD_RUNTIME_LAUNCHES = 0    # riccati_general_backward_runtime_cuda's
FORWARD_LAUNCHES = 0    # general forward launches
FORWARD_INSTANCE_LAUNCHES = 0    # of them, the compile-time instance's
FORWARD_RUNTIME_LAUNCHES = 0     # riccati_general_forward_runtime_cuda's


# ---- bytes and operations (the least the card must do) ----
# The plain kernels' counts with R and r: the fused kernel reads the
# backward kernel's inputs and Jx once and writes the forward kernel's
# outputs and an ok byte (its gains scratch never counts); the backward
# kernel reads A, B, the upper triangles of G and M, mx, mu, c, h, E, F once
# (and δ, δ_c) and writes the gains and an ok byte; the forward kernel reads
# A, B, c, Jx and the gains once and writes dX, dU, dLam, dNu.

general_fused_bytes = sweep_bytes
general_fused_flops = sweep_flops
general_backward_bytes = backward_bytes
general_backward_flops = backward_flops
general_forward_bytes = forward_bytes
general_forward_flops = forward_flops


# ---- plain PyTorch versions ----

def _backward(A, B, G, M, mx, mu, c, delta, delta_c, E, F, h):
    Bn, H, R, nx = c.shape
    nu = B.shape[-1]
    r = E.shape[-2]
    ns = nx + nu
    eye_u = torch.eye(nu, dtype=A.dtype, device=A.device)
    eye_r = torch.eye(r, dtype=A.dtype, device=A.device)
    Md = M + torch.diag_embed(delta.reshape(Bn, 1).expand(Bn, ns))[:, None]
    dc = delta_c.reshape(Bn, 1, 1)

    P = A.new_zeros((Bn, nx, nx))
    p = A.new_zeros((Bn, R, nx))
    okc = torch.ones((Bn,), dtype=torch.bool, device=A.device)
    gains = [None] * H
    for t in range(H - 1, -1, -1):
        A_t, B_t, G_t, M_t, c_t = A[:, t], B[:, t], G[:, t], Md[:, t], c[:, t]
        Mxx, Mxu, Muu = M_t[:, :nx, :nx], M_t[:, :nx, nx:], M_t[:, nx:, nx:]
        Pbar = P + Mxx
        pbar = p + mx[:, t]                              # (Bn, R, nx)
        PA = Pbar @ A_t
        PB = Pbar @ B_t
        Qxx = A_t.mT @ PA + G_t[:, :nx, :nx]
        BtMxu = B_t.mT @ Mxu
        Quu = B_t.mT @ PB + Muu + BtMxu + BtMxu.mT + G_t[:, nx:, nx:]
        Qux = B_t.mT @ PA + Mxu.mT @ A_t + G_t[:, nx:, :nx]
        Pc_p = c_t @ Pbar.mT + pbar                      # (Bn, R, nx)
        qx = Pc_p @ A_t                                  # (Bn, R, nx)
        qu = Pc_p @ B_t + c_t @ Mxu + mu[:, t]           # (Bn, R, nu)

        L, ok_t = _chol_local_retry(Quu, eye_u)
        K = -cho_solve(Qux, L)                           # (Bn, nu, nx)
        k = -cho_solve(qu.mT, L)                         # (Bn, nu, R)
        if r:
            # the stage QP's equality rows: Schur complement on Quu's factor
            E_t, F_t = E[:, t], F[:, t]
            Y = cho_solve(E_t.mT, L)                     # (Bn, nu, r)
            S = E_t @ Y + dc * eye_r
            Ls, ok_s = _chol_local_retry(0.5 * (S + S.mT), eye_r)
            Knu = cho_solve(E_t @ K + F_t, Ls)                       # (r, nx)
            knu = cho_solve(E_t @ k - h[:, t].mT, Ls)                # (r, R)
            K = K - Y @ Knu
            k = k - Y @ knu
            ok_t = ok_t & ok_s
        else:
            Knu = A.new_zeros((Bn, 0, nx))
            knu = A.new_zeros((Bn, 0, R))
        P_new = Qxx + Qux.mT @ K
        p_new = qx + k.mT @ Qux                          # (Bn, R, nx)
        if r:
            P_new = P_new + F_t.mT @ Knu
            p_new = p_new + knu.mT @ F_t
        P = 0.5 * (P_new + P_new.mT)
        p = p_new
        okc = okc & ok_t
        gains[t] = torch.cat([K.reshape(Bn, -1), k.mT.reshape(Bn, -1),
                              Pbar.reshape(Bn, -1), pbar.reshape(Bn, -1),
                              Mxu.reshape(Bn, -1), Knu.reshape(Bn, -1),
                              knu.mT.reshape(Bn, -1)], dim=-1)
    return torch.stack(gains, 1), okc


def _split_gains(g, nx, nu, R, r):
    """One stage's gains (Bn, width) -> K, k, Pbar, pbar, Mxu, Knu, knu."""
    Bn = g.shape[0]
    shapes = ((nu, nx), (R, nu), (nx, nx), (R, nx), (nx, nu), (r, nx),
              (R, r))
    out, o = [], 0
    for a, b in shapes:
        out.append(g[:, o:o + a * b].reshape(Bn, a, b))
        o += a * b
    return out


def _forward(A, B, c, Jx, gains):
    Bn, H, R, nx = c.shape
    nu = B.shape[-1]
    r = Jx.shape[-2]
    dx = A.new_zeros((Bn, R, nx))
    dXs, dUs, dLams, dNus = [], [], [], []
    for t in range(H):
        K, k, Pbar, pbar, Mxu, Knu, knu = _split_gains(gains[:, t], nx, nu,
                                                       R, r)
        du = dx @ K.mT + k                               # (Bn, R, nu)
        dnu = dx @ Knu.mT + knu                          # (Bn, R, r)
        dx = dx @ A[:, t].mT + du @ B[:, t].mT + c[:, t]
        dXs.append(dx)
        dUs.append(du)
        dNus.append(dnu)
        dLams.append(dx @ Pbar.mT + du @ Mxu.mT + pbar + dnu @ Jx[:, t])
    return (torch.stack(dXs, 1), torch.stack(dUs, 1), torch.stack(dLams, 1),
            torch.stack(dNus, 1))


def riccati_general_backward_plain(A, B, G, M, mx, mu, c, delta, delta_c, E,
                                   F, h):
    """Plain general backward sweep: a Python loop from the last stage to
    the first, each stage a batched small-matrix step.  Returns ``(gains,
    ok)``."""
    _rk.PLAIN_CALLS += 1
    return _backward(A, B, G, M, mx, mu, c, delta, delta_c, E, F, h)


def riccati_general_forward_plain(A, B, c, Jx, gains):
    """Plain general forward sweep from the backward sweep's gains, per
    right-hand side: du = K dx + k, dnu = Knu dx + knu, dx' = A dx + B du +
    c, dlam = Pbar dx' + Mxu du + pbar + Jxᵀ dnu.  Returns ``(dX, dU, dLam,
    dNu)``."""
    _rk.PLAIN_CALLS += 1
    return _forward(A, B, c, Jx, gains)


def _sweep(A, B, G, M, mx, mu, c, delta, delta_c, E, F, h, Jx):
    gains, ok = _backward(A, B, G, M, mx, mu, c, delta, delta_c, E, F, h)
    return _forward(A, B, c, Jx, gains) + (ok,)


def riccati_sweep_general_plain(A, B, G, M, mx, mu, c, delta, delta_c, E, F,
                                h, Jx):
    """Plain general sweep: :func:`riccati_general_backward_plain` then
    :func:`riccati_general_forward_plain`."""
    _rk.PLAIN_CALLS += 1
    return _sweep(A, B, G, M, mx, mu, c, delta, delta_c, E, F, h, Jx)


# ---- CUDA wrappers ----

def _dims(c, E):
    if c.dim() != 4:
        raise ValueError(f"c must be (B, H, R, nx), got {tuple(c.shape)}")
    if E.dim() != 4:
        raise ValueError(f"E must be (B, H, r, nu), got {tuple(E.shape)}")
    Bn, H, R, nx = c.shape
    return Bn, H, R, nx, E.shape[-1], E.shape[-2]


def _require(Bn, H, nx, nu, R, r):
    if Bn == 0 or H == 0:
        raise ValueError("the CUDA sweeps need B >= 1 and H >= 1")
    if not _general_fits(nx, nu, R, r):
        raise NotImplementedError(
            f"csrc/{GENERAL_SOURCE} takes nx <= {STREAMED_MAX_NX}, nu <= "
            f"{STREAMED_MAX_NU}, 1 <= R <= {GENERAL_MAX_R}, r <= nu, not "
            f"nx={nx}, nu={nu}, R={R}, r={r}")


def _raise_on(err, what, Bn, H, nx, nu, R, r):
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err} "
                           f"(B={Bn}, H={H}, nx={nx}, nu={nu}, R={R}, r={r})")


def _backward_launch(entry, A, B, G, M, mx, mu, c, delta, delta_c, E, F,
                     h):
    Bn, H, R, nx, nu, r = _dims(c, E)
    ns = nx + nu
    _check(c.device, {
        "A": (A, (Bn, H, nx, nx)), "B": (B, (Bn, H, nx, nu)),
        "G": (G, (Bn, H, ns, ns)), "M": (M, (Bn, H, ns, ns)),
        "mx": (mx, (Bn, H, R, nx)), "mu": (mu, (Bn, H, R, nu)),
        "c": (c, (Bn, H, R, nx)), "delta": (delta, (Bn,)),
        "delta_c": (delta_c, (Bn,)), "E": (E, (Bn, H, r, nu)),
        "F": (F, (Bn, H, r, nx)), "h": (h, (Bn, H, R, r))})
    _require(Bn, H, nx, nu, R, r)
    fn = _entry(GENERAL_SOURCE, entry, 14, 7)
    dev = c.device
    gains = torch.empty((Bn, H, gain_width(nx, nu, R, r)),
                        dtype=torch.float32, device=dev)
    ok = torch.empty((Bn,), dtype=torch.bool, device=dev)
    err = fn(A.data_ptr(), B.data_ptr(), G.data_ptr(), M.data_ptr(),
             mx.data_ptr(), mu.data_ptr(), c.data_ptr(), delta.data_ptr(),
             delta_c.data_ptr(), E.data_ptr(), F.data_ptr(), h.data_ptr(),
             gains.data_ptr(), ok.data_ptr(), Bn, H, nx, nu, R, r,
             dev.index or 0, _stream(dev))
    _raise_on(err, entry, Bn, H, nx, nu, R, r)
    return gains, ok, (nx, nu, R, r)


def riccati_general_backward_cuda(A, B, G, M, mx, mu, c, delta, delta_c, E,
                                  F, h):
    """Launch the general backward kernel of ``csrc/riccati_general.cu`` on
    CUDA tensors (no fallback): the compile-time instance at the shapes of
    ``_GENERAL_BACKWARD_INSTANCES``, the run-time kernel at any other.
    Returns ``(gains, ok)`` as :func:`riccati_general_backward_plain` does.

    Raises on a tensor that is not float32, not contiguous, not on one CUDA
    device or of the wrong shape, and on dims outside the kernel's range.
    """
    global BACKWARD_LAUNCHES, BACKWARD_INSTANCE_LAUNCHES
    gains, ok, shape = _backward_launch(
        "riccati_general_backward_f32", A, B, G, M, mx, mu, c, delta,
        delta_c, E, F, h)
    BACKWARD_LAUNCHES += 1
    if shape in _GENERAL_BACKWARD_INSTANCES:
        BACKWARD_INSTANCE_LAUNCHES += 1
    return gains, ok


def riccati_general_backward_runtime_cuda(A, B, G, M, mx, mu, c, delta,
                                          delta_c, E, F, h):
    """:func:`riccati_general_backward_cuda` with the run-time backward
    kernel at every shape.  Not on the solver's path: it lets one run hold
    the instance against the run-time kernel and time both."""
    global BACKWARD_RUNTIME_LAUNCHES
    gains, ok, _ = _backward_launch(
        "riccati_general_backward_runtime_f32", A, B, G, M, mx, mu, c,
        delta, delta_c, E, F, h)
    BACKWARD_RUNTIME_LAUNCHES += 1
    return gains, ok


def _forward_launch(entry, A, B, c, Jx, gains):
    if Jx.dim() != 4:
        raise ValueError(f"Jx must be (B, H, r, nx), got {tuple(Jx.shape)}")
    if c.dim() != 4:
        raise ValueError(f"c must be (B, H, R, nx), got {tuple(c.shape)}")
    Bn, H, R, nx = c.shape
    nu, r = B.shape[-1], Jx.shape[-2]
    _check(c.device, {
        "A": (A, (Bn, H, nx, nx)), "B": (B, (Bn, H, nx, nu)),
        "c": (c, (Bn, H, R, nx)), "Jx": (Jx, (Bn, H, r, nx)),
        "gains": (gains, (Bn, H, gain_width(nx, nu, R, r)))})
    _require(Bn, H, nx, nu, R, r)
    fn = _entry(GENERAL_SOURCE, entry, 9, 7)
    dev = c.device
    dX = torch.empty((Bn, H, R, nx), dtype=torch.float32, device=dev)
    dU = torch.empty((Bn, H, R, nu), dtype=torch.float32, device=dev)
    dLam = torch.empty((Bn, H, R, nx), dtype=torch.float32, device=dev)
    dNu = torch.empty((Bn, H, R, r), dtype=torch.float32, device=dev)
    err = fn(A.data_ptr(), B.data_ptr(), c.data_ptr(), Jx.data_ptr(),
             gains.data_ptr(), dX.data_ptr(), dU.data_ptr(), dLam.data_ptr(),
             dNu.data_ptr(), Bn, H, nx, nu, R, r, dev.index or 0,
             _stream(dev))
    _raise_on(err, entry, Bn, H, nx, nu, R, r)
    return (dX, dU, dLam, dNu), (nx, nu, R, r)


def riccati_general_forward_cuda(A, B, c, Jx, gains):
    """Launch the general forward kernel of ``csrc/riccati_general.cu`` on
    CUDA tensors (no fallback): the compile-time instance at the shapes of
    ``_GENERAL_FORWARD_INSTANCES``, the run-time kernel at any other.
    Returns ``(dX, dU, dLam, dNu)`` as :func:`riccati_general_forward_plain`
    does.  Inputs that do not start on a 16-byte boundary are copied in
    narrower pieces, never refused."""
    global FORWARD_LAUNCHES, FORWARD_INSTANCE_LAUNCHES
    out, shape = _forward_launch("riccati_general_forward_f32", A, B, c, Jx,
                                 gains)
    FORWARD_LAUNCHES += 1
    if shape in _GENERAL_FORWARD_INSTANCES:
        FORWARD_INSTANCE_LAUNCHES += 1
    return out


def riccati_general_forward_runtime_cuda(A, B, c, Jx, gains):
    """:func:`riccati_general_forward_cuda` with the run-time forward kernel
    at every shape.  Not on the solver's path: it lets one run hold the
    instance against the run-time kernel and time both."""
    global FORWARD_RUNTIME_LAUNCHES
    out, _ = _forward_launch("riccati_general_forward_runtime_f32", A, B, c,
                             Jx, gains)
    FORWARD_RUNTIME_LAUNCHES += 1
    return out


def riccati_sweep_general_streamed_cuda(A, B, G, M, mx, mu, c, delta,
                                        delta_c, E, F, h, Jx):
    """The general sweep on CUDA tensors: the backward kernel writes one
    gains buffer (allocated once per call), the forward kernel reads it;
    both launch on PyTorch's current stream."""
    gains, ok = riccati_general_backward_cuda(A, B, G, M, mx, mu, c, delta,
                                              delta_c, E, F, h)
    return riccati_general_forward_cuda(A, B, c, Jx, gains) + (ok,)


def _require_fused(Bn, H, nx, nu, R, r):
    if (nx, nu, R, r) not in _GENERAL_INSTANCES:
        raise NotImplementedError(
            f"csrc/{GENERAL_FUSED_SOURCE} instantiates (nx, nu, R, r) in "
            f"{sorted(_GENERAL_INSTANCES)} only, not nx={nx}, nu={nu}, R={R},"
            f" r={r}; riccati_sweep_general_streamed_cuda takes it")
    if Bn == 0 or H == 0:
        raise ValueError("the CUDA sweeps need B >= 1 and H >= 1")


def _fused_launch(direct, args, return_gains, stamps=None):
    global FUSED_LAUNCHES, FUSED_STAGED_LAUNCHES, FUSED_DIRECT_LAUNCHES
    A, B, G, M, mx, mu, c, delta, delta_c, E, F, h, Jx = args
    Bn, H, R, nx, nu, r = _dims(c, E)
    _require_fused(Bn, H, nx, nu, R, r)
    ns = nx + nu
    _check(c.device, {
        "A": (A, (Bn, H, nx, nx)), "B": (B, (Bn, H, nx, nu)),
        "G": (G, (Bn, H, ns, ns)), "M": (M, (Bn, H, ns, ns)),
        "mx": (mx, (Bn, H, R, nx)), "mu": (mu, (Bn, H, R, nu)),
        "c": (c, (Bn, H, R, nx)), "delta": (delta, (Bn,)),
        "delta_c": (delta_c, (Bn,)), "E": (E, (Bn, H, r, nu)),
        "F": (F, (Bn, H, r, nx)), "h": (h, (Bn, H, R, r)),
        "Jx": (Jx, (Bn, H, r, nx))})
    staged = not direct and staged_block_problems(H, nx, nu, R, r) > 0
    dev = c.device
    dX = torch.empty((Bn, H, R, nx), dtype=torch.float32, device=dev)
    dU = torch.empty((Bn, H, R, nu), dtype=torch.float32, device=dev)
    dLam = torch.empty((Bn, H, R, nx), dtype=torch.float32, device=dev)
    dNu = torch.empty((Bn, H, R, r), dtype=torch.float32, device=dev)
    ok = torch.empty((Bn,), dtype=torch.bool, device=dev)
    gains = (torch.empty((Bn, H, gain_width(nx, nu, R, r)),
                         dtype=torch.float32, device=dev)
             if return_gains or not staged else None)
    ptrs = [t.data_ptr() for t in args] + [
        dX.data_ptr(), dU.data_ptr(), dLam.data_ptr(), dNu.data_ptr(),
        ok.data_ptr(), None if gains is None else gains.data_ptr()]
    dims = [Bn, H, nx, nu, R, r]
    if direct:
        entry = "riccati_general_fused_direct_f32"
        err = _entry(GENERAL_FUSED_SOURCE, entry, 19, 7)(
            *ptrs, *dims, dev.index or 0, _stream(dev))
    else:
        entry = "riccati_general_fused_f32"
        err = _entry(GENERAL_FUSED_SOURCE, entry, 20, 8)(
            *ptrs, None if stamps is None else stamps.data_ptr(), *dims,
            _aligned_mask(args), dev.index or 0, _stream(dev))
    _raise_on(err, entry, Bn, H, nx, nu, R, r)
    FUSED_LAUNCHES += 1
    if staged:
        FUSED_STAGED_LAUNCHES += 1
    else:
        FUSED_DIRECT_LAUNCHES += 1
    out = (dX, dU, dLam, dNu, ok)
    return out + (gains,) if return_gains else out


def riccati_sweep_general_fused_cuda(A, B, G, M, mx, mu, c, delta, delta_c,
                                     E, F, h, Jx, return_gains=False):
    """Launch the fused ``csrc/riccati_general_fused.cu`` on CUDA tensors (no
    fallback): its staged kernel where a block holds at least one problem
    at this horizon (``kernel_plan``'s ``"kernel"``), its direct kernel
    where none fits.  Returns ``(dX, dU, dLam, dNu, ok)`` as
    :func:`riccati_sweep_general_plain` does, and the gains after them when
    ``return_gains`` (the layout of :func:`riccati_general_backward_plain`'s
    gains); the staged kernel keeps its gains in shared memory and writes
    that buffer only then.  Inputs that do not start on a 16-byte boundary
    are copied 4 bytes at a time, never refused.

    Raises on an (nx, nu, R, r) the source does not instantiate, and on a
    tensor that is not float32, not contiguous, not on one CUDA device or
    of the wrong shape.
    """
    return _fused_launch(False, (A, B, G, M, mx, mu, c, delta, delta_c, E,
                                 F, h, Jx), return_gains)


def fused_phase_stamps(A, B, G, M, mx, mu, c, delta, delta_c, E, F, h, Jx):
    """Launch the staged kernel with its phase stamps on: for each block,
    (SM cycles, device ns) at its start and after its prologue, backward
    pass, forward pass and epilogue, as an int64 tensor (blocks, 5, 2).
    Not on the solver's path: ``chip_smoke.py`` splits the kernel's time
    with it.  Raises where the shape takes the direct kernel."""
    Bn, H, R, nx, nu, r = _dims(c, E)
    P = staged_block_problems(H, nx, nu, R, r)
    if P == 0:
        raise ValueError(f"H={H} takes the direct kernel, which has no "
                         "phase stamps")
    stamps = torch.zeros(((Bn + P - 1) // P, 5, 2), dtype=torch.int64,
                         device=c.device)
    _fused_launch(False, (A, B, G, M, mx, mu, c, delta, delta_c, E, F, h, Jx),
                  False, stamps)
    return stamps


def riccati_sweep_general_fused_direct_cuda(A, B, G, M, mx, mu, c, delta,
                                            delta_c, E, F, h, Jx,
                                            return_gains=False):
    """:func:`riccati_sweep_general_fused_cuda` with the direct kernel (the
    first design: every stage from device memory, the gains in a device
    scratch) at every horizon.  Not on the solver's path: it lets one run
    hold the two designs against each other and time both."""
    return _fused_launch(True, (A, B, G, M, mx, mu, c, delta, delta_c, E,
                                F, h, Jx), return_gains)


def _no_equality_rows(A, B, c):
    """E, F, h, Jx of a sweep with no stage equality rows: (B, H, 0, nu),
    (B, H, 0, nx), (B, H, R, 0), (B, H, 0, nx)."""
    Bn, H, R, nx = c.shape
    nu = B.shape[-1]
    return (A.new_zeros((Bn, H, 0, nu)), A.new_zeros((Bn, H, 0, nx)),
            A.new_zeros((Bn, H, R, 0)), A.new_zeros((Bn, H, 0, nx)))


def riccati_sweep_general(A, B, G, M, mx, mu, c, delta, delta_c=1e-8,
                          E=None, F=None, h=None, Jx=None):
    """Dispatch on :func:`~.riccati_kernel.kernel_plan`: CPU -> the plain
    version; CUDA -> the fused general kernel for the shapes it
    instantiates, the general pair for every other in its envelope (which
    takes (R, r) = (1, 0) too), and outside it (nx > 32, nu > 16, R > 65,
    r > nu) the plain version on the card as a CUDA graph replay
    (``riccati_kernel.replay``), counted in
    ``riccati_kernel.FALLBACK_CALLS`` with one warning a shape; anything
    else raises.

    The JAX package's defaults: ``delta_c`` 1e-8 (a float or a (B,)
    tensor), and ``E=None`` for no stage equality rows (r = 0; F, h and Jx
    are then ignored and built empty).  R, the right-hand sides, is c's
    third axis: 1 where there is no border."""
    if E is None or E.shape[-2] == 0:
        E, F, h, Jx = _no_equality_rows(A, B, c)
    if not isinstance(delta_c, torch.Tensor) or delta_c.dim() == 0:
        delta_c = torch.full_like(delta, float(delta_c))
    Bn, H, R, nx, nu, r = _dims(c, E)
    path = kernel_plan(H, nx, nu, c.device, R=R, r=r)
    args = (A, B, G, M, mx, mu, c, delta, delta_c, E, F, h, Jx)
    if path["path"] == "plain_fallback":
        return _rk.fallback("general", path, _sweep, args,
                            (Bn, H, nx, nu, R, r))
    if path["path"] == "plain":
        return riccati_sweep_general_plain(*args)
    if path["path"] == "cuda_fused_general":
        return riccati_sweep_general_fused_cuda(*args)
    if path["path"] == "unsupported":
        raise NotImplementedError(path["reason"])
    return riccati_sweep_general_streamed_cuda(*args)
