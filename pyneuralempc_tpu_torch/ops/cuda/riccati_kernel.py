"""The fused plain Riccati sweep: CUDA kernel, plain PyTorch version,
dispatch.

Replaces ``pyneuralempc_tpu/ops/pallas/riccati_kernel.py``
``_riccati_pallas_call``'s fused branch (:419-465), the one TPU kernel on the
LV fleet's main path.  The kernel is ``csrc/riccati_sweep.cu`` (one thread
per problem, backward then forward in one launch; see the note at the top
of that file for what bounds it).

* :func:`riccati_sweep_plain` — the plain PyTorch version, batch-first,
  a port of ``solve/riccati.py`` ``riccati_sweep_ref`` with the per-stage
  ``_LOCAL_DELTAS`` retry.  CPU tensors take it; ``chip_smoke.py`` holds
  the kernel against it on the card.
* :func:`riccati_sweep_cuda` — checks its inputs, allocates outputs and
  scratch, launches the kernel on PyTorch's current stream.
* :func:`riccati_sweep` — the dispatch the solver calls: CPU tensors go to
  the plain version, CUDA tensors to the kernel when :func:`kernel_plan`
  has an instantiation for their shape, and anything else raises.  It
  never drops a CUDA tensor to the plain version.

``LAUNCHES`` counts kernel launches and ``PLAIN_CALLS`` calls of the plain
version, so a run can show which path it took.

All functions take batch-first tensors: A (B,H,nx,nx), B (B,H,nx,nu),
G and M (B,H,ns,ns) symmetric, mx (B,H,nx), mu (B,H,nu), c (B,H,nx),
delta (B,); they return dX (B,H,nx), dU (B,H,nu), dLam (B,H,nx), ok (B,).
"""

from __future__ import annotations

import ctypes

import torch

# Local (per-stage, per-problem) regularisation bumps on Quu's diagonal,
# capped at nudge scale: genuine indefiniteness must report ok=False so the
# solver's global-δ ladder convexifies the whole horizon.
_LOCAL_DELTAS = (0.0, 1e-6, 1e-4)

# (nx, nu) pairs that csrc/riccati_sweep.cu instantiates.
_INSTANCES = frozenset({(2, 1)})

LAUNCHES = 0      # kernel launches by riccati_sweep_cuda
PLAIN_CALLS = 0   # calls of riccati_sweep_plain

SOURCE = "riccati_sweep.cu"


def gain_width(nx: int, nu: int) -> int:
    """Floats of per-stage scratch: K, k, Pbar, pbar, Mxu."""
    return nu * nx + nu + nx * nx + nx + nx * nu


def kernel_plan(H: int, nx: int, nu: int, device) -> dict:
    """Which sweep a problem of these dims takes on ``device``, and why.

    A pure function of (H, nx, nu, device type): ``{"path": "plain" |
    "cuda" | "unsupported", "reason": str}``.
    """
    kind = torch.device(device).type
    if kind == "cpu":
        return {"path": "plain",
                "reason": "CPU tensors take the plain PyTorch sweep"}
    if kind == "cuda" and H >= 1 and (nx, nu) in _INSTANCES:
        return {"path": "cuda",
                "reason": f"csrc/{SOURCE} instantiates <{nx}, {nu}>"}
    return {"path": "unsupported",
            "reason": (f"no CUDA sweep for H={H}, nx={nx}, nu={nu} on "
                       f"{kind}: csrc/{SOURCE} instantiates "
                       f"{sorted(_INSTANCES)} only (ROADMAP Queue 2 #2-#3 "
                       "port the streamed sweeps for larger stages)")}


def sweep_bytes(Bn: int, H: int, nx: int, nu: int) -> int:
    """Least bytes the sweep must move: every input read once (G and M as
    given, full ns×ns), every output written once."""
    ns = nx + nu
    ins = H * (nx * nx + nx * nu + 2 * ns * ns + 2 * nx + nu) + 1
    outs = H * (2 * nx + nu)
    return 4 * Bn * (ins + outs) + Bn          # + one ok byte a problem


def sweep_flops(Bn: int, H: int, nx: int, nu: int) -> int:
    """Floating-point operations of one sweep, counted from its formulae
    with one Cholesky factorisation a stage (the δ=0 level)."""
    ns = nx + nu
    bwd = (2 * nx * nx                        # Pbar
           + nx                               # pbar
           + 2 * nx * nx * nx                 # PA
           + 2 * nx * nx * nu                 # PB
           + 2 * nx * nx * nx + nx * nx       # Qxx
           + 2 * nu * nu * nx                 # BtMxu
           + nu * nu * (2 * nx + 5)           # Quu
           + nu * nx * (4 * nx + 2)           # Qux
           + nx * (2 * nx + 1)                # Pc_p
           + 2 * nx * nx                      # qx
           + nu * (4 * nx + 2)                # qu
           + nu * nu * nu // 3 + 2 * nu       # Cholesky
           + (nx + 1) * 2 * nu * nu           # substitutions
           + nx * nx * (2 * nu + 2)           # P update + symmetrise
           + nx * (2 * nu))                   # p update
    fwd = 2 * nu * nx + nu + nx * (2 * ns + 1) + nx * (2 * ns + 1)
    return Bn * H * (bwd + fwd)


def _chol_local_retry(Q, eye):
    """Batched Cholesky with the ``_LOCAL_DELTAS`` escalation (first
    success wins).  ``torch.linalg.cholesky`` raises on a matrix that is
    not positive definite where ``jnp.linalg.cholesky`` returns NaN, so the
    factor comes from ``cholesky_ex`` and is tested like the reference's:
    ``info == 0``, finite, and diag(L) > 1e-6 (pivot² > 1e-12).  Returns
    ``(L_safe, ok)`` with the identity where no bump passed."""
    Q = 0.5 * (Q + Q.mT)     # jnp.linalg.cholesky symmetrises its input
    L_sel = ok_t = None
    for d in _LOCAL_DELTAS:
        L_d, info = torch.linalg.cholesky_ex(Q + d * eye)
        ok_d = ((info == 0) & torch.isfinite(L_d).all(dim=(-2, -1))
                & (L_d.diagonal(dim1=-2, dim2=-1) > 1e-6).all(dim=-1))
        if L_sel is None:
            L_sel, ok_t = L_d, ok_d
        else:
            newly = ok_d & ~ok_t
            L_sel = torch.where(newly[:, None, None], L_d, L_sel)
            ok_t = ok_t | ok_d
    return torch.where(ok_t[:, None, None], L_sel, eye), ok_t


def _mv(Mat, v):
    return (Mat @ v.unsqueeze(-1)).squeeze(-1)


def riccati_sweep_plain(A, B, G, M, mx, mu, c, delta):
    """Plain PyTorch sweep: a Python loop backward over the horizon, then
    forward, each stage a batched small-matrix step."""
    global PLAIN_CALLS
    PLAIN_CALLS += 1
    Bn, H, nx = c.shape
    nu = B.shape[-1]
    ns = nx + nu
    eye_u = torch.eye(nu, dtype=A.dtype, device=A.device)
    Md = M + torch.diag_embed(delta.reshape(Bn, 1).expand(Bn, ns))[:, None]

    P = torch.zeros((Bn, nx, nx), dtype=A.dtype, device=A.device)
    p = torch.zeros((Bn, nx), dtype=A.dtype, device=A.device)
    okc = torch.ones((Bn,), dtype=torch.bool, device=A.device)
    gains = [None] * H
    for t in range(H - 1, -1, -1):
        A_t, B_t, G_t, M_t, c_t = A[:, t], B[:, t], G[:, t], Md[:, t], c[:, t]
        Mxx, Mxu, Muu = M_t[:, :nx, :nx], M_t[:, :nx, nx:], M_t[:, nx:, nx:]
        Pbar = P + Mxx
        pbar = p + mx[:, t]
        PA = Pbar @ A_t
        PB = Pbar @ B_t
        Qxx = A_t.mT @ PA + G_t[:, :nx, :nx]
        BtMxu = B_t.mT @ Mxu
        Quu = B_t.mT @ PB + Muu + BtMxu + BtMxu.mT + G_t[:, nx:, nx:]
        Qux = B_t.mT @ PA + Mxu.mT @ A_t + G_t[:, nx:, :nx]
        Pc_p = _mv(Pbar, c_t) + pbar
        qx = _mv(A_t.mT, Pc_p)
        qu = _mv(B_t.mT, Pc_p) + _mv(Mxu.mT, c_t) + mu[:, t]

        L, ok_t = _chol_local_retry(Quu, eye_u)
        K = -torch.cholesky_solve(Qux, L)
        k = -torch.cholesky_solve(qu.unsqueeze(-1), L).squeeze(-1)
        okc = okc & ok_t
        P_new = Qxx + Qux.mT @ K
        P = 0.5 * (P_new + P_new.mT)
        p = qx + _mv(Qux.mT, k)
        gains[t] = (K, k, Pbar, pbar, Mxu)

    dx = torch.zeros((Bn, nx), dtype=A.dtype, device=A.device)
    dXs, dUs, dLams = [], [], []
    for t in range(H):
        K, k, Pbar, pbar, Mxu = gains[t]
        du = _mv(K, dx) + k
        dx = _mv(A[:, t], dx) + _mv(B[:, t], du) + c[:, t]
        dXs.append(dx)
        dUs.append(du)
        dLams.append(_mv(Pbar, dx) + _mv(Mxu, du) + pbar)
    return (torch.stack(dXs, 1), torch.stack(dUs, 1), torch.stack(dLams, 1),
            okc)


_ENTRY = None     # the kernel's C entry point, bound on first launch


def _entry():
    global _ENTRY
    if _ENTRY is None:
        from .build import load
        fn = load(SOURCE).riccati_sweep_f32
        fn.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 5
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _ENTRY = fn
    return _ENTRY


def riccati_sweep_cuda(A, B, G, M, mx, mu, c, delta):
    """Launch ``csrc/riccati_sweep.cu`` on CUDA tensors (no fallback).

    Raises on a tensor that is not float32, not contiguous, not on one CUDA
    device, of the wrong shape, or of an (nx, nu) with no instantiation.
    """
    global LAUNCHES
    if c.dim() != 3:
        raise ValueError(f"c must be (B, H, nx), got {tuple(c.shape)}")
    Bn, H, nx = c.shape
    nu = B.shape[-1]
    ns = nx + nu
    want = {"A": (A, (Bn, H, nx, nx)), "B": (B, (Bn, H, nx, nu)),
            "G": (G, (Bn, H, ns, ns)), "M": (M, (Bn, H, ns, ns)),
            "mx": (mx, (Bn, H, nx)), "mu": (mu, (Bn, H, nu)),
            "c": (c, (Bn, H, nx)), "delta": (delta, (Bn,))}
    for name, (t, shape) in want.items():
        if t.device.type != "cuda" or t.device != c.device:
            raise ValueError(f"{name} must lie on {c.device} (a CUDA "
                             f"device), got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if Bn == 0 or H == 0:
        raise ValueError("riccati_sweep_cuda needs B >= 1 and H >= 1")
    if (nx, nu) not in _INSTANCES:
        raise NotImplementedError(kernel_plan(H, nx, nu, c.device)["reason"])

    fn = _entry()
    dev = c.device
    dX = torch.empty((Bn, H, nx), dtype=torch.float32, device=dev)
    dU = torch.empty((Bn, H, nu), dtype=torch.float32, device=dev)
    dLam = torch.empty((Bn, H, nx), dtype=torch.float32, device=dev)
    ok = torch.empty((Bn,), dtype=torch.bool, device=dev)
    gains = torch.empty((Bn, H, gain_width(nx, nu)), dtype=torch.float32,
                        device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(A.data_ptr(), B.data_ptr(), G.data_ptr(), M.data_ptr(),
             mx.data_ptr(), mu.data_ptr(), c.data_ptr(), delta.data_ptr(),
             dX.data_ptr(), dU.data_ptr(), dLam.data_ptr(), ok.data_ptr(),
             gains.data_ptr(), Bn, H, nx, nu, dev.index or 0, stream)
    if err != 0:
        raise RuntimeError(f"riccati_sweep kernel launch failed: CUDA error "
                           f"{err} (B={Bn}, H={H}, nx={nx}, nu={nu})")
    LAUNCHES += 1
    return dX, dU, dLam, ok


def riccati_sweep(A, B, G, M, mx, mu, c, delta):
    """Dispatch on the tensors' device: CPU -> plain version, CUDA -> the
    kernel where :func:`kernel_plan` has an instantiation, else raise."""
    Bn, H, nx = c.shape
    nu = B.shape[-1]
    plan = kernel_plan(H, nx, nu, c.device)
    if plan["path"] == "plain":
        return riccati_sweep_plain(A, B, G, M, mx, mu, c, delta)
    if plan["path"] == "cuda":
        return riccati_sweep_cuda(A, B, G, M, mx, mu, c, delta)
    raise NotImplementedError(plan["reason"])
