"""ctypes binding of the native f64 KKT oracle (``csrc/kkt_oracle.cpp``).

The port's own binding (the JAX package has one too; the port shares no
module with it).  The oracle solves the condensed KKT system in double
precision by partially pivoted Gaussian elimination, with no PyTorch, BLAS
or LAPACK in it: a check of the port's KKT solves that shares no code with
them.  The library is built with ``g++`` at first use into
``pyneuralempc_tpu_torch/_build/``, its name keyed by a hash of the source
(the source directory is never written).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Optional, Tuple

import numpy as np
import torch

from ..ops.cuda.build import PACKAGE_DIR

SOURCE = PACKAGE_DIR.parent / "csrc" / "kkt_oracle.cpp"
_LIB: Optional[ctypes.CDLL] = None


def _build_and_load() -> ctypes.CDLL:
    global _LIB
    if _LIB is not None:
        return _LIB
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    out_dir = PACKAGE_DIR / "_build"
    lib_path = out_dir / f"libkkt_oracle_{digest}.so"
    if not lib_path.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_name(f"{lib_path.stem}.{os.getpid()}.tmp.so")
        subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-o", str(tmp),
                        str(SOURCE)], check=True)
        os.replace(tmp, lib_path)   # atomic: a loader never sees half of it
    lib = ctypes.CDLL(str(lib_path))
    f32p = ctypes.POINTER(ctypes.c_float)
    f64p = ctypes.POINTER(ctypes.c_double)
    lib.solve_kkt_batch.restype = ctypes.c_int
    lib.solve_kkt_batch.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        f32p, f32p, f32p, f32p, f32p,
        ctypes.c_double, ctypes.c_double, f64p, f64p]
    _LIB = lib
    return lib


def _f32(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(a, np.float32))


def solve_kkt_oracle(W, Sigma, A, r_tilde, r_p, delta_w: float = 0.0,
                     delta_c: float = 0.0) -> Tuple[np.ndarray, np.ndarray]:
    """Solve the condensed KKT system(s)

        [ W + diag(Σ) + δ_w I   Aᵀ      ] [Δw]   [ −r̃  ]
        [ A                    −δ_c I   ] [Δλ] = [ −r_p ]

    in f64 by the C++ oracle.  Takes one system ((n, n), (n,), (m, n),
    (n,), (m,)) or a batch (a leading axis on each), as numpy arrays or
    tensors (rounded to f32, the oracle's input type); returns (dw, dlam)
    as float64 numpy arrays."""
    lib = _build_and_load()
    W, Sigma, A, r_tilde, r_p = (_f32(a) for a in (W, Sigma, A, r_tilde,
                                                   r_p))
    batched = W.ndim == 3
    if not batched:
        W, Sigma, A, r_tilde, r_p = (a[None] for a in (W, Sigma, A, r_tilde,
                                                       r_p))
    B, n, _ = W.shape
    m = A.shape[1]
    dw = np.zeros((B, n), np.float64)
    dlam = np.zeros((B, m), np.float64)

    def ptr(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))   # contiguous (_f32)

    rc = lib.solve_kkt_batch(
        B, n, m, ptr(W, ctypes.c_float), ptr(Sigma, ctypes.c_float),
        ptr(A, ctypes.c_float), ptr(r_tilde, ctypes.c_float),
        ptr(r_p, ctypes.c_float), float(delta_w), float(delta_c),
        dw.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        dlam.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    if rc != 0:
        raise RuntimeError(f"KKT oracle reported singular system (rc={rc})")
    return (dw, dlam) if batched else (dw[0], dlam[0])


def refine_kkt_point(w0, grad_fn, cons_fn, jac_fn, lag_hess_fn, lb, ub,
                     iters: int = 3, act_tol: float = 1e-6,
                     delta_w: float = 1e-9, delta_c: float = 1e-12):
    """Polish an approximately optimal point by f64 active-set Newton steps
    on the equality KKT system, the linear solves by the oracle.

    The active set is frozen from ``w0`` (bounds within ``act_tol``
    relative slack become equality rows), then ``iters`` Newton steps on

        [ W      A_extᵀ ] [Δw]    [ g + A_extᵀ λ ]
        [ A_ext  0      ] [Δλ] = −[ c_ext        ]

    with A_ext = [∂C; E_active] and c_ext = [C(w); w_act − bound].  The
    residuals and blocks are evaluated in f32 (the NLP being checked), the
    elimination in f64.  The callbacks take f32 CPU tensors:
    ``grad_fn(w) -> (n,)``, ``cons_fn(w) -> (m,)``, ``jac_fn(w) -> (m,
    n)``, ``lag_hess_fn(w, lam) -> (n, n)`` (λ over the m constraint rows).
    Returns the refined float64 ``w`` (numpy)."""
    lb = np.asarray(lb, np.float64)
    ub = np.asarray(ub, np.float64)
    w = np.asarray(w0, np.float64).copy()
    n = w.shape[0]
    act_l = np.isfinite(lb) & (w - lb <= act_tol * (1.0 + np.abs(lb)))
    act_u = np.isfinite(ub) & (ub - w <= act_tol * (1.0 + np.abs(ub)))
    act_u &= ~act_l
    act_idx = np.nonzero(act_l | act_u)[0]
    bound_val = np.where(act_l, lb, ub)[act_idx]
    E = np.zeros((len(act_idx), n), np.float64)
    E[np.arange(len(act_idx)), act_idx] = 1.0

    def t32(v):
        return torch.as_tensor(np.asarray(v, np.float32))

    def f64(v):
        return np.asarray(v.detach().cpu().numpy() if isinstance(
            v, torch.Tensor) else v, np.float64)

    m = f64(cons_fn(t32(w))).shape[0]
    lam_ext = np.zeros(m + len(act_idx), np.float64)
    for _ in range(iters):
        g = f64(grad_fn(t32(w)))
        c = f64(cons_fn(t32(w)))
        A = f64(jac_fn(t32(w)))
        W = f64(lag_hess_fn(t32(w), t32(lam_ext[:m])))
        A_ext = np.concatenate([A, E], axis=0)
        r_p = np.concatenate([c, w[act_idx] - bound_val])
        r_t = g + A_ext.T @ lam_ext
        try:
            dw, dlam = solve_kkt_oracle(W, np.zeros(n), A_ext, r_t, r_p,
                                        delta_w=delta_w, delta_c=delta_c)
        except RuntimeError:
            break    # singular (the active-set guess is degenerate): keep w
        if not (np.all(np.isfinite(dw)) and np.all(np.isfinite(dlam))):
            break
        # cap: the refinement must stay a polish, not a restart
        if float(np.max(np.abs(dw))) > 0.1 * (1.0 + float(np.max(
                np.abs(w)))):
            break
        w = np.clip(w + dw, lb, ub)
        w[act_idx] = bound_val           # active rows exactly on the bound
        lam_ext = lam_ext + dlam
    return w
