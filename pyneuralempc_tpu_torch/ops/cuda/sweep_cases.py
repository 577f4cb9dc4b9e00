"""Seeded inputs for the sweeps' checks, as float32 numpy arrays.

One builder for ``chip_smoke.py`` (which moves them to the card) and the
CPU parity tests (which hand them to the JAX package too), so both hold the
kernels and the plain versions to the same cases.  The data is
tests/test_pallas_kernel.py's; G and M are exactly symmetric.
"""

import numpy as np


def sweep_data(B=3, H=5, nx=2, nu=1, seed=0):
    """A, B, G, M, mx, mu, c, delta of B problems of H stages, δ = 0."""
    rng = np.random.default_rng(seed)
    ns = nx + nu
    A = np.eye(nx) + 0.1 * rng.normal(0, 0.3, (B, H, nx, nx))
    Bm = 0.1 * rng.normal(0, 1, (B, H, nx, nu))
    G = rng.normal(0, 0.05, (B, H, ns, ns)).astype(np.float32)
    G = 0.5 * (G + G.transpose(0, 1, 3, 2))
    M = rng.normal(0, 0.1, (B, H, ns, ns)).astype(np.float32)
    M = 0.5 * (M + M.transpose(0, 1, 3, 2)) + np.eye(ns, dtype=np.float32)
    mx = rng.normal(0, 1, (B, H, nx))
    mu_ = rng.normal(0, 1, (B, H, nu))
    c = rng.normal(0, 0.1, (B, H, nx))
    delta = np.zeros((B,))
    return [np.ascontiguousarray(a, np.float32)
            for a in (A, Bm, G, M, mx, mu_, c, delta)]


def sweep_case(kind, B=4, H=5, nx=2, nu=1, seed=0):
    """:func:`sweep_data` with one of the four cases:

    * ``delta0``;
    * ``delta_per_problem``: δ cycling 0, 0.1, 1, 10;
    * ``negative_curvature``: every odd problem's first control at -50 on
      M's diagonal, so those problems report ok=False;
    * ``local_bump``: stage 1's Quu pivot for the first control (Muu + Guu
      exactly, with B = 0 there) just below zero, rescued at the 1e-6 bump
      on odd problems and only at the 1e-4 bump on problems 2 mod 4; that
      control is decoupled from the states and the other controls (Qux, qu
      and Quu's off-diagonal zero) so the rescued gains stay bounded.
    """
    args = sweep_data(B=B, H=H, nx=nx, nu=nu, seed=seed)
    A, Bm, G, M, mx, mu_, c, delta = args
    if kind == "delta_per_problem":
        delta[:] = np.resize(np.float32([0.0, 0.1, 1.0, 10.0]), B)
    elif kind == "negative_curvature":
        M[1::2, :, nx, nx] = -50.0
    elif kind == "local_bump":
        for sel, gap in ((slice(1, None, 2), 2e-7), (slice(2, None, 4), 2e-5)):
            Bm[sel, 1] = 0.0
            for X in (G, M):
                diag = X[sel, 1, nx, nx].copy()
                X[sel, 1, nx, :] = 0.0
                X[sel, 1, :, nx] = 0.0
                X[sel, 1, nx, nx] = diag
            M[sel, 1, nx, nx] = -G[sel, 1, nx, nx] - gap
            mu_[sel, 1] = 0.0
    elif kind != "delta0":
        raise ValueError(kind)
    return args
