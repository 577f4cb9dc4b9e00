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
      and Quu's off-diagonal zero) so the rescued gains stay bounded;
    * ``delta_rescue``: every problem's first control at -3 on M's
      diagonal and δ cycling 0, 10, so the problems at δ = 0 report
      ok=False and those at δ = 10 pass (the solver's δ ladder; the
      parallel-in-time sweep's stage-wise test agrees here).
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
    elif kind == "delta_rescue":
        M[:, :, nx, nx] = -3.0
        delta[:] = np.resize(np.float32([0.0, 10.0]), B)
    elif kind != "delta0":
        raise ValueError(kind)
    return args


def general_sweep_case(kind, B=4, H=5, nx=2, nu=1, R=2, r=1, seed=0):
    """Inputs of the general sweep, stage-major: A, B, G, M, mx, mu, c (with
    an rhs axis, (B, H, R, ·)), delta, delta_c, E, F, h, Jx.

    The first right-hand side and A, B, G, M, delta are :func:`sweep_case`'s
    (so at R=1, r=0 the case is the plain one); the other right-hand sides
    and the equality rows come from a second seeded draw.  E is identity
    dominant, as in tests/test_pallas_general.py: a random E makes the
    Schur complement S = E Quu⁻¹ Eᵀ nearly singular, and a comparison then
    measures conditioning.  Its noise is half that test's (0.1, not 0.2):
    over 4096 × 50 stages at r = nu = 4, a 0.2 draw gives a few E whose S
    pivot sits at the Cholesky test's 1e-12, and two correct factorisations
    then disagree on ok.  At r = nu the rows fix the control
    (Δu = E⁻¹(h − F Δx)) and nothing steers the states, so the value
    function grows with A's spectral radius (up to ~1.1 here) over the
    horizon; F is drawn at a tenth of its scale there (0.05, not 0.5), and
    the horizon should stay short (H=10: the plain version in f32 is then
    within 1.7e-5 of f64 at B=4096, against 0.25 at H=50 with the full F).
    ``kind`` is one of :func:`sweep_case`'s; on
    ``delta_per_problem`` δ_c cycles 1e-8, 1e-6, 1e-4, 1e-2 too (else 1e-8),
    and on ``local_bump`` the rescued control is decoupled from the
    equality rows (their identity moves to the other controls there, so it
    needs r < nu) and from every right-hand side as well.
    """
    if kind == "local_bump" and r >= nu:
        raise ValueError("local_bump decouples a control from the equality "
                         "rows, which needs r < nu")
    A, Bm, G, M, mx1, mu1, c1, delta = sweep_case(kind, B=B, H=H, nx=nx,
                                                  nu=nu, seed=seed)
    rng = np.random.default_rng(seed + 10007)
    mx = np.concatenate([mx1[:, :, None], rng.normal(0, 1, (B, H, R - 1, nx))],
                        axis=2)
    mu_ = np.concatenate([mu1[:, :, None],
                          rng.normal(0, 1, (B, H, R - 1, nu))], axis=2)
    c = np.concatenate([c1[:, :, None], rng.normal(0, 0.1, (B, H, R - 1, nx))],
                       axis=2)
    E = np.eye(r, nu) + 0.1 * rng.normal(0, 1, (B, H, r, nu))
    F = rng.normal(0, 0.05 if r == nu else 0.5, (B, H, r, nx))
    h = rng.normal(0, 0.3, (B, H, R, r))
    Jx = rng.normal(0, 0.5, (B, H, r, nx))
    dc = np.full((B,), 1e-8)
    if kind == "delta_per_problem":
        dc = np.resize(np.asarray([1e-8, 1e-6, 1e-4, 1e-2]), B)
    elif kind == "local_bump":
        for sel in (slice(1, None, 2), slice(2, None, 4)):
            mu_[sel, 1, :, 0] = 0.0
            E[sel, 1, :, 0] = 0.0
            E[sel, 1, :, 1:] += np.eye(r, nu - 1) - np.eye(r, nu)[:, 1:]
    return [np.ascontiguousarray(a, np.float32)
            for a in (A, Bm, G, M, mx, mu_, c, delta, dc, E, F, h, Jx)]


def scaled_error(outs, refs, ok):
    """The largest |out − ref| of each output over the ok problems, over
    max(1, max|ref|) there, the largest of the outputs: the measure the
    parallel-in-time sweeps are held to the plain one with.  numpy arrays
    or tensors."""
    err = 0.0
    for o, r in zip(outs, refs):
        d = abs(o - r)[ok]
        err = max(err, float(d.max()) / max(1.0, float(abs(r[ok]).max())))
    return err
