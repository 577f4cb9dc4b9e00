"""The least work of one Riccati sweep (backward and forward pass) over a
batch of problems: the bytes it must move and the operations it must do.

A frozen copy of ``pyneuralempc_tpu_torch/ops/cuda/riccati_kernel.py``
``sweep_bytes`` / ``sweep_flops`` and their helpers: every input read once,
every output written once, the gains between the two passes never counted,
G and M as upper triangles, one Cholesky factorisation a stage.  A kernel
that fuses or splits the sweep differently is held to the same work.  R is
the number of right-hand sides and r the stage equality rows; the plain
sweep is R=1, r=0.
"""

from __future__ import annotations


def _bwd_stage_flops(nx: int, nu: int, R: int = 1, r: int = 0) -> int:
    n = (2 * nx * nx                          # Pbar
         + R * nx                             # pbar
         + 2 * nx * nx * nx                   # PA
         + 2 * nx * nx * nu                   # PB
         + 2 * nx * nx * nx + nx * nx         # Qxx
         + 2 * nu * nu * nx                   # BtMxu
         + nu * nu * (2 * nx + 5)             # Quu
         + nu * nx * (4 * nx + 2)             # Qux
         + R * nx * (2 * nx + 1)              # Pc_p
         + R * 2 * nx * nx                    # qx
         + R * nu * (4 * nx + 2)              # qu
         + nu * nu * nu // 3 + 2 * nu         # Cholesky
         + (nx + R + r) * 2 * nu * nu         # substitutions
         + nx * nx * (2 * nu + 2 * r + 2)     # P update + symmetrise
         + R * nx * (2 * nu + 2 * r))         # p update
    if r:
        n += (r * r * (2 * nu + 1)
              + (nx + R) * r * (2 * nu + 1)
              + r * r * r // 3 + 2 * r
              + (nx + R) * 2 * r * r
              + nu * nx * 2 * r + R * nu * 2 * r)
    return n


def _fwd_stage_flops(nx: int, nu: int, R: int = 1, r: int = 0) -> int:
    ns = nx + nu
    return R * (2 * nu * nx + nu
                + r * (2 * nx + 1)
                + nx * (2 * ns + 1)
                + nx * (2 * ns + 1 + 2 * r))


def _input_floats(H: int, nx: int, nu: int, R: int = 1, r: int = 0) -> int:
    ns = nx + nu
    per_stage = (nx * nx + nx * nu + ns * (ns + 1) + R * (2 * nx + nu)
                 + r * (R + nu + nx))
    return H * per_stage + 1 + (1 if r else 0)


def _output_floats(H: int, nx: int, nu: int, R: int = 1, r: int = 0) -> int:
    return H * R * (2 * nx + nu + r)


def sweep_bytes(Bn: int, H: int, nx: int, nu: int, R: int = 1,
                r: int = 0) -> int:
    """Least bytes one sweep of Bn problems must move."""
    floats = (_input_floats(H, nx, nu, R, r) + H * r * nx
              + _output_floats(H, nx, nu, R, r))
    return 4 * Bn * floats + Bn


def sweep_flops(Bn: int, H: int, nx: int, nu: int, R: int = 1,
                r: int = 0) -> int:
    """Operations of one sweep of Bn problems."""
    return Bn * H * (_bwd_stage_flops(nx, nu, R, r)
                     + _fwd_stage_flops(nx, nu, R, r))


def least_seconds(Bn: int, H: int, nx: int, nu: int, peak_flops: float,
                  peak_bytes: float, R: int = 1, r: int = 0) -> float:
    """The least time of one sweep on a device of the given peaks: the
    larger of its bytes over the bandwidth and its operations over the
    arithmetic rate."""
    return max(sweep_bytes(Bn, H, nx, nu, R, r) / peak_bytes,
               sweep_flops(Bn, H, nx, nu, R, r) / peak_flops)
