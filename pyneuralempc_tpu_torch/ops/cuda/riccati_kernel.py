"""The plain Riccati sweep: CUDA kernels, plain PyTorch versions, dispatch;
and the plan, sources and counts of every sweep kernel (the general ones'
wrappers are in :mod:`.riccati_general`).

Replaces the plain sweep of ``pyneuralempc_tpu/ops/pallas/riccati_kernel.py``
``_riccati_pallas_call``: its fused branch (:419-465) and its streamed pair,
the backward kernel (:468) and the forward kernel (:488).

* ``csrc/riccati_general_fused.cu``'s staged kernel at <2, 1, 1, 0> — the
  fused sweep for (nx, nu) in ``_INSTANCES`` (the LV fleet's (2, 1)): the
  general sweep at one right-hand side and no equality rows is the plain
  sweep, so the LV fleet takes the general source's staged design (each
  block's inputs and gains in shared memory), wherever a block holds at
  least one problem at its horizon.
* ``csrc/riccati_sweep.cu`` — the first fused design, one thread per
  problem reading every stage from device memory, backward then forward
  in one launch, at (nx, nu) in ``_INSTANCES``: the fused sweep at a
  horizon where not one problem fits a staged block.
* ``csrc/riccati_streamed.cu`` — the streamed pair, one warp per problem,
  any nx <= 32 and nu <= 16 at run time: the backward kernel writes each
  stage's gains to device memory, the forward kernel reads them back.  The
  backward entry launches a compile-time instance of the general sweep's
  backward template (``csrc/riccati_backward_fixed.cuh``) at one right-hand
  side and no equality rows for the (nx, nu) in ``_BACKWARD_INSTANCES``
  (the quadrotor's (12, 4), the GRU fleet's lifted (10, 1), cartpole's
  (4, 1), the wide fleet's (12, 10), the LSTM fleet's lifted (18, 1) and
  the quadrotor GRU's lifted (28, 4)), and the run-time kernel for every
  other; the forward entry likewise a
  compile-time instance of the general sweep's forward template
  (``csrc/riccati_forward_fixed.cuh``, a ring of stage slots a warp) for
  the (nx, nu) in ``_FORWARD_INSTANCES`` (the first four and the
  quadrotor GRU's), and the run-time kernel for every other.

Beside them:

* :func:`riccati_backward_plain`, :func:`riccati_forward_plain` — the plain
  PyTorch versions of the two halves (a port of ``solve/riccati.py``
  ``riccati_sweep_ref`` with the per-stage ``_LOCAL_DELTAS`` retry);
  :func:`riccati_sweep_plain` is their composition.  CPU tensors take them;
  ``chip_smoke.py`` holds the kernels against them on the card.
* :func:`riccati_sweep_cuda`, :func:`riccati_backward_cuda`,
  :func:`riccati_forward_cuda`, :func:`riccati_sweep_streamed_cuda` — check
  their inputs, allocate outputs and scratch, launch on PyTorch's current
  stream.
* :func:`riccati_backward_runtime_cuda`, :func:`riccati_forward_runtime_cuda`
  — the run-time streamed kernels at any shape, the instances' too, and
  :func:`riccati_sweep_direct_cuda` — ``csrc/riccati_sweep.cu`` at any
  horizon, so that ``chip_smoke.py`` and the card tests can hold the two
  designs of each against each other.  The solver never calls them.
* :func:`riccati_sweep` — the dispatch the solver calls, on
  :func:`kernel_plan`.  A CUDA tensor takes its kernel wherever the plan
  names one; only a shape outside every kernel's envelope (the plan's
  ``"plain_fallback"``: nx > 32 or nu > 16) runs the plain version on the
  card, captured once a shape as a CUDA graph and replayed
  (:func:`replay`), with one warning a shape, as the JAX package's sweep
  takes its scan there.  A kernel that fails to build or launch raises.

``LAUNCHES`` counts fused launches (``STAGED_LAUNCHES`` those of the
staged kernel, ``DIRECT_LAUNCHES`` those of ``csrc/riccati_sweep.cu``),
``BACKWARD_LAUNCHES`` and ``FORWARD_LAUNCHES`` the streamed pair's
(``BACKWARD_INSTANCE_LAUNCHES`` and ``FORWARD_INSTANCE_LAUNCHES`` the
launches of each that took the compile-time instance;
``BACKWARD_RUNTIME_LAUNCHES`` and ``FORWARD_RUNTIME_LAUNCHES`` those of
:func:`riccati_backward_runtime_cuda` and
:func:`riccati_forward_runtime_cuda`), ``PLAIN_CALLS`` calls of a
plain version (a whole plain sweep counts once), and ``FALLBACK_CALLS``
the dispatching calls (:func:`riccati_sweep` and
:func:`.riccati_general.riccati_sweep_general`) that the plan sent to a
plain version on the card, so a run can show which path it took.

All functions take batch-first tensors: A (B,H,nx,nx), B (B,H,nx,nu),
G and M (B,H,ns,ns) symmetric, mx (B,H,nx), mu (B,H,nu), c (B,H,nx),
delta (B,); a sweep returns dX (B,H,nx), dU (B,H,nu), dLam (B,H,nx), ok (B,).
The gains between the two halves are (B,H,gain_width(nx, nu)), each stage
laid out ``[K | k | Pbar | pbar | Mxu]`` (K (nu,nx) and Mxu (nx,nu)
row-major).
"""

from __future__ import annotations

import ctypes
import warnings

import torch

# Local (per-stage, per-problem) regularisation bumps on Quu's diagonal,
# capped at nudge scale: genuine indefiniteness must report ok=False so the
# solver's global-δ ladder convexifies the whole horizon.
_LOCAL_DELTAS = (0.0, 1e-6, 1e-4)

# (nx, nu) pairs of the fused plain sweep: csrc/riccati_sweep.cu
# instantiates them, and csrc/riccati_general_fused.cu's staged entry at
# (nx, nu, 1, 0) (_STAGED_INSTANCES).
_INSTANCES = frozenset({(2, 1)})
# (nx, nu) pairs for which csrc/riccati_streamed.cu's backward entry launches
# the compile-time instance riccati_general_backward_fixed<nx, nu, 1, 0>
# (its C entry point's list): the quadrotor fleets' stage, the GRU fleet's
# lifted stage, cartpole's, the wide fleet's (there, past nu = 4, Quu is
# factored one row a lane, and one stage buffer a warp lets eight blocks
# fit an SM: backward_fixed_smem_bytes), the LSTM fleet's lifted stage
# (there, past nx = 16, the two O(nx^3) products take (row, float4 column)
# tiles, 3 rows a lane over 30 lanes, in one stage buffer a warp) and the
# quadrotor GRU's lifted stage (the same tiles, 10 rows a lane over 27
# lanes; its one stage buffer a warp leaves room for 3 blocks an SM, not
# 8).  Every other shape takes the run-time backward kernel.
_BACKWARD_INSTANCES = frozenset({(12, 4), (10, 1), (4, 1), (12, 10),
                                 (18, 1), (28, 4)})
# (nx, nu) -> ring depth D for which csrc/riccati_streamed.cu's forward
# entry launches the compile-time instance riccati_general_forward_fixed<nx,
# nu, 1, 0, D> (its C entry point's list): the first four stages above and
# the quadrotor GRU's.  Every other shape takes the run-time forward kernel.
# Each depth was chosen by turns on an H100 (PERF.md; eight blocks of four
# warps an SM cap the depth at 3 at (12, 4) and at 2 at (12, 10); at
# (28, 4) no depth leaves room for eight, and depth 3, two blocks an SM,
# was the fastest).
_FORWARD_INSTANCES = {(12, 4): 2, (10, 1): 4, (4, 1): 8, (12, 10): 2,
                      (28, 4): 3}
# Stage widths csrc/riccati_streamed.cu takes: one lane per state row in
# the forward kernel; nu <= 16 is the reference kernel's own cap.
STREAMED_MAX_NX = 32
STREAMED_MAX_NU = 16
# csrc/riccati_general.cu takes the same stage widths, up to 65 right-hand
# sides (1 + the 64 border rows the Riccati backend takes) and r <= nu
# stage equality rows.
GENERAL_MAX_R = 65
# (nx, nu, R, r) tuples that csrc/riccati_general_fused.cu instantiates (its
# C entry point's list): the LV stage with up to two border rows and up to
# one stage equality row; (R, r) = (1, 0) is the plain sweep's.
_GENERAL_INSTANCES = frozenset((2, 1, R, r) for R in (1, 2, 3)
                               for r in (0, 1) if (R, r) != (1, 0))
# csrc/riccati_general_fused.cu's staged entry's list: the general
# instances and the plain sweep's (nx, nu, 1, 0), which riccati_sweep_cuda
# launches (the general sweep at one right-hand side and no equality rows
# is the plain sweep).  Its direct entry's list is _GENERAL_INSTANCES.
_STAGED_INSTANCES = _GENERAL_INSTANCES | {(nx, nu, 1, 0)
                                          for nx, nu in _INSTANCES}
# (nx, nu, R, r) tuples for which csrc/riccati_general.cu's backward entry
# launches its compile-time instance (its C entry point's list): the
# EQ/border quadrotor fleet's stage.  Every other shape takes the run-time
# backward kernel.
_GENERAL_BACKWARD_INSTANCES = frozenset({(12, 4, 2, 1)})
# (nx, nu, R, r) -> ring depth D for which csrc/riccati_general.cu's
# forward entry launches its compile-time instance
# riccati_general_forward_fixed<nx, nu, R, r, D> (its C entry point's
# list): the EQ/border quadrotor fleet's stage.  The instance streams each
# warp's stage inputs through a ring of D stage slots in shared memory
# (depths 2 and 3 timed the same there; 2 takes the less memory).
_GENERAL_FORWARD_INSTANCES = {(12, 4, 2, 1): 2}
# Problems (warps) a block of the streamed kernels (kMaxWarps).
STREAMED_WARPS = 4
# The backward template's residency (csrc/riccati_backward_fixed.cuh): it
# keeps two stage buffers a warp where FIXED_MIN_BLOCKS blocks (B=4096 in one
# wave on 132 SMs) still fit an SM's SM_SMEM bytes of shared memory, each
# block with the runtime's BLOCK_SMEM_RESERVE, and one where they do not.
FIXED_MIN_BLOCKS = 8
SM_SMEM = 228 * 1024
BLOCK_SMEM_RESERVE = 1024
# csrc/riccati_general_fused.cu's two kernels.  The staged kernel's block
# of STAGED_MAX_PROBLEMS threads holds up to that many problems' inputs,
# gains and outputs in at most STAGED_MAX_SMEM bytes of dynamic shared
# memory (the most a block may opt into on an H100); the direct kernel
# takes a horizon at which not one problem fits.
STAGED_KERNEL = "riccati_general_fused_staged_kernel"
DIRECT_KERNEL = "riccati_general_fused_kernel"
SWEEP_KERNEL = "riccati_sweep_kernel"     # csrc/riccati_sweep.cu's
STAGED_MAX_PROBLEMS = 32
STAGED_MAX_SMEM = 232_448

LAUNCHES = 0            # fused plain sweep launches
STAGED_LAUNCHES = 0     # of them, the staged kernel's at <2, 1, 1, 0>
DIRECT_LAUNCHES = 0     # of them, csrc/riccati_sweep.cu's
BACKWARD_LAUNCHES = 0   # streamed backward launches by riccati_backward_cuda
BACKWARD_INSTANCE_LAUNCHES = 0   # of them, the compile-time instance's
BACKWARD_RUNTIME_LAUNCHES = 0    # riccati_backward_runtime_cuda's
FORWARD_LAUNCHES = 0    # streamed forward launches by riccati_forward_cuda
FORWARD_INSTANCE_LAUNCHES = 0    # of them, the compile-time instance's
FORWARD_RUNTIME_LAUNCHES = 0     # riccati_forward_runtime_cuda's
PLAIN_CALLS = 0         # calls of a plain version
FALLBACK_CALLS = 0      # dispatches that ran a plain version on the card

_WARNED = set()         # (sweep, H, nx, nu, R, r) whose fallback warned

SOURCE = "riccati_sweep.cu"
STREAMED_SOURCE = "riccati_streamed.cu"
GENERAL_SOURCE = "riccati_general.cu"
GENERAL_FUSED_SOURCE = "riccati_general_fused.cu"


def gain_width(nx: int, nu: int, R: int = 1, r: int = 0) -> int:
    """Floats of per-stage gains: K, k, Pbar, pbar, Mxu (and, for the
    general sweep's R right-hand sides and r stage-equality rows, Knu and
    knu; k, pbar and knu are per right-hand side)."""
    return (nu * nx + R * nu + nx * nx + R * nx + nx * nu
            + r * nx + R * r)


def _round4(n: int) -> int:
    return (n + 3) & ~3


def staged_smem_bytes(P: int, H: int, nx: int, nu: int, R: int,
                      r: int) -> int:
    """Dynamic shared memory of a staged block of P problems at horizon H
    (``staged_layout`` in csrc/riccati_general_fused.cu): 16 bytes for the
    mbarrier, then the block's slab of every input, each from a 16-byte
    boundary, in the order A, B, c, Jx, δ, δ_c, G, M, mx, mu, E, F, h (G, M
    as stored, ns² floats a stage), then the gains.  The outputs take the
    room of G onward after the backward pass."""
    ns = nx + nu
    per_problem = (H * nx * nx, H * nx * nu, H * R * nx, H * r * nx, 1,
                   1 if r else 0, H * ns * ns, H * ns * ns, H * R * nx,
                   H * R * nu, H * r * nu, H * r * nx, H * R * r)
    o = 4
    for w in per_problem:
        o = _round4(o + P * w)
    return 4 * _round4(o + P * H * gain_width(nx, nu, R, r))


def staged_block_problems(H: int, nx: int, nu: int, R: int, r: int) -> int:
    """Problems a block of the staged kernel takes at horizon H
    (``staged_problems`` in csrc/riccati_general_fused.cu): at most
    STAGED_MAX_PROBLEMS, as many as fit in STAGED_MAX_SMEM bytes; 0 when
    not one problem fits."""
    if H > STAGED_MAX_SMEM // 4:
        return 0
    for P in range(STAGED_MAX_PROBLEMS, 0, -1):
        if staged_smem_bytes(P, H, nx, nu, R, r) <= STAGED_MAX_SMEM:
            return P
    return 0


def _streamed_fits(nx: int, nu: int) -> bool:
    return 1 <= nx <= STREAMED_MAX_NX and 1 <= nu <= STREAMED_MAX_NU


def _general_fits(nx: int, nu: int, R: int, r: int) -> bool:
    return (_streamed_fits(nx, nu) and 1 <= R <= GENERAL_MAX_R
            and 0 <= r <= nu)


def backward_kernel(nx: int, nu: int) -> str:
    """The kernel that csrc/riccati_streamed.cu's backward entry launches at
    this shape, as a profiler names it: the compile-time instance, with its
    template arguments, or the run-time kernel."""
    if (nx, nu) in _BACKWARD_INSTANCES:
        return f"riccati_general_backward_fixed<{nx}, {nu}, 1, 0>"
    return "riccati_backward_kernel"


def forward_kernel(nx: int, nu: int) -> str:
    """The kernel that csrc/riccati_streamed.cu's forward entry launches at
    this shape, as a profiler names it: the compile-time instance, with its
    template arguments (its ring depth last), or the run-time kernel."""
    D = _FORWARD_INSTANCES.get((nx, nu))
    if D is not None:
        return f"riccati_general_forward_fixed<{nx}, {nu}, 1, 0, {D}>"
    return "riccati_forward_kernel"


def general_backward_kernel(nx: int, nu: int, R: int, r: int) -> str:
    """The kernel that csrc/riccati_general.cu's backward entry launches at
    this shape: the compile-time instance or the run-time kernel."""
    if (nx, nu, R, r) in _GENERAL_BACKWARD_INSTANCES:
        return "riccati_general_backward_fixed"
    return "riccati_general_backward_kernel"


def general_forward_kernel(nx: int, nu: int, R: int, r: int) -> str:
    """The kernel that csrc/riccati_general.cu's forward entry launches at
    this shape, as a profiler names it: the compile-time instance, with its
    template arguments, or the run-time kernel."""
    D = _GENERAL_FORWARD_INSTANCES.get((nx, nu, R, r))
    if D is not None:
        return f"riccati_general_forward_fixed<{nx}, {nu}, {R}, {r}, {D}>"
    return "riccati_general_forward_kernel"


def forward_slot_floats(nx: int, nu: int, R: int, r: int) -> int:
    """Floats of one stage slot of the forward instance's ring
    (``ForwardLayout::kSlot`` in csrc/riccati_forward_fixed.cuh): A, B, c,
    Jx and the gains, each from a 16-byte boundary of the slot with room
    for its source's offset of 0-3 floats within 16 bytes."""
    return sum(_round4(n + 3) for n in (
        nx * nx, nx * nu, R * nx, r * nx, gain_width(nx, nu, R, r)) if n)


def forward_ring_bytes(nx: int, nu: int, R: int, r: int, depth: int) -> int:
    """Dynamic shared memory of a block of the forward instance: its
    STREAMED_WARPS warps' rings of ``depth`` stage slots each."""
    return 4 * STREAMED_WARPS * depth * forward_slot_floats(nx, nu, R, r)


def _fixed_stage_floats(nx: int, nu: int, R: int, r: int) -> int:
    """One stage buffer: X = [A | c^T | B] (rows padded to float4s), the
    upper triangles of G and M, mx, mu, E, F, h."""
    ns = nx + nu
    return _round4(nx * _round4(nx + R + nu) + ns * (ns + 1)
                   + R * (nx + nu) + r * (nu + nx + R))


def _fixed_scratch_floats(nx: int, nu: int, R: int, r: int) -> int:
    """P_new (rows nx + 1 apart) and p, then Y, Z, W and Nu."""
    nwp = _round4(nx + R + nu)
    return (_round4(nx * (nx + 1)) + _round4(R * nx) + (nx + nu) * nwp
            + nu * _round4(nx + R + r) + r * _round4(nx + R))


def backward_fixed_buffers(nx: int, nu: int, R: int, r: int) -> int:
    """Stage buffers a warp of the backward instance
    (``FixedLayout::kBuffers``): two where FIXED_MIN_BLOCKS blocks of
    STREAMED_WARPS warps fit an SM with them, else one."""
    two = 2 * _fixed_stage_floats(nx, nu, R, r) + _fixed_scratch_floats(
        nx, nu, R, r)
    fits = FIXED_MIN_BLOCKS * (4 * STREAMED_WARPS * two + BLOCK_SMEM_RESERVE)
    return 2 if fits <= SM_SMEM else 1


def backward_fixed_smem_bytes(nx: int, nu: int, R: int, r: int) -> int:
    """Dynamic shared memory a warp of the backward instance
    ``riccati_general_backward_fixed<nx, nu, R, r>`` takes
    (``FixedLayout::kFloats`` in csrc/riccati_backward_fixed.cuh): its
    stage buffers (:func:`backward_fixed_buffers`) and the scratch; a block
    takes STREAMED_WARPS times as much."""
    return 4 * (backward_fixed_buffers(nx, nu, R, r)
                * _fixed_stage_floats(nx, nu, R, r)
                + _fixed_scratch_floats(nx, nu, R, r))


def _caps_exceeded(nx: int, nu: int, R: int = 1, r: int = 0) -> list:
    """The envelope caps a shape exceeds, as the JAX package's
    ``kernel_plan`` names them ("nu=17 > 16")."""
    caps = []
    if nx > STREAMED_MAX_NX:
        caps.append(f"nx={nx} > {STREAMED_MAX_NX}")
    if nu > STREAMED_MAX_NU:
        caps.append(f"nu={nu} > {STREAMED_MAX_NU}")
    if R > GENERAL_MAX_R:
        caps.append(f"R={R} > {GENERAL_MAX_R}")
    if r > nu:
        caps.append(f"r={r} > nu={nu}")
    return caps


def kernel_plan(H: int, nx: int, nu: int, device, R: int = 1,
                r: int = 0) -> dict:
    """Which sweep a problem of these dims takes on ``device``, and why.

    A pure function of (H, nx, nu, device type, R, r): ``{"path": "plain" |
    "cuda_fused" | "cuda_streamed" | "cuda_fused_general" |
    "cuda_streamed_general" | "plain_fallback" | "unsupported", "reason":
    str}``.  R is the general sweep's number of right-hand sides (1 +
    trajectory-level border rows) and r its stage equality rows; (R, r) =
    (1, 0) is the plain sweep.
    A general shape that csrc/riccati_general_fused.cu instantiates takes
    the fused general kernel before the streamed general pair is asked; its
    plan also names the kernel (``"kernel"``: STAGED_KERNEL, or
    DIRECT_KERNEL at a horizon where not one problem fits in a staged
    block) and the staged block's problems (``"block_problems"``, 0 for the
    direct kernel).  So does the fused plain plan: STAGED_KERNEL (at
    <nx, nu, 1, 0>), or SWEEP_KERNEL (csrc/riccati_sweep.cu) at a horizon
    where not one problem fits.
    A CUDA shape (H >= 1) outside every kernel's envelope plans
    ``"plain_fallback"``, its reason naming each cap it exceeds: the
    dispatch runs the plain PyTorch version on the card, as the JAX
    package's plan sends such shapes to its scan.  ``"unsupported"`` is
    left for H < 1 and devices that are neither the CPU nor CUDA.
    """
    kind = torch.device(device).type
    if kind == "cpu":
        return {"path": "plain",
                "reason": "CPU tensors take the plain PyTorch sweep"}
    on_card = kind == "cuda" and H >= 1
    caps = "; ".join(_caps_exceeded(nx, nu, R, r)) or "outside the envelope"
    if (R, r) != (1, 0):
        if on_card and (nx, nu, R, r) in _GENERAL_INSTANCES:
            P = staged_block_problems(H, nx, nu, R, r)
            how = (f"{P} problems a block in shared memory" if P else
                   f"not one problem's {H} stages fit in shared memory")
            return {"path": "cuda_fused_general",
                    "kernel": STAGED_KERNEL if P else DIRECT_KERNEL,
                    "block_problems": P,
                    "reason": f"csrc/{GENERAL_FUSED_SOURCE} instantiates "
                              f"<{nx}, {nu}, {R}, {r}>; {how}"}
        if on_card and _general_fits(nx, nu, R, r):
            return {"path": "cuda_streamed_general",
                    "reason": f"csrc/{GENERAL_SOURCE} takes nx={nx}, "
                              f"nu={nu}, R={R}, r={r} at run time"}
        envelope = (f"csrc/{GENERAL_SOURCE} takes nx <= {STREAMED_MAX_NX}, "
                    f"nu <= {STREAMED_MAX_NU}, 1 <= R <= {GENERAL_MAX_R}, "
                    "r <= nu")
        if on_card:
            return {"path": "plain_fallback",
                    "reason": (f"no CUDA general sweep for H={H}, nx={nx}, "
                               f"nu={nu}, R={R}, r={r} ({caps}): {envelope}; "
                               "the plain PyTorch sweep runs on the card")}
        return {"path": "unsupported",
                "reason": (f"no CUDA general sweep for H={H}, nx={nx}, "
                           f"nu={nu}, R={R}, r={r} on {kind}: {envelope}")}
    if on_card:
        if (nx, nu) in _INSTANCES:
            P = staged_block_problems(H, nx, nu, 1, 0)
            how = (f"csrc/{GENERAL_FUSED_SOURCE}'s staged kernel at <{nx}, "
                   f"{nu}, 1, 0>, {P} problems a block in shared memory"
                   if P else
                   f"csrc/{SOURCE} <{nx}, {nu}>: not one problem's {H} "
                   "stages fit in shared memory")
            return {"path": "cuda_fused",
                    "kernel": STAGED_KERNEL if P else SWEEP_KERNEL,
                    "block_problems": P,
                    "reason": f"the fused plain sweep at (nx, nu) = ({nx}, "
                              f"{nu}): {how}"}
        if _streamed_fits(nx, nu):
            return {"path": "cuda_streamed",
                    "backward_kernel": backward_kernel(nx, nu),
                    "forward_kernel": forward_kernel(nx, nu),
                    "reason": f"csrc/{STREAMED_SOURCE} takes nx={nx}, "
                              f"nu={nu} at run time"}
    envelope = (f"csrc/{SOURCE} instantiates {sorted(_INSTANCES)} and "
                f"csrc/{STREAMED_SOURCE} takes nx <= {STREAMED_MAX_NX}, nu <= "
                f"{STREAMED_MAX_NU} (the reference kernel's own nu cap)")
    if on_card:
        return {"path": "plain_fallback",
                "reason": (f"no CUDA sweep for H={H}, nx={nx}, nu={nu} "
                           f"({caps}): {envelope}; the plain PyTorch sweep "
                           "runs on the card")}
    return {"path": "unsupported",
            "reason": (f"no CUDA sweep for H={H}, nx={nx}, nu={nu} on "
                       f"{kind}: {envelope}")}


def fallback(sweep: str, plan: dict, fn, args, dims) -> tuple:
    """Run ``fn(*args)``, the plain ``sweep`` ("plain" or "general") that
    ``plan`` (``"plain_fallback"``) sends off the kernels: one CUDA graph
    replay on the card (:func:`replay`), ``fn`` itself on the CPU.  It
    counts one plain call and one fallback, and warns the first time a
    shape ``dims`` = (B, H, nx, nu, R, r) takes it (the JAX package's
    ``_warn_out_of_envelope``)."""
    global FALLBACK_CALLS, PLAIN_CALLS
    FALLBACK_CALLS += 1
    PLAIN_CALLS += 1
    Bn, H, nx, nu, R, r = dims
    key = (sweep, H, nx, nu, R, r)
    if key not in _WARNED:
        _WARNED.add(key)
        warnings.warn(
            f"Riccati {sweep} sweep (H={H}, nx={nx}, nu={nu}, R={R}, r={r}, "
            f"batch={Bn}) is outside every CUDA kernel's envelope "
            f"({plan['reason']}); its plain PyTorch version runs on the "
            "card, as one CUDA graph captured at the shape's first call "
            "(see pyneuralempc_tpu_torch.ops.cuda.riccati_kernel."
            "kernel_plan)", stacklevel=3)
    if args[0].device.type == "cuda":
        return replay(fn, args)
    return fn(*args)


# ---- bytes and operations (the least the card must do) ----
#
# R (right-hand sides) and r (stage equality rows) give the general sweep's
# counts (riccati_general.py); the plain sweep is R=1, r=0.

def _bwd_stage_flops(nx: int, nu: int, R: int = 1, r: int = 0) -> int:
    """Operations of one backward stage, counted from its formulae with one
    Cholesky factorisation of Quu (and of the Schur complement S when
    r > 0) at the δ=0 level."""
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
        n += (r * r * (2 * nu + 1)            # S = E Y + δ_c I
              + (nx + R) * r * (2 * nu + 1)   # Schur right-hand sides
              + r * r * r // 3 + 2 * r        # Cholesky of S
              + (nx + R) * 2 * r * r          # its substitutions
              + nu * nx * 2 * r + R * nu * 2 * r)   # K, k corrections
    return n


def _fwd_stage_flops(nx: int, nu: int, R: int = 1, r: int = 0) -> int:
    ns = nx + nu
    return R * (2 * nu * nx + nu               # du
                + r * (2 * nx + 1)             # dnu
                + nx * (2 * ns + 1)            # dx'
                + nx * (2 * ns + 1 + 2 * r))   # dlam


def _input_floats(H: int, nx: int, nu: int, R: int = 1, r: int = 0) -> int:
    """A, B, the upper triangles of G and M (all the sweep needs of them,
    and all the kernels read), mx, mu, c (and h, E, F) of one problem, with
    its δ (and δ_c)."""
    ns = nx + nu
    per_stage = (nx * nx + nx * nu + ns * (ns + 1) + R * (2 * nx + nu)
                 + r * (R + nu + nx))
    return H * per_stage + 1 + (1 if r else 0)


def _output_floats(H: int, nx: int, nu: int, R: int = 1, r: int = 0) -> int:
    """dX, dU, dLam (and dNu) of one problem."""
    return H * R * (2 * nx + nu + r)


def sweep_bytes(Bn: int, H: int, nx: int, nu: int, R: int = 1,
                r: int = 0) -> int:
    """Least bytes a fused sweep must move: every input read once (the
    general one's Jx too), every output written once, one ok byte a
    problem; the gains between the two passes never count."""
    floats = (_input_floats(H, nx, nu, R, r) + H * r * nx
              + _output_floats(H, nx, nu, R, r))
    return 4 * Bn * floats + Bn


def sweep_flops(Bn: int, H: int, nx: int, nu: int, R: int = 1,
                r: int = 0) -> int:
    """Operations of one sweep (backward and forward)."""
    return Bn * H * (_bwd_stage_flops(nx, nu, R, r)
                     + _fwd_stage_flops(nx, nu, R, r))


def backward_bytes(Bn: int, H: int, nx: int, nu: int, R: int = 1,
                   r: int = 0) -> int:
    """Least bytes a streamed backward kernel must move: the sweep's inputs
    read once, the gains written once, one ok byte a problem."""
    outs = H * gain_width(nx, nu, R, r)
    return 4 * Bn * (_input_floats(H, nx, nu, R, r) + outs) + Bn


def backward_flops(Bn: int, H: int, nx: int, nu: int, R: int = 1,
                   r: int = 0) -> int:
    return Bn * H * _bwd_stage_flops(nx, nu, R, r)


def forward_bytes(Bn: int, H: int, nx: int, nu: int, R: int = 1,
                  r: int = 0) -> int:
    """Least bytes a streamed forward kernel must move: A, B, c (and Jx)
    and the gains read once, dX, dU, dLam (and dNu) written once."""
    ins = H * (nx * nx + nx * nu + R * nx + r * nx
               + gain_width(nx, nu, R, r))
    return 4 * Bn * (ins + _output_floats(H, nx, nu, R, r))


def forward_flops(Bn: int, H: int, nx: int, nu: int, R: int = 1,
                  r: int = 0) -> int:
    return Bn * H * _fwd_stage_flops(nx, nu, R, r)


# ---- plain PyTorch versions ----

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


def cho_solve(X, L):
    """L Lᵀ Z = X for Z, as two batched triangular solves (what
    ``torch.cholesky_solve`` computes; on the card it goes through MAGMA,
    which a CUDA graph cannot capture, and these through cuBLAS)."""
    Y = torch.linalg.solve_triangular(L, X, upper=False)
    return torch.linalg.solve_triangular(L.mT, Y, upper=True)


def _mv(Mat, v):
    return (Mat @ v.unsqueeze(-1)).squeeze(-1)


def _backward(A, B, G, M, mx, mu, c, delta):
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
        K = -cho_solve(Qux, L)
        k = -cho_solve(qu.unsqueeze(-1), L).squeeze(-1)
        okc = okc & ok_t
        P_new = Qxx + Qux.mT @ K
        P = 0.5 * (P_new + P_new.mT)
        p = qx + _mv(Qux.mT, k)
        gains[t] = torch.cat([K.reshape(Bn, nu * nx), k,
                              Pbar.reshape(Bn, nx * nx), pbar,
                              Mxu.reshape(Bn, nx * nu)], dim=-1)
    return torch.stack(gains, 1), okc


def _forward(A, B, c, gains):
    Bn, H, nx = c.shape
    nu = B.shape[-1]
    o_k, o_Pb = nu * nx, nu * nx + nu
    o_pb = o_Pb + nx * nx
    o_Mxu = o_pb + nx
    dx = torch.zeros((Bn, nx), dtype=A.dtype, device=A.device)
    dXs, dUs, dLams = [], [], []
    for t in range(H):
        g = gains[:, t]
        K = g[:, :o_k].reshape(Bn, nu, nx)
        Pbar = g[:, o_Pb:o_pb].reshape(Bn, nx, nx)
        Mxu = g[:, o_Mxu:].reshape(Bn, nx, nu)
        du = _mv(K, dx) + g[:, o_k:o_Pb]
        dx = _mv(A[:, t], dx) + _mv(B[:, t], du) + c[:, t]
        dXs.append(dx)
        dUs.append(du)
        dLams.append(_mv(Pbar, dx) + _mv(Mxu, du) + g[:, o_pb:o_Mxu])
    return torch.stack(dXs, 1), torch.stack(dUs, 1), torch.stack(dLams, 1)


def riccati_backward_plain(A, B, G, M, mx, mu, c, delta):
    """Plain backward sweep: a Python loop from the last stage to the
    first, each stage a batched small-matrix step.  Returns ``(gains,
    ok)``."""
    global PLAIN_CALLS
    PLAIN_CALLS += 1
    return _backward(A, B, G, M, mx, mu, c, delta)


def riccati_forward_plain(A, B, c, gains):
    """Plain forward sweep from the backward sweep's gains: du = K dx + k,
    dx' = A dx + B du + c, dlam = Pbar dx' + Mxu du + pbar.  Returns
    ``(dX, dU, dLam)``."""
    global PLAIN_CALLS
    PLAIN_CALLS += 1
    return _forward(A, B, c, gains)


def _sweep(A, B, G, M, mx, mu, c, delta):
    gains, ok = _backward(A, B, G, M, mx, mu, c, delta)
    return _forward(A, B, c, gains) + (ok,)


def riccati_sweep_plain(A, B, G, M, mx, mu, c, delta):
    """Plain sweep: :func:`riccati_backward_plain` then
    :func:`riccati_forward_plain`."""
    global PLAIN_CALLS
    PLAIN_CALLS += 1
    return _sweep(A, B, G, M, mx, mu, c, delta)


# CUDA graphs of plain sweeps that the fallback replays, keyed by function,
# device and input shapes and dtypes, the most recently used last; at most
# GRAPHS_KEPT (a graph keeps its sweep's intermediates: ~3 GB at B=1024,
# H=100, (34, 1))
_GRAPHS = {}
GRAPHS_KEPT = 4


def replay(fn, args):
    """``fn(*args)`` (a plain sweep, on CUDA tensors) as one CUDA graph,
    captured at the first call of each input shape and replayed after.
    A plain sweep is ~120 small launches a stage, each some 20 µs of the
    host's time, where the card is busy for ~2; a replay issues them at
    once.  The same kernels run in the same order, so the outputs are
    ``fn``'s bit for bit."""
    dev = args[0].device
    key = (fn, dev) + tuple((tuple(a.shape), a.dtype) for a in args)
    entry = _GRAPHS.pop(key, None)
    if entry is None:
        static = [a.clone() for a in args]
        # no autograd graph: a kernel's outputs carry none either
        with torch.cuda.device(dev), torch.no_grad():
            # one call outside the capture, so that cuBLAS and cuSOLVER set
            # up their workspaces first
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                fn(*static)
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                out = fn(*static)
        entry = (graph, static, out)
    _GRAPHS[key] = entry
    while len(_GRAPHS) > GRAPHS_KEPT:
        _GRAPHS.pop(next(iter(_GRAPHS)))
    graph, static, out = entry
    for s, a in zip(static, args):
        s.copy_(a)
    graph.replay()
    return tuple(o.clone() for o in out)


# ---- CUDA wrappers ----

_ENTRIES = {}     # C entry points, bound on first launch


def _entry(source, name, n_ptrs, n_ints=5):
    """The C entry point ``name`` of ``csrc/<source>``: ``n_ptrs`` pointers,
    ``n_ints`` ints (dims, then the device), then the stream."""
    fn = _ENTRIES.get(name)
    if fn is None:
        from .build import load
        fn = getattr(load(source), name)
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _ENTRIES[name] = fn
    return fn


def _check(dev, want):
    """Every tensor of ``want`` ({name: (tensor, shape)}) float32,
    contiguous, of its shape, on the CUDA device ``dev``."""
    for name, (t, shape) in want.items():
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name} must lie on {dev} (a CUDA device), "
                             f"got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_sweep_inputs(A, B, G, M, mx, mu, c, delta):
    if c.dim() != 3:
        raise ValueError(f"c must be (B, H, nx), got {tuple(c.shape)}")
    Bn, H, nx = c.shape
    nu = B.shape[-1]
    ns = nx + nu
    _check(c.device, {
        "A": (A, (Bn, H, nx, nx)), "B": (B, (Bn, H, nx, nu)),
        "G": (G, (Bn, H, ns, ns)), "M": (M, (Bn, H, ns, ns)),
        "mx": (mx, (Bn, H, nx)), "mu": (mu, (Bn, H, nu)),
        "c": (c, (Bn, H, nx)), "delta": (delta, (Bn,))})
    if Bn == 0 or H == 0:
        raise ValueError("the CUDA sweeps need B >= 1 and H >= 1")
    return Bn, H, nx, nu


def _raise_on(err, what, Bn, H, nx, nu):
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err} "
                           f"(B={Bn}, H={H}, nx={nx}, nu={nu})")


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def _aligned_mask(tensors):
    """Bit i set where ``tensors[i]`` starts on a 16-byte boundary: the
    ranges of such an input may take bulk copies into shared memory (the
    staged kernel copies the others 4 bytes at a time)."""
    return sum(1 << i for i, t in enumerate(tensors)
               if t is not None and t.data_ptr() % 16 == 0)


def _sweep_launch(direct, A, B, G, M, mx, mu, c, delta):
    """The fused plain sweep: the staged kernel of
    ``csrc/riccati_general_fused.cu`` at <nx, nu, 1, 0> where a block holds
    a problem at this horizon and ``direct`` is false, else
    ``csrc/riccati_sweep.cu``."""
    global LAUNCHES, STAGED_LAUNCHES, DIRECT_LAUNCHES
    Bn, H, nx, nu = _check_sweep_inputs(A, B, G, M, mx, mu, c, delta)
    if (nx, nu) not in _INSTANCES:
        raise NotImplementedError(
            f"csrc/{SOURCE} instantiates {sorted(_INSTANCES)} only, not "
            f"nx={nx}, nu={nu}; riccati_sweep_streamed_cuda takes it")
    staged = not direct and staged_block_problems(H, nx, nu, 1, 0) > 0
    dev = c.device
    dX = torch.empty((Bn, H, nx), dtype=torch.float32, device=dev)
    dU = torch.empty((Bn, H, nu), dtype=torch.float32, device=dev)
    dLam = torch.empty((Bn, H, nx), dtype=torch.float32, device=dev)
    ok = torch.empty((Bn,), dtype=torch.bool, device=dev)
    if staged:
        # the general sweep at R = 1, r = 0: mx, mu, c are its (B,H,1,·)
        # right-hand sides, δ stands for δ_c (not read), E, F, h, Jx and
        # dNu are empty, and the gains stay in shared memory
        entry = "riccati_general_fused_f32"
        ins = (A, B, G, M, mx, mu, c, delta, delta, None, None, None, None)
        err = _entry(GENERAL_FUSED_SOURCE, entry, 20, 8)(
            *[None if t is None else t.data_ptr() for t in ins],
            dX.data_ptr(), dU.data_ptr(), dLam.data_ptr(), None,
            ok.data_ptr(), None, None, Bn, H, nx, nu, 1, 0,
            _aligned_mask(ins), dev.index or 0, _stream(dev))
    else:
        entry = "riccati_sweep_f32"
        gains = torch.empty((Bn, H, gain_width(nx, nu)), dtype=torch.float32,
                            device=dev)
        err = _entry(SOURCE, entry, 13)(
            A.data_ptr(), B.data_ptr(), G.data_ptr(), M.data_ptr(),
            mx.data_ptr(), mu.data_ptr(), c.data_ptr(), delta.data_ptr(),
            dX.data_ptr(), dU.data_ptr(), dLam.data_ptr(), ok.data_ptr(),
            gains.data_ptr(), Bn, H, nx, nu, dev.index or 0, _stream(dev))
    _raise_on(err, entry, Bn, H, nx, nu)
    LAUNCHES += 1
    if staged:
        STAGED_LAUNCHES += 1
    else:
        DIRECT_LAUNCHES += 1
    return dX, dU, dLam, ok


def riccati_sweep_cuda(A, B, G, M, mx, mu, c, delta):
    """Launch the fused plain sweep on CUDA tensors (no fallback): the
    staged kernel of ``csrc/riccati_general_fused.cu`` at <nx, nu, 1, 0>
    where a block holds at least one problem at this horizon
    (``kernel_plan``'s ``"kernel"``), ``csrc/riccati_sweep.cu`` where none
    fits.  Inputs that do not start on a 16-byte boundary are copied 4
    bytes at a time, never refused.

    Raises on a tensor that is not float32, not contiguous, not on one CUDA
    device, of the wrong shape, or of an (nx, nu) with no instantiation.
    """
    return _sweep_launch(False, A, B, G, M, mx, mu, c, delta)


def riccati_sweep_direct_cuda(A, B, G, M, mx, mu, c, delta):
    """:func:`riccati_sweep_cuda` with ``csrc/riccati_sweep.cu`` (the first
    design: every stage from device memory, the gains in a device scratch)
    at every horizon.  Not on the solver's path: it lets one run hold the
    two designs against each other and time both."""
    return _sweep_launch(True, A, B, G, M, mx, mu, c, delta)


def _require_streamed(nx, nu):
    if not _streamed_fits(nx, nu):
        raise NotImplementedError(
            f"csrc/{STREAMED_SOURCE} takes nx <= {STREAMED_MAX_NX}, nu <= "
            f"{STREAMED_MAX_NU}, not nx={nx}, nu={nu}")


def _backward_launch(entry, A, B, G, M, mx, mu, c, delta):
    Bn, H, nx, nu = _check_sweep_inputs(A, B, G, M, mx, mu, c, delta)
    _require_streamed(nx, nu)
    fn = _entry(STREAMED_SOURCE, entry, 10)
    dev = c.device
    gains = torch.empty((Bn, H, gain_width(nx, nu)), dtype=torch.float32,
                        device=dev)
    ok = torch.empty((Bn,), dtype=torch.bool, device=dev)
    err = fn(A.data_ptr(), B.data_ptr(), G.data_ptr(), M.data_ptr(),
             mx.data_ptr(), mu.data_ptr(), c.data_ptr(), delta.data_ptr(),
             gains.data_ptr(), ok.data_ptr(), Bn, H, nx, nu, dev.index or 0,
             _stream(dev))
    _raise_on(err, entry, Bn, H, nx, nu)
    return gains, ok, (nx, nu)


def riccati_backward_cuda(A, B, G, M, mx, mu, c, delta):
    """Launch the streamed backward kernel of ``csrc/riccati_streamed.cu``
    on CUDA tensors (no fallback): the compile-time instance at the shapes
    of ``_BACKWARD_INSTANCES``, the run-time kernel at any other.  Returns
    ``(gains, ok)`` as :func:`riccati_backward_plain` does."""
    global BACKWARD_LAUNCHES, BACKWARD_INSTANCE_LAUNCHES
    gains, ok, shape = _backward_launch("riccati_backward_f32", A, B, G, M,
                                        mx, mu, c, delta)
    BACKWARD_LAUNCHES += 1
    if shape in _BACKWARD_INSTANCES:
        BACKWARD_INSTANCE_LAUNCHES += 1
    return gains, ok


def riccati_backward_runtime_cuda(A, B, G, M, mx, mu, c, delta):
    """:func:`riccati_backward_cuda` with the run-time backward kernel at
    every shape.  Not on the solver's path: it lets one run hold the
    instance against the run-time kernel and time both."""
    global BACKWARD_RUNTIME_LAUNCHES
    gains, ok, _ = _backward_launch("riccati_backward_runtime_f32", A, B, G,
                                    M, mx, mu, c, delta)
    BACKWARD_RUNTIME_LAUNCHES += 1
    return gains, ok


def _forward_launch(entry, A, B, c, gains):
    if c.dim() != 3:
        raise ValueError(f"c must be (B, H, nx), got {tuple(c.shape)}")
    Bn, H, nx = c.shape
    nu = B.shape[-1]
    _check(c.device, {"A": (A, (Bn, H, nx, nx)), "B": (B, (Bn, H, nx, nu)),
                      "c": (c, (Bn, H, nx)),
                      "gains": (gains, (Bn, H, gain_width(nx, nu)))})
    if Bn == 0 or H == 0:
        raise ValueError("the CUDA sweeps need B >= 1 and H >= 1")
    _require_streamed(nx, nu)
    fn = _entry(STREAMED_SOURCE, entry, 7)
    dev = c.device
    dX = torch.empty((Bn, H, nx), dtype=torch.float32, device=dev)
    dU = torch.empty((Bn, H, nu), dtype=torch.float32, device=dev)
    dLam = torch.empty((Bn, H, nx), dtype=torch.float32, device=dev)
    err = fn(A.data_ptr(), B.data_ptr(), c.data_ptr(), gains.data_ptr(),
             dX.data_ptr(), dU.data_ptr(), dLam.data_ptr(), Bn, H, nx, nu,
             dev.index or 0, _stream(dev))
    _raise_on(err, entry, Bn, H, nx, nu)
    return (dX, dU, dLam), (nx, nu)


def riccati_forward_cuda(A, B, c, gains):
    """Launch the streamed forward kernel of ``csrc/riccati_streamed.cu``
    on CUDA tensors (no fallback): the compile-time instance at the shapes
    of ``_FORWARD_INSTANCES``, the run-time kernel at any other.  Returns
    ``(dX, dU, dLam)`` as :func:`riccati_forward_plain` does.  Inputs that
    do not start on a 16-byte boundary are copied in narrower pieces, never
    refused."""
    global FORWARD_LAUNCHES, FORWARD_INSTANCE_LAUNCHES
    out, shape = _forward_launch("riccati_forward_f32", A, B, c, gains)
    FORWARD_LAUNCHES += 1
    if shape in _FORWARD_INSTANCES:
        FORWARD_INSTANCE_LAUNCHES += 1
    return out


def riccati_forward_runtime_cuda(A, B, c, gains):
    """:func:`riccati_forward_cuda` with the run-time forward kernel at
    every shape.  Not on the solver's path: it lets one run hold the
    instance against the run-time kernel and time both."""
    global FORWARD_RUNTIME_LAUNCHES
    out, _ = _forward_launch("riccati_forward_runtime_f32", A, B, c, gains)
    FORWARD_RUNTIME_LAUNCHES += 1
    return out


def riccati_sweep_streamed_cuda(A, B, G, M, mx, mu, c, delta):
    """The streamed sweep on CUDA tensors: the backward kernel writes one
    gains buffer (allocated once per call), the forward kernel reads it;
    both launch on PyTorch's current stream."""
    gains, ok = riccati_backward_cuda(A, B, G, M, mx, mu, c, delta)
    return riccati_forward_cuda(A, B, c, gains) + (ok,)


def riccati_sweep(A, B, G, M, mx, mu, c, delta):
    """Dispatch on :func:`kernel_plan`: CPU -> plain version, CUDA -> the
    fused or the streamed kernels, or, outside every kernel's envelope, the
    plain version on the card as a CUDA graph replay (counted in
    ``FALLBACK_CALLS``, one warning a shape); anything else raises."""
    Bn, H, nx = c.shape
    nu = B.shape[-1]
    plan = kernel_plan(H, nx, nu, c.device)
    if plan["path"] == "plain_fallback":
        return fallback("plain", plan, _sweep, (A, B, G, M, mx, mu, c, delta),
                        (Bn, H, nx, nu, 1, 0))
    if plan["path"] == "plain":
        return riccati_sweep_plain(A, B, G, M, mx, mu, c, delta)
    if plan["path"] == "cuda_fused":
        return riccati_sweep_cuda(A, B, G, M, mx, mu, c, delta)
    if plan["path"] == "cuda_streamed":
        return riccati_sweep_streamed_cuda(A, B, G, M, mx, mu, c, delta)
    raise NotImplementedError(plan["reason"])
