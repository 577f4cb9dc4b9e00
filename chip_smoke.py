#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Phases (each raises, and the script exits non-zero, on failure):

1. Device: the card's name and power limit, torch and CUDA versions; TF32
   matmuls off.  No CUDA device -> exit 1 with no result.
2. Build: nvcc compiles every kernel of the port from the checkout's
   sources (pyneuralempc_tpu_torch/csrc/*.cu and their headers: the
   backward and forward templates two of them share,
   riccati_backward_fixed.cuh and riccati_forward_fixed.cuh, and the
   copy primitives, bulk_copy.cuh),
   one nvcc for each source, all started together; ptxas registers and
   spills are logged.
3. Fused kernel vs plain: the fused sweep (riccati_sweep_cuda: the staged
   kernel of csrc/riccati_general_fused.cu at <2, 1, 1, 0>) against its
   plain PyTorch version and against the first design
   (csrc/riccati_sweep.cu, riccati_sweep_direct_cuda) at the LV path's
   shapes (B=4096, H=20, nx=2, nu=1) on four seeded cases, with its median
   device time (the kernel's own events in a torch.profiler trace, held
   against the same calls back to back between CUDA events, queued behind
   a spin so that the host's pace opens no gap between them: a window that
   holds no such kernel, or reads it under 80% of that time less an empty
   launch's where it is the window's only kernel, is traced again, and
   raises when five do), its time per wrapper call (CUDA
   events, host work included), the plain version's time and the least
   time the card could take (bound); then both designs' device times in
   turns (riccati_sweep.cu, staged; once a,b,b,a), warm and
   with L2 flushed, and ptxas's report of both.
3b. Streamed pair vs plain: the backward and forward kernels
   (csrc/riccati_streamed.cu) at the quadrotor path's shapes (B=4096, H=50,
   nx=12, nu=4) on the same four cases: the backward kernel's gains and ok
   flags against riccati_backward_plain, the forward kernel against
   riccati_forward_plain fed the same gains, the pair against the plain
   sweep; then the pair against the fused kernel at (2, 1).  At this shape
   both entries launch their compile-time instances
   (riccati_general_backward_fixed<12, 4, 1, 0> and
   riccati_general_forward_fixed<12, 4, 1, 0, D>, the general sweep's
   templates from csrc/riccati_backward_fixed.cuh and
   csrc/riccati_forward_fixed.cuh); each is also held against its run-time
   kernel (riccati_backward_runtime_cuda, riccati_forward_runtime_cuda) on
   the same inputs, and the two designs of each are timed in turns
   (run-time, instance; once a,b,b,a), warm and with L2 flushed,
   with ptxas's report of each.  Times as in 3.
3c. General pair vs plain: the general backward and forward kernels
   (csrc/riccati_general.cu) at the EQ/border quadrotor path's shapes
   (B=4096, H=50, nx=12, nu=4, R=2 right-hand sides, r=1 stage equality
   row) on the four cases (per-problem delta_c too): gains and ok flags
   against riccati_general_backward_plain, the forward kernel against the
   plain forward fed the same gains, the pair against the plain general
   sweep.  At this shape the backward entry launches its compile-time
   instance (riccati_general_backward_fixed<12, 4, 2, 1>); its gains and
   ok flags are also held against the run-time backward kernel
   (riccati_general_backward_runtime_cuda) on the same inputs, and both
   designs are timed.  The forward entry launches its compile-time
   instance too (riccati_general_forward_fixed<12, 4, 2, 1>, a ring of
   stage slots a warp): on the four cases at H=50 and at H=7, and on
   inputs 4 bytes off a 16-byte boundary, it is held against the plain
   forward and the run-time forward kernel
   (riccati_general_forward_runtime_cuda) fed the same gains; the run-time
   kernel and the instance are timed in turns, warm and with L2 flushed,
   each timed instance launch's outputs held to the checked ones bit for
   bit, with ptxas's report of each.  Then one border-only case (R=2, r=0), one
   pure-EQ case (R=1, r=nu, H=10), and the pair at R=1, r=0 against the
   plain streamed pair: these shapes take the run-time kernels, so they
   keep covering them.  Times as in 3.
3d. Fused general kernels vs plain: csrc/riccati_general_fused.cu at the
   budgeted LV path's shapes (B=4096, H=20, nx=2, nu=1) at (R, r) = (2, 0),
   (2, 1), (3, 0) and (3, 1) on the four cases (local_bump only at r=0: it
   decouples a control from the equality rows, which needs r < nu), at
   (1, 1) with H=10, and at (2, 0) with H=50 (24 problems a block, the
   last block ragged): the staged kernel (the solver's) against
   riccati_sweep_general_plain / riccati_general_backward_plain (ok flags,
   every output, the gains it writes when asked), against the direct
   kernel (the first design) and against the streamed general pair on the
   same inputs.  Times as in 3 for the staged kernel; then both kernels'
   device times in turns (direct, staged; once a,b,b,a), as the path
   finds the inputs (warm in L2) and with a 256 MB write before each
   launch (L2 flushed); the staged kernel's phases (prologue, backward,
   forward, epilogue) from its per-block clock stamps, warm and flushed;
   the staged block's problems and shared memory, and ptxas's report of
   both kernels; the streamed general pair timed at the same shape.
3e. Streamed instances at the new paths' stages: the GRU fleet's lifted
   (10, 1) at H=100, B=16384 (the four cases drawn at B=4096 and repeated
   4 times on the card) and cartpole's (4, 1) at H=50 (the four cases at
   B=4096, and each case's first problem alone, the path's B=1), as 3b
   against the plain halves, the run-time kernels and the plain sweep;
   timed as in 3b at the paths' shapes ((4, 1) at B=4096 too, and at the
   multi-start's B=8 without the turns).  So too the quadrotor GRU's
   lifted (28, 4) at H=100, B=4096 (the cases drawn at B=1024 and
   repeated 4 times): the instances riccati_general_backward_fixed<28,
   4, 1, 0> (the tall tiles at nu = 4) and riccati_general_forward_fixed<
   28, 4, 1, 0, D>, whose launches the benchmark cell
   quadrotor_gru.track_b4096 counts (0 here).  Then the
   wide fleet's (12, 10) at H=50, B=4096 (the cases drawn at B=1024 and
   repeated 4 times): the backward entry takes its instance
   riccati_general_backward_fixed<12, 10, 1, 0> there (Quu factored one
   row a lane, one stage buffer a warp), the forward entry its instance
   riccati_general_forward_fixed<12, 10, 1, 0, D>; both against the plain
   halves, the run-time kernels and the plain sweep, the forward instance
   bit for bit against the run-time forward kernel and against its other
   candidate depth (a second build of riccati_streamed.cu at W_ALT_DEPTH,
   from the same source with that one case edited); both timed, each
   instance in turns against its run-time kernel, the forward one against
   the other depth too, warm and with L2 flushed, with ptxas's report of
   each (chip_backward_designs.py times the backward instance's other
   designs).
4. LV path: trains the 2x32 tanh MLP surrogate of the Lotka-Volterra
   system on the card, builds NMPC as bench.py does, solves B=4096 cold and
   then warm re-plans, the plant advanced by the true ODE through the port's
   RK4.  Launch counters are zeroed just before and read just after: the
   fused kernel must have launched, every launch through the staged
   kernel, and the streamed pair and the plain sweep must not have.  Then
   one cold solve whose params are the surrogate stacked B times (one
   model per member): the shared cold solve's converged mask, and its
   controls within 1e-5 on the members f32 fixes (the shared solve from
   starts moved by ±1e-7 moves them by at most 5e-5, with the same
   iterations), within 1e-5 + 2× their own move on the others.
4b. Quadrotor path: NMPC of the quadrotor (true ODE, H=50, RK4, StageCost
   with a terminal term, box bounds) on B=4096 starts, bench.py's protocol:
   one cold solve, one untimed warm re-plan, then timed warm re-plans, each
   from the plan's first state.  Counters as in 4: the streamed pair must
   have launched, every backward and every forward launch through its
   compile-time instance, and the run-time kernels, the fused kernel and
   the plain sweep must not have.
4c. EQ/border quadrotor path: the quadrotor with a zero-net-yaw-torque
   stage equality row and a horizon thrust-impulse budget row
   (pyneuralempc_tpu_torch/examples/fleet_eq.py) on B=4096 starts, 4b's
   protocol.  Counters: the general pair must have launched, every
   backward and every forward launch through its compile-time instance,
   and every other kernel and plain version must not have.  Every plan
   converged (up to 4 of 4096) keeps |u0 - u1 + u2 - u3| <= 1e-4 and its
   thrust impulse within the budget.
4d. Budgeted LV path: the LV MLP fleet (phase 4's trained surrogate) with a
   minimum feed delivery over the horizon, Σu ≥ U_FLOOR
   (pyneuralempc_tpu_torch/examples/lotka_volterra.py: one trajectory-level
   row, R=2, r=0), on B=4096: one cold solve and WARM_STEPS timed warm
   re-plans as in phase 4, then one closed_loop_batch run (api/simulate.py, steps=16,
   replan_every=2: a cold solve and 8 warm re-plans) against the true ODE.
   Counters: the fused general kernel must have launched, every launch
   through its staged kernel, and nothing else in either run; every plan
   converged (up to 4 of 4096) on every solve; the floor held on every
   converged plan and binding on 5-95% of the converged cold plans.
   Closed loop: solves/s, the largest state-box violation on the true
   plant, the mean feed cost.
4e. GRU fleet (pyneuralempc_tpu_torch/examples/fleet_rnn.py at its full
   size, BASELINE config 5): the GRU fit on the card (3000 Adam steps on
   512 x 32 plant sequences), then B=16384 lifted (10-state) problems,
   H=100: a cold solve, one untimed and 1 timed warm re-plan.  Counters
   as in 4b: both instances, at (10, 1); at least 16368/16384 converged on
   every solve.
4f. Cartpole (pyneuralempc_tpu_torch/examples/cartpole.py, BASELINE
   config 3): the 60-step swing-up with the true dynamics, NMPC.next every
   2 steps on the card.  Gates: final cos θ ≥ 0.99, tip clearance ≤ 0.55
   + 1e-3, forces within ±10 + 1e-4, the plant's states within the box +
   1e-3.  Then next_multi_start(n_starts=8) from the hanging start, seed
   0.  Counters over all of it as in 4b: both instances, at (4, 1).
4g. Quadrotor MLP fleet (examples/quadrotor.py --mlp): the normalised
   surrogate fit on the card at the JAX example's settings, then B=1024,
   H=50: a cold solve, one untimed and 1 timed warm re-plan.  Counters as
   in 4b, and the tanh layers' tangent-kernel launches (csrc/tanh_dense.cu,
   K1 and K2) logged; at least 994/1024 converged on every solve; the
   cold plans approach hover.  Then K1 (tanh_tangent_fwd_cuda) and K2
   (tanh_tangent_vjp_cuda) at the benchmark cell's stage blocks (102,400
   primal rows of 16 tangents; K1 at (K, N) = (19, 256) and (256, 256),
   K2 at (256, 256) and (19, 256)): one launch a call, each output within
   2e-5 of its scale of the plain version in float64 on the same inputs,
   then timed as in 3 (device time, wrapper call, plain version, bound);
   both are entries of the kernels line.
4h. Wide fleet (pyneuralempc_tpu_torch/examples/fleet_wide.py, the JAX
   package's tools/fleet_wide_tpu.py: 12 states, 10 thrusts, H=50, RK4,
   B=4096, not cut): a cold solve, one untimed and 1 timed warm re-plan.
   Counters: the streamed pair alone, every backward and every forward
   launch through its instance (the run-time kernels never); at least
   4092/4096 converged on every solve.
4i. Solver options on the LV fleet (phase 4's surrogate, B=4096):
   mu_strategy "monotone" (phase 4's rule again, for a like protocol),
   "adaptive" and "mehrotra", a cold solve and 1 untimed and 1 timed warm
   re-plans each, through the staged fused kernel alone; the cold plans
   against phase 4's monotone cold plans on the members both converged:
   at the same solution (the objectives within 1e-6 relative) |du| <=
   1e-4 (the NLP is not convex: the others stopped at another local
   solution, counted).  The converged counts (cold, every warm re-plan)
   and the members at the same solution are held to the JAX package's own
   on this fleet, less 0.5% of B (tests/measure_torch_mu_strategies.py:
   adaptive 4096, 4096, 4085; Mehrotra 3986, 4082, 3907), and the
   converged counts to 4092 where the JAX package reaches it.  The sweeps
   a lockstep iteration against monotone's.
4j. Import: phase 4's surrogate copied into an nn.Sequential(Linear,
   Tanh, ...) on the card and loaded back by load_torch_mlp (no h5py
   needed): one cold solve at B=4096 gives phase 4's cold plans to 1e-6
   with the same converged mask.
4k. Dense backend (phase 4's fleet, B=4096): IPConfig(kkt="dense"), one
   cold solve and one timed warm re-plan (cut from two to keep the run's
   time: a dense warm re-plan takes ~10 s); its
   cold plans against phase 4's Riccati ones where the objectives agree
   to 1e-6, |du| <= 1e-4 (the NLP is not convex: the others stopped at
   another local solution, counted).  Then phase 4's cost plus move
   suppression MOVE·Σ(u_{t+1} − u_t)² under kkt="auto" (the objective
   probes stage-coupled, so the dense backend), the same protocol, the
   warm re-plan's split of prepare (the Hessian and Jacobian) against the
   batched LU (its busy share is not traced: ~2e5 device events, 35-52 s
   of the run), and 16 members against the CPU.
   Neither launches a sweep kernel or a plain sweep.  The converged counts
   and the members at the same solution are held to the JAX package's on
   this fleet less 0.5% of B (tests/measure_torch_dense_alm.py).
4l. ALM: ALMConfig() on phase 4's first ALM_B members: the converged count
   held to the JAX package's, the outer-iteration histogram, the plans
   against phase 4's interior-point plans where both converged and the
   objectives agree to ALM_SAME_SOLUTION (|du| <= ALM_DU, set from the
   JAX package's own ALM against its interior point), 16 members against
   the CPU (held as the budgeted fleet's: ALM's plans are fixed by f32
   only loosely on some members).
4m. Differentiable: NMPC(differentiable=True) on phase 4's fleet at
   B=4096, the loss Σ U² + Σ objective, gradients with respect to x0 and
   the MLP params; the forward solve and the IFT backward must launch the
   fused kernel (the backward's KKT solve is one Riccati sweep) and never
   the plain sweep; the gradients card against CPU on 16 members (1e-3 of
   the largest entry, + 2x their own move under ±1e-7 on the start),
   central differences for DIFF_N_FD members' x0 (5% or 5e-3); the dense
   direction at B=DIFF_DENSE_B, and card against CPU on 16 of them.
4n. Record: IPConfig(record=True), one cold solve at B=4096: the trace's
   fields (B, max_iter), done turning true at each member's own iteration
   count, the per-member iteration histogram; the budgeted fleet's warm
   re-plan under record (its histogram and its lockstep tail: when the
   slow members' KKT error reaches 10x tol and when they are done); then
   utils.profiling.profile_solver's phases on phase 4's fleet.
4o. Parallel-in-time sweep (solve/pscan.py, PyTorch ops, no kernel of
   its own): riccati_sweep_pscan against the plain sweep on the card on
   seeded cases at (B, H, nx, nu) = (256, 512, 2, 1) and (64, 50, 12, 4),
   δ = 0 and δ per problem (0 or 10, the first control's curvature at -3:
   the δ = 0 members fail), equal ok flags, the scaled error within 2x
   the port's own on the CPU (tests/measure_torch_pscan.py --sweeps), no
   sweep kernel and no plain sweep launched; its time a call and its
   device work beside the fused kernel's device time at (256, 512, 2, 1).
4p. Long-horizon LV fleet (tools/bench_horizon_tpu.py's build_mpc,
   copied: the LV ODE itself, H=512, DT=2/H, B=256): cold + 1 warm
   re-plan under kkt="riccati_pscan" (no sweep kernel, no plain sweep)
   and kkt="riccati" (the staged fused kernel alone); converged counts at
   least the JAX package's own less 0.5% of B (cold: the lower of its two
   backends' counts, which part 4 members), pscan plans against the
   kernel's within 2x the JAX package's own pscan-vs-riccati difference on
   the members converged under both (tests/measure_torch_pscan.py); B=8,
   cold + 1 warm, timed and gated on warm convergence (8/8); 16 pscan
   members card against CPU, cold and one warm re-plan (the CPU solves in
   worker processes meanwhile; converged masks compared where ±1e-7 on
   the start does not flip the CPU's, plans where both converged).
4q. Horizon sharding: make_sharded_sweep on a (2, 4) mesh of the one card
   against plain under 4o's gate; NMPC(mesh=make_horizon_mesh(1, 4)) on
   4p's fleet (kkt_backend "riccati_horizon", no sweep kernel): one warm
   re-plan from 4p's pscan cold carry, its count and plans held to 4p's
   first pscan warm re-plan under 4p's gates.
4r. Scenario sharding: ShardedNMPC over 4 shards of the one card on phase
   4's fleet (B=4096), cold and one warm re-plan with the carry from the
   cold plans' first states: converged masks equal to the unsharded
   solve's, |du| <= 1e-3, each shard's results on its device; the warm
   re-plan converges all members in at most the cold call's iterations;
   both timed against the unsharded ones.
4s. Out of every kernel's envelope: riccati_sweep at nu=17 and
   riccati_sweep_general at R=66 on seeded cases (plan "plain_fallback":
   the plain version on the card, one warning, FALLBACK_CALLS, no kernel,
   the plain version's outputs bit for bit); then the stacked-LSTM fleet
   (examples/fleet_rnn.py lstm_fleet_model("stacked_lstm"): hiddens
   (8, 8), seeded weights, lifted to (34, 1), past nx <= 32; the GRU
   fleet's MPC, H=100, B=1024, cold + 1 warm): every sweep the plain
   fallback, one warning for the run, no kernel; converged counts at least
   the JAX package's own on the same weights less 0.5% of B
   (tests/measure_torch_parity_gaps.py); the first 128 members' cold plans
   card vs CPU (held as 4p's); the fallback sweep's time a call and its
   device work at the fleet's shape.
4t. The LSTM fleet (lstm_fleet_model("lstm"): hidden 8, lifted to
   (18, 1), H=100, B=4096, cold + 2 warm): the backward instance
   riccati_general_backward_fixed<18, 1, 1, 0> and the run-time forward
   kernel riccati_forward_kernel against the plain halves on the four
   seeded cases, the instance against the run-time backward kernel too;
   both timed at the fleet's shape (two entries of the kernels line), the
   instance in turns (a, b, b, a) against the run-time backward kernel,
   whose times are keys of the instance's entry, with ptxas's report of
   both; every backward sweep of the fleet through the instance, every
   forward sweep through the run-time kernel, no fallback; counts and card
   vs CPU as in 4s.
4u. bf16: phase 4's fleet and surrogate with MLPDynamics(compute_dtype=
   bfloat16), B=4096, cold + 2 warm, through the staged fused kernel:
   counts at least the JAX package's own on the same fit less 0.5% of B,
   plans within 2e-2 of phase 4's float32 cold plans on the members
   converged under both, the first 128 members card vs CPU.
4v. BASELINE config 1 (the LV ODE itself, Euler, H=10, one NMPC.next on
   the card): converged, its plan within 1e-4 of the CPU's; phase 4's
   warm re-plan with batch_chunk=1024 against the whole B=4096 re-plan
   (|du| <= 1e-4, + 2x their own move on members f32 fixes loosely; equal
   masks); then `python -m pyneuralempc_tpu_torch.utils.profiling` at
   PROF_BATCH=1024 in a subprocess beside phase 5, which must exit 0.
   Every phase before 4s runs with FALLBACK_CALLS from 0 and must leave it
   at 0 (logged after each).
5. Card vs CPU: 16 LV problems, 16 quadrotor problems, 16 EQ/border
   quadrotor problems and 16 budgeted LV problems solved on the card and on
   the CPU, and the budgeted fleet's closed loop (B=16, steps=4) on both;
   then, with equal iteration counts too, 16 GRU fleet problems, cartpole's
   first re-plan cut at 20 iterations (its first re-plans do not converge
   in 120, and two unconverged nonconvex iterate paths part by f32
   rounding after ~30) and a converging cartpole re-plan, 16 quadrotor MLP
   problems, and the cartpole multi-start's winner (cut at 20 iterations)
   and its index; 16 wide fleet problems; 16 LV problems under each of
   mu_strategy "adaptive" and "mehrotra" and polish_fresh=True, and 16
   under hessian="gauss_newton": equal masks, the converged members'
   plans held as the budgeted ones are (below), the iterates of members
   that take all 60 iterations unconverged not compared.  The CPU halves
   run in the worker processes (those of the quadrotor, EQ/border, wide
   and cartpole checks submitted before the phase starts), the card's in
   this process.
   The budgeted comparisons hold to the 1e-4 gates the members whose CPU
   answer is fixed to them: with the floor binding, feed moved between
   stages at constant Σu is tie-broken only by the 1e-4·Σu² term, and some
   plans move by ~1e-3 when their start moves by 1e-7; those members are
   named, held to equal masks, the floor and the objective, and their
   |Δu| or |Δx| to 1e-4 + 2× what the CPU answer moved.
6. Numbers: warm re-plan p50 latency, solves/s, the time split and the
   device busy share, for each path.

Before them, one JSON line for each of phases 4s-4v.  The last three
lines of stdout are the kernels' JSON line, the card's name and power
limit, and ``{"ok": true, "device": {...}}``.
"""

import json
import os
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import torch

B, H, DT, REG = 4096, 20, 0.1, 1e-4
# timed warm re-plans of the LV paths (once 8, then 4, cut to keep the
# whole run inside its time as paths joined; the other paths' warm
# repeats were cut with it: one timed warm re-plan each, the long-horizon
# fleet's 3 to 2)
WARM_STEPS = 2
MIN_WARM_CONVERGED = 4092
# kernel vs plain, f32: every element within SWEEP_TOL·max(1, |plain|), and
# every output within SWEEP_TOL·max(1, max|plain|) absolute (dLam reaches
# ~80 on the delta=10 problems, where one f32 ulp is already ~8e-6)
SWEEP_TOL = 2e-5
# the streamed pair at quadrotor widths: every element within
# STREAMED_TOL·max(1, |plain|) (tests/test_pallas_kernel.py holds the
# reference's kernel to 2e-4 at these dims)
STREAMED_TOL = 2e-4
CARD_VS_CPU_DU = 1e-4
N_CARD_VS_CPU = 16
# the tanh layers' tangent kernels against their plain versions in float64:
# f32 sums of K or N products in another order, every output within
# TANH_TOL·max(1, max|plain|) (tests/test_torch_cuda.py's TANH_ATOL)
TANH_TOL = 2e-5
# the benchmark cell's stage blocks (quadrotor_mlp.track_b2048, B=2048,
# H=50): primal rows, tangents a row, and each kernel's (K, N) there, the
# first the entry's own, the second under its "other_shape"
TANH_P, TANH_T = 102_400, 16
TANH_SHAPES = {"tanh_tangent_fwd": ((256, 256), (19, 256)),
               "tanh_tangent_vjp": ((256, 256), (19, 256))}
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
F32_FLOP_PER_S = 67e12        # H100 SXM, f32 outside the tensor cores
PALLAS = "pyneuralempc_tpu/ops/pallas/riccati_kernel.py"
CSRC = "pyneuralempc_tpu_torch/csrc/"
# the quadrotor path (bench.py's BASELINE config 4)
QH, QNX, QNU = 50, 12, 4
Q_WARM_STEPS = 1             # once 4, cut as WARM_STEPS
# the EQ/border quadrotor path: R right-hand sides (1 + one budget row), r
# stage equality rows
QR, QEQ = 2, 1
PURE_EQ_H = 10                # the r = nu kernel check's horizon
FWD_ODD_H = 7                 # an odd horizon for the forward instance
EQ_RESIDUAL = 1e-4            # the solver's tol
BUDGET_SLACK = 1e-3
# the budgeted LV path: R right-hand sides (1 + the feed floor row), r = 0;
# the kernel's other instantiated shapes checked beside it
LR, LEQ = 2, 0
FUSED_GENERAL_SHAPES = ((2, 0), (2, 1), (3, 0), (3, 1))
FUSED_RAGGED_H = 50           # 24 problems a staged block at (2, 1, 2, 0)
FLUSH_BYTES = 256 * 2 ** 20   # written between launches: 5x the 50 MB L2
CL_STEPS, CL_REPLAN = 16, 2   # the reference example's cadence
# the floor binds on this share of the converged cold plans (at least, at
# most)
BINDING_SHARE = (0.05, 0.95)
# budgeted card vs CPU: a member is held to the 1e-4 gates when its CPU
# answer moves by at most DETERMINED under a ±PERTURB move of its start;
# any other member to 1e-4 + SPREAD times that move
PERTURB, DETERMINED, SPREAD = 1e-7, 5e-5, 2.0


# profiler windows traced for one timing before it counts as failed
PROFILE_TRIES = 5
# a profiler median under this share of the device time a call takes
# between CUDA events (less an empty launch's), where the kernel is the
# window's only one and the calls were queued behind a spin, is a misread
# window
EVENTS_SHARE = 0.8
# the spin queued ahead of those calls holds the device for this many times
# the host's time to issue them, at least SPIN_MIN_MS and at most SPIN_MAX_MS
SPIN_SHARE, SPIN_MIN_MS, SPIN_MAX_MS = 4.0, 1.0, 200.0

T_START = time.perf_counter()


# the run-time streamed pair at the new paths' stages: (tag, nx, nu, H,
# problems a seeded case draws, times the card repeats them, the path whose
# launches count).  The GRU fleet's lifted stage is 2 states + 8 hidden;
# the quadrotor GRU's (benchmark configuration quadrotor_gru, whose cell
# runs the pair; no phase here does) 12 states + 16 hidden, 4 thrusts.
RNN_B, RNN_H, RNN_NX = 16384, 100, 10
CP_H, CP_NX, CP_TIME_B = 50, 4, 4096
QG_B, QG_H, QG_NX, QG_NU, QG_CASE_B = 4096, 100, 28, 4, 1024
NEW_STREAMED_SHAPES = (
    (f"nx={RNN_NX}, nu=1, H={RNN_H}, B={RNN_B}", RNN_NX, 1, RNN_H, 4096,
     RNN_B // 4096, "fleet_rnn"),
    (f"nx={CP_NX}, nu=1, H={CP_H}", CP_NX, 1, CP_H, CP_TIME_B, 1,
     "cartpole"),
    ("quadrotor_gru", QG_NX, QG_NU, QG_H, QG_CASE_B, QG_B // QG_CASE_B,
     "quadrotor_gru"),
)
# phase 4e: the GRU fleet (examples/fleet_rnn.py at its full size)
RNN_WARM_STEPS = 1
RNN_MIN_CONVERGED = RNN_B - 16     # the 4-in-4096 rate of the other paths
# phase 4f: the cartpole swing-up (examples/cartpole.py)
CP_STEPS = 60
CP_MIN_COS = 0.99
CP_TIP_SLACK, CP_FORCE_SLACK, CP_BOX_SLACK = 1e-3, 1e-4, 1e-3
CP_JAX_CONVERGED = "25/30"         # cartpole_tpu.log, the JAX package
CP_STARTS = 8
# phase 5: cartpole's first re-plan cut at this many iterations (its first
# re-plans do not converge in 120; tests/test_torch_cartpole.py)
CP_FIRST_ITERS = 20
# phase 4g: the quadrotor MLP fleet (examples/quadrotor.py --mlp)
QM_B, QM_WARM_STEPS = 1024, 1
QM_MIN_CONVERGED = 994             # 97%
# phase 4: per-member params give the shared solve's plans to this
PER_MEMBER_DU = 1e-5
# phases 3e and 4h: the wide fleet (examples/fleet_wide.py, the JAX
# package's tools/fleet_wide_tpu.py) at its full size: stage (12, 10),
# H=50, B=4096; seeded kernel cases drawn at W_CASE_B and repeated
W_H, W_NX, W_NU, W_CASE_B = 50, 12, 10, 1024
W_WARM_STEPS = 1
# the forward instance's other candidate ring depth at (12, 10), built as a
# second library of riccati_streamed.cu for the turns (at depth 2 eight
# blocks of four warps fit an SM, at 3 six)
W_ALT_DEPTH = 3
# phase 4i: the solver options on the LV fleet (phase 4's surrogate); the
# small-batch options' batch
OPT_WARM_STEPS = 1
OPT_SMALL_B = 16
# phase 4i: the surrogate's NLP is not convex, and two μ rules can stop at
# different local solutions of one member's problem, objectives up to a
# few % apart, both converged.  A member whose objective agrees with the
# monotone solve's to SAME_SOLUTION (relative) is at the same solution and
# held to CARD_VS_CPU_DU in its plan.  The counts are held to the JAX
# package's own on this fleet (tests/measure_torch_mu_strategies.py, on
# the CPU, with the same eager fit): members converged cold, converged on
# its first warm re-plan, and at the same solution as its monotone cold
# solve; the card may fall short of each by MU_SLACK of B (f32 parts a few
# members' iterate paths), and of the converged counts never below
# MIN_WARM_CONVERGED where the reference reaches it.  Mehrotra's
# predictor-corrector has fat tails from a cold start (the JAX package's
# IPConfig says so): 110 of 4096 members take all 60 iterations there.
SAME_SOLUTION = 1e-6
MU_REFERENCE = {"monotone": {"cold": 4096, "warm": 4096, "same": 4096},
                "adaptive": {"cold": 4096, "warm": 4096, "same": 4085},
                "mehrotra": {"cold": 3986, "warm": 4082, "same": 3907}}
MU_SLACK = 0.005
# phase 4j: the state_dict-imported surrogate's plans against phase 4's
IMPORT_DU = 1e-6
# phase 4k: the dense backend on the LV fleet; phase 4's cost plus move
# suppression MOVE·Σ(u_{t+1} − u_t)² (stage-coupled: the dense backend
# under kkt="auto").  The converged counts and the members at the same
# solution as phase 4's Riccati solve are held to the JAX package's own
# on this fleet, less MU_SLACK of B (tests/measure_torch_dense_alm.py, on
# the CPU, with the same eager fit), and to MIN_WARM_CONVERGED where the
# reference reaches it.
MOVE = 1e-3
DENSE_REFERENCE = {"dense": {"cold": 4071, "warm": 4095, "same": 3870},
                   "moves": {"cold": 4074, "warm": 4094}}
# phase 4l: ALMConfig() on the first ALM_B members; plans held to ALM_DU
# of phase 4's where both converged and the objectives agree to
# ALM_SAME_SOLUTION (relative).  ALM stops at 10x its inner tol with no
# polish, so its plans sit ~1e-3 from the polished interior point's even
# at the same local solution: the JAX package's own ALM, on the CPU, is
# within 1e-6 of its interior point's objective on 11 of 800 members and
# within 1e-3 on 792, its plans there up to 1.82e-3 apart (another local
# solution is 0.68 or more apart); tests/measure_torch_dense_alm.py
ALM_B = 1024
ALM_REFERENCE = {"converged": 800, "same": 792}
ALM_SAME_SOLUTION = 1e-3
ALM_DU = 2e-3
# phase 4m: the differentiable solve; gradients card vs CPU (relative to
# the largest entry), central differences on DIFF_N_FD members (the JAX
# package's test bound: 5% or 5e-3), the dense direction on DIFF_DENSE_B
DIFF_CARD_VS_CPU = 1e-3
DIFF_N_FD = 4
DIFF_FD_EPS = 1e-3
DIFF_FD_RTOL, DIFF_FD_ATOL = 0.05, 5e-3
DIFF_DENSE_B = 64
# phase 4n: profile_solver's medians; the budgeted fleet's warm re-plan
# members whose trace is summarised (the lockstep tail)
PROFILE_ITERS = 1
TAIL_ITERS = 10
# phases 4o-4r: the parallel-in-time sweep (solve/pscan.py), the
# long-horizon LV fleet, the horizon-sharded sweep and solve, scenario
# sharding.  4o: seeded cases (sweep_cases.py) at the long-horizon fleet's
# shape and the quadrotor's; the pscan sweep is held to PSCAN_SPREAD times
# its own scaled error against the plain sweep on the CPU
# (tests/measure_torch_pscan.py --sweeps)
PSCAN_SHAPES = ((256, 512, 2, 1), (64, 50, 12, 4))
PSCAN_CASES = {"delta0": 0, "delta_rescue": 4}
PSCAN_CPU_ERR = {(256, 512, 2, 1): {"delta0": 5.661e-07,
                                    "delta_rescue": 5.522e-07},
                 (64, 50, 12, 4): {"delta0": 6.095e-07,
                                   "delta_rescue": 5.340e-07}}
PSCAN_SPREAD = 2.0
# 4p, 4q: tools/bench_horizon_tpu.py's fleet (the LV ODE itself, H=512,
# DT=2/H), cold + LH_WARM warm re-plans.  The JAX package's own numbers on
# it, on the CPU (tests/measure_torch_pscan.py): the converged counts (cold,
# then each warm re-plan), and its pscan plans' largest |du| against its
# riccati ones on the members converged under both (cold; the largest of
# the warm re-plans).  The plans are held to LH_SPREAD times those; the
# warm counts to each backend's own less MU_SLACK of B, and the cold ones
# to the lower of the two backends' cold counts less MU_SLACK of B: a
# cold count is fixed by f32 only to the few members that stop at
# max_iter near tol, and the JAX package's own two backends (the same
# arithmetic, rounded apart) part 4 members there.  B=8 takes a cold solve
# and LH_SMALL_WARM warm re-plans.
LH_H, LH_B, LH_SMALL_B, LH_WARM, LH_SMALL_WARM = 512, 256, 8, 1, 1
LH_REFERENCE = {"riccati": [230, 256, 256, 256],
                "riccati_pscan": [226, 256, 256, 256]}
LH_JAX_DU = {"cold": 1.330e-04, "warm": 5.794e-05}
LH_SPREAD = 2.0
# 4q: NMPC(mesh=...) on a (1, HORIZON_SHARDS) mesh of the one card
HORIZON_SHARDS = 4
# 4r: ShardedNMPC over SCEN_SHARDS shards of the one card; its plans
# against the unsharded solve's (tests/test_parallel.py's bound)
SCEN_SHARDS = 4
SHARDED_DU = 1e-3
# the CPU halves of the LV fleets' card-vs-CPU checks (4k, 4l, 4p, 5) run
# in CPU_WORKERS spawned processes of CPU_WORKER_THREADS torch threads
# each, while the card solves its halves
CPU_WORKERS, CPU_WORKER_THREADS = 3, 2
# phases 4s-4v: paths the card had not run.  4s, 4t: the LSTM fleets
# (examples/fleet_rnn.py lstm_fleet_model: seeded weights, not fitted, in
# the GRU fleet's MPC, H=LSTM_H): the stacked LSTM lifted to (34, 1), past
# every kernel's nx <= 32, so every sweep runs the plain version on the
# card (kernel_plan's "plain_fallback"), B=1024, cold + 1 warm; the single
# LSTM lifted to (18, 1), the backward instance and the run-time forward
# kernel, B=4096, cold + 2 warm.  Converged counts at least the JAX
# package's own on the same weights less MU_SLACK of B
# (tests/measure_torch_parity_gaps.py, on the CPU); the first LSTM_N_CPU
# members' cold plans card vs CPU (the CPU halves, and their starts moved
# by ±PERTURB, in the workers from the start of the run: they need nothing
# the card computes).
LSTM_H, LSTM_N_CPU = 100, 128
LSTM_B = {"stacked_lstm": 1024, "lstm": 4096}
LSTM_WARM = {"stacked_lstm": 1, "lstm": 2}
LSTM_JAX_CONVERGED = {"stacked_lstm": [941, 993],
                      "lstm": [4045, 4069, 4074]}
# 4s: the dispatches outside every kernel's envelope on seeded cases, (B, H,
# nx, nu, R, r): nu=17 (the plain sweep) and R=66 right-hand sides (the
# general one); each the plain version's result bit for bit
FALLBACK_CASES = ((256, 50, 12, 17, 1, 0), (256, 20, 2, 1, 66, 0))
# 4u: phase 4's fleet and surrogate with bf16 matmuls, cold + BF16_WARM
# warm; the bf16 model's function values carry its rounding while its
# derivatives do not, so the KKT error floors near 1e-3 and most members
# stop at max_iter above the bench tol 1e-5, in both packages: the counts
# are held to the JAX package's own on the same fit (on the CPU) less
# MU_SLACK of B; plans against phase 4's float32 cold plans within
# BF16_VS_F32 on the members converged under both (the model-level bound
# of tests/test_torch_multi_member.py); the first LSTM_N_CPU members card
# vs CPU as the float32 fleets are: a member that converges on both does
# so where bf16's rounding left its plan where float32's is (within 1e-6
# of phase 4's), and its card and CPU plans agreed bit for bit on an H100
# (19 of 128)
BF16_WARM = 2
BF16_JAX_CONVERGED = [711, 605, 493]
BF16_VS_F32 = 2e-2
# 4v: next_batch(batch_chunk=CHUNK) against the whole solve; the profiling
# CLI at PROF_BATCH members in a subprocess, overlapped with phase 5
CHUNK, PROF_BATCH = 1024, 1024


def log(*a):
    """One line of the run's log, after the seconds since the start."""
    print(f"[{time.perf_counter() - T_START:7.1f} s]", *a, flush=True)


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def f_true(x, u):
    """Normalized controlled Lotka-Volterra (bench.py's ground truth)."""
    xr = 30.0 * (x + 1.0)
    ur = 50.0 * u
    d1 = 0.5 * xr[:, :1] - 0.025 * xr[:, :1] * xr[:, 1:]
    d2 = -0.5 * xr[:, 1:] + ur + 0.005 * xr[:, :1] * xr[:, 1:]
    return torch.cat([d1, d2], dim=1) / 30.0


def reset_counters(rk, rg):
    rk.LAUNCHES = rk.BACKWARD_LAUNCHES = rk.FORWARD_LAUNCHES = 0
    rk.STAGED_LAUNCHES = rk.DIRECT_LAUNCHES = 0
    rk.BACKWARD_INSTANCE_LAUNCHES = rk.BACKWARD_RUNTIME_LAUNCHES = 0
    rk.FORWARD_INSTANCE_LAUNCHES = rk.FORWARD_RUNTIME_LAUNCHES = 0
    rk.PLAIN_CALLS = rk.FALLBACK_CALLS = 0
    rg.BACKWARD_LAUNCHES = rg.FORWARD_LAUNCHES = rg.FUSED_LAUNCHES = 0
    rg.BACKWARD_INSTANCE_LAUNCHES = rg.BACKWARD_RUNTIME_LAUNCHES = 0
    rg.FORWARD_INSTANCE_LAUNCHES = rg.FORWARD_RUNTIME_LAUNCHES = 0
    rg.FUSED_STAGED_LAUNCHES = rg.FUSED_DIRECT_LAUNCHES = 0


def counters(rk, rg):
    return {"fused": rk.LAUNCHES, "fused_staged": rk.STAGED_LAUNCHES,
            "fused_direct": rk.DIRECT_LAUNCHES,
            "backward": rk.BACKWARD_LAUNCHES,
            "backward_instance": rk.BACKWARD_INSTANCE_LAUNCHES,
            "backward_runtime": rk.BACKWARD_RUNTIME_LAUNCHES,
            "forward": rk.FORWARD_LAUNCHES,
            "forward_instance": rk.FORWARD_INSTANCE_LAUNCHES,
            "forward_runtime": rk.FORWARD_RUNTIME_LAUNCHES,
            "plain": rk.PLAIN_CALLS, "fallback": rk.FALLBACK_CALLS,
            "general_backward": rg.BACKWARD_LAUNCHES,
            "general_backward_instance": rg.BACKWARD_INSTANCE_LAUNCHES,
            "general_backward_runtime": rg.BACKWARD_RUNTIME_LAUNCHES,
            "general_forward": rg.FORWARD_LAUNCHES,
            "general_forward_instance": rg.FORWARD_INSTANCE_LAUNCHES,
            "general_forward_runtime": rg.FORWARD_RUNTIME_LAUNCHES,
            "fused_general": rg.FUSED_LAUNCHES,
            "fused_general_staged": rg.FUSED_STAGED_LAUNCHES,
            "fused_general_direct": rg.FUSED_DIRECT_LAUNCHES}


def only_launched(n, *names):
    """The named counters moved and every other one stayed at 0."""
    return (all(n[k] > 0 for k in names)
            and all(v == 0 for k, v in n.items() if k not in names))


# ---- phases 3, 3b: kernels vs plain ----

CASES = {"delta0": 0, "delta_per_problem": 1, "negative_curvature": 2,
         "local_bump": 3}


def sweep_case(kind, seed, Bn=B, Hn=H, nx=2, nu=1):
    """One of the seeded cases the CPU parity tests use too
    (pyneuralempc_tpu_torch/ops/cuda/sweep_cases.py), on the card."""
    from pyneuralempc_tpu_torch.ops.cuda import sweep_cases
    case = sweep_cases.sweep_case(kind, B=Bn, H=Hn, nx=nx, nu=nu, seed=seed)
    return [torch.as_tensor(a, device="cuda") for a in case]


def expected_ok(kind, Bn):
    if kind == "negative_curvature":
        return torch.arange(Bn, device="cuda") % 2 == 0
    return torch.ones(Bn, dtype=torch.bool, device="cuda")


def check_ok(kind, got, ref):
    if not torch.equal(got, ref):
        raise RuntimeError(f"{kind}: ok flags differ on "
                           f"{int((got != ref).sum())} problems")
    want = expected_ok(kind, ref.numel())
    if not torch.equal(ref, want):
        raise RuntimeError(f"{kind}: ok flags {int(ref.sum())}/"
                           f"{ref.numel()}, expected {int(want.sum())}")


def errors(outs, refs, ok):
    """(max |diff|, max |diff|/max(1, |plain|), [max(1, max|plain|) per
    output]) over the ok problems; empty outputs (dNu with no equality
    rows) are skipped."""
    abs_err, scaled, mags = 0.0, 0.0, []
    for o, r in zip(outs, refs):
        if r.numel() == 0:
            continue
        d = (o - r).abs()[ok]
        abs_err = max(abs_err, float(d.max()))
        scaled = max(scaled, float((d / r.abs()[ok].clamp(min=1.0)).max()))
        mags.append(max(1.0, float(r[ok].abs().max())))
    return abs_err, scaled, mags


def cuda_median_ms(fn, runs=25, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def kernel_device_ms(fn, kernel_name, runs=25, strict=False, bound_ms=None):
    """Median device time of the kernels whose names hold ``kernel_name``
    (spaces ignored, so a template's arguments can be matched) over ``runs``
    calls of ``fn``, read from a torch.profiler trace, and held against the
    device time of the same calls back to back between one CUDA event pair,
    queued behind a spin so that the host's pace opens no gap between them.
    The trace keeps only some of a window's kernel events (16-25 of 25 on an
    H100, whatever the kernel), now and then none.  So a window is traced
    again, up to PROFILE_TRIES windows, when it holds no such kernel, or when
    its median is under EVENTS_SHARE of the events' time a call less an
    empty launch's, while the kernel is the window's only one and the host
    queued every call before the spin ended.  When no window passes: with
    ``strict``, raise (a misnamed kernel or a misread time must not pass as
    a timing); else the events' time a call (host work included where the
    host did not queue the calls in time).  A median below ``bound_ms``
    lists every event's time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    want = kernel_name.replace(" ", "")
    events_ms, floor_ms, host_ms, queued = back_to_back_ms(fn, runs)
    kept, why = [], ""
    for tries in range(1, PROFILE_TRIES + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        device = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        times = [e.time_range.elapsed_us() / 1e3 for e in device
                 if want in e.name.replace(" ", "")]
        kept.append(len(times))
        if not times:
            why = "no event of the kernel"
            continue
        ms = statistics.median(times)
        checked = queued and len(times) == len(device)
        if checked and ms < EVENTS_SHARE * (events_ms - floor_ms):
            why = (f"median {ms * 1e3:.2f} us under {EVENTS_SHARE:.0%} of "
                   f"the {events_ms * 1e3:.2f} us a call between CUDA "
                   f"events less {floor_ms * 1e3:.2f} us an empty launch")
            continue
        how = (f"profiler, {len(times)} kernels, {min(times) * 1e3:.2f}-"
               f"{max(times) * 1e3:.2f} us, events kept a window "
               f"{kept} of {runs}; {events_ms * 1e3:.2f} us a call back to "
               f"back between CUDA events behind a spin, "
               f"{floor_ms * 1e3:.2f} us an empty launch, "
               f"{host_ms * 1e3:.2f} us to issue a call, "
               + ("checked" if checked else "not checked (" + (
                   "the host issued past the spin" if not queued
                   else "other device work in the window") + ")"))
        if bound_ms is not None and ms < bound_ms:
            how += (f"; BELOW the bound {bound_ms * 1e3:.2f} us, every "
                    f"event's time (us): "
                    + ", ".join(f"{t * 1e3:.2f}" for t in times))
        return ms, how
    if strict:
        raise RuntimeError(f"none of {PROFILE_TRIES} profiler windows times "
                           f"{kernel_name!r} (events kept a window {kept} "
                           f"of {runs}; last window: {why})")
    return (events_ms, f"events over {runs} back-to-back calls (no profiler "
                       f"window passed: events kept {kept} of {runs}; last "
                       f"window: {why})")


_SPIN_CYCLES_PER_MS = []


def spin_cycles_per_ms():
    """torch.cuda._sleep's cycles a millisecond on this card, read once
    from a 1e7-cycle spin between CUDA events."""
    if not _SPIN_CYCLES_PER_MS:
        torch.cuda._sleep(1000)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(10 ** 7)
        stop.record()
        stop.synchronize()
        _SPIN_CYCLES_PER_MS.append(1e7 / start.elapsed_time(stop))
    return _SPIN_CYCLES_PER_MS[0]


def queued_ms(fn, runs, host_ms):
    """The time a call of ``runs`` calls of ``fn`` between one CUDA event
    pair, queued behind a spin of SPIN_SHARE times ``host_ms`` a call; and
    whether
    the host had queued them all before the device reached the first event
    (where not, the time holds the host's)."""
    spin_ms = min(max(SPIN_SHARE * host_ms * runs, SPIN_MIN_MS), SPIN_MAX_MS)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(spin_ms * spin_cycles_per_ms()))
    start.record()
    for _ in range(runs):
        fn()
    stop.record()
    queued = not start.query()
    stop.synchronize()
    return start.elapsed_time(stop) / runs, queued


def back_to_back_ms(fn, runs=25):
    """For ``runs`` back-to-back calls of ``fn``: the time a call between
    CUDA events with the calls queued behind a spin (the device's time where
    the host queued them all in time); an empty launch's time, so queued;
    the host's time to issue a call; and whether the host queued the calls
    in time."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(runs):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / runs
    torch.cuda.synchronize()
    events_ms, queued = queued_ms(fn, runs, host_ms)
    floor_ms, _ = queued_ms(lambda: torch.cuda._sleep(0), runs, host_ms)
    return events_ms, floor_ms, host_ms, queued


def kernel_entry(name, source, site, call, kernel_name, plain, nbytes,
                 flops, shape, plain_runs=20, strict=False):
    """Time one kernel (device time, wrapper call, plain version) and give
    its entry of the kernels line, launches still 0."""
    ms, how = kernel_device_ms(call, kernel_name, strict=strict)
    call_ms = cuda_median_ms(call)
    plain_ms = cuda_median_ms(plain, runs=plain_runs, warmup=1)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    bound_ms = max(t_bytes, t_ops)
    log(f"{name} kernel {shape}: device time median {ms * 1e3:.2f} us "
        f"({how}); {call_ms * 1e3:.1f} us per wrapper call (host work "
        f"included); plain PyTorch {plain_ms:.3f} ms; bound "
        f"{bound_ms * 1e3:.2f} us "
        f"({nbytes / 1e6:.2f} MB at 3.35 TB/s vs {flops / 1e6:.1f} Mflop "
        f"at 67 TFLOP/s) -> roofline share {bound_ms / ms:.2%}")
    return {"name": name, "route": "cuda", "source": CSRC + source,
            "replaces": site, "launches": 0, "ms": ms, "call_ms": call_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None}


def l2_flusher():
    """A wrapper that writes FLUSH_BYTES (5x the L2) before each call."""
    flush = torch.empty(FLUSH_BYTES // 4, device="cuda")

    def flushed(fn):
        def run():
            flush.zero_()
            return fn()
        return run
    return flushed


def design_turns(designs, order, strict=True, bound_ms=None,
                 after_turn=None):
    """Device times of CUDA designs of one function in turns (``order``,
    e.g. old, new, new, old), as the path finds the inputs (warm in L2) and
    with L2 flushed before each launch.  ``designs`` maps a label to (call,
    kernel name); returns {(cache, label): [ms, ...]} and logs each turn
    (every event's time where its median is below ``bound_ms``).
    ``after_turn(cache, label)``, where given, runs after each turn."""
    flushed = l2_flusher()
    turns = {}
    for cache, wrap in (("warm", lambda fn: fn), ("flushed", flushed)):
        for who in order:
            fn, name = designs[who]
            ms, how = kernel_device_ms(wrap(fn), name, strict=strict,
                                       bound_ms=bound_ms)
            turns.setdefault((cache, who), []).append(ms)
            log(f"  turn [{cache}] {who}: {ms * 1e3:.2f} us ({how})")
            if after_turn is not None:
                after_turn(cache, who)
    return turns


def phase_kernels(rk, build_logs):
    """The fused plain sweep (riccati_sweep_cuda: the staged kernel of
    csrc/riccati_general_fused.cu at <2, 1, 1, 0>) against its plain
    version and against csrc/riccati_sweep.cu (riccati_sweep_direct_cuda)
    on the four cases at the LV path's shapes; then both designs timed in
    turns, warm and with L2 flushed."""
    worst_abs, worst_scaled, worst_direct = 0.0, 0.0, 0.0
    plan = rk.kernel_plan(H, 2, 1, "cuda")
    if plan["kernel"] != rk.STAGED_KERNEL:
        raise RuntimeError(f"the LV shape plans {plan['kernel']}")
    for kind, seed in CASES.items():
        args = sweep_case(kind, seed)
        n0 = (rk.STAGED_LAUNCHES, rk.DIRECT_LAUNCHES)
        out = rk.riccati_sweep_cuda(*args)
        direct = rk.riccati_sweep_direct_cuda(*args)
        torch.cuda.synchronize()
        if (rk.STAGED_LAUNCHES, rk.DIRECT_LAUNCHES) != (n0[0] + 1, n0[1] + 1):
            raise RuntimeError(f"{kind}: the staged and direct kernels did "
                               "not launch once each")
        ref = rk.riccati_sweep_plain(*args)
        torch.cuda.synchronize()
        check_ok(kind, out[3], ref[3])
        check_ok(kind, direct[3], ref[3])
        ok = ref[3]
        abs_err, scaled, mags = errors(out[:3], ref[:3], ok)
        d_abs, d_scaled, _ = errors(direct[:3], ref[:3], ok)
        for who, got in (("staged", out), ("riccati_sweep.cu", direct)):
            for label, o, r, mag in zip(("dX", "dU", "dLam"), got, ref,
                                        mags):
                err = float((o - r).abs()[ok].max())
                if not err <= SWEEP_TOL * mag:
                    raise RuntimeError(f"{kind}: {who} {label} differs from "
                                       f"the plain sweep by {err:.3e} > "
                                       f"{SWEEP_TOL} * {mag:.3g}")
        e_direct = errors(out[:3], direct[:3], ok)[1]
        log(f"kernel vs plain [{kind}]: ok {int(ok.sum())}/{B} (equal; "
            f"riccati_sweep.cu's too), max |diff| {abs_err:.3e} (each output "
            f"within {SWEEP_TOL} x max(1, max|plain|)), max "
            f"|diff|/max(1,|plain|) {scaled:.3e}; riccati_sweep.cu vs plain "
            f"{d_abs:.3e} / {d_scaled:.3e}; staged vs riccati_sweep.cu "
            f"{e_direct:.3e}")
        if not (scaled <= SWEEP_TOL and d_scaled <= SWEEP_TOL
                and e_direct <= SWEEP_TOL):
            raise RuntimeError(f"{kind}: the staged kernel differs from the "
                               f"plain sweep by {scaled:.3e}, "
                               f"riccati_sweep.cu from it by {d_scaled:.3e}, "
                               f"the two kernels by {e_direct:.3e} > "
                               f"{SWEEP_TOL}")
        worst_abs = max(worst_abs, abs_err)
        worst_scaled = max(worst_scaled, scaled)
        worst_direct = max(worst_direct, e_direct)

    args = sweep_case("delta0", 0)
    staged_name = f"{rk.STAGED_KERNEL}<2, 1, 1, 0>"
    staged = lambda: rk.riccati_sweep_cuda(*args)  # noqa: E731
    direct = lambda: rk.riccati_sweep_direct_cuda(*args)  # noqa: E731
    entry = kernel_entry(
        "riccati_sweep", "riccati_general_fused.cu", f"{PALLAS}:445",
        staged, staged_name, lambda: rk.riccati_sweep_plain(*args),
        rk.sweep_bytes(B, H, 2, 1), rk.sweep_flops(B, H, 2, 1),
        f"B={B}, H={H}, nx=2, nu=1", strict=True)
    turns = design_turns({"riccati_sweep.cu": (direct, rk.SWEEP_KERNEL),
                          "staged": (staged, staged_name)},
                         turn_order(("riccati_sweep.cu", "staged")))
    mean = {k: statistics.mean(v) for k, v in turns.items()}
    direct_call_ms = cuda_median_ms(direct)
    P = plan["block_problems"]
    smem = rk.staged_smem_bytes(P, H, 2, 1, 1, 0)
    staged_ptxas = ptxas_report(build_logs[rk.GENERAL_FUSED_SOURCE],
                                rk.STAGED_KERNEL, (2, 1, 1, 0))
    direct_ptxas = ptxas_report(build_logs[rk.SOURCE], rk.SWEEP_KERNEL,
                                (2, 1))
    log(f"riccati_sweep at B={B}, H={H}, nx=2, nu=1: staged <2, 1, 1, 0> "
        f"{mean['warm', 'staged'] * 1e3:.2f} us warm / "
        f"{mean['flushed', 'staged'] * 1e3:.2f} us L2 flushed, "
        f"riccati_sweep.cu {mean['warm', 'riccati_sweep.cu'] * 1e3:.2f} us / "
        f"{mean['flushed', 'riccati_sweep.cu'] * 1e3:.2f} us (device time, "
        f"one turn each): the staged kernel takes "
        f"{mean['warm', 'staged'] / mean['warm', 'riccati_sweep.cu']:.2%} of "
        f"riccati_sweep.cu's time warm; wrapper calls "
        f"{entry['call_ms'] * 1e3:.1f} us staged, {direct_call_ms * 1e3:.1f} "
        f"us riccati_sweep.cu")
    log(f"staged block <2, 1, 1, 0>: {P} problems, {smem} bytes of dynamic "
        f"shared memory, {(B + P - 1) // P} blocks; ptxas staged "
        f"<2, 1, 1, 0>: {staged_ptxas}; riccati_sweep.cu <2, 1>: "
        f"{direct_ptxas}")
    entry.update(max_abs_err=worst_abs, max_scaled_err=worst_scaled,
                 max_scaled_err_vs_direct=worst_direct,
                 design=f"staged ({staged_name}, {P} problems a block, "
                        f"{smem} B of shared memory)",
                 staged_turns_ms=turns["warm", "staged"],
                 staged_flushed_turns_ms=turns["flushed", "staged"],
                 direct_turns_ms=turns["warm", "riccati_sweep.cu"],
                 direct_flushed_turns_ms=turns["flushed", "riccati_sweep.cu"],
                 direct_ms=mean["warm", "riccati_sweep.cu"],
                 direct_call_ms=direct_call_ms,
                 flushed_ms=mean["flushed", "staged"],
                 direct_flushed_ms=mean["flushed", "riccati_sweep.cu"],
                 ptxas_staged=staged_ptxas, ptxas_direct=direct_ptxas)
    return entry


def hold_streamed_pair(rk, kind, args, tag):
    """The streamed pair on one seeded case against its plain halves and
    the run-time kernels: the backward entry's gains and ok flags against
    riccati_backward_plain and against the run-time backward kernel, the
    forward entry against riccati_forward_plain and against the run-time
    forward kernel, both fed the same gains, and the pair against the plain
    sweep.  Returns {"backward", "forward": (max |diff|, max scaled diff)
    against plain; "backward_rt", "forward_rt": the max scaled diff
    against the run-time kernel}."""

    def gate(what, abs_err, scaled):
        log(f"streamed {what} [{kind}, {tag}]: max |diff| {abs_err:.3e}, "
            f"max |diff|/max(1,|other|) {scaled:.3e} (limit {STREAMED_TOL})")
        if not scaled <= STREAMED_TOL:
            raise RuntimeError(f"{kind}, {tag}: streamed {what} differs by "
                               f"{scaled:.3e} > {STREAMED_TOL}")

    A, Bm, c = args[0], args[1], args[6]
    gains, ok = rk.riccati_backward_cuda(*args)
    g_rt, ok_rt = rk.riccati_backward_runtime_cuda(*args)
    torch.cuda.synchronize()
    g_ref, ok_ref = rk.riccati_backward_plain(*args)
    check_ok(kind, ok, ok_ref)
    check_ok(kind, ok_rt, ok_ref)
    e_bwd = errors([gains], [g_ref], ok_ref)[:2]
    gate("backward vs plain (gains)", *e_bwd)
    e_bwd_rt = errors([gains], [g_rt], ok_ref)[:2]
    gate("backward vs the run-time kernel (gains)", *e_bwd_rt)
    del g_ref, g_rt
    out = rk.riccati_forward_cuda(A, Bm, c, gains)
    rt = rk.riccati_forward_runtime_cuda(A, Bm, c, gains)
    torch.cuda.synchronize()
    e_fwd = errors(out, rk.riccati_forward_plain(A, Bm, c, gains),
                   ok_ref)[:2]
    gate("forward vs plain (dX, dU, dLam; same gains)", *e_fwd)
    e_fwd_rt = errors(out, rt, ok_ref)[:2]
    gate("forward vs the run-time kernel (same gains)", *e_fwd_rt)
    del out, rt
    pair = rk.riccati_sweep_streamed_cuda(*args)
    torch.cuda.synchronize()
    ref = rk.riccati_sweep_plain(*args)
    check_ok(kind, pair[3], ref[3])
    gate("pair end to end vs plain (dX, dU, dLam)",
         *errors(pair[:3], ref[:3], ok_ref)[:2])
    log(f"  [{kind}, {tag}] ok {int(ok.sum())}/{ok.numel()} (equal to plain "
        "and to the run-time kernel, as expected)")
    return {"backward": e_bwd, "forward": e_fwd, "backward_rt": e_bwd_rt[1],
            "forward_rt": e_fwd_rt[1]}


def worse(worst, got):
    """``worst`` (a hold_streamed_pair result, or None) and ``got``,
    entry by entry, the larger kept."""
    if worst is None:
        return got
    return {k: (tuple(max(a, b) for a, b in zip(v, got[k]))
                if isinstance(v, tuple) else max(v, got[k]))
            for k, v in worst.items()}


def turn_order(labels):
    """One turn a design, in the order given (a, b, b, a until the run
    passed its time limit on a slow host)."""
    return tuple(labels)


def instance_entries(rk, name, args, path, build_log, plain_runs=5):
    """Kernel-line entries of the streamed backward and forward instances on
    ``args``: device time, wrapper call, plain version and bound as in phase
    3, each instance with its run-time kernel timed beside it in turns
    (run-time, instance), warm and with L2 flushed.
    ``path`` names the path whose launches
    phase 4 fills in; ``name`` tags the entries."""
    Bn, Hn, nx = args[6].shape
    nu = args[1].shape[-1]
    A, Bm, c = args[0], args[1], args[6]
    dims = (Bn, Hn, nx, nu)
    label = f"B={Bn}, H={Hn}, nx={nx}, nu={nu}"
    bname, fname = rk.backward_kernel(nx, nu), rk.forward_kernel(nx, nu)
    if not (bname.startswith("riccati_general_backward_fixed<")
            and fname.startswith("riccati_general_forward_fixed<")):
        raise RuntimeError(f"({nx}, {nu}) takes {bname} and {fname}, not "
                           "the compile-time instances")
    gains, ok = rk.riccati_backward_cuda(*args)
    torch.cuda.synchronize()
    bwd_call = lambda: rk.riccati_backward_cuda(*args)  # noqa: E731
    fwd_call = lambda: rk.riccati_forward_cuda(A, Bm, c, gains)  # noqa: E731
    entries = []
    for half, call, kname, runtime, rt_name, plain, nbytes, flops, site in (
            ("backward", bwd_call, bname,
             lambda: rk.riccati_backward_runtime_cuda(*args),
             "riccati_backward_kernel",
             lambda: rk.riccati_backward_plain(*args),
             rk.backward_bytes(*dims), rk.backward_flops(*dims), 468),
            ("forward", fwd_call, fname,
             lambda: rk.riccati_forward_runtime_cuda(A, Bm, c, gains),
             "riccati_forward_kernel",
             lambda: rk.riccati_forward_plain(A, Bm, c, gains),
             rk.forward_bytes(*dims), rk.forward_flops(*dims), 488)):
        entry = kernel_entry(
            f"riccati_{half}{name}", "riccati_streamed.cu",
            f"{PALLAS}:{site}", call, kname, plain, nbytes, flops, label,
            plain_runs=plain_runs, strict=True)
        turns = design_turns({"run-time": (runtime, rt_name),
                              "instance": (call, kname)},
                             turn_order(("run-time", "instance")),
                             bound_ms=entry["bound_ms"])
        mean = {k: statistics.mean(v) for k, v in turns.items()}
        rt_call_ms = cuda_median_ms(runtime)
        log(f"riccati_{half} at {label}: "
            + ", ".join(f"{who} {mean['warm', who] * 1e3:.2f} us warm / "
                        f"{mean['flushed', who] * 1e3:.2f} us L2 flushed"
                        for who in ("run-time", "instance"))
            + f" (device time, one turn each): the instance "
              f"({kname}) takes "
              f"{mean['warm', 'instance'] / mean['warm', 'run-time']:.2%} "
              f"of the run-time kernel's time warm; wrapper calls "
              f"{entry['call_ms'] * 1e3:.1f} us instance, "
              f"{rt_call_ms * 1e3:.1f} us run-time")
        entry.update(design=f"compile-time instance {kname}", path=path,
                     shape=dict(zip(("B", "H", "nx", "nu"), dims)),
                     runtime_ms=mean["warm", "run-time"],
                     runtime_call_ms=rt_call_ms,
                     flushed_ms=mean["flushed", "instance"],
                     runtime_flushed_ms=mean["flushed", "run-time"],
                     turns_ms={f"{cache}, {who}": v
                               for (cache, who), v in turns.items()})
        entries.append(entry)
    bwd, fwd = entries
    depth = rk._FORWARD_INSTANCES[nx, nu]
    bwd["ptxas_instance"] = ptxas_report(
        build_log, "riccati_general_backward_fixed", (nx, nu, 1, 0))
    fwd["ptxas_instance"] = ptxas_report(
        build_log, "riccati_general_forward_fixed", (nx, nu, 1, 0, depth))
    fwd["depth"] = depth
    log(f"ptxas backward instance {bname}: {bwd['ptxas_instance']}; forward "
        f"instance {fname} ({rk.forward_ring_bytes(nx, nu, 1, 0, depth)} B "
        f"of shared memory a block): {fwd['ptxas_instance']}")
    pair_ms = cuda_median_ms(lambda: rk.riccati_sweep_streamed_cuda(*args))
    log(f"streamed sweep{name} (backward + forward, one wrapper call): "
        f"{pair_ms * 1e3:.1f} us")
    return bwd, fwd, pair_ms


def phase_streamed(rk, build_log):
    """The streamed pair against its plain halves and the run-time kernels
    at the quadrotor path's shapes, on the four cases; then the pair
    against the fused kernel at (2, 1); then both instances timed, each
    against its run-time kernel."""
    shape = dict(Bn=B, Hn=QH, nx=QNX, nu=QNU)
    worst = None
    for kind, seed in CASES.items():
        args = sweep_case(kind, seed, **shape)
        worst = worse(worst, hold_streamed_pair(
            rk, kind, args, f"B={B}, H={QH}, nx={QNX}, nu={QNU}"))
        del args

    # two CUDA designs on one function: the pair against the fused kernel
    args = sweep_case("delta0", 0)
    fused = rk.riccati_sweep_cuda(*args)
    pair = rk.riccati_sweep_streamed_cuda(*args)
    torch.cuda.synchronize()
    if not torch.equal(fused[3], pair[3]):
        raise RuntimeError("pair and fused kernel ok flags differ")
    abs_err, scaled, _ = errors(pair[:3], fused[:3], fused[3])
    log(f"streamed pair vs fused kernel (B={B}, H={H}, nx=2, nu=1, delta0): "
        f"max |diff| {abs_err:.3e}, scaled {scaled:.3e} (limit {SWEEP_TOL})")
    if not scaled <= SWEEP_TOL:
        raise RuntimeError(f"pair and fused kernel differ by {scaled:.3e}")

    args = sweep_case("delta0", 0, **shape)
    bwd, fwd, pair_ms = instance_entries(rk, "", args, "quadrotor",
                                         build_log)
    set_worst(bwd, fwd, worst)
    return bwd, fwd, pair_ms


def set_worst(bwd, fwd, worst):
    """The entries' errors on the seeded cases (hold_streamed_pair's)."""
    for entry, key in ((bwd, "backward"), (fwd, "forward")):
        entry.update(max_abs_err=worst[key][0], max_scaled_err=worst[key][1],
                     max_scaled_err_vs_runtime=worst[key + "_rt"])


def general_case(kind, seed, R=QR, r=QEQ, Hn=QH):
    """One of the seeded general cases the CPU tests use too, on the card, at
    the EQ/border quadrotor path's stage widths."""
    from pyneuralempc_tpu_torch.ops.cuda import sweep_cases
    case = sweep_cases.general_sweep_case(kind, B=B, H=Hn, nx=QNX, nu=QNU,
                                          R=R, r=r, seed=seed)
    return [torch.as_tensor(a, device="cuda") for a in case]


def misaligned(t):
    """A contiguous copy of ``t`` 4 bytes past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


def forward_vs_plain_and_runtime(rg, kind, A, Bm, c, Jx, gains, ok, gate):
    """The general forward entry (the instance at the EQ/border stage)
    against the plain forward and the run-time forward kernel fed the same
    gains: (max |diff|, max scaled diff) against plain, and the scaled diff
    against the run-time kernel."""
    out = rg.riccati_general_forward_cuda(A, Bm, c, Jx, gains)
    rt = rg.riccati_general_forward_runtime_cuda(A, Bm, c, Jx, gains)
    torch.cuda.synchronize()
    same = rg.riccati_general_forward_plain(A, Bm, c, Jx, gains)
    e = errors(out, same, ok)
    gate(kind, "forward (dX, dU, dLam, dNu; same gains)", *e[:2])
    e_rt = errors(out, rt, ok)
    gate(kind, "forward instance vs the run-time kernel", *e_rt[:2])
    return e[0], e[1], e_rt[1]


def phase_general(rk, rg, build_log):
    """The general pair against its plain halves at the EQ/border quadrotor
    path's shapes on the four cases; then a border-only and a pure-EQ case,
    and the pair at R=1, r=0 against the plain streamed pair."""
    worst = {"backward": [0.0, 0.0], "forward": [0.0, 0.0]}
    worst_rt, worst_fwd_rt = 0.0, 0.0

    def gate(kind, what, abs_err, scaled):
        log(f"general {what} vs plain [{kind}]: max |diff| {abs_err:.3e}, "
            f"max |diff|/max(1,|plain|) {scaled:.3e} (limit {STREAMED_TOL})")
        if not scaled <= STREAMED_TOL:
            raise RuntimeError(f"{kind}: general {what} differs from plain "
                               f"by {scaled:.3e} > {STREAMED_TOL}")

    def pair_vs_plain(kind, args, label):
        pair = rg.riccati_sweep_general_streamed_cuda(*args)
        torch.cuda.synchronize()
        ref = rg.riccati_sweep_general_plain(*args)
        check_ok(kind, pair[4], ref[4])
        e = errors(pair[:4], ref[:4], ref[4])
        gate(kind, f"pair end to end, {label} (dX, dU, dLam, dNu)", *e[:2])
        return e

    for kind, seed in CASES.items():
        args = general_case(kind, seed)
        A, Bm, c, Jx = args[0], args[1], args[6], args[12]
        gains, ok = rg.riccati_general_backward_cuda(*args[:12])
        torch.cuda.synchronize()
        g_ref, ok_ref = rg.riccati_general_backward_plain(*args[:12])
        check_ok(kind, ok, ok_ref)
        e = errors([gains], [g_ref], ok_ref)
        gate(kind, "backward (gains)", *e[:2])
        worst["backward"] = [max(a, b) for a, b in zip(worst["backward"],
                                                       e[:2])]
        g_rt, ok_rt = rg.riccati_general_backward_runtime_cuda(*args[:12])
        torch.cuda.synchronize()
        check_ok(kind, ok_rt, ok)
        e = errors([gains], [g_rt], ok_ref)
        gate(kind, "backward instance vs the run-time kernel (gains)",
             *e[:2])
        worst_rt = max(worst_rt, e[1])
        del g_rt
        e = forward_vs_plain_and_runtime(rg, kind, A, Bm, c, Jx, gains,
                                         ok_ref, gate)
        worst["forward"] = [max(a, b) for a, b in zip(worst["forward"],
                                                      e[:2])]
        worst_fwd_rt = max(worst_fwd_rt, e[2])
        pair_vs_plain(kind, args, f"R={QR}, r={QEQ}")
        log(f"  [{kind}] ok {int(ok.sum())}/{B} (equal to plain, as "
            "expected)")
        del args, gains, g_ref
    # the forward instance at an odd horizon (the gains of every other stage
    # start 8 bytes off a 16-byte boundary) and on inputs 4 bytes off one
    for kind, seed in CASES.items():
        args = general_case(kind, seed, Hn=FWD_ODD_H)
        gains, ok_ref = rg.riccati_general_backward_plain(*args[:12])
        e = forward_vs_plain_and_runtime(
            rg, f"{kind}, H={FWD_ODD_H}", args[0], args[1], args[6], args[12],
            gains, ok_ref, gate)
        worst["forward"] = [max(a, b) for a, b in zip(worst["forward"],
                                                      e[:2])]
        worst_fwd_rt = max(worst_fwd_rt, e[2])
        del args, gains
    args = general_case("delta_per_problem", 1)
    gains, ok_ref = rg.riccati_general_backward_plain(*args[:12])
    ins = [args[0], args[1], args[6], args[12], gains]
    mis = [misaligned(a) for a in ins]
    moved = rg.riccati_general_forward_cuda(*mis)
    aligned = rg.riccati_general_forward_cuda(*ins)
    torch.cuda.synchronize()
    same_bits = all(torch.equal(m, a) for m, a in zip(moved, aligned))
    e = errors(moved, rg.riccati_general_forward_plain(*ins), ok_ref)
    gate("delta_per_problem", "forward instance, inputs 4 bytes off 16",
         *e[:2])
    log(f"  forward instance on inputs 4 bytes off a 16-byte boundary: the "
        f"aligned inputs' outputs bit for bit: {same_bits}")
    if not same_bits:
        raise RuntimeError("the forward instance's outputs move with the "
                           "inputs' alignment")
    del args, gains, ins, mis, moved, aligned

    pair_vs_plain("delta_per_problem",
                  general_case("delta_per_problem", 1, R=2, r=0),
                  "R=2, r=0 (border only)")
    # at r = nu the rows fix the control and nothing steers the states:
    # a short horizon keeps the comparison about the kernel, not about
    # conditioning (sweep_cases.general_sweep_case)
    pair_vs_plain("delta_per_problem",
                  general_case("delta_per_problem", 1, R=1, r=QNU,
                               Hn=PURE_EQ_H),
                  f"R=1, r={QNU}, H={PURE_EQ_H} (pure EQ)")

    # two CUDA designs on one function: at R=1, r=0 the general pair
    # computes the plain streamed pair's sweep
    args = general_case("delta_per_problem", 1, R=1, r=0)
    gen = rg.riccati_sweep_general_streamed_cuda(*args)
    plain = rk.riccati_sweep_streamed_cuda(
        *[a[:, :, 0].contiguous() if i in (4, 5, 6) else a
          for i, a in enumerate(args[:8])])
    torch.cuda.synchronize()
    check_ok("delta_per_problem", gen[4], plain[3])
    abs_err, scaled, _ = errors([g[:, :, 0] for g in gen[:3]], plain[:3],
                                plain[3])
    log(f"general pair at R=1, r=0 vs streamed pair (B={B}, H={QH}, "
        f"nx={QNX}, nu={QNU}): max |diff| {abs_err:.3e}, scaled "
        f"{scaled:.3e} (limit {STREAMED_TOL})")
    if not scaled <= STREAMED_TOL:
        raise RuntimeError(f"general and streamed pairs differ by "
                           f"{scaled:.3e}")

    args = general_case("delta0", 0)
    A, Bm, c, Jx = args[0], args[1], args[6], args[12]
    gains, ok = rg.riccati_general_backward_cuda(*args[:12])
    dims = (B, QH, QNX, QNU, QR, QEQ)
    label = f"B={B}, H={QH}, nx={QNX}, nu={QNU}, R={QR}, r={QEQ}"
    instance = rk.general_backward_kernel(QNX, QNU, QR, QEQ)
    if instance != "riccati_general_backward_fixed":
        raise RuntimeError(f"the EQ/border stage takes {instance}, not the "
                           "compile-time instance")
    # the template's arguments tell this instance from the quadrotor's
    instance += f"<{QNX}, {QNU}, {QR}, {QEQ}>"
    bwd = kernel_entry(
        "riccati_general_backward", "riccati_general.cu", f"{PALLAS}:991",
        lambda: rg.riccati_general_backward_cuda(*args[:12]), instance,
        lambda: rg.riccati_general_backward_plain(*args[:12]),
        rg.general_backward_bytes(*dims), rg.general_backward_flops(*dims),
        label, plain_runs=5)
    # the other CUDA design of the same function, timed in the same run
    rt_ms, rt_how = kernel_device_ms(
        lambda: rg.riccati_general_backward_runtime_cuda(*args[:12]),
        "riccati_general_backward_kernel")
    rt_call_ms = cuda_median_ms(
        lambda: rg.riccati_general_backward_runtime_cuda(*args[:12]))
    log(f"riccati_general_backward: instance {bwd['ms'] * 1e3:.2f} us, "
        f"run-time kernel {rt_ms * 1e3:.2f} us ({rt_how}; "
        f"{rt_call_ms * 1e3:.1f} us per wrapper call) of device time at "
        f"{label}: the instance takes {bwd['ms'] / rt_ms:.2%} of the "
        f"run-time kernel's time; instance vs run-time gains max scaled "
        f"diff {worst_rt:.3e}")
    bwd.update(design=f"compile-time instance {instance}",
               runtime_ms=rt_ms, runtime_call_ms=rt_call_ms,
               max_scaled_err_vs_runtime=worst_rt)
    fwd_instance = rk.general_forward_kernel(QNX, QNU, QR, QEQ)
    if not fwd_instance.startswith("riccati_general_forward_fixed<"):
        raise RuntimeError(f"the EQ/border stage's forward takes "
                           f"{fwd_instance}, not the compile-time instance")
    # the timed launches' outputs: the last one of each turn must be the
    # checked outputs bit for bit (the instance sums in a fixed order)
    timed = {}

    def inst():
        timed["out"] = rg.riccati_general_forward_cuda(A, Bm, c, Jx, gains)
        return timed["out"]

    checked = inst()
    torch.cuda.synchronize()
    gate("delta0", "forward instance, timed inputs",
         *errors(checked, rg.riccati_general_forward_plain(A, Bm, c, Jx,
                                                           gains), ok)[:2])

    def same_as_checked(cache, who):
        if who != "instance":
            return
        torch.cuda.synchronize()
        if not all(torch.equal(t, q) for t, q in zip(timed["out"], checked)):
            raise RuntimeError(f"a timed launch of the forward instance "
                               f"[{cache}] differs from its checked outputs")

    runtime = lambda: rg.riccati_general_forward_runtime_cuda(  # noqa: E731
        A, Bm, c, Jx, gains)
    fwd = kernel_entry(
        "riccati_general_forward", "riccati_general.cu", f"{PALLAS}:1024",
        inst, fwd_instance,
        lambda: rg.riccati_general_forward_plain(A, Bm, c, Jx, gains),
        rg.general_forward_bytes(*dims), rg.general_forward_flops(*dims),
        label, plain_runs=5, strict=True)
    same_as_checked("entry", "instance")
    # the run-time kernel and the instance in turns, warm and flushed
    turns = design_turns(
        {"run-time": (runtime, "riccati_general_forward_kernel"),
         "instance": (inst, fwd_instance)},
        turn_order(("run-time", "instance")),
        bound_ms=fwd["bound_ms"], after_turn=same_as_checked)
    mean = {k: statistics.mean(v) for k, v in turns.items()}
    rt_call_ms = cuda_median_ms(runtime)
    depth = rk._GENERAL_FORWARD_INSTANCES[QNX, QNU, QR, QEQ]
    ptxas = ptxas_report(build_log, "riccati_general_forward_fixed",
                         (QNX, QNU, QR, QEQ, depth))
    rt_ptxas = ptxas_report(build_log, "riccati_general_forward_kernel", ())
    log(f"riccati_general_forward at {label}: "
        + ", ".join(f"{who} {mean['warm', who] * 1e3:.2f} us warm / "
                    f"{mean['flushed', who] * 1e3:.2f} us L2 flushed"
                    for who in ("run-time", "instance"))
        + f" (device time, one turn each): the instance takes "
          f"{mean['warm', 'instance'] / mean['warm', 'run-time']:.2%} of the "
          f"run-time kernel's time warm; wrapper calls "
          f"{fwd['call_ms'] * 1e3:.1f} us instance, {rt_call_ms * 1e3:.1f} "
          f"us run-time; instance vs run-time outputs max scaled diff "
          f"{worst_fwd_rt:.3e}; every timed instance launch checked gave "
          f"the checked outputs bit for bit")
    log(f"ptxas forward instance (ring of {depth} stage slots, "
        f"{rk.forward_ring_bytes(QNX, QNU, QR, QEQ, depth)} B of shared "
        f"memory a block): {ptxas}; run-time kernel: {rt_ptxas}")
    fwd.update(design=f"compile-time instance {fwd_instance}",
               runtime_ms=mean["warm", "run-time"], runtime_call_ms=rt_call_ms,
               flushed_ms=mean["flushed", "instance"],
               runtime_flushed_ms=mean["flushed", "run-time"],
               turns_ms={f"{cache}, {who}": v
                         for (cache, who), v in turns.items()},
               max_scaled_err_vs_runtime=worst_fwd_rt,
               ptxas_instance=ptxas, ptxas_runtime=rt_ptxas)
    for entry, key in ((bwd, "backward"), (fwd, "forward")):
        entry.update(max_abs_err=worst[key][0], max_scaled_err=worst[key][1])
    pair_ms = cuda_median_ms(
        lambda: rg.riccati_sweep_general_streamed_cuda(*args))
    log(f"general sweep (backward + forward, one wrapper call): "
        f"{pair_ms * 1e3:.1f} us")
    return bwd, fwd, pair_ms


def lv_general_case(kind, seed, R, r, Hn=H):
    """One of the seeded general cases at the LV stage (2, 1), on the
    card."""
    from pyneuralempc_tpu_torch.ops.cuda import sweep_cases
    case = sweep_cases.general_sweep_case(kind, B=B, H=Hn, nx=2, nu=1, R=R,
                                          r=r, seed=seed)
    return [torch.as_tensor(a, device="cuda") for a in case]


def ptxas_report(log, kernel, template_args):
    """ptxas -v's lines for one instance of ``kernel`` in a build log: its
    registers, spills, stack and barriers (dynamic shared memory is set at
    launch and not in the report)."""
    # the instance's mangled name: kernel I Li<arg>E ... E (a kernel that
    # is no template: kernel E, the end of its nested name)
    mangled = (f"{kernel}I{''.join(f'Li{a}E' for a in template_args)}E"
               if template_args else f"{kernel}E")
    out, inside = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            inside = mangled in line
            continue
        if inside and ("Used" in line or "spill" in line or "stack" in line):
            out.append(" ".join(line.replace("ptxas info    :", "").split()))
    return "; ".join(out) or "not in the build log (built earlier)"


PHASES = ("prologue", "backward", "forward", "epilogue")


def phase_split(rg, args, wrap, runs=10):
    """The staged kernel's phases from its stamps (per block: SM cycles and
    device ns at its start and after each phase), medians over the blocks
    and then over ``runs`` launches; with the span from the first block's
    start to the last block's end, and the spread of the blocks' starts."""
    per_run = []
    for _ in range(runs):
        stamps = wrap(lambda: rg.fused_phase_stamps(*args))()
        torch.cuda.synchronize()
        st = stamps.cpu().double()
        per_run.append(
            [float((st[:, k + 1, 1] - st[:, k, 1]).median()) / 1e3
             for k in range(4)]
            + [float((st[:, k + 1, 0] - st[:, k, 0]).median())
               for k in range(4)]
            + [float(st[:, 4, 1].max() - st[:, 0, 1].min()) / 1e3,
               float(st[:, 0, 1].max() - st[:, 0, 1].min()) / 1e3])
    med = [statistics.median(col) for col in zip(*per_run)]
    return {"us": dict(zip(PHASES, med[:4])),
            "cycles": dict(zip(PHASES, med[4:8])),
            "span_us": med[8], "start_spread_us": med[9]}


def phase_fused_general(rk, rg, build_log):
    """The staged fused general kernel against the plain general sweep
    (outputs, ok flags, gains), the direct kernel and the streamed general
    pair on the same inputs at the budgeted LV path's stage; then both
    fused kernels' times, warm and L2-flushed, and the pair's at the
    path's shape (R=2, r=0)."""
    worst, worst_direct, worst_pair = [0.0, 0.0], 0.0, 0.0
    checks = [(kind, seed, R, r, H) for R, r in FUSED_GENERAL_SHAPES
              for kind, seed in CASES.items()
              if kind != "local_bump" or r == 0]
    checks += [(kind, seed, 1, 1, PURE_EQ_H) for kind, seed in CASES.items()
               if kind != "local_bump"]
    checks += [(kind, seed, LR, LEQ, FUSED_RAGGED_H)
               for kind, seed in CASES.items()]
    for kind, seed, R, r, Hn in checks:
        P = rk.staged_block_problems(Hn, 2, 1, R, r)
        label = f"R={R}, r={r}, H={Hn}, {P} problems a block"
        args = lv_general_case(kind, seed, R, r, Hn)
        n0 = rg.FUSED_STAGED_LAUNCHES
        *out, gains = rg.riccati_sweep_general_fused_cuda(*args,
                                                          return_gains=True)
        torch.cuda.synchronize()
        if rg.FUSED_STAGED_LAUNCHES != n0 + 1:
            raise RuntimeError(f"{label}: the staged kernel did not launch")
        ref = rg.riccati_sweep_general_plain(*args)
        g_ref, ok_ref = rg.riccati_general_backward_plain(*args[:12])
        check_ok(kind, out[4], ref[4])
        e = errors(out[:4] + [gains], list(ref[:4]) + [g_ref], ref[4])
        *direct, d_gains = rg.riccati_sweep_general_fused_direct_cuda(
            *args, return_gains=True)
        pair = rg.riccati_sweep_general_streamed_cuda(*args)
        torch.cuda.synchronize()
        check_ok(kind, direct[4], out[4])
        check_ok(kind, pair[4], out[4])
        e_direct = errors(out[:4] + [gains], direct[:4] + [d_gains], out[4])
        e_pair = errors(pair[:4], out[:4], out[4])
        log(f"fused general staged vs plain [{kind}, {label}]: ok "
            f"{int(ref[4].sum())}/{B} (equal), max |diff| {e[0]:.3e}, max "
            f"|diff|/max(1,|plain|) {e[1]:.3e} (outputs and gains; limit "
            f"{STREAMED_TOL}); vs the direct kernel {e_direct[1]:.3e}, vs "
            f"the general pair {e_pair[1]:.3e}")
        if not (e[1] <= STREAMED_TOL and e_direct[1] <= STREAMED_TOL
                and e_pair[1] <= STREAMED_TOL):
            raise RuntimeError(f"{kind}, {label}: the staged kernel differs "
                               f"from plain by {e[1]:.3e}, from the direct "
                               f"kernel by {e_direct[1]:.3e}, from the "
                               f"general pair by {e_pair[1]:.3e}")
        worst = [max(a, b) for a, b in zip(worst, e[:2])]
        worst_direct = max(worst_direct, e_direct[1])
        worst_pair = max(worst_pair, e_pair[1])
        del args, out, gains, ref, g_ref, direct, d_gains, pair

    args = lv_general_case("delta0", 0, LR, LEQ)
    dims = (B, H, 2, 1, LR, LEQ)
    label = f"B={B}, H={H}, nx=2, nu=1, R={LR}, r={LEQ}"
    plan = rk.kernel_plan(H, 2, 1, "cuda", R=LR, r=LEQ)
    if plan["kernel"] != rk.STAGED_KERNEL:
        raise RuntimeError(f"the budgeted LV shape plans {plan['kernel']}")
    P = plan["block_problems"]
    smem = rk.staged_smem_bytes(P, H, 2, 1, LR, LEQ)
    staged = lambda: rg.riccati_sweep_general_fused_cuda(*args)  # noqa: E731
    direct = lambda: rg.riccati_sweep_general_fused_direct_cuda(  # noqa: E731
        *args)
    entry = kernel_entry(
        "riccati_general_fused", "riccati_general_fused.cu", f"{PALLAS}:953",
        staged, rk.STAGED_KERNEL,
        lambda: rg.riccati_sweep_general_plain(*args),
        rg.general_fused_bytes(*dims), rg.general_fused_flops(*dims), label)
    # the two designs in turns, as the path finds the inputs (warm in L2)
    # and with L2 flushed before each launch
    turns = design_turns({"direct": (direct, rk.DIRECT_KERNEL),
                          "staged": (staged, rk.STAGED_KERNEL)},
                         turn_order(("direct", "staged")),
                         strict=False)
    split = {cache: phase_split(rg, args, wrap)
             for cache, wrap in (("warm", lambda fn: fn),
                                 ("flushed", l2_flusher()))}
    for cache, sp in split.items():
        log(f"staged kernel phases [{cache}] (per block, medians; stamps "
            "from %globaltimer and clock64): "
            + ", ".join(f"{k} {sp['us'][k]:.2f} us ({sp['cycles'][k]:.0f} "
                        "cycles)" for k in PHASES)
            + f"; backward {sp['cycles']['backward'] / H:.0f} and forward "
              f"{sp['cycles']['forward'] / H:.0f} cycles a stage; first "
              f"start to last end {sp['span_us']:.2f} us, blocks start "
              f"within {sp['start_spread_us']:.2f} us")
    direct_call_ms = cuda_median_ms(direct)
    mean = {k: statistics.mean(v) for k, v in turns.items()}
    staged_ptxas = ptxas_report(build_log, rk.STAGED_KERNEL, (2, 1, LR, LEQ))
    direct_ptxas = ptxas_report(build_log, rk.DIRECT_KERNEL, (2, 1, LR, LEQ))
    log(f"riccati_general_fused at {label}: staged kernel "
        f"{mean['warm', 'staged'] * 1e3:.2f} us warm / "
        f"{mean['flushed', 'staged'] * 1e3:.2f} us L2 flushed, direct "
        f"kernel {mean['warm', 'direct'] * 1e3:.2f} us / "
        f"{mean['flushed', 'direct'] * 1e3:.2f} us (device time, means of "
        f"one turn each): the staged kernel takes "
        f"{mean['warm', 'staged'] / mean['warm', 'direct']:.2%} of the "
        f"direct kernel's time warm; wrapper calls "
        f"{entry['call_ms'] * 1e3:.1f} us staged, "
        f"{direct_call_ms * 1e3:.1f} us direct")
    log(f"staged block: {P} problems, {smem} bytes of dynamic shared memory,"
        f" {(B + P - 1) // P} blocks; ptxas staged <2, 1, {LR}, {LEQ}>: "
        f"{staged_ptxas}; direct: {direct_ptxas}")
    entry.update(max_abs_err=worst[0], max_scaled_err=worst[1],
                 max_scaled_err_vs_direct=worst_direct,
                 max_scaled_err_vs_pair=worst_pair,
                 design=f"staged ({rk.STAGED_KERNEL}, {P} problems a block, "
                        f"{smem} B of shared memory)",
                 staged_turns_ms=turns["warm", "staged"],
                 staged_flushed_turns_ms=turns["flushed", "staged"],
                 direct_turns_ms=turns["warm", "direct"],
                 direct_flushed_turns_ms=turns["flushed", "direct"],
                 direct_ms=mean["warm", "direct"],
                 direct_call_ms=direct_call_ms,
                 flushed_ms=mean["flushed", "staged"],
                 direct_flushed_ms=mean["flushed", "direct"],
                 ptxas_staged=staged_ptxas, ptxas_direct=direct_ptxas,
                 phase_split=split)
    # the comparison the Pallas design made between its two branches
    gains, _ = rg.riccati_general_backward_cuda(*args[:12])
    A, Bm, c, Jx = args[0], args[1], args[6], args[12]
    bwd_ms, how_b = kernel_device_ms(
        lambda: rg.riccati_general_backward_cuda(*args[:12]),
        "riccati_general_backward_kernel")
    fwd_ms, how_f = kernel_device_ms(
        lambda: rg.riccati_general_forward_cuda(A, Bm, c, Jx, gains),
        "riccati_general_forward_kernel")
    pair_ms = cuda_median_ms(
        lambda: rg.riccati_sweep_general_streamed_cuda(*args))
    entry["pair_ms"] = bwd_ms + fwd_ms
    log(f"streamed general pair at {label}: backward {bwd_ms * 1e3:.2f} us "
        f"({how_b}) + forward {fwd_ms * 1e3:.2f} us ({how_f}) of device "
        f"time; {pair_ms * 1e3:.1f} us per wrapper call; the staged kernel "
        f"takes {entry['ms'] / (bwd_ms + fwd_ms):.2%} of the pair's device "
        "time")
    return entry


# ---- phase 3e: the streamed instances at the new paths' stages ----

def tiled_sweep_case(kind, seed, Bn, Hn, nx, nu, tile):
    """A seeded case of Bn problems repeated ``tile`` times along the batch
    on the card (a case drawn at B=16384, H=100 would take numpy most of a
    minute); the cases' per-problem patterns repeat with a period that
    divides Bn."""
    args = sweep_case(kind, seed, Bn=Bn, Hn=Hn, nx=nx, nu=nu)
    if tile == 1:
        return args
    return [a.repeat((tile,) + (1,) * (a.dim() - 1)) for a in args]


def phase_streamed_new_shapes(rk, build_log):
    """The streamed instances at the GRU fleet's lifted stage (10, 1),
    H=100, B=16384, at cartpole's (4, 1), H=50, and at the quadrotor GRU's
    (28, 4), H=100, B=4096, against the plain halves, the run-time kernels
    and the plain sweep on the four seeded cases ((4, 1) at B=4096 and on
    each case's first problem alone, the path's B=1); then both timed
    against the run-time kernels at the paths' shapes, (4, 1) at B=4096
    too."""
    out = {}
    for tag, nx, nu, Hn, b_case, tile, path in NEW_STREAMED_SHAPES:
        if (nx, nu) not in rk._BACKWARD_INSTANCES or \
                (nx, nu) not in rk._FORWARD_INSTANCES:
            raise RuntimeError(f"({nx}, {nu}) takes {rk.backward_kernel(nx, nu)}"
                               f" and {rk.forward_kernel(nx, nu)}, not the "
                               "compile-time instances")
        plan = rk.kernel_plan(Hn, nx, nu, "cuda")
        if plan["path"] != "cuda_streamed":
            raise RuntimeError(f"({nx}, {nu}) at H={Hn} plans {plan}")
        worst = None
        for kind, seed in CASES.items():
            args = tiled_sweep_case(kind, seed, b_case, Hn, nx, nu, tile)
            label = f"B={b_case * tile}, H={Hn}, nx={nx}, nu={nu}"
            worst = worse(worst, hold_streamed_pair(rk, kind, args, label))
            if path == "cartpole":
                # the path's one problem, checked on its own
                worst = worse(worst, hold_streamed_pair(
                    rk, kind, [a[:1].contiguous() for a in args],
                    f"B=1, H={Hn}, nx={nx}, nu={nu}"))
            del args
        args = tiled_sweep_case("delta0", 0, b_case, Hn, nx, nu, tile)
        if path == "cartpole":
            one = [a[:1].contiguous() for a in args]
            big = instance_entries(rk, f" [{tag}, B={b_case}]", args, path,
                                   build_log)
            bwd, fwd, pair_ms = instance_entries(rk, f" [{tag}, B=1]", one,
                                                 path, build_log)
            for e, e_big in zip((bwd, fwd), big[:2]):
                e.update({f"b{b_case}_{k}": e_big[k] for k in (
                    "ms", "call_ms", "plain_ms", "bound_ms", "runtime_ms",
                    "flushed_ms", "runtime_flushed_ms")})
            # the multi-start's B=CP_STARTS: the instances timed at it too
            for e, e_small in zip((bwd, fwd), pair_entries(
                    rk, f" [{tag}, B={CP_STARTS}]",
                    [a[:CP_STARTS].contiguous() for a in args])):
                e.update({f"b{CP_STARTS}_{k}": e_small[k] for k in (
                    "ms", "call_ms", "plain_ms", "bound_ms")})
        else:
            bwd, fwd, pair_ms = instance_entries(rk, f" [{tag}]", args, path,
                                                 build_log)
        set_worst(bwd, fwd, worst)
        out[path] = (bwd, fwd, pair_ms)
        del args
        torch.cuda.empty_cache()
    return out


def pair_entries(rk, name, args):
    """Kernel-line entries of the kernels that the streamed backward and
    forward entries launch on ``args`` (an instance or the run-time
    kernel): device time, wrapper call, plain version and bound as in
    phase 3, no turns."""
    Bn, Hn, nx = args[6].shape
    nu = args[1].shape[-1]
    dims = (Bn, Hn, nx, nu)
    A, Bm, c = args[0], args[1], args[6]
    gains, _ = rk.riccati_backward_cuda(*args)
    torch.cuda.synchronize()
    label = f"B={Bn}, H={Hn}, nx={nx}, nu={nu}"
    return [kernel_entry(
        f"riccati_backward{name}", "riccati_streamed.cu", f"{PALLAS}:468",
        lambda: rk.riccati_backward_cuda(*args), rk.backward_kernel(nx, nu),
        lambda: rk.riccati_backward_plain(*args), rk.backward_bytes(*dims),
        rk.backward_flops(*dims), label, plain_runs=5, strict=True),
        kernel_entry(
        f"riccati_forward{name}", "riccati_streamed.cu", f"{PALLAS}:488",
        lambda: rk.riccati_forward_cuda(A, Bm, c, gains),
        rk.forward_kernel(nx, nu),
        lambda: rk.riccati_forward_plain(A, Bm, c, gains),
        rk.forward_bytes(*dims), rk.forward_flops(*dims), label,
        plain_runs=5, strict=True)]


def same_bits(a, b):
    """Equal element for element, NaN where the other is NaN (a problem
    whose factorisation failed may carry NaN through its stages)."""
    return bool(((a == b) | (a.isnan() & b.isnan())).all())


def alt_depth_source(rk, build):
    """riccati_streamed.cu with the (12, 10) forward instance at
    W_ALT_DEPTH, written into the build directory (its headers found
    through -I): the other candidate depth, for the turns."""
    depth = rk._FORWARD_INSTANCES[W_NX, W_NU]
    case = f"RICCATI_FORWARD_CASE({W_NX}, {W_NU}, {depth})"
    text = (build.CSRC_DIR / rk.STREAMED_SOURCE).read_text()
    if text.count(case) != 1:
        raise RuntimeError(f"{rk.STREAMED_SOURCE} does not list {case}")
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = build.BUILD_DIR / f"riccati_streamed_wide_d{W_ALT_DEPTH}.cu"
    path.write_text(text.replace(
        case, f"RICCATI_FORWARD_CASE({W_NX}, {W_NU}, {W_ALT_DEPTH})"))
    return path, ("-I", str(build.CSRC_DIR))


def library_forward(lib_path):
    """``riccati_forward_f32`` of another build of riccati_streamed.cu,
    called as riccati_forward_cuda calls its own (no counter moves)."""
    import ctypes
    fn = ctypes.CDLL(str(lib_path)).riccati_forward_f32
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def call(A, Bm, c, gains):
        Bn, Hn, nx = c.shape
        nu = Bm.shape[-1]
        dX, dLam = torch.empty_like(c), torch.empty_like(c)
        dU = c.new_empty((Bn, Hn, nu))
        err = fn(A.data_ptr(), Bm.data_ptr(), c.data_ptr(), gains.data_ptr(),
                 dX.data_ptr(), dU.data_ptr(), dLam.data_ptr(), Bn, Hn, nx,
                 nu, c.device.index or 0,
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"the depth-{W_ALT_DEPTH} forward instance's "
                               f"launch failed: CUDA error {err}")
        return dX, dU, dLam
    return call


def phase_streamed_wide(rk, build_log, alt_forward, alt_log):
    """Phase 3e at the wide fleet's stage (12, 10), H=50, B=4096: the
    backward instance (Quu factored one row a lane, one stage buffer a
    warp) and the forward instance against the plain halves, the run-time
    kernels and the plain sweep on the four seeded cases; the forward
    instance bit for bit against the run-time forward kernel and against
    its other candidate depth; then both timed, each in turns against its
    run-time kernel, warm and with L2 flushed, and the forward instance
    against its other depth."""
    nx, nu, Hn = W_NX, W_NU, W_H
    plan = rk.kernel_plan(Hn, nx, nu, "cuda")
    bname, fname = plan.get("backward_kernel"), plan.get("forward_kernel")
    alt_name = f"riccati_general_forward_fixed<{nx}, {nu}, 1, 0, {W_ALT_DEPTH}>"
    log(f"wide stage: sweep plan {plan}")
    if (plan["path"] != "cuda_streamed"
            or bname != f"riccati_general_backward_fixed<{nx}, {nu}, 1, 0>"
            or not fname.startswith(
                f"riccati_general_forward_fixed<{nx}, {nu}, 1, 0, ")):
        raise RuntimeError(f"({nx}, {nu}) plans {plan}")
    label = f"B={B}, H={Hn}, nx={nx}, nu={nu}"
    worst = None
    for kind, seed in CASES.items():
        args = tiled_sweep_case(kind, seed, W_CASE_B, Hn, nx, nu,
                                B // W_CASE_B)
        worst = worse(worst, hold_streamed_pair(rk, kind, args, label))
        gains, _ = rk.riccati_backward_cuda(*args)
        ins = (args[0], args[1], args[6], gains)
        out = rk.riccati_forward_cuda(*ins)
        rt = rk.riccati_forward_runtime_cuda(*ins)
        alt = alt_forward(*ins)
        torch.cuda.synchronize()
        if not all(same_bits(o, r) and same_bits(o, a)
                   for o, r, a in zip(out, rt, alt)):
            raise RuntimeError(f"{kind}: the forward instance at ({nx}, "
                               f"{nu}) differs from the run-time forward "
                               "kernel or from its other depth")
        log(f"  [{kind}, {label}] forward instance == run-time forward "
            f"kernel == depth {W_ALT_DEPTH}, bit for bit")
        del args, gains, ins, out, rt, alt

    args = tiled_sweep_case("delta0", 0, W_CASE_B, Hn, nx, nu, B // W_CASE_B)
    A, Bm, c = args[0], args[1], args[6]
    dims = (B, Hn, nx, nu)
    gains, _ = rk.riccati_backward_cuda(*args)
    torch.cuda.synchronize()
    bwd_call = lambda: rk.riccati_backward_cuda(*args)  # noqa: E731
    bwd = kernel_entry(
        "riccati_backward [wide]", "riccati_streamed.cu", f"{PALLAS}:468",
        bwd_call, bname, lambda: rk.riccati_backward_plain(*args),
        rk.backward_bytes(*dims), rk.backward_flops(*dims), label,
        plain_runs=3, strict=True)
    b_turns = design_turns(
        {"run-time": (lambda: rk.riccati_backward_runtime_cuda(*args),
                      "riccati_backward_kernel"),
         "instance": (bwd_call, bname)},
        turn_order(("run-time", "instance")), bound_ms=bwd["bound_ms"])
    b_mean = {k: statistics.mean(v) for k, v in b_turns.items()}
    log(f"riccati_backward at {label}: run-time "
        f"{b_mean['warm', 'run-time'] * 1e3:.2f} / "
        f"{b_mean['flushed', 'run-time'] * 1e3:.2f} us, instance "
        f"{b_mean['warm', 'instance'] * 1e3:.2f} / "
        f"{b_mean['flushed', 'instance'] * 1e3:.2f} us (warm / L2 flushed, "
        "one turn each): the instance takes "
        f"{b_mean['warm', 'instance'] / b_mean['warm', 'run-time']:.2%} of "
        "the run-time kernel's time warm, "
        f"{bwd['bound_ms'] / b_mean['warm', 'instance']:.2%} of its bound")
    fwd_call = lambda: rk.riccati_forward_cuda(A, Bm, c, gains)  # noqa: E731
    fwd = kernel_entry(
        "riccati_forward [wide]", "riccati_streamed.cu", f"{PALLAS}:488",
        fwd_call, fname, lambda: rk.riccati_forward_plain(A, Bm, c, gains),
        rk.forward_bytes(*dims), rk.forward_flops(*dims), label,
        plain_runs=3, strict=True)
    turns = design_turns(
        {"run-time": (lambda: rk.riccati_forward_runtime_cuda(A, Bm, c,
                                                              gains),
                      "riccati_forward_kernel"),
         "instance": (fwd_call, fname)},
        turn_order(("run-time", "instance")), bound_ms=fwd["bound_ms"])
    mean = {k: statistics.mean(v) for k, v in turns.items()}
    depth = rk._FORWARD_INSTANCES[nx, nu]
    d_turns = design_turns(
        {f"D={depth}": (fwd_call, fname),
         f"D={W_ALT_DEPTH}": (lambda: alt_forward(A, Bm, c, gains),
                              alt_name)},
        turn_order((f"D={W_ALT_DEPTH}", f"D={depth}")),
        bound_ms=fwd["bound_ms"])
    d_mean = {k: statistics.mean(v) for k, v in d_turns.items()}
    log(f"riccati_forward at {label}: run-time "
        f"{mean['warm', 'run-time'] * 1e3:.2f} / "
        f"{mean['flushed', 'run-time'] * 1e3:.2f} us, instance "
        f"{mean['warm', 'instance'] * 1e3:.2f} / "
        f"{mean['flushed', 'instance'] * 1e3:.2f} us (warm / L2 flushed, "
        "one turn each); ring depths "
        + ", ".join(f"{who} {d_mean['warm', who] * 1e3:.2f} / "
                    f"{d_mean['flushed', who] * 1e3:.2f} us"
                    for who in (f"D={depth}", f"D={W_ALT_DEPTH}")))
    fwd.update(design=f"compile-time instance {fname}", path="fleet_wide",
               shape=dict(zip(("B", "H", "nx", "nu"), dims)),
               runtime_ms=mean["warm", "run-time"],
               flushed_ms=mean["flushed", "instance"],
               runtime_flushed_ms=mean["flushed", "run-time"],
               depth=depth,
               turns_ms={f"{cache}, {who}": v
                         for (cache, who), v in turns.items()},
               depth_turns_ms={f"{cache}, {who}": v
                               for (cache, who), v in d_turns.items()},
               ptxas_instance=ptxas_report(
                   build_log, "riccati_general_forward_fixed",
                   (nx, nu, 1, 0, depth)),
               ptxas_alt_depth=ptxas_report(
                   alt_log, "riccati_general_forward_fixed",
                   (nx, nu, 1, 0, W_ALT_DEPTH)),
               ring_bytes=rk.forward_ring_bytes(nx, nu, 1, 0, depth))
    bwd.update(design=f"compile-time instance {bname}", path="fleet_wide",
               shape=fwd["shape"],
               runtime_ms=b_mean["warm", "run-time"],
               flushed_ms=b_mean["flushed", "instance"],
               runtime_flushed_ms=b_mean["flushed", "run-time"],
               turns_ms={f"{cache}, {who}": v
                         for (cache, who), v in b_turns.items()},
               smem_bytes_a_warp=rk.backward_fixed_smem_bytes(nx, nu, 1, 0),
               stage_buffers=rk.backward_fixed_buffers(nx, nu, 1, 0),
               ptxas_instance=ptxas_report(
                   build_log, "riccati_general_backward_fixed",
                   (nx, nu, 1, 0)),
               ptxas_runtime=ptxas_report(build_log,
                                          "riccati_backward_kernel", ()))
    log(f"ptxas: backward instance ({bwd['stage_buffers']} stage buffer(s), "
        f"{bwd['smem_bytes_a_warp']} B a warp) {bwd['ptxas_instance']}; "
        f"run-time backward {bwd['ptxas_runtime']}; forward "
        f"instance D={depth} ({fwd['ring_bytes']} B a block) "
        f"{fwd['ptxas_instance']}; D={W_ALT_DEPTH} "
        f"({rk.forward_ring_bytes(nx, nu, 1, 0, W_ALT_DEPTH)} B a block) "
        f"{fwd['ptxas_alt_depth']}")
    pair_ms = cuda_median_ms(lambda: rk.riccati_sweep_streamed_cuda(*args))
    log(f"streamed sweep [wide] (backward + forward, one wrapper call): "
        f"{pair_ms * 1e3:.1f} us")
    set_worst(bwd, fwd, worst)
    del args, gains
    torch.cuda.empty_cache()
    return bwd, fwd, pair_ms


# ---- phases 4, 4b, 4c: main paths ----

def make_controller(nempc, device, model=None, cost=None, config=None,
                    differentiable=False, **options):
    """bench.py's LV controller on ``device``: the 2x32 tanh surrogate (or
    ``model``), bench.py's cost (or ``cost``), with IPConfig ``options`` on
    top of bench.py's (or ``config``)."""
    surrogate = model or nempc.MLPDynamics.make(x_dim=2, u_dim=1,
                                                hidden=[32, 32])
    box = nempc.DomainConstraint(states_constraint=[[-1.0, 1.0],
                                                    [-1.0, 0.35]],
                                 control_constraint=[[0.0, 1.2]])
    cfg = config or nempc.IPConfig(tol=1e-5, polish_iters=5, polish_mu=1e-9,
                                   warm_z_corridor=1e2, warm_mu=3e-4,
                                   **options)
    return nempc.NMPC(surrogate, cost or (
        lambda x, u: 1.1 * torch.sum(u) + REG * torch.sum(u * u)),
        [box], H=H, DT=DT, integrator="rk4", config=cfg,
        differentiable=differentiable, device=device)


def telemetry(tag, res):
    it = res.iterations.float()
    return (f"{tag}: converged {int(res.converged.sum())}/"
            f"{res.converged.numel()}  iterations mean {float(it.mean()):.2f}"
            f" max {int(it.max())}  restorations "
            f"{int(res.restorations.sum())}")


def check_plan(res, Hn, nx, nu, Bn=B):
    for t in (res.u, res.x, res.objective):
        if not bool(torch.isfinite(t).all()):
            raise RuntimeError("non-finite plan")
    if (tuple(res.u.shape) != (Bn, Hn, nu)
            or tuple(res.x.shape) != (Bn, Hn, nx)):
        raise RuntimeError(f"unexpected plan shapes {tuple(res.x.shape)}, "
                           f"{tuple(res.u.shape)}")


def report_split(nempc, mpc, carry, xs, res, times, sweeps, sweep_ms, card,
                 params=None, busy=True):
    """Time split of the last warm step (stage blocks and sweeps timed
    alone at the same shapes, times their call counts; one block
    preparation per solver iteration of the lockstep batch), and, with
    ``busy``, the device busy share of one more warm re-plan (same carry,
    result dropped) from torch.profiler's kernel and copy events."""
    Bn = xs.shape[0]
    solver_rt = nempc.runtime(xs, params=params)
    solver_rt["_s_obj"] = torch.ones(Bn, device="cuda")
    direction = nempc.solve.riccati.make_riccati_direction(mpc.nlp,
                                                           mpc.config)
    prep_ms = cuda_median_ms(
        lambda: direction.prepare(carry.w, carry.lam, solver_rt), runs=5)
    n_prep = int(res.iterations.max())
    step_ms = statistics.median(times) * 1e3
    blocks_ms = prep_ms * n_prep
    sweeps_ms = sweep_ms * sweeps
    log(f"[{card}] warm re-plan split (last step, estimated): stage blocks "
        f"{blocks_ms:.1f} ms ({n_prep} x {prep_ms:.2f} ms), sweeps "
        f"{sweeps_ms:.2f} ms ({sweeps} x {sweep_ms:.4f} ms a wrapper "
        "call, host work included), rest "
        f"{step_ms - blocks_ms - sweeps_ms:.1f} ms of p50 {step_ms:.1f} ms")
    busy = (busy_share(mpc, xs, carry, step_ms, card, params, "one")
            if busy else None)
    p50 = statistics.median(times)
    log(f"[{card}] warm re-plan B={Bn}: p50 {p50 * 1e3:.1f} ms, min "
        f"{min(times) * 1e3:.1f} ms -> {Bn / p50:,.0f} solves/s")
    return {"p50_ms": p50 * 1e3, "solves_per_s": Bn / p50,
            "prepare_ms": prep_ms, "busy": busy}


def busy_share(mpc, xs, carry, step_ms, card, params, which):
    """The device busy share of ``which`` (one more) warm re-plan (same
    carry, result dropped) against ``step_ms``, from torch.profiler's
    kernel and copy events; None where the trace holds none."""
    from torch.profiler import ProfilerActivity, profile
    # device events only: recording every host op as well made the traced
    # re-plan take 20-60 s more at 40-60k events
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        mpc.next_batch(xs, params=params, carry=carry)
        torch.cuda.synchronize()
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        log("device busy share: not measured (the trace holds no device "
            "events)")
        return None
    dev_ms = sum(e.time_range.elapsed_us() for e in dev) / 1e3
    log(f"[{card}] {which} warm re-plan: {len(dev)} device events "
        f"(kernels and copies), {dev_ms:.1f} ms of device time -> device "
        f"busy {dev_ms / step_ms:.1%} of the p50 re-plan")
    return dev_ms / step_ms


def phase_main_path(nempc, rk, rg, card):
    from pyneuralempc_tpu_torch.ops.integrators import step_fn

    t0 = time.perf_counter()
    surrogate = nempc.MLPDynamics.make(x_dim=2, u_dim=1, hidden=[32, 32])
    gen = torch.Generator()
    gen.manual_seed(0)
    X, U, Y = nempc.sample_transitions(f_true, gen, 8192, 2, 1,
                                       x_range=(-1.0, 1.2),
                                       u_range=(0.0, 1.2), device="cuda")
    params, mse = nempc.fit_surrogate(surrogate, X, U, Y, steps=3000,
                                      lr=2e-3, batch=1024)
    torch.cuda.synchronize()
    log(f"surrogate trained on the card: mse {mse:.2e} "
        f"({time.perf_counter() - t0:.1f} s, 3000 Adam steps)")

    mpc = make_controller(nempc, "cuda")
    log(f"kkt backend: {mpc.kkt_backend}; sweep plan: "
        f"{rk.kernel_plan(H, 2, 1, 'cuda')}")
    rng = np.random.default_rng(0)
    x0s = np.stack([rng.uniform(0.2, 0.8, B), rng.uniform(-0.9, -0.3, B)],
                   axis=1).astype(np.float32)
    plant = step_fn(nempc.torch_dynamics(f_true, 2, 1), "rk4", DT)

    reset_counters(rk, rg)
    t0 = time.perf_counter()
    xs = torch.as_tensor(x0s, device="cuda")
    carry, res = mpc.next_batch(xs, params=params)
    torch.cuda.synchronize()
    log(f"cold B={B}: {time.perf_counter() - t0:.2f} s  "
        + telemetry("cold", res) + f"  sweeps {rk.LAUNCHES}")
    cold = res
    times, conv, launches = [], [], []
    for step in range(WARM_STEPS):
        xs = plant(xs, res.u[:, 0])
        torch.cuda.synchronize()
        n0 = rk.LAUNCHES
        t0 = time.perf_counter()
        carry, res = mpc.next_batch(xs, params=params, carry=carry)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        conv.append(int(res.converged.sum()))
        launches.append(rk.LAUNCHES - n0)
        log(f"warm {step}: {times[-1] * 1e3:.1f} ms  sweeps "
            f"{launches[-1]}  " + telemetry("warm", res))
    n = counters(rk, rg)
    log(f"LV path: fused kernel launches {n['fused']} (staged "
        f"{n['fused_staged']}, riccati_sweep.cu {n['fused_direct']}), "
        f"streamed backward "
        f"{n['backward']} / forward {n['forward']}, general "
        f"{n['general_backward']} / {n['general_forward']}, plain calls "
        f"{n['plain']}")
    if (not only_launched(n, "fused", "fused_staged")
            or n["fused_staged"] != n["fused"]):
        raise RuntimeError("the LV path did not go through the staged fused "
                           "kernel alone")
    if min(conv) < MIN_WARM_CONVERGED:
        raise RuntimeError(f"warm convergence {conv} below "
                           f"{MIN_WARM_CONVERGED}/{B}")
    check_plan(res, H, 2, 1)
    log(f"converged per warm step {conv}")

    args = sweep_case("delta0", 0)
    sweep_ms = cuda_median_ms(lambda: rk.riccati_sweep_cuda(*args))
    report_split(nempc, mpc, carry, xs, res, times, launches[-1], sweep_ms,
                 card, params=params)

    # per-member inputs: the shared surrogate stacked B times is one model
    # per member (the JAX package's rule), each the shared one.  The
    # per-member path's matmuls are batched products, the shared path's one
    # product: f32 rounds them apart, and some members' cold plans are
    # fixed by f32 only loosely (their shared plan moves by up to ~5e-3
    # when the start moves by 1e-7).  So, as for the budgeted fleet (phase
    # 5), the shared solve is repeated from starts moved by ±PERTURB:
    # members it moves by at most DETERMINED, with the same iterations,
    # are held to PER_MEMBER_DU; any other to PER_MEMBER_DU + SPREAD times
    # its move.
    stacked = [{k: v.expand((B,) + tuple(v.shape)).contiguous()
                for k, v in layer.items()} for layer in params]
    starts = torch.as_tensor(x0s, device="cuda")
    t0 = time.perf_counter()
    _, per = mpc.next_batch(starts, params=stacked)
    torch.cuda.synchronize()
    log(f"per-member params (the surrogate stacked {B} times), cold B={B}: "
        f"{time.perf_counter() - t0:.2f} s  " + telemetry("cold", per))
    moved = torch.zeros(B, device="cuda")
    same_iters = torch.ones(B, dtype=torch.bool, device="cuda")
    for eps in (PERTURB, -PERTURB):
        _, alt = mpc.next_batch(starts + eps, params=params)
        moved = torch.maximum(moved, (alt.u - cold.u).abs().amax(dim=(1, 2)))
        same_iters &= alt.iterations == cold.iterations
    determined = (moved <= DETERMINED) & same_iters
    d = (per.u - cold.u).abs().amax(dim=(1, 2))
    limit = torch.where(determined, torch.full_like(moved, PER_MEMBER_DU),
                        PER_MEMBER_DU + SPREAD * moved)
    same = bool(torch.equal(per.converged, cold.converged))
    worst = torch.argsort(d, descending=True)[:5].tolist()
    log(f"  per-member vs shared: converged masks equal: {same}; "
        f"{int(determined.sum())}/{B} members fixed by f32 (the shared "
        f"answer moves by <= {DETERMINED} under ±{PERTURB} on the start, "
        f"with the same iterations), max |du| {float(d[determined].max()):.3e}"
        f" on them (limit {PER_MEMBER_DU}); the five largest |du|: "
        + ", ".join(f"member {i} {float(d[i]):.3e} (moved "
                    f"{float(moved[i]):.3e}, iterations {int(per.iterations[i])}"
                    f"/{int(cold.iterations[i])}, restorations "
                    f"{int(per.restorations[i])}/{int(cold.restorations[i])})"
                    for i in worst))
    if not (same and bool((d <= limit).all())
            and int(determined.sum()) >= B // 2):
        raise RuntimeError("per-member params do not give the shared "
                           "solve's plans")
    return params, x0s, n["fused_staged"], cold, (carry, res, xs)


def phase_quadrotor(nempc, rk, rg, card, pair_ms):
    from pyneuralempc_tpu_torch.examples.quadrotor import (make_quadrotor_mpc,
                                                           quad_x0s)

    mpc = make_quadrotor_mpc("cuda", H=QH)
    log(f"quadrotor: kkt backend {mpc.kkt_backend}; sweep plan: "
        f"{rk.kernel_plan(QH, QNX, QNU, 'cuda')}")
    x0s = quad_x0s(np.random.default_rng(0), B)
    xs = torch.as_tensor(x0s, device="cuda")

    reset_counters(rk, rg)
    t0 = time.perf_counter()
    carry, res = mpc.next_batch(xs)
    torch.cuda.synchronize()
    log(f"quadrotor cold B={B}, H={QH}: {time.perf_counter() - t0:.2f} s  "
        + telemetry("cold", res))
    conv = [int(res.converged.sum())]
    check_plan(res, QH, QNX, QNU)
    p_start = float(torch.linalg.norm(xs[:, :3], dim=1).mean())
    p_end = float(torch.linalg.norm(res.x[:, -1, :3], dim=1).mean())
    log(f"mean |position|: start {p_start:.3f} -> end of the cold plan "
        f"{p_end:.3f} (limit 0.7 x start)")
    if not p_end < 0.7 * p_start:
        raise RuntimeError("quadrotor plans do not approach hover")

    t0 = time.perf_counter()
    xs = res.x[:, 0].contiguous()
    carry, res = mpc.next_batch(xs, carry=carry)
    torch.cuda.synchronize()
    conv.append(int(res.converged.sum()))
    log(f"warm (untimed): {(time.perf_counter() - t0) * 1e3:.1f} ms  "
        + telemetry("warm", res))
    times, launches = [], []
    for step in range(Q_WARM_STEPS):
        xs = res.x[:, 0].contiguous()
        n0 = rk.BACKWARD_LAUNCHES
        t0 = time.perf_counter()
        carry, res = mpc.next_batch(xs, carry=carry)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        conv.append(int(res.converged.sum()))
        launches.append(rk.BACKWARD_LAUNCHES - n0)
        log(f"warm {step}: {times[-1] * 1e3:.1f} ms  sweeps "
            f"{launches[-1]}  " + telemetry("warm", res))
    n = only_instance_pair(rk, rg, "quadrotor")
    if min(conv) < MIN_WARM_CONVERGED:
        raise RuntimeError(f"quadrotor convergence {conv} (cold, warm...) "
                           f"below {MIN_WARM_CONVERGED}/{B}")
    check_plan(res, QH, QNX, QNU)
    log(f"converged: cold, then every warm step {conv}")
    report_split(nempc, mpc, carry, xs, res, times, launches[-1], pair_ms,
                 card)
    return x0s, n["backward_instance"], n["forward_instance"]


def check_fleet_eq(tag, res, budget, yaw_residual):
    """EQ residual and budget over the converged plans; the share of them
    on which the budget binds."""
    conv = res.converged
    yaw = float(yaw_residual(res.u)[conv].max())
    total = res.u.sum(dim=(1, 2))[conv]
    binding = float((total > budget - BUDGET_SLACK).float().mean())
    log(f"  {tag}: max |u0-u1+u2-u3| {yaw:.3e} (limit {EQ_RESIDUAL}), "
        f"thrust impulse max {float(total.max()):.4f} (budget {budget:.4f}),"
        f" binding on {binding:.2%} of converged plans")
    if not yaw <= EQ_RESIDUAL:
        raise RuntimeError(f"{tag}: yaw-trim row violated by {yaw:.3e}")
    if not bool((total <= budget + BUDGET_SLACK).all()):
        raise RuntimeError(f"{tag}: thrust budget exceeded")
    return binding


def phase_fleet_eq(nempc, rk, rg, card, pair_ms):
    from pyneuralempc_tpu_torch.examples.fleet_eq import (BUDGET,
                                                          make_fleet_eq_mpc,
                                                          yaw_residual)
    from pyneuralempc_tpu_torch.examples.quadrotor import quad_x0s

    mpc = make_fleet_eq_mpc("cuda", border=True, H=QH)
    log(f"EQ/border quadrotor: kkt backend {mpc.kkt_backend}; sweep plan: "
        f"{rk.kernel_plan(QH, QNX, QNU, 'cuda', R=QR, r=QEQ)}")
    x0s = quad_x0s(np.random.default_rng(0), B)
    xs = torch.as_tensor(x0s, device="cuda")

    reset_counters(rk, rg)
    t0 = time.perf_counter()
    carry, res = mpc.next_batch(xs)
    torch.cuda.synchronize()
    log(f"EQ/border quadrotor cold B={B}, H={QH}: "
        f"{time.perf_counter() - t0:.2f} s  " + telemetry("cold", res))
    conv = [int(res.converged.sum())]
    check_plan(res, QH, QNX, QNU)
    binding = [check_fleet_eq("cold", res, BUDGET, yaw_residual)]

    t0 = time.perf_counter()
    xs = res.x[:, 0].contiguous()
    carry, res = mpc.next_batch(xs, carry=carry)
    torch.cuda.synchronize()
    conv.append(int(res.converged.sum()))
    log(f"warm (untimed): {(time.perf_counter() - t0) * 1e3:.1f} ms  "
        + telemetry("warm", res))
    binding.append(check_fleet_eq("warm", res, BUDGET, yaw_residual))
    times, launches = [], []
    for step in range(Q_WARM_STEPS):
        xs = res.x[:, 0].contiguous()
        n0 = rg.BACKWARD_LAUNCHES
        t0 = time.perf_counter()
        carry, res = mpc.next_batch(xs, carry=carry)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        conv.append(int(res.converged.sum()))
        launches.append(rg.BACKWARD_LAUNCHES - n0)
        log(f"warm {step}: {times[-1] * 1e3:.1f} ms  sweeps "
            f"{launches[-1]}  " + telemetry("warm", res))
        binding.append(check_fleet_eq(f"warm {step}", res, BUDGET,
                                      yaw_residual))
    n = counters(rk, rg)
    log(f"EQ/border path: general backward launches "
        f"{n['general_backward']} (the compile-time instance "
        f"{n['general_backward_instance']}), forward "
        f"{n['general_forward']} (the compile-time instance "
        f"{n['general_forward_instance']}); fused "
        f"{n['fused']}, streamed backward {n['backward']} / forward "
        f"{n['forward']}, plain calls {n['plain']}")
    if (not only_launched(n, "general_backward", "general_backward_instance",
                          "general_forward", "general_forward_instance")
            or n["general_forward"] != n["general_backward"]
            or n["general_backward_instance"] != n["general_backward"]
            or n["general_forward_instance"] != n["general_forward"]):
        raise RuntimeError("the EQ/border path did not go through the "
                           "general pair alone, with both kernels' "
                           "compile-time instances")
    if min(conv) < MIN_WARM_CONVERGED:
        raise RuntimeError(f"EQ/border convergence {conv} (cold, warm...) "
                           f"below {MIN_WARM_CONVERGED}/{B}")
    check_plan(res, QH, QNX, QNU)
    log(f"converged: cold, then every warm step {conv}; budget binding "
        f"share (cold, warm...) {[round(b, 4) for b in binding]}")
    report_split(nempc, mpc, carry, xs, res, times, launches[-1], pair_ms,
                 card)
    return x0s, n["general_backward_instance"], n["general_forward_instance"]


def check_floor(tag, res, u_floor):
    """The floor on every converged plan; the share of them on which it
    binds."""
    conv = res.converged
    total = res.u.sum(dim=(1, 2))[conv]
    binding = float(((total - u_floor).abs() <= BUDGET_SLACK).float().mean())
    log(f"  {tag}: Σu min {float(total.min()):.6f} (floor {u_floor}), "
        f"binding on {binding:.2%} of converged plans")
    if not bool((total >= u_floor - BUDGET_SLACK).all()):
        raise RuntimeError(f"{tag}: feed floor violated")
    return binding


def lv_plant(nempc):
    """The true ODE as a single-state plant step (api/simulate.py)."""
    from pyneuralempc_tpu_torch.api.simulate import plant_from_model
    return plant_from_model(nempc.torch_dynamics(f_true, 2, 1), "rk4", DT)


# ---- the CPU halves of the LV fleet's card-vs-CPU checks, in workers ----

_POOL = []


def cpu_pool():
    """Worker processes (spawned: they share nothing with the card's
    process) that solve the CPU halves of the card-vs-CPU checks while the
    card solves its own."""
    if not _POOL:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor
        _POOL.append(ProcessPoolExecutor(
            CPU_WORKERS, mp_context=multiprocessing.get_context("spawn"),
            initializer=torch.set_num_threads,
            initargs=(CPU_WORKER_THREADS,)))
    return _POOL[0]


def lv_solve(kind, device, starts, params, **options):
    """One of the LV fleet's solves of a card-vs-CPU check on ``device``:
    phase 4's controller with IPConfig ``options`` ("lv"), with bf16
    matmuls ("bf16"), under ALMConfig() ("alm"), with the move-suppression cost ("moves"), the
    budgeted fleet's cold solve ("budget") or its closed loop, 4 steps
    ("budget_loop"); ``starts`` numpy, ``params`` the surrogate's.  A
    closed loop's trajectory comes back on the CPU."""
    import pyneuralempc_tpu_torch as nempc
    params = [{k: v.to(device) for k, v in layer.items()}
              for layer in params]
    xs = torch.as_tensor(starts, device=device)
    if kind in ("budget", "budget_loop"):
        from pyneuralempc_tpu_torch.api.simulate import closed_loop_batch
        from pyneuralempc_tpu_torch.examples.lotka_volterra import (
            make_budget_mpc)
        mpc = make_budget_mpc(nempc.MLPDynamics.make(
            x_dim=2, u_dim=1, hidden=[32, 32]), device, H=H, DT=DT)
        if kind == "budget_loop":
            out = closed_loop_batch(mpc, lv_plant(nempc), xs, steps=4,
                                    replan_every=CL_REPLAN, params=params)
            return out._replace(x=out.x.cpu(), converged=out.converged.cpu(),
                                iterations=out.iterations.cpu())
    elif kind == "bf16":
        mpc = make_controller(nempc, device, model=nempc.MLPDynamics.make(
            x_dim=2, u_dim=1, hidden=[32, 32], compute_dtype=torch.bfloat16))
    elif kind == "alm":
        mpc = make_controller(nempc, device, config=nempc.ALMConfig())
        if mpc.kkt_backend != "alm":
            raise RuntimeError(f"ALM: kkt backend {mpc.kkt_backend}")
    else:
        mpc = make_controller(nempc, device, cost=move_cost if
                              kind == "moves" else None, **options)
    return mpc.next_batch(xs, params=params)[1]


def lv_runs(kind, starts, params, **options):
    """``run(device, eps)`` for the card-vs-CPU helpers: :func:`lv_solve`
    from ``starts[eps]`` (eps -> numpy starts), the card's in this process,
    the CPU's submitted to the workers now."""
    on_cpu = [{k: v.cpu() for k, v in layer.items()} for layer in params]
    cpu = {eps: cpu_pool().submit(lv_solve, kind, "cpu", xs, on_cpu,
                                  **options) for eps, xs in starts.items()}

    def run(device, eps):
        if device == "cpu":
            return cpu[eps].result()
        return lv_solve(kind, device, starts[eps], params, **options)
    return run


def moved_starts(xs):
    """The starts and the starts moved by ±PERTURB (eps -> numpy)."""
    return {eps: xs + np.float32(eps) for eps in (0.0, PERTURB, -PERTURB)}


def phase_budget(nempc, rk, rg, card, params, x0s, fused_ms):
    from pyneuralempc_tpu_torch.api.simulate import closed_loop_batch
    from pyneuralempc_tpu_torch.examples.lotka_volterra import (
        U_FLOOR, make_budget_mpc)
    from pyneuralempc_tpu_torch.ops.integrators import step_fn

    surrogate = nempc.MLPDynamics.make(x_dim=2, u_dim=1, hidden=[32, 32])
    mpc = make_budget_mpc(surrogate, "cuda", H=H, DT=DT)
    plan = rk.kernel_plan(H, 2, 1, "cuda", R=LR, r=LEQ)
    log(f"budgeted LV: kkt backend {mpc.kkt_backend}; sweep plan: {plan}")
    if plan["path"] != "cuda_fused_general":
        raise RuntimeError("the budgeted LV path does not plan the fused "
                           "general kernel")
    plant = step_fn(nempc.torch_dynamics(f_true, 2, 1), "rk4", DT)

    reset_counters(rk, rg)
    t0 = time.perf_counter()
    xs = torch.as_tensor(x0s, device="cuda")
    carry, res = mpc.next_batch(xs, params=params)
    torch.cuda.synchronize()
    log(f"budgeted LV cold B={B}: {time.perf_counter() - t0:.2f} s  "
        + telemetry("cold", res))
    conv = [int(res.converged.sum())]
    check_plan(res, H, 2, 1)
    binding = check_floor("cold", res, U_FLOOR)
    lo, hi = BINDING_SHARE
    if not lo <= binding <= hi:
        raise RuntimeError(f"the floor binds on {binding:.2%} of the cold "
                           f"plans, outside [{lo:.0%}, {hi:.0%}]")
    times, launches = [], []
    for step in range(WARM_STEPS):
        xs = plant(xs, res.u[:, 0])
        torch.cuda.synchronize()
        n0 = rg.FUSED_LAUNCHES
        t0 = time.perf_counter()
        carry, res = mpc.next_batch(xs, params=params, carry=carry)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        conv.append(int(res.converged.sum()))
        launches.append(rg.FUSED_LAUNCHES - n0)
        log(f"warm {step}: {times[-1] * 1e3:.1f} ms  sweeps "
            f"{launches[-1]}  " + telemetry("warm", res))
        check_floor(f"warm {step}", res, U_FLOOR)
    n = counters(rk, rg)
    log(f"budgeted LV path: fused general launches {n['fused_general']} "
        f"(staged {n['fused_general_staged']}, direct "
        f"{n['fused_general_direct']}); fused {n['fused']}, streamed "
        f"{n['backward']} / {n['forward']}, general pair "
        f"{n['general_backward']} / {n['general_forward']}, plain calls "
        f"{n['plain']}")
    if (not only_launched(n, "fused_general", "fused_general_staged")
            or n["fused_general_staged"] != n["fused_general"]):
        raise RuntimeError("the budgeted LV path did not go through the "
                           "staged fused general kernel alone")
    if min(conv) < MIN_WARM_CONVERGED:
        raise RuntimeError(f"budgeted LV convergence {conv} (cold, warm...) "
                           f"below {MIN_WARM_CONVERGED}/{B}")
    check_plan(res, H, 2, 1)
    log(f"converged: cold, then every warm step {conv}")
    report_split(nempc, mpc, carry, xs, res, times, launches[-1], fused_ms,
                 card, params=params)

    # the closed loop: a cold solve and CL_STEPS // CL_REPLAN warm re-plans
    reset_counters(rk, rg)
    t0 = time.perf_counter()
    out = closed_loop_batch(mpc, lv_plant(nempc),
                            torch.as_tensor(x0s, device="cuda"),
                            steps=CL_STEPS, replan_every=CL_REPLAN,
                            params=params)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n_cl = counters(rk, rg)
    n_solves = out.converged.shape[0]
    conv_cl = out.converged.sum(dim=1).tolist()
    lb, ub = mpc.nlp.spec.box.tile(1, device="cuda")
    viol = torch.clamp(torch.maximum(lb[:2] - out.x[1:], out.x[1:] - ub[:2]),
                       min=0.0)
    feed = (1.1 * 50.0 * DT * out.u.sum(dim=(0, 2))).mean()
    log(f"closed loop ({CL_STEPS} steps, re-plan every {CL_REPLAN}): "
        f"{n_solves} solves x {B} plants in {dt:.2f} s -> "
        f"{n_solves * B / dt:,.0f} solves/s; converged per solve {conv_cl}; "
        f"max state-box violation on the true plant {float(viol.max()):.3e};"
        f" mean feed cost {float(feed):.4f} (raw units, 1.1 a unit fed); "
        f"fused general launches {n_cl['fused_general']} (staged "
        f"{n_cl['fused_general_staged']}, direct "
        f"{n_cl['fused_general_direct']})")
    if (not only_launched(n_cl, "fused_general", "fused_general_staged")
            or n_cl["fused_general_staged"] != n_cl["fused_general"]):
        raise RuntimeError("the closed loop did not go through the staged "
                           "fused general kernel alone")
    if min(conv_cl) < MIN_WARM_CONVERGED:
        raise RuntimeError(f"closed-loop convergence {conv_cl} below "
                           f"{MIN_WARM_CONVERGED}/{B}")
    if not bool(torch.isfinite(out.x).all()):
        raise RuntimeError("non-finite closed-loop trajectory")
    return n["fused_general_staged"], n_cl["fused_general_staged"]


# ---- phases 4e, 4f, 4g: the GRU fleet, cartpole, the quadrotor MLP ----

def warm_replans(mpc, res, carry, steps, counter, params=None):
    """One untimed and ``steps`` timed warm re-plans, each from the plan's
    first state.  Returns (carry, res, per-solve converged counts, times,
    the sweeps ``counter()`` saw in each timed step)."""
    t0 = time.perf_counter()
    carry, res = mpc.next_batch(res.x[:, 0].contiguous(), params=params,
                                carry=carry)
    torch.cuda.synchronize()
    conv = [int(res.converged.sum())]
    log(f"warm (untimed): {(time.perf_counter() - t0) * 1e3:.1f} ms  "
        + telemetry("warm", res))
    times, launches = [], []
    for step in range(steps):
        xs = res.x[:, 0].contiguous()
        n0 = counter()
        t0 = time.perf_counter()
        carry, res = mpc.next_batch(xs, params=params, carry=carry)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        conv.append(int(res.converged.sum()))
        launches.append(counter() - n0)
        log(f"warm {step}: {times[-1] * 1e3:.1f} ms  sweeps "
            f"{launches[-1]}  " + telemetry("warm", res))
    return carry, res, conv, times, launches


def only_instance_pair(rk, rg, tag):
    """The path's launches: the streamed pair alone, every backward and
    every forward launch through its compile-time instance (the run-time
    kernels never)."""
    n = counters(rk, rg)
    log(f"{tag} path: streamed backward launches {n['backward']} (the "
        f"compile-time instance {n['backward_instance']}), forward "
        f"{n['forward']} (the instance {n['forward_instance']}); run-time "
        f"{n['backward_runtime']} / {n['forward_runtime']}; fused "
        f"{n['fused']}, general {n['general_backward']} / "
        f"{n['general_forward']}, fused general {n['fused_general']}, plain "
        f"calls {n['plain']}")
    if (not only_launched(n, "backward", "backward_instance", "forward",
                          "forward_instance")
            or not n["backward_instance"] == n["backward"] == n["forward"]
            == n["forward_instance"]):
        raise RuntimeError(f"the {tag} path did not go through the streamed "
                           "pair alone, with both compile-time instances")
    return n


def phase_fleet_rnn(nempc, rk, rg, card, pair_ms):
    """The GRU fleet (examples/fleet_rnn.py at its full size): the GRU fit,
    a cold solve at B=16384, H=100, one untimed and RNN_WARM_STEPS timed
    warm re-plans."""
    from pyneuralempc_tpu_torch.examples import fleet_rnn

    t0 = time.perf_counter()
    gd, params, mse = fleet_rnn.fit_fleet_gru("cuda")
    torch.cuda.synchronize()
    log(f"GRU fitted on the card: teacher-forced mse {mse:.2e} "
        f"({time.perf_counter() - t0:.1f} s, {fleet_rnn.FIT_STEPS} Adam "
        f"steps on {fleet_rnn.N_SEQS} x {fleet_rnn.SEQ_LEN} sequences, one "
        "step a CUDA graph replay)")
    mpc = fleet_rnn.make_fleet_rnn_mpc(gd, "cuda", H=RNN_H)
    nx = gd.model.dims.x
    log(f"GRU fleet: kkt backend {mpc.kkt_backend}; lifted state {nx}; "
        f"sweep plan: {rk.kernel_plan(RNN_H, nx, 1, 'cuda')}")
    z0s = fleet_rnn.fleet_starts(gd, RNN_B)

    reset_counters(rk, rg)
    t0 = time.perf_counter()
    carry, res = mpc.next_batch(z0s, params=params)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    log(f"GRU fleet cold B={RNN_B}, H={RNN_H}: {cold_s:.2f} s  "
        + telemetry("cold", res))
    conv = [int(res.converged.sum())]
    check_plan(res, RNN_H, nx, 1, Bn=RNN_B)
    carry, res, warm_conv, times, launches = warm_replans(
        mpc, res, carry, RNN_WARM_STEPS, lambda: rk.BACKWARD_LAUNCHES,
        params)
    conv += warm_conv
    n = only_instance_pair(rk, rg, "GRU fleet")
    if min(conv) < RNN_MIN_CONVERGED:
        raise RuntimeError(f"GRU fleet convergence {conv} (cold, warm...) "
                           f"below {RNN_MIN_CONVERGED}/{RNN_B}")
    check_plan(res, RNN_H, nx, 1, Bn=RNN_B)
    log(f"converged: cold, then every warm step {conv} (the JAX package's "
        "TPU record, fleet_rnn_tpu.log: 16384/16384)")
    split = report_split(nempc, mpc, carry, res.x[:, 0].contiguous(), res,
                         times, launches[-1], pair_ms, card, params=params)
    split.update(cold_s=cold_s, converged=conv)
    return gd, params, z0s, n["backward"], n["forward"], split


def phase_cartpole(nempc, rk, rg, card):
    """The cartpole swing-up (examples/cartpole.py): CP_STEPS plant steps
    with the true dynamics, a re-plan every 2 by NMPC.next on the card;
    then one next_multi_start of CP_STARTS starts from the hanging start."""
    from pyneuralempc_tpu_torch.examples import cartpole

    mpc = cartpole.make_cartpole_mpc("cuda")
    plan = rk.kernel_plan(CP_H, CP_NX, 1, "cuda")
    log(f"cartpole: kkt backend {mpc.kkt_backend}; sweep plan: {plan}")
    reset_counters(rk, rg)
    t0 = time.perf_counter()
    traj, us, conv, lat = cartpole.swing_up(mpc, CP_STEPS, device="cuda")
    loop_s = time.perf_counter() - t0
    loop_pairs = (rk.BACKWARD_LAUNCHES, rk.FORWARD_LAUNCHES)
    cos_final = float(np.cos(traj[-1, 2]))
    tip = float(np.abs(traj[:, 0] + cartpole.L * np.sin(traj[:, 2])).max())
    force = float(np.abs(us).max())
    box = np.asarray(cartpole.STATE_BOX, np.float32)
    viol = float(np.maximum(traj - box[:, 1], box[:, 0] - traj).max())
    warm = np.asarray(lat[2:])
    log(f"cartpole swing-up ({CP_STEPS} steps, a re-plan every "
        f"{cartpole.REPLAN_EVERY}): {loop_s:.1f} s; solves converged "
        f"{sum(conv)}/{len(conv)} (the JAX package's TPU record, "
        f"cartpole_tpu.log: {CP_JAX_CONVERGED}); final cos(theta) "
        f"{cos_final:.5f} (limit {CP_MIN_COS}); tip clearance max {tip:.6f} "
        f"(limit {cartpole.TIP_MAX} + {CP_TIP_SLACK}); |force| max "
        f"{force:.6f} (limit {cartpole.F_MAX} + {CP_FORCE_SLACK}); state-box "
        f"overshoot {viol:.3e} (limit {CP_BOX_SLACK}); re-plan latency "
        f"(the first two left out, as the JAX example does) p50 "
        f"{np.median(warm) * 1e3:.1f} ms, min {warm.min() * 1e3:.1f} ms; "
        f"every re-plan (ms): {[round(t * 1e3, 1) for t in lat]}")
    if not (cos_final >= CP_MIN_COS and tip <= cartpole.TIP_MAX
            + CP_TIP_SLACK and force <= cartpole.F_MAX + CP_FORCE_SLACK
            and viol <= CP_BOX_SLACK and np.isfinite(traj).all()):
        raise RuntimeError("the cartpole swing-up missed a gate")
    # the device's share of one more warm re-plan, from the loop's end
    from torch.profiler import ProfilerActivity, profile
    x_end = torch.as_tensor(traj[-1], device="cuda")
    mpc.next(x_end)
    torch.cuda.synchronize()
    traced0 = (rk.BACKWARD_LAUNCHES, rk.FORWARD_LAUNCHES)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        res = mpc.next(x_end)
        torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = sum(e.time_range.elapsed_us() for e in dev) / 1e3
    traced = (rk.BACKWARD_LAUNCHES - traced0[0],
              rk.FORWARD_LAUNCHES - traced0[1])
    # the path's own sweep kernels in that trace (the profiler keeps only
    # some events: a median a launch, times the launches counted)
    sweep_us = {}
    for half, kname in (("backward", rk.backward_kernel(CP_NX, 1)),
                        ("forward", rk.forward_kernel(CP_NX, 1))):
        want = kname.replace(" ", "")
        ts = [e.time_range.elapsed_us() for e in dev
              if want in e.name.replace(" ", "")]
        sweep_us[half] = statistics.median(ts) if ts else None
        log(f"  traced re-plan, {half} instance {kname}: {len(ts)} of "
            f"{traced[half == 'forward']} launches kept by the profiler, "
            + (f"median {sweep_us[half]:.2f} us" if ts else "none kept"))
    log(f"[{card}] one more warm cartpole re-plan ({int(res.iterations)} "
        f"iterations, traced): {step_ms:.1f} ms, {len(dev)} device events, "
        f"{dev_ms:.1f} ms of device time -> device busy "
        f"{dev_ms / step_ms:.1%}")
    ms0 = (rk.BACKWARD_LAUNCHES, rk.FORWARD_LAUNCHES)

    t0 = time.perf_counter()
    best, idx = mpc.next_multi_start(
        torch.tensor(cartpole.X_HANGING, device="cuda"), n_starts=CP_STARTS,
        generator=torch.Generator().manual_seed(0), return_index=True)
    torch.cuda.synchronize()
    ms_s = time.perf_counter() - t0
    log(f"cartpole next_multi_start ({CP_STARTS} starts from the hanging "
        f"start, seed 0): {ms_s:.1f} s; winner {idx}, converged "
        f"{bool(best.converged)}, objective {float(best.objective):.4f}, "
        f"kkt error {float(best.kkt_error):.3e}, iterations "
        f"{int(best.iterations)}")
    if not bool(torch.isfinite(best.u).all()):
        raise RuntimeError("non-finite multi-start plan")
    multi = (rk.BACKWARD_LAUNCHES - ms0[0], rk.FORWARD_LAUNCHES - ms0[1])
    log(f"cartpole streamed launches (backward, forward): swing-up "
        f"{loop_pairs} at B=1; the traced re-plan and its warm-up "
        f"{(ms0[0] - loop_pairs[0], ms0[1] - loop_pairs[1])} at B=1; the "
        f"multi-start {multi} at B={CP_STARTS}")
    n = only_instance_pair(rk, rg, "cartpole (swing-up, the traced re-plan "
                           "and the multi-start)")
    return n["backward"], n["forward"], {
        "loop_s": loop_s, "converged": f"{sum(conv)}/{len(conv)}",
        "cos_final": cos_final, "tip_max": tip,
        "traced_replan_ms": step_ms, "traced_device_ms": dev_ms,
        "traced_iterations": int(res.iterations),
        "traced_sweep_us": sweep_us, "traced_launches": traced,
        "loop_launches": loop_pairs, "multi_start_launches": multi,
        "p50_ms": float(np.median(warm) * 1e3),
        "min_ms": float(warm.min() * 1e3), "multi_start_s": ms_s,
        "multi_start_index": idx}


def tanh_kernel_entries(td):
    """K1 and K2 (csrc/tanh_dense.cu) at TANH_SHAPES: one launch a call,
    each output held against the plain version in float64 on the same
    inputs, then timed as kernel_entry times; an entry a kernel for the
    kernels line (launches still 0), its second shape's numbers under
    ``other_shape``."""
    g = torch.Generator(device="cuda").manual_seed(0)

    def rand(*shape):
        return torch.randn(*shape, device="cuda", generator=g)
    P, T = TANH_P, TANH_T
    M = P * T
    entries = []
    for name, shapes in TANH_SHAPES.items():
        fwd = name == "tanh_tangent_fwd"
        cuda_fn = td.tangent_fwd_cuda if fwd else td.tangent_vjp_cuda
        plain_fn = td.tangent_fwd_plain if fwd else td.tangent_vjp_plain
        rows = []
        for K, N in shapes:
            y, W = torch.tanh(rand(P, N)), rand(K, N) / K ** 0.5
            if fwd:
                args = (rand(P, T, K), y, W)
                nbytes = 4 * (M * K + M * N + P * N + K * N)
                flops = 2 * M * K * N + 3 * M * N
            else:
                args = (rand(P, T, N), rand(P, T, N), rand(P, N), y, W)
                nbytes = 4 * (2 * M * N + M * K + 2 * P * N + K * N)
                flops = 2 * M * K * N + 7 * M * N
            n0 = (td.K1_LAUNCHES, td.K2_LAUNCHES)
            out = cuda_fn(*args)
            torch.cuda.synchronize()
            if (td.K1_LAUNCHES - n0[0], td.K2_LAUNCHES - n0[1]) != (
                    int(fwd), int(not fwd)):
                raise RuntimeError(f"{name} did not launch its kernel once")
            ref = plain_fn(*(a.double() for a in args))
            scale = max(1.0, float(ref.abs().max()))
            err = float((out.double() - ref).abs().max())
            del out, ref
            shape = f"P={P}, T={T}, K={K}, N={N}"
            log(f"{name} [{shape}] vs plain in float64: max |diff| "
                f"{err:.3e}, scaled {err / scale:.3e} (limit {TANH_TOL})")
            if not err <= TANH_TOL * scale:
                raise RuntimeError(f"{name} differs from its plain version "
                                   f"by {err:.3e} > {TANH_TOL} * {scale:.3g}")
            entry = kernel_entry(
                name, "tanh_dense.cu",
                "none: torch.func's tangent pass of tanh(h W + b) as ATen "
                "ops", lambda: cuda_fn(*args), "tanh_tangent_kernel",
                lambda: plain_fn(*args), nbytes, flops, shape, plain_runs=5,
                strict=True)
            entry.update(shape={"P": P, "T": T, "K": K, "N": N},
                         max_abs_err=err, max_scaled_err=err / scale)
            rows.append(entry)
            del args
            torch.cuda.empty_cache()
        entry, other = rows
        entry["other_shape"] = {k: other[k] for k in (
            "shape", "ms", "call_ms", "plain_ms", "bound_ms", "bound_by",
            "max_abs_err", "max_scaled_err")}
        entries.append(entry)
    return entries


def phase_quadrotor_mlp(nempc, rk, rg, card):
    """The quadrotor MLP fleet (examples/quadrotor.py --mlp): the
    normalised surrogate fit at the JAX example's settings, then B=1024,
    H=50: a cold solve, one untimed and QM_WARM_STEPS timed warm
    re-plans; then the tanh layers' tangent kernels at the benchmark
    cell's shapes (tanh_kernel_entries), their launches those of the
    fleet's re-plans."""
    from pyneuralempc_tpu_torch.examples import quadrotor

    t0 = time.perf_counter()
    model, params, rel_mse = quadrotor.fit_quad_mlp("cuda")
    torch.cuda.synchronize()
    log(f"quadrotor surrogate fitted on the card: normalized mse "
        f"{rel_mse:.2e} ({time.perf_counter() - t0:.1f} s, 15000 Adam steps "
        "of 8192 on 262144 transitions, one step a CUDA graph replay; the "
        "JAX package's TPU record, quadrotor_mlp_tpu.log: 3.36e-04)")
    from pyneuralempc_tpu_torch.ops.cuda import tanh_dense
    mpc = quadrotor.make_quadrotor_mpc("cuda", H=QH, model=model)
    x0s = quadrotor.quad_x0s(np.random.default_rng(0), QM_B, rates=True)
    xs = torch.as_tensor(x0s, device="cuda")
    reset_counters(rk, rg)
    tanh0 = (tanh_dense.K1_LAUNCHES, tanh_dense.K2_LAUNCHES)
    t0 = time.perf_counter()
    carry, res = mpc.next_batch(xs, params=params)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    log(f"quadrotor MLP cold B={QM_B}, H={QH}: {cold_s:.2f} s  "
        + telemetry("cold", res))
    conv = [int(res.converged.sum())]
    check_plan(res, QH, QNX, QNU, Bn=QM_B)
    p_start = float(torch.linalg.norm(xs[:, :3], dim=1).mean())
    p_end = float(torch.linalg.norm(res.x[:, -1, :3], dim=1).mean())
    log(f"mean |position|: start {p_start:.3f} -> end of the cold plan "
        f"{p_end:.3f} (limit 0.7 x start)")
    if not p_end < 0.7 * p_start:
        raise RuntimeError("quadrotor MLP plans do not approach hover")
    carry, res, warm_conv, times, launches = warm_replans(
        mpc, res, carry, QM_WARM_STEPS, lambda: rk.BACKWARD_LAUNCHES,
        params)
    conv += warm_conv
    n = only_instance_pair(rk, rg, "quadrotor MLP")
    tanh = (tanh_dense.K1_LAUNCHES - tanh0[0],
            tanh_dense.K2_LAUNCHES - tanh0[1])
    log(f"tanh layers' tangent kernels (csrc/tanh_dense.cu): K1 {tanh[0]}, "
        f"K2 {tanh[1]} launches over the cold and warm re-plans (none "
        "below models/mlp.py's FUSED_MIN_ELEMENTS tangent rows x width)")
    if min(conv) < QM_MIN_CONVERGED:
        raise RuntimeError(f"quadrotor MLP convergence {conv} (cold, "
                           f"warm...) below {QM_MIN_CONVERGED}/{QM_B}")
    check_plan(res, QH, QNX, QNU, Bn=QM_B)
    log(f"converged: cold, then every warm step {conv} (the JAX package's "
        "TPU record, quadrotor_mlp_tpu.log, other weights: 1008 cold, 1010 "
        "warm)")
    args = sweep_case("delta0", 0, Bn=QM_B, Hn=QH, nx=QNX, nu=QNU)
    pair_ms = cuda_median_ms(lambda: rk.riccati_sweep_streamed_cuda(*args))
    split = report_split(nempc, mpc, carry, res.x[:, 0].contiguous(), res,
                         times, launches[-1], pair_ms, card, params=params)
    split.update(cold_s=cold_s, converged=conv)
    del carry, res, mpc
    torch.cuda.empty_cache()
    tanh_entries = tanh_kernel_entries(tanh_dense)
    for entry, launched in zip(tanh_entries, tanh):
        entry["launches"] = launched
    return model, params, x0s, n["backward"], split, tanh_entries


# ---- phases 4h, 4i, 4j: the wide fleet, the solver options, an import ----

def phase_fleet_wide(nempc, rk, rg, card, pair_ms):
    """Phase 4h: the wide fleet (examples/fleet_wide.py at its full size,
    B=4096, H=50, (12, 10)): a cold solve, one untimed and W_WARM_STEPS
    timed warm re-plans, each from the plan's first state."""
    from pyneuralempc_tpu_torch.examples.fleet_wide import (
        make_fleet_wide_mpc, wide_x0s)

    mpc = make_fleet_wide_mpc("cuda", H=W_H)
    log(f"wide fleet: kkt backend {mpc.kkt_backend}; sweep plan: "
        f"{rk.kernel_plan(W_H, W_NX, W_NU, 'cuda')}")
    x0s = wide_x0s(np.random.default_rng(0), B)
    reset_counters(rk, rg)
    t0 = time.perf_counter()
    carry, res = mpc.next_batch(torch.as_tensor(x0s, device="cuda"))
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    it = res.iterations.float()
    log(f"wide fleet cold B={B}, H={W_H}: {cold_s:.2f} s  "
        + telemetry("cold", res) + "  (the JAX package's TPU record, "
        "tools/fleet_wide_tpu.log: 4096/4096, iterations max 30, mean "
        "9.22)")
    conv = [int(res.converged.sum())]
    cold_iters = (int(it.max()), float(it.mean()))
    check_plan(res, W_H, W_NX, W_NU)
    carry, res, warm_conv, times, launches = warm_replans(
        mpc, res, carry, W_WARM_STEPS, lambda: rk.BACKWARD_LAUNCHES)
    conv += warm_conv
    n = only_instance_pair(rk, rg, "wide fleet")
    if min(conv) < MIN_WARM_CONVERGED:
        raise RuntimeError(f"wide fleet convergence {conv} (cold, warm...) "
                           f"below {MIN_WARM_CONVERGED}/{B}")
    check_plan(res, W_H, W_NX, W_NU)
    it = res.iterations.float()
    log(f"converged: cold, then every warm step {conv}; last warm "
        f"iterations max {int(it.max())}, mean {float(it.mean()):.2f}")
    split = report_split(nempc, mpc, carry, res.x[:, 0].contiguous(), res,
                         times, launches[-1], pair_ms, card)
    split.update(cold_s=cold_s, converged=conv, cold_iterations=cold_iters)
    return x0s, n["backward"], n["forward_instance"], split


def same_solution_gate(tag, res, mono, min_same):
    """``res`` against phase 4's monotone cold plans, on the members both
    converged: at the same solution (objectives within SAME_SOLUTION,
    relative) the plans within CARD_VS_CPU_DU, and at least ``min_same``
    members there; the others (another local solution) are counted."""
    both = res.converged & mono.converged
    rel = ((res.objective - mono.objective).abs()
           / mono.objective.abs().clamp(min=1.0))
    same = both & (rel <= SAME_SOLUTION)
    other = both & ~same
    du = (res.u - mono.u).abs().amax(dim=(1, 2))
    du_same = float(du[same].max()) if bool(same.any()) else 0.0
    rel_other = float(rel[other].max()) if bool(other.any()) else 0.0
    lower = int((other & (res.objective < mono.objective)).sum())
    log(f"  {tag} vs monotone (phase 4's cold plans): both converged "
        f"{int(both.sum())}/{B}; at the same solution {int(same.sum())} "
        f"(at least {min_same}), max |du| {du_same:.3e} (limit "
        f"{CARD_VS_CPU_DU}); at another local solution {int(other.sum())}, "
        f"max |du| {float(du[other].max()) if bool(other.any()) else 0.0:.3e},"
        f" objectives up to {rel_other:.3e} apart, {lower} of them lower "
        "than monotone's")
    if not (du_same <= CARD_VS_CPU_DU and int(same.sum()) >= min_same):
        raise RuntimeError(f"{tag}: plans do not reach the monotone "
                           "solve's solutions")
    return {"same": int(same.sum()), "other": int(other.sum()),
            "du_same": du_same, "rel_other": rel_other,
            "other_lower": lower}


def phase_options(nempc, rk, rg, params, x0s, mono):
    """Phase 4i: mu_strategy "monotone" (phase 4's solve again, for a like
    protocol), "adaptive" and "mehrotra" on the LV fleet (phase 4's
    surrogate, B=4096): a cold solve and one untimed and OPT_WARM_STEPS
    timed warm re-plans each, through the staged fused kernel alone, the
    converged counts and plans against phase 4's monotone cold plans held
    to the JAX package's own on this fleet (MU_REFERENCE); the sweeps a
    lockstep iteration."""
    out = {}
    xs = torch.as_tensor(x0s, device="cuda")
    for strategy in ("monotone", "adaptive", "mehrotra"):
        mpc = make_controller(nempc, "cuda", mu_strategy=strategy)
        reset_counters(rk, rg)
        t0 = time.perf_counter()
        carry, res = mpc.next_batch(xs, params=params)
        torch.cuda.synchronize()
        cold_s, sweeps = time.perf_counter() - t0, rk.LAUNCHES
        per_it = sweeps / int(res.iterations.max())
        log(f"LV fleet, mu_strategy={strategy!r}, cold B={B}: {cold_s:.2f} s"
            f"  " + telemetry("cold", res) + f"  sweeps {sweeps}: "
            f"{per_it:.2f} a lockstep iteration")
        ref = MU_REFERENCE[strategy]
        slack = int(MU_SLACK * B)
        floor = {k: (MIN_WARM_CONVERGED if ref[k] >= MIN_WARM_CONVERGED
                     else ref[k] - slack) for k in ("cold", "warm")}
        conv = [int(res.converged.sum())]
        gate = same_solution_gate(f"mu_strategy={strategy!r}", res, mono,
                                  ref["same"] - slack)
        carry, res, warm_conv, times, launches = warm_replans(
            mpc, res, carry, OPT_WARM_STEPS, lambda: rk.LAUNCHES, params)
        conv += warm_conv
        n = counters(rk, rg)
        if (not only_launched(n, "fused", "fused_staged")
                or n["fused_staged"] != n["fused"]):
            raise RuntimeError(f"mu_strategy={strategy!r}: the LV path did "
                               "not go through the staged fused kernel "
                               "alone")
        log(f"  converged: cold, then every warm step {conv} (at least "
            f"{floor['cold']}, then {floor['warm']}; the JAX package on "
            f"the CPU: {ref['cold']}, then {ref['warm']})")
        if conv[0] < floor["cold"] or min(conv[1:]) < floor["warm"]:
            raise RuntimeError(f"mu_strategy={strategy!r}: convergence "
                               f"{conv} below {floor['cold']} / "
                               f"{floor['warm']} of {B}")
        check_plan(res, H, 2, 1)
        p50 = statistics.median(times)
        log(f"  warm p50 "
            f"{p50 * 1e3:.1f} ms ({B / p50:,.0f} solves/s), sweeps a warm "
            f"re-plan {launches}")
        out[strategy] = dict(gate, cold_s=cold_s, cold_sweeps=sweeps,
                             sweeps_per_iteration=per_it, converged=conv,
                             warm_p50_ms=p50 * 1e3, warm_sweeps=launches)
    return out


def phase_import(nempc, rk, rg, params, x0s, mono):
    """Phase 4j: phase 4's surrogate copied into an nn.Sequential(Linear,
    Tanh, ...) on the card, loaded back by load_torch_mlp (the tensors stay
    on the card; no h5py), and one cold solve at B=4096: its plans are
    phase 4's cold plans."""
    try:
        import h5py  # noqa: F401
        has_h5py = True
    except ImportError:
        has_h5py = False
    sizes = [params[0]["w"].shape[0]] + [p["w"].shape[1] for p in params]
    mods = []
    for i, (fi, fo) in enumerate(zip(sizes[:-1], sizes[1:])):
        mods.append(torch.nn.Linear(fi, fo))
        if i < len(params) - 1:
            mods.append(torch.nn.Tanh())
    net = torch.nn.Sequential(*mods).to("cuda")
    with torch.no_grad():
        for lin, layer in zip(net[::2], params):
            lin.weight.copy_(layer["w"].T)
            lin.bias.copy_(layer["b"])
    model, loaded = nempc.load_torch_mlp(net.state_dict(), x_dim=2, u_dim=1)
    if not all(t.device.type == "cuda" for layer in loaded
               for t in layer.values()):
        raise RuntimeError("load_torch_mlp moved the card's tensors")
    mpc = make_controller(nempc, "cuda", model=model)
    reset_counters(rk, rg)
    t0 = time.perf_counter()
    _, res = mpc.next_batch(torch.as_tensor(x0s, device="cuda"),
                            params=loaded)
    torch.cuda.synchronize()
    du = float((res.u - mono.u).abs().max())
    same = bool(torch.equal(res.converged, mono.converged))
    log(f"imported surrogate (nn.Sequential {sizes} -> load_torch_mlp, h5py "
        f"{'present' if has_h5py else 'absent'}), cold B={B}: "
        f"{time.perf_counter() - t0:.2f} s  " + telemetry("cold", res)
        + f"; against phase 4's cold plans: max |du| {du:.3e} (limit "
        f"{IMPORT_DU}), converged masks equal: {same}")
    n = counters(rk, rg)
    if not (du <= IMPORT_DU and same and n["fused_staged"] > 0):
        raise RuntimeError("the imported surrogate's plans are not phase "
                           "4's")
    return {"du": du, "h5py": has_h5py}


# ---- phases 4k-4n: the dense backend, ALM, the IFT backward, record ----

def no_kernel_launched(rk, rg, tag):
    """The dense backend's path: no sweep kernel and no plain sweep (its
    LU is one batched library call)."""
    n = counters(rk, rg)
    if any(n.values()):
        raise RuntimeError(f"{tag}: sweep kernels or plain sweeps ran on "
                           f"the dense path: {n}")


def dense_split(nempc, mpc, carry, xs, res, times, card, params):
    """The dense warm re-plan's time split (``prepare``, the Hessian and
    Jacobian of every member, and one ``solve_blocks``, the batched LU and
    its refinement, each timed alone at the last carry, times one a
    lockstep iteration); no traced re-plan, to keep the run inside its
    time (one held ~2e5 device events and took 35-52 s of it)."""
    from pyneuralempc_tpu_torch.solve.interior_point import (
        make_dense_direction)
    Bn = xs.shape[0]
    rt = nempc.runtime(xs, params=params)
    rt["_s_obj"] = torch.ones(Bn, device="cuda")
    direction = make_dense_direction(mpc.nlp, mpc.config)
    prep_ms = cuda_median_ms(
        lambda: direction.prepare(carry.w, carry.lam, rt), runs=3,
        warmup=1)
    blocks = direction.prepare(carry.w, carry.lam, rt)
    sig = torch.ones_like(carry.w)
    r = torch.zeros_like(carry.w)
    c = torch.zeros_like(carry.lam)
    lu_ms = cuda_median_ms(
        lambda: direction.solve_blocks(blocks, sig, r, c, retry=False),
        runs=5, warmup=1)
    n_it = int(res.iterations.max())
    step_ms = statistics.median(times) * 1e3
    log(f"[{card}] dense warm re-plan split (last step, estimated): prepare "
        f"{n_it * prep_ms:.1f} ms ({n_it} x {prep_ms:.2f} ms: Hessian and "
        f"Jacobian), LU {n_it * lu_ms:.1f} ms ({n_it} x {lu_ms:.3f} ms: one "
        f"batched LU of {Bn} x {mpc.nlp.n + mpc.nlp.m}^2 and its "
        f"refinement), rest {step_ms - n_it * (prep_ms + lu_ms):.1f} ms of "
        f"p50 {step_ms:.1f} ms")
    p50 = statistics.median(times)
    log(f"[{card}] dense warm re-plan B={Bn}: p50 {p50 * 1e3:.1f} ms, min "
        f"{min(times) * 1e3:.1f} ms -> {Bn / p50:,.0f} solves/s")
    return {"p50_ms": p50 * 1e3, "solves_per_s": Bn / p50,
            "prepare_ms": prep_ms, "lu_ms": lu_ms,
            "iterations": n_it, "busy": None}


def move_cost(x, u):
    """bench.py's cost plus move suppression MOVE·Σ(u_{t+1} − u_t)²: the
    stage coupling makes the objective probe non-separable."""
    return (1.1 * torch.sum(u) + REG * torch.sum(u * u)
            + MOVE * torch.sum((u[1:] - u[:-1]) ** 2))


def phase_dense(nempc, rk, rg, card, params, x0s, mono):
    """Phase 4k: the dense backend on phase 4's fleet (B=4096): under
    kkt="dense" (one cold solve and one timed warm re-plan), plans against phase 4's Riccati cold plans where the
    objectives agree; then phase 4's cost with move suppression under
    kkt="auto" (the dense backend), its warm re-plan's time split, and 16
    members against the CPU port.  The converged counts are held to the
    JAX package's on the same fleet."""
    out = {}
    xs = torch.as_tensor(x0s, device="cuda")
    for kind in ("dense", "moves"):
        mpc = (make_controller(nempc, "cuda", kkt="dense") if kind == "dense"
               else make_controller(nempc, "cuda", cost=move_cost))
        if mpc.kkt_backend != "dense":
            raise RuntimeError(f"{kind}: kkt backend {mpc.kkt_backend}")
        ref = DENSE_REFERENCE[kind]
        reset_counters(rk, rg)
        t0 = time.perf_counter()
        carry, res = mpc.next_batch(xs, params=params)
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        log(f"LV fleet, {kind} (kkt backend {mpc.kkt_backend}), cold B={B}: "
            f"{cold_s:.2f} s  " + telemetry("cold", res))
        check_plan(res, H, 2, 1)
        conv = [int(res.converged.sum())]
        gate = None
        if kind == "dense":
            gate = same_solution_gate("kkt='dense'", res, mono,
                                      ref["same"] - int(MU_SLACK * B))
        # one timed warm re-plan from the plans' first states
        t0 = time.perf_counter()
        carry, res = mpc.next_batch(res.x[:, 0].contiguous(), params=params,
                                    carry=carry)
        torch.cuda.synchronize()
        times = [time.perf_counter() - t0]
        conv.append(int(res.converged.sum()))
        log(f"warm: {times[0] * 1e3:.1f} ms  " + telemetry("warm", res))
        no_kernel_launched(rk, rg, kind)
        floor = {k: (MIN_WARM_CONVERGED if ref[k] >= MIN_WARM_CONVERGED
                     else ref[k] - int(MU_SLACK * B)) for k in ("cold",
                                                                "warm")}
        log(f"  converged: cold, then every warm step {conv} (at least "
            f"{floor['cold']}, then {floor['warm']}; the JAX package on "
            f"the CPU: {ref['cold']}, then {ref['warm']})")
        if conv[0] < floor["cold"] or min(conv[1:]) < floor["warm"]:
            raise RuntimeError(f"{kind}: convergence {conv} below "
                               f"{floor['cold']} / {floor['warm']} of {B}")
        p50 = statistics.median(times)
        log(f"[{card}] {kind} warm re-plan B={B}: p50 {p50 * 1e3:.1f} ms -> "
            f"{B / p50:,.0f} solves/s")
        out[kind] = {"p50_ms": p50 * 1e3, "cold_s": cold_s,
                     "converged": conv}
        if kind == "dense":
            out[kind]["same"] = gate
        else:
            # the time split, once
            out[kind].update(dense_split(nempc, mpc, carry,
                                         res.x[:, 0].contiguous(), res,
                                         times, card, params))

    moves = lv_runs("moves", {0.0: x0s[:N_CARD_VS_CPU]}, params)
    card_vs_cpu(f"LV with move suppression (dense), {N_CARD_VS_CPU} cold "
                "solves", lambda dev: moves(dev, 0.0))
    return out


def phase_alm(nempc, rk, rg, card, params, x0s, mono):
    """Phase 4l: ALMConfig() on phase 4's fleet at B=ALM_B, one cold solve:
    the converged count held to the JAX package's on the same members, the
    outer-iteration histogram, the plans against phase 4's interior-point
    plans where both converged and the objectives agree, and 16 members
    against the CPU port."""
    reset_counters(rk, rg)
    t0 = time.perf_counter()
    res = lv_solve("alm", "cuda", x0s[:ALM_B], params)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    no_kernel_launched(rk, rg, "ALM")
    hist = torch.bincount(res.iterations.long().cpu(),
                          minlength=nempc.ALMConfig().outer_iter + 1)
    conv = int(res.converged.sum())
    floor = ALM_REFERENCE["converged"] - int(MU_SLACK * ALM_B)
    log(f"ALM (ALMConfig()), cold B={ALM_B}: {secs:.2f} s, converged "
        f"{conv}/{ALM_B} (at least {floor}; the JAX package on the CPU: "
        f"{ALM_REFERENCE['converged']}), outer iterations histogram "
        f"{hist.tolist()}")
    check_plan(res, H, 2, 1, Bn=ALM_B)
    if conv < floor:
        raise RuntimeError(f"ALM: {conv}/{ALM_B} converged, below {floor}")
    ip = type(mono)(*[v[:ALM_B] if isinstance(v, torch.Tensor) else v
                      for v in mono])
    both = res.converged & ip.converged
    rel = ((res.objective - ip.objective).abs()
           / ip.objective.abs().clamp(min=1.0))
    du = (res.u - ip.u).abs().amax(dim=(1, 2))
    for t in (1e-6, 1e-5, 1e-4, 1e-3):
        near = both & (rel <= t)
        log(f"  ALM vs phase 4's interior-point plans, objectives within "
            f"{t:g} (relative): {int(near.sum())} of {int(both.sum())} both "
            f"converged, max |du| "
            f"{float(du[near].max()) if bool(near.any()) else 0.0:.3e}")
    same = both & (rel <= ALM_SAME_SOLUTION)
    du_same = float(du[same].max()) if bool(same.any()) else 0.0
    log(f"  gate: objectives within {ALM_SAME_SOLUTION} for at least "
        f"{ALM_REFERENCE['same'] - int(MU_SLACK * ALM_B)} members (the JAX "
        f"package: {ALM_REFERENCE['same']}), |du| there at most {ALM_DU}: "
        f"{int(same.sum())}, {du_same:.3e}")
    if not (du_same <= ALM_DU and int(same.sum())
            >= ALM_REFERENCE["same"] - int(MU_SLACK * ALM_B)):
        raise RuntimeError("ALM: plans do not reach the interior point's")
    # ALM's inner solves stop at 10x tol without a polish, so some plans
    # are fixed by f32 only loosely: held as the budgeted fleet's are
    def same_masks(card, cpu, determined):
        same = bool(torch.equal(card.converged.cpu(), cpu.converged))
        iters = bool(torch.equal(card.iterations.cpu()[determined],
                                 cpu.iterations[determined]))
        log(f"card vs CPU (ALM, {N_CARD_VS_CPU} cold solves): converged "
            f"masks equal: {same}, outer iterations equal on the fixed "
            f"members: {iters}")
        if not (same and iters):
            raise RuntimeError("ALM: card and CPU solves differ")

    # each of the CPU's three solves (the starts, moved by ±PERTURB) a
    # batch of its own, as the card's: ALM's looser plans move with the
    # batch's composition (48 stacked members put one fixed member 1e-3
    # off the card's 16)
    run = lv_runs("alm", moved_starts(x0s[:N_CARD_VS_CPU]), params)
    budget_card_vs_cpu("ALM, cold, |du|", run,
                       lambda a, b: (a.u.cpu() - b.u.cpu()).abs()
                       .amax(dim=(1, 2)), same_masks)
    return {"seconds": secs, "converged": conv, "same": int(same.sum()),
            "du_same": du_same, "outer_histogram": hist.tolist()}


def diff_loss(nempc, dev, params, x0s, kkt="auto"):
    """NMPC(differentiable=True) on phase 4's fleet at ``x0s``: the loss
    Σ U² + Σ objective and its gradients with respect to x0 and every
    params leaf (shared by the members), and the result."""
    mpc = make_controller(nempc, dev, kkt=kkt, differentiable=True)
    x0 = torch.tensor(np.asarray(x0s), device=dev, requires_grad=True)
    p = [{k: v.detach().to(dev).requires_grad_(True) for k, v in
          layer.items()} for layer in params]
    _, res = mpc.next_batch(x0, params=p)
    loss = (res.u ** 2).sum() + res.objective.sum()
    return mpc, x0, p, res, loss


def diff_grads(nempc, dev, params, x0s, kkt="auto"):
    """The differentiable solve's x0 gradient (per member), its params
    gradients (flattened leaves, summed over the members) and its
    converged mask, each moved to the CPU."""
    _, x0, p, res, loss = diff_loss(nempc, dev, params, x0s, kkt)
    loss.backward()
    return (x0.grad.cpu(), [t.grad.cpu() for layer in p
                            for t in layer.values()], res.converged.cpu())


def grads_card_vs_cpu(nempc, params, x0s, tag, kkt="auto"):
    """The differentiable solve's gradients on the card and on the CPU, the
    same members.  As for the plans, the CPU answer is also re-solved from
    starts moved by ±PERTURB: each member's x0 gradient is held to
    DIFF_CARD_VS_CPU of the largest entry plus SPREAD times its own move,
    and each params gradient to DIFF_CARD_VS_CPU plus SPREAD times its
    move, relative to its largest entry (some members' gradients are fixed
    by f32 only loosely: their plans sit on active bounds where Σ_μ is
    μ/slack² with μ = 1e-9)."""
    card = diff_grads(nempc, "cuda", params, x0s, kkt)
    cpu = diff_grads(nempc, "cpu", params, x0s, kkt)
    moved_x = torch.zeros(len(x0s))
    moved_p = [torch.zeros(()) for _ in cpu[1]]
    for eps in (PERTURB, -PERTURB):
        alt = diff_grads(nempc, "cpu", params, x0s + np.float32(eps), kkt)
        moved_x = torch.maximum(moved_x, (alt[0] - cpu[0]).abs().amax(-1))
        moved_p = [torch.maximum(m, (a - b).abs().max())
                   for m, a, b in zip(moved_p, alt[1], cpu[1])]
    scale_x = cpu[0].abs().max().clamp(min=1e-12)
    err_x = (card[0] - cpu[0]).abs().amax(-1) / scale_x
    lim_x = DIFF_CARD_VS_CPU + SPREAD * moved_x / scale_x
    err_p = [float((a - b).abs().max() / b.abs().max().clamp(min=1e-12))
             for a, b in zip(card[1], cpu[1])]
    lim_p = [DIFF_CARD_VS_CPU + SPREAD * float(m / b.abs().max().clamp(
        min=1e-12)) for m, b in zip(moved_p, cpu[1])]
    fixed = moved_x / scale_x <= DIFF_CARD_VS_CPU / 10
    same = bool(torch.equal(card[2], cpu[2]))
    log(f"card vs CPU ({tag}, {len(x0s)} members): x0 gradient up to "
        f"{float(err_x.max()):.3e} of its largest entry; "
        f"{int(fixed.sum())} members whose CPU gradient moves by <= "
        f"{DIFF_CARD_VS_CPU / 10} under ±{PERTURB} on the start, up to "
        f"{float(err_x[fixed].max()) if bool(fixed.any()) else 0.0:.3e} on "
        f"them (limit {DIFF_CARD_VS_CPU}); the others: "
        + ", ".join(f"member {i} {float(err_x[i]):.3e} (moved "
                    f"{float(moved_x[i] / scale_x):.3e})"
                    for i in torch.nonzero(~fixed).flatten().tolist())
        + f"; params gradients {[f'{e:.3e}' for e in err_p]} (limits "
        f"{[f'{v:.3e}' for v in lim_p]}); converged masks equal: {same}")
    if not (bool((err_x <= lim_x).all()) and same
            and all(e <= v for e, v in zip(err_p, lim_p))):
        raise RuntimeError(f"{tag}: card and CPU gradients differ")
    return {"x0": float(err_x.max()), "x0_fixed": float(
        err_x[fixed].max()) if bool(fixed.any()) else 0.0,
        "params": max(err_p), "fixed_members": int(fixed.sum())}


def phase_diff(nempc, rk, rg, card, params, x0s):
    """Phase 4m: NMPC(differentiable=True) on phase 4's fleet at B=4096:
    the loss Σ U² + Σ objective, gradients with respect to x0 and the MLP
    params.  The forward solve and the IFT backward go through the fused
    kernel (the backward's KKT solve is one more Riccati sweep) and never
    the plain sweep; card against CPU on 16 members; central differences
    of the loss for DIFF_N_FD members' x0; a dense-direction
    differentiable solve on DIFF_DENSE_B members against the CPU."""
    reset_counters(rk, rg)
    t0 = time.perf_counter()
    mpc, x0, p, res, loss = diff_loss(nempc, "cuda", params, x0s)
    torch.cuda.synchronize()
    fwd_s = time.perf_counter() - t0
    n_fwd = rk.LAUNCHES
    t0 = time.perf_counter()
    loss.backward()
    torch.cuda.synchronize()
    bwd_s = time.perf_counter() - t0
    n = counters(rk, rg)
    bwd_launches = n["fused"] - n_fwd
    log(f"differentiable LV fleet, B={B}: forward {fwd_s:.2f} s "
        f"({n_fwd} fused launches; " + telemetry("cold", res) + f"), "
        f"backward {bwd_s:.3f} s ({bwd_launches} fused launches, plain "
        f"calls {n['plain']}); gradients finite: "
        f"{bool(torch.isfinite(x0.grad).all())}")
    if not (only_launched(n, "fused", "fused_staged")
            and n["fused_staged"] == n["fused"] and bwd_launches > 0):
        raise RuntimeError("the differentiable path's backward did not go "
                           "through the fused kernel alone")
    if not all(bool(torch.isfinite(t.grad).all()) for t in
               [x0] + [t for layer in p for t in layer.values()]):
        raise RuntimeError("non-finite gradients")
    err = grads_card_vs_cpu(nempc, params, x0s[:N_CARD_VS_CPU], "IFT, "
                            "Riccati direction")
    # central differences, f32, each member's step scaled to its |x0|
    members = torch.nonzero(res.converged).flatten()[:DIFF_N_FD].tolist()
    base = torch.as_tensor(x0s[members], device="cuda")
    eps = DIFF_FD_EPS * base.abs().amax(-1, keepdim=True).clamp(min=1.0)

    def per_member_loss(xs):
        _, r = mpc.next_batch(xs, params=params)
        return ((r.u ** 2).sum(dim=(1, 2)) + r.objective).detach()

    fd = torch.zeros_like(base)
    for i in range(2):
        d = torch.zeros_like(base)
        d[:, i:i + 1] = eps
        fd[:, i] = ((per_member_loss(base + d) - per_member_loss(base - d))
                    / (2 * eps[:, 0]))
    g = x0.grad[members]
    ok = (g - fd).abs() <= DIFF_FD_ATOL + DIFF_FD_RTOL * fd.abs()
    log(f"  central differences (members {members}, eps {DIFF_FD_EPS} x "
        f"max(1, |x0|)): IFT {g.tolist()}, differences {fd.tolist()} "
        f"(within {DIFF_FD_RTOL:.0%} or {DIFF_FD_ATOL}: "
        f"{bool(ok.all())})")
    if not bool(ok.all()):
        raise RuntimeError("IFT gradients disagree with finite differences")
    t0 = time.perf_counter()
    _, x0d, _, res_d, loss_d = diff_loss(nempc, "cuda", params,
                                         x0s[:DIFF_DENSE_B], kkt="dense")
    loss_d.backward()
    torch.cuda.synchronize()
    log(f"differentiable LV fleet, dense direction, B={DIFF_DENSE_B}: "
        f"{time.perf_counter() - t0:.2f} s, " + telemetry("cold", res_d)
        + f", gradients finite: {bool(torch.isfinite(x0d.grad).all())}")
    if not bool(torch.isfinite(x0d.grad).all()):
        raise RuntimeError("dense direction: non-finite gradients")
    err_dense = grads_card_vs_cpu(nempc, params, x0s[:N_CARD_VS_CPU],
                                  "IFT, dense direction", kkt="dense")
    return {"forward_s": fwd_s, "backward_s": bwd_s,
            "forward_launches": n_fwd, "backward_launches": bwd_launches,
            "card_vs_cpu": err, "dense_card_vs_cpu": err_dense}


def phase_record(nempc, rk, rg, card, params, x0s):
    """Phase 4n: IPConfig(record=True) on phase 4's fleet, one cold solve at
    B=4096: the trace's shapes, ``done`` turning true at each member's own
    iteration count, the per-member iteration histogram; the budgeted
    fleet's warm re-plan under record (its lockstep tail); then
    utils.profiling.profile_solver's phases on the same fleet."""
    from pyneuralempc_tpu_torch.utils.profiling import profile_solver
    mpc = make_controller(nempc, "cuda", record=True)
    xs = torch.as_tensor(x0s, device="cuda")
    reset_counters(rk, rg)
    t0 = time.perf_counter()
    _, res = mpc.next_batch(xs, params=params)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    it = res.iterations.long()
    max_iter = mpc.config.max_iter
    tr = res.trace
    shapes = {k: tuple(v.shape) for k, v in tr.items()}
    rows = torch.arange(B, device="cuda")
    done = tr["done"]
    turns = (done[rows, (it - 1).clamp(min=0)]
             & ~done[rows, (it - 2).clamp(min=0)])
    at_own = bool((turns | (it < 2) | ~res.converged).all())
    never = bool((~done[~res.converged]).all())
    hist = torch.bincount(it.cpu(), minlength=max_iter + 1)
    log(f"record=True, cold B={B}: {secs:.2f} s ({rk.LAUNCHES} fused "
        f"launches)  " + telemetry("cold", res) + f"; trace {shapes}; done "
        f"turns true at each member's own iteration count: {at_own}, never "
        f"for the unconverged: {never}")
    log(f"  per-member iterations histogram (count at 0..{max_iter}): "
        f"{hist.tolist()}")
    if not (all(v == (B, max_iter) for v in shapes.values()) and at_own
            and never):
        raise RuntimeError("record=True: the trace is wrong")
    budget = budget_trace(nempc, params, xs)
    t0 = time.perf_counter()
    prof = profile_solver(make_controller(nempc, "cuda"), xs, params=params,
                          iters=PROFILE_ITERS)
    log(f"[{card}] profile_solver (B={B}, medians of {PROFILE_ITERS}, "
        f"{time.perf_counter() - t0:.1f} s): "
        + ", ".join(f"{k} {v * 1e3:.2f} ms" for k, v in prof.items()))
    return {"seconds": secs, "histogram": hist.tolist(),
            "budgeted_warm": budget,
            "profile_ms": {k: v * 1e3 for k, v in prof.items()}}


def budget_trace(nempc, params, xs):
    """The budgeted LV fleet (phase 4d's) under record=True: a cold solve
    and one warm re-plan from its plans' first states.  The warm re-plan's
    per-member iteration histogram, and for the members that take at least
    TAIL_ITERS iterations, when their KKT error first reaches 10x tol and
    when they are done (medians): the iterations a lockstep re-plan waits
    on them."""
    from pyneuralempc_tpu_torch.examples import lotka_volterra as lv
    cfg = nempc.IPConfig(**dict(lv.BENCH_CONFIG, record=True))
    mpc = nempc.NMPC(nempc.MLPDynamics.make(x_dim=2, u_dim=1,
                                            hidden=[32, 32]),
                     lv.bench_cost, [nempc.Box.make(**lv.BENCH_BOX),
                                     lv.feed_floor()],
                     H=H, DT=DT, integrator="rk4", config=cfg, device="cuda")
    carry, res = mpc.next_batch(xs, params=params)
    _, res = mpc.next_batch(res.x[:, 0].contiguous(), params=params,
                            carry=carry)
    it = res.iterations.long()
    hist = torch.bincount(it.cpu(), minlength=cfg.max_iter + 1)
    tail = it >= TAIL_ITERS
    err = res.trace["kkt_error"][tail]
    near = (err <= 10 * cfg.tol).float()
    first_near = torch.where(near.any(-1), near.argmax(-1) + 1,
                             torch.full_like(it[tail], cfg.max_iter))
    mu_then = res.trace["mu"][tail].gather(
        1, (first_near - 1).clamp(min=0)[:, None])[:, 0]
    out = {"histogram": hist.tolist(), "tail_members": int(tail.sum()),
           "first_within_10tol_p50": float(first_near.float().median())
           if bool(tail.any()) else None,
           "done_p50": float(it[tail].float().median())
           if bool(tail.any()) else None,
           "mu_then_p50": float(mu_then.median())
           if bool(tail.any()) else None}
    log(f"  budgeted LV fleet, record=True, a warm re-plan B={B}: converged "
        f"{int(res.converged.sum())}, per-member iterations histogram "
        f"{hist.tolist()}; {out['tail_members']} members take >= "
        f"{TAIL_ITERS}: their KKT error first within 10x tol at iteration "
        f"{out['first_within_10tol_p50']} (median, μ then "
        f"{out['mu_then_p50']}), done at {out['done_p50']}")
    return out


# ---- phases 4o-4r: the parallel-in-time sweep, the long-horizon fleet, ----
# ---- the horizon-sharded sweep and solve, scenario sharding ----

def on_card(tag, tensors):
    """Every tensor lies on the card: no path quietly moves one to the
    CPU."""
    where = {str(t.device) for t in tensors if isinstance(t, torch.Tensor)}
    if where != {"cuda:0"}:
        raise RuntimeError(f"{tag}: outputs on {where}, not on the card")


def device_work_ms(fn, runs=3):
    """The device time of one call of ``fn`` (its kernels and copies, from
    a torch.profiler trace of ``runs`` calls) and its device events a
    call."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    return (sum(e.time_range.elapsed_us() for e in dev) / 1e3 / runs,
            len(dev) / runs)


def pscan_gate(rk, rg, fn, Bn, Hn, nx, nu, kind, tag):
    """``fn`` (a parallel-in-time sweep) against the plain sweep on the
    seeded case on the card: equal ok flags (the expected ones), its
    outputs on the card, the scaled error within PSCAN_SPREAD times the
    port's own on the CPU; no sweep kernel and no plain sweep launched
    by ``fn``.  Returns the case and the error."""
    from pyneuralempc_tpu_torch.ops.cuda.sweep_cases import scaled_error
    args = sweep_case(kind, PSCAN_CASES[kind], Bn, Hn, nx, nu)
    n0 = counters(rk, rg)
    out = fn(*args)
    torch.cuda.synchronize()
    if counters(rk, rg) != n0:
        raise RuntimeError(f"{tag}: a sweep kernel or the plain sweep ran")
    on_card(tag, out)
    ref = rk.riccati_sweep_plain(*args)
    want = (torch.arange(Bn, device="cuda") % 2 == 1
            if kind == "delta_rescue" else torch.ones(Bn, dtype=torch.bool,
                                                      device="cuda"))
    err = scaled_error(out[:3], ref[:3], ref[3])
    limit = PSCAN_SPREAD * PSCAN_CPU_ERR[(Bn, Hn, nx, nu)][kind]
    same = bool(torch.equal(out[3], ref[3]))
    log(f"  {tag} vs plain, {kind}, (B, H, nx, nu) = {(Bn, Hn, nx, nu)}: "
        f"scaled error {err:.3e} (limit {limit:.3e}: {PSCAN_SPREAD} x the "
        f"port's on the CPU), ok {int(out[3].sum())}/{Bn} equal to plain's: "
        f"{same}")
    if not (same and torch.equal(ref[3], want) and err <= limit):
        raise RuntimeError(f"{tag}: the sweep disagrees with plain")
    return args, err


def phase_pscan_sweep(rk, rg, card):
    """Phase 4o: the parallel-in-time sweep alone against the plain one on
    the card, and its time beside the fused kernel's at (256, 512, 2, 1)."""
    from pyneuralempc_tpu_torch.solve.pscan import riccati_sweep_pscan
    out = {}
    for shape in PSCAN_SHAPES:
        for kind in PSCAN_CASES:
            args, err = pscan_gate(rk, rg, riccati_sweep_pscan, *shape,
                                   kind, "pscan")
            out[f"{shape} {kind}"] = err
            if (shape, kind) != (PSCAN_SHAPES[0], "delta0"):
                continue
            plan = rk.kernel_plan(shape[1], 2, 1, "cuda")
            fused_ms, how = kernel_device_ms(
                lambda: rk.riccati_sweep_cuda(*args), plan["kernel"],
                strict=True)
            fused_call = cuda_median_ms(lambda: rk.riccati_sweep_cuda(*args))
            call_ms = cuda_median_ms(lambda: riccati_sweep_pscan(*args),
                                     runs=10, warmup=2)
            work_ms, events = device_work_ms(
                lambda: riccati_sweep_pscan(*args))
            plain_ms = cuda_median_ms(lambda: rk.riccati_sweep_plain(*args),
                                      runs=1, warmup=0)
            log(f"[{card}] sweeps at (B, H, nx, nu) = {shape}: pscan "
                f"{call_ms:.3f} ms a call between CUDA events, its device "
                f"work {work_ms:.3f} ms in {events:.0f} kernels and copies "
                f"a call; the fused kernel ({plan['kernel']}) device time "
                f"{fused_ms * 1e3:.2f} us ({how}), {fused_call * 1e3:.1f} "
                f"us a wrapper call; the plain sweep {plain_ms:.1f} ms")
            out.update(pscan_call_ms=call_ms, pscan_device_ms=work_ms,
                       pscan_events=events, fused_ms=fused_ms,
                       fused_call_ms=fused_call, plain_ms=plain_ms)
    return out


def long_horizon_mpc(nempc, device, kkt="riccati", mesh=None):
    """tools/bench_horizon_tpu.py's build_mpc, copied: the normalised LV
    ODE itself as the model, RK4, the cost 1.1·Σu, the box, H=LH_H,
    DT=2/H, tol 1e-5."""
    model = nempc.torch_dynamics(f_true, x_dim=2, u_dim=1)
    cost = nempc.StageCost(stage=lambda x, u: 1.1 * torch.sum(u))
    box = nempc.DomainConstraint(
        states_constraint=[[-1.0, 1.0], [-1.0, 0.35]],
        control_constraint=[[0.0, 1.2]])
    return nempc.NMPC(model, cost, [box], H=LH_H, DT=2.0 / LH_H,
                      integrator="rk4", config=nempc.IPConfig(tol=1e-5,
                                                              kkt=kkt),
                      mesh=mesh, device=device)


def long_horizon_starts(Bn):
    """tools/bench_horizon_tpu.py's measure starts."""
    rng = np.random.default_rng(0)
    return np.stack([rng.uniform(0.2, 0.8, Bn),
                     rng.uniform(-0.9, -0.3, Bn)], axis=1).astype(np.float32)


def long_horizon_run(mpc, Bn, tag, warm=LH_WARM):
    """A cold solve and ``warm`` warm re-plans from the plans' first states
    (tools/bench_horizon_tpu.py's protocol): per step the result, the
    carry it returned and the time."""
    xs = torch.as_tensor(long_horizon_starts(Bn), device="cuda")
    steps, carries, times = [], [], []
    carry = None
    for k in range(warm + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        carry, res = mpc.next_batch(xs, carry=carry)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        on_card(tag, [res.u, res.x, res.converged, res.iterations,
                      carry.w])
        check_plan(res, LH_H, 2, 1, Bn)
        steps.append(res)
        carries.append(carry)
        log(f"  {tag} B={Bn} {'cold' if k == 0 else f'warm {k - 1}'}: "
            f"{times[-1] * 1e3:.1f} ms  " + telemetry("", res))
        xs = res.x[:, 0].contiguous()
    return steps, carries, times


def hold_counts(tag, steps, floor, reference):
    """Converged counts (cold, each warm re-plan) at least ``floor``."""
    got = [int(r.converged.sum()) for r in steps]
    log(f"  {tag}: converged {got} (at least {floor[:len(got)]}; the JAX "
        f"package on the CPU: {reference[:len(got)]})")
    if any(g < f for g, f in zip(got, floor)):
        raise RuntimeError(f"{tag}: convergence {got} below {floor}")
    return got


def hold_plans(tag, steps, ref_steps, rerun, same_inputs=None, first=0):
    """Plans against ``ref_steps``' on the members converged under both:
    cold (step 0) within LH_SPREAD x the JAX package's own pscan-vs-riccati
    cold difference, warm within LH_SPREAD x its warm one; ``first`` is
    the step ``steps`` starts at.  The cost is linear in u, and a warm
    re-plan starts from each run's own previous plan and carry, so a
    member's plan may be fixed only loosely by what came before.  A member
    past the limit is held to the limit + SPREAD x the reference's own
    move when ``rerun(k, eps)`` re-solves step k of the reference from its
    starts moved by ±PERTURB (the budgeted fleet's rule), with the
    candidate's plan re-solved from the reference's own starts and carry
    (``same_inputs(k)``) where the two runs' inputs differ.  Returns the
    largest |du| a step."""
    dus = []
    for k, (a, b) in enumerate(zip(steps, ref_steps), start=first):
        both = a.converged & b.converged
        d = (a.u - b.u).abs().amax(dim=(1, 2))
        du = float(d[both].max())
        limit = LH_SPREAD * LH_JAX_DU["cold" if k == 0 else "warm"]
        over = torch.nonzero(both & (d > limit)).flatten()
        dus.append(du)
        step = "cold" if k == 0 else f"warm {k - 1}"
        log(f"  {tag} {step}: max |du| {du:.3e} on the {int(both.sum())} "
            f"members converged under both (limit {limit:.3e}); not "
            f"compared: {int((~both).sum())}; past the limit: "
            f"{over.tolist()}")
        if not len(over):
            continue
        same = a if same_inputs is None else same_inputs(k)
        d_same = (same.u - b.u).abs().amax(dim=(1, 2))
        moved = torch.zeros_like(d)
        if bool((d_same[over] > limit).any()):
            for eps in (PERTURB, -PERTURB):
                alt = rerun(k, eps)
                moved = torch.maximum(moved, (alt.u - b.u).abs().amax(
                    dim=(1, 2)))
        log(f"    those members' |du| {d[over].tolist()}; from the "
            f"reference's own starts and carry {d_same[over].tolist()} "
            f"(converged {same.converged[over].tolist()}); the reference's "
            f"own move under ±{PERTURB} on the start, where that is past "
            f"the limit too, {moved[over].tolist()} (limit {limit:.3e} + "
            f"{SPREAD} x that)")
        if not bool((same.converged[over]
                     & (d_same[over] <= limit + SPREAD * moved[over])).all()):
            raise RuntimeError(f"{tag}: plans differ by {du:.3e}")
    return dus


def lh_rerun(mpc, steps, carries, k, eps):
    """Step k of a long-horizon run again, from its starts moved by
    ``eps`` (the cold starts, or the previous step's plans' first states
    with its carry)."""
    if k == 0:
        xs = torch.as_tensor(long_horizon_starts(LH_B), device="cuda")
        return mpc.next_batch(xs + eps)[1]
    xs = steps[k - 1].x[:, 0].contiguous()
    return mpc.next_batch(xs + eps, carry=carries[k - 1])[1]


def lh_floor(kkt, Bn=LH_B):
    """The converged-count floors: cold, the lower of the JAX package's
    two backends' counts, each warm re-plan its own backend's, less
    MU_SLACK of B."""
    cold = min(v[0] for v in LH_REFERENCE.values())
    return [n - int(MU_SLACK * Bn)
            for n in [cold] + LH_REFERENCE[kkt][1:]]


def long_horizon_16(device, eps):
    """The first N_CARD_VS_CPU members of the long-horizon fleet, their
    starts moved by ``eps``, under kkt="riccati_pscan" on ``device``: a cold
    solve and one warm re-plan, (u, converged, iterations) as numpy a step.
    On the CPU it runs in a worker process while the card works."""
    import pyneuralempc_tpu_torch as nempc
    mpc = long_horizon_mpc(nempc, device, "riccati_pscan")
    xs = torch.as_tensor(long_horizon_starts(LH_B)[:N_CARD_VS_CPU]
                         + np.float32(eps), device=device)
    carry, out = None, []
    for _ in range(2):
        carry, res = mpc.next_batch(xs, carry=carry)
        out.append(tuple(t.cpu().numpy() for t in
                         (res.u, res.converged, res.iterations)))
        xs = res.x[:, 0].contiguous()
    return out


def phase_long_horizon(nempc, rk, rg, card):
    """Phase 4p: the long-horizon LV fleet (H=512, B=256) cold + LH_WARM
    warm under kkt="riccati_pscan" and kkt="riccati" (the staged fused
    kernel at (2, 1)); counts and plans against the JAX package's own;
    B=8 cold + LH_SMALL_WARM warm, gated on warm convergence; 16 pscan
    members against the CPU (the CPU solves run in worker processes
    meanwhile)."""
    from types import SimpleNamespace
    out, steps, carries, mpcs = {}, {}, {}, {}
    cpu = {eps: cpu_pool().submit(long_horizon_16, "cpu", eps)
           for eps in (0.0, PERTURB, -PERTURB)}
    for kkt in ("riccati_pscan", "riccati"):
        mpc = mpcs[kkt] = long_horizon_mpc(nempc, "cuda", kkt)
        if mpc.kkt_backend != kkt:
            raise RuntimeError(f"kkt backend {mpc.kkt_backend}")
        reset_counters(rk, rg)
        steps[kkt], carries[kkt], times = long_horizon_run(mpc, LH_B, kkt)
        n = counters(rk, rg)
        if kkt == "riccati_pscan":
            no_kernel_launched(rk, rg, "kkt='riccati_pscan'")
        elif not only_launched(n, "fused", "fused_staged"):
            raise RuntimeError(f"kkt='riccati' at H={LH_H}: {n}")
        conv = hold_counts(kkt, steps[kkt], lh_floor(kkt),
                           LH_REFERENCE[kkt])
        p50 = statistics.median(times[1:])
        log(f"[{card}] long-horizon LV, {kkt}, B={LH_B}, H={LH_H}: cold "
            f"{times[0]:.2f} s, warm p50 {p50 * 1e3:.1f} ms -> "
            f"{LH_B / p50:,.1f} solves/s (fused launches {n['fused']})")
        out[kkt] = {"cold_s": times[0], "p50_ms": p50 * 1e3,
                    "converged": conv, "fused_launches": n["fused"],
                    "iterations_max": [int(r.iterations.max())
                                       for r in steps[kkt]]}
    out["du"] = hold_plans(
        "pscan vs riccati", steps["riccati_pscan"], steps["riccati"],
        lambda k, eps: lh_rerun(mpcs["riccati"], steps["riccati"],
                                carries["riccati"], k, eps),
        lambda k: lh_rerun(mpcs["riccati_pscan"], steps["riccati"],
                           carries["riccati"], k, 0.0))
    # few long problems: B=8, gated on warm convergence only
    for kkt in ("riccati_pscan", "riccati"):
        small, _, times = long_horizon_run(
            long_horizon_mpc(nempc, "cuda", kkt), LH_SMALL_B, kkt,
            warm=LH_SMALL_WARM)
        warm = [int(r.converged.sum()) for r in small[1:]]
        p50 = statistics.median(times[1:])
        log(f"[{card}] long-horizon LV, {kkt}, B={LH_SMALL_B}: cold "
            f"{times[0]:.2f} s, converged {int(small[0].converged.sum())}"
            f"; warm {warm} (all {LH_SMALL_B} needed, as the JAX "
            f"package's), p50 {p50 * 1e3:.1f} ms")
        if min(warm) < LH_SMALL_B:
            raise RuntimeError(f"B={LH_SMALL_B}, {kkt}: warm convergence "
                               f"{warm}")
        out[f"{kkt}_b{LH_SMALL_B}"] = {"cold_s": times[0],
                                       "p50_ms": p50 * 1e3}

    t0 = time.perf_counter()
    card16 = long_horizon_16("cuda", 0.0)
    for step, name in ((0, "cold solves"), (1, "warm re-plans")):
        def pscan16(dev, eps, step=step):
            u, conv, it = (cpu[eps].result() if dev == "cpu"
                           else card16)[step]
            return SimpleNamespace(u=torch.as_tensor(u),
                                   converged=torch.as_tensor(conv),
                                   iterations=torch.as_tensor(it))
        converged_card_vs_cpu(
            f"long-horizon LV, riccati_pscan, H={LH_H}, {N_CARD_VS_CPU} "
            f"{name}", pscan16, loose_masks=True)
    log(f"  ({time.perf_counter() - t0:.1f} s)")
    return (out, mpcs["riccati_pscan"], steps["riccati_pscan"],
            carries["riccati_pscan"])


def phase_horizon(nempc, rk, rg, card, pscan_mpc, pscan_steps,
                  pscan_carries, pscan_call_ms):
    """Phase 4q: the horizon-sharded sweep against plain on the card (a
    (2, 4) mesh of the one card), then NMPC(mesh=...) on a (1, 4) mesh on
    4p's fleet: one warm re-plan from 4p's pscan cold carry and starts,
    held to 4p's first pscan warm re-plan under 4p's gates."""
    from pyneuralempc_tpu_torch.parallel import (make_horizon_mesh,
                                                 make_sharded_sweep)
    dev = torch.device("cuda", 0)
    sharded = make_sharded_sweep(make_horizon_mesh(2, 4, devices=[dev] * 8))
    args, err = pscan_gate(rk, rg, sharded, *PSCAN_SHAPES[0], "delta0",
                           "horizon-sharded (2, 4)")
    call_ms = cuda_median_ms(lambda: sharded(*args), runs=5, warmup=1)
    log(f"[{card}] horizon-sharded sweep (2, 4) at {PSCAN_SHAPES[0]}: "
        f"{call_ms:.3f} ms a call between CUDA events (pscan "
        f"{pscan_call_ms:.3f})")
    mpc = long_horizon_mpc(nempc, "cuda", mesh=make_horizon_mesh(
        1, HORIZON_SHARDS, devices=[dev] * HORIZON_SHARDS))
    if mpc.kkt_backend != "riccati_horizon":
        raise RuntimeError(f"kkt backend {mpc.kkt_backend}")
    reset_counters(rk, rg)
    xs = pscan_steps[0].x[:, 0].contiguous()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, res = mpc.next_batch(xs, carry=pscan_carries[0])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    on_card("NMPC(mesh=...)", [res.u, res.x, res.converged])
    check_plan(res, LH_H, 2, 1, LH_B)
    log(f"  riccati_horizon B={LH_B}, warm 0 from 4p's pscan carry: "
        f"{secs * 1e3:.1f} ms  " + telemetry("", res))
    no_kernel_launched(rk, rg, "NMPC(mesh=...)")
    conv = hold_counts("riccati_horizon, warm 0", [res],
                       lh_floor("riccati_pscan")[1:],
                       LH_REFERENCE["riccati_pscan"][1:])
    dus = hold_plans("horizon vs pscan", [res], pscan_steps[1:2],
                     lambda k, eps: lh_rerun(pscan_mpc, pscan_steps,
                                             pscan_carries, k, eps), first=1)
    log(f"[{card}] long-horizon LV on a (1, {HORIZON_SHARDS}) mesh, B={LH_B}"
        f": a warm re-plan {secs * 1e3:.1f} ms -> {LH_B / secs:,.1f} "
        "solves/s")
    return {"sweep_err": err, "sweep_call_ms": call_ms,
            "warm_ms": secs * 1e3, "converged": conv, "du": dus}


def phase_scenario(nempc, rk, rg, card, params, x0s):
    """Phase 4r: ShardedNMPC over a mesh of the card named SCEN_SHARDS
    times on phase 4's fleet (B=4096): cold, then one warm re-plan with the
    carry from the cold plans' first states (phase 4's protocol), each
    against the unsharded solve's (equal converged masks, |du| within
    SHARDED_DU), each shard's results on its device; the warm re-plan
    converges all members in at most the cold call's iterations."""
    from pyneuralempc_tpu_torch.parallel import ShardedNMPC, make_mesh
    dev = torch.device("cuda", 0)
    mpc = make_controller(nempc, "cuda")
    times, runs = {}, {}
    reset_counters(rk, rg)
    sharded = ShardedNMPC(mpc, make_mesh(devices=[dev] * SCEN_SHARDS))
    for name, runner in (("unsharded", mpc), ("sharded", sharded)):
        xs = torch.as_tensor(x0s, device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        carry, cold = runner.next_batch(xs, params=params)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        carry, warm = runner.next_batch(cold.x[:, 0].contiguous(),
                                        params=params, carry=carry)
        torch.cuda.synchronize()
        times[name] = (t1 - t0, time.perf_counter() - t1)
        runs[name] = (cold, warm, carry)
    plain = runs["unsharded"]
    for res in runs["sharded"]:
        for s, d in zip(res.shards, sharded.devices):
            if {t.device for t in s if isinstance(t, torch.Tensor)} != {d}:
                raise RuntimeError(f"a shard's results are not on its "
                                   f"device {d}")
    cold, warm, _ = runs["sharded"]
    du = [float((a.u - b.u).abs().max()) for a, b in zip(runs["sharded"][:2],
                                                         plain[:2])]
    same = all(bool(torch.equal(a.converged, b.converged))
               for a, b in zip(runs["sharded"][:2], plain[:2]))
    warm_ok = (int(warm.converged.sum()) == B
               and int(warm.iterations.max()) <= int(cold.iterations.max()))
    log(f"ShardedNMPC, {SCEN_SHARDS} shards of the card, B={B}: converged "
        f"masks equal to the unsharded solve's (cold, warm): {same}, max "
        f"|du| {du[0]:.3e}, {du[1]:.3e} (limit {SHARDED_DU}); warm: "
        f"converged {int(warm.converged.sum())}/{B}, iterations max "
        f"{int(warm.iterations.max())} (cold {int(cold.iterations.max())}"
        f"; unsharded {int(plain[1].iterations.max())}, "
        f"{int(plain[0].iterations.max())}); shards "
        f"{[tuple(s.u.shape) for s in cold.shards]}")
    if not (same and max(du) <= SHARDED_DU and warm_ok):
        raise RuntimeError("ShardedNMPC differs from the unsharded solve")
    n = counters(rk, rg)
    if not only_launched(n, "fused", "fused_staged"):
        raise RuntimeError(f"ShardedNMPC: {n}")
    log(f"[{card}] LV fleet B={B}, cold then one warm re-plan: unsharded "
        f"{times['unsharded'][0]:.2f} s + {times['unsharded'][1] * 1e3:.1f} "
        f"ms, {SCEN_SHARDS} shards one after another "
        f"{times['sharded'][0]:.2f} s + {times['sharded'][1] * 1e3:.1f} ms")
    return {"du": du, "times_s": times}


# ---- phase 5: card vs CPU ----

def card_vs_cpu(tag, solve, iterations=False):
    """``solve(device)`` on the card and on the CPU: |du| within
    CARD_VS_CPU_DU and equal converged masks (and, with ``iterations``,
    equal iteration counts).  Returns both results."""
    out = {dev: solve(dev) for dev in ("cuda", "cpu")}
    du = float((out["cuda"].u.cpu() - out["cpu"].u).abs().max())
    same = bool(torch.equal(out["cuda"].converged.cpu(),
                            out["cpu"].converged))
    iters = (not iterations
             or bool(torch.equal(out["cuda"].iterations.cpu(),
                                 out["cpu"].iterations)))
    log(f"card vs CPU ({tag}): max |du| {du:.3e} (limit {CARD_VS_CPU_DU}), "
        f"converged masks equal: {same}"
        + (f", iterations equal: {iters} (converged "
           f"{int(out['cpu'].converged.sum())}/"
           f"{out['cpu'].converged.numel()})" if iterations else ""))
    if not (du <= CARD_VS_CPU_DU and same and iters):
        raise RuntimeError(f"{tag}: card and CPU solves differ: |du| "
                           f"{du:.3e}, masks equal {same}, iterations equal "
                           f"{iters}")
    return out


def budget_card_vs_cpu(tag, run, diff, compare):
    """A fleet (the budgeted one, ALM's) on the card and on the CPU, the CPU
    run also from starts moved by ±PERTURB: members whose CPU answer moves
    by more than DETERMINED under that (``diff(alt, cpu)``, per member) or whose
    iteration counts change are not fixed to the 1e-4 gates by f32.  The
    others are held to CARD_VS_CPU_DU in ``diff(card, cpu)``; these flat
    members to CARD_VS_CPU_DU + SPREAD times their own move.
    ``compare(card, cpu, determined)`` holds every member to what f32 does
    fix (masks, objective, floor)."""
    card, cpu = run("cuda", 0.0), run("cpu", 0.0)
    moved = torch.zeros(N_CARD_VS_CPU)
    same_iters = torch.ones(N_CARD_VS_CPU, dtype=torch.bool)
    for eps in (PERTURB, -PERTURB):
        alt = run("cpu", eps)
        moved = torch.maximum(moved, diff(alt, cpu))
        same_iters &= (alt.iterations == cpu.iterations).reshape(
            -1, N_CARD_VS_CPU).all(0)
    determined = (moved <= DETERMINED) & same_iters
    flat = torch.nonzero(~determined).flatten().tolist()
    d = diff(card, cpu)
    limit = torch.where(determined, torch.tensor(CARD_VS_CPU_DU),
                        CARD_VS_CPU_DU + SPREAD * moved)
    log(f"card vs CPU ({tag}): {int(determined.sum())}/{N_CARD_VS_CPU} "
        f"members fixed by f32 (the CPU answer moves by <= {DETERMINED} "
        f"under ±{PERTURB} on the start, with the same iterations), max "
        f"|diff| {float(d[determined].max()):.3e} on them (limit "
        f"{CARD_VS_CPU_DU}); flat: {flat}, moved "
        f"{[float(moved[i]) for i in flat]}, card vs CPU "
        f"{[float(d[i]) for i in flat]} (limit {CARD_VS_CPU_DU} + {SPREAD} x "
        "moved)")
    if int(determined.sum()) < N_CARD_VS_CPU // 2:
        raise RuntimeError(f"{tag}: fewer than half the members are fixed "
                           "by f32; the comparison says nothing")
    if not bool((d <= limit).all()):
        raise RuntimeError(f"{tag}: card and CPU differ by more than f32 "
                           "explains")
    compare(card, cpu, determined)


def phase_card_vs_cpu_new(gd, rnn_params, z0s, qm_model, qm_params,
                          qm_x0s, examples):
    """The new paths on the card and on the CPU: 16 GRU fleet members,
    cartpole's first re-plan (cut at CP_FIRST_ITERS iterations) and a
    converging re-plan, 16 quadrotor MLP members, and a multi-start's
    winner and its index."""
    from pyneuralempc_tpu_torch.examples import fleet_rnn, quadrotor

    def on(dev, tree):
        if isinstance(tree, dict):
            return {k: on(dev, v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [on(dev, v) for v in tree]
        return tree.to(dev)

    card_vs_cpu(
        f"GRU fleet, H={RNN_H}, {N_CARD_VS_CPU} cold solves",
        lambda dev: fleet_rnn.make_fleet_rnn_mpc(gd, dev, H=RNN_H)
        .next_batch(z0s[:N_CARD_VS_CPU].to(dev),
                    params=on(dev, rnn_params))[1], iterations=True)
    card_vs_cpu(
        f"cartpole's first re-plan, H={CP_H}, cut at {CP_FIRST_ITERS} "
        "iterations", examples("cartpole_first"), iterations=True)
    card_vs_cpu(
        f"cartpole, a converging re-plan 0.3 rad off upright, H={CP_H}",
        examples("cartpole_near"), iterations=True)
    card_vs_cpu(
        f"quadrotor MLP, H={QH}, {N_CARD_VS_CPU} cold solves",
        lambda dev: quadrotor.make_quadrotor_mpc(dev, H=QH, model=qm_model)
        .next_batch(torch.as_tensor(qm_x0s[:N_CARD_VS_CPU], device=dev),
                    params=on(dev, qm_params))[1], iterations=True)
    picks, run = {}, examples("multi_start")

    def multi_start(dev):
        best, picks[dev] = run(dev)
        return best
    card_vs_cpu(f"cartpole next_multi_start, {CP_STARTS} starts, cut at "
                f"{CP_FIRST_ITERS} iterations, the winner", multi_start,
                iterations=True)
    log(f"  multi-start winner: card {picks['cuda']}, CPU {picks['cpu']}")
    if picks["cuda"] != picks["cpu"]:
        raise RuntimeError("the multi-start winners differ")


def phase_card_vs_cpu_wide_options(params, x0s, examples):
    """The wide fleet's 16 cold solves, and the solver options on 16 LV
    members (adaptive and mehrotra; polish_fresh=True at OPT_SMALL_B;
    hessian="gauss_newton", its converged members' plans held as the
    budgeted fleet's; converged counts logged), on the card and on the
    CPU."""
    option_sets = ({"mu_strategy": "adaptive"}, {"mu_strategy": "mehrotra"},
                   {"polish_fresh": True})
    sizes = [N_CARD_VS_CPU if "mu_strategy" in o else OPT_SMALL_B
             for o in option_sets]
    # the CPU halves go to the workers, behind the examples'
    runs = [lv_runs("lv", {0.0: x0s[:n]}, params, **o)
            for o, n in zip(option_sets, sizes)]
    gn = lv_runs("lv", moved_starts(x0s[:N_CARD_VS_CPU]), params,
                 hessian="gauss_newton")
    card_vs_cpu(f"wide fleet, H={W_H}, {N_CARD_VS_CPU} cold solves",
                examples("wide"))

    for options, n, run in zip(option_sets, sizes, runs):
        out = card_vs_cpu(f"LV, {options}, {n} cold solves",
                          lambda dev: run(dev, 0.0))
        log(f"  converged {int(out['cuda'].converged.sum())}/{n} on the "
            f"card, {int(out['cpu'].converged.sum())}/{n} on the CPU")

    # Gauss-Newton curvature converges linearly: some members take all 60
    # iterations unconverged, their iterates no solution and parting by up
    # to ~0.5 when the start moves by 1e-7, and a few converged plans move
    # by ~1e-2.  So the masks are held equal, the converged members' plans
    # as the budgeted fleet's (fixed by f32: 1e-4; flat: 1e-4 + SPREAD x
    # their move), the unconverged members' iterates not at all
    converged_card_vs_cpu(f"LV, hessian='gauss_newton', {N_CARD_VS_CPU} "
                          "cold solves", gn)


def converged_card_vs_cpu(tag, run, loose_masks=False):
    """``run(device, eps)`` (N_CARD_VS_CPU members or any other number,
    their starts moved by eps) on the card and on the CPU, the CPU also at
    ±PERTURB: equal converged masks (with ``loose_masks``, on the members
    whose CPU flag the ±PERTURB moves do not change: where a member stops
    at max_iter near tol, f32 decides whether it converged); the members
    converged on both whose CPU plan moves by at most DETERMINED with the
    same iterations (fixed by f32) held to CARD_VS_CPU_DU in u and to equal
    iterations, the other converged ones to CARD_VS_CPU_DU + SPREAD times
    their move; unconverged members' iterates are not compared."""
    def du(a, b):
        return (a.u.cpu() - b.u).abs().amax(dim=(1, 2))

    card, cpu = run("cuda", 0.0), run("cpu", 0.0)
    n = cpu.converged.numel()
    moved = torch.zeros(n)
    same_iters = torch.ones(n, dtype=torch.bool)
    flips = torch.zeros(n, dtype=torch.bool)
    for eps in (PERTURB, -PERTURB):
        alt = run("cpu", eps)
        moved = torch.maximum(moved, du(alt, cpu))
        same_iters &= alt.iterations == cpu.iterations
        flips |= alt.converged != cpu.converged
    conv = cpu.converged & card.converged.cpu()
    fixed = conv & (moved <= DETERMINED) & same_iters
    d = du(card, cpu)
    limit = torch.where(fixed, torch.tensor(CARD_VS_CPU_DU),
                        CARD_VS_CPU_DU + SPREAD * moved)
    held = ~flips if loose_masks else torch.ones_like(flips)
    same = bool(torch.equal(card.converged.cpu()[held], cpu.converged[held]))
    iters = bool(torch.equal(card.iterations.cpu()[fixed],
                             cpu.iterations[fixed]))
    flat = torch.nonzero(conv & ~fixed).flatten().tolist()
    log(f"card vs CPU ({tag}): converged {int(card.converged.sum())}/"
        f"{n} on the card, {int(cpu.converged.sum())} on the "
        f"CPU, masks equal: {same}"
        + (f" (on the {int(held.sum())} members whose CPU flag ±{PERTURB} "
           "does not change)" if loose_masks else "")
        + f"; {int(fixed.sum())} converged members fixed by f32, "
        f"max |du| "
        f"{float(d[fixed].max()) if bool(fixed.any()) else 0.0:.3e} on them "
        f"(limit {CARD_VS_CPU_DU}), iterations equal on them: {iters}; "
        f"converged and flat: {len(flat)} {flat[:10]}, moved "
        f"{[float(moved[i]) for i in flat[:10]]}, card vs CPU "
        f"{[float(d[i]) for i in flat[:10]]} (limit {CARD_VS_CPU_DU} + "
        f"{SPREAD} x moved)")
    if not (same and iters and bool((d <= limit)[conv].all())):
        raise RuntimeError(f"{tag}: card and CPU solves differ")


def example_solve(kind, device, starts=None):
    """One solve of a phase-5 check that needs nothing the card computes,
    on ``device``: the quadrotor ("quadrotor"), EQ/border quadrotor
    ("fleet_eq") and wide ("wide") fleets from ``starts`` (numpy), H=QH;
    cartpole's first re-plan cut at CP_FIRST_ITERS iterations
    ("cartpole_first"), a converging re-plan 0.3 rad off upright
    ("cartpole_near"), and next_multi_start's winner with its index
    ("multi_start")."""
    from pyneuralempc_tpu_torch.examples import (cartpole, fleet_eq,
                                                 fleet_wide, quadrotor)
    if kind in ("quadrotor", "fleet_eq", "wide"):
        mpc = {"quadrotor": lambda: quadrotor.make_quadrotor_mpc(device,
                                                                 H=QH),
               "fleet_eq": lambda: fleet_eq.make_fleet_eq_mpc(
                   device, border=True, H=QH),
               "wide": lambda: fleet_wide.make_fleet_wide_mpc(
                   device, H=W_H)}[kind]()
        return mpc.next_batch(torch.as_tensor(starts, device=device))[1]
    hanging = torch.tensor(cartpole.X_HANGING).to(device)
    if kind == "cartpole_first":
        return cartpole.make_cartpole_mpc(
            device, max_iter=CP_FIRST_ITERS).next(hanging)
    if kind == "cartpole_near":
        near = torch.tensor([0.1, 0.0, 0.3, 0.0])
        return cartpole.make_cartpole_mpc(device).next(
            near.to(device), init_x=near.expand(CP_H, 4).to(device),
            init_u=torch.zeros(CP_H, 1, device=device))
    if kind == "multi_start":
        return cartpole.make_cartpole_mpc(
            device, max_iter=CP_FIRST_ITERS).next_multi_start(
            hanging, n_starts=CP_STARTS,
            generator=torch.Generator().manual_seed(0), return_index=True)
    raise ValueError(kind)


def example_runs(starts):
    """``run(kind)(device)`` for card_vs_cpu: :func:`example_solve` of each
    kind in ``starts`` (kind -> numpy starts or None), the card's in this
    process, the CPU's submitted to the workers now."""
    cpu = {kind: cpu_pool().submit(example_solve, kind, "cpu", xs)
           for kind, xs in starts.items()}

    def run(kind):
        def solve(device):
            if device == "cpu":
                return cpu[kind].result()
            return example_solve(kind, device, starts[kind])
        return solve
    return run


def phase_card_vs_cpu(params, x0s, examples):
    from pyneuralempc_tpu_torch.examples.lotka_volterra import U_FLOOR

    # the CPU halves of the LV fleet's checks go to the workers too, behind
    # the examples' (run() submits those before this phase)
    starts = x0s[:N_CARD_VS_CPU]
    lv = lv_runs("lv", {0.0: starts}, params)
    budget = lv_runs("budget", moved_starts(starts), params)
    loop = lv_runs("budget_loop", moved_starts(starts), params)

    card_vs_cpu(f"quadrotor, H={QH}, {N_CARD_VS_CPU} cold solves",
                examples("quadrotor"))
    card_vs_cpu(f"EQ/border quadrotor, H={QH}, {N_CARD_VS_CPU} cold solves",
                examples("fleet_eq"))
    card_vs_cpu(f"LV, {N_CARD_VS_CPU} cold solves", lambda dev: lv(dev, 0.0))

    def compare_plans(card, cpu, determined):
        same = bool(torch.equal(card.converged.cpu(), cpu.converged))
        dobj = float((card.objective.cpu() - cpu.objective).abs().max())
        floor = float(card.u.sum(dim=(1, 2)).min())
        log(f"card vs CPU (budgeted LV, {N_CARD_VS_CPU} cold solves): max "
            f"|dobjective| {dobj:.3e}, converged masks equal: {same}, Σu min "
            f"{floor:.6f}")
        if not (same and dobj <= 1e-5 and floor >= U_FLOOR - BUDGET_SLACK):
            raise RuntimeError("budgeted LV: card and CPU solves differ")

    budget_card_vs_cpu("budgeted LV, cold, |du|", budget,
                       lambda alt, ref: (alt.u.cpu() - ref.u).abs()
                       .amax(dim=(1, 2)), compare_plans)

    def compare_loops(card, cpu, determined):
        conv_same = bool(torch.equal(card.converged, cpu.converged))
        it_same = bool(torch.equal(card.iterations[:, determined],
                                   cpu.iterations[:, determined]))
        log(f"card vs CPU (budgeted LV closed loop, B={N_CARD_VS_CPU}, 4 "
            f"steps): converged equal: {conv_same}, iterations equal on the "
            f"fixed members: {it_same}")
        if not (conv_same and it_same):
            raise RuntimeError("budgeted LV closed loop: card and CPU "
                               "differ")

    budget_card_vs_cpu("budgeted LV closed loop, |dx|", loop,
                       lambda alt, ref: (alt.x - ref.x).abs().amax(dim=(0, 2)),
                       compare_loops)


# ---- phases 4s-4v: the LSTM fleets, bf16, config 1 and batch_chunk ----

_PROCS = []      # subprocesses the run started (the profiling CLI)


def no_fallback(rk, tag, fn, *args, **kwargs):
    """One of the paths that predate the out-of-envelope route: every plan
    of it is inside a kernel's envelope, so FALLBACK_CALLS, from 0 before
    it, must still be 0 after it.  Returns ``fn``'s result."""
    rk.FALLBACK_CALLS = 0
    out = fn(*args, **kwargs)
    log(f"{tag}: FALLBACK_CALLS {rk.FALLBACK_CALLS}")
    if rk.FALLBACK_CALLS:
        raise RuntimeError(f"{tag}: {rk.FALLBACK_CALLS} sweeps took the "
                           "plain fallback inside the kernels' envelope")
    return out


def first_members(res, n):
    """The first n members of every batched field of a result."""
    return type(res)(*[v[:n] if isinstance(v, torch.Tensor) and v.dim()
                       else v for v in res])


def lstm_solve(kind, z0s, eps):
    """A worker's half of 4s/4t's card-vs-CPU check: the ``kind`` LSTM
    fleet's cold solve on the CPU from the lifted starts ``z0s`` (numpy),
    their physical part moved by ``eps``."""
    from pyneuralempc_tpu_torch.examples import fleet_rnn
    bundle, params = fleet_rnn.lstm_fleet_model(kind, device="cpu")
    mpc = fleet_rnn.make_fleet_rnn_mpc(bundle, "cpu", H=LSTM_H)
    z = torch.as_tensor(z0s).clone()
    z[:, :bundle.x_dim] += eps
    return mpc.next_batch(z, params=params)[1]


def lstm_cpu_runs():
    """4s/4t's CPU halves, submitted to the workers: each LSTM fleet's first
    LSTM_N_CPU members from their starts and from them moved by ±PERTURB.
    Returns {kind: {eps: future}}."""
    from pyneuralempc_tpu_torch.examples import fleet_rnn
    out = {}
    for kind in LSTM_B:
        bundle, _ = fleet_rnn.lstm_fleet_model(kind, device="cpu")
        z0s = fleet_rnn.fleet_starts(bundle, LSTM_N_CPU, device="cpu").numpy()
        out[kind] = {eps: cpu_pool().submit(lstm_solve, kind, z0s, eps)
                     for eps in (0.0, PERTURB, -PERTURB)}
    return out


def fleet_steps(mpc, xs, params, warm, tag, counter):
    """A cold solve and ``warm`` warm re-plans, each from the plans' first
    states: per step the result, the carry, the time and the sweeps
    ``counter()`` saw."""
    steps, carries, times, sweeps = [], [], [], []
    carry = None
    for k in range(warm + 1):
        n0 = counter()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        carry, res = mpc.next_batch(xs, params=params, carry=carry)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        sweeps.append(counter() - n0)
        on_card(tag, [res.u, res.x, res.converged, carry.w])
        check_plan(res, mpc.H, mpc.spec.dims.x, mpc.spec.dims.u,
                   xs.shape[0])
        steps.append(res)
        carries.append(carry)
        log(f"  {tag} B={xs.shape[0]} {'cold' if k == 0 else f'warm {k - 1}'}"
            f": {times[-1] * 1e3:.1f} ms, sweeps {sweeps[-1]}  "
            + telemetry("", res))
        xs = res.x[:, 0].contiguous()
    return steps, carries, times, sweeps


def jax_floor(reference, Bn):
    """The JAX package's counts less MU_SLACK of B."""
    return [c - int(MU_SLACK * Bn) for c in reference]


def fallback_cases(rk, rg):
    """4s's direct dispatches outside every kernel's envelope: each seeded
    case warns once, counts its calls in FALLBACK_CALLS and launches no
    kernel, and gives the plain version's outputs bit for bit; its time a
    call."""
    from pyneuralempc_tpu_torch.ops.cuda import sweep_cases
    out = {}
    for Bn, Hn, nx, nu, R, r in FALLBACK_CASES:
        if (R, r) == (1, 0):
            case = sweep_cases.sweep_case("delta_per_problem", B=Bn, H=Hn,
                                          nx=nx, nu=nu, seed=1)
            fn, plain, sweep = rk.riccati_sweep, rk.riccati_sweep_plain, \
                "plain"
        else:
            case = sweep_cases.general_sweep_case(
                "delta_per_problem", B=Bn, H=Hn, nx=nx, nu=nu, R=R, r=r,
                seed=1)
            fn, plain, sweep = (rg.riccati_sweep_general,
                                rg.riccati_sweep_general_plain, "general")
        args = [torch.as_tensor(a, device="cuda") for a in case]
        label = f"(B, H, nx, nu, R, r) = {(Bn, Hn, nx, nu, R, r)}"
        plan = rk.kernel_plan(Hn, nx, nu, "cuda", R=R, r=r)
        rk._WARNED.discard((sweep, Hn, nx, nu, R, r))
        reset_counters(rk, rg)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            got = fn(*args)
            again = fn(*args)
        torch.cuda.synchronize()
        n = counters(rk, rg)
        ref = plain(*args)
        same = all(same_bits(a, b) for o in (got, again)
                   for a, b in zip(o, ref))
        warned = [str(w.message) for w in caught
                  if "outside every CUDA kernel's envelope" in
                  str(w.message)]
        ms = cuda_median_ms(lambda: fn(*args), runs=5, warmup=1)
        log(f"fallback dispatch at {label}: plan {plan['path']} "
            f"({plan['reason']}); FALLBACK_CALLS {n['fallback']} for 2 "
            f"calls, {len(warned)} warning(s), kernels launched "
            f"{sum(v for k, v in n.items() if k not in ('fallback', 'plain'))}"
            f"; outputs and ok flags equal to the plain version's bit for "
            f"bit: {same}; ok {int(ref[-1].sum())}/{Bn}; {ms:.2f} ms a "
            "call (CUDA events)")
        if not (plan["path"] == "plain_fallback" and n["fallback"] == 2
                and len(warned) == 1 and only_launched(n, "fallback",
                                                        "plain")
                and same and all(t.device.type == "cuda" for t in got)):
            raise RuntimeError(f"fallback dispatch at {label} failed its "
                               "gates")
        out[label] = ms
    return out


def phase_stacked_lstm(nempc, rk, rg, card, cpu_runs):
    """4s: the stacked-LSTM fleet, lifted past every kernel's nx, solved
    through the plain fallback on the card (one warning, no kernel), its
    counts against the JAX package's, its first members against the CPU;
    the fallback's time a call at the fleet's shape; the direct dispatches
    outside the envelope (fallback_cases)."""
    from pyneuralempc_tpu_torch.examples import fleet_rnn
    kind = "stacked_lstm"
    out = {"dispatch_ms": fallback_cases(rk, rg)}
    bundle, params = fleet_rnn.lstm_fleet_model(kind, device="cuda")
    nx, Bn = bundle.model.dims.x, LSTM_B[kind]
    plan = rk.kernel_plan(LSTM_H, nx, 1, "cuda")
    mpc = fleet_rnn.make_fleet_rnn_mpc(bundle, "cuda", H=LSTM_H)
    log(f"stacked-LSTM fleet (hiddens {bundle.hiddens}, seed "
        f"{fleet_rnn.LSTM_SEEDS[kind]}): kkt backend {mpc.kkt_backend}; "
        f"lifted state {nx}; sweep plan: {plan}")
    if plan["path"] != "plain_fallback" or f"nx={nx} > " not in plan[
            "reason"]:
        raise RuntimeError(f"the stacked-LSTM fleet plans {plan}")
    z0s = fleet_rnn.fleet_starts(bundle, Bn)
    rk._WARNED.discard(("plain", LSTM_H, nx, 1, 1, 0))
    reset_counters(rk, rg)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        steps, carries, times, sweeps = fleet_steps(
            mpc, z0s, params, LSTM_WARM[kind], "stacked LSTM",
            lambda: rk.FALLBACK_CALLS)
    n = counters(rk, rg)
    warned = [str(w.message) for w in caught
              if "outside every CUDA kernel's envelope" in str(w.message)]
    log(f"stacked-LSTM path: FALLBACK_CALLS {n['fallback']} (plain calls "
        f"{n['plain']}), kernels launched "
        f"{sum(v for k, v in n.items() if k not in ('fallback', 'plain'))}"
        f", warnings {len(warned)}: {warned[:1]}")
    if not (only_launched(n, "fallback", "plain") and len(warned) == 1):
        raise RuntimeError("the stacked-LSTM path did not take the plain "
                           "fallback alone, with one warning")
    conv = hold_counts("stacked LSTM", steps,
                       jax_floor(LSTM_JAX_CONVERGED[kind], Bn),
                       LSTM_JAX_CONVERGED[kind])
    runs = cpu_runs[kind]
    card0 = first_members(steps[0], LSTM_N_CPU)
    converged_card_vs_cpu(
        f"stacked-LSTM fleet, H={LSTM_H}, the first {LSTM_N_CPU} cold "
        "solves", lambda dev, eps: card0 if dev == "cuda"
        else runs[eps].result(), loose_masks=True)
    # the fallback sweep at the fleet's shape: its time a call and its
    # device work (PyTorch ops, no kernel of its own)
    args = tiled_sweep_case("delta0", 0, Bn // 4, LSTM_H, nx, 1, 4)
    sweep_ms = cuda_median_ms(lambda: rk.riccati_sweep(*args), runs=5,
                              warmup=1)
    dev_ms, events = device_work_ms(lambda: rk.riccati_sweep(*args))
    bound_ms = rk.sweep_bytes(Bn, LSTM_H, nx, 1) / HBM_BYTES_PER_S * 1e3
    log(f"[{card}] plain fallback sweep at B={Bn}, H={LSTM_H}, nx={nx}, "
        f"nu=1: {sweep_ms:.2f} ms a call (CUDA events), {dev_ms:.2f} ms of "
        f"device work in {events:.0f} kernels and copies; a fused sweep's "
        f"byte bound {bound_ms * 1e3:.2f} us")
    # no traced re-plan: a fallback sweep is ~12k kernels, and one traced
    # warm re-plan of this fleet, 4.5M device events, took 15 minutes
    split = report_split(nempc, mpc, carries[-1], steps[-1].x[:, 0]
                         .contiguous(), steps[-1], times[1:], sweeps[-1],
                         sweep_ms, card, params=params, busy=False)
    del args
    torch.cuda.empty_cache()
    out.update(split, cold_s=times[0], converged=conv,
               fallback_calls=n["fallback"], sweep_ms=sweep_ms,
               sweep_device_ms=dev_ms, sweep_events=events,
               fused_bound_ms=bound_ms,
               iterations_max=[int(r.iterations.max()) for r in steps])
    return out


def phase_lstm(nempc, rk, rg, card, cpu_runs, build_log):
    """4t: the single-LSTM fleet at (18, 1): the backward instance and the
    run-time forward kernel held against the plain halves (the instance
    against the run-time backward kernel too) on the four seeded cases,
    both timed, the instance in turns against the run-time backward
    kernel; then the fleet, every backward sweep through the instance and
    every forward sweep through the run-time kernel, its counts against the
    JAX package's and its first members against the CPU."""
    from pyneuralempc_tpu_torch.examples import fleet_rnn
    kind = "lstm"
    bundle, params = fleet_rnn.lstm_fleet_model(kind, device="cuda")
    nx, Bn = bundle.model.dims.x, LSTM_B[kind]
    plan = rk.kernel_plan(LSTM_H, nx, 1, "cuda")
    bname = f"riccati_general_backward_fixed<{nx}, 1, 1, 0>"
    if (plan["path"], plan.get("backward_kernel"),
            plan.get("forward_kernel")) != ("cuda_streamed", bname,
                                            "riccati_forward_kernel"):
        raise RuntimeError(f"({nx}, 1) plans {plan}, not the backward "
                           "instance and the run-time forward kernel")
    worst = None
    label = f"B={Bn}, H={LSTM_H}, nx={nx}, nu=1"
    for case, seed in CASES.items():
        args = tiled_sweep_case(case, seed, Bn // 4, LSTM_H, nx, 1, 4)
        worst = worse(worst, hold_streamed_pair(rk, case, args, label))
        del args
    args = tiled_sweep_case("delta0", 0, Bn // 4, LSTM_H, nx, 1, 4)
    bwd, fwd = pair_entries(rk, f" [lstm, {label}]", args)
    bwd_call = lambda: rk.riccati_backward_cuda(*args)  # noqa: E731
    rt_call = lambda: rk.riccati_backward_runtime_cuda(*args)  # noqa: E731
    turns = design_turns({"run-time": (rt_call, "riccati_backward_kernel"),
                          "instance": (bwd_call, bname)},
                         ("run-time", "instance", "instance", "run-time"),
                         bound_ms=bwd["bound_ms"])
    mean = {k: statistics.mean(v) for k, v in turns.items()}
    rt_call_ms = cuda_median_ms(rt_call)
    shape = {"B": Bn, "H": LSTM_H, "nx": nx, "nu": 1}
    bwd.update(design=f"compile-time instance {bname}", path="lstm",
               shape=shape, runtime_ms=mean["warm", "run-time"],
               runtime_call_ms=rt_call_ms,
               flushed_ms=mean["flushed", "instance"],
               runtime_flushed_ms=mean["flushed", "run-time"],
               turns_ms={f"{cache}, {who}": v
                         for (cache, who), v in turns.items()},
               smem_bytes_a_warp=rk.backward_fixed_smem_bytes(nx, 1, 1, 0),
               stage_buffers=rk.backward_fixed_buffers(nx, 1, 1, 0),
               ptxas_instance=ptxas_report(
                   build_log, "riccati_general_backward_fixed",
                   (nx, 1, 1, 0)),
               ptxas_runtime=ptxas_report(build_log,
                                          "riccati_backward_kernel", ()))
    fwd.update(design="run-time kernel riccati_forward_kernel", path="lstm",
               shape=shape)
    speedup = mean["warm", "run-time"] / mean["warm", "instance"]
    log(f"riccati_backward at {label}: run-time "
        f"{mean['warm', 'run-time'] * 1e3:.2f} / "
        f"{mean['flushed', 'run-time'] * 1e3:.2f} us, instance "
        f"{mean['warm', 'instance'] * 1e3:.2f} / "
        f"{mean['flushed', 'instance'] * 1e3:.2f} us (warm / L2 flushed, "
        f"means of two turns): the instance {speedup:.2f}x faster warm, "
        f"{bwd['bound_ms'] / mean['warm', 'instance']:.2%} of its bound; "
        f"wrapper calls {bwd['call_ms'] * 1e3:.1f} us instance, "
        f"{rt_call_ms * 1e3:.1f} us run-time")
    log(f"ptxas: backward instance {bname} ({bwd['stage_buffers']} stage "
        f"buffer(s), {bwd['smem_bytes_a_warp']} B a warp) "
        f"{bwd['ptxas_instance']}; run-time backward {bwd['ptxas_runtime']}")
    pair_ms = cuda_median_ms(lambda: rk.riccati_sweep_streamed_cuda(*args))
    log(f"streamed sweep [lstm, {label}] (backward + forward, one wrapper "
        f"call): {pair_ms * 1e3:.1f} us")
    set_worst(bwd, fwd, worst)
    del args
    torch.cuda.empty_cache()

    mpc = fleet_rnn.make_fleet_rnn_mpc(bundle, "cuda", H=LSTM_H)
    log(f"LSTM fleet (hidden {bundle.hidden}, seed "
        f"{fleet_rnn.LSTM_SEEDS[kind]}): kkt backend {mpc.kkt_backend}; "
        f"lifted state {nx}; sweep plan: {plan}")
    z0s = fleet_rnn.fleet_starts(bundle, Bn)
    reset_counters(rk, rg)
    steps, carries, times, sweeps = fleet_steps(
        mpc, z0s, params, LSTM_WARM[kind], "LSTM",
        lambda: rk.BACKWARD_LAUNCHES)
    n = counters(rk, rg)
    log(f"LSTM path: streamed backward launches {n['backward']} (the "
        f"instance {n['backward_instance']}), forward {n['forward']} (the "
        f"instance {n['forward_instance']}): every backward launch the "
        f"instance, every forward launch the run-time kernel; "
        f"FALLBACK_CALLS {n['fallback']}, plain calls {n['plain']}")
    if not (only_launched(n, "backward", "backward_instance", "forward")
            and n["backward_instance"] == n["backward"] == n["forward"]):
        raise RuntimeError("the LSTM path did not go through the backward "
                           "instance and the run-time forward kernel alone")
    conv = hold_counts("LSTM", steps, jax_floor(LSTM_JAX_CONVERGED[kind],
                                                 Bn),
                       LSTM_JAX_CONVERGED[kind])
    runs = cpu_runs[kind]
    card0 = first_members(steps[0], LSTM_N_CPU)
    converged_card_vs_cpu(
        f"LSTM fleet, H={LSTM_H}, the first {LSTM_N_CPU} cold solves",
        lambda dev, eps: card0 if dev == "cuda" else runs[eps].result(),
        loose_masks=True)
    # no traced re-plan, to keep the run inside its time (an H100 was busy
    # 86.5% of one)
    split = report_split(nempc, mpc, carries[-1], steps[-1].x[:, 0]
                         .contiguous(), steps[-1], times[1:], sweeps[-1],
                         pair_ms, card, params=params, busy=False)
    split.update(cold_s=times[0], converged=conv,
                 iterations_max=[int(r.iterations.max()) for r in steps])
    bwd["launches"], fwd["launches"] = n["backward"], n["forward"]
    return bwd, fwd, split


def phase_bf16(nempc, rk, rg, card, params, x0s, mono, cpu_run):
    """4u: phase 4's fleet and surrogate with bf16 matmuls: counts against
    the JAX package's, plans against phase 4's float32 ones, the first
    members against the CPU."""
    model = nempc.MLPDynamics.make(x_dim=2, u_dim=1, hidden=[32, 32],
                                   compute_dtype=torch.bfloat16)
    mpc = make_controller(nempc, "cuda", model=model)
    reset_counters(rk, rg)
    steps, _, times, sweeps = fleet_steps(
        mpc, torch.as_tensor(x0s, device="cuda"), params, BF16_WARM,
        "bf16 LV", lambda: rk.LAUNCHES)
    n = counters(rk, rg)
    log(f"bf16 LV path: fused kernel launches {n['fused']} (staged "
        f"{n['fused_staged']}), FALLBACK_CALLS {n['fallback']}, plain calls "
        f"{n['plain']}")
    cold = steps[0]
    both = cold.converged & mono.converged
    d = (cold.u - mono.u).abs().amax(dim=(1, 2))
    q = torch.quantile(d, torch.tensor([0.5, 0.9, 0.99], device="cuda"))
    log(f"bf16 vs phase 4's float32 cold plans: converged under both "
        f"{int(both.sum())}/{B}, max |du| {float(d[both].max()):.3e} there "
        f"(limit {BF16_VS_F32}); over every member: median "
        f"{float(q[0]):.3e}, 90% {float(q[1]):.3e}, 99% {float(q[2]):.3e}, "
        f"max {float(d.max()):.3e} (bf16's unconverged iterates); "
        f"KKT error median {float(cold.kkt_error.median()):.3e}")
    if not (only_launched(n, "fused", "fused_staged")
            and n["fused_staged"] == n["fused"]):
        raise RuntimeError("the bf16 LV path did not go through the staged "
                           "fused kernel alone")
    conv = hold_counts("bf16 LV", steps, jax_floor(BF16_JAX_CONVERGED, B),
                       BF16_JAX_CONVERGED)
    if not float(d[both].max()) <= BF16_VS_F32:
        raise RuntimeError("bf16 plans differ from float32's past "
                           f"{BF16_VS_F32}")
    converged_card_vs_cpu(
        f"bf16 LV, the first {LSTM_N_CPU} cold solves",
        lambda dev, eps: (first_members(cold, LSTM_N_CPU) if dev == "cuda"
                          else cpu_run("cpu", eps)), loose_masks=True)
    return {"cold_s": times[0], "warm_ms": [t * 1e3 for t in times[1:]],
            "converged": conv, "sweeps": sweeps,
            "vs_f32_both": int(both.sum()),
            "vs_f32_du": float(d[both].max())}


def phase_config1_chunk(nempc, rk, rg, card, params, lv_last):
    """4v: BASELINE config 1 (the LV ODE, Euler, H=10, one NMPC.next)
    against the CPU; phase 4's warm re-plan with batch_chunk=CHUNK against
    the whole one; then the profiling CLI started in a subprocess (phase 5
    runs beside it)."""
    from pyneuralempc_tpu_torch.examples.lotka_volterra import (
        CONFIG1_X0, make_config1_mpc)
    out = {}
    x0 = torch.tensor(CONFIG1_X0)
    reset_counters(rk, rg)
    t0 = time.perf_counter()
    res = make_config1_mpc("cuda").next(x0.cuda())
    torch.cuda.synchronize()
    out["config1_s"] = time.perf_counter() - t0
    n = counters(rk, rg)
    ref = make_config1_mpc("cpu").next(x0)
    du = float((res.u.cpu() - ref.u).abs().max())
    dx = float((res.x.cpu() - ref.x).abs().max())
    log(f"config 1 (LV ODE, Euler, H=10, NMPC.next): {out['config1_s']:.2f} "
        f"s, converged {bool(res.converged)} in {int(res.iterations)} "
        f"iterations (CPU: {bool(ref.converged)} in {int(ref.iterations)}),"
        f" card vs CPU max |du| {du:.3e}, |dx| {dx:.3e} (limit "
        f"{CARD_VS_CPU_DU}); fused launches {n['fused']} (staged "
        f"{n['fused_staged']})")
    if not (bool(res.converged) and bool(ref.converged)
            and du <= CARD_VS_CPU_DU and dx <= CARD_VS_CPU_DU
            and only_launched(n, "fused", "fused_staged")):
        raise RuntimeError("config 1 failed its gates")
    out.update(config1_du=du, config1_iterations=int(res.iterations))

    # batch_chunk: phase 4's last carry re-planned whole and in slices.
    # Each slice solves its members as the whole batch does, but f32 fixes
    # some members' plans only loosely (phase 4's per-member check): the
    # whole re-plan is repeated from starts moved by ±PERTURB, and a member
    # it moves by more than DETERMINED (or whose iterations change) is held
    # to CARD_VS_CPU_DU + SPREAD times its move
    carry, _, xs = lv_last
    mpc = make_controller(nempc, "cuda")
    timed = {}
    for chunk in (None, CHUNK):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        timed[chunk] = mpc.next_batch(xs, params=params, carry=carry,
                                      batch_chunk=chunk)[1]
        torch.cuda.synchronize()
        out[f"chunk_{chunk}_ms"] = (time.perf_counter() - t0) * 1e3
    whole, chunked = timed[None], timed[CHUNK]
    moved = torch.zeros(B, device="cuda")
    same_iters = torch.ones(B, dtype=torch.bool, device="cuda")
    for eps in (PERTURB, -PERTURB):
        alt = mpc.next_batch(xs + eps, params=params, carry=carry)[1]
        moved = torch.maximum(moved, (alt.u - whole.u).abs().amax(dim=(1, 2)))
        same_iters &= alt.iterations == whole.iterations
    determined = (moved <= DETERMINED) & same_iters
    d = (chunked.u - whole.u).abs().amax(dim=(1, 2))
    limit = torch.where(determined, torch.full_like(moved, CARD_VS_CPU_DU),
                        CARD_VS_CPU_DU + SPREAD * moved)
    same = bool(torch.equal(chunked.converged, whole.converged))
    log(f"batch_chunk={CHUNK} vs the whole B={B} warm re-plan: "
        f"{out[f'chunk_{CHUNK}_ms']:.1f} against {out['chunk_None_ms']:.1f} "
        f"ms; converged {int(chunked.converged.sum())} / "
        f"{int(whole.converged.sum())}, masks equal: {same}; "
        f"{int(determined.sum())}/{B} members fixed by f32, max |du| "
        f"{float(d[determined].max()):.3e} on them (limit {CARD_VS_CPU_DU}),"
        f" {float(d.max()):.3e} on all, every member within its limit: "
        f"{bool((d <= limit).all())}")
    if not (same and bool((d <= limit).all())
            and int(determined.sum()) >= B // 2):
        raise RuntimeError("the chunked re-plan differs from the whole one")
    out.update(chunk_du=float(d[determined].max()),
               chunk_fixed=int(determined.sum()))

    # the profiling CLI, the card's default device, in its own process
    env = dict(os.environ, PROF_BATCH=str(PROF_BATCH))
    proc = subprocess.Popen(
        [sys.executable, "-m", "pyneuralempc_tpu_torch.utils.profiling"],
        cwd=str(Path(__file__).resolve().parent), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    _PROCS.append(proc)
    log(f"profiling CLI started (PROF_BATCH={PROF_BATCH}, pid {proc.pid})")
    return out, proc


def finish_profiling(proc, out):
    """Wait for the profiling CLI: it must exit 0 and print its table."""
    t0 = time.perf_counter()
    stdout, stderr = proc.communicate(timeout=900)
    log(f"profiling CLI exited {proc.returncode} (waited "
        f"{time.perf_counter() - t0:.1f} s after phase 5):\n"
        + stderr.strip() + ("\n" + stdout.strip() if stdout.strip() else ""))
    if proc.returncode != 0 or "full warm step" not in stderr:
        raise RuntimeError("the profiling CLI failed")
    out["profiling_rc"] = proc.returncode
    out["profiling_table"] = [line for line in stderr.splitlines()
                              if line.strip().endswith(" ms")]


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        sys.exit(1)
    try:
        run()
    finally:
        for proc in _PROCS:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for pool in _POOL:
            pool.shutdown(cancel_futures=True)


def run():
    import pyneuralempc_tpu_torch as nempc
    from pyneuralempc_tpu_torch.ops.cuda import build, tanh_dense
    rk = nempc.riccati_kernel
    rg = nempc.riccati_general

    # phase 1: device
    card = card_line()
    name = torch.cuda.get_device_name(0)
    log(f"card: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("TF32 off for matmuls and cuDNN (full f32)")

    # phase 2: build, one nvcc for each source, all at once (and the wide
    # forward instance's other candidate depth, for the turns)
    t0 = time.perf_counter()
    sources = (rk.SOURCE, rk.STREAMED_SOURCE, rk.GENERAL_SOURCE,
               rk.GENERAL_FUSED_SOURCE, tanh_dense.SOURCE)
    alt_source = alt_depth_source(rk, build)
    built = build.build_all([build.CSRC_DIR / s for s in sources]
                            + [alt_source])
    *built, alt_built = built
    log(f"built {alt_source[0].name} (the wide forward instance at depth "
        f"{W_ALT_DEPTH}) -> {alt_built.path.name} in "
        f"{alt_built.seconds:.1f} s")
    for src, r in zip(sources, built):
        log(f"built {src} -> {r.path.name} in {r.seconds:.1f} s")
        for line in r.log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"  ptxas: {line.strip()}")
    log(f"build phase {time.perf_counter() - t0:.1f} s")

    # the CPU halves of 4s/4t's card-vs-CPU checks need nothing the card
    # computes: the workers take them now, while the card runs phases 3-4r
    lstm_cpu = lstm_cpu_runs()

    # phases 3, 3b, 3c, 3d: kernels vs plain; every path here predates the
    # out-of-envelope route, so none may take it (no_fallback)
    logs = {src: r.log for src, r in zip(sources, built)}
    fused = no_fallback(rk, "3", phase_kernels, rk, logs)
    bwd, fwd, pair_ms = no_fallback(rk, "3b", phase_streamed, rk,
                                    logs[rk.STREAMED_SOURCE])
    gbwd, gfwd, gpair_ms = no_fallback(rk, "3c", phase_general, rk, rg,
                                       logs[rk.GENERAL_SOURCE])
    gfused = no_fallback(rk, "3d", phase_fused_general, rk, rg,
                         logs[rk.GENERAL_FUSED_SOURCE])
    # phase 3e: the streamed instances at the new paths' stages
    new_shapes = no_fallback(rk, "3e", phase_streamed_new_shapes, rk,
                             logs[rk.STREAMED_SOURCE])
    rnn_bwd, rnn_fwd, rnn_pair_ms = new_shapes["fleet_rnn"]
    cp_bwd, cp_fwd, _ = new_shapes["cartpole"]
    qg_bwd, qg_fwd, _ = new_shapes["quadrotor_gru"]
    w_bwd, w_fwd, w_pair_ms = no_fallback(
        rk, "3e wide", phase_streamed_wide, rk, logs[rk.STREAMED_SOURCE],
        library_forward(alt_built.path), alt_built.log)

    # phases 4-4j, 6: main paths and their numbers
    params, x0s, fused["launches"], mono, lv_last = no_fallback(
        rk, "4", phase_main_path, nempc, rk, rg, card)
    bf16_cpu = lv_runs("bf16", moved_starts(x0s[:LSTM_N_CPU]), params)
    q_x0s, bwd["launches"], fwd["launches"] = no_fallback(
        rk, "4b", phase_quadrotor, nempc, rk, rg, card, pair_ms)
    eq_x0s, gbwd["launches"], gfwd["launches"] = no_fallback(
        rk, "4c", phase_fleet_eq, nempc, rk, rg, card, gpair_ms)
    gfused["launches"], gfused["closed_loop_launches"] = no_fallback(
        rk, "4d", phase_budget, nempc, rk, rg, card, params, x0s,
        gfused["call_ms"])
    (gd, rnn_params, z0s, rnn_bwd["launches"], rnn_fwd["launches"],
     rnn_split) = no_fallback(rk, "4e", phase_fleet_rnn, nempc, rk, rg,
                              card, rnn_pair_ms)
    cp_bwd["launches"], cp_fwd["launches"], cp_run = no_fallback(
        rk, "4f", phase_cartpole, nempc, rk, rg, card)
    (qm_model, qm_params, qm_x0s, bwd["quadrotor_mlp_launches"],
     qm_split, tanh_entries) = no_fallback(rk, "4g", phase_quadrotor_mlp,
                                           nempc, rk, rg, card)
    bwd["quadrotor_mlp_instance_launches"] = bwd["quadrotor_mlp_launches"]
    fwd["quadrotor_mlp_launches"] = bwd["quadrotor_mlp_launches"]
    w_x0s, w_bwd["launches"], w_fwd["launches"], w_split = no_fallback(
        rk, "4h", phase_fleet_wide, nempc, rk, rg, card, w_pair_ms)
    options = no_fallback(rk, "4i", phase_options, nempc, rk, rg, params,
                          x0s, mono)
    imported = no_fallback(rk, "4j", phase_import, nempc, rk, rg, params,
                           x0s, mono)
    # phases 4k-4n: the dense backend, ALM, the IFT backward, record
    dense = no_fallback(rk, "4k", phase_dense, nempc, rk, rg, card, params,
                        x0s, mono)
    alm = no_fallback(rk, "4l", phase_alm, nempc, rk, rg, card, params, x0s,
                      mono)
    diff = no_fallback(rk, "4m", phase_diff, nempc, rk, rg, card, params,
                       x0s)
    fused["ift_forward_launches"] = diff["forward_launches"]
    fused["ift_backward_launches"] = diff["backward_launches"]
    record = no_fallback(rk, "4n", phase_record, nempc, rk, rg, card,
                         params, x0s)
    # phases 4o-4r: the parallel-in-time sweep, the long-horizon fleet, the
    # horizon-sharded sweep and solve, scenario sharding
    pscan = no_fallback(rk, "4o", phase_pscan_sweep, rk, rg, card)
    long_horizon, *pscan_run = no_fallback(rk, "4p", phase_long_horizon,
                                           nempc, rk, rg, card)
    fused["long_horizon_launches"] = long_horizon["riccati"]["fused_launches"]
    horizon = no_fallback(rk, "4q", phase_horizon, nempc, rk, rg, card,
                          *pscan_run, pscan["pscan_call_ms"])
    scenario = no_fallback(rk, "4r", phase_scenario, nempc, rk, rg, card,
                           params, x0s)
    # phases 4s-4v: the stacked-LSTM fleet through the plain fallback, the
    # LSTM fleet through the backward instance at (18, 1), bf16, config 1
    # and batch_chunk
    lstm_bwd, lstm_fwd, lstm = phase_lstm(nempc, rk, rg, card, lstm_cpu,
                                          logs[rk.STREAMED_SOURCE])
    stacked = phase_stacked_lstm(nempc, rk, rg, card, lstm_cpu)
    bf16 = no_fallback(rk, "4u", phase_bf16, nempc, rk, rg, card, params,
                       x0s, mono, bf16_cpu)
    config1, prof = no_fallback(rk, "4v", phase_config1_chunk, nempc, rk, rg,
                                card, params, lv_last)

    # phase 5: card vs CPU (the profiling CLI runs meanwhile); the CPU
    # halves that need nothing the card computes go to the workers first
    n = N_CARD_VS_CPU
    examples = example_runs({"quadrotor": q_x0s[:n], "fleet_eq": eq_x0s[:n],
                             "cartpole_first": None, "cartpole_near": None,
                             "multi_start": None, "wide": w_x0s[:n]})
    no_fallback(rk, "5", phase_card_vs_cpu, params, x0s, examples)
    no_fallback(rk, "5 new paths", phase_card_vs_cpu_new, gd, rnn_params,
                z0s, qm_model, qm_params, qm_x0s, examples)
    no_fallback(rk, "5 wide, options", phase_card_vs_cpu_wide_options,
                params, x0s, examples)
    finish_profiling(prof, config1)
    log(f"paths: GRU fleet {json.dumps(rnn_split)}; cartpole "
        f"{json.dumps(cp_run)}; quadrotor MLP {json.dumps(qm_split)}; wide "
        f"fleet {json.dumps(w_split)}; solver options "
        f"{json.dumps(options)}; import {json.dumps(imported)}; dense "
        f"{json.dumps(dense)}; ALM {json.dumps(alm)}; differentiable "
        f"{json.dumps(diff)}; record {json.dumps(record)}; pscan sweep "
        f"{json.dumps(pscan)}; long horizon {json.dumps(long_horizon)}; "
        f"horizon mesh {json.dumps(horizon)}; scenario sharding "
        f"{json.dumps(scenario)}")

    for tag, phase in (("4s", stacked), ("4t", lstm), ("4u", bf16),
                       ("4v", config1)):
        print(json.dumps({"phase": tag, **phase}))
    print(json.dumps({"kernels": [fused, bwd, fwd, gbwd, gfwd, gfused,
                                  rnn_bwd, rnn_fwd, cp_bwd, cp_fwd, w_bwd,
                                  w_fwd, lstm_bwd, lstm_fwd, qg_bwd,
                                  qg_fwd, *tanh_entries]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
