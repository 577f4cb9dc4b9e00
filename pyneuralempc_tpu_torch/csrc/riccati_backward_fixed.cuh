// The compile-time streamed Riccati backward kernel for Hopper (sm_90a),
// shared by csrc/riccati_streamed.cu (the plain sweep: R = 1 right-hand
// side, r = 0 equality rows) and csrc/riccati_general.cu (R right-hand
// sides, r stage equality rows).  Each source instantiates it for the
// shapes listed at its C backward entry and keeps its own run-time kernel
// for every other shape.
//
// riccati_general_backward_fixed<NX, NU, R, RE> computes what
// riccati_general.cu's run-time riccati_general_backward_kernel computes,
// for one (nx, nu, R, r) fixed at compile time; at R = 1, RE = 0 that is
// riccati_streamed.cu's riccati_backward_kernel (the same inputs, mx and c
// with one right-hand side, and the same gains layout [K | k | Pbar | pbar |
// Mxu]; E, F, h and dc are then not read).  It replaces
// pyneuralempc_tpu/ops/pallas/riccati_kernel.py's streamed backward calls,
// :468 (`_backward_kernel` :191-302) at (12, 4, 1, 0), (10, 1, 1, 0),
// (4, 1, 1, 0), (12, 10, 1, 0) and (18, 1, 1, 0), and :991
// (`_bwd_general_body` :610-787) at (12, 4, 2, 1), with the local-delta
// Cholesky retry of `_chol_solve_retry` :158-188 (`_chol_factor_tiles`
// :120).
//
// What bounds it on an H100: bytes, ~183 us at (12, 4, 1, 0), ~202 us at
// (12, 4, 2, 1) and ~296 us at (12, 10, 1, 0) for B=4096, H=50, ~557 us
// at (18, 1, 1, 0) for B=4096, H=100 (ops/cuda/riccati_kernel.py's
// backward_bytes counts them).  At (18, 1) the stage math weighs the most
// of any instance (6.4 flops a byte against 3.7 at (10, 1), still under
// the card's f32 ridge): what holds it back from its bound there is the
// instructions the two O(nx^3) products issue and how many lanes share
// them (the tiles below).
// One warp per problem and the gains layout of riccati_general.cu.  The
// design against the run-time kernels' ~20 dependent phases a stage:
//  * every lane's entries of every product are fixed at compile time and
//    the loops unroll; a lane keeps the operands it reuses (a row of Pbar,
//    a column of B and of Mxu, a column of A, its substitution column) in
//    registers across the products of a stage;
//  * G and M stay upper triangles, packed row by row (ns(ns+1)/2 floats
//    each), read in place with delta added on M's diagonal where it is
//    read; there is no symmetrising pass;
//  * the stage's right operands sit side by side, X = [A | c^T | B]
//    (nx x (nx + R + nu)), so one product gives Y = Pbar X = [PA | Pc_p |
//    PB + Mxu] and a second Z = B^T Y + Mxu^T X = [Qux | qu^T | Quu - Muu -
//    Guu, before symmetrising]; the substitutions give W = [K | k^T |
//    Quu^-1 E^T] and the Schur step Nu = [Knu | knu^T]; the last product
//    is P_new and p together, X^T Y + Z^T W + F^T Nu (+ G);
//  * Quu's factor and its retry (and S's) run on every lane from
//    registers, so no lane waits on lane 0: five __syncwarp() a stage
//    (four at r = 0).  Past nu = 4 a copy of Quu and its factor on every
//    lane would not fit 64 registers, so lane j < nu holds row j of Quu,
//    takes pivot j and hands it and row j of the factor to the others by
//    __shfl_sync (each pivot seen by all, so each delta level passes or
//    fails on every lane alike), in _chol_factor_tiles' order of terms;
//    the factor goes to P_new's room in shared memory (read and rewritten
//    around it), and the substitutions read it by broadcast: one
//    __syncwarp() more;
//  * the lane maps take any nu <= 32: 32/nu lanes a row of Z, each a
//    float4 column and every 32/nu-th after it (at (12, 10): 3 lanes, 2
//    columns each, 30 lanes working);
//  * past nx = 16 (FixedLayout::kTall, up to nx = 32) two lanes a row of Y
//    and of [P_new | p^T] would take more than 32 lanes; there lane l
//    takes the float4 column l % YC of the rows l / YC + j * (32 / YC)
//    (at (18, 1): 5 columns, 3 rows a lane, 30 lanes working), so each
//    16-byte load of X or Y feeds 3 rows' 12 sums and the scalar operand
//    (Pbar's, A's entry) is one broadcast load a row; Pbar = sym(P_new) +
//    Mxx + delta I is formed in place of P_new first, each entry pair
//    (i, j), (j, i) by one lane, and written to the gains from there in
//    row order: one __syncwarp() more.  Against one lane a row (18 lanes,
//    the row of Pbar or A's column in registers) it measured 1224.42
//    against 1842.30 us at (18, 1, 1, 0), B=4096, H=100 on an H100, with
//    no spills where one lane a row spilled 54 bytes a thread
//    (chip_backward_designs.py 18 1, PERF.md);
//  * past nu = 4 or nx = 16 (FixedLayout::kLarge) the lane id is read anew
//    each stage,
//    so the compiler recomputes each lane's offsets where they are used
//    instead of keeping them across the stage loop: with the shared memory
//    carveout at its largest an SM keeps ~28 KB of L1, and the ~330 bytes
//    a thread that spilled at (12, 10, 1, 0) went to L2; the upper
//    triangles' copies pair row p with row ns - 1 - p, so each copy slot of
//    a lane is used.  Each measured faster on an H100 than the design
//    without it, in turns (chip_backward_designs.py, PERF.md); a Z lane's
//    columns rolled into a loop measured faster too, but the loop's form
//    changed the code of the (12, 4, 2, 1) instance, so they stay unrolled;
//  * the rows of X, Y, Z (and W, Nu) are padded to whole float4s and each
//    lane's output columns of Y, Z and [P_new | p^T] are runs of float4
//    columns, read with 16-byte shared-memory loads: about half the load
//    instructions of one column a lane, which measured 17.6% and 17.8%
//    faster at (12, 4, 1, 0) and (12, 4, 2, 1) on an H100 (509.56 against
//    618.52 us and 600.30 against 730.09 us, one chip_smoke.py run each in
//    one call), the sums unchanged term for term;
//  * a stage is loaded with 4-byte cp.async copies (4 bytes because h's
//    rows are 8-byte aligned only and the triangles' rows start anywhere;
//    each lane issues ~17 a stage, little next to its stage math) into one
//    of two stage buffers in turn, and waited on at once (into one buffer,
//    after a __syncwarp(), where two would not leave room for 8 blocks an
//    SM).  Keeping stage
//    t-1's copies in flight during stage t measured slower on an H100
//    (861.78 against 735.25 us at (12, 4, 2, 1) in one chip_smoke.py run):
//    the 32 resident warps an SM already hide the loads' latency, and the
//    in-flight form spilled 42 more bytes a thread.  For cartpole's one
//    warp alone on an SM, at (4, 1, 1, 0), it timed the same warm and won
//    only with the L2 flushed, which that path's stage inputs, written
//    just before the sweep, are not (PERF.md).
// Shared memory a warp (FixedLayout::kFloats): at (12, 4, 2, 1) two
// 564-float stage buffers (562 floats used) and 580 floats of scratch,
// 6,832 bytes; at (12, 4, 1, 0) two 528-float stage buffers and 552 floats
// of scratch, 6,432 bytes; 3,184 bytes at (10, 1, 1, 0) and 832 at
// (4, 1, 1, 0); at (12, 10, 1, 0) one 816-float stage buffer and 856
// floats of scratch, 6,688 bytes (two buffers, 9,952 bytes, would fit 5
// blocks an SM: B=4096 in two waves, slower in turns, as a register cap
// set for 7 blocks is); at (18, 1, 1, 0) one 760-float stage buffer (759
// used) and 764 floats of scratch, 6,096 bytes (two buffers, 9,136 bytes,
// would fit 6 blocks an SM; a register cap set for 7 blocks, B=4096 in two
// waves, measured 3.3% slower); at (28, 4, 1, 0) one 2,096-float stage
// buffer (X 28 x 36, G and M 528 each, mx 28, mu 4) and 2,120 floats of
// scratch (P_new 28 x 29 = 812, p 28, Y 1,008, Z 144, W 128), 16,864
// bytes, so 3 blocks of 4 warps an SM (B=4096 in 2.6 waves on 132 SMs).
// Every other way 8 blocks of 4 warps (B=4096 in one wave on 132 SMs) fit
// in 228 KB with the 64-register cap.  ptxas: 64
// registers and 96 bytes of spill stores and loads a thread at
// (12, 4, 2, 1), 92 at (12, 4, 1, 0), 54 stores and 80 loads at
// (12, 10, 1, 0), 20 at (10, 1, 1, 0), none at (4, 1, 1, 0) and
// (18, 1, 1, 0) (chip_smoke.py prints every instance's report).

#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Problems (warps) a block: what the plain run-time kernels always take and
// the most the general ones take.
constexpr int kMaxWarps = 4;
constexpr int kMinBlocks = 8;        // resident blocks an SM (backward)
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kSmemPerSM = 228 * 1024;   // an H100 SM's shared memory
constexpr int kBlockReserve = 1024;      // the runtime's reserve a block

// _LOCAL_DELTAS = (0, 1e-6, 1e-4): nudge-scale bumps on the diagonal.
__device__ __forceinline__ float local_delta(int level) {
  return level == 0 ? 0.0f : (level == 1 ? 1e-6f : 1e-4f);
}

template <int N>
__host__ __device__ constexpr int tri(int i, int j) {  // i <= j
  return i * N - (i * (i - 1)) / 2 + (j - i);
}

template <int N>
__device__ __forceinline__ float sym_at(const float* t, int i, int j) {
  return i <= j ? t[tri<N>(i, j)] : t[tri<N>(j, i)];
}

// One 16-byte shared-memory load or store of four floats (16-byte aligned).
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__host__ __device__ constexpr int up4(int n) { return (n + 3) & ~3; }

// Whether kMinBlocks blocks of kMaxWarps warps, each warp `floats` floats
// of shared memory, fit an SM.
__host__ __device__ constexpr bool smem_fits(int floats) {
  return kMinBlocks * (4 * kMaxWarps * floats + kBlockReserve) <= kSmemPerSM;
}

template <int NX, int NU, int R, int RE>
struct FixedLayout {
  static constexpr int NS = NX + NU, NT = NS * (NS + 1) / 2;
  static constexpr int NC = NX + R;        // value columns: P's and the p's
  static constexpr int NW = NC + NU;       // X, Y, Z columns
  static constexpr int NQ = NC + RE;       // substitution columns
  // Row strides in whole float4s: X, Y and Z rows NWP floats apart, W rows
  // NQP, Nu rows NCP; the pad columns only ever feed pad columns.
  static constexpr int NWP = up4(NW), NQP = up4(NQ), NCP = up4(NC);
  static constexpr int PS = NX + 1;        // P_new row stride (no conflicts)
  // one stage buffer
  static constexpr int oX = 0, oG = oX + NX * NWP, oM = oG + NT;
  static constexpr int omx = oM + NT, omu = omx + R * NX;
  static constexpr int oE = omu + R * NU, oF = oE + RE * NU;
  static constexpr int oh = oF + RE * NX, kStage = oh + R * RE;
  static constexpr int kStagePad = up4(kStage);
  // the scratch after the stage buffers
  static constexpr int kScratch = up4(NX * PS) + up4(R * NX) + NX * NWP +
                                  NU * NWP + NU * NQP + RE * NCP;
  // Two stage buffers in turn where kMinBlocks blocks of kMaxWarps warps
  // still fit an SM with them, else one
  static constexpr int kBuffers = smem_fits(2 * kStagePad + kScratch) ? 2 : 1;
  // scratch after the stage buffers, each array 16-byte aligned
  static constexpr int oPn = kBuffers * kStagePad, op = oPn + up4(NX * PS);
  static constexpr int oY = op + up4(R * NX), oZ = oY + NX * NWP;
  static constexpr int oW = oZ + NU * NWP, oNu = oW + NU * NQP;
  static constexpr int kFloats = oNu + RE * NCP;
  // gains
  static constexpr int gK = 0, gk = NX * NU, gPb = gk + R * NU;
  static constexpr int gpb = gPb + NX * NX, gMxu = gpb + R * NX;
  static constexpr int gKnu = gMxu + NX * NU, gknu = gKnu + RE * NX;
  static constexpr int NG = gknu + R * RE;
  // Past nx = 16 two lanes a row of Y and of [P_new | p^T] would take more
  // than 32 lanes.  There (kTiles) lane l takes float4 column l % YC (of a
  // [P_new | p^T] row: l % PC) of the rows l / YC, l / YC + YG, ..., each
  // operand float4 loaded once for its rows, Pbar formed in place of P_new
  // first; without kTiles one lane takes a row (kRowLanes).
  static constexpr bool kTall = NX > 16;
  static constexpr bool kTiles = kTall;
  static constexpr int kRowLanes = kTall ? 1 : 2;
  // lane maps (fixed at compile time), in float4 columns
  static constexpr int YC = NWP / 4;       // of a Y (and a Z) row
  // of them, a row's first lane's
  static constexpr int Y0 = (YC + kRowLanes - 1) / kRowLanes;
  static constexpr int LZ = 32 / NU;       // lanes per Z row
  static constexpr int ZC = (YC + LZ - 1) / LZ;  // of a Z row, a lane's
  static constexpr int PC = NCP / 4;       // of a [P_new | p^T] row
  static constexpr int P0 = (PC + kRowLanes - 1) / kRowLanes;
  // tiles: the lanes a float4 column of Y (of [P_new | p^T]) takes, and the
  // rows each of them takes
  static constexpr int YG = 32 / YC, YR = (NX + YG - 1) / YG;
  static constexpr int PG = 32 / PC, PR = (NX + PG - 1) / PG;
  static constexpr int NTX = NX * (NX + 1) / 2;  // Pbar's upper triangle
  // Past nu = 4 a copy of Quu, its factor and 1/diag on every lane (2 nu
  // (nu + 1) floats, 40 at nu = 4) would not fit beside the rest in 64
  // registers: Quu is factored one row a lane, the factor in P_new's room.
  // Those instances and the tall ones (kLarge) read the lane id anew each
  // stage (lane_id), so the lane's offsets are recomputed where used and
  // not kept, and spilled, across the stage loop, and fold the triangles'
  // copies (rows p and ns - 1 - p together, ns + 1 floats) so that no copy
  // slot goes unused; each measured faster at (12, 10, 1, 0) on an H100
  // (PERF.md).
  static constexpr bool kWide = NU > 4;
  static constexpr bool kLarge = kWide || kTall;
  static_assert(kRowLanes * NX <= 32 && NQ <= 32 && NU <= 32 && RE <= NU,
                "lane maps need nx <= 32 (2 nx <= 32 up to nx = 16), "
                "nx + R + r <= 32 and nu <= 32");
  static_assert(!kWide || NU * NU <= oY - oPn,
                "the row factor (nu x nu) lives where P_new and p do");
};

// Stage t's inputs into a stage buffer, one 4-byte cp.async each (not
// waited on here), A, c and B side by side as X = [A | c^T | B].
template <int NX, int NU, int R, int RE>
__device__ __forceinline__ void fixed_load_stage(
    float* __restrict__ buf, const float* __restrict__ A,
    const float* __restrict__ Bm, const float* __restrict__ G,
    const float* __restrict__ M, const float* __restrict__ mx,
    const float* __restrict__ mu, const float* __restrict__ c,
    const float* __restrict__ E, const float* __restrict__ F,
    const float* __restrict__ h, size_t st, int lane) {
  using L = FixedLayout<NX, NU, R, RE>;
  constexpr int NS = L::NS, NWP = L::NWP;
#pragma unroll
  for (int q = 0; q < (NX * NX + 31) / 32; ++q) {    // A[k][j] -> X[k][j]
    const int e = q * 32 + lane, k = e / NX, j = e - k * NX;
    if (e < NX * NX)
      __pipeline_memcpy_async(buf + L::oX + k * NWP + j,
                              A + st * NX * NX + e, 4);
  }
#pragma unroll
  for (int q = 0; q < (R * NX + 31) / 32; ++q) {     // c[ri][k] -> X[k][NX+ri]
    const int e = q * 32 + lane, ri = e / NX, k = e - ri * NX;
    if (e < R * NX)
      __pipeline_memcpy_async(buf + L::oX + k * NWP + NX + ri,
                              c + st * R * NX + e, 4);
  }
#pragma unroll
  for (int q = 0; q < (NX * NU + 31) / 32; ++q) {    // B[k][al] -> X[k][NC+al]
    const int e = q * 32 + lane, k = e / NU, al = e - k * NU;
    if (e < NX * NU)
      __pipeline_memcpy_async(buf + L::oX + k * NWP + L::NC + al,
                              Bm + st * NX * NU + e, 4);
  }
  if constexpr (L::kLarge) {
#pragma unroll
    for (int q = 0; q < (L::NT + 31) / 32; ++q) {  // upper triangles, folded
      const int e = q * 32 + lane, p = e / (NS + 1), r = e - p * (NS + 1);
      const bool top = r < NS - p;
      const int i = top ? p : NS - 1 - p;
      const int j = top ? p + r : i + r - (NS - p);
      if (e < L::NT) {
        __pipeline_memcpy_async(buf + L::oG + tri<NS>(i, j),
                                G + st * NS * NS + i * NS + j, 4);
        __pipeline_memcpy_async(buf + L::oM + tri<NS>(i, j),
                                M + st * NS * NS + i * NS + j, 4);
      }
    }
  } else {
#pragma unroll
    for (int q = 0; q < (NS * NS + 31) / 32; ++q) {    // upper triangles
      const int e = q * 32 + lane, i = e / NS, j = e - i * NS;
      if (e < NS * NS && i <= j) {
        __pipeline_memcpy_async(buf + L::oG + tri<NS>(i, j),
                                G + st * NS * NS + e, 4);
        __pipeline_memcpy_async(buf + L::oM + tri<NS>(i, j),
                                M + st * NS * NS + e, 4);
      }
    }
  }
  constexpr int nrest = R * NX + R * NU + RE * NU + RE * NX + R * RE;
#pragma unroll
  for (int q = 0; q < (nrest + 31) / 32; ++q) {      // mx, mu, E, F, h
    int e = q * 32 + lane;
    if (e >= nrest) continue;
    const float* src;
    if (e < R * NX) {
      src = mx + st * R * NX + e;
    } else if ((e -= R * NX) < R * NU) {
      src = mu + st * R * NU + e;
    } else if ((e -= R * NU) < RE * NU) {
      src = E + st * RE * NU + e;
    } else if ((e -= RE * NU) < RE * NX) {
      src = F + st * RE * NX + e;
    } else {
      e -= RE * NX;
      src = h + st * R * RE + e;
    }
    __pipeline_memcpy_async(buf + L::omx + q * 32 + lane, src, 4);
  }
}

// Cholesky of Q + d*I (N x N, lower triangle of Q read) in registers, as
// chol_factor does it.
template <int N>
__device__ __forceinline__ bool chol_regs(const float (&Q)[N][N], float d,
                                          float (&L)[N][N], float (&inv)[N]) {
  bool ok = true;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float s = Q[i][i] + d;
#pragma unroll
    for (int q = 0; q < i; ++q) s -= L[i][q] * L[i][q];
    const bool good = s > 1e-12f;
    ok = ok && good;
    const float li = sqrtf(good ? s : 1.0f);
    L[i][i] = li;
    inv[i] = 1.0f / li;
#pragma unroll
    for (int j = i + 1; j < N; ++j) {
      float v = Q[j][i];
#pragma unroll
      for (int q = 0; q < i; ++q) v -= L[j][q] * L[i][q];
      L[j][i] = v * inv[i];
    }
  }
  return ok;
}

// chol_retry in registers: every lane holds the same Q, so the branches
// are uniform across the warp.
template <int N>
__device__ __forceinline__ bool chol_retry_regs(const float (&Q)[N][N],
                                                float (&L)[N][N],
                                                float (&inv)[N]) {
  bool ok = false;
#pragma unroll
  for (int level = 0; level < 3; ++level)
    if (!ok) ok = chol_regs<N>(Q, local_delta(level), L, inv);
  if (!ok) chol_regs<N>(Q, 0.0f, L, inv);
  return ok;
}

template <int N>
__device__ __forceinline__ void chol_solve_regs(const float (&L)[N][N],
                                                const float (&inv)[N],
                                                float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float v = x[i];
#pragma unroll
    for (int q = 0; q < i; ++q) v -= L[i][q] * x[q];
    x[i] = v * inv[i];
  }
#pragma unroll
  for (int i = N - 1; i >= 0; --i) {
    float v = x[i];
#pragma unroll
    for (int q = i + 1; q < N; ++q) v -= L[q][i] * x[q];
    x[i] = v * inv[i];
  }
}

// Cholesky of Q + d*I one row a lane: lane j < N holds row j of Q (Qrow[e]
// = Q[j][e], e <= j) and builds row j of L; pivot i is taken on lane i and
// handed to every lane with row i of L by __shfl_sync, each term in
// chol_regs' order.  Every lane sees every pivot, so the return value
// (whether every pivot passed) is the same on all.  inv_own: lane j's
// 1/L[j][j].
template <int N>
__device__ __forceinline__ bool chol_rows(const float (&Qrow)[N], float d,
                                          int lane, float (&Lrow)[N],
                                          float& inv_own) {
  bool ok = true;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float v = lane == i ? Qrow[i] + d : Qrow[i];
#pragma unroll
    for (int q = 0; q < i; ++q)
      v -= Lrow[q] * __shfl_sync(0xffffffffu, Lrow[q], i);
    const float s = __shfl_sync(0xffffffffu, v, i);
    const bool good = s > 1e-12f;
    ok = ok && good;
    const float li = sqrtf(good ? s : 1.0f);
    const float inv = 1.0f / li;
    if (lane == i) inv_own = inv;
    Lrow[i] = lane > i ? v * inv : 0.0f;
  }
  return ok;
}

// chol_retry by rows: the first of the local deltas whose factor passes,
// else a fourth pass at delta = 0 (which fails again, as at the first
// level).  The loop's exit is the same on every lane.  Lane j < N writes row
// j of the factor to sL (rows N apart), 1/L[j][j] on the diagonal.
template <int N>
__device__ __forceinline__ bool chol_retry_rows(const float (&Qrow)[N],
                                                int lane,
                                                float* __restrict__ sL) {
  float Lrow[N], inv_own = 1.0f;
  bool ok = false;
#pragma unroll 1
  for (int level = 0; level < 4; ++level) {
    ok = chol_rows<N>(Qrow, level < 3 ? local_delta(level) : 0.0f, lane,
                      Lrow, inv_own);
    if (ok) break;
  }
  if (lane < N) {
#pragma unroll
    for (int q = 0; q < N; ++q)
      sL[lane * N + q] = q == lane ? inv_own : Lrow[q];
  }
  return ok;
}

// chol_solve_regs on chol_retry_rows' factor in shared memory, every lane
// reading the same entry at once (a broadcast).
template <int N>
__device__ __forceinline__ void chol_solve_rows(const float* __restrict__ sL,
                                                float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float v = x[i];
#pragma unroll
    for (int q = 0; q < i; ++q) v -= sL[i * N + q] * x[q];
    x[i] = v * sL[i * N + i];
  }
#pragma unroll
  for (int i = N - 1; i >= 0; --i) {
    float v = x[i];
#pragma unroll
    for (int q = i + 1; q < N; ++q) v -= sL[q * N + i] * x[q];
    x[i] = v * sL[i * N + i];
  }
}

// The lane's id, read in a way the compiler may not hoist out of a loop.
__device__ __forceinline__ int lane_id() {
  int l;
  asm volatile("mov.u32 %0, %%laneid;" : "=r"(l));
  return l;
}

// At most 64 registers a thread, as the run-time kernels, so kMinBlocks
// blocks of kMaxWarps warps fit an SM at once.
template <int NX, int NU, int R, int RE>
__global__ void __launch_bounds__(kMaxWarps * 32, kMinBlocks)
riccati_general_backward_fixed(
    const float* __restrict__ A, const float* __restrict__ Bm,
    const float* __restrict__ G, const float* __restrict__ M,
    const float* __restrict__ mx, const float* __restrict__ mu,
    const float* __restrict__ c, const float* __restrict__ delta,
    const float* __restrict__ dc, const float* __restrict__ E,
    const float* __restrict__ F, const float* __restrict__ h,
    float* __restrict__ gains, uint8_t* __restrict__ ok_out, int nbatch,
    int H) {
  using L = FixedLayout<NX, NU, R, RE>;
  constexpr int NS = L::NS, NW = L::NW, NC = L::NC, NQ = L::NQ;
  constexpr int NWP = L::NWP, NQP = L::NQP, NCP = L::NCP, PS = L::PS;
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane0 = threadIdx.x & 31;
  const int b = blockIdx.x * (blockDim.x >> 5) + warp;
  if (b >= nbatch) return;  // the whole warp leaves; no block barrier used
  float* s = smem + warp * L::kFloats;
  float* sPn = s + L::oPn;  // P_new (NX, NX), rows PS apart; P = sym(P_new)
  float* sp = s + L::op;    // p (R, NX)
  float* sY = s + L::oY;    // Y = Pbar X + [0 | pbar^T | Mxu]  (NX, NWP)
  float* sZ = s + L::oZ;    // Z = B^T Y + Mxu^T X + [Gux | mu | 0] (NU, NWP)
  float* sW = s + L::oW;    // W = [K | k^T | Quu^-1 E^T]  (NU, NQP)
  float* sNu = s + L::oNu;  // Nu = [Knu | knu^T]  (RE, NCP)

  const float d = delta[b];
  const float dcb = RE > 0 ? dc[b] : 0.0f;
  // P = 0 and p = 0 after the last stage, and every pad column finite
  for (int e = lane0; e < L::kFloats; e += 32) s[e] = 0.0f;
  __syncwarp();  // the zeros land before any lane's copies
  bool ok = true;  // the same on every lane
  const size_t b0 = static_cast<size_t>(b) * H;

  for (int t = H - 1; t >= 0; --t) {
    const int lane = L::kLarge ? lane_id() : lane0;
    const size_t st = b0 + t;
    // Two stage buffers in turn: the one written here was last read two
    // stages ago, before the barriers of the stage between, so no barrier
    // is needed before the copies.  One buffer: the last stage's reads of
    // it end at a barrier first.  The barrier after the wait makes every
    // lane's copies (and the last stage's P_new and p) visible to all.
    if constexpr (L::kBuffers == 1) __syncwarp();
    float* cur = L::kBuffers == 1 ? s : s + (t & 1) * L::kStagePad;
    fixed_load_stage<NX, NU, R, RE>(cur, A, Bm, G, M, mx, mu, c, E, F, h, st,
                                    lane);
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncwarp();
    const float* sX = cur + L::oX;  // [A | c^T | B]  (NX, NWP)
    const float* sG = cur + L::oG;  // upper triangle
    const float* sM = cur + L::oM;  // upper triangle, delta not added
    const float* smx = cur + L::omx;
    const float* smu = cur + L::omu;
    const float* sE = cur + L::oE;
    const float* sF = cur + L::oF;
    const float* sh = cur + L::oh;
    float* gn = gains + st * L::NG;

    // ---- Y = Pbar [A | c^T | B] + [0 | pbar^T | Mxu]: two lanes a row
    //      (kRowLanes; one past nx = 16), each a run of float4 columns, the
    //      row of Pbar = sym(P_new) + Mxx + delta I in registers; or tiles
    //      (kTiles), Pbar formed in place of P_new first ----
    if constexpr (L::kTiles) {
      // one entry of Pbar's upper triangle a lane and its mirror (rows p
      // and nx - 1 - p folded, nx + 1 entries), each pair read and written
      // by one lane; then the gains' Pbar, row by row
#pragma unroll
      for (int q = 0; q < (L::NTX + 31) / 32; ++q) {
        const int e = q * 32 + lane, p = e / (NX + 1), r = e - p * (NX + 1);
        const bool top = r < NX - p;
        const int i = top ? p : NX - 1 - p;
        const int k = top ? p + r : i + r - (NX - p);
        if (e < L::NTX) {
          const float m = sM[tri<NS>(i, k)] + (i == k ? d : 0.0f);
          const float v = 0.5f * (sPn[i * PS + k] + sPn[k * PS + i]) + m;
          sPn[i * PS + k] = v;
          sPn[k * PS + i] = v;
        }
      }
      __syncwarp();
#pragma unroll
      for (int q = 0; q < (NX * NX + 31) / 32; ++q) {
        const int e = q * 32 + lane, i = e / NX;
        if (e < NX * NX) gn[L::gPb + e] = sPn[i * PS + e - i * NX];
      }
      // lane l: float4 column l % YC of the rows l / YC + j YG, j < YR (a
      // row past nx - 1 reads row nx - 1 and is not stored)
      const int ch = lane % L::YC, g = lane / L::YC;
      if (g < L::YG) {
        int rows[L::YR];
#pragma unroll
        for (int j = 0; j < L::YR; ++j) rows[j] = min(g + j * L::YG, NX - 1);
        float v[L::YR][4] = {};
#pragma unroll
        for (int k = 0; k < NX; ++k) {
          const float4 x = ld4(sX + k * NWP + 4 * ch);
#pragma unroll
          for (int j = 0; j < L::YR; ++j) {
            const float pk = sPn[rows[j] * PS + k];
            v[j][0] += pk * x.x;
            v[j][1] += pk * x.y;
            v[j][2] += pk * x.z;
            v[j][3] += pk * x.w;
          }
        }
#pragma unroll
        for (int j = 0; j < L::YR; ++j) {
          const int i = g + j * L::YG;
          if (i >= NX) continue;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int col = 4 * ch + q;
            if (col >= NX && col < NC) {       // Pc_p = c Pbar^T + pbar
              const int ri = col - NX;
              const float pb = sp[ri * NX + i] + smx[ri * NX + i];
              gn[L::gpb + ri * NX + i] = pb;
              v[j][q] += pb;
            } else if (col >= NC && col < NW) {  // PB + Mxu
              const int al = col - NC;
              const float mxu = sM[tri<NS>(i, NX + al)];
              gn[L::gMxu + i * NU + al] = mxu;
              v[j][q] += mxu;
            }
          }
          st4(sY + i * NWP + 4 * ch, v[j]);
        }
      }
    } else if (lane < L::kRowLanes * NX) {
      const bool first = lane < NX;
      const int i = first ? lane : lane - NX;
      const int ch0 = first ? 0 : L::Y0;
      float row[NX];
#pragma unroll
      for (int k = 0; k < NX; ++k) {
        const float m = sym_at<NS>(sM, i, k) + (i == k ? d : 0.0f);
        row[k] = 0.5f * (sPn[i * PS + k] + sPn[k * PS + i]) + m;
        if (L::kRowLanes == 1 || (k < NX / 2) == first)
          gn[L::gPb + i * NX + k] = row[k];
      }
#pragma unroll
      for (int o = 0; o < L::Y0; ++o) {
        const int ch = ch0 + o;
        if (ch >= L::YC) continue;
        float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int k = 0; k < NX; ++k) {
          const float4 x = ld4(sX + k * NWP + 4 * ch);
          v[0] += row[k] * x.x;
          v[1] += row[k] * x.y;
          v[2] += row[k] * x.z;
          v[3] += row[k] * x.w;
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int col = 4 * ch + q;
          if (col >= NX && col < NC) {       // Pc_p = c Pbar^T + pbar
            const int ri = col - NX;
            const float pb = sp[ri * NX + i] + smx[ri * NX + i];
            gn[L::gpb + ri * NX + i] = pb;
            v[q] += pb;
          } else if (col >= NC && col < NW) {  // PB + Mxu
            const int al = col - NC;
            const float mxu = sM[tri<NS>(i, NX + al)];
            gn[L::gMxu + i * NU + al] = mxu;
            v[q] += mxu;
          }
        }
        st4(sY + i * NWP + 4 * ch, v);
      }
    }
    __syncwarp();

    // ---- Z = B^T Y + Mxu^T X + [Gux | mu | 0] = [Qux | qu^T | B^T PB +
    //      B^T Mxu + Mxu^T B]: 32/NU lanes a row (the last 32 mod NU lanes
    //      idle), each the float4 columns m, m + 32/NU, ..., B's and Mxu's
    //      column in registers ----
    {
      const int al = lane / L::LZ, m = lane - al * L::LZ;
      if ((32 % NU == 0 || al < NU) && m < L::YC) {
        float bcol[NX], mcol[NX];
#pragma unroll
        for (int k = 0; k < NX; ++k) {
          bcol[k] = sX[k * NWP + NC + al];
          mcol[k] = sM[tri<NS>(k, NX + al)];
        }
#pragma unroll
        for (int o = 0; o < L::ZC; ++o) {
          const int ch = m + o * L::LZ;
          if (o > 0 && ch >= L::YC) continue;
          float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          float w[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
          for (int k = 0; k < NX; ++k) {
            const float4 y = ld4(sY + k * NWP + 4 * ch);
            const float4 x = ld4(sX + k * NWP + 4 * ch);
            v[0] += bcol[k] * y.x;
            v[1] += bcol[k] * y.y;
            v[2] += bcol[k] * y.z;
            v[3] += bcol[k] * y.w;
            w[0] += mcol[k] * x.x;
            w[1] += mcol[k] * x.y;
            w[2] += mcol[k] * x.z;
            w[3] += mcol[k] * x.w;
          }
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int col = 4 * ch + q;
            v[q] += w[q];
            if (col < NX)
              v[q] += sG[tri<NS>(col, NX + al)];
            else if (col < NC)
              v[q] += smu[(col - NX) * NU + al];
          }
          st4(sZ + al * NWP + 4 * ch, v);
        }
      }
    }
    __syncwarp();

    // ---- Quu = sym(Z's last NU columns) + Muu + delta I + Guu, factored
    //      with the local-delta retry on every lane (or one row a lane, the
    //      factor in P_new's room, which the Y phase has read and the last
    //      phase rewrites); one substitution column a lane: K = -Quu^-1 Qux,
    //      k = -Quu^-1 qu, Y = Quu^-1 E^T ----
    float Lq[NU][NU], iq[NU], x[NU];   // Lq, iq: the register factor's
    if constexpr (L::kWide) {
      float Qrow[NU];
#pragma unroll
      for (int e = 0; e < NU; ++e) {
        const int a = lane;
        Qrow[e] = 0.0f;
        if (a < NU && e <= a)
          Qrow[e] = 0.5f * (sZ[a * NWP + NC + e] + sZ[e * NWP + NC + a])
                    + (sM[tri<NS>(NX + e, NX + a)] + (a == e ? d : 0.0f))
                    + sG[tri<NS>(NX + e, NX + a)];
      }
      ok = chol_retry_rows<NU>(Qrow, lane, sPn) && ok;
      __syncwarp();   // every row of the factor lands before it is read
    } else {
      float Q[NU][NU];
#pragma unroll
      for (int a = 0; a < NU; ++a)
#pragma unroll
        for (int e = 0; e <= a; ++e) {
          Q[a][e] = 0.5f * (sZ[a * NWP + NC + e] + sZ[e * NWP + NC + a])
                    + (sM[tri<NS>(NX + e, NX + a)] + (a == e ? d : 0.0f))
                    + sG[tri<NS>(NX + e, NX + a)];
          Q[e][a] = Q[a][e];
        }
      ok = chol_retry_regs<NU>(Q, Lq, iq) && ok;
    }
#pragma unroll
    for (int al = 0; al < NU; ++al) {
      float v = 0.0f;
      if (lane < NC)
        v = -sZ[al * NWP + lane];
      else if (lane < NQ)
        v = sE[(lane - NC) * NU + al];
      x[al] = v;
    }
    if constexpr (L::kWide)
      chol_solve_rows<NU>(sPn, x);
    else
      chol_solve_regs<NU>(Lq, iq, x);
    if (lane < NQ) {
#pragma unroll
      for (int al = 0; al < NU; ++al) sW[al * NQP + lane] = x[al];
    }
    if constexpr (RE == 0) {
      if (lane < NX) {
#pragma unroll
        for (int al = 0; al < NU; ++al) gn[L::gK + al * NX + lane] = x[al];
      } else if (lane < NC) {
#pragma unroll
        for (int al = 0; al < NU; ++al)
          gn[L::gk + (lane - NX) * NU + al] = x[al];
      }
    }
    __syncwarp();

    if constexpr (RE > 0) {
      // ---- S = sym(E Y) + delta_c I, factored on every lane; one column a
      //      lane: Knu = S^-1 (E K + F), knu = S^-1 (E k - h), then
      //      K -= Y Knu, k -= Y knu ----
      float Ls[RE][RE], is[RE];
      {
        float S[RE][RE];
#pragma unroll
        for (int i = 0; i < RE; ++i)
#pragma unroll
          for (int j = 0; j <= i; ++j) {
            float v_ij = 0.0f, v_ji = 0.0f;
#pragma unroll
            for (int al = 0; al < NU; ++al) {
              v_ij += sE[i * NU + al] * sW[al * NQP + NC + j];
              v_ji += sE[j * NU + al] * sW[al * NQP + NC + i];
            }
            S[i][j] = 0.5f * (v_ij + v_ji) + (i == j ? dcb : 0.0f);
            S[j][i] = S[i][j];
          }
        ok = chol_retry_regs<RE>(S, Ls, is) && ok;
      }
      if (lane < NC) {
        float nu[RE];
#pragma unroll
        for (int q = 0; q < RE; ++q) {
          float v = 0.0f;
#pragma unroll
          for (int al = 0; al < NU; ++al) v += sE[q * NU + al] * x[al];
          nu[q] = v + (lane < NX ? sF[q * NX + lane]
                                 : -sh[(lane - NX) * RE + q]);
        }
        chol_solve_regs<RE>(Ls, is, nu);
#pragma unroll
        for (int al = 0; al < NU; ++al) {
          float v = 0.0f;
#pragma unroll
          for (int q = 0; q < RE; ++q) v += sW[al * NQP + NC + q] * nu[q];
          x[al] -= v;
          sW[al * NQP + lane] = x[al];
        }
#pragma unroll
        for (int q = 0; q < RE; ++q) sNu[q * NCP + lane] = nu[q];
        if (lane < NX) {
#pragma unroll
          for (int al = 0; al < NU; ++al) gn[L::gK + al * NX + lane] = x[al];
#pragma unroll
          for (int q = 0; q < RE; ++q) gn[L::gKnu + q * NX + lane] = nu[q];
        } else {
          const int ri = lane - NX;
#pragma unroll
          for (int al = 0; al < NU; ++al) gn[L::gk + ri * NU + al] = x[al];
#pragma unroll
          for (int q = 0; q < RE; ++q) gn[L::gknu + ri * RE + q] = nu[q];
        }
      }
      __syncwarp();
    }

    // ---- [P_new | p^T] = A^T [PA | Pc_p^T] + Qux^T [K | k^T]
    //      + F^T [Knu | knu^T] + [Gxx | 0]: two lanes a row (kRowLanes),
    //      each a run of float4 columns, A's, Qux's and F's column in
    //      registers, or tiles (kTiles) as Y's; P_new is symmetrised where
    //      the next stage reads it ----
    if constexpr (L::kTiles) {
      const int ch = lane % L::PC, g = lane / L::PC;
      if (g < L::PG) {
        int rows[L::PR];
#pragma unroll
        for (int j = 0; j < L::PR; ++j) rows[j] = min(g + j * L::PG, NX - 1);
        float v[L::PR][4] = {}, w[L::PR][4] = {}, z[L::PR][4] = {};
#pragma unroll
        for (int k = 0; k < NX; ++k) {
          const float4 y = ld4(sY + k * NWP + 4 * ch);
#pragma unroll
          for (int j = 0; j < L::PR; ++j) {
            const float a = sX[k * NWP + rows[j]];
            v[j][0] += a * y.x;
            v[j][1] += a * y.y;
            v[j][2] += a * y.z;
            v[j][3] += a * y.w;
          }
        }
#pragma unroll
        for (int al = 0; al < NU; ++al) {
          const float4 y = ld4(sW + al * NQP + 4 * ch);
#pragma unroll
          for (int j = 0; j < L::PR; ++j) {
            const float zc = sZ[al * NWP + rows[j]];
            w[j][0] += zc * y.x;
            w[j][1] += zc * y.y;
            w[j][2] += zc * y.z;
            w[j][3] += zc * y.w;
          }
        }
#pragma unroll
        for (int q = 0; q < RE; ++q) {
          const float4 y = ld4(sNu + q * NCP + 4 * ch);
#pragma unroll
          for (int j = 0; j < L::PR; ++j) {
            const float f = sF[q * NX + rows[j]];
            z[j][0] += f * y.x;
            z[j][1] += f * y.y;
            z[j][2] += f * y.z;
            z[j][3] += f * y.w;
          }
        }
#pragma unroll
        for (int j = 0; j < L::PR; ++j) {
          const int i = g + j * L::PG;
          if (i >= NX) continue;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = 4 * ch + e;
            if (col < NX)
              sPn[i * PS + col] =
                  (v[j][e] + sym_at<NS>(sG, i, col)) + w[j][e] + z[j][e];
            else if (col < NC)
              sp[(col - NX) * NX + i] = v[j][e] + w[j][e] + z[j][e];
          }
        }
      }
    } else if (lane < L::kRowLanes * NX) {
      const bool first = lane < NX;
      const int i = first ? lane : lane - NX;
      const int ch0 = first ? 0 : L::P0;
      float acol[NX], zcol[NU], fcol[RE > 0 ? RE : 1];
#pragma unroll
      for (int k = 0; k < NX; ++k) acol[k] = sX[k * NWP + i];
#pragma unroll
      for (int al = 0; al < NU; ++al) zcol[al] = sZ[al * NWP + i];
#pragma unroll
      for (int q = 0; q < RE; ++q) fcol[q] = sF[q * NX + i];
#pragma unroll
      for (int o = 0; o < L::P0; ++o) {
        const int ch = ch0 + o;
        if (ch >= L::PC) continue;
        float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        float w[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        float z[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int k = 0; k < NX; ++k) {
          const float4 y = ld4(sY + k * NWP + 4 * ch);
          v[0] += acol[k] * y.x;
          v[1] += acol[k] * y.y;
          v[2] += acol[k] * y.z;
          v[3] += acol[k] * y.w;
        }
#pragma unroll
        for (int al = 0; al < NU; ++al) {
          const float4 y = ld4(sW + al * NQP + 4 * ch);
          w[0] += zcol[al] * y.x;
          w[1] += zcol[al] * y.y;
          w[2] += zcol[al] * y.z;
          w[3] += zcol[al] * y.w;
        }
#pragma unroll
        for (int q = 0; q < RE; ++q) {
          const float4 y = ld4(sNu + q * NCP + 4 * ch);
          z[0] += fcol[q] * y.x;
          z[1] += fcol[q] * y.y;
          z[2] += fcol[q] * y.z;
          z[3] += fcol[q] * y.w;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 4 * ch + e;
          if (col < NX)
            sPn[i * PS + col] = (v[e] + sym_at<NS>(sG, i, col)) + w[e] + z[e];
          else if (col < NC)
            sp[(col - NX) * NX + i] = v[e] + w[e] + z[e];
        }
      }
    }
    // the next stage's first barrier orders these writes before its reads
  }
  if (lane0 == 0) ok_out[b] = ok ? 1 : 0;
}

// Dynamic shared memory above the default 48 KB must be asked for.
template <typename Kernel>
cudaError_t reserve_smem(Kernel kernel, size_t bytes) {
  if (bytes <= static_cast<size_t>(kDefaultSmem)) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// The instance <NX, NU, R, RE>: kMaxWarps warps a block, the shared memory
// carveout at its largest so kMinBlocks blocks fit an SM.
template <int NX, int NU, int R, int RE>
cudaError_t backward_fixed(
    const void* A, const void* Bm, const void* G, const void* M,
    const void* mx, const void* mu, const void* c, const void* delta,
    const void* dc, const void* E, const void* F, const void* h, void* gains,
    void* ok, int nbatch, int H, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (nbatch <= 0 || H <= 0) return cudaErrorInvalidValue;
  auto kernel = riccati_general_backward_fixed<NX, NU, R, RE>;
  const size_t smem =
      sizeof(float) * kMaxWarps * FixedLayout<NX, NU, R, RE>::kFloats;
  err = reserve_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const dim3 grid((nbatch + kMaxWarps - 1) / kMaxWarps);
  kernel<<<grid, kMaxWarps * 32, smem, stream>>>(
      static_cast<const float*>(A), static_cast<const float*>(Bm),
      static_cast<const float*>(G), static_cast<const float*>(M),
      static_cast<const float*>(mx), static_cast<const float*>(mu),
      static_cast<const float*>(c), static_cast<const float*>(delta),
      static_cast<const float*>(dc), static_cast<const float*>(E),
      static_cast<const float*>(F), static_cast<const float*>(h),
      static_cast<float*>(gains), static_cast<uint8_t*>(ok), nbatch, H);
  return cudaGetLastError();
}

}  // namespace
