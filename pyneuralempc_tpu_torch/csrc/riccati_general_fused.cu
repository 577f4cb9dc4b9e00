// Fused general Riccati sweep for Hopper (sm_90a): R right-hand sides that
// share one factorisation a stage, and r stage equality rows solved by a
// Schur complement on Quu's factor; the whole backward recursion and the
// whole forward recursion in ONE launch, one thread per problem.
//
// Replaces pyneuralempc_tpu/ops/pallas/riccati_kernel.py
// `_riccati_general_pallas_call`, resident branch (:890-970, `pallas_call`
// at :953): `_bwd_general_body` (:610-787, with the local-delta Cholesky
// retry of `_chol_solve_retry` :158-188 on both Quu and S) followed by
// `_fwd_general_body` (:790-847) in one program.  The plain PyTorch version
// of the same function is `riccati_sweep_general_plain` in
// pyneuralempc_tpu_torch/ops/cuda/riccati_general.py.
//
// What bounds it on an H100: bytes.  At B=4096, H=20, nx=2, nu=1, R=2, r=0
// (the budgeted LV fleet) the sweep must read A, B, the upper triangles of
// G and M, mx, mu, c (28 floats a stage) and write dX, dU, dLam (10 floats
// a stage): ~12.5 MB, ~3.7 us at 3.35 TB/s.  Its arithmetic (~0.02 GFLOP)
// is negligible at 67 TFLOP/s (f32, outside the tensor cores).  What holds
// it far from that is latency: each thread walks two serial H-stage
// chains, and 4096 problems make one warp an SM.
//
// Two kernels, one stage arithmetic.  (NX, NU, R, RE) are template
// parameters, so a stage lives in registers and every product is unrolled
// straight-line code; backward_stage() and forward_stage() hold the sums
// (per stage, Quu's Cholesky with the local-delta retry gives K, every k
// and Y = Quu^-1 E^T; with RE > 0, S = sym(E Y) + delta_c I is factored
// with its own retry and gives Knu and knu, K and k are corrected by -Y Knu
// and -Y knu, and P and p take F^T Knu and F^T knu).  The kernels differ
// only in where the operands live:
//
//  * riccati_general_fused_staged_kernel (the solver's kernel).  A block
//    of 32 threads owns P consecutive problems (staged_problems(): at most
//    32, as many as fit the 227 KB of shared memory a block).  Batch-first
//    tensors make the block's share of each input one contiguous range, so
//    the prologue brings every range into shared memory with one bulk copy
//    (cp.async.bulk, completing on one mbarrier) each, or, where a range is
//    not 16-byte aligned or sized, with 4-byte cp.async copies from every
//    lane.  Each thread then runs its backward chain from shared memory
//    with the next stage's operands loaded into registers while the current
//    stage computes; the gains stay in shared memory ([stage][gain][problem],
//    no bank conflicts) for the forward pass, which prefetches the same
//    way.  The outputs are assembled in their global layout in the room of
//    G, M, mx, mu, E, F, h (read by the backward pass only), a stage's rows
//    with 16- or 8-byte stores, and leave as contiguous ranges in coalesced
//    16-byte stores by all 32 lanes.  The global gains scratch is written
//    only when the caller asks for it.
//  * riccati_general_fused_kernel (the first design, kept for comparison and
//    for horizons at which not one problem fits in shared memory).  Each
//    thread reads its stages from global memory, strided by a problem's
//    horizon, and keeps its gains in a global scratch between the passes.
//
// Layouts (all float32, C-contiguous, batch first, per-rhs tensors
// stage-major so a stage's R right-hand sides are contiguous):
//   A (B,H,NX,NX)  Bm (B,H,NX,NU)  G, M (B,H,NS,NS) symmetric, of which only
//   the upper triangle (i <= j) is read  mx, c (B,H,R,NX)  mu (B,H,R,NU)
//   delta, dc (B,)  E (B,H,RE,NU)  F, Jx (B,H,RE,NX)  h (B,H,R,RE)
//   outputs dX, dLam (B,H,R,NX)  dU (B,H,R,NU)  dNu (B,H,R,RE)  ok (B,) as
//   0/1 bytes
//   gains (B,H,NG), each stage [K (NU,NX) | k (R,NU) | Pbar (NX,NX)
//   | pbar (R,NX) | Mxu (NX,NU) | Knu (RE,NX) | knu (R,RE)], row-major,
//   NG = NU*NX + R*NU + NX*NX + R*NX + NX*NU + RE*NX + R*RE
// With RE = 0, dc, E, F, h, Jx and dNu are not read or written.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk_copy.cuh"

namespace {

constexpr int kThreads = 32;
// Dynamic shared memory a block may opt into on an H100 (227 KB); the
// wrapper's STAGED_MAX_SMEM (ops/cuda/riccati_kernel.py) is the same.
constexpr int kMaxSmem = 232448;

// _LOCAL_DELTAS = (0, 1e-6, 1e-4): nudge-scale bumps on the diagonal.
__device__ __forceinline__ float local_delta(int level) {
  return level == 0 ? 0.0f : (level == 1 ? 1e-6f : 1e-4f);
}

// Unrolled Cholesky of Q + d*I (lower triangle of Q read).  A failed pivot
// (s <= 1e-12) is replaced by 1 so the factor stays finite; the return
// value says whether every pivot passed (_chol_factor_tiles).
template <int N>
__device__ __forceinline__ bool chol_factor(const float (&Q)[N][N], float d,
                                            float (&L)[N][N],
                                            float (&inv_d)[N]) {
  bool ok = true;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float s = Q[i][i] + d;
#pragma unroll
    for (int q = 0; q < i; ++q) s -= L[i][q] * L[i][q];
    const bool good = s > 1e-12f;
    ok = ok && good;
    L[i][i] = sqrtf(good ? s : 1.0f);
    inv_d[i] = 1.0f / L[i][i];
#pragma unroll
    for (int j = i + 1; j < N; ++j) {
      float v = Q[j][i];
#pragma unroll
      for (int q = 0; q < i; ++q) v -= L[j][q] * L[i][q];
      L[j][i] = v * inv_d[i];
    }
  }
  return ok;
}

// The local-delta blend of _chol_solve_retry: factor at each bump while the
// pivot test fails, keep the first factor that passes (the delta=0 factor
// when none does).
template <int N>
__device__ __forceinline__ bool chol_retry(const float (&Q)[N][N],
                                           float (&L)[N][N],
                                           float (&inv_d)[N]) {
  bool ok = chol_factor<N>(Q, local_delta(0), L, inv_d);
#pragma unroll
  for (int level = 1; level < 3; ++level) {
    if (ok) break;
    float L2[N][N], inv2[N];
    if (chol_factor<N>(Q, local_delta(level), L2, inv2)) {
#pragma unroll
      for (int i = 0; i < N; ++i) {
        inv_d[i] = inv2[i];
#pragma unroll
        for (int j = 0; j <= i; ++j) L[i][j] = L2[i][j];
      }
      ok = true;
    }
  }
  return ok;
}

// Forward then back substitution with the factor (_chol_sub_tiles).
template <int N>
__device__ __forceinline__ void chol_subst(const float (&L)[N][N],
                                           const float (&inv_d)[N],
                                           const float (&rhs)[N],
                                           float (&x)[N]) {
  float y[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float v = rhs[i];
#pragma unroll
    for (int q = 0; q < i; ++q) v -= L[i][q] * y[q];
    y[i] = v * inv_d[i];
  }
#pragma unroll
  for (int i = N - 1; i >= 0; --i) {
    float v = y[i];
#pragma unroll
    for (int q = i + 1; q < N; ++q) v -= L[q][i] * x[q];
    x[i] = v * inv_d[i];
  }
}

template <int NX, int NU, int R, int RE>
struct Shape {
  static constexpr int NS = NX + NU;
  static constexpr int RS = RE > 0 ? RE : 1;   // extent (RE = 0 keeps one)
  static constexpr int NG = NU * NX + R * NU + NX * NX + R * NX + NX * NU
                            + RE * NX + R * RE;
};

// One backward stage's operands, in registers.  G and M are symmetric and
// filled from their upper triangles (i <= j), the only elements read.
template <int NX, int NU, int R, int RE>
struct BwdOperands {
  static constexpr int NS = NX + NU, RS = RE > 0 ? RE : 1;
  float A[NX][NX], B[NX][NU], G[NS][NS], M[NS][NS];
  float mx[R][NX], mu[R][NU], c[R][NX];
  float E[RS][NU], F[RS][NX], h[R][RS];
};

// One stage's gains.
template <int NX, int NU, int R, int RE>
struct Gains {
  static constexpr int RS = RE > 0 ? RE : 1;
  float K[NU][NX], k[R][NU], Pbar[NX][NX], pbar[R][NX], Mxu[NX][NU];
  float Knu[RS][NX], knu[R][RS];
};

// One forward stage's operands.
template <int NX, int NU, int R, int RE>
struct FwdOperands {
  static constexpr int RS = RE > 0 ? RE : 1;
  float A[NX][NX], B[NX][NU], c[R][NX], Jx[RS][NX];
  Gains<NX, NU, R, RE> g;
};

// Calls f(o, x) on every gain x of `g` with its offset o in the layout
// [K | k | Pbar | pbar | Mxu | Knu | knu].
template <int NX, int NU, int R, int RE, typename Gn, typename Fn>
__device__ __forceinline__ void for_each_gain(Gn& g, Fn&& f) {
  int o = 0;
#pragma unroll
  for (int al = 0; al < NU; ++al)
#pragma unroll
    for (int j = 0; j < NX; ++j) f(o++, g.K[al][j]);
#pragma unroll
  for (int ri = 0; ri < R; ++ri)
#pragma unroll
    for (int al = 0; al < NU; ++al) f(o++, g.k[ri][al]);
#pragma unroll
  for (int i = 0; i < NX; ++i)
#pragma unroll
    for (int j = 0; j < NX; ++j) f(o++, g.Pbar[i][j]);
#pragma unroll
  for (int ri = 0; ri < R; ++ri)
#pragma unroll
    for (int i = 0; i < NX; ++i) f(o++, g.pbar[ri][i]);
#pragma unroll
  for (int i = 0; i < NX; ++i)
#pragma unroll
    for (int al = 0; al < NU; ++al) f(o++, g.Mxu[i][al]);
  if constexpr (RE > 0) {
#pragma unroll
    for (int q = 0; q < RE; ++q)
#pragma unroll
      for (int j = 0; j < NX; ++j) f(o++, g.Knu[q][j]);
#pragma unroll
    for (int ri = 0; ri < R; ++ri)
#pragma unroll
      for (int q = 0; q < RE; ++q) f(o++, g.knu[ri][q]);
  }
}

// Gain o of the stage to dst[o * stride].
template <int NX, int NU, int R, int RE>
__device__ __forceinline__ void store_gains(const Gains<NX, NU, R, RE>& g,
                                            float* dst, int stride) {
  for_each_gain<NX, NU, R, RE>(g, [&](int o, const float& x) {
    dst[o * stride] = x;
  });
}

template <int NX, int NU, int R, int RE>
__device__ __forceinline__ void load_gains(Gains<NX, NU, R, RE>& g,
                                           const float* src, int stride) {
  for_each_gain<NX, NU, R, RE>(g, [&](int o, float& x) {
    x = src[o * stride];
  });
}

// W consecutive floats from src: 16- or 8-byte loads when Vec and W's size
// allow them (src is then aligned to them), one float at a time otherwise;
// store_floats the same way to dst.
template <int W, bool Vec>
__device__ __forceinline__ void load_floats(float* dst, const float* src) {
  if constexpr (Vec && W % 4 == 0) {
#pragma unroll
    for (int i = 0; i < W; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(src + i);
      dst[i] = v.x;
      dst[i + 1] = v.y;
      dst[i + 2] = v.z;
      dst[i + 3] = v.w;
    }
  } else if constexpr (Vec && W % 2 == 0) {
#pragma unroll
    for (int i = 0; i < W; i += 2) {
      const float2 v = *reinterpret_cast<const float2*>(src + i);
      dst[i] = v.x;
      dst[i + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < W; ++i) dst[i] = src[i];
  }
}

template <int W, bool Vec>
__device__ __forceinline__ void store_floats(float* dst, const float* src) {
  if constexpr (Vec && W % 4 == 0) {
#pragma unroll
    for (int i = 0; i < W; i += 4)
      *reinterpret_cast<float4*>(dst + i) =
          make_float4(src[i], src[i + 1], src[i + 2], src[i + 3]);
  } else if constexpr (Vec && W % 2 == 0) {
#pragma unroll
    for (int i = 0; i < W; i += 2)
      *reinterpret_cast<float2*>(dst + i) = make_float2(src[i], src[i + 1]);
  } else {
#pragma unroll
    for (int i = 0; i < W; ++i) dst[i] = src[i];
  }
}

// The symmetric NS x NS stage matrix from its upper triangle.
template <int NS>
__device__ __forceinline__ void load_sym(float (&X)[NS][NS],
                                         const float* src) {
#pragma unroll
  for (int i = 0; i < NS; ++i)
#pragma unroll
    for (int j = i; j < NS; ++j) X[i][j] = X[j][i] = src[i * NS + j];
}

// One backward stage's operands from the stage's rows of each input.
template <int NX, int NU, int R, int RE, bool Vec>
__device__ __forceinline__ void load_backward(
    BwdOperands<NX, NU, R, RE>& s, const float* a, const float* bm,
    const float* g, const float* m, const float* mxv, const float* muv,
    const float* cv, const float* ev, const float* fv, const float* hv) {
  load_floats<NX * NX, Vec>(&s.A[0][0], a);
  load_floats<NX * NU, Vec>(&s.B[0][0], bm);
  load_sym<NX + NU>(s.G, g);
  load_sym<NX + NU>(s.M, m);
  load_floats<R * NX, Vec>(&s.mx[0][0], mxv);
  load_floats<R * NU, Vec>(&s.mu[0][0], muv);
  load_floats<R * NX, Vec>(&s.c[0][0], cv);
  if constexpr (RE > 0) {
    load_floats<RE * NU, Vec>(&s.E[0][0], ev);
    load_floats<RE * NX, Vec>(&s.F[0][0], fv);
    load_floats<R * RE, Vec>(&s.h[0][0], hv);
  }
}

template <int NX, int NU, int R, int RE, bool Vec>
__device__ __forceinline__ void load_forward(FwdOperands<NX, NU, R, RE>& s,
                                             const float* a,
                                             const float* bm,
                                             const float* cv,
                                             const float* jx) {
  load_floats<NX * NX, Vec>(&s.A[0][0], a);
  load_floats<NX * NU, Vec>(&s.B[0][0], bm);
  load_floats<R * NX, Vec>(&s.c[0][0], cv);
  if constexpr (RE > 0) load_floats<RE * NX, Vec>(&s.Jx[0][0], jx);
}

// ---- one backward stage: value function V_t(dx) = 1/2 dx'P dx + p_r'dx
//      per rhs, (P, p) at stage t+1 in, at stage t out; the stage's gains
//      into gn; returns whether both factorisations passed ----
template <int NX, int NU, int R, int RE>
__device__ __forceinline__ bool backward_stage(
    const BwdOperands<NX, NU, R, RE>& s, float d, float dcb,
    float (&P)[NX][NX], float (&p)[R][NX], Gains<NX, NU, R, RE>& gn) {
  const auto& Av = s.A;
  const auto& Bv = s.B;
  auto& Pbar = gn.Pbar;
  auto& pbar = gn.pbar;
  auto& Mxu = gn.Mxu;
  auto& K = gn.K;
  auto& kk = gn.k;
  auto& Knu = gn.Knu;
  auto& knu = gn.knu;

  // Pbar = P + Mxx + delta I, pbar = p + mx, Mxu (M's state-control block)
#pragma unroll
  for (int i = 0; i < NX; ++i) {
#pragma unroll
    for (int j = 0; j < NX; ++j)
      Pbar[i][j] = P[i][j] + s.M[i][j] + (i == j ? d : 0.0f);
#pragma unroll
    for (int al = 0; al < NU; ++al) Mxu[i][al] = s.M[i][NX + al];
#pragma unroll
    for (int ri = 0; ri < R; ++ri) pbar[ri][i] = p[ri][i] + s.mx[ri][i];
  }

  float PA[NX][NX], PB[NX][NU];
#pragma unroll
  for (int i = 0; i < NX; ++i) {
#pragma unroll
    for (int j = 0; j < NX; ++j) {
      float v = 0.0f;
#pragma unroll
      for (int k = 0; k < NX; ++k) v += Pbar[i][k] * Av[k][j];
      PA[i][j] = v;
    }
#pragma unroll
    for (int al = 0; al < NU; ++al) {
      float v = 0.0f;
#pragma unroll
      for (int k = 0; k < NX; ++k) v += Pbar[i][k] * Bv[k][al];
      PB[i][al] = v;
    }
  }

  float Qxx[NX][NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) {
#pragma unroll
    for (int j = 0; j < NX; ++j) {
      float v = 0.0f;
#pragma unroll
      for (int k = 0; k < NX; ++k) v += Av[k][i] * PA[k][j];
      Qxx[i][j] = v + s.G[i][j];
    }
  }

  float BtMxu[NU][NU];
#pragma unroll
  for (int al = 0; al < NU; ++al) {
#pragma unroll
    for (int be = 0; be < NU; ++be) {
      float v = 0.0f;
#pragma unroll
      for (int k = 0; k < NX; ++k) v += Bv[k][al] * Mxu[k][be];
      BtMxu[al][be] = v;
    }
  }

  float Quu[NU][NU], Qux[NU][NX];
#pragma unroll
  for (int al = 0; al < NU; ++al) {
#pragma unroll
    for (int be = 0; be < NU; ++be) {
      float v = 0.0f;
#pragma unroll
      for (int k = 0; k < NX; ++k) v += Bv[k][al] * PB[k][be];
      Quu[al][be] = v + s.M[NX + al][NX + be]
                    + (al == be ? d : 0.0f) + BtMxu[al][be]
                    + BtMxu[be][al] + s.G[NX + al][NX + be];
    }
#pragma unroll
    for (int j = 0; j < NX; ++j) {
      float v = 0.0f, w = 0.0f;
#pragma unroll
      for (int k = 0; k < NX; ++k) {
        v += Bv[k][al] * PA[k][j];
        w += Mxu[k][al] * Av[k][j];
      }
      Qux[al][j] = v + w + s.G[NX + al][j];
    }
  }

  // per rhs: Pc_p = Pbar c + pbar, qx = A' Pc_p, qu = B' Pc_p + Mxu' c + mu
  float qx[R][NX], qu[R][NU];
#pragma unroll
  for (int ri = 0; ri < R; ++ri) {
    const auto& cc = s.c[ri];
    float Pc_p[NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      float v = 0.0f;
#pragma unroll
      for (int k = 0; k < NX; ++k) v += Pbar[i][k] * cc[k];
      Pc_p[i] = v + pbar[ri][i];
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      float v = 0.0f;
#pragma unroll
      for (int k = 0; k < NX; ++k) v += Av[k][i] * Pc_p[k];
      qx[ri][i] = v;
    }
#pragma unroll
    for (int al = 0; al < NU; ++al) {
      float v = 0.0f, w = 0.0f;
#pragma unroll
      for (int k = 0; k < NX; ++k) {
        v += Bv[k][al] * Pc_p[k];
        w += Mxu[k][al] * cc[k];
      }
      qu[ri][al] = v + w + s.mu[ri][al];
    }
  }

  // ---- one Quu factor: K = -Quu^-1 Qux, k = -Quu^-1 qu per rhs ----
  float L[NU][NU], inv_d[NU];
  bool ok_t = chol_retry<NU>(Quu, L, inv_d);

#pragma unroll
  for (int j = 0; j < NX; ++j) {
    float rhs[NU], sol[NU];
#pragma unroll
    for (int al = 0; al < NU; ++al) rhs[al] = Qux[al][j];
    chol_subst<NU>(L, inv_d, rhs, sol);
#pragma unroll
    for (int al = 0; al < NU; ++al) K[al][j] = -sol[al];
  }
#pragma unroll
  for (int ri = 0; ri < R; ++ri) {
    float sol[NU];
    chol_subst<NU>(L, inv_d, qu[ri], sol);
#pragma unroll
    for (int al = 0; al < NU; ++al) kk[ri][al] = -sol[al];
  }

  // ---- stage equality rows: Schur complement on Quu's factor ----
  if constexpr (RE > 0) {
    const auto& Ev = s.E;
    const auto& Fv = s.F;
    float Y[NU][RE];
    // Y = Quu^-1 E^T, one column a row of E
#pragma unroll
    for (int q = 0; q < RE; ++q) {
      float sol[NU];
      chol_subst<NU>(L, inv_d, Ev[q], sol);
#pragma unroll
      for (int al = 0; al < NU; ++al) Y[al][q] = sol[al];
    }
    // S = sym(E Y) + delta_c I, factored with its own local-delta retry
    float S[RE][RE];
#pragma unroll
    for (int i = 0; i < RE; ++i) {
#pragma unroll
      for (int j = 0; j < RE; ++j) {
        float v_ij = 0.0f, v_ji = 0.0f;
#pragma unroll
        for (int al = 0; al < NU; ++al) {
          v_ij += Ev[i][al] * Y[al][j];
          v_ji += Ev[j][al] * Y[al][i];
        }
        S[i][j] = 0.5f * (v_ij + v_ji) + (i == j ? dcb : 0.0f);
      }
    }
    float Ls[RE][RE], invs[RE];
    ok_t = chol_retry<RE>(S, Ls, invs) && ok_t;
    // Knu = S^-1 (E K + F), knu = S^-1 (E k - h) per rhs
#pragma unroll
    for (int j = 0; j < NX; ++j) {
      float rhs[RE], sol[RE];
#pragma unroll
      for (int q = 0; q < RE; ++q) {
        float v = Fv[q][j];
#pragma unroll
        for (int al = 0; al < NU; ++al) v += Ev[q][al] * K[al][j];
        rhs[q] = v;
      }
      chol_subst<RE>(Ls, invs, rhs, sol);
#pragma unroll
      for (int q = 0; q < RE; ++q) Knu[q][j] = sol[q];
    }
#pragma unroll
    for (int ri = 0; ri < R; ++ri) {
      float rhs[RE], sol[RE];
#pragma unroll
      for (int q = 0; q < RE; ++q) {
        float v = -s.h[ri][q];
#pragma unroll
        for (int al = 0; al < NU; ++al) v += Ev[q][al] * kk[ri][al];
        rhs[q] = v;
      }
      chol_subst<RE>(Ls, invs, rhs, sol);
#pragma unroll
      for (int q = 0; q < RE; ++q) knu[ri][q] = sol[q];
    }
    // K -= Y Knu, k -= Y knu
#pragma unroll
    for (int al = 0; al < NU; ++al) {
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        float v = 0.0f;
#pragma unroll
        for (int q = 0; q < RE; ++q) v += Y[al][q] * Knu[q][j];
        K[al][j] -= v;
      }
#pragma unroll
      for (int ri = 0; ri < R; ++ri) {
        float v = 0.0f;
#pragma unroll
        for (int q = 0; q < RE; ++q) v += Y[al][q] * knu[ri][q];
        kk[ri][al] -= v;
      }
    }
  }

  // ---- P = sym(Qxx + Qux' K + F' Knu), p = qx + Qux' k + F' knu ----
  float Pn[NX][NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) {
#pragma unroll
    for (int j = 0; j < NX; ++j) {
      float v = Qxx[i][j];
#pragma unroll
      for (int al = 0; al < NU; ++al) v += Qux[al][i] * K[al][j];
      if constexpr (RE > 0) {
#pragma unroll
        for (int q = 0; q < RE; ++q) v += s.F[q][i] * Knu[q][j];
      }
      Pn[i][j] = v;
    }
  }
#pragma unroll
  for (int i = 0; i < NX; ++i) {
#pragma unroll
    for (int ri = 0; ri < R; ++ri) {
      float v = qx[ri][i];
#pragma unroll
      for (int al = 0; al < NU; ++al) v += Qux[al][i] * kk[ri][al];
      if constexpr (RE > 0) {
#pragma unroll
        for (int q = 0; q < RE; ++q) v += s.F[q][i] * knu[ri][q];
      }
      p[ri][i] = v;
    }
#pragma unroll
    for (int j = 0; j < NX; ++j) P[i][j] = 0.5f * (Pn[i][j] + Pn[j][i]);
  }
  return ok_t;
}

// ---- one forward stage, per rhs: du = K dx + k, dnu = Knu dx + knu,
//      dx' = A dx + B du + c, dlam = Pbar dx' + Mxu du + pbar + Jx' dnu;
//      dx at stage t-1 in, at stage t out ----
template <int NX, int NU, int R, int RE>
__device__ __forceinline__ void forward_stage(
    const FwdOperands<NX, NU, R, RE>& s, float (&dx)[R][NX],
    float (&dU)[R][NU], float (&dNu)[R][Shape<NX, NU, R, RE>::RS],
    float (&dLam)[R][NX]) {
  const auto& g = s.g;
#pragma unroll
  for (int ri = 0; ri < R; ++ri) {
    float du[NU];
#pragma unroll
    for (int al = 0; al < NU; ++al) {
      float v = 0.0f;
#pragma unroll
      for (int j = 0; j < NX; ++j) v += g.K[al][j] * dx[ri][j];
      du[al] = v + g.k[ri][al];
      dU[ri][al] = du[al];
    }
    if constexpr (RE > 0) {
#pragma unroll
      for (int q = 0; q < RE; ++q) {
        float v = 0.0f;
#pragma unroll
        for (int j = 0; j < NX; ++j) v += g.Knu[q][j] * dx[ri][j];
        dNu[ri][q] = v + g.knu[ri][q];
      }
    }
    float dxn[NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      float v = 0.0f, w = 0.0f;
#pragma unroll
      for (int j = 0; j < NX; ++j) v += s.A[i][j] * dx[ri][j];
#pragma unroll
      for (int al = 0; al < NU; ++al) w += s.B[i][al] * du[al];
      dxn[i] = v + w + s.c[ri][i];
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      float v = 0.0f, w = 0.0f, z = 0.0f;
#pragma unroll
      for (int j = 0; j < NX; ++j) v += g.Pbar[i][j] * dxn[j];
#pragma unroll
      for (int al = 0; al < NU; ++al) w += g.Mxu[i][al] * du[al];
      if constexpr (RE > 0) {
#pragma unroll
        for (int q = 0; q < RE; ++q) z += dNu[ri][q] * s.Jx[q][i];
      }
      dLam[ri][i] = v + w + g.pbar[ri][i] + z;
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) dx[ri][i] = dxn[i];
  }
}

// ---- the first design: every operand from global memory ----
template <int NX, int NU, int R, int RE>
__global__ void __launch_bounds__(kThreads)
riccati_general_fused_kernel(
    const float* __restrict__ A, const float* __restrict__ Bm,
    const float* __restrict__ G, const float* __restrict__ M,
    const float* __restrict__ mx, const float* __restrict__ mu,
    const float* __restrict__ c, const float* __restrict__ delta,
    const float* __restrict__ dc, const float* __restrict__ E,
    const float* __restrict__ F, const float* __restrict__ h,
    const float* __restrict__ Jx, float* __restrict__ dX,
    float* __restrict__ dU, float* __restrict__ dLam,
    float* __restrict__ dNu, uint8_t* __restrict__ ok_out,
    float* __restrict__ gains, int nbatch, int H) {
  using S = Shape<NX, NU, R, RE>;
  constexpr int NS = S::NS, NG = S::NG;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= nbatch) return;
  const float d = delta[b];
  float dcb = 0.0f;
  if constexpr (RE > 0) dcb = dc[b];

  float P[NX][NX], p[R][NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) {
#pragma unroll
    for (int j = 0; j < NX; ++j) P[i][j] = 0.0f;
#pragma unroll
    for (int ri = 0; ri < R; ++ri) p[ri][i] = 0.0f;
  }
  bool ok = true;
  for (int t = H - 1; t >= 0; --t) {
    const size_t st = static_cast<size_t>(b) * H + t;
    BwdOperands<NX, NU, R, RE> s;
    load_backward<NX, NU, R, RE, false>(
        s, A + st * NX * NX, Bm + st * NX * NU, G + st * NS * NS,
        M + st * NS * NS, mx + st * R * NX, mu + st * R * NU,
        c + st * R * NX, E + st * RE * NU, F + st * RE * NX,
        h + st * R * RE);
    Gains<NX, NU, R, RE> gn;
    const bool ok_t = backward_stage(s, d, dcb, P, p, gn);
    ok = ok && ok_t;
    store_gains(gn, gains + st * NG, 1);
  }

  float dx[R][NX];
#pragma unroll
  for (int ri = 0; ri < R; ++ri)
#pragma unroll
    for (int i = 0; i < NX; ++i) dx[ri][i] = 0.0f;
  for (int t = 0; t < H; ++t) {
    const size_t st = static_cast<size_t>(b) * H + t;
    FwdOperands<NX, NU, R, RE> s;
    load_forward<NX, NU, R, RE, false>(s, A + st * NX * NX,
                                       Bm + st * NX * NU, c + st * R * NX,
                                       Jx + st * RE * NX);
    load_gains(s.g, gains + st * NG, 1);
    float du[R][NU], dnu[R][S::RS], dlam[R][NX];
    forward_stage(s, dx, du, dnu, dlam);
#pragma unroll
    for (int ri = 0; ri < R; ++ri) {
      const size_t row = st * R + ri;
#pragma unroll
      for (int al = 0; al < NU; ++al) dU[row * NU + al] = du[ri][al];
      if constexpr (RE > 0) {
#pragma unroll
        for (int q = 0; q < RE; ++q) dNu[row * RE + q] = dnu[ri][q];
      }
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        dLam[row * NX + i] = dlam[ri][i];
        dX[row * NX + i] = dx[ri][i];
      }
    }
  }
  ok_out[b] = ok ? 1 : 0;
}

// ---- the staged kernel's block: every input's slab, the gains and the
//      outputs in dynamic shared memory ----

// Inputs in the C entry's argument order; bit i of the wrapper's alignment
// mask says whether input i starts on a 16-byte boundary.
enum Input { kA, kB, kG, kM, kMx, kMu, kC, kDelta, kDc, kE, kF, kH, kJx,
             kInputs };

// Floats of input i that one problem holds.
template <int NX, int NU, int R, int RE>
__host__ __device__ constexpr int input_floats(int i, int H) {
  constexpr int NS = NX + NU;
  switch (i) {
    case kA: return H * NX * NX;
    case kB: return H * NX * NU;
    case kG: case kM: return H * NS * NS;
    case kMx: case kC: return H * R * NX;
    case kMu: return H * R * NU;
    case kDelta: return 1;
    case kDc: return RE > 0 ? 1 : 0;
    case kE: return H * RE * NU;
    case kF: case kJx: return H * RE * NX;
    case kH: return H * R * RE;
    default: return 0;
  }
}

// Offsets in floats from the block's base.  The mbarrier takes the first
// 16 bytes; each slab starts on a 16-byte boundary.  The slabs the forward
// pass reads come first; G, M, mx, mu, E, F, h, read by the backward pass
// only, follow, and the outputs' slabs take their room after it, each in
// its global layout, so that it leaves as one contiguous range.
enum Output { kdX, kdU, kdLam, kdNu, kOutputs };

struct StagedLayout {
  int slab[kInputs];
  int gains;         // [stage][gain][problem]
  int out[kOutputs];
  int floats;        // the whole block
};

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

template <int NX, int NU, int R, int RE>
__host__ __device__ constexpr StagedLayout staged_layout(int P, int H) {
  StagedLayout L{};
  int o = 4;
  const int order[kInputs] = {kA, kB, kC, kJx, kDelta, kDc, kG, kM, kMx,
                              kMu, kE, kF, kH};
#pragma unroll
  for (int n = 0; n < kInputs; ++n) {
    L.slab[order[n]] = o;
    o = round4(o + P * input_floats<NX, NU, R, RE>(order[n], H));
  }
  L.gains = o;
  L.floats = round4(o + P * H * Shape<NX, NU, R, RE>::NG);
  const int out_floats[kOutputs] = {H * R * NX, H * R * NU, H * R * NX,
                                    H * R * RE};
  o = L.slab[kG];
#pragma unroll
  for (int n = 0; n < kOutputs; ++n) {
    L.out[n] = o;
    o = round4(o + P * out_floats[n]);
  }
  return L;
}

// Problems a block of the staged kernel takes at horizon H: at most
// kThreads, as many as fit in kMaxSmem; 0 when not one fits.
template <int NX, int NU, int R, int RE>
__host__ __device__ constexpr int staged_problems(int H) {
  if (H > kMaxSmem / 4) return 0;   // not one stage of one problem fits
  for (int P = kThreads; P > 0; --P)
    if (4 * staged_layout<NX, NU, R, RE>(P, H).floats <= kMaxSmem) return P;
  return 0;
}

constexpr int kStamps = 5;   // phase stamps a block (see the kernel)

// src[0, n) (16-byte aligned shared memory) to dst[0, n) by all lanes: a
// warp instruction stores 512 consecutive bytes when dst is 16-byte aligned
// and n a multiple of 4, 128 otherwise.
__device__ __forceinline__ void store_slab(float* __restrict__ dst,
                                           const float* src, int n,
                                           int lane) {
  if (reinterpret_cast<uintptr_t>(dst) % 16 == 0 && n % 4 == 0) {
    float4* d = reinterpret_cast<float4*>(dst);
    const float4* s = reinterpret_cast<const float4*>(src);
    for (int j = lane; j < n / 4; j += kThreads) d[j] = s[j];
  } else {
    for (int j = lane; j < n; j += kThreads) dst[j] = src[j];
  }
}

template <int NX, int NU, int R, int RE>
__global__ void __launch_bounds__(kThreads)
riccati_general_fused_staged_kernel(
    const float* __restrict__ A, const float* __restrict__ Bm,
    const float* __restrict__ G, const float* __restrict__ M,
    const float* __restrict__ mx, const float* __restrict__ mu,
    const float* __restrict__ c, const float* __restrict__ delta,
    const float* __restrict__ dc, const float* __restrict__ E,
    const float* __restrict__ F, const float* __restrict__ h,
    const float* __restrict__ Jx, float* __restrict__ dX,
    float* __restrict__ dU, float* __restrict__ dLam,
    float* __restrict__ dNu, uint8_t* __restrict__ ok_out,
    float* __restrict__ gains_out, long long* __restrict__ stamps,
    int nbatch, int H, int P, unsigned aligned) {
  using S = Shape<NX, NU, R, RE>;
  constexpr int NS = S::NS, NG = S::NG;
  // a stage's outputs fit where its G, M, mx, mu, E, F, h were, with 9
  // floats to spare for the output slabs' rounding to 16 bytes
  static_assert(2 * NS * NS + R * (NX + NU) + RE * (NU + NX) + R * RE
                    >= R * (2 * NX + NU + RE) + 9,
                "the outputs must fit where G, M, mx, mu, E, F, h were");
  extern __shared__ __align__(16) float smem[];
  const StagedLayout L = staged_layout<NX, NU, R, RE>(P, H);
  const int lane = threadIdx.x;
  const size_t b0 = static_cast<size_t>(blockIdx.x) * P;
  const int n = min(P, nbatch - static_cast<int>(b0));
  const float* const src[kInputs] = {A, Bm, G, M, mx, mu, c, delta, dc, E,
                                     F, h, Jx};
  // with `stamps`, lane 0 records (cycles, ns) at the start and after the
  // prologue, the backward pass, the forward pass and the epilogue:
  // stamps[(block * kStamps + k) * 2 + {0, 1}]
  auto stamp = [&](int k) {
    if (stamps != nullptr && lane == 0) {
      long long* at = stamps + (blockIdx.x * kStamps + k) * 2;
      read_clocks(at, at + 1);
    }
  };
  stamp(0);

  // ---- prologue: the block's range of every input into shared memory, a
  //      bulk copy each where it is 16-byte aligned and sized ----
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  unsigned bulk = 0;
  uint32_t tx = 0;
#pragma unroll
  for (int i = 0; i < kInputs; ++i) {
    const size_t w = input_floats<NX, NU, R, RE>(i, H);
    const size_t bytes = 4 * w * n;
    if (w > 0 && ((aligned >> i) & 1u) && (4 * w * b0) % 16 == 0
        && bytes % 16 == 0) {
      bulk |= 1u << i;
      tx += static_cast<uint32_t>(bytes);
    }
  }
  if (bulk != 0 && lane == 0) mbar_init(bar);
  __syncthreads();
  if (bulk != 0 && lane == 0) {
    mbar_arrive_expect_tx(bar, tx);
#pragma unroll
    for (int i = 0; i < kInputs; ++i) {
      if ((bulk >> i) & 1u) {
        const size_t w = input_floats<NX, NU, R, RE>(i, H);
        bulk_copy_g2s(smem + L.slab[i], src[i] + b0 * w,
                      static_cast<uint32_t>(4 * w * n), bar);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kInputs; ++i) {
    const int w = input_floats<NX, NU, R, RE>(i, H);
    if (w > 0 && !((bulk >> i) & 1u)) {
      const float* from = src[i] + b0 * w;
      float* to = smem + L.slab[i];
      for (int j = lane; j < n * w; j += kThreads)
        copy4_async(to + j, from + j);
    }
  }
  copy4_wait_all();
  if (bulk != 0) mbar_wait(bar, 0);
  __syncthreads();
  stamp(1);

  // the stage-t rows of problem p's slabs
  const int p = lane;
  auto row = [&](int i, int t, int width) {
    return smem + L.slab[i] + (p * H + t) * width;
  };
  auto load_bwd = [&](BwdOperands<NX, NU, R, RE>& s, int t) {
    load_backward<NX, NU, R, RE, true>(
        s, row(kA, t, NX * NX), row(kB, t, NX * NU), row(kG, t, NS * NS),
        row(kM, t, NS * NS), row(kMx, t, R * NX), row(kMu, t, R * NU),
        row(kC, t, R * NX), row(kE, t, RE * NU), row(kF, t, RE * NX),
        row(kH, t, R * RE));
  };
  auto load_fwd = [&](FwdOperands<NX, NU, R, RE>& s, int t) {
    load_forward<NX, NU, R, RE, true>(s, row(kA, t, NX * NX),
                                      row(kB, t, NX * NU),
                                      row(kC, t, R * NX),
                                      row(kJx, t, RE * NX));
    load_gains(s.g, smem + L.gains + t * NG * P + p, P);
  };

  // ---- backward, stage t-1's operands loaded while stage t computes ----
  if (p < n) {
    const float d = smem[L.slab[kDelta] + p];
    float dcb = 0.0f;
    if constexpr (RE > 0) dcb = smem[L.slab[kDc] + p];
    float Pv[NX][NX], pv[R][NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) {
#pragma unroll
      for (int j = 0; j < NX; ++j) Pv[i][j] = 0.0f;
#pragma unroll
      for (int ri = 0; ri < R; ++ri) pv[ri][i] = 0.0f;
    }
    bool ok = true;
    BwdOperands<NX, NU, R, RE> cur, next;
    load_bwd(cur, H - 1);
    for (int t = H - 1; t >= 0; --t) {
      load_bwd(next, t > 0 ? t - 1 : 0);
      Gains<NX, NU, R, RE> gn;
      const bool ok_t = backward_stage(cur, d, dcb, Pv, pv, gn);
      ok = ok && ok_t;
      store_gains(gn, smem + L.gains + t * NG * P + p, P);
      if (gains_out != nullptr)
        store_gains(gn, gains_out + ((b0 + p) * H + t) * NG, 1);
      cur = next;
    }
    ok_out[b0 + p] = ok ? 1 : 0;
  }
  __syncthreads();   // G, M, mx, mu, E, F, h are free for the outputs
  stamp(2);

  // ---- forward, stage t+1's operands loaded while stage t computes; each
  //      stage's outputs to their slabs in shared memory ----
  if (p < n) {
    float dx[R][NX];
#pragma unroll
    for (int ri = 0; ri < R; ++ri)
#pragma unroll
      for (int i = 0; i < NX; ++i) dx[ri][i] = 0.0f;
    FwdOperands<NX, NU, R, RE> cur, next;
    load_fwd(cur, 0);
    for (int t = 0; t < H; ++t) {
      load_fwd(next, t + 1 < H ? t + 1 : t);
      float du[R][NU], dnu[R][S::RS], dlam[R][NX];
      forward_stage(cur, dx, du, dnu, dlam);
      const int st = p * H + t;
      store_floats<R * NX, true>(smem + L.out[kdX] + st * R * NX, &dx[0][0]);
      store_floats<R * NU, true>(smem + L.out[kdU] + st * R * NU, &du[0][0]);
      store_floats<R * NX, true>(smem + L.out[kdLam] + st * R * NX,
                                 &dlam[0][0]);
      if constexpr (RE > 0)
        store_floats<R * RE, true>(smem + L.out[kdNu] + st * R * RE,
                                   &dnu[0][0]);
      cur = next;
    }
  }
  __syncthreads();
  stamp(3);

  // ---- epilogue: each output's range leaves in coalesced stores ----
  store_slab(dX + b0 * H * R * NX, smem + L.out[kdX], n * H * R * NX, lane);
  store_slab(dU + b0 * H * R * NU, smem + L.out[kdU], n * H * R * NU, lane);
  store_slab(dLam + b0 * H * R * NX, smem + L.out[kdLam], n * H * R * NX,
             lane);
  if constexpr (RE > 0)
    store_slab(dNu + b0 * H * R * RE, smem + L.out[kdNu], n * H * R * RE,
               lane);
  stamp(4);
}

template <int NX, int NU, int R, int RE>
cudaError_t launch_direct(const void* A, const void* Bm, const void* G,
                          const void* M, const void* mx, const void* mu,
                          const void* c, const void* delta, const void* dc,
                          const void* E, const void* F, const void* h,
                          const void* Jx, void* dX, void* dU, void* dLam,
                          void* dNu, void* ok, void* gains, int nbatch, int H,
                          cudaStream_t stream) {
  if (gains == nullptr) return cudaErrorInvalidValue;   // its scratch
  const dim3 grid((nbatch + kThreads - 1) / kThreads);
  riccati_general_fused_kernel<NX, NU, R, RE><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(A), static_cast<const float*>(Bm),
      static_cast<const float*>(G), static_cast<const float*>(M),
      static_cast<const float*>(mx), static_cast<const float*>(mu),
      static_cast<const float*>(c), static_cast<const float*>(delta),
      static_cast<const float*>(dc), static_cast<const float*>(E),
      static_cast<const float*>(F), static_cast<const float*>(h),
      static_cast<const float*>(Jx), static_cast<float*>(dX),
      static_cast<float*>(dU), static_cast<float*>(dLam),
      static_cast<float*>(dNu), static_cast<uint8_t*>(ok),
      static_cast<float*>(gains), nbatch, H);
  return cudaGetLastError();
}

// The staged kernel where a problem fits in shared memory, the direct one
// where none does.  `gains` may be null for the staged kernel.
template <int NX, int NU, int R, int RE>
cudaError_t launch(const void* A, const void* Bm, const void* G, const void* M,
                   const void* mx, const void* mu, const void* c,
                   const void* delta, const void* dc, const void* E,
                   const void* F, const void* h, const void* Jx, void* dX,
                   void* dU, void* dLam, void* dNu, void* ok, void* gains,
                   void* stamps, int nbatch, int H, unsigned aligned,
                   cudaStream_t stream) {
  const int P = staged_problems<NX, NU, R, RE>(H);
  if (P == 0)
    return launch_direct<NX, NU, R, RE>(A, Bm, G, M, mx, mu, c, delta, dc, E,
                                        F, h, Jx, dX, dU, dLam, dNu, ok,
                                        gains, nbatch, H, stream);
  const int bytes = 4 * staged_layout<NX, NU, R, RE>(P, H).floats;
  auto kernel = riccati_general_fused_staged_kernel<NX, NU, R, RE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((nbatch + P - 1) / P);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(A), static_cast<const float*>(Bm),
      static_cast<const float*>(G), static_cast<const float*>(M),
      static_cast<const float*>(mx), static_cast<const float*>(mu),
      static_cast<const float*>(c), static_cast<const float*>(delta),
      static_cast<const float*>(dc), static_cast<const float*>(E),
      static_cast<const float*>(F), static_cast<const float*>(h),
      static_cast<const float*>(Jx), static_cast<float*>(dX),
      static_cast<float*>(dU), static_cast<float*>(dLam),
      static_cast<float*>(dNu), static_cast<uint8_t*>(ok),
      static_cast<float*>(gains), static_cast<long long*>(stamps), nbatch,
      H, P, aligned);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes).  Each launches on `stream` of
// `device` and returns the launch's cudaError_t (0 on success).  The
// instances are (nx, nu) = (2, 1) with R in {1, 2, 3} right-hand sides and
// r in {0, 1} equality rows; any other shape returns cudaErrorInvalidValue.
// The staged entry also takes (R, r) = (1, 0), the plain sweep's shape
// (riccati_sweep_cuda launches it there: the general sweep at one
// right-hand side and no equality rows is the plain sweep), and its list
// is `_STAGED_INSTANCES` in ops/cuda/riccati_kernel.py; the direct entry's
// is `_GENERAL_INSTANCES` (at (1, 0) riccati_sweep.cu is the direct
// design).
//
// riccati_general_fused_f32: the staged kernel, or the direct kernel at a
// horizon where not one problem fits in shared memory.  Bit i of `aligned`
// says that input i (A, Bm, G, M, mx, mu, c, delta, dc, E, F, h, Jx) starts
// on a 16-byte boundary, so that its ranges may take bulk copies; `gains`
// (B,H,NG) is written when it is not null, and the direct kernel needs it;
// `stamps`, when not null, takes the staged kernel's phase stamps (int64,
// blocks x kStamps x 2).
extern "C" int riccati_general_fused_f32(
    const void* A, const void* Bm, const void* G, const void* M,
    const void* mx, const void* mu, const void* c, const void* delta,
    const void* dc, const void* E, const void* F, const void* h,
    const void* Jx, void* dX, void* dU, void* dLam, void* dNu, void* ok,
    void* gains, void* stamps, int nbatch, int H, int nx, int nu, int R,
    int r, int aligned, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nbatch <= 0 || H <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RICCATI_GENERAL_FUSED_CASE(NX_, NU_, R_, RE_)                       \
  if (nx == NX_ && nu == NU_ && R == R_ && r == RE_)                        \
    return static_cast<int>(launch<NX_, NU_, R_, RE_>(                      \
        A, Bm, G, M, mx, mu, c, delta, dc, E, F, h, Jx, dX, dU, dLam, dNu, \
        ok, gains, stamps, nbatch, H, static_cast<unsigned>(aligned), s));
  RICCATI_GENERAL_FUSED_CASE(2, 1, 1, 0)
  RICCATI_GENERAL_FUSED_CASE(2, 1, 1, 1)
  RICCATI_GENERAL_FUSED_CASE(2, 1, 2, 0)
  RICCATI_GENERAL_FUSED_CASE(2, 1, 2, 1)
  RICCATI_GENERAL_FUSED_CASE(2, 1, 3, 0)
  RICCATI_GENERAL_FUSED_CASE(2, 1, 3, 1)
#undef RICCATI_GENERAL_FUSED_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// riccati_general_fused_direct_f32: the direct kernel at every horizon,
// `gains` its scratch.  Not on the solver's path: it lets one run hold the
// two designs against each other and time both.
extern "C" int riccati_general_fused_direct_f32(
    const void* A, const void* Bm, const void* G, const void* M,
    const void* mx, const void* mu, const void* c, const void* delta,
    const void* dc, const void* E, const void* F, const void* h,
    const void* Jx, void* dX, void* dU, void* dLam, void* dNu, void* ok,
    void* gains, int nbatch, int H, int nx, int nu, int R, int r, int device,
    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nbatch <= 0 || H <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RICCATI_GENERAL_FUSED_DIRECT_CASE(NX_, NU_, R_, RE_)                \
  if (nx == NX_ && nu == NU_ && R == R_ && r == RE_)                        \
    return static_cast<int>(launch_direct<NX_, NU_, R_, RE_>(               \
        A, Bm, G, M, mx, mu, c, delta, dc, E, F, h, Jx, dX, dU, dLam, dNu, \
        ok, gains, nbatch, H, s));
  RICCATI_GENERAL_FUSED_DIRECT_CASE(2, 1, 1, 1)
  RICCATI_GENERAL_FUSED_DIRECT_CASE(2, 1, 2, 0)
  RICCATI_GENERAL_FUSED_DIRECT_CASE(2, 1, 2, 1)
  RICCATI_GENERAL_FUSED_DIRECT_CASE(2, 1, 3, 0)
  RICCATI_GENERAL_FUSED_DIRECT_CASE(2, 1, 3, 1)
#undef RICCATI_GENERAL_FUSED_DIRECT_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
