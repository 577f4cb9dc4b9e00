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
// a stage): ~12.5 MB, ~3.7 us at 3.35 TB/s.  Its arithmetic (~0.04 GFLOP)
// is negligible at 67 TFLOP/s (f32, outside the tensor cores).
//
// Design.  That of riccati_sweep.cu (the fused plain sweep) grown by the R
// and r axes: (NX, NU, R, RE) are template parameters, so the stage lives
// in registers, every product is unrolled straight-line code, and the
// carry (P, and p per right-hand side) and the forward pass's running dx
// per right-hand side stay in registers across stages.  Per stage, Quu's
// Cholesky with the local-delta retry gives K, every k and Y = Quu^-1 E^T;
// with RE > 0, S = sym(E Y) + delta_c I is factored with its own retry and
// gives Knu and knu, K and k are corrected by -Y Knu and -Y knu, and P and p
// take F^T Knu and F^T knu.  The per-stage gains go to a global scratch
// laid out as the streamed general pair's gains buffer (the TPU kernel kept
// them in VMEM); each thread reads back only its own gains in the forward
// pass, so no synchronisation across threads is needed.  Like the fused
// plain kernel this first design is latency-bound: each thread walks two
// serial H-stage chains, 4096 problems give ~31 threads an SM, and the
// per-stage loads are strided by a problem's horizon (no coalescing).
//
// Layouts (all float32, C-contiguous, batch first, per-rhs tensors
// stage-major so a stage's R right-hand sides are contiguous):
//   A (B,H,NX,NX)  Bm (B,H,NX,NU)  G, M (B,H,NS,NS) symmetric, of which only
//   the upper triangle (i <= j) is read  mx, c (B,H,R,NX)  mu (B,H,R,NU)
//   delta, dc (B,)  E (B,H,RE,NU)  F, Jx (B,H,RE,NX)  h (B,H,R,RE)
//   outputs dX, dLam (B,H,R,NX)  dU (B,H,R,NU)  dNu (B,H,R,RE)  ok (B,) as
//   0/1 bytes
//   scratch gains (B,H,NG), each stage [K (NU,NX) | k (R,NU) | Pbar (NX,NX)
//   | pbar (R,NX) | Mxu (NX,NU) | Knu (RE,NX) | knu (R,RE)], row-major,
//   NG = NU*NX + R*NU + NX*NX + R*NX + NX*NU + RE*NX + R*RE
// With RE = 0, dc, E, F, h, Jx and dNu are not read or written.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 32;   // 4096 problems -> 128 blocks, one per SM

// _LOCAL_DELTAS = (0, 1e-6, 1e-4): nudge-scale bumps on the diagonal.
__device__ __forceinline__ float local_delta(int level) {
  return level == 0 ? 0.0f : (level == 1 ? 1e-6f : 1e-4f);
}

// Element (i, j) of a symmetric NS x NS stage matrix, read from its upper
// triangle.
template <int NS>
__device__ __forceinline__ float sym(const float* __restrict__ X, int i,
                                     int j) {
  return i <= j ? X[i * NS + j] : X[j * NS + i];
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
  constexpr int NS = NX + NU;
  constexpr int RS = RE > 0 ? RE : 1;   // array extent (RE = 0 keeps one)
  constexpr int NG = NU * NX + R * NU + NX * NX + R * NX + NX * NU
                     + RE * NX + R * RE;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= nbatch) return;
  const float d = delta[b];
  float dcb = 0.0f;
  if constexpr (RE > 0) dcb = dc[b];

  // ---- backward: value function V_t(dx) = 1/2 dx'P dx + p_r'dx per rhs ----
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
    const float* a = A + st * NX * NX;
    const float* bm = Bm + st * NX * NU;
    const float* g = G + st * NS * NS;
    const float* m = M + st * NS * NS;
    const float* mxv = mx + st * R * NX;
    const float* muv = mu + st * R * NU;
    const float* cv = c + st * R * NX;
    float* gn = gains + st * NG;

    float Av[NX][NX], Bv[NX][NU];
#pragma unroll
    for (int i = 0; i < NX; ++i) {
#pragma unroll
      for (int j = 0; j < NX; ++j) Av[i][j] = a[i * NX + j];
#pragma unroll
      for (int al = 0; al < NU; ++al) Bv[i][al] = bm[i * NU + al];
    }

    // Pbar = P + Mxx + delta I, pbar = p + mx, Mxu (M's state-control block)
    float Pbar[NX][NX], pbar[R][NX], Mxu[NX][NU];
#pragma unroll
    for (int i = 0; i < NX; ++i) {
#pragma unroll
      for (int j = 0; j < NX; ++j)
        Pbar[i][j] = P[i][j] + sym<NS>(m, i, j) + (i == j ? d : 0.0f);
#pragma unroll
      for (int al = 0; al < NU; ++al) Mxu[i][al] = sym<NS>(m, i, NX + al);
#pragma unroll
      for (int ri = 0; ri < R; ++ri) pbar[ri][i] = p[ri][i] + mxv[ri * NX + i];
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
        Qxx[i][j] = v + sym<NS>(g, i, j);
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
        Quu[al][be] = v + sym<NS>(m, NX + al, NX + be)
                      + (al == be ? d : 0.0f) + BtMxu[al][be]
                      + BtMxu[be][al] + sym<NS>(g, NX + al, NX + be);
      }
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        float v = 0.0f, w = 0.0f;
#pragma unroll
        for (int k = 0; k < NX; ++k) {
          v += Bv[k][al] * PA[k][j];
          w += Mxu[k][al] * Av[k][j];
        }
        Qux[al][j] = v + w + sym<NS>(g, NX + al, j);
      }
    }

    // per rhs: Pc_p = Pbar c + pbar, qx = A' Pc_p, qu = B' Pc_p + Mxu' c + mu
    float qx[R][NX], qu[R][NU];
#pragma unroll
    for (int ri = 0; ri < R; ++ri) {
      float cc[NX], Pc_p[NX];
#pragma unroll
      for (int i = 0; i < NX; ++i) cc[i] = cv[ri * NX + i];
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
        qu[ri][al] = v + w + muv[ri * NU + al];
      }
    }

    // ---- one Quu factor: K = -Quu^-1 Qux, k = -Quu^-1 qu per rhs ----
    float L[NU][NU], inv_d[NU];
    bool ok_t = chol_retry<NU>(Quu, L, inv_d);

    float K[NU][NX], kk[R][NU];
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
    float Fv[RS][NX], Knu[RS][NX], knu[R][RS];
    if constexpr (RE > 0) {
      const float* ev = E + st * RE * NU;
      const float* fv = F + st * RE * NX;
      const float* hv = h + st * R * RE;
      float Ev[RE][NU], Y[NU][RE];
#pragma unroll
      for (int q = 0; q < RE; ++q) {
#pragma unroll
        for (int al = 0; al < NU; ++al) Ev[q][al] = ev[q * NU + al];
#pragma unroll
        for (int j = 0; j < NX; ++j) Fv[q][j] = fv[q * NX + j];
      }
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
          float v = -hv[ri * RE + q];
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
    ok = ok && ok_t;

    // ---- stage gains for the forward pass:
    //      [K | k | Pbar | pbar | Mxu | Knu | knu] ----
    int o = 0;
#pragma unroll
    for (int al = 0; al < NU; ++al)
#pragma unroll
      for (int j = 0; j < NX; ++j) gn[o++] = K[al][j];
#pragma unroll
    for (int ri = 0; ri < R; ++ri)
#pragma unroll
      for (int al = 0; al < NU; ++al) gn[o++] = kk[ri][al];
#pragma unroll
    for (int i = 0; i < NX; ++i)
#pragma unroll
      for (int j = 0; j < NX; ++j) gn[o++] = Pbar[i][j];
#pragma unroll
    for (int ri = 0; ri < R; ++ri)
#pragma unroll
      for (int i = 0; i < NX; ++i) gn[o++] = pbar[ri][i];
#pragma unroll
    for (int i = 0; i < NX; ++i)
#pragma unroll
      for (int al = 0; al < NU; ++al) gn[o++] = Mxu[i][al];
    if constexpr (RE > 0) {
#pragma unroll
      for (int q = 0; q < RE; ++q)
#pragma unroll
        for (int j = 0; j < NX; ++j) gn[o++] = Knu[q][j];
#pragma unroll
      for (int ri = 0; ri < R; ++ri)
#pragma unroll
        for (int q = 0; q < RE; ++q) gn[o++] = knu[ri][q];
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
          for (int q = 0; q < RE; ++q) v += Fv[q][i] * Knu[q][j];
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
          for (int q = 0; q < RE; ++q) v += Fv[q][i] * knu[ri][q];
        }
        p[ri][i] = v;
      }
#pragma unroll
      for (int j = 0; j < NX; ++j) P[i][j] = 0.5f * (Pn[i][j] + Pn[j][i]);
    }
  }

  // ---- forward, per rhs: du = K dx + k, dnu = Knu dx + knu,
  //      dx' = A dx + B du + c, dlam = Pbar dx' + Mxu du + pbar + Jx' dnu ----
  float dx[R][NX];
#pragma unroll
  for (int ri = 0; ri < R; ++ri)
#pragma unroll
    for (int i = 0; i < NX; ++i) dx[ri][i] = 0.0f;
  for (int t = 0; t < H; ++t) {
    const size_t st = static_cast<size_t>(b) * H + t;
    const float* a = A + st * NX * NX;
    const float* bm = Bm + st * NX * NU;
    const float* cv = c + st * R * NX;
    const float* gn = gains + st * NG;
    const float* K = gn;
    const float* kk = K + NU * NX;
    const float* Pbar = kk + R * NU;
    const float* pbar = Pbar + NX * NX;
    const float* Mxu = pbar + R * NX;
    const float* Knu = Mxu + NX * NU;
    const float* knu = Knu + RE * NX;
    const float* jx = Jx + st * RE * NX;

#pragma unroll
    for (int ri = 0; ri < R; ++ri) {
      const size_t row = st * R + ri;
      float du[NU];
#pragma unroll
      for (int al = 0; al < NU; ++al) {
        float v = 0.0f;
#pragma unroll
        for (int j = 0; j < NX; ++j) v += K[al * NX + j] * dx[ri][j];
        du[al] = v + kk[ri * NU + al];
        dU[row * NU + al] = du[al];
      }
      float dnu[RS];
      if constexpr (RE > 0) {
#pragma unroll
        for (int q = 0; q < RE; ++q) {
          float v = 0.0f;
#pragma unroll
          for (int j = 0; j < NX; ++j) v += Knu[q * NX + j] * dx[ri][j];
          dnu[q] = v + knu[ri * RE + q];
          dNu[row * RE + q] = dnu[q];
        }
      }
      float dxn[NX];
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        float v = 0.0f, w = 0.0f;
#pragma unroll
        for (int j = 0; j < NX; ++j) v += a[i * NX + j] * dx[ri][j];
#pragma unroll
        for (int al = 0; al < NU; ++al) w += bm[i * NU + al] * du[al];
        dxn[i] = v + w + cv[ri * NX + i];
      }
#pragma unroll
      for (int i = 0; i < NX; ++i) {
        float v = 0.0f, w = 0.0f, z = 0.0f;
#pragma unroll
        for (int j = 0; j < NX; ++j) v += Pbar[i * NX + j] * dxn[j];
#pragma unroll
        for (int al = 0; al < NU; ++al) w += Mxu[i * NU + al] * du[al];
        if constexpr (RE > 0) {
#pragma unroll
          for (int q = 0; q < RE; ++q) z += dnu[q] * jx[q * NX + i];
        }
        dLam[row * NX + i] = v + w + pbar[ri * NX + i] + z;
        dX[row * NX + i] = dxn[i];
        dx[ri][i] = dxn[i];
      }
    }
  }
  ok_out[b] = ok ? 1 : 0;
}

template <int NX, int NU, int R, int RE>
cudaError_t launch(const void* A, const void* Bm, const void* G, const void* M,
                   const void* mx, const void* mu, const void* c,
                   const void* delta, const void* dc, const void* E,
                   const void* F, const void* h, const void* Jx, void* dX,
                   void* dU, void* dLam, void* dNu, void* ok, void* gains,
                   int nbatch, int H, cudaStream_t stream) {
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

}  // namespace

// Plain C entry point (bound with ctypes).  Launches on `stream` of
// `device` and returns the launch's cudaError_t (0 on success).  The
// instances are (nx, nu) = (2, 1) with R in {1, 2, 3} right-hand sides and
// r in {0, 1} equality rows, except (R, r) = (1, 0) (the plain sweep,
// riccati_sweep.cu); any other shape returns cudaErrorInvalidValue.  This
// list and `_GENERAL_INSTANCES` in ops/cuda/riccati_kernel.py must agree.
extern "C" int riccati_general_fused_f32(
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
#define RICCATI_GENERAL_FUSED_CASE(NX_, NU_, R_, RE_)                       \
  if (nx == NX_ && nu == NU_ && R == R_ && r == RE_)                        \
    return static_cast<int>(launch<NX_, NU_, R_, RE_>(                      \
        A, Bm, G, M, mx, mu, c, delta, dc, E, F, h, Jx, dX, dU, dLam, dNu, \
        ok, gains, nbatch, H, s));
  RICCATI_GENERAL_FUSED_CASE(2, 1, 1, 1)
  RICCATI_GENERAL_FUSED_CASE(2, 1, 2, 0)
  RICCATI_GENERAL_FUSED_CASE(2, 1, 2, 1)
  RICCATI_GENERAL_FUSED_CASE(2, 1, 3, 0)
  RICCATI_GENERAL_FUSED_CASE(2, 1, 3, 1)
#undef RICCATI_GENERAL_FUSED_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
