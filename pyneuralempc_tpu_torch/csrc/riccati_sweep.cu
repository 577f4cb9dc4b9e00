// Fused plain Riccati sweep for Hopper (sm_90a): the whole backward
// recursion and the whole forward recursion of the structured KKT solve,
// in ONE launch, one thread per problem.
//
// Replaces pyneuralempc_tpu/ops/pallas/riccati_kernel.py
// `_riccati_pallas_call`, fused branch (:419-465): `_backward_kernel` and
// `_forward_kernel` with fused=True, and the per-lane local-delta Cholesky
// helpers `_chol_factor_tiles` / `_chol_sub_tiles` / `_chol_solve_retry`.
// The plain PyTorch version of the same function is
// `riccati_sweep_plain` in pyneuralempc_tpu_torch/ops/cuda/riccati_kernel.py.
//
// What bounds it on an H100: bytes.  At B=4096, H=20, nx=2, nu=1 the sweep
// must read A, B, G, M, mx, mu, c (29 floats a stage) and write dX, dU,
// dLam (5 floats a stage): at least 4096*20*34*4 B ~= 11 MB, ~3.3 us at
// 3.35 TB/s.  Its arithmetic is ~1e7 flop, which is negligible at 67
// TFLOP/s (f32, outside the tensor cores).
//
// This first design is latency-bound, not bandwidth-bound: each thread
// walks one serial H-stage chain twice (backward, then forward) and
// B=4096 problems give only ~31 threads per SM.  Per-stage loads are
// strided by a problem's whole horizon, so they do not coalesce.  The
// design keeps what the TPU kernel kept out of device memory where it can:
// the value-function carry (P, p) and the running dx live in registers.
// The per-stage gains (K, k, Pbar, pbar, Mxu) go to a global scratch buffer
// between the two passes (the TPU kernel kept them in VMEM); each thread
// reads back only its own gains, so no synchronisation across blocks is
// needed.  Making it fast (batch-innermost coalesced layouts, several
// threads per problem, shared-memory staging) is later work.
//
// Layouts (all float32, C-contiguous, batch first):
//   A (B,H,NX,NX)  Bm (B,H,NX,NU)  G, M (B,H,NS,NS) symmetric, of which only
//   the upper triangle (i <= j) is read, as the TPU kernel reads its packed
//   triangles  mx (B,H,NX)  mu (B,H,NU)  c (B,H,NX)  delta (B,)
//   outputs dX (B,H,NX)  dU (B,H,NU)  dLam (B,H,NX)  ok (B,) as 0/1 bytes
//   scratch gains (B,H,NU*NX+NU+NX*NX+NX+NX*NU)

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 32;   // 4096 problems -> 128 blocks, one per SM

// _LOCAL_DELTAS = (0, 1e-6, 1e-4): nudge-scale bumps on Quu's diagonal.
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
template <int NU>
__device__ __forceinline__ bool chol_factor(const float (&Q)[NU][NU], float d,
                                            float (&L)[NU][NU],
                                            float (&inv_d)[NU]) {
  bool ok = true;
#pragma unroll
  for (int i = 0; i < NU; ++i) {
    float s = Q[i][i] + d;
#pragma unroll
    for (int q = 0; q < i; ++q) s -= L[i][q] * L[i][q];
    const bool good = s > 1e-12f;
    ok = ok && good;
    L[i][i] = sqrtf(good ? s : 1.0f);
    inv_d[i] = 1.0f / L[i][i];
#pragma unroll
    for (int j = i + 1; j < NU; ++j) {
      float v = Q[j][i];
#pragma unroll
      for (int q = 0; q < i; ++q) v -= L[j][q] * L[i][q];
      L[j][i] = v * inv_d[i];
    }
  }
  return ok;
}

// Forward then back substitution with the factor (_chol_sub_tiles).
template <int NU>
__device__ __forceinline__ void chol_subst(const float (&L)[NU][NU],
                                           const float (&inv_d)[NU],
                                           const float (&rhs)[NU],
                                           float (&x)[NU]) {
  float y[NU];
#pragma unroll
  for (int i = 0; i < NU; ++i) {
    float v = rhs[i];
#pragma unroll
    for (int q = 0; q < i; ++q) v -= L[i][q] * y[q];
    y[i] = v * inv_d[i];
  }
#pragma unroll
  for (int i = NU - 1; i >= 0; --i) {
    float v = y[i];
#pragma unroll
    for (int q = i + 1; q < NU; ++q) v -= L[q][i] * x[q];
    x[i] = v * inv_d[i];
  }
}

template <int NX, int NU>
__global__ void __launch_bounds__(kThreads)
riccati_sweep_kernel(const float* __restrict__ A, const float* __restrict__ Bm,
                     const float* __restrict__ G, const float* __restrict__ M,
                     const float* __restrict__ mx,
                     const float* __restrict__ mu,
                     const float* __restrict__ c,
                     const float* __restrict__ delta,
                     float* __restrict__ dX, float* __restrict__ dU,
                     float* __restrict__ dLam, uint8_t* __restrict__ ok_out,
                     float* __restrict__ gains, int nbatch, int H) {
  constexpr int NS = NX + NU;
  constexpr int NG = NU * NX + NU + NX * NX + NX + NX * NU;
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= nbatch) return;
  const float d = delta[b];

  // ---- backward: value function V_t(dx) = 1/2 dx'P dx + p'dx ----
  float P[NX][NX], p[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    p[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < NX; ++j) P[i][j] = 0.0f;
  }
  bool ok = true;

  for (int t = H - 1; t >= 0; --t) {
    const size_t st = static_cast<size_t>(b) * H + t;
    const float* a = A + st * NX * NX;
    const float* bm = Bm + st * NX * NU;
    const float* g = G + st * NS * NS;
    const float* m = M + st * NS * NS;
    const float* cv = c + st * NX;
    float* gn = gains + st * NG;

    float Av[NX][NX], Bv[NX][NU], cc[NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      cc[i] = cv[i];
#pragma unroll
      for (int j = 0; j < NX; ++j) Av[i][j] = a[i * NX + j];
#pragma unroll
      for (int al = 0; al < NU; ++al) Bv[i][al] = bm[i * NU + al];
    }

    float Pbar[NX][NX], pbar[NX], Mxu[NX][NU];
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      pbar[i] = p[i] + mx[st * NX + i];
#pragma unroll
      for (int j = 0; j < NX; ++j)
        Pbar[i][j] = P[i][j] + sym<NS>(m, i, j) + (i == j ? d : 0.0f);
#pragma unroll
      for (int al = 0; al < NU; ++al) Mxu[i][al] = sym<NS>(m, i, NX + al);
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

    float Pc_p[NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      float v = 0.0f;
#pragma unroll
      for (int k = 0; k < NX; ++k) v += Pbar[i][k] * cc[k];
      Pc_p[i] = v + pbar[i];
    }
    float qx[NX], qu[NU];
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      float v = 0.0f;
#pragma unroll
      for (int k = 0; k < NX; ++k) v += Av[k][i] * Pc_p[k];
      qx[i] = v;
    }
#pragma unroll
    for (int al = 0; al < NU; ++al) {
      float v = 0.0f, w = 0.0f;
#pragma unroll
      for (int k = 0; k < NX; ++k) {
        v += Bv[k][al] * Pc_p[k];
        w += Mxu[k][al] * cc[k];
      }
      qu[al] = v + w + mu[st * NU + al];
    }

    // Gains [K | k] = -Quu^-1 [Qux | qu] with the local-delta blend of
    // _chol_solve_retry: factor at each bump, keep the first factor that
    // passes (the delta=0 factor when none does), substitute once.
    float L[NU][NU], inv_d[NU];
    bool ok_t = chol_factor<NU>(Quu, local_delta(0), L, inv_d);
#pragma unroll
    for (int level = 1; level < 3; ++level) {
      if (ok_t) break;
      float L2[NU][NU], inv2[NU];
      if (chol_factor<NU>(Quu, local_delta(level), L2, inv2)) {
#pragma unroll
        for (int i = 0; i < NU; ++i) {
          inv_d[i] = inv2[i];
#pragma unroll
          for (int j = 0; j <= i; ++j) L[i][j] = L2[i][j];
        }
        ok_t = true;
      }
    }
    ok = ok && ok_t;

    float K[NU][NX], kk[NU];
#pragma unroll
    for (int j = 0; j <= NX; ++j) {
      float rhs[NU], sol[NU];
#pragma unroll
      for (int al = 0; al < NU; ++al) rhs[al] = j < NX ? Qux[al][j] : qu[al];
      chol_subst<NU>(L, inv_d, rhs, sol);
#pragma unroll
      for (int al = 0; al < NU; ++al) {
        if (j < NX) K[al][j] = -sol[al];
        else kk[al] = -sol[al];
      }
    }

    // stage gains for the forward pass: [K | k | Pbar | pbar | Mxu]
    int o = 0;
#pragma unroll
    for (int al = 0; al < NU; ++al)
#pragma unroll
      for (int j = 0; j < NX; ++j) gn[o++] = K[al][j];
#pragma unroll
    for (int al = 0; al < NU; ++al) gn[o++] = kk[al];
#pragma unroll
    for (int i = 0; i < NX; ++i)
#pragma unroll
      for (int j = 0; j < NX; ++j) gn[o++] = Pbar[i][j];
#pragma unroll
    for (int i = 0; i < NX; ++i) gn[o++] = pbar[i];
#pragma unroll
    for (int i = 0; i < NX; ++i)
#pragma unroll
      for (int al = 0; al < NU; ++al) gn[o++] = Mxu[i][al];

    float Pn[NX][NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) {
#pragma unroll
      for (int j = 0; j < NX; ++j) {
        float v = Qxx[i][j];
#pragma unroll
        for (int al = 0; al < NU; ++al) v += Qux[al][i] * K[al][j];
        Pn[i][j] = v;
      }
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      float v = qx[i];
#pragma unroll
      for (int al = 0; al < NU; ++al) v += Qux[al][i] * kk[al];
      p[i] = v;
#pragma unroll
      for (int j = 0; j < NX; ++j) P[i][j] = 0.5f * (Pn[i][j] + Pn[j][i]);
    }
  }

  // ---- forward: du = K dx + k, dx' = A dx + B du + c,
  //      dlam = Pbar dx' + Mxu du + pbar ----
  float dx[NX];
#pragma unroll
  for (int i = 0; i < NX; ++i) dx[i] = 0.0f;
  for (int t = 0; t < H; ++t) {
    const size_t st = static_cast<size_t>(b) * H + t;
    const float* a = A + st * NX * NX;
    const float* bm = Bm + st * NX * NU;
    const float* cv = c + st * NX;
    const float* gn = gains + st * NG;
    const float* K = gn;
    const float* kk = gn + NU * NX;
    const float* Pbar = kk + NU;
    const float* pbar = Pbar + NX * NX;
    const float* Mxu = pbar + NX;

    float du[NU];
#pragma unroll
    for (int al = 0; al < NU; ++al) {
      float v = 0.0f;
#pragma unroll
      for (int j = 0; j < NX; ++j) v += K[al * NX + j] * dx[j];
      du[al] = v + kk[al];
    }
    float dxn[NX];
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      float v = 0.0f, w = 0.0f;
#pragma unroll
      for (int j = 0; j < NX; ++j) v += a[i * NX + j] * dx[j];
#pragma unroll
      for (int al = 0; al < NU; ++al) w += bm[i * NU + al] * du[al];
      dxn[i] = v + w + cv[i];
    }
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      float v = 0.0f, w = 0.0f;
#pragma unroll
      for (int j = 0; j < NX; ++j) v += Pbar[i * NX + j] * dxn[j];
#pragma unroll
      for (int al = 0; al < NU; ++al) w += Mxu[i * NU + al] * du[al];
      dLam[st * NX + i] = v + w + pbar[i];
      dX[st * NX + i] = dxn[i];
    }
#pragma unroll
    for (int al = 0; al < NU; ++al) dU[st * NU + al] = du[al];
#pragma unroll
    for (int i = 0; i < NX; ++i) dx[i] = dxn[i];
  }
  ok_out[b] = ok ? 1 : 0;
}

template <int NX, int NU>
cudaError_t launch(const void* A, const void* Bm, const void* G, const void* M,
                   const void* mx, const void* mu, const void* c,
                   const void* delta, void* dX, void* dU, void* dLam, void* ok,
                   void* gains, int nbatch, int H, cudaStream_t stream) {
  const dim3 grid((nbatch + kThreads - 1) / kThreads);
  riccati_sweep_kernel<NX, NU><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(A), static_cast<const float*>(Bm),
      static_cast<const float*>(G), static_cast<const float*>(M),
      static_cast<const float*>(mx), static_cast<const float*>(mu),
      static_cast<const float*>(c), static_cast<const float*>(delta),
      static_cast<float*>(dX), static_cast<float*>(dU),
      static_cast<float*>(dLam), static_cast<uint8_t*>(ok),
      static_cast<float*>(gains), nbatch, H);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point (bound with ctypes).  Launches on `stream` of
// `device` and returns the launch's cudaError_t (0 on success); an
// (nx, nu) with no instantiation returns cudaErrorInvalidValue.
extern "C" int riccati_sweep_f32(const void* A, const void* Bm, const void* G,
                                 const void* M, const void* mx, const void* mu,
                                 const void* c, const void* delta, void* dX,
                                 void* dU, void* dLam, void* ok, void* gains,
                                 int nbatch, int H, int nx, int nu,
                                 int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nbatch <= 0 || H <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nx == 2 && nu == 1)
    err = launch<2, 1>(A, Bm, G, M, mx, mu, c, delta, dX, dU, dLam, ok, gains,
                       nbatch, H, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
