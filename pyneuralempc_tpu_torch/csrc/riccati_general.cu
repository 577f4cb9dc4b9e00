// Streamed general Riccati sweep for Hopper (sm_90a): R right-hand sides
// that share one factorisation a stage, and r stage equality rows solved by
// a Schur complement on Quu's factor.  A backward kernel writes every
// stage's gains to device memory, a forward kernel reads them back.  One
// warp per problem; (nx, nu, R, r) at run time, and both kernels also as
// compile-time instances for the EQ/border fleet's stage.
//
// Replaces pyneuralempc_tpu/ops/pallas/riccati_kernel.py
// `_riccati_general_pallas_call`'s streamed pair: the backward call (:991,
// body `_bwd_general_body` :610-787, with the local-delta Cholesky retry of
// `_chol_solve_retry` :158-188 on both Quu and S) and the forward call
// (:1024, body `_fwd_general_body` :790-847).  The plain PyTorch versions
// of the same functions are `riccati_general_backward_plain` and
// `riccati_general_forward_plain` in
// pyneuralempc_tpu_torch/ops/cuda/riccati_general.py.
//
// What bounds them on an H100: bytes.  At B=4096, H=50, nx=12, nu=4, R=2,
// r=1 the backward kernel must read A, B, the upper triangles of G and M,
// mx, mu, c, h, E, F (538 floats a stage) and write the gains (286 floats a
// stage): ~675 MB, ~202 us at 3.35 TB/s, against ~3.3 GFLOP (~49 us at
// 67 TFLOP/s in f32).  The forward kernel reads A, B, c, Jx and the gains
// (514 floats a stage) and writes dX, dU, dLam, dNu (58): ~469 MB, ~140 us,
// for ~0.39 GFLOP.
//
// Design.  That of riccati_streamed.cu, grown by the R and r axes: the
// stage lives in dynamic shared memory sized at launch from (nx, nu, R, r)
// (~6.7 KB a warp at (12, 4, 2, 1), ~128 KB at the widest (32, 16, 65, 16)),
// loaded with coalesced warp-wide copies; each product spreads its output
// entries over the 32 lanes with __syncwarp() between phases; the value
// function carry (P and the R vectors p) stays in shared memory across
// stages.  Quu's Cholesky runs on lane 0 and its nx + R + r substitutions
// (K's columns, each k, and Y = Quu^-1 E^T) one column per lane, looping
// when there are more than 32.  With r > 0, S = E Y + delta_c I is
// symmetrised and factored on lane 0 with its own local-delta retry, and
// its nx + R substitutions give Knu and knu; K and k are then corrected by
// -Y Knu and -Y knu, and P and p take F^T Knu and F^T knu.  Warps per block
// are chosen at launch from the shared memory a warp needs (4, fewer for
// the widest stages); past 48 KB a block the launch asks for more.  The
// backward kernel is capped at 64 registers so that all 4096 problems of
// the EQ/border quadrotor fleet are resident at once.  The backward entry
// launches a compile-time instance of the backward kernel at the fleet's
// (12, 4, 2, 1) (riccati_general_backward_fixed, in
// riccati_backward_fixed.cuh, which csrc/riccati_streamed.cu shares), which
// runs a stage in 5 phases, and this run-time kernel at any other shape.
// The forward entry likewise launches a compile-time instance of the
// forward kernel at (12, 4, 2, 1) with a ring of 2 stage slots a warp
// (riccati_general_forward_fixed, in riccati_forward_fixed.cuh, which
// csrc/riccati_streamed.cu shares).  This run-time forward kernel makes
// six dependent device-memory round trips a stage (five warp-wide copies,
// then the products), ~1.2 us each under load: it takes the time of its
// loads' latency, not of their bytes.  Since only dx carries from stage
// to stage, the instance requests each stage's inputs D stages ahead into
// a ring of stage slots in shared memory (cp.async, 16 bytes wherever the
// addresses allow) and keeps dx in registers, exchanged by shuffles.
//
// Layouts (all float32, C-contiguous, batch first, per-rhs tensors
// stage-major so a stage's R right-hand sides are contiguous):
//   A (B,H,NX,NX)  Bm (B,H,NX,NU)  G, M (B,H,NS,NS) symmetric, of which only
//   the upper triangle (i <= j) is read  mx, c (B,H,R,NX)  mu (B,H,R,NU)
//   delta, dc (B,)  E (B,H,r,NU)  F, Jx (B,H,r,NX)  h (B,H,R,r)
//   gains (B,H,NG), each stage [K (NU,NX) | k (R,NU) | Pbar (NX,NX) |
//   pbar (R,NX) | Mxu (NX,NU) | Knu (r,NX) | knu (R,r)],
//   NG = NU*NX + R*NU + NX*NX + R*NX + NX*NU + r*NX + R*r
//   ok (B,) as 0/1 bytes   dX, dLam (B,H,R,NX)  dU (B,H,R,NU)  dNu (B,H,R,r)

#include <cuda_runtime.h>
#include <stdint.h>

#include "riccati_backward_fixed.cuh"
#include "riccati_forward_fixed.cuh"

namespace {

constexpr int kMaxNx = 32;
constexpr int kMaxNu = 16;           // the reference kernel's own cap
constexpr int kMaxR = 65;            // 1 + the 64 border rows

__host__ __device__ __forceinline__ int gain_width(int nx, int nu, int R,
                                                   int r) {
  return nu * nx + R * nu + nx * nx + R * nx + nx * nu + r * nx + R * r;
}

// Floats of shared memory one warp of the backward kernel uses.
__host__ __device__ __forceinline__ int backward_floats(int nx, int nu, int R,
                                                        int r) {
  const int ns = nx + nu;
  return 5 * nx * nx          // A, P, Pbar, PA (then P_new), Qxx
         + 4 * nx * nu        // B, PB, Qux, K
         + 2 * ns * ns        // G, M
         + 6 * R * nx         // mx, c, p, pbar, Pc_p, qx
         + 3 * R * nu         // mu, qu, k
         + 2 * nu * nu + nu   // Quu, L, 1/diag(L)
         + 2 * r * nu         // E, Y^T
         + 2 * r * nx         // F, Knu
         + 2 * R * r          // h, knu
         + 2 * r * r + r;     // S, Ls, 1/diag(Ls)
}

// Floats of shared memory one warp of the forward kernel uses.
__host__ __device__ __forceinline__ int forward_floats(int nx, int nu, int R,
                                                       int r) {
  return nx * nx + nx * nu + R * nx + r * nx + gain_width(nx, nu, R, r)
         + 2 * R * nx + R * nu + R * r;   // dx, dx', du, dnu
}

// Each lane stages up to kBatch elements in registers before it stores
// any, so a copy waits for one round of device-memory latency per
// 32*kBatch floats instead of one per 32.
constexpr int kBatch = 8;

// Warp-wide coalesced copy of n floats.
__device__ __forceinline__ void warp_copy(float* __restrict__ dst,
                                          const float* __restrict__ src,
                                          int n, int lane) {
  for (int base = 0; base < n; base += 32 * kBatch) {
    float v[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int e = base + q * 32 + lane;
      v[q] = e < n ? src[e] : 0.0f;
    }
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int e = base + q * 32 + lane;
      if (e < n) dst[e] = v[q];
    }
  }
}

// Symmetric NS x NS stage matrix from its upper triangle, plus d on the
// diagonal.
__device__ __forceinline__ void warp_load_sym(float* __restrict__ dst,
                                              const float* __restrict__ src,
                                              int ns, float d, int lane) {
  const int n = ns * ns;
  for (int base = 0; base < n; base += 32 * kBatch) {
    float v[kBatch];
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int e = base + q * 32 + lane;
      v[q] = 0.0f;
      if (e < n && e / ns <= e % ns) v[q] = src[e];
    }
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
      const int e = base + q * 32 + lane;
      if (e >= n) continue;
      const int i = e / ns, j = e - i * ns;
      if (i < j) {
        dst[i * ns + j] = v[q];
        dst[j * ns + i] = v[q];
      } else if (i == j) {
        dst[e] = v[q] + d;
      }
    }
  }
}

// Cholesky of Q + d*I (n x n, lower triangle of Q read) into L and
// 1/diag(L).  A failed pivot (s <= 1e-12) is replaced by 1 so the factor
// stays finite; the return value says whether every pivot passed
// (_chol_factor_tiles).  One lane.
__device__ bool chol_factor(const float* __restrict__ Q, int n, float d,
                            float* __restrict__ L, float* __restrict__ inv_d) {
  bool ok = true;
  for (int i = 0; i < n; ++i) {
    float s = Q[i * n + i] + d;
    for (int q = 0; q < i; ++q) s -= L[i * n + q] * L[i * n + q];
    const bool good = s > 1e-12f;
    ok = ok && good;
    const float li = sqrtf(good ? s : 1.0f);
    L[i * n + i] = li;
    inv_d[i] = 1.0f / li;
    for (int j = i + 1; j < n; ++j) {
      float v = Q[j * n + i];
      for (int q = 0; q < i; ++q) v -= L[j * n + q] * L[i * n + q];
      L[j * n + i] = v * inv_d[i];
    }
  }
  return ok;
}

// The local-delta blend of _chol_solve_retry: factor at each bump while
// the pivot test fails, keep the first factor that passes (the delta=0
// factor when none does).  One lane.
__device__ bool chol_retry(const float* __restrict__ Q, int n,
                           float* __restrict__ L, float* __restrict__ inv_d) {
  bool ok = false;
  for (int level = 0; level < 3 && !ok; ++level)
    ok = chol_factor(Q, n, local_delta(level), L, inv_d);
  if (!ok) chol_factor(Q, n, 0.0f, L, inv_d);
  return ok;
}

// Solve (L L^T) x = b in place: x holds b on entry, its n entries `stride`
// floats apart.  One lane.
__device__ __forceinline__ void chol_solve(const float* __restrict__ L,
                                           const float* __restrict__ inv_d,
                                           int n, float* x, int stride) {
  for (int i = 0; i < n; ++i) {
    float v = x[i * stride];
    for (int q = 0; q < i; ++q) v -= L[i * n + q] * x[q * stride];
    x[i * stride] = v * inv_d[i];
  }
  for (int i = n - 1; i >= 0; --i) {
    float v = x[i * stride];
    for (int q = i + 1; q < n; ++q) v -= L[q * n + i] * x[q * stride];
    x[i * stride] = v * inv_d[i];
  }
}

// At most 64 registers a thread, so kMinBlocks blocks of 4 warps fit on an
// SM at once and B=4096 problems run in one wave on 132 SMs.
__global__ void __launch_bounds__(kMaxWarps * 32, kMinBlocks)
riccati_general_backward_kernel(
    const float* __restrict__ A, const float* __restrict__ Bm,
    const float* __restrict__ G, const float* __restrict__ M,
    const float* __restrict__ mx, const float* __restrict__ mu,
    const float* __restrict__ c, const float* __restrict__ delta,
    const float* __restrict__ dc, const float* __restrict__ E,
    const float* __restrict__ F, const float* __restrict__ h,
    float* __restrict__ gains, uint8_t* __restrict__ ok_out, int nbatch,
    int H, int nx, int nu, int R, int r) {
  extern __shared__ float smem[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * warps + warp;
  if (b >= nbatch) return;  // the whole warp leaves; no block barrier used
  const int ns = nx + nu, nxx = nx * nx, nxu = nx * nu;
  const int Rnx = R * nx, Rnu = R * nu, ng = gain_width(nx, nu, R, r);

  float* s = smem + warp * backward_floats(nx, nu, R, r);
  float* sA = s;
  float* sB = sA + nxx;
  float* sG = sB + nxu;
  float* sM = sG + ns * ns;         // M + delta*I
  float* smx = sM + ns * ns;        // (R, nx)
  float* smu = smx + Rnx;           // (R, nu)
  float* sc = smu + Rnu;            // (R, nx)
  float* sE = sc + Rnx;             // (r, nu)
  float* sF = sE + r * nu;          // (r, nx)
  float* sh = sF + r * nx;          // (R, r)
  float* sP = sh + R * r;
  float* sp = sP + nxx;             // (R, nx)
  float* sPb = sp + Rnx;
  float* spb = sPb + nxx;           // (R, nx)
  float* sPA = spb + Rnx;           // PA, then P_new
  float* sPB = sPA + nxx;
  float* sQxx = sPB + nxu;
  float* sQuu = sQxx + nxx;
  float* sQux = sQuu + nu * nu;
  float* sPcp = sQux + nxu;         // (R, nx)
  float* sqx = sPcp + Rnx;          // (R, nx)
  float* squ = sqx + Rnx;           // (R, nu)
  float* sL = squ + Rnu;
  float* sinv = sL + nu * nu;
  float* sK = sinv + nu;            // (nu, nx)
  float* sk = sK + nxu;             // (R, nu)
  float* sYt = sk + Rnu;            // Y^T (r, nu)
  float* sS = sYt + r * nu;         // (r, r)
  float* sLs = sS + r * r;
  float* sinvs = sLs + r * r;
  float* sKnu = sinvs + r;          // (r, nx)
  float* sknu = sKnu + r * nx;      // (R, r)

  const float d = delta[b];
  const float dcb = r > 0 ? dc[b] : 0.0f;
  for (int e = lane; e < nxx; e += 32) sP[e] = 0.0f;
  for (int e = lane; e < Rnx; e += 32) sp[e] = 0.0f;
  bool ok = true;   // kept by lane 0
  __syncwarp();

  for (int t = H - 1; t >= 0; --t) {
    const size_t st = static_cast<size_t>(b) * H + t;

    // ---- load the stage ----
    warp_copy(sA, A + st * nxx, nxx, lane);
    warp_copy(sB, Bm + st * nxu, nxu, lane);
    warp_load_sym(sG, G + st * ns * ns, ns, 0.0f, lane);
    warp_load_sym(sM, M + st * ns * ns, ns, d, lane);
    warp_copy(smx, mx + st * Rnx, Rnx, lane);
    warp_copy(smu, mu + st * Rnu, Rnu, lane);
    warp_copy(sc, c + st * Rnx, Rnx, lane);
    if (r > 0) {
      warp_copy(sE, E + st * r * nu, r * nu, lane);
      warp_copy(sF, F + st * r * nx, r * nx, lane);
      warp_copy(sh, h + st * R * r, R * r, lane);
    }
    __syncwarp();

    // ---- Pbar = P + Mxx, pbar = p + mx ----
    for (int e = lane; e < nxx; e += 32) {
      const int i = e / nx, j = e - i * nx;
      sPb[e] = sP[e] + sM[i * ns + j];
    }
    for (int e = lane; e < Rnx; e += 32) spb[e] = sp[e] + smx[e];
    __syncwarp();

    // ---- PA = Pbar A, PB = Pbar B, Pc_p = c Pbar^T + pbar ----
    for (int e = lane; e < nxx; e += 32) {
      const int i = e / nx, j = e - i * nx;
      float v = 0.0f;
      for (int k = 0; k < nx; ++k) v += sPb[i * nx + k] * sA[k * nx + j];
      sPA[e] = v;
    }
    for (int e = lane; e < nxu; e += 32) {
      const int i = e / nu, al = e - i * nu;
      float v = 0.0f;
      for (int k = 0; k < nx; ++k) v += sPb[i * nx + k] * sB[k * nu + al];
      sPB[e] = v;
    }
    for (int e = lane; e < Rnx; e += 32) {
      const int ri = e / nx, i = e - ri * nx;
      float v = 0.0f;
      for (int k = 0; k < nx; ++k) v += sPb[i * nx + k] * sc[ri * nx + k];
      sPcp[e] = v + spb[e];
    }
    __syncwarp();

    // ---- Qxx, Quu, Qux, qx, qu  (Mxu[k][al] = M[k][nx+al]) ----
    for (int e = lane; e < nxx; e += 32) {
      const int i = e / nx, j = e - i * nx;
      float v = 0.0f;
      for (int k = 0; k < nx; ++k) v += sA[k * nx + i] * sPA[k * nx + j];
      sQxx[e] = v + sG[i * ns + j];
    }
    for (int e = lane; e < nu * nu; e += 32) {
      const int al = e / nu, be = e - al * nu;
      float v = 0.0f, w_ab = 0.0f, w_ba = 0.0f;
      for (int k = 0; k < nx; ++k) {
        v += sB[k * nu + al] * sPB[k * nu + be];
        w_ab += sB[k * nu + al] * sM[k * ns + nx + be];
        w_ba += sB[k * nu + be] * sM[k * ns + nx + al];
      }
      sQuu[e] = v + sM[(nx + al) * ns + nx + be] + w_ab + w_ba
                + sG[(nx + al) * ns + nx + be];
    }
    for (int e = lane; e < nxu; e += 32) {
      const int al = e / nx, j = e - al * nx;
      float v = 0.0f, w = 0.0f;
      for (int k = 0; k < nx; ++k) {
        v += sB[k * nu + al] * sPA[k * nx + j];
        w += sM[k * ns + nx + al] * sA[k * nx + j];
      }
      sQux[e] = v + w + sG[(nx + al) * ns + j];
    }
    for (int e = lane; e < Rnx; e += 32) {
      const int ri = e / nx, i = e - ri * nx;
      float v = 0.0f;
      for (int k = 0; k < nx; ++k) v += sA[k * nx + i] * sPcp[ri * nx + k];
      sqx[e] = v;
    }
    for (int e = lane; e < Rnu; e += 32) {
      const int ri = e / nu, al = e - ri * nu;
      float v = 0.0f, w = 0.0f;
      for (int k = 0; k < nx; ++k) {
        v += sB[k * nu + al] * sPcp[ri * nx + k];
        w += sM[k * ns + nx + al] * sc[ri * nx + k];
      }
      squ[e] = v + w + smu[e];
    }
    __syncwarp();

    // ---- Cholesky of Quu with the local-delta blend ----
    if (lane == 0) ok = chol_retry(sQuu, nu, sL, sinv) && ok;
    __syncwarp();

    // ---- one factor, nx + R + r right-hand sides, one column a lane:
    //      K = -Quu^-1 Qux, k = -Quu^-1 qu, Y = Quu^-1 E^T ----
    for (int j = lane; j < nx + R + r; j += 32) {
      float* x;
      int stride;
      float sign = -1.0f;
      if (j < nx) {
        x = sK + j;
        stride = nx;
        for (int i = 0; i < nu; ++i) x[i * nx] = sQux[i * nx + j];
      } else if (j < nx + R) {
        x = sk + (j - nx) * nu;
        stride = 1;
        for (int i = 0; i < nu; ++i) x[i] = squ[(j - nx) * nu + i];
      } else {
        x = sYt + (j - nx - R) * nu;
        stride = 1;
        sign = 1.0f;
        for (int i = 0; i < nu; ++i) x[i] = sE[(j - nx - R) * nu + i];
      }
      chol_solve(sL, sinv, nu, x, stride);
      for (int i = 0; i < nu; ++i) x[i * stride] *= sign;
    }
    __syncwarp();

    if (r > 0) {
      // ---- S = sym(E Y) + delta_c I, factored with its own retry ----
      for (int e = lane; e < r * r; e += 32) {
        const int i = e / r, j = e - i * r;
        float v_ij = 0.0f, v_ji = 0.0f;
        for (int al = 0; al < nu; ++al) {
          v_ij += sE[i * nu + al] * sYt[j * nu + al];
          v_ji += sE[j * nu + al] * sYt[i * nu + al];
        }
        sS[e] = 0.5f * (v_ij + v_ji) + (i == j ? dcb : 0.0f);
      }
      __syncwarp();
      if (lane == 0) ok = chol_retry(sS, r, sLs, sinvs) && ok;
      __syncwarp();

      // ---- Knu = S^-1 (E K + F), knu = S^-1 (E k - h), one column a
      //      lane, then K -= Y Knu, k -= Y knu ----
      for (int j = lane; j < nx + R; j += 32) {
        float* x;
        int stride;
        if (j < nx) {
          x = sKnu + j;
          stride = nx;
          for (int i = 0; i < r; ++i) {
            float v = sF[i * nx + j];
            for (int al = 0; al < nu; ++al)
              v += sE[i * nu + al] * sK[al * nx + j];
            x[i * nx] = v;
          }
        } else {
          const int ri = j - nx;
          x = sknu + ri * r;
          stride = 1;
          for (int i = 0; i < r; ++i) {
            float v = -sh[ri * r + i];
            for (int al = 0; al < nu; ++al)
              v += sE[i * nu + al] * sk[ri * nu + al];
            x[i] = v;
          }
        }
        chol_solve(sLs, sinvs, r, x, stride);
      }
      __syncwarp();
      for (int e = lane; e < nxu; e += 32) {
        const int al = e / nx, j = e - al * nx;
        float v = 0.0f;
        for (int i = 0; i < r; ++i) v += sYt[i * nu + al] * sKnu[i * nx + j];
        sK[e] -= v;
      }
      for (int e = lane; e < Rnu; e += 32) {
        const int ri = e / nu, al = e - ri * nu;
        float v = 0.0f;
        for (int i = 0; i < r; ++i) v += sYt[i * nu + al] * sknu[ri * r + i];
        sk[e] -= v;
      }
      __syncwarp();
    }

    // ---- stream the stage's gains [K | k | Pbar | pbar | Mxu | Knu |
    //      knu]; P_new = Qxx + Qux' K + F' Knu, p = qx + Qux' k + F' knu
    float* gn = gains + st * ng;
    warp_copy(gn, sK, nxu, lane);
    warp_copy(gn + nxu, sk, Rnu, lane);
    warp_copy(gn + nxu + Rnu, sPb, nxx, lane);
    warp_copy(gn + nxu + Rnu + nxx, spb, Rnx, lane);
    float* gM = gn + nxu + Rnu + nxx + Rnx;
    for (int e = lane; e < nxu; e += 32) {
      const int i = e / nu, al = e - i * nu;
      gM[e] = sM[i * ns + nx + al];
    }
    if (r > 0) {
      warp_copy(gM + nxu, sKnu, r * nx, lane);
      warp_copy(gM + nxu + r * nx, sknu, R * r, lane);
    }
    for (int e = lane; e < nxx; e += 32) {
      const int i = e / nx, j = e - i * nx;
      float v = 0.0f, w = 0.0f;
      for (int al = 0; al < nu; ++al) v += sQux[al * nx + i] * sK[al * nx + j];
      for (int q = 0; q < r; ++q) w += sF[q * nx + i] * sKnu[q * nx + j];
      sPA[e] = sQxx[e] + v + w;
    }
    for (int e = lane; e < Rnx; e += 32) {
      const int ri = e / nx, i = e - ri * nx;
      float v = 0.0f, w = 0.0f;
      for (int al = 0; al < nu; ++al) v += sk[ri * nu + al] * sQux[al * nx + i];
      for (int q = 0; q < r; ++q) w += sknu[ri * r + q] * sF[q * nx + i];
      sp[e] = sqx[e] + v + w;
    }
    __syncwarp();

    // ---- P = (P_new + P_new') / 2 ----
    for (int e = lane; e < nxx; e += 32) {
      const int i = e / nx, j = e - i * nx;
      sP[e] = 0.5f * (sPA[e] + sPA[j * nx + i]);
    }
    __syncwarp();
  }
  if (lane == 0) ok_out[b] = ok ? 1 : 0;
}

__global__ void __launch_bounds__(kMaxWarps * 32)
riccati_general_forward_kernel(
    const float* __restrict__ A, const float* __restrict__ Bm,
    const float* __restrict__ c, const float* __restrict__ Jx,
    const float* __restrict__ gains, float* __restrict__ dX,
    float* __restrict__ dU, float* __restrict__ dLam,
    float* __restrict__ dNu, int nbatch, int H, int nx, int nu, int R,
    int r) {
  extern __shared__ float smem[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * warps + warp;
  if (b >= nbatch) return;
  const int nxx = nx * nx, nxu = nx * nu, Rnx = R * nx, Rnu = R * nu;
  const int ng = gain_width(nx, nu, R, r);

  float* s = smem + warp * forward_floats(nx, nu, R, r);
  float* sA = s;
  float* sB = sA + nxx;
  float* sc = sB + nxu;             // (R, nx)
  float* sJx = sc + Rnx;            // (r, nx)
  float* sg = sJx + r * nx;
  float* sdx = sg + ng;             // (R, nx)
  float* sdxn = sdx + Rnx;          // (R, nx)
  float* sdu = sdxn + Rnx;          // (R, nu)
  float* sdnu = sdu + Rnu;          // (R, r)
  const float* sK = sg;
  const float* sk = sK + nxu;
  const float* sPb = sk + Rnu;
  const float* spb = sPb + nxx;
  const float* sMxu = spb + Rnx;
  const float* sKnu = sMxu + nxu;
  const float* sknu = sKnu + r * nx;

  for (int e = lane; e < Rnx; e += 32) sdx[e] = 0.0f;

  for (int t = 0; t < H; ++t) {
    const size_t st = static_cast<size_t>(b) * H + t;
    warp_copy(sA, A + st * nxx, nxx, lane);
    warp_copy(sB, Bm + st * nxu, nxu, lane);
    warp_copy(sc, c + st * Rnx, Rnx, lane);
    if (r > 0) warp_copy(sJx, Jx + st * r * nx, r * nx, lane);
    warp_copy(sg, gains + st * ng, ng, lane);
    __syncwarp();

    // du = K dx + k, dnu = Knu dx + knu, per right-hand side
    for (int e = lane; e < Rnu; e += 32) {
      const int ri = e / nu, al = e - ri * nu;
      float v = 0.0f;
      for (int j = 0; j < nx; ++j) v += sK[al * nx + j] * sdx[ri * nx + j];
      sdu[e] = v + sk[e];
      dU[st * Rnu + e] = sdu[e];
    }
    for (int e = lane; e < R * r; e += 32) {
      const int ri = e / r, q = e - ri * r;
      float v = 0.0f;
      for (int j = 0; j < nx; ++j) v += sKnu[q * nx + j] * sdx[ri * nx + j];
      sdnu[e] = v + sknu[e];
      dNu[st * R * r + e] = sdnu[e];
    }
    __syncwarp();

    // dx' = A dx + B du + c
    for (int e = lane; e < Rnx; e += 32) {
      const int ri = e / nx, i = e - ri * nx;
      float v = 0.0f, w = 0.0f;
      for (int j = 0; j < nx; ++j) v += sA[i * nx + j] * sdx[ri * nx + j];
      for (int al = 0; al < nu; ++al) w += sB[i * nu + al] * sdu[ri * nu + al];
      sdxn[e] = v + w + sc[e];
      dX[st * Rnx + e] = sdxn[e];
    }
    __syncwarp();

    // dlam = Pbar dx' + Mxu du + pbar + Jx^T dnu; then dx = dx'
    for (int e = lane; e < Rnx; e += 32) {
      const int ri = e / nx, i = e - ri * nx;
      float v = 0.0f, w = 0.0f, z = 0.0f;
      for (int j = 0; j < nx; ++j) v += sPb[i * nx + j] * sdxn[ri * nx + j];
      for (int al = 0; al < nu; ++al)
        w += sMxu[i * nu + al] * sdu[ri * nu + al];
      for (int q = 0; q < r; ++q) z += sdnu[ri * r + q] * sJx[q * nx + i];
      dLam[st * Rnx + e] = v + w + spb[e] + z;
      sdx[e] = sdxn[e];
    }
    __syncwarp();
  }
}

// Checks the dims and picks the warps a block: as many as fit the device's
// opt-in shared memory a block, at most kMaxWarps.
cudaError_t plan_launch(int nbatch, int H, int nx, int nu, int R, int r,
                        int device, int floats_per_warp, int* warps) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (nbatch <= 0 || H <= 0 || nx < 1 || nx > kMaxNx || nu < 1 ||
      nu > kMaxNu || R < 1 || R > kMaxR || r < 0 || r > nu)
    return cudaErrorInvalidValue;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return err;
  const size_t per_warp = sizeof(float) * static_cast<size_t>(floats_per_warp);
  int w = static_cast<int>(static_cast<size_t>(optin) / per_warp);
  if (w < 1) return cudaErrorInvalidValue;
  *warps = w < kMaxWarps ? w : kMaxWarps;
  return cudaSuccess;
}

// The run-time kernel at any (nx, nu, R, r) in range.
cudaError_t backward_runtime(
    const void* A, const void* Bm, const void* G, const void* M,
    const void* mx, const void* mu, const void* c, const void* delta,
    const void* dc, const void* E, const void* F, const void* h, void* gains,
    void* ok, int nbatch, int H, int nx, int nu, int R, int r, int device,
    cudaStream_t stream) {
  const int fpw = backward_floats(nx, nu, R, r);
  int warps = 0;
  cudaError_t err = plan_launch(nbatch, H, nx, nu, R, r, device, fpw, &warps);
  if (err != cudaSuccess) return err;
  const size_t smem = sizeof(float) * static_cast<size_t>(warps) * fpw;
  err = reserve_smem(riccati_general_backward_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((nbatch + warps - 1) / warps);
  riccati_general_backward_kernel<<<grid, warps * 32, smem, stream>>>(
      static_cast<const float*>(A), static_cast<const float*>(Bm),
      static_cast<const float*>(G), static_cast<const float*>(M),
      static_cast<const float*>(mx), static_cast<const float*>(mu),
      static_cast<const float*>(c), static_cast<const float*>(delta),
      static_cast<const float*>(dc), static_cast<const float*>(E),
      static_cast<const float*>(F), static_cast<const float*>(h),
      static_cast<float*>(gains), static_cast<uint8_t*>(ok), nbatch, H, nx,
      nu, R, r);
  return cudaGetLastError();
}

// The run-time forward kernel at any (nx, nu, R, r) in range.
cudaError_t forward_runtime(const void* A, const void* Bm, const void* c,
                            const void* Jx, const void* gains, void* dX,
                            void* dU, void* dLam, void* dNu, int nbatch,
                            int H, int nx, int nu, int R, int r, int device,
                            cudaStream_t stream) {
  const int fpw = forward_floats(nx, nu, R, r);
  int warps = 0;
  cudaError_t err = plan_launch(nbatch, H, nx, nu, R, r, device, fpw, &warps);
  if (err != cudaSuccess) return err;
  const size_t smem = sizeof(float) * static_cast<size_t>(warps) * fpw;
  err = reserve_smem(riccati_general_forward_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((nbatch + warps - 1) / warps);
  riccati_general_forward_kernel<<<grid, warps * 32, smem, stream>>>(
      static_cast<const float*>(A), static_cast<const float*>(Bm),
      static_cast<const float*>(c), static_cast<const float*>(Jx),
      static_cast<const float*>(gains), static_cast<float*>(dX),
      static_cast<float*>(dU), static_cast<float*>(dLam),
      static_cast<float*>(dNu), nbatch, H, nx, nu, R, r);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes).  Each launches on `stream` of
// `device` and returns the launch's cudaError_t (0 on success); dims
// outside 1 <= nx <= 32, 1 <= nu <= 16, 1 <= R <= 65, 0 <= r <= nu return
// cudaErrorInvalidValue.  With r = 0, E, F, h (backward) and Jx, dNu
// (forward) are not read or written.
//
// riccati_general_backward_f32 launches the compile-time instance for the
// (nx, nu, R, r) below and the run-time kernel for any other; this list and
// `_GENERAL_BACKWARD_INSTANCES` in ops/cuda/riccati_kernel.py must agree.
// riccati_general_backward_runtime_f32 launches the run-time kernel at any
// shape, so that the two designs can be held against each other.
extern "C" int riccati_general_backward_f32(
    const void* A, const void* Bm, const void* G, const void* M,
    const void* mx, const void* mu, const void* c, const void* delta,
    const void* dc, const void* E, const void* F, const void* h, void* gains,
    void* ok, int nbatch, int H, int nx, int nu, int R, int r, int device,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RICCATI_GENERAL_BACKWARD_CASE(NX_, NU_, R_, RE_)                    \
  if (nx == NX_ && nu == NU_ && R == R_ && r == RE_)                        \
    return static_cast<int>(backward_fixed<NX_, NU_, R_, RE_>(              \
        A, Bm, G, M, mx, mu, c, delta, dc, E, F, h, gains, ok, nbatch, H,   \
        device, s));
  RICCATI_GENERAL_BACKWARD_CASE(12, 4, 2, 1)
#undef RICCATI_GENERAL_BACKWARD_CASE
  return static_cast<int>(backward_runtime(A, Bm, G, M, mx, mu, c, delta, dc,
                                           E, F, h, gains, ok, nbatch, H, nx,
                                           nu, R, r, device, s));
}

extern "C" int riccati_general_backward_runtime_f32(
    const void* A, const void* Bm, const void* G, const void* M,
    const void* mx, const void* mu, const void* c, const void* delta,
    const void* dc, const void* E, const void* F, const void* h, void* gains,
    void* ok, int nbatch, int H, int nx, int nu, int R, int r, int device,
    void* stream) {
  return static_cast<int>(backward_runtime(
      A, Bm, G, M, mx, mu, c, delta, dc, E, F, h, gains, ok, nbatch, H, nx,
      nu, R, r, device, static_cast<cudaStream_t>(stream)));
}

// riccati_general_forward_f32 likewise launches the forward instance for
// the (nx, nu, R, r) below, with the ring depth D named beside it, and the
// run-time kernel for any other; this list and
// `_GENERAL_FORWARD_INSTANCES` in ops/cuda/riccati_kernel.py (shape ->
// depth) must agree.  Depths 2 and 3 timed the same within 1% at
// (12, 4, 2, 1) on an H100 (PERF.md); 2 takes the less shared memory.  The
// instance takes inputs at any 4-byte alignment.
// riccati_general_forward_runtime_f32 launches the run-time kernel at any
// shape.
extern "C" int riccati_general_forward_f32(
    const void* A, const void* Bm, const void* c, const void* Jx,
    const void* gains, void* dX, void* dU, void* dLam, void* dNu, int nbatch,
    int H, int nx, int nu, int R, int r, int device, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RICCATI_GENERAL_FORWARD_CASE(NX_, NU_, R_, RE_, D_)                 \
  if (nx == NX_ && nu == NU_ && R == R_ && r == RE_)                        \
    return static_cast<int>(forward_fixed<NX_, NU_, R_, RE_, D_>(           \
        A, Bm, c, Jx, gains, dX, dU, dLam, dNu, nbatch, H, device, s));
  RICCATI_GENERAL_FORWARD_CASE(12, 4, 2, 1, 2)
#undef RICCATI_GENERAL_FORWARD_CASE
  return static_cast<int>(forward_runtime(A, Bm, c, Jx, gains, dX, dU, dLam,
                                          dNu, nbatch, H, nx, nu, R, r,
                                          device, s));
}

extern "C" int riccati_general_forward_runtime_f32(
    const void* A, const void* Bm, const void* c, const void* Jx,
    const void* gains, void* dX, void* dU, void* dLam, void* dNu, int nbatch,
    int H, int nx, int nu, int R, int r, int device, void* stream) {
  return static_cast<int>(forward_runtime(
      A, Bm, c, Jx, gains, dX, dU, dLam, dNu, nbatch, H, nx, nu, R, r,
      device, static_cast<cudaStream_t>(stream)));
}
