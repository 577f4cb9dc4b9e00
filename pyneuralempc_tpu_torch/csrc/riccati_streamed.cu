// Streamed plain Riccati sweep for Hopper (sm_90a): a backward kernel that
// writes every stage's gains to device memory, and a forward kernel that
// reads them back.  One warp per problem, stage widths (nx, nu) at run time.
//
// Replaces pyneuralempc_tpu/ops/pallas/riccati_kernel.py
// `_riccati_pallas_call`'s streamed pair: the backward call (:468, body
// `_backward_kernel` :191-302, with the per-problem local-delta Cholesky
// retry of `_chol_solve_retry` :158-188) and the forward call (:488, body
// `_forward_kernel` :305-337).  The plain PyTorch versions of the same
// functions are `riccati_backward_plain` and `riccati_forward_plain` in
// pyneuralempc_tpu_torch/ops/cuda/riccati_kernel.py.
//
// What bounds them on an H100: bytes.  At B=4096, H=50, nx=12, nu=4 the
// backward kernel must read A, B, the upper triangles of G and M, mx, mu, c
// (492 floats a stage) and write the gains (256 floats a stage): ~613 MB,
// ~183 us at 3.35 TB/s, against ~3.0 GFLOP (~44 us at 67 TFLOP/s in f32).  The forward kernel
// reads A, B, c and the gains (460 floats a stage) and writes dX, dU, dLam
// (28): ~400 MB, ~119 us, for ~0.18 GFLOP.
//
// Design.  A problem's stages form a serial chain, so the parallelism is
// across problems and, inside a problem, across the entries of each
// stage's small matrix products.  One thread per problem (as in
// riccati_sweep.cu) would hold P, Pbar, PA and Qxx (4 x 144 floats at
// nx=12) in registers and spill; so each problem gets one warp, and its
// stage lives in dynamic shared memory sized at launch from (nx, nu)
// (~6 KB a warp at (12, 4)).  Each stage is loaded with coalesced warp-wide
// copies, each lane holding several loads in flight (the upper triangles of
// G and M only, mirrored in shared memory);
// each product spreads its output entries over the 32 lanes, with
// __syncwarp() between phases.  Quu's Cholesky runs on lane 0; the nx+1
// substitutions (K's columns and k) run one column per lane.  The
// value-function carry (P, p) stays in shared memory across stages, as the
// TPU kernel kept it in VMEM scratch across grid steps; the gains, which
// the TPU kernel streamed to HBM between its two calls, go to device
// memory here too.  Warps never share data, so no block-level barrier is
// used.  The backward kernel is capped at 64 registers so that all 4096
// problems of the quadrotor fleet are resident at once (8 blocks of 4
// warps an SM).
//
// The backward entry launches a compile-time instance of the backward
// kernel at the quadrotor's (12, 4), the GRU fleet's lifted (10, 1),
// cartpole's (4, 1), the wide fleet's (12, 10), the LSTM fleet's lifted
// (18, 1) and the quadrotor GRU's lifted (28, 4):
// riccati_general_backward_fixed<NX, NU, 1, 0>, the general
// sweep's template (riccati_backward_fixed.cuh, shared with
// csrc/riccati_general.cu) at one right-hand side and no equality rows,
// which computes this backward kernel's function with the stage's widths
// fixed, operands reused from registers, G and M read as packed triangles
// and four __syncwarp() phases a stage instead of ~20 (six at (12, 10):
// Quu factored one row a lane, in one stage buffer a warp; six at
// (18, 1) and (28, 4): Pbar formed in place of P_new before tiles of the
// products, in one stage buffer a warp; at (28, 4) 16,864 bytes a warp, so
// three blocks of four warps an SM and not eight).  The forward entry
// likewise launches riccati_general_forward_fixed<NX, NU, 1, 0, D>
// (riccati_forward_fixed.cuh, shared too) at the first four shapes and at
// (28, 4): each warp's stage inputs requested D stages ahead into a ring of
// stage slots, dx in registers (at (28, 4) 7,920 bytes a slot, so the
// three slots of a warp leave room for two blocks an SM).  The run-time
// kernels below take every other (nx, nu).
//
// Layouts (all float32, C-contiguous, batch first):
//   A (B,H,NX,NX)  Bm (B,H,NX,NU)  G, M (B,H,NS,NS) symmetric, of which only
//   the upper triangle (i <= j) is read  mx (B,H,NX)  mu (B,H,NU)
//   c (B,H,NX)  delta (B,)
//   gains (B,H,NG), each stage [K (NU,NX) | k (NU) | Pbar (NX,NX) |
//   pbar (NX) | Mxu (NX,NU)], NG = NU*NX + NU + NX*NX + NX + NX*NU
//   ok (B,) as 0/1 bytes   dX (B,H,NX)  dU (B,H,NU)  dLam (B,H,NX)

#include <cuda_runtime.h>
#include <stdint.h>

#include "riccati_backward_fixed.cuh"
#include "riccati_forward_fixed.cuh"

namespace {

constexpr int kMaxNx = 32;           // forward kernel: one lane per row
constexpr int kMaxNu = 16;           // the reference kernel's own cap

__host__ __device__ __forceinline__ int gain_width(int nx, int nu) {
  return nu * nx + nu + nx * nx + nx + nx * nu;
}

// Floats of shared memory one warp of the backward kernel uses.
__host__ __device__ __forceinline__ int backward_floats(int nx, int nu) {
  const int ns = nx + nu;
  return 5 * nx * nx          // A, P, Pbar, PA (then P_new), Qxx
         + 4 * nx * nu        // B, PB, Qux, K
         + 2 * ns * ns        // G, M
         + 6 * nx             // mx, c, p, pbar, Pc_p, qx
         + 2 * nu * nu        // Quu, L
         + 4 * nu;            // mu, qu, 1/diag(L), k
}

// Floats of shared memory one warp of the forward kernel uses.
__host__ __device__ __forceinline__ int forward_floats(int nx, int nu) {
  return nx * nx + nx * nu + nx + gain_width(nx, nu) + nx + nu;
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
    for (int r = 0; r < kBatch; ++r) {
      const int e = base + r * 32 + lane;
      v[r] = e < n ? src[e] : 0.0f;
    }
#pragma unroll
    for (int r = 0; r < kBatch; ++r) {
      const int e = base + r * 32 + lane;
      if (e < n) dst[e] = v[r];
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
    for (int r = 0; r < kBatch; ++r) {
      const int e = base + r * 32 + lane;
      v[r] = 0.0f;
      if (e < n && e / ns <= e % ns) v[r] = src[e];
    }
#pragma unroll
    for (int r = 0; r < kBatch; ++r) {
      const int e = base + r * 32 + lane;
      if (e >= n) continue;
      const int i = e / ns, j = e - i * ns;
      if (i < j) {
        dst[i * ns + j] = v[r];
        dst[j * ns + i] = v[r];
      } else if (i == j) {
        dst[e] = v[r] + d;
      }
    }
  }
}

// Cholesky of Q + d*I (nu x nu, lower triangle of Q read) into L and
// 1/diag(L).  A failed pivot (s <= 1e-12) is replaced by 1 so the factor
// stays finite; the return value says whether every pivot passed
// (_chol_factor_tiles).  One lane.
__device__ bool chol_factor(const float* __restrict__ Q, int nu, float d,
                            float* __restrict__ L, float* __restrict__ inv_d) {
  bool ok = true;
  for (int i = 0; i < nu; ++i) {
    float s = Q[i * nu + i] + d;
    for (int q = 0; q < i; ++q) s -= L[i * nu + q] * L[i * nu + q];
    const bool good = s > 1e-12f;
    ok = ok && good;
    const float li = sqrtf(good ? s : 1.0f);
    L[i * nu + i] = li;
    inv_d[i] = 1.0f / li;
    for (int j = i + 1; j < nu; ++j) {
      float v = Q[j * nu + i];
      for (int q = 0; q < i; ++q) v -= L[j * nu + q] * L[i * nu + q];
      L[j * nu + i] = v * inv_d[i];
    }
  }
  return ok;
}

// At most 64 registers a thread, so kMinBlocks blocks (32 problems) fit
// on an SM at once and B=4096 problems run in one wave on 132 SMs; left
// free, nvcc takes 96 and the launch runs in two.
__global__ void __launch_bounds__(kMaxWarps * 32, kMinBlocks)
riccati_backward_kernel(const float* __restrict__ A,
                        const float* __restrict__ Bm,
                        const float* __restrict__ G,
                        const float* __restrict__ M,
                        const float* __restrict__ mx,
                        const float* __restrict__ mu,
                        const float* __restrict__ c,
                        const float* __restrict__ delta,
                        float* __restrict__ gains,
                        uint8_t* __restrict__ ok_out, int nbatch, int H,
                        int nx, int nu) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * kMaxWarps + warp;
  if (b >= nbatch) return;  // the whole warp leaves; no block barrier used
  const int ns = nx + nu, nxx = nx * nx, nxu = nx * nu;
  const int ng = gain_width(nx, nu);

  float* s = smem + warp * backward_floats(nx, nu);
  float* sA = s;
  float* sB = sA + nxx;
  float* sG = sB + nxu;
  float* sM = sG + ns * ns;         // M + delta*I
  float* smx = sM + ns * ns;
  float* smu = smx + nx;
  float* sc = smu + nu;
  float* sP = sc + nx;
  float* sp = sP + nxx;
  float* sPb = sp + nx;
  float* spb = sPb + nxx;
  float* sPA = spb + nx;            // PA, then P_new
  float* sPB = sPA + nxx;
  float* sQxx = sPB + nxu;
  float* sQuu = sQxx + nxx;
  float* sQux = sQuu + nu * nu;
  float* sPcp = sQux + nxu;
  float* sqx = sPcp + nx;
  float* squ = sqx + nx;
  float* sL = squ + nu;
  float* sinv = sL + nu * nu;
  float* sK = sinv + nu;
  float* sk = sK + nxu;

  const float d = delta[b];
  for (int e = lane; e < nxx; e += 32) sP[e] = 0.0f;
  for (int e = lane; e < nx; e += 32) sp[e] = 0.0f;
  bool ok = true;   // kept by lane 0
  __syncwarp();

  for (int t = H - 1; t >= 0; --t) {
    const size_t st = static_cast<size_t>(b) * H + t;

    // ---- load the stage ----
    warp_copy(sA, A + st * nxx, nxx, lane);
    warp_copy(sB, Bm + st * nxu, nxu, lane);
    warp_load_sym(sG, G + st * ns * ns, ns, 0.0f, lane);
    warp_load_sym(sM, M + st * ns * ns, ns, d, lane);
    warp_copy(smx, mx + st * nx, nx, lane);
    warp_copy(smu, mu + st * nu, nu, lane);
    warp_copy(sc, c + st * nx, nx, lane);
    __syncwarp();

    // ---- Pbar = P + Mxx, pbar = p + mx ----
    for (int e = lane; e < nxx; e += 32) {
      const int i = e / nx, j = e - i * nx;
      sPb[e] = sP[e] + sM[i * ns + j];
    }
    for (int i = lane; i < nx; i += 32) spb[i] = sp[i] + smx[i];
    __syncwarp();

    // ---- PA = Pbar A, PB = Pbar B, Pc_p = Pbar c + pbar ----
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
    for (int i = lane; i < nx; i += 32) {
      float v = 0.0f;
      for (int k = 0; k < nx; ++k) v += sPb[i * nx + k] * sc[k];
      sPcp[i] = v + spb[i];
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
    for (int i = lane; i < nx; i += 32) {
      float v = 0.0f;
      for (int k = 0; k < nx; ++k) v += sA[k * nx + i] * sPcp[k];
      sqx[i] = v;
    }
    for (int al = lane; al < nu; al += 32) {
      float v = 0.0f, w = 0.0f;
      for (int k = 0; k < nx; ++k) {
        v += sB[k * nu + al] * sPcp[k];
        w += sM[k * ns + nx + al] * sc[k];
      }
      squ[al] = v + w + smu[al];
    }
    __syncwarp();

    // ---- Cholesky of Quu with the local-delta blend of
    //      _chol_solve_retry: factor at each bump while the pivot test
    //      fails, keep the first factor that passes (the delta=0 factor
    //      when none does) ----
    if (lane == 0) {
      bool ok_t = false;
      for (int level = 0; level < 3 && !ok_t; ++level)
        ok_t = chol_factor(sQuu, nu, local_delta(level), sL, sinv);
      if (!ok_t) chol_factor(sQuu, nu, 0.0f, sL, sinv);
      ok = ok && ok_t;
    }
    __syncwarp();

    // ---- [K | k] = -Quu^-1 [Qux | qu]: one column per lane, forward
    //      then back substitution in place in the output column ----
    for (int j = lane; j <= nx; j += 32) {
      const float* rhs = j < nx ? sQux + j : squ;
      float* x = j < nx ? sK + j : sk;
      const int stride = j < nx ? nx : 1;
      for (int i = 0; i < nu; ++i) {
        float v = rhs[i * stride];
        for (int q = 0; q < i; ++q) v -= sL[i * nu + q] * x[q * stride];
        x[i * stride] = v * sinv[i];
      }
      for (int i = nu - 1; i >= 0; --i) {
        float v = x[i * stride];
        for (int q = i + 1; q < nu; ++q) v -= sL[q * nu + i] * x[q * stride];
        x[i * stride] = v * sinv[i];
      }
      for (int i = 0; i < nu; ++i) x[i * stride] = -x[i * stride];
    }
    __syncwarp();

    // ---- stream the stage's gains [K | k | Pbar | pbar | Mxu];
    //      P_new = Qxx + Qux' K, p = qx + Qux' k ----
    float* gn = gains + st * ng;
    warp_copy(gn, sK, nxu, lane);
    warp_copy(gn + nxu, sk, nu, lane);
    warp_copy(gn + nxu + nu, sPb, nxx, lane);
    warp_copy(gn + nxu + nu + nxx, spb, nx, lane);
    float* gM = gn + nxu + nu + nxx + nx;
    for (int e = lane; e < nxu; e += 32) {
      const int i = e / nu, al = e - i * nu;
      gM[e] = sM[i * ns + nx + al];
    }
    for (int e = lane; e < nxx; e += 32) {
      const int i = e / nx, j = e - i * nx;
      float v = 0.0f;
      for (int al = 0; al < nu; ++al) v += sQux[al * nx + i] * sK[al * nx + j];
      sPA[e] = sQxx[e] + v;
    }
    for (int i = lane; i < nx; i += 32) {
      float v = 0.0f;
      for (int al = 0; al < nu; ++al) v += sQux[al * nx + i] * sk[al];
      sp[i] = sqx[i] + v;
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
riccati_forward_kernel(const float* __restrict__ A,
                       const float* __restrict__ Bm,
                       const float* __restrict__ c,
                       const float* __restrict__ gains,
                       float* __restrict__ dX, float* __restrict__ dU,
                       float* __restrict__ dLam, int nbatch, int H, int nx,
                       int nu) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * kMaxWarps + warp;
  if (b >= nbatch) return;
  const int nxx = nx * nx, nxu = nx * nu, ng = gain_width(nx, nu);

  float* s = smem + warp * forward_floats(nx, nu);
  float* sA = s;
  float* sB = sA + nxx;
  float* sc = sB + nxu;
  float* sg = sc + nx;
  float* sdx = sg + ng;
  float* sdu = sdx + nx;
  const float* sK = sg;
  const float* sk = sK + nxu;
  const float* sPb = sk + nu;
  const float* spb = sPb + nxx;
  const float* sMxu = spb + nx;

  for (int i = lane; i < nx; i += 32) sdx[i] = 0.0f;

  for (int t = 0; t < H; ++t) {
    const size_t st = static_cast<size_t>(b) * H + t;
    warp_copy(sA, A + st * nxx, nxx, lane);
    warp_copy(sB, Bm + st * nxu, nxu, lane);
    warp_copy(sc, c + st * nx, nx, lane);
    warp_copy(sg, gains + st * ng, ng, lane);
    __syncwarp();

    // du = K dx + k
    if (lane < nu) {
      float v = 0.0f;
      for (int j = 0; j < nx; ++j) v += sK[lane * nx + j] * sdx[j];
      sdu[lane] = v + sk[lane];
    }
    __syncwarp();

    // dx' = A dx + B du + c
    float dxn = 0.0f;
    if (lane < nx) {
      float v = 0.0f, w = 0.0f;
      for (int j = 0; j < nx; ++j) v += sA[lane * nx + j] * sdx[j];
      for (int al = 0; al < nu; ++al) w += sB[lane * nu + al] * sdu[al];
      dxn = v + w + sc[lane];
    }
    __syncwarp();
    if (lane < nx) sdx[lane] = dxn;
    __syncwarp();

    // dlam = Pbar dx' + Mxu du + pbar
    if (lane < nx) {
      float v = 0.0f, w = 0.0f;
      for (int j = 0; j < nx; ++j) v += sPb[lane * nx + j] * sdx[j];
      for (int al = 0; al < nu; ++al) w += sMxu[lane * nu + al] * sdu[al];
      dLam[st * nx + lane] = v + w + spb[lane];
      dX[st * nx + lane] = dxn;
    }
    if (lane < nu) dU[st * nu + lane] = sdu[lane];
    __syncwarp();
  }
}

cudaError_t check_args(int nbatch, int H, int nx, int nu, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (nbatch <= 0 || H <= 0 || nx < 1 || nx > kMaxNx || nu < 1 ||
      nu > kMaxNu)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

// The run-time backward kernel at any (nx, nu) in range.
cudaError_t backward_runtime(const void* A, const void* Bm, const void* G,
                             const void* M, const void* mx, const void* mu,
                             const void* c, const void* delta, void* gains,
                             void* ok, int nbatch, int H, int nx, int nu,
                             int device, cudaStream_t stream) {
  cudaError_t err = check_args(nbatch, H, nx, nu, device);
  if (err != cudaSuccess) return err;
  const size_t smem = sizeof(float) * kMaxWarps * backward_floats(nx, nu);
  err = reserve_smem(riccati_backward_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((nbatch + kMaxWarps - 1) / kMaxWarps);
  riccati_backward_kernel<<<grid, kMaxWarps * 32, smem, stream>>>(
      static_cast<const float*>(A), static_cast<const float*>(Bm),
      static_cast<const float*>(G), static_cast<const float*>(M),
      static_cast<const float*>(mx), static_cast<const float*>(mu),
      static_cast<const float*>(c), static_cast<const float*>(delta),
      static_cast<float*>(gains), static_cast<uint8_t*>(ok), nbatch, H, nx,
      nu);
  return cudaGetLastError();
}

// The run-time forward kernel at any (nx, nu) in range.
cudaError_t forward_runtime(const void* A, const void* Bm, const void* c,
                            const void* gains, void* dX, void* dU,
                            void* dLam, int nbatch, int H, int nx, int nu,
                            int device, cudaStream_t stream) {
  cudaError_t err = check_args(nbatch, H, nx, nu, device);
  if (err != cudaSuccess) return err;
  const size_t smem = sizeof(float) * kMaxWarps * forward_floats(nx, nu);
  err = reserve_smem(riccati_forward_kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((nbatch + kMaxWarps - 1) / kMaxWarps);
  riccati_forward_kernel<<<grid, kMaxWarps * 32, smem, stream>>>(
      static_cast<const float*>(A), static_cast<const float*>(Bm),
      static_cast<const float*>(c), static_cast<const float*>(gains),
      static_cast<float*>(dX), static_cast<float*>(dU),
      static_cast<float*>(dLam), nbatch, H, nx, nu);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry points (bound with ctypes).  Each launches on `stream` of
// `device` and returns the launch's cudaError_t (0 on success); dims
// outside 1 <= nx <= 32, 1 <= nu <= 16 return cudaErrorInvalidValue.
//
// riccati_backward_f32 launches the compile-time instance
// riccati_general_backward_fixed<NX, NU, 1, 0> for the (nx, nu) below and
// the run-time kernel for any other; this list and `_BACKWARD_INSTANCES` in
// ops/cuda/riccati_kernel.py must agree.  At one right-hand side mx and c
// are laid out as the general sweep's, and with no equality rows the
// instance reads no E, F, h or dc (delta stands in for dc).
// riccati_backward_runtime_f32 launches the run-time kernel at any shape,
// so that the two designs can be held against each other.
extern "C" int riccati_backward_f32(const void* A, const void* Bm,
                                    const void* G, const void* M,
                                    const void* mx, const void* mu,
                                    const void* c, const void* delta,
                                    void* gains, void* ok, int nbatch, int H,
                                    int nx, int nu, int device,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RICCATI_BACKWARD_CASE(NX_, NU_)                                     \
  if (nx == NX_ && nu == NU_)                                               \
    return static_cast<int>(backward_fixed<NX_, NU_, 1, 0>(                 \
        A, Bm, G, M, mx, mu, c, delta, delta, nullptr, nullptr, nullptr,    \
        gains, ok, nbatch, H, device, s));
  RICCATI_BACKWARD_CASE(12, 4)
  RICCATI_BACKWARD_CASE(10, 1)
  RICCATI_BACKWARD_CASE(4, 1)
  RICCATI_BACKWARD_CASE(12, 10)
  RICCATI_BACKWARD_CASE(18, 1)
  RICCATI_BACKWARD_CASE(28, 4)
#undef RICCATI_BACKWARD_CASE
  return static_cast<int>(backward_runtime(A, Bm, G, M, mx, mu, c, delta,
                                           gains, ok, nbatch, H, nx, nu,
                                           device, s));
}

extern "C" int riccati_backward_runtime_f32(
    const void* A, const void* Bm, const void* G, const void* M,
    const void* mx, const void* mu, const void* c, const void* delta,
    void* gains, void* ok, int nbatch, int H, int nx, int nu, int device,
    void* stream) {
  return static_cast<int>(backward_runtime(
      A, Bm, G, M, mx, mu, c, delta, gains, ok, nbatch, H, nx, nu, device,
      static_cast<cudaStream_t>(stream)));
}

// riccati_forward_f32 launches the compile-time instance
// riccati_general_forward_fixed<NX, NU, 1, 0, D> for the (nx, nu) below,
// with the ring depth D named beside each, and the run-time kernel for any
// other; this list and `_FORWARD_INSTANCES` (shape -> depth) in
// ops/cuda/riccati_kernel.py must agree.  Each depth was chosen by turns
// on an H100 (PERF.md).  At one right-hand side c and the gains
// are laid out as the general sweep's; with no equality rows the instance
// reads no Jx and writes no dNu.  It takes inputs at any 4-byte
// alignment.  riccati_forward_runtime_f32 launches the run-time kernel at
// any shape, so that the two designs can be held against each other.
extern "C" int riccati_forward_f32(const void* A, const void* Bm,
                                   const void* c, const void* gains,
                                   void* dX, void* dU, void* dLam, int nbatch,
                                   int H, int nx, int nu, int device,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RICCATI_FORWARD_CASE(NX_, NU_, D_)                                  \
  if (nx == NX_ && nu == NU_)                                               \
    return static_cast<int>(forward_fixed<NX_, NU_, 1, 0, D_>(              \
        A, Bm, c, nullptr, gains, dX, dU, dLam, nullptr, nbatch, H, device, \
        s));
  RICCATI_FORWARD_CASE(12, 4, 2)
  RICCATI_FORWARD_CASE(10, 1, 4)
  RICCATI_FORWARD_CASE(4, 1, 8)
  RICCATI_FORWARD_CASE(12, 10, 2)
  RICCATI_FORWARD_CASE(28, 4, 3)
#undef RICCATI_FORWARD_CASE
  return static_cast<int>(forward_runtime(A, Bm, c, gains, dX, dU, dLam,
                                          nbatch, H, nx, nu, device, s));
}

extern "C" int riccati_forward_runtime_f32(const void* A, const void* Bm,
                                           const void* c, const void* gains,
                                           void* dX, void* dU, void* dLam,
                                           int nbatch, int H, int nx, int nu,
                                           int device, void* stream) {
  return static_cast<int>(forward_runtime(
      A, Bm, c, gains, dX, dU, dLam, nbatch, H, nx, nu, device,
      static_cast<cudaStream_t>(stream)));
}
