// The compile-time streamed Riccati forward kernel for Hopper (sm_90a),
// shared by csrc/riccati_streamed.cu (the plain sweep: R = 1 right-hand
// side, r = 0 equality rows) and csrc/riccati_general.cu (R right-hand
// sides, r stage equality rows).  Each source instantiates it for the
// shapes, and at the ring depths, listed at its C forward entry and keeps
// its own run-time forward kernel for every other shape.
//
// riccati_general_forward_fixed<NX, NU, R, RE, D> computes what
// riccati_general.cu's run-time riccati_general_forward_kernel computes,
// for one (nx, nu, R, r) fixed at compile time, the sums term for term in
// the same order; at R = 1, RE = 0 that is riccati_streamed.cu's
// riccati_forward_kernel (the same inputs, c with one right-hand side, the
// gains layout [K | k | Pbar | pbar | Mxu], dX, dU, dLam as (B, H, 1, .);
// Jx and dNu are then not read or written).  It replaces
// pyneuralempc_tpu/ops/pallas/riccati_kernel.py's streamed forward calls,
// :488 (`_forward_kernel` :305-337) at (12, 4, 1, 0), (10, 1, 1, 0),
// (4, 1, 1, 0) and (12, 10, 1, 0), and :1024 (`_fwd_general_body`
// :790-847) at (12, 4, 2, 1).
//
// What bounds it on an H100: bytes (~119 us at (12, 4, 1, 0) and ~140 us
// at (12, 4, 2, 1) for B=4096, H=50; ~532 us at (10, 1, 1, 0) for
// B=16384, H=100) at a fleet's width; at one problem (cartpole's B=1) the
// latency of its H dependent stages.  The run-time forward kernels make
// several dependent device-memory round trips a stage (warp-wide copies,
// then the products), ~1.2 us each under load, and nothing of stage t+1 is
// in flight while stage t computes: they take the time of their loads'
// latency, not of their bytes.  Since only dx carries from stage to stage,
// this kernel requests each stage's inputs D stages ahead into a ring of D
// stage slots in shared memory (cp.async, 16 bytes wherever the addresses
// allow) and keeps dx in registers, exchanged by shuffles.  D is a
// template argument: each C case list names the depth of each instance.
// At a fleet's width 32 resident warps an SM hide most of a stage's
// latency, and a deeper ring costs shared memory; at one warp on one SM
// only the ring's depth does.  __launch_bounds__(128, 8) keeps eight
// blocks of four warps an SM (B = 4096 in one wave on 132 SMs), which caps
// D at 3, 6, 25 and 2 at (12, 4, 1, 0), (10, 1, 1, 0), (4, 1, 1, 0) and
// (12, 10, 1, 0) (228 KB less 1 KB a block, over 4 warps' slots).

#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk_copy.cuh"
#include "riccati_backward_fixed.cuh"

namespace {

// One stage slot of a warp's ring: A, B, c, Jx and the gains, each range
// from a 16-byte boundary with room for its source's offset of 0-3 floats
// within 16 bytes (a range sits at that offset in the slot too, so that
// source and slot agree mod 16 and its interior goes in 16-byte copies).
template <int NX, int NU, int R, int RE>
struct ForwardLayout {
  static constexpr int nA = NX * NX, nB = NX * NU, nc = R * NX;
  static constexpr int nJ = RE * NX;
  static constexpr int NG = NU * NX + R * NU + NX * NX + R * NX + NX * NU
                            + RE * NX + R * RE;
  static constexpr int oA = 0, oB = oA + up4(nA + 3), oc = oB + up4(nB + 3);
  static constexpr int oJ = oc + up4(nc + 3);
  static constexpr int og = oJ + (nJ > 0 ? up4(nJ + 3) : 0);
  static constexpr int kSlot = og + up4(NG + 3);
  // gains: [K (NU,NX) | k (R,NU) | Pbar (NX,NX) | pbar (R,NX) | Mxu (NX,NU)
  //        | Knu (RE,NX) | knu (R,RE)]
  static constexpr int gK = 0, gk = NU * NX, gPb = gk + R * NU;
  static constexpr int gpb = gPb + NX * NX, gMxu = gpb + R * NX;
  static constexpr int gKnu = gMxu + NX * NU, gknu = gKnu + RE * NX;
  static_assert(R * NX <= 32 && NU + RE <= NX,
                "one lane an entry of dx: R nx <= 32, nu + r <= nx");
};

// Floats of shared memory one warp of the forward instance uses: D stage
// slots.
template <int NX, int NU, int R, int RE, int D>
__host__ __device__ constexpr int forward_ring_floats() {
  return D * ForwardLayout<NX, NU, R, RE>::kSlot;
}

// A float pointer's offset within its 16 bytes, in floats (0-3).
__device__ __forceinline__ int phase16(const float* p) {
  return static_cast<int>(reinterpret_cast<uintptr_t>(p) >> 2) & 3;
}

// n <= 3 floats whose first lies `phase` floats past a 16-byte boundary,
// both at source and destination: 8-byte copies where both ends are
// 8-byte aligned, 4-byte copies otherwise.  One lane.
__device__ __forceinline__ void copy_short_async(float* dst, const float* src,
                                                 int n, int phase) {
  for (int e = 0; e < n;) {
    if (((phase + e) & 1) == 0 && e + 2 <= n) {
      copy8_async(dst + e, src + e);
      e += 2;
    } else {
      copy4_async(dst + e, src + e);
      e += 1;
    }
  }
}

// The N floats at src to dst16 + phase16(src) (dst16 16-byte aligned) by
// the warp's lanes, at the widest width the addresses allow: 16-byte
// copies from src's first 16-byte boundary, the head before it and the
// tail after the last whole 16 bytes in 8- and 4-byte copies.  Not waited
// on here.
template <int N>
__device__ __forceinline__ void ring_copy(float* dst16, const float* src,
                                          int lane) {
  if (N == 0) return;
  const int m = phase16(src);
  const int h = min((4 - m) & 3, N);     // floats before the boundary
  const int n4 = (N - h) >> 2;
  float* dst = dst16 + m;
  for (int q = lane; q < n4; q += 32)
    copy16_async(dst + h + 4 * q, src + h + 4 * q);
  if (lane == 0) copy_short_async(dst, src, h, m);
  if (lane == 1)
    copy_short_async(dst + h + 4 * n4, src + h + 4 * n4, N - h - 4 * n4, 0);
}

// One warp a problem.  A, B, c, Jx and the gains never depend on dx, so
// stage t + D's are requested as soon as stage t's slot of the warp's
// D-slot ring is free (one cp.async group a stage, waited on with D - 1
// groups left in flight), and the warp waits only for the slot it is
// about to use.  Lane ri*NX + i keeps dx[ri][i] and the whole dx of its
// right-hand side (NX shuffles a stage); lanes ri*NX + al (al < NU)
// compute du[ri][al] and lanes ri*NX + NU + q dnu[ri][q], which the others
// take by shuffles.  A stage's dependent part is du (NX FMAs), NU
// shuffles, dx' (A dx computed meanwhile, then NU FMAs) and NX shuffles;
// dlam is off the chain.  The outputs leave from the lanes that hold
// them, a stage's entries contiguous per problem.  At most 64 registers a
// thread, so kMinBlocks blocks of kMaxWarps warps fit an SM (17,152 B of
// shared memory a block at (12, 4, 2, 1) and D = 2) and B = 4096 problems
// run in one wave on 132 SMs.
template <int NX, int NU, int R, int RE, int D>
__global__ void __launch_bounds__(kMaxWarps * 32, kMinBlocks)
riccati_general_forward_fixed(
    const float* __restrict__ A, const float* __restrict__ Bm,
    const float* __restrict__ c, const float* __restrict__ Jx,
    const float* __restrict__ gains, float* __restrict__ dX,
    float* __restrict__ dU, float* __restrict__ dLam,
    float* __restrict__ dNu, int nbatch, int H) {
  using L = ForwardLayout<NX, NU, R, RE>;
  static_assert(D >= 1, "a ring of at least one stage slot");
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * kMaxWarps + warp;
  if (b >= nbatch) return;   // the whole warp leaves; no block barrier used
  float* ring = smem + warp * forward_ring_floats<NX, NU, R, RE, D>();
  // lane -> (ri, i); the lanes past R*NX shadow lane (R-1)*NX and store
  // nothing
  const bool live = lane < R * NX;
  const int ri = live ? lane / NX : R - 1;
  const int i = live ? lane - ri * NX : 0;
  const int base = ri * NX;                 // this rhs's first lane
  const bool is_du = i < NU, is_dnu = !is_du && i < NU + RE;

  // stage t's inputs into its slot; one group a stage, empty past H
  auto request = [&](int t) {
    if (t < H) {
      float* slot = ring + (t % D) * L::kSlot;
      const size_t st = static_cast<size_t>(b) * H + t;
      ring_copy<L::nA>(slot + L::oA, A + st * L::nA, lane);
      ring_copy<L::nB>(slot + L::oB, Bm + st * L::nB, lane);
      ring_copy<L::nc>(slot + L::oc, c + st * L::nc, lane);
      ring_copy<L::nJ>(slot + L::oJ, Jx + st * L::nJ, lane);
      ring_copy<L::NG>(slot + L::og, gains + st * L::NG, lane);
    }
    __pipeline_commit();
  };
#pragma unroll
  for (int t = 0; t < D; ++t) request(t);

  float x[NX];           // dx[ri] of the previous stage, on every lane
#pragma unroll
  for (int j = 0; j < NX; ++j) x[j] = 0.0f;
  for (int t = 0; t < H; ++t) {
    copy_wait_prior<D - 1>();       // stage t's group has landed
    __syncwarp();                   // and every lane's copies are seen
    const size_t st = static_cast<size_t>(b) * H + t;
    const float* slot = ring + (t % D) * L::kSlot;
    const float* sA = slot + L::oA + phase16(A + st * L::nA);
    const float* sB = slot + L::oB + phase16(Bm + st * L::nB);
    const float* sc = slot + L::oc + phase16(c + st * L::nc);
    const float* sJ = slot + L::oJ + phase16(Jx + st * L::nJ);
    const float* sg = slot + L::og + phase16(gains + st * L::NG);

    // du = K dx + k (lanes i < NU), dnu = Knu dx + knu (the next RE)
    const float* krow = sg + L::gK + min(i, NU - 1) * NX;
    float bias = sg[L::gk + ri * NU + min(i, NU - 1)];
    if constexpr (RE > 0) {
      if (!is_du) {
        const int q = min(i - NU, RE - 1);
        krow = sg + L::gKnu + q * NX;
        bias = sg[L::gknu + ri * RE + q];
      }
    }
    float v = 0.0f;
#pragma unroll
    for (int j = 0; j < NX; ++j) v += krow[j] * x[j];
    const float own = v + bias;
    // A dx meanwhile
    float va = 0.0f;
#pragma unroll
    for (int j = 0; j < NX; ++j) va += sA[i * NX + j] * x[j];
    float du[NU];
#pragma unroll
    for (int al = 0; al < NU; ++al)
      du[al] = __shfl_sync(0xffffffffu, own, base + al);
    float dnu[RE > 0 ? RE : 1];
#pragma unroll
    for (int q = 0; q < RE; ++q)
      dnu[q] = __shfl_sync(0xffffffffu, own, base + NU + q);

    // dx' = A dx + B du + c
    float wa = 0.0f;
#pragma unroll
    for (int al = 0; al < NU; ++al) wa += sB[i * NU + al] * du[al];
    const float dxn = va + wa + sc[ri * NX + i];
#pragma unroll
    for (int j = 0; j < NX; ++j)
      x[j] = __shfl_sync(0xffffffffu, dxn, base + j);

    // dlam = Pbar dx' + Mxu du + pbar + Jx^T dnu
    float vl = 0.0f, wl = 0.0f, zl = 0.0f;
#pragma unroll
    for (int j = 0; j < NX; ++j) vl += sg[L::gPb + i * NX + j] * x[j];
#pragma unroll
    for (int al = 0; al < NU; ++al) wl += sg[L::gMxu + i * NU + al] * du[al];
#pragma unroll
    for (int q = 0; q < RE; ++q) zl += dnu[q] * sJ[q * NX + i];
    const float dlam = vl + wl + sg[L::gpb + ri * NX + i] + zl;

    if (live) {
      dX[st * (R * NX) + lane] = dxn;
      dLam[st * (R * NX) + lane] = dlam;
      if (is_du) dU[st * (R * NU) + ri * NU + i] = own;
      if (is_dnu) dNu[st * (R * RE) + ri * RE + (i - NU)] = own;
    }
    __syncwarp();                   // every lane is done with the slot
    request(t + D);
  }
}

// The forward instance <NX, NU, R, RE, D>: kMaxWarps warps a block, the
// shared memory carveout at its largest so that kMinBlocks blocks fit an
// SM.
template <int NX, int NU, int R, int RE, int D>
cudaError_t forward_fixed(const void* A, const void* Bm, const void* c,
                          const void* Jx, const void* gains, void* dX,
                          void* dU, void* dLam, void* dNu, int nbatch, int H,
                          int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (nbatch <= 0 || H <= 0) return cudaErrorInvalidValue;
  auto kernel = riccati_general_forward_fixed<NX, NU, R, RE, D>;
  const size_t smem =
      sizeof(float) * kMaxWarps * forward_ring_floats<NX, NU, R, RE, D>();
  err = reserve_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const dim3 grid((nbatch + kMaxWarps - 1) / kMaxWarps);
  kernel<<<grid, kMaxWarps * 32, smem, stream>>>(
      static_cast<const float*>(A), static_cast<const float*>(Bm),
      static_cast<const float*>(c), static_cast<const float*>(Jx),
      static_cast<const float*>(gains), static_cast<float*>(dX),
      static_cast<float*>(dU), static_cast<float*>(dLam),
      static_cast<float*>(dNu), nbatch, H);
  return cudaGetLastError();
}

}  // namespace
