// The tangent passes of a tanh dense layer y = tanh(h W + b) for Hopper
// (sm_90a): two float32 GEMMs over the tangent rows, each with the tanh's
// derivative folded in.
//
//   K1 (tanh_tangent_fwd_f32):  ydot = (1 - y^2) * (hdot W)
//   K2 (tanh_tangent_vjp_f32):  gdot_h = (gdot_y * (1 - y^2)
//                                         - 2 y * ydot * g_y) W^T
//
// Tangents come P x T x X (P primal rows, T tangents a row, X features) at
// any strides; the primal rows y, g_y (P x N) and W (K x N) are
// contiguous; each output is (P*T) x width, contiguous.  Tangent row
// r = p*T + t reads primal row p = r / T, so a row's T tangents share its
// y and g_y, which are never expanded to the tangent width.  The plain
// PyTorch versions are tangent_fwd_plain and tangent_vjp_plain in
// pyneuralempc_tpu_torch/ops/cuda/tanh_dense.py.
//
// Replaces no TPU kernel: the JAX package leaves these passes to XLA.  In
// the port, torch.func composes them from ATen ops (the pre-activation
// tangent, a bias add, tanh_backward on a broadcast primal, the products
// and sums of its jvp), each a pass over the tangent width; here every
// such intermediate stays in registers.
//
// What bounds them on an H100: float32 FFMA issue at the stage blocks'
// widths.  At N = K = 256 a tangent row costs 2*256*256 flops against
// 4*(256 + 256) bytes (K1) or 4*(3*256) bytes (K2): 256 and 171 flops a
// byte, past the card's 20 flops a byte (67 TFLOP/s over 3.35 TB/s).  At
// K = 19 (K1) or an output of 19 (K2) the same rows are bound by bytes.
// IEEE float32 throughout: no tensor cores (TF32 would change the result).
//
// Design.  A classic SIMT GEMM: a 256-thread block computes a BM x BN
// output tile with an 8 x TN register tile a thread (two 4-row halves
// BM/2 apart, and two 4-column halves BN/2 apart at TN = 8, so each
// thread's shared-memory reads are float4 and conflict-free); the
// reduction advances in slices of BK = 8 through two shared-memory
// buffers, the next slice's global loads held in registers while the
// current one is multiplied, one barrier a slice.  The operand loads are
// where the derivative goes: K2 forms its operand gdot_y (1 - y^2) -
// 2 y ydot g_y while loading (the primal rows from L1, shared by the T
// tangents of a row); K1 scales each output by 1 - y^2 before the store.
// Two tiles: BM x BN = 128 x 128 (TN = 8) where the output is wider than
// 32 columns, 256 x 32 (TN = 4) where it is narrower (K2 into the first
// layer's 19 inputs), so that a narrow output does not idle 3/4 of the
// block's FFMA.  Blocks walk the column tiles of a row tile one after
// another, so the second reads its rows from L2.  Each row's slice comes
// as float4 loads where the tangents' layout allows (unit feature stride,
// row strides a multiple of 4, 16-byte aligned), one float a load
// elsewhere.  At most 128 registers, so that two blocks share an SM.  A
// missing gdot_y or ydot (a zero tangent) is a null pointer.  Chosen by
// turns on an H100 (PERF.md): slices of 8 over 16, two blocks an SM over
// one, K2's operand formed as its loads arrive over after half the
// slice's products.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBK = 8;
constexpr int kTM = 8;
constexpr int kPad = 4;     // shared rows padded: conflict-free stores

struct Operand {            // a tangent P x T x X at strides (sp, st, sx)
  const float* __restrict__ ptr;
  long long sp, st, sx;
};

struct Args {
  Operand a0, a1;           // K1: hdot; K2: gdot_y, ydot (either null)
  const float* __restrict__ y;
  const float* __restrict__ g;
  const float* __restrict__ W;
  float* __restrict__ out;
  long long M, T;           // tangent rows P*T, tangents a primal row
  int R, C;                 // reduction length, output width
};


// Loads V floats at p: one float4 (V = 4) or one float.
template <int V>
__device__ __forceinline__ void get(const float* p, float (&dst)[V]) {
  if constexpr (V == 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    dst[0] = v.x; dst[1] = v.y; dst[2] = v.z; dst[3] = v.w;
  } else {
    dst[0] = __ldg(p);
  }
}

// acc += the products of one slice: a thread's 8 rows (two 4-row halves
// BM/2 apart) by its TN columns (two 4-column halves BN/2 apart at TN =
// 8), each read from shared memory as float4.
template <int BM, int BN, int TN>
__device__ __forceinline__ void products(float (&acc)[kTM][TN],
                                         const float (*As)[BM + kPad],
                                         const float (*Bs)[BN + kPad],
                                         int ty, int tx) {
#pragma unroll
  for (int kk = 0; kk < kBK; ++kk) {
    float av[kTM], bv[TN];
    const float4 a_lo = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
    const float4 a_hi =
        *reinterpret_cast<const float4*>(&As[kk][BM / 2 + ty * 4]);
    av[0] = a_lo.x; av[1] = a_lo.y; av[2] = a_lo.z; av[3] = a_lo.w;
    av[4] = a_hi.x; av[5] = a_hi.y; av[6] = a_hi.z; av[7] = a_hi.w;
    const float4 b_lo = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
    bv[0] = b_lo.x; bv[1] = b_lo.y; bv[2] = b_lo.z; bv[3] = b_lo.w;
    if constexpr (TN == 8) {
      const float4 b_hi =
          *reinterpret_cast<const float4*>(&Bs[kk][BN / 2 + tx * 4]);
      bv[4] = b_hi.x; bv[5] = b_hi.y; bv[6] = b_hi.z; bv[7] = b_hi.w;
    }
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// MODE 0: K1, reduce over K (R = K, C = N), B[k][c] = W[k*N + c].
// MODE 1: K2, reduce over N (R = N, C = K), B[n][c] = W[c*N + n].
// VEC: each tangent row's slice of the reduction comes as float4 loads
// (unit feature stride, row strides and R multiples of 4, 16-byte aligned
// operands); else one float a load.
template <int MODE, int BN, int TN, bool VEC>
__global__ void __launch_bounds__(kThreads, 2)
tanh_tangent_kernel(Args a) {
  constexpr int TX = BN / TN;
  constexpr int TY = kThreads / TX;
  constexpr int BM = TY * kTM;
  constexpr int V = VEC ? 4 : 1;                 // floats a load
  constexpr int LOADS = BM * kBK / (kThreads * V);
  constexpr int B_PER = kBK * BN / kThreads;
  constexpr int AS = BM + kPad;
  constexpr int BS = BN + kPad;
  __shared__ __align__(16) float As[2][kBK][AS];
  __shared__ __align__(16) float Bs[2][kBK][BS];

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int n_col = (a.C + BN - 1) / BN;
  const long long m0 = (long long)(blockIdx.x / n_col) * BM;
  const int c0 = (blockIdx.x % n_col) * BN;

  // the A rows this thread loads: load i covers row m = e / (kBK / V),
  // columns kq .. kq + V - 1 of each slice, e = tid + i * kThreads; each
  // row's operands as pointers to its first column (null: a zero tangent
  // or a row past M)
  const int kq = (tid % (kBK / V)) * V;
  const float* t0[LOADS];
  const float* t1[LOADS];
  const float* pq[LOADS];        // K2: the primal row's y (g at the same
                                 // offset from a.g)
#pragma unroll
  for (int i = 0; i < LOADS; ++i) {
    const long long r = m0 + (tid + i * kThreads) / (kBK / V);
    const long long p = r < a.M ? r / a.T : 0;
    const long long t = r - p * a.T;
    const bool live = r < a.M;
    t0[i] = live && a.a0.ptr ? a.a0.ptr + p * a.a0.sp + t * a.a0.st : nullptr;
    t1[i] = live && a.a1.ptr ? a.a1.ptr + p * a.a1.sp + t * a.a1.st : nullptr;
    pq[i] = live ? a.y + p * a.R : nullptr;
  }
  const long long g_off = MODE == 1 && a.g ? a.g - a.y : 0;

  // the next slice, held in registers while the current one is multiplied
  // (K2's operand formed from its four loads as they arrive)
  float r0[LOADS][V], r1[LOADS][V], ry[LOADS][V], rg[LOADS][V], rb[B_PER];

  float acc[kTM][TN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  const int n_k = (a.R + kBK - 1) / kBK;
  int buf = 0;
  for (int kt = 0; kt <= n_k; ++kt) {
    // the next slice's loads go out before this slice's products
    if (kt < n_k) {
      const int k = kt * kBK + kq;
      const bool in = k < a.R;
#pragma unroll
      for (int i = 0; i < LOADS; ++i) {
#pragma unroll
        for (int j = 0; j < V; ++j) r0[i][j] = r1[i][j] = ry[i][j] = rg[i][j] = 0.f;
        if (MODE == 0) {
          if (in && t0[i]) get<V>(t0[i] + k * a.a0.sx, r0[i]);
        } else if (in && pq[i]) {
          get<V>(pq[i] + k, ry[i]);
          if (t0[i]) get<V>(t0[i] + k * a.a0.sx, r0[i]);
          if (t1[i]) {
            get<V>(t1[i] + k * a.a1.sx, r1[i]);
            get<V>(pq[i] + g_off + k, rg[i]);
          }
#pragma unroll
          for (int j = 0; j < V; ++j)
            r0[i][j] = r0[i][j] * (1.f - ry[i][j] * ry[i][j])
                       - 2.f * r1[i][j] * ry[i][j] * rg[i][j];
        }
      }
#pragma unroll
      for (int i = 0; i < B_PER; ++i) {
        const int e = tid + i * kThreads;
        int kk, c;
        if (MODE == 0) { kk = e / BN; c = e % BN; }   // along W's rows
        else { kk = e % kBK; c = e / kBK; }           // along W's columns
        const int kr = kt * kBK + kk, cc = c0 + c;
        float v = 0.f;
        if (kr < a.R && cc < a.C)
          v = MODE == 0 ? __ldg(a.W + (long long)kr * a.C + cc)
                        : __ldg(a.W + (long long)cc * a.R + kr);
        rb[i] = v;
      }
    }
    if (kt > 0) {
      products<BM, BN, TN>(acc, As[buf], Bs[buf], ty, tx);
      buf ^= 1;
    }
    if (kt < n_k) {
      // into the buffer the last slice's products are done with (the
      // barrier at the end of the last step)
#pragma unroll
      for (int i = 0; i < LOADS; ++i) {
        const int m = (tid + i * kThreads) / (kBK / V);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          As[buf][kq + j][m] = r0[i][j];
        }
      }
#pragma unroll
      for (int i = 0; i < B_PER; ++i) {
        const int e = tid + i * kThreads;
        if (MODE == 0) Bs[buf][e / BN][e % BN] = rb[i];
        else Bs[buf][e % kBK][e / kBK] = rb[i];
      }
    }
    __syncthreads();
  }

  // epilogue: K1 scales by 1 - y^2 of the row's primal; four columns at a
  // time where the output's rows allow 16-byte stores
  const bool vec = (a.C % 4) == 0;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const long long r = m0 + (i < 4 ? ty * 4 + i : BM / 2 + ty * 4 + i - 4);
    if (r >= a.M) continue;
    const long long p = r / a.T;
    float* orow = a.out + r * a.C;
#pragma unroll
    for (int h = 0; h < TN / 4; ++h) {
      const int c = c0 + (h == 0 ? tx * 4 : BN / 2 + tx * 4);
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = acc[i][h * 4 + j];
        if (MODE == 0 && c + j < a.C) {
          const float yv = __ldg(a.y + p * a.C + c + j);
          v[j] *= 1.f - yv * yv;
        }
      }
      if (vec && c + 3 < a.C) {
        *reinterpret_cast<float4*>(orow + c) =
            make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c + j < a.C) orow[c + j] = v[j];
      }
    }
  }
}

bool aligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// Whether every tangent row's slices can come as float4 loads.
bool vec_ok(const Operand& o) {
  return o.ptr == nullptr
         || (o.sx == 1 && o.sp % 4 == 0 && o.st % 4 == 0 && aligned(o.ptr));
}

template <int MODE, int BN, int TN>
cudaError_t launch_tile(const Args& a, cudaStream_t stream) {
  constexpr int BM = (kThreads / (BN / TN)) * kTM;
  const long long blocks = ((a.M + BM - 1) / BM) * ((a.C + BN - 1) / BN);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const bool vec = a.R % 4 == 0 && vec_ok(a.a0) && vec_ok(a.a1)
                   && (MODE == 0 || (aligned(a.y) && aligned(a.g)));
  if (vec)
    tanh_tangent_kernel<MODE, BN, TN, true>
        <<<(unsigned)blocks, kThreads, 0, stream>>>(a);
  else
    tanh_tangent_kernel<MODE, BN, TN, false>
        <<<(unsigned)blocks, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch(const Args& a, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  if (a.M <= 0 || a.T <= 0 || a.R <= 0 || a.C <= 0) return cudaErrorInvalidValue;
  return a.C > 32 ? launch_tile<MODE, 128, 8>(a, stream)
                  : launch_tile<MODE, 32, 4>(a, stream);
}

}  // namespace

// Both entries take float32 device pointers, launch on `stream` on
// `device`, and return the launch's cudaError_t (0 on success).
// hdot is P x T x K at strides (sp, st, sx); y is P x N, W is K x N; out
// (P*T) x N.
extern "C" int tanh_tangent_fwd_f32(const void* hdot, const void* y,
                                    const void* W, void* out, long long P,
                                    long long T, long long K, long long N,
                                    long long sp, long long st, long long sx,
                                    int device, void* stream) {
  Args a{};
  a.a0 = {static_cast<const float*>(hdot), sp, st, sx};
  a.a1 = {nullptr, 0, 0, 0};
  a.y = static_cast<const float*>(y);
  a.g = nullptr;
  a.W = static_cast<const float*>(W);
  a.out = static_cast<float*>(out);
  a.M = P * T;
  a.T = T;
  a.R = static_cast<int>(K);
  a.C = static_cast<int>(N);
  return static_cast<int>(
      launch<0>(a, device, static_cast<cudaStream_t>(stream)));
}

// gdot (gdot_y) and ydot are P x T x N at their strides, either null; g
// (g_y) and y are P x N, W is K x N; out (P*T) x K.
extern "C" int tanh_tangent_vjp_f32(const void* gdot, const void* ydot,
                                    const void* g, const void* y,
                                    const void* W, void* out, long long P,
                                    long long T, long long K, long long N,
                                    long long sgp, long long sgt,
                                    long long sgx, long long syp,
                                    long long syt, long long syx, int device,
                                    void* stream) {
  Args a{};
  a.a0 = {static_cast<const float*>(gdot), sgp, sgt, sgx};
  a.a1 = {static_cast<const float*>(ydot), syp, syt, syx};
  a.y = static_cast<const float*>(y);
  a.g = static_cast<const float*>(g);
  a.W = static_cast<const float*>(W);
  a.out = static_cast<float*>(out);
  a.M = P * T;
  a.T = T;
  a.R = static_cast<int>(N);
  a.C = static_cast<int>(K);
  return static_cast<int>(
      launch<1>(a, device, static_cast<cudaStream_t>(stream)));
}
