// FlashAttention-2 forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel kubetorch_tpu/ops/attention.py:_fwd_kernel
// (launched by _fwd, public flash_attention). Same function: causal (or
// full) attention with an online softmax and fp32 accumulators, GQA through
// kv-head h*NKV/N, whole K/V tiles above the diagonal skipped and the
// diagonal tile masked with -1e30, fully masked rows written as 0. With a
// non-null `lse` it also writes each row's log-sum-exp m + log(l) (the
// residual the backward kernels in flash_bwd.cu recompute P from), as the
// Pallas kernel does with need_lse; a null `lse` writes nothing more.
// Numerics follow the Pallas body: q, k and v are widened to fp32 and both
// products (Q.K^T and P.V) run in fp32, so P is never rounded to bf16.
//
// What bounds it on the H100: at the serving prefill shapes (T <= 2048,
// Hd 128) the causal work is 2*T^2*Hd*N flops against (2N+2NKV)*T*Hd*2
// bytes, ~T/2 flops per byte, so operations bound it, not HBM. This first
// version computes with plain fp32 FMAs (CUDA cores, 67 TFLOP/s peak) to
// keep the reference's fp32 P.V exactly; it does not reach the bf16 tensor
// core bound. What the design does about it: a 64x64 tile per step, each
// thread owning a 4x4 block of logits and a 4x(Hd/16) block of the output
// in registers, K tile rows padded in shared memory so the logit loop reads
// without bank conflicts, and the heaviest causal q tiles scheduled first.
// wgmma/TMA and a tensor-core P.V are later work.
//
// Layout: q (B, S, N, Hd), k/v (B, S, NKV, Hd), out (B, S, N, Hd), read and
// written in place through their strides (no head-major copy); lse fp32
// (B, N, S), contiguous. C interface,
// launched on the caller's stream; returns the cudaError_t of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // key rows per tile
constexpr int THREADS = 256;  // 16 x 16 threads; thread (ty, tx)
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct FwdParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // (B, N, S) or null
  int S, N, NKV;
  long long qs[3], ks[3], vs[3], os[3];  // element strides of (b, s, head)
  float scale;
  int causal;
};

// Copy rows [r0, r0 + BK) of one head into shared memory (row stride
// `dstride`), 16-byte loads; rows at or past `limit` become zeros.
template <typename T, int HD, int ROWS>
__device__ __forceinline__ void load_tile(T* dst, int dstride, const T* src,
                                          long long sstride, int r0, int limit) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int PER_ROW = HD / VEC;
  for (int idx = threadIdx.x; idx < ROWS * PER_ROW; idx += THREADS) {
    const int r = idx / PER_ROW;
    const int c = (idx % PER_ROW) * VEC;
    T vals[VEC];
    if (r0 + r < limit) {
      *reinterpret_cast<uint4*>(vals) =
          *reinterpret_cast<const uint4*>(src + (long long)(r0 + r) * sstride + c);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) vals[e] = from_f<T>(0.f);
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) dst[r * dstride + c + e] = vals[e];
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(FwdParams p) {
  constexpr int KPAD = sizeof(T) == 2 ? 2 : 1;  // one 32-bit word per row
  constexpr int KSTR = HD + KPAD;
  constexpr int PSTR = BK + 1;
  constexpr int CPT = HD / 16;  // output columns per thread

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h * p.NKV / p.N;
  const int q0 = qt * BQ;
  const int S = p.S;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  extern __shared__ __align__(16) unsigned char smem[];
  float* Ps = reinterpret_cast<float*>(smem);
  T* Qs = reinterpret_cast<T*>(Ps + BQ * PSTR);
  T* Ks = Qs + BQ * HD;
  T* Vs = Ks + BK * KSTR;

  const T* q = static_cast<const T*>(p.q) + b * p.qs[0] + h * p.qs[2];
  const T* k = static_cast<const T*>(p.k) + b * p.ks[0] + kvh * p.ks[2];
  const T* v = static_cast<const T*>(p.v) + b * p.vs[0] + kvh * p.vs[2];
  load_tile<T, HD, BQ>(Qs, HD, q, p.qs[1], q0, S);

  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  int n_kt = (S + BK - 1) / BK;
  if (p.causal) n_kt = min(n_kt, (q0 + BQ - 1) / BK + 1);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's K/V/P are no longer read
    load_tile<T, HD, BK>(Ks, KSTR, k, p.ks[1], k0, S);
    load_tile<T, HD, BK>(Vs, HD, v, p.vs[1], k0, S);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = to_f(Qs[(ty + 16 * i) * HD + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = to_f(Ks[(tx + 16 * j) * KSTR + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // online softmax; a row's 64 logits sit in the 16 lanes sharing ty
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        float x = s[i][j] * p.scale;
        if (col >= S || (p.causal && col > row)) x = NEG_INF;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pij = expf(s[i][j] - m_new);
        Ps[(ty + 16 * i) * PSTR + tx + 16 * j] = pij;
        sum += pij;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    // acc += P.V in fp32
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float vv[CPT];
#pragma unroll
      for (int c = 0; c < CPT; ++c) vv[c] = to_f(Vs[kk * HD + tx * CPT + c]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pv = Ps[(ty + 16 * i) * PSTR + kk];
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[i][c] = fmaf(pv, vv[c], acc[i][c]);
      }
    }
  }

  T* o = static_cast<T*>(p.o) + b * p.os[0] + h * p.os[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= S) continue;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      o[(long long)row * p.os[1] + tx * CPT + c] = from_f<T>(acc[i][c] / l_safe);
    if (p.lse != nullptr && tx == 0)
      p.lse[((long long)b * p.N + h) * S + row] = m[i] + logf(l_safe);
  }
}

template <typename T, int HD>
cudaError_t launch(const FwdParams& p, int B, cudaStream_t stream) {
  constexpr int KPAD = sizeof(T) == 2 ? 2 : 1;
  const size_t smem = BQ * (BK + 1) * sizeof(float) +
                      (size_t)(BQ * HD + BK * (HD + KPAD) + BK * HD) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.S + BQ - 1) / BQ, p.N, B);
  flash_fwd_kernel<T, HD><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. strides: q, k, v, out element strides
// of (b, s, head), 12 values. Head dim 16, 32, 64 or 128. lse: fp32
// (B, N, S) contiguous, or null to write none.
extern "C" int kt_flash_fwd(const void* q, const void* k, const void* v, void* o,
                            float* lse, int dtype, int B, int S, int N, int NKV, int HD,
                            const long long* strides, float scale, int causal,
                            void* stream) {
  FwdParams p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = lse;
  p.S = S;
  p.N = N;
  p.NKV = NKV;
  for (int i = 0; i < 3; ++i) {
    p.qs[i] = strides[i];
    p.ks[i] = strides[3 + i];
    p.vs[i] = strides[6 + i];
    p.os[i] = strides[9 + i];
  }
  p.scale = scale;
  p.causal = causal;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0) return cudaSuccess;
  switch (dtype * 1000 + HD) {
    case 1128: return launch<__nv_bfloat16, 128>(p, B, st);
    case 1064: return launch<__nv_bfloat16, 64>(p, B, st);
    case 1032: return launch<__nv_bfloat16, 32>(p, B, st);
    case 1016: return launch<__nv_bfloat16, 16>(p, B, st);
    case 128: return launch<float, 128>(p, B, st);
    case 64: return launch<float, 64>(p, B, st);
    case 32: return launch<float, 32>(p, B, st);
    case 16: return launch<float, 16>(p, B, st);
    default: return cudaErrorInvalidValue;
  }
}
