// Flash-decode for Hopper (sm_90a): one new token per slot against that
// slot's KV cache rows <= pos.
//
// Replaces the Pallas TPU kernel kubetorch_tpu/ops/decode_attention.py:
// _make_decode_kernel(quant=False) (launched by _decode_call, public
// decode_attention). Same function: online softmax over K/V tiles, the
// query block is the GQA group of one kv-head, every tile past the slot's
// frontier is neither loaded nor computed, masked logits are -1e30, P is
// rounded to the cache type before the P.V product, accumulation in fp32.
//
// What bounds it on the H100: bytes. Each kv row is read once and feeds
// only 2*G*Hd flops per operand (G = N/NKV = 4 for Llama-3-8B), far below
// the ~295 flops per byte where the tensor cores would become the limit,
// so the least time is the live rows of K and V over 3.35 TB/s. What the
// design does about it: the cache is read in place through its strides as
// (B, S, NKV, Hd) — no per-step transpose or copy — with 16-byte loads,
// and only rows <= pos[b] are touched; q stays in shared memory in fp32.
// This first version runs one block per (kv-head, slot), so 8 slots x 8
// kv-heads fill 64 of 132 SMs and each block streams its rows without
// overlap; splitting S across blocks with a log-sum-exp combine is the
// planned redesign.
//
// Layout: q (B, NH, Hd), ck/cv (B, S, NKV, Hd), pos (B,) int32 on the
// device, out (B, NH, Hd). C interface, launched on the caller's stream;
// returns the cudaError_t of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BK = 64;        // cache rows per tile (two per lane of a warp)
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAXR = 8;       // outputs per thread: G * Hd <= 2048
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct DecParams {
  const void* q;
  const void* k;
  const void* v;
  const int* pos;
  void* o;
  int S, NH, NKV;
  long long qs[2];          // q (b, head) element strides
  long long ks[3], vs[3];   // cache (b, s, head) element strides
  long long os[2];          // out (b, head)
  float scale;
};

template <typename T, int HD>
__device__ __forceinline__ void load_rows(T* dst, int dstride, const T* src,
                                          long long sstride, int r0, int limit) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int PER_ROW = HD / VEC;
  for (int idx = threadIdx.x; idx < BK * PER_ROW; idx += THREADS) {
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
__global__ void __launch_bounds__(THREADS) decode_kernel(DecParams p) {
  constexpr int KPAD = sizeof(T) == 2 ? 2 : 1;
  constexpr int KSTR = HD + KPAD;
  const int h = blockIdx.x;  // kv-head
  const int b = blockIdx.y;  // slot
  const int G = p.NH / p.NKV;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;

  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);  // (G, HD)
  float* Ps = Qs + G * HD;                     // (G, BK)
  float* Ms = Ps + G * BK;                     // running max per row
  float* Ls = Ms + G;                          // running sum per row
  float* As = Ls + G;                          // this tile's rescale per row
  T* Ks = reinterpret_cast<T*>(As + G);        // (BK, KSTR)
  T* Vs = Ks + BK * KSTR;                      // (BK, HD)

  // rows [0, n) are live: the frontier row pos[b] itself is included
  const int n = max(0, min(p.pos[b] + 1, p.S));

  const T* q = static_cast<const T*>(p.q) + b * p.qs[0] + (long long)h * G * p.qs[1];
  for (int idx = threadIdx.x; idx < G * HD; idx += THREADS)
    Qs[idx] = to_f(q[(idx / HD) * p.qs[1] + idx % HD]);
  for (int g = threadIdx.x; g < G; g += THREADS) {
    Ms[g] = NEG_INF;
    Ls[g] = 0.f;
  }
  float acc[MAXR];
#pragma unroll
  for (int r = 0; r < MAXR; ++r) acc[r] = 0.f;

  const T* k = static_cast<const T*>(p.k) + b * p.ks[0] + h * p.ks[2];
  const T* v = static_cast<const T*>(p.v) + b * p.vs[0] + h * p.vs[2];
  const int n_kt = (n + BK - 1) / BK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile is no longer read
    load_rows<T, HD>(Ks, KSTR, k, p.ks[1], k0, n);
    load_rows<T, HD>(Vs, HD, v, p.vs[1], k0, n);
    __syncthreads();

    // logits: one (row, key) pair per thread per pass
    for (int idx = threadIdx.x; idx < G * BK; idx += THREADS) {
      const int g = idx / BK;
      const int c = idx % BK;
      const float* qg = Qs + g * HD;
      const T* kc = Ks + c * KSTR;
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < HD; ++d) s = fmaf(qg[d], to_f(kc[d]), s);
      s *= p.scale;
      Ps[idx] = (k0 + c < n) ? s : NEG_INF;
    }
    __syncthreads();

    // online softmax, one warp per query row; P rounds to the cache type
    for (int g = warp; g < G; g += WARPS) {
      const float a = Ps[g * BK + lane];
      const float c = Ps[g * BK + lane + 32];
      float mx = fmaxf(a, c);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = Ms[g];
      const float m_new = fmaxf(m_prev, mx);
      const float pa = expf(a - m_new);
      const float pc = expf(c - m_new);
      float sum = pa + pc;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      Ps[g * BK + lane] = to_f(from_f<T>(pa));
      Ps[g * BK + lane + 32] = to_f(from_f<T>(pc));
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        As[g] = alpha;
        Ls[g] = Ls[g] * alpha + sum;
        Ms[g] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P.V, each thread owning fixed (row, dim) outputs
#pragma unroll
    for (int r = 0; r < MAXR; ++r) {
      const int idx = threadIdx.x + r * THREADS;
      if (idx < G * HD) {
        const int g = idx / HD;
        const int d = idx % HD;
        const float* pg = Ps + g * BK;
        float a = acc[r] * As[g];
#pragma unroll 8
        for (int c = 0; c < BK; ++c) a = fmaf(pg[c], to_f(Vs[c * HD + d]), a);
        acc[r] = a;
      }
    }
  }
  __syncthreads();  // Ls is complete

  T* o = static_cast<T*>(p.o) + b * p.os[0] + (long long)h * G * p.os[1];
#pragma unroll
  for (int r = 0; r < MAXR; ++r) {
    const int idx = threadIdx.x + r * THREADS;
    if (idx < G * HD) {
      const int g = idx / HD;
      const float l = Ls[g];
      const float l_safe = l == 0.f ? 1.f : l;
      o[g * p.os[1] + idx % HD] = from_f<T>(acc[r] / l_safe);
    }
  }
}

template <typename T, int HD>
cudaError_t launch(const DecParams& p, int B, cudaStream_t stream) {
  constexpr int KPAD = sizeof(T) == 2 ? 2 : 1;
  const int G = p.NH / p.NKV;
  const size_t smem = (size_t)(G * HD + G * BK + 3 * G) * sizeof(float) +
                      (size_t)(BK * (HD + KPAD) + BK * HD) * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      decode_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(p.NKV, B);
  decode_kernel<T, HD><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. strides: q (b, head), ck (b, s, head),
// cv (b, s, head), out (b, head) element strides, 10 values. Head dim 16, 32,
// 64 or 128; NH / NKV * Hd <= 2048.
extern "C" int kt_decode_attention(const void* q, const void* ck, const void* cv,
                                   const int* pos, void* o, int dtype, int B, int S,
                                   int NH, int NKV, int HD, const long long* strides,
                                   float scale, void* stream) {
  DecParams p;
  p.q = q;
  p.k = ck;
  p.v = cv;
  p.pos = pos;
  p.o = o;
  p.S = S;
  p.NH = NH;
  p.NKV = NKV;
  p.qs[0] = strides[0];
  p.qs[1] = strides[1];
  for (int i = 0; i < 3; ++i) {
    p.ks[i] = strides[2 + i];
    p.vs[i] = strides[5 + i];
  }
  p.os[0] = strides[8];
  p.os[1] = strides[9];
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0) return cudaSuccess;
  if (NKV <= 0 || NH % NKV != 0 || (NH / NKV) * HD > MAXR * THREADS)
    return cudaErrorInvalidValue;
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
