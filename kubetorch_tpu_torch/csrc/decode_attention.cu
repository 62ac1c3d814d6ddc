// Flash-decode for Hopper (sm_90a): one new token per slot against that
// slot's KV cache rows <= pos, over a bf16/fp32 cache (B1) or an int8
// cache with per-row fp32 scales (B2).
//
// Replaces the Pallas TPU kernel kubetorch_tpu/ops/decode_attention.py:
// _make_decode_kernel (launched by _decode_call; public decode_attention
// for quant=False, decode_attention_quant for quant=True). Same function:
// online softmax over K/V tiles, the query block is the GQA group of one
// kv-head, every tile past the slot's frontier is neither loaded nor
// computed, masked logits are -1e30, accumulation in fp32. Like the Pallas
// file, both cache layouts share ONE kernel body (decode_kernel<T, HD,
// QUANT>), so the frontier skip, the online softmax and the finalize can
// never drift apart; QUANT only changes the cache element type and where
// the row scales fold in:
// - QUANT = false: P is rounded to the cache type before the P.V product;
// - QUANT = true: K/V tiles are int8 and widen to fp32, the logits are
//   (q . k) * scale * ks[row], P is not rounded, P * vs[row] meets the
//   int8 V widened to fp32, and the output is in q's type.
//
// What bounds it on the H100: bytes. Each kv row is read once and feeds
// only 2*G*Hd flops per operand (G = N/NKV = 4 for Llama-3-8B), far below
// the ~295 flops per byte where the tensor cores would become the limit,
// so the least time is the live rows of K and V (and, for B2, their row
// scales) over 3.35 TB/s. What the design does about it: the cache is read
// in place through its strides as (B, S, NKV, Hd) — no per-step transpose
// or copy — with 16-byte loads (8 bf16 or 16 int8 values), and only rows
// <= pos[b] are touched; q stays in shared memory in fp32. B2's scales
// (B, S, NKV) are read through their strides, one per live row and tile.
// This first version runs one block per (kv-head, slot), so 8 slots x 8
// kv-heads fill 64 of 132 SMs and each block streams its rows without
// overlap; splitting S across blocks with a log-sum-exp combine is the
// planned redesign, for B1 and B2 together.
//
// Layout: q (B, NH, Hd), ck/cv (B, S, NKV, Hd), pos (B,) int32 on the
// device, out (B, NH, Hd); for B2 also ks/vs (B, S, NKV) fp32. C
// interface, launched on the caller's stream; returns the cudaError_t of
// the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BK = 64;        // cache rows per tile (two per lane of a warp)
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAXR = 8;       // outputs per thread: G * Hd <= 2048
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct DecParams {
  const void* q;
  const void* k;
  const void* v;
  const float* ksc;         // B2 only: per-row K and V scales
  const float* vsc;
  const int* pos;
  void* o;
  int S, NH, NKV;
  long long qs[2];          // q (b, head) element strides
  long long ks[3], vs[3];   // cache (b, s, head) element strides
  long long os[2];          // out (b, head)
  long long kss[3], vss[3]; // B2 scales (b, s, head) element strides
  float scale;
};

// the cache element type: T itself, or int8 for the quantized layout
template <typename T, bool QUANT>
using CacheT = typename std::conditional<QUANT, int8_t, T>::type;

// shared-memory row padding of the K tile, by element size: every K row
// spans an odd number of 32-bit words, so the logits loop's 32 keys fall
// in 32 banks
template <typename CT>
__host__ __device__ constexpr int kpad() {
  return sizeof(CT) == 1 ? 4 : (sizeof(CT) == 2 ? 2 : 1);
}

template <typename T, int HD>
__device__ __forceinline__ void load_rows(T* dst, int dstride, const T* src,
                                          long long sstride, int r0, int limit) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int PER_ROW = HD / VEC;
  for (int idx = threadIdx.x; idx < BK * PER_ROW; idx += THREADS) {
    const int r = idx / PER_ROW;
    const int c = (idx % PER_ROW) * VEC;
    alignas(16) T vals[VEC];
    if (r0 + r < limit) {
      *reinterpret_cast<uint4*>(vals) =
          *reinterpret_cast<const uint4*>(src + (long long)(r0 + r) * sstride + c);
    } else {
      *reinterpret_cast<uint4*>(vals) = make_uint4(0u, 0u, 0u, 0u);  // zero in every type
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) dst[r * dstride + c + e] = vals[e];
  }
}

template <typename T, int HD, bool QUANT>
__global__ void __launch_bounds__(THREADS) decode_kernel(DecParams p) {
  using CT = CacheT<T, QUANT>;
  constexpr int KSTR = HD + kpad<CT>();
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
  float* KSs = As + G;                         // B2: this tile's K row scales
  float* VSs = KSs + (QUANT ? BK : 0);         // B2: and V row scales
  CT* Ks = reinterpret_cast<CT*>(VSs + (QUANT ? BK : 0));  // (BK, KSTR)
  CT* Vs = Ks + BK * KSTR;                     // (BK, HD)

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

  const CT* k = static_cast<const CT*>(p.k) + b * p.ks[0] + h * p.ks[2];
  const CT* v = static_cast<const CT*>(p.v) + b * p.vs[0] + h * p.vs[2];
  const int n_kt = (n + BK - 1) / BK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile is no longer read
    load_rows<CT, HD>(Ks, KSTR, k, p.ks[1], k0, n);
    load_rows<CT, HD>(Vs, HD, v, p.vs[1], k0, n);
    if constexpr (QUANT) {
      const float* ksb = p.ksc + b * p.kss[0] + h * p.kss[2];
      const float* vsb = p.vsc + b * p.vss[0] + h * p.vss[2];
      for (int r = threadIdx.x; r < BK; r += THREADS) {
        const bool live = k0 + r < n;
        KSs[r] = live ? ksb[(long long)(k0 + r) * p.kss[1]] : 0.f;
        VSs[r] = live ? vsb[(long long)(k0 + r) * p.vss[1]] : 0.f;
      }
    }
    __syncthreads();

    // logits: one (row, key) pair per thread per pass
    for (int idx = threadIdx.x; idx < G * BK; idx += THREADS) {
      const int g = idx / BK;
      const int c = idx % BK;
      const float* qg = Qs + g * HD;
      const CT* kc = Ks + c * KSTR;
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < HD; ++d) s = fmaf(qg[d], to_f(kc[d]), s);
      s *= p.scale;
      if constexpr (QUANT) s *= KSs[c];    // the row scale on the logit column
      Ps[idx] = (k0 + c < n) ? s : NEG_INF;
    }
    __syncthreads();

    // online softmax, one warp per query row; P rounds to the cache type
    // (B1) or, unrounded, takes the V row scale (B2)
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
      if constexpr (QUANT) {
        Ps[g * BK + lane] = pa * VSs[lane];
        Ps[g * BK + lane + 32] = pc * VSs[lane + 32];
      } else {
        Ps[g * BK + lane] = to_f(from_f<T>(pa));
        Ps[g * BK + lane + 32] = to_f(from_f<T>(pc));
      }
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

template <typename T, int HD, bool QUANT>
cudaError_t launch(const DecParams& p, int B, cudaStream_t stream) {
  using CT = CacheT<T, QUANT>;
  const int G = p.NH / p.NKV;
  const size_t smem =
      (size_t)(G * HD + G * BK + 3 * G + (QUANT ? 2 * BK : 0)) * sizeof(float) +
      (size_t)(BK * (HD + kpad<CT>()) + BK * HD) * sizeof(CT);
  cudaError_t err = cudaFuncSetAttribute(decode_kernel<T, HD, QUANT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(p.NKV, B);
  decode_kernel<T, HD, QUANT><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// dtype (0 = float32, 1 = bfloat16) and head dim → the instantiation
template <bool QUANT>
cudaError_t dispatch(const DecParams& p, int dtype, int B, int HD, cudaStream_t st) {
  if (B <= 0) return cudaSuccess;
  if (p.NKV <= 0 || p.NH % p.NKV != 0 || (p.NH / p.NKV) * HD > MAXR * THREADS)
    return cudaErrorInvalidValue;
  switch (dtype * 1000 + HD) {
    case 1128: return launch<__nv_bfloat16, 128, QUANT>(p, B, st);
    case 1064: return launch<__nv_bfloat16, 64, QUANT>(p, B, st);
    case 1032: return launch<__nv_bfloat16, 32, QUANT>(p, B, st);
    case 1016: return launch<__nv_bfloat16, 16, QUANT>(p, B, st);
    case 128: return launch<float, 128, QUANT>(p, B, st);
    case 64: return launch<float, 64, QUANT>(p, B, st);
    case 32: return launch<float, 32, QUANT>(p, B, st);
    case 16: return launch<float, 16, QUANT>(p, B, st);
    default: return cudaErrorInvalidValue;
  }
}

DecParams make_params(const void* q, const void* ck, const void* cv, const int* pos,
                      void* o, int S, int NH, int NKV, const long long* strides,
                      float scale) {
  DecParams p = {};
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
  return p;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. strides: q (b, head), ck (b, s, head),
// cv (b, s, head), out (b, head) element strides, 10 values. Head dim 16, 32,
// 64 or 128; NH / NKV * Hd <= 2048.
extern "C" int kt_decode_attention(const void* q, const void* ck, const void* cv,
                                   const int* pos, void* o, int dtype, int B, int S,
                                   int NH, int NKV, int HD, const long long* strides,
                                   float scale, void* stream) {
  const DecParams p = make_params(q, ck, cv, pos, o, S, NH, NKV, strides, scale);
  return dispatch<false>(p, dtype, B, HD, static_cast<cudaStream_t>(stream));
}

// B2: kq/vq int8 (B, S, NKV, Hd), ks/vs fp32 (B, S, NKV); dtype is q's and
// the output's. strides: the 10 of kt_decode_attention (kq and vq in place
// of ck and cv), then ks (b, s, head) and vs (b, s, head): 16 values.
extern "C" int kt_decode_attention_quant(const void* q, const void* kq, const float* ks,
                                         const void* vq, const float* vs,
                                         const int* pos, void* o, int dtype, int B,
                                         int S, int NH, int NKV, int HD,
                                         const long long* strides, float scale,
                                         void* stream) {
  DecParams p = make_params(q, kq, vq, pos, o, S, NH, NKV, strides, scale);
  p.ksc = ks;
  p.vsc = vs;
  for (int i = 0; i < 3; ++i) {
    p.kss[i] = strides[10 + i];
    p.vss[i] = strides[13 + i];
  }
  return dispatch<true>(p, dtype, B, HD, static_cast<cudaStream_t>(stream));
}
