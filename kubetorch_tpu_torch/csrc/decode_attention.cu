// Flash-decode for Hopper (sm_90a): one new token per slot against that
// slot's KV cache rows <= pos, over a bf16/fp32 cache (B1) or an int8
// cache with per-row fp32 scales (B2).
//
// Replaces the Pallas TPU kernel kubetorch_tpu/ops/decode_attention.py:
// _make_decode_kernel (launched by _decode_call; public decode_attention
// for quant=False, decode_attention_quant for quant=True). Same function:
// online softmax over 64-row K/V tiles, the query block is the GQA group of
// one kv-head, no tile past the slot's frontier is loaded or computed,
// masked logits are -1e30, accumulation in fp32. Like the Pallas file, both
// cache layouts share ONE body per design, so the frontier skip, the online
// softmax and the finalize can never drift apart; QUANT only changes the
// cache element type and where the row scales fold in:
// - QUANT = false: P is rounded to the cache type before the P.V product;
// - QUANT = true: K/V are int8, the logits are (q . k) * scale * ks[row],
//   P is not rounded, P * vs[row] meets V, and the output is in q's type.
//
// What bounds it on the H100: bytes. Each kv row is read once and feeds
// 2 * G * Hd flops per operand (G = NH / NKV = 4 for Llama-3-8B): 4 flops a
// byte of bf16 K/V, 8 of int8, far below the ~295 where the tensor cores
// would be the limit. The least time is the live rows of K and V (and, for
// B2, their row scales) over 3.35 TB/s, so the design is about keeping
// enough loads in flight on every SM, and the arithmetic off their path.
//
// Two bodies, chosen by kt_decode_attention_body:
//
// bf16 q at head dim 64 or 128 with G <= 16: decode_split, the cache split
// across blocks. One block per (split, kv-head, slot); a split is a run of
// whole 64-row tiles whose length the wrapper picks from (B, NKV, S) alone
// (ops/decode_attention.py:decode_split_plan), never from pos, so the grid
// is the same on every decode step and a CUDA graph of the step replays it.
// A split whose first row lies past its slot's frontier returns at once and
// reads nothing (the Pallas index maps' frontier skip). Inside a block,
// four warps stream the split's tiles through a 2-stage cp.async ring (16-
// byte copies into padded shared rows; rows past the frontier arrive as
// zeros), so the next tile's load overlaps this tile's products. Warp w
// takes keys 16w .. 16w + 15 of each tile, in the FA2 register form with
// mma.sync m16n8k16 (bf16 in, fp32 accumulate):
// - S = q . K^T: q's G rows, padded to 16, are the A operand, loaded once
//   into registers; K's rows as stored are the B operand (ldmatrix);
// - the tile's row max is exchanged through shared memory, so every warp
//   rescales under the same running max, as one online softmax over the
//   tile would;
// - S's accumulator is, pair by pair, the A fragment of P . V, with V the
//   B operand through ldmatrix.trans. B1 packs P to bf16 (the reference's
//   rounding); B2 multiplies the unrounded P by vs and runs the product
//   over its two bf16 halves, hi = bf16(x) and lo = bf16(x - hi) (~16 bits
//   kept; rounding it once is ~1e-3 of a row, a different result);
// - int8 K and V widen exactly to bf16: each warp converts its own 16 rows
//   into a private bf16 staging tile before its ldmatrix reads.
// The padding of G = 4 to 16 rows wastes 3/4 of each product; the tensor
// work is still ~11% of an SM's rate at the byte bound. At the end, the
// four warps' sums are added in warp order in shared memory. A slot whose
// live rows fit one split (n_live <= 1) has its output written by split 0
// directly; otherwise each live split writes its running max m, sum l and
// unnormalised fp32 acc for the G rows to a partial buffer the wrapper
// allocates per call, and decode_combine, a second pass of one block per
// (query row, kv-head, slot), combines them in split order as the reference's
// sp_decode_attention does (kubetorch_tpu/parallel/ring_attention.py:146):
// m_g = max m, corr = exp(m - m_g), l_g = sum l * corr, acc_g = sum acc *
// corr, out = acc_g / (l_g == 0 ? 1 : l_g). Only the n_live splits that
// hold a live row are read, so a split with no live row never carries
// weight. Why a second pass and not the last block to arrive: it needs no
// counter that outlives the call, so two streams or a graph replay can
// never share state, the sums hold no atomics (two calls agree bit for
// bit), and its extra launch costs the host ~3 us a layer inside the same
// C call, small against a host-bound step.
//
// fp32 q, head dim 16 or 32, or G > 16: decode_kernel, the first design,
// one block per (kv-head, slot), fp32 FMA loops over shared memory.
//
// Layout: q (B, NH, Hd), ck/cv (B, S, NKV, Hd), pos (B,) int32 on the
// device, out (B, NH, Hd); for B2 also ks/vs (B, S, NKV) fp32, all read in
// place through their strides. C interface, launched on the caller's
// stream; returns the cudaError_t of the launches.

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

// rows [0, n) of slot b are live: the frontier row pos[b] itself is included
__device__ __forceinline__ int live_rows(const DecParams& p, int b) {
  return max(0, min(p.pos[b] + 1, p.S));
}

// the cache element type: T itself, or int8 for the quantized layout
template <typename T, bool QUANT>
using CacheT = typename std::conditional<QUANT, int8_t, T>::type;

// ---------------------------------------------------------------------------
// fp32 q, head dim 16/32, G > 16: the FMA body, one block per (kv-head, slot)
// ---------------------------------------------------------------------------

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

  const int n = live_rows(p, b);

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
cudaError_t launch_fma(const DecParams& p, int B, cudaStream_t stream) {
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

// ---------------------------------------------------------------------------
// bf16 q at head dim 64/128, G <= 16: the split tensor-core body
// ---------------------------------------------------------------------------

constexpr int SP_WARPS = 4;                // warp w: keys 16w .. 16w + 15 of a tile
constexpr int SP_THREADS = 32 * SP_WARPS;
constexpr int SP_STAGES = 2;
constexpr int SP_MAXG = 16;                // q rows of the m16 side

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(addr))));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(addr))));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float x, float y) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(x, y);  // x in the low half
  return *reinterpret_cast<const uint32_t*>(&v);
}

// (x, y) as hi = bf16(x, y) and lo = bf16(x - hi, y - hi); x - hi is exact
__device__ __forceinline__ void split_bf16x2(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16x2(x - hf.x, y - hf.y);
}

// Shared-memory layout of the split body (byte offsets), by cache element
// type and head dim. A ring stage holds one 64-row tile of K and of V (and
// for int8 their 64 K and 64 V row scales); bf16 rows are padded by 16
// bytes, so the 8 rows of an ldmatrix fall in 8 distinct bank groups.
// Int8 rows are widened by each warp into its own padded bf16 staging
// rows (16 of K, 16 of V). The final per-warp sums reuse the ring.
template <typename CT, int HD>
struct SplitSmem {
  static constexpr bool QUANT = sizeof(CT) == 1;
  static constexpr int RS = HD * (int)sizeof(CT) + (QUANT ? 0 : 16);  // ring row bytes
  static constexpr int TILE = BK * RS;
  static constexpr int SCALES = QUANT ? 2 * BK * 4 : 0;
  static constexpr int STAGE = 2 * TILE + SCALES;
  static constexpr int SST = HD * 2 + 16;                      // staging row bytes
  static constexpr int STAGING = QUANT ? SP_WARPS * 2 * 16 * SST : 0;
  static constexpr int RING = 0;
  static constexpr int STG = RING + SP_STAGES * STAGE;
  static constexpr int RED = STG + STAGING;                    // (warp, row) tile max
  static constexpr int LSUM = RED + SP_WARPS * 16 * 4;         // (warp, row) sums
  static constexpr int MROW = LSUM + SP_WARPS * 16 * 4;        // running max per row
  static constexpr int BYTES = MROW + 16 * 4;
  static_assert(SP_WARPS * SP_MAXG * HD * 4 <= SP_STAGES * STAGE, "sums fit the ring");
};

// Issue one tile's cp.async copies: K and V rows r0 .. r0 + 63 (rows at or
// past n arrive as zeros and read nothing) and, for int8, their row scales.
template <typename CT, int HD, bool QUANT>
__device__ __forceinline__ void load_split_tile(unsigned char* stage, const CT* k, long long k1,
                                                const CT* v, long long v1, const float* ksb,
                                                long long ks1, const float* vsb, long long vs1,
                                                int r0, int n) {
  using L = SplitSmem<CT, HD>;
  constexpr int CPR = HD * (int)sizeof(CT) / 16;  // 16-byte chunks per row
  constexpr int VEC = 16 / (int)sizeof(CT);
  for (int i = threadIdx.x; i < 2 * BK * CPR; i += SP_THREADS) {
    const bool is_v = i >= BK * CPR;
    const int j = is_v ? i - BK * CPR : i;
    const int r = j / CPR, c = j % CPR;
    const bool live = r0 + r < n;
    const CT* base = is_v ? v : k;
    const CT* src = live ? base + (long long)(r0 + r) * (is_v ? v1 : k1) + c * VEC : base;
    cp_async16(stage + (is_v ? L::TILE : 0) + r * L::RS + c * 16, src, live ? 16 : 0);
  }
  if constexpr (QUANT) {
    const int r = threadIdx.x % BK;
    const bool is_v = threadIdx.x >= BK;
    const bool live = r0 + r < n;
    const float* base = is_v ? vsb : ksb;
    const float* src = live ? base + (long long)(r0 + r) * (is_v ? vs1 : ks1) : base;
    cp_async4(stage + 2 * L::TILE + (is_v ? BK * 4 : 0) + r * 4, src, live ? 4 : 0);
  }
}

// int8 byte i of w, exactly, as fp32: the bits 0x4B0000uu with u = byte ^
// 0x80 are 2^23 + x + 128 (one byte permute and one add, no conversion)
template <int I>
__device__ __forceinline__ float i8_to_f(uint32_t w_x80) {
  return __int_as_float(__byte_perm(w_x80, 0x4B000000u, I | 0x7440)) - 8388736.f;
}

// Widen a warp's 16 int8 rows (ring rows of RS bytes) to bf16 staging rows.
template <int HD>
__device__ __forceinline__ void widen_rows(unsigned char* dst, int dst_stride,
                                           const unsigned char* src, int src_stride, int lane) {
  constexpr int CPR = HD / 16;
#pragma unroll
  for (int i = lane; i < 16 * CPR; i += 32) {
    const int r = i / CPR, c = i % CPR;
    const uint4 w = *reinterpret_cast<const uint4*>(src + r * src_stride + c * 16);
    const uint32_t words[4] = {w.x ^ 0x80808080u, w.y ^ 0x80808080u, w.z ^ 0x80808080u,
                               w.w ^ 0x80808080u};
    uint32_t o[8];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      o[2 * e] = pack_bf16x2(i8_to_f<0>(words[e]), i8_to_f<1>(words[e]));
      o[2 * e + 1] = pack_bf16x2(i8_to_f<2>(words[e]), i8_to_f<3>(words[e]));
    }
    uint4* d = reinterpret_cast<uint4*>(dst + r * dst_stride + c * 32);
    d[0] = make_uint4(o[0], o[1], o[2], o[3]);
    d[1] = make_uint4(o[4], o[5], o[6], o[7]);
  }
}

// grid (splits, NKV, B); the split's rows are [split * split_rows, + split_rows)
template <int HD, bool QUANT>
__global__ void __launch_bounds__(SP_THREADS)
    decode_split(DecParams p, int split_rows, int splits, float* __restrict__ work) {
  using T = __nv_bfloat16;
  using CT = CacheT<T, QUANT>;
  using L = SplitSmem<CT, HD>;
  constexpr int NT = HD / 8;  // n8 tiles of the output
  const int split = blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int B = gridDim.z;
  const int G = p.NH / p.NKV;
  const int n = live_rows(p, b);
  const int n_live = (n + split_rows - 1) / split_rows;  // splits holding a live row
  // the frontier skip: a split past the frontier reads nothing; split 0
  // always runs, and writes zeros for a slot with no live row
  if (split > 0 && split >= n_live) return;
  const bool direct = n_live <= 1;  // the output needs no combine

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int gid = lane >> 2, tig = lane & 3;

  extern __shared__ __align__(128) unsigned char smem[];
  float* red = reinterpret_cast<float*>(smem + L::RED);
  float* lsum = reinterpret_cast<float*>(smem + L::LSUM);
  float* mrow = reinterpret_cast<float*>(smem + L::MROW);

  const CT* k = static_cast<const CT*>(p.k) + b * p.ks[0] + h * p.ks[2];
  const CT* v = static_cast<const CT*>(p.v) + b * p.vs[0] + h * p.vs[2];
  const float* ksb = nullptr;
  const float* vsb = nullptr;
  if constexpr (QUANT) {
    ksb = p.ksc + b * p.kss[0] + h * p.kss[2];
    vsb = p.vsc + b * p.vss[0] + h * p.vss[2];
  }
  const int row0 = split * split_rows;
  const int nt_tiles = max(0, (min(row0 + split_rows, n) - row0 + BK - 1) / BK);

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF;  // running max of rows gid, gid + 8
  float l0 = 0.f, l1 = 0.f;          // this thread's share of their sums

#pragma unroll
  for (int i = 0; i < SP_STAGES; ++i) {
    if (i < nt_tiles)
      load_split_tile<CT, HD, QUANT>(smem + L::RING + i * L::STAGE, k, p.ks[1], v, p.vs[1], ksb,
                                     QUANT ? p.kss[1] : 0, vsb, QUANT ? p.vss[1] : 0,
                                     row0 + i * BK, n);
    cp_async_commit();
  }
  // while the first tiles load: q's rows gid and gid + 8 of the group as
  // A fragments, one per k16 step
  uint32_t qa[HD / 16][4];
  {
    const T* q = static_cast<const T*>(p.q) + b * p.qs[0] + (long long)h * G * p.qs[1];
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = gid + 8 * (i & 1);
        const int col = 16 * kk + 2 * tig + 8 * (i >> 1);
        qa[kk][i] = row < G ? *reinterpret_cast<const uint32_t*>(q + row * p.qs[1] + col) : 0u;
      }
  }

  for (int t = 0; t < nt_tiles; ++t) {
    const int r0 = row0 + t * BK;
    unsigned char* stage = smem + L::RING + (t % SP_STAGES) * L::STAGE;
    cp_async_wait<SP_STAGES - 1>();  // tile t has landed
    __syncthreads();

    // this warp's 16 K and V rows as bf16, and their byte stride
    const unsigned char* kw;
    const unsigned char* vw;
    int kvs;
    if constexpr (QUANT) {
      unsigned char* stg = smem + L::STG + warp * 2 * 16 * L::SST;
      widen_rows<HD>(stg, L::SST, stage + 16 * warp * L::RS, L::RS, lane);
      widen_rows<HD>(stg + 16 * L::SST, L::SST, stage + L::TILE + 16 * warp * L::RS, L::RS,
                     lane);
      __syncwarp();
      kw = stg;
      vw = stg + 16 * L::SST;
      kvs = L::SST;
    } else {
      kw = stage + 16 * warp * L::RS;
      vw = stage + L::TILE + 16 * warp * L::RS;
      kvs = L::RS;
    }

    // S = q . K^T over the warp's 16 keys: n8 tiles 0 and 1
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    {
      const int mi = lane >> 3;
      const unsigned char* a = kw + ((mi >> 1) * 8 + (lane & 7)) * kvs + (mi & 1) * 16;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t kb[4];
        ldmatrix_x4(kb, a + kk * 32);
        mma_bf16(s[0], qa[kk], kb[0], kb[1]);
        mma_bf16(s[1], qa[kk], kb[2], kb[3]);
      }
    }
    // scale, row scales, mask; element e of n8 tile j is key
    // 16 warp + 8 j + 2 tig + (e & 1) of row gid (e < 2) or gid + 8
    const float* kss = reinterpret_cast<const float*>(stage + 2 * L::TILE);
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = 16 * warp + 8 * j + 2 * tig + (e & 1);
        float x = s[j][e] * p.scale;
        if constexpr (QUANT) x *= kss[key];
        x = r0 + key < n ? x : NEG_INF;
        s[j][e] = x;
        if (e < 2) mx0 = fmaxf(mx0, x);
        else mx1 = fmaxf(mx1, x);
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    if (tig == 0) {
      red[warp * 16 + gid] = mx0;
      red[warp * 16 + gid + 8] = mx1;
    }
    __syncthreads();
    // the tile's max, in warp order: the same running max in every warp
    float t0 = red[gid], t1 = red[gid + 8];
#pragma unroll
    for (int w = 1; w < SP_WARPS; ++w) {
      t0 = fmaxf(t0, red[w * 16 + gid]);
      t1 = fmaxf(t1, red[w * 16 + gid + 8]);
    }
    const float mn0 = fmaxf(m0, t0), mn1 = fmaxf(m1, t1);
    const float al0 = __expf(m0 - mn0), al1 = __expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float pr[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) pr[j][e] = __expf(s[j][e] - (e < 2 ? mn0 : mn1));
    l0 = l0 * al0 + (pr[0][0] + pr[0][1]) + (pr[1][0] + pr[1][1]);
    l1 = l1 * al1 + (pr[0][2] + pr[0][3]) + (pr[1][2] + pr[1][3]);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      acc[j][0] *= al0;
      acc[j][1] *= al0;
      acc[j][2] *= al1;
      acc[j][3] *= al1;
    }

    // P as the A fragment over the warp's 16 keys: (row gid, keys 2 tig,
    // + 1), (gid + 8, same), (gid, 8 + 2 tig, + 1), (gid + 8, same)
    uint32_t pa[4], plo[4];
    if constexpr (QUANT) {
      const float* vss = kss + BK;
      const float v0 = vss[16 * warp + 2 * tig], v1 = vss[16 * warp + 2 * tig + 1];
      const float v8 = vss[16 * warp + 8 + 2 * tig], v9 = vss[16 * warp + 9 + 2 * tig];
      split_bf16x2(pr[0][0] * v0, pr[0][1] * v1, pa[0], plo[0]);
      split_bf16x2(pr[0][2] * v0, pr[0][3] * v1, pa[1], plo[1]);
      split_bf16x2(pr[1][0] * v8, pr[1][1] * v9, pa[2], plo[2]);
      split_bf16x2(pr[1][2] * v8, pr[1][3] * v9, pa[3], plo[3]);
    } else {
      pa[0] = pack_bf16x2(pr[0][0], pr[0][1]);
      pa[1] = pack_bf16x2(pr[0][2], pr[0][3]);
      pa[2] = pack_bf16x2(pr[1][0], pr[1][1]);
      pa[3] = pack_bf16x2(pr[1][2], pr[1][3]);
    }

    // acc += P . V: V's 16 rows through ldmatrix.trans, two n8 tiles a load
    {
      const int mi = lane >> 3;
      const unsigned char* a = vw + ((mi & 1) * 8 + (lane & 7)) * kvs + (mi >> 1) * 16;
#pragma unroll
      for (int j2 = 0; j2 < NT / 2; ++j2) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, a + j2 * 32);
        mma_bf16(acc[2 * j2], pa, vb[0], vb[1]);
        mma_bf16(acc[2 * j2 + 1], pa, vb[2], vb[3]);
        if constexpr (QUANT) {
          mma_bf16(acc[2 * j2], plo, vb[0], vb[1]);
          mma_bf16(acc[2 * j2 + 1], plo, vb[2], vb[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage
    if (t + SP_STAGES < nt_tiles)
      load_split_tile<CT, HD, QUANT>(stage, k, p.ks[1], v, p.vs[1], ksb, QUANT ? p.kss[1] : 0,
                                     vsb, QUANT ? p.vss[1] : 0, r0 + SP_STAGES * BK, n);
    cp_async_commit();
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it takes the warps' sums

  // the four warps' l and acc, added in warp order
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  float* accs = reinterpret_cast<float*>(smem + L::RING);  // (warp, G, HD)
  if (tig == 0) {
    lsum[warp * 16 + gid] = l0;
    lsum[warp * 16 + gid + 8] = l1;
    if (warp == 0) {
      mrow[gid] = m0;
      mrow[gid + 8] = m1;
    }
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = 8 * j + 2 * tig;
    if (gid < G)
      *reinterpret_cast<float2*>(accs + (warp * G + gid) * HD + col) =
          make_float2(acc[j][0], acc[j][1]);
    if (gid + 8 < G)
      *reinterpret_cast<float2*>(accs + (warp * G + gid + 8) * HD + col) =
          make_float2(acc[j][2], acc[j][3]);
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < G * HD; idx += SP_THREADS) {
    const int g = idx / HD, d = idx % HD;
    float a = accs[g * HD + d];
    float l = lsum[g];
#pragma unroll
    for (int w = 1; w < SP_WARPS; ++w) {
      a += accs[(w * G + g) * HD + d];
      l += lsum[w * 16 + g];
    }
    if (direct) {
      T* o = static_cast<T*>(p.o) + b * p.os[0] + (long long)(h * G + g) * p.os[1];
      o[d] = __float2bfloat16(a / (l == 0.f ? 1.f : l));
    } else {
      // partials: acc (splits, B, NKV, G, HD), then (m, l) (splits, B, NKV, G, 2)
      const long long row = (((long long)split * B + b) * p.NKV + h) * G + g;
      work[row * HD + d] = a;
      if (d == 0) {
        float* ml = work + (long long)splits * B * p.NH * HD;
        ml[2 * row] = mrow[g];
        ml[2 * row + 1] = l;
      }
    }
  }
}

// grid (G, NKV, B), one thread per output column d: the live splits of one
// query row, m_g = max m (exact in any order), then in split order corr =
// exp(m - m_g), l_g = sum l * corr, acc_g = sum acc * corr, and out = acc_g
// / (l_g == 0 ? 1 : l_g). The partials are staged through shared memory by
// cp.async, CMB_CHUNK splits at a time, so a chunk's loads are all in
// flight at once and only the sums run in order. Slots that fit one split
// were written by the split body and are skipped.
constexpr int CMB_CHUNK = 32;

__global__ void __launch_bounds__(128)
    decode_combine(DecParams p, int split_rows, int splits, const float* __restrict__ work) {
  const int g = blockIdx.x, h = blockIdx.y, b = blockIdx.z, B = gridDim.z;
  const int HD = blockDim.x, d = threadIdx.x;
  const int G = p.NH / p.NKV;
  const int n_live = (live_rows(p, b) + split_rows - 1) / split_rows;
  if (n_live <= 1) return;
  __shared__ __align__(16) float sacc[CMB_CHUNK * 128];
  __shared__ float scorr[CMB_CHUNK], sl[CMB_CHUNK], smax[4];
  const long long stride = (long long)B * p.NH;  // query rows between splits
  const long long row = ((long long)b * p.NKV + h) * G + g;
  const float* ml = work + (long long)splits * stride * HD + 2 * row;  // split s at 2 s stride
  const float* acc = work + row * HD;                                  // split s at s stride HD

  float mx = NEG_INF;
  for (int s = d; s < n_live; s += HD) mx = fmaxf(mx, ml[2 * s * stride]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  if (d % 32 == 0) smax[d / 32] = mx;
  __syncthreads();
  float m_g = smax[0];
  for (int w = 1; w < HD / 32; ++w) m_g = fmaxf(m_g, smax[w]);

  float l = 0.f, a = 0.f;
  for (int c0 = 0; c0 < n_live; c0 += CMB_CHUNK) {
    const int nc = min(CMB_CHUNK, n_live - c0);
    for (int k = d; k < nc * (HD / 4); k += HD) {  // 16-byte pieces of the chunk
      const int i = k / (HD / 4), c4 = 4 * (k % (HD / 4));
      cp_async16(sacc + i * HD + c4, acc + (c0 + i) * stride * HD + c4, 16);
    }
    cp_async_commit();
    if (d < nc) {
      scorr[d] = __expf(ml[2 * (c0 + d) * stride] - m_g);
      sl[d] = ml[2 * (c0 + d) * stride + 1];
    }
    cp_async_wait<0>();
    __syncthreads();
    for (int i = 0; i < nc; ++i) {
      l += sl[i] * scorr[i];
      a += sacc[i * HD + d] * scorr[i];
    }
    __syncthreads();  // the chunk is read before the next one lands
  }
  __nv_bfloat16* o =
      static_cast<__nv_bfloat16*>(p.o) + b * p.os[0] + (long long)(h * G + g) * p.os[1];
  o[d] = __float2bfloat16(a / (l == 0.f ? 1.f : l));
}

template <int HD, bool QUANT>
cudaError_t launch_split(const DecParams& p, int B, int split_rows, void* work,
                         cudaStream_t stream) {
  using L = SplitSmem<CacheT<__nv_bfloat16, QUANT>, HD>;
  if (split_rows <= 0 || split_rows % BK) return cudaErrorInvalidValue;
  const int splits = (p.S + split_rows - 1) / split_rows;
  if (splits > 1 && work == nullptr) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(decode_split<HD, QUANT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (err != cudaSuccess) return err;
  float* w = static_cast<float*>(work);
  decode_split<HD, QUANT>
      <<<dim3(splits, p.NKV, B), SP_THREADS, L::BYTES, stream>>>(p, split_rows, splits, w);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  decode_combine<<<dim3(p.NH / p.NKV, p.NKV, B), HD, 0, stream>>>(p, split_rows, splits, w);
  return cudaGetLastError();
}

// which body: 1 = the split tensor-core body, 0 = the FMA body
int body_of(int dtype, int HD, int NH, int NKV) {
  return dtype == 1 && (HD == 64 || HD == 128) && NKV > 0 && NH / NKV <= SP_MAXG ? 1 : 0;
}

// dtype (0 = float32, 1 = bfloat16) and head dim → the instantiation
template <bool QUANT>
cudaError_t dispatch(const DecParams& p, int dtype, int B, int HD, int split_rows, void* work,
                     cudaStream_t st) {
  if (B <= 0) return cudaSuccess;
  if (p.NKV <= 0 || p.NH % p.NKV != 0 || (p.NH / p.NKV) * HD > MAXR * THREADS)
    return cudaErrorInvalidValue;
  if (body_of(dtype, HD, p.NH, p.NKV)) {
    if (HD == 128) return launch_split<128, QUANT>(p, B, split_rows, work, st);
    return launch_split<64, QUANT>(p, B, split_rows, work, st);
  }
  switch (dtype * 1000 + HD) {
    case 1128: return launch_fma<__nv_bfloat16, 128, QUANT>(p, B, st);
    case 1064: return launch_fma<__nv_bfloat16, 64, QUANT>(p, B, st);
    case 1032: return launch_fma<__nv_bfloat16, 32, QUANT>(p, B, st);
    case 1016: return launch_fma<__nv_bfloat16, 16, QUANT>(p, B, st);
    case 128: return launch_fma<float, 128, QUANT>(p, B, st);
    case 64: return launch_fma<float, 64, QUANT>(p, B, st);
    case 32: return launch_fma<float, 32, QUANT>(p, B, st);
    case 16: return launch_fma<float, 16, QUANT>(p, B, st);
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

// 1 if (dtype, head dim, NH, NKV) takes the split tensor-core body, 0 if
// the FMA body; the same answer for B1 and B2.
extern "C" int kt_decode_attention_body(int dtype, int HD, int NH, int NKV) {
  return body_of(dtype, HD, NH, NKV);
}

// dtype: 0 = float32, 1 = bfloat16. strides: q (b, head), ck (b, s, head),
// cv (b, s, head), out (b, head) element strides, 10 values. Head dim 16, 32,
// 64 or 128; NH / NKV * Hd <= 2048. split_rows (a multiple of 64) and work
// serve the split body: work holds splits * B * NH * (Hd + 2) fp32 values,
// splits = ceil(S / split_rows), and may be null when splits == 1.
extern "C" int kt_decode_attention(const void* q, const void* ck, const void* cv,
                                   const int* pos, void* o, int dtype, int B, int S,
                                   int NH, int NKV, int HD, const long long* strides,
                                   float scale, int split_rows, void* work, void* stream) {
  const DecParams p = make_params(q, ck, cv, pos, o, S, NH, NKV, strides, scale);
  return dispatch<false>(p, dtype, B, HD, split_rows, work, static_cast<cudaStream_t>(stream));
}

// B2: kq/vq int8 (B, S, NKV, Hd), ks/vs fp32 (B, S, NKV); dtype is q's and
// the output's. strides: the 10 of kt_decode_attention (kq and vq in place
// of ck and cv), then ks (b, s, head) and vs (b, s, head): 16 values.
extern "C" int kt_decode_attention_quant(const void* q, const void* kq, const float* ks,
                                         const void* vq, const float* vs,
                                         const int* pos, void* o, int dtype, int B,
                                         int S, int NH, int NKV, int HD,
                                         const long long* strides, float scale,
                                         int split_rows, void* work, void* stream) {
  DecParams p = make_params(q, kq, vq, pos, o, S, NH, NKV, strides, scale);
  p.ksc = ks;
  p.vsc = vs;
  for (int i = 0; i < 3; ++i) {
    p.kss[i] = strides[10 + i];
    p.vss[i] = strides[13 + i];
  }
  return dispatch<true>(p, dtype, B, HD, split_rows, work, static_cast<cudaStream_t>(stream));
}
