// FlashAttention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel kubetorch_tpu/ops/attention.py:_fwd_kernel
// (launched by _fwd, public flash_attention). Same function: causal (or
// full) attention with an online softmax and fp32 accumulators, GQA through
// kv-head h*NKV/N, whole K/V tiles above the diagonal skipped and the
// diagonal tile masked with -1e30, fully masked rows written as 0. With a
// non-null `lse` it also writes each row's log-sum-exp m + log(l) (the
// residual the backward kernels in flash_bwd.cu recompute P from), as the
// Pallas kernel does with need_lse; a null `lse` writes nothing more.
//
// Two bodies, chosen by (dtype, head dim) alone:
//
// bf16 at head dim 64 and 128 (the port's models: Llama-3.2-1B has 64,
// Llama-3-8B 128): flash_fwd_sm90, on the tensor cores. What bounds it on
// the H100: the causal work is 4*Hd flops per (q, k) pair against ~T/2
// flops per byte at the prefill and training shapes, so operations bound
// it, not HBM. Numerics: the Pallas body widens q, k and v to fp32 and
// keeps P unrounded. Q.K^T of bf16 inputs is exact on bf16 tensor cores
// with fp32 accumulation (up to the order of the sums); P.V has an fp32
// operand, so P goes to the tensor cores as two bf16 halves, hi = bf16(P)
// and lo = bf16(P - hi), and O += hi.V + lo.V: about 16 significant bits
// of P (error ~2^-17 per element, against 2^-9 for rounding P to bf16), at
// 6*Hd flops per pair instead of 4. Design: one block per (64-row q tile,
// head, batch), heaviest causal tiles first; one consumer warpgroup owns
// the 64 rows and one producer warp issues TMA copies (q once, then K/V
// tiles of 64 keys through a ring of 3 stages at Hd 64, 2 at Hd 128, each
// stage with a full/empty mbarrier pair). S = Q.K^T is wgmma m64n64k16
// with both operands in shared memory; the online softmax runs on the
// accumulator in registers (row statistics reduced across the 4 threads
// that share a row); the accumulator is already the A-register layout of
// P.V, so P is split and fed to register-A wgmma without touching shared
// memory. The q tile is 64 rows, not 128: short prefills (T = 128, B = 1,
// 32 heads) then give 64 blocks rather than 32 for 132 SMs, and with a
// 57 KB (Hd 64) or 81 KB (Hd 128) footprint three or two blocks share an
// SM, so one block's softmax runs beside another's wgmma. ptxas (CUDA
// 12.9, sm_90a) gives 99 registers a thread at Hd 64 and 131 at Hd 128,
// no spills.
//
// fp32 at every head dim, and bf16 at 16 and 32: flash_fwd_kernel, the
// first port's body, plain fp32 FMAs on CUDA cores (wgmma takes no fp32,
// and TF32's ~2^-11 would break the fp32 tolerance). A 64x64 tile per
// step, each thread owning a 4x4 block of logits and a 4x(Hd/16) block of
// the output in registers, K tile rows padded in shared memory so the
// logit loop reads without bank conflicts.
//
// Layout: q (B, S, N, Hd), k/v (B, S, NKV, Hd), out (B, S, N, Hd), read and
// written in place through their strides (no head-major copy); lse fp32
// (B, N, S), contiguous. C interface, launched on the caller's stream;
// returns the cudaError_t of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

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

// ---------------------------------------------------------------------------
// bf16, head dim 64 / 128: tensor cores (wgmma) fed by TMA
// ---------------------------------------------------------------------------

constexpr int CONSUMERS = 128;                // one warpgroup: 64 q rows
constexpr int SM90_THREADS = CONSUMERS + 32;  // + one producer warp

template <int HD>
struct FwdSmem {  // byte offsets from a 1024-byte-aligned base
  static constexpr int STAGES = HD == 64 ? 3 : 2;
  static constexpr int Q_BYTES = BQ * HD * 2;   // HD/64 chunks of BQ x 128 B
  static constexpr int KV_BYTES = BK * HD * 2;  // one K or V tile
  static constexpr int Q = 0;
  static constexpr int K = Q + Q_BYTES;                // + stage * KV_BYTES
  static constexpr int V = K + STAGES * KV_BYTES;      // + stage * KV_BYTES
  static constexpr int BAR = V + STAGES * KV_BYTES;    // q_full, full[], empty[]
  static constexpr int BYTES = BAR + 8 * (1 + 2 * STAGES);
};

template <int HD>
__global__ void __launch_bounds__(SM90_THREADS)
    flash_fwd_sm90(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, FwdParams p) {
  using L = FwdSmem<HD>;
  using namespace sm90;
  constexpr int CHUNKS = HD / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + L::STAGES;

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h * p.NKV / p.N;
  const int q0 = qt * BQ;
  const int S = p.S;
  int n_kt = (S + BK - 1) / BK;
  if (p.causal) n_kt = min(n_kt, (q0 + BQ - 1) / BK + 1);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {  // producer warp: one lane issues TMA
    if (threadIdx.x == CONSUMERS) {
      mbar_arrive_expect_tx(q_full, L::Q_BYTES);
      for (int c = 0; c < CHUNKS; ++c)
        tma_load_4d(smem + L::Q + c * BQ * 128, &tq, q_full, c * 64, h, q0, b);
      int stage = 0;
      uint32_t phase = 0;
      for (int kt = 0; kt < n_kt; ++kt) {
        mbar_wait(&empty[stage], phase ^ 1);
        mbar_arrive_expect_tx(&full[stage], 2 * L::KV_BYTES);
        for (int c = 0; c < CHUNKS; ++c) {
          tma_load_4d(smem + L::K + stage * L::KV_BYTES + c * BK * 128, &tk, &full[stage],
                      c * 64, kvh, kt * BK, b);
          tma_load_4d(smem + L::V + stage * L::KV_BYTES + c * BK * 128, &tv, &full[stage],
                      c * 64, kvh, kt * BK, b);
        }
        if (++stage == L::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // consumer warpgroup: rows r0 and r0 + 8 of the q tile, columns 8j + 2c
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int c2 = 2 * (lane % 4);
  const int r0 = q0 + 16 * warp + lane / 4;
  const int r1 = r0 + 8;
  const uint32_t q_addr = smem_addr(smem + L::Q);

  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;

  mbar_wait(q_full, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    mbar_wait(&full[stage], phase);
    const uint32_t k_addr = smem_addr(smem + L::K + stage * L::KV_BYTES);
    const uint32_t v_addr = smem_addr(smem + L::V + stage * L::KV_BYTES);

    // S = Q.K^T: k steps of 16 along the head dim, 4 per 64-wide chunk
    float s[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
      const uint32_t off = (ks % 4) * 32;  // within a 128-byte swizzled row
      wgmma_ss(s, desc_sw128(q_addr + (ks / 4) * BQ * 128 + off, 16),
               desc_sw128(k_addr + (ks / 4) * BK * 128 + off, 16), ks > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // scale and mask (only the diagonal and the ragged last tile need it)
    const bool edge = k0 + BK > S || (p.causal && k0 + BK - 1 > q0);
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = k0 + 8 * j + c2 + e;
        float x0 = s[4 * j + e] * p.scale;
        float x1 = s[4 * j + 2 + e] * p.scale;
        if (edge) {
          if (col >= S || (p.causal && col > r0)) x0 = NEG_INF;
          if (col >= S || (p.causal && col > r1)) x1 = NEG_INF;
        }
        s[4 * j + e] = x0;
        s[4 * j + 2 + e] = x1;
        mx0 = fmaxf(mx0, x0);
        mx1 = fmaxf(mx1, x1);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = expf(m0 - mn0), a1 = expf(m1 - mn1);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[4 * j + e] = expf(s[4 * j + e] - mn0);
        s[4 * j + 2 + e] = expf(s[4 * j + 2 + e] - mn1);
        sum0 += s[4 * j + e];
        sum1 += s[4 * j + 2 + e];
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, off);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, off);
    }
    l0 = l0 * a0 + sum0;
    l1 = l1 * a1 + sum1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      o[4 * j] *= a0;
      o[4 * j + 1] *= a0;
      o[4 * j + 2] *= a1;
      o[4 * j + 3] *= a1;
    }

    // O += P.V as hi.V + lo.V; V is MN-major (head dim contiguous), a k16
    // step is 16 key rows
    uint32_t ph[BK / 4], pl[BK / 4];
    split_acc(s, ph, pl);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t dv = desc_sw128(v_addr + kk * 16 * 128, BK * 128);
      wgmma_rs(o, ph[4 * kk], ph[4 * kk + 1], ph[4 * kk + 2], ph[4 * kk + 3], dv);
      wgmma_rs(o, pl[4 * kk], pl[4 * kk + 1], pl[4 * kk + 2], pl[4 * kk + 3], dv);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    fence_regs(ph);
    fence_regs(pl);
    mbar_arrive(&empty[stage]);
    if (++stage == L::STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }

  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.o) + b * p.os[0] + h * p.os[2];
  const float ls0 = l0 == 0.f ? 1.f : l0;
  const float ls1 = l1 == 0.f ? 1.f : l1;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    const int col = 8 * j + c2;
    if (r0 < S)
      *reinterpret_cast<__nv_bfloat162*>(out + (long long)r0 * p.os[1] + col) =
          __floats2bfloat162_rn(o[4 * j] / ls0, o[4 * j + 1] / ls0);
    if (r1 < S)
      *reinterpret_cast<__nv_bfloat162*>(out + (long long)r1 * p.os[1] + col) =
          __floats2bfloat162_rn(o[4 * j + 2] / ls1, o[4 * j + 3] / ls1);
  }
  if (p.lse != nullptr && lane % 4 == 0) {
    float* lse = p.lse + ((long long)b * p.N + h) * S;
    if (r0 < S) lse[r0] = m0 + logf(ls0);
    if (r1 < S) lse[r1] = m1 + logf(ls1);
  }
}

template <int HD>
cudaError_t launch_sm90(const FwdParams& p, int B, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  cudaError_t err = sm90::encode_bshd(&tq, p.q, B, p.S, p.N, HD, p.qs, BQ);
  if (err == cudaSuccess) err = sm90::encode_bshd(&tk, p.k, B, p.S, p.NKV, HD, p.ks, BK);
  if (err == cudaSuccess) err = sm90::encode_bshd(&tv, p.v, B, p.S, p.NKV, HD, p.vs, BK);
  if (err != cudaSuccess) return err;
  const int smem = FwdSmem<HD>::BYTES + 1024;  // + alignment slack
  err = cudaFuncSetAttribute(flash_fwd_sm90<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.S + BQ - 1) / BQ, p.N, B);
  flash_fwd_sm90<HD><<<grid, SM90_THREADS, smem, stream>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

// Which body serves (dtype, head dim): the dispatch below and the query
// kt_flash_fwd_body read this one predicate.
bool takes_sm90(int dtype, int HD) { return dtype == 1 && (HD == 64 || HD == 128); }

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
  if (takes_sm90(dtype, HD))
    return HD == 64 ? launch_sm90<64>(p, B, st) : launch_sm90<128>(p, B, st);
  switch (dtype * 1000 + HD) {
    case 1032: return launch<__nv_bfloat16, 32>(p, B, st);
    case 1016: return launch<__nv_bfloat16, 16>(p, B, st);
    case 128: return launch<float, 128>(p, B, st);
    case 64: return launch<float, 64>(p, B, st);
    case 32: return launch<float, 32>(p, B, st);
    case 16: return launch<float, 16>(p, B, st);
    default: return cudaErrorInvalidValue;
  }
}

// 1 if (dtype, head dim) runs on the tensor-core body, 0 if on the fp32-FMA
// body (the tests read this; the launch above dispatches on the same
// predicate).
extern "C" int kt_flash_fwd_body(int dtype, int HD) { return takes_sm90(dtype, HD) ? 1 : 0; }
