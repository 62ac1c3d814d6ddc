// FlashAttention-2 backward for Hopper (sm_90a): dQ (kt_flash_bwd_dq) and
// dK/dV (kt_flash_bwd_dkv).
//
// Replaces the Pallas TPU kernels kubetorch_tpu/ops/attention.py:
// _bwd_dq_kernel and _bwd_dkv_kernel (both launched by _bwd, the VJP of
// flash_attention). Same functions: P = exp(s * scale - LSE) recomputed
// from the forward's log-sum-exp, dP = dO.V^T, dS = P * (dP - delta) * scale
// with delta = rowsum(dO * O) computed outside the kernels, then
//   dQ = dS.K                      (one block per q tile, head, batch)
//   dV = P^T.dO, dK = dS^T.Q       (one block per k tile, kv-head, batch)
// Causal tiles above the diagonal are skipped and the diagonal tile is
// masked with -1e30 before exp, as in the forward. The Pallas bodies widen
// q, k, v and dO to fp32 and keep P and dS unrounded; each output rounds to
// its input's type once.
//
// The dK/dV block owns its k tile's sums for the whole GQA group: it loops
// over every query head h = kvh * group + g of its kv-head and every q tile
// at or past the diagonal, and writes dK/dV once. That is the Pallas
// kernel's folded (group x q-block) axis (qhead = h * group + i / nq_blocks,
// qblock = i % nq_blocks) unrolled into two loops, with no atomics, so the
// result is deterministic.
//
// What bounds it on the H100: the causal backward does 14 * Hd flops per
// (q, k) pair (dQ 6, dK/dV 8) against ~8 * S * Hd bytes per head, so
// operations bound it at every training shape.
//
// dK/dV in bf16 at head dim 64 and 128: bwd_dkv_sm90, on the tensor cores.
// One block per (64-key tile, kv-head, batch); one consumer warpgroup owns
// the 64 key rows and keeps the dK and dV accumulators (64 x Hd fp32 each)
// in registers for the block's life; one producer warp TMA-loads K and V
// once, then streams (Q, dO) tiles and their LSE and delta rows through a
// ring of 2 stages with a full/empty mbarrier pair each. Per q tile, four
// wgmma products: S^T = K.Q^T and dP^T = V.dO^T (both operands in shared
// memory, bf16 x bf16 exact with fp32 sums); P^T and dS^T in fp32
// registers, masked as the Pallas body masks, with LSE and delta indexed
// by column; then dV += P^T.dO and dK += dS^T.Q as register-A wgmma, each
// over the hi and the lo bf16 half of its fp32 operand (P or dS = hi + lo,
// ~16 significant bits; 12*Hd flops per pair instead of 8), dO and Q read
// MN-major from the same ring tiles. Register pressure: the two
// accumulators take Hd values per thread (128 at Hd 128), so at Hd 128 the
// q tile is 32 rows (S^T and dP^T 16 registers each) and at Hd 64 it is 64
// rows (32 each); the dS and P fragments replace S^T and dP^T in place.
// With one consumer warpgroup that fits without setmaxnreg: ptxas (CUDA
// 12.9, sm_90a, -Xptxas -v) gives 173 registers a thread at Hd 64 and 200
// at Hd 128, no spill stores or loads.
//
// dQ in bf16 at head dim 64 and 128: bwd_dq_sm90, the same design turned
// around. One block per (64-row q tile, head, batch), heaviest causal tiles
// first; one consumer warpgroup owns the 64 query rows and keeps the dQ
// accumulator (64 x Hd fp32) in registers; one producer warp TMA-loads Q
// and dO once, stores the tile's LSE and delta rows, then streams the K and
// V tiles of the head's kv-head (h * NKV / N) up to the diagonal through a
// ring of 3 stages at Hd 64, 2 at Hd 128. Per k tile: S = Q.K^T and
// dP = dO.V^T as SS wgmma (exact bf16 products, fp32 sums); P and dS in the
// accumulator registers with LSE and delta indexed by row, masked before
// the exp (columns past S arrive as zeros from TMA, but delta is not zero
// there); dQ += dS.K as register-A wgmma over the hi and lo halves of dS,
// K read MN-major from the same ring tile (8*Hd flops per pair instead of
// 6).
//
// dQ and dK/dV in fp32 or at bf16 head dim 16 or 32: the first port's
// bodies, plain fp32 FMAs on CUDA cores (67 TFLOP/s
// peak), 64x64 tiles, each thread a 4x4 block of logits and dP and a
// 4 x (Hd/16) block of each accumulator in registers; all tile rows padded
// by one 32-bit word in shared memory so the column-strided reads of the
// logit loops hit distinct banks; heaviest causal tiles scheduled first.
//
// Layout: q/dO/dQ (B, S, N, Hd), k/v/dK/dV (B, S, NKV, Hd), read and
// written in place through their strides; lse and delta fp32 (B, N, S),
// contiguous. C interface, launched on the caller's stream; each entry
// returns the cudaError_t of its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int BQ = 64;        // query rows per tile
constexpr int BK = 64;        // key rows per tile
constexpr int THREADS = 256;  // 16 x 16 threads; thread (ty, tx)
constexpr int PSTR = BK + 1;  // row stride of the fp32 P / dS tiles
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// row stride in shared memory of a (rows, HD) tile: one 32-bit word of pad
template <typename T, int HD>
__host__ __device__ constexpr int tile_stride() { return HD + (sizeof(T) == 2 ? 2 : 1); }

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;    // (B, N, S)
  const float* delta;  // (B, N, S)
  void* dq;
  void* dk;
  void* dv;
  int S, N, NKV;
  // element strides of (b, s, head)
  long long qs[3], ks[3], vs[3], dos[3], dqs[3], dks[3], dvs[3];
  float scale;
  int causal;
};

// Copy rows [r0, r0 + ROWS) of one head into shared memory (row stride
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

// lse and delta of rows [r0, r0 + BQ) into shared memory; rows past S read 0
// (their q and dO rows are zeros, so they contribute dS = 0 and P.dO = 0).
__device__ __forceinline__ void load_stats(float* lse_s, float* delta_s,
                                           const float* lse, const float* delta,
                                           int r0, int S) {
  for (int r = threadIdx.x; r < BQ; r += THREADS) {
    const bool live = r0 + r < S;
    lse_s[r] = live ? lse[r0 + r] : 0.f;
    delta_s[r] = live ? delta[r0 + r] : 0.f;
  }
}

// s = Q.K^T and dp = dO.V^T for the thread's 4x4 block: query rows
// ty + 16i of the q tile, key rows tx + 16j of the k tile.
template <typename T, int HD>
__device__ __forceinline__ void logits_and_dp(const T* Qs, const T* dOs, const T* Ks,
                                              const T* Vs, int tx, int ty,
                                              float (&s)[4][4], float (&dp)[4][4]) {
  constexpr int TS = tile_stride<T, HD>();
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; ++d) {
    float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qv[i] = to_f(Qs[(ty + 16 * i) * TS + d]);
      ov[i] = to_f(dOs[(ty + 16 * i) * TS + d]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kv[j] = to_f(Ks[(tx + 16 * j) * TS + d]);
      vv[j] = to_f(Vs[(tx + 16 * j) * TS + d]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
      }
  }
}

// P and dS of the thread's block, masked as the forward masks (key past S,
// or above the diagonal, -> -1e30 before exp). Rows q0 + ty + 16i, columns
// k0 + tx + 16j.
__device__ __forceinline__ void probs_and_ds(const BwdParams& p, int q0, int k0, int tx,
                                             int ty, const float* lse_s,
                                             const float* delta_s, float (&s)[4][4],
                                             float (&dp)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    const float lse = lse_s[ty + 16 * i];
    const float delta = delta_s[ty + 16 * i];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = k0 + tx + 16 * j;
      float x = s[i][j] * p.scale;
      if (col >= p.S || (p.causal && col > row)) x = NEG_INF;
      const float pij = expf(x - lse);
      s[i][j] = pij;                                   // s now holds P
      dp[i][j] = pij * (dp[i][j] - delta) * p.scale;   // dp now holds dS
    }
  }
}

// A2: dQ for one (q tile, head, batch).
template <typename T, int HD>
__global__ void __launch_bounds__(THREADS) bwd_dq_kernel(BwdParams p) {
  constexpr int TS = tile_stride<T, HD>();
  constexpr int CPT = HD / 16;  // accumulator columns per thread: tx + 16c

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h * p.NKV / p.N;
  const int q0 = qt * BQ;
  const int S = p.S;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  extern __shared__ __align__(16) unsigned char smem[];
  float* dSs = reinterpret_cast<float*>(smem);
  float* lse_s = dSs + BQ * PSTR;
  float* delta_s = lse_s + BQ;
  T* Qs = reinterpret_cast<T*>(delta_s + BQ);
  T* dOs = Qs + BQ * TS;
  T* Ks = dOs + BQ * TS;
  T* Vs = Ks + BK * TS;

  const T* q = static_cast<const T*>(p.q) + b * p.qs[0] + h * p.qs[2];
  const T* dout = static_cast<const T*>(p.dout) + b * p.dos[0] + h * p.dos[2];
  const T* k = static_cast<const T*>(p.k) + b * p.ks[0] + kvh * p.ks[2];
  const T* v = static_cast<const T*>(p.v) + b * p.vs[0] + kvh * p.vs[2];
  const long long stat0 = ((long long)b * p.N + h) * S;
  load_tile<T, HD, BQ>(Qs, TS, q, p.qs[1], q0, S);
  load_tile<T, HD, BQ>(dOs, TS, dout, p.dos[1], q0, S);
  load_stats(lse_s, delta_s, p.lse + stat0, p.delta + stat0, q0, S);

  float acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;

  int n_kt = (S + BK - 1) / BK;
  if (p.causal) n_kt = min(n_kt, (q0 + BQ - 1) / BK + 1);

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's K/V/dS are no longer read
    load_tile<T, HD, BK>(Ks, TS, k, p.ks[1], k0, S);
    load_tile<T, HD, BK>(Vs, TS, v, p.vs[1], k0, S);
    __syncthreads();

    float s[4][4], dp[4][4];
    logits_and_dp<T, HD>(Qs, dOs, Ks, Vs, tx, ty, s, dp);
    probs_and_ds(p, q0, k0, tx, ty, lse_s, delta_s, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) dSs[(ty + 16 * i) * PSTR + tx + 16 * j] = dp[i][j];
    __syncthreads();

    // acc += dS.K in fp32
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float kv[CPT];
#pragma unroll
      for (int c = 0; c < CPT; ++c) kv[c] = to_f(Ks[kk * TS + tx + 16 * c]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ds = dSs[(ty + 16 * i) * PSTR + kk];
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[i][c] = fmaf(ds, kv[c], acc[i][c]);
      }
    }
  }

  T* dq = static_cast<T*>(p.dq) + b * p.dqs[0] + h * p.dqs[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= S) continue;
#pragma unroll
    for (int c = 0; c < CPT; ++c)
      dq[(long long)row * p.dqs[1] + tx + 16 * c] = from_f<T>(acc[i][c]);
  }
}

// A3: dK and dV for one (k tile, kv-head, batch), summed over every query
// head of the GQA group and every q tile at or past the diagonal.
template <typename T, int HD>
__global__ void __launch_bounds__(THREADS) bwd_dkv_kernel(BwdParams p) {
  constexpr int TS = tile_stride<T, HD>();
  constexpr int CPT = HD / 16;

  const int kt = blockIdx.x;  // causal: k tile 0 sees every q tile, so first
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int group = p.N / p.NKV;
  const int k0 = kt * BK;
  const int S = p.S;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;

  extern __shared__ __align__(16) unsigned char smem[];
  float* Ps = reinterpret_cast<float*>(smem);
  float* dSs = Ps + BQ * PSTR;
  float* lse_s = dSs + BQ * PSTR;
  float* delta_s = lse_s + BQ;
  T* Ks = reinterpret_cast<T*>(delta_s + BQ);
  T* Vs = Ks + BK * TS;
  T* Qs = Vs + BK * TS;
  T* dOs = Qs + BQ * TS;

  const T* k = static_cast<const T*>(p.k) + b * p.ks[0] + kvh * p.ks[2];
  const T* v = static_cast<const T*>(p.v) + b * p.vs[0] + kvh * p.vs[2];
  load_tile<T, HD, BK>(Ks, TS, k, p.ks[1], k0, S);
  load_tile<T, HD, BK>(Vs, TS, v, p.vs[1], k0, S);

  // key rows ty + 16i of the tile, columns tx + 16c
  float dk[4][CPT], dv[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) dk[i][c] = dv[i][c] = 0.f;

  const int n_qt = (S + BQ - 1) / BQ;
  // first q tile whose last row reaches k0 (the Pallas kernel's
  // qb * block_q + block_q - 1 >= kj * block_k)
  const int qt0 = p.causal ? k0 / BQ : 0;

  for (int g = 0; g < group; ++g) {
    const int h = kvh * group + g;
    const T* q = static_cast<const T*>(p.q) + b * p.qs[0] + h * p.qs[2];
    const T* dout = static_cast<const T*>(p.dout) + b * p.dos[0] + h * p.dos[2];
    const long long stat0 = ((long long)b * p.N + h) * S;
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();  // the previous q tile and P/dS are no longer read
      load_tile<T, HD, BQ>(Qs, TS, q, p.qs[1], q0, S);
      load_tile<T, HD, BQ>(dOs, TS, dout, p.dos[1], q0, S);
      load_stats(lse_s, delta_s, p.lse + stat0, p.delta + stat0, q0, S);
      __syncthreads();

      float s[4][4], dp[4][4];
      logits_and_dp<T, HD>(Qs, dOs, Ks, Vs, tx, ty, s, dp);
      probs_and_ds(p, q0, k0, tx, ty, lse_s, delta_s, s, dp);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          Ps[(ty + 16 * i) * PSTR + tx + 16 * j] = s[i][j];
          dSs[(ty + 16 * i) * PSTR + tx + 16 * j] = dp[i][j];
        }
      __syncthreads();

      // dV += P^T.dO and dK += dS^T.Q in fp32, over the tile's query rows
#pragma unroll 2
      for (int qq = 0; qq < BQ; ++qq) {
        float ov[CPT], qv[CPT];
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          ov[c] = to_f(dOs[qq * TS + tx + 16 * c]);
          qv[c] = to_f(Qs[qq * TS + tx + 16 * c]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pv = Ps[qq * PSTR + ty + 16 * i];
          const float ds = dSs[qq * PSTR + ty + 16 * i];
#pragma unroll
          for (int c = 0; c < CPT; ++c) {
            dv[i][c] = fmaf(pv, ov[c], dv[i][c]);
            dk[i][c] = fmaf(ds, qv[c], dk[i][c]);
          }
        }
      }
    }
  }

  T* dkp = static_cast<T*>(p.dk) + b * p.dks[0] + kvh * p.dks[2];
  T* dvp = static_cast<T*>(p.dv) + b * p.dvs[0] + kvh * p.dvs[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= S) continue;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      dkp[(long long)row * p.dks[1] + tx + 16 * c] = from_f<T>(dk[i][c]);
      dvp[(long long)row * p.dvs[1] + tx + 16 * c] = from_f<T>(dv[i][c]);
    }
  }
}

template <typename T, int HD>
cudaError_t launch_dq(const BwdParams& p, int B, cudaStream_t stream) {
  const size_t smem = (BQ * PSTR + 2 * BQ) * sizeof(float) +
                      (size_t)(2 * BQ + 2 * BK) * tile_stride<T, HD>() * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dq_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.S + BQ - 1) / BQ, p.N, B);
  bwd_dq_kernel<T, HD><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_dkv(const BwdParams& p, int B, cudaStream_t stream) {
  const size_t smem = (2 * BQ * PSTR + 2 * BQ) * sizeof(float) +
                      (size_t)(2 * BQ + 2 * BK) * tile_stride<T, HD>() * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dkv_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.S + BK - 1) / BK, p.NKV, B);
  bwd_dkv_kernel<T, HD><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// dK/dV in bf16 at head dim 64 / 128: tensor cores (wgmma) fed by TMA
// ---------------------------------------------------------------------------

constexpr int CONSUMERS = 128;                // one warpgroup: 64 key rows
constexpr int SM90_THREADS = CONSUMERS + 32;  // + one producer warp
constexpr int STAGES = 2;

template <int HD>
struct DkvSmem {  // byte offsets from a 1024-byte-aligned base
  static constexpr int BQ = HD == 64 ? 64 : 32;  // q rows per ring stage
  static constexpr int KV_BYTES = BK * HD * 2;   // HD/64 chunks of BK x 128 B
  static constexpr int Q_BYTES = BQ * HD * 2;
  static constexpr int K = 0;
  static constexpr int V = K + KV_BYTES;
  static constexpr int Q = V + KV_BYTES;                 // + stage * Q_BYTES
  static constexpr int DO = Q + STAGES * Q_BYTES;        // + stage * Q_BYTES
  static constexpr int STATS = DO + STAGES * Q_BYTES;    // [stage][lse, delta][BQ] fp32
  static constexpr int BAR = STATS + STAGES * 2 * BQ * 4;  // kv_full, full[], empty[]
  static constexpr int BYTES = BAR + 8 * (1 + 2 * STAGES);
};

template <int HD>
__global__ void __launch_bounds__(SM90_THREADS)
    bwd_dkv_sm90(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                 BwdParams p) {
  using L = DkvSmem<HD>;
  using namespace sm90;
  constexpr int TQ = L::BQ;
  constexpr int CHUNKS = HD / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  float* stats = reinterpret_cast<float*>(smem + L::STATS);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + STAGES;

  const int kt = blockIdx.x;  // causal: k tile 0 sees every q tile, so first
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int group = p.N / p.NKV;
  const int k0 = kt * BK;
  const int S = p.S;
  const int n_qt = (S + TQ - 1) / TQ;
  // first q tile whose last row reaches k0 (the Pallas kernel's
  // qb * block_q + block_q - 1 >= kj * block_k)
  const int qt0 = p.causal ? k0 / TQ : 0;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 32);  // every producer lane: its LSE/delta stores
      mbar_init(&empty[s], CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {  // producer warp
    const int lane = threadIdx.x - CONSUMERS;
    if (lane == 0) {
      mbar_arrive_expect_tx(kv_full, 2 * L::KV_BYTES);
      for (int c = 0; c < CHUNKS; ++c) {
        tma_load_4d(smem + L::K + c * BK * 128, &tk, kv_full, c * 64, kvh, k0, b);
        tma_load_4d(smem + L::V + c * BK * 128, &tv, kv_full, c * 64, kvh, k0, b);
      }
    }
    int stage = 0;
    uint32_t phase = 0;
    for (int g = 0; g < group; ++g) {
      const int h = kvh * group + g;
      const long long stat0 = ((long long)b * p.N + h) * S;
      for (int qt = qt0; qt < n_qt; ++qt) {
        const int q0 = qt * TQ;
        mbar_wait(&empty[stage], phase ^ 1);
        // rows past S read 0: their q and dO rows are zeros, so they
        // contribute dS = 0 and P.dO = 0
        float* st = stats + stage * 2 * TQ;
        for (int r = lane; r < TQ; r += 32) {
          const bool live = q0 + r < S;
          st[r] = live ? p.lse[stat0 + q0 + r] : 0.f;
          st[TQ + r] = live ? p.delta[stat0 + q0 + r] : 0.f;
        }
        if (lane == 0) {
          mbar_arrive_expect_tx(&full[stage], 2 * L::Q_BYTES);
          for (int c = 0; c < CHUNKS; ++c) {
            tma_load_4d(smem + L::Q + stage * L::Q_BYTES + c * TQ * 128, &tq, &full[stage],
                        c * 64, h, q0, b);
            tma_load_4d(smem + L::DO + stage * L::Q_BYTES + c * TQ * 128, &tdo, &full[stage],
                        c * 64, h, q0, b);
          }
        } else {
          mbar_arrive(&full[stage]);
        }
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // consumer warpgroup: key rows kr0 and kr0 + 8 of the tile, query
  // columns 8j + 2c of each q tile
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int c2 = 2 * (lane % 4);
  const int kr0 = k0 + 16 * warp + lane / 4;
  const int kr1 = kr0 + 8;
  const uint32_t k_addr = smem_addr(smem + L::K);
  const uint32_t v_addr = smem_addr(smem + L::V);

  float dk[HD / 2], dv[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dk[i] = dv[i] = 0.f;

  mbar_wait(kv_full, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (int g = 0; g < group; ++g) {
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int q0 = qt * TQ;
      mbar_wait(&full[stage], phase);
      const uint32_t q_addr = smem_addr(smem + L::Q + stage * L::Q_BYTES);
      const uint32_t do_addr = smem_addr(smem + L::DO + stage * L::Q_BYTES);
      const float* lse_s = stats + stage * 2 * TQ;
      const float* delta_s = lse_s + TQ;

      // S^T = K.Q^T and dP^T = V.dO^T: k steps of 16 along the head dim
      float st[TQ / 2], dpt[TQ / 2];
#pragma unroll
      for (int i = 0; i < TQ / 2; ++i) st[i] = dpt[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < HD / 16; ++ks) {
        const uint32_t off = (ks % 4) * 32;  // within a 128-byte swizzled row
        wgmma_ss(st, desc_sw128(k_addr + (ks / 4) * BK * 128 + off, 16),
                 desc_sw128(q_addr + (ks / 4) * TQ * 128 + off, 16), ks > 0);
      }
#pragma unroll
      for (int ks = 0; ks < HD / 16; ++ks) {
        const uint32_t off = (ks % 4) * 32;
        wgmma_ss(dpt, desc_sw128(v_addr + (ks / 4) * BK * 128 + off, 16),
                 desc_sw128(do_addr + (ks / 4) * TQ * 128 + off, 16), ks > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(st);
      fence_regs(dpt);

      // P^T and dS^T in place, masked where key > query or key >= S
#pragma unroll
      for (int j = 0; j < TQ / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qi = 8 * j + c2 + e;
          const int qc = q0 + qi;
          const float lse = lse_s[qi];
          const float delta = delta_s[qi];
          float x0 = st[4 * j + e] * p.scale;
          float x1 = st[4 * j + 2 + e] * p.scale;
          if (kr0 >= S || (p.causal && kr0 > qc)) x0 = NEG_INF;
          if (kr1 >= S || (p.causal && kr1 > qc)) x1 = NEG_INF;
          const float p0 = expf(x0 - lse);
          const float p1 = expf(x1 - lse);
          st[4 * j + e] = p0;
          st[4 * j + 2 + e] = p1;
          dpt[4 * j + e] = p0 * (dpt[4 * j + e] - delta) * p.scale;
          dpt[4 * j + 2 + e] = p1 * (dpt[4 * j + 2 + e] - delta) * p.scale;
        }
      }

      // dV += P^T.dO and dK += dS^T.Q, each as hi + lo; dO and Q MN-major
      // (head dim contiguous), a k16 step is 16 query rows
      uint32_t ph[TQ / 4], pl[TQ / 4], sh[TQ / 4], sl[TQ / 4];
      split_acc(st, ph, pl);
      split_acc(dpt, sh, sl);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TQ / 16; ++kk) {
        const uint64_t ddo = desc_sw128(do_addr + kk * 16 * 128, TQ * 128);
        const uint64_t dq = desc_sw128(q_addr + kk * 16 * 128, TQ * 128);
        wgmma_rs(dv, ph[4 * kk], ph[4 * kk + 1], ph[4 * kk + 2], ph[4 * kk + 3], ddo);
        wgmma_rs(dv, pl[4 * kk], pl[4 * kk + 1], pl[4 * kk + 2], pl[4 * kk + 3], ddo);
        wgmma_rs(dk, sh[4 * kk], sh[4 * kk + 1], sh[4 * kk + 2], sh[4 * kk + 3], dq);
        wgmma_rs(dk, sl[4 * kk], sl[4 * kk + 1], sl[4 * kk + 2], sl[4 * kk + 3], dq);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dk);
      fence_regs(dv);
      fence_regs(ph);
      fence_regs(pl);
      fence_regs(sh);
      fence_regs(sl);
      mbar_arrive(&empty[stage]);
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
  }

  __nv_bfloat16* dkp = static_cast<__nv_bfloat16*>(p.dk) + b * p.dks[0] + kvh * p.dks[2];
  __nv_bfloat16* dvp = static_cast<__nv_bfloat16*>(p.dv) + b * p.dvs[0] + kvh * p.dvs[2];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    const int col = 8 * j + c2;
    if (kr0 < S) {
      *reinterpret_cast<__nv_bfloat162*>(dkp + (long long)kr0 * p.dks[1] + col) =
          __floats2bfloat162_rn(dk[4 * j], dk[4 * j + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dvp + (long long)kr0 * p.dvs[1] + col) =
          __floats2bfloat162_rn(dv[4 * j], dv[4 * j + 1]);
    }
    if (kr1 < S) {
      *reinterpret_cast<__nv_bfloat162*>(dkp + (long long)kr1 * p.dks[1] + col) =
          __floats2bfloat162_rn(dk[4 * j + 2], dk[4 * j + 3]);
      *reinterpret_cast<__nv_bfloat162*>(dvp + (long long)kr1 * p.dvs[1] + col) =
          __floats2bfloat162_rn(dv[4 * j + 2], dv[4 * j + 3]);
    }
  }
}

template <int HD>
cudaError_t launch_dkv_sm90(const BwdParams& p, int B, cudaStream_t stream) {
  using L = DkvSmem<HD>;
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err = sm90::encode_bshd(&tq, p.q, B, p.S, p.N, HD, p.qs, L::BQ);
  if (err == cudaSuccess) err = sm90::encode_bshd(&tdo, p.dout, B, p.S, p.N, HD, p.dos, L::BQ);
  if (err == cudaSuccess) err = sm90::encode_bshd(&tk, p.k, B, p.S, p.NKV, HD, p.ks, BK);
  if (err == cudaSuccess) err = sm90::encode_bshd(&tv, p.v, B, p.S, p.NKV, HD, p.vs, BK);
  if (err != cudaSuccess) return err;
  const int smem = L::BYTES + 1024;  // + alignment slack
  err = cudaFuncSetAttribute(bwd_dkv_sm90<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.S + BK - 1) / BK, p.NKV, B);
  bwd_dkv_sm90<HD><<<grid, SM90_THREADS, smem, stream>>>(tq, tk, tv, tdo, p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// dQ in bf16 at head dim 64 / 128: tensor cores (wgmma) fed by TMA
// ---------------------------------------------------------------------------

template <int HD>
struct DqSmem {  // byte offsets from a 1024-byte-aligned base
  static constexpr int STAGES = HD == 64 ? 3 : 2;
  static constexpr int Q_BYTES = BQ * HD * 2;   // HD/64 chunks of BQ x 128 B
  static constexpr int KV_BYTES = BK * HD * 2;  // one K or V tile
  static constexpr int Q = 0;
  static constexpr int DO = Q + Q_BYTES;
  static constexpr int STATS = DO + Q_BYTES;            // [lse, delta][BQ] fp32
  static constexpr int K = STATS + 1024;                // + stage * KV_BYTES
  static constexpr int V = K + STAGES * KV_BYTES;       // + stage * KV_BYTES
  static constexpr int BAR = V + STAGES * KV_BYTES;     // q_full, full[], empty[]
  static constexpr int BYTES = BAR + 8 * (1 + 2 * STAGES);
  static_assert(2 * BQ * 4 <= 1024, "stats fit their slot");
};

template <int HD>
__global__ void __launch_bounds__(SM90_THREADS)
    bwd_dq_sm90(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                BwdParams p) {
  using L = DqSmem<HD>;
  using namespace sm90;
  constexpr int CHUNKS = HD / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  float* stats = reinterpret_cast<float*>(smem + L::STATS);
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
    mbar_init(q_full, 32);  // every producer lane: its LSE/delta stores
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {  // producer warp
    const int lane = threadIdx.x - CONSUMERS;
    // the tile's LSE and delta, by row; rows past S read 0 (their q and dO
    // rows are zeros and they are never written)
    const long long stat0 = ((long long)b * p.N + h) * S;
    for (int r = lane; r < BQ; r += 32) {
      const bool live = q0 + r < S;
      stats[r] = live ? p.lse[stat0 + q0 + r] : 0.f;
      stats[BQ + r] = live ? p.delta[stat0 + q0 + r] : 0.f;
    }
    if (lane != 0) {
      mbar_arrive(q_full);
      return;
    }
    mbar_arrive_expect_tx(q_full, 2 * L::Q_BYTES);
    for (int c = 0; c < CHUNKS; ++c) {
      tma_load_4d(smem + L::Q + c * BQ * 128, &tq, q_full, c * 64, h, q0, b);
      tma_load_4d(smem + L::DO + c * BQ * 128, &tdo, q_full, c * 64, h, q0, b);
    }
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
    return;
  }

  // consumer warpgroup: rows r0 and r0 + 8 of the q tile, key columns
  // 8j + 2c of each k tile
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int c2 = 2 * (lane % 4);
  const int r0 = q0 + 16 * warp + lane / 4;
  const int r1 = r0 + 8;
  const uint32_t q_addr = smem_addr(smem + L::Q);
  const uint32_t do_addr = smem_addr(smem + L::DO);

  float dq[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) dq[i] = 0.f;

  mbar_wait(q_full, 0);
  // LSE and delta are per query row (A3 reads them per column)
  const float lse0 = stats[r0 - q0], lse1 = stats[r1 - q0];
  const float delta0 = stats[BQ + r0 - q0], delta1 = stats[BQ + r1 - q0];
  int stage = 0;
  uint32_t phase = 0;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    mbar_wait(&full[stage], phase);
    const uint32_t k_addr = smem_addr(smem + L::K + stage * L::KV_BYTES);
    const uint32_t v_addr = smem_addr(smem + L::V + stage * L::KV_BYTES);

    // S = Q.K^T and dP = dO.V^T: k steps of 16 along the head dim
    float s[BK / 2], dp[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = dp[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
      const uint32_t off = (ks % 4) * 32;  // within a 128-byte swizzled row
      wgmma_ss(s, desc_sw128(q_addr + (ks / 4) * BQ * 128 + off, 16),
               desc_sw128(k_addr + (ks / 4) * BK * 128 + off, 16), ks > 0);
    }
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
      const uint32_t off = (ks % 4) * 32;
      wgmma_ss(dp, desc_sw128(do_addr + (ks / 4) * BQ * 128 + off, 16),
               desc_sw128(v_addr + (ks / 4) * BK * 128 + off, 16), ks > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);
    fence_regs(dp);

    // P and dS in place of dP, masked where key > query or key >= S (the
    // columns past S come in as zeros, but delta is not zero there)
    const bool edge = k0 + BK > S || (p.causal && k0 + BK - 1 > q0);
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
        const float p0 = expf(x0 - lse0);
        const float p1 = expf(x1 - lse1);
        dp[4 * j + e] = p0 * (dp[4 * j + e] - delta0) * p.scale;
        dp[4 * j + 2 + e] = p1 * (dp[4 * j + 2 + e] - delta1) * p.scale;
      }
    }

    // dQ += dS.K as hi + lo; K is MN-major (head dim contiguous), a k16
    // step is 16 key rows
    uint32_t sh[BK / 4], sl[BK / 4];
    split_acc(dp, sh, sl);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t dk = desc_sw128(k_addr + kk * 16 * 128, BK * 128);
      wgmma_rs(dq, sh[4 * kk], sh[4 * kk + 1], sh[4 * kk + 2], sh[4 * kk + 3], dk);
      wgmma_rs(dq, sl[4 * kk], sl[4 * kk + 1], sl[4 * kk + 2], sl[4 * kk + 3], dk);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(dq);
    fence_regs(sh);
    fence_regs(sl);
    mbar_arrive(&empty[stage]);
    if (++stage == L::STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }

  __nv_bfloat16* dqp = static_cast<__nv_bfloat16*>(p.dq) + b * p.dqs[0] + h * p.dqs[2];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    const int col = 8 * j + c2;
    if (r0 < S)
      *reinterpret_cast<__nv_bfloat162*>(dqp + (long long)r0 * p.dqs[1] + col) =
          __floats2bfloat162_rn(dq[4 * j], dq[4 * j + 1]);
    if (r1 < S)
      *reinterpret_cast<__nv_bfloat162*>(dqp + (long long)r1 * p.dqs[1] + col) =
          __floats2bfloat162_rn(dq[4 * j + 2], dq[4 * j + 3]);
  }
}

template <int HD>
cudaError_t launch_dq_sm90(const BwdParams& p, int B, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err = sm90::encode_bshd(&tq, p.q, B, p.S, p.N, HD, p.qs, BQ);
  if (err == cudaSuccess) err = sm90::encode_bshd(&tdo, p.dout, B, p.S, p.N, HD, p.dos, BQ);
  if (err == cudaSuccess) err = sm90::encode_bshd(&tk, p.k, B, p.S, p.NKV, HD, p.ks, BK);
  if (err == cudaSuccess) err = sm90::encode_bshd(&tv, p.v, B, p.S, p.NKV, HD, p.vs, BK);
  if (err != cudaSuccess) return err;
  const int smem = DqSmem<HD>::BYTES + 1024;  // + alignment slack
  err = cudaFuncSetAttribute(bwd_dq_sm90<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  dim3 grid((p.S + BQ - 1) / BQ, p.N, B);
  bwd_dq_sm90<HD><<<grid, SM90_THREADS, smem, stream>>>(tq, tk, tv, tdo, p);
  return cudaGetLastError();
}

// Which body serves dQ and dK/dV at (dtype, head dim): the dispatch and the
// queries kt_flash_bwd_dq_body / kt_flash_bwd_dkv_body read this one
// predicate.
bool takes_sm90(int dtype, int HD) { return dtype == 1 && (HD == 64 || HD == 128); }

cudaError_t dispatch_dq(const BwdParams& p, int dtype, int B, int HD, cudaStream_t st) {
  if (takes_sm90(dtype, HD))
    return HD == 64 ? launch_dq_sm90<64>(p, B, st) : launch_dq_sm90<128>(p, B, st);
  switch (dtype * 1000 + HD) {
    case 1032: return launch_dq<__nv_bfloat16, 32>(p, B, st);
    case 1016: return launch_dq<__nv_bfloat16, 16>(p, B, st);
    case 128: return launch_dq<float, 128>(p, B, st);
    case 64: return launch_dq<float, 64>(p, B, st);
    case 32: return launch_dq<float, 32>(p, B, st);
    case 16: return launch_dq<float, 16>(p, B, st);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch_dkv(const BwdParams& p, int dtype, int B, int HD, cudaStream_t st) {
  if (takes_sm90(dtype, HD))
    return HD == 64 ? launch_dkv_sm90<64>(p, B, st) : launch_dkv_sm90<128>(p, B, st);
  switch (dtype * 1000 + HD) {
    case 1032: return launch_dkv<__nv_bfloat16, 32>(p, B, st);
    case 1016: return launch_dkv<__nv_bfloat16, 16>(p, B, st);
    case 128: return launch_dkv<float, 128>(p, B, st);
    case 64: return launch_dkv<float, 64>(p, B, st);
    case 32: return launch_dkv<float, 32>(p, B, st);
    case 16: return launch_dkv<float, 16>(p, B, st);
    default: return cudaErrorInvalidValue;
  }
}

BwdParams make_params(const void* q, const void* k, const void* v, const void* dout,
                      const float* lse, const float* delta, int S, int N, int NKV,
                      const long long* strides, float scale, int causal) {
  BwdParams p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = lse;
  p.delta = delta;
  p.S = S;
  p.N = N;
  p.NKV = NKV;
  for (int i = 0; i < 3; ++i) {
    p.qs[i] = strides[i];
    p.ks[i] = strides[3 + i];
    p.vs[i] = strides[6 + i];
    p.dos[i] = strides[9 + i];
  }
  p.scale = scale;
  p.causal = causal;
  return p;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. strides: q, k, v, dout, dq element
// strides of (b, s, head), 15 values. Head dim 16, 32, 64 or 128. lse and
// delta: fp32 (B, N, S) contiguous.
extern "C" int kt_flash_bwd_dq(const void* q, const void* k, const void* v,
                               const void* dout, const float* lse, const float* delta,
                               void* dq, int dtype, int B, int S, int N, int NKV, int HD,
                               const long long* strides, float scale, int causal,
                               void* stream) {
  BwdParams p = make_params(q, k, v, dout, lse, delta, S, N, NKV, strides, scale, causal);
  p.dq = dq;
  for (int i = 0; i < 3; ++i) p.dqs[i] = strides[12 + i];
  if (B <= 0 || S <= 0) return cudaSuccess;
  return dispatch_dq(p, dtype, B, HD, static_cast<cudaStream_t>(stream));
}

// As kt_flash_bwd_dq; strides: q, k, v, dout, dk, dv, 18 values.
extern "C" int kt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                const void* dout, const float* lse, const float* delta,
                                void* dk, void* dv, int dtype, int B, int S, int N,
                                int NKV, int HD, const long long* strides, float scale,
                                int causal, void* stream) {
  BwdParams p = make_params(q, k, v, dout, lse, delta, S, N, NKV, strides, scale, causal);
  p.dk = dk;
  p.dv = dv;
  for (int i = 0; i < 3; ++i) {
    p.dks[i] = strides[12 + i];
    p.dvs[i] = strides[15 + i];
  }
  if (B <= 0 || S <= 0) return cudaSuccess;
  return dispatch_dkv(p, dtype, B, HD, static_cast<cudaStream_t>(stream));
}

// 1 if dQ at (dtype, head dim) runs on the tensor-core body, 0 if on the
// fp32-FMA body.
extern "C" int kt_flash_bwd_dq_body(int dtype, int HD) { return takes_sm90(dtype, HD) ? 1 : 0; }

// 1 if dK/dV at (dtype, head dim) runs on the tensor-core body, 0 if on the
// fp32-FMA body.
extern "C" int kt_flash_bwd_dkv_body(int dtype, int HD) { return takes_sm90(dtype, HD) ? 1 : 0; }
