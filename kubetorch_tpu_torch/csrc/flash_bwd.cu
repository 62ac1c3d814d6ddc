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
// masked with -1e30 before exp, as in the forward. Numerics follow the
// Pallas bodies: q, k, v and dO widen to fp32, every product runs in fp32,
// each output rounds to its input's type once.
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
// operations bound it at every training shape. This first version runs
// plain fp32 FMAs on CUDA cores (67 TFLOP/s peak), like the forward, to
// keep the reference's fp32 products; it does not reach the bf16 tensor
// core bound. What the design does about it: 64x64 tiles, each thread a 4x4
// block of logits and dP and a 4 x (Hd/16) block of each accumulator in
// registers; all tile rows padded by one 32-bit word in shared memory so
// the column-strided reads of the logit loops hit distinct banks; heaviest
// causal tiles scheduled first. wgmma/TMA are later work.
//
// Layout: q/dO/dQ (B, S, N, Hd), k/v/dK/dV (B, S, NKV, Hd), read and
// written in place through their strides; lse and delta fp32 (B, N, S),
// contiguous. C interface, launched on the caller's stream; each entry
// returns the cudaError_t of its launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

template <bool DQ>
cudaError_t dispatch(const BwdParams& p, int dtype, int B, int HD, cudaStream_t st) {
  switch (dtype * 1000 + HD) {
    case 1128: return DQ ? launch_dq<__nv_bfloat16, 128>(p, B, st) : launch_dkv<__nv_bfloat16, 128>(p, B, st);
    case 1064: return DQ ? launch_dq<__nv_bfloat16, 64>(p, B, st) : launch_dkv<__nv_bfloat16, 64>(p, B, st);
    case 1032: return DQ ? launch_dq<__nv_bfloat16, 32>(p, B, st) : launch_dkv<__nv_bfloat16, 32>(p, B, st);
    case 1016: return DQ ? launch_dq<__nv_bfloat16, 16>(p, B, st) : launch_dkv<__nv_bfloat16, 16>(p, B, st);
    case 128: return DQ ? launch_dq<float, 128>(p, B, st) : launch_dkv<float, 128>(p, B, st);
    case 64: return DQ ? launch_dq<float, 64>(p, B, st) : launch_dkv<float, 64>(p, B, st);
    case 32: return DQ ? launch_dq<float, 32>(p, B, st) : launch_dkv<float, 32>(p, B, st);
    case 16: return DQ ? launch_dq<float, 16>(p, B, st) : launch_dkv<float, 16>(p, B, st);
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
  return dispatch<true>(p, dtype, B, HD, static_cast<cudaStream_t>(stream));
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
  return dispatch<false>(p, dtype, B, HD, static_cast<cudaStream_t>(stream));
}
