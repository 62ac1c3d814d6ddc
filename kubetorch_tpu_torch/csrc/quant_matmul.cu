// Fused int4 matmul for Hopper (sm_90a): out = x @ W, W int4 in the
// half-split nibble pack, fp32 out.
//
// Replaces the Pallas TPU kernel kubetorch_tpu/ops/quant_matmul.py:_kernel
// (launched by _q4_matmul, public q4_matmul). Same function: x (M, K) in
// bf16; packed (K/2, N) int8, byte row r holding weight row r in its low
// nibble and row r + K/2 in its high nibble; scale (G, N) fp32, one scale
// per group of g = K/G rows and column. For each group t < G/2, the lo
// plane's rows [t*g, (t+1)*g) meet x[:, t*g : (t+1)*g] and the hi plane's
// meet x[:, K/2 + t*g : ...]; each product accumulates in fp32 over the
// group, is multiplied by its scale row (t for lo, G/2 + t for hi), and
// the sum of the two is added to the output, groups in order. The nibbles
// are p = int32(byte), lo = (p << 28) >> 28, hi = (p << 24) >> 28,
// arithmetic shifts, so the values come out sign-extended in [-8, 7] and
// are exact in bf16. This is the Pallas body's
// jnp.dot(bf16, bf16, preferred_element_type=f32) * s, so the tensor cores
// (mma.sync m16n8k16 bf16, fp32 accumulate) compute it without any change
// of numerics.
//
// What bounds it on the H100: at decode (M = 8 rows) bytes — the packed
// weight (K/2 * N) and its scales are read once and each byte feeds only
// 2 * M * 2 flops, so the least time is the weight stream over 3.35 TB/s;
// at a prefill of 2048 rows operations (2 * M * K * N over the bf16 tensor
// rate). What the design does about it: the packed tile is the only
// weight stream (half of int8's bytes), loaded with 16-byte cp.async into
// a ring of shared-memory stages so that several chunks are in flight
// while one is unpacked and multiplied; each chunk of 64 packed rows is
// unpacked once into two bf16 tiles in shared memory (one per nibble
// plane) and read by every warp with ldmatrix. One block per (M tile,
// N tile) loops over the groups, which takes the place of the Pallas
// kernel's sequential K axis; a fresh fragment per group and plane is
// scaled by that group's scale row before it joins the accumulator. M is
// tiled, so a 2048-row prefill and 8 decode rows go through the same
// kernel (two tile shapes: 16 x 32 for M <= 16, 64 x 64 above); ragged M
// and N edges are masked (N must be a multiple of 16). Later work: wgmma
// and TMA for the prefill shapes, and split-K for decode, where N / 32
// tiles of a 1024- or 4096-wide projection leave many of the 132 SMs
// idle.
//
// C interface, launched on the caller's stream; returns the cudaError_t
// of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <int BM_, int BN_, int KC_, int STAGES_, int WM_, int WN_>
struct Tile {
  static constexpr int BM = BM_;          // rows of x per block
  static constexpr int BN = BN_;          // output columns per block
  static constexpr int KC = KC_;          // packed rows per pipeline stage
  static constexpr int STAGES = STAGES_;  // cp.async ring depth
  static constexpr int WM = WM_;          // warps along M
  static constexpr int WN = WN_;          // warps along N
  static constexpr int THREADS = 32 * WM * WN;
  static constexpr int MI = BM / WM / 16;  // m16 tiles per warp
  static constexpr int NI = BN / WN / 8;   // n8 tiles per warp
  static constexpr int XS = KC + 8;        // x tile row stride (bf16): no bank conflicts
  static constexpr int WS = BN + 8;        // unpacked weight row stride (bf16)
  static constexpr int P_BYTES = KC * BN;  // packed int8 tile
  static constexpr int X_BYTES = BM * XS * 2;
  static constexpr int STAGE_BYTES = P_BYTES + 2 * X_BYTES;  // packed + x lo + x hi
  static constexpr int W_BYTES = KC * WS * 2;
  static constexpr int SMEM = STAGES * STAGE_BYTES + 2 * W_BYTES;
  static_assert(MI >= 1 && NI >= 1 && KC % 16 == 0 && BN % 16 == 0, "tile");
  static_assert(P_BYTES % 16 == 0 && X_BYTES % 16 == 0 && W_BYTES % 16 == 0,
                "16-byte aligned stage parts");
};

using SmallM = Tile<16, 32, 64, 6, 1, 4>;   // decode: M <= 16
using LargeM = Tile<64, 64, 64, 3, 2, 2>;   // prefill

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; a false predicate writes 16 zero bytes and reads none
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

template <class C>
__global__ void __launch_bounds__(C::THREADS)
    q4_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ packed,
              const float* __restrict__ scale, float* __restrict__ out, int M, int N,
              int K, int G) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int half = K / 2;
  const int hg = G / 2;                   // groups per plane
  const int group = half / hg;            // rows per group
  const int chunks_per_group = group / C::KC;
  const int n_chunks = half / C::KC;
  const int m0 = blockIdx.y * C::BM;
  const int n0 = blockIdx.x * C::BN;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp / C::WN;
  const int wn = warp % C::WN;
  const int gid = lane >> 2;   // mma fragment row / column group
  const int tig = lane & 3;    // thread in group

  __nv_bfloat16* Wlo = reinterpret_cast<__nv_bfloat16*>(smem + C::STAGES * C::STAGE_BYTES);
  __nv_bfloat16* Whi = Wlo + C::KC * C::WS;

  // stage s: packed (KC, BN) int8, then x lo and x hi (BM, XS) bf16
  auto load_chunk = [&](int c, int s) {
    unsigned char* base = smem + s * C::STAGE_BYTES;
    int8_t* P = reinterpret_cast<int8_t*>(base);
    __nv_bfloat16* Xl = reinterpret_cast<__nv_bfloat16*>(base + C::P_BYTES);
    __nv_bfloat16* Xh = reinterpret_cast<__nv_bfloat16*>(base + C::P_BYTES + C::X_BYTES);
    const int k0 = c * C::KC;   // packed row = column of x within a plane
    constexpr int PSEG = C::BN / 16;
    for (int i = tid; i < C::KC * PSEG; i += C::THREADS) {
      const int r = i / PSEG;
      const int col = (i % PSEG) * 16;
      const bool ok = n0 + col < N;
      cp_async16(P + r * C::BN + col,
                 packed + (long long)(k0 + r) * N + (ok ? n0 + col : 0), ok);
    }
    constexpr int XSEG = C::KC / 8;
    for (int i = tid; i < C::BM * XSEG; i += C::THREADS) {
      const int r = i / XSEG;
      const int col = (i % XSEG) * 8;
      const bool ok = m0 + r < M;
      const __nv_bfloat16* src = x + (long long)(ok ? m0 + r : 0) * K + k0 + col;
      cp_async16(Xl + r * C::XS + col, src, ok);
      cp_async16(Xh + r * C::XS + col, src + half, ok);
    }
  };

  float acc[C::MI][C::NI][4];
  float plo[C::MI][C::NI][4];
  float phi[C::MI][C::NI][4];
#pragma unroll
  for (int mi = 0; mi < C::MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < C::NI; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = plo[mi][ni][e] = phi[mi][ni][e] = 0.f;

#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) {
    if (s < n_chunks) load_chunk(s, s);
    cp_async_commit();
  }

  const int wrow = wm * (C::MI * 16);   // this warp's first row in the tile
  const int wcol = wn * (C::NI * 8);    // and first column

  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<C::STAGES - 2>();
    __syncthreads();   // chunk c landed; chunk c-1's tiles are no longer read
    if (c + C::STAGES - 1 < n_chunks)
      load_chunk(c + C::STAGES - 1, (c + C::STAGES - 1) % C::STAGES);
    cp_async_commit();

    unsigned char* base = smem + (c % C::STAGES) * C::STAGE_BYTES;
    const int8_t* P = reinterpret_cast<const int8_t*>(base);
    const __nv_bfloat16* Xl = reinterpret_cast<const __nv_bfloat16*>(base + C::P_BYTES);
    const __nv_bfloat16* Xh =
        reinterpret_cast<const __nv_bfloat16*>(base + C::P_BYTES + C::X_BYTES);

    // unpack both nibble planes into bf16 tiles, row-major (k, n)
    constexpr int QUADS = C::BN / 4;
    for (int i = tid; i < C::KC * QUADS; i += C::THREADS) {
      const int r = i / QUADS;
      const int nq = (i % QUADS) * 4;
      const uint32_t w = *reinterpret_cast<const uint32_t*>(P + r * C::BN + nq);
      __align__(8) __nv_bfloat16 lo[4];
      __align__(8) __nv_bfloat16 hi[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t byte = (w >> (8 * j)) & 0xFFu;
        lo[j] = __int2bfloat16_rn(static_cast<int32_t>(byte << 28) >> 28);
        hi[j] = __int2bfloat16_rn(static_cast<int32_t>(byte << 24) >> 28);
      }
      *reinterpret_cast<uint2*>(Wlo + r * C::WS + nq) = *reinterpret_cast<const uint2*>(lo);
      *reinterpret_cast<uint2*>(Whi + r * C::WS + nq) = *reinterpret_cast<const uint2*>(hi);
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < C::KC; kk += 16) {
      uint32_t alo[C::MI][4], ahi[C::MI][4];
#pragma unroll
      for (int mi = 0; mi < C::MI; ++mi) {
        const int off = (wrow + mi * 16 + (lane & 15)) * C::XS + kk + (lane >> 4) * 8;
        ldsm_x4(alo[mi], Xl + off);
        ldsm_x4(ahi[mi], Xh + off);
      }
#pragma unroll
      for (int ni = 0; ni < C::NI; ++ni) {
        uint32_t blo[2], bhi[2];
        const int off = (kk + (lane & 15)) * C::WS + wcol + ni * 8;
        ldsm_x2_trans(blo, Wlo + off);
        ldsm_x2_trans(bhi, Whi + off);
#pragma unroll
        for (int mi = 0; mi < C::MI; ++mi) {
          mma_bf16(plo[mi][ni], alo[mi], blo);
          mma_bf16(phi[mi][ni], ahi[mi], bhi);
        }
      }
    }

    // the group is complete: scale each plane's product by its own scale
    // row and add the two to the accumulator; the next group starts fresh
    if ((c + 1) % chunks_per_group == 0) {
      const int t = c / chunks_per_group;
#pragma unroll
      for (int ni = 0; ni < C::NI; ++ni) {
        const int n = n0 + wcol + ni * 8 + tig * 2;
        float2 sl = make_float2(0.f, 0.f), sh = make_float2(0.f, 0.f);
        if (n < N) {
          sl = *reinterpret_cast<const float2*>(scale + (long long)t * N + n);
          sh = *reinterpret_cast<const float2*>(scale + (long long)(hg + t) * N + n);
        }
#pragma unroll
        for (int mi = 0; mi < C::MI; ++mi) {
          float* a = acc[mi][ni];
          float* l = plo[mi][ni];
          float* h = phi[mi][ni];
          a[0] += l[0] * sl.x + h[0] * sh.x;
          a[1] += l[1] * sl.y + h[1] * sh.y;
          a[2] += l[2] * sl.x + h[2] * sh.x;
          a[3] += l[3] * sl.y + h[3] * sh.y;
#pragma unroll
          for (int e = 0; e < 4; ++e) l[e] = h[e] = 0.f;
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mi = 0; mi < C::MI; ++mi) {
#pragma unroll
    for (int ni = 0; ni < C::NI; ++ni) {
      const int n = n0 + wcol + ni * 8 + tig * 2;
      const int row = m0 + wrow + mi * 16 + gid;
      if (n >= N) continue;
      if (row < M)
        *reinterpret_cast<float2*>(out + (long long)row * N + n) =
            make_float2(acc[mi][ni][0], acc[mi][ni][1]);
      if (row + 8 < M)
        *reinterpret_cast<float2*>(out + (long long)(row + 8) * N + n) =
            make_float2(acc[mi][ni][2], acc[mi][ni][3]);
    }
  }
}

template <class C>
cudaError_t launch(const void* x, const void* packed, const void* scale, void* out, int M,
                   int N, int K, int G, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      q4_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid((N + C::BN - 1) / C::BN, (M + C::BM - 1) / C::BM);
  q4_kernel<C><<<grid, C::THREADS, C::SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(packed),
      static_cast<const float*>(scale), static_cast<float*>(out), M, N, K, G);
  return cudaGetLastError();
}

}  // namespace

// x (M, K) bf16, packed (K/2, N) int8, scale (G, N) fp32, out (M, N) fp32,
// all contiguous and 16-byte aligned. The group K / G must be a multiple of
// 64 and N a multiple of 16.
extern "C" int kt_q4_matmul(const void* x, const void* packed, const void* scale,
                            void* out, int M, int N, int K, int G, void* stream) {
  if (M <= 0 || N <= 0) return cudaSuccess;
  if (K <= 0 || K % 2 || G < 2 || G % 2 || (K / 2) % (G / 2) ||
      ((K / 2) / (G / 2)) % 64 || N % 16)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 16) return launch<SmallM>(x, packed, scale, out, M, N, K, G, st);
  return launch<LargeM>(x, packed, scale, out, M, N, K, G, st);
}
