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
// are p = int32(byte), lo = (p << 28) >> 28, hi = (p << 24) >> 28, so the
// values are sign-extended in [-8, 7] and exact in bf16. This is the Pallas
// body's jnp.dot(bf16, bf16, preferred_element_type=f32) * s, so the tensor
// cores (bf16 x bf16, fp32 accumulate) compute it without any change of
// numerics. A nibble becomes bf16 without a conversion instruction: the
// bf16 bits 0x4300 | u are 128 + u for u < 16, and a sign-extended nibble
// is (nib ^ 8) - 8, so bf16(0x4300 | (nib ^ 8)) - 136 is it exactly.
//
// Two bodies, chosen by M alone (kt_q4_matmul_body):
//
// M <= 16 (decode): q4_splitk, bound by bytes — the packed weight is read
// once and each byte feeds 2 * M * 2 flops. The K axis is split across
// blocks (the wrapper picks the number of splits, each a run of whole
// groups, so that the grid covers the 132 SMs a few times); the splits'
// fp32 partials go to an (splits, M, N) buffer and q4_combine adds them in
// split order, so the result is deterministic (no atomics). Inside a block
// each warp owns 32 output columns and computes out^T = W^T . x^T with
// mma.sync m16n8k16: the weight columns fill the 16-row side (two m16
// tiles), the rows of x the n8 side, so no half of the tile is empty. The
// packed weight goes from global memory straight into registers, 32-bit
// words of 4 columns, and is unpacked in registers into the A fragments:
// the k order inside a k16 step is permuted (logical k 2c, 2c+1, 2c+8,
// 2c+9 are packed rows 4c .. 4c+3, for A and for x alike), so one thread's
// words are exactly its fragments. The next 64-row chunk's words and x
// values are loaded while the current one is multiplied; no shared memory,
// no barrier. A fresh fragment per group and plane is scaled by that
// group's scale row before it joins the accumulator.
//
// M > 16 (prefill): q4_wgmma, bound by operations at 2048 rows. Blocks of
// 128 rows of x x 128 output columns: two consumer warpgroups and one
// producer lane. The producer streams, per step of 64 packed rows of one
// group and one plane (the group's lo chunks, then its hi chunks), the x
// tile, the packed tile (both with 128-byte swizzle; rows of x past M read
// as zeros) and the plane's scale row, all by TMA, through a ring of 4
// stages. Each consumer warpgroup computes out^T = W^T . x^T for 64 output
// columns and all 128 rows: the weight is wgmma's register-A operand,
// unpacked by each thread straight from the packed tile into its
// fragments (two adjacent columns, so each k row is one 16-bit load), and
// x is the B operand read K-major from the tile TMA wrote; no unpacked
// weight goes to shared memory, and the warpgroups never wait for each
// other. A step's fragments are built while the previous step's wgmma
// runs. A group accumulator starts fresh on each group and plane and, at
// the end of the plane's group, out += acc * s. The packed tile is loaded
// twice per group (once per plane; the second read hits L2) so that one
// group accumulator is enough: 128 fp32 registers a thread for it and the
// output. tools/q4_probe.py times the body with parts of it cut out.
//
// C interface, launched on the caller's stream; returns the cudaError_t
// of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

// t holds byte a in bits 0-7 and byte b in bits 16-23 (bits 8-15 and 24-31
// are ignored): bf16x2 (s(a), s(b)) of their low (HI = false) or high
// nibbles, sign-extended.
template <bool HI>
__device__ __forceinline__ uint32_t nibbles_bf16x2(uint32_t t) {
  if (HI) t >>= 4;
  const uint32_t bits = (t & 0x000F000Fu) ^ 0x43084308u;  // 128 + (nib ^ 8)
  const uint32_t k136 = 0x43084308u;                      // bf16x2 (136, 136)
  const __nv_bfloat162 v = __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&bits),
                                   *reinterpret_cast<const __nv_bfloat162*>(&k136));
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ---------------------------------------------------------------------------
// M <= 16: split-K, mma.sync, packed words straight into registers
// ---------------------------------------------------------------------------

constexpr int DEC_WARPS = 4;
constexpr int DEC_BN = 32 * DEC_WARPS;  // output columns per block, 32 per warp
constexpr int CHUNK = 64;               // packed rows per unit (4 k16 steps)

__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// One chunk's operands for one thread: w[4 s + i] is packed row
// 16 s + 4 tig + i of the chunk at the thread's 4 columns (one 32-bit
// word), xv[p][s][nt] x row 8 nt + gid of plane p at the same 4 rows of k
// (4 bf16); rows past M and columns past N read as zeros.
template <int NT>
__device__ __forceinline__ void load_chunk(uint32_t (&w)[16], uint2 (&xv)[2][4][NT],
                                           const __nv_bfloat16* __restrict__ x,
                                           const uint32_t* __restrict__ words, int row_words,
                                           bool live, int M, int K, int chunk, int tig,
                                           int gid) {
  const int r0 = chunk * CHUNK + 4 * tig;
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[4 * s + i] = live ? __ldg(words + (long long)(r0 + 16 * s + i) * row_words) : 0u;
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int row = 8 * nt + gid;
        xv[p][s][nt] = row < M ? __ldg(reinterpret_cast<const uint2*>(
                                     x + (long long)row * K + p * (K / 2) + r0 + 16 * s))
                               : make_uint2(0u, 0u);
      }
}

// NT: n8 tiles of x rows (1 for M <= 8, 2 for M <= 16)
template <int NT>
__global__ void __launch_bounds__(32 * DEC_WARPS)
    q4_splitk(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ packed,
              const float* __restrict__ scale, float* __restrict__ out, int M, int N, int K,
              int G, int splits) {
  const int half = K / 2;
  const int hg = G / 2;            // groups per plane
  const int group = half / hg;     // packed rows per group
  const int cpg = group / CHUNK;   // chunks per group
  const int split = blockIdx.y;
  // this split's groups: [t0, t1) (ops/quant_matmul.py:q4_split_ranges)
  const int t0 = split * hg / splits;
  const int t1 = (split + 1) * hg / splits;
  const int lane = threadIdx.x % 32;
  const int gid = lane >> 2;  // fragment row (weight column) group
  const int tig = lane & 3;   // thread in group: packed rows 4 tig .. 4 tig + 3
  // this thread's 4 output columns: n .. n + 3 (N is a multiple of 16)
  const int n = blockIdx.x * DEC_BN + (threadIdx.x / 32) * 32 + 4 * gid;
  const bool live = n < N;
  const uint32_t* words = reinterpret_cast<const uint32_t*>(packed) + n / 4;
  const int row_words = N / 4;

  uint32_t wc[16], wn[16];
  uint2 xc[2][4][NT], xn[2][4][NT];
  // [mt][nt][e]: C of m16 tile mt (weight columns n + 2 mt, n + 2 mt + 1)
  // and n8 tile nt (x rows 8 nt + 2 tig, + 1)
  float acc[2][NT][4], plo[2][NT][4], phi[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = plo[mt][nt][e] = phi[mt][nt][e] = 0.f;

  const int c_begin = t0 * cpg, c_end = t1 * cpg;
  float4 sl = make_float4(0.f, 0.f, 0.f, 0.f), sh = sl;
  if (c_begin < c_end) load_chunk<NT>(wc, xc, x, words, row_words, live, M, K, c_begin, tig, gid);
  for (int c = c_begin; c < c_end; ++c) {
    if (c + 1 < c_end) load_chunk<NT>(wn, xn, x, words, row_words, live, M, K, c + 1, tig, gid);
    if (c % cpg == 0 && live) {  // the group's scale rows, used at its end
      const int t = c / cpg;
      sl = __ldg(reinterpret_cast<const float4*>(scale + (long long)t * N + n));
      sh = __ldg(reinterpret_cast<const float4*>(scale + (long long)(hg + t) * N + n));
    }
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const uint32_t w0 = wc[4 * s], w1 = wc[4 * s + 1], w2 = wc[4 * s + 2], w3 = wc[4 * s + 3];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        // fragment rows gid and gid + 8 are columns n + 2 mt and n + 2 mt + 1
        const uint32_t j0 = 2 * mt, j1 = 2 * mt + 1;
        const uint32_t t0w = __byte_perm(w0, w1, j0 | ((4 + j0) << 8));
        const uint32_t t1w = __byte_perm(w0, w1, j1 | ((4 + j1) << 8));
        const uint32_t t2w = __byte_perm(w2, w3, j0 | ((4 + j0) << 8));
        const uint32_t t3w = __byte_perm(w2, w3, j1 | ((4 + j1) << 8));
        const uint32_t l0 = nibbles_bf16x2<false>(t0w), l1 = nibbles_bf16x2<false>(t1w);
        const uint32_t l2 = nibbles_bf16x2<false>(t2w), l3 = nibbles_bf16x2<false>(t3w);
        const uint32_t h0 = nibbles_bf16x2<true>(t0w), h1 = nibbles_bf16x2<true>(t1w);
        const uint32_t h2 = nibbles_bf16x2<true>(t2w), h3 = nibbles_bf16x2<true>(t3w);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          mma_bf16(plo[mt][nt], l0, l1, l2, l3, xc[0][s][nt].x, xc[0][s][nt].y);
          mma_bf16(phi[mt][nt], h0, h1, h2, h3, xc[1][s][nt].x, xc[1][s][nt].y);
        }
      }
    }
    if ((c + 1) % cpg == 0) {  // the group is complete: scale each plane
      const float slv[4] = {sl.x, sl.y, sl.z, sl.w}, shv[4] = {sh.x, sh.y, sh.z, sh.w};
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = 2 * mt + e / 2;  // e 0, 1: row gid; 2, 3: row gid + 8
            acc[mt][nt][e] += plo[mt][nt][e] * slv[col] + phi[mt][nt][e] * shv[col];
            plo[mt][nt][e] = phi[mt][nt][e] = 0.f;
          }
    }
#pragma unroll
    for (int i = 0; i < 16; ++i) wc[i] = wn[i];
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int s = 0; s < 4; ++s)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) xc[p][s][nt] = xn[p][s][nt];
  }

  if (!live) return;
  float* dst = out + (long long)split * M * N;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {  // x rows 8 nt + 2 tig + e
      const int row = 8 * nt + 2 * tig + e;
      if (row < M)
        *reinterpret_cast<float4*>(dst + (long long)row * N + n) =
            make_float4(acc[0][nt][e], acc[0][nt][2 + e], acc[1][nt][e], acc[1][nt][2 + e]);
    }
}

// out = the sum of the splits' partials (splits, M, N), in split order
__global__ void q4_combine(const float4* __restrict__ part, float4* __restrict__ out,
                           long long n4, int splits) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  float4 a = part[i];
  for (int s = 1; s < splits; ++s) {
    const float4 b = part[s * n4 + i];
    a.x += b.x;
    a.y += b.y;
    a.z += b.z;
    a.w += b.w;
  }
  out[i] = a;
}

cudaError_t launch_splitk(const void* x, const void* packed, const void* scale, void* out,
                          void* work, int M, int N, int K, int G, int splits,
                          cudaStream_t stream) {
  float* dst = splits > 1 ? static_cast<float*>(work) : static_cast<float*>(out);
  dim3 grid((N + DEC_BN - 1) / DEC_BN, splits);
  auto xs = static_cast<const __nv_bfloat16*>(x);
  auto ps = static_cast<const int8_t*>(packed);
  auto ss = static_cast<const float*>(scale);
  if (M <= 8)
    q4_splitk<1><<<grid, 32 * DEC_WARPS, 0, stream>>>(xs, ps, ss, dst, M, N, K, G, splits);
  else
    q4_splitk<2><<<grid, 32 * DEC_WARPS, 0, stream>>>(xs, ps, ss, dst, M, N, K, G, splits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long long n4 = (long long)M * N / 4;
  q4_combine<<<(unsigned)((n4 + 255) / 256), 256, 0, stream>>>(
      static_cast<const float4*>(work), static_cast<float4*>(out), n4, splits);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// M > 16: wgmma + TMA
// ---------------------------------------------------------------------------

constexpr int PF_BM = 128;  // x rows per block: the wgmma's N
constexpr int PF_BN = 128;  // output columns per block
constexpr int PF_WN = 64;   // output columns per consumer warpgroup: the wgmma's M
constexpr int PF_KC = 64;   // packed rows per step
constexpr int PF_STAGES = 4;
constexpr int PF_CONSUMERS = 256;
constexpr int PF_THREADS = PF_CONSUMERS + 32;  // + one producer warp

struct PfSmem {  // byte offsets from a 1024-byte-aligned base
  static constexpr int X_BYTES = PF_BM * PF_KC * 2;  // 128 rows x 128 B, swizzled
  static constexpr int P_BYTES = PF_KC * PF_BN;      // 64 rows x 128 B, swizzled
  static constexpr int SC_BYTES = PF_BN * 4;
  static constexpr int X = 0;                         // + stage * X_BYTES
  static constexpr int P = X + PF_STAGES * X_BYTES;   // + stage * P_BYTES
  static constexpr int SC = P + PF_STAGES * P_BYTES;  // + stage * SC_BYTES
  static constexpr int BAR = SC + PF_STAGES * SC_BYTES;  // full[], empty[]
  static constexpr int BYTES = BAR + 8 * 2 * PF_STAGES;
};

// acc += part * the plane's scale: fragment rows g and g + 8 are the
// thread's weight columns col and col + 1
__device__ __forceinline__ void add_scaled(float (&acc)[PF_BM / 2], const float (&part)[PF_BM / 2],
                                           const unsigned char* scale_row, int col) {
  const float2 s = *reinterpret_cast<const float2*>(scale_row + 4 * col);
#pragma unroll
  for (int j = 0; j < PF_BM / 8; ++j) {
    acc[4 * j] += part[4 * j] * s.x;
    acc[4 * j + 1] += part[4 * j + 1] * s.x;
    acc[4 * j + 2] += part[4 * j + 2] * s.y;
    acc[4 * j + 3] += part[4 * j + 3] * s.y;
  }
}

// The register-A fragments of one step (64 packed rows of the swizzled
// tile P) for the thread's two weight columns col and col + 1 (fragment
// rows g and g + 8), one nibble plane: fragment kk holds k rows 16 kk + 2c,
// + 1, + 8 and + 9. Each k row's two bytes are one 16-bit load; the
// 128-byte swizzle puts the four rows of a warp's load on distinct banks.
template <bool HI>
__device__ __forceinline__ void a_fragments(const unsigned char* P, int col, int c,
                                            uint32_t (&a)[PF_KC / 4]) {
#pragma unroll
  for (int kk = 0; kk < PF_KC / 16; ++kk) {
    uint32_t v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int r = 16 * kk + 2 * c + (q & 1) + 8 * (q >> 1);
      v[q] = *reinterpret_cast<const uint16_t*>(P + r * 128 + (((col >> 4) ^ (r & 7)) << 4) +
                                                (col & 15));
    }
    const uint32_t t0 = v[0] | (v[1] << 16), t1 = v[2] | (v[3] << 16);
    a[4 * kk] = nibbles_bf16x2<HI>(t0);           // column col, k 2c and 2c + 1
    a[4 * kk + 1] = nibbles_bf16x2<HI>(t0 >> 8);  // column col + 1
    a[4 * kk + 2] = nibbles_bf16x2<HI>(t1);       // column col, k 2c + 8 and + 9
    a[4 * kk + 3] = nibbles_bf16x2<HI>(t1 >> 8);
  }
}

__global__ void __launch_bounds__(PF_THREADS, 1)
    q4_wgmma(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tp,
             const __grid_constant__ CUtensorMap ts, float* __restrict__ out, int M, int N, int K,
             int G) {
  using L = PfSmem;
  using namespace sm90;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* empty = full + PF_STAGES;

  const int half = K / 2;
  const int hg = G / 2;
  const int group = half / hg;
  const int cpg = group / PF_KC;   // steps per group and plane
  const int n_steps = hg * 2 * cpg;
  const int m0 = blockIdx.x * PF_BM;
  const int n0 = blockIdx.y * PF_BN;

  if (threadIdx.x == 0) {
    for (int s = 0; s < PF_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], PF_CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= PF_CONSUMERS) {  // producer warp: one lane issues TMA
    if (threadIdx.x != PF_CONSUMERS) return;
    int stage = 0;
    uint32_t phase = 0;
    for (int i = 0; i < n_steps; ++i) {
      const int t = i / (2 * cpg);
      const int plane = (i / cpg) % 2;
      const int prow = t * group + (i % cpg) * PF_KC;
      mbar_wait(&empty[stage], phase ^ 1);
      mbar_arrive_expect_tx(&full[stage], L::X_BYTES + L::P_BYTES + L::SC_BYTES);
      tma_load_2d(smem + L::X + stage * L::X_BYTES, &tx, &full[stage], plane * half + prow, m0);
      tma_load_2d(smem + L::P + stage * L::P_BYTES, &tp, &full[stage], n0, prow);
      tma_load_2d(smem + L::SC + stage * L::SC_BYTES, &ts, &full[stage], n0, plane * hg + t);
      if (++stage == PF_STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    return;
  }

  // consumers: out^T = W^T . x^T. Warpgroup wg owns weight columns
  // 64 wg .. 64 wg + 63 of the tile (the wgmma's M) for all 128 rows of x
  // (its N, read K-major from the x tile). Fragment rows g and g + 8 of
  // warp w are the columns col = 64 wg + 16 w + 2g and col + 1, so one
  // thread's two columns sit side by side in the packed tile; the
  // accumulator's columns 8j + 2c and + 1 are rows of x.
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32;
  const int lane = threadIdx.x % 32;
  const int c4 = lane % 4;
  const int col = PF_WN * wg + 16 * warp + 2 * (lane / 4);

  float acc[PF_BM / 2], part[PF_BM / 2];
#pragma unroll
  for (int i = 0; i < PF_BM / 2; ++i) acc[i] = part[i] = 0.f;
  uint32_t a[PF_KC / 4];
#pragma unroll
  for (int i = 0; i < PF_KC / 4; ++i) a[i] = 0u;

  int stage = 0, prev = 0;
  uint32_t phase = 0;
  for (int i = 0; i < n_steps; ++i) {
    const int plane = (i / cpg) % 2;
    const int c = i % cpg;  // chunk within the group and plane
    mbar_wait(&full[stage], phase);
    // this step's fragments, while step i - 1's wgmma still reads a[]
    uint32_t an[PF_KC / 4];
    const unsigned char* P = smem + L::P + stage * L::P_BYTES;
    if (plane)
      a_fragments<true>(P, col, c4, an);
    else
      a_fragments<false>(P, col, c4, an);

    // step i - 1's products are done: a[] is free, its stage can be
    // refilled, and if it ended a group's plane, its product joins the
    // output
    wgmma_wait_all();
    fence_regs(part);
    fence_regs(a);
    if (i > 0) {
      if (c == 0) add_scaled(acc, part, smem + L::SC + prev * L::SC_BYTES, col);
      mbar_arrive(&empty[prev]);
    }
#pragma unroll
    for (int q = 0; q < PF_KC / 4; ++q) a[q] = an[q];

    const uint32_t x_addr = smem_addr(smem + L::X + stage * L::X_BYTES);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < PF_KC / 16; ++kk)
      wgmma_rs_kb(part, a[4 * kk], a[4 * kk + 1], a[4 * kk + 2], a[4 * kk + 3],
                  desc_sw128(x_addr + kk * 32, 16), c > 0 || kk > 0);
    wgmma_commit();
    prev = stage;
    if (++stage == PF_STAGES) {
      stage = 0;
      phase ^= 1;
    }
  }
  wgmma_wait_all();
  fence_regs(part);
  fence_regs(a);
  add_scaled(acc, part, smem + L::SC + prev * L::SC_BYTES, col);

  const int n = n0 + col;
  if (n >= N) return;
#pragma unroll
  for (int j = 0; j < PF_BM / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int row = m0 + 8 * j + 2 * c4 + e;
      if (row < M)
        *reinterpret_cast<float2*>(out + (long long)row * N + n) =
            make_float2(acc[4 * j + e], acc[4 * j + 2 + e]);
    }
}

cudaError_t launch_wgmma(const void* x, const void* packed, const void* scale, void* out,
                         int M, int N, int K, int G, cudaStream_t stream) {
  CUtensorMap tx, tp, ts;
  cudaError_t err = sm90::encode_2d(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, M, K, 2LL * K,
                                    PF_KC, PF_BM, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == cudaSuccess)
    err = sm90::encode_2d(&tp, CU_TENSOR_MAP_DATA_TYPE_UINT8, packed, K / 2, N, N, PF_BN, PF_KC,
                          CU_TENSOR_MAP_SWIZZLE_128B);
  if (err == cudaSuccess)
    err = sm90::encode_2d(&ts, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, scale, G, N, 4LL * N, PF_BN, 1,
                          CU_TENSOR_MAP_SWIZZLE_NONE);
  if (err != cudaSuccess) return err;
  const int smem = PfSmem::BYTES + 1024;  // + alignment slack
  err = cudaFuncSetAttribute(q4_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  // m tiles fastest: the blocks that share a weight tile run together
  dim3 grid((M + PF_BM - 1) / PF_BM, (N + PF_BN - 1) / PF_BN);
  q4_wgmma<<<grid, PF_THREADS, smem, stream>>>(tx, tp, ts, static_cast<float*>(out), M, N, K,
                                               G);
  return cudaGetLastError();
}

// Which body serves M rows: the launch and kt_q4_matmul_body read this one
// predicate. 0: split-K mma.sync (decode), 1: wgmma + TMA (prefill).
int body_for(int M) { return M <= 16 ? 0 : 1; }

}  // namespace

// x (M, K) bf16, packed (K/2, N) int8, scale (G, N) fp32, out (M, N) fp32,
// all contiguous and 16-byte aligned. The group K / G must be a multiple of
// 64 and N a multiple of 16. At M <= 16, `splits` runs of whole groups
// split K (1 <= splits <= G / 2) and, above 1, `work` holds their
// (splits, M, N) fp32 partials; at M > 16 both are ignored.
extern "C" int kt_q4_matmul(const void* x, const void* packed, const void* scale, void* out,
                            void* work, int M, int N, int K, int G, int splits, void* stream) {
  if (M <= 0 || N <= 0) return cudaSuccess;
  if (K <= 0 || K % 2 || G < 2 || G % 2 || (K / 2) % (G / 2) ||
      ((K / 2) / (G / 2)) % 64 || N % 16)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (body_for(M) == 0) {
    if (splits < 1 || splits > G / 2 || (splits > 1 && work == nullptr))
      return cudaErrorInvalidValue;
    return launch_splitk(x, packed, scale, out, work, M, N, K, G, splits, st);
  }
  return launch_wgmma(x, packed, scale, out, M, N, K, G, st);
}

// 0 if (M, K, N, G) runs the split-K decode body, 1 if the wgmma prefill
// body (the tests and chip_smoke.py read this; the launch above dispatches
// on the same predicate).
extern "C" int kt_q4_matmul_body(int M, int K, int N, int G) {
  (void)K;
  (void)N;
  (void)G;
  return body_for(M);
}
