// K1: W8A16 dequant-matmul  out[M, N] = (x[M, K] @ q[K, N]) * s[N].
//
// Replaces int8_matmul_pallas (lantern_tpu/ops/quant.py:73): bf16
// activations, int8 weights with one f32 scale per output channel, f32
// accumulation, the scale applied once at the end.  One launch a call, in
// one of two forms chosen by the row count M (ops/quant.k1_form):
//
// - M <= 64 (decode: 2 rows for AR, 2 x tree rows for a small verify):
//   int8_matmul_kernel<NP>.  At most 128 operations for every weight byte
//   against the ~295 the card needs before its tensor cores are the limit:
//   bound by the K * N weight bytes, and the design is about moving them.
// - M > 64 (the 512-row verify of 16 CFG rows x 32 tree nodes, prefills,
//   calibration): int8_matmul_kernel_wide<SPLIT>.  At M = 512 a weight
//   byte feeds 1,024 operations, so the call is bound by the tensor cores,
//   and the design is about keeping them fed: each weight byte leaves HBM
//   once a call and is dequantized once for every 128 activation rows.
//
// Both forms keep one rule, bit for bit: a row's result depends on neither
// M nor the other rows.  The k stages (KC = 64 rows), the split count
// (ops/quant.k1_splits, from K and N) and the order of every sum are
// functions of K and N; M only picks the form and the instruction's width.
// So a token computed inside a 512-row verify equals its AR computation.
//
// The narrow form, int8_matmul_kernel<NP>.
// - A thread block (one warpgroup of 4 warps) owns BN = 128 output columns,
//   so every weight row it reads is a full 128-byte line, and one split of
//   the k range.
// - The weights go raw, as int8, through a ring of 4 shared-memory stages
//   of KC = 64 k rows (8 KB each) filled by 16-byte cp.async copies three
//   stages ahead, together with the stage's slice of the x rows (bf16, 128
//   bytes a row in the 128-byte swizzle, zero rows up to the instruction's
//   width).  Nothing is written back to shared memory as bf16.
// - The product is wgmma.m64nNk16 (bf16, f32 accumulation) with the 64-row
//   side on the weight's columns and the activation rows on its N side
//   (8, 16, 32 or 64 wide): out^T = q^T x^T.  The A operand, q^T, comes
//   from registers: each thread reads four 4-byte words (4 adjacent columns
//   of k rows 2c, 2c+1, 2c+8, 2c+9), turns them into bf16 by byte permutes
//   (exact) and so holds the A fragments of two instructions; the B operand,
//   x^T, is read by the tensor cores straight from the swizzled stage.  The
//   64 rows of an instruction are free to permute, so a thread ends up
//   owning 4 adjacent output columns of every activation row it holds.  The
//   conversion of the next k step overlaps the running instruction (two
//   fragment buffers, wgmma.wait_group 1).
// - Split-K for the thin shapes: the wrapper (ops/quant.k1_splits, from K
//   and N alone) divides the stages of the k range over gridDim.y blocks so
//   that a launch has two blocks an SM, as far as every split still streams
//   1024 k rows (under that its partials cost more than it saves: at
//   K = N = 4096, M = 64 nine splits took 0.040 ms, four 0.029 ms; NVIDIA
//   H100 80GB HBM3, 700.00 W).  Each split writes
//   its f32 partials and takes a ticket of its column tile; the last to
//   arrive adds the partials in split order, scales and stores, then resets
//   the ticket.  No float atomics.
//
// The wide form, int8_matmul_kernel_wide<SPLIT>.
// - A persistent grid, one block an SM (as many as there are tiles), walks
//   the (column tile, row tile) pairs of 128 weight columns x 128 activation
//   rows, row tile fastest: the blocks that hold the row tiles of one column
//   tile run at the same time, so that tile's weight bytes come from HBM
//   once and from L2 for the other row tiles, and x (4 MB at the verify)
//   stays in L2.  Chosen by measurement over a cluster that multicasts the
//   weight tile to the blocks of 2 row tiles (or x to those of 2 column
//   tiles): built on this kernel, each was bit-equal and took 1.8x as long
//   at every verify shape with the card full of clusters, 2.5x both at once
//   (NVIDIA H100 80GB HBM3, 700 W; PERF.md section 6).
// - A producer warp keeps TMA loads of the int8 weight tile (64 k rows x 128
//   columns, 8 KB) and of the bf16 activation tile (128 rows x 64 k, 16 KB),
//   both in the 128-byte swizzle, in flight through a ring of 8 stages with
//   a full and an empty mbarrier each.  TMA zero-fills past K, M and N.
// - Two consumer warpgroups own 64 weight columns each and share the
//   activation tile.  A thread reads 2 adjacent columns of k rows 2c, 2c+1,
//   2c+8, 2c+9 (four 2-byte loads, no bank conflicts in the swizzle), turns
//   them into the A fragment of one wgmma.m64n128k16 by the narrow form's
//   byte permutes and runs it against the 128 activation rows of the stage.
//   The stage is released one k step later, once its last instruction is
//   done (wgmma.wait_group 1).
// - The splits of k1_splits are accumulation checkpoints inside the block:
//   at a split's first stage the accumulator starts from zeros, at its last
//   it is added into a running f32 total that starts at 0.f, in split order,
//   which is what the narrow form's last block adds from the partials; one
//   split (SPLIT false) keeps the accumulator as it is, as the narrow form
//   does.  Then the scale, then the rounding to bf16 or f32 out.  No
//   partials go to device memory.  Accumulator and total are 64 + 64 f32
//   registers a thread, which is what bounds the warpgroup's tile at 64
//   columns x 128 rows (m64n128; n256 would need 256 registers a thread).
#include <cuda.h>

#include "common.cuh"

namespace {

constexpr int BN = 128;       // output columns per block
constexpr int KC = 64;        // contraction rows per stage
constexpr int STAGES = 4;
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int WROW = BN + 16;        // padded weight row (bytes)
constexpr int XROW = KC * 2;         // x row: 128 bytes, swizzled
constexpr int MAX_ROWS = 64;
static_assert(KC * WROW % 1024 == 0, "x stages must stay 1024-byte aligned");

template <int NP>   // activation rows of the instruction: 8, 16, 32 or 64
struct Stage {
  static constexpr int BYTES = KC * WROW + (NP < 8 ? 8 : NP) * XROW;
  static_assert(BYTES % 1024 == 0, "stages must stay 1024-byte aligned");
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool live) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int n = live ? 16 : 0;     // 0 source bytes: the 16 are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(n));
}

// out^T[64, N] += A[64, 16] (registers) * B[16, N] (shared memory)
__device__ __forceinline__ void wgmma_rs(float (&d)[4], const uint32_t (&a)[4],
                                         uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[8], const uint32_t (&a)[4],
                                         uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4],
                                         uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keeps registers an asynchronous instruction still reads (or writes) from
// being reused or read before its wait
__device__ __forceinline__ void keep(uint32_t (&r)[4]) {
  asm volatile("" : "+r"(r[0]), "+r"(r[1]), "+r"(r[2]), "+r"(r[3])::"memory");
}
template <int ND>
__device__ __forceinline__ void keep(float (&d)[ND]) {
#pragma unroll
  for (int i = 0; i < ND; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// B operand: 16 k of NP rows, K-major, 128-byte swizzle; groups of 8 rows
// are 1024 bytes apart
__device__ __forceinline__ uint64_t b_desc(const void* p) {
  const uint64_t addr = (uint64_t)__cvta_generic_to_shared(p);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

// byte I of a word of int8 values that were xor-ed with 0x80 -> its f32
// value: 0x4B0000uu is 2^23 + u, and u = value + 128
template <int I>
__device__ __forceinline__ float int8_f32(uint32_t w) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540 | I)) - 8388736.f;
}

// two f32 holding small integers -> packed bf16 (lo in the low half)
__device__ __forceinline__ uint32_t pack_hi(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// the A fragments of the two instructions of a k step from four weight words
// (k rows 2c, 2c+1, 2c+8, 2c+9; 4 adjacent columns each): instruction P takes
// column 2P as the fragment's row g and column 2P + 1 as its row g + 8
template <int P>
__device__ __forceinline__ void a_frag(uint32_t (&a)[4], const uint32_t (&w)[4]) {
  a[0] = pack_hi(int8_f32<2 * P>(w[0]), int8_f32<2 * P>(w[1]));
  a[1] = pack_hi(int8_f32<2 * P + 1>(w[0]), int8_f32<2 * P + 1>(w[1]));
  a[2] = pack_hi(int8_f32<2 * P>(w[2]), int8_f32<2 * P>(w[3]));
  a[3] = pack_hi(int8_f32<2 * P + 1>(w[2]), int8_f32<2 * P + 1>(w[3]));
}

template <int NP>
__global__ void __launch_bounds__(THREADS)
int8_matmul_kernel(const __nv_bfloat16* __restrict__ x,
                   const int8_t* __restrict__ q, const float* __restrict__ s,
                   void* __restrict__ out, float* __restrict__ part,
                   int* __restrict__ tickets, int M, int K, int N,
                   int out_f32) {
  constexpr int SB = Stage<NP>::BYTES;
  constexpr int ND = NP / 2;       // accumulators a thread, an instruction
  extern __shared__ unsigned char smem_raw[];
  // the swizzle is a function of the address: stages start at 1024 bytes
  unsigned char* smem = smem_raw +
      ((1024 - ((unsigned)__cvta_generic_to_shared(smem_raw) & 1023)) & 1023);

  const int n0 = blockIdx.x * BN;
  const int z = blockIdx.y, nsplit = gridDim.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gi = lane >> 2, c = lane & 3;

  // this split's stages of the k range (a function of K and the grid)
  const int nst = (K + KC - 1) / KC;
  const int st0 = (int)((long long)z * nst / nsplit);
  const int st1 = (int)((long long)(z + 1) * nst / nsplit);
  const int ntot = st1 - st0;

  auto fill = [&](int i) {
    if (i < ntot) {
      unsigned char* xs = smem + (size_t)(i % STAGES) * SB;
      unsigned char* ws = xs + NP * XROW;
      const int k0 = (st0 + i) * KC;
      for (int ch = tid; ch < KC * (BN / 16); ch += THREADS) {
        const int r = ch / (BN / 16), col = (ch % (BN / 16)) * 16;
        const bool live = k0 + r < K && n0 + col < N;
        const size_t off = live ? (size_t)(k0 + r) * N + n0 + col : 0;
        cp_async16(ws + r * WROW + col, q + off, live);
      }
      for (int ch = tid; ch < NP * (KC / 8); ch += THREADS) {
        const int r = ch / (KC / 8), kk = ch % (KC / 8);
        const bool live = r < M && k0 + kk * 8 < K;
        const size_t off = live ? (size_t)r * K + k0 + kk * 8 : 0;
        cp_async16(xs + r * XROW + ((kk ^ (r & 7)) << 4), x + off, live);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  float acc[2][ND];
#pragma unroll
  for (int p = 0; p < 2; ++p)
#pragma unroll
    for (int i = 0; i < ND; ++i) acc[p][i] = 0.f;
  uint32_t abuf[2][2][4] = {};     // [k step parity][instruction][fragment]

  // one loop fills and consumes: the first STAGES - 1 rounds only fill
  for (int i = 1 - STAGES; i < ntot; ++i) {
    if (i >= 0) {
      asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2));
      // the copies land through the generic proxy, the tensor cores read
      // through the async one
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();             // stage i has landed; stage i-1 is consumed
    }
    fill(i + STAGES - 1);
    if (i < 0) continue;
    const unsigned char* xs = smem + (size_t)(i % STAGES) * SB;
    const unsigned char* ws = xs + NP * XROW;
#pragma unroll
    for (int ks = 0; ks < KC / 16; ++ks) {
      // weight words: columns 32 warp + 4 gi .. + 3 of k rows
      // 16 ks + {2c, 2c+1, 2c+8, 2c+9}
      uint32_t w[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int k = 16 * ks + 2 * c + (r & 1) + 8 * (r >> 1);
        w[r] = *reinterpret_cast<const uint32_t*>(ws + k * WROW + 32 * warp +
                                                  4 * gi) ^ 0x80808080u;
      }
      a_frag<0>(abuf[ks & 1][0], w);
      a_frag<1>(abuf[ks & 1][1], w);
      wgmma_fence();
      const uint64_t desc = b_desc(xs + 32 * ks);
      wgmma_rs(acc[0], abuf[ks & 1][0], desc);
      wgmma_rs(acc[1], abuf[ks & 1][1], desc);
      wgmma_commit();
      wgmma_wait<1>();             // the previous k step's pair is done
      keep(abuf[(ks & 1) ^ 1][0]);
      keep(abuf[(ks & 1) ^ 1][1]);
    }
    wgmma_wait<0>();               // the stage may be refilled after this
    keep(abuf[1][0]);
    keep(abuf[1][1]);
  }
  keep(acc[0]);
  keep(acc[1]);

  // acc[p][4j + 2h + e] is activation row 8j + 2c + e, column
  // n0 + 32 warp + 4 gi + 2p + h: 4 adjacent columns a thread and row
  const bool single = nsplit == 1;
  float* mine = part + (size_t)z * M * N;
  const int n = n0 + 32 * warp + 4 * gi;
  auto store = [&](int r, float4 v) {
    const float4 sc = *reinterpret_cast<const float4*>(s + n);
    v.x *= sc.x; v.y *= sc.y; v.z *= sc.z; v.w *= sc.w;
    if (out_f32) {
      *reinterpret_cast<float4*>(static_cast<float*>(out) + (size_t)r * N + n) = v;
    } else {
      __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
      __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
      uint2 pk;
      pk.x = *reinterpret_cast<uint32_t*>(&lo);
      pk.y = *reinterpret_cast<uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(out) +
                                (size_t)r * N + n) = pk;
    }
  };
#pragma unroll
  for (int j = 0; j < NP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = 8 * j + 2 * c + e;
      if (r >= M || n >= N) continue;
      const float4 v = make_float4(acc[0][4 * j + e], acc[0][4 * j + 2 + e],
                                   acc[1][4 * j + e], acc[1][4 * j + 2 + e]);
      if (single)
        store(r, v);
      else
        *reinterpret_cast<float4*>(mine + (size_t)r * N + n) = v;
    }
  if (single) return;

  // the last split of this column tile to arrive adds all partials in
  // split order (the same order whatever M is and whoever arrives last)
  __shared__ int is_last;
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const int got = atomicAdd(tickets + blockIdx.x, 1);
    is_last = got == nsplit - 1;
    if (is_last) tickets[blockIdx.x] = 0;    // ready for the next launch
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
#pragma unroll
  for (int j = 0; j < NP / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = 8 * j + 2 * c + e;
      if (r >= M || n >= N) continue;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
      for (int zz = 0; zz < nsplit; ++zz) {
        const float4 p = __ldcg(reinterpret_cast<const float4*>(
            part + ((size_t)zz * M + r) * N + n));
        v.x += p.x; v.y += p.y; v.z += p.z; v.w += p.w;
      }
      store(r, v);
    }
}

template <int NP>
int launch(const __nv_bfloat16* x, const int8_t* q, const float* s, void* out,
           float* part, int* tickets, int M, int K, int N, int nsplit,
           int out_f32, cudaStream_t st) {
  constexpr int SMEM = STAGES * Stage<NP>::BYTES + 1024;   // alignment slack
  const cudaError_t e = cudaFuncSetAttribute(
      int8_matmul_kernel<NP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((N + BN - 1) / BN, nsplit);
  int8_matmul_kernel<NP><<<grid, THREADS, SMEM, st>>>(x, q, s, out, part,
                                                     tickets, M, K, N, out_f32);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------ the wide form

constexpr int WBN = 128;      // weight columns of a tile: 64 a consumer
constexpr int WBM = 128;      // activation rows of a tile (the n128 side)
constexpr int WSTAGES = 8;
constexpr int WCONSUMERS = 2;                     // warpgroups
constexpr int WTHREADS = WCONSUMERS * 128 + 32;   // and one producer warp
constexpr int W_TILE = KC * WBN;                  // int8 weight tile, 8 KB
constexpr int X_TILE = WBM * KC * 2;              // bf16 x tile, 16 KB
constexpr int WSTAGE = W_TILE + X_TILE;
constexpr int WSMEM = WSTAGES * WSTAGE + 1024;    // alignment slack
static_assert(W_TILE % 1024 == 0 && WSTAGE % 1024 == 0,
              "swizzled tiles must stay 1024-byte aligned");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(b)),
               "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* b, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
               "r"(smem_addr(b)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(b))
               : "memory");
}
// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* b, int parity) {
  const uint32_t a = smem_addr(b);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
  } while (!done);
}
// the box at (c0, c1) (innermost first) of a 2-d tensor map -> dst; the
// bytes land on the mbarrier's transaction count
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(c1) : "memory");
}

// the A fragment of one instruction from four 2-byte loads: columns cb and
// cb + 1 (the fragment's rows g and g + 8) of k rows 2c, 2c+1, 2c+8, 2c+9
__device__ __forceinline__ void a_frag_pair(uint32_t (&a)[4], uint32_t h0,
                                            uint32_t h1, uint32_t h8,
                                            uint32_t h9) {
  const uint32_t lo = __byte_perm(h0, h1, 0x5410) ^ 0x80808080u;
  const uint32_t hi = __byte_perm(h8, h9, 0x5410) ^ 0x80808080u;
  a[0] = pack_hi(int8_f32<0>(lo), int8_f32<2>(lo));
  a[1] = pack_hi(int8_f32<1>(lo), int8_f32<3>(lo));
  a[2] = pack_hi(int8_f32<0>(hi), int8_f32<2>(hi));
  a[3] = pack_hi(int8_f32<1>(hi), int8_f32<3>(hi));
}

template <bool SPLIT>
__global__ void __launch_bounds__(WTHREADS, 1)
int8_matmul_kernel_wide(const __grid_constant__ CUtensorMap wmap,
                        const __grid_constant__ CUtensorMap xmap,
                        const float* __restrict__ s, void* __restrict__ out,
                        int M, int K, int N, int nsplit, int out_f32) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw +
      ((1024 - ((unsigned)__cvta_generic_to_shared(smem_raw) & 1023)) & 1023);
  __shared__ __align__(8) uint64_t full[WSTAGES], empty[WSTAGES];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nst = (K + KC - 1) / KC;
  const int nrt = (M + WBM - 1) / WBM;
  const int ntiles = (N + WBN - 1) / WBN * nrt;
  if (tid == 0) {
    for (int i = 0; i < WSTAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], WCONSUMERS * 4);     // one arrival a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == WCONSUMERS * 4) {
    // the producer: every stage of every tile of this block, in order
    if (lane == 0) {
      int it = 0;
      for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
        const int n0 = t / nrt * WBN, m0 = t % nrt * WBM;
        for (int st = 0; st < nst; ++st, ++it) {
          const int slot = it % WSTAGES;
          mbar_wait(&empty[slot], ((it / WSTAGES) & 1) ^ 1);
          unsigned char* ws = smem + (size_t)slot * WSTAGE;
          mbar_expect(&full[slot], WSTAGE);
          tma_load(ws, &wmap, &full[slot], n0, st * KC);
          tma_load(ws + W_TILE, &xmap, &full[slot], st * KC, m0);
        }
      }
    }
    return;
  }

  // a consumer: 64 weight columns (warpgroup j) of every tile; thread (g, c)
  // of warp w reads columns cb, cb + 1 of the tile
  const int j = warp >> 2, w = warp & 3, g = lane >> 2, c = lane & 3;
  const int cb = 64 * j + 16 * w + 2 * g;
  const int chunk = cb >> 4;
  // k rows 2c and 2c + 1 of the stage's first k step in the 128-byte
  // swizzle (16-byte chunk ^ (k row & 7)); 2c + 8 and 2c + 9 are 1024
  // bytes further, the next k step 2048
  const int o0 = 256 * c + ((chunk ^ (2 * c)) << 4) + 2 * g;
  const int o1 = 256 * c + 128 + ((chunk ^ (2 * c + 1)) << 4) + 2 * g;
  int it = 0;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int n0 = t / nrt * WBN, m0 = t % nrt * WBM;
    float acc[64];
    float tot[SPLIT ? 64 : 1] = {};
    int held = -1;             // a consumed stage not yet released
    for (int z = 0; z < nsplit; ++z) {
      // this split's stages of the k range, as the narrow form cuts them
      const int st0 = (int)((long long)z * nst / nsplit);
      const int st1 = (int)((long long)(z + 1) * nst / nsplit);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.f;
      uint32_t abuf[2][4] = {};
      for (int st = st0; st < st1; ++st, ++it) {
        const int slot = it % WSTAGES;
        mbar_wait(&full[slot], (it / WSTAGES) & 1);
        const unsigned char* ws = smem + (size_t)slot * WSTAGE;
        const unsigned char* xs = ws + W_TILE;
#pragma unroll
        for (int ks = 0; ks < KC / 16; ++ks) {
          const unsigned char* wk = ws + 2048 * ks;
          a_frag_pair(abuf[ks & 1],
                      *reinterpret_cast<const unsigned short*>(wk + o0),
                      *reinterpret_cast<const unsigned short*>(wk + o1),
                      *reinterpret_cast<const unsigned short*>(wk + o0 + 1024),
                      *reinterpret_cast<const unsigned short*>(wk + o1 + 1024));
          wgmma_fence();
          wgmma_rs(acc, abuf[ks & 1], b_desc(xs + 32 * ks));
          wgmma_commit();
          wgmma_wait<1>();         // the previous k step's instruction is done
          keep(abuf[(ks & 1) ^ 1]);
          if (ks == 0 && held >= 0) {
            // so is the last of the previous stage: give that stage back
            if (lane == 0) mbar_arrive(&empty[held]);
            held = -1;
          }
        }
        held = slot;
      }
      wgmma_wait<0>();
      keep(abuf[0]);
      keep(abuf[1]);
      keep(acc);
      if (held >= 0) {
        if (lane == 0) mbar_arrive(&empty[held]);
        held = -1;
      }
      if constexpr (SPLIT) {
#pragma unroll
        for (int i = 0; i < 64; ++i) tot[i] += acc[i];
      }
    }

    // v[4i + 2h + e] is activation row m0 + 8i + 2c + e, column n0 + cb + h
    const int n = n0 + cb;
    auto store = [&](const float (&v)[64]) {
      const float2 sc = *reinterpret_cast<const float2*>(s + n);
#pragma unroll
      for (int i = 0; i < 16; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = m0 + 8 * i + 2 * c + e;
          if (r >= M) continue;
          const float v0 = v[4 * i + e] * sc.x, v1 = v[4 * i + 2 + e] * sc.y;
          if (out_f32) {
            *reinterpret_cast<float2*>(static_cast<float*>(out) +
                                       (size_t)r * N + n) = make_float2(v0, v1);
          } else {
            *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) +
                                               (size_t)r * N + n) =
                __floats2bfloat162_rn(v0, v1);
          }
        }
    };
    if (n < N) {
      if constexpr (SPLIT)
        store(tot);
      else
        store(acc);
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime (no libcuda link)
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// a row-major [rows, cols] tensor cut into boxes of [box_rows, box_cols],
// 128 bytes of a box row in the 128-byte swizzle, zeros outside
bool tensor_map(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes,
                const void* base, int rows, int cols, int box_rows,
                int box_cols) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(base), dims, strides, box,
                unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool SPLIT>
int launch_wide(const CUtensorMap& wmap, const CUtensorMap& xmap,
                const float* s, void* out, int M, int K, int N, int nsplit,
                int out_f32, cudaStream_t st) {
  cudaError_t e = cudaFuncSetAttribute(
      int8_matmul_kernel_wide<SPLIT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, WSMEM);
  if (e != cudaSuccess) return (int)e;
  static int cache[lantern::MAX_DEVICES];
  int wave = 0;
  e = lantern::wave_blocks(int8_matmul_kernel_wide<SPLIT>, WTHREADS, WSMEM,
                           cache, &wave);
  if (e != cudaSuccess) return (int)e;
  const long long tiles =
      (long long)((N + WBN - 1) / WBN) * ((M + WBM - 1) / WBM);
  const int grid = (int)(tiles < wave ? tiles : wave);
  int8_matmul_kernel_wide<SPLIT><<<grid, WTHREADS, WSMEM, st>>>(
      wmap, xmap, s, out, M, K, N, nsplit, out_f32);
  return (int)cudaGetLastError();
}

}  // namespace

LANTERN_EXPORT int lantern_int8_matmul(const void* x, const void* q,
                                       const void* s, void* out, void* part,
                                       void* tickets, int M, int K, int N,
                                       int nsplit, int out_f32, void* stream) {
  if (M < 1 || M > MAX_ROWS || K < 1 || N < 1 || K % 8 || N % 16 ||
      nsplit < 1 || nsplit > 65535 ||
      (nsplit > 1 && (part == nullptr || tickets == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* qb = static_cast<const int8_t*>(q);
  const auto* sb = static_cast<const float*>(s);
  auto* pb = static_cast<float*>(part);
  auto* tb = static_cast<int*>(tickets);
  if (M <= 8) return launch<8>(xb, qb, sb, out, pb, tb, M, K, N, nsplit, out_f32, st);
  if (M <= 16) return launch<16>(xb, qb, sb, out, pb, tb, M, K, N, nsplit, out_f32, st);
  if (M <= 32) return launch<32>(xb, qb, sb, out, pb, tb, M, K, N, nsplit, out_f32, st);
  return launch<64>(xb, qb, sb, out, pb, tb, M, K, N, nsplit, out_f32, st);
}

// the wide form, one launch for any M > 0 (the wrapper sends M > 64 here):
// no partials and no tickets
LANTERN_EXPORT int lantern_int8_matmul_wide(const void* x, const void* q,
                                            const void* s, void* out, int M,
                                            int K, int N, int nsplit,
                                            int out_f32, void* stream) {
  if (M < 1 || K < 1 || N < 1 || K % 8 || N % 16 || nsplit < 1 ||
      nsplit > (K + KC - 1) / KC)
    return (int)cudaErrorInvalidValue;
  CUtensorMap wmap, xmap;
  if (!tensor_map(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, q, K, N, KC, WBN) ||
      !tensor_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, M, K, WBM, KC))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const auto* sb = static_cast<const float*>(s);
  if (nsplit == 1)
    return launch_wide<false>(wmap, xmap, sb, out, M, K, N, 1, out_f32, st);
  return launch_wide<true>(wmap, xmap, sb, out, M, K, N, nsplit, out_f32, st);
}
