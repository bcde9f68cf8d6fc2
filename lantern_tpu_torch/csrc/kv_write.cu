// K3: KV block write.  New rows [L, B, T, G*128] (K and V) land at rows
// [start[b], start[b]+T) of batch row b of the grouped planes
// [L, B, G, S, 128] (start is one value for every row, or one a row: the
// batched engine's R requests are 2R rows, each at its own length); for an int8
// cache each 128-lane group row is quantized on the way (one f32 scale per
// row into the [L, B, G, S] scale planes), byte for byte as
// kv.quantize_rows.
//
// Replaces write_block (lantern_tpu/ops/pallas/kv_update.py:170), which
// only copied rows; here the quantization that XLA ran before it is fused
// into the same launch.  start is read from device memory (no host sync),
// per row, and clamped to [0, S-T] like lax.dynamic_update_slice.
//
// Bound: HBM bytes, each bf16 row read once and each int8 row and scale
// written once (50 MB at the rollback path's 32-row block of 32 layers),
// so the card needs megabytes in flight to reach its memory rate.
//
// Design: a streaming quantize-and-store.
// - A half-warp owns one (l, b, t, g) row index, for K and V at once: 16
//   lanes of one 16-byte load each take the row's 256 bytes.  A round gives
//   every half-warp UNITS indices and issues all of their loads (2 * UNITS
//   16-byte loads a lane) before any reduction.
// - The grid is one wave (the SM count times the blocks an SM holds, from
//   the occupancy of this kernel), or fewer blocks when the rows are fewer;
//   a grid-stride loop takes the rest.  Adjacent half-warps take adjacent
//   rows, so a warp's load is 512 contiguous bytes.
// - The row's amax is a 4-step shuffle within the half-warp; the division
//   is the fast sequence shared with K2 (common.cuh), so no IEEE division's
//   range check serialises the quotients.  A lane stores its 8 int8 values
//   as one 8-byte store; one lane of each half-warp stores the scale.
// - The bf16 cache (the drafter's) takes the same layout without the
//   quantization: a 16-byte copy a lane.
// Two row indices a round, at 8 blocks an SM, already put some 128 KB of
// loads in flight on an SM, so what the kernel lacks of the card's memory
// rate is not loads in flight: four indices a round, fewer blocks an SM,
// the next round's loads issued before this round's stores, or the rows
// taken in destination order all timed no better on an NVIDIA H100 80GB
// HBM3 (700.00 W).
#include "common.cuh"

namespace {

constexpr int CHUNKS = 16;            // 16-byte chunks of a 128-lane bf16 row
constexpr int THREADS = 256;
constexpr int HALVES = THREADS / 16;  // half-warps a block
constexpr int UNITS = 2;              // row indices a half-warp takes a round

struct Round {
  uint4 raw[2][UNITS];                // this lane's chunk of K's and V's rows
};

// the lane's chunks of the round at `base` (zeros past the last row)
__device__ __forceinline__ void load_round(const uint4* __restrict__ kn,
                                           const uint4* __restrict__ vn,
                                           int base, int stride, int h0,
                                           int hl, int rows, Round& rd) {
#pragma unroll
  for (int u = 0; u < UNITS; ++u) {
    const int r = base + u * stride + h0;
    rd.raw[0][u] = rd.raw[1][u] = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows) {
      rd.raw[0][u] = kn[(size_t)r * CHUNKS + hl];
      rd.raw[1][u] = vn[(size_t)r * CHUNKS + hl];
    }
  }
}

// the int8 cache: quantize a round's rows (K and V of UNITS row indices a
// half-warp) and store their bytes and scales.  Unit u is skipped by the
// whole warp when its first half-warp has no row there (`any`), so the
// shuffles stay warp-wide.
__device__ __forceinline__ void quantize_store(
    const Round& rd, const size_t (&drow)[UNITS], const bool (&live)[UNITS],
    const bool (&any)[UNITS], int hl, int8_t* __restrict__ kb,
    int8_t* __restrict__ vb, float* __restrict__ ksc,
    float* __restrict__ vsc) {
#pragma unroll
  for (int u = 0; u < UNITS; ++u) {
    if (!any[u]) continue;
    float v[2][8], amax[2];
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const __nv_bfloat162* h =
          reinterpret_cast<const __nv_bfloat162*>(&rd.raw[x][u]);
      float a = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(h[i]);
        v[x][2 * i] = f.x;
        v[x][2 * i + 1] = f.y;
        a = fmaxf(a, fmaxf(fabsf(f.x), fabsf(f.y)));
      }
      amax[x] = a;
    }
#pragma unroll
    for (int o = 8; o > 0; o >>= 1)
#pragma unroll
      for (int x = 0; x < 2; ++x)
        amax[x] = fmaxf(amax[x], __shfl_xor_sync(0xffffffffu, amax[x], o));
    float scale[2];
    uint32_t w[2][2];
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      scale[x] = lantern::quant_scale(amax[x]);
      lantern::quantize_fast(v[x], scale[x], w[x]);
    }
#pragma unroll
    for (int x = 0; x < 2; ++x) lantern::quantize_fixup(v[x], scale[x], w[x]);
    if (!live[u]) continue;
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      int8_t* dst = (x ? vb : kb) + drow[u] * 128;
      reinterpret_cast<uint2*>(dst)[hl] = make_uint2(w[x][0], w[x][1]);
      if (hl == 0) (x ? vsc : ksc)[drow[u]] = scale[x];
    }
  }
}

template <bool QUANT>
__global__ void __launch_bounds__(THREADS)
kv_write_kernel(const uint4* __restrict__ kn, const uint4* __restrict__ vn,
                void* __restrict__ kb, void* __restrict__ vb,
                float* __restrict__ ksc, float* __restrict__ vsc,
                const int* __restrict__ starts, int start_stride, int B,
                int T, int G, int S, int rows) {
  const int hl = threadIdx.x & 15;                 // lane in the half-warp
  const int h0 = blockIdx.x * HALVES + (threadIdx.x >> 4);
  const int hw = h0 & ~1;                          // the warp's first half
  const int stride = gridDim.x * HALVES;
  // the loop bound is uniform over the grid, so every lane of a warp makes
  // the same rounds and takes part in every shuffle
  for (int base = 0; base < rows; base += UNITS * stride) {
    Round rd;
    load_round(kn, vn, base, stride, h0, hl, rows, rd);
    size_t drow[UNITS];
    bool live[UNITS], any[UNITS];
#pragma unroll
    for (int u = 0; u < UNITS; ++u) {
      const int r = base + u * stride + h0;
      live[u] = r < rows;
      any[u] = base + u * stride + hw < rows;
      const int g = r % G, rest = r / G;
      const int t = rest % T, lb = rest / T;
      // this row's start (every lane of a half-warp reads the same word)
      const int start =
          live[u] ? min(max(starts[(lb % B) * start_stride], 0), S - T) : 0;
      drow[u] = ((size_t)lb * G + g) * S + start + t;
    }
    if (!QUANT) {
#pragma unroll
      for (int u = 0; u < UNITS; ++u) {
        if (!live[u]) continue;
        static_cast<uint4*>(kb)[drow[u] * CHUNKS + hl] = rd.raw[0][u];
        static_cast<uint4*>(vb)[drow[u] * CHUNKS + hl] = rd.raw[1][u];
      }
    } else {
      quantize_store(rd, drow, live, any, hl, static_cast<int8_t*>(kb),
                     static_cast<int8_t*>(vb), ksc, vsc);
    }
  }
}

template <bool QUANT>
int launch(const void* k_new, const void* v_new, void* k_buf, void* v_buf,
           void* k_scale, void* v_scale, const int* starts, int start_stride,
           int B, int T, int G, int S, int rows, cudaStream_t st) {
  static int cache[lantern::MAX_DEVICES] = {0};
  int wave = 0;
  const cudaError_t e = lantern::wave_blocks(kv_write_kernel<QUANT>, THREADS,
                                             0, cache, &wave);
  if (e != cudaSuccess) return (int)e;
  const int need = (rows + HALVES - 1) / HALVES;
  const int grid = need < wave ? need : wave;
  kv_write_kernel<QUANT><<<grid, THREADS, 0, st>>>(
      static_cast<const uint4*>(k_new), static_cast<const uint4*>(v_new),
      k_buf, v_buf, static_cast<float*>(k_scale), static_cast<float*>(v_scale),
      starts, start_stride, B, T, G, S, rows);
  return (int)cudaGetLastError();
}

}  // namespace

// starts: int32, one for every batch row (start_stride 0) or one a row
// (start_stride 1)
LANTERN_EXPORT int lantern_kv_write(const void* k_new, const void* v_new,
                                    void* k_buf, void* v_buf, void* k_scale,
                                    void* v_scale, const void* starts,
                                    int start_stride, int L, int B, int T,
                                    int G, int S, int quantized,
                                    void* stream) {
  const long long rows = (long long)L * B * T * G;
  // 2^30 rows would be 256 GB of new rows, more than a card holds; below it
  // no row index of the grid-stride loop overflows an int
  if (L < 1 || B < 1 || T < 1 || G < 1 || T > S || rows > (1LL << 30) ||
      (start_stride != 0 && start_stride != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const auto* sp = static_cast<const int*>(starts);
  return quantized ? launch<true>(k_new, v_new, k_buf, v_buf, k_scale,
                                  v_scale, sp, start_stride, B, T, G, S,
                                  (int)rows, st)
                   : launch<false>(k_new, v_new, k_buf, v_buf, nullptr,
                                   nullptr, sp, start_stride, B, T, G, S,
                                   (int)rows, st);
}
