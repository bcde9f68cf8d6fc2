// K3: KV block write.  new rows [L, B, T, G*128] (K and V) land at rows
// [start, start+T) of the grouped planes [L, B, G, S, 128]; for an int8
// cache each 128-lane group row is quantized on the way (one f32 scale per
// row into the [L, B, G, S] scale planes), exactly as kv.quantize_rows.
//
// Replaces write_block (lantern_tpu/ops/pallas/kv_update.py:170), which
// only copied rows; here the quantization that XLA ran before it is fused
// into the same launch.  start is read from device memory (no host sync)
// and clamped to [0, S-T] like lax.dynamic_update_slice.
//
// Bound: HBM bytes — each bf16 row read once, each int8 row and scale
// written once.  Design: one warp per (tensor, row), four lanes' worth of
// values per thread (8-byte loads, 4-byte int8 stores); all layers and
// both K and V in one launch (grid.y selects K or V).
#include "common.cuh"

namespace {

constexpr int W = 128;
constexpr int THREADS = 256;
constexpr int ROWS_PER_BLOCK = THREADS / 32;

template <bool QUANT>
__global__ void __launch_bounds__(THREADS)
kv_write_kernel(const __nv_bfloat16* __restrict__ kn,
                const __nv_bfloat16* __restrict__ vn, void* __restrict__ kb,
                void* __restrict__ vb, float* __restrict__ ksc,
                float* __restrict__ vsc, const int* __restrict__ start_ptr,
                int L, int B, int T, int G, int S) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long rows = (long long)L * B * T * G;
  const long long r = (long long)blockIdx.x * ROWS_PER_BLOCK + warp;
  if (r >= rows) return;
  const bool is_v = blockIdx.y == 1;
  const int g = (int)(r % G);
  long long rest = r / G;
  const int t = (int)(rest % T);
  rest /= T;
  const int b = (int)(rest % B);
  const int l = (int)(rest / B);
  const int start = min(max(*start_ptr, 0), S - T);
  const long long drow = (((long long)l * B + b) * G + g) * S + start + t;

  float v[4];
  lantern::load_bf16x4((is_v ? vn : kn) + r * W + lane * 4, v);
  if (QUANT) {
    const float s = lantern::quantize_row4(v);
    char4 packed = make_char4((signed char)v[0], (signed char)v[1],
                              (signed char)v[2], (signed char)v[3]);
    int8_t* dst = static_cast<int8_t*>(is_v ? vb : kb) + drow * W + lane * 4;
    *reinterpret_cast<char4*>(dst) = packed;
    if (lane == 0) (is_v ? vsc : ksc)[drow] = s;
  } else {
    __nv_bfloat16* dst =
        static_cast<__nv_bfloat16*>(is_v ? vb : kb) + drow * W + lane * 4;
    __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    reinterpret_cast<__nv_bfloat162*>(dst)[0] = lo;
    reinterpret_cast<__nv_bfloat162*>(dst)[1] = hi;
  }
}

}  // namespace

LANTERN_EXPORT int lantern_kv_write(const void* k_new, const void* v_new,
                                    void* k_buf, void* v_buf, void* k_scale,
                                    void* v_scale, const void* start, int L,
                                    int B, int T, int G, int S, int quantized,
                                    void* stream) {
  if (L < 1 || B < 1 || T < 1 || G < 1 || T > S)
    return (int)cudaErrorInvalidValue;
  const long long rows = (long long)L * B * T * G;
  const dim3 grid((unsigned)((rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK), 2);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const auto* kn = static_cast<const __nv_bfloat16*>(k_new);
  const auto* vn = static_cast<const __nv_bfloat16*>(v_new);
  const auto* sp = static_cast<const int*>(start);
  if (quantized)
    kv_write_kernel<true><<<grid, THREADS, 0, st>>>(
        kn, vn, k_buf, v_buf, static_cast<float*>(k_scale),
        static_cast<float*>(v_scale), sp, L, B, T, G, S);
  else
    kv_write_kernel<false><<<grid, THREADS, 0, st>>>(
        kn, vn, k_buf, v_buf, nullptr, nullptr, sp, L, B, T, G, S);
  return (int)cudaGetLastError();
}
