// K1: W8A16 dequant-matmul  out[M, N] = (x[M, K] @ q[K, N]) * s[N].
//
// Replaces int8_matmul_pallas (lantern_tpu/ops/quant.py:73): bf16
// activations, int8 weights with one f32 scale per output channel, f32
// accumulation, the scale applied once at the end.
//
// Bound: decode forwards have M <= 64 rows (2 for AR, 2 x tree rows for
// verification), so the product streams K*N weight bytes for at most 128
// operations per byte: at M = 2 it is bound by HBM bytes, at M = 64 the
// work per byte nears what CUDA cores can do, hence the tensor cores.
//
// Design (simple first): each thread block owns BN = 32 output columns for
// all M rows.  It walks K in stages of KC = 128 rows: the x stage (M rows,
// zero-padded to 16-row tiles) and the int8 weight stage are read with
// 16-byte coalesced loads into registers one stage ahead, and the weights
// are converted to bf16 (exact for int8) on their way into shared memory.
// Four warps split each stage's k16 chunks and run bf16 wmma 16x16x16
// products into f32 fragments; the warps' partial sums are added in a
// fixed order at the end.  A row's
// result therefore depends on neither M nor the other rows, so a token
// computed inside a 64-row tree forward equals its AR computation.
#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int BN = 32;        // output columns per block
constexpr int KC = 128;       // contraction rows per shared-memory stage
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int XLD = KC + 8;   // padded leading dims (elements, multiples of 8)
constexpr int WLD = BN + 8;
constexpr int MAX_ROWS = 64;
constexpr int SMEM_BYTES = WARPS * MAX_ROWS * BN * 4;   // >= xs + ws stages
static_assert(MAX_ROWS * XLD * 2 + KC * WLD * 2 <= SMEM_BYTES,
              "stages must fit under the reduction buffer");

template <int MT>   // 16-row tiles: ceil(M / 16)
__global__ void __launch_bounds__(THREADS)
int8_matmul_kernel(const __nv_bfloat16* __restrict__ x,
                   const int8_t* __restrict__ q, const float* __restrict__ s,
                   void* __restrict__ out, int M, int K, int N, int out_f32) {
  constexpr int MP = MT * 16;
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem + MP * XLD * 2);
  float* red = reinterpret_cast<float*>(smem);

  const int n0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MT][BN / 16];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < BN / 16; ++nt) wmma::fill_fragment(acc[mt][nt], 0.f);

  // stage loads go through registers so that the next stage's global
  // loads are in flight while the tensor cores work on the current one
  constexpr int XCH = MP * (KC / 8) / THREADS;   // 16-byte x chunks / thread
  constexpr int WCH = KC * (BN / 16) / THREADS;  // 16-byte weight chunks
  uint4 xr[XCH];
  int4 wr[WCH];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < XCH; ++i) {
      const int c = tid + i * THREADS;
      const int r = c / (KC / 8), kk = (c % (KC / 8)) * 8;
      xr[i] = make_uint4(0u, 0u, 0u, 0u);
      if (r < M && k0 + kk < K)
        xr[i] = *reinterpret_cast<const uint4*>(x + (size_t)r * K + k0 + kk);
    }
#pragma unroll
    for (int i = 0; i < WCH; ++i) {
      const int c = tid + i * THREADS;
      const int r = c / (BN / 16), nn = (c % (BN / 16)) * 16;
      wr[i] = make_int4(0, 0, 0, 0);
      if (k0 + r < K && n0 + nn < N)
        wr[i] = *reinterpret_cast<const int4*>(q + (size_t)(k0 + r) * N + n0 + nn);
    }
  };
  auto stash = [&]() {
#pragma unroll
    for (int i = 0; i < XCH; ++i) {
      const int c = tid + i * THREADS;
      const int r = c / (KC / 8), kk = (c % (KC / 8)) * 8;
      *reinterpret_cast<uint4*>(xs + r * XLD + kk) = xr[i];
    }
#pragma unroll
    for (int i = 0; i < WCH; ++i) {
      const int c = tid + i * THREADS;
      const int r = c / (BN / 16), nn = (c % (BN / 16)) * 16;
      const int8_t* b8 = reinterpret_cast<const int8_t*>(&wr[i]);
      __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(ws + r * WLD + nn);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        dst[j] = __floats2bfloat162_rn((float)b8[2 * j], (float)b8[2 * j + 1]);
    }
  };

  fetch(0);
  for (int k0 = 0; k0 < K; k0 += KC) {
    stash();          // x rows (pad rows 0) and bf16-converted weights
    __syncthreads();
    if (k0 + KC < K) fetch(k0 + KC);
    for (int kc = warp; kc < KC / 16; kc += WARPS) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>
          bf[BN / 16];
#pragma unroll
      for (int nt = 0; nt < BN / 16; ++nt)
        wmma::load_matrix_sync(bf[nt], ws + kc * 16 * WLD + nt * 16, WLD);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> af;
        wmma::load_matrix_sync(af, xs + mt * 16 * XLD + kc * 16, XLD);
#pragma unroll
        for (int nt = 0; nt < BN / 16; ++nt)
          wmma::mma_sync(acc[mt][nt], af, bf[nt], acc[mt][nt]);
      }
    }
    __syncthreads();
  }

  // per-warp partial sums -> shared memory (aliases the stages)
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < BN / 16; ++nt)
      wmma::store_matrix_sync(red + (warp * MP + mt * 16) * BN + nt * 16,
                              acc[mt][nt], BN, wmma::mem_row_major);
  __syncthreads();
  for (int i = tid; i < M * BN; i += THREADS) {
    const int r = i / BN, c = i % BN, n = n0 + c;
    if (n >= N) continue;
    float v = red[r * BN + c];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) v += red[(w * MP + r) * BN + c];
    v *= s[n];
    if (out_f32)
      reinterpret_cast<float*>(out)[(size_t)r * N + n] = v;
    else
      reinterpret_cast<__nv_bfloat16*>(out)[(size_t)r * N + n] =
          __float2bfloat16(v);
  }
}

}  // namespace

LANTERN_EXPORT int lantern_int8_matmul(const void* x, const void* q,
                                       const void* s, void* out, int M, int K,
                                       int N, int out_f32, void* stream) {
  if (M < 1 || M > MAX_ROWS || K < 1 || N < 1 || K % 8 || N % 16)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + BN - 1) / BN);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* qb = static_cast<const int8_t*>(q);
  const auto* sb = static_cast<const float*>(s);
  switch ((M + 15) / 16) {
    case 1: int8_matmul_kernel<1><<<grid, THREADS, 0, st>>>(xb, qb, sb, out, M, K, N, out_f32); break;
    case 2: int8_matmul_kernel<2><<<grid, THREADS, 0, st>>>(xb, qb, sb, out, M, K, N, out_f32); break;
    case 3: int8_matmul_kernel<3><<<grid, THREADS, 0, st>>>(xb, qb, sb, out, M, K, N, out_f32); break;
    default: int8_matmul_kernel<4><<<grid, THREADS, 0, st>>>(xb, qb, sb, out, M, K, N, out_f32); break;
  }
  return (int)cudaGetLastError();
}
