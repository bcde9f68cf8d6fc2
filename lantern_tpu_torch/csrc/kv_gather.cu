// K4: tree-rollback gather.  In every [S, W] window of the grouped planes
// [L, B, G, S, W] (K and V), rows start + rel[j] move to rows start + j for
// j < A, in place; for an int8 cache the same rows of the [L, B, G, S] f32
// scale planes move with them, from the same clamped index.
//
// Replaces gather_write_block (lantern_tpu/ops/pallas/kv_update.py:313).
// The TPU kernel stages an aligned row window in VMEM and applies a
// permutation matmul; none of that is needed here.  Rows are moved as raw
// 16-byte chunks, so int8, bf16 and f32 planes are all byte-exact.
//
// start ([] or [B]) and rel ([A] or [B, A]) are read from device memory
// (no host sync): one start and one accepted path for every batch row, or
// one a row (the batched engine's R requests are 2R rows, each with its
// own length and path).  rel is clamped to [0, blk-1] and start to
// [0, S-blk], so no index can leave the window.
//
// Bound: HBM bytes, A rows read and written once per window (5.4 MB at the
// Lumina shape, 1.6 us at the card's rate).  What costs more than that is
// latency: a window's row addresses depend on start and rel, so each
// window pays two dependent reads (indices, then rows) before it stores.
//
// Design: a copy that pays that chain once per warp, not once per block.
// - One warp owns one (plane, batch, group) window, K and V and both scale
//   planes; a block holds 8 warps and the grid is one wave, with a
//   grid-stride loop over windows.  No block-wide barrier.
// - A warp reads start and rel once for its batch row (lane j holds row
//   j's clamped rel) and again only when a later window belongs to another
//   row; with one start and one path every window of the warp shares them.
// - Register path (A <= 32 and the rows fit RC 16-byte chunks a lane a
//   tensor): the warp loads all of its window's rows, K and V, and the
//   scales into registers, waits at __syncwarp, then stores them.  Sources
//   and destinations overlap (pads past the accepted count point anywhere
//   in the block), and the semantics are gather-all-then-write-all from
//   the original rows: one warp owns a window's rows, so the warp barrier
//   is enough.  With the whole grid in one wave, every window's loads are
//   in flight before the first stores land.
// - Shared-memory path (larger A): each warp stages its window's rows and
//   scales in its own slice of shared memory, one tensor at a time.
#include "common.cuh"

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  uint4* kb;
  uint4* vb;
  float* ksc;              // null for a bf16 or f32 cache
  float* vsc;
  const int* starts;       // [1] or [B]
  const int* rels;         // [A] or [B, A]
  int start_stride;        // 0: one start for every row; 1: one a row
  int rel_stride;          // 0: one path for every row; A: one a row
  int B, G, S, A, blk, chunks, windows;
  int stage_bytes;         // a warp's slice of shared memory (shared path)
};

__device__ __forceinline__ int clamp_rel(const Args& a, int b, int j) {
  return min(max(a.rels[(size_t)b * a.rel_stride + j], 0), a.blk - 1);
}

__device__ __forceinline__ int clamp_start(const Args& a, int b) {
  return min(max(a.starts[b * a.start_stride], 0), a.S - a.blk);
}

// the batch row whose indices window w (= (plane * B + b) * G + g) takes;
// 0 when every row shares them
__device__ __forceinline__ int row_of(const Args& a, int w) {
  return (a.start_stride | a.rel_stride) ? (w / a.G) % a.B : 0;
}

template <int RC>
__global__ void __launch_bounds__(THREADS) kv_gather_kernel(const Args a) {
  const int lane = threadIdx.x & 31;
  const int n = a.A * a.chunks;       // chunks of one tensor's A rows
  int cur = -1, start = 0, src = 0;   // row, its start, lane's rel (row j)
  for (int w = blockIdx.x * WARPS + (threadIdx.x >> 5); w < a.windows;
       w += gridDim.x * WARPS) {
    const int b = row_of(a, w);
    if (b != cur) {                   // the same for every lane of the warp
      cur = b;
      start = clamp_start(a, b);
      src = lane < a.A ? clamp_rel(a, b, lane) : 0;
    }
    const size_t row0 = (size_t)w * a.S + start;   // row `start` of window w
    uint4 kx[RC], vx[RC];
#pragma unroll
    for (int i = 0; i < RC; ++i) {
      const int c = lane + 32 * i;
      const int j = c / a.chunks;
      const int sj = __shfl_sync(FULL, src, j & 31);
      if (c < n) {
        const size_t at = (row0 + sj) * a.chunks + (c - j * a.chunks);
        kx[i] = a.kb[at];
        vx[i] = a.vb[at];
      }
    }
    const bool scaled = a.ksc != nullptr && lane < a.A;
    float ks = 0.f, vs = 0.f;
    if (scaled) {
      ks = a.ksc[row0 + src];
      vs = a.vsc[row0 + src];
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < RC; ++i) {
      const int c = lane + 32 * i;
      if (c < n) {
        a.kb[row0 * a.chunks + c] = kx[i];
        a.vb[row0 * a.chunks + c] = vx[i];
      }
    }
    if (scaled) {
      a.ksc[row0 + lane] = ks;
      a.vsc[row0 + lane] = vs;
    }
  }
}

// the shared-memory path, blockDim.x / 32 warps a block
__global__ void __launch_bounds__(THREADS) kv_gather_shared_kernel(
    const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wpb = blockDim.x >> 5;
  uint4* rows = reinterpret_cast<uint4*>(smem + (size_t)warp * a.stage_bytes);
  float* scl = reinterpret_cast<float*>(rows + (size_t)a.A * a.chunks);
  const int n = a.A * a.chunks;
  for (int w = blockIdx.x * wpb + warp; w < a.windows; w += gridDim.x * wpb) {
    const int b = row_of(a, w);
    const size_t row0 = (size_t)w * a.S + clamp_start(a, b);
    for (int x = 0; x < 2; ++x) {
      uint4* buf = x ? a.vb : a.kb;
      float* sc = x ? a.vsc : a.ksc;
      for (int c = lane; c < n; c += 32) {
        const int j = c / a.chunks;
        rows[c] = buf[(row0 + clamp_rel(a, b, j)) * a.chunks +
                      (c - j * a.chunks)];
      }
      if (sc != nullptr)
        for (int j = lane; j < a.A; j += 32)
          scl[j] = sc[row0 + clamp_rel(a, b, j)];
      __syncwarp();
      for (int c = lane; c < n; c += 32) buf[row0 * a.chunks + c] = rows[c];
      if (sc != nullptr)
        for (int j = lane; j < a.A; j += 32) sc[row0 + j] = scl[j];
      __syncwarp();                 // the slice is refilled next
    }
  }
}

template <int RC>
int launch(const Args& a, cudaStream_t st) {
  static int cache[lantern::MAX_DEVICES] = {0};
  int wave = 0;
  const cudaError_t e =
      lantern::wave_blocks(kv_gather_kernel<RC>, THREADS, 0, cache, &wave);
  if (e != cudaSuccess) return (int)e;
  const int need = (a.windows + WARPS - 1) / WARPS;
  kv_gather_kernel<RC><<<need < wave ? need : wave, THREADS, 0, st>>>(a);
  return (int)cudaGetLastError();
}

int launch_shared(const Args& a, cudaStream_t st) {
  int dev = 0, max_smem = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  if (a.stage_bytes > max_smem) return (int)cudaErrorInvalidValue;
  const int wpb = max_smem / a.stage_bytes < WARPS
                      ? max_smem / a.stage_bytes : WARPS;
  const size_t smem = (size_t)wpb * a.stage_bytes;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kv_gather_shared_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  int wave = 0;
  e = lantern::wave_blocks(kv_gather_shared_kernel, wpb * 32, smem, nullptr,
                           &wave);
  if (e != cudaSuccess) return (int)e;
  const int need = (a.windows + wpb - 1) / wpb;
  kv_gather_shared_kernel<<<need < wave ? need : wave, wpb * 32, smem, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// planes: L; starts: int32, one for every batch row (start_stride 0) or
// one a row (1); rels: int32 [A] (rel_stride 0) or [B, A] (rel_stride A);
// row_bytes: W * element size, a multiple of 16; staging: 16-byte chunks a
// lane holds per tensor (1, 2, 4 or 8: the register path, A <= 32), or 0
// for the shared-memory path
LANTERN_EXPORT int lantern_kv_gather(void* k_buf, void* v_buf, void* k_scale,
                                     void* v_scale, const void* starts,
                                     int start_stride, const void* rels,
                                     int rel_stride, int planes, int B,
                                     int G, int S, int A, int blk,
                                     int row_bytes, int staging,
                                     void* stream) {
  if (planes < 1 || B < 1 || G < 1 || A < 1 || A > blk || blk > S ||
      row_bytes < 16 || row_bytes % 16 ||
      (start_stride != 0 && start_stride != 1) ||
      (rel_stride != 0 && rel_stride != A))
    return (int)cudaErrorInvalidValue;
  const long long windows = (long long)planes * B * G;
  if (windows > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  Args a;
  a.kb = static_cast<uint4*>(k_buf);
  a.vb = static_cast<uint4*>(v_buf);
  a.ksc = static_cast<float*>(k_scale);
  a.vsc = static_cast<float*>(v_scale);
  a.starts = static_cast<const int*>(starts);
  a.rels = static_cast<const int*>(rels);
  a.start_stride = start_stride;
  a.rel_stride = rel_stride;
  a.B = B;
  a.G = G;
  a.S = S;
  a.A = A;
  a.blk = blk;
  a.chunks = row_bytes / 16;
  a.windows = (int)windows;
  const long long stage = ((long long)A * (row_bytes + 4) + 15) / 16 * 16;
  a.stage_bytes = stage > 0x7fffffffLL ? 0x7fffffff : (int)stage;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (staging > 0 && (A > 32 || (long long)A * a.chunks > 32LL * staging))
    return (int)cudaErrorInvalidValue;
  switch (staging) {
    case 0: return launch_shared(a, st);
    case 1: return launch<1>(a, st);
    case 2: return launch<2>(a, st);
    case 4: return launch<4>(a, st);
    case 8: return launch<8>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
