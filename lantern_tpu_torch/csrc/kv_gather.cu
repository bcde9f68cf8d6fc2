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
// Bound: HBM bytes (A rows read and written once per window: ~5 MB at the
// Lumina shape), far below the launch overhead, so the kernel is
// launch-bound.  Design: one thread block per (plane, batch, group) window
// and tensor (grid.y selects K or V); the block loads the A source rows
// (and scales) into shared memory, waits at a barrier, then stores them to
// rows start .. start+A-1.  Sources and destinations overlap (pads past the
// accepted count point anywhere in the block), and the semantics are
// gather-all-then-write-all from the original buffer: because one block
// owns a window's rows, the barrier is enough.
//
// start [R] and rel [R, A] are read from device memory (no host sync):
// slot r owns planes [r * L / R, (r + 1) * L / R).  rel is clamped to
// [0, blk-1] and start to [0, S-blk], so no index can leave the window.
#include "common.cuh"

namespace {

constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
kv_gather_kernel(void* __restrict__ kb, void* __restrict__ vb,
                 float* __restrict__ ksc, float* __restrict__ vsc,
                 const int* __restrict__ starts, const int* __restrict__ rels,
                 int planes_per_start, int BG, int S, int A, int blk,
                 int chunks) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint4* rows = reinterpret_cast<uint4*>(smem_raw);            // [A][chunks]
  float* scl = reinterpret_cast<float*>(rows + (size_t)A * chunks);  // [A]
  const bool is_v = blockIdx.y == 1;
  const long long window = blockIdx.x;             // (plane * B + b) * G + g
  const int r = (int)(window / BG) / planes_per_start;
  const int start = min(max(starts[r], 0), S - blk);
  const int* rel = rels + (size_t)r * A;
  uint4* base = reinterpret_cast<uint4*>(is_v ? vb : kb) +
                ((size_t)window * S + start) * chunks;
  float* sbase = (is_v ? vsc : ksc);
  const int n = A * chunks;
  for (int i = threadIdx.x; i < n; i += THREADS) {
    const int j = i / chunks, c = i - j * chunks;
    const int src = min(max(rel[j], 0), blk - 1);
    rows[i] = base[(size_t)src * chunks + c];
  }
  if (sbase != nullptr) {
    sbase += (size_t)window * S + start;
    for (int j = threadIdx.x; j < A; j += THREADS)
      scl[j] = sbase[min(max(rel[j], 0), blk - 1)];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n; i += THREADS) base[i] = rows[i];
  if (sbase != nullptr)
    for (int j = threadIdx.x; j < A; j += THREADS) sbase[j] = scl[j];
}

}  // namespace

// planes: L (= R * layers); row_bytes: W * element size, a multiple of 16
LANTERN_EXPORT int lantern_kv_gather(void* k_buf, void* v_buf, void* k_scale,
                                     void* v_scale, const void* starts,
                                     const void* rels, int planes, int B,
                                     int G, int S, int R, int A, int blk,
                                     int row_bytes, void* stream) {
  if (planes < 1 || B < 1 || G < 1 || R < 1 || planes % R || A < 1 ||
      A > blk || blk > S || row_bytes < 16 || row_bytes % 16)
    return (int)cudaErrorInvalidValue;
  const int chunks = row_bytes / 16;
  const size_t smem = (size_t)A * (row_bytes + sizeof(float));
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const long long windows = (long long)planes * B * G;
  if (windows > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)windows, 2);
  kv_gather_kernel<<<grid, THREADS, smem,
                     reinterpret_cast<cudaStream_t>(stream)>>>(
      k_buf, v_buf, static_cast<float*>(k_scale), static_cast<float*>(v_scale),
      static_cast<const int*>(starts), static_cast<const int*>(rels),
      planes / R, B * G, S, A, blk, chunks);
  return (int)cudaGetLastError();
}
