// Python bindings of the port's kernels.  Each kernel file exposes a plain C
// launcher that returns the cudaError_t of its launch; these functions take
// the tensors the Python wrappers have already checked, pass their pointers
// and the current stream, and raise on a failed launch.
#include <c10/cuda/CUDAStream.h>
#include <cuda_runtime.h>
#include <torch/extension.h>

extern "C" {
int lantern_int8_matmul(const void* x, const void* q, const void* s, void* out,
                        void* part, void* tickets, int M, int K, int N,
                        int nsplit, int out_f32, void* stream);
int lantern_tree_attention(const void* q, const void* k_new, const void* v_new,
                           const void* k_cache, const void* v_cache,
                           const void* k_scale, const void* v_scale,
                           const void* length, int length_stride,
                           const void* mask, const void* wmask,
                           const void* bias, void* out,
                           void* part, void* tickets, int B, int T, int G,
                           int S, int window, int rows, int heads, int rep,
                           int nsplit, int quantized, float scale,
                           void* stream);
int lantern_kv_write(const void* k_new, const void* v_new, void* k_buf,
                     void* v_buf, void* k_scale, void* v_scale,
                     const void* starts, int start_stride, int L, int B,
                     int T, int G, int S, int quantized, void* stream);
int lantern_kv_gather(void* k_buf, void* v_buf, void* k_scale, void* v_scale,
                      const void* starts, int start_stride, const void* rels,
                      int rel_stride, int planes, int B, int G, int S, int A,
                      int blk, int row_bytes, int staging, void* stream);
}

namespace {

void check(int rc, const char* kernel) {
  TORCH_CHECK(rc == 0, "lantern_tpu_torch: ", kernel, " launch failed: ",
              cudaGetErrorString(static_cast<cudaError_t>(rc)),
              " (cudaError ", rc, ")");
}

void* stream_of(const at::Tensor& t) {
  return c10::cuda::getCurrentCUDAStream(t.get_device()).stream();
}

void* ptr(const c10::optional<at::Tensor>& t) {
  return t.has_value() ? t->data_ptr() : nullptr;
}

// out[M, N] = (x[M, K] @ q[K, N]) * s[N]; when nsplit > 1 part holds the k
// splits' f32 partials [nsplit, M, N] and tickets (int32, zero between
// launches) one counter per 128-column tile
void int8_matmul(const at::Tensor& x, const at::Tensor& q, const at::Tensor& s,
                 at::Tensor& out, const c10::optional<at::Tensor>& part,
                 const c10::optional<at::Tensor>& tickets, int64_t nsplit) {
  check(lantern_int8_matmul(x.data_ptr(), q.data_ptr(), s.data_ptr(),
                            out.data_ptr(), ptr(part), ptr(tickets), x.size(0),
                            x.size(1), q.size(1), nsplit,
                            out.scalar_type() == at::kFloat, stream_of(x)),
        "int8_matmul");
}

// k_new/v_new [B, T, nkv, hd] with nkv * hd = G * 128 (one KV head of 128
// or two of 64 a group); q/out [B, T, nh, hd], nh a multiple of nkv (GQA:
// rep = nh / nkv query heads a KV head); caches [B, G, S, 128]; when
// nsplit > 1 part holds the per-split partials and tickets (int32, zero
// between launches) one counter per (b, g, row tile of `rows` folded query
// rows, T * rep of them); wmask [B, T, window]
// (or none) is the visibility of cache rows [length, length + window);
// length int32 [1] (every batch row) or [B] (one a row)
void tree_attention(const at::Tensor& q, const at::Tensor& k_new,
                    const at::Tensor& v_new, const at::Tensor& k_cache,
                    const at::Tensor& v_cache,
                    const c10::optional<at::Tensor>& k_scale,
                    const c10::optional<at::Tensor>& v_scale,
                    const at::Tensor& length, const at::Tensor& mask,
                    const c10::optional<at::Tensor>& wmask,
                    const at::Tensor& bias, at::Tensor& out,
                    const c10::optional<at::Tensor>& part,
                    const c10::optional<at::Tensor>& tickets, int64_t rows,
                    int64_t nsplit, double scale) {
  check(lantern_tree_attention(
            q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
            k_cache.data_ptr(), v_cache.data_ptr(), ptr(k_scale),
            ptr(v_scale), length.data_ptr(), length.numel() == 1 ? 0 : 1,
            mask.data_ptr(), ptr(wmask),
            bias.data_ptr(), out.data_ptr(), ptr(part), ptr(tickets),
            q.size(0), q.size(1),
            k_cache.size(1), k_cache.size(2),
            wmask.has_value() ? wmask->size(2) : 0, rows,
            k_new.size(2) / k_cache.size(1), q.size(2) / k_new.size(2),
            nsplit,
            k_scale.has_value(),
            static_cast<float>(scale), stream_of(q)),
        "tree_attention");
}

// k_new/v_new [L, B, T, n_kv, hd]; planes [L, B, G, S, 128]; starts int32
// [1] (every batch row) or [B] (one a row); in place
void kv_write(const at::Tensor& k_new, const at::Tensor& v_new,
              at::Tensor& k_buf, at::Tensor& v_buf,
              const c10::optional<at::Tensor>& k_scale,
              const c10::optional<at::Tensor>& v_scale,
              const at::Tensor& starts) {
  check(lantern_kv_write(k_new.data_ptr(), v_new.data_ptr(), k_buf.data_ptr(),
                         v_buf.data_ptr(), ptr(k_scale), ptr(v_scale),
                         starts.data_ptr(), starts.numel() == 1 ? 0 : 1,
                         k_buf.size(0), k_buf.size(1),
                         k_new.size(2), k_buf.size(2), k_buf.size(3),
                         k_scale.has_value(), stream_of(k_buf)),
        "kv_write");
}

// planes [L, B, G, S, W] (any of int8, bf16, f32); starts int32 [1] or
// [B]; rels int32 [A] or [B, A] (one start and path for every batch row, or
// one a row); staging: 16-byte chunks a lane holds per tensor, or 0 for
// the shared-memory path (kv.k4_staging); in place
void kv_gather(at::Tensor& k_buf, at::Tensor& v_buf,
               const c10::optional<at::Tensor>& k_scale,
               const c10::optional<at::Tensor>& v_scale,
               const at::Tensor& starts, const at::Tensor& rels, int64_t blk,
               int64_t staging) {
  check(lantern_kv_gather(
            k_buf.data_ptr(), v_buf.data_ptr(), ptr(k_scale), ptr(v_scale),
            starts.data_ptr(), starts.numel() == 1 ? 0 : 1, rels.data_ptr(),
            rels.dim() == 1 ? 0 : static_cast<int>(rels.size(1)),
            k_buf.size(0), k_buf.size(1), k_buf.size(2), k_buf.size(3),
            rels.size(-1), blk,
            k_buf.size(4) * k_buf.element_size(), staging, stream_of(k_buf)),
        "kv_gather");
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("int8_matmul", &int8_matmul);
  m.def("tree_attention", &tree_attention);
  m.def("kv_write", &kv_write);
  m.def("kv_gather", &kv_gather);
}
