// Max aggregation over the ELL neighbour table, with first-winner slots, and
// its backward.
//
// Forward replaces the TPU kernel gnn_tumor_seg_tpu/ops/pallas/gather_agg.py:135
// `_max_kernel` (launched by `tiled_aggregate_max_fwd`, gather_agg.py:166/174).
//
//   out[b,v,f] = max over slots d with mask[b,v,d] > 0 of h[b, nbr[b,v,d], f],
//                0 where row v has no real slot;
//   arg[b,v,f] = the first slot d that attains that max (strict `>` against a
//                running best that starts at -1e30, as gather_agg.py:146-160).
//
// h is float32 or bfloat16 and `out` has h's type; `arg` is uint8 (D <= 128).
// Max selects and does no arithmetic, so the result is bitwise equal to the
// plain PyTorch version (ops/kernels/max_agg.py:max_aggregate_plain).
//
// Backward replaces gather_agg.py:200 `_max_bwd_kernel` (launched by
// `tiled_max_backward`, gather_agg.py:238). On the symmetric, deduplicated
// table each edge u -> v is stored at both ends, and rslot[u,d] is the slot
// of u in row v = nbr[u,d]. The gradient is then a gather, with no scatter
// and no atomics:
//
//   grad[b,u,f] = sum over slots d of u with mask[b,u,d] > 0 and
//                 arg[b,v,f] == rslot[b,u,d] of gout[b,v,f],  v = nbr[b,u,d],
//
// summed in float32 in slot order d = 0..D-1 and stored in gout's type, so
// it is deterministic and bitwise equal to max_aggregate_backward_plain.
//
// What bounds both on an H100: bytes. They do one compare (and, backward,
// one add) per (v, d, f), far below the card's operation rate. Forward
// traffic is h read once (for a full-size brain's node bucket, 12288 x 256 x
// 4 B = 12.6 MB, which fits the 50 MB L2, so the D-fold re-reads of
// neighbour rows mostly hit L2), plus nbr and mask (N x D x 4 B each), plus
// out (N x F) and, when it is stored, arg (N x F bytes). Backward reads gout
// and arg once (B x N x F x (4 + 1) B: 50 MB of gout alone for a training
// batch of 6 x 8192 nodes at F=256 in f32, the size of the whole L2, so its
// D-fold re-reads partly come from HBM), nbr, mask and rslot (3 x N x D x 4
// B) and writes grad.
//
// Design (first, simple version): one block per (batch, tile of destination
// rows); threads run along F so each neighbour row is read with coalesced
// loads; the block stages its rows' neighbour indices (padded slots as -1)
// and, backward, their rslot entries in shared memory once, so the inner
// loop over D reads only h (gout and arg). The running max and slot, or the
// running sum, stay in registers. Tails of N and F are masked. The serve
// path discards `arg`, so a template flag drops its store there. Left for a
// later change: vector loads, cp.async/TMA staging of nbr, persistent blocks.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegLarge = -1e30f;
constexpr int kMaxDegree = 128;
constexpr int kThreadsPerBlock = 256;

__device__ __forceinline__ float load_as_float(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_as_float(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}
__device__ __forceinline__ void store_from_float(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_from_float(__nv_bfloat16* p, float v) {
  // round to nearest even; exact for the forward, whose v is 0 or read from bf16
  *p = __float2bfloat16(v);
}

template <typename T, bool kStoreArg>
__global__ void max_agg_kernel(const T* __restrict__ h,
                               const int32_t* __restrict__ nbr,
                               const float* __restrict__ mask,
                               T* __restrict__ out, uint8_t* __restrict__ arg,
                               int N, int D, int F) {
  extern __shared__ int32_t slots[];  // [blockDim.y, D]: source row or -1
  const int b = blockIdx.y;
  const int row0 = blockIdx.x * blockDim.y;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int n_threads = blockDim.x * blockDim.y;
  for (int i = tid; i < blockDim.y * D; i += n_threads) {
    const int r = row0 + i / D;
    int32_t s = -1;
    if (r < N) {
      const int64_t off = ((int64_t)b * N + r) * D + i % D;
      if (mask[off] > 0.f) s = nbr[off];
    }
    slots[i] = s;
  }
  __syncthreads();

  const int r = row0 + threadIdx.y;
  if (r >= N) return;
  const int32_t* row_slots = slots + threadIdx.y * D;
  const T* hb = h + (int64_t)b * N * F;
  const int64_t o = ((int64_t)b * N + r) * F;
  for (int f = threadIdx.x; f < F; f += blockDim.x) {
    float best = kNegLarge;
    int win = 0;
    bool any = false;
    for (int d = 0; d < D; ++d) {
      const int32_t u = row_slots[d];
      if (u < 0) continue;
      any = true;
      const float v = load_as_float(hb + (int64_t)u * F + f);
      if (v > best) {
        best = v;
        win = d;
      }
    }
    store_from_float(out + o + f, any ? best : 0.f);
    if (kStoreArg) arg[o + f] = (uint8_t)win;
  }
}

template <typename T>
__global__ void max_agg_bwd_kernel(const T* __restrict__ gout,
                                   const uint8_t* __restrict__ arg,
                                   const int32_t* __restrict__ nbr,
                                   const float* __restrict__ mask,
                                   const int32_t* __restrict__ rslot,
                                   T* __restrict__ grad, int N, int D, int F) {
  // [blockDim.y, D] source rows (or -1), then [blockDim.y, D] rslot
  extern __shared__ int32_t slots[];
  int32_t* rslots = slots + blockDim.y * D;
  const int b = blockIdx.y;
  const int row0 = blockIdx.x * blockDim.y;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int n_threads = blockDim.x * blockDim.y;
  for (int i = tid; i < blockDim.y * D; i += n_threads) {
    const int r = row0 + i / D;
    int32_t s = -1, j = 0;
    if (r < N) {
      const int64_t off = ((int64_t)b * N + r) * D + i % D;
      if (mask[off] > 0.f) {
        s = nbr[off];
        j = rslot[off];
      }
    }
    slots[i] = s;
    rslots[i] = j;
  }
  __syncthreads();

  const int r = row0 + threadIdx.y;
  if (r >= N) return;
  const int32_t* row_slots = slots + threadIdx.y * D;
  const int32_t* row_rslots = rslots + threadIdx.y * D;
  const T* gb = gout + (int64_t)b * N * F;
  const uint8_t* ab = arg + (int64_t)b * N * F;
  const int64_t o = ((int64_t)b * N + r) * F;
  for (int f = threadIdx.x; f < F; f += blockDim.x) {
    float acc = 0.f;
    for (int d = 0; d < D; ++d) {
      const int32_t v = row_slots[d];
      if (v < 0) continue;
      const int64_t src = (int64_t)v * F + f;
      if ((int32_t)__ldg(ab + src) == row_rslots[d]) acc += load_as_float(gb + src);
    }
    store_from_float(grad + o + f, acc);
  }
}

// threads along F: a warp per row at F <= 32 (F=20 on the first GSpool
// layer), up to 128 lanes at wide F; the rest of the block takes more rows
dim3 block_for(int F) {
  const int bx = F >= 128 ? 128 : ((F + 31) / 32) * 32;
  return dim3(bx, kThreadsPerBlock / bx);
}

template <typename T>
int launch(const void* h, const void* nbr, const void* mask, void* out,
           void* arg, int B, int N, int D, int F, int store_arg,
           void* stream) {
  if (B <= 0 || N <= 0 || F <= 0) return (int)cudaSuccess;
  if (D <= 0 || D > kMaxDegree) return (int)cudaErrorInvalidValue;
  const dim3 block = block_for(F);
  const dim3 grid((N + block.y - 1) / block.y, B);
  const size_t smem = (size_t)block.y * D * sizeof(int32_t);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (store_arg) {
    max_agg_kernel<T, true><<<grid, block, smem, s>>>(
        static_cast<const T*>(h), static_cast<const int32_t*>(nbr),
        static_cast<const float*>(mask), static_cast<T*>(out),
        static_cast<uint8_t*>(arg), N, D, F);
  } else {
    max_agg_kernel<T, false><<<grid, block, smem, s>>>(
        static_cast<const T*>(h), static_cast<const int32_t*>(nbr),
        static_cast<const float*>(mask), static_cast<T*>(out), nullptr, N, D,
        F);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* gout, const void* arg, const void* nbr,
               const void* mask, const void* rslot, void* grad, int B, int N,
               int D, int F, void* stream) {
  if (B <= 0 || N <= 0 || F <= 0) return (int)cudaSuccess;
  if (D <= 0 || D > kMaxDegree) return (int)cudaErrorInvalidValue;
  const dim3 block = block_for(F);
  const dim3 grid((N + block.y - 1) / block.y, B);
  const size_t smem = (size_t)2 * block.y * D * sizeof(int32_t);
  max_agg_bwd_kernel<T><<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(gout), static_cast<const uint8_t*>(arg),
      static_cast<const int32_t*>(nbr), static_cast<const float*>(mask),
      static_cast<const int32_t*>(rslot), static_cast<T*>(grad), N, D, F);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int gts_max_agg_f32(const void* h, const void* nbr, const void* mask,
                    void* out, void* arg, int B, int N, int D, int F,
                    int store_arg, void* stream) {
  return launch<float>(h, nbr, mask, out, arg, B, N, D, F, store_arg, stream);
}

int gts_max_agg_bf16(const void* h, const void* nbr, const void* mask,
                     void* out, void* arg, int B, int N, int D, int F,
                     int store_arg, void* stream) {
  return launch<__nv_bfloat16>(h, nbr, mask, out, arg, B, N, D, F, store_arg,
                               stream);
}

int gts_max_agg_bwd_f32(const void* gout, const void* arg, const void* nbr,
                        const void* mask, const void* rslot, void* grad, int B,
                        int N, int D, int F, void* stream) {
  return launch_bwd<float>(gout, arg, nbr, mask, rslot, grad, B, N, D, F,
                           stream);
}

int gts_max_agg_bwd_bf16(const void* gout, const void* arg, const void* nbr,
                         const void* mask, const void* rslot, void* grad,
                         int B, int N, int D, int F, void* stream) {
  return launch_bwd<__nv_bfloat16>(gout, arg, nbr, mask, rslot, grad, B, N, D,
                                   F, stream);
}

const char* gts_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
