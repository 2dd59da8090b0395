// Sum and mean aggregation over the ELL neighbour table.
//
// Replaces the TPU kernel gnn_tumor_seg_tpu/ops/pallas/gather_agg.py:68
// `_sum_kernel` (launched by `tiled_aggregate`, gather_agg.py:95).
//
//   out[b,v,f] = sum over slots d with mask[b,v,d] > 0 of h[b, nbr[b,v,d], f],
//   mean:        that sum / max(deg, 1), deg = the number of real slots of v,
//
// summed in float32 in slot order d = 0..D-1 and stored in h's type (float32
// or bfloat16), so it is deterministic and bitwise equal to the plain
// PyTorch version (ops/kernels/sum_agg.py:sum_aggregate_plain). On the
// symmetric table this kernel is also its own backward (gather_agg.py:295-304):
// grad_h = sum over the same table of gout, for mean of gout / max(deg, 1).
//
// What bounds it on an H100: bytes. It does one add per (v, d, f). Compulsory
// traffic is h read once (B x N x F, 50 MB for a training batch of 6 x 8192
// nodes at F=256 in f32, the size of the whole L2, so the D-fold re-reads of
// neighbour rows partly come from HBM), nbr and mask (N x D x 4 B each) and
// out written once.
//
// Design (first, simple version, the layout of max_agg.cu): one block per
// (batch, tile of destination rows); threads run along F so each neighbour
// row is read with coalesced loads; the block stages its rows' neighbour
// indices in shared memory once (padded slots as -1); the running sum and
// the real-slot count stay in registers. Tails of N and F are masked. Left
// for a later change: vector loads, more rows per block, persistent blocks.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxDegree = 128;
constexpr int kThreadsPerBlock = 256;

__device__ __forceinline__ float load_as_float(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_as_float(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}
__device__ __forceinline__ void store_from_float(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_from_float(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even
}

template <typename T, bool kMean>
__global__ void sum_agg_kernel(const T* __restrict__ h,
                               const int32_t* __restrict__ nbr,
                               const float* __restrict__ mask,
                               T* __restrict__ out, int N, int D, int F) {
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
    float acc = 0.f;
    int deg = 0;
    for (int d = 0; d < D; ++d) {
      const int32_t u = row_slots[d];
      if (u < 0) continue;
      ++deg;
      acc += load_as_float(hb + (int64_t)u * F + f);
    }
    if (kMean) acc = acc / (float)(deg > 1 ? deg : 1);
    store_from_float(out + o + f, acc);
  }
}

template <typename T>
int launch(const void* h, const void* nbr, const void* mask, void* out, int B,
           int N, int D, int F, int mean, void* stream) {
  if (B <= 0 || N <= 0 || F <= 0) return (int)cudaSuccess;
  if (D <= 0 || D > kMaxDegree) return (int)cudaErrorInvalidValue;
  // threads along F: a warp per row at F <= 32 (F=20 on the first layer), up
  // to 128 lanes at wide F; the rest of the block takes more rows
  const int bx = F >= 128 ? 128 : ((F + 31) / 32) * 32;
  const int by = kThreadsPerBlock / bx;
  const dim3 block(bx, by);
  const dim3 grid((N + by - 1) / by, B);
  const size_t smem = (size_t)by * D * sizeof(int32_t);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mean) {
    sum_agg_kernel<T, true><<<grid, block, smem, s>>>(
        static_cast<const T*>(h), static_cast<const int32_t*>(nbr),
        static_cast<const float*>(mask), static_cast<T*>(out), N, D, F);
  } else {
    sum_agg_kernel<T, false><<<grid, block, smem, s>>>(
        static_cast<const T*>(h), static_cast<const int32_t*>(nbr),
        static_cast<const float*>(mask), static_cast<T*>(out), N, D, F);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int gts_sum_agg_f32(const void* h, const void* nbr, const void* mask, void* out,
                    int B, int N, int D, int F, int mean, void* stream) {
  return launch<float>(h, nbr, mask, out, B, N, D, F, mean, stream);
}

int gts_sum_agg_bf16(const void* h, const void* nbr, const void* mask,
                     void* out, int B, int N, int D, int F, int mean,
                     void* stream) {
  return launch<__nv_bfloat16>(h, nbr, mask, out, B, N, D, F, mean, stream);
}

const char* gts_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
