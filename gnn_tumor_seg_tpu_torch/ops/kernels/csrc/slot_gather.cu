// Per-slot neighbour gather over the ELL neighbour table, and its backward.
//
// Layouts (B graphs, N rows, D slots, W values a row):
//   x, grad      [B, N, W]      float32 or bfloat16
//   out, gout    [B, N, D, W]   the same type
//   nbr, rslot   [B, N, D]      int32
//   mask         [B, N, D]      float32 (> 0 on a real slot)
//
// 1. slot_gather_kernel replaces gnn_tumor_seg_tpu/ops/pallas/slot_gather.py:58
//    `_slot_gather_kernel` (launched by `_slot_gather_raw`, slot_gather.py:84):
//      out[b,v,d,:] = x[b, nbr[b,v,d], :] on a real slot, 0 on a padded one.
//    It copies bits, so the float32 and bfloat16 variants are one kernel on
//    4- and 2-byte words, bitwise equal to the plain PyTorch version.
// 2. slot_gather_bwd_kernel is the gradient (slot_gather.py:121-133). On the
//    symmetric, deduplicated table rslot[u,d] is the slot of u in row
//    v = nbr[u,d], so the transposed routing is a gather, with no scatter and
//    no atomics:
//      grad[u,:] = sum over u's real slots d of gout[v, rslot[u,d], :],
//    summed in float32 in slot order (d = 0..D-1) and stored in gout's type:
//    deterministic and bitwise equal to the plain version
//    (ops/kernels/slot_gather.py). The TPU backward fetches each peer's D
//    cotangent rows with a second forward launch and selects one with a
//    D-way compare; reading the one row through rslot moves 1/D of those
//    bytes.
//
// What bounds them on an H100: bytes, and at these widths launch latency.
// They do no arithmetic beyond the backward's one add per (u, d, w). In the
// decomposed GAT path W is the head count (1-4), so a layer's out is
// B*N*D*W*4 bytes, 9.4 MB for a training batch of 6 x 8192 rows at D=12,
// W=4 in float32: about 3 microseconds of HBM time, near a launch's cost.
// So the forward must spend few instructions a byte; the first version
// spent two 64-bit divisions by run-time values on each output word.
//
// Design: the TPU kernel's one-hot MXU matmuls over a compacted unique-row
// block (slot_gather.py:6-10) work around slow row gathers on the TPU; here
// a thread reads nbr directly. The forward gives each thread one slot: it
// reads the slot's mask and nbr once (coalesced), with the graph as
// blockIdx.y so no index needs a division, and copies the W words with code
// specialised for W = 1, 2, 4 (one aligned vector: 16 bytes at W=4 in
// float32, 8 in bfloat16) and W = 3 (a division by a constant), and a
// generic loop for other W (up to 48 in the checks): both copy the block's
// output words flat through shared-memory source offsets, so stores stay
// coalesced. The backward gives each thread one (row, w) of grad and loops
// over its slots.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxDegree = 128;
constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 16;   // backward: 16 blocks for each of the 132 SMs

__device__ __forceinline__ float load_as_float(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_as_float(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}
__device__ __forceinline__ void store_from_float(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_from_float(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as torch's .to(bfloat16)
}

// Word is uint32_t (float32) or uint16_t (bfloat16): a copy of the bits;
// a padded slot gets all-zero bits, +0.0 in both types.
template <typename Word, int W> struct VecOf;   // W words as one access
template <> struct VecOf<uint32_t, 1> { using type = uint32_t; };
template <> struct VecOf<uint32_t, 2> { using type = uint2; };
template <> struct VecOf<uint32_t, 4> { using type = uint4; };
template <> struct VecOf<uint16_t, 1> { using type = uint16_t; };
template <> struct VecOf<uint16_t, 2> { using type = uint32_t; };
template <> struct VecOf<uint16_t, 4> { using type = uint2; };

// One thread per slot (b, v, d), blockIdx.y = b: 32-bit index arithmetic
// with no division (launch_fwd checks B*N*D*W < 2^31). W = 1, 2 or 4: the
// thread copies its slot's W words as one aligned vector. Any other W (3, or
// W = 0 for the run-time `width`): the block stages its slots' source
// offsets in shared memory and copies its contiguous run of output words
// flat, so every store is coalesced.
template <typename Word, int W>
__global__ void __launch_bounds__(kThreads)
slot_gather_kernel(const Word* __restrict__ x, const int32_t* __restrict__ nbr,
                   const float* __restrict__ mask, Word* __restrict__ out,
                   int N, int D, int width) {
  const int w = W > 0 ? W : width;
  const int per_graph = N * D;
  const int j0 = blockIdx.x * kThreads;        // the block's first slot in graph b
  const int j = j0 + threadIdx.x;
  const int slot0 = blockIdx.y * per_graph;
  int src = -1;                                 // first word of the source row
  if (j < per_graph && __ldg(mask + slot0 + j) > 0.f)
    src = (blockIdx.y * N + __ldg(nbr + slot0 + j)) * w;
  if constexpr (W == 1 || W == 2 || W == 4) {
    using V = typename VecOf<Word, W>::type;
    if (j >= per_graph) return;
    V v{};
    if (src >= 0) v = __ldg(reinterpret_cast<const V*>(x + src));
    reinterpret_cast<V*>(out)[slot0 + j] = v;
  } else {
    __shared__ int srcs[kThreads];
    srcs[threadIdx.x] = src;
    __syncthreads();
    const int n = min(kThreads, per_graph - j0) * w;   // the block's words
    Word* o = out + (slot0 + j0) * w;
#pragma unroll 4
    for (int k = threadIdx.x; k < n; k += kThreads) {
      const int s = k / w;                      // a multiply-shift at W = 3
      const int sv = srcs[s];
      o[k] = sv < 0 ? Word(0) : __ldg(x + sv + (k - s * w));
    }
  }
}

template <typename T>
__global__ void slot_gather_bwd_kernel(const T* __restrict__ gout,
                                       const int32_t* __restrict__ nbr,
                                       const float* __restrict__ mask,
                                       const int32_t* __restrict__ rslot,
                                       T* __restrict__ grad, int N, int D,
                                       int W, int64_t total) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t node = i / W;                 // b * N + u
    const int w = (int)(i - node * W);
    const int64_t graph0 = node - node % N;     // b * N
    float acc = 0.f;
    for (int d = 0; d < D; ++d) {
      const int64_t off = node * D + d;
      if (!(__ldg(mask + off) > 0.f)) continue;
      const int64_t src = ((graph0 + __ldg(nbr + off)) * D + __ldg(rslot + off)) * W + w;
      acc = __fadd_rn(acc, load_as_float(gout + src));
    }
    store_from_float(grad + i, acc);
  }
}

int check_dims(int B, int N, int D, int W) {
  if (D <= 0 || D > kMaxDegree || W <= 0 || B < 0 || N < 0)
    return (int)cudaErrorInvalidValue;
  return (int)cudaSuccess;
}

unsigned blocks_for(int64_t total) {
  const int64_t want = (total + kThreads - 1) / kThreads;
  return (unsigned)(want < kMaxBlocks ? want : kMaxBlocks);
}

template <typename Word, int W>
void launch_fwd_w(const void* x, const void* nbr, const void* mask, void* out,
                  int B, int N, int D, int width, cudaStream_t s) {
  const dim3 grid((N * D + kThreads - 1) / kThreads, B);
  slot_gather_kernel<Word, W><<<grid, kThreads, 0, s>>>(
      static_cast<const Word*>(x), static_cast<const int32_t*>(nbr),
      static_cast<const float*>(mask), static_cast<Word*>(out), N, D, width);
}

template <typename Word>
int launch_fwd(const void* x, const void* nbr, const void* mask, void* out,
               int B, int N, int D, int W, void* stream) {
  const int rc = check_dims(B, N, D, W);
  if (rc != (int)cudaSuccess) return rc;
  if ((int64_t)B * N * D * W >= ((int64_t)1 << 31) || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || N == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the vector copies need x and out aligned to W words, as torch allocates
  const uintptr_t vec = (uintptr_t)W * sizeof(Word);
  const bool aligned = (reinterpret_cast<uintptr_t>(x) % vec == 0 &&
                        reinterpret_cast<uintptr_t>(out) % vec == 0);
  if (W == 1) launch_fwd_w<Word, 1>(x, nbr, mask, out, B, N, D, W, s);
  else if (W == 2 && aligned) launch_fwd_w<Word, 2>(x, nbr, mask, out, B, N, D, W, s);
  else if (W == 3) launch_fwd_w<Word, 3>(x, nbr, mask, out, B, N, D, W, s);
  else if (W == 4 && aligned) launch_fwd_w<Word, 4>(x, nbr, mask, out, B, N, D, W, s);
  else launch_fwd_w<Word, 0>(x, nbr, mask, out, B, N, D, W, s);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* gout, const void* nbr, const void* mask,
               const void* rslot, void* grad, int B, int N, int D, int W,
               void* stream) {
  const int rc = check_dims(B, N, D, W);
  if (rc != (int)cudaSuccess) return rc;
  const int64_t total = (int64_t)B * N * W;
  if (total == 0) return (int)cudaSuccess;
  slot_gather_bwd_kernel<T><<<blocks_for(total), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(gout), static_cast<const int32_t*>(nbr),
      static_cast<const float*>(mask), static_cast<const int32_t*>(rslot),
      static_cast<T*>(grad), N, D, W, total);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int gts_slot_gather_f32(const void* x, const void* nbr, const void* mask,
                        void* out, int B, int N, int D, int W, void* stream) {
  return launch_fwd<uint32_t>(x, nbr, mask, out, B, N, D, W, stream);
}

int gts_slot_gather_bf16(const void* x, const void* nbr, const void* mask,
                         void* out, int B, int N, int D, int W, void* stream) {
  return launch_fwd<uint16_t>(x, nbr, mask, out, B, N, D, W, stream);
}

int gts_slot_gather_bwd_f32(const void* gout, const void* nbr, const void* mask,
                            const void* rslot, void* grad, int B, int N, int D,
                            int W, void* stream) {
  return launch_bwd<float>(gout, nbr, mask, rslot, grad, B, N, D, W, stream);
}

int gts_slot_gather_bwd_bf16(const void* gout, const void* nbr,
                             const void* mask, const void* rslot, void* grad,
                             int B, int N, int D, int W, void* stream) {
  return launch_bwd<__nv_bfloat16>(gout, nbr, mask, rslot, grad, B, N, D, W,
                                   stream);
}

const char* gts_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
