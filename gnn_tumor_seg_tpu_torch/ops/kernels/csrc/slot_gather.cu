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
// The backward reads the three tables (mask, nbr, rslot: 7.1 MB for that
// batch) and gout at the real slots, so at W=1 its bytes are mostly the
// tables'. So both must spend few instructions a byte and keep many loads
// in flight; the first versions spent two 64-bit divisions by run-time
// values on each word.
//
// Design: the TPU kernel's one-hot MXU matmuls over a compacted unique-row
// block (slot_gather.py:6-10) work around slow row gathers on the TPU; here
// a thread reads nbr directly, and no index needs a division (the graph is
// blockIdx.y, offsets are 32-bit). The forward gives each thread one slot:
// it reads the slot's mask and nbr once (coalesced) and copies the W words
// with code specialised for W = 1, 2, 4 (one aligned vector: 16 bytes at
// W=4 in float32, 8 in bfloat16) and W = 3 (a division by a constant), and
// a generic loop for other W (up to 48 in the checks): both copy the
// block's output words flat through shared-memory source offsets, so
// stores stay coalesced. The backward gives each thread one row u holding
// all its W sums: it reads the row's mask, nbr and rslot once, four
// entries a load when D % 4 == 0 (the lanes of a warp read adjacent rows,
// so L1 serves the rest of each line), kGradChunk slots' table entries and
// then their gout loads in flight together before the adds, which run in
// slot order with one rounding each; a slot's W words are one aligned
// vector at W = 1, 2, 4, and a generic loop walks the slots once per run of
// four words for other W. The grid is one thread a row, so its blocks are
// small (kGradThreads) to spread the rows over the SMs.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxDegree = 128;
constexpr int kThreads = 256;

// a word's value: float32 bits, or bfloat16 bits (exact, as __bfloat162float)
__device__ __forceinline__ float word_to_float(uint32_t b) { return __uint_as_float(b); }
__device__ __forceinline__ float word_to_float(uint16_t b) {
  return __uint_as_float((uint32_t)b << 16);
}
__device__ __forceinline__ uint32_t float_to_word(float v, uint32_t) { return __float_as_uint(v); }
__device__ __forceinline__ uint16_t float_to_word(float v, uint16_t) {
  // round to nearest even, as torch's .to(bfloat16)
  return __bfloat16_as_ushort(__float2bfloat16(v));
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

// the backward's slots a thread takes together (their table entries, then
// their gout loads, all in flight before the adds) and its block size
// (scripts/torch_port_kernel_variants.py --dec)
constexpr int kGradChunk = 16;
constexpr int kGradThreads = 128;

// One thread per row u of graph blockIdx.y, holding its W sums: 32-bit
// index arithmetic with no division (launch_bwd checks B*N*D*W < 2^31).
// kVecTable: the row's mask, nbr and rslot entries are read four at a time
// (D % 4 == 0, tables 16-byte aligned). W = 1, 2 or 4: a slot's W words of
// gout are one aligned vector and the W sums one store. Any other W (W = 0
// for the run-time `width`): the thread walks its slots once per run of
// four words.
template <typename Word, int W, bool kVecTable>
__global__ void __launch_bounds__(kGradThreads)
slot_gather_bwd_kernel(const Word* __restrict__ gout,
                       const int32_t* __restrict__ nbr,
                       const float* __restrict__ mask,
                       const int32_t* __restrict__ rslot,
                       Word* __restrict__ grad, int N, int D, int width) {
  constexpr int C = kGradChunk;
  static_assert(C % 4 == 0, "the table is read four entries at a time");
  constexpr int R = W > 0 ? W : 4;               // sums a thread holds
  const int w = W > 0 ? W : width;
  const int u = blockIdx.x * kGradThreads + threadIdx.x;
  if (u >= N) return;
  const int graph0 = blockIdx.y * N;
  const int row = (graph0 + u) * D;              // the row's first table entry
  for (int w0 = 0; w0 < w; w0 += R) {
    float acc[R];
#pragma unroll
    for (int k = 0; k < R; ++k) acc[k] = 0.f;
    for (int d0 = 0; d0 < D; d0 += C) {
      // the chunk's table entries, all in flight together
      float m[C];
      int32_t v[C], rs[C];
      if constexpr (kVecTable) {
#pragma unroll
        for (int q = 0; q < C / 4; ++q) {
          if (d0 + 4 * q < D) {
            const int off = row + d0 + 4 * q;
            const float4 mm = __ldg(reinterpret_cast<const float4*>(mask + off));
            const int4 nn = __ldg(reinterpret_cast<const int4*>(nbr + off));
            const int4 rr = __ldg(reinterpret_cast<const int4*>(rslot + off));
            m[4 * q] = mm.x; m[4 * q + 1] = mm.y; m[4 * q + 2] = mm.z; m[4 * q + 3] = mm.w;
            v[4 * q] = nn.x; v[4 * q + 1] = nn.y; v[4 * q + 2] = nn.z; v[4 * q + 3] = nn.w;
            rs[4 * q] = rr.x; rs[4 * q + 1] = rr.y; rs[4 * q + 2] = rr.z; rs[4 * q + 3] = rr.w;
          } else {
#pragma unroll
            for (int k = 0; k < 4; ++k) m[4 * q + k] = 0.f;
          }
        }
      } else {
#pragma unroll
        for (int s = 0; s < C; ++s) {
          m[s] = 0.f;
          if (d0 + s < D) {
            m[s] = __ldg(mask + row + d0 + s);
            v[s] = __ldg(nbr + row + d0 + s);
            rs[s] = __ldg(rslot + row + d0 + s);
          }
        }
      }
      // the chunk's gout words (first word of slot rslot of row v: the
      // cotangent of the reverse edge), all in flight together
      if constexpr (W > 0) {
        using V = typename VecOf<Word, W>::type;
        union { V raw; Word v[W]; } g[C];
#pragma unroll
        for (int s = 0; s < C; ++s)
          if (m[s] > 0.f)
            g[s].raw = __ldg(reinterpret_cast<const V*>(
                gout + ((graph0 + v[s]) * D + rs[s]) * W));
        // in slot order: bitwise the plain version's float32 sum
#pragma unroll
        for (int s = 0; s < C; ++s)
          if (m[s] > 0.f) {
#pragma unroll
            for (int k = 0; k < W; ++k) acc[k] = __fadd_rn(acc[k], word_to_float(g[s].v[k]));
          }
      } else {
        Word g[C][R];
#pragma unroll
        for (int s = 0; s < C; ++s)
          if (m[s] > 0.f) {
            const Word* src = gout + ((graph0 + v[s]) * D + rs[s]) * w + w0;
#pragma unroll
            for (int k = 0; k < R; ++k)
              if (w0 + k < w) g[s][k] = __ldg(src + k);
          }
#pragma unroll
        for (int s = 0; s < C; ++s)
          if (m[s] > 0.f) {
#pragma unroll
            for (int k = 0; k < R; ++k) acc[k] = __fadd_rn(acc[k], word_to_float(g[s][k]));
          }
      }
    }
    if constexpr (W > 0) {
      using V = typename VecOf<Word, W>::type;
      union { V raw; Word v[W]; } o;
#pragma unroll
      for (int k = 0; k < W; ++k) o.v[k] = float_to_word(acc[k], Word());
      reinterpret_cast<V*>(grad)[graph0 + u] = o.raw;
    } else {
      Word* o = grad + (graph0 + u) * w + w0;
#pragma unroll
      for (int k = 0; k < R; ++k)
        if (w0 + k < w) o[k] = float_to_word(acc[k], Word());
    }
  }
}

int check_dims(int B, int N, int D, int W) {
  if (D <= 0 || D > kMaxDegree || W <= 0 || B < 0 || N < 0)
    return (int)cudaErrorInvalidValue;
  return (int)cudaSuccess;
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

template <typename Word, int W, bool kVecTable>
void launch_bwd_w(const void* gout, const void* nbr, const void* mask,
                  const void* rslot, void* grad, int B, int N, int D, int width,
                  cudaStream_t s) {
  const dim3 grid((N + kGradThreads - 1) / kGradThreads, B);
  slot_gather_bwd_kernel<Word, W, kVecTable><<<grid, kGradThreads, 0, s>>>(
      static_cast<const Word*>(gout), static_cast<const int32_t*>(nbr),
      static_cast<const float*>(mask), static_cast<const int32_t*>(rslot),
      static_cast<Word*>(grad), N, D, width);
}

template <typename Word, bool kVecTable>
void launch_bwd_table(const void* gout, const void* nbr, const void* mask,
                      const void* rslot, void* grad, int B, int N, int D, int W,
                      cudaStream_t s) {
  // the vector paths need gout and grad aligned to W words, as torch allocates
  const uintptr_t vec = (uintptr_t)W * sizeof(Word);
  const bool aligned = (reinterpret_cast<uintptr_t>(gout) % vec == 0 &&
                        reinterpret_cast<uintptr_t>(grad) % vec == 0);
  if (W == 1) launch_bwd_w<Word, 1, kVecTable>(gout, nbr, mask, rslot, grad, B, N, D, W, s);
  else if (W == 2 && aligned) launch_bwd_w<Word, 2, kVecTable>(gout, nbr, mask, rslot, grad, B, N, D, W, s);
  else if (W == 4 && aligned) launch_bwd_w<Word, 4, kVecTable>(gout, nbr, mask, rslot, grad, B, N, D, W, s);
  else launch_bwd_w<Word, 0, kVecTable>(gout, nbr, mask, rslot, grad, B, N, D, W, s);
}

template <typename Word>
int launch_bwd(const void* gout, const void* nbr, const void* mask,
               const void* rslot, void* grad, int B, int N, int D, int W,
               void* stream) {
  const int rc = check_dims(B, N, D, W);
  if (rc != (int)cudaSuccess) return rc;
  if ((int64_t)B * N * D * W >= ((int64_t)1 << 31) || B > 65535)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || N == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // four table entries a load when every row starts 16 bytes in
  const bool vec_table = D % 4 == 0 &&
      (reinterpret_cast<uintptr_t>(nbr) | reinterpret_cast<uintptr_t>(mask) |
       reinterpret_cast<uintptr_t>(rslot)) % 16 == 0;
  if (vec_table) launch_bwd_table<Word, true>(gout, nbr, mask, rslot, grad, B, N, D, W, s);
  else launch_bwd_table<Word, false>(gout, nbr, mask, rslot, grad, B, N, D, W, s);
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
  return launch_bwd<uint32_t>(gout, nbr, mask, rslot, grad, B, N, D, W, stream);
}

int gts_slot_gather_bwd_bf16(const void* gout, const void* nbr,
                             const void* mask, const void* rslot, void* grad,
                             int B, int N, int D, int W, void* stream) {
  return launch_bwd<uint16_t>(gout, nbr, mask, rslot, grad, B, N, D, W,
                                   stream);
}

const char* gts_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
