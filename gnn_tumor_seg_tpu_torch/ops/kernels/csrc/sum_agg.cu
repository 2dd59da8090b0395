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
// traffic is the referenced rows of h read once (B x N x F, 50 MB for a
// training batch of 6 x 8192 nodes at F=256 in float32, the size of the whole
// L2), nbr and mask (N x D x 4 B each) and out written once. Each real slot
// re-reads its neighbour's row, which the bound counts once: those re-reads
// come from L2 when the rows of a neighbourhood lie close together (they do
// for supervoxel graphs, whose node ids follow space), so a good kernel sits
// at some 2-3x the byte bound, as the weighted combine does (weighted_sum.cu).
//
// Design (the weighted combine's, weighted_sum.cu, without the weights). The
// TPU kernel's one-hot MXU contraction over a compacted unique-row block
// (gather_agg.py:68-92) works around slow row gathers on the TPU; here the
// kernel reads nbr directly.
//  * Each thread owns an aligned vector of VEC contiguous features (VEC = 8,
//    4, 2 or 1, the widest that divides F, keeps a load at 16 bytes, and to
//    which h and out are aligned: float32 4 and bfloat16 8 at F=256, 4 at
//    F=20), read and written as one vector.
//  * Threads map flat onto (row, vector): at F=256 in float32 a row takes 64
//    threads and a block of 256 four rows; at F=20 a row takes 5 threads and
//    a block 51 rows, so no lane idles. Blocks take whole warps over their
//    rows. A row of more than 256 vectors (F=515) takes a third grid
//    dimension over feature runs. Graphs are the slower grid dimension
//    (blockIdx.y), so a wave gathers from the rows of about one graph, which
//    stay in L2.
//  * Staging, one round trip: the block loads mask and nbr of all its rows'
//    slots at once (kStageUnroll entries a thread in flight), then compacts
//    each row's real slots (their source rows) in slot order in shared
//    memory with warp ballots and keeps their number, which is also the
//    mean's degree. The feature loop runs over the real slots alone, so a
//    table with holes (real slots after padded ones) costs nothing more.
//  * kAggChunk slots' vector loads are in flight before their adds. The
//    adds then run in slot order, one rounding each; skipping a padded slot
//    equals the plain version's add of +0.0 (a float32 sum from +0.0 never
//    becomes -0.0), so the result stays bitwise the plain version's. The
//    mean divides once, as an IEEE division (__fdiv_rn), as the plain
//    version does; the build uses no fast-math.
//  * kAggChunk and the launch bound (kAggMinBlocks, blocks of 256 threads an
//    SM that the registers must allow) were tuned together
//    (scripts/torch_port_kernel_variants.py --agg).

#include <algorithm>
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxDegree = 128;
constexpr int kThreads = 256;
constexpr size_t kSmemBudget = 48 * 1024;
// table entries (mask, nbr) a thread loads together while staging
constexpr int kStageUnroll = 4;
// blocks of 256 threads an SM that the kernel's registers must allow: 6
// (40 registers a thread); with kAggChunk = 4, a bound of 8 (32 registers)
// spills and none (46-56 registers) was slower at F=256
// (scripts/torch_port_kernel_variants.py --agg)
constexpr int kAggMinBlocks = 6;

// BYTES bytes moved with one aligned access (at most 16)
template <int BYTES> struct Raw { uint4 w[1]; };
template <> struct Raw<8> { uint2 w[1]; };
template <> struct Raw<4> { uint32_t w[1]; };
template <> struct Raw<2> { uint16_t w[1]; };

template <int BYTES>
__device__ __forceinline__ Raw<BYTES> load_raw(const void* p) {
  Raw<BYTES> r;
  using W = std::decay_t<decltype(r.w[0])>;
  r.w[0] = __ldg(static_cast<const W*>(p));
  return r;
}

template <int BYTES>
__device__ __forceinline__ void store_raw(void* p, const Raw<BYTES>& r) {
  using W = std::decay_t<decltype(r.w[0])>;
  *static_cast<W*>(p) = r.w[0];
}

// VEC values of a type kept as their bits (uint32_t for float32, uint16_t
// for bfloat16), readable one by one or moved as one vector
template <typename Bits, int VEC>
union Pack {
  Bits v[VEC];
  Raw<sizeof(Bits) * VEC> raw;
};

template <typename T> struct BitsOf;
template <> struct BitsOf<float> { using type = uint32_t; };
template <> struct BitsOf<__nv_bfloat16> { using type = uint16_t; };

__device__ __forceinline__ float bits_to_float(uint32_t b) { return __uint_as_float(b); }
__device__ __forceinline__ float bits_to_float(uint16_t b) {
  return __uint_as_float((uint32_t)b << 16);   // exact, as __bfloat162float
}
__device__ __forceinline__ uint32_t float_to_bits(float v, uint32_t) { return __float_as_uint(v); }
__device__ __forceinline__ uint16_t float_to_bits(float v, uint16_t) {
  return __bfloat16_as_ushort(__float2bfloat16(v));   // round to nearest even
}

// Stages, for rows row0 .. row0 + rows - 1 of graph b, the source rows of
// each row's real slots in slot order in slots[rl * Dp ...] and their number
// in count[rl]. Every thread of the block calls it (it holds two barriers);
// blockDim.x is a multiple of 32.
__device__ __forceinline__ void stage_slots(const int32_t* __restrict__ nbr,
                                            const float* __restrict__ mask,
                                            int* slots, int* count, int b,
                                            int row0, int rows, int N, int D,
                                            int Dp) {
  const int nt = blockDim.x;
  const int total = rows * D;
  const int64_t base = ((int64_t)b * N + row0) * D;
  const int last = min(rows, N - row0) * D - 1;   // the block's last table entry
  // one round trip: each thread's kStageUnroll entries are all in flight
  // before any is read (offsets clamped into the table, so no load branches)
  for (int i0 = threadIdx.x; i0 < total; i0 += kStageUnroll * nt) {
    float m[kStageUnroll];
    int32_t s[kStageUnroll];
#pragma unroll
    for (int u = 0; u < kStageUnroll; ++u) {
      const int64_t off = base + min(i0 + u * nt, last);
      m[u] = __ldg(mask + off);
      s[u] = __ldg(nbr + off);
    }
#pragma unroll
    for (int u = 0; u < kStageUnroll; ++u) {
      const int i = i0 + u * nt;
      if (i < total) {
        const int rl = i / D;
        const int d = i - rl * D;
        slots[rl * Dp + d] = i <= last && m[u] > 0.f ? s[u] : -1;
      }
    }
  }
  __syncthreads();
  // compaction in place: P lanes a row (D rounded up to a power of two, at
  // most 32), so a warp takes 32 / P rows at a time; a row of more than 32
  // slots goes in runs of 32. A lane's slot moves to the number of real
  // slots before it, never past where it was read.
  int P = 1;
  while (P < D && P < 32) P *= 2;
  const int per_warp = 32 / P;
  const int lane = threadIdx.x & 31;
  const int seg = lane / P;
  const int j = lane - seg * P;
  const unsigned below = (1u << j) - 1u;
  for (int rb = (threadIdx.x >> 5) * per_warp; rb < rows; rb += (nt >> 5) * per_warp) {
    const int rl = rb + seg;          // the loops' bounds are uniform in a warp
    int n = 0;
    for (int d0 = 0; d0 < D; d0 += P) {
      const int d = d0 + j;
      int e = -1;
      if (rl < rows && d < D) e = slots[rl * Dp + d];
      const unsigned bits = __ballot_sync(0xffffffffu, e >= 0);
      const unsigned mine = P == 32 ? bits : (bits >> (seg * P)) & ((1u << P) - 1u);
      if (e >= 0) slots[rl * Dp + n + __popc(mine & below)] = e;
      n += __popc(mine);
    }
    if (j == 0 && rl < rows) count[rl] = n;
  }
  __syncthreads();
}

// One block per (tile of `rows` destination rows, graph b, run z of
// vectors); thread t serves row t / tpr and the VEC features starting at
// (z * tpr + t % tpr) * VEC, tpr = F / VEC threads a row, at most 256.
// Offsets within a graph are 32-bit (N * F < 2^31).
template <typename T, bool kMean, int VEC>
__global__ void __launch_bounds__(kThreads, kAggMinBlocks)
sum_agg_kernel(const T* __restrict__ h, const int32_t* __restrict__ nbr,
               const float* __restrict__ mask, T* __restrict__ out, int N,
               int D, int F, int tpr, int rows, int Dp) {
  using Bits = typename BitsOf<T>::type;
  // slots whose vector loads start together: 4 beat 2 and 8 under the
  // bound of 6 blocks (scripts/torch_port_kernel_variants.py --agg)
  constexpr int kAggChunk = 4;
  extern __shared__ int slots[];                  // [rows, Dp], then count
  int* count = slots + rows * Dp;
  const int b = blockIdx.y;
  const int row0 = blockIdx.x * rows;
  stage_slots(nbr, mask, slots, count, b, row0, rows, N, D, Dp);

  const int rl = threadIdx.x / tpr;
  const int r = row0 + rl;
  const int f = (blockIdx.z * tpr + threadIdx.x - rl * tpr) * VEC;
  if (rl >= rows || r >= N || f >= F) return;
  const int n = count[rl];
  const int* rs = slots + rl * Dp;
  const T* hb = h + (int64_t)b * N * F + f;
  float acc[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
  for (int k0 = 0; k0 < n; k0 += kAggChunk) {
    Pack<Bits, VEC> v[kAggChunk];
#pragma unroll
    for (int c = 0; c < kAggChunk; ++c) {
      if (k0 + c < n) v[c].raw = load_raw<sizeof(Bits) * VEC>(hb + rs[k0 + c] * F);
    }
    // in slot order: bitwise the plain version's float32 sum
#pragma unroll
    for (int c = 0; c < kAggChunk; ++c) {
      if (k0 + c < n) {
#pragma unroll
        for (int k = 0; k < VEC; ++k) acc[k] = __fadd_rn(acc[k], bits_to_float(v[c].v[k]));
      }
    }
  }
  if (kMean) {
    const float deg = (float)max(n, 1);
#pragma unroll
    for (int k = 0; k < VEC; ++k) acc[k] = __fdiv_rn(acc[k], deg);
  }
  Pack<Bits, VEC> o;
#pragma unroll
  for (int k = 0; k < VEC; ++k) o.v[k] = float_to_bits(acc[k], Bits());
  store_raw(out + ((int64_t)b * N + r) * F + f, o.raw);
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename T, int VEC>
int launch_vec(const void* h, const void* nbr, const void* mask, void* out,
               int B, int N, int D, int F, int mean, cudaStream_t s) {
  const int vecs = F / VEC;                       // vectors a row
  const int tpr = std::min(vecs, kThreads);       // threads a row
  const int Dp = D | 1;   // odd row stride: no bank conflicts between rows
  const size_t per_row = (size_t)(Dp + 1) * sizeof(int);
  // as many rows as fill 256 threads, within 48 KB of staged slots (at
  // least 94 rows at D=128)
  const int rows = std::min(kThreads / tpr, (int)(kSmemBudget / per_row));
  const int threads = (rows * tpr + 31) / 32 * 32;   // whole warps: ballots
  const dim3 grid((N + rows - 1) / rows, B, (vecs + tpr - 1) / tpr);
  if (grid.z > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = rows * per_row;
  const T* hp = static_cast<const T*>(h);
  const int32_t* np = static_cast<const int32_t*>(nbr);
  const float* mp = static_cast<const float*>(mask);
  T* op = static_cast<T*>(out);
  if (mean)
    sum_agg_kernel<T, true, VEC><<<grid, threads, smem, s>>>(hp, np, mp, op, N, D, F,
                                                             tpr, rows, Dp);
  else
    sum_agg_kernel<T, false, VEC><<<grid, threads, smem, s>>>(hp, np, mp, op, N, D, F,
                                                              tpr, rows, Dp);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* h, const void* nbr, const void* mask, void* out, int B,
           int N, int D, int F, int mean, void* stream) {
  if (B <= 0 || N <= 0 || F <= 0) return (int)cudaSuccess;
  if (D <= 0 || D > kMaxDegree || B > 65535 || (int64_t)N * F >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the widest vector of at most 16 bytes that divides F and to which h and
  // out are aligned
  auto fits = [&](int vec) {
    return F % vec == 0 && aligned(h, vec * (int)sizeof(T)) &&
           aligned(out, vec * (int)sizeof(T));
  };
  if constexpr (sizeof(T) == 2) {
    if (fits(8)) return launch_vec<T, 8>(h, nbr, mask, out, B, N, D, F, mean, s);
  }
  if (fits(4)) return launch_vec<T, 4>(h, nbr, mask, out, B, N, D, F, mean, s);
  if (fits(2)) return launch_vec<T, 2>(h, nbr, mask, out, B, N, D, F, mean, s);
  return launch_vec<T, 1>(h, nbr, mask, out, B, N, D, F, mean, s);
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
