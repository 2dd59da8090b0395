// Edge-weighted neighbour combine over the ELL neighbour table, its
// transpose through the reciprocal slots, and the per-edge pair dot.
//
// Layouts (B graphs, N rows, D slots, H heads of F features, HF = H*F):
//   values, gout, out, a, c  [B, N, HF]   float32 or bfloat16 (one type, T)
//   weights                  [B, N, D*H]  float32, slot-major (d*H + h)
//   scores                   [B, N, D*H]  float32
//   nbr, rslot               [B, N, D]    int32
//   mask                     [B, N, D]    float32 (> 0 on a real slot)
//
// 1. wsum_kernel<T, false, VEC> replaces gnn_tumor_seg_tpu/ops/pallas/
//    weighted_sum.py:86 `_wsum_kernel` (launched by `_wsum_raw`, :114):
//      out[v,h,:] = sum over v's real slots d of w[v,d,h] * values[nbr[v,d],h,:].
//    A padded slot adds nothing, whatever its weight (weighted_sum.py:98-99).
// 2. wsum_kernel<T, true, VEC> is the same kernel in the gradient
//    (`_tws_bwd`, :224-232): d/d(values) is the combine over the reverse
//    weights w_rev[u,d,h] = w[v, rslot[u,d], h], v = nbr[u,d]. rslot[u,d] is
//    the slot of u in row v of the symmetric, deduplicated table, so the
//    kernel reads each reverse weight through it (a gather, no scatter, no
//    atomics) where the TPU fetches them first with a slot_gather and a
//    D-way select (`_reverse_weights`, :202-210). The result is exact for
//    weights that are not symmetric too.
// 3. pairdot_kernel replaces weighted_sum.py:144 `_pairdot_kernel` (launched
//    by `_pairdot`, :173), the gradient of the weights and the device path
//    of ops/sddmm.py:
//      s[v,d,h] = <a[v,h,:], c[nbr[v,d],h,:]> on a real slot, 0 on a padded one.
//
// Arithmetic is float32 in both types. The combines (1, 2) add explicitly
// rounded products in slot order (__fmul_rn, __fadd_rn, which nvcc never
// contracts into an FMA), so they are bitwise equal to their plain PyTorch
// versions (ops/kernels/weighted_sum.py). The pair dot sums over F in lanes
// and a shuffle tree, another order than the plain version's sum. No kernel
// uses atomics: every result is the same run to run.
//
// What bounds them on an H100: bytes. Per (row, slot, feature) each does one
// multiply and one add; the traffic is the referenced rows of values (or
// gout, or c) once, the output written once, and the per-slot tables (nbr,
// mask, weights or scores: 12 + 4H bytes a slot). A hidden layer of GAT's
// training batch (B=6, N=8192, D=12, HF=1024, float32) moves ~0.39 GB, some
// 0.12 ms at 3.35 TB/s; a weighted SAGE layer at HF=256 a quarter of that.
// A neighbour row is re-read for each of its D slots and comes from L2 only
// when the rows of a neighbourhood lie close together (they do for
// supervoxel graphs, whose node ids follow space): at about ten real slots
// a row, those re-reads are ~1.7 GB from L2 at HF=1024, so a good combine
// sits at 2-3x the byte bound, not at 1x.
//
// Combine design (the layout of max_agg.cu's backward). The TPU kernels'
// weighted one-hot histograms on the MXU over a compacted unique-row block,
// carried as bf16 hi/lo halves (weighted_sum.py:8-15, 95-110), work around
// slow row gathers on the TPU; here the kernel reads nbr directly.
//  * Each thread owns an aligned vector of VEC contiguous features inside
//    one head (VEC = 8, 4, 2 or 1, the widest that divides F and keeps a
//    load at 16 bytes: float32 at most 4, bfloat16 at most 8), read and
//    written as one vector.
//  * Threads map flat onto (row, vector): at HF=4 in float32 one thread is a
//    row, at HF=256 a row takes 64 threads and a block of 256 four rows. A
//    row of more than 256 vectors (F=515) takes a third grid dimension over
//    feature runs. Graphs are the slower grid dimension (blockIdx.y), so a
//    wave gathers from the rows of about one graph, which stay in L2.
//  * Staging, one round trip: the block loads mask, nbr and (reverse) rslot
//    of all its rows' slots at once (several entries a thread in flight),
//    then compacts each row's real slots in slot order in shared memory
//    with warp ballots and keeps their number. The feature loop runs over
//    the real slots alone and never tests a padded one.
//  * Each slot's weight is read in the feature loop beside the slot's
//    vector: both depend on the staged (source, slot) pair alone, so the
//    reverse weight w[v, rslot] costs no second dependent round trip before
//    the loop, and no shared memory (the lanes of one head read one
//    address, one transaction a warp).
//  * kChunk slots' loads are in flight before their adds. The adds then run
//    in slot order, one rounding each; skipping a padded slot equals the
//    plain version's add of +0.0 (a float32 sum from +0.0 never becomes
//    -0.0), so the result stays bitwise the plain version's.
// The pair dot gives a group of G lanes (a power of two from 4 to 32) one
// (row, head): the lanes stride over F for each slot's dot and reduce with
// xor shuffles inside the group. Left for later: the pair dot's vector
// loads, cp.async or TMA staging, persistent blocks.

#include <algorithm>
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxDegree = 128;
constexpr int kMaxHeads = 16;
constexpr int kThreads = 256;
constexpr size_t kSmemBudget = 48 * 1024;
// table entries (mask, nbr, rslot) a thread loads together while staging
constexpr int kStageUnroll = 4;

__device__ __forceinline__ float load_as_float(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_as_float(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

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

// ---------------------------------------------------------------- combine

// Stages, for rows row0 .. row0 + rows - 1 of graph b, the real slots of
// each row in slot order as (source row, second index) pairs in
// slots[rl * Dp ...] and their number in count[rl]; the second index is
// rslot[v,d] when kReverse, else d. Every thread of the block calls it (it
// holds two barriers); blockDim.x is a multiple of 32.
template <bool kReverse>
__device__ __forceinline__ void stage_slots(const int32_t* __restrict__ nbr,
                                            const float* __restrict__ mask,
                                            const int32_t* __restrict__ rslot,
                                            int2* slots, int* count, int b,
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
    int32_t s[kStageUnroll], k[kStageUnroll];
#pragma unroll
    for (int u = 0; u < kStageUnroll; ++u) {
      const int64_t off = base + min(i0 + u * nt, last);
      m[u] = __ldg(mask + off);
      s[u] = __ldg(nbr + off);
      k[u] = kReverse ? __ldg(rslot + off) : 0;
    }
#pragma unroll
    for (int u = 0; u < kStageUnroll; ++u) {
      const int i = i0 + u * nt;
      if (i < total) {
        const int rl = i / D;
        const int d = i - rl * D;
        const bool real = i <= last && m[u] > 0.f;
        slots[rl * Dp + d] = real ? make_int2(s[u], kReverse ? k[u] : d)
                                  : make_int2(-1, 0);
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
      int2 e = make_int2(-1, 0);
      if (rl < rows && d < D) e = slots[rl * Dp + d];
      const unsigned bits = __ballot_sync(0xffffffffu, e.x >= 0);
      const unsigned mine = P == 32 ? bits : (bits >> (seg * P)) & ((1u << P) - 1u);
      if (e.x >= 0) slots[rl * Dp + n + __popc(mine & below)] = e;
      n += __popc(mine);
    }
    if (j == 0 && rl < rows) count[rl] = n;
  }
  __syncthreads();
}

// One block per (tile of `rows` destination rows, graph b, run z of
// vectors); thread t serves row t / tpr and the VEC features starting at
// (z * tpr + t % tpr) * VEC, tpr = HF / VEC threads a row, at most 256.
// Offsets within a graph are 32-bit (N * HF and N * D * H < 2^31).
template <typename T, bool kReverse, int VEC>
__global__ void __launch_bounds__(kThreads)
wsum_kernel(const T* __restrict__ values, const float* __restrict__ weights,
            const int32_t* __restrict__ nbr, const float* __restrict__ mask,
            const int32_t* __restrict__ rslot, T* __restrict__ out, int N,
            int D, int H, int F, int tpr, int rows, int Dp) {
  using Bits = typename BitsOf<T>::type;
  // slots whose loads start together: 2 keeps float32 at 32 registers, 8
  // blocks of 256 an SM; 4 and 8 hold more and were slower
  // (scripts/torch_port_kernel_variants.py)
  constexpr int kChunk = 2;
  extern __shared__ int2 slots[];                 // [rows, Dp], then count
  int* count = reinterpret_cast<int*>(slots + rows * Dp);
  const int b = blockIdx.y;
  const int row0 = blockIdx.x * rows;
  stage_slots<kReverse>(nbr, mask, rslot, slots, count, b, row0, rows, N, D, Dp);

  const int HF = H * F;
  const int rl = threadIdx.x / tpr;
  const int r = row0 + rl;
  const int f = (blockIdx.z * tpr + threadIdx.x - rl * tpr) * VEC;
  if (rl >= rows || r >= N || f >= HF) return;
  const int h = f / F;
  const int n = count[rl];
  const int2* rs = slots + rl * Dp;
  const T* vb = values + (int64_t)b * N * HF + f;
  // forward: the row's own weight w[r, d, h]; reverse: w[v, rslot, h]
  const float* wb = weights + (int64_t)b * N * D * H + (kReverse ? 0 : r * D * H) + h;
  float acc[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
  for (int k0 = 0; k0 < n; k0 += kChunk) {
    float w[kChunk];
    Pack<Bits, VEC> v[kChunk];
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      if (k0 + c < n) {
        const int2 s = rs[k0 + c];
        w[c] = __ldg(wb + (kReverse ? s.x * D + s.y : s.y) * H);
        v[c].raw = load_raw<sizeof(Bits) * VEC>(vb + s.x * HF);
      }
    }
    // in slot order: bitwise the plain version's float32 sum
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      if (k0 + c < n) {
#pragma unroll
        for (int k = 0; k < VEC; ++k)
          acc[k] = __fadd_rn(acc[k], __fmul_rn(w[c], bits_to_float(v[c].v[k])));
      }
    }
  }
  Pack<Bits, VEC> o;
#pragma unroll
  for (int k = 0; k < VEC; ++k) o.v[k] = float_to_bits(acc[k], Bits());
  store_raw(out + ((int64_t)b * N + r) * HF + f, o.raw);
}

// --------------------------------------------------------------- pair dot

template <typename T>
__global__ void pairdot_kernel(const T* __restrict__ a, const T* __restrict__ c,
                               const int32_t* __restrict__ nbr,
                               const float* __restrict__ mask,
                               float* __restrict__ scores, int N, int D, int H,
                               int F, int G) {
  const int gl = threadIdx.x & (G - 1);           // lane within the group
  const int group = threadIdx.x / G;
  const int groups = blockDim.x / G;
  const int b = blockIdx.y;
  const int64_t pair = (int64_t)blockIdx.x * groups + group;  // (row, head)
  const bool live = pair < (int64_t)N * H;
  const int r = live ? (int)(pair / H) : 0;
  const int h = live ? (int)(pair % H) : 0;
  const int HF = H * F;
  const int64_t node = (int64_t)b * N + r;
  const T* ar = a + node * HF + h * F;
  const T* cb = c + (int64_t)b * N * HF + h * F;

  // every lane of the warp runs every shuffle: the loop bounds are uniform
  for (int d = 0; d < D; ++d) {
    const int64_t off = node * D + d;
    const bool real = live && mask[off] > 0.f;
    float part = 0.f;
    if (real) {
      const T* cs = cb + (int64_t)nbr[off] * HF;
      for (int f = gl; f < F; f += G)
        part = fmaf(load_as_float(ar + f), load_as_float(cs + f), part);
    }
    for (int o = G / 2; o > 0; o >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, o);
    if (live && gl == 0) scores[off * H + h] = part;
  }
}

// ---------------------------------------------------------------- launches

int check_dims(int B, int N, int D, int H, int F) {
  if (D <= 0 || D > kMaxDegree || H <= 0 || H > kMaxHeads || F <= 0 || B < 0 ||
      N < 0)
    return (int)cudaErrorInvalidValue;
  return (int)cudaSuccess;
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename T, int VEC>
int launch_wsum_vec(const void* values, const void* weights, const void* nbr,
                    const void* mask, const void* rslot, void* out, int B,
                    int N, int D, int H, int F, int reverse, cudaStream_t s) {
  const int vecs = H * F / VEC;                   // vectors a row
  const int tpr = std::min(vecs, kThreads);       // threads a row
  const int Dp = D | 1;   // odd row stride: no bank conflicts between rows
  const size_t per_row = (size_t)Dp * sizeof(int2) + sizeof(int);
  // as many rows as fill 256 threads, within 48 KB of staged slots (at
  // least 47 rows at D=128)
  const int rows = std::min(kThreads / tpr, (int)(kSmemBudget / per_row));
  const int threads = (rows * tpr + 31) / 32 * 32;   // whole warps: ballots
  const dim3 grid((N + rows - 1) / rows, B, (vecs + tpr - 1) / tpr);
  if (grid.z > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = rows * per_row;
  const T* v = static_cast<const T*>(values);
  const float* w = static_cast<const float*>(weights);
  const int32_t* n = static_cast<const int32_t*>(nbr);
  const float* m = static_cast<const float*>(mask);
  const int32_t* rs = static_cast<const int32_t*>(rslot);
  T* o = static_cast<T*>(out);
  if (reverse)
    wsum_kernel<T, true, VEC><<<grid, threads, smem, s>>>(v, w, n, m, rs, o, N, D,
                                                          H, F, tpr, rows, Dp);
  else
    wsum_kernel<T, false, VEC><<<grid, threads, smem, s>>>(v, w, n, m, rs, o, N, D,
                                                           H, F, tpr, rows, Dp);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_wsum(const void* values, const void* weights, const void* nbr,
                const void* mask, const void* rslot, void* out, int B, int N,
                int D, int H, int F, int reverse, void* stream) {
  const int rc = check_dims(B, N, D, H, F);
  if (rc != (int)cudaSuccess) return rc;
  if (reverse && rslot == nullptr) return (int)cudaErrorInvalidValue;
  if (B == 0 || N == 0) return (int)cudaSuccess;
  if (B > 65535 || (int64_t)N * H * F >= (1LL << 31) ||
      (int64_t)N * D * H >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the widest vector of at most 16 bytes that divides F and to which both
  // feature pointers are aligned
  auto fits = [&](int vec) {
    return F % vec == 0 && aligned(values, vec * (int)sizeof(T)) &&
           aligned(out, vec * (int)sizeof(T));
  };
#define GTS_WSUM(VEC)                                                       \
  launch_wsum_vec<T, VEC>(values, weights, nbr, mask, rslot, out, B, N, D, \
                          H, F, reverse, s)
  if constexpr (sizeof(T) == 2) {
    if (fits(8)) return GTS_WSUM(8);
  }
  if (fits(4)) return GTS_WSUM(4);
  if (fits(2)) return GTS_WSUM(2);
  return GTS_WSUM(1);
#undef GTS_WSUM
}

template <typename T>
int launch_pairdot(const void* a, const void* c, const void* nbr,
                   const void* mask, void* scores, int B, int N, int D, int H,
                   int F, void* stream) {
  const int rc = check_dims(B, N, D, H, F);
  if (rc != (int)cudaSuccess) return rc;
  if (B == 0 || N == 0) return (int)cudaSuccess;
  // lanes per (row, head): a power of two covering F, from 4 to 32
  int G = 4;
  while (G < F && G < 32) G *= 2;
  const int groups = kThreads / G;
  const int64_t pairs = (int64_t)N * H;
  const dim3 grid((unsigned)((pairs + groups - 1) / groups), B);
  pairdot_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<const T*>(c),
      static_cast<const int32_t*>(nbr), static_cast<const float*>(mask),
      static_cast<float*>(scores), N, D, H, F, G);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int gts_wsum_f32(const void* values, const void* weights, const void* nbr,
                 const void* mask, const void* rslot, void* out, int B, int N,
                 int D, int H, int F, int reverse, void* stream) {
  return launch_wsum<float>(values, weights, nbr, mask, rslot, out, B, N, D, H,
                            F, reverse, stream);
}

int gts_wsum_bf16(const void* values, const void* weights, const void* nbr,
                  const void* mask, const void* rslot, void* out, int B, int N,
                  int D, int H, int F, int reverse, void* stream) {
  return launch_wsum<__nv_bfloat16>(values, weights, nbr, mask, rslot, out, B,
                                    N, D, H, F, reverse, stream);
}

int gts_pairdot_f32(const void* a, const void* c, const void* nbr,
                    const void* mask, void* scores, int B, int N, int D, int H,
                    int F, void* stream) {
  return launch_pairdot<float>(a, c, nbr, mask, scores, B, N, D, H, F, stream);
}

int gts_pairdot_bf16(const void* a, const void* c, const void* nbr,
                     const void* mask, void* scores, int B, int N, int D, int H,
                     int F, void* stream) {
  return launch_pairdot<__nv_bfloat16>(a, c, nbr, mask, scores, B, N, D, H, F,
                                       stream);
}

const char* gts_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
