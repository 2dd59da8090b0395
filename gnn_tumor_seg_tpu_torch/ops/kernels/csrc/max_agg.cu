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
// What bounds both on an H100: bytes at best. They do one compare (and,
// backward, one add) per (v, d, f), far below the card's operation rate.
// Forward traffic is the referenced rows of h read once (for a full-size
// brain's node bucket, 12288 x 256 x 4 B = 12.6 MB, which fits the 50 MB L2,
// so the D-fold re-reads of neighbour rows mostly hit L2), plus nbr and mask
// (N x D x 4 B each), plus out (N x F) and, when it is stored, arg (N x F
// bytes). The bound counts each referenced row once; the forward re-reads it
// once per real slot, from L2 at best, so a good forward sits at some 2-3x
// the bound, as the weighted combine does (weighted_sum.cu). Backward reads
// gout and arg once (B x N x F x (4 + 1) B), nbr, mask and rslot (3 x N x D
// x 4 B) and writes grad. In practice the backward is bound by how many
// loads are in flight: each real slot needs a load of arg and then, where
// arg names the slot, a load of gout that depends on it, and the D-fold
// re-reads of arg come from L2.
//
// Forward design (the weighted combine's, weighted_sum.cu, with a compare in
// place of the multiply-add). The TPU kernel's one-hot MXU gathers over a
// compacted unique-row block (gather_agg.py:135-163) work around slow row
// gathers on the TPU; here the kernel reads nbr directly.
//  * Each thread owns an aligned vector of VEC contiguous features (VEC = 8,
//    4, 2 or 1, the widest that divides F, keeps a load at 16 bytes, and to
//    which h, out and, when stored, arg are aligned: float32 4 and bfloat16 8
//    at F=256, 4 at F=20), read as one vector; out is written as one vector
//    and arg as one of VEC bytes.
//  * Threads map flat onto (row, vector): at F=256 in float32 a row takes 64
//    threads and a block of 256 four rows; at F=20 a block takes 51 rows, so
//    no lane idles. Blocks take whole warps over their rows. A row of more
//    than 256 vectors (F=515) takes a third grid dimension over feature
//    runs. Graphs are the slower grid dimension (blockIdx.y), so a wave
//    gathers from the rows of about one graph, which stay in L2.
//  * Staging, one round trip: the block loads mask and nbr of all its rows'
//    slots at once (kStageUnroll entries a thread in flight), then compacts
//    each row's real slots in slot order in shared memory with warp ballots,
//    as (source row, slot d) pairs, and keeps their number. The feature loop
//    runs over the real slots alone and stores the original slot d of the
//    winner, so a table with holes (real slots after padded ones) gives the
//    plain version's arg.
//  * kAggChunk slots' vector loads are in flight before their compares. The
//    compares then run in slot order with a strict `>` against a running
//    best from -1e30, so the first winner keeps the slot, across chunks too;
//    a row with no real slot gives out 0 and arg 0. The serve path discards
//    `arg`, so a template flag drops its store (and the slot tracking) there.
//  * kAggChunk and the launch bound (kAggMinBlocks, blocks of 256 threads an
//    SM that the registers must allow) were tuned together
//    (scripts/torch_port_kernel_variants.py --agg).
//
// Backward design: each thread owns a vector of VEC contiguous features
// (VEC = 8, 4, 2 or 1, the widest that divides F), read as one aligned
// vector: at VEC=8 two 16-byte loads of float32 gout or one of bfloat16, and
// one 8-byte load of arg. Threads map flat onto (row, vector), so at F=20
// (five vectors of 4) a warp spans parts of seven rows and no lane idles. A
// block of up to 256 threads takes as many rows as fill it (8 at F=256, 51
// at F=20) and stages their (source row, rslot) pairs, with padded slots as
// -1, in shared memory once; the slot loop stops at the block's last real
// slot. Slots go in pairs: both arg loads start, then the gout loads of
// the slots that won any of the thread's features. Larger groups of slots
// (4-8) hold more loads in flight per thread but need 58-133 registers at
// VEC=8 instead of 45-48, so fewer threads fit an SM, and were slower
// (scripts/torch_port_kernel_variants.py). The sum stays in slot order in
// float32 registers, so the result is deterministic and bitwise the plain
// version's. L2: graphs are the slower grid dimension, so a wave of blocks
// gathers from the rows of about one graph, 8192 x 256 x 5 B = 10.5 MB of
// gout and arg at the training shape in float32 and 21 MB at the largest
// node bucket (16384), within the 50 MB L2. Left for later: cp.async
// staging of the table, persistent blocks.

#include <algorithm>
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegLarge = -1e30f;
constexpr int kMaxDegree = 128;
constexpr int kThreads = 256;
constexpr size_t kSmemBudget = 48 * 1024;
// table entries (mask, nbr) a forward thread loads together while staging
constexpr int kStageUnroll = 4;
// blocks of 256 threads an SM that the forward's registers must allow: 6
// (40 registers a thread); a bound of 8 (32 registers) spills the store
// variant's float32 vectors of 4 and bfloat16's of 8
// (scripts/torch_port_kernel_variants.py --agg)
constexpr int kAggMinBlocks = 6;

// ---- shared by both ----

// BYTES bytes moved with the widest aligned accesses (two 16-byte ones at 32)
template <int BYTES> struct Raw { uint4 w[BYTES / 16]; };
template <> struct Raw<8> { uint2 w[1]; };
template <> struct Raw<4> { uint32_t w[1]; };
template <> struct Raw<2> { uint16_t w[1]; };
template <> struct Raw<1> { uint8_t w[1]; };

template <int BYTES>
__device__ __forceinline__ Raw<BYTES> load_raw(const void* p) {
  Raw<BYTES> r;
  using W = std::decay_t<decltype(r.w[0])>;
#pragma unroll
  for (int i = 0; i < (int)(sizeof(r) / sizeof(W)); ++i)
    r.w[i] = __ldg(static_cast<const W*>(p) + i);
  return r;
}

template <int BYTES>
__device__ __forceinline__ void store_raw(void* p, const Raw<BYTES>& r) {
  using W = std::decay_t<decltype(r.w[0])>;
#pragma unroll
  for (int i = 0; i < (int)(sizeof(r) / sizeof(W)); ++i)
    static_cast<W*>(p)[i] = r.w[i];
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

// ---- forward ----

// Stages, for rows row0 .. row0 + rows - 1 of graph b, the real slots of
// each row in slot order as pairs (source row, slot d) in slots[rl * Dp
// ...] and their number in count[rl]. Every thread of the block calls it (it
// holds two barriers); blockDim.x is a multiple of 32.
__device__ __forceinline__ void stage_slots(const int32_t* __restrict__ nbr,
                                            const float* __restrict__ mask,
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
        const bool real = i <= last && m[u] > 0.f;
        slots[rl * Dp + d] = real ? make_int2(s[u], d) : make_int2(-1, 0);
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
// (z * tpr + t % tpr) * VEC, tpr = F / VEC threads a row, at most 256.
// Offsets within a graph are 32-bit (N * F < 2^31). The serve path discards
// `arg`, so kStoreArg drops its store there.
template <typename T, bool kStoreArg, int VEC>
__global__ void __launch_bounds__(kThreads, kAggMinBlocks)
max_agg_kernel(const T* __restrict__ h, const int32_t* __restrict__ nbr,
               const float* __restrict__ mask, T* __restrict__ out,
               uint8_t* __restrict__ arg, int N, int D, int F, int tpr,
               int rows, int Dp) {
  using Bits = typename BitsOf<T>::type;
  // slots whose vector loads start together: the store variant's winner
  // slots hold registers, and 2 beat 4 there at F=256 (0.075 against 0.105
  // ms in float32, 0.057 against 0.064 in bfloat16, NVIDIA H100 80GB HBM3,
  // 700 W); the serve variant takes 4 (scripts/torch_port_kernel_variants.py
  // --agg)
  constexpr int kAggChunk = kStoreArg ? 2 : 4;
  extern __shared__ int2 staged[];                // [rows, Dp], then count
  int* count = reinterpret_cast<int*>(staged + rows * Dp);
  const int b = blockIdx.y;
  const int row0 = blockIdx.x * rows;
  stage_slots(nbr, mask, staged, count, b, row0, rows, N, D, Dp);

  const int rl = threadIdx.x / tpr;
  const int r = row0 + rl;
  const int f = (blockIdx.z * tpr + threadIdx.x - rl * tpr) * VEC;
  if (rl >= rows || r >= N || f >= F) return;
  const int n = count[rl];
  const int2* rs = staged + rl * Dp;
  const T* hb = h + (int64_t)b * N * F + f;
  // the winners' slots as VEC bytes, packed four to a register
  float best[VEC];
  Pack<uint8_t, VEC> win;
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    best[k] = kNegLarge;
    win.v[k] = 0;
  }
  for (int k0 = 0; k0 < n; k0 += kAggChunk) {
    int d[kAggChunk];
    Pack<Bits, VEC> v[kAggChunk];
#pragma unroll
    for (int c = 0; c < kAggChunk; ++c) {
      if (k0 + c < n) {
        const int2 s = rs[k0 + c];
        d[c] = s.y;
        v[c].raw = load_raw<sizeof(Bits) * VEC>(hb + s.x * F);
      }
    }
    // in slot order with a strict `>`: the first slot that attains the max
    // wins, as in the plain version
#pragma unroll
    for (int c = 0; c < kAggChunk; ++c) {
      if (k0 + c < n) {
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          const float x = bits_to_float(v[c].v[k]);
          if (x > best[k]) {
            best[k] = x;
            win.v[k] = (uint8_t)d[c];
          }
        }
      }
    }
  }
  const int64_t o = ((int64_t)b * N + r) * F + f;
  Pack<Bits, VEC> ov;
#pragma unroll
  for (int k = 0; k < VEC; ++k) ov.v[k] = float_to_bits(n > 0 ? best[k] : 0.f, Bits());
  store_raw(out + o, ov.raw);
  if (kStoreArg) store_raw(arg + o, win.raw);
}

// ---- backward ----

constexpr int kBwdThreads = 256;
// rows x D slots staged a block, as int2: 48 000 bytes, under the 48 KB a
// block gets without opting in (D=128 leaves 46 rows)
constexpr int kMaxStaged = 6000;

// One block per (tile of `rows` destination rows, graph b, run z of
// features); thread t serves row t / tpr and the VEC features starting at
// (z * tpr + t % tpr) * VEC, tpr = F / VEC threads a row, at most 256, so z
// is 0 at the model's widths. A warp may span several rows, so no lane idles
// at narrow F. VEC divides F and every pointer is aligned to a vector, so
// each access is one aligned vector. Offsets within a graph are 32-bit
// (N * F < 2^31). One vector a thread: a loop over several would cost
// registers, and with them threads on an SM.
template <typename T, int VEC>
__global__ void __launch_bounds__(kBwdThreads)
max_agg_bwd_kernel(const T* __restrict__ gout, const uint8_t* __restrict__ arg,
                   const int32_t* __restrict__ nbr,
                   const float* __restrict__ mask,
                   const int32_t* __restrict__ rslot, T* __restrict__ grad,
                   int N, int D, int F, int tpr, int rows) {
  using Bits = typename BitsOf<T>::type;
  // slots whose loads start together; more would hold more registers
  // (58-133 a thread at 4-8 slots and VEC=8, against 45-48) and keep fewer
  // threads on an SM
  constexpr int kChunk = 2;
  extern __shared__ int2 staged[];   // [rows, D]: (source row or -1, rslot)
  __shared__ int n_slots;            // 1 + the block's last real slot
  const int b = blockIdx.y;
  const int row0 = blockIdx.x * rows;
  if (threadIdx.x == 0) n_slots = 0;
  __syncthreads();
  int last = 0;
  for (int i = threadIdx.x; i < rows * D; i += blockDim.x) {
    const int rl = i / D;
    const int d = i - rl * D;
    int2 s = make_int2(-1, 0);
    if (row0 + rl < N) {
      // three independent loads, so the staging costs one round trip
      const int64_t off = ((int64_t)b * N + row0 + rl) * D + d;
      const float m = __ldg(mask + off);
      const int32_t v = __ldg(nbr + off), j = __ldg(rslot + off);
      if (m > 0.f) {
        s = make_int2(v, j);
        last = max(last, d + 1);
      }
    }
    staged[i] = s;
  }
  if (last > 0) atomicMax(&n_slots, last);
  __syncthreads();

  const int rl = threadIdx.x / tpr;
  const int r = row0 + rl;
  const int f = (blockIdx.z * tpr + threadIdx.x - rl * tpr) * VEC;
  if (r >= N || f >= F) return;
  const int2* row_slots = staged + rl * D;
  const T* gb = gout + (int64_t)b * N * F + f;
  const uint8_t* ab = arg + (int64_t)b * N * F + f;
  const int n = n_slots;
  float acc[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
  for (int d0 = 0; d0 < n; d0 += kChunk) {
    // the chunk's arg vectors, all in flight before any is read
    int2 s[kChunk];
    Pack<uint8_t, VEC> a[kChunk];
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      s[c] = d0 + c < n ? row_slots[d0 + c] : make_int2(-1, 0);
      if (s[c].x >= 0) a[c].raw = load_raw<VEC>(ab + s[c].x * F);
    }
    // then the gout vectors of the slots that won any of the VEC features
    unsigned hit[kChunk];
    Pack<Bits, VEC> g[kChunk];
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      hit[c] = 0;
      if (s[c].x >= 0) {
#pragma unroll
        for (int k = 0; k < VEC; ++k)
          hit[c] |= (unsigned)(a[c].v[k] == s[c].y) << k;
      }
      if (hit[c]) g[c].raw = load_raw<sizeof(Bits) * VEC>(gb + s[c].x * F);
    }
    // summed in slot order: bitwise the plain version's float32 sum
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
#pragma unroll
      for (int k = 0; k < VEC; ++k)
        if ((hit[c] >> k) & 1u) acc[k] += bits_to_float(g[c].v[k]);
    }
  }
  Pack<Bits, VEC> o;
#pragma unroll
  for (int k = 0; k < VEC; ++k) o.v[k] = float_to_bits(acc[k], Bits());
  store_raw(grad + ((int64_t)b * N + r) * F + f, o.raw);
}

// ---- launches ----

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename T, int VEC>
int launch_vec(const void* h, const void* nbr, const void* mask, void* out,
               void* arg, int B, int N, int D, int F, int store_arg,
               cudaStream_t s) {
  const int vecs = F / VEC;                       // vectors a row
  const int tpr = std::min(vecs, kThreads);       // threads a row
  const int Dp = D | 1;   // odd row stride: no bank conflicts between rows
  const size_t per_row = (size_t)Dp * sizeof(int2) + sizeof(int);
  // as many rows as fill 256 threads, within 48 KB of staged slots (at
  // least 47 rows at D=128)
  const int rows = std::min(kThreads / tpr, (int)(kSmemBudget / per_row));
  const int threads = (rows * tpr + 31) / 32 * 32;   // whole warps: ballots
  // graphs are the slower grid dimension: a wave of blocks gathers from the
  // rows of about one graph, which stay in L2
  const dim3 grid((N + rows - 1) / rows, B, (vecs + tpr - 1) / tpr);
  if (grid.z > 65535) return (int)cudaErrorInvalidValue;
  const size_t smem = rows * per_row;
  const T* hp = static_cast<const T*>(h);
  const int32_t* np = static_cast<const int32_t*>(nbr);
  const float* mp = static_cast<const float*>(mask);
  T* op = static_cast<T*>(out);
  if (store_arg)
    max_agg_kernel<T, true, VEC><<<grid, threads, smem, s>>>(
        hp, np, mp, op, static_cast<uint8_t*>(arg), N, D, F, tpr, rows, Dp);
  else
    max_agg_kernel<T, false, VEC><<<grid, threads, smem, s>>>(
        hp, np, mp, op, nullptr, N, D, F, tpr, rows, Dp);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* h, const void* nbr, const void* mask, void* out,
           void* arg, int B, int N, int D, int F, int store_arg,
           void* stream) {
  if (B <= 0 || N <= 0 || F <= 0) return (int)cudaSuccess;
  if (D <= 0 || D > kMaxDegree || B > 65535 || (int64_t)N * F >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the widest vector of at most 16 bytes that divides F and to which h,
  // out and (when stored) arg are aligned
  auto fits = [&](int vec) {
    return F % vec == 0 && aligned(h, vec * (int)sizeof(T)) &&
           aligned(out, vec * (int)sizeof(T)) && (!store_arg || aligned(arg, vec));
  };
  if constexpr (sizeof(T) == 2) {
    if (fits(8)) return launch_vec<T, 8>(h, nbr, mask, out, arg, B, N, D, F, store_arg, s);
  }
  if (fits(4)) return launch_vec<T, 4>(h, nbr, mask, out, arg, B, N, D, F, store_arg, s);
  if (fits(2)) return launch_vec<T, 2>(h, nbr, mask, out, arg, B, N, D, F, store_arg, s);
  return launch_vec<T, 1>(h, nbr, mask, out, arg, B, N, D, F, store_arg, s);
}

template <typename T, int VEC>
int launch_bwd_vec(const void* gout, const void* arg, const void* nbr,
                   const void* mask, const void* rslot, void* grad, int B,
                   int N, int D, int F, cudaStream_t s) {
  const int tpr = std::min(F / VEC, kBwdThreads);   // threads a row
  const int rows = std::min(kBwdThreads / tpr, kMaxStaged / D);
  // graphs are the slower grid dimension: a wave of blocks gathers from the
  // rows of about one graph, which fit L2 (10.5 MB at 8192 x 256 in float32)
  const dim3 grid((N + rows - 1) / rows, B, (F / VEC + tpr - 1) / tpr);
  const size_t smem = (size_t)rows * D * sizeof(int2);
  max_agg_bwd_kernel<T, VEC><<<grid, rows * tpr, smem, s>>>(
      static_cast<const T*>(gout), static_cast<const uint8_t*>(arg),
      static_cast<const int32_t*>(nbr), static_cast<const float*>(mask),
      static_cast<const int32_t*>(rslot), static_cast<T*>(grad), N, D, F,
      tpr, rows);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* gout, const void* arg, const void* nbr,
               const void* mask, const void* rslot, void* grad, int B, int N,
               int D, int F, void* stream) {
  if (B <= 0 || N <= 0 || F <= 0) return (int)cudaSuccess;
  if (D <= 0 || D > kMaxDegree || B > 65535 || (int64_t)N * F >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the widest vector that divides F and to which every pointer is aligned
  auto fits = [&](int vec) {
    return F % vec == 0 && aligned(gout, vec * (int)sizeof(T)) &&
           aligned(grad, vec * (int)sizeof(T)) && aligned(arg, vec);
  };
  if (fits(8))
    return launch_bwd_vec<T, 8>(gout, arg, nbr, mask, rslot, grad, B, N, D, F, s);
  if (fits(4))
    return launch_bwd_vec<T, 4>(gout, arg, nbr, mask, rslot, grad, B, N, D, F, s);
  if (fits(2))
    return launch_bwd_vec<T, 2>(gout, arg, nbr, mask, rslot, grad, B, N, D, F, s);
  return launch_bwd_vec<T, 1>(gout, arg, nbr, mask, rslot, grad, B, N, D, F, s);
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
