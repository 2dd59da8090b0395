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
// versions (ops/kernels/weighted_sum.py). The pair dot sums over F in FMAs
// over each lane's vectors and then across lanes with xor shuffles, another
// order than the plain version's sum. No kernel uses atomics: every result
// is the same run to run.
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
// a row, those re-reads are ~1.7 GB from L2 at HF=1024, so a good kernel
// sits at 2-3x the byte bound, not at 1x.
//
// All three read nbr directly. The TPU kernels' weighted one-hot histograms
// on the MXU over a compacted unique-row block, carried as bf16 hi/lo
// halves (weighted_sum.py:8-15, 95-110), work around slow row gathers on
// the TPU. Shared by all three:
//  * each thread owns aligned vectors of VEC contiguous features inside one
//    head (VEC = 8, 4, 2 or 1, the widest that divides F, keeps a load at 16
//    bytes, float32 at most 4 and bfloat16 at most 8, and to which the
//    feature pointers are aligned), read and written as one vector;
//  * graphs are the slower grid dimension (blockIdx.y), so a wave gathers
//    from the rows of about one graph, which stay in L2;
//  * staging, one round trip: the block loads mask, nbr and (reverse) rslot
//    of all its rows' slots at once (several entries a thread in flight),
//    then compacts each row's real slots in slot order in shared memory
//    with warp ballots and keeps their number (stage_slots). Loops over
//    slots run over the real slots alone and never test a padded one;
//  * a chunk of slots' loads is in flight before their arithmetic; the
//    chunk and the launch bound are tuned together for registers, since
//    blocks resident on an SM decide (scripts/torch_port_kernel_variants.py).
//
// Combine (the layout of max_agg.cu's backward): threads map flat onto
// (row, vector): at HF=4 in float32 one thread is a row, at HF=256 a row
// takes 64 threads and a block of 256 four rows. A row of more than 256
// vectors (F=515) takes a third grid dimension over feature runs. Each
// slot's weight is read in the feature loop beside the slot's vector: both
// depend on the staged (source, slot) pair alone, so the reverse weight
// w[v, rslot] costs no second dependent round trip before the loop, and no
// shared memory (the lanes of one head read one address, one transaction a
// warp). kChunk slots' loads are in flight before their adds. The adds then
// run in slot order, one rounding each; skipping a padded slot equals the
// plain version's add of +0.0 (a float32 sum from +0.0 never becomes -0.0),
// so the result stays bitwise the plain version's.
//
// Pair dot (the layout of fused_gat.cu's backward, whose d_alpha is the
// same dot): a group of L lanes owns one (row, head), L the head's vectors
// rounded up to a power of two, at most 32 and at most 256 / H, each lane
// holding one or two vectors of a (two once a head has kPdTwoAt vectors:
// (4,256) is 32 lanes of two vectors of 4 in float32 and 16 lanes of two
// vectors of 8 in bfloat16, (1,20) 8 lanes of which 3 idle, (1,4) one lane
// that needs no shuffle). The groups of a row
// are adjacent, threads run flat over (row, head, lane) in blocks of whole
// warps, at most kPdMaxRows rows a block. a is loaded once per row into
// registers. For each chunk of kPdChunk real slots the lanes load the c
// vectors, dot them with a, and reduce the chunk's dots across the L lanes
// together with xor shuffles: each exchange halves the values a lane
// holds, so a chunk costs kPdChunk - 1 + log2(L / kPdChunk) shuffles, not
// kPdChunk * log2(L) as one slot at a time. The lane left holding a slot's dot
// writes it at the slot's position among the block's scores in shared
// memory, which start at +0.0, so padded slots stay +0.0; the block then
// writes its rows' D*H scores as one contiguous, coalesced run. What holds
// it above the byte bound is what holds the combines: the D-fold re-reads
// of c rows from L2 in float32; in bfloat16, whose bytes are half, the
// per-slot chain of a block (staging, a round trip per chunk) as well.
// Left for later: cp.async or TMA staging, persistent blocks that stage
// the next rows while the current ones compute.

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

// slots whose c vectors a lane loads together, and the launch bound (blocks
// of 256 threads an SM that the registers must allow: 4, 64 registers). A
// bound of 6 blocks spills at float32's two vectors of 4
// (scripts/torch_port_kernel_variants.py --dec)
constexpr int kPdChunk = 4;
constexpr int kPdMinBlocks = 4;
// vectors a head from which a lane holds two: fewer lanes a head, so fewer
// shuffles and more loads in flight a lane (bfloat16 at F=256, 32 vectors
// of 8, took 0.65x the time of 32 lanes of one)
constexpr int kPdTwoAt = 32;
// rows a pair-dot block takes at most: at (H,F) = (1,4) a thread is a row,
// and 256 rows a block would leave 192 blocks for 132 SMs
constexpr int kPdMaxRows = 128;

// One block per (tile of `rows` rows, graph b). Thread t is lane t % L of
// the group t / L, which owns (row, head) = ((t / L) / H, (t / L) % H);
// lane l holds a's vectors l, l + L, ... of the head (NV of them a run of
// L * NV vectors; a head of more vectors goes in runs, each adding its
// part of every dot in shared memory). Shared memory: the staged slots
// [rows, Dp] and count [rows], then the block's scores [rows, D*H], +0.0
// where no real slot writes. Offsets within a graph are 32-bit (N * HF and
// N * D * H < 2^31).
template <typename T, int VEC, int NV>
__global__ void __launch_bounds__(kThreads, kPdMinBlocks)
pairdot_kernel(const T* __restrict__ a, const T* __restrict__ c,
               const int32_t* __restrict__ nbr, const float* __restrict__ mask,
               float* __restrict__ scores, int N, int D, int H, int F, int L,
               int rows, int Dp) {
  using Bits = typename BitsOf<T>::type;
  constexpr int C = kPdChunk;
  extern __shared__ int2 slots[];                 // [rows, Dp], then count
  int* count = reinterpret_cast<int*>(slots + rows * Dp);
  const int DH = D * H;
  float* sc = reinterpret_cast<float*>(count + rows);   // [rows, DH]
  const int b = blockIdx.y;
  const int row0 = blockIdx.x * rows;
  for (int i = threadIdx.x; i < rows * DH; i += blockDim.x) sc[i] = 0.f;
  stage_slots<false>(nbr, mask, nullptr, slots, count, b, row0, rows, N, D, Dp);

  const int HF = H * F;
  const int vph = F / VEC;                        // vectors a head
  const int gl = threadIdx.x & (L - 1);
  const int pair = threadIdx.x / L;
  const int rl = pair / H;
  const int h = pair - rl * H;
  const bool live = rl < rows && row0 + rl < N;
  const int n = live ? count[rl] : 0;
  // every lane of a warp runs every shuffle: the loops' bounds are uniform
  const int nmax = __reduce_max_sync(0xffffffffu, n);
  const T* ar = a + ((int64_t)b * N + row0 + rl) * HF + h * F;
  const T* cb = c + (int64_t)b * N * HF + h * F;
  const int2* rs = slots + rl * Dp;
  float* sr = sc + rl * DH + h;
  for (int j0 = 0; j0 < vph; j0 += L * NV) {
    Pack<Bits, VEC> av[NV];                       // this run's a vectors
    bool has[NV];
#pragma unroll
    for (int q = 0; q < NV; ++q) {
      const int j = j0 + q * L + gl;
      has[q] = n > 0 && j < vph;
      if (has[q]) av[q].raw = load_raw<sizeof(Bits) * VEC>(ar + j * VEC);
    }
    for (int k0 = 0; k0 < nmax; k0 += C) {
      Pack<Bits, VEC> cv[C][NV];
#pragma unroll
      for (int s = 0; s < C; ++s) {
        if (k0 + s < n) {
          const T* cs = cb + rs[k0 + s].x * HF;
#pragma unroll
          for (int q = 0; q < NV; ++q)
            if (has[q])
              cv[s][q].raw = load_raw<sizeof(Bits) * VEC>(cs + (j0 + q * L + gl) * VEC);
        }
      }
      float part[C];
#pragma unroll
      for (int s = 0; s < C; ++s) {
        part[s] = 0.f;
        if (k0 + s < n) {
#pragma unroll
          for (int q = 0; q < NV; ++q)
            if (has[q]) {
#pragma unroll
              for (int k = 0; k < VEC; ++k)
                part[s] = fmaf(bits_to_float(av[q].v[k]),
                               bits_to_float(cv[s][q].v[k]), part[s]);
            }
        }
      }
      // across the group's L lanes, each exchange halving the values a lane
      // holds: afterwards this lane holds the dots of chunk slots first ..
      // first + held - 1 in part[0 ..], and the lanes whose bits in `rest`
      // are 0 write them
      int first = 0, held = C;
      int o = L >> 1;
#pragma unroll
      for (int hs = C / 2; hs >= 1; hs >>= 1) {
        if (o > 0) {                              // uniform in the warp
          const bool up = (gl & o) != 0;
#pragma unroll
          for (int i = 0; i < hs; ++i) {
            const float send = up ? part[i] : part[i + hs];
            const float keep = up ? part[i + hs] : part[i];
            part[i] = keep + __shfl_xor_sync(0xffffffffu, send, o);
          }
          if (up) first += hs;
          held = hs;
          o >>= 1;
        }
      }
      const unsigned rest = o > 0 ? 2u * o - 1u : 0u;
      for (; o > 0; o >>= 1) part[0] += __shfl_xor_sync(0xffffffffu, part[0], o);
      if ((gl & rest) == 0) {
#pragma unroll
        for (int i = 0; i < C; ++i) {
          const int k = k0 + first + i;
          if (i < held && k < n) {
            float* p = sr + rs[k].y * H;
            *p = j0 == 0 ? part[i] : *p + part[i];
          }
        }
      }
    }
  }
  __syncthreads();
  // the block's rows' scores, padded slots +0.0, as one contiguous run
  const int live_rows = min(rows, N - row0);
  float* out = scores + ((int64_t)b * N + row0) * DH;
  for (int i = threadIdx.x; i < live_rows * DH; i += blockDim.x) out[i] = sc[i];
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

template <typename T, int VEC, int NV>
int launch_pairdot_vec(const void* a, const void* c, const void* nbr,
                       const void* mask, void* scores, int B, int N, int D,
                       int H, int F, cudaStream_t s) {
  // lanes per (row, head): a power of two covering the head's vectors, NV a
  // lane, at most 32 (a warp) and at most 256 / H (a row fits a block)
  const int vph = F / VEC;
  int L = 1;
  while (L < 32 && L * NV < vph && 2 * L * H <= kThreads) L *= 2;
  const int lanes = H * L;
  const int Dp = D | 1;   // odd row stride: no bank conflicts between rows
  const size_t per_row = (size_t)Dp * sizeof(int2) + sizeof(int) +
                         (size_t)D * H * sizeof(float);
  // as many rows as fill 256 threads, at most kPdMaxRows, within 48 KB of
  // shared memory (at least 5 rows at D=128, H=16)
  const int rows = std::max(1, std::min({kThreads / lanes, kPdMaxRows,
                                         (int)(kSmemBudget / per_row)}));
  const int threads = (rows * lanes + 31) / 32 * 32;   // whole warps: shuffles
  const dim3 grid((N + rows - 1) / rows, B);
  pairdot_kernel<T, VEC, NV><<<grid, threads, rows * per_row, s>>>(
      static_cast<const T*>(a), static_cast<const T*>(c),
      static_cast<const int32_t*>(nbr), static_cast<const float*>(mask),
      static_cast<float*>(scores), N, D, H, F, L, rows, Dp);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_pairdot(const void* a, const void* c, const void* nbr,
                   const void* mask, void* scores, int B, int N, int D, int H,
                   int F, void* stream) {
  const int rc = check_dims(B, N, D, H, F);
  if (rc != (int)cudaSuccess) return rc;
  if (B == 0 || N == 0) return (int)cudaSuccess;
  if (B > 65535 || (int64_t)N * H * F >= (1LL << 31) ||
      (int64_t)N * D * H >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the widest vector of at most 16 bytes that divides F and to which a
  // and c are aligned; two vectors a lane once a head has kPdTwoAt or more
  auto fits = [&](int vec) {
    return F % vec == 0 && aligned(a, vec * (int)sizeof(T)) &&
           aligned(c, vec * (int)sizeof(T));
  };
#define GTS_PAIRDOT(VEC)                                                       \
  (F / VEC >= kPdTwoAt                                                         \
       ? launch_pairdot_vec<T, VEC, 2>(a, c, nbr, mask, scores, B, N, D, H, F, s) \
       : launch_pairdot_vec<T, VEC, 1>(a, c, nbr, mask, scores, B, N, D, H, F, s))
  if constexpr (sizeof(T) == 2) {
    if (fits(8)) return GTS_PAIRDOT(8);
  }
  if (fits(4)) return GTS_PAIRDOT(4);
  if (fits(2)) return GTS_PAIRDOT(2);
  return GTS_PAIRDOT(1);
#undef GTS_PAIRDOT
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
