// Fused GAT attention over the ELL neighbour table: the forward (edge
// softmax, weighted combine and the layer epilogue in one kernel), its
// backward through the softmax, and the reverse combine that routes the
// gradient to the source nodes.
//
// Layouts (B graphs, N rows, D slots, H heads of F features, HF = H*F):
//   z, gout, out, res, d_z  [B, N, HF]   float32 or bfloat16 (one type, T)
//   el, er                  [B, N, H]    T
//   bias                    [HF]         T
//   nbr, rslot              [B, N, D]    int32
//   mask                    [B, N, D]    float32 (> 0 on a real slot)
//   alpha, d_pre            [B, N, D*H]  float32, slot-major (d*H + h)
//   pos                     [B, N, D*H]  uint8, 1 where the LeakyReLU output
//                                        of a real slot is >= 0
//   d_er, d_el              [B, N, H]    float32
//
// 1. gat_fwd_kernel replaces gnn_tumor_seg_tpu/ops/pallas/fused_gat.py:103
//    `_fwd_kernel` (launched by `_fused_fwd_raw`, fused_gat.py:350):
//      pre[v,d,h]   = LeakyReLU(el[nbr[v,d],h] + er[v,h])
//      alpha[v,:,h] = softmax over the real slots (0 on rows without one:
//                     the exp runs over the masked logit, fused_gat.py:136-146)
//      out[v,h,:]   = act(sum_d alpha[v,d,h] z[nbr[v,d],h,:] + bias + res),
//                     act ELU (exp argument clamped, :177-179) or none.
//    Training stores alpha (float32) and the sign of pre as a uint8 mask:
//    the backward reads only that sign (LeakyReLU' = 1 where pre >= 0, else
//    the slope), so one byte replaces the TPU kernel's bf16 pre. Serving
//    stores neither.
// 2. gat_bwd_kernel replaces fused_gat.py:186 `_bwd_kernel` (in `_fga_bwd`,
//    :420); gout is already multiplied by ELU' (:426-428):
//      d_alpha[v,d,h] = <gout[v,h,:], z[nbr[v,d],h,:]>
//      d_pre[v,d,h]   = mask * LeakyReLU'(pre) * alpha (d_alpha - sum_d alpha d_alpha)
//      d_er[v,h]      = sum_d d_pre[v,d,h].
// 3. gat_rev_kernel replaces fused_gat.py:238 `_bwd2_kernel` (via
//    `_reverse_combine`, :311). On the symmetric, deduplicated table,
//    rslot[u,d] is the slot of u in row v = nbr[u,d], so the transposed
//    products are gathers, with no scatter and no atomics:
//      d_z[u,h,:] = sum_d alpha[v,rslot[u,d],h] gout[v,h,:]
//      d_el[u,h]  = sum_d d_pre[v,rslot[u,d],h].
//
// Arithmetic is float32 in every type; sums over slots run in slot order.
// Kernels 1 and 3 use explicitly rounded adds and products (__fadd_rn,
// __fmul_rn, which nvcc never contracts into an FMA), so the reverse
// combine is bitwise equal to its plain PyTorch version
// (ops/kernels/fused_gat.py) and the forward differs from it only where
// CUDA's expf and PyTorch's exp differ: given alpha, its combine is bitwise
// the plain version's. The backward's dot over F runs in FMAs over each
// lane's vectors and then a shuffle tree, another order than the plain
// version's sum. No kernel uses atomics: every result is the same run to
// run.
//
// What bounds them on an H100: bytes. Per (row, slot, feature) each does
// one or two flops; the traffic is z (forward, backward) or gout (reverse)
// read once per referenced row, the output written once, and the per-slot
// tables (nbr, mask, alpha, pos, d_pre: a few bytes per slot and head). A
// hidden layer of the training batch (B=6, N=8192, HF=1024, float32) has
// z, gout, out and d_z of 201 MB each, beyond the 50 MB L2, so a neighbour
// row re-read for each of its D slots comes from L2 only when the rows of
// a neighbourhood lie close together (they do for supervoxel graphs, whose
// node ids follow space). The byte bound counts each referenced row once;
// every kernel here re-reads it once per real slot (about ten a row), from
// L2 at best, so a good kernel's floor lies at some 2-3x the byte bound.
//
// Design. The TPU kernels' unique-row compaction and one-hot MXU
// contractions (fused_gat.py:70-80, 115-126) work around slow row gathers
// on the TPU; here every kernel reads nbr directly. All three share one
// layout and one staging step:
//  * each thread owns an aligned vector of VEC contiguous features inside
//    one head (VEC = 8, 4, 2 or 1, the widest that divides F with a load of
//    at most 16 bytes, and to which the feature pointers are aligned);
//  * the block owns whole rows, all heads; graphs are the slower grid
//    dimension, so a wave gathers from the rows of about one graph, which
//    stay in L2. The rows a block takes are bounded by its threads, by 48
//    KB of shared memory (at D=128 and narrow rows) and, in the forward
//    and the backward, by kMaxRows (at HF=4, where a thread is a row, so
//    that the grid has enough blocks);
//  * staging is one round trip (stage_slots): the block loads mask and nbr
//    (and rslot, for the reverse combine) of all its rows' slots at once,
//    then compacts each row's real slots in slot order in shared memory
//    with warp ballots and keeps their number; loops over slots then run
//    over the real slots alone;
//  * kChunk slots' loads are in flight before their arithmetic; kChunk is
//    tuned for registers, since blocks resident on an SM, not loads in
//    flight a thread, decide (scripts/torch_port_kernel_variants.py).
//
// Forward: threads map flat onto (row, vector): at (H,F) = (4,256) a block
// of 256 threads is a row in float32 (two in bfloat16), at (1,4) in float32
// a thread is a row; a row of more than 256 vectors takes a third grid
// dimension (each of its blocks recomputes the row's softmax; the first
// stores it). After staging, one pass loads el[nbr] for every (row, real
// slot, head) of the block with the loads in flight together and writes the
// logit, and a flag (real, sign), at the slot's position in shared memory;
// one thread per (row, head) runs the softmax over the slot positions as
// the plain version does (max, exp, sum in slot order, alpha = e * (1 /
// max(sum, 1e-20)), so a row without a real slot gets alpha 0 and no NaN).
// Training then writes alpha and the sign mask of the block's rows as one
// contiguous span each, 0 on padded slots. In the feature loop each real
// slot's alpha comes from shared memory beside its z vector; bias, res and
// ELU are applied to the vector, which is stored once.
//
// Backward: a group of G lanes (a power of two up to 32) owns one (row,
// head) and keeps that head's gout in registers as vectors (at F=256: 32
// lanes, two vectors of 4 each in float32, one of 8 in bfloat16; at F=4 one
// lane); the groups of a row are adjacent, so a head's dot reduces inside
// one warp. For each chunk of real slots the lanes load the z vectors, dot
// them with gout, and reduce the chunk's dots together in one shuffle tree;
// the group's first lane writes d_alpha at the slot's position in shared
// memory (0 on padded slots) and then sums alpha d_alpha in slot order. The
// softmax and LeakyReLU backward run over the block's rows as one
// contiguous span (alpha, pos, mask read and d_pre written coalesced), and
// one thread per (row, head) sums d_er in slot order.
//
// Reverse combine (the design of weighted_sum.cu's combine, whose reverse
// instantiation computes the same d_z with alpha as the weights): threads
// flat over (row, vector) as in the forward; the feature loop reads the
// reverse alpha[v, rslot, h] beside the slot's gout vector (both depend on
// the staged (v, rslot) pair alone, so the dependent load costs no round
// trip of its own). After d_z's store, the thread that owns a head's first
// vector reads d_pre[v, rslot, h] over the same staged slots and sums d_el
// in slot order. Skipping a padded slot equals the plain version's add of
// +0.0, so d_z and d_el stay bitwise the plain version's.

#include <algorithm>
#include <cstdint>
#include <initializer_list>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegLarge = -1e30f;
constexpr int kMaxDegree = 128;
constexpr int kMaxHeads = 16;
constexpr int kThreads = 256;
// the backward gives a row H groups of up to 32 lanes: 512 at 16 heads
constexpr int kBwdMaxThreads = 512;
constexpr size_t kSmemBudget = 48 * 1024;
// table entries (mask, nbr, rslot; el) a thread loads together while staging
constexpr int kStageUnroll = 4;
// rows a forward or backward block takes at most: at the output layer's
// HF=4 a thread is a row, and 256 rows a block would leave 192 blocks for
// 132 SMs (scripts/torch_port_kernel_variants.py)
constexpr int kMaxRows = 128;
// blocks of 256 threads an SM that the forward's registers must allow: 8
// (32 registers a thread), 6 (40) at bfloat16's vectors of 8, which spill
// at 32 (scripts/torch_port_kernel_variants.py)
template <typename T, int VEC>
constexpr int kFwdMinBlocks = sizeof(T) == 2 && VEC == 8 ? 6 : 8;

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

// Stages, for rows row0 .. row0 + rows - 1 of graph b, the real slots of
// each row in slot order as pairs (source row v, rslot) when kRslot, else
// (source row v, slot position d), in slots[rl * Dp ...], and their number
// in count[rl]. Every thread of the block calls it (it holds two
// barriers); blockDim.x is a multiple of 32.
template <bool kRslot>
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
      if (kRslot) k[u] = __ldg(rslot + off);
    }
#pragma unroll
    for (int u = 0; u < kStageUnroll; ++u) {
      const int i = i0 + u * nt;
      if (i < total) {
        const int rl = i / D;
        const int d = i - rl * D;
        const bool real = i <= last && m[u] > 0.f;
        slots[rl * Dp + d] = real ? make_int2(s[u], kRslot ? k[u] : d) : make_int2(-1, 0);
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

// ---------------------------------------------------------------- forward

// One block per (tile of `rows` destination rows, graph b, run z of
// vectors); thread t serves row t / tpr and the VEC features starting at
// (z * tpr + t % tpr) * VEC, tpr = HF / VEC threads a row, at most 256.
// Shared memory: the staged slots [rows, Dp] and count [rows], then the
// logits (then alpha) [rows, D*H] and their flags [rows, D*H] (bit 0: a
// real slot, bit 1: its LeakyReLU output is >= 0) at slot positions.
// alpha_out and pos_out are null when serving. Offsets within a graph are
// 32-bit (N * HF and N * D * H < 2^31).
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, kFwdMinBlocks<T, VEC>)
gat_fwd_kernel(const T* __restrict__ z, const T* __restrict__ el,
               const T* __restrict__ er, const int32_t* __restrict__ nbr,
               const float* __restrict__ mask, const T* __restrict__ bias,
               const T* __restrict__ res, T* __restrict__ out,
               float* __restrict__ alpha_out, uint8_t* __restrict__ pos_out,
               int N, int D, int H, int F, float slope, bool act, int tpr,
               int rows, int Dp) {
  using Bits = typename BitsOf<T>::type;
  // slots whose loads start together: 2 keeps float32 at 40 registers and
  // was fastest in both types (scripts/torch_port_kernel_variants.py)
  constexpr int kFwdChunk = 2;
  extern __shared__ int2 slots[];                 // [rows, Dp], then count
  int* count = reinterpret_cast<int*>(slots + rows * Dp);
  const int DH = D * H;
  float* w = reinterpret_cast<float*>(count + rows);                // [rows, DH]
  uint8_t* flag = reinterpret_cast<uint8_t*>(w + rows * DH);        // [rows, DH]
  const int b = blockIdx.y;
  const int row0 = blockIdx.x * rows;
  const int nt = blockDim.x;
  const int total = rows * DH;
  // padded slots keep the -1e30 sentinel and flag 0 (before the staging
  // barrier)
  for (int i = threadIdx.x; i < total; i += nt) {
    w[i] = kNegLarge;
    flag[i] = 0;
  }
  stage_slots<false>(nbr, mask, nullptr, slots, count, b, row0, rows, N, D, Dp);

  // logits of every (row, real slot, head), kStageUnroll a thread in flight
  const int64_t graph = (int64_t)b * N;
  for (int i0 = threadIdx.x; i0 < total; i0 += kStageUnroll * nt) {
    float e[kStageUnroll], q[kStageUnroll];
    int at[kStageUnroll];
#pragma unroll
    for (int u = 0; u < kStageUnroll; ++u) {
      const int i = i0 + u * nt;
      at[u] = -1;
      if (i < total) {
        const int ri = i / DH;
        const int rem = i - ri * DH;
        const int k = rem / H;
        const int hi = rem - k * H;
        if (k < count[ri]) {
          const int2 s = slots[ri * Dp + k];
          e[u] = load_as_float(el + (graph + s.x) * H + hi);
          q[u] = load_as_float(er + (graph + row0 + ri) * H + hi);
          at[u] = ri * DH + s.y * H + hi;         // the slot's position
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kStageUnroll; ++u) {
      if (at[u] >= 0) {
        const float p = __fadd_rn(e[u], q[u]);
        const float logit = p >= 0.f ? p : __fmul_rn(p, slope);
        w[at[u]] = logit;
        flag[at[u]] = logit >= 0.f ? 3 : 1;
      }
    }
  }
  __syncthreads();

  // masked softmax over the slot positions, one thread per (row, head),
  // as the plain version computes it
  for (int i = threadIdx.x; i < rows * H; i += nt) {
    const int ri = i / H;
    float* wr = w + ri * DH + (i - ri * H);
    const uint8_t* fr = flag + ri * DH + (i - ri * H);
    float mx = kNegLarge;
    for (int d = 0; d < D; ++d) mx = fmaxf(mx, wr[d * H]);
    float sum = 0.f;
    for (int d = 0; d < D; ++d) {
      const float e = (fr[d * H] & 1) ? expf(__fsub_rn(wr[d * H], mx)) : 0.f;
      wr[d * H] = e;
      sum = __fadd_rn(sum, e);
    }
    const float inv = __fdiv_rn(1.f, fmaxf(sum, 1e-20f));
    for (int d = 0; d < D; ++d) wr[d * H] = __fmul_rn(wr[d * H], inv);
  }
  __syncthreads();

  // training: alpha and the sign mask of the block's rows, each one
  // contiguous span
  if (alpha_out != nullptr && blockIdx.z == 0) {
    const int n = min(rows, N - row0) * DH;
    float* ao = alpha_out + (graph + row0) * DH;
    uint8_t* po = pos_out + (graph + row0) * DH;
    for (int i = threadIdx.x; i < n; i += nt) {
      ao[i] = w[i];
      po[i] = flag[i] >> 1;
    }
  }

  // weighted combine over the real slots, in slot order, and the epilogue
  const int HF = H * F;
  const int rl = threadIdx.x / tpr;
  const int r = row0 + rl;
  const int f = (blockIdx.z * tpr + threadIdx.x - rl * tpr) * VEC;
  if (rl >= rows || r >= N || f >= HF) return;
  const int n = count[rl];
  const int2* rs = slots + rl * Dp;
  const float* ar = w + rl * DH + f / F;
  const T* zb = z + graph * HF + f;
  float acc[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
  for (int k0 = 0; k0 < n; k0 += kFwdChunk) {
    float a[kFwdChunk];
    Pack<Bits, VEC> g[kFwdChunk];
#pragma unroll
    for (int c = 0; c < kFwdChunk; ++c) {
      if (k0 + c < n) {
        const int2 s = rs[k0 + c];
        a[c] = ar[s.y * H];
        g[c].raw = load_raw<sizeof(Bits) * VEC>(zb + s.x * HF);
      }
    }
#pragma unroll
    for (int c = 0; c < kFwdChunk; ++c) {
      if (k0 + c < n) {
#pragma unroll
        for (int k = 0; k < VEC; ++k)
          acc[k] = __fadd_rn(acc[k], __fmul_rn(a[c], bits_to_float(g[c].v[k])));
      }
    }
  }
  const int64_t node = graph + r;
  Pack<Bits, VEC> bv, rv, o;
  bv.raw = load_raw<sizeof(Bits) * VEC>(bias + f);
  if (res != nullptr) rv.raw = load_raw<sizeof(Bits) * VEC>(res + node * HF + f);
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    float v = __fadd_rn(acc[k], bits_to_float(bv.v[k]));
    if (res != nullptr) v = __fadd_rn(v, bits_to_float(rv.v[k]));
    if (act) v = v > 0.f ? v : __fsub_rn(expf(fminf(v, 0.f)), 1.f);
    o.v[k] = float_to_bits(v, Bits());
  }
  store_raw(out + node * HF + f, o.raw);
}

// --------------------------------------------------------------- backward

// One block per (tile of `rows` rows, graph b). Thread t is lane t % G of
// the group t / G, which owns (row, head) = ((t / G) / H, (t / G) % H);
// lane l holds the head's gout vectors l, l + G, ... (NV of them a run of
// G * NV vectors; a head of more vectors goes in runs). Shared memory: the
// staged slots [rows, Dp] and count [rows], d_alpha (then d_pre) [rows,
// D*H] at slot positions, and sum_d alpha d_alpha [rows, H].
template <typename T, int VEC, int NV>
__global__ void __launch_bounds__(kBwdMaxThreads)
gat_bwd_kernel(const T* __restrict__ gout, const T* __restrict__ z,
               const float* __restrict__ alpha, const uint8_t* __restrict__ pos,
               const int32_t* __restrict__ nbr, const float* __restrict__ mask,
               float* __restrict__ d_pre, float* __restrict__ d_er, int N,
               int D, int H, int F, int G, int rows, int Dp, float slope) {
  using Bits = typename BitsOf<T>::type;
  // slots whose z loads start together: 4 at bfloat16's vectors of 8, 2
  // elsewhere (float32's vectors of 4 spill at 4 when a lane holds one)
  // (scripts/torch_port_kernel_variants.py)
  constexpr int kBwdChunk = VEC == 8 ? 4 : 2;
  extern __shared__ int2 slots[];                 // [rows, Dp], then count
  int* count = reinterpret_cast<int*>(slots + rows * Dp);
  const int DH = D * H;
  float* da = reinterpret_cast<float*>(count + rows);   // [rows, DH]
  float* sv = da + rows * DH;                            // [rows, H]
  const int b = blockIdx.y;
  const int row0 = blockIdx.x * rows;
  const int nt = blockDim.x;
  for (int i = threadIdx.x; i < rows * DH; i += nt) da[i] = 0.f;
  stage_slots<false>(nbr, mask, nullptr, slots, count, b, row0, rows, N, D, Dp);

  const int HF = H * F;
  const int vph = F / VEC;                        // vectors a head
  const int gl = threadIdx.x & (G - 1);
  const int pair = threadIdx.x / G;
  const int rl = pair / H;
  const int h = pair - rl * H;
  const bool live = rl < rows && row0 + rl < N;
  const int n = live ? count[rl] : 0;
  // every lane of a warp runs every shuffle: the loops' bounds are uniform
  const int nmax = __reduce_max_sync(0xffffffffu, n);
  const int64_t graph = (int64_t)b * N;
  const int64_t node = graph + row0 + rl;
  const T* go = gout + node * HF + h * F;
  const T* zb = z + graph * HF + h * F;
  const int2* rs = slots + rl * Dp;
  float* dar = da + rl * DH + h;
  for (int j0 = 0; j0 < vph; j0 += G * NV) {
    Pack<Bits, VEC> g[NV];                        // this run's gout vectors
    bool has[NV];
#pragma unroll
    for (int q = 0; q < NV; ++q) {
      const int j = j0 + q * G + gl;
      has[q] = n > 0 && j < vph;
      if (has[q]) g[q].raw = load_raw<sizeof(Bits) * VEC>(go + j * VEC);
    }
    for (int k0 = 0; k0 < nmax; k0 += kBwdChunk) {
      Pack<Bits, VEC> zv[kBwdChunk][NV];
#pragma unroll
      for (int c = 0; c < kBwdChunk; ++c) {
        if (k0 + c < n) {
          const T* zs = zb + rs[k0 + c].x * HF;
#pragma unroll
          for (int q = 0; q < NV; ++q)
            if (has[q])
              zv[c][q].raw = load_raw<sizeof(Bits) * VEC>(zs + (j0 + q * G + gl) * VEC);
        }
      }
      float part[kBwdChunk];
#pragma unroll
      for (int c = 0; c < kBwdChunk; ++c) {
        part[c] = 0.f;
        if (k0 + c < n) {
#pragma unroll
          for (int q = 0; q < NV; ++q)
            if (has[q]) {
#pragma unroll
              for (int k = 0; k < VEC; ++k)
                part[c] = fmaf(bits_to_float(g[q].v[k]),
                               bits_to_float(zv[c][q].v[k]), part[c]);
            }
        }
      }
      for (int o = G / 2; o > 0; o >>= 1) {
#pragma unroll
        for (int c = 0; c < kBwdChunk; ++c)
          part[c] += __shfl_xor_sync(0xffffffffu, part[c], o);
      }
      if (gl == 0) {
#pragma unroll
        for (int c = 0; c < kBwdChunk; ++c) {
          if (k0 + c < n) {
            float* p = dar + rs[k0 + c].y * H;
            *p = j0 == 0 ? part[c] : *p + part[c];
          }
        }
      }
    }
  }
  // the group's first lane wrote every d_alpha of its (row, head): it sums
  // alpha d_alpha over the slot positions in slot order, as the plain
  // version does
  if (live && gl == 0) {
    const float* al = alpha + node * DH + h;
    float s = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) s = __fadd_rn(s, __fmul_rn(__ldg(al + d * H), dar[d * H]));
    sv[rl * H + h] = s;
  }
  __syncthreads();

  // softmax and LeakyReLU backward over the block's rows, one contiguous
  // span: alpha, pos and mask read and d_pre written coalesced
  const int live_rows = min(rows, N - row0);
  const int64_t base = (graph + row0) * DH;
  const float* mb = mask + (graph + row0) * D;
  for (int i = threadIdx.x; i < live_rows * DH; i += nt) {
    const int r2 = i / DH;
    const int rem = i - r2 * DH;
    const int d = rem / H;
    const int h2 = rem - d * H;
    const float de = __fmul_rn(__ldg(alpha + base + i), __fsub_rn(da[i], sv[r2 * H + h2]));
    float dp = __ldg(pos + base + i) ? de : __fmul_rn(de, slope);
    if (!(__ldg(mb + r2 * D + d) > 0.f)) dp = 0.f;
    d_pre[base + i] = dp;
    da[i] = dp;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < live_rows * H; i += nt) {
    const int r2 = i / H;
    const float* p = da + r2 * DH + (i - r2 * H);
    float acc = 0.f;
    for (int d = 0; d < D; ++d) acc = __fadd_rn(acc, p[d * H]);
    d_er[(graph + row0) * H + i] = acc;
  }
}

// -------------------------------------------------------- reverse combine

// One block per (tile of `rows` destination rows, graph b, run z of
// vectors); thread t serves row t / tpr and the VEC features starting at
// (z * tpr + t % tpr) * VEC, tpr = HF / VEC threads a row, at most 256.
// Offsets within a graph are 32-bit (N * HF and N * D * H < 2^31).
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
gat_rev_kernel(const T* __restrict__ gout, const float* __restrict__ alpha,
               const float* __restrict__ d_pre, const int32_t* __restrict__ nbr,
               const float* __restrict__ mask, const int32_t* __restrict__ rslot,
               T* __restrict__ d_z, float* __restrict__ d_el, int N, int D,
               int H, int F, int tpr, int rows, int Dp) {
  using Bits = typename BitsOf<T>::type;
  // slots whose loads start together: 2 keeps float32 at 38 registers, where
  // 4 and 8 were slower; bfloat16's vectors of 8 were fastest at 4
  // (scripts/torch_port_kernel_variants.py)
  constexpr int kChunk = VEC == 8 ? 4 : 2;
  extern __shared__ int2 slots[];                 // [rows, Dp], then count
  int* count = reinterpret_cast<int*>(slots + rows * Dp);
  const int b = blockIdx.y;
  const int row0 = blockIdx.x * rows;
  stage_slots<true>(nbr, mask, rslot, slots, count, b, row0, rows, N, D, Dp);

  const int HF = H * F;
  const int rl = threadIdx.x / tpr;
  const int r = row0 + rl;
  const int f = (blockIdx.z * tpr + threadIdx.x - rl * tpr) * VEC;
  if (rl >= rows || r >= N || f >= HF) return;
  const int h = f / F;
  const int n = count[rl];
  const int2* rs = slots + rl * Dp;
  const T* gb = gout + (int64_t)b * N * HF + f;
  // alpha and d_pre of the reverse edge, in the neighbour's own row
  const int64_t graph = (int64_t)b * N * D * H + h;
  const float* ab = alpha + graph;
  float acc[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
  for (int k0 = 0; k0 < n; k0 += kChunk) {
    float a[kChunk];
    Pack<Bits, VEC> g[kChunk];
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      if (k0 + c < n) {
        const int2 s = rs[k0 + c];
        a[c] = __ldg(ab + (s.x * D + s.y) * H);
        g[c].raw = load_raw<sizeof(Bits) * VEC>(gb + s.x * HF);
      }
    }
    // in slot order: bitwise the plain version's float32 sum
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      if (k0 + c < n) {
#pragma unroll
        for (int k = 0; k < VEC; ++k)
          acc[k] = __fadd_rn(acc[k], __fmul_rn(a[c], bits_to_float(g[c].v[k])));
      }
    }
  }
  const int64_t node = (int64_t)b * N + r;
  Pack<Bits, VEC> o;
#pragma unroll
  for (int k = 0; k < VEC; ++k) o.v[k] = float_to_bits(acc[k], Bits());
  store_raw(d_z + node * HF + f, o.raw);
  if (f != h * F) return;
  // the head's first vector sums d_el, in slot order, in a pass of its own:
  // inside the feature loop it held more registers there (40 against 38 in
  // float32) and was slower
  constexpr int kElChunk = 8;
  const float* pb = d_pre + graph;
  float el = 0.f;
  for (int k0 = 0; k0 < n; k0 += kElChunk) {
    float p[kElChunk];
#pragma unroll
    for (int c = 0; c < kElChunk; ++c)
      if (k0 + c < n) p[c] = __ldg(pb + (rs[k0 + c].x * D + rs[k0 + c].y) * H);
#pragma unroll
    for (int c = 0; c < kElChunk; ++c)
      if (k0 + c < n) el = __fadd_rn(el, p[c]);
  }
  d_el[node * H + h] = el;
}

// ---------------------------------------------------------------- launches

int check_dims(int B, int N, int D, int H, int F) {
  if (D <= 0 || D > kMaxDegree || H <= 0 || H > kMaxHeads || F <= 0)
    return (int)cudaErrorInvalidValue;
  if (B > 65535 || (int64_t)N * H * F >= (1LL << 31) ||
      (int64_t)N * D * H >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  return (int)cudaSuccess;
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// Calls launch(std::integral_constant<int, VEC>()) with the widest vector
// of at most 16 bytes that divides F and to which every pointer in `ptrs`
// is aligned.
template <typename T, typename Launch>
int dispatch_vec(int F, std::initializer_list<const void*> ptrs, Launch launch) {
  auto fits = [&](int vec) {
    if (F % vec) return false;
    for (const void* p : ptrs)
      if (p != nullptr && !aligned(p, vec * (int)sizeof(T))) return false;
    return true;
  };
  if constexpr (sizeof(T) == 2) {
    if (fits(8)) return launch(std::integral_constant<int, 8>());
  }
  if (fits(4)) return launch(std::integral_constant<int, 4>());
  if (fits(2)) return launch(std::integral_constant<int, 2>());
  return launch(std::integral_constant<int, 1>());
}

template <typename T>
int launch_fwd(const void* z, const void* el, const void* er, const void* nbr,
               const void* mask, const void* bias, const void* res, void* out,
               void* alpha, void* pos, int B, int N, int D, int H, int F,
               float slope, int act, int save, void* stream) {
  const int rc = check_dims(B, N, D, H, F);
  if (rc != (int)cudaSuccess) return rc;
  if (B <= 0 || N <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch_vec<T>(F, {z, bias, res, out}, [&](auto vec) {
    constexpr int VEC = decltype(vec)::value;
    const int vecs = H * F / VEC;                   // vectors a row
    const int tpr = std::min(vecs, kThreads);       // threads a row
    const int Dp = D | 1;   // odd row stride: no bank conflicts between rows
    const size_t per_row = (size_t)Dp * sizeof(int2) + sizeof(int) +
                           (size_t)D * H * (sizeof(float) + 1);
    // as many rows as fill 256 threads, at most kMaxRows, within 48 KB of
    // shared memory (at least 4 rows at D=128, H=16)
    const int rows = std::min({kThreads / tpr, kMaxRows, (int)(kSmemBudget / per_row)});
    const int threads = (rows * tpr + 31) / 32 * 32;   // whole warps: ballots
    const dim3 grid((N + rows - 1) / rows, B, (vecs + tpr - 1) / tpr);
    const size_t smem = (rows * per_row + 3) / 4 * 4;
    gat_fwd_kernel<T, VEC><<<grid, threads, smem, s>>>(
        static_cast<const T*>(z), static_cast<const T*>(el),
        static_cast<const T*>(er), static_cast<const int32_t*>(nbr),
        static_cast<const float*>(mask), static_cast<const T*>(bias),
        static_cast<const T*>(res), static_cast<T*>(out),
        save ? static_cast<float*>(alpha) : nullptr,
        save ? static_cast<uint8_t*>(pos) : nullptr, N, D, H, F, slope,
        act != 0, tpr, rows, Dp);
    return (int)cudaGetLastError();
  });
}

template <typename T, int VEC, int NV>
int launch_bwd_vec(const void* gout, const void* z, const void* alpha,
                   const void* pos, const void* nbr, const void* mask,
                   void* d_pre, void* d_er, int B, int N, int D, int H, int F,
                   float slope, cudaStream_t s) {
  // lanes per (row, head): a power of two, up to 32, covering the head's
  // vectors NV a lane
  const int vph = F / VEC;
  int G = 1;
  while (G < 32 && G * NV < vph) G *= 2;
  const int lanes = H * G;                        // lanes a row, <= 512
  const int Dp = D | 1;
  const size_t per_row = (size_t)Dp * sizeof(int2) + sizeof(int) +
                         (size_t)(D + 1) * H * sizeof(float);
  // as many rows as fill 256 threads (a row of more lanes takes its own
  // block), at most kMaxRows, within 48 KB of shared memory (at least 5
  // rows at D=128, H=16)
  const int rows = std::max(1, std::min({kThreads / lanes, kMaxRows,
                                         (int)(kSmemBudget / per_row)}));
  const int threads = (rows * lanes + 31) / 32 * 32;   // whole warps: shuffles
  const dim3 grid((N + rows - 1) / rows, B);
  gat_bwd_kernel<T, VEC, NV><<<grid, threads, rows * per_row, s>>>(
      static_cast<const T*>(gout), static_cast<const T*>(z),
      static_cast<const float*>(alpha), static_cast<const uint8_t*>(pos),
      static_cast<const int32_t*>(nbr), static_cast<const float*>(mask),
      static_cast<float*>(d_pre), static_cast<float*>(d_er), N, D, H, F, G,
      rows, Dp, slope);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* gout, const void* z, const void* alpha,
               const void* pos, const void* nbr, const void* mask, void* d_pre,
               void* d_er, int B, int N, int D, int H, int F, float slope,
               void* stream) {
  const int rc = check_dims(B, N, D, H, F);
  if (rc != (int)cudaSuccess) return rc;
  if (B <= 0 || N <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch_vec<T>(F, {gout, z}, [&](auto vec) {
    constexpr int VEC = decltype(vec)::value;
    // two vectors a lane once a head has 64 or more (F=256 in float32)
    if (F / VEC >= 64)
      return launch_bwd_vec<T, VEC, 2>(gout, z, alpha, pos, nbr, mask, d_pre,
                                       d_er, B, N, D, H, F, slope, s);
    return launch_bwd_vec<T, VEC, 1>(gout, z, alpha, pos, nbr, mask, d_pre, d_er,
                                     B, N, D, H, F, slope, s);
  });
}

template <typename T, int VEC>
int launch_rev_vec(const void* gout, const void* alpha, const void* d_pre,
                   const void* nbr, const void* mask, const void* rslot,
                   void* d_z, void* d_el, int B, int N, int D, int H, int F,
                   cudaStream_t s) {
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
  gat_rev_kernel<T, VEC><<<grid, threads, rows * per_row, s>>>(
      static_cast<const T*>(gout), static_cast<const float*>(alpha),
      static_cast<const float*>(d_pre), static_cast<const int32_t*>(nbr),
      static_cast<const float*>(mask), static_cast<const int32_t*>(rslot),
      static_cast<T*>(d_z), static_cast<float*>(d_el), N, D, H, F, tpr, rows,
      Dp);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_rev(const void* gout, const void* alpha, const void* d_pre,
               const void* nbr, const void* mask, const void* rslot, void* d_z,
               void* d_el, int B, int N, int D, int H, int F, void* stream) {
  const int rc = check_dims(B, N, D, H, F);
  if (rc != (int)cudaSuccess) return rc;
  if (B <= 0 || N <= 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch_vec<T>(F, {gout, d_z}, [&](auto vec) {
    return launch_rev_vec<T, decltype(vec)::value>(gout, alpha, d_pre, nbr, mask,
                                                   rslot, d_z, d_el, B, N, D, H,
                                                   F, s);
  });
}

}  // namespace

extern "C" {

int gts_gat_fwd_f32(const void* z, const void* el, const void* er,
                    const void* nbr, const void* mask, const void* bias,
                    const void* res, void* out, void* alpha, void* pos, int B,
                    int N, int D, int H, int F, float slope, int act, int save,
                    void* stream) {
  return launch_fwd<float>(z, el, er, nbr, mask, bias, res, out, alpha, pos, B,
                           N, D, H, F, slope, act, save, stream);
}

int gts_gat_fwd_bf16(const void* z, const void* el, const void* er,
                     const void* nbr, const void* mask, const void* bias,
                     const void* res, void* out, void* alpha, void* pos, int B,
                     int N, int D, int H, int F, float slope, int act, int save,
                     void* stream) {
  return launch_fwd<__nv_bfloat16>(z, el, er, nbr, mask, bias, res, out, alpha,
                                   pos, B, N, D, H, F, slope, act, save,
                                   stream);
}

int gts_gat_bwd_f32(const void* gout, const void* z, const void* alpha,
                    const void* pos, const void* nbr, const void* mask,
                    void* d_pre, void* d_er, int B, int N, int D, int H, int F,
                    float slope, void* stream) {
  return launch_bwd<float>(gout, z, alpha, pos, nbr, mask, d_pre, d_er, B, N,
                           D, H, F, slope, stream);
}

int gts_gat_bwd_bf16(const void* gout, const void* z, const void* alpha,
                     const void* pos, const void* nbr, const void* mask,
                     void* d_pre, void* d_er, int B, int N, int D, int H,
                     int F, float slope, void* stream) {
  return launch_bwd<__nv_bfloat16>(gout, z, alpha, pos, nbr, mask, d_pre,
                                   d_er, B, N, D, H, F, slope, stream);
}

int gts_gat_rev_f32(const void* gout, const void* alpha, const void* d_pre,
                    const void* nbr, const void* mask, const void* rslot,
                    void* d_z, void* d_el, int B, int N, int D, int H, int F,
                    void* stream) {
  return launch_rev<float>(gout, alpha, d_pre, nbr, mask, rslot, d_z, d_el, B,
                           N, D, H, F, stream);
}

int gts_gat_rev_bf16(const void* gout, const void* alpha, const void* d_pre,
                     const void* nbr, const void* mask, const void* rslot,
                     void* d_z, void* d_el, int B, int N, int D, int H, int F,
                     void* stream) {
  return launch_rev<__nv_bfloat16>(gout, alpha, d_pre, nbr, mask, rslot, d_z,
                                   d_el, B, N, D, H, F, stream);
}

const char* gts_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
