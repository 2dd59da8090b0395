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
// Arithmetic is float32 in every type; sums run in slot order. Kernels 1 and
// 3 use explicitly rounded adds and products (__fadd_rn, __fmul_rn, which
// nvcc never contracts into an FMA), so the reverse combine is bitwise equal
// to its plain PyTorch version (ops/kernels/fused_gat.py) and the forward
// differs from it only where CUDA's expf and PyTorch's exp differ. The
// backward's dot over F is a warp-shuffle tree, another order than the plain
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
// node ids follow space).
//
// Design. The TPU kernels' unique-row compaction and one-hot MXU
// contractions (fused_gat.py:70-80, 115-126) work around slow row gathers
// on the TPU; here every kernel reads nbr directly.
//
// Forward (first, simple version): a block takes a tile of destination
// rows, stages the rows' slots (padded slots as -1) and their logits, then
// alpha, in shared memory; one thread per (row, head) runs the softmax in
// slot order, and then the threads run along HF, each accumulating its
// feature over the slots in a register, with the epilogue fused. Backward
// (first, simple version): a group of G lanes (a power of two from 4 to 32:
// 32 at F >= 32, 4 at the output layer's F=4) takes one (row, head): the
// lanes stride over F for each slot's dot and reduce with xor shuffles
// inside the group, keep d_alpha in shared memory, and then split the
// slots for the softmax backward. Left for later in both: vector loads,
// more rows per block at wide HF, cp.async or TMA staging.
//
// Reverse combine (the design of weighted_sum.cu's combine, whose reverse
// instantiation computes the same d_z with alpha as the weights):
//  * each thread owns an aligned vector of VEC contiguous features inside
//    one head (VEC = 8, 4, 2 or 1, the widest that divides F with a load of
//    at most 16 bytes), and threads map flat onto (row, vector): at (H,F) =
//    (1,4) in float32 a thread is a row, at (4,256) a block of 256 threads
//    is a row (two in bfloat16); a row of more than 256 vectors takes a
//    third grid dimension. Graphs are the slower grid dimension, so a wave
//    gathers gout from the rows of about one graph;
//  * staging is one round trip: the block loads mask, nbr and rslot of all
//    its rows' slots at once, then compacts each row's real slots in slot
//    order in shared memory with warp ballots and keeps their number;
//  * the feature loop runs over the real slots alone. For each slot it
//    reads the reverse alpha[v, rslot, h] beside the slot's gout vector
//    (both depend on the staged pair alone, so the dependent load costs no
//    round trip of its own), with kChunk slots' loads in flight before
//    their adds. After d_z's store, the thread that owns a head's first
//    vector reads d_pre[v, rslot, h] over the same staged slots and sums
//    d_el in slot order;
//  * sums in slot order with one rounding per product and add: skipping a
//    padded slot equals the plain version's add of +0.0, so d_z and d_el
//    stay bitwise the plain version's.
// What bounds it: the D-fold re-reads of gout rows from L2 (about ten real
// slots a row), so its floor is some 2-3x the byte bound.

#include <algorithm>
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegLarge = -1e30f;
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
__device__ __forceinline__ void store_from_float(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_from_float(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as torch's .to(bfloat16)
}

// ---------------------------------------------------------------- forward

template <typename T, bool kAct, bool kRes, bool kSave>
__global__ void gat_fwd_kernel(const T* __restrict__ z, const T* __restrict__ el,
                               const T* __restrict__ er,
                               const int32_t* __restrict__ nbr,
                               const float* __restrict__ mask,
                               const T* __restrict__ bias,
                               const T* __restrict__ res, T* __restrict__ out,
                               float* __restrict__ alpha_out,
                               uint8_t* __restrict__ pos_out, int N, int D,
                               int H, int F, float slope) {
  extern __shared__ float smem[];
  const int R = blockDim.y;                                 // rows per block
  int32_t* slots = reinterpret_cast<int32_t*>(smem);        // [R, D]
  float* w = smem + R * D;                                  // [R, D, H]
  const int b = blockIdx.y;
  const int row0 = blockIdx.x * R;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nt = blockDim.x * blockDim.y;
  const int HF = H * F;
  const int DH = D * H;

  for (int i = tid; i < R * D; i += nt) {
    const int r = row0 + i / D;
    int32_t s = -1;
    if (r < N) {
      const int64_t off = ((int64_t)b * N + r) * D + i % D;
      if (mask[off] > 0.f) s = nbr[off];
    }
    slots[i] = s;
  }
  __syncthreads();

  // logits: el of each slot's source plus the row's er, LeakyReLU; padded
  // slots get the -1e30 sentinel
  for (int i = tid; i < R * DH; i += nt) {
    const int rl = i / DH;
    const int d = (i / H) % D;
    const int h = i % H;
    const int r = row0 + rl;
    float logit = kNegLarge;
    if (r < N) {
      const int64_t node = (int64_t)b * N + r;
      const int32_t s = slots[rl * D + d];
      uint8_t positive = 0;
      if (s >= 0) {
        const float p = __fadd_rn(load_as_float(el + ((int64_t)b * N + s) * H + h),
                                  load_as_float(er + node * H + h));
        logit = p >= 0.f ? p : __fmul_rn(p, slope);
        positive = logit >= 0.f;
      }
      if (kSave) pos_out[node * DH + d * H + h] = positive;
    }
    w[i] = logit;
  }
  __syncthreads();

  // masked softmax over the slots, one thread per (row, head)
  for (int i = tid; i < R * H; i += nt) {
    const int rl = i / H;
    const int h = i % H;
    const int r = row0 + rl;
    if (r >= N) continue;
    const int64_t node = (int64_t)b * N + r;
    const int32_t* rs = slots + rl * D;
    float* wr = w + rl * DH + h;
    float mx = kNegLarge;
    for (int d = 0; d < D; ++d) mx = fmaxf(mx, wr[d * H]);
    float sum = 0.f;
    for (int d = 0; d < D; ++d) {
      const float e = rs[d] >= 0 ? expf(__fsub_rn(wr[d * H], mx)) : 0.f;
      wr[d * H] = e;
      sum = __fadd_rn(sum, e);
    }
    const float inv = __fdiv_rn(1.f, fmaxf(sum, 1e-20f));
    for (int d = 0; d < D; ++d) {
      const float a = __fmul_rn(wr[d * H], inv);
      wr[d * H] = a;
      if (kSave) alpha_out[node * DH + d * H + h] = a;
    }
  }
  __syncthreads();

  // weighted combine along HF and the epilogue
  const int rl = threadIdx.y;
  const int r = row0 + rl;
  if (r >= N) return;
  const int64_t node = (int64_t)b * N + r;
  const int32_t* rs = slots + rl * D;
  const float* ar = w + rl * DH;
  const T* zb = z + (int64_t)b * N * HF;
  for (int f = threadIdx.x; f < HF; f += blockDim.x) {
    const int h = f / F;
    float acc = 0.f;
    for (int d = 0; d < D; ++d) {
      const int32_t s = rs[d];
      if (s < 0) continue;
      acc = __fadd_rn(acc, __fmul_rn(ar[d * H + h],
                                     load_as_float(zb + (int64_t)s * HF + f)));
    }
    float v = __fadd_rn(acc, load_as_float(bias + f));
    if (kRes) v = __fadd_rn(v, load_as_float(res + node * HF + f));
    if (kAct) v = v > 0.f ? v : __fsub_rn(expf(fminf(v, 0.f)), 1.f);
    store_from_float(out + node * HF + f, v);
  }
}

// --------------------------------------------------------------- backward

template <typename T>
__global__ void gat_bwd_kernel(const T* __restrict__ gout,
                               const T* __restrict__ z,
                               const float* __restrict__ alpha,
                               const uint8_t* __restrict__ pos,
                               const int32_t* __restrict__ nbr,
                               const float* __restrict__ mask,
                               float* __restrict__ d_pre,
                               float* __restrict__ d_er, int N, int D, int H,
                               int F, int G, float slope) {
  extern __shared__ float smem[];  // [groups, D]: d_alpha, then d_pre
  const int gl = threadIdx.x & (G - 1);           // lane within the group
  const int group = threadIdx.x / G;
  const int groups = blockDim.x / G;
  const int b = blockIdx.y;
  const int64_t pair = (int64_t)blockIdx.x * groups + group;  // (row, head)
  const bool live = pair < (int64_t)N * H;
  const int r = live ? (int)(pair / H) : 0;
  const int h = live ? (int)(pair % H) : 0;
  const int HF = H * F;
  const int DH = D * H;
  const int64_t node = (int64_t)b * N + r;
  float* da = smem + group * D;
  const T* go = gout + node * HF + h * F;
  const T* zb = z + (int64_t)b * N * HF + h * F;

  // every lane of the warp runs every shuffle: the loop bounds are uniform
  for (int d = 0; d < D; ++d) {
    const int64_t off = node * D + d;
    const bool real = live && mask[off] > 0.f;
    float part = 0.f;
    if (real) {
      const T* zs = zb + (int64_t)nbr[off] * HF;
      for (int f = gl; f < F; f += G)
        part = fmaf(load_as_float(go + f), load_as_float(zs + f), part);
    }
    for (int o = G / 2; o > 0; o >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, o);
    if (gl == 0) da[d] = part;
  }
  __syncwarp();

  // softmax and LeakyReLU backward; the lanes of a group split the slots.
  // Lanes of a group past the last (row, head) skip the work but still
  // reach every __syncwarp.
  const float* al = alpha + node * DH + h;
  const uint8_t* ps = pos + node * DH + h;
  float s = 0.f;
  if (live)
    for (int d = 0; d < D; ++d) s = __fadd_rn(s, __fmul_rn(al[d * H], da[d]));
  __syncwarp();                                  // all reads of da done
  if (live) {
    for (int d = gl; d < D; d += G) {
      const float de = __fmul_rn(al[d * H], __fsub_rn(da[d], s));
      float dp = ps[d * H] ? de : __fmul_rn(de, slope);
      if (!(mask[node * D + d] > 0.f)) dp = 0.f;
      d_pre[node * DH + d * H + h] = dp;
      da[d] = dp;
    }
  }
  __syncwarp();
  if (live && gl == 0) {
    float acc = 0.f;
    for (int d = 0; d < D; ++d) acc = __fadd_rn(acc, da[d]);
    d_er[node * H + h] = acc;
  }
}

// -------------------------------------------------------- reverse combine

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
// each row in slot order as (source row v, rslot) pairs in
// slots[rl * Dp ...] and their number in count[rl]. Every thread of the
// block calls it (it holds two barriers); blockDim.x is a multiple of 32.
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
      k[u] = __ldg(rslot + off);
    }
#pragma unroll
    for (int u = 0; u < kStageUnroll; ++u) {
      const int i = i0 + u * nt;
      if (i < total) {
        const int rl = i / D;
        const int d = i - rl * D;
        const bool real = i <= last && m[u] > 0.f;
        slots[rl * Dp + d] = real ? make_int2(s[u], k[u]) : make_int2(-1, 0);
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
  stage_slots(nbr, mask, rslot, slots, count, b, row0, rows, N, D, Dp);

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
  (void)B;
  (void)N;
  return (int)cudaSuccess;
}

// threads along HF (a power of two up to 256: the output layer's HF=4 takes
// 4 lanes a row); the rest of the block takes more rows, as many as the
// shared-memory budget allows (`per_row` bytes each)
dim3 row_block(int HF, size_t per_row) {
  int bx = 1;
  while (bx < HF && bx < kThreads) bx *= 2;
  int by = kThreads / bx;
  const int fit = (int)(kSmemBudget / per_row);
  if (by > fit) by = fit > 0 ? fit : 1;
  return dim3(bx, by);
}

template <typename T, bool kAct, bool kRes, bool kSave>
void launch_fwd_t(dim3 grid, dim3 block, size_t smem, cudaStream_t s,
                  const void* z, const void* el, const void* er,
                  const void* nbr, const void* mask, const void* bias,
                  const void* res, void* out, void* alpha, void* pos, int N,
                  int D, int H, int F, float slope) {
  gat_fwd_kernel<T, kAct, kRes, kSave><<<grid, block, smem, s>>>(
      static_cast<const T*>(z), static_cast<const T*>(el),
      static_cast<const T*>(er), static_cast<const int32_t*>(nbr),
      static_cast<const float*>(mask), static_cast<const T*>(bias),
      static_cast<const T*>(res), static_cast<T*>(out),
      static_cast<float*>(alpha), static_cast<uint8_t*>(pos), N, D, H, F,
      slope);
}

template <typename T>
int launch_fwd(const void* z, const void* el, const void* er, const void* nbr,
               const void* mask, const void* bias, const void* res, void* out,
               void* alpha, void* pos, int B, int N, int D, int H, int F,
               float slope, int act, int save, void* stream) {
  const int rc = check_dims(B, N, D, H, F);
  if (rc != (int)cudaSuccess) return rc;
  if (B <= 0 || N <= 0) return (int)cudaSuccess;
  const size_t per_row = (size_t)D * (1 + H) * sizeof(float);
  const dim3 block = row_block(H * F, per_row);
  const dim3 grid((N + block.y - 1) / block.y, B);
  const size_t smem = block.y * per_row;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool has_res = res != nullptr;
#define GTS_FWD(A, R, S)                                                      \
  launch_fwd_t<T, A, R, S>(grid, block, smem, s, z, el, er, nbr, mask, bias, \
                           res, out, alpha, pos, N, D, H, F, slope)
  if (act) {
    if (has_res) {
      if (save) GTS_FWD(true, true, true); else GTS_FWD(true, true, false);
    } else {
      if (save) GTS_FWD(true, false, true); else GTS_FWD(true, false, false);
    }
  } else {
    if (has_res) {
      if (save) GTS_FWD(false, true, true); else GTS_FWD(false, true, false);
    } else {
      if (save) GTS_FWD(false, false, true); else GTS_FWD(false, false, false);
    }
  }
#undef GTS_FWD
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
  // lanes per (row, head): a power of two covering F, at least 4 (so at
  // most 64 groups a block keep D floats each within 32 KB at D = 128)
  int G = 4;
  while (G < F && G < 32) G *= 2;
  const int groups = kThreads / G;
  const int64_t pairs = (int64_t)N * H;
  const dim3 grid((unsigned)((pairs + groups - 1) / groups), B);
  const size_t smem = (size_t)groups * D * sizeof(float);
  gat_bwd_kernel<T><<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(gout), static_cast<const T*>(z),
      static_cast<const float*>(alpha), static_cast<const uint8_t*>(pos),
      static_cast<const int32_t*>(nbr), static_cast<const float*>(mask),
      static_cast<float*>(d_pre), static_cast<float*>(d_er), N, D, H, F, G,
      slope);
  return (int)cudaGetLastError();
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
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
  if (B > 65535 || (int64_t)N * H * F >= (1LL << 31) ||
      (int64_t)N * D * H >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the widest vector of at most 16 bytes that divides F and to which both
  // feature pointers are aligned
  auto fits = [&](int vec) {
    return F % vec == 0 && aligned(gout, vec * (int)sizeof(T)) &&
           aligned(d_z, vec * (int)sizeof(T));
  };
#define GTS_REV(VEC)                                                           \
  launch_rev_vec<T, VEC>(gout, alpha, d_pre, nbr, mask, rslot, d_z, d_el, B, \
                         N, D, H, F, s)
  if constexpr (sizeof(T) == 2) {
    if (fits(8)) return GTS_REV(8);
  }
  if (fits(4)) return GTS_REV(4);
  if (fits(2)) return GTS_REV(2);
  return GTS_REV(1);
#undef GTS_REV
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
