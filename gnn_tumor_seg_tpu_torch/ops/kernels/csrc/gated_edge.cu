// GraphGPS's GatedGCN edge block over the padded slot table, forward and
// backward, in a few passes over the edge tensors.
//
// Layouts (R = B*N rows, D slots a row, W channels):
//   eW, e_j, b_j, e_hat, e, e_new, g, dt, db_j   [R, D, W]   float32 or bfloat16
//   d, a, x, dx, dd                               [R, W]      the same type
//   den, num                                      [R, W]      float32
//   mask                                          [R, D]      float32 (> 0 on a real slot)
//   keep                                          [R, D, W]   uint8 (bool), dropout's mask
//   part                                          [2, P, W]   float32, one row a block
//   stats                                         [7, W]      float32 (mean, inv, a, c, a_r, c_r, var_ok)
//
// Replaces no Pallas kernel: GraphGPS has no JAX counterpart. The port ran
// this block as some 40 PyTorch operations (models/gps.py before), each a
// pass over an edge tensor of [6, 8192, 24, 96] in the train-gps-b6 cell.
// With i a row and j the source of slot (i, k):
//
//   ê  = (eW + e_j + d_i) on a real slot         (0 on a padded one)
//   σ  = sigmoid(ê);  x_i = a_i + Σ_k σ b_j / (Σ_k σ + eps)   (real slots)
//   e' = e + ReLU(ê a_r + c_r)                   (BatchNorm over the real slots)
//
// 1. gated_edge_gate_kernel: one thread per (row, run of V channels), looping
//    over the row's slots: reads eW, e_j and b_j on the real slots, writes ê
//    there (rounded to the compute type, as the plain version stores it),
//    x, and the float32 sums den and num that the backward reuses; with
//    kStats, each block's float32 sums of ê and ê² for BatchNorm.
// 2. gated_edge_stats_kernel sums the blocks' rows in a fixed order (no
//    atomics: replays are bitwise equal), and computes the batch's mean and
//    variance, the scale a = rsqrt(var + eps) (1 + g) and shift c = b - mean
//    a, and their values rounded to the compute type (a_r, c_r), and updates
//    the running statistics as MaskedBatchNorm does (momentum, the unbiased
//    variance); in evaluation it reads the running statistics instead.
// 3. gated_edge_update_kernel: e' = e + ReLU(round(ê a_r + c_r)) on the real
//    slots, 0 on the padded ones (which no later reader takes). With
//    kDrop, the ReLU's output passes dropout first: keep ? round(v scale) :
//    0, scale = 1 / (1 - rate), the mask drawn by torch beforehand (as the
//    plain version's torch.where(keep, v / (1 - rate), 0)).
// 4. gated_edge_relu_grad_kernel: each block's sums of dy = g 1[y > 0] and
//    dy ê over the real slots, y recomputed as the forward rounded it (with
//    kDrop, g through dropout: keep ? round(g scale) : 0).
// 5. gated_edge_stats_grad_kernel: the BatchNorm's backward over the
//    channel sums (fixed order): dg, db, and the two coefficients k1, k2
//    with which every real slot's dê gains k1 + k2 ê.
// 6. gated_edge_gate_grad_kernel: one thread per (row, run of V channels):
//    dt = dê on the real slots (σ' (dnum b_j + dden), plus dy a_r + k1 + k2 ê
//    with the BatchNorm), 0 on the padded ones; db_j = σ dnum on the real
//    slots (the padded ones stay unwritten: the slot gather's backward reads
//    real slots only); dd = Σ_k dt in float32.
//
// What bounds them on an H100: bytes. Each does a sigmoid and a few FMAs a
// value, far below the 295 operations a byte where the tensor cores would
// take over. So the design moves each edge tensor about once a pass and
// skips the padded slots' reads (about half of them in the cell: 7 000 real
// of 8 192 rows, 10-19 real of 24 slots): a pass reads its row's mask word
// and loads nothing for a padded slot. The row threads load 8 bytes a value
// run (4 bfloat16 or 2 float32 channels), so a warp reads a slot's channels
// as whole 32-byte sectors, and take a row's slots kChunk at a time, every
// load of the chunk in flight before its arithmetic; the row of a thread
// stays in registers across its slots, so the node-level sums (x, den, num,
// dd) need no second pass.
// Per-channel sums go through shared memory and one row a block, then a
// fixed-order pass: deterministic. All offsets are 32-bit (the wrapper
// checks R*D*W < 2^31).

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// threads a row block holds at most (rows = kRowThreads / threads a row; a
// row's W / V threads fit one block, and the wrapper takes W up to 384)
constexpr int kRowThreads = 384;
constexpr int kFlatThreads = 256;
// the statistics kernels: 32 channels by 32 lanes of partial rows
constexpr int kLanes = 32;

// a word's value: float32, or bfloat16 bits (exact, as __bfloat162float)
__device__ __forceinline__ float to_f(float w) { return w; }
__device__ __forceinline__ float to_f(uint16_t w) { return __uint_as_float((uint32_t)w << 16); }
// round to nearest even, as torch's .to(bfloat16)
__device__ __forceinline__ void from_f(float v, float& w) { w = v; }
__device__ __forceinline__ void from_f(float v, uint16_t& w) {
  w = __bfloat16_as_ushort(__float2bfloat16(v));
}
// v rounded to Word and back
template <typename Word> __device__ __forceinline__ float rnd(float v) {
  Word w;
  from_f(v, w);
  return to_f(w);
}

template <int Bytes> struct Raw;
template <> struct Raw<2> { using type = uint16_t; };
template <> struct Raw<4> { using type = uint32_t; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<16> { using type = uint4; };

// V words as one aligned access
template <typename Word, int V> union Pack {
  typename Raw<sizeof(Word) * V>::type raw;
  Word w[V];
};

template <typename Word, int V> using RawOf = typename Raw<sizeof(Word) * V>::type;

template <typename Word, int V>
__device__ __forceinline__ RawOf<Word, V> load_raw(const Word* __restrict__ p) {
  return __ldg(reinterpret_cast<const RawOf<Word, V>*>(p));
}

template <typename Word, int V>
__device__ __forceinline__ void unpack(RawOf<Word, V> raw, float (&f)[V]) {
  Pack<Word, V> k;
  k.raw = raw;
#pragma unroll
  for (int i = 0; i < V; ++i) f[i] = to_f(k.w[i]);
}

template <typename Word, int V>
__device__ __forceinline__ void load(const Word* __restrict__ p, float (&f)[V]) {
  unpack<Word, V>(load_raw<Word, V>(p), f);
}

// The row kernels walk a row's slots kChunk at a time: the chunk's mask
// words, then every real slot's loads, all in flight before the arithmetic.
constexpr int kChunk = 4;

__device__ __forceinline__ void chunk_mask(const float* __restrict__ m, int k0, int D,
                                           float (&mk)[kChunk]) {
#pragma unroll
  for (int c = 0; c < kChunk; ++c) mk[c] = k0 + c < D ? __ldg(m + k0 + c) : 0.f;
}

template <typename Word, int V>
__device__ __forceinline__ void store(Word* __restrict__ p, const float (&f)[V]) {
  using T = typename Raw<sizeof(Word) * V>::type;
  Pack<Word, V> k;
#pragma unroll
  for (int i = 0; i < V; ++i) from_f(f[i], k.w[i]);
  *reinterpret_cast<T*>(p) = k.raw;
}

template <typename Word, int V>
__device__ __forceinline__ void store_zero(Word* __restrict__ p) {
  using T = typename Raw<sizeof(Word) * V>::type;
  Pack<Word, V> k;
#pragma unroll
  for (int i = 0; i < V; ++i) k.w[i] = Word(0);
  *reinterpret_cast<T*>(p) = k.raw;
}

// V per-channel floats of stats row `row`
template <int V>
__device__ __forceinline__ void channel(const float* __restrict__ stats, int row, int W,
                                        int c0, float (&f)[V]) {
#pragma unroll
  for (int i = 0; i < V; ++i) f[i] = __ldg(stats + row * W + c0 + i);
}

__device__ __forceinline__ float sigmoid(float t) { return 1.f / (1.f + expf(-t)); }

// the BatchNorm's output before its ReLU, rounded to the compute type as the
// plain version's addcmul stores it; the backward recomputes it bitwise
template <typename Word>
__device__ __forceinline__ float bn_out(float e_hat, float a_r, float c_r) {
  return rnd<Word>(__fmaf_rn(e_hat, a_r, c_r));
}

// the upstream gradient of the edge update's ReLU output through dropout:
// keep ? round(g scale) : 0, as autograd takes it back through torch.where
// and the scaling
template <typename Word, bool kDrop>
__device__ __forceinline__ float dropped(float g, const uint8_t* __restrict__ keep,
                                         int off, float scale) {
  if constexpr (kDrop) return __ldg(keep + off) ? rnd<Word>(__fmul_rn(g, scale)) : 0.f;
  return g;
}

enum Stat { kMean = 0, kInv, kA, kC, kAr, kCr, kVarOk, kNumStats };

// Each block's per-channel sums of its rows' V-channel runs s1, s2 -> part
// rows blockIdx.x and gridDim.x + blockIdx.x, in a fixed order.
template <int V>
__device__ __forceinline__ void block_sums(float* red, int rows, int lr, int c0, int W,
                                           const float (&s1)[V], const float (&s2)[V],
                                           float* __restrict__ part) {
  float* r1 = red;
  float* r2 = red + rows * W;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    r1[lr * W + c0 + i] = s1[i];
    r2[lr * W + c0 + i] = s2[i];
  }
  __syncthreads();
  for (int w = threadIdx.x; w < W; w += blockDim.x) {
    float t1 = 0.f, t2 = 0.f;
    for (int j = 0; j < rows; ++j) {
      t1 += r1[j * W + w];
      t2 += r2[j * W + w];
    }
    part[blockIdx.x * W + w] = t1;
    part[(gridDim.x + blockIdx.x) * W + w] = t2;
  }
}

// 1. The gate: ê, x, den and num; with kStats the blocks' sums of ê and ê².
template <typename Word, int V, bool kStats>
__global__ void __launch_bounds__(kRowThreads, 2)
gated_edge_gate_kernel(const Word* __restrict__ ew, const Word* __restrict__ ej,
                       const Word* __restrict__ bj, const Word* __restrict__ d,
                       const Word* __restrict__ a, const float* __restrict__ mask,
                       Word* __restrict__ e_hat, Word* __restrict__ x,
                       float* __restrict__ den, float* __restrict__ num,
                       float* __restrict__ part, int R, int D, int W, float gate_eps) {
  extern __shared__ float red[];
  const int tpn = W / V;
  const int rows = blockDim.x / tpn;
  const int lr = threadIdx.x / tpn;
  const int c0 = (threadIdx.x - lr * tpn) * V;
  const int r = blockIdx.x * rows + lr;
  float s1[V], s2[V];
#pragma unroll
  for (int i = 0; i < V; ++i) s1[i] = s2[i] = 0.f;
  if (r < R) {
    float dv[V], sden[V], snum[V];
    load<Word, V>(d + r * W + c0, dv);
#pragma unroll
    for (int i = 0; i < V; ++i) sden[i] = snum[i] = 0.f;
    const float* m = mask + r * D;
    for (int k0 = 0; k0 < D; k0 += kChunk) {
      float mk[kChunk];
      chunk_mask(m, k0, D, mk);
      RawOf<Word, V> rp[kChunk] = {}, rq[kChunk] = {}, rb[kChunk] = {};
#pragma unroll
      for (int c = 0; c < kChunk; ++c)
        if (mk[c] > 0.f) {
          const int off = (r * D + k0 + c) * W + c0;
          rp[c] = load_raw<Word, V>(ew + off);
          rq[c] = load_raw<Word, V>(ej + off);
          rb[c] = load_raw<Word, V>(bj + off);
        }
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        if (!(mk[c] > 0.f)) continue;
        float p[V], q[V], b[V];
        unpack<Word, V>(rp[c], p);
        unpack<Word, V>(rq[c], q);
        unpack<Word, V>(rb[c], b);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float t = rnd<Word>(p[i] + q[i] + dv[i]);
          const float s = sigmoid(t);
          p[i] = t;
          sden[i] += s;
          snum[i] = __fmaf_rn(s, b[i], snum[i]);
          if constexpr (kStats) {
            s1[i] += t;
            s2[i] = __fmaf_rn(t, t, s2[i]);
          }
        }
        if (e_hat) store<Word, V>(e_hat + (r * D + k0 + c) * W + c0, p);
      }
    }
    float xv[V];
    load<Word, V>(a + r * W + c0, xv);
#pragma unroll
    for (int i = 0; i < V; ++i) xv[i] += snum[i] / (sden[i] + gate_eps);
    store<Word, V>(x + r * W + c0, xv);
    if (den) {
      store<float, V>(den + r * W + c0, sden);
      store<float, V>(num + r * W + c0, snum);
    }
  }
  if constexpr (kStats) block_sums<V>(red, rows, lr, c0, W, s1, s2, part);
}

// 2. The BatchNorm's statistics: grid ceil(W / 32), block (32, kLanes).
__global__ void __launch_bounds__(32 * kLanes)
gated_edge_stats_kernel(const float* __restrict__ part, int P,
                        const float* __restrict__ count, const float* __restrict__ g,
                        const float* __restrict__ b, float* __restrict__ run_mean,
                        float* __restrict__ run_var, float* __restrict__ stats, int W,
                        float eps, float momentum, int train, int bf16) {
  __shared__ float sh[2][kLanes][33];
  const int w = blockIdx.x * 32 + threadIdx.x;
  const int lane = threadIdx.y;
  float s1 = 0.f, s2 = 0.f;
  if (train && w < W)
    for (int p = lane; p < P; p += kLanes) {
      s1 += part[p * W + w];
      s2 += part[(P + p) * W + w];
    }
  sh[0][lane][threadIdx.x] = s1;
  sh[1][lane][threadIdx.x] = s2;
  __syncthreads();
  if (lane != 0 || w >= W) return;
  float mean, var, ok = 1.f;
  if (train) {
    float t1 = 0.f, t2 = 0.f;
    for (int j = 0; j < kLanes; ++j) {
      t1 += sh[0][j][threadIdx.x];
      t2 += sh[1][j][threadIdx.x];
    }
    const float n = *count;
    mean = __fdiv_rn(t1, n);
    const float raw = __fsub_rn(__fdiv_rn(t2, n), __fmul_rn(mean, mean));
    ok = raw >= 0.f ? 1.f : 0.f;
    var = fmaxf(raw, 0.f);
    const float unbiased = __fmul_rn(var, __fdiv_rn(n, fmaxf(__fsub_rn(n, 1.f), 1.f)));
    // torch's lerp with a weight below 1/2: self + weight (end - self)
    const float rm = run_mean[w], rv = run_var[w];
    run_mean[w] = __fmaf_rn(momentum, __fsub_rn(mean, rm), rm);
    run_var[w] = __fmaf_rn(momentum, __fsub_rn(unbiased, rv), rv);
  } else {
    mean = run_mean[w];
    var = run_var[w];
  }
  const float inv = rsqrtf(__fadd_rn(var, eps));
  const float sa = __fmul_rn(inv, __fadd_rn(1.f, g[w]));
  const float sc = __fsub_rn(b[w], __fmul_rn(mean, sa));
  stats[kMean * W + w] = mean;
  stats[kInv * W + w] = inv;
  stats[kA * W + w] = sa;
  stats[kC * W + w] = sc;
  stats[kAr * W + w] = bf16 ? rnd<uint16_t>(sa) : sa;
  stats[kCr * W + w] = bf16 ? rnd<uint16_t>(sc) : sc;
  stats[kVarOk * W + w] = ok;
}

// 3. The edge update e' = e + ReLU(y) (with kDrop, ReLU(y) through
// dropout), one thread per (slot, run of V).
template <typename Word, int V, bool kDrop>
__global__ void __launch_bounds__(kFlatThreads)
gated_edge_update_kernel(const Word* __restrict__ e, const Word* __restrict__ e_hat,
                         const float* __restrict__ mask, const float* __restrict__ stats,
                         const uint8_t* __restrict__ keep, float scale,
                         Word* __restrict__ e_new, int slots, int W) {
  const int tpn = W / V;
  const int i = blockIdx.x * kFlatThreads + threadIdx.x;
  if (i >= slots * tpn) return;
  const int slot = i / tpn;
  const int c0 = (i - slot * tpn) * V;
  const int off = slot * W + c0;
  if (!(__ldg(mask + slot) > 0.f)) {
    store_zero<Word, V>(e_new + off);
    return;
  }
  float ev[V], h[V], ar[V], cr[V];
  load<Word, V>(e + off, ev);
  load<Word, V>(e_hat + off, h);
  channel<V>(stats, kAr, W, c0, ar);
  channel<V>(stats, kCr, W, c0, cr);
#pragma unroll
  for (int k = 0; k < V; ++k) {
    float y = fmaxf(bn_out<Word>(h[k], ar[k], cr[k]), 0.f);
    if constexpr (kDrop) y = __ldg(keep + off + k) ? rnd<Word>(__fmul_rn(y, scale)) : 0.f;
    ev[k] += y;
  }
  store<Word, V>(e_new + off, ev);
}

// 4. The blocks' sums of dy and dy ê over the real slots.
template <typename Word, int V, bool kDrop>
__global__ void __launch_bounds__(kRowThreads, 2)
gated_edge_relu_grad_kernel(const Word* __restrict__ g, const Word* __restrict__ e_hat,
                            const float* __restrict__ mask,
                            const float* __restrict__ stats,
                            const uint8_t* __restrict__ keep, float scale,
                            float* __restrict__ part, int R, int D, int W) {
  extern __shared__ float red[];
  const int tpn = W / V;
  const int rows = blockDim.x / tpn;
  const int lr = threadIdx.x / tpn;
  const int c0 = (threadIdx.x - lr * tpn) * V;
  const int r = blockIdx.x * rows + lr;
  float s1[V], s2[V];
#pragma unroll
  for (int i = 0; i < V; ++i) s1[i] = s2[i] = 0.f;
  if (r < R) {
    float ar[V], cr[V];
    channel<V>(stats, kAr, W, c0, ar);
    channel<V>(stats, kCr, W, c0, cr);
    const float* m = mask + r * D;
    for (int k0 = 0; k0 < D; k0 += kChunk) {
      float mk[kChunk];
      chunk_mask(m, k0, D, mk);
      RawOf<Word, V> rg[kChunk] = {}, rh[kChunk] = {};
#pragma unroll
      for (int c = 0; c < kChunk; ++c)
        if (mk[c] > 0.f) {
          const int off = (r * D + k0 + c) * W + c0;
          rg[c] = load_raw<Word, V>(g + off);
          rh[c] = load_raw<Word, V>(e_hat + off);
        }
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        if (!(mk[c] > 0.f)) continue;
        float gv[V], h[V];
        unpack<Word, V>(rg[c], gv);
        unpack<Word, V>(rh[c], h);
        const int off = (r * D + k0 + c) * W + c0;
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float dy = bn_out<Word>(h[i], ar[i], cr[i]) > 0.f
                               ? dropped<Word, kDrop>(gv[i], keep, off + i, scale)
                               : 0.f;
          s1[i] += dy;
          s2[i] = __fmaf_rn(dy, h[i], s2[i]);
        }
      }
    }
  }
  block_sums<V>(red, rows, lr, c0, W, s1, s2, part);
}

// 5. The BatchNorm's backward over the channel sums: dg, db and k = (k1, k2).
__global__ void __launch_bounds__(32 * kLanes)
gated_edge_stats_grad_kernel(const float* __restrict__ part, int P,
                             const float* __restrict__ count, const float* __restrict__ g,
                             const float* __restrict__ stats, float* __restrict__ dg,
                             float* __restrict__ db, float* __restrict__ kk, int W,
                             int train) {
  __shared__ float sh[2][kLanes][33];
  const int w = blockIdx.x * 32 + threadIdx.x;
  const int lane = threadIdx.y;
  float s1 = 0.f, s2 = 0.f;
  if (w < W)
    for (int p = lane; p < P; p += kLanes) {
      s1 += part[p * W + w];
      s2 += part[(P + p) * W + w];
    }
  sh[0][lane][threadIdx.x] = s1;
  sh[1][lane][threadIdx.x] = s2;
  __syncthreads();
  if (lane != 0 || w >= W) return;
  float dc = 0.f, dar = 0.f;
  for (int j = 0; j < kLanes; ++j) {
    dc += sh[0][j][threadIdx.x];
    dar += sh[1][j][threadIdx.x];
  }
  const float mean = stats[kMean * W + w], inv = stats[kInv * W + w];
  const float sa = stats[kA * W + w];
  // c = b - mean a:  db = dc, da = d(a_r) - mean dc, d(mean) = -a dc
  const float da = __fsub_rn(dar, __fmul_rn(mean, dc));
  db[w] = dc;
  dg[w] = __fmul_rn(da, inv);
  float k1 = 0.f, k2 = 0.f;
  if (train) {
    // a = inv (1 + g), inv = rsqrt(var + eps), var = S2 / n - mean^2
    // (clamped at 0), mean = S1 / n
    const float n = *count;
    const float dinv = __fmul_rn(da, __fadd_rn(1.f, g[w]));
    const float dvar = __fmul_rn(__fmul_rn(dinv, -0.5f), __fmul_rn(__fmul_rn(inv, inv), inv))
                       * stats[kVarOk * W + w];
    const float dmean = __fsub_rn(-__fmul_rn(sa, dc), __fmul_rn(__fmul_rn(2.f, mean), dvar));
    k1 = __fdiv_rn(dmean, n);
    k2 = __fdiv_rn(__fmul_rn(2.f, dvar), n);
  }
  kk[w] = k1;
  kk[W + w] = k2;
}

// 6. The gate's backward: dt, db_j and dd; with kBn the BatchNorm's dê
// (with kDrop, its upstream gradient through dropout).
template <typename Word, int V, bool kBn, bool kDrop>
__global__ void __launch_bounds__(kRowThreads, 2)
gated_edge_gate_grad_kernel(const Word* __restrict__ dx, const float* __restrict__ den,
                            const float* __restrict__ num, const Word* __restrict__ e_hat,
                            const Word* __restrict__ bj, const Word* __restrict__ g,
                            const float* __restrict__ mask,
                            const float* __restrict__ stats, const float* __restrict__ kk,
                            const uint8_t* __restrict__ keep, float scale,
                            Word* __restrict__ dt, Word* __restrict__ dbj,
                            Word* __restrict__ dd, int R, int D, int W, float gate_eps) {
  const int tpn = W / V;
  const int rows = blockDim.x / tpn;
  const int lr = threadIdx.x / tpn;
  const int c0 = (threadIdx.x - lr * tpn) * V;
  const int r = blockIdx.x * rows + lr;
  if (r >= R) return;
  // x = a + num / (den + eps): dnum = dx / (den + eps),
  // dden = -dx num / (den + eps)^2
  float dnum[V], dden[V], dsum[V];
  {
    float q[V], dn[V], nm[V];
    load<Word, V>(dx + r * W + c0, q);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      dn[i] = __ldg(den + r * W + c0 + i) + gate_eps;
      nm[i] = __ldg(num + r * W + c0 + i);
      dnum[i] = q[i] / dn[i];
      dden[i] = -q[i] * nm[i] / (dn[i] * dn[i]);
      dsum[i] = 0.f;
    }
  }
  float ar[V], cr[V], k1[V], k2[V];
  if constexpr (kBn) {
    channel<V>(stats, kAr, W, c0, ar);
    channel<V>(stats, kCr, W, c0, cr);
    channel<V>(kk, 0, W, c0, k1);
    channel<V>(kk, 1, W, c0, k2);
  }
  const float* m = mask + r * D;
  for (int k0 = 0; k0 < D; k0 += kChunk) {
    float mk[kChunk];
    chunk_mask(m, k0, D, mk);
    RawOf<Word, V> rh[kChunk] = {}, rb[kChunk] = {}, rg[kChunk] = {};
#pragma unroll
    for (int c = 0; c < kChunk; ++c)
      if (mk[c] > 0.f) {
        const int off = (r * D + k0 + c) * W + c0;
        rh[c] = load_raw<Word, V>(e_hat + off);
        rb[c] = load_raw<Word, V>(bj + off);
        if constexpr (kBn) rg[c] = load_raw<Word, V>(g + off);
      }
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      if (k0 + c >= D) break;
      const int off = (r * D + k0 + c) * W + c0;
      if (!(mk[c] > 0.f)) {
        store_zero<Word, V>(dt + off);
        continue;
      }
      float h[V], b[V], gv[V], t[V], ds[V];
      unpack<Word, V>(rh[c], h);
      unpack<Word, V>(rb[c], b);
      if constexpr (kBn) unpack<Word, V>(rg[c], gv);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float s = sigmoid(h[i]);
        float v = __fmaf_rn(dnum[i], b[i], dden[i]) * s * (1.f - s);
        if constexpr (kBn) {
          const float dy = bn_out<Word>(h[i], ar[i], cr[i]) > 0.f
                               ? dropped<Word, kDrop>(gv[i], keep, off + i, scale)
                               : 0.f;
          v += dy * ar[i] + k1[i] + k2[i] * h[i];
        }
        t[i] = rnd<Word>(v);
        dsum[i] += t[i];
        ds[i] = s * dnum[i];
      }
      store<Word, V>(dt + off, t);
      store<Word, V>(dbj + off, ds);
    }
  }
  store<Word, V>(dd + r * W + c0, dsum);
}

// ---------------------------------------------------------------- launches

// V is 1 or 8 bytes of words; a row's runs fit one block
int check(int bf16, int R, int D, int W, int V) {
  if (R < 0 || D <= 0 || W <= 0 || (V != 1 && V * (bf16 ? 2 : 4) != 8) || W % V ||
      W / V > kRowThreads || (int64_t)R * D * W >= ((int64_t)1 << 31))
    return (int)cudaErrorInvalidValue;
  return (int)cudaSuccess;
}

int rows_of(int W, int V) { return kRowThreads / (W / V); }

template <typename Word, int V, bool kStats>
void gate_v(const void* ew, const void* ej, const void* bj, const void* d, const void* a,
            const void* mask, void* e_hat, void* x, void* den, void* num, void* part,
            int R, int D, int W, float gate_eps, cudaStream_t s) {
  const int rows = rows_of(W, V);
  const int threads = rows * (W / V);
  const size_t smem = kStats ? 2 * (size_t)rows * W * sizeof(float) : 0;
  gated_edge_gate_kernel<Word, V, kStats><<<(R + rows - 1) / rows, threads, smem, s>>>(
      static_cast<const Word*>(ew), static_cast<const Word*>(ej),
      static_cast<const Word*>(bj), static_cast<const Word*>(d),
      static_cast<const Word*>(a), static_cast<const float*>(mask),
      static_cast<Word*>(e_hat), static_cast<Word*>(x), static_cast<float*>(den),
      static_cast<float*>(num), static_cast<float*>(part), R, D, W, gate_eps);
}

template <typename Word, int V, bool kDrop>
void update_v(const void* e, const void* e_hat, const void* mask, const void* stats,
              const void* keep, float scale, void* e_new, int R, int D, int W,
              cudaStream_t s) {
  const int n = R * D * (W / V);
  gated_edge_update_kernel<Word, V, kDrop><<<(n + kFlatThreads - 1) / kFlatThreads,
                                             kFlatThreads, 0, s>>>(
      static_cast<const Word*>(e), static_cast<const Word*>(e_hat),
      static_cast<const float*>(mask), static_cast<const float*>(stats),
      static_cast<const uint8_t*>(keep), scale, static_cast<Word*>(e_new), R * D, W);
}

template <typename Word, int V, bool kDrop>
void relu_grad_v(const void* g, const void* e_hat, const void* mask, const void* stats,
                 const void* keep, float scale, void* part, int R, int D, int W,
                 cudaStream_t s) {
  const int rows = rows_of(W, V);
  const size_t smem = 2 * (size_t)rows * W * sizeof(float);
  gated_edge_relu_grad_kernel<Word, V, kDrop>
      <<<(R + rows - 1) / rows, rows * (W / V), smem, s>>>(
          static_cast<const Word*>(g), static_cast<const Word*>(e_hat),
          static_cast<const float*>(mask), static_cast<const float*>(stats),
          static_cast<const uint8_t*>(keep), scale, static_cast<float*>(part), R, D, W);
}

template <typename Word, int V, bool kBn, bool kDrop>
void gate_grad_v(const void* dx, const void* den, const void* num, const void* e_hat,
                 const void* bj, const void* g, const void* mask, const void* stats,
                 const void* kk, const void* keep, float scale, void* dt, void* dbj,
                 void* dd, int R, int D, int W, float gate_eps, cudaStream_t s) {
  const int rows = rows_of(W, V);
  gated_edge_gate_grad_kernel<Word, V, kBn, kDrop>
      <<<(R + rows - 1) / rows, rows * (W / V), 0, s>>>(
          static_cast<const Word*>(dx), static_cast<const float*>(den),
          static_cast<const float*>(num), static_cast<const Word*>(e_hat),
          static_cast<const Word*>(bj), static_cast<const Word*>(g),
          static_cast<const float*>(mask), static_cast<const float*>(stats),
          static_cast<const float*>(kk), static_cast<const uint8_t*>(keep), scale,
          static_cast<Word*>(dt), static_cast<Word*>(dbj), static_cast<Word*>(dd), R, D,
          W, gate_eps);
}

// V = 8 bytes of words (4 bfloat16, 2 float32) or 1
#define GTS_BY_V(Word, V, CALL)                                          \
  do {                                                                   \
    if (V == 1) { constexpr int kV = 1; CALL; }                          \
    else { constexpr int kV = 8 / sizeof(Word); CALL; }                  \
  } while (0)

#define GTS_BY_TYPE(bf16, V, CALL)                                       \
  do {                                                                   \
    if (bf16) { using Word = uint16_t; GTS_BY_V(Word, V, CALL); }        \
    else { using Word = float; GTS_BY_V(Word, V, CALL); }                \
  } while (0)

}  // namespace

extern "C" {

// row blocks' rows (one partial row each) for width W and runs of V words
int gts_gated_edge_rows(int W, int V) { return rows_of(W, V); }

int gts_gated_edge_gate(int bf16, int V, const void* ew, const void* ej, const void* bj,
                        const void* d, const void* a, const void* mask, void* e_hat,
                        void* x, void* den, void* num, void* part, int R, int D, int W,
                        float gate_eps, void* stream) {
  const int rc = check(bf16, R, D, W, V);
  if (rc != (int)cudaSuccess) return rc;
  if (R == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (part)
    GTS_BY_TYPE(bf16, V, (gate_v<Word, kV, true>(ew, ej, bj, d, a, mask, e_hat, x, den,
                                                 num, part, R, D, W, gate_eps, s)));
  else
    GTS_BY_TYPE(bf16, V, (gate_v<Word, kV, false>(ew, ej, bj, d, a, mask, e_hat, x, den,
                                                  num, part, R, D, W, gate_eps, s)));
  return (int)cudaGetLastError();
}

int gts_gated_edge_stats(int bf16, const void* part, int P, const void* count,
                         const void* g, const void* b, void* run_mean, void* run_var,
                         void* stats, int W, float eps, float momentum, int train,
                         void* stream) {
  if (W <= 0 || P < 0) return (int)cudaErrorInvalidValue;
  const dim3 block(32, kLanes);
  gated_edge_stats_kernel<<<(W + 31) / 32, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part), P, static_cast<const float*>(count),
      static_cast<const float*>(g), static_cast<const float*>(b),
      static_cast<float*>(run_mean), static_cast<float*>(run_var),
      static_cast<float*>(stats), W, eps, momentum, train, bf16);
  return (int)cudaGetLastError();
}

// keep (null: no dropout) is dropout's mask on the edge update, scale 1 / (1 - rate)
int gts_gated_edge_update(int bf16, int V, const void* e, const void* e_hat,
                          const void* mask, const void* stats, const void* keep,
                          float scale, void* e_new, int R, int D, int W, void* stream) {
  const int rc = check(bf16, R, D, W, V);
  if (rc != (int)cudaSuccess) return rc;
  if (R == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (keep)
    GTS_BY_TYPE(bf16, V, (update_v<Word, kV, true>(e, e_hat, mask, stats, keep, scale,
                                                   e_new, R, D, W, s)));
  else
    GTS_BY_TYPE(bf16, V, (update_v<Word, kV, false>(e, e_hat, mask, stats, keep, scale,
                                                    e_new, R, D, W, s)));
  return (int)cudaGetLastError();
}

int gts_gated_edge_relu_grad(int bf16, int V, const void* g, const void* e_hat,
                             const void* mask, const void* stats, const void* keep,
                             float scale, void* part, int R, int D, int W, void* stream) {
  const int rc = check(bf16, R, D, W, V);
  if (rc != (int)cudaSuccess) return rc;
  if (R == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (keep)
    GTS_BY_TYPE(bf16, V, (relu_grad_v<Word, kV, true>(g, e_hat, mask, stats, keep, scale,
                                                      part, R, D, W, s)));
  else
    GTS_BY_TYPE(bf16, V, (relu_grad_v<Word, kV, false>(g, e_hat, mask, stats, keep, scale,
                                                       part, R, D, W, s)));
  return (int)cudaGetLastError();
}

int gts_gated_edge_stats_grad(const void* part, int P, const void* count, const void* g,
                              const void* stats, void* dg, void* db, void* kk, int W,
                              int train, void* stream) {
  if (W <= 0 || P < 0) return (int)cudaErrorInvalidValue;
  const dim3 block(32, kLanes);
  gated_edge_stats_grad_kernel<<<(W + 31) / 32, block, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part), P, static_cast<const float*>(count),
      static_cast<const float*>(g), static_cast<const float*>(stats),
      static_cast<float*>(dg), static_cast<float*>(db), static_cast<float*>(kk), W,
      train);
  return (int)cudaGetLastError();
}

int gts_gated_edge_gate_grad(int bf16, int V, const void* dx, const void* den,
                             const void* num, const void* e_hat, const void* bj,
                             const void* g, const void* mask, const void* stats,
                             const void* kk, const void* keep, float scale, void* dt,
                             void* dbj, void* dd, int R, int D, int W, float gate_eps,
                             void* stream) {
  const int rc = check(bf16, R, D, W, V);
  if (rc != (int)cudaSuccess) return rc;
  if (R == 0) return (int)cudaSuccess;
  if (keep && !g) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (keep)
    GTS_BY_TYPE(bf16, V, (gate_grad_v<Word, kV, true, true>(
                             dx, den, num, e_hat, bj, g, mask, stats, kk, keep, scale, dt,
                             dbj, dd, R, D, W, gate_eps, s)));
  else if (g)
    GTS_BY_TYPE(bf16, V, (gate_grad_v<Word, kV, true, false>(
                             dx, den, num, e_hat, bj, g, mask, stats, kk, keep, scale, dt,
                             dbj, dd, R, D, W, gate_eps, s)));
  else
    GTS_BY_TYPE(bf16, V, (gate_grad_v<Word, kV, false, false>(
                             dx, den, num, e_hat, bj, g, mask, stats, kk, keep, scale, dt,
                             dbj, dd, R, D, W, gate_eps, s)));
  return (int)cudaGetLastError();
}

const char* gts_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
