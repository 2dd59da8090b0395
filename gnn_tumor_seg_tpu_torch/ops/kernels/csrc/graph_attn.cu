// GraphGPS's global attention over each graph's real nodes: a forward and a
// deterministic backward (a prep kernel and two kernels without atomics).
//
// Layouts (B graphs, N padded rows, H heads of F columns, 1 <= F <= 32):
//   qkv, dqkv  [B, N, 3*H*F] bf16     q | k | v, head h at columns h*F of each
//   out, gout  [B, N, H*F]   bf16     the layout `@ w_o` takes
//   lse, dsum  [B, H, N]     float32  row log-sum-exp (natural log), rowsum(dO*O)
//   counts     [B]           int32    real nodes of each graph: its rows 0..n-1
//
// 1. gps_flash_fwd_kernel: out = softmax(q k^T / sqrt(F)) v over the graph's
//    n real keys, for its n real queries; padded rows of out are 0, and so is
//    every row of a graph with n = 0. The training variant stores the row
//    log-sum-exp (+inf on padded rows); the serve variant stores none.
// 2. gps_flash_bwd_prep_kernel: dsum = rowsum(gout * out) in float32.
// 3. gps_flash_bwd_dkdv_kernel: dk and dv of a block of keys, looping over
//    the query tiles; gps_flash_bwd_dq_kernel: dq of a block of queries,
//    looping over the key tiles. Both recompute P = exp2(s*log2e/sqrt(F) -
//    lse*log2e) and dS = P (dP - dsum); each output row is summed by one warp
//    in one order, so the backward is deterministic. Padded rows of dqkv are
//    0.
//
// Replaces no Pallas kernel: GraphGPS has no JAX counterpart. It replaces
// torch's scaled_dot_product_attention (flash) on the "fast" path, which
// needed the head width padded 12 -> 16 with a key-mask channel, computed
// every pair of the padded 8 192 nodes, ran width 16 as 32 and accumulated
// dQ with float32 atomics.
//
// What bounds it on an H100: at F = 12 a query-key pair costs 2 F = 24 MACs
// on the tensor cores (4 F forward and 10 F backward flops) but one exp2 on
// the SFU, which runs 16 a clock an SM (~4.2 T/s on the card), plus a few
// FP32 operations (scale and shift, sum, the bf16 packing, dP - D and the
// product). So the SFU and the FMA pipe bound it, not the tensor cores or
// the bytes (q, k, v and out are 2.4 MB a graph and head pair of passes);
// the backward pays two exp2 a pair (P recomputed once in each kernel).
//
// Design: FA2-style tiles over `mma.sync.m16n8k16` (bf16 in, float32
// accumulators): a head width up to 16 is one k-step (KD = 1), up to 32 two;
// columns F..16 KD-1 are zeros staged in shared memory, never read from
// device memory. A block covers a fixed tile of rows of the padded grid and
// reads n from `counts`: a tile at or past n writes zeros and exits, key and
// query loops stop at the tile holding n - 1, and the last tile masks its
// rows at and past n, so pairs with padding are computed only up to the
// tile edge (ceil(n/128)*128 queries by ceil(n/32)*32 keys a graph and head
// forward, 128 by 64 backward: 7 040 x 7 008 and 7 040^2 for n = 7 000). The
// softmax's score tile (32 keys) stays in registers; S's accumulator
// fragments are P's A fragments for P V, so P never touches shared memory.
// The online softmax rescales O and l only when some row's maximum grew (a
// warp vote), which skips that exp2 on most tiles. Tiles are staged through registers into double-buffered
// shared memory (one barrier a tile; a loaded word is first used by its
// store after the tile's compute, so the load latency hides behind it),
// row-major with rows padded to 8 KD + 4 words and transposed with columns
// padded to 8 halves past the tile, so every `ldmatrix` of B fragments hits
// 32 banks. The backward kernels hold 32 rows a warp (two m-tiles sharing
// each fragment read from shared memory), which halves the shared-memory
// bytes a pair. Launch bounds keep 4 blocks an SM (32 forward warps, 16
// backward) without spills; other bounds and tiles, 16 rows a warp in the
// backward, and the row sum from a column of ones in V ran no faster on the
// card (PERF.md). Every exp2 is `ex2.approx.ftz.f32`.
//
// Offsets are 32-bit: the entry points refuse B*N*3*H*F >= 2^31.

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kFwdWarps = 8;
constexpr int kFwdThreads = 32 * kFwdWarps;
constexpr int kFwdMinBlocks = 4;      // the forward's launch bound at KD = 1
constexpr int kBM = 16 * kFwdWarps;   // forward: queries a block, 16 a warp
constexpr int kBN = 32;               // forward: keys a tile
constexpr int kBwdWarps = 4;
constexpr int kBwdThreads = 32 * kBwdWarps;
constexpr int kDkdvMinBlocks = 4;     // the backward's launch bounds at KD = 1
constexpr int kDqMinBlocks = 4;
constexpr int kMT = 2;                // backward: m-tiles of 16 rows a warp
constexpr int kBR = 16 * kMT * kBwdWarps;   // backward: a block's own rows
constexpr int kBT = 64;               // backward: rows of the other side a tile
constexpr int kPrepThreads = 256;
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// two floats as one bf16x2 word, `lo` in the low half (the lower column of a
// fragment), each rounded to nearest even
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint16_t to_bf16(float v) {
  return __bfloat16_as_ushort(__float2bfloat16(v));
}

__device__ __forceinline__ float from_bf16(uint16_t b) {
  return __uint_as_float((uint32_t)b << 16);
}

// d += a b: m16n8k16, a row-major 16x16 and b column-major 16x8 in bf16, d
// float32. Lane l = 4 g + t holds a[0..3] = A(g, 2t..2t+1), A(g+8, 2t..),
// A(g, 2t+8..), A(g+8, 2t+8..); b0 = B(2t..2t+1, g), b1 = B(2t+8.., g);
// d[0..3] = D(g, 2t), D(g, 2t+1), D(g+8, 2t), D(g+8, 2t+1).
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 b16 matrices from shared memory: lane i gives the address of row
// i % 8 of matrix i / 8 and gets r[m] = the pair (row g, columns 2t, 2t+1)
// of matrix m, a B fragment of m16n8k16.
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const uint32_t* row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

// The row this lane gives ldsm4 for the B fragments of two n-tiles (rows
// row0..row0+15 of a tile in shared memory, `stride` words a row) at the
// k-step whose 16 values start at word `col`: r[0], r[1] are b0, b1 of rows
// row0.., r[2], r[3] those of rows row0 + 8...
__device__ __forceinline__ const uint32_t* frag_row(const uint32_t* s, int row0,
                                                   int col, int stride, int lane) {
  return s + (row0 + 8 * (lane >> 4) + (lane & 7)) * stride + col +
         4 * ((lane >> 3) & 1);
}

// Columns c and c + 1 (c even) of a row as one word, 0 at and past F.
// `vec`: F is even and the matrix 4-byte aligned, so the pair is one load.
__device__ __forceinline__ uint32_t load_pair(const uint16_t* row, int c, int F,
                                              bool vec) {
  if (c >= F) return 0u;
  if (vec) return __ldg(reinterpret_cast<const uint32_t*>(row + c));
  const uint32_t lo = __ldg(row + c);
  const uint32_t hi = c + 1 < F ? (uint32_t)__ldg(row + c + 1) : 0u;
  return lo | (hi << 16);
}

// A fragments (k-steps 0..KD-1) of rows r and r + 8 of a row-major matrix in
// device memory (`head` its first column, `stride` its row stride); rows at
// and past n read 0.
template <int KD>
__device__ __forceinline__ void load_a(uint32_t (&a)[KD][4], const uint16_t* head,
                                       int stride, int r, int n, int F, bool vec,
                                       int t) {
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    const int c = 16 * kk + 2 * t;
    const bool v0 = r < n, v1 = r + 8 < n;
    a[kk][0] = v0 ? load_pair(head + r * stride, c, F, vec) : 0u;
    a[kk][1] = v1 ? load_pair(head + (r + 8) * stride, c, F, vec) : 0u;
    a[kk][2] = v0 ? load_pair(head + r * stride, c + 8, F, vec) : 0u;
    a[kk][3] = v1 ? load_pair(head + (r + 8) * stride, c + 8, F, vec) : 0u;
  }
}

// One thread's share of an R-row tile (rows r0.., F columns zero-extended
// to 16 KD) on its way from device to shared memory: `load` reads its words
// into registers (rows at and past n read 0), `store_rows` writes them
// row-major (kRowWords words a row) and `store_cols` transposed (kColHalves
// halves a column). The padding puts the 8 rows or columns of a fragment read on 32
// distinct banks. A loaded word is first used by a store, after the tile's
// compute, so the loads' latency hides behind it.
template <int R, int KD, int T>
struct Tile {
  static constexpr int kWords = 8 * KD;
  static constexpr int kRowWords = kWords + 4;
  static constexpr int kColHalves = R + 8;
  static constexpr int kColWords = kColHalves / 2;
  static constexpr int kRowTile = R * kRowWords;          // words in shared memory
  static constexpr int kColTile = 16 * KD * kColWords;
  static constexpr int kItems = R * kWords / T;
  static_assert(R * kWords % T == 0, "a tile's words split evenly over the threads");
  uint32_t v[kItems];

  __device__ __forceinline__ void load(const uint16_t* head, int stride, int r0,
                                       int n, int F, bool vec) {
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int item = threadIdx.x + i * T;
      const int r = r0 + item / kWords;
      v[i] = r < n ? load_pair(head + r * stride, 2 * (item % kWords), F, vec) : 0u;
    }
  }

  __device__ __forceinline__ void store_rows(uint32_t* s) const {
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int item = threadIdx.x + i * T;
      s[(item / kWords) * kRowWords + item % kWords] = v[i];
    }
  }

  __device__ __forceinline__ void store_cols(uint32_t* s) const {
    uint16_t* h = reinterpret_cast<uint16_t*>(s);
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const int item = threadIdx.x + i * T;
      const int j = item / kWords, c = 2 * (item % kWords);
      h[c * kColHalves + j] = (uint16_t)(v[i] & 0xffffu);
      h[(c + 1) * kColHalves + j] = (uint16_t)(v[i] >> 16);
    }
  }
};

// Rows r0..r0+rows-1 (those under N) of F columns set to +0.0.
__device__ __forceinline__ void zero_rows(uint16_t* head, int stride, int r0,
                                          int rows, int N, int F, int T) {
  for (int i = threadIdx.x; i < rows * F; i += T) {
    const int r = r0 + i / F;
    if (r < N) head[r * stride + i % F] = 0;
  }
}

// One block: kBM queries of graph blockIdx.z, head blockIdx.y; warp w holds
// queries 16 w.. (rows r and r + 8 of its lane group g).
template <int KD, bool kLse>
__global__ void __launch_bounds__(kFwdThreads, KD == 1 ? kFwdMinBlocks : 2)
gps_flash_fwd_kernel(const uint16_t* __restrict__ qkv,
                     const int32_t* __restrict__ counts, uint16_t* __restrict__ out,
                     float* __restrict__ lse, int N, int H, int F, float scale_log2,
                     bool vec) {
  using KT = Tile<kBN, KD, kFwdThreads>;
  __shared__ __align__(16) uint32_t ks[2][KT::kRowTile];
  __shared__ __align__(16) uint32_t vt[2][KT::kColTile];
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBM;
  const int n = __ldg(counts + b);
  const int HF = H * F, stride = 3 * HF;
  const uint16_t* qh = qkv + b * N * stride + h * F;
  const uint16_t* kh = qh + HF;
  const uint16_t* vh = kh + HF;
  uint16_t* oh = out + b * N * HF + h * F;
  float* lrow = kLse ? lse + (b * H + h) * N : nullptr;
  if (q0 >= n) {                       // no real query in the tile
    zero_rows(oh, HF, q0, kBM, N, F, kFwdThreads);
    if (kLse)
      for (int i = threadIdx.x; i < kBM && q0 + i < N; i += kFwdThreads)
        lrow[q0 + i] = INFINITY;
    return;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r = q0 + 16 * warp + g;
  uint32_t qa[KD][4];
  load_a<KD>(qa, qh, stride, r, n, F, vec, t);
  float o[2 * KD][4];
#pragma unroll
  for (int dn = 0; dn < 2 * KD; ++dn) o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const int tiles = (n + kBN - 1) / kBN;
  KT tk, tv;
  tk.load(kh, stride, 0, n, F, vec);
  tv.load(vh, stride, 0, n, F, vec);
  tk.store_rows(ks[0]);
  tv.store_cols(vt[0]);
  __syncthreads();
  for (int it = 0; it < tiles; ++it) {
    const int buf = it & 1, k0 = it * kBN;
    const bool more = it + 1 < tiles;
    if (more) {
      tk.load(kh, stride, k0 + kBN, n, F, vec);
      tv.load(vh, stride, k0 + kBN, n, F, vec);
    }
    // s = q k^T over the tile's keys: key 8 nt + 2t (+1) in s[nt][0..1], rows r
    // and r + 8 in [0..1] and [2..3]
    float s[kBN / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBN / 8; nt += 2) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = s[nt + 1][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t kb[4];
        ldsm4(kb, frag_row(ks[buf], 8 * nt, 8 * kk, KT::kRowWords, lane));
        mma(s[nt], qa[kk], kb[0], kb[1]);
        mma(s[nt + 1], qa[kk], kb[2], kb[3]);
      }
    }
    if (k0 + kBN > n) {                // the last tile: keys at and past n weigh 0
#pragma unroll
      for (int nt = 0; nt < kBN / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + 8 * nt + 2 * t + (e & 1) >= n) s[nt][e] = -INFINITY;
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt) {
      mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(kAll, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(kAll, mx[i], 2));
    }
    // tile 0 holds key 0, so every row's maximum is finite from it on
    if (__any_sync(kAll, mx[0] != m[0] || mx[1] != m[1])) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float a = ex2((m[i] - mx[i]) * scale_log2);
        l[i] *= a;
#pragma unroll
        for (int dn = 0; dn < 2 * KD; ++dn) {
          o[dn][2 * i] *= a;
          o[dn][2 * i + 1] *= a;
        }
        m[i] = mx[i];
      }
    }
    const float shift0 = -m[0] * scale_log2, shift1 = -m[1] * scale_log2;
#pragma unroll
    for (int nt = 0; nt < kBN / 8; ++nt) {
      s[nt][0] = ex2(fmaf(s[nt][0], scale_log2, shift0));
      s[nt][1] = ex2(fmaf(s[nt][1], scale_log2, shift0));
      s[nt][2] = ex2(fmaf(s[nt][2], scale_log2, shift1));
      s[nt][3] = ex2(fmaf(s[nt][3], scale_log2, shift1));
      l[0] += s[nt][0] + s[nt][1];
      l[1] += s[nt][2] + s[nt][3];
    }
    // o += p v, 16 keys a k-step: p's accumulators are its A fragments
#pragma unroll
    for (int j = 0; j < kBN / 16; ++j) {
      const uint32_t pa[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]),
                              pack_bf16(s[2 * j][2], s[2 * j][3]),
                              pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                              pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
      for (int dn = 0; dn < 2 * KD; dn += 2) {
        uint32_t vb[4];
        ldsm4(vb, frag_row(vt[buf], 8 * dn, 8 * j, KT::kColWords, lane));
        mma(o[dn], pa, vb[0], vb[1]);
        mma(o[dn + 1], pa, vb[2], vb[3]);
      }
    }
    if (more) {
      tk.store_rows(ks[buf ^ 1]);
      tv.store_cols(vt[buf ^ 1]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(kAll, l[i], 1);
    l[i] += __shfl_xor_sync(kAll, l[i], 2);
    const int row = r + 8 * i;
    if (row >= N) continue;
    const bool real = row < n;
    const float inv = 1.f / l[i];
    uint16_t* orow = oh + row * HF;
#pragma unroll
    for (int dn = 0; dn < 2 * KD; ++dn)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * dn + 2 * t + e;
        if (c < F) orow[c] = real ? to_bf16(o[dn][2 * i + e] * inv) : (uint16_t)0;
      }
    if (kLse && t == 0)
      lrow[row] = real ? (m[i] * scale_log2 + log2f(l[i])) * kLn2 : INFINITY;
  }
}

// dsum[b, h, row] = sum over c < F of gout * out (float32, in column
// order); 0 on padded rows. One thread a (row, head) of graph blockIdx.y.
__global__ void __launch_bounds__(kPrepThreads)
gps_flash_bwd_prep_kernel(const uint16_t* __restrict__ out,
                          const uint16_t* __restrict__ gout,
                          const int32_t* __restrict__ counts,
                          float* __restrict__ dsum, int N, int H, int F) {
  const int b = blockIdx.y;
  const int idx = blockIdx.x * kPrepThreads + threadIdx.x;   // row * H + head
  if (idx >= N * H) return;
  const int row = idx / H, h = idx - row * H;
  float s = 0.f;
  if (row < __ldg(counts + b)) {
    const int off = (b * N * H + idx) * F;
    for (int c = 0; c < F; ++c)
      s = fmaf(from_bf16(__ldg(out + off + c)), from_bf16(__ldg(gout + off + c)), s);
  }
  dsum[(b * H + h) * N + row] = s;
}

// A tile's per-query statistics on their way to shared memory: threads
// below kBT hold a query's lse * log2e (+inf on a padded row), the others
// its dsum (0 there).
__device__ __forceinline__ float load_stat(const float* lrow, const float* drow,
                                           int q0, int n) {
  const int row = q0 + threadIdx.x % kBT;
  if (threadIdx.x < kBT) return row < n ? __ldg(lrow + row) * kLog2e : INFINITY;
  return row < n ? __ldg(drow + row) : 0.f;
}

// One block: kBR keys of graph blockIdx.z, head blockIdx.y; warp w holds
// keys 32 w.. as two m-tiles (rows r + 16 mt and r + 16 mt + 8). Loops over
// the query tiles: s^T = k q^T, dp^T = v dO^T, p^T = exp2(s^T scale_log2 -
// lse2), ds^T = p^T (dp^T - dsum); dv += p^T dO, dk += ds^T q (scaled at the
// end). The accumulators of p^T and ds^T are the A fragments of those
// products.
template <int KD>
__global__ void __launch_bounds__(kBwdThreads, KD == 1 ? kDkdvMinBlocks : 2)
gps_flash_bwd_dkdv_kernel(const uint16_t* __restrict__ qkv,
                          const uint16_t* __restrict__ gout,
                          const float* __restrict__ lse,
                          const float* __restrict__ dsum,
                          const int32_t* __restrict__ counts,
                          uint16_t* __restrict__ dqkv, int N, int H, int F,
                          float scale_log2, float scale, bool vec) {
  static_assert(kBwdThreads == 2 * kBT, "a tile's statistics are a thread each");
  using QT = Tile<kBT, KD, kBwdThreads>;
  __shared__ __align__(16) uint32_t qs[2][QT::kRowTile];
  __shared__ __align__(16) uint32_t gs[2][QT::kRowTile];
  __shared__ __align__(16) uint32_t qt[2][QT::kColTile];
  __shared__ __align__(16) uint32_t gt[2][QT::kColTile];
  __shared__ __align__(16) float stat_s[2][2 * kBT];       // lse2 | dsum
  const int b = blockIdx.z, h = blockIdx.y, k0 = blockIdx.x * kBR;
  const int n = __ldg(counts + b);
  const int HF = H * F, stride = 3 * HF;
  const uint16_t* qh = qkv + b * N * stride + h * F;
  const uint16_t* kh = qh + HF;
  const uint16_t* vh = kh + HF;
  const uint16_t* gh = gout + b * N * HF + h * F;
  uint16_t* dkh = dqkv + b * N * stride + HF + h * F;
  uint16_t* dvh = dkh + HF;
  const float* lrow = lse + (b * H + h) * N;
  const float* drow = dsum + (b * H + h) * N;
  if (k0 >= n) {                       // no real key in the block
    zero_rows(dkh, stride, k0, kBR, N, F, kBwdThreads);
    zero_rows(dvh, stride, k0, kBR, N, F, kBwdThreads);
    return;
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r = k0 + 16 * kMT * warp + g;
  uint32_t ka[kMT][KD][4], va[kMT][KD][4];
  float dk[kMT][2 * KD][4], dv[kMT][2 * KD][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
    load_a<KD>(ka[mt], kh, stride, r + 16 * mt, n, F, vec, t);
    load_a<KD>(va[mt], vh, stride, r + 16 * mt, n, F, vec, t);
#pragma unroll
    for (int dn = 0; dn < 2 * KD; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[mt][dn][e] = dv[mt][dn][e] = 0.f;
  }
  const int tiles = (n + kBT - 1) / kBT;
  QT tq, tg;
  tq.load(qh, stride, 0, n, F, vec);
  tg.load(gh, HF, 0, n, F, vec);
  float stat = load_stat(lrow, drow, 0, n);
  tq.store_rows(qs[0]);
  tq.store_cols(qt[0]);
  tg.store_rows(gs[0]);
  tg.store_cols(gt[0]);
  stat_s[0][threadIdx.x] = stat;
  __syncthreads();
  for (int it = 0; it < tiles; ++it) {
    const int buf = it & 1;
    const bool more = it + 1 < tiles;
    if (more) {
      tq.load(qh, stride, (it + 1) * kBT, n, F, vec);
      tg.load(gh, HF, (it + 1) * kBT, n, F, vec);
      stat = load_stat(lrow, drow, (it + 1) * kBT, n);
    }
#pragma unroll
    for (int j = 0; j < kBT / 16; ++j) {   // 16 queries a k-step
      // queries 16 j + 8 nt + 2t (+1) are the columns of [nt][0..1] and [2..3]
      float2 l2[2], dd[2];
      float st[kMT][2][4], dp[kMT][2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int c = 16 * j + 8 * nt + 2 * t;
        l2[nt] = *reinterpret_cast<const float2*>(&stat_s[buf][c]);
        dd[nt] = *reinterpret_cast<const float2*>(&stat_s[buf][kBT + c]);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            st[mt][nt][e] = 0.f;
            dp[mt][nt][e] = 0.f;
          }
      }
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t qb[4], gb[4];
        ldsm4(qb, frag_row(qs[buf], 16 * j, 8 * kk, QT::kRowWords, lane));
        ldsm4(gb, frag_row(gs[buf], 16 * j, 8 * kk, QT::kRowWords, lane));
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          mma(st[mt][0], ka[mt][kk], qb[0], qb[1]);
          mma(st[mt][1], ka[mt][kk], qb[2], qb[3]);
          mma(dp[mt][0], va[mt][kk], gb[0], gb[1]);
          mma(dp[mt][1], va[mt][kk], gb[2], gb[3]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = ex2(fmaf(st[mt][nt][e], scale_log2,
                                     -((e & 1) ? l2[nt].y : l2[nt].x)));
            st[mt][nt][e] = p;
            dp[mt][nt][e] = p * (dp[mt][nt][e] - ((e & 1) ? dd[nt].y : dd[nt].x));
          }
      uint32_t pa[kMT][4], sa[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        pa[mt][0] = pack_bf16(st[mt][0][0], st[mt][0][1]);
        pa[mt][1] = pack_bf16(st[mt][0][2], st[mt][0][3]);
        pa[mt][2] = pack_bf16(st[mt][1][0], st[mt][1][1]);
        pa[mt][3] = pack_bf16(st[mt][1][2], st[mt][1][3]);
        sa[mt][0] = pack_bf16(dp[mt][0][0], dp[mt][0][1]);
        sa[mt][1] = pack_bf16(dp[mt][0][2], dp[mt][0][3]);
        sa[mt][2] = pack_bf16(dp[mt][1][0], dp[mt][1][1]);
        sa[mt][3] = pack_bf16(dp[mt][1][2], dp[mt][1][3]);
      }
#pragma unroll
      for (int dn = 0; dn < 2 * KD; dn += 2) {
        uint32_t gb[4], qb[4];
        ldsm4(gb, frag_row(gt[buf], 8 * dn, 8 * j, QT::kColWords, lane));
        ldsm4(qb, frag_row(qt[buf], 8 * dn, 8 * j, QT::kColWords, lane));
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          mma(dv[mt][dn], pa[mt], gb[0], gb[1]);
          mma(dv[mt][dn + 1], pa[mt], gb[2], gb[3]);
          mma(dk[mt][dn], sa[mt], qb[0], qb[1]);
          mma(dk[mt][dn + 1], sa[mt], qb[2], qb[3]);
        }
      }
    }
    if (more) {
      tq.store_rows(qs[buf ^ 1]);
      tq.store_cols(qt[buf ^ 1]);
      tg.store_rows(gs[buf ^ 1]);
      tg.store_cols(gt[buf ^ 1]);
      stat_s[buf ^ 1][threadIdx.x] = stat;
    }
    __syncthreads();
  }
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r + 16 * mt + 8 * i;
      if (row >= N) continue;
      const bool real = row < n;
#pragma unroll
      for (int dn = 0; dn < 2 * KD; ++dn)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * dn + 2 * t + e;
          if (c >= F) continue;
          dkh[row * stride + c] = real ? to_bf16(dk[mt][dn][2 * i + e] * scale) : (uint16_t)0;
          dvh[row * stride + c] = real ? to_bf16(dv[mt][dn][2 * i + e]) : (uint16_t)0;
        }
    }
}

// One block: kBR queries of graph blockIdx.z, head blockIdx.y; warp w holds
// queries 32 w.. as two m-tiles. Loops over the key tiles: s = q k^T, dp =
// dO v^T, p = exp2(s scale_log2 - lse2) (0 on keys at and past n), ds = p
// (dp - dsum); dq += ds k (scaled at the end).
template <int KD>
__global__ void __launch_bounds__(kBwdThreads, KD == 1 ? kDqMinBlocks : 2)
gps_flash_bwd_dq_kernel(const uint16_t* __restrict__ qkv,
                        const uint16_t* __restrict__ gout,
                        const float* __restrict__ lse,
                        const float* __restrict__ dsum,
                        const int32_t* __restrict__ counts,
                        uint16_t* __restrict__ dqkv, int N, int H, int F,
                        float scale_log2, float scale, bool vec) {
  using KT = Tile<kBT, KD, kBwdThreads>;
  __shared__ __align__(16) uint32_t ks[2][KT::kRowTile];
  __shared__ __align__(16) uint32_t vs[2][KT::kRowTile];
  __shared__ __align__(16) uint32_t kt[2][KT::kColTile];
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kBR;
  const int n = __ldg(counts + b);
  const int HF = H * F, stride = 3 * HF;
  const uint16_t* qh = qkv + b * N * stride + h * F;
  const uint16_t* kh = qh + HF;
  const uint16_t* vh = kh + HF;
  const uint16_t* gh = gout + b * N * HF + h * F;
  uint16_t* dqh = dqkv + b * N * stride + h * F;
  if (q0 >= n) {                       // no real query in the block
    zero_rows(dqh, stride, q0, kBR, N, F, kBwdThreads);
    return;
  }
  const float* lrow = lse + (b * H + h) * N;
  const float* drow = dsum + (b * H + h) * N;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r = q0 + 16 * kMT * warp + g;
  uint32_t qa[kMT][KD][4], ga[kMT][KD][4];
  float l2[kMT][2], dd[kMT][2], dq[kMT][2 * KD][4];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
    load_a<KD>(qa[mt], qh, stride, r + 16 * mt, n, F, vec, t);
    load_a<KD>(ga[mt], gh, HF, r + 16 * mt, n, F, vec, t);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r + 16 * mt + 8 * i;
      l2[mt][i] = row < n ? __ldg(lrow + row) * kLog2e : INFINITY;
      dd[mt][i] = row < n ? __ldg(drow + row) : 0.f;
    }
#pragma unroll
    for (int dn = 0; dn < 2 * KD; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) dq[mt][dn][e] = 0.f;
  }
  const int tiles = (n + kBT - 1) / kBT;
  KT tk, tv;
  tk.load(kh, stride, 0, n, F, vec);
  tv.load(vh, stride, 0, n, F, vec);
  tk.store_rows(ks[0]);
  tk.store_cols(kt[0]);
  tv.store_rows(vs[0]);
  __syncthreads();
  for (int it = 0; it < tiles; ++it) {
    const int buf = it & 1, k0 = it * kBT;
    const bool more = it + 1 < tiles;
    if (more) {
      tk.load(kh, stride, k0 + kBT, n, F, vec);
      tv.load(vh, stride, k0 + kBT, n, F, vec);
    }
#pragma unroll 2
    for (int j = 0; j < kBT / 16; ++j) {   // 16 keys a k-step
      float s[kMT][2][4], dp[kMT][2][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[mt][nt][e] = 0.f;
            dp[mt][nt][e] = 0.f;
          }
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t kb[4], vb[4];
        ldsm4(kb, frag_row(ks[buf], 16 * j, 8 * kk, KT::kRowWords, lane));
        ldsm4(vb, frag_row(vs[buf], 16 * j, 8 * kk, KT::kRowWords, lane));
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          mma(s[mt][0], qa[mt][kk], kb[0], kb[1]);
          mma(s[mt][1], qa[mt][kk], kb[2], kb[3]);
          mma(dp[mt][0], ga[mt][kk], vb[0], vb[1]);
          mma(dp[mt][1], ga[mt][kk], vb[2], vb[3]);
        }
      }
      const bool edge = k0 + 16 * j + 16 > n;
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p = ex2(fmaf(s[mt][nt][e], scale_log2, -l2[mt][e >> 1]));
            if (edge && k0 + 16 * j + 8 * nt + 2 * t + (e & 1) >= n) p = 0.f;
            dp[mt][nt][e] = p * (dp[mt][nt][e] - dd[mt][e >> 1]);
          }
      uint32_t sa[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        sa[mt][0] = pack_bf16(dp[mt][0][0], dp[mt][0][1]);
        sa[mt][1] = pack_bf16(dp[mt][0][2], dp[mt][0][3]);
        sa[mt][2] = pack_bf16(dp[mt][1][0], dp[mt][1][1]);
        sa[mt][3] = pack_bf16(dp[mt][1][2], dp[mt][1][3]);
      }
#pragma unroll
      for (int dn = 0; dn < 2 * KD; dn += 2) {
        uint32_t kb[4];
        ldsm4(kb, frag_row(kt[buf], 8 * dn, 8 * j, KT::kColWords, lane));
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          mma(dq[mt][dn], sa[mt], kb[0], kb[1]);
          mma(dq[mt][dn + 1], sa[mt], kb[2], kb[3]);
        }
      }
    }
    if (more) {
      tk.store_rows(ks[buf ^ 1]);
      tk.store_cols(kt[buf ^ 1]);
      tv.store_rows(vs[buf ^ 1]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = r + 16 * mt + 8 * i;
      if (row >= N) continue;
      const bool real = row < n;
#pragma unroll
      for (int dn = 0; dn < 2 * KD; ++dn)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * dn + 2 * t + e;
          if (c < F)
            dqh[row * stride + c] = real ? to_bf16(dq[mt][dn][2 * i + e] * scale) : (uint16_t)0;
        }
    }
}

bool dims_ok(int B, int N, int H, int F) {
  return B >= 1 && N >= 1 && H >= 1 && F >= 1 && F <= 32 && B <= 65535 &&
         H <= 65535 && (int64_t)B * N * 3 * H * F < ((int64_t)1 << 31);
}

bool aligned4(const void* p) { return reinterpret_cast<uintptr_t>(p) % 4 == 0; }

template <int KD>
void launch_fwd(const uint16_t* qkv, const int32_t* counts, uint16_t* out,
                float* lse, int B, int N, int H, int F, float scale_log2,
                bool vec, cudaStream_t s) {
  const dim3 grid((N + kBM - 1) / kBM, H, B);
  if (lse)
    gps_flash_fwd_kernel<KD, true><<<grid, kFwdThreads, 0, s>>>(
        qkv, counts, out, lse, N, H, F, scale_log2, vec);
  else
    gps_flash_fwd_kernel<KD, false><<<grid, kFwdThreads, 0, s>>>(
        qkv, counts, out, lse, N, H, F, scale_log2, vec);
}

template <int KD>
int launch_bwd(const uint16_t* qkv, const uint16_t* out, const uint16_t* gout,
               const float* lse, const int32_t* counts, float* dsum,
               uint16_t* dqkv, int B, int N, int H, int F, float scale_log2,
               float scale, bool vec, cudaStream_t s) {
  gps_flash_bwd_prep_kernel<<<dim3((N * H + kPrepThreads - 1) / kPrepThreads, B),
                              kPrepThreads, 0, s>>>(out, gout, counts, dsum, N, H, F);
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  const dim3 grid((N + kBR - 1) / kBR, H, B);
  gps_flash_bwd_dkdv_kernel<KD><<<grid, kBwdThreads, 0, s>>>(
      qkv, gout, lse, dsum, counts, dqkv, N, H, F, scale_log2, scale, vec);
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return (int)rc;
  gps_flash_bwd_dq_kernel<KD><<<grid, kBwdThreads, 0, s>>>(
      qkv, gout, lse, dsum, counts, dqkv, N, H, F, scale_log2, scale, vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out [B,N,H*F] and, unless lse is null, lse [B,H,N] from qkv [B,N,3*H*F]
// and counts [B]; scale_log2 = log2(e) / sqrt(F).
int gts_gps_attn_fwd(const void* qkv, const void* counts, void* out, void* lse,
                     int B, int N, int H, int F, float scale_log2, void* stream) {
  if (!dims_ok(B, N, H, F)) return (int)cudaErrorInvalidValue;
  const bool vec = F % 2 == 0 && aligned4(qkv);
  const auto* q = static_cast<const uint16_t*>(qkv);
  const auto* c = static_cast<const int32_t*>(counts);
  auto* o = static_cast<uint16_t*>(out);
  auto* l = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (F <= 16) launch_fwd<1>(q, c, o, l, B, N, H, F, scale_log2, vec, s);
  else launch_fwd<2>(q, c, o, l, B, N, H, F, scale_log2, vec, s);
  return (int)cudaGetLastError();
}

// dqkv [B,N,3*H*F] from the forward's qkv, out and lse and gout [B,N,H*F];
// dsum [B,H,N] is float32 scratch; scale = 1 / sqrt(F).
int gts_gps_attn_bwd(const void* qkv, const void* out, const void* gout,
                     const void* lse, const void* counts, void* dsum, void* dqkv,
                     int B, int N, int H, int F, float scale_log2, float scale,
                     void* stream) {
  if (!dims_ok(B, N, H, F)) return (int)cudaErrorInvalidValue;
  const bool vec = F % 2 == 0 && aligned4(qkv) && aligned4(gout);
  const auto* q = static_cast<const uint16_t*>(qkv);
  const auto* o = static_cast<const uint16_t*>(out);
  const auto* go = static_cast<const uint16_t*>(gout);
  const auto* l = static_cast<const float*>(lse);
  const auto* c = static_cast<const int32_t*>(counts);
  auto* d = static_cast<float*>(dsum);
  auto* dq = static_cast<uint16_t*>(dqkv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return F <= 16
      ? launch_bwd<1>(q, o, go, l, c, d, dq, B, N, H, F, scale_log2, scale, vec, s)
      : launch_bwd<2>(q, o, go, l, c, d, dq, B, N, H, F, scale_log2, scale, vec, s);
}

const char* gts_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
