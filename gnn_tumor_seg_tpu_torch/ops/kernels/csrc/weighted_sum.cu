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
// 1. wsum_kernel<T, false> replaces gnn_tumor_seg_tpu/ops/pallas/
//    weighted_sum.py:86 `_wsum_kernel` (launched by `_wsum_raw`, :114):
//      out[v,h,:] = sum over v's real slots d of w[v,d,h] * values[nbr[v,d],h,:].
//    A padded slot adds nothing, whatever its weight (weighted_sum.py:98-99).
// 2. wsum_kernel<T, true> is the same kernel in the gradient
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
// supervoxel graphs, whose node ids follow space).
//
// Design (first, simple version; the layout of fused_gat.cu): the TPU
// kernels' weighted one-hot histograms on the MXU over a compacted
// unique-row block, carried as bf16 hi/lo halves (weighted_sum.py:8-15,
// 95-110), work around slow row gathers on the TPU; here every kernel reads
// nbr directly. The combines give a block a tile of destination rows: the
// block stages each row's source slots (padded as -1) and their per-head
// weights (forward, or reverse through rslot) in shared memory, then the
// threads run along HF, each accumulating its feature over the slots in a
// register. The pair dot gives a group of G lanes (a power of two from 4 to
// 32) one (row, head): the lanes stride over F for each slot's dot and
// reduce with xor shuffles inside the group. Left for later: vector loads,
// more rows per block at wide HF, cp.async or TMA staging.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxDegree = 128;
constexpr int kMaxHeads = 16;
constexpr int kThreads = 256;
constexpr size_t kSmemBudget = 48 * 1024;

__device__ __forceinline__ float load_as_float(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_as_float(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}
__device__ __forceinline__ void store_from_float(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_from_float(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as torch's .to(bfloat16)
}

// ---------------------------------------------------------------- combine

template <typename T, bool kReverse>
__global__ void wsum_kernel(const T* __restrict__ values,
                            const float* __restrict__ weights,
                            const int32_t* __restrict__ nbr,
                            const float* __restrict__ mask,
                            const int32_t* __restrict__ rslot,
                            T* __restrict__ out, int N, int D, int H, int F) {
  extern __shared__ float smem[];
  const int R = blockDim.y;                                 // rows per block
  int32_t* slots = reinterpret_cast<int32_t*>(smem);        // [R, D] source or -1
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

  // each slot's weights: the row's own, or the reverse edge's from the
  // neighbour's row through rslot
  for (int i = tid; i < R * DH; i += nt) {
    const int rl = i / DH;
    const int d = (i / H) % D;
    const int h = i % H;
    const int32_t s = slots[rl * D + d];
    float wv = 0.f;
    if (s >= 0) {
      const int64_t off = ((int64_t)b * N + row0 + rl) * D + d;
      wv = kReverse ? weights[(((int64_t)b * N + s) * D + rslot[off]) * H + h]
                    : weights[off * H + h];
    }
    w[i] = wv;
  }
  __syncthreads();

  const int rl = threadIdx.y;
  const int r = row0 + rl;
  if (r >= N) return;
  const int64_t node = (int64_t)b * N + r;
  const int32_t* rs = slots + rl * D;
  const float* wr = w + rl * DH;
  const T* vb = values + (int64_t)b * N * HF;
  for (int f = threadIdx.x; f < HF; f += blockDim.x) {
    const int h = f / F;
    float acc = 0.f;
    for (int d = 0; d < D; ++d) {
      const int32_t s = rs[d];
      if (s < 0) continue;
      acc = __fadd_rn(acc, __fmul_rn(wr[d * H + h],
                                     load_as_float(vb + (int64_t)s * HF + f)));
    }
    store_from_float(out + node * HF + f, acc);
  }
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

// threads along HF (a power of two up to 256: GAT's output layer, HF=4,
// takes 4 lanes a row); the rest of the block takes more rows, as many as
// the shared-memory budget allows (`per_row` bytes each)
dim3 row_block(int HF, size_t per_row) {
  int bx = 1;
  while (bx < HF && bx < kThreads) bx *= 2;
  int by = kThreads / bx;
  const int fit = (int)(kSmemBudget / per_row);
  if (by > fit) by = fit > 0 ? fit : 1;
  return dim3(bx, by);
}

template <typename T>
int launch_wsum(const void* values, const void* weights, const void* nbr,
                const void* mask, const void* rslot, void* out, int B, int N,
                int D, int H, int F, int reverse, void* stream) {
  const int rc = check_dims(B, N, D, H, F);
  if (rc != (int)cudaSuccess) return rc;
  if (reverse && rslot == nullptr) return (int)cudaErrorInvalidValue;
  if (B == 0 || N == 0) return (int)cudaSuccess;
  const size_t per_row = (size_t)D * (1 + H) * sizeof(float);
  const dim3 block = row_block(H * F, per_row);
  const dim3 grid((N + block.y - 1) / block.y, B);
  const size_t smem = block.y * per_row;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const T* v = static_cast<const T*>(values);
  const float* w = static_cast<const float*>(weights);
  const int32_t* n = static_cast<const int32_t*>(nbr);
  const float* m = static_cast<const float*>(mask);
  const int32_t* rs = static_cast<const int32_t*>(rslot);
  T* o = static_cast<T*>(out);
  if (reverse)
    wsum_kernel<T, true><<<grid, block, smem, s>>>(v, w, n, m, rs, o, N, D, H, F);
  else
    wsum_kernel<T, false><<<grid, block, smem, s>>>(v, w, n, m, rs, o, N, D, H, F);
  return (int)cudaGetLastError();
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
