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
// Design (first, simple version): the TPU kernels' unique-row compaction and
// one-hot MXU contractions (fused_gat.py:70-80, 115-126) work around slow
// row gathers on the TPU; here every kernel reads nbr directly. Forward and
// reverse combine give a block a tile of destination rows: the block stages
// the rows' slots (padded slots as -1) and their per-slot, per-head scalars
// (logits then alpha; or the reverse alpha and d_pre) in shared memory,
// one thread per (row, head) runs the softmax or the d_el sum in slot
// order, and then the threads run along HF, each accumulating its feature
// over the slots in a register, with the epilogue fused. The backward gives
// a group of G lanes (a power of two from 4 to 32: 32 at F >= 32, 4 at the
// output layer's F=4) one (row, head): the lanes stride over F for each slot's dot
// and reduce with xor shuffles inside the group, keep d_alpha in shared
// memory, and then split the slots for the softmax backward. Left for later:
// vector loads, more rows per block at wide HF, cp.async or TMA staging.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegLarge = -1e30f;
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

template <typename T>
__global__ void gat_rev_kernel(const T* __restrict__ gout,
                               const float* __restrict__ alpha,
                               const float* __restrict__ d_pre,
                               const int32_t* __restrict__ nbr,
                               const float* __restrict__ mask,
                               const int32_t* __restrict__ rslot,
                               T* __restrict__ d_z, float* __restrict__ d_el,
                               int N, int D, int H, int F) {
  extern __shared__ float smem[];
  const int R = blockDim.y;
  int32_t* slots = reinterpret_cast<int32_t*>(smem);        // [R, D] source or -1
  int32_t* rslots = slots + R * D;                           // [R, D]
  float* arev = smem + 2 * R * D;                            // [R, D, H]
  float* prev = arev + R * D * H;                            // [R, D, H]
  const int b = blockIdx.y;
  const int row0 = blockIdx.x * R;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nt = blockDim.x * blockDim.y;
  const int HF = H * F;
  const int DH = D * H;

  for (int i = tid; i < R * D; i += nt) {
    const int r = row0 + i / D;
    int32_t s = -1, j = 0;
    if (r < N) {
      const int64_t off = ((int64_t)b * N + r) * D + i % D;
      if (mask[off] > 0.f) {
        s = nbr[off];
        j = rslot[off];
      }
    }
    slots[i] = s;
    rslots[i] = j;
  }
  __syncthreads();

  // alpha and d_pre of the reverse edge, from the neighbour's own row
  for (int i = tid; i < R * DH; i += nt) {
    const int rl = i / DH;
    const int d = (i / H) % D;
    const int h = i % H;
    const int32_t s = slots[rl * D + d];
    float a = 0.f, p = 0.f;
    if (s >= 0) {
      const int64_t src = (((int64_t)b * N + s) * D + rslots[rl * D + d]) * H + h;
      a = alpha[src];
      p = d_pre[src];
    }
    arev[i] = a;
    prev[i] = p;
  }
  __syncthreads();

  for (int i = tid; i < R * H; i += nt) {
    const int rl = i / H;
    const int h = i % H;
    const int r = row0 + rl;
    if (r >= N) continue;
    float acc = 0.f;
    for (int d = 0; d < D; ++d)
      if (slots[rl * D + d] >= 0) acc = __fadd_rn(acc, prev[rl * DH + d * H + h]);
    d_el[((int64_t)b * N + r) * H + h] = acc;
  }

  const int rl = threadIdx.y;
  const int r = row0 + rl;
  if (r >= N) return;
  const int64_t node = (int64_t)b * N + r;
  const int32_t* rs = slots + rl * D;
  const float* ar = arev + rl * DH;
  const T* gb = gout + (int64_t)b * N * HF;
  for (int f = threadIdx.x; f < HF; f += blockDim.x) {
    const int h = f / F;
    float acc = 0.f;
    for (int d = 0; d < D; ++d) {
      const int32_t s = rs[d];
      if (s < 0) continue;
      acc = __fadd_rn(acc, __fmul_rn(ar[d * H + h],
                                     load_as_float(gb + (int64_t)s * HF + f)));
    }
    store_from_float(d_z + node * HF + f, acc);
  }
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

template <typename T>
int launch_rev(const void* gout, const void* alpha, const void* d_pre,
               const void* nbr, const void* mask, const void* rslot, void* d_z,
               void* d_el, int B, int N, int D, int H, int F, void* stream) {
  const int rc = check_dims(B, N, D, H, F);
  if (rc != (int)cudaSuccess) return rc;
  if (B <= 0 || N <= 0) return (int)cudaSuccess;
  const size_t per_row = (size_t)D * (2 + 2 * H) * sizeof(float);
  const dim3 block = row_block(H * F, per_row);
  const dim3 grid((N + block.y - 1) / block.y, B);
  gat_rev_kernel<T><<<grid, block, block.y * per_row,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(gout), static_cast<const float*>(alpha),
      static_cast<const float*>(d_pre), static_cast<const int32_t*>(nbr),
      static_cast<const float*>(mask), static_cast<const int32_t*>(rslot),
      static_cast<T*>(d_z), static_cast<float*>(d_el), N, D, H, F);
  return (int)cudaGetLastError();
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
