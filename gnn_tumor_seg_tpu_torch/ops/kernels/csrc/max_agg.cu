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
// Forward traffic is h read once (for a full-size brain's node bucket, 12288
// x 256 x 4 B = 12.6 MB, which fits the 50 MB L2, so the D-fold re-reads of
// neighbour rows mostly hit L2), plus nbr and mask (N x D x 4 B each), plus
// out (N x F) and, when it is stored, arg (N x F bytes). Backward reads gout
// and arg once (B x N x F x (4 + 1) B), nbr, mask and rslot (3 x N x D x 4 B)
// and writes grad. In practice the backward is bound by how many loads are in
// flight: each real slot needs a load of arg and then, where arg names the
// slot, a load of gout that depends on it, and the D-fold re-reads of arg
// come from L2.
//
// Forward design (first, simple version): one block per (batch, tile of
// destination rows); threads run along F so each neighbour row is read with
// coalesced loads; the block stages its rows' neighbour indices (padded
// slots as -1) in shared memory once, so the inner loop over D reads only h.
// The running max and slot stay in registers. Tails of N and F are masked.
// The serve path discards `arg`, so a template flag drops its store there.
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
constexpr int kThreadsPerBlock = 256;

__device__ __forceinline__ float load_as_float(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_as_float(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}
__device__ __forceinline__ void store_from_float(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_from_float(__nv_bfloat16* p, float v) {
  // round to nearest even; exact for the forward, whose v is 0 or read from bf16
  *p = __float2bfloat16(v);
}

template <typename T, bool kStoreArg>
__global__ void max_agg_kernel(const T* __restrict__ h,
                               const int32_t* __restrict__ nbr,
                               const float* __restrict__ mask,
                               T* __restrict__ out, uint8_t* __restrict__ arg,
                               int N, int D, int F) {
  extern __shared__ int32_t slots[];  // [blockDim.y, D]: source row or -1
  const int b = blockIdx.y;
  const int row0 = blockIdx.x * blockDim.y;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int n_threads = blockDim.x * blockDim.y;
  for (int i = tid; i < blockDim.y * D; i += n_threads) {
    const int r = row0 + i / D;
    int32_t s = -1;
    if (r < N) {
      const int64_t off = ((int64_t)b * N + r) * D + i % D;
      if (mask[off] > 0.f) s = nbr[off];
    }
    slots[i] = s;
  }
  __syncthreads();

  const int r = row0 + threadIdx.y;
  if (r >= N) return;
  const int32_t* row_slots = slots + threadIdx.y * D;
  const T* hb = h + (int64_t)b * N * F;
  const int64_t o = ((int64_t)b * N + r) * F;
  for (int f = threadIdx.x; f < F; f += blockDim.x) {
    float best = kNegLarge;
    int win = 0;
    bool any = false;
    for (int d = 0; d < D; ++d) {
      const int32_t u = row_slots[d];
      if (u < 0) continue;
      any = true;
      const float v = load_as_float(hb + (int64_t)u * F + f);
      if (v > best) {
        best = v;
        win = d;
      }
    }
    store_from_float(out + o + f, any ? best : 0.f);
    if (kStoreArg) arg[o + f] = (uint8_t)win;
  }
}

// ---- backward ----

constexpr int kBwdThreads = 256;
// rows x D slots staged a block, as int2: 48 000 bytes, under the 48 KB a
// block gets without opting in (D=128 leaves 46 rows)
constexpr int kMaxStaged = 6000;

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

// threads along F: a warp per row at F <= 32 (F=20 on the first GSpool
// layer), up to 128 lanes at wide F; the rest of the block takes more rows
dim3 block_for(int F) {
  const int bx = F >= 128 ? 128 : ((F + 31) / 32) * 32;
  return dim3(bx, kThreadsPerBlock / bx);
}

template <typename T>
int launch(const void* h, const void* nbr, const void* mask, void* out,
           void* arg, int B, int N, int D, int F, int store_arg,
           void* stream) {
  if (B <= 0 || N <= 0 || F <= 0) return (int)cudaSuccess;
  if (D <= 0 || D > kMaxDegree) return (int)cudaErrorInvalidValue;
  const dim3 block = block_for(F);
  const dim3 grid((N + block.y - 1) / block.y, B);
  const size_t smem = (size_t)block.y * D * sizeof(int32_t);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (store_arg) {
    max_agg_kernel<T, true><<<grid, block, smem, s>>>(
        static_cast<const T*>(h), static_cast<const int32_t*>(nbr),
        static_cast<const float*>(mask), static_cast<T*>(out),
        static_cast<uint8_t*>(arg), N, D, F);
  } else {
    max_agg_kernel<T, false><<<grid, block, smem, s>>>(
        static_cast<const T*>(h), static_cast<const int32_t*>(nbr),
        static_cast<const float*>(mask), static_cast<T*>(out), nullptr, N, D,
        F);
  }
  return (int)cudaGetLastError();
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
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
