// Flash attention at head sizes above 256: the wide route of the general
// family, W1 (forward), W2 (dk, dv) and W3 (dq), for f32, fp16 and bf16 at
// any head size that shared memory holds (ops/_cuda.py:WIDE_MAX_D).
//
// Replaces: the same Pallas kernels as G1-G3
// (horovod_tpu/ops/flash_attention.py): W1 _fwd_kernel, _fwd_kernel_unrollkv
// and _fwd_kernel_fullunroll; W2 _dkdv_kernel and _dkdv_kernel_grouped; W3
// _dq_kernel and _dq_kernel_grouped, for the head sizes G1-G3 cannot stage
// (G3 already needs 200,704 of 227 KiB of shared memory at D 256 in f32).
// The JAX package has no bound on D; ops/_cuda.py:flash_family sends
// D > 256 here.
//
// A simple design that is right first; making it fast is later work.  A
// block of 4 warps owns ONE row of one head: a query row (W1, W3) or a key
// row (W2).  The row's own operands (W1: q; W3: q and dO; W2: k and v) and
// its f32 accumulators (o; dq; dk and dv) live in shared memory as D
// floats each, so D is bounded by shared memory alone (W2: 16 D bytes).
// The other side streams from global memory 32 rows a tile: each warp
// takes every fourth row of the tile and forms its dot products over D
// in FFMA, lanes striding the columns (coalesced), reduced by a butterfly
// of shuffles; then every thread updates the accumulator columns it owns
// (c = thread, thread + 128, ...) with the tile's rows, in row order.
//
// Every sum runs in a fixed order without atomics: every result is
// deterministic.  Numerics follow the plain versions
// (ops/flash_attention.py) and G1-G3, cast points included:
// s = (q.k) * scale; the forward is an online softmax that starts at
// _NEG_BIG, adds each tile's p.v from 0 into o in f32 and rounds p to the
// input dtype before p.v, with o = acc / max(l, 1e-30) and
// lse = m + log(max(l, 1e-30)); the backward forms p = exp(s - lse),
// ds = p (dp - delta) scale, and rounds p and ds to the input dtype before
// dv += p^T dO, dk += ds^T q and dq += ds k.  Rows at or past seq_len see
// no key (o = 0), keys at or past it are never read.

#include <cuda_fp16.h>

#include "flash_common.cuh"

namespace htt {

constexpr int kWideThreads = 128;
constexpr int kWideWarps = kWideThreads / 32;
constexpr int kWideTile = 32;  // rows of the other side a step

__device__ __forceinline__ float wide_f32(float x) { return x; }
__device__ __forceinline__ float wide_f32(__half x) {
  return __half2float(x);
}
__device__ __forceinline__ float wide_f32(bf16 x) {
  return __bfloat162float(x);
}

template <typename E>
__device__ __forceinline__ E wide_from(float x);
template <>
__device__ __forceinline__ float wide_from<float>(float x) { return x; }
template <>
__device__ __forceinline__ __half wide_from<__half>(float x) {
  return __float2half_rn(x);
}
template <>
__device__ __forceinline__ bf16 wide_from<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to the input dtype, as the plain versions cast p and ds.
template <typename E>
__device__ __forceinline__ float wide_round(float x) {
  return wide_f32(wide_from<E>(x));
}

template <typename E>
struct WideParams {
  const E* in[4];  // q, k, v, dout
  long long in_sb[4], in_st[4];
  E* out[2];  // W1: o; W2: dk, dv; W3: dq
  long long out_sb[2], out_st[2];
  float* lse;  // W1 writes it, W2 and W3 read it
  const float* delta;
  int H, T, D, lim, causal;
  float scale;
};

template <typename E>
__device__ __forceinline__ const E* wide_row(const WideParams<E>& p, int op,
                                             int b, int t, int h) {
  return p.in[op] + b * p.in_sb[op] + t * p.in_st[op] +
         static_cast<long long>(h) * p.D;
}

template <typename E>
__device__ __forceinline__ E* wide_out_row(const WideParams<E>& p, int op,
                                           int b, int t, int h) {
  return p.out[op] + b * p.out_sb[op] + t * p.out_st[op] +
         static_cast<long long>(h) * p.D;
}

// sum over c < D of a[c] * x[c], a in shared memory, x a row in global
// memory; every lane of the warp gets the same bits.
template <typename E>
__device__ __forceinline__ float warp_dot(const float* a, const E* x, int D,
                                          int lane) {
  float acc = 0.f;
  for (int c = lane; c < D; c += 32) acc = fmaf(a[c], wide_f32(x[c]), acc);
  for (int off = 16; off; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  return acc;
}

template <typename E>
__device__ __forceinline__ void load_row(float* dst, const E* src, int D) {
  for (int c = threadIdx.x; c < D; c += kWideThreads)
    dst[c] = wide_f32(src[c]);
}

__device__ __forceinline__ void zero_row(float* dst, int D) {
  for (int c = threadIdx.x; c < D; c += kWideThreads) dst[c] = 0.f;
}

// Keys a query row sees: none past seq_len, up to the row under
// causality.
__device__ __forceinline__ int visible_keys(int i, int lim, int causal) {
  return i < lim ? (causal ? i + 1 : lim) : 0;
}

// W1: o and lse of query row blockIdx.x.
template <typename E>
__global__ void __launch_bounds__(kWideThreads)
    flash_fwd_wide_kernel(const WideParams<E> p) {
  extern __shared__ float wide_smem[];
  float* sq = wide_smem;    // D: the query row
  float* so = sq + p.D;     // D: the output accumulator
  __shared__ float ss[kWideTile], sp[kWideTile];
  const int i = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  load_row(sq, wide_row(p, 0, b, i, h), p.D);
  zero_row(so, p.D);
  __syncthreads();
  const int n = visible_keys(i, p.lim, p.causal);
  float m = kNegBig, l = 0.f;
  for (int j0 = 0; j0 < n; j0 += kWideTile) {
    const int nk = min(kWideTile, n - j0);
    for (int jj = warp; jj < nk; jj += kWideWarps) {
      const float s = warp_dot(sq, wide_row(p, 1, b, j0 + jj, h), p.D,
                               lane) * p.scale;
      if (lane == 0) ss[jj] = s;
    }
    __syncthreads();
    float mt = m;
    for (int jj = 0; jj < nk; ++jj) mt = fmaxf(mt, ss[jj]);
    const float alpha = expf(m - mt);
    if (threadIdx.x < nk) sp[threadIdx.x] = expf(ss[threadIdx.x] - mt);
    __syncthreads();
    float sum = 0.f;
    for (int jj = 0; jj < nk; ++jj) sum += sp[jj];
    for (int c = threadIdx.x; c < p.D; c += kWideThreads) {
      float acc = 0.f;
      for (int jj = 0; jj < nk; ++jj)
        acc = fmaf(wide_round<E>(sp[jj]),
                   wide_f32(wide_row(p, 2, b, j0 + jj, h)[c]), acc);
      so[c] = so[c] * alpha + acc;
    }
    m = mt;
    l = l * alpha + sum;
    __syncthreads();  // every thread is done with ss and sp
  }
  const float la = fmaxf(l, 1e-30f);
  E* orow = wide_out_row(p, 0, b, i, h);
  for (int c = threadIdx.x; c < p.D; c += kWideThreads)
    orow[c] = wide_from<E>(so[c] / la);
  if (threadIdx.x == 0)
    p.lse[(static_cast<long long>(b) * p.H + h) * p.T + i] = m + logf(la);
}

// W3: dq of query row blockIdx.x.
template <typename E>
__global__ void __launch_bounds__(kWideThreads)
    flash_bwd_dq_wide_kernel(const WideParams<E> p) {
  extern __shared__ float wide_smem[];
  float* sq = wide_smem;     // D: the query row
  float* sdo = sq + p.D;     // D: its dO row
  float* sdq = sdo + p.D;    // D: the dq accumulator
  __shared__ float sds[kWideTile];
  const int i = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  load_row(sq, wide_row(p, 0, b, i, h), p.D);
  load_row(sdo, wide_row(p, 3, b, i, h), p.D);
  zero_row(sdq, p.D);
  __syncthreads();
  const long long row = (static_cast<long long>(b) * p.H + h) * p.T + i;
  const float lse = p.lse[row], delta = p.delta[row];
  const int n = visible_keys(i, p.lim, p.causal);
  for (int j0 = 0; j0 < n; j0 += kWideTile) {
    const int nk = min(kWideTile, n - j0);
    for (int jj = warp; jj < nk; jj += kWideWarps) {
      const float s = warp_dot(sq, wide_row(p, 1, b, j0 + jj, h), p.D,
                               lane) * p.scale;
      const float dp = warp_dot(sdo, wide_row(p, 2, b, j0 + jj, h), p.D,
                                lane);
      if (lane == 0)
        sds[jj] = wide_round<E>(expf(s - lse) * (dp - delta) * p.scale);
    }
    __syncthreads();
    for (int c = threadIdx.x; c < p.D; c += kWideThreads) {
      float acc = 0.f;
      for (int jj = 0; jj < nk; ++jj)
        acc = fmaf(sds[jj], wide_f32(wide_row(p, 1, b, j0 + jj, h)[c]),
                   acc);
      sdq[c] += acc;
    }
    __syncthreads();  // every thread is done with sds
  }
  E* dq = wide_out_row(p, 0, b, i, h);
  for (int c = threadIdx.x; c < p.D; c += kWideThreads)
    dq[c] = wide_from<E>(sdq[c]);
}

// W2: dk and dv of key row blockIdx.x.
template <typename E>
__global__ void __launch_bounds__(kWideThreads)
    flash_bwd_dkdv_wide_kernel(const WideParams<E> p) {
  extern __shared__ float wide_smem[];
  float* sk = wide_smem;     // D: the key row
  float* sv = sk + p.D;      // D: its v row
  float* sdk = sv + p.D;     // D: the dk accumulator
  float* sdv = sdk + p.D;    // D: the dv accumulator
  __shared__ float sp[kWideTile], sds[kWideTile];
  const int j = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  load_row(sk, wide_row(p, 1, b, j, h), p.D);
  load_row(sv, wide_row(p, 2, b, j, h), p.D);
  zero_row(sdk, p.D);
  zero_row(sdv, p.D);
  __syncthreads();
  // Queries that see key j: none when j is past seq_len, else those
  // before seq_len, from j on under causality.
  const int first = p.causal ? j : 0;
  const int last = j < p.lim ? p.lim : first;
  const long long rows = (static_cast<long long>(b) * p.H + h) * p.T;
  for (int i0 = first; i0 < last; i0 += kWideTile) {
    const int nq = min(kWideTile, last - i0);
    for (int ii = warp; ii < nq; ii += kWideWarps) {
      const int i = i0 + ii;
      const float s = warp_dot(sk, wide_row(p, 0, b, i, h), p.D, lane) *
                      p.scale;
      const float dp = warp_dot(sv, wide_row(p, 3, b, i, h), p.D, lane);
      if (lane == 0) {
        const float pr = expf(s - p.lse[rows + i]);
        sp[ii] = wide_round<E>(pr);
        sds[ii] = wide_round<E>(pr * (dp - p.delta[rows + i]) * p.scale);
      }
    }
    __syncthreads();
    for (int c = threadIdx.x; c < p.D; c += kWideThreads) {
      float acc_v = 0.f, acc_k = 0.f;
      for (int ii = 0; ii < nq; ++ii) {
        acc_v = fmaf(sp[ii], wide_f32(wide_row(p, 3, b, i0 + ii, h)[c]),
                     acc_v);
        acc_k = fmaf(sds[ii], wide_f32(wide_row(p, 0, b, i0 + ii, h)[c]),
                     acc_k);
      }
      sdv[c] += acc_v;
      sdk[c] += acc_k;
    }
    __syncthreads();  // every thread is done with sp and sds
  }
  E* dk = wide_out_row(p, 0, b, j, h);
  E* dv = wide_out_row(p, 1, b, j, h);
  for (int c = threadIdx.x; c < p.D; c += kWideThreads) {
    dk[c] = wide_from<E>(sdk[c]);
    dv[c] = wide_from<E>(sdv[c]);
  }
}

// Shared memory of kernel 0 (W1), 1 (W2) or 2 (W3) at head size D: the
// block's own rows and accumulators, D floats each.
inline long long wide_smem_bytes(int kernel, int D) {
  const int rows = kernel == 0 ? 2 : kernel == 1 ? 4 : 3;
  return 4LL * rows * D;
}

template <typename E>
cudaError_t launch_wide(int kernel, const void* const* ptrs,
                        const long long* strides, const void* lse,
                        const void* delta, int B, int H, int T, int D,
                        int seq_len, int causal, float scale, int smem,
                        cudaStream_t stream) {
  WideParams<E> p{};
  for (int i = 0; i < 4; ++i) {
    p.in[i] = static_cast<const E*>(ptrs[i]);
    p.in_sb[i] = strides[2 * i];
    p.in_st[i] = strides[2 * i + 1];
  }
  for (int i = 0; i < 2; ++i) {
    p.out[i] = static_cast<E*>(const_cast<void*>(ptrs[4 + i]));
    p.out_sb[i] = strides[8 + 2 * i];
    p.out_st[i] = strides[9 + 2 * i];
  }
  p.lse = static_cast<float*>(const_cast<void*>(lse));
  p.delta = static_cast<const float*>(delta);
  p.H = H;
  p.T = T;
  p.D = D;
  p.lim = seq_len;
  p.causal = causal;
  p.scale = scale;
  void (*fn)(const WideParams<E>) =
      kernel == 0   ? flash_fwd_wide_kernel<E>
      : kernel == 1 ? flash_bwd_dkdv_wide_kernel<E>
                    : flash_bwd_dq_wide_kernel<E>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  fn<<<dim3(T, H, B), kWideThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// ptrs: q, k, v, dout, then the outputs (W1: o; W2: dk, dv; W3: dq), null
// where a kernel has none; strides: (batch, row) of each in the same
// order, in elements; smem_bytes: ops/_cuda.py:wide_smem_bytes, checked
// here.
inline int run_wide(int kernel, int dtype, const void* const* ptrs,
                    const long long* strides, const void* lse,
                    const void* delta, int B, int H, int T, int D,
                    int seq_len, int causal, float scale, int smem_bytes,
                    void* stream) {
  if (dtype < 0 || dtype > 2 || D < 1 || T < 1 ||
      smem_bytes != wide_smem_bytes(kernel, D))
    return cudaErrorInvalidValue;
  if (H > 65535 || B > 65535) return cudaErrorInvalidConfiguration;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_wide<float>(kernel, ptrs, strides, lse, delta, B, H, T,
                                D, seq_len, causal, scale, smem_bytes, s);
    case 1:
      return launch_wide<__half>(kernel, ptrs, strides, lse, delta, B, H, T,
                                 D, seq_len, causal, scale, smem_bytes, s);
    default:
      return launch_wide<bf16>(kernel, ptrs, strides, lse, delta, B, H, T,
                               D, seq_len, causal, scale, smem_bytes, s);
  }
}

}  // namespace htt

// W1.  q, k, v: (B, T, H*D) views of dtype `dtype` (0 f32, 1 fp16, 2 bf16)
// with unit column stride; o: the same; lse: (B, H, T) f32.  smem_bytes is
// horovod_tpu_torch/ops/_cuda.py:wide_smem_bytes, checked here.  Returns
// the CUDA error code of the launch.
extern "C" int htt_flash_fwd_wide(
    int dtype, const void* q, long long q_sb, long long q_st, const void* k,
    long long k_sb, long long k_st, const void* v, long long v_sb,
    long long v_st, void* o, long long o_sb, long long o_st, void* lse,
    int B, int H, int T, int D, int seq_len, int causal, float scale,
    int smem_bytes, void* stream) {
  const void* ptrs[6] = {q, k, v, nullptr, o, nullptr};
  const long long strides[12] = {q_sb, q_st, k_sb, k_st, v_sb, v_st,
                                 0,    0,    o_sb, o_st, 0,    0};
  return htt::run_wide(0, dtype, ptrs, strides, lse, nullptr, B, H, T, D,
                       seq_len, causal, scale, smem_bytes, stream);
}

// W2.  Inputs as W1 plus dout and lse, delta (B, H, T) f32; dk, dv:
// (B, T, H*D) views of the same dtype, written in full.
extern "C" int htt_flash_bwd_dkdv_wide(
    int dtype, const void* q, long long q_sb, long long q_st, const void* k,
    long long k_sb, long long k_st, const void* v, long long v_sb,
    long long v_st, const void* dout, long long do_sb, long long do_st,
    const void* lse, const void* delta, void* dk, long long dk_sb,
    long long dk_st, void* dv, long long dv_sb, long long dv_st, int B,
    int H, int T, int D, int seq_len, int causal, float scale,
    int smem_bytes, void* stream) {
  const void* ptrs[6] = {q, k, v, dout, dk, dv};
  const long long strides[12] = {q_sb,  q_st,  k_sb,  k_st,  v_sb,  v_st,
                                 do_sb, do_st, dk_sb, dk_st, dv_sb, dv_st};
  return htt::run_wide(1, dtype, ptrs, strides, lse, delta, B, H, T, D,
                       seq_len, causal, scale, smem_bytes, stream);
}

// W3.  Inputs as W2; dq: a (B, T, H*D) view of the same dtype.
extern "C" int htt_flash_bwd_dq_wide(
    int dtype, const void* q, long long q_sb, long long q_st, const void* k,
    long long k_sb, long long k_st, const void* v, long long v_sb,
    long long v_st, const void* dout, long long do_sb, long long do_st,
    const void* lse, const void* delta, void* dq, long long dq_sb,
    long long dq_st, int B, int H, int T, int D, int seq_len, int causal,
    float scale, int smem_bytes, void* stream) {
  const void* ptrs[6] = {q, k, v, dout, dq, nullptr};
  const long long strides[12] = {q_sb,  q_st,  k_sb,  k_st, v_sb, v_st,
                                 do_sb, do_st, dq_sb, dq_st, 0,   0};
  return htt::run_wide(2, dtype, ptrs, strides, lse, delta, B, H, T, D,
                       seq_len, causal, scale, smem_bytes, stream);
}
