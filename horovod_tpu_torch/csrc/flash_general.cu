// Flash attention for the inputs that the Hopper kernels do not take: the
// general family G1 (forward), G2 (dk, dv) and G3 (dq), for f32, fp16 and
// bf16 at any head size 1 <= D <= 256, on the CUDA cores.
//
// Replaces: the same Pallas kernels as P1, P2 and P3
// (horovod_tpu/ops/flash_attention.py:_fwd_kernel, _fwd_kernel_unrollkv,
// _fwd_kernel_fullunroll; _dkdv_kernel, _dkdv_kernel_grouped; _dq_kernel,
// _dq_kernel_grouped), for what the JAX package runs there and P1-P3
// refuse: f32 (the reference's own f32 tests and models), fp16, and head
// sizes that are not a multiple of 16 in [16, 128] (dim 32 with 4 heads is
// D 8).  ops/_cuda.py:flash_family picks the family from the dtype and D.
//
// What bounds it: every product runs in f32 FFMA on the CUDA cores (no
// tensor cores, so no TF32 rounding of f32 inputs): at the training shape
// in f32 (B 8, H 16, T 2048, D 128, causal) the forward's two products
// are ~137 GFLOP, ~2.0 ms at the card's 67 TFLOP/s FP32 rate, and memory
// is far from the bound.  This first version is simple rather than fast:
// it also spends shared-memory loads and shuffles on every product.
//
// The design, one for all three: a block of 4 warps owns 16 rows of one
// head (query rows for G1 and G3, key rows for G2), 4 per warp, and loops
// over the other side in tiles of 32 rows staged in shared memory as f32
// (rows past T read as 0; row stride D rounded up to odd, so that the 32
// lanes reading 32 different rows hit 32 banks).  In each tile lane j
// takes row j of the tile and forms its scores against the warp's 4 rows
// (s = q.k and, in the backward, dp = dO.v); softmax sums and maxima are
// warp reductions; then the lanes split the D columns (lane + 32 i) and
// add p.v, ds.k or p.dO and ds.q, taking the 32 factors of the tile by
// shuffles.  Sums run in a fixed order and without atomics: every result
// is deterministic, G3 included.
//
// Numerics follow the plain versions (ops/flash_attention.py), cast
// points included: s = (q.k) * scale; the forward is an online softmax
// that starts at _NEG_BIG and rounds p to the input dtype before p.v, with
// o = acc / max(l, 1e-30) and lse = m + log(max(l, 1e-30)); the backward
// forms p = exp(s - lse) (masked entries 0), ds = p (dp - delta) scale,
// and rounds p and ds to the input dtype before dv += p^T dO,
// dk += ds^T q and dq += ds k.  exp and log are the accurate expf/logf.

#include <cuda_fp16.h>

#include "flash_common.cuh"

namespace htt {

constexpr int kGenRows = 16;    // rows a block owns, 4 per warp
constexpr int kGenTile = 32;    // rows of the other side per tile
constexpr int kGenThreads = 128;
constexpr int kGenMaxD = 256;
constexpr int kGenCols = kGenMaxD / 32;  // columns a lane holds, at most

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

template <typename E>
__device__ __forceinline__ E from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to E and back: a cast point of the plain versions.
template <typename E>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<E>(x));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename E>
struct GenView {
  const E* ptr;  // head h of batch b at ptr + b * sb + h * D
  long long sb, st;
};

template <typename E>
struct GenOut {
  E* ptr;
  long long sb, st;
};

template <typename E>
struct GenParams {
  GenView<E> q, k, v, dout;
  GenOut<E> o, dq, dk, dv;
  float* lse;            // (B, H, T): written by G1, read by G2, G3
  const float* delta;    // (B, H, T)
  int H, T, D, lim, causal;
  float scale;
};

// Shared-memory row stride of a staged tile: D rounded up to odd.
__host__ __device__ inline int gen_ld(int D) { return D | 1; }

// Dynamic shared memory of G1 (kernel 0), G2 (1) or G3 (2) at head size D.
inline int gen_smem_bytes(int kernel, int D) {
  const int ld = gen_ld(D);
  if (kernel == 0) return (kGenRows + 2 * kGenTile) * ld * 4;
  return 2 * (kGenRows + kGenTile) * ld * 4 +
         (kernel == 1 ? 2 * kGenTile * 4 : 0);
}

// Rows row0..row0+n-1 of one head into shared memory as f32, stride ld;
// rows at or past T become 0.
template <typename E>
__device__ __forceinline__ void stage(float* s, int ld, const E* g,
                                      long long st, int row0, int n, int T_,
                                      int D) {
  for (int i = threadIdx.x; i < n * D; i += kGenThreads) {
    const int r = i / D, col = i - r * D;
    s[r * ld + col] =
        row0 + r < T_ ? to_f32(g[(long long)(row0 + r) * st + col]) : 0.f;
  }
}

// Row `row` of a staged tile dotted with each of the 4 rows at `own`.
__device__ __forceinline__ void dot4(float (&acc)[4], const float* own,
                                     const float* row, int ld, int D) {
#pragma unroll
  for (int r = 0; r < 4; ++r) acc[r] = 0.f;
  for (int d = 0; d < D; ++d) {
    const float x = row[d];
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[r] = fmaf(own[r * ld + d], x, acc[r]);
  }
}

// acc[r][i] += sum over the tile's rows j of f[r] of lane j times
// tile[j][lane + 32 i].
__device__ __forceinline__ void add_rows(float (&acc)[4][kGenCols],
                                         const float (&f)[4],
                                         const float* tile, int ld, int D,
                                         int lane) {
  for (int j = 0; j < kGenTile; ++j) {
    float fj[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) fj[r] = __shfl_sync(0xffffffffu, f[r], j);
#pragma unroll
    for (int i = 0; i < kGenCols; ++i) {
      const int col = lane + 32 * i;
      if (col < D) {
        const float x = tile[j * ld + col];
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[r][i] = fmaf(fj[r], x, acc[r][i]);
      }
    }
  }
}

// The 4 rows of a warp as E, columns lane + 32 i; rows at or past T are
// dropped.
template <typename E>
__device__ __forceinline__ void store_rows(const GenOut<E>& out, int b,
                                           int h, int row0, int T_, int D,
                                           const float (&acc)[4][kGenCols],
                                           const float (&div)[4], int lane) {
  E* g = out.ptr + b * out.sb + (long long)h * D;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    if (row0 + r >= T_) continue;
#pragma unroll
    for (int i = 0; i < kGenCols; ++i) {
      const int col = lane + 32 * i;
      if (col < D)
        g[(long long)(row0 + r) * out.st + col] =
            from_f32<E>(acc[r][i] / div[r]);
    }
  }
}

// G1: o and lse for 16 query rows.
template <typename E>
__global__ void __launch_bounds__(kGenThreads)
    flash_fwd_general_kernel(const GenParams<E> p) {
  extern __shared__ float gsm[];
  const int D = p.D, ld = gen_ld(D);
  float* sQ = gsm;
  float* sK = sQ + kGenRows * ld;
  float* sV = sK + kGenTile * ld;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kGenRows;  // heaviest first
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int row0 = q0 + 4 * warp;
  const long long hD = (long long)h * D;
  stage(sQ, ld, p.q.ptr + b * p.q.sb + hD, p.q.st, q0, kGenRows, p.T, D);

  float m[4], l[4], o[4][kGenCols];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = kNegBig;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < kGenCols; ++i) o[r][i] = 0.f;
  }
  int n_kv = q0 < p.lim ? (p.lim + kGenTile - 1) / kGenTile : 0;
  if (p.causal) n_kv = min(n_kv, (q0 + kGenRows - 1) / kGenTile + 1);
  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * kGenTile;
    __syncthreads();  // every warp is done with the previous tile
    stage(sK, ld, p.k.ptr + b * p.k.sb + hD, p.k.st, k0, kGenTile, p.T, D);
    stage(sV, ld, p.v.ptr + b * p.v.sb + hD, p.v.st, k0, kGenTile, p.T, D);
    __syncthreads();
    float s[4], pr[4];
    dot4(s, sQ + 4 * warp * ld, sK + lane * ld, ld, D);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const bool vis = visible(row0 + r, k0 + lane, p.causal, p.lim);
      const float sv = s[r] * p.scale;
      const float mx = warp_max(vis ? sv : __int_as_float(0xff800000));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_new);
      const float pe = vis ? expf(sv - m_new) : 0.f;
      l[r] = l[r] * alpha + warp_sum(pe);
      m[r] = m_new;
      pr[r] = round_to<E>(pe);
#pragma unroll
      for (int i = 0; i < kGenCols; ++i) o[r][i] *= alpha;
    }
    add_rows(o, pr, sV, ld, D, lane);
  }

  float lsafe[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) lsafe[r] = fmaxf(l[r], 1e-30f);
  store_rows(p.o, b, h, row0, p.T, D, o, lsafe, lane);
  if (lane < 4 && row0 + lane < p.T) {
    float mr = m[0], lr = lsafe[0];
#pragma unroll
    for (int r = 1; r < 4; ++r)
      if (lane == r) mr = m[r], lr = lsafe[r];
    p.lse[((long long)b * p.H + h) * p.T + row0 + lane] = mr + logf(lr);
  }
}

// G3: dq for 16 query rows.
template <typename E>
__global__ void __launch_bounds__(kGenThreads)
    flash_bwd_dq_general_kernel(const GenParams<E> p) {
  extern __shared__ float gsm[];
  const int D = p.D, ld = gen_ld(D);
  float* sQ = gsm;
  float* sO = sQ + kGenRows * ld;
  float* sK = sO + kGenRows * ld;
  float* sV = sK + kGenTile * ld;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kGenRows;
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int row0 = q0 + 4 * warp;
  const long long hD = (long long)h * D;
  const long long bh = (long long)b * p.H + h;
  stage(sQ, ld, p.q.ptr + b * p.q.sb + hD, p.q.st, q0, kGenRows, p.T, D);
  stage(sO, ld, p.dout.ptr + b * p.dout.sb + hD, p.dout.st, q0, kGenRows,
        p.T, D);
  float lse[4], delta[4], dq[4][kGenCols];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const bool in = row0 + r < p.T;
    lse[r] = in ? p.lse[bh * p.T + row0 + r] : 0.f;
    delta[r] = in ? p.delta[bh * p.T + row0 + r] : 0.f;
#pragma unroll
    for (int i = 0; i < kGenCols; ++i) dq[r][i] = 0.f;
  }
  int n_kv = q0 < p.lim ? (p.lim + kGenTile - 1) / kGenTile : 0;
  if (p.causal) n_kv = min(n_kv, (q0 + kGenRows - 1) / kGenTile + 1);
  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * kGenTile;
    __syncthreads();
    stage(sK, ld, p.k.ptr + b * p.k.sb + hD, p.k.st, k0, kGenTile, p.T, D);
    stage(sV, ld, p.v.ptr + b * p.v.sb + hD, p.v.st, k0, kGenTile, p.T, D);
    __syncthreads();
    float s[4], dp[4], ds[4];
    dot4(s, sQ + 4 * warp * ld, sK + lane * ld, ld, D);
    dot4(dp, sO + 4 * warp * ld, sV + lane * ld, ld, D);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const bool vis = visible(row0 + r, k0 + lane, p.causal, p.lim);
      const float pe = vis ? expf(s[r] * p.scale - lse[r]) : 0.f;
      ds[r] = round_to<E>(pe * (dp[r] - delta[r]) * p.scale);
    }
    add_rows(dq, ds, sK, ld, D, lane);
  }
  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  store_rows(p.dq, b, h, row0, p.T, D, dq, one, lane);
}

// G2: dk and dv for 16 key rows.
template <typename E>
__global__ void __launch_bounds__(kGenThreads)
    flash_bwd_dkdv_general_kernel(const GenParams<E> p) {
  extern __shared__ float gsm[];
  const int D = p.D, ld = gen_ld(D);
  float* sK = gsm;
  float* sV = sK + kGenRows * ld;
  float* sQ = sV + kGenRows * ld;
  float* sO = sQ + kGenTile * ld;
  float* sL = sO + kGenTile * ld;
  float* sD = sL + kGenTile;
  const int k0 = blockIdx.x * kGenRows;  // low keys have the most work
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x & 31;
  const int key0 = k0 + 4 * warp;
  const long long hD = (long long)h * D;
  const long long bh = (long long)b * p.H + h;
  stage(sK, ld, p.k.ptr + b * p.k.sb + hD, p.k.st, k0, kGenRows, p.T, D);
  stage(sV, ld, p.v.ptr + b * p.v.sb + hD, p.v.st, k0, kGenRows, p.T, D);
  float dk[4][kGenCols], dv[4][kGenCols];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int i = 0; i < kGenCols; ++i) dk[r][i] = dv[r][i] = 0.f;
  const int i_begin = p.causal ? k0 / kGenTile : 0;
  const int i_end = k0 < p.lim ? (p.lim + kGenTile - 1) / kGenTile : 0;
  for (int it = i_begin; it < i_end; ++it) {
    const int q0 = it * kGenTile;
    __syncthreads();
    stage(sQ, ld, p.q.ptr + b * p.q.sb + hD, p.q.st, q0, kGenTile, p.T, D);
    stage(sO, ld, p.dout.ptr + b * p.dout.sb + hD, p.dout.st, q0, kGenTile,
          p.T, D);
    const int i = threadIdx.x;
    if (i < kGenTile) {
      const bool in = q0 + i < p.T;
      sL[i] = in ? p.lse[bh * p.T + q0 + i] : 0.f;
      sD[i] = in ? p.delta[bh * p.T + q0 + i] : 0.f;
    }
    __syncthreads();
    float s[4], dp[4], pr[4], ds[4];
    dot4(s, sK + 4 * warp * ld, sQ + lane * ld, ld, D);
    dot4(dp, sV + 4 * warp * ld, sO + lane * ld, ld, D);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const bool vis = visible(q0 + lane, key0 + r, p.causal, p.lim);
      const float pe = vis ? expf(s[r] * p.scale - sL[lane]) : 0.f;
      pr[r] = round_to<E>(pe);
      ds[r] = round_to<E>(pe * (dp[r] - sD[lane]) * p.scale);
    }
    add_rows(dv, pr, sO, ld, D, lane);
    add_rows(dk, ds, sQ, ld, D, lane);
  }
  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  store_rows(p.dk, b, h, key0, p.T, D, dk, one, lane);
  store_rows(p.dv, b, h, key0, p.T, D, dv, one, lane);
}

template <typename E>
cudaError_t launch_general(int kernel, const GenParams<E>& p, int B,
                           int smem, cudaStream_t stream) {
  void (*fn)(const GenParams<E>) =
      kernel == 0 ? flash_fwd_general_kernel<E>
      : kernel == 1 ? flash_bwd_dkdv_general_kernel<E>
                    : flash_bwd_dq_general_kernel<E>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.T + kGenRows - 1) / kGenRows, p.H, B);
  fn<<<grid, kGenThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename E>
GenParams<E> gen_params(const void* const* ptrs, const long long* strides,
                        const void* lse, const void* delta, int H, int T,
                        int D, int seq_len, int causal, float scale) {
  GenParams<E> p{};
  GenView<E>* in[4] = {&p.q, &p.k, &p.v, &p.dout};
  GenOut<E>* out[4] = {&p.o, &p.dq, &p.dk, &p.dv};
  for (int i = 0; i < 4; ++i)
    *in[i] = GenView<E>{static_cast<const E*>(ptrs[i]), strides[2 * i],
                        strides[2 * i + 1]};
  for (int i = 0; i < 4; ++i)
    *out[i] = GenOut<E>{static_cast<E*>(const_cast<void*>(ptrs[4 + i])),
                        strides[8 + 2 * i], strides[9 + 2 * i]};
  p.lse = static_cast<float*>(const_cast<void*>(lse));
  p.delta = static_cast<const float*>(delta);
  p.H = H;
  p.T = T;
  p.D = D;
  p.lim = seq_len;
  p.causal = causal;
  p.scale = scale;
  return p;
}

// ptrs: q, k, v, dout, o, dq, dk, dv (null where a kernel has none);
// strides: (batch, row) of each, in the same order, in elements; dtype:
// 0 f32, 1 fp16, 2 bf16.
inline int run_general(int kernel, int dtype, const void* const* ptrs,
                       const long long* strides, const void* lse,
                       const void* delta, int B, int H, int T, int D,
                       int seq_len, int causal, float scale, int smem_bytes,
                       void* stream) {
  if (D < 1 || D > kGenMaxD || smem_bytes != gen_smem_bytes(kernel, D))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_general(kernel, gen_params<float>(
          ptrs, strides, lse, delta, H, T, D, seq_len, causal, scale),
          B, smem_bytes, s);
    case 1:
      return launch_general(kernel, gen_params<__half>(
          ptrs, strides, lse, delta, H, T, D, seq_len, causal, scale),
          B, smem_bytes, s);
    case 2:
      return launch_general(kernel, gen_params<bf16>(
          ptrs, strides, lse, delta, H, T, D, seq_len, causal, scale),
          B, smem_bytes, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace htt

// G1.  q, k, v: (B, T, H*D) views of dtype `dtype` (0 f32, 1 fp16, 2 bf16)
// with unit column stride; o: the same; lse: (B, H, T) f32.  smem_bytes is
// the plan of horovod_tpu_torch/ops/_cuda.py:general_plan, checked here.
// Returns the CUDA error code of the launch.
extern "C" int htt_flash_fwd_general(
    int dtype, const void* q, long long q_sb, long long q_st, const void* k,
    long long k_sb, long long k_st, const void* v, long long v_sb,
    long long v_st, void* o, long long o_sb, long long o_st, void* lse,
    int B, int H, int T, int D, int seq_len, int causal, float scale,
    int smem_bytes, void* stream) {
  const void* ptrs[8] = {q, k, v, nullptr, o, nullptr, nullptr, nullptr};
  const long long strides[16] = {q_sb, q_st, k_sb, k_st, v_sb, v_st, 0, 0,
                                 o_sb, o_st, 0, 0, 0, 0, 0, 0};
  return htt::run_general(0, dtype, ptrs, strides, lse, nullptr, B, H, T, D,
                          seq_len, causal, scale, smem_bytes, stream);
}

// G2.  Inputs as G1 plus dout and lse, delta (B, H, T) f32; dk, dv:
// (B, T, H*D) views of the same dtype, written in full.
extern "C" int htt_flash_bwd_dkdv_general(
    int dtype, const void* q, long long q_sb, long long q_st, const void* k,
    long long k_sb, long long k_st, const void* v, long long v_sb,
    long long v_st, const void* dout, long long do_sb, long long do_st,
    const void* lse, const void* delta, void* dk, long long dk_sb,
    long long dk_st, void* dv, long long dv_sb, long long dv_st, int B,
    int H, int T, int D, int seq_len, int causal, float scale,
    int smem_bytes, void* stream) {
  const void* ptrs[8] = {q, k, v, dout, nullptr, nullptr, dk, dv};
  const long long strides[16] = {q_sb, q_st, k_sb, k_st, v_sb, v_st,
                                 do_sb, do_st, 0, 0, 0, 0, dk_sb, dk_st,
                                 dv_sb, dv_st};
  return htt::run_general(1, dtype, ptrs, strides, lse, delta, B, H, T, D,
                          seq_len, causal, scale, smem_bytes, stream);
}

// G3.  Inputs as G2; dq: a (B, T, H*D) view of the same dtype.
extern "C" int htt_flash_bwd_dq_general(
    int dtype, const void* q, long long q_sb, long long q_st, const void* k,
    long long k_sb, long long k_st, const void* v, long long v_sb,
    long long v_st, const void* dout, long long do_sb, long long do_st,
    const void* lse, const void* delta, void* dq, long long dq_sb,
    long long dq_st, int B, int H, int T, int D, int seq_len, int causal,
    float scale, int smem_bytes, void* stream) {
  const void* ptrs[8] = {q, k, v, dout, nullptr, dq, nullptr, nullptr};
  const long long strides[16] = {q_sb, q_st, k_sb, k_st, v_sb, v_st,
                                 do_sb, do_st, 0, 0, dq_sb, dq_st, 0, 0,
                                 0, 0};
  return htt::run_general(2, dtype, ptrs, strides, lse, delta, B, H, T, D,
                          seq_len, causal, scale, smem_bytes, stream);
}
