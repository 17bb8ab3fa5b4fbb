// Flash-attention forward (port kernel P1) for Hopper, sm_90a.
//
// Replaces: horovod_tpu/ops/flash_attention.py:_fwd_kernel (via _fwd and
// _fwd_packed), _fwd_kernel_unrollkv and _fwd_kernel_fullunroll.  All three
// compute the same o and lse; their differences are VMEM and Mosaic
// schedules that have no meaning here.
//
// What bounds it: at the training shape (B 8, H 16, T 2048, D 128, causal)
// the two products q.k^T and p.v are ~137 GFLOP against ~0.27 GB of
// q/k/v/o/lse traffic, so the card's bf16 tensor-core rate is the bound
// (~0.14 ms at 989 TFLOP/s), not its memory (~0.08 ms at 3.35 TB/s).
//
// What the design does about it: one block of 4 warps per (q tile of 64
// rows, head, batch); the q tile stays in shared memory and k/v tiles of
// 64 rows stream through it.  Both products run on the tensor cores with
// mma.sync m16n8k16 (bf16 in, f32 accumulate), and the online-softmax
// state (running max, sum and the 16 x D output accumulator of each warp)
// never leaves registers: the accumulator layout of s is reused as the A
// operand of p.v, so p never touches shared memory.  The loop stops at the
// causal diagonal (the skip _live_block makes), and q tiles are issued
// heaviest first.  Not yet done: wgmma, TMA and a software pipeline of the
// k/v loads, which the tensor-core rate needs to be approached.
//
// Numerics follow _fwd_kernel: s = (q.k^T) * scale in f32, masked entries
// get _NEG_BIG and p = 0, p is rounded to bf16 before p.v, and finally
// o = acc / max(l, 1e-30) and lse = m + log(max(l, 1e-30)).

#include "flash_common.cuh"

namespace htt {

struct FwdParams {
  View q, k, v;
  OutView o;
  float* lse;  // (B, H, T)
  int H, T, lim, causal;
  float scale;
};

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const FwdParams p) {
  constexpr int LD = D + kPad;
  constexpr int NT = D / 8;  // accumulator tiles across D
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + kTile * LD;
  bf16* sV = sK + kTile * LD;

  const int nq = (p.T + kTile - 1) / kTile;
  const int qt = nq - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q0 = qt * kTile;

  const bf16* qg = p.q.ptr + b * p.q.sb + h * D;
  const bf16* kg = p.k.ptr + b * p.k.sb + h * D;
  const bf16* vg = p.v.ptr + b * p.v.sb + h * D;
  load_tile<D>(sQ, qg, p.q.st, q0, p.T);

  const int row[2] = {q0 + warp * 16 + (lane >> 2),
                      q0 + warp * 16 + (lane >> 2) + 8};
  float m[2] = {kNegBig, kNegBig};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums
  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;

  int n_kv = q0 < p.lim ? (p.lim + kTile - 1) / kTile : 0;
  if (p.causal) n_kv = min(n_kv, qt + 1);

  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * kTile;
    __syncthreads();  // every warp is done with the previous k/v tile
    load_tile<D>(sK, kg, p.k.st, k0, p.T);
    load_tile<D>(sV, vg, p.v.st, k0, p.T);
    __syncthreads();

    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      frag_a<LD>(a, sQ, warp * 16, kk * 16, lane);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        uint32_t bb[2];
        frag_b_nk<LD>(bb, sK, nt * 8, kk * 16, lane);
        mma(s[nt], a, bb);
      }
    }

    float bmax[2] = {kNegBig, kNegBig};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + nt * 8 + 2 * (lane & 3) + (e & 1);
        float x = s[nt][e] * p.scale;
        if (!visible(row[e >> 1], col, p.causal, p.lim)) x = kNegBig;
        s[nt][e] = x;
        bmax[e >> 1] = fmaxf(bmax[e >> 1], x);
      }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float m_new = fmaxf(m[i], quad_max(bmax[i]));
      alpha[i] = __expf(m[i] - m_new);
      m[i] = m_new;
      l[i] *= alpha[i];
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + nt * 8 + 2 * (lane & 3) + (e & 1);
        const float pe = visible(row[e >> 1], col, p.causal, p.lim)
                             ? __expf(s[nt][e] - m[e >> 1])
                             : 0.f;
        s[nt][e] = pe;
        l[e >> 1] += pe;
      }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      acc[nt][0] *= alpha[0];
      acc[nt][1] *= alpha[0];
      acc[nt][2] *= alpha[1];
      acc[nt][3] *= alpha[1];
    }
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t a[4];
      acc_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t bb[2];
        frag_b_kn<LD>(bb, sV, kk * 16, nt * 8, lane);
        mma(acc[nt], a, bb);
      }
    }
  }

  float lsafe[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) lsafe[i] = fmaxf(quad_sum(l[i]), 1e-30f);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    acc[nt][0] /= lsafe[0];
    acc[nt][1] /= lsafe[0];
    acc[nt][2] /= lsafe[1];
    acc[nt][3] /= lsafe[1];
  }
  store_rows<D>(p.o.ptr + b * p.o.sb + h * D, p.o.st, q0 + warp * 16, p.T,
                acc, lane);
  if ((lane & 3) == 0) {
    float* lse = p.lse + ((long long)b * p.H + h) * p.T;
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (row[i] < p.T) lse[row[i]] = m[i] + logf(lsafe[i]);
  }
}

struct FwdLaunch {
  FwdParams p;
  int B;
  cudaStream_t stream;
  template <int D>
  cudaError_t operator()() const {
    const int smem = 3 * kTile * (D + kPad) * (int)sizeof(bf16);
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((p.T + kTile - 1) / kTile, p.H, B);
    flash_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(p);
    return cudaGetLastError();
  }
};

}  // namespace htt

// q, k, v: (B, T, H*D) bf16 views; o: (B, T, H*D) bf16; lse: (B, H, T) f32.
// seq_len <= T is the real length (T when none is given).  Returns the
// CUDA error code of the launch (0 on success).
extern "C" int htt_flash_fwd(const void* q, long long q_sb, long long q_st,
                             const void* k, long long k_sb, long long k_st,
                             const void* v, long long v_sb, long long v_st,
                             void* o, long long o_sb, long long o_st,
                             void* lse, int B, int H, int T, int D,
                             int seq_len, int causal, float scale,
                             void* stream) {
  using namespace htt;
  FwdLaunch launch;
  launch.p.q = View{static_cast<const bf16*>(q), q_sb, q_st};
  launch.p.k = View{static_cast<const bf16*>(k), k_sb, k_st};
  launch.p.v = View{static_cast<const bf16*>(v), v_sb, v_st};
  launch.p.o = OutView{static_cast<bf16*>(o), o_sb, o_st};
  launch.p.lse = static_cast<float*>(lse);
  launch.p.H = H;
  launch.p.T = T;
  launch.p.lim = seq_len;
  launch.p.causal = causal;
  launch.p.scale = scale;
  launch.B = B;
  launch.stream = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch_d(D, launch));
}
