// Flash-attention backward for Hopper, sm_90a: the dq kernel (port kernel
// P3), the dq half of the FlashAttention-2 split.  The dk/dv half, P2, is
// flash_bwd_dkdv.cu.
//
// Replaces: horovod_tpu/ops/flash_attention.py:_dq_kernel and
// _dq_kernel_grouped, as reached through _bwd_pallas_packed and
// _bwd_pallas_packed_grouped.  The head grouping there widens VMEM rows;
// here one block handles one head and the grouping has no counterpart.
//
// What bounds it: at the training shape (B 8, H 16, T 2048, D 128,
// causal) P3 runs three products per live tile pair (s, dp, dq;
// ~206 GFLOP) against well under 1 GB of traffic, so it is bound by the
// bf16 tensor-core rate (~0.21 ms at 989 TFLOP/s), not by memory.
//
// What the design does about it: one block of 4 warps per (q tile of 64
// rows, head, batch); k/v tiles up to the diagonal stream through shared
// memory while dq stays in registers.  Every product is mma.sync
// m16n8k16 (bf16 in, f32 accumulate); ds goes from the accumulator
// registers of one product straight into the A operand of the next.  No
// atomics, so the result is deterministic.  Not yet done: the wgmma, TMA
// and warp-specialised pipeline that P1 and P2 have (hopper.cuh).
//
// Numerics follow _dq_kernel: p = exp(s*scale - lse) with masked entries
// 0, ds = p * (dO V^T - delta) * scale, dq += bf16(ds) k.  delta =
// rowsum(dO * O) comes in precomputed, as in _bwd_pallas_packed.

#include "flash_common.cuh"

namespace htt {

struct BwdParams {
  View q, k, v, dout;
  const float* lse;    // (B, H, T)
  const float* delta;  // (B, H, T)
  OutView dq;
  int H, T, lim, causal;
  float scale;
};

// P3: dq for one q tile.  Warp w owns query rows q0+16w..q0+16w+15.
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const BwdParams p) {
  constexpr int LD = D + kPad;
  constexpr int NT = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sO = sQ + kTile * LD;  // the dO tile
  bf16* sK = sO + kTile * LD;
  bf16* sV = sK + kTile * LD;

  const int nq = (p.T + kTile - 1) / kTile;
  const int qt = nq - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int q0 = qt * kTile;
  const long long bh = (long long)b * p.H + h;

  const bf16* kg = p.k.ptr + b * p.k.sb + h * D;
  const bf16* vg = p.v.ptr + b * p.v.sb + h * D;
  load_tile<D>(sQ, p.q.ptr + b * p.q.sb + h * D, p.q.st, q0, p.T);
  load_tile<D>(sO, p.dout.ptr + b * p.dout.sb + h * D, p.dout.st, q0, p.T);

  const int row[2] = {q0 + warp * 16 + (lane >> 2),
                      q0 + warp * 16 + (lane >> 2) + 8};
  float lse[2], delta[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lse[i] = row[i] < p.T ? p.lse[bh * p.T + row[i]] : 0.f;
    delta[i] = row[i] < p.T ? p.delta[bh * p.T + row[i]] : 0.f;
  }
  float dq[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
    dq[nt][0] = dq[nt][1] = dq[nt][2] = dq[nt][3] = 0.f;

  int n_kv = q0 < p.lim ? (p.lim + kTile - 1) / kTile : 0;
  if (p.causal) n_kv = min(n_kv, qt + 1);

  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * kTile;
    __syncthreads();  // every warp is done with the previous k/v tile
    load_tile<D>(sK, kg, p.k.st, k0, p.T);
    load_tile<D>(sV, vg, p.v.st, k0, p.T);
    __syncthreads();

    // s = q k^T and dp = dO v^T.
    float s[8][4], dp[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4], ao[4];
      frag_a<LD>(a, sQ, warp * 16, kk * 16, lane);
      frag_a<LD>(ao, sO, warp * 16, kk * 16, lane);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        uint32_t bb[2];
        frag_b_nk<LD>(bb, sK, nt * 8, kk * 16, lane);
        mma(s[nt], a, bb);
        frag_b_nk<LD>(bb, sV, nt * 8, kk * 16, lane);
        mma(dp[nt], ao, bb);
      }
    }
    // ds = p (dp - delta) * scale.
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + nt * 8 + 2 * (lane & 3) + (e & 1);
        const int i = e >> 1;
        const float pe = visible(row[i], col, p.causal, p.lim)
                             ? __expf(s[nt][e] * p.scale - lse[i])
                             : 0.f;
        s[nt][e] = pe * (dp[nt][e] - delta[i]) * p.scale;
      }
    // dq += ds k.
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t a[4];
      acc_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint32_t bb[2];
        frag_b_kn<LD>(bb, sK, kk * 16, nt * 8, lane);
        mma(dq[nt], a, bb);
      }
    }
  }

  store_rows<D>(p.dq.ptr + b * p.dq.sb + h * D, p.dq.st, q0 + warp * 16,
                p.T, dq, lane);
}

struct DqLaunch {
  BwdParams p;
  int B;
  cudaStream_t stream;
  template <int D>
  cudaError_t operator()() const {
    const int smem = 4 * kTile * (D + kPad) * (int)sizeof(bf16);
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((p.T + kTile - 1) / kTile, p.H, B);
    flash_bwd_dq_kernel<D><<<grid, kThreads, smem, stream>>>(p);
    return cudaGetLastError();
  }
};

inline BwdParams bwd_params(const void* q, long long q_sb, long long q_st,
                            const void* k, long long k_sb, long long k_st,
                            const void* v, long long v_sb, long long v_st,
                            const void* dout, long long do_sb,
                            long long do_st, const void* lse,
                            const void* delta, int H, int T, int seq_len,
                            int causal, float scale) {
  BwdParams p{};
  p.q = View{static_cast<const bf16*>(q), q_sb, q_st};
  p.k = View{static_cast<const bf16*>(k), k_sb, k_st};
  p.v = View{static_cast<const bf16*>(v), v_sb, v_st};
  p.dout = View{static_cast<const bf16*>(dout), do_sb, do_st};
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.H = H;
  p.T = T;
  p.lim = seq_len;
  p.causal = causal;
  p.scale = scale;
  return p;
}

}  // namespace htt

// q, k, v, dout: (B, T, H*D) bf16 views; lse, delta: (B, H, T) f32; dq:
// (B, T, H*D) bf16 view.  Returns the CUDA error code of the launch.
extern "C" int htt_flash_bwd_dq(
    const void* q, long long q_sb, long long q_st, const void* k,
    long long k_sb, long long k_st, const void* v, long long v_sb,
    long long v_st, const void* dout, long long do_sb, long long do_st,
    const void* lse, const void* delta, void* dq, long long dq_sb,
    long long dq_st, int B, int H, int T, int D, int seq_len, int causal,
    float scale, void* stream) {
  using namespace htt;
  DqLaunch launch;
  launch.p = bwd_params(q, q_sb, q_st, k, k_sb, k_st, v, v_sb, v_st, dout,
                        do_sb, do_st, lse, delta, H, T, seq_len, causal,
                        scale);
  launch.p.dq = OutView{static_cast<bf16*>(dq), dq_sb, dq_st};
  launch.B = B;
  launch.stream = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch_d(D, launch));
}
