// Flash-attention backward, the dq half (port kernel P3), for Hopper,
// sm_90a.  The dk/dv half, P2, is flash_bwd_dkdv.cu.
//
// Replaces: horovod_tpu/ops/flash_attention.py:_dq_kernel and
// _dq_kernel_grouped, as reached through _bwd_pallas_packed and
// _bwd_pallas_packed_grouped.  The head grouping there widens VMEM rows;
// here one block handles one head and the grouping has no counterpart.
//
// What bounds it: at the training shape (B 8, H 16, T 2048, D 128,
// causal) it runs three products per live (q, kv) pair (s, dp, dq;
// ~206 GFLOP) against well under 1 GB of traffic, so the bf16 tensor-core
// rate bounds it (~0.21 ms at 989 TFLOP/s), not memory.
//
// What the design does about it: the shape of P1 (flash_fwd.cu) with
// other products.  One block of three warpgroups per (q tile of 128 rows,
// head, batch).  The producer's thread 0 loads the q and dO tiles once by
// TMA, then streams 64-row k and v tiles up to the causal diagonal into a
// ring of `stages` buffers guarded by "full" and "empty" mbarriers; the
// producer gives its registers to the two consumer warpgroups
// (setmaxnreg), which own 64 q rows each with their lse and delta in
// registers.  Per kv tile a consumer forms s = q k^T and dp = dO v^T with
// wgmma from shared memory (all K-major), then in registers
// p = exp(s*scale - lse) and ds = p (dp - delta) scale (no online softmax:
// lse is known), rounds ds to bf16 register A fragments and adds
// dq += ds k with wgmma taking k MN-major, exactly as P1 adds p.v.  ds
// never leaves the registers and dq (64 f32 a thread at D 128) stays there
// for the whole kv loop.  Only tiles that the diagonal or seq_len cross
// are masked; a warpgroup whose rows all lie before the kv tile skips its
// products.  The q tiles of one head are neighbours in the grid (x,
// heaviest first), so that its k and v tiles stay in L2.  The head size is
// padded to 64 or 128 columns by TMA's zero fill.  No atomics, a fixed kv
// order: two launches give the same bits.
//
// Numerics follow _dq_kernel: p = exp(s*scale - lse) with masked entries
// 0, ds = p * (dO V^T - delta) * scale, dq += bf16(ds) k.  delta =
// rowsum(dO * O) comes in precomputed, as in _bwd_pallas_packed.  exp(x)
// is computed as exp2(x * log2(e)).

#include "hopper.cuh"

namespace htt {

constexpr int kDqRows = 128;        // q rows per block, 64 per consumer
constexpr int kDqKv = 64;           // k and v rows per stage
constexpr int kDqThreads = 3 * kWgThreads;

struct DqParams {
  CUtensorMap tq, tk, tv, tdo;  // (D, H, T, B) maps
  const float* lse;    // (B, H, T)
  const float* delta;  // (B, H, T)
  bf16* dq;
  long long dq_sb, dq_st;
  int H, T, D, lim, causal, stages;
  float scale;
};

// Dynamic shared memory of one block: alignment slack, the q and dO
// tiles, k and v rings, and 1 + 2 * stages mbarriers.
inline int dq_smem_bytes(int dp, int stages) {
  return 1024 + 2 * tile_bytes(kDqRows, dp) +
         2 * stages * tile_bytes(kDqKv, dp) + 8 * (1 + 2 * stages);
}

template <int DP>
__global__ void __launch_bounds__(kDqThreads, 1)
    flash_bwd_dq_kernel(const __grid_constant__ DqParams p) {
  constexpr int kQBytes = tile_bytes(kDqRows, DP);
  constexpr int kKvBytes = tile_bytes(kDqKv, DP);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sQ = align_1024(smem_raw);
  unsigned char* sO = sQ + kQBytes;              // the dO tile
  unsigned char* sK = sO + kQBytes;              // stage s at s * kKvBytes
  unsigned char* sV = sK + p.stages * kKvBytes;
  uint64_t* qo_full = reinterpret_cast<uint64_t*>(sV + p.stages * kKvBytes);
  uint64_t* full = qo_full + 1;
  uint64_t* empty = full + p.stages;

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = qt * kDqRows;
  int n_kv = q0 < p.lim ? (p.lim + kDqKv - 1) / kDqKv : 0;
  if (p.causal) n_kv = min(n_kv, (q0 + kDqRows - 1) / kDqKv + 1);

  if (threadIdx.x == 0) {
    mbar_init(qo_full, 1);
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * kWgThreads / 32);  // one arrival per warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < kWgThreads) {
    // Producer.  One thread issues every load; the warpgroup keeps 24
    // registers a thread.
    regs_dealloc<24>();
    if (threadIdx.x == 0 && n_kv > 0) {
      mbar_arrive_expect_tx(qo_full, 2 * kQBytes);
      tma_load_tile<DP>(sQ, &p.tq, qo_full, kDqRows, h, q0, b);
      tma_load_tile<DP>(sO, &p.tdo, qo_full, kDqRows, h, q0, b);
      for (int j = 0; j < n_kv; ++j) {
        const int s = j % p.stages;
        mbar_wait(&empty[s], ((j / p.stages) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], 2 * kKvBytes);
        tma_load_tile<DP>(sK + s * kKvBytes, &p.tk, &full[s], kDqKv, h,
                          j * kDqKv, b);
        tma_load_tile<DP>(sV + s * kKvBytes, &p.tv, &full[s], kDqKv, h,
                          j * kDqKv, b);
      }
    }
  } else {
    // Consumers: warpgroup c owns q rows r0..r0+63.
    regs_alloc<240>();
    const int c = threadIdx.x / kWgThreads - 1;
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x & 31;
    const int r0 = q0 + 64 * c;
    const int row[2] = {r0 + 16 * warp + acc_row(0, lane),
                        r0 + 16 * warp + acc_row(2, lane)};
    const long long bh = (long long)b * p.H + h;
    const float scale_log2 = p.scale * kLog2e;
    // lse * log2(e) and delta of this thread's two rows (rows past T are
    // never visible, so their 0 is never used).
    float lse_l2[2], delta[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const bool in = row[r] < p.T;
      lse_l2[r] = in ? p.lse[bh * p.T + row[r]] * kLog2e : 0.f;
      delta[r] = in ? p.delta[bh * p.T + row[r]] : 0.f;
    }
    float dq[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dq[i] = 0.f;

    if (n_kv > 0) mbar_wait(qo_full, 0);
    for (int j = 0; j < n_kv; ++j) {
      const int s = j % p.stages;
      const int k0 = j * kDqKv;
      const unsigned char* tk = sK + s * kKvBytes;
      const unsigned char* tv = sV + s * kKvBytes;
      mbar_wait(&full[s], (j / p.stages) & 1);
      if (!((p.causal && k0 > r0 + 63) || r0 >= p.lim)) {
        // s = q k^T and dp = dO v^T (queries x keys).
        float sc[kDqKv / 2], dp[kDqKv / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)
          wgmma_ss(sc, desc_k_major(sQ, kDqRows, 64 * c, 16 * kk),
                   desc_k_major(tk, kDqKv, 0, 16 * kk), kk > 0);
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)
          wgmma_ss(dp, desc_k_major(sO, kDqRows, 64 * c, 16 * kk),
                   desc_k_major(tv, kDqKv, 0, 16 * kk), kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        hold(sc);
        hold(dp);

        // ds = p (dp - delta) scale, rounded to bf16 A fragments.
        const bool masked = (p.causal && k0 + kDqKv - 1 > r0) ||
                            k0 + kDqKv > p.lim || r0 + 64 > p.lim;
        uint32_t da[kDqKv / 16][4];
#pragma unroll
        for (int i = 0; i < kDqKv / 2; ++i) {
          const int r = (i >> 1) & 1;
          float pe = fast_exp2(fmaf(sc[i], scale_log2, -lse_l2[r]));
          if (masked &&
              !visible(row[r], k0 + acc_col(i, lane), p.causal, p.lim))
            pe = 0.f;
          sc[i] = pe * (dp[i] - delta[r]) * p.scale;
        }
#pragma unroll
        for (int kk = 0; kk < kDqKv / 16; ++kk) acc_to_a_frag(da[kk], sc, kk);

        // dq += ds k.
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kDqKv / 16; ++kk)
          wgmma_rs(dq, da[kk], desc_mn_major(tk, kDqKv, 16 * kk), 1);
        wgmma_commit();
        wgmma_wait<0>();
        hold(dq);
        hold(da);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    bf16* dqg = p.dq + b * p.dq_sb + h * p.D;
#pragma unroll
    for (int nb = 0; nb < DP / 8; ++nb) {
      const int col = acc_col(4 * nb, lane);
      if (nb * 8 >= p.D) continue;  // padding columns
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (row[r] < p.T)
          *reinterpret_cast<uint32_t*>(dqg + (long long)row[r] * p.dq_st +
                                       col) =
              pack_f32(dq[4 * nb + 2 * r], dq[4 * nb + 2 * r + 1]);
    }
  }
}

template <int DP>
cudaError_t launch_dq(const DqParams& p, int B, int smem,
                      cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.T + kDqRows - 1) / kDqRows, p.H, B);
  flash_bwd_dq_kernel<DP><<<grid, kDqThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace htt

// q, k, v, dout: (B, T, H*D) bf16 views; lse, delta: (B, H, T) f32; dq:
// (B, T, H*D) bf16 view, written in full (rows of q tiles with no live kv
// tile get zeros).  stages and smem_bytes are the plan of
// horovod_tpu_torch/ops/_cuda.py:flash_plan, checked here.  Returns the
// CUDA error code of the launch.
extern "C" int htt_flash_bwd_dq(
    const void* q, long long q_sb, long long q_st, const void* k,
    long long k_sb, long long k_st, const void* v, long long v_sb,
    long long v_st, const void* dout, long long do_sb, long long do_st,
    const void* lse, const void* delta, void* dq, long long dq_sb,
    long long dq_st, int B, int H, int T, int D, int seq_len, int causal,
    float scale, int stages, int smem_bytes, void* stream) {
  using namespace htt;
  if (D % 16 != 0 || D < 16 || D > 128 || stages < 2)
    return cudaErrorInvalidValue;
  const int dp = D <= 64 ? 64 : 128;
  if (smem_bytes != dq_smem_bytes(dp, stages)) return cudaErrorInvalidValue;
  DqParams p{};
  cudaError_t err;
  if ((err = encode_heads(&p.tq, q, D, H, T, B, q_st, q_sb, kDqRows)) ||
      (err = encode_heads(&p.tdo, dout, D, H, T, B, do_st, do_sb,
                          kDqRows)) ||
      (err = encode_heads(&p.tk, k, D, H, T, B, k_st, k_sb, kDqKv)) ||
      (err = encode_heads(&p.tv, v, D, H, T, B, v_st, v_sb, kDqKv)))
    return static_cast<int>(err);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = static_cast<bf16*>(dq);
  p.dq_sb = dq_sb;
  p.dq_st = dq_st;
  p.H = H;
  p.T = T;
  p.D = D;
  p.lim = seq_len;
  p.causal = causal;
  p.stages = stages;
  p.scale = scale;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dp == 64 ? launch_dq<64>(p, B, smem_bytes, s)
                                   : launch_dq<128>(p, B, smem_bytes, s));
}
