// Flash-attention backward, the dk/dv half (port kernel P2), for Hopper,
// sm_90a.
//
// Replaces: horovod_tpu/ops/flash_attention.py:_dkdv_kernel and
// _dkdv_kernel_grouped, as reached through _bwd_pallas_packed and
// _bwd_pallas_packed_grouped.  The head grouping there widens VMEM rows;
// here one block handles one head and the grouping has no counterpart.
//
// What bounds it: at the training shape (B 8, H 16, T 2048, D 128,
// causal) it runs four products per live (q, kv) pair (s, dp, dv, dk;
// ~275 GFLOP) against well under 1 GB of traffic, so the bf16 tensor-core
// rate bounds it (~0.278 ms at 989 TFLOP/s), not memory.
//
// What the design does about it: the shape of P1 (flash_fwd.cu).  One
// block of three warpgroups per (kv tile of 128 keys, head, batch).  The
// producer warp loads the k and v tiles once by TMA, then streams 64-row
// q and dO tiles from the causal diagonal on into a ring of `stages`
// buffers, with each tile's 64 lse and delta values beside it (plain
// loads by the producer warp; rows past T read as 0), guarded by "full"
// and "empty" mbarriers; it gives its registers to the two consumer
// warpgroups (setmaxnreg), which own 64 keys each and keep their f32 dk
// and dv (64 + 64 values a thread at D 128) in registers for the whole
// q loop.  Per q tile a consumer forms s^T = k q^T and dp^T = v dO^T
// with wgmma from shared memory (all K-major), p^T and ds^T in
// registers, and adds dv += bf16(p^T) dO and dk += bf16(ds^T) q with
// wgmma taking p^T and ds^T as register A operands and dO and q
// MN-major.  Only tiles that the diagonal or seq_len cross are masked; a
// warpgroup whose keys all lie past the q tile skips its products.  The
// kv tiles of one head are neighbours in the grid (x), so that the q and
// dO tiles they all stream stay in L2 (heads first it runs 1.17x slower,
// flash_ablation.py).  The head size is padded to 64 or 128 columns by
// TMA's zero fill.  No atomics: the result is deterministic.  Tried and
// left out: the two consumers taking turns at the products (ping-pong),
// and issuing dv/dk of one q tile beside s^T/dp^T of the next; neither
// was faster.
//
// Numerics follow _dkdv_kernel: p = exp(s*scale - lse) with masked
// entries 0, dv += bf16(p)^T dO, ds = p * (dO V^T - delta) * scale,
// dk += bf16(ds)^T q.  delta = rowsum(dO * O) comes in precomputed, as in
// _bwd_pallas_packed.  exp(x) is computed as exp2(x * log2(e)).

#include "hopper.cuh"

namespace htt {

constexpr int kDkdvKeys = 128;   // keys per block, 64 per consumer
constexpr int kDkdvQ = 64;       // q and dO rows per stage
constexpr int kDkdvThreads = 3 * kWgThreads;

struct DkdvParams {
  CUtensorMap tq, tk, tv, tdo;  // (D, H, T, B) maps
  const float* lse;    // (B, H, T)
  const float* delta;  // (B, H, T)
  bf16* dk;
  bf16* dv;
  long long dk_sb, dk_st, dv_sb, dv_st;
  int H, T, D, lim, causal, stages;
  float scale;
};

// Dynamic shared memory of one block: alignment slack, the k and v tiles,
// per stage a q tile, a dO tile and 64 lse and 64 delta values, and
// 1 + 2 * stages mbarriers.
inline int dkdv_smem_bytes(int dp, int stages) {
  return 1024 + 2 * tile_bytes(kDkdvKeys, dp) +
         stages * (2 * tile_bytes(kDkdvQ, dp) + 2 * kDkdvQ * 4) +
         8 * (1 + 2 * stages);
}

template <int DP>
__global__ void __launch_bounds__(kDkdvThreads, 1)
    flash_bwd_dkdv_kernel(const __grid_constant__ DkdvParams p) {
  constexpr int kKvBytes = tile_bytes(kDkdvKeys, DP);
  constexpr int kQBytes = tile_bytes(kDkdvQ, DP);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sK = align_1024(smem_raw);
  unsigned char* sV = sK + kKvBytes;
  unsigned char* sQ = sV + kKvBytes;             // stage s at s * kQBytes
  unsigned char* sO = sQ + p.stages * kQBytes;   // the dO tiles
  float* sL = reinterpret_cast<float*>(sO + p.stages * kQBytes);
  float* sD = sL + p.stages * kDkdvQ;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sD + p.stages * kDkdvQ);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + p.stages;

  const int kt = blockIdx.x;  // low kv tiles have the most causal work
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int k0 = kt * kDkdvKeys;
  const long long bh = (long long)b * p.H + h;
  const int i_begin = p.causal ? k0 / kDkdvQ : 0;
  const int i_end = k0 < p.lim ? (p.lim + kDkdvQ - 1) / kDkdvQ : 0;
  const int n_q = max(i_end - i_begin, 0);

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&full[s], 32);                    // the producer warp
      mbar_init(&empty[s], 2 * kWgThreads / 32);  // one arrival per warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < kWgThreads) {
    // Producer: warp 0 loads lse and delta, its lane 0 issues the TMA.  At
    // 24 registers it spilled 8 bytes; 40 leave the consumers 232, enough.
    regs_dealloc<40>();
    const int lane = threadIdx.x;
    if (threadIdx.x < 32 && n_q > 0) {
      if (lane == 0) {
        mbar_arrive_expect_tx(kv_full, 2 * kKvBytes);
        tma_load_tile<DP>(sK, &p.tk, kv_full, kDkdvKeys, h, k0, b);
        tma_load_tile<DP>(sV, &p.tv, kv_full, kDkdvKeys, h, k0, b);
      }
      for (int it = 0; it < n_q; ++it) {
        const int s = it % p.stages;
        const int q0 = (i_begin + it) * kDkdvQ;
        mbar_wait(&empty[s], ((it / p.stages) & 1) ^ 1);
        for (int r = lane; r < kDkdvQ; r += 32) {
          const bool in = q0 + r < p.T;
          sL[s * kDkdvQ + r] = in ? p.lse[bh * p.T + q0 + r] : 0.f;
          sD[s * kDkdvQ + r] = in ? p.delta[bh * p.T + q0 + r] : 0.f;
        }
        if (lane == 0) {
          mbar_arrive_expect_tx(&full[s], 2 * kQBytes);
          tma_load_tile<DP>(sQ + s * kQBytes, &p.tq, &full[s], kDkdvQ, h, q0,
                            b);
          tma_load_tile<DP>(sO + s * kQBytes, &p.tdo, &full[s], kDkdvQ, h,
                            q0, b);
        } else {
          mbar_arrive(&full[s]);
        }
      }
    }
  } else {
    // Consumers: warpgroup c owns keys key0..key0+63.
    regs_alloc<232>();
    const int c = threadIdx.x / kWgThreads - 1;
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x & 31;
    const int key0 = k0 + 64 * c;
    const int key[2] = {key0 + 16 * warp + acc_row(0, lane),
                        key0 + 16 * warp + acc_row(2, lane)};
    const float scale_log2 = p.scale * kLog2e;
    float dk[DP / 2], dv[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dk[i] = dv[i] = 0.f;

    if (n_q > 0) mbar_wait(kv_full, 0);
    for (int it = 0; it < n_q; ++it) {
      const int s = it % p.stages;
      const int q0 = (i_begin + it) * kDkdvQ;
      const unsigned char* tq = sQ + s * kQBytes;
      const unsigned char* to = sO + s * kQBytes;
      const float* lse = sL + s * kDkdvQ;
      const float* delta = sD + s * kDkdvQ;
      mbar_wait(&full[s], (it / p.stages) & 1);
      if (!((p.causal && key0 > q0 + kDkdvQ - 1) || key0 >= p.lim)) {
        // s^T = k q^T and dp^T = v dO^T (keys x queries).
        float st[kDkdvQ / 2], dpt[kDkdvQ / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)
          wgmma_ss(st, desc_k_major(sK, kDkdvKeys, 64 * c, 16 * kk),
                   desc_k_major(tq, kDkdvQ, 0, 16 * kk), kk > 0);
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)
          wgmma_ss(dpt, desc_k_major(sV, kDkdvKeys, 64 * c, 16 * kk),
                   desc_k_major(to, kDkdvQ, 0, 16 * kk), kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        hold(st);
        hold(dpt);

        // p^T and ds^T = p^T (dp^T - delta) * scale, rounded to bf16 A
        // fragments.
        const bool masked = (p.causal && key0 + 63 > q0) ||
                            q0 + kDkdvQ > p.lim || key0 + 64 > p.lim;
        uint32_t pa[kDkdvQ / 16][4], da[kDkdvQ / 16][4];
#pragma unroll
        for (int i = 0; i < kDkdvQ / 2; ++i) {
          const int col = acc_col(i, lane);  // query, within the tile
          float pe = fast_exp2(fmaf(st[i], scale_log2, -lse[col] * kLog2e));
          if (masked &&
              !visible(q0 + col, key[(i >> 1) & 1], p.causal, p.lim))
            pe = 0.f;
          st[i] = pe;
          dpt[i] = pe * (dpt[i] - delta[col]) * p.scale;
        }
#pragma unroll
        for (int kk = 0; kk < kDkdvQ / 16; ++kk) {
          acc_to_a_frag(pa[kk], st, kk);
          acc_to_a_frag(da[kk], dpt, kk);
        }

        // dv += p^T dO and dk += ds^T q.
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kDkdvQ / 16; ++kk)
          wgmma_rs(dv, pa[kk], desc_mn_major(to, kDkdvQ, 16 * kk), 1);
#pragma unroll
        for (int kk = 0; kk < kDkdvQ / 16; ++kk)
          wgmma_rs(dk, da[kk], desc_mn_major(tq, kDkdvQ, 16 * kk), 1);
        wgmma_commit();
        wgmma_wait<0>();
        hold(dv);
        hold(dk);
        hold(pa);
        hold(da);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    bf16* dkg = p.dk + b * p.dk_sb + h * p.D;
    bf16* dvg = p.dv + b * p.dv_sb + h * p.D;
#pragma unroll
    for (int nb = 0; nb < DP / 8; ++nb) {
      const int col = acc_col(4 * nb, lane);
      if (nb * 8 >= p.D) continue;  // padding columns
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (key[r] >= p.T) continue;
        *reinterpret_cast<uint32_t*>(dkg + (long long)key[r] * p.dk_st +
                                     col) =
            pack_f32(dk[4 * nb + 2 * r], dk[4 * nb + 2 * r + 1]);
        *reinterpret_cast<uint32_t*>(dvg + (long long)key[r] * p.dv_st +
                                     col) =
            pack_f32(dv[4 * nb + 2 * r], dv[4 * nb + 2 * r + 1]);
      }
    }
  }
}

template <int DP>
cudaError_t launch_dkdv(const DkdvParams& p, int B, int smem,
                        cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.T + kDkdvKeys - 1) / kDkdvKeys, p.H, B);
  flash_bwd_dkdv_kernel<DP><<<grid, kDkdvThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace htt

// q, k, v, dout: (B, T, H*D) bf16 views; lse, delta: (B, H, T) f32;
// dk, dv: (B, T, H*D) bf16 views, written in full (rows of kv tiles with no
// live q tile get zeros).  stages and smem_bytes are the plan of
// horovod_tpu_torch/ops/_cuda.py:flash_plan, checked here.  Returns the
// CUDA error code of the launch.
extern "C" int htt_flash_bwd_dkdv(
    const void* q, long long q_sb, long long q_st, const void* k,
    long long k_sb, long long k_st, const void* v, long long v_sb,
    long long v_st, const void* dout, long long do_sb, long long do_st,
    const void* lse, const void* delta, void* dk, long long dk_sb,
    long long dk_st, void* dv, long long dv_sb, long long dv_st, int B,
    int H, int T, int D, int seq_len, int causal, float scale, int stages,
    int smem_bytes, void* stream) {
  using namespace htt;
  if (D % 16 != 0 || D < 16 || D > 128 || stages < 2)
    return cudaErrorInvalidValue;
  const int dp = D <= 64 ? 64 : 128;
  if (smem_bytes != dkdv_smem_bytes(dp, stages)) return cudaErrorInvalidValue;
  DkdvParams p{};
  cudaError_t err;
  if ((err = encode_heads(&p.tq, q, D, H, T, B, q_st, q_sb, kDkdvQ)) ||
      (err = encode_heads(&p.tk, k, D, H, T, B, k_st, k_sb, kDkdvKeys)) ||
      (err = encode_heads(&p.tv, v, D, H, T, B, v_st, v_sb, kDkdvKeys)) ||
      (err = encode_heads(&p.tdo, dout, D, H, T, B, do_st, do_sb, kDkdvQ)))
    return static_cast<int>(err);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  p.dk_sb = dk_sb;
  p.dk_st = dk_st;
  p.dv_sb = dv_sb;
  p.dv_st = dv_st;
  p.H = H;
  p.T = T;
  p.D = D;
  p.lim = seq_len;
  p.causal = causal;
  p.stages = stages;
  p.scale = scale;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dp == 64 ? launch_dkdv<64>(p, B, smem_bytes, s)
                                   : launch_dkdv<128>(p, B, smem_bytes, s));
}
