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
// (~0.139 ms at 989 TFLOP/s), not its memory (~0.08 ms at 3.35 TB/s).
//
// What the design does about it (FlashAttention-3's shape): only wgmma
// reaches the tensor cores' full rate, and it wants its operands in
// shared memory, fed without the threads' help.  One block of three
// warpgroups per (q tile of 128 rows, head, batch).  Warpgroup 0 is the
// producer: one thread issues TMA loads of the q tile once and of 128-row
// k and v tiles into a ring of `stages` buffers, each guarded by a "full"
// and an "empty" mbarrier; it gives up its registers (setmaxnreg) to the
// two consumer warpgroups, which own 64 q rows each.  A consumer computes
// s = q.k^T with wgmma from shared memory (both operands K-major), the
// online softmax in registers, rounds p to bf16 in registers and adds
// p.v with wgmma taking p as its register A operand and v MN-major, then
// frees the stage.  p never touches shared memory; loads of the next
// tiles overlap the products of this one.  Only tiles that the causal
// diagonal or seq_len cross are masked; the kv loop stops at the
// diagonal.  The q tiles of one head are neighbours in the grid (x,
// heaviest first), so that its k and v tiles stay in L2: issued heaviest
// first over all heads (grid z), the same kernel runs 1.33x slower
// (flash_ablation.py).  The head size is padded to 64 or 128 columns in
// shared memory: TMA fills the columns past D (and the rows past T) with
// zeros, which add nothing.  The result is deterministic: no atomics, a
// fixed kv order.  Tried and left out: the two consumers taking turns at
// the products (FlashAttention-3's ping-pong) with p.v of one tile issued
// beside q.k^T of the next was no faster.
//
// Numerics follow _fwd_kernel: s = (q.k^T) * scale in f32, masked entries
// get p = 0 (the running max starts at _NEG_BIG), p is rounded to bf16
// before p.v, and finally o = acc / max(l, 1e-30) and
// lse = m + log(max(l, 1e-30)) (natural log).  exp(x - m) is computed as
// exp2((x - m) * log2(e)).

#include "hopper.cuh"

namespace htt {

constexpr int kFwdRows = 128;       // q rows per block, 64 per consumer
constexpr int kFwdKv = 128;         // kv rows per stage
constexpr int kFwdThreads = 3 * kWgThreads;

struct FwdParams {
  CUtensorMap tq, tk, tv;  // (D, H, T, B) maps, boxes of 64 x 128
  bf16* o;
  long long o_sb, o_st;
  float* lse;  // (B, H, T)
  int H, T, D, lim, causal, stages;
  float scale;
};

// Dynamic shared memory of one block: alignment slack, the q tile, k and
// v rings, and 1 + 3 * stages mbarriers.
inline int fwd_smem_bytes(int dp, int stages) {
  return 1024 + tile_bytes(kFwdRows, dp) +
         2 * stages * tile_bytes(kFwdKv, dp) + 8 * (1 + 3 * stages);
}

template <int DP>
__global__ void __launch_bounds__(kFwdThreads, 1)
    flash_fwd_kernel(const __grid_constant__ FwdParams p) {
  constexpr int kQBytes = tile_bytes(kFwdRows, DP);
  constexpr int kKvBytes = tile_bytes(kFwdKv, DP);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sQ = align_1024(smem_raw);
  unsigned char* sK = sQ + kQBytes;              // stage s at s * kKvBytes
  unsigned char* sV = sK + p.stages * kKvBytes;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sV + p.stages * kKvBytes);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + p.stages;
  uint64_t* empty = v_full + p.stages;

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = qt * kFwdRows;
  int n_kv = q0 < p.lim ? (p.lim + kFwdKv - 1) / kFwdKv : 0;
  if (p.causal) n_kv = min(n_kv, (q0 + kFwdRows - 1) / kFwdKv + 1);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
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
      mbar_arrive_expect_tx(q_full, kQBytes);
      tma_load_tile<DP>(sQ, &p.tq, q_full, kFwdRows, h, q0, b);
      for (int j = 0; j < n_kv; ++j) {
        const int s = j % p.stages;
        mbar_wait(&empty[s], ((j / p.stages) & 1) ^ 1);
        mbar_arrive_expect_tx(&k_full[s], kKvBytes);
        tma_load_tile<DP>(sK + s * kKvBytes, &p.tk, &k_full[s], kFwdKv, h,
                          j * kFwdKv, b);
        mbar_arrive_expect_tx(&v_full[s], kKvBytes);
        tma_load_tile<DP>(sV + s * kKvBytes, &p.tv, &v_full[s], kFwdKv, h,
                          j * kFwdKv, b);
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
    const float scale_log2 = p.scale * kLog2e;
    float m[2] = {kNegBig, kNegBig};
    float l[2] = {0.f, 0.f};  // this thread's share of the row sums
    float o[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;

    if (n_kv > 0) mbar_wait(q_full, 0);
    for (int j = 0; j < n_kv; ++j) {
      const int s = j % p.stages;
      const uint32_t phase = (j / p.stages) & 1;
      const int k0 = j * kFwdKv;
      const unsigned char* tk = sK + s * kKvBytes;
      const unsigned char* tv = sV + s * kKvBytes;

      float sc[kFwdKv / 2];
      mbar_wait(&k_full[s], phase);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        wgmma_ss(sc, desc_k_major(sQ, kFwdRows, 64 * c, 16 * kk),
                 desc_k_major(tk, kFwdKv, 0, 16 * kk), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      hold(sc);

      // The mask, only on tiles that the diagonal or seq_len cross.
      if ((p.causal && k0 + kFwdKv - 1 > r0) || k0 + kFwdKv > p.lim ||
          r0 + 64 > p.lim) {
#pragma unroll
        for (int i = 0; i < kFwdKv / 2; ++i)
          if (!visible(row[(i >> 1) & 1], k0 + acc_col(i, lane), p.causal,
                       p.lim))
            sc[i] = neg_inf();
      }
      float mx[2] = {neg_inf(), neg_inf()};
#pragma unroll
      for (int i = 0; i < kFwdKv / 2; ++i)
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
      float alpha[2], mb[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m[r], quad_max(mx[r]) * p.scale);
        alpha[r] = fast_exp2((m[r] - m_new) * kLog2e);
        m[r] = m_new;
        // Rows with nothing visible yet keep m = _NEG_BIG, whose log2e
        // multiple overflows; their masked entries are -inf, so any
        // finite offset gives them p = 0.
        mb[r] = m_new == kNegBig ? 0.f : m_new * kLog2e;
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int i = 0; i < kFwdKv / 2; ++i) {
        const int r = (i >> 1) & 1;
        sc[i] = fast_exp2(fmaf(sc[i], scale_log2, -mb[r]));
        l[r] += sc[i];
      }
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
      uint32_t pa[kFwdKv / 16][4];
#pragma unroll
      for (int kk = 0; kk < kFwdKv / 16; ++kk) acc_to_a_frag(pa[kk], sc, kk);

      mbar_wait(&v_full[s], phase);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kFwdKv / 16; ++kk)
        wgmma_rs(o, pa[kk], desc_mn_major(tv, kFwdKv, 16 * kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
      hold(o);
      hold(pa);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    float lsafe[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) lsafe[r] = fmaxf(quad_sum(l[r]), 1e-30f);
    bf16* og = p.o + b * p.o_sb + h * p.D;
#pragma unroll
    for (int nb = 0; nb < DP / 8; ++nb) {
      const int col = acc_col(4 * nb, lane);
      if (nb * 8 >= p.D) continue;  // padding columns
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (row[r] < p.T)
          *reinterpret_cast<uint32_t*>(og + (long long)row[r] * p.o_st +
                                       col) =
              pack_f32(o[4 * nb + 2 * r] / lsafe[r],
                       o[4 * nb + 2 * r + 1] / lsafe[r]);
    }
    if ((lane & 3) == 0) {
      float* lse = p.lse + ((long long)b * p.H + h) * p.T;
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (row[r] < p.T) lse[row[r]] = m[r] + logf(lsafe[r]);
    }
  }
}

template <int DP>
cudaError_t launch_fwd(const FwdParams& p, int B, int smem,
                       cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.T + kFwdRows - 1) / kFwdRows, p.H, B);
  flash_fwd_kernel<DP><<<grid, kFwdThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace htt

// q, k, v: (B, T, H*D) bf16 views; o: (B, T, H*D) bf16; lse: (B, H, T) f32.
// seq_len <= T is the real length (T when none is given).  stages and
// smem_bytes are the plan of horovod_tpu_torch/ops/_cuda.py:flash_plan,
// checked here.  Returns the CUDA error code of the launch (0 on success).
extern "C" int htt_flash_fwd(const void* q, long long q_sb, long long q_st,
                             const void* k, long long k_sb, long long k_st,
                             const void* v, long long v_sb, long long v_st,
                             void* o, long long o_sb, long long o_st,
                             void* lse, int B, int H, int T, int D,
                             int seq_len, int causal, float scale,
                             int stages, int smem_bytes, void* stream) {
  using namespace htt;
  if (D % 16 != 0 || D < 16 || D > 128 || stages < 2)
    return cudaErrorInvalidValue;
  const int dp = D <= 64 ? 64 : 128;
  if (smem_bytes != fwd_smem_bytes(dp, stages)) return cudaErrorInvalidValue;
  FwdParams p{};
  cudaError_t err;
  if ((err = encode_heads(&p.tq, q, D, H, T, B, q_st, q_sb, kFwdRows)) ||
      (err = encode_heads(&p.tk, k, D, H, T, B, k_st, k_sb, kFwdKv)) ||
      (err = encode_heads(&p.tv, v, D, H, T, B, v_st, v_sb, kFwdKv)))
    return static_cast<int>(err);
  p.o = static_cast<bf16*>(o);
  p.o_sb = o_sb;
  p.o_st = o_st;
  p.lse = static_cast<float*>(lse);
  p.H = H;
  p.T = T;
  p.D = D;
  p.lim = seq_len;
  p.causal = causal;
  p.stages = stages;
  p.scale = scale;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dp == 64 ? launch_fwd<64>(p, B, smem_bytes, s)
                                   : launch_fwd<128>(p, B, smem_bytes, s));
}
