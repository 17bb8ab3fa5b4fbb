// Flash-attention backward for Hopper, sm_90a, in one pass: port kernel P6.
//
// Replaces: horovod_tpu/ops/flash_attention.py:_bwd_fused_kernel (through
// _bwd_pallas_fused, flash_attention(bwd_impl="pallas_fused")) and
// _bwd_kernel_fullunroll (through _bwd_pallas_packed under
// HOROVOD_TPU_FLASH_BWD=fullunroll).  Both compute s, p, dp and ds once per
// (q block, kv block) pair and contract them into dq, dk and dv: five
// products per pair, where the split pair P2 + P3 (flash_bwd_dkdv.cu,
// flash_bwd_dq.cu) computes s and dp twice and runs seven.
//
// What bounds it: at the training shape (B 8, H 16, T 2048, D 128, causal)
// the five products are ~344 GFLOP against ~0.5 GB of traffic, so the bf16
// tensor-core rate bounds it (~0.35 ms at 989 TFLOP/s), not memory.  The
// dq sum crosses blocks and adds ~1.1 GB of f32 reductions in L2.
//
// What the design does about it: P2's loop (flash_bwd_dkdv.cu) with the
// dq product added.  One block of three warpgroups per (kv tile of 128
// keys, head, batch), the kv tiles of one head neighbours in the grid.
// The producer warp loads k and v once by TMA and streams 64-row q and dO
// tiles with their lse and delta through a ring of `stages` buffers; the
// two consumer warpgroups own 64 keys each and keep their f32 dk and dv in
// registers for the whole q loop (setmaxnreg gives them 232).  Per q tile
// a consumer forms s^T = k q^T and dp^T = v dO^T with wgmma, p^T and ds^T
// in registers, and adds dv += bf16(p^T) dO and dk += bf16(ds^T) q with
// wgmma taking its register A fragments.  For dq(64 q x D) = ds(64 q x
// 128 kv) k(128 kv x D) the A operand must be ds, not ds^T, which the
// registers cannot give; so each consumer stores bf16(ds^T) for its 64
// keys into a swizzled 128 x 64 shared tile (16 KiB, two of them, one per
// q tile parity), and fences the generic proxy against the async one.
// The consumers take turns at dq: on q tile i consumer i % 2 waits at a
// named barrier until both halves are staged, then runs the whole
// 64 x D x 128 product with wgmma, A = the staged tile read MN-major
// (transposed; 16-bit types allow it) and B = the resident k tile
// MN-major, over the key halves that are live; the other consumer only
// arrives at the barrier and goes on to the next q tile, so that its
// products overlap this dq (both consumers taking 64 columns of every
// tile in lockstep was slower: nothing overlapped their dq products).
// The dq tile goes to shared memory (threads of a quad pair swap halves
// first, so that every store is 16 bytes) and one thread hands it to the
// TMA unit, which adds it to the f32 dq workspace
// (cp.reduce.async.bulk.tensor, through a tensor map that drops columns
// past D and rows past T) while the consumer goes on; the threads' own
// 16-byte atomics were slower.  A second launch in the same entry point
// casts the workspace into the bf16 dq view.  The TPU kernels keep dq in
// VMEM across a sequential grid; blocks on Hopper run in no order, so the
// cross-block sum is an atomic one.
//
// Determinism: the order in which the kv-tile blocks add to a dq row
// changes from run to run, so dq's last bits do (dk and dv do not).  The
// JAX kernels sum in kv order; P2 + P3 stay the deterministic path.
//
// Numerics follow _bwd_fused_kernel: p = exp(s*scale - lse) with masked
// entries 0, dv += bf16(p)^T dO, ds = p * (dO V^T - delta) * scale,
// dk += bf16(ds)^T q, dq += bf16(ds) k.  delta = rowsum(dO * O) comes in
// precomputed.  exp(x) is computed as exp2(x * log2(e)).

#include "hopper.cuh"

namespace htt {

constexpr int kFusedKeys = 128;   // keys per block, 64 per consumer
constexpr int kFusedQ = 64;       // q and dO rows per stage
constexpr int kFusedThreads = 3 * kWgThreads;
constexpr int kDsBytes = kFusedKeys * kRowBytes;  // bf16 ds^T, 128 x 64
constexpr int kDqTile = 64 * 64 * 4;      // f32 dq, 64 q rows x 64 cols
constexpr int kDqBytes = 4 * kDqTile;     // 64 x 128 per consumer

struct FusedParams {
  CUtensorMap tq, tk, tv, tdo;  // (D, H, T, B) bf16 maps
  CUtensorMap tdq;     // the f32 dq workspace, boxes of 64 x 64
  const float* lse;    // (B, H, T)
  const float* delta;  // (B, H, T)
  bf16* dk;
  bf16* dv;
  long long dk_sb, dk_st, dv_sb, dv_st;
  int H, T, D, lim, causal, stages;
  float scale;
};

// Dynamic shared memory of one block: alignment slack, the k and v tiles,
// per stage a q tile, a dO tile and 64 lse and 64 delta values, two
// staged ds^T tiles, a staged 64 x 128 f32 dq tile per consumer, and
// 1 + 2 * stages mbarriers.
inline int fused_smem_bytes(int dp, int stages) {
  return 1024 + 2 * tile_bytes(kFusedKeys, dp) +
         stages * (2 * tile_bytes(kFusedQ, dp) + 2 * kFusedQ * 4) +
         2 * kDsBytes + kDqBytes + 8 * (1 + 2 * stages);
}

// Byte offset of bf16 element (row, col) of a tile of 128-byte rows with
// the 128-byte swizzle (the 16-byte chunk index XOR row % 8), the layout
// TMA writes and wgmma reads.
__device__ __forceinline__ uint32_t swizzled(int row, int col) {
  return row * kRowBytes + ((((col >> 3) ^ row) & 7) << 4) + (col & 7) * 2;
}


// A consumer's 64 x DP f32 dq accumulator into DP / 64 dense shared tiles
// of 64 x 64 (256-byte rows), 16 bytes a store.
template <int DP>
__device__ __forceinline__ void stage_dq(unsigned char* buf,
                                         const float (&dq)[DP / 2], int warp,
                                         int lane) {
  const int odd = lane & 1;
  const int rr = 16 * warp + (lane >> 2) + 8 * odd;
#pragma unroll
  for (int nb = 0; nb < DP / 8; ++nb) {
    const float a0 = dq[4 * nb], a1 = dq[4 * nb + 1];
    const float b0 = dq[4 * nb + 2], b1 = dq[4 * nb + 3];
    const float x0 = __shfl_xor_sync(0xffffffffu, odd ? a0 : b0, 1);
    const float x1 = __shfl_xor_sync(0xffffffffu, odd ? a1 : b1, 1);
    const int col = (8 * nb + 4 * ((lane & 3) >> 1)) & 63;
    *reinterpret_cast<float4*>(buf + (nb / 8) * kDqTile + rr * 256 +
                               4 * col) =
        odd ? make_float4(x0, x1, b0, b1) : make_float4(a0, a1, x0, x1);
  }
  fence_proxy_async();
}

template <int DP>
__global__ void __launch_bounds__(kFusedThreads, 1)
    flash_bwd_fused_kernel(const __grid_constant__ FusedParams p) {
  constexpr int kKvBytes = tile_bytes(kFusedKeys, DP);
  constexpr int kQBytes = tile_bytes(kFusedQ, DP);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sK = align_1024(smem_raw);
  unsigned char* sV = sK + kKvBytes;
  unsigned char* sQ = sV + kKvBytes;             // stage s at s * kQBytes
  unsigned char* sO = sQ + p.stages * kQBytes;   // the dO tiles
  unsigned char* sS = sO + p.stages * kQBytes;   // two ds^T tiles
  unsigned char* sDq = sS + 2 * kDsBytes;        // a dq tile a consumer
  float* sL = reinterpret_cast<float*>(sDq + kDqBytes);
  float* sD = sL + p.stages * kFusedQ;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sD + p.stages * kFusedQ);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + p.stages;

  const int kt = blockIdx.x;  // low kv tiles have the most causal work
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int k0 = kt * kFusedKeys;
  const long long bh = (long long)b * p.H + h;
  const int i_begin = p.causal ? k0 / kFusedQ : 0;
  const int i_end = k0 < p.lim ? (p.lim + kFusedQ - 1) / kFusedQ : 0;
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
    // Producer: warp 0 loads lse and delta, its lane 0 issues the TMA.
    regs_dealloc<40>();
    const int lane = threadIdx.x;
    if (threadIdx.x < 32 && n_q > 0) {
      if (lane == 0) {
        mbar_arrive_expect_tx(kv_full, 2 * kKvBytes);
        tma_load_tile<DP>(sK, &p.tk, kv_full, kFusedKeys, h, k0, b);
        tma_load_tile<DP>(sV, &p.tv, kv_full, kFusedKeys, h, k0, b);
      }
      for (int it = 0; it < n_q; ++it) {
        const int s = it % p.stages;
        const int q0 = (i_begin + it) * kFusedQ;
        mbar_wait(&empty[s], ((it / p.stages) & 1) ^ 1);
        for (int r = lane; r < kFusedQ; r += 32) {
          const bool in = q0 + r < p.T;
          sL[s * kFusedQ + r] = in ? p.lse[bh * p.T + q0 + r] : 0.f;
          sD[s * kFusedQ + r] = in ? p.delta[bh * p.T + q0 + r] : 0.f;
        }
        if (lane == 0) {
          mbar_arrive_expect_tx(&full[s], 2 * kQBytes);
          tma_load_tile<DP>(sQ + s * kQBytes, &p.tq, &full[s], kFusedQ, h,
                            q0, b);
          tma_load_tile<DP>(sO + s * kQBytes, &p.tdo, &full[s], kFusedQ, h,
                            q0, b);
        } else {
          mbar_arrive(&full[s]);
        }
      }
    }
  } else {
    // Consumers: warpgroup c owns keys key0..key0+63, and the dq of
    // every other q tile.
    regs_alloc<232>();
    const int c = threadIdx.x / kWgThreads - 1;
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x & 31;
    const int key0 = k0 + 64 * c;
    const int key[2] = {key0 + 16 * warp + acc_row(0, lane),
                        key0 + 16 * warp + acc_row(2, lane)};
    const float scale_log2 = p.scale * kLog2e;
    const bool issuer = threadIdx.x % kWgThreads == 0;
    float dk[DP / 2], dv[DP / 2];
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) dk[i] = dv[i] = 0.f;

    if (n_q > 0) mbar_wait(kv_full, 0);
    for (int it = 0; it < n_q; ++it) {
      const int s = it % p.stages;
      const int q0 = (i_begin + it) * kFusedQ;
      const unsigned char* tq = sQ + s * kQBytes;
      const unsigned char* to = sO + s * kQBytes;
      const float* lse = sL + s * kFusedQ;
      const float* delta = sD + s * kFusedQ;
      unsigned char* ds_tile = sS + (it & 1) * kDsBytes;
      // Which key halves of the block see this q tile (the same answer
      // in both consumers).
      bool live[2];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        live[hf] = !((p.causal && k0 + 64 * hf > q0 + kFusedQ - 1) ||
                     k0 + 64 * hf >= p.lim);
      mbar_wait(&full[s], (it / p.stages) & 1);
      if (c == 0 ? live[0] : live[1]) {
        uint32_t pa[kFusedQ / 16][4], da[kFusedQ / 16][4];
        // s^T = k q^T and dp^T = v dO^T (keys x queries).
        float st[kFusedQ / 2], dpt[kFusedQ / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)
          wgmma_ss(st, desc_k_major(sK, kFusedKeys, 64 * c, 16 * kk),
                   desc_k_major(tq, kFusedQ, 0, 16 * kk), kk > 0);
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)
          wgmma_ss(dpt, desc_k_major(sV, kFusedKeys, 64 * c, 16 * kk),
                   desc_k_major(to, kFusedQ, 0, 16 * kk), kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        hold(st);
        hold(dpt);

        // p^T and ds^T = p^T (dp^T - delta) * scale, rounded to bf16 A
        // fragments.
        const bool masked = (p.causal && key0 + 63 > q0) ||
                            q0 + kFusedQ > p.lim || key0 + 64 > p.lim;
#pragma unroll
        for (int i = 0; i < kFusedQ / 2; ++i) {
          const int col = acc_col(i, lane);  // query, within the tile
          float pe = fast_exp2(fmaf(st[i], scale_log2, -lse[col] * kLog2e));
          if (masked &&
              !visible(q0 + col, key[(i >> 1) & 1], p.causal, p.lim))
            pe = 0.f;
          st[i] = pe;
          dpt[i] = pe * (dpt[i] - delta[col]) * p.scale;
        }
#pragma unroll
        for (int kk = 0; kk < kFusedQ / 16; ++kk) {
          acc_to_a_frag(pa[kk], st, kk);
          acc_to_a_frag(da[kk], dpt, kk);
        }

        // Stage bf16(ds^T) rows 64c.. of the tile: fragment kk holds
        // queries 16kk + 2t (+8) of keys g and g + 8 of the warp's 16.
        const int g = lane >> 2, t = lane & 3;
        const int kr = 64 * c + 16 * warp + g;
#pragma unroll
        for (int kk = 0; kk < kFusedQ / 16; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            *reinterpret_cast<uint32_t*>(
                ds_tile + swizzled(kr + 8 * (e & 1),
                                   16 * kk + 2 * t + 8 * (e >> 1))) =
                da[kk][e];
        fence_proxy_async();

        // dv += p^T dO and dk += ds^T q.
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kFusedQ / 16; ++kk)
          wgmma_rs(dv, pa[kk], desc_mn_major(to, kFusedQ, 16 * kk), 1);
#pragma unroll
        for (int kk = 0; kk < kFusedQ / 16; ++kk)
          wgmma_rs(dk, da[kk], desc_mn_major(tq, kFusedQ, 16 * kk), 1);
        wgmma_commit();
        wgmma_wait<0>();
        hold(dv);
        hold(dk);
        hold(pa);
        hold(da);
      }
      // Consumer it % 2 adds this tile's dq (all DP columns), once both
      // halves of ds^T are staged; the other goes on to the next tile.
      const int doer = it & 1;
      const bool dq_work = live[0] || live[1];
      if (c == doer) {
        if (issuer) bulk_wait_read();  // its last add has read its buffer
        named_barrier(1 + (it & 1), 2 * kWgThreads);
        if (dq_work) {
          float dq[DP / 2];
#pragma unroll
          for (int i = 0; i < DP / 2; ++i) dq[i] = 0.f;
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kFusedKeys / 16; ++kk)
            if (live[kk / 4])
              wgmma_ss_mn(dq, desc_mn_major(ds_tile, kFusedKeys, 16 * kk),
                          desc_mn_major(sK, kFusedKeys, 16 * kk), 1);
          wgmma_commit();
          wgmma_wait<0>();
          hold(dq);
          unsigned char* buf = sDq + c * 2 * kDqTile;
          stage_dq<DP>(buf, dq, warp, lane);
          named_barrier(3 + c, kWgThreads);
          if (issuer) {
#pragma unroll
            for (int cb = 0; cb < DP / 64; ++cb)
              tma_add(&p.tdq, buf + cb * kDqTile, 64 * cb, h, q0, b);
            bulk_commit();
          }
        }
      } else {
        named_barrier_arrive(1 + (it & 1), 2 * kWgThreads);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    if (issuer) bulk_wait();  // the dq adds in flight have landed
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

// dq (bf16 view) = the f32 workspace, 8 columns per thread.
__global__ void flash_bwd_fused_dq_cast(const float* __restrict__ acc,
                                        OutView dq, int T, int C,
                                        long long n_vec) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_vec) return;
  const int vecs = C / 8;
  const long long row = i / vecs;  // b * T + t
  const int c = (int)(i % vecs) * 8;
  const float4* src = reinterpret_cast<const float4*>(acc + row * C + c);
  const float4 x = src[0], y = src[1];
  uint4 out;
  out.x = pack_f32(x.x, x.y);
  out.y = pack_f32(x.z, x.w);
  out.z = pack_f32(y.x, y.y);
  out.w = pack_f32(y.z, y.w);
  *reinterpret_cast<uint4*>(dq.ptr + (row / T) * dq.sb + (row % T) * dq.st +
                            c) = out;
}

template <int DP>
cudaError_t launch_fused(const FusedParams& p, int B, int smem,
                         cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_fused_kernel<DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.T + kFusedKeys - 1) / kFusedKeys, p.H, B);
  flash_bwd_fused_kernel<DP><<<grid, kFusedThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace htt

// q, k, v, dout: (B, T, H*D) bf16 views; lse, delta: (B, H, T) f32;
// dq, dk, dv: (B, T, H*D) bf16 views, written in full; dq_acc: a
// contiguous (B, T, H*D) f32 workspace (its contents are overwritten).
// Zeroes the workspace, runs the one-pass kernel, then casts the workspace
// into dq, all on `stream`.  stages and smem_bytes are the plan of
// horovod_tpu_torch/ops/_cuda.py:flash_plan, checked here.  Returns the
// CUDA error code of the launches.
extern "C" int htt_flash_bwd_fused(
    const void* q, long long q_sb, long long q_st, const void* k,
    long long k_sb, long long k_st, const void* v, long long v_sb,
    long long v_st, const void* dout, long long do_sb, long long do_st,
    const void* lse, const void* delta, void* dq, long long dq_sb,
    long long dq_st, void* dk, long long dk_sb, long long dk_st, void* dv,
    long long dv_sb, long long dv_st, void* dq_acc, int B, int H, int T,
    int D, int seq_len, int causal, float scale, int stages, int smem_bytes,
    void* stream) {
  using namespace htt;
  if (D % 16 != 0 || D < 16 || D > 128 || stages < 2)
    return cudaErrorInvalidValue;
  const int dp = D <= 64 ? 64 : 128;
  if (smem_bytes != fused_smem_bytes(dp, stages))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int C = H * D;
  const long long n = (long long)B * T * C;
  cudaError_t err = cudaMemsetAsync(dq_acc, 0, n * sizeof(float), s);
  if (err != cudaSuccess) return static_cast<int>(err);

  FusedParams p{};
  if ((err = encode_heads(&p.tq, q, D, H, T, B, q_st, q_sb, kFusedQ)) ||
      (err = encode_heads(&p.tk, k, D, H, T, B, k_st, k_sb, kFusedKeys)) ||
      (err = encode_heads(&p.tv, v, D, H, T, B, v_st, v_sb, kFusedKeys)) ||
      (err = encode_heads(&p.tdo, dout, D, H, T, B, do_st, do_sb,
                          kFusedQ)) ||
      (err = encode_map(&p.tdq, dq_acc, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                        CU_TENSOR_MAP_SWIZZLE_NONE, D, H, T, B, C,
                        (long long)T * C, 64, kFusedQ)))
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
  err = dp == 64 ? launch_fused<64>(p, B, smem_bytes, s)
                 : launch_fused<128>(p, B, smem_bytes, s);
  if (err != cudaSuccess) return static_cast<int>(err);

  const long long n_vec = n / 8;
  const int threads = 256;
  const long long blocks = (n_vec + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  flash_bwd_fused_dq_cast<<<(unsigned)blocks, threads, 0, s>>>(
      static_cast<const float*>(dq_acc),
      OutView{static_cast<bf16*>(dq), dq_sb, dq_st}, T, C, n_vec);
  return static_cast<int>(cudaGetLastError());
}
