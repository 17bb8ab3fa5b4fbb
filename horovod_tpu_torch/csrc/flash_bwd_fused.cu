// Flash-attention backward for Hopper, sm_90a, in one pass: port kernel P6.
//
// Replaces: horovod_tpu/ops/flash_attention.py:_bwd_fused_kernel (through
// _bwd_pallas_fused, flash_attention(bwd_impl="pallas_fused")) and
// _bwd_kernel_fullunroll (through _bwd_pallas_packed under
// HOROVOD_TPU_FLASH_BWD=fullunroll).  Both compute s, p, dp and ds once per
// (q block, kv block) pair and contract them into dq, dk and dv: five
// products per pair, where the split pair P2 + P3 (flash_bwd.cu) computes s
// and dp twice and runs seven.
//
// What bounds it: at the training shape (B 8, H 16, T 2048, D 128, causal)
// the five products are ~344 GFLOP against ~0.5 GB of traffic, so the bf16
// tensor-core rate bounds it (~0.35 ms at 989 TFLOP/s), not memory.  The
// dq sum crosses blocks and adds ~2.2 GB of f32 reductions in L2.
//
// What the design does about it: it is the FlashAttention-2 backward, not
// the TPU's grid.  One block of 4 warps per (kv tile of 64 rows, head,
// batch), as P2 was before its wgmma redesign: the k/v tile stays in
// shared memory while the q and dO tiles from the causal diagonal on
// stream through, and each warp keeps the f32 dk and dv of its 16 key
// rows in registers.  Per q tile a warp
// computes s^T, p^T, dv, dp^T and ds^T for its key rows as P2 did, stages
// ds (bf16, [key][query]) in shared memory and adds ds^T q to dk; then the
// warps switch to query rows, read ds back transposed as the A operand and
// form ds k, 16 or 32 columns of D at a time so that no f32 dq fragment
// lives beside dk and dv.  Each chunk goes through the shared memory of
// the q and dO tiles (dead by then) so that every thread adds 4
// consecutive floats to the f32 dq workspace with one vector atomic: whole
// 128-byte rows per quarter warp.  A second launch in the same entry point
// casts the workspace into the bf16 dq view.  Every fragment comes from
// shared memory by ldmatrix (transposing where the operand is stored
// k-major).
// The TPU kernels keep dq in VMEM across a sequential grid; blocks on
// Hopper run in no order, so the cross-block sum is an atomic one.
//
// Determinism: the order in which the kv-tile blocks add to a dq row
// changes from run to run, so dq's last bits do (dk and dv do not).  The
// JAX kernels sum in kv order; P2 + P3 stay the deterministic path.
//
// Numerics follow _bwd_fused_kernel: p = exp(s*scale - lse) with masked
// entries 0, dv += bf16(p)^T dO, ds = p * (dO V^T - delta) * scale,
// dk += bf16(ds)^T q, dq += bf16(ds) k.  delta = rowsum(dO * O) comes in
// precomputed.  Not yet done: wgmma, TMA and pipelined loads.

#include "flash_common.cuh"

namespace htt {

struct FusedParams {
  View q, k, v, dout;
  const float* lse;    // (B, H, T)
  const float* delta;  // (B, H, T)
  OutView dk, dv;
  float* dq_acc;       // (B, T, H*D) f32, zeroed before the launch
  int H, T, lim, causal;
  float scale;
};

constexpr int kLdS = kTile + kPad;  // row stride of the staged ds tile

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_fused_kernel(const FusedParams p) {
  constexpr int LD = D + kPad;
  constexpr int NT = D / 8;
  constexpr int CH = D % 32 == 0 ? 32 : 16;  // dq columns per product
  constexpr int LDC = CH + 8;                // row stride of a staged chunk
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + kTile * LD;
  bf16* sQ = sV + kTile * LD;
  bf16* sO = sQ + kTile * LD;   // the dO tile
  bf16* sS = sO + kTile * LD;   // bf16(ds), [key][query]
  float* sL = reinterpret_cast<float*>(sS + kTile * kLdS);
  float* sD = sL + kTile;

  const int kt = blockIdx.x;  // low kv tiles have the most causal work
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int k0 = kt * kTile;
  const long long bh = (long long)b * p.H + h;
  const long long C = (long long)p.H * D;
  // A warp's dq chunk (16 rows x CH f32) in the memory of the q and dO
  // tiles, which the dq phase no longer reads: 4 x 16 x LDC floats fit in
  // their 2 x 64 x LD bf16 since CH <= D.
  float* stage = reinterpret_cast<float*>(sQ) + warp * 16 * LDC;

  const bf16* qg = p.q.ptr + b * p.q.sb + h * D;
  const bf16* og = p.dout.ptr + b * p.dout.sb + h * D;
  float* dqg = p.dq_acc + (long long)b * p.T * C + h * D;
  load_tile<D>(sK, p.k.ptr + b * p.k.sb + h * D, p.k.st, k0, p.T);
  load_tile<D>(sV, p.v.ptr + b * p.v.sb + h * D, p.v.st, k0, p.T);

  const int key[2] = {k0 + warp * 16 + (lane >> 2),
                      k0 + warp * 16 + (lane >> 2) + 8};
  float dk[NT][4], dv[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[nt][e] = dv[nt][e] = 0.f;

  const int i_begin = p.causal ? kt : 0;
  const int i_end = k0 < p.lim ? (p.lim + kTile - 1) / kTile : 0;
  for (int i = i_begin; i < i_end; ++i) {
    const int q0 = i * kTile;
    __syncthreads();  // every warp is done with the previous q/dO/ds tiles
    load_tile<D>(sQ, qg, p.q.st, q0, p.T);
    load_tile<D>(sO, og, p.dout.st, q0, p.T);
    for (int r = threadIdx.x; r < kTile; r += kThreads) {
      const bool in = q0 + r < p.T;
      sL[r] = in ? p.lse[bh * p.T + q0 + r] : 0.f;
      sD[r] = in ? p.delta[bh * p.T + q0 + r] : 0.f;
    }
    __syncthreads();

    // s^T = k q^T, then p^T.  Warp w: keys 16w..16w+15 x the 64 queries.
    float st[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) st[nt][0] = st[nt][1] = st[nt][2] = st[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      ldsm_a<LD>(a, sK, warp * 16, kk * 16, lane);
#pragma unroll
      for (int nt = 0; nt < 8; nt += 2) {
        uint32_t bb[4];
        ldsm_b_nk<LD>(bb, sQ, nt * 8, kk * 16, lane);
        mma(st[nt], a, bb);
        mma(st[nt + 1], a, bb + 2);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = nt * 8 + 2 * (lane & 3) + (e & 1);
        st[nt][e] = visible(q0 + c, key[e >> 1], p.causal, p.lim)
                        ? __expf(st[nt][e] * p.scale - sL[c])
                        : 0.f;
      }

    // dv += p^T dO.
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t a[4];
      acc_to_a(a, st[2 * kk], st[2 * kk + 1]);
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2) {
        uint32_t bb[4];
        ldsm_b_kn<LD>(bb, sO, kk * 16, nt * 8, lane);
        mma(dv[nt], a, bb);
        mma(dv[nt + 1], a, bb + 2);
      }
    }

    // dp^T = v dO^T, then ds^T = p^T (dp^T - delta) * scale.
    float dpt[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) dpt[nt][0] = dpt[nt][1] = dpt[nt][2] = dpt[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t a[4];
      ldsm_a<LD>(a, sV, warp * 16, kk * 16, lane);
#pragma unroll
      for (int nt = 0; nt < 8; nt += 2) {
        uint32_t bb[4];
        ldsm_b_nk<LD>(bb, sO, nt * 8, kk * 16, lane);
        mma(dpt[nt], a, bb);
        mma(dpt[nt + 1], a, bb + 2);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = nt * 8 + 2 * (lane & 3) + (e & 1);
        st[nt][e] = st[nt][e] * (dpt[nt][e] - sD[c]) * p.scale;
      }

    // Stage bf16(ds^T) as [key][query], two queries per 32-bit store.
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = warp * 16 + (lane >> 2) + 8 * half;
        const int c = nt * 8 + 2 * (lane & 3);
        *reinterpret_cast<uint32_t*>(sS + r * kLdS + c) =
            pack_f32(st[nt][2 * half], st[nt][2 * half + 1]);
      }

    // dk += ds^T q.
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t a[4];
      acc_to_a(a, st[2 * kk], st[2 * kk + 1]);
#pragma unroll
      for (int nt = 0; nt < NT; nt += 2) {
        uint32_t bb[4];
        ldsm_b_kn<LD>(bb, sQ, kk * 16, nt * 8, lane);
        mma(dk[nt], a, bb);
        mma(dk[nt + 1], a, bb + 2);
      }
    }
    __syncthreads();  // ds is staged; q and dO are no longer read

    // dq[q0 + 16w .. q0 + 16w + 15] += ds k, CH columns at a time.
    const int row0 = q0 + warp * 16;
    if (row0 < p.lim) {  // rows at or past lim have ds = 0
      uint32_t a[kTile / 16][4];
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk)
        ldsm_a_t<kLdS>(a[kk], sS, warp * 16, kk * 16, lane);
#pragma unroll
      for (int c0 = 0; c0 < D; c0 += CH) {
        float acc[CH / 8][4];
#pragma unroll
        for (int j = 0; j < CH / 8; ++j)
          acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < kTile / 16; ++kk)
#pragma unroll
          for (int j = 0; j < CH / 8; j += 2) {
            uint32_t bb[4];
            ldsm_b_kn<LD>(bb, sK, kk * 16, c0 + j * 8, lane);
            mma(acc[j], a[kk], bb);
            mma(acc[j + 1], a[kk], bb + 2);
          }
#pragma unroll
        for (int j = 0; j < CH / 8; ++j) {
          float* s0 = stage + (lane >> 2) * LDC + j * 8 + 2 * (lane & 3);
          *reinterpret_cast<float2*>(s0) = make_float2(acc[j][0], acc[j][1]);
          *reinterpret_cast<float2*>(s0 + 8 * LDC) =
              make_float2(acc[j][2], acc[j][3]);
        }
        __syncwarp();
        // 16 rows x CH columns as float4s, CH / 4 of them per row.
#pragma unroll
        for (int idx = lane; idx < 16 * CH / 4; idx += 32) {
          const int r = idx / (CH / 4);
          const int c = (idx % (CH / 4)) * 4;
          if (row0 + r < p.lim)
            atomicAdd(reinterpret_cast<float4*>(dqg + (row0 + r) * C + c0 + c),
                      *reinterpret_cast<const float4*>(stage + r * LDC + c));
        }
        __syncwarp();
      }
    }
  }

  store_rows<D>(p.dk.ptr + b * p.dk.sb + h * D, p.dk.st, k0 + warp * 16,
                p.T, dk, lane);
  store_rows<D>(p.dv.ptr + b * p.dv.sb + h * D, p.dv.st, k0 + warp * 16,
                p.T, dv, lane);
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

struct FusedLaunch {
  FusedParams p;
  int B;
  cudaStream_t stream;
  template <int D>
  cudaError_t operator()() const {
    const int smem = 4 * kTile * (D + kPad) * (int)sizeof(bf16) +
                     kTile * kLdS * (int)sizeof(bf16) +
                     2 * kTile * (int)sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_fused_kernel<D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const dim3 grid((p.T + kTile - 1) / kTile, p.H, B);
    flash_bwd_fused_kernel<D><<<grid, kThreads, smem, stream>>>(p);
    return cudaGetLastError();
  }
};

}  // namespace htt

// q, k, v, dout: (B, T, H*D) bf16 views; lse, delta: (B, H, T) f32;
// dq, dk, dv: (B, T, H*D) bf16 views, written in full; dq_acc: a
// contiguous (B, T, H*D) f32 workspace (its contents are overwritten).
// Zeroes the workspace, runs the one-pass kernel, then casts the workspace
// into dq, all on `stream`.  Returns the CUDA error code of the launches.
extern "C" int htt_flash_bwd_fused(
    const void* q, long long q_sb, long long q_st, const void* k,
    long long k_sb, long long k_st, const void* v, long long v_sb,
    long long v_st, const void* dout, long long do_sb, long long do_st,
    const void* lse, const void* delta, void* dq, long long dq_sb,
    long long dq_st, void* dk, long long dk_sb, long long dk_st, void* dv,
    long long dv_sb, long long dv_st, void* dq_acc, int B, int H, int T,
    int D, int seq_len, int causal, float scale, void* stream) {
  using namespace htt;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int C = H * D;
  const long long n = (long long)B * T * C;
  cudaError_t err = cudaMemsetAsync(dq_acc, 0, n * sizeof(float), s);
  if (err != cudaSuccess) return static_cast<int>(err);

  FusedLaunch launch;
  FusedParams& p = launch.p;
  p.q = View{static_cast<const bf16*>(q), q_sb, q_st};
  p.k = View{static_cast<const bf16*>(k), k_sb, k_st};
  p.v = View{static_cast<const bf16*>(v), v_sb, v_st};
  p.dout = View{static_cast<const bf16*>(dout), do_sb, do_st};
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dk = OutView{static_cast<bf16*>(dk), dk_sb, dk_st};
  p.dv = OutView{static_cast<bf16*>(dv), dv_sb, dv_st};
  p.dq_acc = static_cast<float*>(dq_acc);
  p.H = H;
  p.T = T;
  p.lim = seq_len;
  p.causal = causal;
  p.scale = scale;
  launch.B = B;
  launch.stream = s;
  err = dispatch_d(D, launch);
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
