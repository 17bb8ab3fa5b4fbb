// Flash attention for the inputs that the Hopper kernels do not take: the
// general family G1 (forward), G2 (dk, dv) and G3 (dq), for f32, fp16 and
// bf16 at any head size 1 <= D <= 256.
//
// Replaces: the same Pallas kernels as P1, P2 and P3
// (horovod_tpu/ops/flash_attention.py): G1 _fwd_kernel,
// _fwd_kernel_unrollkv and _fwd_kernel_fullunroll; G2 _dkdv_kernel and
// _dkdv_kernel_grouped; G3 _dq_kernel and _dq_kernel_grouped, for what the
// JAX package runs there and P1-P3 refuse: f32 (the reference's own f32
// tests and models), fp16, and head sizes that are not a multiple of 16 in
// [16, 128] (dim 32 with 4 heads is D 8).  ops/_cuda.py:flash_family picks
// the family from the dtype and D.
//
// G1-G3 run their products on the tensor cores, as mma.sync.m16n8k8
// with TF32 operands taken from registers.  f32 operands keep f32
// accuracy by the "3xTF32" split of CUTLASS's OpMultiplyAddFastF32:
// x = hi + lo with hi = x rounded to TF32 (to nearest, ties away, as
// cvt.rna) and lo = x - hi, which the tensor cores truncate to TF32, and
// a.b = hi.lo + lo.hi + hi.hi, the small products first, into one
// accumulator (lo.lo, ~2^-22 relative, is dropped).  fp16 and bf16
// values, and p and ds once rounded to them, are exact in TF32 and take
// one product.  What bounds them: at
// the training shape in f32 (B 8, H 16, T 2048, D 128, causal) G1's two
// products are ~137 GFLOP, G2's four ~275 and G3's three ~206: 0.83, 1.67
// and 1.25 ms as three TF32 products at the card's 495 TFLOP/s (mma.sync
// itself peaks near 305 TFLOP/s on an H100, flash_ablation.py), against
// 2.05, 4.10 and 3.08 ms for the same sums in FFMA at 67 TFLOP/s.  Around
// each product the operands' way into registers costs as much again:
// fragments are read from shared memory (by ldmatrix where the layout
// allows, else by scalar loads) and, in f32, every value is split by a few
// integer and float instructions, by every warp that uses it.
//
// The design: a block of 4 warps owns 64 rows of one head (query rows for
// G1 and G3, the heaviest first; key rows for G2, the lowest first), one
// m16 row tile per warp, staged once in shared memory (G3: q and dO); the
// other side streams through one buffer per operand, 32 rows at a time
// (G1 and G3: k and v; G2: q with its lse and delta, and dO), each refilled
// by cp.async while the products that do not read it run.  That leaves G1
// at 68.6 KB in f32 at D 128 (1 KiB of it slack, see product_rows), three
// blocks an SM, and G2 and G3 at two (G2 holds dk and dv in registers, G3
// stages 128 own rows).  Tiles hold the raw elements and are converted as
// fragments load; rows at or past T and columns from D up to D8 (D
// rounded up to 8) are zero-filled, so they add nothing to the products.
// The copy width is 16 bytes where every row start of every operand is
// 16-byte aligned, else 4 where it is 4-byte aligned, else one element by
// plain loads (odd D in fp16/bf16): a rule on the input that
// ops/_cuda.py:general_plan applies and the entry points check.  A tile's
// row stride is 16 bytes times an odd number, so that the 32 lanes of
// each fragment load hit distinct banks.  The accumulator of s = q.k^T
// (G1), ds (G3) or s^T = k.q^T and dp^T = v.dO^T (G2) is the A operand of
// the next product as it lies: the C fragment holds columns (2t, 2t + 1)
// of a quad's row where A wants (t, t + 4), and since that sum runs over
// the keys (G1, G3) or queries (G2), whose order inside one 8-wide step is
// free, the B fragment of v (G1), k (G3), dO and q (G2) is read at rows 2t
// and 2t + 1.  Row maxima and sums of the online softmax go across the 4
// lanes of a quad; G3 keeps lse and delta of its rows g and g + 8 in
// registers.  The tensor cores truncate as they accumulate, so o, dk, dv
// and dq are not summed there across tiles: each tile's contribution is,
// from 0, and is then added in f32 (product_rows).  G2's dk and dv (2 x 16
// x D8 f32 a warp) do not fit in registers beyond D8 = 128: there the grid
// takes two column halves of dk and dv, each of which recomputes s^T and
// dp^T (1.5x the products, only at those sizes); G3's dq (16 x D8 f32 a
// warp) fits up to D8 = 256, as G1's o does.  Warps skip the tiles that
// causal and seq_len mask entirely for them, and mask element by element
// only on tiles that cross the diagonal or an edge.
//
// Every sum runs in a fixed order without atomics: every result is
// deterministic.  Numerics follow the plain versions
// (ops/flash_attention.py), cast points included: s = (q.k) * scale; the
// forward is an online softmax that starts at _NEG_BIG and rounds p to the
// input dtype before p.v, with o = acc / max(l, 1e-30) and
// lse = m + log(max(l, 1e-30)); the backward forms p = exp(s - lse)
// (masked entries 0), ds = p (dp - delta) scale, and rounds p and ds to the
// input dtype before dv += p^T dO, dk += ds^T q and dq += ds k.  exp and
// log are the accurate expf/logf.

#include "flash_mma.cuh"

namespace htt {

constexpr int kGenMaxD = 256;

// G2: column halves of dk/dv (two beyond D8 = 128), and the columns of
// the first.
__host__ __device__ inline int gen_halves(int D) {
  return gen_d8(D) > 128 ? 2 : 1;
}
__host__ __device__ inline int gen_half_cols(int D) {
  const int d8 = gen_d8(D);
  return gen_halves(D) == 2 ? ((d8 / 2 + 7) & ~7) : d8;
}

// Dynamic shared memory of G1 (kernel 0), G2 (1) or G3 (2) at head size D
// and element size es.  G1: the 64 q rows, a k and a v tile.  G2: the 64
// k and v rows, a q and a dO tile and the q tile's lse and delta.  G3: the
// 64 q and dO rows, a k and a v tile.  Each then kTcSlack bytes.
inline int gen_smem_bytes(int kernel, int D, int es) {
  const int row = gen_tc_ld(D, es) * es;
  if (kernel == 0) return (kTcRows + 2 * kTcKeys) * row + kTcSlack;
  if (kernel == 1)
    return (2 * kTcRows + 2 * kTcQueries) * row + 2 * kTcQueries * 4 +
           kTcSlack;
  return (2 * kTcRows + 2 * kTcKeys) * row + kTcSlack;
}


// G1: o and lse for 64 query rows.  NT: 8-column tiles of o a warp holds,
// at least D8 / 8.
template <typename E, int NT>
__global__ void __launch_bounds__(kGenThreads, NT <= 16 ? 3 : 1)
    flash_fwd_general_kernel(const GenParams<E> p) {
  extern __shared__ uint4 gsm_tc[];
  const int D = p.D, d8 = gen_d8(D), nk = d8 / 8;
  const int ld = gen_tc_ld(D, sizeof(E));
  E* sQ = reinterpret_cast<E*>(gsm_tc);
  E* sK = sQ + kTcRows * ld;
  E* sV = sK + kTcKeys * ld;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTcRows;  // heaviest first
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wrow = q0 + 16 * warp;  // the warp's first query row
  const long long hD = (long long)h * D;
  const E* gk = p.k.ptr + b * p.k.sb + hD;
  const E* gv = p.v.ptr + b * p.v.sb + hD;
  int n_kv = q0 < p.lim ? (p.lim + kTcKeys - 1) / kTcKeys : 0;
  if (p.causal) n_kv = min(n_kv, (q0 + kTcRows - 1) / kTcKeys + 1);
  // One buffer each for k and v: the next k loads while p.v runs, the
  // next v while q.k^T and the softmax run (two barriers a tile).
  if (n_kv > 0) {
    stage_tile(sQ, ld, p.q.ptr + b * p.q.sb + hD, p.q.st, q0, kTcRows, p.T,
               D, d8, p.vec);
    stage_tile(sK, ld, gk, p.k.st, 0, kTcKeys, p.T, D, d8, p.vec);
    cp_async_commit();
    stage_tile(sV, ld, gv, p.v.st, 0, kTcKeys, p.T, D, d8, p.vec);
    cp_async_commit();
    cp_async_wait<1>();
  }
  __syncthreads();  // q and k tile 0 are in shared memory

  float o[NT][4], m[2] = {kNegBig, kNegBig}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[nt][c] = 0.f;
  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * kTcKeys;
    const bool busy = wrow < p.lim && !(p.causal && k0 > wrow + 15);
    float s[kTcKeys / 8][4], alpha[2];
    if (busy) {
      // s = q.k^T: 16 rows x the tile's keys, n-tile nt = keys 8 nt ..
      // 8 nt + 7.
      product_t<E, kTcKeys / 8>(s, sQ + 16 * warp * ld, sK, ld, nk, g, t);
      // Online softmax over rows g (r 0) and g + 8 (r 1) of the warp.
      const float kNegInf = __int_as_float(0xff800000);
      const bool edge = (p.causal && k0 + kTcKeys - 1 > wrow) ||
                        k0 + kTcKeys > p.lim || wrow + 16 > p.lim;
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int nt = 0; nt < kTcKeys / 8; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float x = s[nt][c] * p.scale;
          if (edge && !visible(wrow + g + (c >> 1) * 8,
                               k0 + 8 * nt + 2 * t + (c & 1), p.causal,
                               p.lim))
            x = kNegInf;
          s[nt][c] = x;
          mx[c >> 1] = fmaxf(mx[c >> 1], x);
        }
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m[r], quad_max(mx[r]));
        alpha[r] = expf(m[r] - m_new);
        m[r] = m_new;
      }
#pragma unroll
      for (int nt = 0; nt < kTcKeys / 8; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float e = expf(s[nt][c] - m[c >> 1]);  // 0 where masked
          sum[c >> 1] += e;
          s[nt][c] = round_to<E>(e);
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + quad_sum(sum[r]);
    }
    cp_async_wait<0>();
    __syncthreads();  // every warp is done with k tile j; v tile j is in
    //                   shared memory
    if (j + 1 < n_kv)
      stage_tile(sK, ld, gk, p.k.st, k0 + kTcKeys, kTcKeys, p.T, D, d8,
                 p.vec);
    cp_async_commit();
    if (busy)  // o = o alpha + p.v.
      product_rows<E, NT, kTcKeys>(o, s, sV, ld, nk, alpha[0], alpha[1], g,
                                   t);
    cp_async_wait<0>();
    __syncthreads();  // every warp is done with v tile j; k tile j + 1 is
    //                   in shared memory
    if (j + 1 < n_kv)
      stage_tile(sV, ld, gv, p.v.st, k0 + kTcKeys, kTcKeys, p.T, D, d8,
                 p.vec);
    cp_async_commit();
  }

  const float la = fmaxf(l[0], 1e-30f), lb = fmaxf(l[1], 1e-30f);
  store_frags<E, NT>(p.o.ptr + b * p.o.sb + hD, p.o.st, wrow, 0, nk, p.T, D,
                     o, la, lb, g, t);
  if (t == 0) {
    float* lse = p.lse + ((long long)b * p.H + h) * p.T;
    if (wrow + g < p.T) lse[wrow + g] = m[0] + logf(la);
    if (wrow + g + 8 < p.T) lse[wrow + g + 8] = m[1] + logf(lb);
  }
}

// G2: dk and dv for 64 key rows, columns of one half (all of them at
// D8 <= 128).  NT: 8-column tiles of dk and dv a warp holds, at least the
// half's.
template <typename E, int NT>
__global__ void __launch_bounds__(kGenThreads)
    flash_bwd_dkdv_general_kernel(const GenParams<E> p) {
  constexpr int BQ = kTcQueries;
  extern __shared__ uint4 gsm_tc[];
  const int D = p.D, d8 = gen_d8(D), nk = d8 / 8;
  const int ld = gen_tc_ld(D, sizeof(E));
  E* sK = reinterpret_cast<E*>(gsm_tc);
  E* sV = sK + kTcRows * ld;
  E* sQ = sV + kTcRows * ld;
  E* sO = sQ + BQ * ld;
  float* sL = reinterpret_cast<float*>(sO + BQ * ld);  // lse of the q tile
  float* sD = sL + BQ;                                   // delta
  const int halves = gen_halves(D);
  const int kb = blockIdx.x / halves, half = blockIdx.x - kb * halves;
  const int c0 = half * gen_half_cols(D);  // the half's first column
  const int n_ct = (half ? d8 - c0 : gen_half_cols(D)) / 8;
  const int k0 = kb * kTcRows;  // low keys have the most work: first
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wkey = k0 + 16 * warp;  // the warp's first key row
  const long long hD = (long long)h * D;
  const long long bh = (long long)b * p.H + h;
  const E* gq = p.q.ptr + b * p.q.sb + hD;
  const E* go = p.dout.ptr + b * p.dout.sb + hD;
  const int i_begin = p.causal ? k0 / BQ : 0;
  const int i_end = k0 < p.lim ? (p.lim + BQ - 1) / BQ : 0;
  auto stage_q = [&](int it) {  // q, lse and delta of q tile it
    stage_tile(sQ, ld, gq, p.q.st, it * BQ, BQ, p.T, D, d8, p.vec);
    stage_vals(sL, p.lse + bh * p.T, it * BQ, BQ, p.T);
    stage_vals(sD, p.delta + bh * p.T, it * BQ, BQ, p.T);
  };
  // One buffer each for q and dO: the next q loads while dv += p^T dO
  // runs, the next dO while s^T = k.q^T runs (three barriers a tile).
  if (i_begin < i_end) {
    stage_tile(sK, ld, p.k.ptr + b * p.k.sb + hD, p.k.st, k0, kTcRows, p.T,
               D, d8, p.vec);
    stage_tile(sV, ld, p.v.ptr + b * p.v.sb + hD, p.v.st, k0, kTcRows, p.T,
               D, d8, p.vec);
    stage_q(i_begin);
    cp_async_commit();
    stage_tile(sO, ld, go, p.dout.st, i_begin * BQ, BQ, p.T, D, d8, p.vec);
    cp_async_commit();
    cp_async_wait<1>();
  }
  __syncthreads();  // k, v and q tile i_begin are in shared memory

  float dk[NT][4], dv[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) dk[nt][c] = dv[nt][c] = 0.f;
  for (int it = i_begin; it < i_end; ++it) {
    const int q0 = it * BQ;
    const bool busy = wkey < p.lim && !(p.causal && q0 + BQ - 1 < wkey);
    // s^T = k.q^T and dp^T = v.dO^T: 16 keys x BQ queries.
    float st[BQ / 8][4], dp[BQ / 8][4];
    if (busy) product_t<E, BQ / 8>(st, sK + 16 * warp * ld, sQ, ld, nk, g, t);
    cp_async_wait<0>();
    __syncthreads();  // dO tile it is in shared memory
    if (busy) {
      product_t<E, BQ / 8>(dp, sV + 16 * warp * ld, sO, ld, nk, g, t);
      // p = exp(s scale - lse) (0 where masked), ds = p (dp - delta)
      // scale, both rounded to E; st and dp now hold them.
      const bool edge = (p.causal && q0 < wkey + 15) || q0 + BQ > p.lim ||
                        wkey + 16 > p.lim;
#pragma unroll
      for (int nt = 0; nt < BQ / 8; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int ql = 8 * nt + 2 * t + (c & 1);
          const bool vis = !edge || visible(q0 + ql, wkey + g + (c >> 1) * 8,
                                            p.causal, p.lim);
          const float pe = vis ? expf(st[nt][c] * p.scale - sL[ql]) : 0.f;
          st[nt][c] = round_to<E>(pe);
          dp[nt][c] = round_to<E>(pe * (dp[nt][c] - sD[ql]) * p.scale);
        }
      // dk += ds^T q over the half's columns.
      product_rows<E, NT, BQ>(dk, dp, sQ + c0, ld, n_ct, 1.f, 1.f, g, t);
    }
    __syncthreads();  // every warp is done with q tile it, lse and delta
    if (it + 1 < i_end) stage_q(it + 1);
    cp_async_commit();
    if (busy)  // dv += p^T dO over the half's columns.
      product_rows<E, NT, BQ>(dv, st, sO + c0, ld, n_ct, 1.f, 1.f, g, t);
    cp_async_wait<0>();
    __syncthreads();  // every warp is done with dO tile it; q tile it + 1
    //                   is in shared memory
    if (it + 1 < i_end)
      stage_tile(sO, ld, go, p.dout.st, q0 + BQ, BQ, p.T, D, d8, p.vec);
    cp_async_commit();
  }

  store_frags<E, NT>(p.dk.ptr + b * p.dk.sb + hD, p.dk.st, wkey, c0, n_ct,
                     p.T, D, dk, 1.f, 1.f, g, t);
  store_frags<E, NT>(p.dv.ptr + b * p.dv.sb + hD, p.dv.st, wkey, c0, n_ct,
                     p.T, D, dv, 1.f, 1.f, g, t);
}

// G3: dq for 64 query rows.  NT: 8-column tiles of dq a warp holds, at
// least D8 / 8.  Two blocks an SM below NT 32: shared memory holds no
// more in f32 at D 128, and ptxas may then give a thread up to 255
// registers; one at NT 32, as G1.
template <typename E, int NT>
__global__ void __launch_bounds__(kGenThreads, NT <= 16 ? 2 : 1)
    flash_bwd_dq_general_kernel(const GenParams<E> p) {
  extern __shared__ uint4 gsm_tc[];
  const int D = p.D, d8 = gen_d8(D), nk = d8 / 8;
  const int ld = gen_tc_ld(D, sizeof(E));
  E* sQ = reinterpret_cast<E*>(gsm_tc);
  E* sO = sQ + kTcRows * ld;
  E* sV = sO + kTcRows * ld;
  E* sK = sV + kTcKeys * ld;  // last: ds.k reads into the slack past it
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTcRows;  // heaviest first
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wrow = q0 + 16 * warp;  // the warp's first query row
  const long long hD = (long long)h * D;
  const long long bh = (long long)b * p.H + h;
  const E* gk = p.k.ptr + b * p.k.sb + hD;
  const E* gv = p.v.ptr + b * p.v.sb + hD;
  int n_kv = q0 < p.lim ? (p.lim + kTcKeys - 1) / kTcKeys : 0;
  if (p.causal) n_kv = min(n_kv, (q0 + kTcRows - 1) / kTcKeys + 1);
  // lse and delta of rows g (r 0) and g + 8 (r 1); rows at or past T read
  // as 0 (the mask hides them).
  float lse[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wrow + g + 8 * r;
    lse[r] = row < p.T ? p.lse[bh * p.T + row] : 0.f;
    delta[r] = row < p.T ? p.delta[bh * p.T + row] : 0.f;
  }
  // One buffer each for k and v: the next v loads while q.k^T, ds and ds.k
  // run, the next k while dO.v^T runs (two barriers a tile).
  if (n_kv > 0) {
    stage_tile(sO, ld, p.dout.ptr + b * p.dout.sb + hD, p.dout.st, q0,
               kTcRows, p.T, D, d8, p.vec);
    stage_tile(sV, ld, gv, p.v.st, 0, kTcKeys, p.T, D, d8, p.vec);
    cp_async_commit();
    stage_tile(sQ, ld, p.q.ptr + b * p.q.sb + hD, p.q.st, q0, kTcRows, p.T,
               D, d8, p.vec);
    stage_tile(sK, ld, gk, p.k.st, 0, kTcKeys, p.T, D, d8, p.vec);
    cp_async_commit();
    cp_async_wait<1>();
  }
  __syncthreads();  // dO and v tile 0 are in shared memory

  float dq[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) dq[nt][c] = 0.f;
  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * kTcKeys;
    const bool busy = wrow < p.lim && !(p.causal && k0 > wrow + 15);
    const bool more = j + 1 < n_kv;
    // dp = dO.v^T, then ds: 16 rows x the tile's keys, n-tile nt = keys
    // 8 nt .. 8 nt + 7.
    float dp[kTcKeys / 8][4];
    if (busy)
      product_t<E, kTcKeys / 8>(dp, sO + 16 * warp * ld, sV, ld, nk, g, t);
    cp_async_wait<0>();
    __syncthreads();  // every warp is done with v tile j; q and k tile j
    //                   are in shared memory
    if (more)
      stage_tile(sV, ld, gv, p.v.st, k0 + kTcKeys, kTcKeys, p.T, D, d8,
                 p.vec);
    cp_async_commit();
    if (busy) {
      float s[kTcKeys / 8][4];
      product_t<E, kTcKeys / 8>(s, sQ + 16 * warp * ld, sK, ld, nk, g, t);
      // p = exp(s scale - lse) (0 where masked), ds = p (dp - delta)
      // scale rounded to E.
      const bool edge = (p.causal && k0 + kTcKeys - 1 > wrow) ||
                        k0 + kTcKeys > p.lim || wrow + 16 > p.lim;
#pragma unroll
      for (int nt = 0; nt < kTcKeys / 8; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const bool vis =
              !edge || visible(wrow + g + (c >> 1) * 8,
                               k0 + 8 * nt + 2 * t + (c & 1), p.causal,
                               p.lim);
          const float pe =
              vis ? expf(s[nt][c] * p.scale - lse[c >> 1]) : 0.f;
          dp[nt][c] =
              round_to<E>(pe * (dp[nt][c] - delta[c >> 1]) * p.scale);
        }
      // dq += ds.k.
      product_rows<E, NT, kTcKeys>(dq, dp, sK, ld, nk, 1.f, 1.f, g, t);
    }
    cp_async_wait<0>();
    __syncthreads();  // every warp is done with k tile j; v tile j + 1 is
    //                   in shared memory
    if (more)
      stage_tile(sK, ld, gk, p.k.st, k0 + kTcKeys, kTcKeys, p.T, D, d8,
                 p.vec);
    cp_async_commit();
  }

  store_frags<E, NT>(p.dq.ptr + b * p.dq.sb + hD, p.dq.st, wrow, 0, nk, p.T,
                     D, dq, 1.f, 1.f, g, t);
}

template <typename E>
cudaError_t launch_general(int kernel, const GenParams<E>& p, int B,
                           int smem, cudaStream_t stream) {
  const int d8 = gen_d8(p.D);
  void (*fn)(const GenParams<E>);
  int blocks;
  if (kernel == 0) {
    fn = d8 <= 64    ? flash_fwd_general_kernel<E, 8>
         : d8 <= 128 ? flash_fwd_general_kernel<E, 16>
                     : flash_fwd_general_kernel<E, 32>;
    blocks = (p.T + kTcRows - 1) / kTcRows;
  } else if (kernel == 1) {
    fn = d8 <= 64 ? flash_bwd_dkdv_general_kernel<E, 8>
                  : flash_bwd_dkdv_general_kernel<E, 16>;
    blocks = (p.T + kTcRows - 1) / kTcRows * gen_halves(p.D);
  } else {
    fn = d8 <= 64    ? flash_bwd_dq_general_kernel<E, 8>
         : d8 <= 128 ? flash_bwd_dq_general_kernel<E, 16>
                     : flash_bwd_dq_general_kernel<E, 32>;
    blocks = (p.T + kTcRows - 1) / kTcRows;
  }
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  fn<<<dim3(blocks, p.H, B), kGenThreads, smem, stream>>>(p);
  return cudaGetLastError();
}


// ptrs: q, k, v, dout, o, dq, dk, dv (null where a kernel has none);
// strides: (batch, row) of each, in the same order, in elements; dtype:
// 0 f32, 1 fp16, 2 bf16; vec and smem_bytes: the plan of
// ops/_cuda.py:general_plan, checked here.
inline int run_general(int kernel, int dtype, const void* const* ptrs,
                       const long long* strides, const void* lse,
                       const void* delta, int B, int H, int T, int D,
                       int seq_len, int causal, float scale, int vec,
                       int smem_bytes, void* stream) {
  const int es = dtype == 0 ? 4 : 2;
  if (dtype < 0 || dtype > 2 || D < 1 || D > kGenMaxD ||
      smem_bytes != gen_smem_bytes(kernel, D, es) ||
      !copies_fit(kernel, ptrs, strides, D, es, vec))
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_general(kernel, gen_params<float>(
          ptrs, strides, lse, delta, H, T, D, seq_len, causal, scale, vec),
          B, smem_bytes, s);
    case 1:
      return launch_general(kernel, gen_params<__half>(
          ptrs, strides, lse, delta, H, T, D, seq_len, causal, scale, vec),
          B, smem_bytes, s);
    default:
      return launch_general(kernel, gen_params<bf16>(
          ptrs, strides, lse, delta, H, T, D, seq_len, causal, scale, vec),
          B, smem_bytes, s);
  }
}

}  // namespace htt

// G1.  q, k, v: (B, T, H*D) views of dtype `dtype` (0 f32, 1 fp16, 2 bf16)
// with unit column stride; o: the same; lse: (B, H, T) f32.  vec (the
// staging copy width) and smem_bytes are the plan of
// horovod_tpu_torch/ops/_cuda.py:general_plan, checked here.  Returns the
// CUDA error code of the launch.
extern "C" int htt_flash_fwd_general(
    int dtype, const void* q, long long q_sb, long long q_st, const void* k,
    long long k_sb, long long k_st, const void* v, long long v_sb,
    long long v_st, void* o, long long o_sb, long long o_st, void* lse,
    int B, int H, int T, int D, int seq_len, int causal, float scale,
    int vec, int smem_bytes, void* stream) {
  const void* ptrs[8] = {q, k, v, nullptr, o, nullptr, nullptr, nullptr};
  const long long strides[16] = {q_sb, q_st, k_sb, k_st, v_sb, v_st, 0, 0,
                                 o_sb, o_st, 0, 0, 0, 0, 0, 0};
  return htt::run_general(0, dtype, ptrs, strides, lse, nullptr, B, H, T, D,
                          seq_len, causal, scale, vec, smem_bytes, stream);
}

// G2.  Inputs as G1 plus dout and lse, delta (B, H, T) f32; dk, dv:
// (B, T, H*D) views of the same dtype, written in full.
extern "C" int htt_flash_bwd_dkdv_general(
    int dtype, const void* q, long long q_sb, long long q_st, const void* k,
    long long k_sb, long long k_st, const void* v, long long v_sb,
    long long v_st, const void* dout, long long do_sb, long long do_st,
    const void* lse, const void* delta, void* dk, long long dk_sb,
    long long dk_st, void* dv, long long dv_sb, long long dv_st, int B,
    int H, int T, int D, int seq_len, int causal, float scale, int vec,
    int smem_bytes, void* stream) {
  const void* ptrs[8] = {q, k, v, dout, nullptr, nullptr, dk, dv};
  const long long strides[16] = {q_sb, q_st, k_sb, k_st, v_sb, v_st,
                                 do_sb, do_st, 0, 0, 0, 0, dk_sb, dk_st,
                                 dv_sb, dv_st};
  return htt::run_general(1, dtype, ptrs, strides, lse, delta, B, H, T, D,
                          seq_len, causal, scale, vec, smem_bytes, stream);
}

// G3.  Inputs as G2; dq: a (B, T, H*D) view of the same dtype.
extern "C" int htt_flash_bwd_dq_general(
    int dtype, const void* q, long long q_sb, long long q_st, const void* k,
    long long k_sb, long long k_st, const void* v, long long v_sb,
    long long v_st, const void* dout, long long do_sb, long long do_st,
    const void* lse, const void* delta, void* dq, long long dq_sb,
    long long dq_st, int B, int H, int T, int D, int seq_len, int causal,
    float scale, int vec, int smem_bytes, void* stream) {
  const void* ptrs[8] = {q, k, v, dout, nullptr, dq, nullptr, nullptr};
  const long long strides[16] = {q_sb, q_st, k_sb, k_st, v_sb, v_st,
                                 do_sb, do_st, 0, 0, dq_sb, dq_st, 0, 0,
                                 0, 0};
  return htt::run_general(2, dtype, ptrs, strides, lse, delta, B, H, T, D,
                          seq_len, causal, scale, vec, smem_bytes, stream);
}
