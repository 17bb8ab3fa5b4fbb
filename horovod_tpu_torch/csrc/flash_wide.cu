// Flash attention at head sizes above 256: the wide route of the general
// family, W1 (forward), W2 (dk, dv) and W3 (dq), for f32, fp16 and bf16 at
// any head size up to ops/_cuda.py:WIDE_MAX_D.
//
// Replaces: the same Pallas kernels as G1-G3
// (horovod_tpu/ops/flash_attention.py): W1 _fwd_kernel, _fwd_kernel_unrollkv
// and _fwd_kernel_fullunroll; W2 _dkdv_kernel and _dkdv_kernel_grouped; W3
// _dq_kernel and _dq_kernel_grouped, for the head sizes G1-G3 cannot stage
// (G3 already needs 200,704 of 227 KiB of shared memory at D 256 in f32).
// The JAX package has no bound on D; ops/_cuda.py:flash_family sends
// D > 256 here.
//
// W1-W3 run on the tensor cores with G1-G3's pieces (flash_mma.cuh):
// mma.sync.m16n8k8 with TF32 operands, three products a term for f32 and
// one for fp16, bf16 and p, ds once rounded.  A block owns 64 rows of one
// head (W1 and W3: query rows, the heaviest first; W2: key rows, the
// lowest first) with two groups of 4 warps: warps w and w + 4 own the
// same m16 tile of rows.  What bounds them is what bounds G1-G3, the
// products and the operands' way into registers, and past D 256 two
// limits besides: 64 rows x D no longer fit shared memory, nor 16 x D f32
// of o or dq (2 x 16 x D of dk and dv) a warp's registers.  So:
// - the products over D (W1: s = q.k^T; W2: s^T = k.q^T, dp^T = v.dO^T;
//   W3: dp = dO.v^T, s = q.k^T) run in steps of 2 dc columns of each
//   operand, through two buffers filled by cp.async: the next step loads
//   while this one's products run.  Each step's part is summed from 0 on
//   the tensor cores and added to the warp's s (dp) in f32.  In W1 and
//   W2 group 0 takes the first dc columns of each step and group 1 the
//   rest, and the two warps of a pair add their partial tiles through
//   shared memory (put_part, add_part).  W3 streams 64 keys a tile
//   instead of 32, and the pair splits the keys: each warp forms s and dp
//   for its 32 keys over the whole step, so each staged step serves twice
//   the keys; the two then exchange ds (put_part, get_part).  Shared
//   memory does not grow with D, and no product is formed twice in a
//   block.  W1 may stage its 64 q rows whole instead, once, and W3 its 64
//   q and 64 dO rows (q_res), where ops/_cuda.py:wide_plan finds that
//   they fit.
// - the columns of o (W1), dk and dv (W2) and dq (W3) are cut into chunks
//   of at most oc columns, which a warp's registers hold: two a block, one
//   a group.  Each block forms s (s and dp) over all of D for its two
//   chunks, so for n chunks, b = ceil(n / 2) blocks of them, the products
//   are (b + 1) / 2 (W1, W2) and (2 b + 1) / 3 (W3) of the least: 1x (W1,
//   W3) and 1.5x (W2) at D 384 (wide_plan's `products`, which also counts
//   the extra chunks a grid too small to fill the card takes).
// The other side streams a tile of 32 rows at a time (W1: k and v; W2: q
// and dO with their lse and delta; W3: 64 rows of k and v).  Of the tile
// that p.v (v), dv += p^T dO and dk += ds^T q (dO, q) or dq += ds.k (k)
// read, only the block's column chunks are staged, once a tile.  Both
// warp groups issue the copies.  Rows at or past seq_len are staged as 0,
// never read.  lse is written by the first group of the blocks of the
// first chunks; W3 keeps the lse and delta of its rows in registers, as
// G3.  Warps skip the tiles that causality and seq_len mask entirely for
// them; the mask applies element by element only on tiles that cross the
// diagonal or an edge.  Copies are 16, 4 or one element wide by
// general_plan's rule.
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

#include "flash_mma.cuh"

namespace htt {

// ---------------------------------------------------------------------------
// W1-W3.

constexpr int kWideTcThreads = 2 * kGenThreads;  // two groups of 4 warps
// Accumulators of a chunk's f32 sum over D (product_t): one, as each sum
// over a chunk is short; it saves the registers W2 and W3 need.
constexpr int kWideSets = 1;
constexpr int kSPart = 16 * kTcKeys;  // f32 of one warp's partial s tile
constexpr int kW3Keys = 2 * kTcKeys;  // k and v rows of a W3 tile

// W1-W3: the general family's parameters plus the plan of
// ops/_cuda.py:wide_plan.
template <typename E>
struct WideTcParams {
  GenParams<E> g;
  int oc;     // columns of o (W1), dk and dv (W2) or dq (W3) a warp group
  //             computes
  int dc;     // half the columns of each step over D (W1, W2: a warp
  //             group's half)
  int q_res;  // W1: the block's 64 q rows are staged whole, once; W3: its
  //             64 q and 64 dO rows
};

// Column chunks of oc columns (the last may be narrower) over D8, one a
// warp group, and the blocks of a row block: two chunks each.
__host__ __device__ inline int wide_chunks(int D, int oc) {
  return (gen_d8(D) + oc - 1) / oc;
}
__host__ __device__ inline int wide_block_chunks(int D, int oc) {
  return (wide_chunks(D, oc) + 1) / 2;
}

// Dynamic shared memory of W1 (kernel 0), W2 (1) or W3 (2) at head size
// D, element size es and the plan's oc, dc and q_res; a step's tiles are
// 2 dc columns wide, the tiles of the block's column chunks 2 oc.  W1:
// its q rows (64 x D whole, or two buffers of a step's 64 rows), two
// buffers of a step's 32 k rows, the 8 warps' partial s tiles, the v
// tile's 32 rows.  W2: two buffers of a step's 64 k and 64 v rows and 32
// q and 32 dO rows, the q tile's lse and delta, the 8 warps' partial s
// and dp tiles, the q and dO tiles' 32 rows.  W3: its q and dO rows (64
// x D each whole, or two buffers of a step's 64 each), two buffers of a
// step's 64 k and 64 v rows, the 8 warps' ds tiles, the k tile's 64 rows.
// Each then kTcSlack bytes.
inline long long wide_tc_smem_bytes(int kernel, int D, int es, int oc,
                                    int dc, int q_res) {
  const long long c = gen_tc_ld(2 * dc, es) * es;
  const long long o = gen_tc_ld(2 * oc, es) * es;
  if (kernel == 0)
    return (q_res ? kTcRows * gen_tc_ld(D, es) * es : 2 * kTcRows * c) +
           2 * kTcKeys * c + 8 * kSPart * 4 + kTcKeys * o + kTcSlack;
  if (kernel == 2)
    return (q_res ? 2 * kTcRows * gen_tc_ld(D, es) * es : 4 * kTcRows * c) +
           4 * kW3Keys * c + 8 * kSPart * 4 + kW3Keys * o + kTcSlack;
  return 2 * (2 * kTcRows + 2 * kTcQueries) * c + 2 * kTcQueries * 4 +
         2 * 8 * kSPart * 4 + 2 * kTcQueries * o + kTcSlack;
}

// stage_tile by both warp groups of a W1-W3 block, each staging half
// of the n rows.
template <typename E>
__device__ __forceinline__ void stage_halves(E* s, int ld, const E* g,
                                             long long st, int row0, int n,
                                             int T_, int D, int d8,
                                             int vec) {
  const int gr = threadIdx.x / kGenThreads, half = n / 2;
  stage_tile(s + gr * half * ld, ld, g, st, row0 + gr * half, half, T_, D,
             d8, vec, static_cast<int>(threadIdx.x % kGenThreads));
}

// Columns a warp group's half of a step of `cols` columns starting at
// column off of the step: its 8-column steps of the product over D.
__device__ __forceinline__ int wide_half_steps(int cols, int off, int dc) {
  return max(min(cols - off, dc), 0) / 8;
}

// A warp's partial tile (16 rows x 32 f32 of C fragments) to shared
// memory, and the partner warp's added to it: the two parts of the sum
// over D.  a + b is b + a in f32, so both warps get the same bits.
__device__ __forceinline__ void put_part(float* s, const float (&x)[4][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[(nt * 4 + c) * 32 + lane] = x[nt][c];
}
__device__ __forceinline__ void add_part(float (&x)[4][4], const float* s) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) x[nt][c] += s[(nt * 4 + c) * 32 + lane];
}
// The partner warp's tile, as put_part left it (W3's ds).
__device__ __forceinline__ void get_part(float (&x)[4][4], const float* s) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) x[nt][c] = s[(nt * 4 + c) * 32 + lane];
}

// W1: o (two column chunks of it, one a warp group) and lse for 64 query
// rows.  Warps w and w + 4 own the same 16 rows; each forms s over its
// half of every step's columns, and they add their parts through shared
// memory.  NT: 8-column tiles of o a warp holds, at least oc / 8.
template <typename E, int NT>
__global__ void __launch_bounds__(kWideTcThreads)
    flash_fwd_wide_kernel(const WideTcParams<E> w) {
  static_assert(kTcKeys == 32, "partial s tiles are 16 x 32");
  const GenParams<E>& p = w.g;
  extern __shared__ uint4 wsm_tc[];
  const int D = p.D, d8 = gen_d8(D);
  const int ldc = gen_tc_ld(2 * w.dc, sizeof(E));
  const int ldq = w.q_res ? gen_tc_ld(D, sizeof(E)) : ldc;
  const int ldv = gen_tc_ld(2 * w.oc, sizeof(E));
  E* sQ = reinterpret_cast<E*>(wsm_tc);
  E* sK = sQ + kTcRows * (w.q_res ? ldq : 2 * ldc);
  float* sS = reinterpret_cast<float*>(sK + 2 * kTcKeys * ldc);
  E* sV = reinterpret_cast<E*>(sS + 8 * kSPart);  // last: p.v reads past it
  const int n_bc = wide_block_chunks(D, w.oc);
  const int rb = blockIdx.x / n_bc, bc = blockIdx.x - rb * n_bc;
  const int q0 = (gridDim.x / n_bc - 1 - rb) * kTcRows;  // heaviest first
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, gr = warp >> 2;
  const int cb = 2 * bc * w.oc;  // the block's columns
  const int cb_cols = min(2 * w.oc, d8 - cb);
  const int n_ct = max(min(w.oc, d8 - cb - gr * w.oc), 0) / 8;  // own
  const int wrow = q0 + 16 * (warp & 3);  // the warp's first query row
  const long long hD = (long long)h * D;
  const E* gq = p.q.ptr + b * p.q.sb + hD;
  const E* gk = p.k.ptr + b * p.k.sb + hD;
  const E* gv = p.v.ptr + b * p.v.sb + hD;
  int n_kv = q0 < p.lim ? (p.lim + kTcKeys - 1) / kTcKeys : 0;
  if (p.causal) n_kv = min(n_kv, (q0 + kTcRows - 1) / kTcKeys + 1);
  const int n_dc = (d8 + 2 * w.dc - 1) / (2 * w.dc);
  const int n_steps = n_kv * n_dc;
  // Step i: columns 2 dc (i % n_dc) .. of k tile i / n_dc (and of the q
  // rows unless they are resident), into buffer i & 1.
  auto stage_step = [&](int i) {
    const int j = i / n_dc, d0 = (i - j * n_dc) * 2 * w.dc;
    const int cols = min(2 * w.dc, d8 - d0);
    if (!w.q_res)
      stage_halves(sQ + (i & 1) * kTcRows * ldc, ldc, gq + d0, p.q.st, q0,
                   kTcRows, p.lim, D - d0, cols, p.vec);
    stage_halves(sK + (i & 1) * kTcKeys * ldc, ldc, gk + d0, p.k.st,
                 j * kTcKeys, kTcKeys, p.lim, D - d0, cols, p.vec);
  };
  if (n_steps > 0) {
    if (w.q_res)
      stage_halves(sQ, ldq, gq, p.q.st, q0, kTcRows, p.lim, D, d8, p.vec);
    stage_step(0);
  }
  cp_async_commit();

  float o[NT][4], m[2] = {kNegBig, kNegBig}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[nt][c] = 0.f;
  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * kTcKeys;
    const bool busy = wrow < p.lim && !(p.causal && k0 > wrow + 15);
    // s = q.k^T: 16 rows x the tile's keys, n-tile nt = keys 8 nt ..
    // 8 nt + 7; this warp's part, step by step over its columns.
    float s[kTcKeys / 8][4] = {}, alpha[2];
    for (int d = 0; d < n_dc; ++d) {
      const int i = j * n_dc + d, d0 = d * 2 * w.dc + gr * w.dc;
      cp_async_wait<0>();
      __syncthreads();  // step i is in buffer i & 1; every warp is done
      //                   with step i - 1 and, at d 0, with v tile j - 1
      if (d == 0)
        stage_halves(sV, ldv, gv + cb, p.v.st, k0, kTcKeys, p.lim, D - cb,
                     cb_cols, p.vec);
      cp_async_commit();
      if (i + 1 < n_steps) stage_step(i + 1);
      cp_async_commit();
      const int nk = wide_half_steps(d8 - d * 2 * w.dc, gr * w.dc, w.dc);
      if (busy && nk > 0) {
        const E* a = w.q_res ? sQ + 16 * (warp & 3) * ldq + d0
                             : sQ + ((i & 1) * kTcRows + 16 * (warp & 3)) *
                                        ldc + gr * w.dc;
        product_t<E, kTcKeys / 8, true, kWideSets>(
            s, a, ldq, sK + (i & 1) * kTcKeys * ldc + gr * w.dc, ldc, nk, g,
            t);
      }
    }
    if (busy) put_part(sS + warp * kSPart, s);
    cp_async_wait<1>();
    __syncthreads();  // v tile j and both parts of s are in shared memory
    if (busy) {
      add_part(s, sS + (warp ^ 4) * kSPart);
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
      // o = o alpha + p.v over the group's columns.
      product_rows<E, NT, kTcKeys>(o, s, sV + gr * w.oc, ldv, n_ct, alpha[0],
                                   alpha[1], g, t);
    }
  }

  const float la = fmaxf(l[0], 1e-30f), lb = fmaxf(l[1], 1e-30f);
  store_frags<E, NT>(p.o.ptr + b * p.o.sb + hD, p.o.st, wrow,
                     cb + gr * w.oc, n_ct, p.T, D, o, la, lb, g, t);
  if (bc == 0 && gr == 0 && t == 0) {
    float* lse = p.lse + ((long long)b * p.H + h) * p.T;
    if (wrow + g < p.T) lse[wrow + g] = m[0] + logf(la);
    if (wrow + g + 8 < p.T) lse[wrow + g + 8] = m[1] + logf(lb);
  }
}

// W2: dk and dv (two column chunks of each, one a warp group) for 64 key
// rows.  Warps w and w + 4 own the same 16 keys; each forms s^T and dp^T
// over its half of every step's columns, and they add their parts
// through shared memory.  NT: 8-column tiles of dk and dv a warp holds,
// at least oc / 8.
template <typename E, int NT>
__global__ void __launch_bounds__(kWideTcThreads)
    flash_bwd_dkdv_wide_kernel(const WideTcParams<E> w) {
  constexpr int BQ = kTcQueries;
  constexpr int kStepRows = 2 * kTcRows + 2 * BQ;  // k, v, q, dO
  static_assert(BQ == 32, "partial s tiles are 16 x 32");
  const GenParams<E>& p = w.g;
  extern __shared__ uint4 wsm_tc[];
  const int D = p.D, d8 = gen_d8(D);
  const int ldc = gen_tc_ld(2 * w.dc, sizeof(E));
  const int ldo = gen_tc_ld(2 * w.oc, sizeof(E));
  E* sC = reinterpret_cast<E*>(wsm_tc);  // two buffers of kStepRows rows
  float* sL = reinterpret_cast<float*>(sC + 2 * kStepRows * ldc);  // lse
  float* sD = sL + BQ;                                  // delta
  float* sS = sD + BQ;  // partial s^T (8 warps), then dp^T (8 warps)
  E* sQo = reinterpret_cast<E*>(sS + 16 * kSPart);  // the q tile's
  E* sOo = sQo + BQ * ldo;  // and the dO tile's columns, last
  const int n_bc = wide_block_chunks(D, w.oc);
  const int kb = blockIdx.x / n_bc, bc = blockIdx.x - kb * n_bc;
  const int k0 = kb * kTcRows;  // low keys have the most work: first
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, gr = warp >> 2;
  const int cb = 2 * bc * w.oc;  // the block's columns
  const int cb_cols = min(2 * w.oc, d8 - cb);
  const int n_ct = max(min(w.oc, d8 - cb - gr * w.oc), 0) / 8;  // own
  const int wkey = k0 + 16 * (warp & 3);  // the warp's first key row
  const long long hD = (long long)h * D;
  const long long bh = (long long)b * p.H + h;
  const E* gq = p.q.ptr + b * p.q.sb + hD;
  const E* gk = p.k.ptr + b * p.k.sb + hD;
  const E* gv = p.v.ptr + b * p.v.sb + hD;
  const E* go = p.dout.ptr + b * p.dout.sb + hD;
  const int i_begin = p.causal ? k0 / BQ : 0;
  const int i_end = k0 < p.lim ? (p.lim + BQ - 1) / BQ : 0;
  const int n_dc = (d8 + 2 * w.dc - 1) / (2 * w.dc);
  const int n_steps = max(i_end - i_begin, 0) * n_dc;
  // Step i: columns 2 dc (i % n_dc) .. of the block's k and v rows and
  // of q tile i_begin + i / n_dc and its dO, into buffer i & 1.
  auto stage_step = [&](int i) {
    const int it = i / n_dc, d0 = (i - it * n_dc) * 2 * w.dc;
    const int cols = min(2 * w.dc, d8 - d0), q0 = (i_begin + it) * BQ;
    E* s = sC + (i & 1) * kStepRows * ldc;
    stage_halves(s, ldc, gk + d0, p.k.st, k0, kTcRows, p.lim, D - d0, cols,
                 p.vec);
    stage_halves(s + kTcRows * ldc, ldc, gv + d0, p.v.st, k0, kTcRows,
                 p.lim, D - d0, cols, p.vec);
    stage_halves(s + 2 * kTcRows * ldc, ldc, gq + d0, p.q.st, q0, BQ, p.lim,
                 D - d0, cols, p.vec);
    stage_halves(s + (2 * kTcRows + BQ) * ldc, ldc, go + d0, p.dout.st, q0,
                 BQ, p.lim, D - d0, cols, p.vec);
  };
  if (n_steps > 0) stage_step(0);
  cp_async_commit();

  float dk[NT][4], dv[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) dk[nt][c] = dv[nt][c] = 0.f;
  for (int it = i_begin; it < i_end; ++it) {
    const int q0 = it * BQ;
    const bool busy = wkey < p.lim && !(p.causal && q0 + BQ - 1 < wkey);
    // s^T = k.q^T and dp^T = v.dO^T: 16 keys x BQ queries; this warp's
    // part, step by step over its columns.
    float st[BQ / 8][4] = {}, dp[BQ / 8][4] = {};
    for (int d = 0; d < n_dc; ++d) {
      const int i = (it - i_begin) * n_dc + d;
      cp_async_wait<0>();
      __syncthreads();  // step i is in buffer i & 1; every warp is done
      //                   with step i - 1 and, at d 0, with q tile it - 1
      if (d == 0) {
        stage_halves(sQo, ldo, gq + cb, p.q.st, q0, BQ, p.lim, D - cb,
                     cb_cols, p.vec);
        stage_halves(sOo, ldo, go + cb, p.dout.st, q0, BQ, p.lim, D - cb,
                     cb_cols, p.vec);
        stage_vals(gr ? sD : sL, (gr ? p.delta : p.lse) + bh * p.T, q0, BQ,
                   p.T, static_cast<int>(threadIdx.x % kGenThreads));
      }
      cp_async_commit();
      if (i + 1 < n_steps) stage_step(i + 1);
      cp_async_commit();
      const int nk = wide_half_steps(d8 - d * 2 * w.dc, gr * w.dc, w.dc);
      if (busy && nk > 0) {
        const E* c = sC + (i & 1) * kStepRows * ldc + gr * w.dc;
        product_t<E, BQ / 8, true, kWideSets>(
            st, c + 16 * (warp & 3) * ldc, ldc, c + 2 * kTcRows * ldc, ldc,
            nk, g, t);
        product_t<E, BQ / 8, true, kWideSets>(
            dp, c + (kTcRows + 16 * (warp & 3)) * ldc, ldc,
            c + (2 * kTcRows + BQ) * ldc, ldc, nk, g, t);
      }
    }
    if (busy) {
      put_part(sS + warp * kSPart, st);
      put_part(sS + (8 + warp) * kSPart, dp);
    }
    cp_async_wait<1>();
    __syncthreads();  // the q and dO tiles' columns, lse, delta and both
    //                   parts of s^T and dp^T are in shared memory
    if (busy) {
      add_part(st, sS + (warp ^ 4) * kSPart);
      add_part(dp, sS + (8 + (warp ^ 4)) * kSPart);
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
      // dk += ds^T q and dv += p^T dO over the group's columns.
      product_rows<E, NT, BQ>(dk, dp, sQo + gr * w.oc, ldo, n_ct, 1.f, 1.f,
                              g, t);
      product_rows<E, NT, BQ>(dv, st, sOo + gr * w.oc, ldo, n_ct, 1.f, 1.f,
                              g, t);
    }
  }

  const int c0 = cb + gr * w.oc;
  store_frags<E, NT>(p.dk.ptr + b * p.dk.sb + hD, p.dk.st, wkey, c0, n_ct,
                     p.T, D, dk, 1.f, 1.f, g, t);
  store_frags<E, NT>(p.dv.ptr + b * p.dv.sb + hD, p.dv.st, wkey, c0, n_ct,
                     p.T, D, dv, 1.f, 1.f, g, t);
}

// W3: dq (two column chunks of it, one a warp group) for 64 query rows,
// k and v streamed kW3Keys = 64 rows a tile.  Warps w and w + 4 own the
// same 16 rows and split the tile's keys: each forms dp = dO.v^T and
// s = q.k^T for its 32 keys over all of every step's columns, then ds;
// the two exchange ds through shared memory, and each adds ds.k of both
// halves to its chunk of dq.  NT: 8-column tiles of dq a warp holds, at
// least oc / 8.
template <typename E, int NT>
__global__ void __launch_bounds__(kWideTcThreads)
    flash_bwd_dq_wide_kernel(const WideTcParams<E> w) {
  static_assert(kTcKeys == 32, "a warp's s and dp tiles are 16 x 32");
  const GenParams<E>& p = w.g;
  extern __shared__ uint4 wsm_tc[];
  const int D = p.D, d8 = gen_d8(D);
  const int ldc = gen_tc_ld(2 * w.dc, sizeof(E));
  const int ldq = w.q_res ? gen_tc_ld(D, sizeof(E)) : ldc;
  const int ldk = gen_tc_ld(2 * w.oc, sizeof(E));
  // q and dO rows: resident, 64 each, or two buffers of a step's 64 q
  // and 64 dO rows; then two buffers of a step's 64 k and 64 v rows.
  E* sQ = reinterpret_cast<E*>(wsm_tc);
  E* sKV = sQ + 2 * kTcRows * (w.q_res ? ldq : 2 * ldc);
  float* sS = reinterpret_cast<float*>(sKV + 4 * kW3Keys * ldc);  // ds
  E* sKo = reinterpret_cast<E*>(sS + 8 * kSPart);  // last: ds.k reads past
  const int n_bc = wide_block_chunks(D, w.oc);
  const int rb = blockIdx.x / n_bc, bc = blockIdx.x - rb * n_bc;
  const int q0 = (gridDim.x / n_bc - 1 - rb) * kTcRows;  // heaviest first
  const int h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3, gr = warp >> 2;
  const int cb = 2 * bc * w.oc;  // the block's columns
  const int cb_cols = min(2 * w.oc, d8 - cb);
  const int n_ct = max(min(w.oc, d8 - cb - gr * w.oc), 0) / 8;  // own
  const int wrow = q0 + 16 * (warp & 3);  // the warp's first query row
  const long long hD = (long long)h * D;
  const long long bh = (long long)b * p.H + h;
  const E* gq = p.q.ptr + b * p.q.sb + hD;
  const E* gk = p.k.ptr + b * p.k.sb + hD;
  const E* gv = p.v.ptr + b * p.v.sb + hD;
  const E* go = p.dout.ptr + b * p.dout.sb + hD;
  int n_kv = q0 < p.lim ? (p.lim + kW3Keys - 1) / kW3Keys : 0;
  if (p.causal) n_kv = min(n_kv, (q0 + kTcRows - 1) / kW3Keys + 1);
  const int n_dc = (d8 + 2 * w.dc - 1) / (2 * w.dc);
  const int n_steps = n_kv * n_dc;
  // Step i: columns 2 dc (i % n_dc) .. of k and v tile i / n_dc (and of
  // the q and dO rows unless they are resident), into buffer i & 1.
  auto stage_step = [&](int i) {
    const int j = i / n_dc, d0 = (i - j * n_dc) * 2 * w.dc;
    const int cols = min(2 * w.dc, d8 - d0);
    if (!w.q_res) {
      E* s = sQ + (i & 1) * 2 * kTcRows * ldc;
      stage_halves(s, ldc, gq + d0, p.q.st, q0, kTcRows, p.lim, D - d0,
                   cols, p.vec);
      stage_halves(s + kTcRows * ldc, ldc, go + d0, p.dout.st, q0, kTcRows,
                   p.lim, D - d0, cols, p.vec);
    }
    E* s = sKV + (i & 1) * 2 * kW3Keys * ldc;
    stage_halves(s, ldc, gk + d0, p.k.st, j * kW3Keys, kW3Keys, p.lim,
                 D - d0, cols, p.vec);
    stage_halves(s + kW3Keys * ldc, ldc, gv + d0, p.v.st, j * kW3Keys,
                 kW3Keys, p.lim, D - d0, cols, p.vec);
  };
  if (n_steps > 0) {
    if (w.q_res) {
      stage_halves(sQ, ldq, gq, p.q.st, q0, kTcRows, p.lim, D, d8, p.vec);
      stage_halves(sQ + kTcRows * ldq, ldq, go, p.dout.st, q0, kTcRows,
                   p.lim, D, d8, p.vec);
    }
    stage_step(0);
  }
  cp_async_commit();
  // lse and delta of rows g (r 0) and g + 8 (r 1); rows at or past T read
  // as 0 (the mask hides them).
  float lse[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wrow + g + 8 * r;
    lse[r] = row < p.T ? p.lse[bh * p.T + row] : 0.f;
    delta[r] = row < p.T ? p.delta[bh * p.T + row] : 0.f;
  }

  float dq[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) dq[nt][c] = 0.f;
  const int r = 16 * (warp & 3);
  for (int j = 0; j < n_kv; ++j) {
    // The warp's keys: k0 .. k0 + 31; its partner's: k0 ^ 32 .. + 31.
    const int k0 = j * kW3Keys + kTcKeys * gr, k1 = k0 ^ kTcKeys;
    const bool busy = wrow < p.lim && k0 < p.lim &&
                      !(p.causal && k0 > wrow + 15);
    const bool busy1 = wrow < p.lim && k1 < p.lim &&
                       !(p.causal && k1 > wrow + 15);
    // dp = dO.v^T and s = q.k^T: 16 rows x the warp's keys, n-tile nt =
    // keys k0 + 8 nt .. k0 + 8 nt + 7, step by step over D.
    float dp[kTcKeys / 8][4] = {}, s[kTcKeys / 8][4] = {};
    for (int d = 0; d < n_dc; ++d) {
      const int i = j * n_dc + d;
      cp_async_wait<0>();
      __syncthreads();  // step i is in buffer i & 1; every warp is done
      //                   with step i - 1 and, at d 0, with k tile j - 1
      //                   and the ds of tile j - 1
      if (d == 0)
        stage_halves(sKo, ldk, gk + cb, p.k.st, j * kW3Keys, kW3Keys, p.lim,
                     D - cb, cb_cols, p.vec);
      cp_async_commit();
      if (i + 1 < n_steps) stage_step(i + 1);
      cp_async_commit();
      const int nk = min(2 * w.dc, d8 - d * 2 * w.dc) / 8;
      if (busy) {
        const E* aq = w.q_res ? sQ + r * ldq + d * 2 * w.dc
                              : sQ + ((i & 1) * 2 * kTcRows + r) * ldc;
        const E* kv = sKV + ((i & 1) * 2 * kW3Keys + kTcKeys * gr) * ldc;
        product_t<E, kTcKeys / 8, true, kWideSets>(
            dp, aq + kTcRows * ldq, ldq, kv + kW3Keys * ldc, ldc, nk, g, t);
        product_t<E, kTcKeys / 8, true, kWideSets>(s, aq, ldq, kv, ldc, nk,
                                                   g, t);
      }
    }
    if (busy) {
      // p = exp(s scale - lse) (0 where masked), ds = p (dp - delta)
      // scale rounded to E; dp now holds ds, for the partner too.
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
      put_part(sS + warp * kSPart, dp);
    }
    cp_async_wait<1>();
    __syncthreads();  // k tile j's columns and both warps' ds are in
    //                   shared memory
    // dq += ds.k over the group's columns: the warp's keys, then its
    // partner's.
    const E* ko = sKo + gr * w.oc;
    if (busy)
      product_rows<E, NT, kTcKeys>(dq, dp, ko + kTcKeys * gr * ldk, ldk,
                                   n_ct, 1.f, 1.f, g, t);
    if (busy1) {
      get_part(s, sS + (warp ^ 4) * kSPart);
      product_rows<E, NT, kTcKeys>(dq, s, ko + kTcKeys * (gr ^ 1) * ldk,
                                   ldk, n_ct, 1.f, 1.f, g, t);
    }
  }

  store_frags<E, NT>(p.dq.ptr + b * p.dq.sb + hD, p.dq.st, wrow,
                     cb + gr * w.oc, n_ct, p.T, D, dq, 1.f, 1.f, g, t);
}

// Columns of o (W1, kernel 0), dk and dv (W2, 1) or dq (W3, 2) a warp may
// hold: the instantiations' largest NT.
__host__ __device__ inline int wide_max_oc(int kernel) {
  return kernel == 0 ? 256 : kernel == 1 ? 128 : 192;
}

template <typename E>
cudaError_t launch_wide_tc(int kernel, const WideTcParams<E>& w, int B,
                           int smem, cudaStream_t stream) {
  void (*fn)(const WideTcParams<E>);
  if (kernel == 0)
    fn = w.oc <= 128   ? flash_fwd_wide_kernel<E, 16>
         : w.oc <= 192 ? flash_fwd_wide_kernel<E, 24>
                       : flash_fwd_wide_kernel<E, 32>;
  else if (kernel == 1)
    fn = w.oc <= 64 ? flash_bwd_dkdv_wide_kernel<E, 8>
                    : flash_bwd_dkdv_wide_kernel<E, 16>;
  else
    fn = w.oc <= 128 ? flash_bwd_dq_wide_kernel<E, 16>
                     : flash_bwd_dq_wide_kernel<E, 24>;
  const int blocks =
      (w.g.T + kTcRows - 1) / kTcRows * wide_block_chunks(w.g.D, w.oc);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  fn<<<dim3(blocks, w.g.H, B), kWideTcThreads, smem, stream>>>(w);
  return cudaGetLastError();
}

// ptrs: q, k, v, dout, o, dq, dk, dv (null where a kernel has none);
// strides: (batch, row) of each, in the same order, in elements; dtype:
// 0 f32, 1 fp16, 2 bf16; vec, oc, dc, q_res and smem_bytes: the plan of
// ops/_cuda.py:wide_plan, checked here.
inline int run_wide_tc(int kernel, int dtype, const void* const* ptrs,
                       const long long* strides, const void* lse,
                       const void* delta, int B, int H, int T, int D,
                       int seq_len, int causal, float scale, int vec, int oc,
                       int dc, int q_res, int smem_bytes, void* stream) {
  const int es = dtype == 0 ? 4 : 2;
  if (dtype < 0 || dtype > 2 || D < 1 || T < 1 || oc < 8 || oc % 8 ||
      oc > wide_max_oc(kernel) || dc < 8 || dc % 8 || q_res < 0 ||
      q_res > (kernel != 1) ||
      smem_bytes != wide_tc_smem_bytes(kernel, D, es, oc, dc, q_res) ||
      !copies_fit(kernel, ptrs, strides, D, es, vec))
    return cudaErrorInvalidValue;
  if (H > 65535 || B > 65535) return cudaErrorInvalidConfiguration;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_wide_tc(kernel, WideTcParams<float>{gen_params<float>(
          ptrs, strides, lse, delta, H, T, D, seq_len, causal, scale, vec),
          oc, dc, q_res}, B, smem_bytes, s);
    case 1:
      return launch_wide_tc(kernel, WideTcParams<__half>{gen_params<__half>(
          ptrs, strides, lse, delta, H, T, D, seq_len, causal, scale, vec),
          oc, dc, q_res}, B, smem_bytes, s);
    default:
      return launch_wide_tc(kernel, WideTcParams<bf16>{gen_params<bf16>(
          ptrs, strides, lse, delta, H, T, D, seq_len, causal, scale, vec),
          oc, dc, q_res}, B, smem_bytes, s);
  }
}

}  // namespace htt

// W1.  q, k, v: (B, T, H*D) views of dtype `dtype` (0 f32, 1 fp16, 2 bf16)
// with unit column stride; o: the same; lse: (B, H, T) f32.  vec (the
// staging copy width), oc, dc, q_res and smem_bytes are the plan of
// horovod_tpu_torch/ops/_cuda.py:wide_plan, checked here.  Returns the
// CUDA error code of the launch.
extern "C" int htt_flash_fwd_wide(
    int dtype, const void* q, long long q_sb, long long q_st, const void* k,
    long long k_sb, long long k_st, const void* v, long long v_sb,
    long long v_st, void* o, long long o_sb, long long o_st, void* lse,
    int B, int H, int T, int D, int seq_len, int causal, float scale,
    int vec, int oc, int dc, int q_res, int smem_bytes, void* stream) {
  const void* ptrs[8] = {q, k, v, nullptr, o, nullptr, nullptr, nullptr};
  const long long strides[16] = {q_sb, q_st, k_sb, k_st, v_sb, v_st, 0, 0,
                                 o_sb, o_st, 0, 0, 0, 0, 0, 0};
  return htt::run_wide_tc(0, dtype, ptrs, strides, lse, nullptr, B, H, T, D,
                          seq_len, causal, scale, vec, oc, dc, q_res,
                          smem_bytes, stream);
}

// W2.  Inputs as W1 plus dout and lse, delta (B, H, T) f32; dk, dv:
// (B, T, H*D) views of the same dtype, written in full; q_res is 0.
extern "C" int htt_flash_bwd_dkdv_wide(
    int dtype, const void* q, long long q_sb, long long q_st, const void* k,
    long long k_sb, long long k_st, const void* v, long long v_sb,
    long long v_st, const void* dout, long long do_sb, long long do_st,
    const void* lse, const void* delta, void* dk, long long dk_sb,
    long long dk_st, void* dv, long long dv_sb, long long dv_st, int B,
    int H, int T, int D, int seq_len, int causal, float scale, int vec,
    int oc, int dc, int q_res, int smem_bytes, void* stream) {
  const void* ptrs[8] = {q, k, v, dout, nullptr, nullptr, dk, dv};
  const long long strides[16] = {q_sb, q_st, k_sb, k_st, v_sb, v_st,
                                 do_sb, do_st, 0, 0, 0, 0, dk_sb, dk_st,
                                 dv_sb, dv_st};
  return htt::run_wide_tc(1, dtype, ptrs, strides, lse, delta, B, H, T, D,
                          seq_len, causal, scale, vec, oc, dc, q_res,
                          smem_bytes, stream);
}

// W3.  Inputs as W2; dq: a (B, T, H*D) view of the same dtype, written
// in full; vec, oc, dc, q_res and smem_bytes as W1's.
extern "C" int htt_flash_bwd_dq_wide(
    int dtype, const void* q, long long q_sb, long long q_st, const void* k,
    long long k_sb, long long k_st, const void* v, long long v_sb,
    long long v_st, const void* dout, long long do_sb, long long do_st,
    const void* lse, const void* delta, void* dq, long long dq_sb,
    long long dq_st, int B, int H, int T, int D, int seq_len, int causal,
    float scale, int vec, int oc, int dc, int q_res, int smem_bytes,
    void* stream) {
  const void* ptrs[8] = {q, k, v, dout, nullptr, dq, nullptr, nullptr};
  const long long strides[16] = {q_sb, q_st, k_sb, k_st, v_sb, v_st,
                                 do_sb, do_st, 0, 0, dq_sb, dq_st, 0, 0,
                                 0, 0};
  return htt::run_wide_tc(2, dtype, ptrs, strides, lse, delta, B, H, T, D,
                          seq_len, causal, scale, vec, oc, dc, q_res,
                          smem_bytes, stream);
}
