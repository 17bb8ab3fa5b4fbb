// The tensor-core pieces of the general family G1-G3 (flash_general.cu)
// and of the wide route's W1 and W2 (flash_wide.cu): the block geometry,
// the launch parameters, staging by cp.async, the fragments of
// mma.sync.m16n8k8 with TF32 operands, the split TF32 product ("3xTF32"
// for f32, one product for fp16 and bf16) and the two products built on
// it (product_t: a tile times another's transpose; product_rows: C
// fragments times a tile, each tile's part summed from 0 and added in
// f32).  flash_general.cu explains the method and its numerics.
#pragma once

#include <cuda_fp16.h>

#include <type_traits>

#include "flash_common.cuh"

namespace htt {

constexpr int kGenThreads = 128;
constexpr int kTcRows = 64;     // rows a block owns, 16 per warp
constexpr int kTcKeys = 32;     // k and v rows of a G1 or G3 tile
constexpr int kTcQueries = 32;  // q and dO rows of a G2 tile
constexpr int kSumSets = 2;     // accumulators a sum over D is dealt into
constexpr int kTileGroup = 8;   // 8-column tiles of acc summed together
constexpr int kTcSlack = 1024;  // bytes past the tiles (product_rows)

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
  int vec;               // bytes per staging copy (16, 4 or E's)
};

// The head size rounded up to a multiple of 8 (the k of m16n8k8).
__host__ __device__ inline int gen_d8(int D) { return (D + 7) & ~7; }

// Row stride, in elements of es bytes, of a staged tile: at least D8, and
// 16 bytes times an odd number.  The fragment loads read a (row g, column
// t) pattern (A, and B of q.k^T) or a (row 2t, column g) one (B of p.v or
// ds.k); with rows 16 x odd bytes apart, each reaches 32 distinct banks in
// f32 and 16 distinct words on distinct banks in fp16/bf16 (two lanes a
// word), and rows stay 16-byte aligned for cp.async.
__host__ __device__ inline int gen_tc_ld(int D, int es) {
  const int d8 = gen_d8(D);
  return (d8 * es) % 32 == 16 ? d8 : d8 + 16 / es;
}

// ---------------------------------------------------------------------------
// Staging by cp.async, fragments, the split TF32 product.

template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(src_bytes)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
                 "l"(src), "n"(kBytes), "r"(src_bytes)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

template <typename E, int kBytes>
__device__ __forceinline__ void stage_async(E* s, int ld, const E* g,
                                            long long st, int row0, int n,
                                            int T_, int D, int d8,
                                            int tid) {
  // The copy width divides every row's D elements (general_plan's rule),
  // so a chunk is whole or, past T or D, zero.
  constexpr int kPer = kBytes / static_cast<int>(sizeof(E));
  const int per_row = d8 / kPer;
  if (kGenThreads % per_row == 0) {
    // per_row divides kGenThreads, so it is a power of two.  Each thread
    // keeps one column and steps kGenThreads / per_row rows: a compare, a
    // select and the copy a chunk.
    const int shift = __ffs(per_row) - 1;
    const int dr = kGenThreads >> shift;
    const int c = (tid & (per_row - 1)) * kPer;
    int r = tid >> shift;
    const bool col_in = c < D;
    const E* src = g + (long long)(row0 + r) * st + c;
    E* dst = s + r * ld + c;
    for (; r < n; r += dr, src += dr * st, dst += dr * ld) {
      const bool in = col_in && row0 + r < T_;
      cp_async<kBytes>(dst, in ? src : g, in ? kBytes : 0);
    }
    return;
  }
  // Chunk i = tid + kGenThreads j is row r, column c: one division for
  // the first, then steps of kGenThreads chunks.
  int r = tid / per_row, c = (tid - r * per_row) * kPer;
  const int dr = kGenThreads / per_row;
  const int dc = (kGenThreads - dr * per_row) * kPer;
  for (; r < n;) {
    const bool in = row0 + r < T_ && c < D;
    cp_async<kBytes>(s + r * ld + c,
                     in ? g + (long long)(row0 + r) * st + c : g,
                     in ? kBytes : 0);
    r += dr;
    c += dc;
    if (c >= d8) {
      c -= d8;
      ++r;
    }
  }
}

// Rows row0..row0+n-1, columns 0..d8-1 of one head (at g, row stride st)
// into a shared tile of row stride ld; rows at or past T and columns at or
// past D read as 0.  vec is the copy width in bytes: 16 or 4 by cp.async
// (the caller commits and waits), else one element by plain loads.  By
// kGenThreads threads, tid 0 .. kGenThreads - 1.
template <typename E>
__device__ __forceinline__ void stage_tile(E* s, int ld, const E* g,
                                           long long st, int row0, int n,
                                           int T_, int D, int d8, int vec,
                                           int tid) {
  if (vec == 16) {
    stage_async<E, 16>(s, ld, g, st, row0, n, T_, D, d8, tid);
  } else if (vec == 4) {
    stage_async<E, 4>(s, ld, g, st, row0, n, T_, D, d8, tid);
  } else {
    for (int i = tid; i < n * d8; i += kGenThreads) {
      const int r = i / d8, c = i - r * d8;
      s[r * ld + c] = row0 + r < T_ && c < D
                          ? g[(long long)(row0 + r) * st + c]
                          : from_f32<E>(0.f);
    }
  }
}

// n f32 values of a (B, H, T) row from row0 into shared memory; rows at
// or past T read as 0.  By kGenThreads threads, as stage_tile.
__device__ __forceinline__ void stage_vals(float* s, const float* g,
                                           int row0, int n, int T_,
                                           int tid) {
  for (int i = tid; i < n; i += kGenThreads) {
    const bool in = row0 + i < T_;
    cp_async<4>(s + i, in ? g + row0 + i : g, in ? 4 : 0);
  }
}

// stage_tile and stage_vals by a block of kGenThreads threads (G1-G3).
template <typename E>
__device__ __forceinline__ void stage_tile(E* s, int ld, const E* g,
                                           long long st, int row0, int n,
                                           int T_, int D, int d8, int vec) {
  stage_tile(s, ld, g, st, row0, n, T_, D, d8, vec,
             static_cast<int>(threadIdx.x));
}
__device__ __forceinline__ void stage_vals(float* s, const float* g,
                                           int row0, int n, int T_) {
  stage_vals(s, g, row0, n, T_, static_cast<int>(threadIdx.x));
}

// x rounded to TF32 (to nearest, ties away from zero, as cvt.rna), as
// bits: half a TF32 ulp added to the magnitude, the 13 low bits dropped.
// Two integer instructions for a finite x; cvt.rna.tf32.f32 compiles to
// three on sm_90, which also keep infinities and NaNs.
__device__ __forceinline__ unsigned tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x as a TF32 operand: for f32, hi = rna(x) and lo = x - hi, exact in f32.
// The tensor cores read a TF32 operand's top 19 bits and ignore the 13 low
// ones, so lo enters the products rounded toward zero, as the small part
// of CUTLASS's 3xTF32 does: an error of ~2^-21 relative to x where
// rounding lo to nearest gives ~2^-22, the size of the lo.lo term dropped
// anyway (chip_smoke.py's f32 errors agree to three digits either way),
// for two instructions fewer a split.  fp16 and bf16 values (and p, ds
// rounded to them) are exact in TF32 and need no lo.
template <typename E>
__device__ __forceinline__ void split(float x, unsigned& hi, unsigned& lo) {
  if constexpr (std::is_same<E, float>::value) {
    hi = tf32_rna(x);
    lo = __float_as_uint(x - __uint_as_float(hi));
  } else {
    hi = __float_as_uint(x);
    lo = 0u;
  }
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a.b: three TF32 products for f32 (small ones first), one otherwise.
template <typename E>
__device__ __forceinline__ void mma3(float (&c)[4], const unsigned (&ah)[4],
                                     const unsigned (&al)[4],
                                     const unsigned (&bh)[2],
                                     const unsigned (&bl)[2]) {
  if constexpr (std::is_same<E, float>::value) {
    mma_tf32(c, ah, bl);
    mma_tf32(c, al, bh);
  }
  mma_tf32(c, ah, bh);
}

// Four 8 x 8 matrices of 16-bit values, that is 8 x 4 of 32-bit ones, from
// shared memory in one instruction: lane l gives the address of row l % 8
// of matrix l / 8 and receives, of each matrix, the 32-bit value at row
// l / 4, column l % 4: the (g, t) of an m16n8k8 TF32 fragment.
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// The A fragment at s (row 0, column 0 of a 16 x 8 block): rows g, g + 8,
// columns t, t + 4; in f32 by one ldmatrix.
template <typename E>
__device__ __forceinline__ void frag_a(unsigned (&hi)[4], unsigned (&lo)[4],
                                       const E* s, int ld, int g, int t) {
  if constexpr (std::is_same<E, float>::value) {
    const int lane = threadIdx.x & 31, m = lane >> 3;
    unsigned x[4];
    ldsm_x4(x, s + ((m & 1) * 8 + (lane & 7)) * ld + (m >> 1) * 4);
#pragma unroll
    for (int i = 0; i < 4; ++i) split<E>(__uint_as_float(x[i]), hi[i], lo[i]);
  } else {
    split<E>(to_f32(s[g * ld + t]), hi[0], lo[0]);
    split<E>(to_f32(s[(g + 8) * ld + t]), hi[1], lo[1]);
    split<E>(to_f32(s[g * ld + t + 4]), hi[2], lo[2]);
    split<E>(to_f32(s[(g + 8) * ld + t + 4]), hi[3], lo[3]);
  }
}

// The B fragments of a product with a tile's transpose (B[k][n] = s[n][k])
// for two n-tiles, rows 0-7 and 8-15 of s: row g, columns t and t + 4; in
// f32 by one ldmatrix.
template <typename E>
__device__ __forceinline__ void frag_bt2(unsigned (&hi)[2][2],
                                         unsigned (&lo)[2][2], const E* s,
                                         int ld, int g, int t) {
  if constexpr (std::is_same<E, float>::value) {
    const int lane = threadIdx.x & 31, m = lane >> 3;
    unsigned x[4];
    ldsm_x4(x, s + ((m >> 1) * 8 + (lane & 7)) * ld + (m & 1) * 4);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      split<E>(__uint_as_float(x[i]), hi[i >> 1][i & 1], lo[i >> 1][i & 1]);
  } else {
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      split<E>(to_f32(s[(8 * n + g) * ld + t]), hi[n][0], lo[n][0]);
      split<E>(to_f32(s[(8 * n + g) * ld + t + 4]), hi[n][1], lo[n][1]);
    }
  }
}

// The B fragment of a product with the tile itself (B[k][n] = s[k'][n]),
// its 8 rows in the free order that lets a C fragment feed A as it lies:
// k = t is row 2t, k = t + 4 is row 2t + 1; column g.
template <typename E>
__device__ __forceinline__ void frag_b(unsigned (&hi)[2], unsigned (&lo)[2],
                                       const E* s, int ld, int g, int t) {
  split<E>(to_f32(s[2 * t * ld + g]), hi[0], lo[0]);
  split<E>(to_f32(s[(2 * t + 1) * ld + g]), hi[1], lo[1]);
}

// A C fragment (rows g, g + 8; columns 2t, 2t + 1) as the A operand of the
// next product, columns in the order of frag_b.
template <typename E>
__device__ __forceinline__ void frag_c_as_a(unsigned (&hi)[4],
                                            unsigned (&lo)[4],
                                            const float (&c)[4]) {
  split<E>(c[0], hi[0], lo[0]);
  split<E>(c[2], hi[1], lo[1]);
  split<E>(c[1], hi[2], lo[2]);
  split<E>(c[3], hi[3], lo[3]);
}

// Columns 2t, 2t + 1 of the 8-column tiles of an accumulator (rows r0 + g
// and r0 + g + 8, first column c0), divided by div[0] (row g) and div[1]
// (row g + 8), into a (B, T, H*D) view at g_out; rows at or past T and
// columns at or past `cols` (absolute, from c0) are dropped.
template <typename E, int NT>
__device__ __forceinline__ void store_frags(E* g_out, long long st, int r0,
                                            int c0, int n_tiles, int T_,
                                            int D, const float (&acc)[NT][4],
                                            float div0, float div1, int g,
                                            int t) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    if (nt >= n_tiles) break;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int row = r0 + g + (c >> 1) * 8;
      const int col = c0 + 8 * nt + 2 * t + (c & 1);
      if (row < T_ && col < D)
        g_out[(long long)row * st + col] =
            from_f32<E>(acc[nt][c] / (c >> 1 ? div1 : div0));
    }
  }
}

// acc[nb] = the 16 rows of a (row stride lda) times the 8 rows 8 nb ..
// 8 nb + 7 of b (row stride ldb), transposed, over nk steps of 8 columns:
// s = q.k^T (G1, G3, W1), dp = dO.v^T (G3), s^T = k.q^T or dp^T = v.dO^T
// (G2, W2).  In f32 the steps are dealt round kSumSets accumulators, added
// at the end, so that more chains of dependent products are in flight
// (three products a step) and each runs a shorter sum; fp16 and bf16 (one
// product a step) keep one, which saves the registers G2 needs there.
// kAdd: the sum, taken from 0, is added to acc in f32 (W1 and W2 sum
// their products over D chunk by chunk); kF32Sets: the accumulators of
// f32.
template <typename E, int NB, bool kAdd = false, int kF32Sets = kSumSets>
__device__ __forceinline__ void product_t(float (&acc)[NB][4], const E* a,
                                          int lda, const E* b, int ldb,
                                          int nk, int g, int t) {
  static_assert(NB % 2 == 0, "B fragments load two n-tiles at a time");
  constexpr int kSets = std::is_same<E, float>::value ? kF32Sets : 1;
  float part[kSets][NB][4] = {};
  int kk = 0;
  for (; kk + kSets <= nk; kk += kSets) {
#pragma unroll
    for (int u = 0; u < kSets; ++u) {
      unsigned ah[4], al[4];
      frag_a<E>(ah, al, a + 8 * (kk + u), lda, g, t);
#pragma unroll
      for (int nb = 0; nb < NB; nb += 2) {
        unsigned bh[2][2], bl[2][2];
        frag_bt2<E>(bh, bl, b + 8 * nb * ldb + 8 * (kk + u), ldb, g,
                    t);
        mma3<E>(part[u][nb], ah, al, bh[0], bl[0]);
        mma3<E>(part[u][nb + 1], ah, al, bh[1], bl[1]);
      }
    }
  }
  for (; kk < nk; ++kk) {
    unsigned ah[4], al[4];
    frag_a<E>(ah, al, a + 8 * kk, lda, g, t);
#pragma unroll
    for (int nb = 0; nb < NB; nb += 2) {
      unsigned bh[2][2], bl[2][2];
      frag_bt2<E>(bh, bl, b + 8 * nb * ldb + 8 * kk, ldb, g, t);
      mma3<E>(part[0][nb], ah, al, bh[0], bl[0]);
      mma3<E>(part[0][nb + 1], ah, al, bh[1], bl[1]);
    }
  }
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float x = part[0][nb][c];
#pragma unroll
      for (int u = 1; u < kSets; ++u) x += part[u][nb][c];
      acc[nb][c] = kAdd ? acc[nb][c] + x : x;
    }
}

// product_t with one row stride for both tiles (G1-G3).
template <typename E, int NB>
__device__ __forceinline__ void product_t(float (&acc)[NB][4], const E* a,
                                          const E* b, int ld, int nk, int g,
                                          int t) {
  product_t<E, NB, false>(acc, a, ld, b, ld, nk, g, t);
}

// acc = acc x (f0 on row g, f1 on row g + 8) + a.tile, for the 8-column
// tiles nt < n_tiles of acc, with a: K / 8 C fragments (16 rows x 8 of the
// K rows of the shared tile each), used as A operands in the order of
// frag_b: o += p.v, dv += p^T dO, dk += ds^T q, dq += ds.k.  kTileGroup
// tiles of acc at a time take their sums over the K rows on the tensor
// cores from 0, then one f32 FMA each: the tensor cores truncate as they accumulate, so
// a long sum kept in their accumulator drifts toward 0 by about an ulp a
// product (beyond chip_smoke.py's 1e-5 over T 2048 in f32), while f32
// rounds to nearest.  A group that passes n_tiles computes tiles beyond
// it, which are never stored, from whatever lies past the tile's columns
// (kTcSlack bytes after the last tile keep those reads in bounds): a
// clamp of the tile index would cost address arithmetic on every load.
template <typename E, int NT, int K>
__device__ __forceinline__ void product_rows(float (&acc)[NT][4],
                                             const float (&a)[K / 8][4],
                                             const E* tile, int ld,
                                             int n_tiles, float f0, float f1,
                                             int g, int t) {
  static_assert(NT % kTileGroup == 0, "groups of tiles must divide NT");
  unsigned ah[K / 8][4], al[K / 8][4];
#pragma unroll
  for (int ks = 0; ks < K / 8; ++ks) frag_c_as_a<E>(ah[ks], al[ks], a[ks]);
#pragma unroll
  for (int n0 = 0; n0 < NT; n0 += kTileGroup) {
    if (n0 >= n_tiles) break;
    float part[kTileGroup][4] = {};
#pragma unroll
    for (int ks = 0; ks < K / 8; ++ks)
#pragma unroll
      for (int i = 0; i < kTileGroup; ++i) {
        unsigned bh[2], bl[2];
        frag_b<E>(bh, bl, tile + 8 * ks * ld + 8 * (n0 + i), ld, g, t);
        mma3<E>(part[i], ah[ks], al[ks], bh, bl);
      }
#pragma unroll
    for (int i = 0; i < kTileGroup; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        acc[n0 + i][c] = fmaf(acc[n0 + i][c], c >> 1 ? f1 : f0, part[i][c]);
  }
}

template <typename E>
GenParams<E> gen_params(const void* const* ptrs, const long long* strides,
                        const void* lse, const void* delta, int H, int T,
                        int D, int seq_len, int causal, float scale,
                        int vec) {
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
  p.vec = vec;
  return p;
}

// Whether a kernel may stage every row of the operands it reads (q, k, v;
// and dout for G2 and G3) with vec-byte copies: 16 or 4 where the start,
// both strides and the head's columns keep every row start vec-aligned,
// the element size always.
inline bool copies_fit(int kernel, const void* const* ptrs,
                       const long long* strides, int D, int es, int vec) {
  if (vec == es) return true;
  if (vec != 16 && vec != 4) return false;
  for (int i = 0; i < (kernel == 0 ? 3 : 4); ++i)
    if (reinterpret_cast<unsigned long long>(ptrs[i]) % vec ||
        strides[2 * i] * es % vec || strides[2 * i + 1] * es % vec ||
        static_cast<long long>(D) * es % vec)
      return false;
  return true;
}

}  // namespace htt
