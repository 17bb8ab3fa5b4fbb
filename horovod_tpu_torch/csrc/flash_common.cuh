// Shared pieces of the flash-attention kernels: tile loads, mma.sync
// fragment loads and the mask.  Included by flash_fwd.cu and flash_bwd.cu.
//
// Layout contract (all three kernels): every bf16 operand is a (B, T, H*D)
// view with unit column stride, a row stride `st` and a batch stride `sb`
// (both in elements, multiples of 8).  Head h of an operand starts at
// column h*D of its view, so q, k and v may be three column regions of one
// fused (B, T, 3C) projection and dq, dk, dv three regions of one gradient.
// lse and delta are contiguous (B, H, T) f32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace htt {

typedef __nv_bfloat16 bf16;

constexpr int kTile = 64;      // rows per tile on both the q and kv side
constexpr int kThreads = 128;  // 4 warps; warp w owns rows 16w..16w+15
constexpr int kPad = 8;        // bf16 of padding per shared-memory row
// _NEG_BIG of horovod_tpu/parallel/ring_attention.py: -0.7 * f32 max,
// taken in double and rounded once to f32, as PyTorch rounds the Python
// float, so fully masked rows get bit-identical lse in kernel and plain.
constexpr float kNegBig = static_cast<float>(-0.7 * 3.40282346638528859812e+38);

struct View {
  const bf16* ptr;
  long long sb;  // batch stride, elements
  long long st;  // row stride, elements
};

struct OutView {
  bf16* ptr;
  long long sb;
  long long st;
};

// The mask of _block_mask (flash_attention.py:169): causal, plus the real
// length `lim` on rows and columns.  lim is seq_len, or T when none is
// given, which also masks the ragged tail of the last tile.
__device__ __forceinline__ bool visible(int row, int col, int causal,
                                        int lim) {
  return (!causal || col <= row) && row < lim && col < lim;
}

// Copy rows row0..row0+63 (all D columns) of one head into shared memory
// with row stride D + kPad; rows at or past T are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(bf16* s, const bf16* g,
                                          long long st, int row0, int T) {
  constexpr int kVec = D / 8;  // 16-byte vectors per row
  constexpr int LD = D + kPad;
  for (int i = threadIdx.x; i < kTile * kVec; i += kThreads) {
    const int r = i / kVec;
    const int c = (i % kVec) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < T)
      v = *reinterpret_cast<const uint4*>(g + (long long)(row0 + r) * st + c);
    *reinterpret_cast<uint4*>(s + r * LD + c) = v;
  }
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(const bf16* lo,
                                              const bf16* hi) {
  const uint32_t a = *reinterpret_cast<const uint16_t*>(lo);
  const uint32_t b = *reinterpret_cast<const uint16_t*>(hi);
  return a | (b << 16);
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// A operand (16x16, row major) at (row0, k0) of a row-major smem matrix.
template <int LD>
__device__ __forceinline__ void frag_a(uint32_t a[4], const bf16* s,
                                       int row0, int k0, int lane) {
  const bf16* p = s + (row0 + (lane >> 2)) * LD + k0 + 2 * (lane & 3);
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * LD);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * LD + 8);
}

// B operand (16x8, k by n) from a smem matrix stored [n][k]: the pairs
// along k are contiguous.
template <int LD>
__device__ __forceinline__ void frag_b_nk(uint32_t b[2], const bf16* s,
                                          int n0, int k0, int lane) {
  const bf16* p = s + (n0 + (lane >> 2)) * LD + k0 + 2 * (lane & 3);
  b[0] = ld32(p);
  b[1] = ld32(p + 8);
}

// B operand (16x8, k by n) from a smem matrix stored [k][n]: gathered.
template <int LD>
__device__ __forceinline__ void frag_b_kn(uint32_t b[2], const bf16* s,
                                          int k0, int n0, int lane) {
  const bf16* p = s + (k0 + 2 * (lane & 3)) * LD + n0 + (lane >> 2);
  b[0] = pack_bf16(p, p + LD);
  b[1] = pack_bf16(p + 8 * LD, p + 9 * LD);
}

// A operand for k-step kk taken from two f32 accumulator tiles (16x8 each,
// columns 16kk..16kk+15), rounded to bf16: the register layout of the
// accumulator of one product is the A layout of the next.
__device__ __forceinline__ void acc_to_a(uint32_t a[4], const float c0[4],
                                         const float c1[4]) {
  a[0] = pack_f32(c0[0], c0[1]);
  a[1] = pack_f32(c0[2], c0[3]);
  a[2] = pack_f32(c1[0], c1[1]);
  a[3] = pack_f32(c1[2], c1[3]);
}

// c += a * b on the tensor cores, bf16 in, f32 accumulate.
__device__ __forceinline__ void mma(float c[4], const uint32_t a[4],
                                    const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Store one warp's 16 x D f32 accumulator as bf16 rows row0.. of a view
// (rows at or past T are dropped).
template <int D>
__device__ __forceinline__ void store_rows(bf16* g, long long st, int row0,
                                           int T, float (&acc)[D / 8][4],
                                           int lane) {
  const int r = row0 + (lane >> 2);
  const int c = 2 * (lane & 3);
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    if (r < T)
      *reinterpret_cast<uint32_t*>(g + (long long)r * st + nt * 8 + c) =
          pack_f32(acc[nt][0], acc[nt][1]);
    if (r + 8 < T)
      *reinterpret_cast<uint32_t*>(g + (long long)(r + 8) * st + nt * 8 + c) =
          pack_f32(acc[nt][2], acc[nt][3]);
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Run `launch.template operator()<D>()` for a head size D that is a
// multiple of 16 up to 128; returns cudaErrorInvalidValue otherwise.
template <typename F>
inline cudaError_t dispatch_d(int D, const F& launch) {
  switch (D) {
    case 16: return launch.template operator()<16>();
    case 32: return launch.template operator()<32>();
    case 48: return launch.template operator()<48>();
    case 64: return launch.template operator()<64>();
    case 80: return launch.template operator()<80>();
    case 96: return launch.template operator()<96>();
    case 112: return launch.template operator()<112>();
    case 128: return launch.template operator()<128>();
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace htt
