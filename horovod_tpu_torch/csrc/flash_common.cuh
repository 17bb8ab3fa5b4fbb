// Shared pieces of the flash-attention kernels: the mask, the _NEG_BIG
// constant, the output view, bf16 packing and the quad reductions.
// The Hopper kernels P1-P3 and P6 add the TMA, mbarrier and wgmma pieces
// of hopper.cuh; the general family G1-G3 (flash_general.cu) needs only
// these.
//
// Layout contract (all kernels): every operand is a (B, T, H*D) view with
// unit column stride, a row stride `st` and a batch stride `sb` (both in
// elements).  Head h of an operand starts at column h*D of its view, so q,
// k and v may be three column regions of one fused (B, T, 3C) projection
// and dq, dk, dv three regions of one gradient.  lse and delta are
// contiguous (B, H, T) f32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace htt {

typedef __nv_bfloat16 bf16;

// _NEG_BIG of horovod_tpu/parallel/ring_attention.py: -0.7 * f32 max,
// taken in double and rounded once to f32, as PyTorch rounds the Python
// float, so fully masked rows get bit-identical lse in kernel and plain.
constexpr float kNegBig = static_cast<float>(-0.7 * 3.40282346638528859812e+38);

// A (B, T, C) bf16 output view.
struct OutView {
  bf16* ptr;
  long long sb;  // batch stride, elements
  long long st;  // row stride, elements
};

// The mask of _block_mask (flash_attention.py:169): causal, plus the real
// length `lim` on rows and columns.  lim is seq_len, or T when none is
// given, which also masks the ragged tail of the last tile.
__device__ __forceinline__ bool visible(int row, int col, int causal,
                                        int lim) {
  return (!causal || col <= row) && row < lim && col < lim;
}

__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

}  // namespace htt
