// Int8 block codec (port kernels P4 int8_quantize and P5 int8_dequantize)
// for Hopper, sm_90a.
//
// Replaces: horovod_tpu/ops/quantized_collectives.py:_quant_kernel (via
// _pallas_quantize and quantize_blocks) and _deq_kernel (via
// _pallas_dequantize and dequantize_blocks).
//
// What it computes, per 1024-element block of f32:
//   scale = absmax > 0 ? max(absmax * f32(1/127), FLT_MIN) : 1
//   q     = round_half_even(clip(x * (1 / scale), -127, 127))   (int8)
// and back: x' = float(q) * scale.  Bit-exact with the JAX codec, with
// cpp/htpu/quantize.cc and with the plain PyTorch versions
// (_quantize_plain, _dequantize_plain in ops/quantized_collectives.py).
// That needs explicit rounding: every product is __fmul_rn (so nvcc cannot
// contract anything into an FMA), the reciprocal is the IEEE division
// __fdiv_rn, and the round is __float2int_rn (ties to even) after the
// clamp.  The build uses no --use_fast_math, so subnormals are kept.
//
// What bounds it: memory.  Each element moves 5 bytes (f32 in and int8 out,
// or the reverse) plus 4 bytes of scale per block, one or two operations
// per byte, so at the timing shape (n = 67,108,864, the head leaf of the
// headline model) the bound is ~335.8 MB / 3.35 TB/s = ~0.100 ms.
//
// What the design does about it: one CUDA block of 256 threads per
// quantization block, so the absmax reduction never leaves the block.  Each
// thread loads one float4 (16 bytes, neighbouring threads on neighbouring
// addresses), reduces with warp shuffles and then across the 8 warps in
// shared memory; thread 0 writes the scale and its reciprocal, and each
// thread writes its 4 int8 as one char4.  Dequantize is the same grid the
// other way.  Not yet done: several blocks per CUDA block and wider stores,
// which the memory rate may need to be approached.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockElems = 1024;
constexpr int kThreads = kBlockElems / 4;  // one float4 per thread
constexpr int kWarps = kThreads / 32;
constexpr float kInv127 = 1.0f / 127.0f;   // f32(1) / f32(127)
constexpr float kMinScale = 1.17549435e-38f;  // FLT_MIN

__device__ __forceinline__ signed char quant_one(float x, float inv) {
  float v = __fmul_rn(x, inv);
  v = fminf(fmaxf(v, -127.0f), 127.0f);
  return static_cast<signed char>(__float2int_rn(v));
}

__global__ void __launch_bounds__(kThreads)
    int8_quantize_kernel(const float4* __restrict__ x,
                         char4* __restrict__ q,
                         float* __restrict__ scales) {
  __shared__ float warp_max[kWarps];
  __shared__ float block_inv;
  const long long b = blockIdx.x;
  const int t = threadIdx.x;
  const float4 v = x[b * kThreads + t];
  float m = fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)),
                  fmaxf(fabsf(v.z), fabsf(v.w)));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  }
  if ((t & 31) == 0) warp_max[t >> 5] = m;
  __syncthreads();
  if (t == 0) {
    float absmax = warp_max[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) absmax = fmaxf(absmax, warp_max[w]);
    const float scale =
        absmax > 0.0f ? fmaxf(__fmul_rn(absmax, kInv127), kMinScale) : 1.0f;
    scales[b] = scale;
    block_inv = __fdiv_rn(1.0f, scale);
  }
  __syncthreads();
  const float inv = block_inv;
  char4 out;
  out.x = quant_one(v.x, inv);
  out.y = quant_one(v.y, inv);
  out.z = quant_one(v.z, inv);
  out.w = quant_one(v.w, inv);
  q[b * kThreads + t] = out;
}

__global__ void __launch_bounds__(kThreads)
    int8_dequantize_kernel(const char4* __restrict__ q,
                           const float* __restrict__ scales,
                           float4* __restrict__ out) {
  const long long b = blockIdx.x;
  const int t = threadIdx.x;
  const float s = scales[b];
  const char4 c = q[b * kThreads + t];
  out[b * kThreads + t] = make_float4(
      __fmul_rn(static_cast<float>(c.x), s),
      __fmul_rn(static_cast<float>(c.y), s),
      __fmul_rn(static_cast<float>(c.z), s),
      __fmul_rn(static_cast<float>(c.w), s));
}

}  // namespace

// x: (blocks, 1024) f32, 16-byte aligned.  Writes q (blocks, 1024) int8 and
// scales (blocks) f32.  Returns the CUDA error of the launch.
extern "C" int htt_int8_quantize(const void* x, void* q, void* scales,
                                 long long blocks, void* stream) {
  int8_quantize_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(x), static_cast<char4*>(q),
      static_cast<float*>(scales));
  return static_cast<int>(cudaGetLastError());
}

// q: (blocks, 1024) int8, scales (blocks) f32.  Writes out (blocks, 1024)
// f32, 16-byte aligned.
extern "C" int htt_int8_dequantize(const void* q, const void* scales,
                                   void* out, long long blocks,
                                   void* stream) {
  int8_dequantize_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const char4*>(q), static_cast<const float*>(scales),
      static_cast<float4*>(out));
  return static_cast<int>(cudaGetLastError());
}
