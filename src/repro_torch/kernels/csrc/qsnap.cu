// qsnap — blockwise absmax int8 quantization of checkpoint state, for Hopper
// (sm_90a). Plain C interface, loaded with ctypes by
// src/repro_torch/kernels/qsnap.py.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/qsnap.py:
//   qsnap_quantize_kernel   <- _quant_kernel   (called from qsnap_quantize)
//   qsnap_dequantize_kernel <- _dequant_kernel (called from qsnap_dequantize)
//
// Contract: bit-identity with the host codec (repro_torch/ckpt/compression.py
// quantize_int8 / dequantize_int8), so device- and host-encoded QS01 payloads
// share CAS digests. Every rounding is therefore explicit:
//   scale = __fmul_rn(absmax, f32(1/127))   (1.0 when absmax == 0)
//   code  = clamp(rintf(__fdiv_rn(x, scale)), -127, 127)   rintf: half to even
//   value = __fmul_rn(f32(code), scale)     bf16 out via __float2bfloat16_rn
// Built without --use_fast_math and with --fmad=false (no FMA contraction).
// Non-finite inputs are out of contract: fmaxf drops a NaN where numpy's max
// keeps it.
//
// Bound: memory bandwidth. Quantize moves ~5 bytes per f32 element (read 4,
// write 1 code + 4/256 of a scale), ~3 per bf16 element; dequantize ~5 to
// f32, ~3 to bf16. A few flops per element are far below the card's compute
// roofline. Design: one warp per 256-element block, 8 elements a lane, lane l
// touching elements l, l+32, ..., so every load and store of the warp is one
// coalesced run; the block's absmax is a warp-shuffle max and lane 0 stores
// the scale. bf16 is read directly and widened to f32 (exact), which does
// away with the reference's separate pad-and-cast pass; the ragged tail past
// n reads as zeros, so pad codes are 0 exactly as zero padding gives.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;              // elements per scale (QS01 block)
constexpr int kPerLane = kBlock / 32;    // elements each lane handles
constexpr int kWarpsPerCta = 8;          // 256 threads, 8 blocks per CTA
constexpr int kDequantThreads = 256;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(uint16_t v) {
  return __uint_as_float(static_cast<unsigned>(v) << 16);  // bf16 -> f32
}

template <typename T>
__global__ void qsnap_quantize_kernel(const T* __restrict__ x, long long n,
                                      long long n_blocks,
                                      int8_t* __restrict__ codes,
                                      float* __restrict__ scales) {
  const float kInv127 = __uint_as_float(0x3c010204u);  // f32(1.0 / 127.0)
  const int lane = threadIdx.x & 31;
  const long long blk =
      static_cast<long long>(blockIdx.x) * kWarpsPerCta + (threadIdx.x >> 5);
  if (blk >= n_blocks) return;  // whole warp leaves together
  const long long base = blk * kBlock;
  float v[kPerLane];
  float amax = 0.f;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const long long i = base + j * 32 + lane;
    v[j] = i < n ? widen(x[i]) : 0.f;
    amax = fmaxf(amax, fabsf(v[j]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  float scale = __fmul_rn(amax, kInv127);
  if (scale == 0.f) scale = 1.f;
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    const float q = fminf(fmaxf(rintf(__fdiv_rn(v[j], scale)), -127.f), 127.f);
    codes[base + j * 32 + lane] = static_cast<int8_t>(q);
  }
  if (lane == 0) scales[blk] = scale;
}

template <bool kBf16Out>
__global__ void qsnap_dequantize_kernel(const int8_t* __restrict__ codes,
                                        const float* __restrict__ scales,
                                        long long n, void* __restrict__ out) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const float y =
        __fmul_rn(static_cast<float>(codes[i]), scales[i / kBlock]);
    if (kBf16Out)
      static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(y);
    else
      static_cast<float*>(out)[i] = y;
  }
}

}  // namespace

extern "C" {

// x: n elements, f32 (is_bf16 == 0) or bf16 bits (is_bf16 == 1).
// codes: ceil(n/256)*256 int8; scales: ceil(n/256) f32. Returns cudaError_t.
int qsnap_quantize(const void* x, int is_bf16, long long n, void* codes,
                   void* scales, void* stream) {
  const long long n_blocks = (n + kBlock - 1) / kBlock;
  if (n_blocks == 0) return 0;
  const dim3 grid(
      static_cast<unsigned>((n_blocks + kWarpsPerCta - 1) / kWarpsPerCta));
  const dim3 block(32 * kWarpsPerCta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    qsnap_quantize_kernel<uint16_t><<<grid, block, 0, s>>>(
        static_cast<const uint16_t*>(x), n, n_blocks,
        static_cast<int8_t*>(codes), static_cast<float*>(scales));
  else
    qsnap_quantize_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(x), n, n_blocks,
        static_cast<int8_t*>(codes), static_cast<float*>(scales));
  return static_cast<int>(cudaGetLastError());
}

// codes: n int8 (n % 256 == 0); scales: n/256 f32; out: n f32 or bf16.
int qsnap_dequantize(const void* codes, const void* scales, long long n,
                     void* out, int out_bf16, void* stream) {
  if (n == 0) return 0;
  long long blocks = (n + kDequantThreads - 1) / kDequantThreads;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;  // grid-stride beyond
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(blocks));
  if (out_bf16)
    qsnap_dequantize_kernel<true><<<grid, kDequantThreads, 0, s>>>(
        static_cast<const int8_t*>(codes), static_cast<const float*>(scales),
        n, out);
  else
    qsnap_dequantize_kernel<false><<<grid, kDequantThreads, 0, s>>>(
        static_cast<const int8_t*>(codes), static_cast<const float*>(scales),
        n, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
