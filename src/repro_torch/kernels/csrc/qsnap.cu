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
// write 1 code + 4/256 of a scale), ~3 per bf16 element; dequantize reads 1
// byte of code and 4/256 of a scale and writes 4 (f32) or 2 (bf16). A few
// flops per element are far below the card's compute roofline.
//
// Quantize: one warp per 256-element block, 8 elements a lane, lane l
// touching elements l, l+32, ..., so every load and store of the warp is one
// coalesced run; the block's absmax is a warp-shuffle max and lane 0 stores
// the scale. bf16 is read directly and widened to f32 (exact), which does
// away with the reference's separate pad-and-cast pass; the ragged tail past
// n reads as zeros, so pad codes are 0 exactly as zero padding gives.
//
// Dequantize: the first design gave each thread one element: a 1-byte code
// load, a 4-byte scale load with a 64-bit division, a 4- or 2-byte store.
// A full SM then kept ~2 KB of reads in flight where the card's latency and
// rate ask for ~15 KB (Little's law), so it ran at about a third of the
// bound, held by latency. This design moves 16-byte vectors:
//   * a thread loads 16 codes with one 16-byte load that bypasses L1 (each
//     code is read once), kVecsPerThread of them issued before any is used;
//     16 divides 256, so one scale load serves a vector. Neighbouring threads
//     take neighbouring vectors: each load instruction of a CTA reads one
//     contiguous 4 KB run;
//   * 16 codes expand to 64 bytes of f32 (32 of bf16). Stored straight from
//     the thread that loaded them, a warp's 16-byte stores would each land
//     in 32 separate sectors at half a sector each, which ran slower than the
//     first design. So each warp stages its 512 codes in shared memory and
//     reads them back transposed: every store instruction (float4, or 8
//     packed bf16) writes one contiguous 512-byte run, with a streaming hint;
//   * a CTA covers kDequantTile codes: a 64-bit base once, 32-bit offsets
//     inside; the grid covers every vector once (no grid-stride loop, which
//     was no faster); n % 256 == 0, so the last CTA masks whole 256-code
//     blocks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;              // elements per scale (QS01 block)
constexpr int kPerLane = kBlock / 32;    // elements each lane handles
constexpr int kWarpsPerCta = 8;          // 256 threads, 8 blocks per CTA
constexpr int kDequantThreads = 256;
constexpr int kVecCodes = 16;            // codes in one 16-byte vector
constexpr int kVecsPerScale = kBlock / kVecCodes;
constexpr int kVecsPerThread = 4;        // vector loads in flight a thread
constexpr int kTileVecs = kDequantThreads * kVecsPerThread;
constexpr int kDequantTile = kTileVecs * kVecCodes;  // codes a CTA covers

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

// One 16-byte load of codes, not kept in L1: each code is read once.
__device__ __forceinline__ uint4 load_stream(const uint4* p) {
  uint4 r;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0,%1,%2,%3}, [%4];"
      : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
      : "l"(p));
  return r;
}

// Byte k of w, a code, times its scale.
__device__ __forceinline__ float decode(uint32_t w, int k, float scale) {
  return __fmul_rn(static_cast<float>(static_cast<int8_t>(w >> (8 * k))),
                   scale);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(hi)))
             << 16;
}

__device__ __forceinline__ uint32_t decode_bf16x2(uint32_t w, int k,
                                                  float scale) {
  return pack_bf16(decode(w, k, scale), decode(w, k + 1, scale));
}

template <bool kBf16Out>
__global__ void __launch_bounds__(kDequantThreads)
    qsnap_dequantize_kernel(const int8_t* __restrict__ codes,
                            const float* __restrict__ scales,
                            long long n_vecs, void* __restrict__ out) {
  __shared__ uint4 stage[kDequantThreads];  // each warp's 512 codes
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long base = static_cast<long long>(blockIdx.x) * kTileVecs;
  const long long left = n_vecs - base;
  const int m = left < kTileVecs ? static_cast<int>(left) : kTileVecs;
  const uint4* c = reinterpret_cast<const uint4*>(codes) + base;
  const float* s = scales + base / kVecsPerScale;
  // vector j of this thread: j * kDequantThreads + threadIdx.x
  uint4 w[kVecsPerThread];
  float sc[kVecsPerThread];
#pragma unroll
  for (int j = 0; j < kVecsPerThread; ++j) {
    const int v = j * kDequantThreads + threadIdx.x;
    w[j] = make_uint4(0, 0, 0, 0);
    sc[j] = 0.f;
    if (v < m) {
      w[j] = load_stream(c + v);
      sc[j] = __ldg(s + v / kVecsPerScale);
    }
  }
  float4* out_f32 = static_cast<float4*>(out) + 4 * base;  // 4 values each
  uint4* out_bf16 = static_cast<uint4*>(out) + 2 * base;    // 8 values each
  uint4* staged = stage + warp * 32;
  const uint32_t* words = reinterpret_cast<const uint32_t*>(staged);
  const uint2* pairs = reinterpret_cast<const uint2*>(staged);
#pragma unroll
  for (int j = 0; j < kVecsPerThread; ++j) {
    // the warp's 32 vectors: codes [16 vb, 16 vb + 512), two scale blocks
    // whose scales lanes 0 and 16 hold; m is a multiple of 16, so a block
    // is valid as a whole
    const int vb = j * kDequantThreads + warp * 32;
    staged[lane] = w[j];
    __syncwarp();
    const float s0 = __shfl_sync(0xffffffffu, sc[j], 0);
    const float s1 = __shfl_sync(0xffffffffu, sc[j], 16);
    if (kBf16Out) {
      // store k: 8 values from codes [256 k + 8 lane, +8), block k
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        if (vb + kVecsPerScale * k >= m) continue;
        const uint2 q = pairs[32 * k + lane];
        const float sk = k ? s1 : s0;
        __stcs(out_bf16 + 2 * vb + 32 * k + lane,
               make_uint4(decode_bf16x2(q.x, 0, sk), decode_bf16x2(q.x, 2, sk),
                          decode_bf16x2(q.y, 0, sk), decode_bf16x2(q.y, 2, sk)));
      }
    } else {
      // store k: 4 values from codes [128 k + 4 lane, +4), block k / 2
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (vb + kVecsPerScale * (k >> 1) >= m) continue;
        const uint32_t q = words[32 * k + lane];
        const float sk = k >> 1 ? s1 : s0;
        __stcs(out_f32 + 4 * vb + 32 * k + lane,
               make_float4(decode(q, 0, sk), decode(q, 1, sk),
                           decode(q, 2, sk), decode(q, 3, sk)));
      }
    }
    __syncwarp();  // the stage is rewritten for j + 1
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

// codes: n int8 (n % 256 == 0), 16-byte aligned; scales: n/256 f32;
// out: n f32 or bf16, 16-byte aligned.
int qsnap_dequantize(const void* codes, const void* scales, long long n,
                     void* out, int out_bf16, void* stream) {
  if (n == 0) return 0;
  if (n % kBlock) return static_cast<int>(cudaErrorInvalidValue);
  const long long n_vecs = n / kVecCodes;
  const dim3 grid(static_cast<unsigned>((n_vecs + kTileVecs - 1) / kTileVecs));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_bf16)
    qsnap_dequantize_kernel<true><<<grid, kDequantThreads, 0, s>>>(
        static_cast<const int8_t*>(codes), static_cast<const float*>(scales),
        n_vecs, out);
  else
    qsnap_dequantize_kernel<false><<<grid, kDequantThreads, 0, s>>>(
        static_cast<const int8_t*>(codes), static_cast<const float*>(scales),
        n_vecs, out);
  return static_cast<int>(cudaGetLastError());
}

// Codes one CTA of the dequantize kernel covers.
int qsnap_dequantize_tile() { return kDequantTile; }

}  // extern "C"
