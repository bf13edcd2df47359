// decode_attention — one query token per sequence over a KV cache, GQA, for
// Hopper (sm_90a). Plain C interface, loaded with ctypes by
// src/repro_torch/kernels/decode_attention.py.
//
// Replaces the Pallas TPU kernel _decode_kernel of
// src/repro/kernels/decode_attention.py (called from decode_attention_bhd).
// It computes what that kernel computes: the g q-heads of kv-head hk
// (h = hk * g + i) attend over cache slots 0..pos inclusive, scores
// q.k^T * (1/sqrt(hd)) and softmax in f32, output cast to q's dtype. There
// is no sliding window: the TPU kernel has none. `pos` is a kernel
// argument, so no step builds anything anew.
//
// Bound on this card: the cache is read once, q and the output are a few
// KB. At the served decode (cache [8,4,640,64] bf16 at pos 639) that is
// 5.2 MB, 1.6 us at 3.35 TB/s; the products are ~1 op per byte, far below
// the card's compute roofline. Design: a grid of (B, Hkv) alone is 32
// blocks at the served shape, so T is split into 64-slot chunks, one block
// of 128 threads each, over slots 0..pos only: slots past pos are never
// read (they may hold stale values). A block stages its chunk of k and v
// and the g query rows in shared memory as f32, computes the chunk's exact
// softmax pieces (max m, sum l, unnormalised acc [g, hd]) and writes them
// to scratch; a second kernel combines the chunks of each (b, hk) in chunk
// order: no atomics, a fixed reduction order, so two launches give the same
// bits. What the design leaves on the table: 16-byte loads and a pipeline
// of loads in flight (each block loads its chunk, then computes), the
// scratch round trip, and the second launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 64;     // cache slots per block
constexpr int kThreads = 128;  // 4 warps
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(uint16_t v) {
  return __uint_as_float(static_cast<unsigned>(v) << 16);  // bf16 -> f32
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(uint16_t* p, float v) {
  *reinterpret_cast<__nv_bfloat16*>(p) = __float2bfloat16_rn(v);
}

template <int HD>
size_t smem_bytes(int g) {
  // q [g][HD], k [kChunk][HD+1], v [kChunk][HD], p [g][kChunk], all f32
  return sizeof(float) *
         (g * HD + kChunk * (HD + 1) + kChunk * HD + g * kChunk);
}

// grid (n_chunks, B * Hkv). Scratch per (b, hk, chunk): m[g], l[g],
// acc[g][HD].
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    decode_chunk_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, long long q_sb,
                        long long q_sh, long long k_sb, long long k_sh,
                        long long k_ss, long long v_sb, long long v_sh,
                        long long v_ss, int Hkv, int g, int pos,
                        float scale, float* __restrict__ part_m,
                        float* __restrict__ part_l,
                        float* __restrict__ part_acc) {
  constexpr int KP = HD + 1;  // odd pitch: a warp's rows hit 32 banks
  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + g * HD;
  float* v_s = k_s + kChunk * KP;
  float* p_s = v_s + kChunk * HD;

  const int chunk = blockIdx.x, n_chunks = gridDim.x, bh = blockIdx.y;
  const int b = bh / Hkv, hk = bh % Hkv;
  const int k0 = chunk * kChunk;
  const int n = min(kChunk, pos + 1 - k0);  // visible slots of this chunk
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const T* qb = q + b * q_sb + static_cast<long long>(hk) * g * q_sh;
  for (int e = tid; e < g * HD; e += kThreads) {
    const int i = e / HD, d = e % HD;
    q_s[e] = widen(qb[i * q_sh + d]);
  }
  const T* kb = k + b * k_sb + hk * k_sh + k0 * k_ss;
  const T* vb = v + b * v_sb + hk * v_sh + k0 * v_ss;
  for (int e = tid; e < n * HD; e += kThreads) {
    const int r = e / HD, d = e % HD;
    k_s[r * KP + d] = widen(kb[r * k_ss + d]);
    v_s[r * HD + d] = widen(vb[r * v_ss + d]);
  }
  __syncthreads();

  for (int e = tid; e < g * kChunk; e += kThreads) {
    const int i = e / kChunk, j = e % kChunk;
    float s = kNegInf;
    if (j < n) {
      float dot = 0.f;
#pragma unroll 8
      for (int d = 0; d < HD; ++d)
        dot = fmaf(q_s[i * HD + d], k_s[j * KP + d], dot);
      s = dot * scale;
    }
    p_s[e] = s;
  }
  __syncthreads();

  const long long part = (static_cast<long long>(bh) * n_chunks + chunk) * g;
  for (int i = warp; i < g; i += kThreads / 32) {
    float* row = p_s + i * kChunk;
    float mx = kNegInf;
    for (int j = lane; j < kChunk; j += 32) mx = fmaxf(mx, row[j]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sum = 0.f;
    for (int j = lane; j < kChunk; j += 32) {
      const float p = j < n ? expf(row[j] - mx) : 0.f;
      row[j] = p;
      sum += p;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) {
      part_m[part + i] = mx;
      part_l[part + i] = sum;
    }
  }
  __syncthreads();

  for (int e = tid; e < g * HD; e += kThreads) {
    const int i = e / HD, d = e % HD;
    float acc = 0.f;
    for (int j = 0; j < n; ++j)
      acc = fmaf(p_s[i * kChunk + j], v_s[j * HD + d], acc);
    part_acc[(part + i) * HD + d] = acc;
  }
}

// grid (B * Hkv): combine the chunks of each (b, hk) in chunk order.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    decode_combine_kernel(const float* __restrict__ part_m,
                          const float* __restrict__ part_l,
                          const float* __restrict__ part_acc,
                          T* __restrict__ o, long long o_sb, long long o_sh,
                          int Hkv, int g, int n_chunks) {
  const int bh = blockIdx.x, b = bh / Hkv, hk = bh % Hkv;
  const long long base = static_cast<long long>(bh) * n_chunks * g;
  for (int e = threadIdx.x; e < g * HD; e += kThreads) {
    const int i = e / HD, d = e % HD;
    float mx = kNegInf;
    for (int c = 0; c < n_chunks; ++c)
      mx = fmaxf(mx, part_m[base + c * g + i]);
    float l = 0.f, acc = 0.f;
    for (int c = 0; c < n_chunks; ++c) {
      const long long at = base + c * g + i;
      const float w = expf(part_m[at] - mx);
      l = fmaf(part_l[at], w, l);
      acc = fmaf(part_acc[at * HD + d], w, acc);
    }
    put(o + b * o_sb + static_cast<long long>(hk * g + i) * o_sh + d,
        acc / fmaxf(l, 1e-30f));
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o,
           const long long* st, int B, int Hkv, int g, int pos,
           float* part_m, float* part_l, float* part_acc,
           cudaStream_t stream) {
  auto chunk_kern = decode_chunk_kernel<T, HD>;
  const size_t smem = smem_bytes<HD>(g);
  cudaError_t err = cudaFuncSetAttribute(
      chunk_kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_chunks = pos / kChunk + 1;
  chunk_kern<<<dim3(n_chunks, B * Hkv), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], Hkv, g, pos, 1.0f / sqrtf(static_cast<float>(HD)),
      part_m, part_l, part_acc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_combine_kernel<T, HD><<<B * Hkv, kThreads, 0, stream>>>(
      part_m, part_l, part_acc, static_cast<T*>(o), st[8], st[9], Hkv, g,
      n_chunks);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v, void* o,
                const long long* st, int B, int Hkv, int g, int pos,
                float* pm, float* pl, float* pa, cudaStream_t s) {
  switch (hd) {
    case 32:
      return launch<T, 32>(q, k, v, o, st, B, Hkv, g, pos, pm, pl, pa, s);
    case 64:
      return launch<T, 64>(q, k, v, o, st, B, Hkv, g, pos, pm, pl, pa, s);
    case 96:
      return launch<T, 96>(q, k, v, o, st, B, Hkv, g, pos, pm, pl, pa, s);
    case 128:
      return launch<T, 128>(q, k, v, o, st, B, Hkv, g, pos, pm, pl, pa, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Slots per chunk: the caller sizes the scratch for pos / chunk + 1 chunks.
int decode_attention_chunk() { return kChunk; }

// q: [B,H,hd]; k/v: [B,Hkv,T,hd]; o: [B,H,hd]; all f32 (is_bf16 == 0) or
// all bf16. `strides` holds 10 element strides: q (b, h), k (b, h, t),
// v (b, h, t), o (b, h); hd contiguous. 0 <= pos < T. Scratch, f32:
// part_m and part_l [B*Hkv*n_chunks*g], part_acc [B*Hkv*n_chunks*g*hd],
// n_chunks = pos / chunk + 1. Returns cudaError_t.
int decode_attention_fwd(const void* q, const void* k, const void* v,
                         void* o, const long long* strides, int is_bf16,
                         int B, int H, int Hkv, int hd, int pos,
                         void* part_m, void* part_l, void* part_acc,
                         void* stream) {
  if (B == 0 || H == 0) return 0;
  const int g = H / Hkv;
  float* pm = static_cast<float*>(part_m);
  float* pl = static_cast<float*>(part_l);
  float* pa = static_cast<float*>(part_acc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch_hd<uint16_t>(hd, q, k, v, o, strides, B, Hkv, g, pos, pm,
                                 pl, pa, s);
  return dispatch_hd<float>(hd, q, k, v, o, strides, B, Hkv, g, pos, pm, pl,
                            pa, s);
}

}  // extern "C"
