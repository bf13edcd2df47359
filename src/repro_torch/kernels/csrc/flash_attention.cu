// flash_attention — blocked GQA attention forward (prefill) for Hopper
// (sm_90a). Plain C interface, loaded with ctypes by
// src/repro_torch/kernels/flash_attention.py.
//
// Replaces the Pallas TPU kernel _flash_kernel of
// src/repro/kernels/flash_attention.py (called from flash_attention_bhsd).
// It computes what that kernel computes: q-head h reads kv-head h / g;
// scores q.k^T * (1/sqrt(hd)) in f32; a key is visible when it lies below
// kv_len, at or before the query (causal) and less than `window` positions
// back (sliding window); an online softmax with f32 running max m, sum l
// and accumulator acc; output acc / max(l, 1e-30) cast to q's dtype.
//
// Bound on this card: at the served prefill (q [8,12,512,64] against k/v
// [8,4,512,64], bf16, causal) the function reads 10.5 MB and writes 6.3 MB
// (5.0 us at 3.35 TB/s) and does 3.2 GFLOP of visible products (3.3 us at
// the bf16 tensor-core peak), so the bytes bound it; at S = T = 4096 the
// operations do. This kernel is the simple design: one block of 256
// threads per (b, h, 64-row query tile); the q tile and each 64-key k/v
// tile are widened to f32 in shared memory and multiplied on the CUDA
// cores with explicit fmaf (the library is built with --fmad=false); the
// loop over k/v tiles inside the block takes the place of the TPU's
// sequential grid dimension. What it leaves on the table: the tensor cores
// (wgmma), TMA and a ring of tiles in flight, and the 4x re-read of each
// kv-head by its g q-heads from L2.
//
// Masking: a masked score contributes exactly 0 (p is set to 0, not
// exp(-1e30 - m)), so a tile wholly outside the causal/window band leaves
// m, l and acc bit-for-bit unchanged (corr = exp(0) = 1, p = 0) and the
// kernel skips such tiles; `skip` = 0 visits them instead (used to check
// that both give the same bits). Keys at or past kv_len are never read.
// No atomics and a fixed reduction order: two launches give the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 x 16: ty owns 4 rows, tx 4 key columns
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(uint16_t v) {
  return __uint_as_float(static_cast<unsigned>(v) << 16);  // bf16 -> f32
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(uint16_t* p, float v) {
  *reinterpret_cast<__nv_bfloat16*>(p) = __float2bfloat16_rn(v);
}

// element strides of a [B, heads, seq, hd] operand (hd is contiguous)
struct Strides {
  long long b, h, s;
};

template <int HD>
constexpr size_t smem_bytes() {
  // q [kBQ][HD+1], k [kBK][HD+1], v [kBK][HD], p [kBQ][kBK+1], all f32
  return sizeof(float) *
         (kBQ * (HD + 1) + kBK * (HD + 1) + kBK * HD + kBQ * (kBK + 1));
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, Strides qs,
                     Strides ks, Strides vs, Strides os, int S, int T_len,
                     int group, int kv_len, int causal, int window,
                     float scale, int skip) {
  constexpr int QP = HD + 1;  // odd pitches: column reads are conflict-free
  constexpr int KP = HD + 1;
  constexpr int PP = kBK + 1;
  constexpr int DC = HD / 16;  // output dims per thread
  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + kBQ * QP;
  float* v_s = k_s + kBK * KP;
  float* p_s = v_s + kBK * HD;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / group;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;
  T* ob = o + b * os.b + h * os.h;

  for (int e = tid; e < kBQ * HD; e += kThreads) {
    const int r = e / HD, d = e % HD;
    q_s[r * QP + d] = q0 + r < S ? widen(qb[(q0 + r) * qs.s + d]) : 0.f;
  }

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  // the keys this query tile can see: [k_lo, k_hi)
  int k_lo = 0, k_hi = T_len;
  if (skip) {
    k_hi = kv_len;
    if (causal) k_hi = min(k_hi, q0 + kBQ);
    if (window > 0) k_lo = max(0, q0 - window + 1);
  }
  for (int k0 = (k_lo / kBK) * kBK; k0 < k_hi; k0 += kBK) {
    __syncthreads();  // the previous tile's k_s, v_s, p_s are consumed
    for (int e = tid; e < kBK * HD; e += kThreads) {
      const int r = e / HD, d = e % HD;
      const bool ok = k0 + r < kv_len;
      k_s[r * KP + d] = ok ? widen(kb[(k0 + r) * ks.s + d]) : 0.f;
      v_s[r * HD + d] = ok ? widen(vb[(k0 + r) * vs.s + d]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = q_s[(ty * 4 + i) * QP + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = k_s[(tx + 16 * c) * KP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[i][c] = fmaf(qv[i], kv[c], s[i][c]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i;
      bool ok[4];
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kp = k0 + tx + 16 * c;
        ok[c] = kp < kv_len && (!causal || kp <= qp) &&
                (window <= 0 || qp - kp < window);
        s[i][c] = ok[c] ? s[i][c] * scale : kNegInf;
        mx = fmaxf(mx, s[i][c]);
      }
      // the 16 lanes of a row are one half-warp: xor offsets below 16
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = ok[c] ? expf(s[i][c] - m_new) : 0.f;
        p_s[(ty * 4 + i) * PP + tx + 16 * c] = p;
        rs += p;
      }
      // butterfly: every lane of the row ends with the same bits
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      float vv[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = v_s[j * HD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = p_s[(ty * 4 + i) * PP + j];
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty * 4 + i;
    if (qp >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < DC; ++c)
      put(ob + qp * os.s + tx + 16 * c, acc[i][c] / denom);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o,
           const long long* st, int B, int H, int S, int T_len, int group,
           int kv_len, int causal, int window, int skip,
           cudaStream_t stream) {
  auto kern = flash_fwd_kernel<T, HD>;
  const size_t smem = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), qs, ks, vs, os, S, T_len,
      group, kv_len, causal, window, 1.0f / sqrtf(static_cast<float>(HD)),
      skip);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_hd(int hd, const void* q, const void* k, const void* v, void* o,
                const long long* st, int B, int H, int S, int T_len,
                int group, int kv_len, int causal, int window, int skip,
                cudaStream_t s) {
  switch (hd) {
    case 32:
      return launch<T, 32>(q, k, v, o, st, B, H, S, T_len, group, kv_len,
                           causal, window, skip, s);
    case 64:
      return launch<T, 64>(q, k, v, o, st, B, H, S, T_len, group, kv_len,
                           causal, window, skip, s);
    case 96:
      return launch<T, 96>(q, k, v, o, st, B, H, S, T_len, group, kv_len,
                           causal, window, skip, s);
    case 128:
      return launch<T, 128>(q, k, v, o, st, B, H, S, T_len, group, kv_len,
                            causal, window, skip, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// q: [B,H,S,hd], k/v: [B,Hkv,T,hd], o: [B,H,S,hd], all f32 (is_bf16 == 0)
// or all bf16; `strides` holds 12 element strides (b, h, s) of q, k, v, o
// in that order, hd contiguous. window <= 0: no window. skip != 0: skip
// tiles outside the causal/window band. Returns cudaError_t.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        const long long* strides, int is_bf16, int B, int H,
                        int S, int Hkv, int T_len, int hd, int kv_len,
                        int causal, int window, int skip, void* stream) {
  if (B == 0 || H == 0 || S == 0) return 0;
  const int group = H / Hkv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch_hd<uint16_t>(hd, q, k, v, o, strides, B, H, S, T_len,
                                 group, kv_len, causal, window, skip, s);
  return dispatch_hd<float>(hd, q, k, v, o, strides, B, H, S, T_len, group,
                            kv_len, causal, window, skip, s);
}

}  // extern "C"
