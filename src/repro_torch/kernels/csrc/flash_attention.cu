// flash_attention — blocked GQA attention forward (prefill) for Hopper
// (sm_90a). Plain C interface, loaded with ctypes by
// src/repro_torch/kernels/flash_attention.py.
//
// Replaces the Pallas TPU kernel _flash_kernel of
// src/repro/kernels/flash_attention.py (called from flash_attention_bhsd).
// It computes what that kernel computes: q-head h reads kv-head h / g;
// scores q.k^T * scale (by default 1/sqrt(hd)) in f32; a key is visible
// when it lies below kv_len, at or before the query (causal) and less than
// `window` positions back (sliding window); an online softmax with f32
// running max m, sum l and accumulator acc; output acc / max(l, 1e-30) cast
// to q's dtype.
//
// Bound on this card: at the served prefill (q [8,12,512,64] against k/v
// [8,4,512,64], bf16, causal) the function reads 10.5 MB and writes 6.3 MB
// (5.0 us at 3.35 TB/s) and does 3.2 GFLOP of visible products (3.3 us at
// the bf16 tensor-core peak), so the bytes bound it; at S = T = 4096, B = 2
// it does 51.5 GFLOP (52 us at 989 TFLOP/s), so the operations bound it.
//
// bf16 (the served model's type): flash_tc_kernel, on the tensor cores.
//  - Both products are mma.sync.aligned.m16n8k16 (bf16 operands, f32
//    accumulators) fed by ldmatrix from shared memory (.trans for V).
//    mma.sync, not wgmma: its register fragments let the score
//    accumulators become the A operand of p.v in registers, with no trip
//    through shared memory, and its per-warp rows keep the per-row masks
//    and the fixed quad butterfly simple. wgmma + TMA (a 64-row warpgroup
//    tile read from shared memory once for four warps, descriptors,
//    mbarriers) is left for a later redesign.
//  - q.k^T: bf16 x bf16 products are exact in f32, so the scores differ
//    from the TPU kernel's f32 dot_general only in the order of the sum.
//    p is rounded to bf16 before p.v, as in every tensor-core flash
//    kernel; l sums the f32 p.
//  - The softmax is what issue slots go to, so a score costs one fmaf
//    (s * scale * log2 e - m * scale * log2 e) and one ex2.approx, with
//    no branch and no select: a masked score is -inf, whose p is exactly
//    0. exp2f's guard of the denormal range, and a branch or select per
//    score for the mask, made the kernel markedly slower. The running
//    max's correction keeps exp2f, whose exp2f(0) is exactly 1.
//  - A block holds 128 stacked rows, one m16 tile for each of 8 warps
//    (two tiles a warp need twice the registers and ran no faster): row r of
//    kv-head hk is query position r / g of q-head hk * g + r % g, so the g
//    q-heads that share a kv-head share each K/V tile the block copies to
//    shared memory; a row's mask uses its position, not its stacked index.
//  - K/V tiles (64 keys for hd <= 64, 32 above) come in with 16-byte
//    cp.async into a ring of two stages: the next tile's copy is issued
//    before the current tile's products (three stages ran no faster).
//    Shared rows are padded by 16 bytes, so ldmatrix's eight
//    rows hit distinct banks.
//  - Head dim 256 (gemma3) keeps the same design: a warp's 16 rows hold
//    16 x 256 f32 accumulators, 128 registers a thread, beside a 16 x 32
//    score tile; the q tile and two stages of 32-key K/V tiles take 132
//    KiB of shared memory, so one block runs on an SM.
//  - The grid is one dimension, the last (heaviest under a causal mask)
//    row tiles of every (b, kv-head) first, so the triangle leaves no tail.
//  - Operands are read through their strides; 16-byte copies need
//    16-byte-aligned bases and (b, h, s) strides that are multiples of 8
//    elements, which the wrapper checks.
//  What is left: the mma.sync rate, the softmax's issue slots, and each of
//  the 8 warps reading the whole K and V tile from shared memory by
//  ldmatrix. wgmma, asynchronous and reading its B operand from shared
//  memory once per warpgroup, with the softmax of one tile overlapping
//  the products of the next, is the way past them. Times in PERF.md
//  (chip_smoke.py).
// f32: flash_fwd_kernel, the CUDA-core design (one block of 256 threads
// per (b, h, 64-row query tile), tiles widened in shared memory, explicit
// fmaf; the library is built with --fmad=false; at head dim 256 its tiles
// take 209 KiB of the 227 KiB a block may have). TF32 tensor cores would
// break the f32 tolerance (2e-5) and the reduced f32 model's parity.
//
// Masking: a masked score contributes exactly 0 (p is 0, not
// exp(-1e30 - m)), so a tile wholly outside the causal/window band leaves
// m, l and acc bit-for-bit unchanged (corr = exp(0) = 1, p = 0) and the
// kernels skip such tiles (the bf16 kernel also per warp); `skip` = 0
// visits them instead (used to check that both give the same bits). Keys
// at or past kv_len are never read (zero-filled in shared memory). No
// atomics and a fixed reduction order (the row max and sum over the quad
// of lanes in a fixed butterfly): two launches give the same bits.
//
// lse (optional, f32 [B,H,S], bf16 kernel only): each row's natural-log
// log-sum-exp of its scaled scores, m * scale + log l, from the running max
// and sum, for the backward. Without it the kernel writes exactly what it
// wrote before. The f32 kernel takes none (f32 trains through
// attention_ref).
//
// Backward (flash_attention_bwd; bf16 at head dim 64 and 128 only: head dim
// 256 and f32 train through attention_ref's autograd). It replaces no TPU
// kernel: the reference trains through attention_ref's autograd, and so did
// the port. Three launches, no atomics, a fixed order: two calls give the
// same bits.
//  - flash_bwd_dot_kernel: D = rowsum(dO o) in f32, a warp a row.
//  - flash_bwd_dkv_kernel: a block per (b, kv-head, 128 keys), 16 keys a
//    warp as the rows of transposed products (sT = k q^T, dpT = v dO^T), so
//    pT and dsT = pT (dpT - D) are in registers as the A operands of
//    dv += pT dO and dk += dsT q; the block walks the query tiles of all g
//    q-heads of its kv-head (cp.async, two stages), so the group's sum stays
//    in f32 registers and dk, dv are written once.
//  - flash_bwd_dq_kernel: the forward's stacked 128-row block walking its
//    key tiles: s = q k^T, dp = dO v^T, ds = p (dp - D), dq += ds k.
//  p = 2^(s scale log2 e - lse log2 e), masked by the forward's rule (a
//  masked score is -inf, so p is exactly 0); p and ds are rounded to bf16
//  for their products, accumulators are f32; dq and dk are scaled once.
//  Tiles outside the causal/window band are skipped. Outputs are written
//  through their strides, so the [B,S,H,hd] layout of training needs no
//  copy. Bound at internlm2's training shape (B 4, 16 q-heads over 8, S =
//  T = 4096, hd 128, causal): given lse, the backward needs 5 products (s,
//  dp, dv, dk, dq) over the visible half, 10 x 128 FLOP a visible pair a
//  head, 6.9e11 FLOP, 0.70 ms at 989 TFLOP/s, while its bytes (q, k, v, o,
//  dO, dq, dk, dv, lse, D: ~0.4 GB) take 0.12 ms at 3.35 TB/s: the
//  operations bound it. This design makes 7: the dQ kernel recomputes s and
//  dp, which the dK/dV kernel has already made. Times in PERF.md
//  (chip_smoke.py).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kLog2e = 1.4426950408889634f;

// element strides of a [B, heads, seq, hd] operand (hd is contiguous)
struct Strides {
  long long b, h, s;
};

// Raise a kernel's dynamic shared memory limit once per device, not once
// per launch. `done` is a bit mask of the devices already set.
template <typename Kernel>
cudaError_t allow_smem(Kernel kern, size_t bytes,
                       std::atomic<unsigned long long>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (bit && (done.load(std::memory_order_acquire) & bit)) return cudaSuccess;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess && bit) done.fetch_or(bit, std::memory_order_release);
  return err;
}

// ---------------------------------------------------------------------------
// f32: the CUDA-core kernel
// ---------------------------------------------------------------------------

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 256;  // 16 x 16: ty owns 4 rows, tx 4 key columns

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }

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

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               const long long* st, int B, int H, int S, int T_len,
               int group, int kv_len, int causal, int window, int skip,
               float scale, cudaStream_t stream) {
  static std::atomic<unsigned long long> smem_set{0};
  auto kern = flash_fwd_kernel<float, HD>;
  const size_t smem = smem_bytes<HD>();
  cudaError_t err = allow_smem(kern, smem, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), qs, ks, vs, os, S,
      T_len, group, kv_len, causal, window,
      scale > 0.0f ? scale : 1.0f / sqrtf(static_cast<float>(HD)), skip);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel
// ---------------------------------------------------------------------------

constexpr int kTcWarps = 8;
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kMT = 1;                     // m16 tiles per warp
constexpr int kBM = kTcWarps * kMT * 16;   // stacked rows per block
constexpr int kStages = 2;                 // K/V tiles in the ring

template <int HD>
struct TcShape {
  static constexpr int BK = HD <= 64 ? 64 : 32;  // keys per K/V tile
  static constexpr int P = HD + 8;  // shared row pitch in bf16: +16 bytes
  static constexpr int Q_ELEMS = kBM * P;
  static constexpr int KV_ELEMS = BK * P;
  // q tile, then kStages stages of (k tile, v tile)
  static constexpr size_t SMEM = 2 * (Q_ELEMS + 2 * kStages * KV_ELEMS);
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; src_bytes 0 writes 16 zeros and
// reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr,
                                              uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x by the hardware's approximation (relative error ~2^-22, results
// below 2^-126 flushed to 0); exp2f's guard of the denormal range costs
// several instructions a call
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// One block: 128 stacked rows of one (b, kv-head); grid.x enumerates
// (row tile, b, kv-head) with the last row tiles first.
template <int HD>
__global__ void __launch_bounds__(kTcThreads)
    flash_tc_kernel(const uint16_t* __restrict__ q,
                    const uint16_t* __restrict__ k,
                    const uint16_t* __restrict__ v, uint16_t* __restrict__ o,
                    Strides qs, Strides ks, Strides vs, Strides os, int B,
                    int Hkv, int S, int T_len, int group, int kv_len,
                    int causal, int window, float scale_log2, int skip,
                    int n_tiles, float* __restrict__ lse) {
  using Shape = TcShape<HD>;
  constexpr int BK = Shape::BK, P = Shape::P;
  constexpr int NT = BK / 8;    // n8 tiles of keys (scores)
  constexpr int DT = HD / 8;    // n8 tiles of head dims (output)
  constexpr int CH = HD / 8;    // 16-byte chunks of a row
  extern __shared__ __align__(16) uint16_t smem_tc[];
  uint16_t* q_s = smem_tc;
  uint16_t* kv_s = smem_tc + Shape::Q_ELEMS;  // stage st: k, then v

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_bh = B * Hkv;
  const int bh = blockIdx.x % n_bh;
  const int tile = n_tiles - 1 - blockIdx.x / n_bh;
  const int b = bh / Hkv, hk = bh % Hkv;
  const int R = S * group;  // stacked rows of this (b, kv-head)
  const int r0 = tile * kBM;
  const uint16_t* qb = q + b * qs.b + static_cast<long long>(hk) * group * qs.h;
  const uint16_t* kb = k + b * ks.b + hk * ks.h;
  const uint16_t* vb = v + b * vs.b + hk * vs.h;
  uint16_t* ob = o + b * os.b + static_cast<long long>(hk) * group * os.h;

  // the q tile: stacked row r is position r / g of q-head hk * g + r % g;
  // rows past R are zero
  for (int e = tid; e < kBM * CH; e += kTcThreads) {
    const int r = e / CH, c = e % CH, rr = r0 + r;
    const uint16_t* src = qb;
    int n = 0;
    if (rr < R) {
      const int s = rr / group, i = rr - s * group;
      src = qb + i * qs.h + s * qs.s + c * 8;
      n = 16;
    }
    cp_async16(smem_addr(q_s + r * P + c * 8), src, n);
  }

  auto load_kv = [&](int t, int st) {
    const int k0 = t * BK;
    uint16_t* kd = kv_s + st * 2 * Shape::KV_ELEMS;
    uint16_t* vd = kd + Shape::KV_ELEMS;
    for (int e = tid; e < BK * CH; e += kTcThreads) {
      const int r = e / CH, c = e % CH;
      const bool ok = k0 + r < kv_len;  // keys at or past kv_len: not read
      const long long kr = ok ? (k0 + r) * ks.s + c * 8 : 0;
      const long long vr = ok ? (k0 + r) * vs.s + c * 8 : 0;
      cp_async16(smem_addr(kd + r * P + c * 8), kb + kr, ok ? 16 : 0);
      cp_async16(smem_addr(vd + r * P + c * 8), vb + vr, ok ? 16 : 0);
    }
  };

  // positions of the block's and this warp's rows
  const int pos_lo = r0 / group;
  const int pos_hi = (min(r0 + kBM, R) - 1) / group;  // r0 < R
  const int w_first = r0 + warp * kMT * 16;
  const bool w_rows = w_first < R;
  const int wpos_lo = w_first / group;
  const int wpos_hi = (min(w_first + kMT * 16, R) - 1) / group;

  // the key tiles this block can see
  int k_lo = 0, k_hi = T_len;
  if (skip) {
    k_hi = kv_len;
    if (causal) k_hi = min(k_hi, pos_hi + 1);
    if (window > 0) k_lo = max(0, pos_lo - window + 1);
  }
  const int t_lo = k_lo / BK, t_hi = (k_hi + BK - 1) / BK;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (t_lo + st < t_hi) load_kv(t_lo + st, st);
    cp_async_commit();
  }

  // the 2 x kMT rows this thread holds: lane / 4 and lane / 4 + 8 of each
  // m16 tile
  int rpos[kMT][2];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      rpos[mt][hf] = (w_first + mt * 16 + hf * 8 + (lane >> 2)) / group;

  float acc[kMT][DT][4];
  float m[kMT][2], l[kMT][2];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      m[mt][hf] = kNegInf;
      l[mt][hf] = 0.f;
    }
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][dt][e] = 0.f;
  }

  for (int t = t_lo; t < t_hi; ++t) {
    const int st = (t - t_lo) % kStages;
    if (t + kStages - 1 < t_hi)  // in flight during this tile
      load_kv(t + kStages - 1, (t - t_lo + kStages - 1) % kStages);
    cp_async_commit();
    cp_async_wait<kStages - 1>();  // this tile (and q) have landed
    __syncthreads();

    const int k0 = t * BK;
    bool live = w_rows;  // a warp of rows past R has nothing to do
    if (skip && live)    // does any key of the tile reach a row of the warp?
      live = k0 < kv_len && (!causal || k0 <= wpos_hi) &&
             (window <= 0 || wpos_lo - (k0 + BK - 1) < window);
    if (live) {
      const uint16_t* kt = kv_s + st * 2 * Shape::KV_ELEMS;
      const uint16_t* vt = kt + Shape::KV_ELEMS;
      // every key visible to every row of the warp: no masks needed
      const bool full = k0 + BK <= kv_len &&
                        (!causal || k0 + BK - 1 <= wpos_lo) &&
                        (window <= 0 || wpos_hi - k0 < window);

      // s = q k^T
      float s[kMT][NT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[mt][j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t a[kMT][4];
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt)
          ldsm_x4(smem_addr(q_s +
                            (warp * kMT * 16 + mt * 16 + (lane & 15)) * P +
                            kk * 16 + (lane >> 4) * 8),
                  a[mt]);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t bk[4];
          ldsm_x4(smem_addr(kt +
                            (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * P +
                            kk * 16 + ((lane >> 3) & 1) * 8),
                  bk);
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt) {
            mma_bf16(s[mt][2 * np], a[mt], bk[0], bk[1]);
            mma_bf16(s[mt][2 * np + 1], a[mt], bk[2], bk[3]);
          }
        }
      }

      // online softmax: m is the running max of the raw scores, and
      // p = 2^(s * scale * log2(e) - m * scale * log2(e)): one fmaf and
      // one ex2 a score. A masked score is -inf, so its p is exactly 0
      // (fmaf keeps -inf, ex2(-inf) = +0) with no select, and a tile
      // wholly masked for a row leaves that row's m, l and acc unchanged.
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          if (!full) {
            const int qp = rpos[mt][hf];
            const float masked = __int_as_float(0xff800000u);  // -inf
#pragma unroll
            for (int j = 0; j < NT; ++j)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int kp = k0 + j * 8 + 2 * (lane & 3) + e;
                const bool vis = kp < kv_len && (!causal || kp <= qp) &&
                                 (window <= 0 || qp - kp < window);
                if (!vis) s[mt][j][hf * 2 + e] = masked;
              }
          }
          float mx = kNegInf;
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) mx = fmaxf(mx, s[mt][j][hf * 2 + e]);
          // the 4 lanes of a row are a quad: a fixed butterfly
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float m_new = fmaxf(m[mt][hf], mx);
          // exp2f, not ex2_approx: exp2f(0) is exactly 1, so a tile that
          // changes no max changes no bit
          const float corr = exp2f((m[mt][hf] - m_new) * scale_log2);
          const float neg_m = -m_new * scale_log2;
          float rs = 0.f;
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float p =
                  ex2_approx(fmaf(s[mt][j][hf * 2 + e], scale_log2, neg_m));
              s[mt][j][hf * 2 + e] = p;
              rs += p;
            }
          l[mt][hf] = l[mt][hf] * corr + rs;  // this lane's columns only
          m[mt][hf] = m_new;
#pragma unroll
          for (int dt = 0; dt < DT; ++dt) {
            acc[mt][dt][hf * 2] *= corr;
            acc[mt][dt][hf * 2 + 1] *= corr;
          }
        }
      }

      // acc += p v: the score fragments are the A operand, in registers
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t pa[kMT][4];
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          pa[mt][0] = pack_bf16(s[mt][2 * kk][0], s[mt][2 * kk][1]);
          pa[mt][1] = pack_bf16(s[mt][2 * kk][2], s[mt][2 * kk][3]);
          pa[mt][2] = pack_bf16(s[mt][2 * kk + 1][0], s[mt][2 * kk + 1][1]);
          pa[mt][3] = pack_bf16(s[mt][2 * kk + 1][2], s[mt][2 * kk + 1][3]);
        }
#pragma unroll
        for (int dp = 0; dp < DT / 2; ++dp) {
          uint32_t bv[4];
          ldsm_x4_trans(
              smem_addr(vt +
                        (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * P +
                        dp * 16 + (lane >> 4) * 8),
              bv);
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt) {
            mma_bf16(acc[mt][2 * dp], pa[mt], bv[0], bv[1]);
            mma_bf16(acc[mt][2 * dp + 1], pa[mt], bv[2], bv[3]);
          }
        }
      }
    }
    __syncthreads();  // stage st is consumed before it is refilled
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float lt = l[mt][hf];
      lt += __shfl_xor_sync(0xffffffffu, lt, 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
      const int rr = w_first + mt * 16 + hf * 8 + (lane >> 2);
      if (rr >= R) continue;
      const int s = rr / group, i = rr - s * group;
      if (lse && (lane & 3) == 0)  // natural log: (m * scale * log2 e + log2 l) ln 2
        lse[(static_cast<long long>(bh) * group + i) * S + s] =
            lt > 0.f ? (m[mt][hf] * scale_log2 + log2f(lt)) * kLn2 : -INFINITY;
      uint16_t* orow = ob + i * os.h + s * os.s + 2 * (lane & 3);
      const float denom = fmaxf(lt, 1e-30f);
#pragma unroll
      for (int dt = 0; dt < DT; ++dt)
        *reinterpret_cast<uint32_t*>(orow + dt * 8) =
            pack_bf16(acc[mt][dt][hf * 2] / denom,
                      acc[mt][dt][hf * 2 + 1] / denom);
    }
  }
}

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                const long long* st, int B, int Hkv, int S, int T_len,
                int group, int kv_len, int causal, int window, int skip,
                float scale, float* lse, cudaStream_t stream) {
  static std::atomic<unsigned long long> smem_set{0};
  auto kern = flash_tc_kernel<HD>;
  constexpr size_t smem = TcShape<HD>::SMEM;
  cudaError_t err = allow_smem(kern, smem, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  const int n_tiles = (S * group + kBM - 1) / kBM;
  const float scale_log2 =
      scale > 0.0f ? 1.4426950408889634f * scale
                   : 1.4426950408889634f / sqrtf(static_cast<float>(HD));
  kern<<<n_tiles * B * Hkv, kTcThreads, smem, stream>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<uint16_t*>(o), qs, ks, vs,
      os, B, Hkv, S, T_len, group, kv_len, causal, window, scale_log2, skip,
      n_tiles, lse);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16 backward: D = rowsum(dO o), then dK/dV and dQ, on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kBN = kTcWarps * 16;  // keys per dK/dV block: 16 a warp

template <int HD>
struct BwdShape {
  static constexpr int BK = HD <= 64 ? 64 : 32;  // dQ: keys per K/V tile
  static constexpr int BQ = HD <= 64 ? 64 : 32;  // dK/dV: queries per tile
  static constexpr int P = HD + 8;               // as TcShape's pitch
  // dQ: the q and dO tiles, then kStages stages of (k tile, v tile)
  static constexpr size_t DQ_SMEM = 2 * (2 * kBM * P + 2 * kStages * BK * P);
  // dK/dV: the k and v tiles, kStages stages of (q tile, dO tile), then
  // kStages stages of the tile's rows' lse (log2) and D, f32
  static constexpr size_t DKV_SMEM =
      2 * (2 * kBN * P + 2 * kStages * BQ * P) + 4 * 2 * kStages * BQ;
};

__device__ __forceinline__ float bf16_bits_to_f32(uint16_t x) {
  return __uint_as_float(static_cast<uint32_t>(x) << 16);
}

// a row's natural-log lse as the exponent offset of p = 2^(s c - lse2):
// a row that saw no key (-inf) gets +inf, so its p is 0
__device__ __forceinline__ float lse_log2(float lse) {
  return lse == -INFINITY ? INFINITY : lse * kLog2e;
}

// D[b, h, s] = sum over d of dO * o (f32, [B,H,S] contiguous): a warp a row
template <int HD>
__global__ void __launch_bounds__(256)
    flash_bwd_dot_kernel(const uint16_t* __restrict__ o,
                         const uint16_t* __restrict__ dout,
                         float* __restrict__ dsum, Strides os, Strides dos,
                         int H, int S, long long n_rows) {
  constexpr int PER = HD / 32;  // elements a lane
  const long long row =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (row >= n_rows) return;
  const int s = static_cast<int>(row % S);
  const long long bh = row / S;
  const int h = static_cast<int>(bh % H), b = static_cast<int>(bh / H);
  const uint16_t* orow = o + b * os.b + h * os.h + s * os.s + lane * PER;
  const uint16_t* drow = dout + b * dos.b + h * dos.h + s * dos.s + lane * PER;
  float acc = 0.f;
#pragma unroll
  for (int e = 0; e < PER; ++e)
    acc = fmaf(bf16_bits_to_f32(orow[e]), bf16_bits_to_f32(drow[e]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) dsum[row] = acc;
}

// dQ: one block of 128 stacked rows of one (b, kv-head), as the forward's
// (row r is position r / g of q-head hk * g + r % g), walking the key tiles
// its rows see. A warp's 16 rows: s = q k^T, dp = dO v^T, p = 2^(s c -
// lse2), ds = p (dp - D), dq += ds k; dq is scaled once at the end.
template <int HD>
__global__ void __launch_bounds__(kTcThreads)
    flash_bwd_dq_kernel(const uint16_t* __restrict__ q,
                        const uint16_t* __restrict__ k,
                        const uint16_t* __restrict__ v,
                        const uint16_t* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ dsum,
                        uint16_t* __restrict__ dq, Strides qs, Strides ks,
                        Strides vs, Strides dos, Strides dqs, int B, int Hkv,
                        int S, int T_len, int group, int causal, int window,
                        float scale_log2, float scale, int n_tiles) {
  using Shape = BwdShape<HD>;
  constexpr int BK = Shape::BK, P = Shape::P;
  constexpr int NT = BK / 8;  // n8 tiles of keys
  constexpr int DT = HD / 8;  // n8 tiles of head dims
  constexpr int CH = HD / 8;  // 16-byte chunks of a row
  constexpr int KV_ELEMS = BK * P;
  extern __shared__ __align__(16) uint16_t smem_dq[];
  uint16_t* q_s = smem_dq;
  uint16_t* do_s = q_s + kBM * P;
  uint16_t* kv_s = do_s + kBM * P;  // stage st: k, then v

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_bh = B * Hkv;
  const int bh = blockIdx.x % n_bh;
  const int tile = n_tiles - 1 - blockIdx.x / n_bh;
  const int b = bh / Hkv, hk = bh % Hkv;
  const int R = S * group;
  const int r0 = tile * kBM;
  const long long h0 = static_cast<long long>(hk) * group;
  const uint16_t* qb = q + b * qs.b + h0 * qs.h;
  const uint16_t* dob = dout + b * dos.b + h0 * dos.h;
  const uint16_t* kb = k + b * ks.b + hk * ks.h;
  const uint16_t* vb = v + b * vs.b + hk * vs.h;
  uint16_t* dqb = dq + b * dqs.b + h0 * dqs.h;
  const long long row0 = static_cast<long long>(bh) * group * S;  // lse, D

  for (int e = tid; e < kBM * CH; e += kTcThreads) {
    const int r = e / CH, c = e % CH, rr = r0 + r;
    const uint16_t* qsrc = qb;
    const uint16_t* dsrc = dob;
    int n = 0;
    if (rr < R) {
      const int s = rr / group, i = rr - s * group;
      qsrc = qb + i * qs.h + s * qs.s + c * 8;
      dsrc = dob + i * dos.h + s * dos.s + c * 8;
      n = 16;
    }
    cp_async16(smem_addr(q_s + r * P + c * 8), qsrc, n);
    cp_async16(smem_addr(do_s + r * P + c * 8), dsrc, n);
  }

  auto load_kv = [&](int t, int st) {
    const int k0 = t * BK;
    uint16_t* kd = kv_s + st * 2 * KV_ELEMS;
    uint16_t* vd = kd + KV_ELEMS;
    for (int e = tid; e < BK * CH; e += kTcThreads) {
      const int r = e / CH, c = e % CH;
      const bool ok = k0 + r < T_len;
      const long long kr = ok ? (k0 + r) * ks.s + c * 8 : 0;
      const long long vr = ok ? (k0 + r) * vs.s + c * 8 : 0;
      cp_async16(smem_addr(kd + r * P + c * 8), kb + kr, ok ? 16 : 0);
      cp_async16(smem_addr(vd + r * P + c * 8), vb + vr, ok ? 16 : 0);
    }
  };

  const int pos_lo = r0 / group;
  const int pos_hi = (min(r0 + kBM, R) - 1) / group;
  const int w_first = r0 + warp * 16;
  const bool w_rows = w_first < R;
  const int wpos_lo = w_first / group;
  const int wpos_hi = (min(w_first + 16, R) - 1) / group;

  int k_lo = 0, k_hi = T_len;
  if (causal) k_hi = min(k_hi, pos_hi + 1);
  if (window > 0) k_lo = max(0, pos_lo - window + 1);
  const int t_lo = k_lo / BK, t_hi = (k_hi + BK - 1) / BK;
  if (t_lo < t_hi) load_kv(t_lo, 0);
  cp_async_commit();

  // this thread's two rows: lane / 4 and lane / 4 + 8 of the warp's tile
  int rpos[2];
  float lse2[2], dd[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int rr = w_first + hf * 8 + (lane >> 2);
    rpos[hf] = rr / group;
    lse2[hf] = INFINITY;
    dd[hf] = 0.f;
    if (rr < R) {
      const int s = rr / group, i = rr - s * group;
      lse2[hf] = lse_log2(lse[row0 + static_cast<long long>(i) * S + s]);
      dd[hf] = dsum[row0 + static_cast<long long>(i) * S + s];
    }
  }

  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;

  for (int t = t_lo; t < t_hi; ++t) {
    const int st = (t - t_lo) % kStages;
    if (t + 1 < t_hi) load_kv(t + 1, (t - t_lo + 1) % kStages);
    cp_async_commit();
    cp_async_wait<1>();  // this tile (and q, dO) have landed
    __syncthreads();

    const int k0 = t * BK;
    bool live = w_rows && (!causal || k0 <= wpos_hi) &&
                (window <= 0 || wpos_lo - (k0 + BK - 1) < window);
    if (live) {
      const uint16_t* kt = kv_s + st * 2 * KV_ELEMS;
      const uint16_t* vt = kt + KV_ELEMS;
      const bool full = k0 + BK <= T_len &&
                        (!causal || k0 + BK - 1 <= wpos_lo) &&
                        (window <= 0 || wpos_hi - k0 < window);
      float s[NT][4], dp[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
      // s = q k^T and dp = dO v^T: k and v rows are the B operands' columns
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t aq[4], ad[4];
        const int a_off = (warp * 16 + (lane & 15)) * P + kk * 16 +
                          (lane >> 4) * 8;
        ldsm_x4(smem_addr(q_s + a_off), aq);
        ldsm_x4(smem_addr(do_s + a_off), ad);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          const int b_off = (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * P +
                            kk * 16 + ((lane >> 3) & 1) * 8;
          uint32_t bk[4], bv[4];
          ldsm_x4(smem_addr(kt + b_off), bk);
          ldsm_x4(smem_addr(vt + b_off), bv);
          mma_bf16(s[2 * np], aq, bk[0], bk[1]);
          mma_bf16(s[2 * np + 1], aq, bk[2], bk[3]);
          mma_bf16(dp[2 * np], ad, bv[0], bv[1]);
          mma_bf16(dp[2 * np + 1], ad, bv[2], bv[3]);
        }
      }
      // p = 2^(s c - lse2), a masked score -inf so p is 0; ds in s's place
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int qp = rpos[hf];
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float x = s[j][hf * 2 + e];
            if (!full) {
              const int kp = k0 + j * 8 + 2 * (lane & 3) + e;
              const bool vis = kp < T_len && (!causal || kp <= qp) &&
                               (window <= 0 || qp - kp < window);
              if (!vis) x = -INFINITY;
            }
            const float p = ex2_approx(fmaf(x, scale_log2, -lse2[hf]));
            s[j][hf * 2 + e] = p * (dp[j][hf * 2 + e] - dd[hf]);
          }
      }
      // dq += ds k: the ds fragments are the A operand, k read transposed
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t pa[4];
        pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
        for (int dp2 = 0; dp2 < DT / 2; ++dp2) {
          uint32_t bk[4];
          ldsm_x4_trans(
              smem_addr(kt +
                        (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * P +
                        dp2 * 16 + (lane >> 4) * 8),
              bk);
          mma_bf16(acc[2 * dp2], pa, bk[0], bk[1]);
          mma_bf16(acc[2 * dp2 + 1], pa, bk[2], bk[3]);
        }
      }
    }
    __syncthreads();  // stage st is consumed before it is refilled
  }
  cp_async_wait<0>();

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int rr = w_first + hf * 8 + (lane >> 2);
    if (rr >= R) continue;
    const int s = rr / group, i = rr - s * group;
    uint16_t* row = dqb + i * dqs.h + s * dqs.s + 2 * (lane & 3);
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
      *reinterpret_cast<uint32_t*>(row + dt * 8) =
          pack_bf16(acc[dt][hf * 2] * scale, acc[dt][hf * 2 + 1] * scale);
  }
}

// dK and dV: one block of 128 keys of one (b, kv-head), 16 a warp, walking
// the query tiles of the g q-heads that read the kv-head, so the group's
// sum stays in registers. Transposed products, keys as rows: sT = k q^T,
// dpT = v dO^T, pT = 2^(sT c - lse2), dv += pT dO, dsT = pT (dpT - D),
// dk += dsT q; dk is scaled once at the end.
template <int HD>
__global__ void __launch_bounds__(kTcThreads)
    flash_bwd_dkv_kernel(const uint16_t* __restrict__ q,
                         const uint16_t* __restrict__ k,
                         const uint16_t* __restrict__ v,
                         const uint16_t* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ dsum,
                         uint16_t* __restrict__ dk, uint16_t* __restrict__ dv,
                         Strides qs, Strides ks, Strides vs, Strides dos,
                         Strides dks, Strides dvs, int B, int Hkv, int S,
                         int T_len, int group, int causal, int window,
                         float scale_log2, float scale) {
  using Shape = BwdShape<HD>;
  constexpr int BQ = Shape::BQ, P = Shape::P;
  constexpr int NQ = BQ / 8;  // n8 tiles of queries
  constexpr int DT = HD / 8;
  constexpr int CH = HD / 8;
  constexpr int Q_ELEMS = BQ * P;
  extern __shared__ __align__(16) uint16_t smem_dkv[];
  uint16_t* k_s = smem_dkv;
  uint16_t* v_s = k_s + kBN * P;
  uint16_t* qd_s = v_s + kBN * P;  // stage st: q, then dO
  float* f_s = reinterpret_cast<float*>(qd_s + kStages * 2 * Q_ELEMS);
  // stage st: lse2 at f_s + st * 2 * BQ, D after it

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_bh = B * Hkv;
  const int bh = blockIdx.x % n_bh;
  const int tile = blockIdx.x / n_bh;  // the first key tiles (most queries
                                       // under a causal mask) first
  const int b = bh / Hkv, hk = bh % Hkv;
  const int n0 = tile * kBN;
  const long long h0 = static_cast<long long>(hk) * group;
  const uint16_t* qb = q + b * qs.b + h0 * qs.h;
  const uint16_t* dob = dout + b * dos.b + h0 * dos.h;
  const uint16_t* kb = k + b * ks.b + hk * ks.h;
  const uint16_t* vb = v + b * vs.b + hk * vs.h;
  const long long row0 = static_cast<long long>(bh) * group * S;

  for (int e = tid; e < kBN * CH; e += kTcThreads) {
    const int r = e / CH, c = e % CH;
    const bool ok = n0 + r < T_len;
    const long long kr = ok ? (n0 + r) * ks.s + c * 8 : 0;
    const long long vr = ok ? (n0 + r) * vs.s + c * 8 : 0;
    cp_async16(smem_addr(k_s + r * P + c * 8), kb + kr, ok ? 16 : 0);
    cp_async16(smem_addr(v_s + r * P + c * 8), vb + vr, ok ? 16 : 0);
  }

  // the queries that see a key of the block: [q_lo, q_hi)
  const int n_last = min(n0 + kBN, T_len) - 1;
  const int q_lo = causal ? n0 : 0;
  const int q_hi = window > 0 ? min(S, n_last + window) : S;
  const int t_lo = q_lo / BQ;
  const int nqt = max(0, (q_hi + BQ - 1) / BQ - t_lo);
  const int n_it = group * nqt;  // (q-head, query tile) pairs

  auto load_q = [&](int it, int st) {
    const int i = it / nqt, q0 = (t_lo + it % nqt) * BQ;
    uint16_t* qd = qd_s + st * 2 * Q_ELEMS;
    uint16_t* dd = qd + Q_ELEMS;
    for (int e = tid; e < BQ * CH; e += kTcThreads) {
      const int r = e / CH, c = e % CH;
      const bool ok = q0 + r < S;
      const long long qr = ok ? i * qs.h + (q0 + r) * qs.s + c * 8 : 0;
      const long long dr = ok ? i * dos.h + (q0 + r) * dos.s + c * 8 : 0;
      cp_async16(smem_addr(qd + r * P + c * 8), qb + qr, ok ? 16 : 0);
      cp_async16(smem_addr(dd + r * P + c * 8), dob + dr, ok ? 16 : 0);
    }
    float* fl = f_s + st * 2 * BQ;
    for (int r = tid; r < BQ; r += kTcThreads) {
      const bool ok = q0 + r < S;
      const long long at = row0 + static_cast<long long>(i) * S + q0 + r;
      fl[r] = ok ? lse_log2(lse[at]) : INFINITY;
      fl[BQ + r] = ok ? dsum[at] : 0.f;
    }
  };
  if (n_it > 0) load_q(0, 0);
  cp_async_commit();

  const int w0 = n0 + warp * 16;  // the warp's first key
  int kpos[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) kpos[hf] = w0 + hf * 8 + (lane >> 2);

  float acc_k[DT][4], acc_v[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[dt][e] = acc_v[dt][e] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    const int st = it % kStages;
    if (it + 1 < n_it) load_q(it + 1, (it + 1) % kStages);
    cp_async_commit();
    cp_async_wait<1>();  // this tile (and k, v) have landed
    __syncthreads();

    const int q0 = (t_lo + it % nqt) * BQ;
    const bool live = w0 < T_len && (!causal || w0 <= q0 + BQ - 1) &&
                      (window <= 0 || q0 - (w0 + 15) < window);
    if (live) {
      const uint16_t* qt = qd_s + st * 2 * Q_ELEMS;
      const uint16_t* dot = qt + Q_ELEMS;
      const float* lt = f_s + st * 2 * BQ;
      const float* dt_s = lt + BQ;
      const bool full = w0 + 16 <= T_len && q0 + BQ <= S &&
                        (!causal || w0 + 15 <= q0) &&
                        (window <= 0 || q0 + BQ - 1 - w0 < window);
      float sT[NQ][4], dpT[NQ][4];
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) sT[j][e] = dpT[j][e] = 0.f;
      // sT = k q^T and dpT = v dO^T: q and dO rows are the B operands'
      // columns
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t ak[4], av[4];
        const int a_off = (warp * 16 + (lane & 15)) * P + kk * 16 +
                          (lane >> 4) * 8;
        ldsm_x4(smem_addr(k_s + a_off), ak);
        ldsm_x4(smem_addr(v_s + a_off), av);
#pragma unroll
        for (int np = 0; np < NQ / 2; ++np) {
          const int b_off = (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * P +
                            kk * 16 + ((lane >> 3) & 1) * 8;
          uint32_t bq[4], bd[4];
          ldsm_x4(smem_addr(qt + b_off), bq);
          ldsm_x4(smem_addr(dot + b_off), bd);
          mma_bf16(sT[2 * np], ak, bq[0], bq[1]);
          mma_bf16(sT[2 * np + 1], ak, bq[2], bq[3]);
          mma_bf16(dpT[2 * np], av, bd[0], bd[1]);
          mma_bf16(dpT[2 * np + 1], av, bd[2], bd[3]);
        }
      }
      // pT in sT's place, dsT in dpT's: a column is a query, with its lse2
      // and D from shared memory
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = j * 8 + 2 * (lane & 3) + e, qp = q0 + c;
          const float l2 = lt[c], dq_ = dt_s[c];
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            float x = sT[j][hf * 2 + e];
            if (!full) {
              const int kp = kpos[hf];
              const bool vis = kp < T_len && qp < S &&
                               (!causal || kp <= qp) &&
                               (window <= 0 || qp - kp < window);
              if (!vis) x = -INFINITY;
            }
            const float p = ex2_approx(fmaf(x, scale_log2, -l2));
            sT[j][hf * 2 + e] = p;
            dpT[j][hf * 2 + e] = p * (dpT[j][hf * 2 + e] - dq_);
          }
        }
      // dv += pT dO and dk += dsT q: the fragments are the A operands,
      // dO and q read transposed
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        uint32_t pa[4], da[4];
        pa[0] = pack_bf16(sT[2 * kk][0], sT[2 * kk][1]);
        pa[1] = pack_bf16(sT[2 * kk][2], sT[2 * kk][3]);
        pa[2] = pack_bf16(sT[2 * kk + 1][0], sT[2 * kk + 1][1]);
        pa[3] = pack_bf16(sT[2 * kk + 1][2], sT[2 * kk + 1][3]);
        da[0] = pack_bf16(dpT[2 * kk][0], dpT[2 * kk][1]);
        da[1] = pack_bf16(dpT[2 * kk][2], dpT[2 * kk][3]);
        da[2] = pack_bf16(dpT[2 * kk + 1][0], dpT[2 * kk + 1][1]);
        da[3] = pack_bf16(dpT[2 * kk + 1][2], dpT[2 * kk + 1][3]);
#pragma unroll
        for (int dp2 = 0; dp2 < DT / 2; ++dp2) {
          const int t_off =
              (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * P + dp2 * 16 +
              (lane >> 4) * 8;
          uint32_t bd[4], bq[4];
          ldsm_x4_trans(smem_addr(dot + t_off), bd);
          ldsm_x4_trans(smem_addr(qt + t_off), bq);
          mma_bf16(acc_v[2 * dp2], pa, bd[0], bd[1]);
          mma_bf16(acc_v[2 * dp2 + 1], pa, bd[2], bd[3]);
          mma_bf16(acc_k[2 * dp2], da, bq[0], bq[1]);
          mma_bf16(acc_k[2 * dp2 + 1], da, bq[2], bq[3]);
        }
      }
    }
    __syncthreads();  // stage st is consumed before it is refilled
  }
  cp_async_wait<0>();

  uint16_t* dkb = dk + b * dks.b + hk * dks.h;
  uint16_t* dvb = dv + b * dvs.b + hk * dvs.h;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int kp = kpos[hf];
    if (kp >= T_len) continue;
    uint16_t* krow = dkb + kp * dks.s + 2 * (lane & 3);
    uint16_t* vrow = dvb + kp * dvs.s + 2 * (lane & 3);
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      *reinterpret_cast<uint32_t*>(krow + dt * 8) = pack_bf16(
          acc_k[dt][hf * 2] * scale, acc_k[dt][hf * 2 + 1] * scale);
      *reinterpret_cast<uint32_t*>(vrow + dt * 8) =
          pack_bf16(acc_v[dt][hf * 2], acc_v[dt][hf * 2 + 1]);
    }
  }
}

template <int HD>
int launch_bwd(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const float* lse, float* dsum, void* dq,
               void* dk, void* dv, const long long* st, int B, int H, int S,
               int Hkv, int T_len, int causal, int window, float scale,
               cudaStream_t stream) {
  static std::atomic<unsigned long long> dq_set{0}, dkv_set{0};
  using Shape = BwdShape<HD>;
  auto dq_kern = flash_bwd_dq_kernel<HD>;
  auto dkv_kern = flash_bwd_dkv_kernel<HD>;
  cudaError_t err = allow_smem(dq_kern, Shape::DQ_SMEM, dq_set);
  if (err == cudaSuccess) err = allow_smem(dkv_kern, Shape::DKV_SMEM, dkv_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]},
      dos{st[12], st[13], st[14]}, dqs{st[15], st[16], st[17]},
      dks{st[18], st[19], st[20]}, dvs{st[21], st[22], st[23]};
  const auto* q16 = static_cast<const uint16_t*>(q);
  const auto* k16 = static_cast<const uint16_t*>(k);
  const auto* v16 = static_cast<const uint16_t*>(v);
  const auto* do16 = static_cast<const uint16_t*>(dout);
  const int group = H / Hkv;
  const float sc = scale > 0.0f ? scale : 1.0f / sqrtf(static_cast<float>(HD));
  const float scale_log2 = kLog2e * sc;
  const long long n_rows = static_cast<long long>(B) * H * S;
  flash_bwd_dot_kernel<HD><<<static_cast<unsigned>((n_rows + 7) / 8), 256, 0,
                             stream>>>(static_cast<const uint16_t*>(o), do16,
                                       dsum, os, dos, H, S, n_rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = (S * group + kBM - 1) / kBM;
  dq_kern<<<n_tiles * B * Hkv, kTcThreads, Shape::DQ_SMEM, stream>>>(
      q16, k16, v16, do16, lse, dsum, static_cast<uint16_t*>(dq), qs, ks, vs,
      dos, dqs, B, Hkv, S, T_len, group, causal, window, scale_log2, sc,
      n_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_ktiles = (T_len + kBN - 1) / kBN;
  dkv_kern<<<n_ktiles * B * Hkv, kTcThreads, Shape::DKV_SMEM, stream>>>(
      q16, k16, v16, do16, lse, dsum, static_cast<uint16_t*>(dk),
      static_cast<uint16_t*>(dv), qs, ks, vs, dos, dks, dvs, B, Hkv, S, T_len,
      group, causal, window, scale_log2, sc);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch(int is_bf16, const void* q, const void* k, const void* v, void* o,
           const long long* st, int B, int H, int S, int Hkv, int T_len,
           int kv_len, int causal, int window, int skip, float scale,
           float* lse, cudaStream_t s) {
  const int group = H / Hkv;
  if (is_bf16)
    return launch_bf16<HD>(q, k, v, o, st, B, Hkv, S, T_len, group, kv_len,
                           causal, window, skip, scale, lse, s);
  if (lse) return static_cast<int>(cudaErrorInvalidValue);  // bf16 only
  return launch_f32<HD>(q, k, v, o, st, B, H, S, T_len, group, kv_len,
                        causal, window, skip, scale, s);
}

}  // namespace

extern "C" {

// q: [B,H,S,hd], k/v: [B,Hkv,T,hd], o: [B,H,S,hd], all f32 (is_bf16 == 0)
// or all bf16; `strides` holds 12 element strides (b, h, s) of q, k, v, o
// in that order, hd contiguous (bf16: bases 16-byte aligned, strides
// multiples of 8). window <= 0: no window. skip != 0: skip tiles outside
// the causal/window band. scale > 0: the scores' scale; else 1/sqrt(hd).
// lse: null, or (bf16 only) f32 [B,H,S] (contiguous) for each row's
// natural-log log-sum-exp of its scaled scores (-inf for a row that sees no
// key).
// Returns cudaError_t.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        const long long* strides, int is_bf16, int B, int H,
                        int S, int Hkv, int T_len, int hd, int kv_len,
                        int causal, int window, int skip, float scale,
                        float* lse, void* stream) {
  if (B == 0 || H == 0 || S == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32:
      return launch<32>(is_bf16, q, k, v, o, strides, B, H, S, Hkv, T_len,
                        kv_len, causal, window, skip, scale, lse, s);
    case 64:
      return launch<64>(is_bf16, q, k, v, o, strides, B, H, S, Hkv, T_len,
                        kv_len, causal, window, skip, scale, lse, s);
    case 96:
      return launch<96>(is_bf16, q, k, v, o, strides, B, H, S, Hkv, T_len,
                        kv_len, causal, window, skip, scale, lse, s);
    case 128:
      return launch<128>(is_bf16, q, k, v, o, strides, B, H, S, Hkv, T_len,
                         kv_len, causal, window, skip, scale, lse, s);
    case 256:
      return launch<256>(is_bf16, q, k, v, o, strides, B, H, S, Hkv, T_len,
                         kv_len, causal, window, skip, scale, lse, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}


// The backward of flash_attention_fwd, bf16 at head dim 64 or 128: from q,
// k, v, the forward's o and lse (f32 [B,H,S]) and dO, writes dq [B,H,S,hd]
// and dk, dv [B,Hkv,T,hd] in the operands' dtype, and D = rowsum(dO o) into
// the f32 workspace dsum [B,H,S] (contiguous, like lse). `strides` holds 24
// element strides (b, h, s) of q, k, v, o, dO, dq, dk, dv in that order, hd
// contiguous, bases 16-byte aligned, strides multiples of 8. Keys are
// visible by the forward's rule with kv_len = T. Returns cudaError_t.
int flash_attention_bwd(const void* q, const void* k, const void* v,
                        const void* o, const void* dout, const float* lse,
                        float* dsum, void* dq, void* dk, void* dv,
                        const long long* strides, int B, int H, int S,
                        int Hkv, int T_len, int hd, int causal, int window,
                        float scale, void* stream) {
  if (B == 0 || H == 0 || S == 0 || T_len == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64:
      return launch_bwd<64>(q, k, v, o, dout, lse, dsum, dq, dk, dv, strides,
                            B, H, S, Hkv, T_len, causal, window, scale, s);
    case 128:
      return launch_bwd<128>(q, k, v, o, dout, lse, dsum, dq, dk, dv,
                             strides, B, H, S, Hkv, T_len, causal, window,
                             scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
