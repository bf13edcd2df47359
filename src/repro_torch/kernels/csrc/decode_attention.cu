// decode_attention — one query token per sequence over a KV cache, GQA, for
// Hopper (sm_90a). Plain C interface, loaded with ctypes by
// src/repro_torch/kernels/decode_attention.py.
//
// Replaces the Pallas TPU kernel _decode_kernel of
// src/repro/kernels/decode_attention.py (called from decode_attention_bhd).
// It computes what that kernel computes: the g q-heads of kv-head hk
// (h = hk * g + i) attend over cache slots 0..pos inclusive, scores
// q.k^T * scale (by default 1/sqrt(hd)) and softmax in f32, output cast
// to q's dtype. There is no sliding window: the TPU kernel has none. `pos`
// is a kernel argument, or an int32 in device memory (a decode step
// replayed from a CUDA graph), so no step builds anything anew.
//
// Bound on this card: the cache slots 0..pos are read once, q and the
// output are a few KB. At the served decode (cache [8,4,640,64] bf16 at
// pos 639) that is 5.2 MB, 1.6 us at 3.35 TB/s; at T = 32768 (B = 8) it is
// 268 MB, 80 us. The products are ~1 op per byte, far below the card's
// compute roofline: the bytes bound it.
//
// Design:
//  - The slots 0..pos are split into chunks whose size the wrapper
//    computes from the shapes and pos alone (decode_attention.py
//    decode_plan), never from the card: a job suspended on one card and
//    resumed on another gives the same bits. One block of 128 threads per
//    (b, kv-head, group of at most 8 q-heads, chunk); the q-heads of a
//    kv-head share each k/v row the block loads. At the served step that
//    is 320 blocks of 64 slots, at T = 32768 4,096 blocks of 256.
//  - A block streams its chunk through shared memory in 32-slot tiles:
//    16-byte cp.async copies (8 bf16 or 4 f32 a thread) into a ring of
//    three stages, so two tiles are in flight while one computes. Slots
//    at or past pos + 1 are zero-filled, never read.
//  - Compute: a lane group of L lanes (L * 16 bytes >= one row, at most a
//    warp) owns slots grp, grp + NG, ... of a tile (NG groups); each lane
//    reads 16 bytes of k and of v of a slot, or PPL = 2 such pieces where
//    a row is wider than a warp's 32 (hd 256 in f32: pieces li and li + 32,
//    so neighbouring lanes still read neighbouring addresses). Rows of 256
//    dims come in 16-slot tiles, so a lane's slots of a tile stay at 32
//    values of k and of v in registers. The g queries live in registers; a
//    score is the lane's 16-byte dot product summed over the group by an
//    xor butterfly (every lane ends with the same bits). Each group keeps
//    an online softmax (m, l, acc) in the log2 domain, a slot's p by one
//    ex2.approx with no branch (a slot past the chunk scores -inf, whose
//    p is exactly 0); the block combines its NG groups in group order
//    through shared memory.
//  - A block of a one-chunk plan writes the output. Otherwise it writes
//    its chunk's (m, l, acc) to the scratch, fences, and takes a ticket
//    (an atomic counter per (b, kv-head, head group)); the block that draws
//    the last ticket combines the chunks and resets the counter: the max
//    of the chunks' m (exact in any order), their weights 2^(m - max) in
//    shared memory, then l and acc summed in chunk order. The ticket
//    decides only which block combines, so the bits do not depend on
//    timing: two launches give the same bits. One launch, at most one
//    scratch tensor a call, and the dynamic shared-memory limit raised
//    once per instantiation, not per launch.
//  - With `pos` in device memory, the grid is fixed by the shapes alone:
//    the most chunks decode_plan gives them (`want`, the grid's y). Each
//    block evaluates decode_plan's integer arithmetic from that `pos`, and
//    a block at or past its n_chunks returns before it writes scratch or
//    takes a ticket. Scratch, tickets and the combine follow n_chunks, not
//    the grid, so the sums are the host-`pos` launch's, bit for bit.
//  - With an `lse` pointer (a context-parallel decode, where each data
//    rank reads its own slice of the slots and the ranks' results are
//    merged), the block that writes a head's output also writes its
//    natural-log log-sum-exp of the slots it read, ln 2 * (m + log2 l) of
//    the same (m, l) that normalise the output: in the one-chunk path and
//    in the last-ticket merge alike. The output's arithmetic is the same
//    with or without it.
// 16-byte copies need 16-byte-aligned q, k and v and (b, h, t) strides
// that are multiples of 16 bytes, which the wrapper checks.
// What is left: each block pays a fixed latency (q, the first tile, the
// fence and the ticket) on 64 KB of cache at T = 32768; fewer, longer
// blocks run faster there (PERF.md, scripts/attention_times.py
// --plan-blocks), at the cost of a split that fills the card less.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 128;  // 4 warps
constexpr int kMaxChunks = 512;  // decode_attention.py MAX_CHUNKS
constexpr int kChunkStep = 64;   // decode_attention.py CHUNK_STEP
constexpr float kNegInf = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;  // log2 units -> natural log

// 16 bytes of T widened to f32: 8 bf16 or 4 f32
__device__ __forceinline__ void widen(const uint4& w, float (&f)[8]) {
  const uint32_t x[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(x[i] << 16);
    f[2 * i + 1] = __uint_as_float(x[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void widen(const uint4& w, float (&f)[4]) {
  f[0] = __uint_as_float(w.x);
  f[1] = __uint_as_float(w.y);
  f[2] = __uint_as_float(w.z);
  f[3] = __uint_as_float(w.w);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(uint16_t* p, float v) {
  *reinterpret_cast<__nv_bfloat16*>(p) = __float2bfloat16_rn(v);
}

// 2^x by the hardware's approximation (relative error ~2^-22, results
// below 2^-126 flushed to 0, ex2(-inf) = +0); exp2f's guard of the
// denormal range costs several instructions a call
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <typename T, int HD, int GM>
struct DecodeShape {
  static constexpr int EPL = 16 / static_cast<int>(sizeof(T));  // per load
  static constexpr int PIECES = HD / EPL;  // 16-byte pieces of a row
  static constexpr int L = PIECES <= 4 ? 4 : PIECES <= 8 ? 8
                         : PIECES <= 16 ? 16 : 32;  // lanes per slot
  static constexpr int PPL = PIECES > L ? PIECES / L : 1;  // pieces a lane
  static constexpr int W = PPL * EPL;               // values a lane holds
  static_assert(PIECES <= L || PIECES % L == 0, "row of whole warps");
  static constexpr int NG = kThreads / L;           // lane groups a block
  static constexpr int TILE = HD < 256 ? 32 : 16;   // slots a stage
  static constexpr int U = TILE / NG;  // slots of a lane group a tile
  static constexpr int STAGES = 3;
  static constexpr int STAGE_ELEMS = 2 * TILE * HD;  // k rows, then v rows
  static constexpr int REC = HD + 2;  // scratch record: m, l, acc[HD]
  static constexpr size_t RING = STAGES * STAGE_ELEMS * sizeof(T);
  static constexpr size_t COMBINE = NG * GM * REC * sizeof(float);
  static constexpr size_t CHUNKS = 2 * kMaxChunks * GM * sizeof(float);
  static constexpr size_t SMEM = RING > COMBINE
                                     ? (RING > CHUNKS ? RING : CHUNKS)
                                     : (COMBINE > CHUNKS ? COMBINE : CHUNKS);
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

// grid (B * Hkv * n_hg, n_chunks), or (B * Hkv * n_hg, want) with pos_dev:
// x has no practical limit, y holds at most kMaxChunks. Scratch record of
// (b, hk, hg, chunk, head i): part[((bhg * n_chunks + chunk) * GM + i) *
// (HD + 2)] = m, l, acc[HD]. tickets[bhg] is 0 before the launch and after
// it.
template <typename T, int HD, int GM>
__global__ void __launch_bounds__(kThreads)
    decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ o, long long q_sb,
                  long long q_sh, long long k_sb, long long k_sh,
                  long long k_ss, long long v_sb, long long v_sh,
                  long long v_ss, long long o_sb, long long o_sh, int Hkv,
                  int g, int n_hg, int pos, int chunk, float scale_log2,
                  float* __restrict__ part, int* __restrict__ tickets,
                  float* __restrict__ lse, const int* __restrict__ pos_dev) {
  using Sh = DecodeShape<T, HD, GM>;
  constexpr int EPL = Sh::EPL, PIECES = Sh::PIECES, L = Sh::L, PPL = Sh::PPL,
                W = Sh::W, NG = Sh::NG, TILE = Sh::TILE, U = Sh::U,
                STAGES = Sh::STAGES, REC = Sh::REC;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ring = reinterpret_cast<T*>(smem_raw);  // then reused by the combine
  __shared__ int sm_last;

  const int bhg = blockIdx.x, c = blockIdx.y;
  int n_chunks = gridDim.y;
  if (pos_dev != nullptr) {  // decode_plan over the grid's `want` chunks
    pos = *pos_dev;
    const int slots = pos + 1;
    chunk = (slots + n_chunks - 1) / n_chunks;
    chunk = max(kChunkStep, (chunk + kChunkStep - 1) / kChunkStep * kChunkStep);
    n_chunks = (slots + chunk - 1) / chunk;
    if (c >= n_chunks) return;
  }
  const int hg = bhg % n_hg, bh = bhg / n_hg;
  const int b = bh / Hkv, hk = bh % Hkv;
  const int h0 = hk * g + hg * GM, gh = min(GM, g - hg * GM);
  const int c0 = c * chunk, n = min(chunk, pos + 1 - c0);
  const int tid = threadIdx.x, grp = tid / L, li = tid % L;
  const bool active = li < PIECES;
  const T* kb = k + b * k_sb + hk * k_sh + c0 * k_ss;
  const T* vb = v + b * v_sb + hk * v_sh + c0 * v_ss;

  // tile t holds slots [t * TILE, (t + 1) * TILE) of the chunk; slots at or
  // past n (past pos) are zero-filled, never read
  auto issue = [&](int t, int st) {
    T* kd = ring + st * Sh::STAGE_ELEMS;
    T* vd = kd + TILE * HD;
    for (int e = tid; e < TILE * PIECES; e += kThreads) {
      const int r = e / PIECES, pc = e % PIECES, slot = t * TILE + r;
      const bool ok = slot < n;
      cp_async16(smem_addr(kd + r * HD + pc * EPL),
                 kb + (ok ? slot * k_ss + pc * EPL : 0), ok ? 16 : 0);
      cp_async16(smem_addr(vd + r * HD + pc * EPL),
                 vb + (ok ? slot * v_ss + pc * EPL : 0), ok ? 16 : 0);
    }
  };
  const int tiles = (n + TILE - 1) / TILE;
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < tiles) issue(st, st);
    cp_async_commit();
  }

  // value j * EPL + e of a lane is element (li + j * L) * EPL + e of a row
  float qf[GM][W];
#pragma unroll
  for (int i = 0; i < GM; ++i) {
#pragma unroll
    for (int j = 0; j < PPL; ++j) {
      float f[EPL];
      if (i < gh && active) {
        widen(*reinterpret_cast<const uint4*>(q + b * q_sb + (h0 + i) * q_sh +
                                              (li + j * L) * EPL),
              f);
      } else {
#pragma unroll
        for (int e = 0; e < EPL; ++e) f[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < EPL; ++e) qf[i][j * EPL + e] = f[e];
    }
  }
  float m[GM], l[GM], acc[GM][W];
#pragma unroll
  for (int i = 0; i < GM; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < W; ++e) acc[i][e] = 0.f;
  }

  for (int t = 0; t < tiles; ++t) {
    const int nt = t + STAGES - 1;
    if (nt < tiles) issue(nt, nt % STAGES);  // in flight during this tile
    cp_async_commit();
    cp_async_wait<STAGES - 1>();  // tile t has landed
    __syncthreads();

    const T* kt = ring + (t % STAGES) * Sh::STAGE_ELEMS;
    const T* vt = kt + TILE * HD;
    // slot grp + NG * u of the tile is this lane group's
    // a slot past the chunk's end scores -inf: its p is exactly 0
    const float masked = __int_as_float(0xff800000u);
    float sc[U][GM], vf[U][W];
    bool valid[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = grp + NG * u;
      valid[u] = t * TILE + r < n;
      float kf[W];
#pragma unroll
      for (int j = 0; j < PPL; ++j) {
        uint4 kw = make_uint4(0u, 0u, 0u, 0u), vw = kw;
        if (active) {
          const int off = r * HD + (li + j * L) * EPL;
          kw = *reinterpret_cast<const uint4*>(kt + off);
          vw = *reinterpret_cast<const uint4*>(vt + off);
        }
        float kp[EPL], vp[EPL];
        widen(kw, kp);
        widen(vw, vp);
#pragma unroll
        for (int e = 0; e < EPL; ++e) {
          kf[j * EPL + e] = kp[e];
          vf[u][j * EPL + e] = vp[e];
        }
      }
#pragma unroll
      for (int i = 0; i < GM; ++i) {
        if (i >= gh) continue;  // uniform over the block
        float d = 0.f;
#pragma unroll
        for (int e = 0; e < W; ++e) d = fmaf(qf[i][e], kf[e], d);
#pragma unroll
        for (int w = L / 2; w > 0; w >>= 1)
          d += __shfl_xor_sync(0xffffffffu, d, w);
        sc[u][i] = valid[u] ? d * scale_log2 : masked;
      }
    }
#pragma unroll
    for (int i = 0; i < GM; ++i) {
      if (i >= gh) continue;
      float mx = kNegInf;
#pragma unroll
      for (int u = 0; u < U; ++u) mx = fmaxf(mx, sc[u][i]);
      const float m_new = fmaxf(m[i], mx);
      const float corr = exp2f(m[i] - m_new);  // exactly 1 if m holds
      l[i] *= corr;
#pragma unroll
      for (int e = 0; e < W; ++e) acc[i][e] *= corr;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float p = ex2_approx(sc[u][i] - m_new);  // masked: exactly 0
        l[i] += p;
#pragma unroll
        for (int e = 0; e < W; ++e) acc[i][e] = fmaf(p, vf[u][e], acc[i][e]);
      }
      m[i] = m_new;
    }
    __syncthreads();  // stage t % STAGES is consumed before it is refilled
  }

  // combine the block's lane groups, in group order, in the ring's memory
  float* sm_m = reinterpret_cast<float*>(smem_raw);  // [NG][GM]
  float* sm_l = sm_m + NG * GM;                       // [NG][GM]
  float* sm_acc = sm_l + NG * GM;                     // [NG][GM][HD]
#pragma unroll
  for (int i = 0; i < GM; ++i) {
    if (i >= gh) continue;
    if (active) {
#pragma unroll
      for (int j = 0; j < PPL; ++j)
#pragma unroll
        for (int e = 0; e < EPL; ++e)
          sm_acc[(grp * GM + i) * HD + (li + j * L) * EPL + e] =
              acc[i][j * EPL + e];
    }
    if (li == 0) {
      sm_m[grp * GM + i] = m[i];
      sm_l[grp * GM + i] = l[i];
    }
  }
  __syncthreads();
  T* ob = o + b * o_sb + h0 * o_sh;
  float* rec =
      n_chunks == 1
          ? nullptr
          : part + (static_cast<long long>(bhg) * n_chunks + c) * GM * REC;
  for (int e = tid; e < gh * HD; e += kThreads) {
    const int i = e / HD, d = e % HD;
    float mx = kNegInf;
    for (int r = 0; r < NG; ++r) mx = fmaxf(mx, sm_m[r * GM + i]);
    float ls = 0.f, a = 0.f;
    for (int r = 0; r < NG; ++r) {
      const float w = exp2f(sm_m[r * GM + i] - mx);
      ls = fmaf(sm_l[r * GM + i], w, ls);
      a = fmaf(sm_acc[(r * GM + i) * HD + d], w, a);
    }
    if (n_chunks == 1) {
      put(ob + i * o_sh + d, a / fmaxf(ls, 1e-30f));
      if (lse != nullptr && d == 0)
        lse[b * Hkv * g + h0 + i] = kLn2 * (mx + log2f(ls));
    } else {
      rec[i * REC + 2 + d] = a;
      if (d == 0) {
        rec[i * REC] = mx;
        rec[i * REC + 1] = ls;
      }
    }
  }
  if (n_chunks == 1) return;

  // the block that draws the last ticket combines the chunks
  __threadfence();
  __syncthreads();
  if (tid == 0) sm_last = atomicAdd(tickets + bhg, 1) == n_chunks - 1;
  __syncthreads();
  if (!sm_last) return;
  __threadfence();
  // each chunk's m and l into shared memory (the ring's memory again), the
  // max over the chunks per head (exact in any order), each chunk's weight
  // 2^(m - max) beside its l; then the sums, in chunk order
  const float* base = part + static_cast<long long>(bhg) * n_chunks * GM * REC;
  float* w_s = reinterpret_cast<float*>(smem_raw);  // [n_chunks][GM]
  float* l_s = w_s + n_chunks * GM;                  // [n_chunks][GM]
  __shared__ float mx_s[GM];
  for (int e = tid; e < n_chunks * GM; e += kThreads) {
    const int r = e / GM, i = e % GM;
    w_s[e] = i < gh ? __ldcg(base + (r * GM + i) * REC) : kNegInf;
    l_s[e] = i < gh ? __ldcg(base + (r * GM + i) * REC + 1) : 0.f;
  }
  __syncthreads();
  for (int i = tid >> 5; i < gh; i += kThreads / 32) {
    float mx = kNegInf;
    for (int r = tid & 31; r < n_chunks; r += 32)
      mx = fmaxf(mx, w_s[r * GM + i]);
#pragma unroll
    for (int w = 16; w > 0; w >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
    if ((tid & 31) == 0) mx_s[i] = mx;
  }
  __syncthreads();
  for (int e = tid; e < n_chunks * GM; e += kThreads)
    w_s[e] = exp2f(w_s[e] - mx_s[e % GM]);
  __syncthreads();
  for (int e = tid; e < gh * HD; e += kThreads) {
    const int i = e / HD, d = e % HD;
    float ls = 0.f, a = 0.f;
#pragma unroll 16
    for (int r = 0; r < n_chunks; ++r) {  // chunk order: fixed bits
      const float w = w_s[r * GM + i];
      ls = fmaf(l_s[r * GM + i], w, ls);
      a = fmaf(__ldcg(base + (r * GM + i) * REC + 2 + d), w, a);
    }
    put(ob + i * o_sh + d, a / fmaxf(ls, 1e-30f));
    if (lse != nullptr && d == 0)
      lse[b * Hkv * g + h0 + i] = kLn2 * (mx_s[i] + log2f(ls));
  }
  if (tid == 0) tickets[bhg] = 0;
}

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

template <typename T, int HD, int GM>
int launch(const void* q, const void* k, const void* v, void* o,
           const long long* st, int B, int Hkv, int g, int n_hg, int pos,
           int chunk, int n_chunks, float scale, float* part, int* tickets,
           float* lse, const int* pos_dev, cudaStream_t stream) {
  static std::atomic<unsigned long long> smem_set{0};
  auto kern = decode_kernel<T, HD, GM>;
  constexpr size_t smem = DecodeShape<T, HD, GM>::SMEM;
  cudaError_t err = allow_smem(kern, smem, smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale_log2 =
      scale > 0.0f ? 1.4426950408889634f * scale
                   : 1.4426950408889634f / sqrtf(static_cast<float>(HD));
  kern<<<dim3(B * Hkv * n_hg, n_chunks), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), st[0], st[1], st[2],
      st[3], st[4], st[5], st[6], st[7], st[8], st[9], Hkv, g, n_hg, pos,
      chunk, scale_log2, part, tickets, lse, pos_dev);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int dispatch_gm(int gm, const void* q, const void* k, const void* v, void* o,
                const long long* st, int B, int Hkv, int g, int n_hg, int pos,
                int chunk, int n_chunks, float scale, float* part,
                int* tickets, float* lse, const int* pd, cudaStream_t s) {
  switch (gm) {
    case 1:
      return launch<T, HD, 1>(q, k, v, o, st, B, Hkv, g, n_hg, pos, chunk,
                              n_chunks, scale, part, tickets, lse, pd, s);
    case 2:
      return launch<T, HD, 2>(q, k, v, o, st, B, Hkv, g, n_hg, pos, chunk,
                              n_chunks, scale, part, tickets, lse, pd, s);
    case 4:
      return launch<T, HD, 4>(q, k, v, o, st, B, Hkv, g, n_hg, pos, chunk,
                              n_chunks, scale, part, tickets, lse, pd, s);
    case 8:
      return launch<T, HD, 8>(q, k, v, o, st, B, Hkv, g, n_hg, pos, chunk,
                              n_chunks, scale, part, tickets, lse, pd, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int dispatch_hd(int hd, int gm, const void* q, const void* k, const void* v,
                void* o, const long long* st, int B, int Hkv, int g,
                int n_hg, int pos, int chunk, int n_chunks, float scale,
                float* part, int* tickets, float* lse, const int* pd,
                cudaStream_t s) {
  switch (hd) {
    case 32:
      return dispatch_gm<T, 32>(gm, q, k, v, o, st, B, Hkv, g, n_hg, pos,
                                chunk, n_chunks, scale, part, tickets, lse,
                                pd, s);
    case 64:
      return dispatch_gm<T, 64>(gm, q, k, v, o, st, B, Hkv, g, n_hg, pos,
                                chunk, n_chunks, scale, part, tickets, lse,
                                pd, s);
    case 96:
      return dispatch_gm<T, 96>(gm, q, k, v, o, st, B, Hkv, g, n_hg, pos,
                                chunk, n_chunks, scale, part, tickets, lse,
                                pd, s);
    case 128:
      return dispatch_gm<T, 128>(gm, q, k, v, o, st, B, Hkv, g, n_hg, pos,
                                 chunk, n_chunks, scale, part, tickets, lse,
                                 pd, s);
    case 256:
      return dispatch_gm<T, 256>(gm, q, k, v, o, st, B, Hkv, g, n_hg, pos,
                                 chunk, n_chunks, scale, part, tickets, lse,
                                 pd, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// q: [B,H,hd]; k/v: [B,Hkv,T,hd]; o: [B,H,hd]; all f32 (is_bf16 == 0) or
// all bf16. `strides` holds 10 element strides: q (b, h), k (b, h, t),
// v (b, h, t), o (b, h); hd contiguous. 0 <= pos < T. The plan (from
// decode_attention.py decode_plan): `chunk` slots per chunk, n_chunks =
// ceil((pos + 1) / chunk), `heads` q-heads per block (1, 2, 4 or 8),
// n_hg = ceil(g / heads) head groups. When n_chunks > 1: `part`, f32
// scratch of B * Hkv * n_hg * n_chunks * heads * (hd + 2), and `tickets`,
// B * Hkv * n_hg int32 that are 0 (and are 0 again after the kernel).
// `scale` > 0: the scores' scale; else 1/sqrt(hd).
// `lse`, when not null: f32 [B, H], contiguous, each head's natural-log
// log-sum-exp of its scaled scores over slots 0..pos.
// `pos_dev`, when not null: a device int32 with 0 <= *pos_dev < T, read in
// place of `pos`; `chunk` is then unused and `n_chunks` is decode_plan's
// `want`, the most chunks any pos gives, for which `part` is sized.
// Returns cudaError_t.
int decode_attention_fwd(const void* q, const void* k, const void* v,
                         void* o, const long long* strides, int is_bf16,
                         int B, int H, int Hkv, int hd, int pos, int chunk,
                         int n_chunks, int heads, float scale, void* part,
                         void* tickets, void* lse, const void* pos_dev,
                         void* stream) {
  if (B == 0 || H == 0) return 0;
  const int g = H / Hkv;
  const int n_hg = (g + heads - 1) / heads;
  if (heads < 1 || n_chunks < 1 || n_chunks > kMaxChunks ||
      (pos_dev == nullptr && (chunk < 1 || n_chunks != pos / chunk + 1)) ||
      (n_chunks > 1 && (part == nullptr || tickets == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int* pd = static_cast<const int*>(pos_dev);
  float* pa = static_cast<float*>(part);
  int* tk = static_cast<int*>(tickets);
  float* ls = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch_hd<uint16_t>(hd, heads, q, k, v, o, strides, B, Hkv, g,
                                 n_hg, pos, chunk, n_chunks, scale, pa, tk,
                                 ls, pd, s);
  return dispatch_hd<float>(hd, heads, q, k, v, o, strides, B, Hkv, g, n_hg,
                            pos, chunk, n_chunks, scale, pa, tk, ls, pd, s);
}

}  // extern "C"
