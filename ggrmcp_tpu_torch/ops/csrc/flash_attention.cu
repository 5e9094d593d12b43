// Blockwise FlashAttention forward for Hopper (sm_90a), plain C entry.
//
// Replaces: ggrmcp_tpu/ops/attention.py::_flash_kernel, the Pallas TPU
// kernel launched by flash_attention (pallas_call at attention.py:286).
// Same contract: q [B, Sq, H, D], k/v [B, Sk, KVH, D] with H % KVH == 0
// (query head h reads KV head h / (H / KVH), K/V never repeated);
// per-batch q_offset[B] (absolute position of q[0]) and kv_len[B]
// (valid key prefix); mask k < kv_len, plus q_pos >= k_pos when causal,
// plus k_pos > q_pos - window when windowed; f32 running max,
// denominator and accumulator; rows with no valid key are written as 0.
// Two changes from the TPU contract: Sq and Sk need not be multiples of
// the tile (the ragged edge is masked here), and q/k/v may be strided
// views (any batch/sequence/head strides; the head_dim stride must be 1).
//
// Two kernels behind one entry.
//
// bfloat16 (the serving path; D = 32, 64, 128): the Hopper layout of a
// ring of TMA-fed shared-memory tiles, a producer warpgroup and two
// consumer warpgroups on wgmma. Tiles are 128 query rows of one query
// head of one batch row; the k loop uses the TPU kernel's bounds (it
// stops at min(kv_len, q_off + q_start + 128, Sk) under causality and,
// with a window, starts at the 128-key tile holding the first row's
// window start), so causal and windowed prefill skip dead tiles.
//   - Producer: one thread issues TMA loads of rank-4 tensor maps
//     (D, heads, seq, batch) built per call from the views' strides:
//     the Q tile once per output tile, K and V tiles of 128 keys into a
//     two-stage ring each, every stage with a "full" mbarrier (armed with
//     the byte count) and an "empty" one (every consumer warp arrives
//     once its wgmma reading the stage has retired). The seq extent is the
//     view's own, so the ragged edge is zero-filled by TMA and the cache's
//     scratch position past Sk is never read.
//   - Consumers: 64 query rows each. S = Q K^T is wgmma m64n128k16 with Q
//     and K K-major in shared memory (128-byte swizzle, 64-byte at D=32)
//     and an f32 accumulator; the online softmax runs in f32 in the exp2
//     domain on the accumulator fragments; O += P V is wgmma with P
//     rounded to bf16 in registers (the TPU kernel keeps it f32; against
//     the f32 plain version that costs well under one bf16 output step)
//     and V MN-major from shared memory (the transpose bit). Only tiles
//     that cross kv_len, the diagonal or the window's lower edge test
//     each element. The two consumer warpgroups take turns at the tensor
//     cores (named barriers), so that one's softmax overlaps the other's
//     products. The output goes through swizzled shared memory (stmatrix)
//     and out by a TMA store, which clips rows past Sq.
//   - setmaxnreg moves registers from the producer (40) to the consumers
//     (232); one branch per role, never rejoined.
//   - Persistent blocks (one per SM) walk the tiles with the query heads
//     of one KV head side by side (their K/V tiles meet in L2) and, under
//     causality, the longest q-tiles first. Three Q buffers rotate, so the
//     next tile's Q and K/V load during this one; a tile's last P V is
//     issued with the next tile's first Q K^T, and its output is stored
//     while that runs.
// float32 (the tiny configs): one block per (64 query rows, query head,
//   batch row), CUDA-core FMAs on f32 tiles in shared memory, 256
//   threads, 4x4 scores per thread; no tensor cores, which would round to
//   TF32.
// bf16 views need a 16-byte-aligned base and strides that are multiples
// of 16 bytes (TMA's rule; the wrapper copies a view that breaks it).
//
// Bound on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s HBM) at the
// main path's shapes (llama3-8b: H=32, KVH=8, D=128, bf16):
//   operations  4 * B * H * Sq * Sk_eff * D  (Sk_eff = keys each query
//               row really attends, ~Sk/2 for causal fresh prefill)
//   bytes       Q + K + V + O = 2 * D * (2 * B * Sq * H + 2 * B * Sk * KVH)
// e.g. fused admission [32, 512]: 4*32*32*512*256.5*128 = 68.9 GFLOP ->
// 0.070 ms on the tensor cores vs 335.5 MB -> 0.100 ms of HBM: bound by
// bytes. The 6th chunk of a chunked admission, [4, 512] at q_offset
// 2560 over kv_len 3072: 94.5 GFLOP -> 0.096 ms vs 84 MB -> 0.025 ms:
// bound by operations. chip_smoke.py computes the bound of every case
// from its own inputs.
//
// What this design still leaves on the table (work for a later change):
// the softmax of a step does not overlap that warpgroup's own products
// (only the other warpgroup's), the causal diagonal tile is computed
// whole, the K/V tiles are fetched once per query head (the four heads of
// a KV head share them through L2, not shared memory), and persistent
// blocks take tiles in a fixed round-robin rather than from a queue.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per K/V tile
constexpr int THREADS = 256;  // 16 x 16 thread grid
constexpr float NEG_INF = -1e30f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const int* q_offset;
  const int* kv_len;
  int sq, sk, h, kvh;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int causal, window;
};

template <int D>
constexpr size_t smem_bytes() {
  // Qs [BQ][D+1], Ks [BK][D+1], Vs [BK][D], Ps [BQ][BK+1], row stats 3*BQ
  return sizeof(float) *
         (BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1) + 3 * BQ);
}

// ---------------------------------------------------------------------------
// float32: CUDA cores (the tensor cores would round to TF32).
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const Args a) {
  extern __shared__ float smem[];
  float* Qs = smem;                       // [BQ][D+1]
  float* Ks = Qs + BQ * (D + 1);          // [BK][D+1]
  float* Vs = Ks + BK * (D + 1);          // [BK][D]
  float* Ps = Vs + BK * D;                // [BQ][BK+1]
  float* row_m = Ps + BQ * (BK + 1);      // [BQ] running max
  float* row_l = row_m + BQ;              // [BQ] running denominator
  float* row_alpha = row_l + BQ;          // [BQ] this tile's rescale

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int q_start = blockIdx.x * BQ;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int kv_head = head / (a.h / a.kvh);
  const int q_off = a.q_offset[b];
  const int limit = a.kv_len[b];
  const float scale = (float)(1.0 / sqrt((double)D));

  const float* q =
      static_cast<const float*>(a.q) + b * a.q_sb + head * a.q_sh;
  const float* k =
      static_cast<const float*>(a.k) + b * a.k_sb + kv_head * a.k_sh;
  const float* v =
      static_cast<const float*>(a.v) + b * a.v_sb + kv_head * a.v_sh;
  float* o = static_cast<float*>(a.o) + b * a.o_sb + head * a.o_sh;

  // Stage the (pre-scaled) q tile; rows past Sq load as zeros.
  for (int idx = tid; idx < BQ * D; idx += THREADS) {
    const int r = idx / D, d = idx % D;
    const int qr = q_start + r;
    Qs[r * (D + 1) + d] =
        qr < a.sq ? q[(long long)qr * a.q_ss + d] * scale : 0.f;
  }
  if (tid < BQ) {
    row_m[tid] = NEG_INF;
    row_l[tid] = 0.f;
  }

  // Loop bounds of the TPU kernel.
  int kv_limit = limit;
  if (a.causal) kv_limit = min(kv_limit, q_off + q_start + BQ);
  kv_limit = min(kv_limit, a.sk);
  const int num_iters = kv_limit > 0 ? (kv_limit + BK - 1) / BK : 0;
  int start_iter = 0;
  if (a.window > 0) start_iter = max(q_off + q_start - a.window + 1, 0) / BK;

  constexpr int DC = D / 16;  // output columns per thread
  float acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DC; ++j) acc[i][j] = 0.f;

  for (int kb = start_iter; kb < num_iters; ++kb) {
    const int k_start = kb * BK;
    __syncthreads();  // previous tile's Ks/Vs/Ps reads are done
    for (int idx = tid; idx < BK * D; idx += THREADS) {
      const int c = idx / D, d = idx % D;
      const int kp = k_start + c;
      float kv = 0.f, vv = 0.f;
      if (kp < a.sk) {
        kv = k[(long long)kp * a.k_ss + d];
        vv = v[(long long)kp * a.v_ss + d];
      }
      Ks[c * (D + 1) + d] = kv;
      Vs[c * D + d] = vv;
    }
    __syncthreads();

    // Scores: rows ty + 16 i, keys tx + 16 j.
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int q_pos = q_off + q_start + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int k_pos = k_start + c;
        bool ok = k_pos < limit && k_pos < a.sk;
        if (a.causal) {
          ok = ok && q_pos >= k_pos;
          if (a.window > 0) ok = ok && k_pos > q_pos - a.window;
        }
        Ps[r * (BK + 1) + c] = ok ? s[i][j] : NEG_INF;
      }
    }
    __syncthreads();

    // Online softmax: 4 threads per row, 16 keys each.
    {
      const int r = tid / 4;
      const int part = tid % 4;
      float* prow = Ps + r * (BK + 1) + part * 16;
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < 16; ++c) mx = fmaxf(mx, prow[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = row_m[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const float p = expf(prow[c] - m_new);
        prow[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      __syncwarp();
      if (part == 0) {
        const float alpha = expf(m_prev - m_new);
        row_alpha[r] = alpha;
        row_l[r] = row_l[r] * alpha + sum;
        row_m[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P @ V
    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) alpha[i] = row_alpha[ty + 16 * i];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < DC; ++j) acc[i][j] *= alpha[i];
#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float p[4], vv[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty + 16 * i) * (BK + 1) + c];
#pragma unroll
      for (int j = 0; j < DC; ++j) vv[j] = Vs[c * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DC; ++j) acc[i][j] = fmaf(p[i], vv[j], acc[i][j]);
    }
  }
  __syncthreads();

  // Epilogue: rows whose running max never left NEG_INF saw no valid key.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int qr = q_start + r;
    if (qr >= a.sq) continue;
    const bool live = row_m[r] > NEG_INF / 2;
    const float inv = 1.f / fmaxf(row_l[r], 1e-30f);
    float* orow = o + (long long)qr * a.o_ss;
#pragma unroll
    for (int j = 0; j < DC; ++j)
      orow[tx + 16 * j] = live ? acc[i][j] * inv : 0.f;
  }
}

// ---------------------------------------------------------------------------
// bfloat16: TMA-fed wgmma, one producer and two consumer warpgroups.
// ---------------------------------------------------------------------------

namespace wg {

using namespace hopper;

constexpr int BQ = 128;       // query rows per tile: 64 per consumer warpgroup
constexpr int BK = 128;       // keys per K/V tile
constexpr int STAGES = 2;     // depth of the K and V rings
constexpr int QBUF = 3;       // Q tiles in flight (each stages its output)
constexpr int CONSUMERS = 2;  // consumer warpgroups
constexpr int THREADS = 128 * (1 + CONSUMERS);
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
// Named barriers (0 is __syncthreads'): 1 + c for consumer c's epilogue,
// SCHED + c for consumer c's turn at the tensor cores.
constexpr int SCHED = 1 + CONSUMERS;

// Shared memory of one block, from a 1024-byte-aligned base. A tile of
// R rows is NCH column chunks of CHUNK elements, each chunk R swizzled
// rows of ROWB bytes (one TMA box wide): chunk c starts at c * R * ROWB.
// QBUF Q tiles rotate over the output tiles: one is computed on, the
// next is loaded ahead, and the one before is still being stored (each
// Q tile also stages its output tile).
template <int D>
struct Smem {
  static constexpr int CHUNK = D < 64 ? D : 64;
  static constexpr int ROWB = 2 * CHUNK;  // 128 (128-byte swizzle) or 64
  static constexpr int NCH = D / CHUNK;
  static constexpr uint32_t LAYOUT = ROWB == 128 ? 1 : 2;  // wgmma swizzle
  static constexpr uint32_t SBO = 8 * ROWB;  // one swizzle atom
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;  // one K or V tile
  static constexpr int Q = 0;                   // QBUF Q (and output) tiles
  static constexpr int K = Q + QBUF * Q_BYTES;  // STAGES K tiles
  static constexpr int V = K + STAGES * KV_BYTES;  // STAGES V tiles
  static constexpr int BAR = V + STAGES * KV_BYTES;
  static constexpr int BYTES =
      BAR + 8 * (4 * STAGES + 2 * QBUF) + 1024;  // + alignment
};

// The block's mbarriers (shared addresses; entry i of each at + 8 i).
struct Bars {
  uint32_t k_full, k_empty, v_full, v_empty, q_full, q_empty;
  __device__ explicit Bars(uint32_t bar)
      : k_full(bar),
        k_empty(bar + 8 * STAGES),
        v_full(bar + 16 * STAGES),
        v_empty(bar + 24 * STAGES),
        q_full(bar + 32 * STAGES),
        q_empty(bar + 32 * STAGES + 8 * QBUF) {}
};

// The swizzle TMA applies to a byte offset from an atom-aligned base.
template <int ROWB>
__device__ __forceinline__ uint32_t swizzle(uint32_t off) {
  return off ^ (((off >> 7) & (ROWB == 128 ? 7 : 3)) << 4);
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// 1 / x in one instruction (IEEE division adds a slow-path subroutine).
__device__ __forceinline__ float rcp(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One output tile (query head, batch row, BQ query rows) and its k-loop
// bounds, which are the TPU kernel's: stop at min(kv_len, q_off +
// q_start + BQ, Sk) under causality; with a window, start at the tile
// holding the first row's window start. Tiles are numbered with the
// query heads innermost (the heads that share a KV head run side by
// side and meet its tiles in L2) and, under causality, the longest
// q-tiles first.
struct Tile {
  int head, b, q_start, q_off, limit, it_begin, it_end;
};

__device__ __forceinline__ Tile tile_at(const Args& a, int batch, int idx) {
  const int n_qt = (a.sq + BQ - 1) / BQ;
  Tile t;
  t.head = idx % a.h;
  idx /= a.h;
  t.b = idx % batch;
  idx /= batch;
  t.q_start = (a.causal ? n_qt - 1 - idx : idx) * BQ;
  t.q_off = a.q_offset[t.b];
  t.limit = min(a.kv_len[t.b], a.sk);
  int kv_limit = t.limit;
  if (a.causal) kv_limit = min(kv_limit, t.q_off + t.q_start + BQ);
  t.it_end = kv_limit > 0 ? (kv_limit + BK - 1) / BK : 0;
  t.it_begin =
      a.window > 0 ? max(t.q_off + t.q_start - a.window + 1, 0) / BK : 0;
  return t;
}

// The producer: one thread keeps the rings full with TMA loads: the Q
// tile of each output tile (into the buffer of the tile QBUF back, once
// that tile's output has left), then its K and V tiles, each into the
// stage the consumers released last.
template <int D>
__device__ __forceinline__ void produce(const CUtensorMap* qm,
                                        const CUtensorMap* km,
                                        const CUtensorMap* vm, const Args& a,
                                        int batch, int n_tiles, uint32_t base) {
  using S = Smem<D>;
  const Bars bars(base + S::BAR);
  tma_prefetch(qm);
  tma_prefetch(km);
  tma_prefetch(vm);
  const int group = a.h / a.kvh;
  int n = 0;  // K/V tiles loaded by this block
  int local = 0;
  for (int idx = blockIdx.x; idx < n_tiles; idx += gridDim.x, ++local) {
    const Tile t = tile_at(a, batch, idx);
    const int kv_head = t.head / group;
    const int qb = local % QBUF;
    mbar_wait(bars.q_empty + 8 * qb, ((local / QBUF) & 1) ^ 1);
    mbar_arrive_expect_tx(bars.q_full + 8 * qb, S::Q_BYTES);
#pragma unroll
    for (int c = 0; c < S::NCH; ++c)
      tma_load_4d(base + S::Q + qb * S::Q_BYTES + c * BQ * S::ROWB, qm,
                  bars.q_full + 8 * qb, c * S::CHUNK, t.head, t.q_start, t.b);
    for (int it = t.it_begin; it < t.it_end; ++it, ++n) {
      const int st = n % STAGES;
      const uint32_t par = ((n / STAGES) & 1) ^ 1;
      mbar_wait(bars.k_empty + 8 * st, par);
      mbar_arrive_expect_tx(bars.k_full + 8 * st, S::KV_BYTES);
#pragma unroll
      for (int c = 0; c < S::NCH; ++c)
        tma_load_4d(base + S::K + st * S::KV_BYTES + c * BK * S::ROWB, km,
                    bars.k_full + 8 * st, c * S::CHUNK, kv_head, it * BK, t.b);
      mbar_wait(bars.v_empty + 8 * st, par);
      mbar_arrive_expect_tx(bars.v_full + 8 * st, S::KV_BYTES);
#pragma unroll
      for (int c = 0; c < S::NCH; ++c)
        tma_load_4d(base + S::V + st * S::KV_BYTES + c * BK * S::ROWB, vm,
                    bars.v_full + 8 * st, c * S::CHUNK, kv_head, it * BK, t.b);
    }
  }
}

// O[64 x D] += P[64 x 16] V[16 x D]; V MN-major in shared memory.
template <int D>
__device__ __forceinline__ void mma_pv(float (&o)[D / 2],
                                       const uint32_t (&p)[4],
                                       uint64_t desc_v) {
  if constexpr (D == 128) wgmma_m64n128k16_rs(o, p, desc_v);
  if constexpr (D == 64) wgmma_m64n64k16_rs(o, p, desc_v);
  if constexpr (D == 32) wgmma_m64n32k16_rs(o, p, desc_v);
}

// Issue S = Q K^T (64 x BK, f32; Q and K K-major) as one wgmma group.
template <int D>
__device__ __forceinline__ void issue_qk(float (&s)[BK / 2], uint32_t q,
                                         uint32_t k) {
  using S = Smem<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 / S::CHUNK, e = (kk * 16 % S::CHUNK) * 2;
    wgmma_m64n128k16_ss(
        s, smem_desc(q + c * BQ * S::ROWB + e, 16, S::SBO, S::LAYOUT),
        smem_desc(k + c * BK * S::ROWB + e, 16, S::SBO, S::LAYOUT), kk > 0);
  }
  wgmma_commit();
}

// Issue O += P V (P in registers, V MN-major) as one wgmma group.
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2],
                                         const uint32_t (&p)[BK / 16][4],
                                         uint32_t v) {
  using S = Smem<D>;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    mma_pv<D>(o, p[kk],
              smem_desc(v + kk * 16 * S::ROWB, BK * S::ROWB, S::SBO,
                        S::LAYOUT));
  wgmma_commit();
}

// The rows of one consumer thread and its online-softmax state. Thread
// (warp w, lane 4g + t) of a consumer warpgroup holds rows 16w + g
// (ri = 0) and 16w + g + 8 (ri = 1) of the wgmma accumulators, columns
// 8j + 2t and 8j + 2t + 1 for every j.
struct Rows {
  int q_lo;   // position of the warpgroup's first row
  int q_row;  // position of this thread's row ri = 0 (ri = 1 adds 8)
  int t4;
  float m[2];  // running max of the raw scores
  float l[2];  // running denominator, this thread's columns only

  // Mask the scores of K tile `it`, fold them into m and l, leave
  // exp2((s - m) * scale * log2 e) in s (one FFMA and one ex2 each) and
  // O's rescale in alpha. Tiles wholly inside every row's valid range
  // skip the mask; the others keep key k of a row when lo <= k < hi.
  __device__ __forceinline__ void softmax(float (&s)[BK / 2],
                                          float (&alpha)[2], const Args& a,
                                          const Tile& t, int it,
                                          float scale_log2) {
    const int k0 = it * BK;
    const bool whole =
        k0 + BK <= t.limit && (!a.causal || k0 + BK - 1 <= q_lo) &&
        (a.window <= 0 || k0 > q_lo + 63 - a.window);
    if (!whole) {
#pragma unroll
      for (int ri = 0; ri < 2; ++ri) {
        const int qp = q_row + 8 * ri;
        const int hi = a.causal ? min(t.limit, qp + 1) : t.limit;
        const int lo = a.causal && a.window > 0 ? qp - a.window + 1 : 0;
#pragma unroll
        for (int j = 0; j < BK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kp = k0 + 8 * j + 2 * t4 + e;
            float& x = s[4 * j + 2 * ri + e];
            x = kp >= lo && kp < hi ? x : NEG_INF;
          }
      }
    }
    // The four threads of a row combine their maxima by shuffles.
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
        mx = fmaxf(mx, fmaxf(s[4 * j + 2 * ri], s[4 * j + 2 * ri + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[ri], mx);
      alpha[ri] = ex2((m[ri] - m_new) * scale_log2);
      m[ri] = m_new;
      // A row with no valid key yet keeps exp2 of the masked scores at 0.
      const float m_scaled = m_new > NEG_INF / 2 ? m_new * scale_log2 : 0.f;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float x =
              ex2(fmaf(s[4 * j + 2 * ri + e], scale_log2, -m_scaled));
          s[4 * j + 2 * ri + e] = x;
          sum += x;
        }
      l[ri] = l[ri] * alpha[ri] + sum;
    }
  }
};

// P rounded to bf16: the score accumulators are the A fragments (the
// accumulator and A layouts agree for 16-bit A).
__device__ __forceinline__ void pack_p(uint32_t (&p)[BK / 16][4],
                                       const float (&s)[BK / 2]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      p[kk][r] = pack(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
}

template <int N>
__device__ __forceinline__ void rescale(float (&o)[N], const float (&alpha)[2]) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    o[4 * j] *= alpha[0];
    o[4 * j + 1] *= alpha[0];
    o[4 * j + 2] *= alpha[1];
    o[4 * j + 3] *= alpha[1];
  }
}

// A consumer warpgroup: 64 query rows of every tile of this block.
//
// Step i > 0 of a tile issues S_i = Q K_i^T and then O += P_{i-1} V_{i-1},
// waits for both and runs the softmax of S_i; a tile's last P V goes out
// with the next tile's S_0, and the tile's output is written while S_0
// runs. The two consumer warpgroups take turns to issue (named
// barriers SCHED + c), so that one's softmax overlaps the other's
// products. (Overlapping the softmax with P_{i-1} V_{i-1} inside one
// warpgroup measured no faster on the H100: the other warpgroup already
// keeps the tensor cores busy then.) Every wgmma group is waited for on
// straight-line code, and O and P are fenced before each wgmma.fence:
// ptxas serialises the wgmma otherwise.
template <int D>
__device__ __forceinline__ void consume(const CUtensorMap* om, const Args& a,
                                        int batch, int n_tiles, uint32_t base,
                                        int cw) {
  using S = Smem<D>;
  const Bars bars(base + S::BAR);
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t4 = lane & 3;
  // Scores go to the exp2 domain: exp(x * scale) = exp2(x * scale * log2 e).
  const float scale_log2 = (float)(1.4426950408889634 / sqrt((double)D));
  const uint32_t k_base = base + S::K, v_base = base + S::V;
  // This warpgroup's rows of the Q tile of the block's output tile
  // `local`, which later stage that tile's output.
  auto q_rows = [&](int local) {
    return base + S::Q + (local % QBUF) * S::Q_BYTES + cw * 64 * S::ROWB;
  };
  auto start = [&](Rows& rows, float (&o)[D / 2], const Tile& t) {
    rows.q_lo = t.q_off + t.q_start + cw * 64;
    rows.q_row = rows.q_lo + warp * 16 + g;
    rows.t4 = t4;
    rows.m[0] = rows.m[1] = NEG_INF;
    rows.l[0] = rows.l[1] = 0.f;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  };
  // Output tile `local`: full denominators, rows with no valid key
  // written as 0, through its Q buffer swizzled as TMA reads it (stmatrix:
  // one instruction per 16 x 16 block) and out by TMA, which clips rows
  // past Sq.
  auto write_output = [&](const Rows& rows, const float (&o)[D / 2],
                          const Tile& t, int local) {
    float inv[2];
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      float l = rows.l[ri];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      inv[ri] = rows.m[ri] > NEG_INF / 2 ? rcp(fmaxf(l, 1e-30f)) : 0.f;
    }
    // Lane l addresses row l % 8 (+ 8 for odd l / 8) of column block
    // l / 16 of each 16 x 16 block.
    const int mi = lane >> 3;
    const uint32_t row = (warp * 16 + (lane & 7) + 8 * (mi & 1)) * S::ROWB;
    const uint32_t rows_addr = q_rows(local);
#pragma unroll
    for (int j = 0; j < D / 8; j += 2) {
      const int col = 8 * (j + (mi >> 1));
      stmatrix_x4(rows_addr + (col / S::CHUNK) * BQ * S::ROWB +
                      swizzle<S::ROWB>(row + (col % S::CHUNK) * 2),
                  pack(o[4 * j] * inv[0], o[4 * j + 1] * inv[0]),
                  pack(o[4 * j + 2] * inv[1], o[4 * j + 3] * inv[1]),
                  pack(o[4 * j + 4] * inv[0], o[4 * j + 5] * inv[0]),
                  pack(o[4 * j + 6] * inv[1], o[4 * j + 7] * inv[1]));
    }
    fence_proxy_async();
    bar_sync(1 + cw, 128);
    if (tid == 0) {
#pragma unroll
      for (int c = 0; c < S::NCH; ++c)
        tma_store_4d(om, rows_addr + c * BQ * S::ROWB, c * S::CHUNK, t.head,
                     t.q_start + cw * 64, t.b);
      tma_store_commit();
    }
  };
  // The previous tile's output store must have read its Q buffer before
  // the producer may refill it; tile `local` checks that at its end, long
  // after the store went out (its own store is not yet committed).
  auto release_prev_q = [&](int local) {
    if (tid == 0 && local > 0) {
      tma_store_wait_read();
      mbar_arrive(bars.q_empty + 8 * ((local - 1) % QBUF));
    }
  };

  if (cw == 1) bar_arrive(SCHED, 256);  // consumer 0 issues first
  int idx = blockIdx.x;
  if (idx >= n_tiles) return;
  int n = 0;  // K/V tiles consumed by this block
  int local = 0;
  Tile t = tile_at(a, batch, idx);
  Rows rows;
  float o[D / 2];
  float s[BK / 2];
  uint32_t p[BK / 16][4];  // P of the previous step as bf16 A fragments
  float alpha[2];
  start(rows, o, t);

  mbar_wait(bars.q_full, 0);
  if (t.it_begin < t.it_end) {  // S_0 of the block's first tile
    mbar_wait(bars.k_full, 0);
    bar_sync(SCHED + cw, 256);
    wgmma_fence();
    issue_qk<D>(s, q_rows(0), k_base);
    bar_arrive(SCHED + (cw ^ 1), 256);
    wgmma_wait<0>();
    fence_regs(s);
    if (lane == 0) mbar_arrive(bars.k_empty);
    rows.softmax(s, alpha, a, t, t.it_begin, scale_log2);  // O is 0
    pack_p(p, s);
    n = 1;
  }
  while (true) {
    for (int it = t.it_begin + 1; it < t.it_end; ++it, ++n) {
      const int st = n % STAGES, pst = (n - 1) % STAGES;
      mbar_wait(bars.k_full + 8 * st, (n / STAGES) & 1);
      bar_sync(SCHED + cw, 256);
      fence_regs(o);
      fence_regs(p);
      wgmma_fence();
      issue_qk<D>(s, q_rows(local), k_base + st * S::KV_BYTES);
      mbar_wait(bars.v_full + 8 * pst, ((n - 1) / STAGES) & 1);
      issue_pv<D>(o, p, v_base + pst * S::KV_BYTES);
      bar_arrive(SCHED + (cw ^ 1), 256);
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(o);
      fence_regs(p);
      if (lane == 0) {
        mbar_arrive(bars.k_empty + 8 * st);
        mbar_arrive(bars.v_empty + 8 * pst);
      }
      rows.softmax(s, alpha, a, t, it, scale_log2);
      rescale(o, alpha);
      pack_p(p, s);
    }

    // The tail: t's last P V, the next tile u's S_0, t's output.
    const int next = idx + gridDim.x;
    const bool more = next < n_tiles;
    const Tile u = tile_at(a, batch, more ? next : idx);
    const bool t_steps = t.it_begin < t.it_end;
    const bool u_steps = more && u.it_begin < u.it_end;
    if (t_steps && u_steps) {
      const int st = n % STAGES, pst = (n - 1) % STAGES;
      mbar_wait(bars.q_full + 8 * ((local + 1) % QBUF),
                ((local + 1) / QBUF) & 1);
      mbar_wait(bars.k_full + 8 * st, (n / STAGES) & 1);
      mbar_wait(bars.v_full + 8 * pst, ((n - 1) / STAGES) & 1);
      bar_sync(SCHED + cw, 256);
      fence_regs(o);
      fence_regs(p);
      wgmma_fence();
      issue_pv<D>(o, p, v_base + pst * S::KV_BYTES);
      issue_qk<D>(s, q_rows(local + 1), k_base + st * S::KV_BYTES);
      bar_arrive(SCHED + (cw ^ 1), 256);
      release_prev_q(local);
      wgmma_wait<1>();  // t's last P V is done; u's S_0 may still run
      fence_regs(o);
      fence_regs(p);
      if (lane == 0) mbar_arrive(bars.v_empty + 8 * pst);
      write_output(rows, o, t, local);
      wgmma_wait<0>();
      fence_regs(s);
      if (lane == 0) mbar_arrive(bars.k_empty + 8 * st);
      start(rows, o, u);
      rows.softmax(s, alpha, a, u, u.it_begin, scale_log2);  // O is 0
      pack_p(p, s);
      ++n;
    } else {  // a tile without keys, or the block's last tile
      if (t_steps) {
        const int pst = (n - 1) % STAGES;
        mbar_wait(bars.v_full + 8 * pst, ((n - 1) / STAGES) & 1);
        fence_regs(o);
        fence_regs(p);
        wgmma_fence();
        issue_pv<D>(o, p, v_base + pst * S::KV_BYTES);
        wgmma_wait<0>();
        fence_regs(o);
        fence_regs(p);
        if (lane == 0) mbar_arrive(bars.v_empty + 8 * pst);
      }
      release_prev_q(local);
      write_output(rows, o, t, local);
      if (more) {
        start(rows, o, u);
        mbar_wait(bars.q_full + 8 * ((local + 1) % QBUF),
                  ((local + 1) / QBUF) & 1);
      }
      if (u_steps) {
        const int st = n % STAGES;
        mbar_wait(bars.k_full + 8 * st, (n / STAGES) & 1);
        bar_sync(SCHED + cw, 256);
        wgmma_fence();
        issue_qk<D>(s, q_rows(local + 1), k_base + st * S::KV_BYTES);
        bar_arrive(SCHED + (cw ^ 1), 256);
        wgmma_wait<0>();
        fence_regs(s);
        if (lane == 0) mbar_arrive(bars.k_empty + 8 * st);
        rows.softmax(s, alpha, a, u, u.it_begin, scale_log2);  // O is 0
        pack_p(p, s);
        ++n;
      }
    }
    if (!more) break;
    t = u;
    idx = next;
    ++local;
  }
  if (tid == 0) tma_store_wait_read();
}

// Persistent: each block walks tiles blockIdx.x, + gridDim.x, ... so that
// one tile's end overlaps the next tile's loads and first product.
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_wg_kernel(const __grid_constant__ CUtensorMap qm,
                    const __grid_constant__ CUtensorMap km,
                    const __grid_constant__ CUtensorMap vm,
                    const __grid_constant__ CUtensorMap om, const Args a,
                    int batch, int n_tiles) {
  using S = Smem<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  if (threadIdx.x == 0) {
    const Bars bars(base + S::BAR);
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(bars.k_full + 8 * i, 1);  // the producer's arrive + bytes
      mbar_init(bars.v_full + 8 * i, 1);
      mbar_init(bars.k_empty + 8 * i, 4 * CONSUMERS);  // one per warp
      mbar_init(bars.v_empty + 8 * i, 4 * CONSUMERS);
    }
    for (int i = 0; i < QBUF; ++i) {
      mbar_init(bars.q_full + 8 * i, 1);
      mbar_init(bars.q_empty + 8 * i, CONSUMERS);  // once the output left
    }
    mbar_fence_init();
  }
  __syncthreads();
  // One branch per role, never rejoined, so that ptxas can honour
  // setmaxnreg.
  if (threadIdx.x < 128) {
    regs_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) produce<D>(&qm, &km, &vm, a, batch, n_tiles, base);
  } else {
    regs_inc<CONSUMER_REGS>();
    consume<D>(&om, a, batch, n_tiles, base, threadIdx.x / 128 - 1);
  }
}

}  // namespace wg

template <int D>
int launch(const Args& a, int batch, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.sq + BQ - 1) / BQ, a.h, batch);
  flash_fwd_kernel<D><<<grid, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// Error codes besides cudaError_t values (all > 0).
constexpr int ERR_UNSUPPORTED = -1;  // dtype, head_dim or shape
constexpr int ERR_NO_ENCODER = -2;   // cuTensorMapEncodeTiled not found
constexpr int ERR_ENCODE = -1000;    // minus the CUresult of a failed encoding

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API function; it is taken through
// the runtime's entry-point query, so the library needs no -lcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A rank-4 map (D, heads, seq, batch) over a [batch, seq, heads, D] bf16
// view with element strides sb, ss, sh and unit stride over D; boxes of
// CHUNK x 1 head x `rows` x 1 batch row, swizzled as wgmma reads them.
// The seq extent is the view's own, so a box past it is zero-filled on
// load and clipped on store.
template <int D>
int encode_map(CUtensorMap* map, const void* ptr, int batch, int seq,
               int heads, long long sb, long long ss, long long sh, int rows,
               CUtensorMapL2promotion l2) {
  using S = wg::Smem<D>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return ERR_NO_ENCODER;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads,
                              (cuuint64_t)(seq > 0 ? seq : 1),
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)ss * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)S::CHUNK, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      S::ROWB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
      l2, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_ENCODE - (int)r;
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      sms = 0;
  }
  return sms;
}

template <int D>
int launch_wg(const Args& a, int batch, cudaStream_t stream) {
  using S = wg::Smem<D>;
  CUtensorMap qm, km, vm, om;
  int err;
  if ((err = encode_map<D>(&qm, a.q, batch, a.sq, a.h, a.q_sb, a.q_ss,
                           a.q_sh, wg::BQ,
                           CU_TENSOR_MAP_L2_PROMOTION_L2_128B)) != 0 ||
      (err = encode_map<D>(&km, a.k, batch, a.sk, a.kvh, a.k_sb, a.k_ss,
                           a.k_sh, wg::BK,
                           CU_TENSOR_MAP_L2_PROMOTION_L2_256B)) != 0 ||
      (err = encode_map<D>(&vm, a.v, batch, a.sk, a.kvh, a.v_sb, a.v_ss,
                           a.v_sh, wg::BK,
                           CU_TENSOR_MAP_L2_PROMOTION_L2_256B)) != 0 ||
      (err = encode_map<D>(&om, a.o, batch, a.sq, a.h, a.o_sb, a.o_ss,
                           a.o_sh, 64, CU_TENSOR_MAP_L2_PROMOTION_NONE)) != 0)
    return err;
  const cudaError_t ce = cudaFuncSetAttribute(
      wg::flash_fwd_wg_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      S::BYTES);
  if (ce != cudaSuccess) return (int)ce;
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  const int n_tiles = a.h * batch * ((a.sq + wg::BQ - 1) / wg::BQ);
  const int grid = n_tiles < sms ? n_tiles : sms;
  wg::flash_fwd_wg_kernel<D><<<grid, wg::THREADS, S::BYTES, stream>>>(
      qm, km, vm, om, a, batch, n_tiles);
  return (int)cudaGetLastError();
}

int dispatch(const Args& a, int batch, int d, int dtype, cudaStream_t s) {
  if (dtype == 0) {
    switch (d) {
      case 32: return launch<32>(a, batch, s);
      case 64: return launch<64>(a, batch, s);
      case 128: return launch<128>(a, batch, s);
    }
  } else if (dtype == 1) {
    switch (d) {
      case 32: return launch_wg<32>(a, batch, s);
      case 64: return launch_wg<64>(a, batch, s);
      case 128: return launch_wg<128>(a, batch, s);
    }
  }
  return ERR_UNSUPPORTED;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. window <= 0 = no window. Strides
// are in elements; bf16 strides of size-1 dims must still be multiples
// of 8 (TMA takes every stride). Returns 0 on success, a cudaError_t
// value when a launch or attribute was refused, -1 for an unsupported
// dtype / head_dim / shape, -2 when the driver has no
// cuTensorMapEncodeTiled, or -1000 - CUresult when a tensor map could
// not be encoded.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o,
    const int* q_offset, const int* kv_len,
    int batch, int sq, int sk, int h, int kvh, int d,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    int causal, int window, int dtype, void* stream) {
  if (batch <= 0 || sq <= 0 || h <= 0 || kvh <= 0 || h % kvh != 0)
    return ERR_UNSUPPORTED;
  Args a{q, k, v, o, q_offset, kv_len, sq, sk, h, kvh,
         q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
         o_sb, o_ss, o_sh, causal, window};
  return dispatch(a, batch, d, dtype, static_cast<cudaStream_t>(stream));
}
