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
// Design (simple, correct first). One thread block per (q-tile of 64
// rows, query head, batch row). The k loop uses the TPU kernel's
// bounds: it stops at min(kv_len, q_off + q_start + 64, Sk) under
// causality and, with a window, starts at the 64-key tile holding the
// first row's window start, so causal and windowed prefill skip dead
// tiles. Two kernels behind one entry:
//   bfloat16 (the serving path): 4 warps, 16 query rows each. K/V tiles
//     of 64 x D bf16 (16 KB each at D=128) are staged in shared memory
//     by cp.async, two stages deep, so the next tile loads while this
//     one computes. S = Q K^T and O += P V run on the tensor cores
//     (mma.sync m16n8k16, bf16 in, f32 accumulate); Q stays in
//     registers as A fragments, V's B fragments come transposed from
//     row-major shared memory via ldmatrix. Softmax is online in f32
//     (exp2 domain) on the accumulator fragments. P is rounded to bf16
//     for the P V product (the TPU kernel keeps it f32); against the
//     f32 plain version that costs well under one bf16 output step.
//   float32 (the tiny configs): CUDA-core FMAs on f32 tiles in shared
//     memory, 256 threads, 4x4 scores per thread; no tensor cores, which
//     would round to TF32.
// q/k/v are read through their strides; the bf16 kernel's 16-byte
// copies need 16-byte-aligned rows (the wrapper copies a view that is
// not).
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
// What this design leaves on the table (work for a later change): no
// wgmma (mma.sync reaches only part of Hopper's tensor-core rate), no
// TMA (every thread issues its own 16-byte copies), no warp
// specialisation (the same warps load and compute), no persistent
// scheduling across tiles, and causal blocks of uneven length.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

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
// bfloat16: tensor cores through mma.sync (m16n8k16, f32 accumulate).
// ---------------------------------------------------------------------------

namespace tc {

constexpr int THREADS = 128;  // 4 warps, 16 query rows each

typedef __nv_bfloat16 bf16;

template <int D>
__host__ __device__ constexpr int ld() { return D + 8; }  // smem row stride (+16 B)

template <int D>
constexpr size_t smem_bytes() {
  // Two stages of a K tile and a V tile, [BK][D + 8] bf16 each.
  return 2 * 2 * BK * ld<D>() * sizeof(bf16);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  // 16 bytes global -> shared; src-size 0 fills the 16 bytes with zeros.
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [row0, row0 + BK) of a [rows, D] matrix (row stride `stride`
// elements, unit inner stride) into smem [BK][D + 8]; rows past `rows`
// are zero.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long stride, int row0,
                                          int rows, int tid) {
  constexpr int VEC = D / 8;  // 16-byte vectors per row
  for (int i = tid; i < BK * VEC; i += THREADS) {
    const int r = i / VEC, c = (i % VEC) * 8;
    const bool ok = row0 + r < rows;
    const bf16* g = ok ? src + (long long)(row0 + r) * stride + c : src;
    cp_async16(dst + r * ld<D>() + c, g, ok);
  }
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// c[16x8] += a[16x16] * b[16x8], bf16 in, f32 accumulate.
__device__ __forceinline__ void mma(float* c, const uint32_t* a, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices, each delivered transposed (B operands of P V).
__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const bf16* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_tc_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem_tc[];
  constexpr int LD = ld<D>();
  constexpr int TILE = BK * LD;  // one K or V tile
  // Stage s holds its K tile at smem_k(s) and its V tile right after it
  // (pointer arithmetic, not an array of pointers: a runtime index into
  // one would put it in local memory).
  bf16* const smem = reinterpret_cast<bf16*>(smem_tc);
  auto smem_k = [&](int stage) { return smem + stage * 2 * TILE; };

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;  // mma fragment row / column pair
  const int q_start = blockIdx.x * BQ;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const int kv_head = head / (a.h / a.kvh);
  const int q_off = a.q_offset[b];
  const int limit = a.kv_len[b];
  // Scores go to the exp2 domain: exp(x * scale) = exp2(x * scale * log2 e).
  const float scale_log2 = (float)(1.4426950408889634 / sqrt((double)D));

  const bf16* q = static_cast<const bf16*>(a.q) + b * a.q_sb + head * a.q_sh;
  const bf16* k =
      static_cast<const bf16*>(a.k) + b * a.k_sb + kv_head * a.k_sh;
  const bf16* v =
      static_cast<const bf16*>(a.v) + b * a.v_sb + kv_head * a.v_sh;
  bf16* o = static_cast<bf16*>(a.o) + b * a.o_sb + head * a.o_sh;

  // Loop bounds of the TPU kernel.
  int kv_limit = limit;
  if (a.causal) kv_limit = min(kv_limit, q_off + q_start + BQ);
  kv_limit = min(kv_limit, a.sk);
  const int num_iters = kv_limit > 0 ? (kv_limit + BK - 1) / BK : 0;
  int start_iter = 0;
  if (a.window > 0) start_iter = max(q_off + q_start - a.window + 1, 0) / BK;

  // Stage the q tile (through stage 1's K buffer) and the first K/V tile.
  load_tile<D>(smem_k(1), q, a.q_ss, q_start, a.sq, tid);
  if (start_iter < num_iters) {
    load_tile<D>(smem_k(0), k, a.k_ss, start_iter * BK, a.sk, tid);
    load_tile<D>(smem_k(0) + TILE, v, a.v_ss, start_iter * BK, a.sk, tid);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // This warp's 16 query rows as A fragments, kept in registers.
  uint32_t qf[D / 16][4];
  {
    const bf16* qs = smem_k(1) + warp * 16 * LD;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      qf[kk][0] = ld32(qs + g * LD + kk * 16 + 2 * t);
      qf[kk][1] = ld32(qs + (g + 8) * LD + kk * 16 + 2 * t);
      qf[kk][2] = ld32(qs + g * LD + kk * 16 + 2 * t + 8);
      qf[kk][3] = ld32(qs + (g + 8) * LD + kk * 16 + 2 * t + 8);
    }
  }
  __syncthreads();  // stage 1 may now be overwritten

  // Rows g and g + 8 of the warp's slice: running max, partial
  // denominator (this thread's columns only) and accumulator.
  float m[2] = {NEG_INF, NEG_INF};
  float l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  const int q_pos0 = q_off + q_start + warp * 16 + g;  // row g; g + 8 adds 8

  for (int kb = start_iter; kb < num_iters; ++kb) {
    const int stage = (kb - start_iter) & 1;
    if (kb + 1 < num_iters) {  // prefetch the next tile into the other stage
      bf16* next = smem_k(stage ^ 1);
      load_tile<D>(next, k, a.k_ss, (kb + 1) * BK, a.sk, tid);
      load_tile<D>(next + TILE, v, a.v_ss, (kb + 1) * BK, a.sk, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* ks = smem_k(stage);
    const bf16* vs = ks + TILE;
    const int k_start = kb * BK;

    // S = Q K^T: 16 rows x 64 keys per warp, eight 16x8 tiles.
    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      const bf16* krow = ks + (j * 8 + g) * LD + 2 * t;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma(s[j], qf[kk], ld32(krow + kk * 16), ld32(krow + kk * 16 + 8));
    }

    // Scale and mask. Tiles wholly inside every row's valid range skip
    // the per-element test.
    const bool full =
        k_start + BK <= min(limit, a.sk) &&
        (!a.causal || k_start + BK - 1 <= q_off + q_start) &&
        (a.window <= 0 || k_start > q_off + q_start + BQ - 1 - a.window);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k_pos = k_start + j * 8 + 2 * t + (e & 1);
        const int q_pos = q_pos0 + (e >> 1) * 8;
        bool ok = true;
        if (!full) {
          ok = k_pos < limit && k_pos < a.sk;
          if (a.causal) {
            ok = ok && q_pos >= k_pos;
            if (a.window > 0) ok = ok && k_pos > q_pos - a.window;
          }
        }
        s[j][e] = ok ? s[j][e] * scale_log2 : NEG_INF;
      }

    // Online softmax for rows g (ri = 0) and g + 8 (ri = 1); the four
    // threads of a row (t = 0..3) combine their maxima by shuffles.
#pragma unroll
    for (int ri = 0; ri < 2; ++ri) {
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * ri], s[j][2 * ri + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[ri], mx);
      const float alpha = exp2f(m[ri] - m_new);
      m[ri] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp2f(s[j][2 * ri + e] - m_new);
          s[j][2 * ri + e] = p;
          sum += p;
        }
      l[ri] = l[ri] * alpha + sum;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[n][2 * ri] *= alpha;
        acc[n][2 * ri + 1] *= alpha;
      }
    }

    // acc += P V: P's C fragments become A fragments (rounded to bf16),
    // V's B fragments come transposed from row-major smem by ldmatrix.
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t pa[4] = {
          pack(s[2 * kk][0], s[2 * kk][1]),
          pack(s[2 * kk][2], s[2 * kk][3]),
          pack(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack(s[2 * kk + 1][2], s[2 * kk + 1][3]),
      };
      const int mi = lane >> 3, i = lane & 7;
      const bf16* vrow = vs + (kk * 16 + (mi & 1) * 8 + i) * LD + (mi >> 1) * 8;
#pragma unroll
      for (int n = 0; n < D / 8; n += 2) {
        uint32_t bv[4];
        ldsm_x4_trans(bv, vrow + n * 8);
        mma(acc[n], pa, bv[0], bv[1]);
        mma(acc[n + 1], pa, bv[2], bv[3]);
      }
    }
    __syncthreads();  // this stage is refilled two iterations on
  }

  // Epilogue: full denominators, dead rows (no valid key) written as 0.
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    l[ri] += __shfl_xor_sync(0xffffffffu, l[ri], 1);
    l[ri] += __shfl_xor_sync(0xffffffffu, l[ri], 2);
  }
#pragma unroll
  for (int ri = 0; ri < 2; ++ri) {
    const int r = q_start + warp * 16 + g + ri * 8;
    if (r >= a.sq) continue;
    const float inv = m[ri] > NEG_INF / 2 ? 1.f / fmaxf(l[ri], 1e-30f) : 0.f;
    bf16* orow = o + (long long)r * a.o_ss + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(orow + n * 8) =
          pack(acc[n][2 * ri] * inv, acc[n][2 * ri + 1] * inv);
  }
}

}  // namespace tc

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

template <int D>
int launch_tc(const Args& a, int batch, cudaStream_t stream) {
  const size_t smem = tc::smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      tc::flash_fwd_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.sq + BQ - 1) / BQ, a.h, batch);
  tc::flash_fwd_tc_kernel<D><<<grid, tc::THREADS, smem, stream>>>(a);
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
      case 32: return launch_tc<32>(a, batch, s);
      case 64: return launch_tc<64>(a, batch, s);
      case 128: return launch_tc<128>(a, batch, s);
    }
  }
  return -1;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. window <= 0 = no window. Strides
// are in elements. Returns 0 on success, a cudaError_t value when the
// launch was refused, or -1 for an unsupported dtype / head_dim.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o,
    const int* q_offset, const int* kv_len,
    int batch, int sq, int sk, int h, int kvh, int d,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    int causal, int window, int dtype, void* stream) {
  if (batch <= 0 || sq <= 0 || h <= 0 || kvh <= 0 || h % kvh != 0) return -1;
  Args a{q, k, v, o, q_offset, kv_len, sq, sk, h, kvh,
         q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
         o_sb, o_ss, o_sh, causal, window};
  return dispatch(a, batch, d, dtype, static_cast<cudaStream_t>(stream));
}
