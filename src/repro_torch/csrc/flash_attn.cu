// Flash attention, forward: online softmax over KV tiles, on the tensor cores.
//
//   s[qp, kp] = (q[qp] . k[kp]) * scale,  masked to -2e38 where kp >= Skv or,
//               when causal, kp > qp (the mask is aligned at position 0)
//   out[qp]   = sum_kp softmax_kp(s[qp, :]) v[kp]
//
// on q (B, Sq, H, hd) and k, v (B, Skv, H, hd), contiguous, f32 or bf16
// (one dtype), read in place (no transpose to (B·H, S, hd)); out has q's
// layout and dtype.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attn/kernel.py
// `flash_attention` (`_flash_kernel`).  Its grid (B·H, Sq/bq, Skv/bk)
// carries the running max m, sum l and accumulator across the sequential
// KV grid axis in VMEM scratch; a CUDA grid has no order, so here the KV
// axis is a loop inside the block and m, l and the accumulator live in
// registers.  The arithmetic is the Pallas kernel's: the same finite
// NEG_INF, p = exp(s - m_new), corr = exp(m_prev - m_new),
// l = l·corr + Σp, acc = acc·corr + p·v, out = acc / max(l, 1e-30).  With
// causal masking a block stops at the last KV tile that meets the diagonal
// of its last row: a tile wholly above it adds exactly 0 and leaves m
// unchanged (NEG_INF is finite and key 0 is visible to every row, so m is
// finite after the first tile).  Sq and Skv need not be multiples of the
// tiles: padded q rows are computed and not written, padded keys masked.
// hd <= 256.  Two kernels, one per dtype, on one FlashAttention-2 design.
//
// What bounds it on an H100: 4·hd flops per visible (q, k) pair (QK^T and
// PV); at (B, S, H, hd) = (1, 2048, 24, 128), causal, 25.8 GFLOP against
// 25 MB of q, k, v and out at f32 (0.0075 ms of HBM).  Operations bound at
// both dtypes: 0.026 ms on the 989 TFLOP/s bf16 tensor cores; at f32 each
// product is three TF32 products (below), 77.3 GFLOP of tensor work on the
// 495 TFLOP/s TF32 tensor cores, 0.156 ms.
//
// The shared design.  One block of 4 warps per (query tile of TC_BQ = 64
// rows, b·H + h) on a 1-D grid, the tile index major, so that the longest
// causal tiles of every head are scheduled first; each warp owns 16 query
// rows.  Both products are `mma.sync` with f32 accumulators.  The 16 x BK
// score tile of a warp stays in registers as m16n8 C fragments: lane (g =
// lane / 4, t = lane % 4) holds rows g and g + 8 at keys 2t and 2t + 1 of
// each n8 tile, so a row lives in the 4 lanes of a quad and its max takes
// two shuffles.  The mask is applied only on tiles that cross the diagonal
// or the Skv edge.  Scores are kept in log2 units (scale·log2 e folded into
// the scale), so p = 2^(s - m) and corr are one `ex2.approx` each, the same
// exp up to f32 rounding; l sums the f32 p.  q's and K's fragments come from
// shared memory by `ldmatrix.x4` without `.trans` (K stored [key][hd] is
// already the `.col` B operand).  K and V tiles arrive in a two-stage ring
// by 16-byte `cp.async.cg` (one commit group per tile), so tile j + 1 loads
// while tile j computes.  Shared rows are padded by 16 bytes (HD + 8 bf16,
// HD + 4 f32), so the 8 row addresses of an `ldmatrix` phase fall in
// distinct banks without a swizzle.  The kernels are templated on HD in
// {64, 128, 256}: hd zero-pads to the next one in shared memory (zero
// columns change neither q·k nor the written columns).  A whole number of
// 16-byte chunks per row (hd % 8 == 0 at bf16, hd % 4 == 0 at f32) with
// 16-byte aligned tensors takes `cp.async`; any other hd, or an unaligned
// base, element loads in the same kernel.
//
// bf16 (`flash_tc_kernel`): `mma.sync.m16n8k16` on bf16.  QK^T: a product
// of two bf16 values is exact in f32, so this is the reference's f32 dot of
// the upcast inputs up to summation order.  q's A fragments are loaded once
// into registers at HD <= 128 (again per tile at HD = 256).  PV: the C
// fragments of two neighbouring n8 score tiles are exactly the A fragment of
// an m16k16 product, so p never touches shared memory.  p rounded once to
// bf16 (as FlashAttention-2 and SDPA do) misses the 1e-3 check where a row
// sees few keys (up to 1.7e-3 on an H100), so p goes in as bf16 hi + lo,
// two products on the same V fragments.  V's B fragments come by
// `ldmatrix.x4.trans`.  64-key tiles: (64 + 4·64)·(HD + 8)·2 bytes of
// shared memory, 87 KB at HD = 128, two blocks per SM.
//
// f32 (`flash_tf32_kernel`): `mma.sync.m16n8k8` on tf32, in 3xTF32.  Each
// f32 operand x is split as hi = tf32(x) and lo = tf32(x - hi), both
// rounded to nearest, ties away (`cvt.rna`'s rounding, by integer
// operations: `split_tf32`), and a·b is a_lo·b_hi + a_hi·b_lo + a_hi·b_hi,
// the two small products accumulated first.  The dropped a_lo·b_lo is about
// 2^-22 of a·b, so the result keeps f32 accuracy; one TF32 product (2^-11)
// is off by about 1e-3 (a causal row 0 returns v rounded to tf32), far
// beyond the 2e-5 that the f32 checks hold.  The kernel issues more split
// instructions than `mma`s (four integer or float operations per split
// value, and every warp splits what it reads), so the split's cost shows
// in its time.  A k8 step of tf32 is 32 bytes, as a k16 step of bf16, so
// q's and K's `ldmatrix` addresses are the bf16 kernel's: an 8 x 4-word
// matrix read as b16 pairs gives lane (g, t) word t of row g, the tf32 A
// (row) and B (`.col`) fragment element.  q is split per tile from shared
// memory (its hi and lo fragments in registers would take 128 registers a
// thread at HD = 128); every warp splits the K and V fragments it reads.
// `ldmatrix.trans` cannot transpose 32-bit elements, so V's B fragments are
// scalar `ld.shared`.  The C fragment of a score tile is not PV's A
// fragment: a lane holds keys 2t and 2t + 1, the A fragment wants columns t
// and t + 4.  A sum over keys does not depend on their order, so the keys
// are relabelled instead of shuffled: the C registers are the A fragment
// with logical column t = physical key 2t and t + 4 = key 2t + 1, and V's
// b0 / b1 are read from rows 2t and 2t + 1.  With rows of HD + 4 floats
// (HD % 32 == 0, so a row is 4 banks on) those 32 loads fall in 32 distinct
// banks.  Tiles: 64 keys at HD = 64, 32 above, for two blocks per SM at HD
// <= 128: (64 + 4·BK)·(HD + 4)·4 bytes, 87 KB at HD = 64, 101 KB at 128 and
// 200 KB at 256 (one block).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG_INF = -2.0e38f;
constexpr int TC_BQ = 64;                    // query rows per block
constexpr int TC_THREADS = TC_BQ / 16 * 32;  // one warp per 16 query rows

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// 2^x by the special function unit (relative error about 2^-22; results
// below 2^-126 flush to 0, as p that small adds nothing to an f32 sum)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// 16 bytes global -> shared without a register; src_bytes = 0 writes zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>  // wait until at most N of this thread's groups are in flight
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// rows row0 .. row0 + ROWS - 1 of one head (row stride `pos_stride`
// elements) into a [ROWS][HD + E] shared tile, E = the elements of 16
// bytes; rows >= n_rows and columns >= hd become 0.  With VEC by cp.async
// (the caller commits and waits), else by element loads and stores.
template <int ROWS, int HD, bool VEC, typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int row0, int n_rows,
                                          long long pos_stride, int hd, int tid) {
  constexpr int E = 16 / sizeof(T);
  constexpr int S = HD + E;
  if constexpr (VEC) {
    constexpr int CH = HD / E;  // 16-byte chunks per row
    static_assert(ROWS * CH % TC_THREADS == 0, "whole chunks per thread");
    const int hd_ch = hd / E;
#pragma unroll
    for (int i = 0; i < ROWS * CH / TC_THREADS; ++i) {
      const int idx = tid + i * TC_THREADS, r = idx / CH, c = idx % CH;
      const bool ok = row0 + r < n_rows && c < hd_ch;
      cp_async16(smem_addr(dst + r * S + c * E),
                 ok ? src + (row0 + r) * pos_stride + c * E : src, ok ? 16 : 0);
    }
  } else {
    for (int idx = tid; idx < ROWS * HD; idx += TC_THREADS) {
      const int r = idx / HD, c = idx % HD;
      dst[r * S + c] = row0 + r < n_rows && c < hd ? src[(row0 + r) * pos_stride + c]
                                                   : from_f32<T>(0.f);
    }
  }
}

// -- bf16 ----------------------------------------------------------------------

constexpr int TC_BK = 64;  // keys per tile

// c (16 x 8, f32) += a (16 x 16, bf16, row) · b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a pair of f32 as bf16 hi + lo fragments: hi = bf16(x), lo = bf16(x - hi),
// so hi + lo holds x to about 2^-17 relative
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h2 = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h2);
  const __nv_bfloat162 l2 = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h2);
  lo = *reinterpret_cast<const uint32_t*>(&l2);
}

template <int HD, bool VEC>
__global__ void __launch_bounds__(TC_THREADS)
flash_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int sq,
                int skv, int h, int hd, float scale, int causal) {
  constexpr int S = HD + 8;           // bf16 per shared row
  constexpr int KV_TILE = TC_BK * S;  // bf16 per shared k or v tile
  constexpr int KS = HD / 16;         // k16 steps of q·k
  constexpr int NS = TC_BK / 8;       // n8 tiles of the scores
  constexpr int NV = HD / 8;          // n8 tiles of the accumulator
  constexpr bool Q_IN_REGS = HD <= 128;
  extern __shared__ __align__(16) unsigned char tc_smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(tc_smem);  // [TC_BQ][S]
  __nv_bfloat16* ks = qs + TC_BQ * S;                             // [2][TC_BK][S]
  __nv_bfloat16* vs = ks + 2 * KV_TILE;                           // [2][TC_BK][S]

  const int n_q = (sq + TC_BQ - 1) / TC_BQ, bh = gridDim.x / n_q;
  const int q0 = (n_q - 1 - static_cast<int>(blockIdx.x) / bh) * TC_BQ;
  const int bhi = blockIdx.x % bh, bi = bhi / h, head = bhi % h;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const long long pos_stride = static_cast<long long>(h) * hd;
  const __nv_bfloat16* qb = q + (static_cast<long long>(bi) * sq * h + head) * hd;
  const __nv_bfloat16* kb = k + (static_cast<long long>(bi) * skv * h + head) * hd;
  const __nv_bfloat16* vb = v + (static_cast<long long>(bi) * skv * h + head) * hd;
  __nv_bfloat16* ob = o + (static_cast<long long>(bi) * sq * h + head) * hd;
  // scores in log2 units, so that p = 2^(s - m) is one ex2
  const float scale_log2 = scale * 1.4426950408889634f;

  // each lane's ldmatrix row address: q (A, rows of the warp), k (B of two
  // n8 key tiles), v (B of two n8 hd tiles, transposed)
  const uint32_t q_lane = smem_addr(qs + (warp * 16 + lane % 16) * S + (lane / 16) * 8);
  const uint32_t k_lane = smem_addr(ks + (lane % 8 + (lane / 16) * 8) * S + ((lane / 8) % 2) * 8);
  const uint32_t v_lane = smem_addr(vs + (lane % 8 + ((lane / 8) % 2) * 8) * S + (lane / 16) * 8);
  // the lane's rows are qrow and qrow + 8 (r = 0, 1: fragment elements e =
  // 2r, 2r + 1)
  const int qrow = q0 + warp * 16 + g;

  int n_k = (skv + TC_BK - 1) / TC_BK;
  if (causal) n_k = min(n_k, (min(q0 + TC_BQ, sq) - 1) / TC_BK + 1);
  // group 0: q and the first k, v tiles; each iteration then commits the
  // next tile's group into the other stage of the ring before it computes
  load_tile<TC_BQ, HD, VEC>(qs, qb, q0, sq, pos_stride, hd, tid);
  if (n_k > 0) {
    load_tile<TC_BK, HD, VEC>(ks, kb, 0, skv, pos_stride, hd, tid);
    load_tile<TC_BK, HD, VEC>(vs, vb, 0, skv, pos_stride, hd, tid);
  }
  cp_async_commit();

  uint32_t qf[Q_IN_REGS ? KS : 1][4];
  float acc[NV][4];
#pragma unroll
  for (int n = 0; n < NV; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m_i[2] = {NEG_INF, NEG_INF}, l_i[2] = {0.f, 0.f};  // l_i: this lane's share

  for (int j = 0; j < n_k; ++j) {
    const int k0 = j * TC_BK, stage = (j & 1) * KV_TILE * 2;  // bytes
    if (j + 1 < n_k) {
      const int next = ((j + 1) & 1) * KV_TILE;
      load_tile<TC_BK, HD, VEC>(ks + next, kb, k0 + TC_BK, skv, pos_stride, hd, tid);
      load_tile<TC_BK, HD, VEC>(vs + next, vb, k0 + TC_BK, skv, pos_stride, hd, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile's group (and q's) has landed
    __syncthreads();
    if constexpr (Q_IN_REGS) {
      if (j == 0) {
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) ldsm_x4(q_lane + kk * 32, qf[kk]);
      }
    }

    // s = q·k^T over the warp's 16 rows and the tile's keys
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t a[4];
      if constexpr (Q_IN_REGS) {
#pragma unroll
        for (int e = 0; e < 4; ++e) a[e] = qf[kk][e];
      } else {
        ldsm_x4(q_lane + kk * 32, a);
      }
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t b[4];
        ldsm_x4(k_lane + stage + (np * 16 * S + kk * 16) * 2, b);
        mma_bf16(s[2 * np], a, b[0], b[1]);
        mma_bf16(s[2 * np + 1], a, b[2], b[3]);
      }
    }

    // scale and mask (keys k0 + 8n + 2t + (e & 1)), new row max, rescale
    const bool edge = k0 + TC_BK > skv || (causal && k0 + TC_BK - 1 > q0);
    float mx[2] = {m_i[0], m_i[1]};
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale_log2;
        if (edge) {
          const int kpos = k0 + 8 * n + 2 * t + (e & 1);
          if (kpos >= skv || (causal && kpos > qrow + 8 * (e / 2))) x = NEG_INF;
        }
        s[n][e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float corr = exp2_approx(m_i[r] - mx[r]);
      m_i[r] = mx[r];
      l_i[r] *= corr;
#pragma unroll
      for (int n = 0; n < NV; ++n) {
        acc[n][2 * r] *= corr;
        acc[n][2 * r + 1] *= corr;
      }
    }

    // acc += p·v: p's C fragments repacked in registers as the A fragments
    // of two bf16 products, hi and lo, so that p keeps f32 accuracy
#pragma unroll
    for (int kt = 0; kt < TC_BK / 16; ++kt) {
      float p[2][4];
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[half][e] = exp2_approx(s[2 * kt + half][e] - mx[e / 2]);
          l_i[e / 2] += p[half][e];
        }
      uint32_t p_hi[4], p_lo[4];
      split_bf16(p[0][0], p[0][1], p_hi[0], p_lo[0]);
      split_bf16(p[0][2], p[0][3], p_hi[1], p_lo[1]);
      split_bf16(p[1][0], p[1][1], p_hi[2], p_lo[2]);
      split_bf16(p[1][2], p[1][3], p_hi[3], p_lo[3]);
#pragma unroll
      for (int np = 0; np < NV / 2; ++np) {
        uint32_t b[4];
        ldsm_x4_trans(v_lane + stage + (kt * 16 * S + np * 16) * 2, b);
        mma_bf16(acc[2 * np], p_hi, b[0], b[1]);
        mma_bf16(acc[2 * np + 1], p_hi, b[2], b[3]);
        mma_bf16(acc[2 * np], p_lo, b[0], b[1]);
        mma_bf16(acc[2 * np + 1], p_lo, b[2], b[3]);
      }
    }
    __syncthreads();  // this stage is consumed before the next load refills it
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_i[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int qpos = qrow + 8 * r;
    if (qpos >= sq) continue;
    const float denom = fmaxf(l, 1e-30f);
    __nv_bfloat16* orow = ob + qpos * pos_stride;
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      const int col = 8 * n + 2 * t;
      const float x0 = acc[n][2 * r] / denom, x1 = acc[n][2 * r + 1] / denom;
      if constexpr (VEC) {
        if (col < hd)
          *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(x0, x1);
      } else {
        if (col < hd) orow[col] = __float2bfloat16(x0);
        if (col + 1 < hd) orow[col + 1] = __float2bfloat16(x1);
      }
    }
  }
}

// -- f32: 3xTF32 ---------------------------------------------------------------

// keys per tile: two blocks per SM at HD <= 128
__host__ __device__ constexpr int tf32_bk(int hd) { return hd <= 64 ? 64 : 32; }

// x as tf32 hi + lo: hi = tf32(x), lo = tf32(x - hi), both rounded to
// nearest, ties away from zero (`cvt.rna`), so hi + lo holds x to about
// 2^-22 relative.  `cvt.rna.tf32.f32` is emulated on sm_90 (NaN and
// infinity checks around the rounding); for finite x adding half a tf32 ulp
// (bit 12) to the bits and dropping the 13 low bits is the same rounding in
// two integer operations.  lo keeps its low bits: the tensor core ignores
// them, so its +0x1000 alone rounds it.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;
}

// c (16 x 8, f32) += a (16 x 8, tf32, row) · b (8 x 8, tf32, col)
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a·b in 3xTF32, a and b = (b0, b1) split into hi and lo: the two
// small products first, then hi·hi
__device__ __forceinline__ void mma_3xtf32(float (&c)[4], const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4], uint32_t b0_hi,
                                           uint32_t b1_hi, uint32_t b0_lo, uint32_t b1_lo) {
  mma_tf32(c, a_lo, b0_hi, b1_hi);
  mma_tf32(c, a_hi, b0_lo, b1_lo);
  mma_tf32(c, a_hi, b0_hi, b1_hi);
}

// at least two blocks per SM: ptxas otherwise aims at three (168 registers)
// and spills at HD = 128
template <int HD, bool VEC>
__global__ void __launch_bounds__(TC_THREADS, 2)
flash_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ o, int sq, int skv, int h,
                  int hd, float scale, int causal) {
  constexpr int BK = tf32_bk(HD);
  constexpr int S = HD + 4;        // floats per shared row
  constexpr int KV_TILE = BK * S;  // floats per shared k or v tile
  constexpr int KS = HD / 8;       // k8 steps of q·k
  constexpr int NS = BK / 8;       // n8 tiles of the scores, k8 steps of p·v
  constexpr int NV = HD / 8;       // n8 tiles of the accumulator
  extern __shared__ __align__(16) unsigned char tf_smem[];
  float* qs = reinterpret_cast<float*>(tf_smem);  // [TC_BQ][S]
  float* ks = qs + TC_BQ * S;                      // [2][BK][S]
  float* vs = ks + 2 * KV_TILE;                    // [2][BK][S]

  const int n_q = (sq + TC_BQ - 1) / TC_BQ, bh = gridDim.x / n_q;
  const int q0 = (n_q - 1 - static_cast<int>(blockIdx.x) / bh) * TC_BQ;
  const int bhi = blockIdx.x % bh, bi = bhi / h, head = bhi % h;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const long long pos_stride = static_cast<long long>(h) * hd;
  const float* qb = q + (static_cast<long long>(bi) * sq * h + head) * hd;
  const float* kb = k + (static_cast<long long>(bi) * skv * h + head) * hd;
  const float* vb = v + (static_cast<long long>(bi) * skv * h + head) * hd;
  float* ob = o + (static_cast<long long>(bi) * sq * h + head) * hd;
  const float scale_log2 = scale * 1.4426950408889634f;

  // ldmatrix row addresses, as the bf16 kernel's (a k8 step is 32 bytes):
  // q (A: rows g, g + 8; words t, t + 4), k (B of two n8 key tiles: key g;
  // words t, t + 4); v: this lane's B elements, rows 2t and 2t + 1 of a k8
  // step (the relabelled keys) at column g of an n8 tile
  const uint32_t q_lane = smem_addr(qs + (warp * 16 + lane % 16) * S + (lane / 16) * 4);
  const uint32_t k_lane = smem_addr(ks + (lane % 8 + (lane / 16) * 8) * S + ((lane / 8) % 2) * 4);
  const float* v_lane = vs + 2 * t * S + g;
  const int qrow = q0 + warp * 16 + g;

  int n_k = (skv + BK - 1) / BK;
  if (causal) n_k = min(n_k, (min(q0 + TC_BQ, sq) - 1) / BK + 1);
  load_tile<TC_BQ, HD, VEC>(qs, qb, q0, sq, pos_stride, hd, tid);
  if (n_k > 0) {
    load_tile<BK, HD, VEC>(ks, kb, 0, skv, pos_stride, hd, tid);
    load_tile<BK, HD, VEC>(vs, vb, 0, skv, pos_stride, hd, tid);
  }
  cp_async_commit();

  float acc[NV][4];
#pragma unroll
  for (int n = 0; n < NV; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m_i[2] = {NEG_INF, NEG_INF}, l_i[2] = {0.f, 0.f};  // l_i: this lane's share

  for (int j = 0; j < n_k; ++j) {
    const int k0 = j * BK, stage = (j & 1) * KV_TILE;  // floats
    if (j + 1 < n_k) {
      const int next = ((j + 1) & 1) * KV_TILE;
      load_tile<BK, HD, VEC>(ks + next, kb, k0 + BK, skv, pos_stride, hd, tid);
      load_tile<BK, HD, VEC>(vs + next, vb, k0 + BK, skv, pos_stride, hd, tid);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile's group (and q's) has landed
    __syncthreads();

    // s = q·k^T over the warp's 16 rows and the tile's keys
    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t a[4], a_hi[4], a_lo[4];
      ldsm_x4(q_lane + kk * 32, a);
#pragma unroll
      for (int e = 0; e < 4; ++e) split_tf32(__uint_as_float(a[e]), a_hi[e], a_lo[e]);
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t b[4], b_hi[4], b_lo[4];
        ldsm_x4(k_lane + (stage + np * 16 * S) * 4 + kk * 32, b);
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(__uint_as_float(b[e]), b_hi[e], b_lo[e]);
        mma_3xtf32(s[2 * np], a_hi, a_lo, b_hi[0], b_hi[1], b_lo[0], b_lo[1]);
        mma_3xtf32(s[2 * np + 1], a_hi, a_lo, b_hi[2], b_hi[3], b_lo[2], b_lo[3]);
      }
    }

    // scale and mask (keys k0 + 8n + 2t + (e & 1)), new row max, rescale
    const bool edge = k0 + BK > skv || (causal && k0 + BK - 1 > q0);
    float mx[2] = {m_i[0], m_i[1]};
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale_log2;
        if (edge) {
          const int kpos = k0 + 8 * n + 2 * t + (e & 1);
          if (kpos >= skv || (causal && kpos > qrow + 8 * (e / 2))) x = NEG_INF;
        }
        s[n][e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float corr = exp2_approx(m_i[r] - mx[r]);
      m_i[r] = mx[r];
      l_i[r] *= corr;
#pragma unroll
      for (int n = 0; n < NV; ++n) {
        acc[n][2 * r] *= corr;
        acc[n][2 * r + 1] *= corr;
      }
    }

    // acc += p·v, one k8 step per n8 score tile: the C registers (rows g, g
    // + 8; keys 2t, 2t + 1) are the A fragment with logical column t = key
    // 2t and t + 4 = key 2t + 1, so V's b0 / b1 come from rows 2t, 2t + 1
#pragma unroll
    for (int kt = 0; kt < NS; ++kt) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = exp2_approx(s[kt][e] - mx[e / 2]);
        l_i[e / 2] += p[e];
      }
      uint32_t p_hi[4], p_lo[4];
      split_tf32(p[0], p_hi[0], p_lo[0]);  // (g, t)
      split_tf32(p[2], p_hi[1], p_lo[1]);  // (g + 8, t)
      split_tf32(p[1], p_hi[2], p_lo[2]);  // (g, t + 4)
      split_tf32(p[3], p_hi[3], p_lo[3]);  // (g + 8, t + 4)
      const float* vrow = v_lane + stage + kt * 8 * S;
#pragma unroll
      for (int n = 0; n < NV; ++n) {
        uint32_t b0_hi, b0_lo, b1_hi, b1_lo;
        split_tf32(vrow[8 * n], b0_hi, b0_lo);
        split_tf32(vrow[S + 8 * n], b1_hi, b1_lo);
        mma_3xtf32(acc[n], p_hi, p_lo, b0_hi, b1_hi, b0_lo, b1_lo);
      }
    }
    __syncthreads();  // this stage is consumed before the next load refills it
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_i[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int qpos = qrow + 8 * r;
    if (qpos >= sq) continue;
    const float denom = fmaxf(l, 1e-30f);
    float* orow = ob + qpos * pos_stride;
#pragma unroll
    for (int n = 0; n < NV; ++n) {
      const int col = 8 * n + 2 * t;
      const float x0 = acc[n][2 * r] / denom, x1 = acc[n][2 * r + 1] / denom;
      if constexpr (VEC) {
        if (col < hd) *reinterpret_cast<float2*>(orow + col) = make_float2(x0, x1);
      } else {
        if (col < hd) orow[col] = x0;
        if (col + 1 < hd) orow[col + 1] = x1;
      }
    }
  }
}

// -- launch ----------------------------------------------------------------------

template <typename T, int HD, bool VEC>
cudaError_t launch_hd(const void* q, const void* k, const void* v, void* o, int batch, int sq,
                      int skv, int h, int hd, float scale, int causal, cudaStream_t stream) {
  constexpr bool F32 = sizeof(T) == 4;
  constexpr int BK = F32 ? tf32_bk(HD) : TC_BK;
  const size_t smem = static_cast<size_t>(TC_BQ + 4 * BK) * (HD + 16 / sizeof(T)) * sizeof(T);
  void (*kernel)(const T*, const T*, const T*, T*, int, int, int, int, float, int);
  if constexpr (F32) kernel = flash_tf32_kernel<HD, VEC>;
  else kernel = flash_tc_kernel<HD, VEC>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) {
      // a failed runtime call is also this runtime's last error: consume it, or
      // the next launch's cudaGetLastError() would report it as its own
      cudaGetLastError();
      return err;
    }
  }
  // one block per (query tile, b·H + h), the tile index major, so that the
  // longest causal tiles of every head are scheduled first
  const long long blocks = static_cast<long long>((sq + TC_BQ - 1) / TC_BQ) * batch * h;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(blocks), TC_THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), sq, skv, h, hd, scale, causal);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t launch_vec(bool vec, const void* q, const void* k, const void* v, void* o,
                       int batch, int sq, int skv, int h, int hd, float scale, int causal,
                       cudaStream_t stream) {
  return vec ? launch_hd<T, HD, true>(q, k, v, o, batch, sq, skv, h, hd, scale, causal, stream)
             : launch_hd<T, HD, false>(q, k, v, o, batch, sq, skv, h, hd, scale, causal, stream);
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int batch, int sq,
                   int skv, int h, int hd, float scale, int causal, cudaStream_t stream) {
  // 16-byte loads need every row start 16-byte aligned: hd a whole number
  // of 16-byte chunks and aligned base pointers (a contiguous view may
  // start at an offset)
  const uintptr_t bases = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o);
  const bool vec = hd % (16 / sizeof(T)) == 0 && bases % 16 == 0;
  if (hd <= 64)
    return launch_vec<T, 64>(vec, q, k, v, o, batch, sq, skv, h, hd, scale, causal, stream);
  if (hd <= 128)
    return launch_vec<T, 128>(vec, q, k, v, o, batch, sq, skv, h, hd, scale, causal, stream);
  if (hd <= 256)
    return launch_vec<T, 256>(vec, q, k, v, o, batch, sq, skv, h, hd, scale, causal, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// q, o: (batch, sq, h, hd); k, v: (batch, skv, h, hd), contiguous.  dtype:
// 0 = float32, 1 = bfloat16.  causal: 0 or 1.  Returns the cudaError_t of
// the launch (0 on success).
extern "C" int flash_attn_launch(const void* q, const void* k, const void* v, void* o,
                                 int batch, int sq, int skv, int h, int hd, float scale,
                                 int causal, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(
        launch<float>(q, k, v, o, batch, sq, skv, h, hd, scale, causal, s));
  if (dtype == 1)
    return static_cast<int>(
        launch<__nv_bfloat16>(q, k, v, o, batch, sq, skv, h, hd, scale, causal, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
