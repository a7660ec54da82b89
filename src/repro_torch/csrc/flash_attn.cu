// Flash attention, forward: online softmax over KV tiles.
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
// hd <= 256.  Two kernels, one per dtype.
//
// What bounds it on an H100: 4·hd flops per visible (q, k) pair (QK^T and
// PV); at (B, S, H, hd) = (1, 2048, 24, 128), causal, 25.8 GFLOP against
// 25 MB of q, k, v and out (0.0075 ms of HBM).  Operations bound either
// way: 0.385 ms on the 67 TFLOP/s f32 CUDA cores, 0.026 ms on the 989
// TFLOP/s bf16 tensor cores.
//
// f32 (`flash_kernel`): the CUDA cores, f32 throughout.  One block of 256
// threads per (query tile of BQ = 64 rows, b·H + h), the longest causal
// tiles first.  The block stages the q tile and, one after another, each
// KV tile of BK = 64 keys in shared memory (q and k transposed, [hd][64 +
// 1], so the products read both without bank conflicts), computes the 64 x
// 64 scores as a 4 x 4 register tile per thread (rows ty + 16i, columns tx
// + 16j), takes each row's max and sum by shuffles among the 16 threads
// that hold it, writes p to shared memory, and adds p·v into a 4 x
// ceil(hd/16) register accumulator over the same rows (shared memory:
// 4·(2·65·hd + 64·hd + 64·65) bytes, 113 KB at hd = 128).
//
// bf16 (`flash_tc_kernel`): the tensor cores, in the FlashAttention-2
// forward design.  One block of 4 warps per (query tile of TC_BQ = 64 rows,
// b·H + h), the longest causal tiles of every head first; each warp owns 16
// query rows.  Both products are `mma.sync.m16n8k16` on bf16 with f32
// accumulators.  QK^T: a product of two bf16 values is exact in f32, so
// this is the reference's f32 dot of the upcast inputs up to summation
// order.  q's A fragments come once from shared memory by `ldmatrix.x4`
// (into registers at HD <= 128, again per tile at HD = 256); K stored
// [key][hd] is already the `.col` B operand, so `ldmatrix.x4` without
// `.trans`.  The 16 x 64 score tile of a warp stays in registers (32 f32 a
// thread); a row lives in the 4 lanes of a quad, so its max takes two
// shuffles, and the mask is applied only on tiles that cross the diagonal
// or the Skv edge.  Scores are kept in log2 units (scale·log2 e folded into
// the scale), so p = 2^(s - m) and corr are one `ex2.approx` each, the same
// exp up to f32 rounding.  PV: the C fragments of two neighbouring n8 score
// tiles are exactly the A fragment of an m16k16 product, so p never touches
// shared memory.  p rounded once to bf16 (as FlashAttention-2 and SDPA do)
// misses the 1e-3 check where a row sees few keys (up to 1.7e-3 on an
// H100), so p goes in as bf16 hi + lo, two products on the same V
// fragments: PV costs twice the tensor-core work of QK^T, and p keeps f32
// accuracy.  l sums the f32 p.  V's B fragments come by `ldmatrix.x4.trans`
// from V stored [key][hd].  K and V tiles arrive in a two-stage ring by
// 16-byte `cp.async.cg` (one commit group per tile), so tile j + 1 loads
// while tile j computes.  Shared memory rows are HD + 8 bf16 long, so the 8
// row addresses of an `ldmatrix` phase fall in distinct banks without a
// swizzle: (64 + 4·64)·(HD + 8)·2 bytes, 87 KB at HD = 128, two blocks per
// SM.  The kernel is templated on HD in {64, 128, 256}: hd zero-pads to the
// next one in shared memory (zero columns change neither q·k nor the
// written columns).  hd % 8 == 0 with 16-byte aligned tensors takes
// `cp.async`; any other hd, or an unaligned base, element loads in the same
// kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64, BK = 64, THREADS = 256;
constexpr float NEG_INF = -2.0e38f;

__device__ __forceinline__ float to_f32(float v) { return v; }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }

// max / sum over the 16 lanes that share a row (lanes differ in bits 0-3)
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T, int NJ>  // NJ = columns of hd per thread, ceil(hd / 16) <= NJ
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ o, int sq, int skv, int h, int hd, float scale, int causal) {
  extern __shared__ float smem[];
  float* qt = smem;                  // [hd][BQ + 1]
  float* kt = qt + hd * (BQ + 1);    // [hd][BK + 1]
  float* vs = kt + hd * (BK + 1);    // [BK][hd]
  float* ps = vs + BK * hd;          // [BQ][BK + 1]
  const int n_q = (sq + BQ - 1) / BQ;
  const int q0 = (n_q - 1 - static_cast<int>(blockIdx.x)) * BQ;
  const int bi = blockIdx.y / h, hi = blockIdx.y % h;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const long long pos_stride = static_cast<long long>(h) * hd;
  const T* qb = q + (static_cast<long long>(bi) * sq * h + hi) * hd;
  const T* kb = k + (static_cast<long long>(bi) * skv * h + hi) * hd;
  const T* vb = v + (static_cast<long long>(bi) * skv * h + hi) * hd;
  T* ob = o + (static_cast<long long>(bi) * sq * h + hi) * hd;

  for (int idx = tid; idx < BQ * hd; idx += THREADS) {
    const int r = idx / hd, c = idx % hd;
    qt[c * (BQ + 1) + r] = q0 + r < sq ? to_f32(qb[(q0 + r) * pos_stride + c]) : 0.f;
  }

  float m_i[4], l_i[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = NEG_INF;
    l_i[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  int n_k = (skv + BK - 1) / BK;
  if (causal) n_k = min(n_k, (min(q0 + BQ, sq) - 1) / BK + 1);
  for (int ik = 0; ik < n_k; ++ik) {
    const int k0 = ik * BK;
    __syncthreads();  // q staged; the previous tile's k, v and p are consumed
    for (int idx = tid; idx < BK * hd; idx += THREADS) {
      const int r = idx / hd, c = idx % hd;
      const bool ok = k0 + r < skv;
      const long long g = (k0 + r) * pos_stride + c;
      kt[c * (BK + 1) + r] = ok ? to_f32(kb[g]) : 0.f;
      vs[r * hd + c] = ok ? to_f32(vb[g]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int c = 0; c < hd; ++c) {
      float a[4], bb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qt[c * (BQ + 1) + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bb[j] = kt[c * (BK + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += a[i] * bb[j];
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int qpos = q0 + r;
      float rmax = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool valid = kpos < skv && (!causal || kpos <= qpos);
        s[i][j] = valid ? s[i][j] * scale : NEG_INF;
        rmax = fmaxf(rmax, s[i][j]);
      }
      const float m_new = fmaxf(m_i[i], row_max(rmax));
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps[r * (BK + 1) + tx + 16 * j] = p;
        rsum += p;
      }
      const float corr = expf(m_i[i] - m_new);
      l_i[i] = l_i[i] * corr + row_sum(rsum);
      m_i[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

    for (int c = 0; c < BK; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(ty + 16 * i) * (BK + 1) + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = tx + 16 * j;
        if (col < hd) {
          const float vv = vs[c * hd + col];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] += p[i] * vv;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= sq) continue;
    const float denom = fmaxf(l_i[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = tx + 16 * j;
      if (col < hd) ob[qpos * pos_stride + col] = from_f32<T>(acc[i][j] / denom);
    }
  }
}

template <typename T, int NJ>
cudaError_t launch_nj(const void* q, const void* k, const void* v, void* o, int batch,
                      int sq, int skv, int h, int hd, float scale, int causal,
                      cudaStream_t stream) {
  const size_t smem =
      (2 * static_cast<size_t>(hd) * (BQ + 1) + BK * hd + BQ * (BK + 1)) * sizeof(float);
  auto kernel = flash_kernel<T, NJ>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((sq + BQ - 1) / BQ, batch * h);
  kernel<<<grid, THREADS, smem, stream>>>(static_cast<const T*>(q),
                                          static_cast<const T*>(k),
                                          static_cast<const T*>(v), static_cast<T*>(o),
                                          sq, skv, h, hd, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int batch, int sq,
                   int skv, int h, int hd, float scale, int causal, cudaStream_t stream) {
  if (hd <= 64)
    return launch_nj<T, 4>(q, k, v, o, batch, sq, skv, h, hd, scale, causal, stream);
  if (hd <= 128)
    return launch_nj<T, 8>(q, k, v, o, batch, sq, skv, h, hd, scale, causal, stream);
  if (hd <= 256)
    return launch_nj<T, 16>(q, k, v, o, batch, sq, skv, h, hd, scale, causal, stream);
  return cudaErrorInvalidValue;
}

// -- bf16: the tensor cores ---------------------------------------------------

constexpr int TC_BQ = 64, TC_BK = 64;        // query rows, keys per tile
constexpr int TC_THREADS = TC_BQ / 16 * 32;  // one warp per 16 query rows

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

// c (16 x 8, f32) += a (16 x 16, bf16, row) · b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x by the special function unit (relative error about 2^-22; results
// below 2^-126 flush to 0, as p that small adds nothing to an f32 sum)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
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
// elements) into a [ROWS][HD + 8] shared tile; rows >= n_rows and columns
// >= hd become 0.  With VEC by cp.async (the caller commits and waits),
// else by element loads and stores.
template <int ROWS, int HD, bool VEC>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          int row0, int n_rows, long long pos_stride,
                                          int hd, int tid) {
  constexpr int S = HD + 8;
  if constexpr (VEC) {
    constexpr int CH = HD / 8;  // 16-byte chunks per row
    static_assert(ROWS * CH % TC_THREADS == 0, "whole chunks per thread");
    const int hd_ch = hd / 8;
#pragma unroll
    for (int i = 0; i < ROWS * CH / TC_THREADS; ++i) {
      const int idx = tid + i * TC_THREADS, r = idx / CH, c = idx % CH;
      const bool ok = row0 + r < n_rows && c < hd_ch;
      cp_async16(smem_addr(dst + r * S + c * 8),
                 ok ? src + (row0 + r) * pos_stride + c * 8 : src, ok ? 16 : 0);
    }
  } else {
    for (int idx = tid; idx < ROWS * HD; idx += TC_THREADS) {
      const int r = idx / HD, c = idx % HD;
      dst[r * S + c] = row0 + r < n_rows && c < hd ? src[(row0 + r) * pos_stride + c]
                                                   : __float2bfloat16(0.f);
    }
  }
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

template <int HD, bool VEC>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o, int batch,
                      int sq, int skv, int h, int hd, float scale, int causal,
                      cudaStream_t stream) {
  const size_t smem =
      static_cast<size_t>(TC_BQ + 4 * TC_BK) * (HD + 8) * sizeof(__nv_bfloat16);
  auto kernel = flash_tc_kernel<HD, VEC>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  // one block per (query tile, b·H + h), the tile index major, so that the
  // longest causal tiles of every head are scheduled first
  const long long blocks = static_cast<long long>((sq + TC_BQ - 1) / TC_BQ) * batch * h;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(blocks), TC_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), sq, skv, h, hd,
      scale, causal);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_tc_hd(bool vec, const void* q, const void* k, const void* v, void* o,
                         int batch, int sq, int skv, int h, int hd, float scale, int causal,
                         cudaStream_t stream) {
  return vec ? launch_tc<HD, true>(q, k, v, o, batch, sq, skv, h, hd, scale, causal, stream)
             : launch_tc<HD, false>(q, k, v, o, batch, sq, skv, h, hd, scale, causal, stream);
}

cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, int batch,
                        int sq, int skv, int h, int hd, float scale, int causal,
                        cudaStream_t stream) {
  // 16-byte loads need every row start 16-byte aligned: hd % 8 == 0 and
  // aligned base pointers (a contiguous view may start at an offset)
  const uintptr_t bases = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o);
  const bool vec = hd % 8 == 0 && bases % 16 == 0;
  if (hd <= 64)
    return launch_tc_hd<64>(vec, q, k, v, o, batch, sq, skv, h, hd, scale, causal, stream);
  if (hd <= 128)
    return launch_tc_hd<128>(vec, q, k, v, o, batch, sq, skv, h, hd, scale, causal, stream);
  if (hd <= 256)
    return launch_tc_hd<256>(vec, q, k, v, o, batch, sq, skv, h, hd, scale, causal, stream);
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
    return static_cast<int>(launch_bf16(q, k, v, o, batch, sq, skv, h, hd, scale, causal, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
