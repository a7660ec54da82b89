// N queries bound to each of M static dictionary entries, blockwise:
//
//   conv: out[n, m, b, i] = sum_k x[n, b, k] * dict[m, b, (i - k) mod d]
//   corr: out[n, m, b, i] = sum_k x[n, b, k] * dict[m, b, (i + k) mod d]
//
// for contiguous x (N, B, d) and dict (M, B, d), f32 accumulation, output
// in x's dtype (f32 or bf16), written as (N, M, B, d), the layout of
// `circ_bind_dict`; the Pallas `circ_dict`'s (N, B, M, d) is a transposed
// view of it.
//
// Replaces the Pallas TPU kernel src/repro/kernels/circ_conv/kernel.py
// `circ_dict` (`_dict_kernel`).  That kernel builds each entry's d×d
// circulant in VMEM once per (query tile, block, entry) grid step and
// feeds it to the MXU as a (tile_n × d) @ (d × d) matmul.  Here the same
// product runs on the tensor cores, but the circulant is never built: its
// B fragments are read straight from the entry's row.
//
// What bounds it on an H100: 2·N·M·B·d² flops against (N + M)·B·d inputs
// and N·M·B·d outputs.  At (N, M, B, d) = (256, 16, 4, 256) that is 2.15
// GFLOP against 16.8 MB of f32 output.  f32 runs in 3xTF32 (three TF32
// products per f32 product): 0.0130 ms on the 495 TFLOP/s TF32 tensor
// cores, against 0.0053 ms of HBM: operations bound.  bf16 does one
// product on the 989 TFLOP/s bf16 tensor cores (0.0022 ms) against 8.4 MB
// (0.0027 ms): bytes bound.
//
// Design.
// * One GEMM per (entry m, block b): out[n, m, b, :] = x[n, b, :] @ C,
//   C[k][i] = y[(i ∓ k) mod d].  A block takes a query tile of BN = 16 or
//   32 rows of one block b and a group of MG entries (MG grows while the
//   grid keeps >= 132 blocks: 2 at the `ops` shape, 256 blocks), so the
//   tile is staged once for MG GEMMs.  d pads to dp, a multiple of 64;
//   padded k are zeros in the x tile, padded columns are computed and not
//   written.  A warp computes 16 rows × 64 columns (8 n8 tiles) over the
//   whole k range; the block's 8 warps walk the (BN / 16) × (dp / 64) warp
//   tiles of each entry.
// * The circulant from the row.  Each entry's row is staged once as
//   v[q] = y[(dp − 1 − q) mod d] (conv; index q = dp − 1 − i + k) or
//   v[q] = y[q mod d] (corr; q = i + k), q in [0, 2·dp], so every fragment
//   element is one shared load with no wrap.  A B fragment depends on its
//   k step and column tile only through k0 ∓ i0, so from one k step to the
//   next the 8 tiles of a warp reuse 7 fragments and load one (f32; bf16
//   reloads a chunk's 15 words every 4 k steps): a register window.
// * f32 in 3xTF32 (`mma.sync.m16n8k8` tf32): each operand split once into
//   tf32 hi + lo in shared memory (the x tile once per block, each row
//   once per entry), then lo·hi + hi·lo + hi·hi per product, as
//   flash_attn.cu's f32 kernel.  The lanes of a B-fragment load read 11
//   consecutive words (q = const + t − g): no bank conflict.  A fragments
//   come by `ldmatrix.x4` from rows padded by 16 bytes.
// * bf16 (`mma.sync.m16n8k16`, f32 accumulation): a B register holds
//   C[k][i], C[k + 1][i], which are v[q], v[q + 1]: adjacent in v, on an
//   even element for half the lanes.  v is stored twice, as the word pairs
//   (v[2w], v[2w + 1]) and (v[2w + 1], v[2w + 2]), the second copy 16
//   banks apart, so every register is one aligned 32-bit load and a
//   fragment load touches two disjoint runs of at most 8 banks.
// * Staging and stores.  The x tile comes by `cp.async` (every copy of a
//   thread in flight at once) and is split in place; the rows are gathered
//   four loads at a time.  f32 outputs leave the C fragments as 8-byte
//   pairs, whole 32-byte sectors; bf16 pairs would be half sectors, so a
//   warp's 16 × 64 bf16 tile goes through a buffer in shared memory and
//   out in 16-byte stores (the stores had cost more than the products).
// * Chunked accumulation.  The tensor cores add into their f32
//   accumulator rounding toward zero, so over d = 1600 the error of one
//   running fragment reached 2.2e-3 on randn inputs.  Each chunk of 64 k
//   (8 k steps) sums from zero in the tensor cores and the chunks add in
//   f32 (round to nearest) in registers.
// * Fixed order, no atomics.  Each output's k-sum runs over the k steps in
//   order, in an order that depends on d alone, so row n is bit-identical
//   whatever N is and whichever tile it lands in, and launches repeat bit
//   for bit.
//
// ptxas (nvcc -Xptxas -v, sm_90a, CUDA 12.8): dict_tf32_kernel 128 / 127
// registers (conv / corr), dict_bf16_kernel 100 / 98, no spills.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int NT = 8;              // n8 tiles per warp tile
constexpr int WCOLS = 8 * NT;      // output columns per warp tile; d pads to a multiple
constexpr int WROWS = 16;          // query rows per warp tile (the mma's M)
constexpr int MAX_WARPS = 8;
constexpr int MAX_GROUP = 8;       // dictionary entries per block, at most
constexpr int SMS = 132;           // an H100's SMs
constexpr size_t MAX_SMEM = 232448;  // bytes one block may use on Hopper

constexpr int OB_PITCH = WCOLS + 8;  // bf16 per row of a warp's output buffer

// bytes of dynamic shared memory: the x tile (tf32 hi and lo, or bf16) and
// MG staged rows (tf32 hi and lo of 2·dp words, or the two bf16 word
// copies); bf16 adds each warp's 16 x 64 output buffer
size_t smem_bytes(int dp, int bn, int mg, bool bf16) {
  if (bf16)
    return 2ull * bn * (dp + 8) + 4ull * mg * (2 * dp + 16) +
           2ull * MAX_WARPS * WROWS * OB_PITCH;
  return 8ull * bn * (dp + 4) + 16ull * mg * dp;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared without a register, so that all of a thread's
// copies are in flight at once
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// x as tf32 hi + lo (flash_attn.cu's split: round to nearest by integer
// operations; the tensor core ignores lo's low 13 bits)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct Args {
  const void* x;
  const void* dict;
  void* out;
  int n, m, b, d;
  int dp, bn, mg;
  int vec;      // x rows start 16-byte aligned and d is a multiple of 16 bytes
  int vec_out;  // the same for the output rows
};

// v[q] of the row y: conv y[(dp - 1 - q) mod d], corr y[q mod d]
template <bool CORR>
__device__ __forceinline__ int row_index(int q, int d, int dp) {
  if (CORR) return q % d;
  int r = (dp - 1 - q) % d;
  return r < 0 ? r + d : r;
}

// out[nq, mi, blk, i], out[nq, mi, blk, i + 1] from a C fragment's pair (f32)
__device__ __forceinline__ void store_pair(const Args& a, int nq, int mi, int blk, int i,
                                          float v0, float v1) {
  if (nq >= a.n || i >= a.d) return;
  float* o = static_cast<float*>(a.out) +
             ((static_cast<long long>(nq) * a.m + mi) * a.b + blk) * a.d + i;
  if ((a.d & 1) == 0) {  // i even and d even: an aligned pair
    *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
  } else {
    o[0] = v0;
    if (i + 1 < a.d) o[1] = v1;
  }
}

// -- f32: 3xTF32 ---------------------------------------------------------------

// one warp tile (16 rows from row0, 64 columns from col0) of one entry:
// acc += x_tile @ C over the whole k range
template <bool CORR>
__device__ __forceinline__ void warp_tile_tf32(const uint32_t* xh, const uint32_t* xl,
                                               int xs, const uint32_t* yh,
                                               const uint32_t* yl, int dp, int row0,
                                               int col0, float (&acc)[NT][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int arow = row0 + (lane & 7) + 8 * ((lane >> 3) & 1), acol = 4 * (lane >> 4);
  const uint32_t a_hi = smem_addr(xh + arow * xs + acol);
  const uint32_t a_lo = smem_addr(xl + arow * xs + acol);
  // fragment Q: b0 = v[bq + 8Q], b1 = v[bq + 8Q + 4]; tile j at k step s
  // takes Q = s - j (conv) or s + j (corr)
  const int bq = CORR ? col0 + g + t : dp - 1 - col0 - g + t;
  const uint32_t* ph = yh + bq;
  const uint32_t* pl = yl + bq;
  uint32_t h0[NT], h1[NT], l0[NT], l1[NT];  // fragment Q lives in slot Q mod NT
#pragma unroll
  for (int j = 1; j < NT; ++j) {  // the fragments of k step 0 but one
    const int q = CORR ? j - 1 : -j;
    const int slot = CORR ? j - 1 : NT - j;
    h0[slot] = ph[8 * q];
    h1[slot] = ph[8 * q + 4];
    l0[slot] = pl[8 * q];
    l1[slot] = pl[8 * q + 4];
  }
  const int ksteps = dp / 8;  // a multiple of NT
  for (int s0 = 0; s0 < ksteps; s0 += NT) {
    // the tensor cores add into their accumulator rounding toward zero, so
    // a chunk of 64 k sums from 0 there and the chunks add in f32 here
    float part[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) part[j][0] = part[j][1] = part[j][2] = part[j][3] = 0.f;
#pragma unroll
    for (int u = 0; u < NT; ++u) {
      const int s = s0 + u;
      const int q = CORR ? s + NT - 1 : s;
      const int slot = CORR ? (u + NT - 1) % NT : u;
      h0[slot] = ph[8 * q];
      h1[slot] = ph[8 * q + 4];
      l0[slot] = pl[8 * q];
      l1[slot] = pl[8 * q + 4];
      uint32_t ah[4], al[4];
      ldsm_x4(a_hi + 32 * s, ah);
      ldsm_x4(a_lo + 32 * s, al);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int sl = CORR ? (u + j) % NT : (u - j + NT) % NT;
        // the two small products first, then hi·hi
        mma_tf32(part[j], al, h0[sl], h1[sl]);
        mma_tf32(part[j], ah, l0[sl], l1[sl]);
        mma_tf32(part[j], ah, h0[sl], h1[sl]);
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      acc[j][0] += part[j][0];
      acc[j][1] += part[j][1];
      acc[j][2] += part[j][2];
      acc[j][3] += part[j][3];
    }
  }
}

template <bool CORR>
__global__ void __launch_bounds__(MAX_WARPS * 32, 2) dict_tf32_kernel(const Args a) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int dp = a.dp, bn = a.bn, d = a.d;
  const int xs = dp + 4;  // words per staged x row (16 bytes of padding)
  uint32_t* xh = smem;
  uint32_t* xl = xh + bn * xs;
  uint32_t* ys = xl + bn * xs;  // per entry: hi [2·dp], lo [2·dp]
  const int groups = (a.m + a.mg - 1) / a.mg;
  const int gi = blockIdx.x % groups;
  const int blk = (blockIdx.x / groups) % a.b;
  const int n0 = (blockIdx.x / groups / a.b) * bn;
  const int m0 = gi * a.mg;
  const float* x = static_cast<const float*>(a.x);
  const float* dict = static_cast<const float*>(a.dict);

  // the x tile, zero beyond n and d, split into hi and lo: whole 16-byte
  // chunks by cp.async into hi (split in place below), the rest by element
  const int chunks = dp / 4;
  const float* xb = x + (static_cast<long long>(n0) * a.b + blk) * d;
  const long long xrow = static_cast<long long>(a.b) * d;
  auto copied = [&](int r, int k) { return a.vec && n0 + r < a.n && k < d; };
  for (int idx = threadIdx.x; idx < bn * chunks; idx += blockDim.x) {
    const int r = idx / chunks, k = (idx - r * chunks) * 4;
    if (copied(r, k)) {
      cp_async16(xh + r * xs + k, xb + r * xrow + k);
      continue;
    }
    uint4 hi, lo;
    float v[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (n0 + r < a.n && k + e < d) v[e] = xb[r * xrow + k + e];
    split_tf32(v[0], hi.x, lo.x);
    split_tf32(v[1], hi.y, lo.y);
    split_tf32(v[2], hi.z, lo.z);
    split_tf32(v[3], hi.w, lo.w);
    *reinterpret_cast<uint4*>(xh + r * xs + k) = hi;
    *reinterpret_cast<uint4*>(xl + r * xs + k) = lo;
  }
  // the group's rows as v, split; four loads in flight per thread
  const int entries = a.m - m0 < a.mg ? a.m - m0 : a.mg;
  const int total = entries * 2 * dp;
  for (int base = threadIdx.x; base < total; base += 4 * blockDim.x) {
    float v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int idx = base + u * blockDim.x, e = idx / (2 * dp), q = idx - e * 2 * dp;
      if (idx < total)
        v[u] = dict[(static_cast<long long>(m0 + e) * a.b + blk) * d + row_index<CORR>(q, d, dp)];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int idx = base + u * blockDim.x, e = idx / (2 * dp), q = idx - e * 2 * dp;
      if (idx < total) split_tf32(v[u], ys[e * 4 * dp + q], ys[e * 4 * dp + 2 * dp + q]);
    }
  }
  cp_async_wait_all();
  for (int idx = threadIdx.x; idx < bn * chunks; idx += blockDim.x) {  // own copies
    const int r = idx / chunks, k = (idx - r * chunks) * 4;
    if (!copied(r, k)) continue;
    const float4 f = *reinterpret_cast<const float4*>(xh + r * xs + k);
    uint4 hi, lo;
    split_tf32(f.x, hi.x, lo.x);
    split_tf32(f.y, hi.y, lo.y);
    split_tf32(f.z, hi.z, lo.z);
    split_tf32(f.w, hi.w, lo.w);
    *reinterpret_cast<uint4*>(xh + r * xs + k) = hi;
    *reinterpret_cast<uint4*>(xl + r * xs + k) = lo;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int col_tiles = dp / WCOLS, tiles = (bn / WROWS) * col_tiles;
  for (int e = 0; e < a.mg && m0 + e < a.m; ++e) {
    const uint32_t* yh = ys + e * 4 * dp;
    for (int tile = warp; tile < tiles; tile += nwarps) {
      const int row0 = (tile / col_tiles) * WROWS, col0 = (tile % col_tiles) * WCOLS;
      if (n0 + row0 >= a.n) continue;
      float acc[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
      warp_tile_tf32<CORR>(xh, xl, xs, yh, yh + 2 * dp, dp, row0, col0, acc);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int i = col0 + 8 * j + 2 * t, nq = n0 + row0 + g;
        store_pair(a, nq, m0 + e, blk, i, acc[j][0], acc[j][1]);
        store_pair(a, nq + 8, m0 + e, blk, i, acc[j][2], acc[j][3]);
      }
    }
  }
}

// -- bf16 ----------------------------------------------------------------------

constexpr int BU = 4;                  // k steps of 16 per chunk
constexpr int BW = NT + 2 * BU - 1;    // B words a chunk's tiles read

template <bool CORR>
__device__ __forceinline__ void warp_tile_bf16(const __nv_bfloat16* xt, int xs,
                                               const uint32_t* c0, const uint32_t* c1,
                                               int dp, int row0, int col0,
                                               float (&acc)[NT][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int arow = row0 + (lane & 7) + 8 * ((lane >> 3) & 1), acol = 8 * (lane >> 4);
  const uint32_t a_addr = smem_addr(xt + arow * xs + acol);
  // word W(w): the pair (v[q], v[q + 1]), q = bq + 8w; tile j at k step s
  // takes b0 = W(2s - j), b1 = W(2s - j + 1) (conv) or W(2s + j), W(2s + j + 1)
  const int bq = CORR ? col0 + g + 2 * t : dp - 1 - col0 - g + 2 * t;
  const uint32_t* wp = (bq & 1) ? c1 + (bq - 1) / 2 : c0 + bq / 2;
  const int ksteps = dp / 16;  // a multiple of BU
  for (int s0 = 0; s0 < ksteps; s0 += BU) {
    const int wbase = CORR ? 2 * s0 : 2 * s0 - NT + 1;
    uint32_t w[BW];
#pragma unroll
    for (int i = 0; i < BW; ++i) w[i] = wp[4 * (wbase + i)];
#pragma unroll
    for (int u = 0; u < BU; ++u) {
      uint32_t af[4];
      ldsm_x4(a_addr + 32 * (s0 + u), af);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int i = CORR ? 2 * u + j : 2 * u - j + NT - 1;
        mma_bf16(acc[j], af, w[i], w[i + 1]);
      }
    }
  }
}

template <bool CORR>
__global__ void __launch_bounds__(MAX_WARPS * 32, 2) dict_bf16_kernel(const Args a) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int dp = a.dp, bn = a.bn, d = a.d;
  const int xs = dp + 8;  // bf16 per staged x row (16 bytes of padding)
  __nv_bfloat16* xt = reinterpret_cast<__nv_bfloat16*>(smem);
  uint32_t* ys = smem + bn * xs / 2;  // per entry: copy 0 [dp], 16 words, copy 1 [dp]
  const int ystride = 2 * dp + 16;
  // the warp's output buffer [WROWS][OB_PITCH], after the staged rows
  __nv_bfloat16* ob = reinterpret_cast<__nv_bfloat16*>(ys + a.mg * ystride) +
                      (threadIdx.x >> 5) * WROWS * OB_PITCH;
  const int groups = (a.m + a.mg - 1) / a.mg;
  const int gi = blockIdx.x % groups;
  const int blk = (blockIdx.x / groups) % a.b;
  const int n0 = (blockIdx.x / groups / a.b) * bn;
  const int m0 = gi * a.mg;
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(a.x);
  const unsigned short* dict = static_cast<const unsigned short*>(a.dict);

  const int chunks = dp / 8;
  const __nv_bfloat16* xb = x + (static_cast<long long>(n0) * a.b + blk) * d;
  const long long xrow = static_cast<long long>(a.b) * d;
  for (int idx = threadIdx.x; idx < bn * chunks; idx += blockDim.x) {
    const int r = idx / chunks, k = (idx - r * chunks) * 8;
    const bool row = n0 + r < a.n;
    if (a.vec && row && k < d) {
      cp_async16(xt + r * xs + k, xb + r * xrow + k);
      continue;
    }
    unsigned short h[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    const unsigned short* s16 = reinterpret_cast<const unsigned short*>(xb + r * xrow + k);
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (row && k + e < d) h[e] = s16[e];
    *reinterpret_cast<uint4*>(xt + r * xs + k) =
        make_uint4(h[0] | (uint32_t(h[1]) << 16), h[2] | (uint32_t(h[3]) << 16),
                   h[4] | (uint32_t(h[5]) << 16), h[6] | (uint32_t(h[7]) << 16));
  }
  // the group's rows as the two word copies; two words in flight per thread
  const int entries = a.m - m0 < a.mg ? a.m - m0 : a.mg;
  const int total = entries * dp;
  for (int base = threadIdx.x; base < total; base += 2 * blockDim.x) {
    uint32_t v[2][3];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int idx = base + u * blockDim.x, e = idx / dp, w = idx - e * dp;
      const unsigned short* y = dict + (static_cast<long long>(m0 + e) * a.b + blk) * d;
      if (idx < total) {
#pragma unroll
        for (int i = 0; i < 3; ++i) v[u][i] = y[row_index<CORR>(2 * w + i, d, dp)];
      }
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int idx = base + u * blockDim.x, e = idx / dp, w = idx - e * dp;
      if (idx < total) {
        uint32_t* c0 = ys + e * ystride;
        c0[w] = v[u][0] | (v[u][1] << 16);
        c0[dp + 16 + w] = v[u][1] | (v[u][2] << 16);
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();

  const int warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int col_tiles = dp / WCOLS, tiles = (bn / WROWS) * col_tiles;
  for (int e = 0; e < a.mg && m0 + e < a.m; ++e) {
    const uint32_t* c0 = ys + e * ystride;
    for (int tile = warp; tile < tiles; tile += nwarps) {
      const int row0 = (tile / col_tiles) * WROWS, col0 = (tile % col_tiles) * WCOLS;
      if (n0 + row0 >= a.n) continue;
      float acc[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
      warp_tile_bf16<CORR>(xt, xs, c0, c0 + dp + 16, dp, row0, col0, acc);
      // through the warp's buffer, so that each lane stores 16 bytes and a
      // row's 128 bytes go out whole: two-byte pairs straight from the C
      // fragments leave half sectors (measured: the stores cost more than
      // the products)
      __syncwarp();  // the last tile's reads of the buffer are done
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int col = 8 * j + 2 * t;
        *reinterpret_cast<__nv_bfloat162*>(ob + g * OB_PITCH + col) =
            __floats2bfloat162_rn(acc[j][0], acc[j][1]);
        *reinterpret_cast<__nv_bfloat162*>(ob + (g + 8) * OB_PITCH + col) =
            __floats2bfloat162_rn(acc[j][2], acc[j][3]);
      }
      __syncwarp();
#pragma unroll
      for (int it = 0; it < WROWS * WCOLS / 8 / 32; ++it) {
        const int r = it * 4 + (lane >> 3), c = 8 * (lane & 7);
        const int nq = n0 + row0 + r, i = col0 + c;
        if (nq >= a.n || i >= d) continue;
        __nv_bfloat16* o = static_cast<__nv_bfloat16*>(a.out) +
                           ((static_cast<long long>(nq) * a.m + m0 + e) * a.b + blk) * d + i;
        const __nv_bfloat16* src = ob + r * OB_PITCH + c;
        if (a.vec_out && i + 8 <= d) {
          *reinterpret_cast<uint4*>(o) = *reinterpret_cast<const uint4*>(src);
        } else {
          for (int k = 0; k < 8 && i + k < d; ++k) o[k] = src[k];
        }
      }
    }
  }
}

template <typename T>
cudaError_t launch(Args a, int corr, cudaStream_t stream) {
  constexpr bool BF16 = sizeof(T) == 2;
  const int d = a.d;
  a.dp = (d + WCOLS - 1) / WCOLS * WCOLS;
  a.bn = a.n > WROWS && smem_bytes(a.dp, 2 * WROWS, 1, BF16) <= MAX_SMEM ? 2 * WROWS : WROWS;
  if (smem_bytes(a.dp, a.bn, 1, BF16) > MAX_SMEM) return cudaErrorInvalidValue;
  const long long tiles_n = (a.n + a.bn - 1) / a.bn;
  auto blocks_for = [&](int mg) { return tiles_n * a.b * ((a.m + mg - 1) / mg); };
  a.mg = 1;
  while (2 * a.mg <= a.m && 2 * a.mg <= MAX_GROUP &&
         smem_bytes(a.dp, a.bn, 2 * a.mg, BF16) <= MAX_SMEM && blocks_for(2 * a.mg) >= SMS)
    a.mg *= 2;
  const long long blocks = blocks_for(a.mg);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const int warp_tiles = (a.bn / WROWS) * (a.dp / WCOLS);
  const int threads = 32 * (warp_tiles < MAX_WARPS ? warp_tiles : MAX_WARPS);
  constexpr int E = 16 / sizeof(T);  // elements per 16 bytes
  a.vec = d % E == 0 && reinterpret_cast<uintptr_t>(a.x) % 16 == 0;
  a.vec_out = d % E == 0 && reinterpret_cast<uintptr_t>(a.out) % 16 == 0;
  const size_t smem = smem_bytes(a.dp, a.bn, a.mg, BF16);
  void (*kernel)(const Args);
  if constexpr (BF16) {
    kernel = corr ? dict_bf16_kernel<true> : dict_bf16_kernel<false>;
  } else {
    kernel = corr ? dict_tf32_kernel<true> : dict_tf32_kernel<false>;
  }
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
  kernel<<<static_cast<unsigned int>(blocks), threads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  corr: 0 = conv, 1 = corr.  Writes
// out as (N, M, B, d).  Returns the cudaError_t of the launch (0 on
// success); cudaErrorInvalidValue when d needs more shared memory than a
// block has (`kernels/circ_conv/ops.py:dict_smem_bytes` is the same
// formula).
extern "C" int circ_dict_launch(const void* x, const void* dict, void* out, int n, int m,
                                int b, int d, int dtype, int corr, void* stream) {
  if (n <= 0 || m <= 0 || b <= 0 || d <= 0) return 0;  // nothing to compute
  Args a{};
  a.x = x;
  a.dict = dict;
  a.out = out;
  a.n = n;
  a.m = m;
  a.b = b;
  a.d = d;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(launch<float>(a, corr, s));
  if (dtype == 1) return static_cast<int>(launch<__nv_bfloat16>(a, corr, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
