// Quantised matmul: int8 activations times int8 or packed-int4 weights.
//
//   y[m, n] = float(sum_k xq[m, k] * wq[k, n]) * (xs[m] * ws[n])
//
// xq (M, K) int8 row-major; wq (K, N) int8, or (K, N/2) bytes holding two
// int4 values each (low nibble = even column, high nibble = odd column,
// both sign-extended by an arithmetic shift); xs (M,) and ws (N,) f32;
// y (M, N) f32.  The sum is an exact int32 accumulator.  The epilogue keeps
// the association of the Pallas kernel, acc * (xs * ws): the JAX reference
// qmatmul_ref computes (acc * xs) * ws, which can differ by one ulp.
//
// Replaces the Pallas TPU kernel src/repro/kernels/qmatmul/kernel.py
// `qmatmul` (`_qmm_kernel`, `unpack_int4`).  The TPU kernel pads M, N and K
// to its block shape and carries the int32 tile across a sequential K grid
// axis; here the K loop is inside the block, and the M, N and K edges are
// zeros in shared memory, so no padded copies are made.
//
// What bounds it on an H100: at the serving path's shapes (M = 8·bucket
// <= 64, K = 128, N in {5, 6, 8}) the work is ~131 K int8 MACs on ~11 KB,
// nanoseconds of either the int8 tensor cores (1979 TOP/s) or HBM, so the
// launch latency and one dependent global-memory round trip bound it; at
// large shapes the int8 tensor cores do.
//
// Design.  The products are `mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.
// s32`: exact int32 sums on the int8 tensor cores.  A block is 4 warps
// over a 64 x 8 output tile, a warp owns 16 x 8, so the served N in
// {5, 6, 8} is one n-tile and M = 64 one block.  The whole K of the block's
// x rows and of its 8 weight columns is staged at once where it fits (K <=
// 512, rounded up to 32: at K = 128, 8 KB of x and 1 KB of w), so a served
// call makes one global-memory round trip: x by 16-byte `cp.async.cg`
// (rows beyond M zero-filled by the copy itself), w by byte loads that
// transpose it to [n][k] and unpack int4 to sign-extended int8, low nibble
// first, as ref.unpack_int4_ref.  Beyond K = 512, 256-wide K chunks go
// through a two-stage ring: chunk c + 1's x copies and w loads (held in
// registers) are in flight while chunk c's `mma`s run.  K, M and N edges
// are zeros in shared memory; an x whose K is not a multiple of 16 (or an
// unaligned base) is staged by element loads instead of `cp.async`, 16
// bytes of a row per thread, all loaded before any is stored, so they are
// in flight together.
// Shared rows are padded by 16 bytes, so the 32-bit fragment loads of a
// warp (lane (g, t) reads row g at byte 4t) fall in 32 distinct banks.  The
// epilogue is float(acc) * (xs[m] * ws[n]), so the output equals the plain
// version bit for bit.
//
// ptxas (nvcc -Xptxas -v, sm_90a, CUDA 12.8): 91 registers (int8 and int4),
// no spills.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 4;
constexpr int BM = 16 * WARPS;  // output rows per block
constexpr int BN = 8;           // output columns per block
constexpr int PAD = 16;         // bytes of padding per shared row
constexpr int WHOLE_K = 512;    // K staged in one phase up to this
constexpr int RING_K = 256;     // K per ring stage beyond it
constexpr int THREADS = 32 * WARPS;
constexpr int W_PER_THREAD = BN * RING_K / THREADS;

struct Args {
  const int8_t* xq;
  const int8_t* wq;
  const float* xs;
  const float* ws;
  float* out;
  int M, N, K, w_cols;
  int kc;       // K per stage (a multiple of 32)
  int chunks;   // stages of kc to cover K
  int vec_x;    // x by 16-byte cp.async
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(dst), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the weight at (k, n), unpacked; 0 beyond K or N
template <bool INT4>
__device__ __forceinline__ int8_t weight(const Args& a, int k, int n) {
  if (k >= a.K || n >= a.N) return 0;
  if (INT4) {
    const int8_t byte = a.wq[static_cast<long long>(k) * a.w_cols + (n >> 1)];
    return (n & 1) ? static_cast<int8_t>(byte >> 4)
                   : static_cast<int8_t>(static_cast<int8_t>(byte << 4) >> 4);
  }
  return a.wq[static_cast<long long>(k) * a.w_cols + n];
}

// x rows [m0, m0 + BM), K range [k0, k0 + kc) -> xt[BM][kc + PAD]
__device__ __forceinline__ void stage_x(const Args& a, int8_t* xt, int m0, int k0) {
  const int stride = a.kc + PAD;
  if (a.vec_x) {
    const int per_row = a.kc / 16;
    for (int i = threadIdx.x; i < BM * per_row; i += THREADS) {
      const int r = i / per_row, q = i % per_row;
      const int gm = m0 + r, gk = k0 + 16 * q;
      const bool in = gm < a.M && gk < a.K;  // K % 16 == 0: whole or nothing
      const int8_t* src = in ? a.xq + static_cast<long long>(gm) * a.K + gk : a.xq;
      cp_async16(smem_addr(xt + r * stride + 16 * q), src, in ? 16 : 0);
    }
  } else {  // 16 consecutive bytes of one row per thread, loaded before stored
    constexpr int RUN = 16;
    for (int i = threadIdx.x * RUN; i < BM * a.kc; i += THREADS * RUN) {
      const int r = i / a.kc, c = i % a.kc;  // kc % 32 == 0: the run stays in row r
      const int gm = m0 + r;
      int8_t v[RUN];
#pragma unroll
      for (int j = 0; j < RUN; ++j) {
        const int gk = k0 + c + j;
        v[j] = gm < a.M && gk < a.K ? a.xq[static_cast<long long>(gm) * a.K + gk] : int8_t(0);
      }
#pragma unroll
      for (int j = 0; j < RUN; ++j) xt[r * stride + c + j] = v[j];
    }
  }
}

// w columns [n0, n0 + BN), K range [k0, k0 + kc) -> wt[BN][kc + PAD]
template <bool INT4>
__device__ __forceinline__ void stage_w(const Args& a, int8_t* wt, int n0, int k0) {
  const int stride = a.kc + PAD;
  for (int c = threadIdx.x; c < a.kc; c += THREADS) {  // one k row per thread
    int8_t v[BN];
#pragma unroll
    for (int n = 0; n < BN; ++n) v[n] = weight<INT4>(a, k0 + c, n0 + n);
#pragma unroll
    for (int n = 0; n < BN; ++n) wt[n * stride + c] = v[n];
  }
}

template <bool INT4>
__global__ void __launch_bounds__(THREADS) qmm_kernel(const Args a) {
  extern __shared__ __align__(16) int8_t smem[];
  const int stride = a.kc + PAD;
  const int stage_bytes = (BM + BN) * stride;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  int acc[4] = {0, 0, 0, 0};

  int8_t wr[W_PER_THREAD];  // the next ring stage's weights, in flight
  stage_x(a, smem, m0, 0);
  cp_async_commit();
  stage_w<INT4>(a, smem + BM * stride, n0, 0);
  for (int c = 0; c < a.chunks; ++c) {
    int8_t* xt = smem + (c & 1) * stage_bytes;
    int8_t* wt = xt + BM * stride;
    const bool next = c + 1 < a.chunks;
    if (next) {  // ring: only where kc == RING_K
      stage_x(a, smem + ((c + 1) & 1) * stage_bytes, m0, (c + 1) * a.kc);
      cp_async_commit();
#pragma unroll
      for (int i = 0; i < W_PER_THREAD; ++i) {
        const int e = threadIdx.x + i * THREADS;
        wr[i] = weight<INT4>(a, (c + 1) * a.kc + e / BN, n0 + e % BN);
      }
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int8_t* xa = xt + (16 * warp + g) * stride + 4 * t;
    const int8_t* wb = wt + g * stride + 4 * t;
    for (int k = 0; k < a.kc; k += 32) {
      const uint32_t fa[4] = {*reinterpret_cast<const uint32_t*>(xa + k),
                              *reinterpret_cast<const uint32_t*>(xa + 8 * stride + k),
                              *reinterpret_cast<const uint32_t*>(xa + k + 16),
                              *reinterpret_cast<const uint32_t*>(xa + 8 * stride + k + 16)};
      mma_s8(acc, fa, *reinterpret_cast<const uint32_t*>(wb + k),
             *reinterpret_cast<const uint32_t*>(wb + k + 16));
    }
    if (next) {
      int8_t* wn = smem + ((c + 1) & 1) * stage_bytes + BM * stride;
#pragma unroll
      for (int i = 0; i < W_PER_THREAD; ++i) {
        const int e = threadIdx.x + i * THREADS;
        wn[(e % BN) * stride + e / BN] = wr[i];
      }
    }
    __syncthreads();
  }

  // lane (g, t) holds rows g, g + 8 at columns 2t, 2t + 1
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + 16 * warp + g + (i >= 2 ? 8 : 0);
    const int n = n0 + 2 * t + (i & 1);
    if (m < a.M && n < a.N)
      a.out[static_cast<long long>(m) * a.N + n] =
          static_cast<float>(acc[i]) * (a.xs[m] * a.ws[n]);
  }
}

}  // namespace

// int4: 0 = wq is (K, N) int8, 1 = wq is (K, N/2) packed int4 (N even).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int qmatmul_launch(const void* xq, const void* wq, const void* xs,
                              const void* ws, void* out, int M, int N, int K,
                              int int4, void* stream) {
  if (M <= 0 || N <= 0) return 0;  // nothing to compute
  Args a{};
  a.xq = static_cast<const int8_t*>(xq);
  a.wq = static_cast<const int8_t*>(wq);
  a.xs = static_cast<const float*>(xs);
  a.ws = static_cast<const float*>(ws);
  a.out = static_cast<float*>(out);
  a.M = M;
  a.N = N;
  a.K = K;
  a.w_cols = int4 ? N / 2 : N;
  const int kp = (K + 31) / 32 * 32;
  a.kc = kp <= WHOLE_K ? (kp > 0 ? kp : 32) : RING_K;
  a.chunks = (kp + a.kc - 1) / a.kc;
  if (a.chunks < 1) a.chunks = 1;
  a.vec_x = K % 16 == 0 && reinterpret_cast<uintptr_t>(xq) % 16 == 0;
  const size_t smem = static_cast<size_t>(a.chunks > 1 ? 2 : 1) * (BM + BN) * (a.kc + PAD);
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (int4) {
    qmm_kernel<true><<<grid, THREADS, smem, s>>>(a);
  } else {
    qmm_kernel<false><<<grid, THREADS, smem, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
