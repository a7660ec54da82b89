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
// axis; here one block owns a 16×16 output tile, loops over K in steps of
// 32 with both operand tiles in shared memory, and masks the M, N and K
// edges itself, so no padded copies are made.  int4 weights are unpacked
// as they are staged into shared memory.
//
// What bounds it on an H100: at the serving path's shapes (M = 8·bucket
// <= 64, K = 128, N in {5, 6, 8}) the work is ~130 K int8 MACs on ~10 KB,
// nanoseconds of either resource, so the launch latency bounds it.  The
// MACs run as plain int32 multiply-adds on the CUDA cores; a kernel for
// large shapes would feed the int8 tensor cores instead.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int TM = 16;
constexpr int TN = 16;
constexpr int TK = 32;

template <bool INT4>
__global__ void qmm_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ wq,
                           const float* __restrict__ xs, const float* __restrict__ ws,
                           float* __restrict__ out, int M, int N, int K, int w_cols) {
  __shared__ int8_t xt[TM][TK];
  __shared__ int8_t wt[TK][TN];
  const int tx = threadIdx.x;  // output column within the tile
  const int ty = threadIdx.y;  // output row within the tile
  const int tid = ty * TN + tx;
  const int m0 = blockIdx.y * TM;
  const int n0 = blockIdx.x * TN;
  int acc = 0;
  for (int k0 = 0; k0 < K; k0 += TK) {
    for (int i = tid; i < TM * TK; i += TM * TN) {
      const int r = i / TK, c = i % TK;
      const int gm = m0 + r, gk = k0 + c;
      xt[r][c] = (gm < M && gk < K) ? xq[static_cast<long long>(gm) * K + gk] : int8_t(0);
    }
    for (int i = tid; i < TK * TN; i += TM * TN) {
      const int r = i / TN, c = i % TN;
      const int gk = k0 + r, gn = n0 + c;
      int8_t v = 0;
      if (gk < K && gn < N) {
        if (INT4) {
          const int8_t byte = wq[static_cast<long long>(gk) * w_cols + (gn >> 1)];
          v = (gn & 1) ? static_cast<int8_t>(byte >> 4)
                       : static_cast<int8_t>(static_cast<int8_t>(byte << 4) >> 4);
        } else {
          v = wq[static_cast<long long>(gk) * w_cols + gn];
        }
      }
      wt[r][c] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK; ++kk) {
      acc += static_cast<int>(xt[ty][kk]) * static_cast<int>(wt[kk][tx]);
    }
    __syncthreads();
  }
  const int m = m0 + ty, n = n0 + tx;
  if (m < M && n < N) {
    out[static_cast<long long>(m) * N + n] = static_cast<float>(acc) * (xs[m] * ws[n]);
  }
}

}  // namespace

// int4: 0 = wq is (K, N) int8, 1 = wq is (K, N/2) packed int4 (N even).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int qmatmul_launch(const void* xq, const void* wq, const void* xs,
                              const void* ws, void* out, int M, int N, int K,
                              int int4, void* stream) {
  const dim3 block(TN, TM);
  const dim3 grid((N + TN - 1) / TN, (M + TM - 1) / TM);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* x = static_cast<const int8_t*>(xq);
  const int8_t* w = static_cast<const int8_t*>(wq);
  const float* a = static_cast<const float*>(xs);
  const float* b = static_cast<const float*>(ws);
  float* y = static_cast<float*>(out);
  if (int4) {
    qmm_kernel<true><<<grid, block, 0, s>>>(x, w, a, b, y, M, N, K, N / 2);
  } else {
    qmm_kernel<false><<<grid, block, 0, s>>>(x, w, a, b, y, M, N, K, N);
  }
  return static_cast<int>(cudaGetLastError());
}
