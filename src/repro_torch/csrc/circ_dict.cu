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
// feeds it to the MXU as a (tile_n × d) @ (d × d) matmul.  The circulant
// is a device of the MXU, not the semantics, and is not copied here.
//
// Design: one thread block per (query tile of TN = 16 queries, dictionary
// row (m, b)).  The block stages the dictionary row (d floats) and the
// tile's 16 query rows (transposed, [d][16]) in shared memory once; each
// thread then owns output indices i, i + blockDim, ... and walks k, reading
// dict[(i ∓ k) mod d] once for all 16 queries (16 accumulators in
// registers) and the 16 x[., k] as four broadcast float4 loads.  The entry
// is reused by the whole tile without being rebuilt per query.  The index
// wraps by a compare, so any d works whose (TN + 1)·d·4 bytes fit shared
// memory (d <= 3418); the wrapper raises above that.
//
// What bounds it on an H100: 2·N·M·B·d² flops against (N + M)·B·d inputs
// and N·M·B·d outputs.  At (N, M, B, d) = (256, 16, 4, 256) f32 that is
// 2.15 GFLOP (0.032 ms on the 67 TFLOP/s f32 CUDA cores) against 18 MB
// (0.005 ms of HBM): operations bound.  This version runs on the CUDA
// cores; the circulant product on the tensor cores (a (TN × d) @ (d × d)
// GEMM per entry, as the TPU does) is the redesign.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TN = 16;  // queries per block (a multiple of 4: float4 reads)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T, bool CORR>
__global__ void circ_dict_kernel(const T* __restrict__ x, const T* __restrict__ dict,
                                 T* __restrict__ out, int n, int m, int b, int d) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;           // [d][TN]: the query tile, transposed
  float* ys = smem + TN * d;  // [d]: dictionary row (m_i, blk)
  const int row = blockIdx.y;  // m_i * b + blk
  const int blk = row % b;
  const int n0 = blockIdx.x * TN;
  const T* yrow = dict + static_cast<long long>(row) * d;
  for (int k = threadIdx.x; k < d; k += blockDim.x) ys[k] = to_f32(yrow[k]);
  for (int t = 0; t < TN; ++t) {
    const int nq = n0 + t;
    const T* xrow = x + (static_cast<long long>(nq) * b + blk) * d;
    for (int k = threadIdx.x; k < d; k += blockDim.x)
      xs[k * TN + t] = nq < n ? to_f32(xrow[k]) : 0.f;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    float acc[TN];
#pragma unroll
    for (int t = 0; t < TN; ++t) acc[t] = 0.f;
    int j = i;  // conv: (i - k) mod d; corr: (i + k) mod d
    for (int k = 0; k < d; ++k) {
      const float yv = ys[j];
      const float4* xk = reinterpret_cast<const float4*>(xs + k * TN);
#pragma unroll
      for (int t4 = 0; t4 < TN / 4; ++t4) {
        const float4 v = xk[t4];
        acc[4 * t4 + 0] += v.x * yv;
        acc[4 * t4 + 1] += v.y * yv;
        acc[4 * t4 + 2] += v.z * yv;
        acc[4 * t4 + 3] += v.w * yv;
      }
      if (CORR) {
        if (++j == d) j = 0;
      } else {
        if (--j < 0) j = d - 1;
      }
    }
#pragma unroll
    for (int t = 0; t < TN; ++t) {
      const int nq = n0 + t;
      if (nq < n) {
        // out[nq, m_i, blk, :] starts at row (nq * m + m_i) * b + blk
        const long long o = static_cast<long long>(nq) * m * b + row;
        out[o * d + i] = from_f32<T>(acc[t]);
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* dict, void* out, int n, int m, int b,
                   int d, int corr, cudaStream_t stream) {
  const int threads = d >= 256 ? 256 : ((d + 31) / 32) * 32;
  const size_t smem = static_cast<size_t>(TN + 1) * d * sizeof(float);
  auto kernel = corr ? circ_dict_kernel<T, true> : circ_dict_kernel<T, false>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((n + TN - 1) / TN, m * b);
  kernel<<<grid, threads, smem, stream>>>(static_cast<const T*>(x),
                                          static_cast<const T*>(dict),
                                          static_cast<T*>(out), n, m, b, d);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  corr: 0 = conv, 1 = corr.  Writes
// out as (N, M, B, d).  Returns the cudaError_t of the launch (0 on
// success).
extern "C" int circ_dict_launch(const void* x, const void* dict, void* out, int n, int m,
                                int b, int d, int dtype, int corr, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(launch<float>(x, dict, out, n, m, b, d, corr, s));
  if (dtype == 1)
    return static_cast<int>(
        launch<__nv_bfloat16>(x, dict, out, n, m, b, d, corr, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
