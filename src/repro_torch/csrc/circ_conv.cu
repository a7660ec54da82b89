// Blockwise circular convolution / correlation of N×B independent pairs.
//
//   conv: out[r, n] = sum_k x[r, k] * y[r, (n - k) mod d]
//   corr: out[r, n] = sum_k x[r, k] * y[r, (n + k) mod d]
//
// for every row r of the contiguous (N, B, d) inputs, f32 accumulation,
// output in x's dtype (f32 or bf16).
//
// Replaces the Pallas TPU kernel src/repro/kernels/circ_conv/kernel.py
// `circ_elem` (`_elem_kernel`).  That kernel builds a d×d circulant in VMEM
// with log2(d) roll-selects so the MXU can do the work as a batched
// mat-vec; the circulant is a TPU device, not the semantics, and is not
// copied here.
//
// Design: one thread block per row (one (n, b) pair).  The block stages x
// and y in shared memory (2·d·4 bytes, 2 KB at d = 256), then each thread
// owns output indices n, n + blockDim, ... and loops over k.  x[k] is a
// broadcast read (every thread the same address) and y[(n ∓ k) mod d] is
// read at consecutive addresses by consecutive threads, so neither read
// conflicts on shared-memory banks.  The index wraps by a compare, not a
// modulo, so any d >= 1 works.
//
// What bounds it on an H100: the work is 2·N·B·d² flops on about
// 12·N·B·d bytes (x, y read, out written, f32).  At the serving path's
// shapes (N <= 64 rows of B = 4 blocks at d = 256) that is ~34 MFLOP and
// ~0.8 MB, well under 10 µs of either resource, so the launch latency
// bounds it.  The flops run on the CUDA cores in f32 (67 TFLOP/s peak),
// not the tensor cores: a faster version would build the circulant tile
// in shared memory and use the tensor cores, or batch many binds in one
// launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T, bool CORR>
__global__ void circ_elem_kernel(const T* __restrict__ x, const T* __restrict__ y,
                                 T* __restrict__ out, int d) {
  extern __shared__ float smem[];
  float* xs = smem;
  float* ys = smem + d;
  const long long base = static_cast<long long>(blockIdx.x) * d;
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    xs[i] = to_f32(x[base + i]);
    ys[i] = to_f32(y[base + i]);
  }
  __syncthreads();
  for (int n = threadIdx.x; n < d; n += blockDim.x) {
    float acc = 0.f;
    for (int k = 0; k < d; ++k) {
      int j = CORR ? n + k : n - k;
      if (CORR) {
        if (j >= d) j -= d;
      } else {
        if (j < 0) j += d;
      }
      acc += xs[k] * ys[j];
    }
    out[base + n] = from_f32<T>(acc);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* y, void* out, long long rows, int d,
                   int corr, cudaStream_t stream) {
  const int threads = d >= 256 ? 256 : ((d + 31) / 32) * 32;
  const size_t smem = 2 * static_cast<size_t>(d) * sizeof(float);
  auto kernel = corr ? circ_elem_kernel<T, true> : circ_elem_kernel<T, false>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<static_cast<unsigned int>(rows), threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(y), static_cast<T*>(out), d);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  corr: 0 = conv, 1 = corr.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int circ_elem_launch(const void* x, const void* y, void* out,
                                long long rows, int d, int dtype, int corr,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(launch<float>(x, y, out, rows, d, corr, s));
  if (dtype == 1) return static_cast<int>(launch<__nv_bfloat16>(x, y, out, rows, d, corr, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
