// Fused VSA unbind -> dense classify head (MIMONet's symbolic tail).
//
//   out[n, k, c] = b[c] + sum_blk sum_j unbound[n, k, blk, j] * w[blk, j, c]
//   unbound[n, k, blk, j] = sum_i keys[k, blk, i] * x[n, blk, (j + i) mod d]
//
// i.e. corr(keys[k], x[n]) (the argument order of vsa.unbind(keys, x))
// followed by the dense head, for contiguous f32 keys (K, B, d), x (N, B, d),
// w (B, d, C) and b (1, C); out (N, K, C) f32.  The unbound codes never
// leave the block: they are formed in registers and multiplied straight into
// the head.
//
// Replaces the Pallas TPU kernel src/repro/kernels/unbind_classify/kernel.py
// `fused_unbind_classify` (`_unbind_classify_kernel`).  That kernel builds
// each key block's d×d correlation circulant in VMEM for the MXU and
// accumulates the logits across a grid axis over the B blocks; neither
// carries over.
//
// Design: one thread block per output row (n, k).  A loop inside the block
// walks the B blocks: it stages keys[k, blk, :] and x[n, blk, :] in shared
// memory (2·d·4 bytes), then each thread owns indices j, j + blockDim, ...,
// forms unbound[j] with the compare-and-wrap index of circ_conv.cu (any
// d >= 1) and multiplies it into w[blk, j, :], keeping C partial sums in
// registers (C <= MAX_C = 32; the wrapper raises above).  A fixed-order
// reduction ends the block: a butterfly of warp shuffles, then the warps'
// partials summed in warp order from shared memory by the first C threads,
// which write b[c] + sum.  There are no atomics, so repeated launches give
// bit-identical results.
//
// What bounds it on an H100: the work is 2·N·K·B·(d² + d·C) flops.  At the
// serving path's shape (N = 8, K = 2, B = 4, d = 128, C = 5) that is about
// 2.18 MFLOP, 0.033 µs at 67 TFLOP/s f32 (CUDA cores), on about 31 KB of
// inputs and outputs, 0.009 µs at 3.35 TB/s: operations bound it, and at
// N·K = 16 blocks on 132 SMs the launch latency (microseconds) dominates
// both.  This kernel takes the simple route that is right: it spends one
// launch where the staged path spends two (circ_conv corr, then a dense
// head) and writes no unbound codes to memory.  A faster version would put
// several (n, k) rows in one block so that each staged key block is reused,
// and the d² products on the tensor cores.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_C = 32;
constexpr int MAX_WARPS = 8;  // threads per block <= 256

__global__ void unbind_classify_kernel(const float* __restrict__ keys,
                                       const float* __restrict__ x,
                                       const float* __restrict__ w,
                                       const float* __restrict__ b,
                                       float* __restrict__ out,
                                       int n_keys, int blocks, int d, int n_cls) {
  extern __shared__ float smem[];
  float* ks = smem;      // keys[k, blk, :]
  float* xs = smem + d;  // x[n, blk, :]
  __shared__ float red[MAX_WARPS][MAX_C];

  const int row = blockIdx.x;  // n * K + k
  const int n = row / n_keys;
  const int k = row - n * n_keys;
  float acc[MAX_C];
#pragma unroll
  for (int c = 0; c < MAX_C; ++c) acc[c] = 0.f;

  for (int blk = 0; blk < blocks; ++blk) {
    const long long kbase = (static_cast<long long>(k) * blocks + blk) * d;
    const long long xbase = (static_cast<long long>(n) * blocks + blk) * d;
    for (int i = threadIdx.x; i < d; i += blockDim.x) {
      ks[i] = keys[kbase + i];
      xs[i] = x[xbase + i];
    }
    __syncthreads();
    for (int j = threadIdx.x; j < d; j += blockDim.x) {
      float u = 0.f;
      for (int i = 0; i < d; ++i) {
        int m = j + i;
        if (m >= d) m -= d;
        u += ks[i] * xs[m];
      }
      const float* wrow = w + (static_cast<long long>(blk) * d + j) * n_cls;
#pragma unroll
      for (int c = 0; c < MAX_C; ++c) {
        if (c < n_cls) acc[c] += u * wrow[c];
      }
    }
    __syncthreads();  // the next block overwrites ks / xs
  }

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int c = 0; c < MAX_C; ++c) {
    if (c < n_cls) {
      float v = acc[c];
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0) red[warp][c] = v;
    }
  }
  __syncthreads();
  if (threadIdx.x < n_cls) {
    const int c = threadIdx.x;
    const int warps = (blockDim.x + 31) >> 5;
    float s = 0.f;
    for (int i = 0; i < warps; ++i) s += red[i][c];
    out[static_cast<long long>(row) * n_cls + c] = b[c] + s;
  }
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success); cudaErrorInvalidValue
// when n_cls exceeds MAX_C.
extern "C" int unbind_classify_launch(const void* keys, const void* x, const void* w,
                                      const void* b, void* out, long long n, int n_keys,
                                      int blocks, int d, int n_cls, void* stream) {
  if (n_cls < 1 || n_cls > MAX_C) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = d >= 256 ? 256 : ((d + 31) / 32) * 32;
  const size_t smem = 2 * static_cast<size_t>(d) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(unbind_classify_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long rows = n * n_keys;
  unbind_classify_kernel<<<static_cast<unsigned int>(rows), threads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(keys), static_cast<const float*>(x),
      static_cast<const float*>(w), static_cast<const float*>(b),
      static_cast<float*>(out), n_keys, blocks, d, n_cls);
  return static_cast<int>(cudaGetLastError());
}
