// Fused VSA match probability (the paper's SIMD unit, Listing 1's
// match_prob_multi_batched):
//
//   qn[n, b, :] = q[n, b, :] * rsqrt(sum q[n, b, :]^2 + 1e-18)   (same for dict)
//   z[n, m]     = (sum_{b, i} qn[n, b, i] * dn[m, b, i]) / B / temp
//   out[n, m]   = exp(z[n, m] - max_m z[n, :]) / sum_m exp(...)
//
// for contiguous q (N, B, d) and dict (M, B, d), f32 or bf16 (one dtype),
// f32 arithmetic, output (N, M) f32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/simd_fused/kernel.py
// `fused_match_prob` (`_match_prob_kernel`), whose grid walks query tiles
// with the whole dictionary resident in VMEM and normalises the dictionary
// again at every grid step.
//
// Design: two kernels behind one entry point.
//  1. `normalise_rows` normalises each dictionary block once per launch
//     (one warp per (m, b) row) into an f32 scratch the wrapper allocates.
//  2. `match_prob_kernel`: one thread block per tile of TQ = 4 queries.  It
//     stages the tile's normalised query rows (TQ x B·d) and keeps the
//     tile's TQ x M logits in shared memory, and streams the normalised
//     dictionary through shared memory in chunks of `mc` entries (the
//     wrapper picks `mc` so that all three fit).  Each warp takes one entry
//     of a chunk and computes its TQ logits at once (lanes stride over B·d,
//     then a shuffle reduction in a fixed order, so repeated launches are
//     bit-identical).  Then one warp per row takes the max-subtracted
//     softmax over the M logits on chip and writes the row.
//
// What bounds it on an H100: 2·N·M·B·d flops against (N + M)·B·d inputs
// and N·M f32 outputs.  At (N, M, B, d) = (512, 16, 4, 256) f32 that is 17
// MFLOP (0.00025 ms at 67 TFLOP/s) against 2.2 MB (0.00066 ms at 3.35
// TB/s): bytes bound, and at this size really by the latency of two
// launches and of each block's serial chain (stage, dot, reduce, softmax).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int TQ = 4;          // query rows per block
constexpr int THREADS = 256;   // 8 warps

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// dst[r, :] = src[r, :] * rsqrt(sum src[r, :]^2 + 1e-18), one warp per row
template <typename T>
__global__ void normalise_rows(const T* __restrict__ src, float* __restrict__ dst,
                               int rows, int d) {
  const long long r = (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (r >= rows) return;
  const T* s = src + r * d;
  float ss = 0.f;
  for (int i = lane; i < d; i += 32) {
    const float v = to_f32(s[i]);
    ss += v * v;
  }
  const float scale = rsqrtf(warp_sum(ss) + 1e-18f);
  for (int i = lane; i < d; i += 32) dst[r * d + i] = to_f32(s[i]) * scale;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
match_prob_kernel(const T* __restrict__ q, const float* __restrict__ dn,
                  float* __restrict__ out, int n, int m, int b, int d, int mc,
                  float temp) {
  extern __shared__ float smem[];
  const int f = b * d;
  float* qs = smem;              // [TQ][f]: normalised query rows
  float* logit = qs + TQ * f;    // [TQ][m]
  float* ds = logit + TQ * m;    // [mc][f]: a chunk of the dictionary
  const long long n0 = static_cast<long long>(blockIdx.x) * TQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  constexpr int WARPS = THREADS / 32;

  for (int rb = warp; rb < TQ * b; rb += WARPS) {  // (row, block) pairs
    const int r = rb / b, blk = rb % b;
    float* dst = qs + r * f + blk * d;
    if (n0 + r >= n) {
      for (int i = lane; i < d; i += 32) dst[i] = 0.f;
      continue;
    }
    const T* src = q + ((n0 + r) * b + blk) * d;
    float ss = 0.f;
    for (int i = lane; i < d; i += 32) {
      const float v = to_f32(src[i]);
      dst[i] = v;
      ss += v * v;
    }
    const float scale = rsqrtf(warp_sum(ss) + 1e-18f);
    for (int i = lane; i < d; i += 32) dst[i] *= scale;  // this lane wrote dst[i]
  }

  for (int m0 = 0; m0 < m; m0 += mc) {
    const int cnt = min(mc, m - m0);
    __syncthreads();  // the query rows are staged; the last chunk is consumed
    const float* chunk = dn + static_cast<long long>(m0) * f;
    for (int i = threadIdx.x; i < cnt * f; i += THREADS) ds[i] = chunk[i];
    __syncthreads();
    for (int e = warp; e < cnt; e += WARPS) {
      float acc[TQ];
#pragma unroll
      for (int r = 0; r < TQ; ++r) acc[r] = 0.f;
      const float* de = ds + e * f;
      for (int i = lane; i < f; i += 32) {
        const float dv = de[i];
#pragma unroll
        for (int r = 0; r < TQ; ++r) acc[r] += qs[r * f + i] * dv;
      }
#pragma unroll
      for (int r = 0; r < TQ; ++r) {
        const float s = warp_sum(acc[r]);
        if (lane == 0) logit[r * m + m0 + e] = s / static_cast<float>(b) / temp;
      }
    }
  }
  __syncthreads();

  if (warp < TQ && n0 + warp < n) {  // softmax over the row's M logits
    float* z = logit + warp * m;
    float mx = -3.0e38f;
    for (int j = lane; j < m; j += 32) mx = fmaxf(mx, z[j]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < m; j += 32) {
      const float e = expf(z[j] - mx);
      z[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    float* row = out + (n0 + warp) * m;
    for (int j = lane; j < m; j += 32) row[j] = z[j] / sum;
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* dict, float* dn, float* out, int n, int m,
                   int b, int d, int mc, float temp, cudaStream_t stream) {
  const long long rows = static_cast<long long>(m) * b;
  const int per_block = THREADS / 32;
  normalise_rows<T><<<static_cast<unsigned int>((rows + per_block - 1) / per_block),
                       THREADS, 0, stream>>>(static_cast<const T*>(dict), dn,
                                             static_cast<int>(rows), d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long f = static_cast<long long>(b) * d;
  const size_t smem = (TQ * f + static_cast<long long>(TQ) * m + mc * f) * sizeof(float);
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(match_prob_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  match_prob_kernel<T><<<(n + TQ - 1) / TQ, THREADS, smem, stream>>>(
      static_cast<const T*>(q), dn, out, n, m, b, d, mc, temp);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q and dict alike).  dn: f32 scratch of
// M·B·d floats.  mc: dictionary entries per shared-memory chunk, chosen by
// the wrapper so that 4·(TQ·(B·d + M) + mc·B·d) bytes fit.  Returns the
// cudaError_t of the launches (0 on success).
extern "C" int match_prob_launch(const void* q, const void* dict, void* dn, void* out,
                                 int n, int m, int b, int d, int mc, float temp,
                                 int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* dnf = static_cast<float*>(dn);
  float* o = static_cast<float*>(out);
  if (dtype == 0)
    return static_cast<int>(launch<float>(q, dict, dnf, o, n, m, b, d, mc, temp, s));
  if (dtype == 1)
    return static_cast<int>(
        launch<__nv_bfloat16>(q, dict, dnf, o, n, m, b, d, mc, temp, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
