// Flash attention, forward: online softmax over KV tiles, f32 inside.
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
// l = l·corr + Σp, acc = acc·corr + p·v, out = acc / max(l, 1e-30).
//
// Design: one block of 256 threads per (query tile of BQ = 64 rows, b·H +
// h), the longest causal tiles first.  The block stages the q tile and,
// one after another, each KV tile of BK = 64 keys in shared memory (q and
// k transposed, [hd][64 + 1], so the products read both without bank
// conflicts), computes the 64 x 64 scores as a 4 x 4 register tile per
// thread (rows ty + 16i, columns tx + 16j), takes each row's max and sum
// by shuffles among the 16 threads that hold it, writes p to shared
// memory, and adds p·v into a 4 x ceil(hd/16) register accumulator over
// the same rows.  With causal masking it stops at the last KV tile that
// meets the diagonal of the tile's last row: a tile wholly above it adds
// exactly 0 and leaves m unchanged (NEG_INF is finite and key 0 is
// visible to every row, so m is finite after the first tile).  Sq and Skv
// need not be multiples of 64: padded q rows are computed and not
// written, padded keys are masked.  hd <= 256 (shared memory: 4·(2·65·hd
// + 64·hd + 64·65) bytes, 113 KB at hd = 128).
//
// What bounds it on an H100: 4·hd flops per visible (q, k) pair (QK^T and
// PV), so at (B, S, H, hd) = (1, 2048, 24, 128), causal, 25.8 GFLOP:
// 0.385 ms on the 67 TFLOP/s f32 CUDA cores this version uses, against
// 0.026 ms on the bf16 tensor cores (989 TFLOP/s) a wgmma redesign would
// use; the 25 MB of q, k, v and out take 0.0075 ms of HBM.  Operations
// bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64, BK = 64, THREADS = 256;
constexpr float NEG_INF = -2.0e38f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

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
