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
// What bounds it on an H100: 2·N·M·B·d flops against (N + M)·B·d inputs
// and N·M f32 outputs.  At (N, M, B, d) = (512, 16, 4, 256) f32 that is 17
// MFLOP (0.00025 ms on the 67 TFLOP/s f32 CUDA cores) against 2.2 MB
// (0.00066 ms at 3.35 TB/s): bytes bound, and really by the latency of one
// launch and of each CTA's chain (stage, dot, softmax).  At (64, 1024, 4,
// 256) f32 it is 134 MFLOP (0.0021 ms) against 4.5 MB: operations bound on
// paper; in practice each CTA streams its 512 KB slice of the dictionary
// from L2 (once per query tile) at what one SM can draw, and that, with the
// dot's shared-memory reads, is what costs the time.
//
// Design: one launch, no scratch.  The grid is (query tiles of TQ = 4) x S,
// and the S CTAs of a tile form one thread-block cluster (dims (1, S, 1),
// S <= 8, chosen by the wrapper's `cluster_size` so that tiles x S about
// fills the card).  Rank k of a cluster owns entries [k·Ms, k·Ms + Ms) of
// the dictionary, Ms = ceil(M / S), and keeps their TQ x Ms logits in
// shared memory.
// * Staging.  The query tile comes by 16-byte `cp.async` as the caller's
//   dtype (raw, not normalised), and each (query, block) row's
//   rsqrt(sum of squares) is taken from that copy.  The dictionary streams
//   per thread: each thread copies, by `cp.async`, exactly the 16-byte
//   units it will multiply, DEPTH steps ahead, into its own ring in shared
//   memory, so its own `cp.async.wait_group` is all the ordering the loop
//   needs (no barrier in the loop).  bf16 stays bf16 in global and shared
//   memory and is widened in registers.  Rows whose length or address is
//   not a multiple of 16 bytes are copied element by element, with zeros
//   past d.
// * The dot, register-tiled.  Warp w owns entries w, w + 8, w + 16, w + 24
//   of each pass of PASS = 32 entries, lane l the units l, l + 32, ... of
//   each of their block rows, in order.  A step is 4 queries' and 4
//   entries' 16 bytes (8 shared loads) for 64 (f32) or 128 (bf16) FMAs.
//   The same loads give the entries' sums of squares; at the end of a
//   block row they meet over the 32 lanes (a fixed butterfly that scatters
//   the values over the lanes), and the row's partial dots are scaled by
//   rsqrt(ss_q + 1e-18) · rsqrt(ss_d + 1e-18): the block is normalised
//   without writing a normalised copy.  At the end of a pass the lanes'
//   sums meet the same way and the logits (/ B / temp) go to shared
//   memory.  The order of every pair's sum depends on B and d alone, not on
//   N, M or S.
// * Softmax across the cluster.  Each CTA takes its rows' max over its
//   slice and the sum of exp(z - max); the S (max, sum) pairs meet through
//   distributed shared memory (`map_shared_rank`) in rank order after one
//   `cluster.sync()`; each CTA writes its own slice of the normalised row,
//   then waits on the cluster barrier it arrived at once it had read the
//   others' pairs, so that no CTA leaves while another still reads its
//   shared memory.  At S = 1 no cluster barrier is used.
// No atomics, and every order is fixed by (B, d, S): repeated launches are
// bit-identical, and so are the rows of any N that gives the same S.
//
// The wrapper's `simd_fused/ops.py:smem_bytes` repeats this file's
// shared-memory formula (`geometry`); change both together.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int TQ = 4;                  // queries per CTA
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int E = 4;                   // entries per warp and pass
constexpr int PASS = WARPS * E;        // entries per pass over the k-range
constexpr int DEPTH = 2;               // steps of each thread's copies in flight
constexpr int RING = DEPTH + 1;        // its ring of steps in shared memory
constexpr int MAX_CLUSTER = 8;         // the portable cluster size
constexpr size_t MAX_SMEM = 232448;    // a Hopper block's shared memory
constexpr unsigned FULL = 0xffffffffu;

struct Geometry {
  int dp;       // d padded to 16 bytes: the row stride of the query tile
  int rowu;     // 16-byte units per block row
  int ms;       // entries per cluster rank, ceil(M / S)
  size_t smem;  // dynamic shared memory
};

// the threads' rings (RING steps of E units each), the query tile (TQ·B
// rows of dp elements), rq (TQ·B floats), the cluster's exchange slots
// (2·TQ floats) and the logits (TQ·Ms floats)
Geometry geometry(int m, int s, int b, int d, int elt) {
  Geometry g;
  const int w = 16 / elt;
  g.dp = (d + w - 1) / w * w;
  g.rowu = g.dp / w;
  g.ms = (m + s - 1) / s;
  g.smem = 16ull * THREADS * RING * E + static_cast<size_t>(TQ) * b * g.dp * elt +
           4ull * TQ * b + 8ull * TQ + 4ull * TQ * g.ms;
  return g;
}

template <typename T>
struct Args {
  const T* q;
  const T* dict;
  float* out;
  int n, m, b, d;
  int rowu, ms, vec;
  float temp;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared without a register
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, off));
  return v;
}

// NV values summed over the warp's 32 lanes, scattered: at each butterfly
// step a lane keeps half its values and adds its partner's half to them,
// so NV - 1 + (5 - log2 NV) shuffles in all.  Lane l returns the total of
// value l >> (5 - log2 NV); the lanes that hold one value hold the same
// bits, and the order of every sum is fixed by the lanes alone.
template <int NV, int OFF = 16>
__device__ __forceinline__ float scatter_sum(float (&v)[NV], int lane) {
  constexpr int C = NV * OFF / 16;  // values still held before this step
  if constexpr (C > 1) {
    const bool hi = lane & OFF;
#pragma unroll
    for (int i = 0; i < C / 2; ++i) {
      const float send = hi ? v[i] : v[i + C / 2];
      const float keep = hi ? v[i + C / 2] : v[i];
      v[i] = keep + __shfl_xor_sync(FULL, send, OFF);
    }
  } else {
    v[0] += __shfl_xor_sync(FULL, v[0], OFF);
  }
  if constexpr (OFF > 1) return scatter_sum<NV, OFF / 2>(v, lane);
  return v[0];
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

// element i of a 16-byte unit, widened to f32
template <typename T> __device__ __forceinline__ float elem(const uint4& u, int i);
template <> __device__ __forceinline__ float elem<float>(const uint4& u, int i) {
  return __uint_as_float((&u.x)[i]);
}
template <> __device__ __forceinline__ float elem<__nv_bfloat16>(const uint4& u, int i) {
  const uint32_t w = (&u.x)[i >> 1];
  return __uint_as_float((i & 1) ? (w & 0xffff0000u) : (w << 16));
}

// elements [k0, k0 + 16 / sizeof(T)) of a row of d into one 16-byte unit of
// shared memory, zeros past d: the path of rows that are not 16-byte units
template <typename T>
__device__ __forceinline__ void copy_unit(uint4* dst, const T* row, int k0, int d) {
  constexpr int W = 16 / sizeof(T);
  T* out = reinterpret_cast<T*>(dst);
#pragma unroll
  for (int k = 0; k < W; ++k) out[k] = k0 + k < d ? row[k0 + k] : zero<T>();
}

// where a thread's copies stand: pass p, block row blk, step t (unit
// lane + 32·t of the row), the warp's entries in the pass and the start of
// block row blk of the first of them
template <typename T>
struct Stream {
  int p = -1, blk = 0, t = 0, jn = 0;
  const T* row = nullptr;

  __device__ __forceinline__ void begin_pass(const Args<T>& a, long long m0, int mc,
                                             int warp) {
    ++p;
    blk = 0;
    t = 0;
    const int rows = mc - p * PASS;
    jn = min(E, max(0, (rows - warp + WARPS - 1) / WARPS));
    row = a.dict + (m0 + static_cast<long long>(p) * PASS + warp) * a.b * a.d;
  }

  __device__ __forceinline__ void advance(const Args<T>& a, int steps, long long m0, int mc,
                                          int warp) {
    if (++t < steps) return;
    t = 0;
    row += a.d;
    if (++blk == a.b) begin_pass(a, m0, mc, warp);
  }
};

// one step of a thread's copies into ring stage `stage`, as one commit
// group (empty past the stream's end).  Each thread reads back only what
// it copied itself, so its own cp.async.wait_group is all the ordering
// needed.
template <typename T>
__device__ __forceinline__ void stage_step(const Args<T>& a, uint4* mine, int stage,
                                           const Stream<T>& c, int lane) {
  constexpr int W = 16 / sizeof(T);
  const long long estride = static_cast<long long>(WARPS) * a.b * a.d;  // entry j to j + 1
  const int u = lane + 32 * c.t;
  if (u < a.rowu) {
    uint4* dst = mine + stage * E * 32;
    const T* row = c.row;
#pragma unroll
    for (int j = 0; j < E; ++j, row += estride, dst += 32) {
      if (j < c.jn) {
        if (a.vec) cp_async16(dst, row + u * W);
        else copy_unit<T>(dst, row, u * W, a.d);
      }
    }
  }
  cp_async_commit();
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2) match_prob_kernel(const Args<T> a) {
  constexpr int W = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int b = a.b, rowu = a.rowu;
  const int splits = gridDim.y;

  uint4* ring = reinterpret_cast<uint4*>(smem);          // [WARPS][RING][E][32]
  uint4* qs = ring + THREADS * RING * E;                  // [TQ][B][rowu]
  float* rq = reinterpret_cast<float*>(qs + TQ * b * rowu);  // [TQ][B]
  float* part_max = rq + TQ * b;                          // [TQ]
  float* part_sum = part_max + TQ;                        // [TQ]
  float* logit = part_sum + TQ;                           // [TQ][ms]
  uint4* mine = ring + warp * RING * E * 32 + lane;       // this thread's units

  const long long n0 = static_cast<long long>(blockIdx.x) * TQ;
  const int rows_q = static_cast<int>(min(static_cast<long long>(TQ), a.n - n0));
  const long long m0 = static_cast<long long>(blockIdx.y) * a.ms;
  const int mc = static_cast<int>(min(static_cast<long long>(a.ms), a.m - m0));
  const int passes = (mc + PASS - 1) / PASS;
  const int steps = (rowu + 31) / 32;  // per block row

  // the query tile, and the first DEPTH steps of every thread's stream
  const T* qsrc = a.q + n0 * b * a.d;
  for (int row = warp; row < rows_q * b; row += WARPS) {  // row = r·B + blk
    for (int u = lane; u < rowu; u += 32) {
      if (a.vec) cp_async16(qs + row * rowu + u, qsrc + row * a.d + u * W);
      else copy_unit<T>(qs + row * rowu + u, qsrc + row * a.d, u * W, a.d);
    }
  }
  cp_async_commit();
  Stream<T> issue;
  issue.begin_pass(a, m0, mc, warp);
#pragma unroll
  for (int i = 0; i < DEPTH; ++i) {
    stage_step(a, mine, i, issue, lane);
    issue.advance(a, steps, m0, mc, warp);
  }
  cp_async_wait<DEPTH>();  // the query tile is in
  __syncthreads();
  for (int row = warp; row < rows_q * b; row += WARPS) {
    const T* x = reinterpret_cast<const T*>(qs + row * rowu);
    float ss = 0.f;
    for (int k = lane; k < rowu * W; k += 32) {
      const float v = to_f32(x[k]);
      ss = fmaf(v, v, ss);
    }
    ss = warp_sum(ss);
    if (lane == 0) rq[row] = rsqrtf(ss + 1e-18f);
  }
  __syncthreads();

  // warp w owns entries w, w + 8, w + 16, w + 24 of each pass, and lane l
  // the units l, l + 32, l + 64, ... of each of their block rows
  float acc[TQ][E], part[TQ][E], ssd[E];
#pragma unroll
  for (int j = 0; j < E; ++j) {
    ssd[j] = 0.f;
#pragma unroll
    for (int r = 0; r < TQ; ++r) acc[r][j] = part[r][j] = 0.f;
  }
  int stage = 0;
  for (int p = 0; p < passes; ++p) {
    const int rows = min(PASS, mc - p * PASS);
    const int jn = min(E, (rows - warp + WARPS - 1) / WARPS);  // this warp's entries
    for (int blk = 0; blk < b; ++blk) {
      for (int t = 0; t < steps; ++t) {
        stage_step(a, mine, stage == 0 ? DEPTH : stage - 1, issue, lane);
        issue.advance(a, steps, m0, mc, warp);
        cp_async_wait<DEPTH>();  // this step's copies are in
        const int u = lane + 32 * t;
        if (u < rowu && jn > 0) {
          uint4 qv[TQ], dv[E];
#pragma unroll
          for (int r = 0; r < TQ; ++r) qv[r] = qs[(r * b + blk) * rowu + u];
#pragma unroll
          for (int j = 0; j < E; ++j)
            if (j < jn) dv[j] = mine[(stage * E + j) * 32];
#pragma unroll
          for (int x = 0; x < W; ++x) {
            float qx[TQ];
#pragma unroll
            for (int r = 0; r < TQ; ++r) qx[r] = elem<T>(qv[r], x);
#pragma unroll
            for (int j = 0; j < E; ++j) {
              if (j < jn) {
                const float dx = elem<T>(dv[j], x);
                ssd[j] = fmaf(dx, dx, ssd[j]);
#pragma unroll
                for (int r = 0; r < TQ; ++r) part[r][j] = fmaf(qx[r], dx, part[r][j]);
              }
            }
          }
        }
        stage = stage == DEPTH ? 0 : stage + 1;
      }
      // end of a block row: normalise its partial dots
      const float ss = scatter_sum(ssd, lane);  // entry lane >> 3's
      const float rd_own = rsqrtf(ss + 1e-18f);
#pragma unroll
      for (int j = 0; j < E; ++j) {
        const float rd = __shfl_sync(FULL, rd_own, j * (32 / E));
        ssd[j] = 0.f;
#pragma unroll
        for (int r = 0; r < TQ; ++r) {
          acc[r][j] = fmaf(part[r][j], rq[r * b + blk] * rd, acc[r][j]);
          part[r][j] = 0.f;
        }
      }
    }
    // end of a pass: the lanes' sums meet
    float flat[TQ * E];
#pragma unroll
    for (int r = 0; r < TQ; ++r)
#pragma unroll
      for (int j = 0; j < E; ++j) {
        flat[r * E + j] = acc[r][j];
        acc[r][j] = 0.f;
      }
    const float z = scatter_sum(flat, lane);  // value lane >> 1: (r, j)
    const int r = lane / (2 * E), j = lane / 2 % E;
    if (lane % 2 == 0 && r < rows_q && j < jn)
      logit[r * a.ms + p * PASS + warp + WARPS * j] = z / static_cast<float>(b) / a.temp;
  }
  __syncthreads();  // the logits are in

  // softmax over the row's M logits, spread over the cluster's S CTAs: each
  // takes its slice's max and sum of exps; the S pairs meet in rank order
  float* z = logit + warp * a.ms;
  float mx = 0.f;
  if (warp < rows_q) {
    mx = __int_as_float(0xff800000);  // -inf
    for (int j = lane; j < mc; j += 32) mx = fmaxf(mx, z[j]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < mc; j += 32) {
      const float e = expf(z[j] - mx);
      z[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      part_max[warp] = mx;
      part_sum[warp] = sum;
    }
  }
  if (splits == 1) {
    __syncthreads();
    if (warp < rows_q) {
      const float sum = part_sum[warp];
      float* row = a.out + (n0 + warp) * a.m;
      for (int j = lane; j < mc; j += 32) row[j] = z[j] / sum;
    }
    return;
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  float scale = 0.f, sum = 0.f;
  if (warp < rows_q) {
    float gmax = __int_as_float(0xff800000);
    for (int r = 0; r < splits; ++r)
      gmax = fmaxf(gmax, cluster.map_shared_rank(part_max, r)[warp]);
    for (int r = 0; r < splits; ++r)
      sum += cluster.map_shared_rank(part_sum, r)[warp] *
             expf(cluster.map_shared_rank(part_max, r)[warp] - gmax);
    scale = expf(mx - gmax);
  }
  // done with the other CTAs' shared memory; none leaves before all are
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  if (warp < rows_q) {
    float* row = a.out + (n0 + warp) * a.m + m0;
    for (int j = lane; j < mc; j += 32) row[j] = z[j] * scale / sum;
  }
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <typename T>
cudaError_t launch(const void* q, const void* dict, float* out, int n, int m, int b, int d,
                   int splits, float temp, cudaStream_t stream) {
  if (n < 1 || m < 1 || b < 1 || d < 1 || splits < 1 || splits > MAX_CLUSTER || splits > m)
    return cudaErrorInvalidValue;
  const Geometry g = geometry(m, splits, b, d, sizeof(T));
  // every rank owns at least one entry, and the CTA fits its shared memory
  if (static_cast<long long>(splits - 1) * g.ms >= m || g.smem > MAX_SMEM)
    return cudaErrorInvalidValue;
  constexpr int W = 16 / sizeof(T);
  const int vec = d % W == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(dict) % 16 == 0;
  const Args<T> a{static_cast<const T*>(q), static_cast<const T*>(dict), out, n, m, b, d,
                  g.rowu, g.ms, vec, temp};
  cudaError_t err = cudaFuncSetAttribute(match_prob_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(g.smem));
  // a failed runtime call is also this runtime's last error: consume it, or
  // the next launch's cudaGetLastError() would report it as its own
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned int>((n + TQ - 1) / TQ),
                     static_cast<unsigned int>(splits), 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = g.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = static_cast<unsigned int>(splits);
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, match_prob_kernel<T>, a);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q and dict alike).  splits: the
// cluster size S (1..8, at most M, every rank owning an entry), chosen by
// the wrapper's `cluster_size`.  Returns the cudaError_t of the launch (0
// on success); nothing falls back to another S.
extern "C" int match_prob_launch(const void* q, const void* dict, void* out, int n, int m,
                                 int b, int d, int splits, float temp, int dtype,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* o = static_cast<float*>(out);
  if (dtype == 0)
    return static_cast<int>(launch<float>(q, dict, o, n, m, b, d, splits, temp, s));
  if (dtype == 1)
    return static_cast<int>(
        launch<__nv_bfloat16>(q, dict, o, n, m, b, d, splits, temp, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
