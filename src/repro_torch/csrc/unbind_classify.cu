// Fused VSA unbind -> dense classify head (MIMONet's symbolic tail).
//
//   out[n, k, c] = b[c] + sum_blk sum_j unbound[n, k, blk, j] * w[blk, j, c]
//   unbound[n, k, blk, j] = sum_i keys[k, blk, i] * x[n, blk, (j + i) mod d]
//
// i.e. corr(keys[k], x[n]) (the argument order of vsa.unbind(keys, x))
// followed by the dense head, for contiguous f32 keys (K, B, d), x (N, B, d),
// w (B, d, C) and b (1, C); out (N, K, C) f32.  The unbound codes never
// leave the block: they are formed in shared memory and multiplied straight
// into the head.
//
// Replaces the Pallas TPU kernel src/repro/kernels/unbind_classify/kernel.py
// `fused_unbind_classify` (`_unbind_classify_kernel`).  That kernel builds
// each key block's d×d correlation circulant in VMEM for the MXU and
// accumulates the logits across a grid axis over the B blocks; neither
// carries over.
//
// What bounds it on an H100: 2·N·K·B·(d² + d·C) flops.  At the serving
// path's shape (N = 8, K = 2, B = 4, d = 128, C = 5) that is about 2.18
// MFLOP, 0.033 µs on the 67 TFLOP/s f32 CUDA cores, on about 31 KB of
// inputs and outputs (0.009 µs of HBM): operations bound on paper, and
// far under the few µs a launch takes.  What sets the time is the longest
// chain of dependent steps in a block, so the design cuts that chain.
//
// Design.  One block per output row (n, k); its rows are the B blocks
// (k, blk), taken in batches of RB rows that fit shared memory (all B at
// the served shape: one batch).
// * Unbind with a split d-sum, circ_conv.cu's scheme (corr).  A row's
//   unbound outputs are tiles of 64; 8 threads (a group) own a tile, each
//   thread J = 8 consecutive outputs, and walk one slice of the i-sum
//   (S slices of ks = dp / S; S from d alone: 4 at d = 128, 8 at 256) with
//   a register window of x staged twice over (no index wrap; 16-byte
//   chunks XOR-swizzled against bank conflicts), 64 FMAs per four 16-byte
//   shared loads.  All RB × tiles × S (row, tile, slice) units of a batch
//   run at once: at (8, 2, 4, 128, 5) 64 groups, 512 threads, each with a
//   chain of 32 FMAs, where the first kernel ran 128 threads through d =
//   128 FMAs four blocks in a row.
// * All inputs of a batch (and w, when it fits) come by `cp.async`, every
//   copy of a thread in flight before one wait.
// * The slices meet in shared memory, added in slice order; each thread
//   then multiplies the unbound values it owns into w's rows (staged in
//   shared memory with the inputs when they fit, read from global
//   otherwise) and keeps C partial sums (C <= MAX_C = 32).
// * A fixed-order reduction ends each batch: a butterfly of warp shuffles,
//   then the warps' partials summed in warp order by the first C threads,
//   which add the batch's sum to their running total and finally write
//   b[c] + total.  No atomics, and every order depends on d, B and C alone,
//   so repeated launches are bit-identical.
//
// ptxas (nvcc -Xptxas -v, sm_90a, CUDA 12.8): 57 registers, no spills.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int MAX_C = 32;
constexpr int J = 8;             // consecutive unbound outputs per thread
constexpr int GROUP = 8;         // threads per output tile
constexpr int TILE = J * GROUP;  // outputs per tile; d pads to a multiple
constexpr int MAX_THREADS = 512;
constexpr int MAX_WARPS = MAX_THREADS / 32;
// bytes of shared memory one block may use on Hopper, less the static
// reduction array
constexpr size_t MAX_DYN_SMEM = 232448 - MAX_WARPS * MAX_C * 4;

struct Args {
  const float* keys;
  const float* x;
  const float* w;
  const float* b;
  float* out;
  int n_keys, blocks, d, n_cls;
  int dp, splits, ks, rb, stage_w, vec;
};

// d padded and the slice count S: the largest power of two up to 16 (4
// above dp = 1024) whose slices are a multiple of 16 and at least 32 long
int padded(int d) { return (d + TILE - 1) / TILE * TILE; }
int splits_for(int dp) {
  const int smax = dp > 1024 ? 4 : 16;
  int s = 1;
  while (2 * s <= smax && dp % (2 * s * 16) == 0 && dp / (2 * s) >= 32) s *= 2;
  return s;
}
// bytes per staged row: x twice over, the key, the S partial sums
size_t row_bytes(int dp, int s) { return 4ull * (3 + s) * dp; }

__device__ __forceinline__ int swz(int c) { return c ^ ((c >> 3) & 1); }

__device__ __forceinline__ void window8(const float* buf, int p, float (&w)[J]) {
  const float4 a = reinterpret_cast<const float4*>(buf)[swz(p >> 2)];
  const float4 b = reinterpret_cast<const float4*>(buf)[swz((p >> 2) + 1)];
  w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
  w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
}

__device__ __forceinline__ void x8(const float* xr, int k, float (&v)[J]) {
  const float4 a = *reinterpret_cast<const float4*>(xr + k);
  const float4 b = *reinterpret_cast<const float4*>(xr + k + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// one chunk of 8 i: outputs j read the window at j + t for i = i0 + t
__device__ __forceinline__ void chunk(float (&acc)[J], const float (&kv)[J],
                                      const float (&lo)[J], const float (&hi)[J]) {
#pragma unroll
  for (int t = 0; t < J; ++t) {
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int i = j + t;
      acc[j] = fmaf(kv[t], i < J ? lo[i] : hi[i - J], acc[j]);
    }
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared without a register: every copy of a thread is
// in flight at once, and the loads of a row do not wait for the last row's
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// rows b0 .. b0 + nb - 1 of key k and query n: keys[k, blk] zero-padded to
// dp into kr_all (dp each), x[n, blk] into xe_all as xe[p] = x[p mod d],
// p in [0, 2·dp), in swizzled 16-byte chunks (2·dp each).  The caller
// waits for the copies and syncs.
__device__ __forceinline__ void stage_rows(const Args& a, int n, int k, int b0, int nb,
                                           float* kr_all, float* xe_all) {
  const int d = a.d, dp = a.dp;
  const float* keys = a.keys + (k * static_cast<long long>(a.blocks) + b0) * d;
  const float* x = a.x + (n * static_cast<long long>(a.blocks) + b0) * d;
  if (a.vec) {  // d == dp, rows 16-byte aligned
    const int dq = d / 4;
    for (int idx = threadIdx.x; idx < nb * dq; idx += blockDim.x) {
      const int r = idx / dq, c = idx - r * dq;
      const float* src = x + static_cast<long long>(r) * d + 4 * c;
      float* xe = xe_all + 2 * r * dp;
      cp_async16(kr_all + r * dp + 4 * c, keys + static_cast<long long>(r) * d + 4 * c);
      cp_async16(xe + 4 * swz(c), src);
      cp_async16(xe + 4 * swz(c + dq), src);
    }
  } else {
#pragma unroll 4
    for (int idx = threadIdx.x; idx < nb * dp; idx += blockDim.x) {
      const int r = idx / dp, i = idx - r * dp;
      kr_all[idx] = i < d ? keys[static_cast<long long>(r) * d + i] : 0.f;
    }
#pragma unroll 4
    for (int idx = threadIdx.x; idx < 2 * nb * dp; idx += blockDim.x) {
      const int r = idx / (2 * dp), p = idx - r * 2 * dp;
      xe_all[2 * r * dp + ((swz(p >> 2) << 2) | (p & 3))] =
          x[static_cast<long long>(r) * d + p % d];
    }
  }
}

__global__ void __launch_bounds__(MAX_THREADS) unbind_classify_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float red[MAX_WARPS][MAX_C];
  const int d = a.d, dp = a.dp, S = a.splits, ks = a.ks, rb = a.rb, C = a.n_cls;
  const int tiles = dp / TILE;
  float* xe_all = smem;                      // rb × 2·dp
  float* kr_all = xe_all + 2 * rb * dp;      // rb × dp
  float* part = kr_all + rb * dp;            // rb × tiles × S × TILE
  float* ws = part + rb * S * dp;            // B × d × C, when staged
  const int row = blockIdx.x;                // n * K + k
  const int n = row / a.n_keys, k = row - n * a.n_keys;

  const float* w = a.w;
  if (a.stage_w) {  // waited for with the first batch's rows
    const int count = a.blocks * d * C;
    if (count % 4 == 0 && reinterpret_cast<uintptr_t>(a.w) % 16 == 0) {
      for (int i = threadIdx.x; i < count / 4; i += blockDim.x)
        cp_async16(ws + 4 * i, a.w + 4 * i);
    } else {
      for (int i = threadIdx.x; i < count; i += blockDim.x) ws[i] = a.w[i];
    }
    w = ws;
  }

  const int group = threadIdx.x / GROUP, lane = threadIdx.x % GROUP;
  const int groups = blockDim.x / GROUP;
  const int warp = threadIdx.x >> 5, wl = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  float total = 0.f;  // thread c < C: the logit's sum over the batches so far

  for (int b0 = 0; b0 < a.blocks; b0 += rb) {
    const int nb = a.blocks - b0 < rb ? a.blocks - b0 : rb;
    stage_rows(a, n, k, b0, nb, kr_all, xe_all);
    cp_async_wait_all();
    __syncthreads();

    // the unbound codes: (row, tile, slice) units, one group each
    const int units = nb * tiles * S;
    for (int u = group; u < units; u += groups) {
      const int r = u / (tiles * S), tile = (u / S) % tiles, s = u % S;
      const float* kr = kr_all + r * dp;
      const float* xe = xe_all + 2 * r * dp;
      const int k0 = s * ks;
      float acc[J];
#pragma unroll
      for (int t = 0; t < J; ++t) acc[t] = 0.f;
      float wa[J], wb[J], kv[J];
      int p = tile * TILE + lane * J + k0;  // window [wa, wb] = x[p .. p + 16)
      window8(xe, p, wa);
      window8(xe, p + J, wb);
      for (int c = 0; c < ks; c += 2 * J) {
        x8(kr, k0 + c, kv);
        chunk(acc, kv, wa, wb);
        window8(xe, p + 2 * J, wa);  // window [wb, wa]
        x8(kr, k0 + c + J, kv);
        chunk(acc, kv, wb, wa);
        if (c + 2 * J < ks) window8(xe, p + 3 * J, wb);  // window [wa, wb]
        p += 2 * J;
      }
      float* mine = part + u * TILE + lane * J;
      *reinterpret_cast<float4*>(mine) = make_float4(acc[0], acc[1], acc[2], acc[3]);
      *reinterpret_cast<float4*>(mine + 4) = make_float4(acc[4], acc[5], acc[6], acc[7]);
    }
    __syncthreads();

    // the head: each unbound value (its slices added in slice order) into
    // C partial sums
    float hacc[MAX_C];
#pragma unroll
    for (int c = 0; c < MAX_C; ++c) hacc[c] = 0.f;
    for (int e = threadIdx.x; e < nb * d; e += blockDim.x) {
      const int r = e / d, j = e - r * d;
      const float* src = part + ((r * tiles + j / TILE) * S) * TILE + j % TILE;
      float u = src[0];
      for (int s = 1; s < S; ++s) u += src[s * TILE];
      const float* wrow = w + (static_cast<long long>(b0 + r) * d + j) * C;
#pragma unroll
      for (int c = 0; c < MAX_C; ++c)
        if (c < C) hacc[c] = fmaf(u, wrow[c], hacc[c]);
    }
#pragma unroll
    for (int c = 0; c < MAX_C; ++c) {
      if (c < C) {
        float v = hacc[c];
        for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
        if (wl == 0) red[warp][c] = v;
      }
    }
    __syncthreads();
    if (threadIdx.x < C) {
      float s = 0.f;
      for (int i = 0; i < warps; ++i) s += red[i][threadIdx.x];
      total += s;
    }
    if (b0 + rb < a.blocks) __syncthreads();  // the next batch overwrites them
  }
  if (threadIdx.x < C)
    a.out[static_cast<long long>(row) * C + threadIdx.x] = a.b[threadIdx.x] + total;
}

}  // namespace

// Returns the cudaError_t of the launch (0 on success); cudaErrorInvalidValue
// when n_cls is outside 1..MAX_C or one row of d does not fit shared memory
// (`kernels/unbind_classify/ops.py:smem_bytes` is the same formula).
extern "C" int unbind_classify_launch(const void* keys, const void* x, const void* w,
                                      const void* b, void* out, long long n, int n_keys,
                                      int blocks, int d, int n_cls, void* stream) {
  if (n_cls < 1 || n_cls > MAX_C) return static_cast<int>(cudaErrorInvalidValue);
  if (n <= 0 || n_keys <= 0) return 0;  // nothing to compute
  Args a{};
  a.keys = static_cast<const float*>(keys);
  a.x = static_cast<const float*>(x);
  a.w = static_cast<const float*>(w);
  a.b = static_cast<const float*>(b);
  a.out = static_cast<float*>(out);
  a.n_keys = n_keys;
  a.blocks = blocks;
  a.d = d;
  a.n_cls = n_cls;
  a.dp = padded(d);
  a.splits = splits_for(a.dp);
  a.ks = a.dp / a.splits;
  const size_t rowb = row_bytes(a.dp, a.splits);
  if (rowb > MAX_DYN_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  const size_t fit = MAX_DYN_SMEM / rowb;
  a.rb = blocks < static_cast<long long>(fit) ? blocks : static_cast<int>(fit);
  const size_t w_bytes = 4ull * blocks * d * n_cls;
  a.stage_w = a.rb * rowb + w_bytes <= MAX_DYN_SMEM;
  a.vec = d == a.dp && reinterpret_cast<uintptr_t>(keys) % 16 == 0 &&
          reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const size_t smem = a.rb * rowb + (a.stage_w ? w_bytes : 0);
  const int units = a.rb * (a.dp / TILE) * a.splits;
  int threads = units * GROUP < MAX_THREADS ? units * GROUP : MAX_THREADS;
  threads = (threads + 31) / 32 * 32;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(unbind_classify_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) {
      // a failed runtime call is also this runtime's last error: consume it, or
      // the next launch's cudaGetLastError() would report it as its own
      cudaGetLastError();
      return static_cast<int>(err);
    }
  }
  const long long rows = n * n_keys;
  unbind_classify_kernel<<<static_cast<unsigned int>(rows), threads, smem,
                           static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
