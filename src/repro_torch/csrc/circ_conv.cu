// Blockwise circular convolution / correlation of N×B independent pairs.
//
//   conv: out[r, n] = sum_k x[r, k] * y[r, (n - k) mod d]
//   corr: out[r, n] = sum_k x[r, k] * y[r, (n + k) mod d]
//
// for every row r = (i, j) of x and y, (N, B, d) tensors read by stride:
// row (i, j) of x starts at x + i·x_sn + j·x_sb (elements), either stride
// may be 0 (a key broadcast over the batch), and only d is contiguous.  The
// output is a fresh contiguous (N, B, d) tensor in x's dtype (f32 or bf16);
// the sums are f32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/circ_conv/kernel.py
// `circ_elem` (`_elem_kernel`).  That kernel builds a d×d circulant in VMEM
// with log2(d) roll-selects so the MXU can do the work as a batched
// mat-vec; the circulant is a TPU device, not the semantics, and is not
// copied here.
//
// What bounds it on an H100: 2·d² flops per row on 12·d bytes (f32).  At
// the largest served shape, (64, 4, 256), that is 33.6 MFLOP: 0.5 µs of
// the f32 CUDA cores (67 TFLOP/s), against 0.8 MB (0.25 µs of HBM).  At the
// served bucket 8, (8, 4, 256) (39 of NVSA's 42 calls), it is 0.06 µs.
// Both sit under the launch floor of a few µs, so the design aims at a
// short critical path per block and at spreading few rows over many SMs.
//
// Design.
// * Register window.  A thread owns J = 8 consecutive outputs n0..n0+7 of
//   one row and walks a slice of k in chunks of 8.  For a chunk at k0 its
//   outputs need y at 15 consecutive positions (n0 - k0 - 8 .. n0 - k0 + 7
//   for conv, n0 + k0 .. n0 + k0 + 14 for corr); they live in two register
//   halves of 8, and the next chunk reuses one half and loads the other
//   (two 16-byte shared loads), so a chunk is 64 FMAs against four 16-byte
//   shared loads (the other two: x[k0..k0+7], the same address for the 8
//   threads of a group, a broadcast).  The two halves swap roles from chunk
//   to chunk (the loop is unrolled by two), so no register is moved.
// * No index wrap in the loop.  y is staged in shared memory twice over,
//   ye[p] = y[(p - off) mod d] for p in [0, 2·dp) (off = dp for conv, 0 for
//   corr), with d padded to dp (a multiple of 128, of 256 above 512) and x
//   zero-padded to dp; padded outputs are computed and not written.
// * Banks.  The 8 threads of a group own outputs 8 apart, so their 16-byte
//   window loads are 32 bytes apart and two of them would share a bank; ye is
//   stored with its 16-byte chunk c at c ^ ((c >> 3) & 1), which puts the 8
//   loads of a group (one shared-memory phase) in 8 distinct bank quads.
// * Splitting rows over the card.  The 64 outputs of a tile are 8 threads
//   (a group); the k-sum of a tile is split over S groups (S = dp / 32 up to
//   dp = 512, then 16, so 4 or more chunks each), and the S partial sums
//   meet in shared memory, added in slice order.  A unit (one tile of one
//   row, S groups) is the smallest block: (8, 4, 256) runs as 128 blocks of
//   64 threads, so 32 rows put work on 128 of the 132 SMs.  With more rows
//   a block takes 2, 4, ... units (the tiles of one row, or whole rows), as
//   long as the grid keeps two blocks per SM and 256 threads per block:
//   (64, 4, 256) runs as 512 blocks of two tiles.
// * Fixed order.  Each output is the slice sums in k order, added in slice
//   order; S depends on d alone, so the result does not depend on N, B, the
//   strides or the launch, and repeated launches are bit-identical.
// * Loads.  A row whose start is 16-byte aligned (base and both strides),
//   with d == dp, is staged by 16-byte loads; any other row (an odd
//   offset of a bf16 slice, an odd d) by element loads with the index taken
//   mod d, in the same kernel.
//
// ptxas (nvcc -Xptxas -v, sm_90a, CUDA 12.8): 48 registers in each of the
// four instantiations (f32 / bf16, conv / corr), no spills.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int J = 8;             // consecutive outputs per thread
constexpr int GROUP = 8;         // threads per output tile
constexpr int TILE = J * GROUP;  // outputs per tile
constexpr int MAX_BLOCK = 256;   // threads per block, at most
constexpr int MIN_BLOCKS = 264;  // two blocks per SM of an H100 (132 SMs)

struct Args {
  const void* x;
  const void* y;
  void* out;
  long long rows;
  int b, d;
  long long x_sn, x_sb, y_sn, y_sb;
  int dp;          // d padded
  int ks;          // k per slice (a multiple of 2·J)
  int splits;      // S = dp / ks
  int tiles;       // dp / TILE
  int rb, tb;      // rows and tiles per block (rb == 1 or tb == tiles)
  int vec_x, vec_y;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// 16-byte chunk c of the y buffer sits at chunk swz(c)
__device__ __forceinline__ int swz(int c) { return c ^ ((c >> 3) & 1); }

__device__ __forceinline__ void put4(float* buf, int chunk, float4 v) {
  reinterpret_cast<float4*>(buf)[swz(chunk)] = v;
}

// 8 consecutive floats of the y buffer from position p (a multiple of 8)
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

// one chunk of 8 k: the window is [lo, hi], 16 consecutive y values;
// conv reads window[J + j - t], corr window[j + t], for k = k0 + t
template <bool CORR>
__device__ __forceinline__ void chunk(float (&acc)[J], const float (&xv)[J],
                                      const float (&lo)[J], const float (&hi)[J]) {
#pragma unroll
  for (int t = 0; t < J; ++t) {
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int i = CORR ? j + t : J + j - t;
      acc[j] = fmaf(xv[t], i < J ? lo[i] : hi[i - J], acc[j]);
    }
  }
}

// 16 bytes of a row as floats: 4 f32 or 8 bf16
__device__ __forceinline__ int load16(const float* src, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(src);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  return 4;
}
__device__ __forceinline__ int load16(const __nv_bfloat16* src, float (&v)[8]) {
  const uint4 a = *reinterpret_cast<const uint4*>(src);
  const uint32_t words[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    __nv_bfloat162 pair;
    *reinterpret_cast<uint32_t*>(&pair) = words[i];
    const float2 f = __bfloat1622float2(pair);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
  return 8;
}

template <typename T>
__device__ __forceinline__ void stage_row(const Args& a, const T* x, const T* y, float* xs,
                                          float* ye, bool corr) {
  const int d = a.d, dp = a.dp;
  constexpr int EPV = 16 / sizeof(T);  // elements per 16-byte load
  if (a.vec_x) {  // d == dp, so no padding
    for (int c = threadIdx.x; c < d / EPV; c += blockDim.x) {
      float v[8];
      load16(x + c * EPV, v);
#pragma unroll
      for (int i = 0; i < EPV; i += 4)
        *reinterpret_cast<float4*>(xs + c * EPV + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
    }
  } else {  // unrolled, so that several loads are in flight before their stores
#pragma unroll 4
    for (int k = threadIdx.x; k < dp; k += blockDim.x) xs[k] = k < d ? to_f32(x[k]) : 0.f;
  }
  if (a.vec_y) {  // d == dp: ye[p] = y[p mod d] for either mode
    for (int c = threadIdx.x; c < d / EPV; c += blockDim.x) {
      float v[8];
      load16(y + c * EPV, v);
#pragma unroll
      for (int i = 0; i < EPV; i += 4) {
        const float4 f = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
        const int q = (c * EPV + i) >> 2;
        put4(ye, q, f);
        put4(ye, q + (d >> 2), f);
      }
    }
  } else {
    const int off = corr ? 0 : dp;
#pragma unroll 4
    for (int p = threadIdx.x; p < 2 * dp; p += blockDim.x) {
      int i = (p - off) % d;
      if (i < 0) i += d;
      ye[(swz(p >> 2) << 2) | (p & 3)] = to_f32(y[i]);
    }
  }
}

template <typename T, bool CORR>
__global__ void __launch_bounds__(MAX_BLOCK) circ_elem_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  const int dp = a.dp;
  float* xs_all = smem;                            // rb × dp
  float* ye_all = xs_all + a.rb * dp;              // rb × 2·dp
  float* part = ye_all + 2 * a.rb * dp;            // units × S × TILE
  const int tile_blocks = a.tiles / a.tb;
  const long long row0 = static_cast<long long>(blockIdx.x / tile_blocks) * a.rb;
  const int tile0 = (blockIdx.x % tile_blocks) * a.tb;

  for (int r = 0; r < a.rb; ++r) {
    const long long row = row0 + r;
    if (row >= a.rows) break;
    const long long i = row / a.b, j = row % a.b;
    const T* x = static_cast<const T*>(a.x) + i * a.x_sn + j * a.x_sb;
    const T* y = static_cast<const T*>(a.y) + i * a.y_sn + j * a.y_sb;
    stage_row<T>(a, x, y, xs_all + r * dp, ye_all + 2 * r * dp, CORR);
  }
  __syncthreads();

  // group -> (unit, slice); unit -> (row in block, tile)
  const int g = threadIdx.x / GROUP, lane = threadIdx.x % GROUP;
  const int unit = g / a.splits, s = g % a.splits;
  const int r = unit / a.tb, tile = tile0 + unit % a.tb;
  const float* xr = xs_all + r * dp;
  const float* ye = ye_all + 2 * r * dp;
  const int n0 = tile * TILE + lane * J;
  const int k0 = s * a.ks;
  float acc[J];
#pragma unroll
  for (int t = 0; t < J; ++t) acc[t] = 0.f;
  float wa[J], wb[J], xv[J];
  if (CORR) {
    int p = n0 + k0;  // window [wa, wb] = y[p .. p + 16)
    window8(ye, p, wa);
    window8(ye, p + J, wb);
    for (int c = 0; c < a.ks; c += 2 * J) {
      x8(xr, k0 + c, xv);
      chunk<true>(acc, xv, wa, wb);
      window8(ye, p + 2 * J, wa);  // window [wb, wa]
      x8(xr, k0 + c + J, xv);
      chunk<true>(acc, xv, wb, wa);
      if (c + 2 * J < a.ks) window8(ye, p + 3 * J, wb);  // window [wa, wb]
      p += 2 * J;
    }
  } else {
    int p = n0 - k0 - J + dp;  // window [wa, wb] = ye[p .. p + 16)
    window8(ye, p, wa);
    window8(ye, p + J, wb);
    for (int c = 0; c < a.ks; c += 2 * J) {
      x8(xr, k0 + c, xv);
      chunk<false>(acc, xv, wa, wb);
      window8(ye, p - J, wb);  // window [wb, wa]
      x8(xr, k0 + c + J, xv);
      chunk<false>(acc, xv, wb, wa);
      if (c + 2 * J < a.ks) window8(ye, p - 2 * J, wa);  // window [wa, wb]
      p -= 2 * J;
    }
  }
  float* mine = part + (unit * a.splits + s) * TILE + lane * J;
  *reinterpret_cast<float4*>(mine) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  *reinterpret_cast<float4*>(mine + 4) = make_float4(acc[4], acc[5], acc[6], acc[7]);
  __syncthreads();

  // the S partial sums of 4 outputs, in slice order, per thread
  const int units = a.rb * a.tb;
  T* out = static_cast<T*>(a.out);
  for (int e = threadIdx.x; e < units * (TILE / 4); e += blockDim.x) {
    const int u = e / (TILE / 4), q = e % (TILE / 4);
    const long long row = row0 + u / a.tb;
    if (row >= a.rows) continue;
    const float* src = part + u * a.splits * TILE + q * 4;
    float4 sum = *reinterpret_cast<const float4*>(src);
    for (int t = 1; t < a.splits; ++t) {
      const float4 v = *reinterpret_cast<const float4*>(src + t * TILE);
      sum.x += v.x; sum.y += v.y; sum.z += v.z; sum.w += v.w;
    }
    const int n = (tile0 + u % a.tb) * TILE + q * 4;
    T* o = out + row * a.d + n;
    const float vals[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
    for (int t = 0; t < 4; ++t)
      if (n + t < a.d) o[t] = from_f32<T>(vals[t]);
  }
}

bool aligned16(const void* p, long long sn, long long sb, int elt) {
  return (reinterpret_cast<uintptr_t>(p) % 16 == 0) && (sn * elt) % 16 == 0 &&
         (sb * elt) % 16 == 0;
}

template <typename T>
cudaError_t launch(Args a, int corr, cudaStream_t stream) {
  const int d = a.d;
  a.dp = d <= 512 ? (d + 127) / 128 * 128 : (d + 255) / 256 * 256;
  a.ks = a.dp <= 512 ? 32 : a.dp / 16;
  a.splits = a.dp / a.ks;
  a.tiles = a.dp / TILE;
  const int unit_threads = a.splits * GROUP;
  const long long units = a.rows * a.tiles;
  int per_block = 1;
  for (;;) {
    const int twice = 2 * per_block;
    if (twice * unit_threads > MAX_BLOCK) break;
    if (a.tiles % twice != 0 && twice % a.tiles != 0) break;
    if ((units + twice - 1) / twice < MIN_BLOCKS) break;
    per_block = twice;
  }
  a.tb = per_block <= a.tiles ? per_block : a.tiles;
  a.rb = per_block / a.tb;
  const int elt = static_cast<int>(sizeof(T));
  a.vec_x = d == a.dp && aligned16(a.x, a.x_sn, a.x_sb, elt);
  a.vec_y = d == a.dp && aligned16(a.y, a.y_sn, a.y_sb, elt);
  const long long blocks = (a.rows + a.rb - 1) / a.rb * (a.tiles / a.tb);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  const size_t smem = sizeof(float) * (static_cast<size_t>(a.rb) * 3 * a.dp +
                                       static_cast<size_t>(per_block) * a.splits * TILE);
  auto kernel = corr ? circ_elem_kernel<T, true> : circ_elem_kernel<T, false>;
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
  kernel<<<static_cast<unsigned int>(blocks), per_block * unit_threads, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// x, y: (n, b, d) by strides (elements; the last dimension contiguous),
// out: contiguous (n, b, d).  dtype: 0 = float32, 1 = bfloat16.  corr: 0 =
// conv, 1 = corr.  Returns the cudaError_t of the launch (0 on success).
extern "C" int circ_elem_launch(const void* x, const void* y, void* out, long long n, int b,
                                int d, long long x_sn, long long x_sb, long long y_sn,
                                long long y_sb, int dtype, int corr, void* stream) {
  if (n <= 0 || b <= 0 || d <= 0) return 0;  // nothing to compute
  Args a{};
  a.x = x;
  a.y = y;
  a.out = out;
  a.rows = n * b;
  a.b = b;
  a.d = d;
  a.x_sn = x_sn;
  a.x_sb = x_sb;
  a.y_sn = y_sn;
  a.y_sb = y_sb;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(launch<float>(a, corr, s));
  if (dtype == 1) return static_cast<int>(launch<__nv_bfloat16>(a, corr, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
