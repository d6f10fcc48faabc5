// Segment sum for Hopper (sm_90a): the CUDA C++ port of the Pallas kernel in
// repro/kernels/segsum/segsum.py (_segsum_kernel / sorted_segment_sum_pallas).
//
//   sorted_segment_sum   out[s, :] = sum of data[i, :] over the rows i with
//                        seg[i] == s; ids outside [0, n_segments) add
//                        nothing; f32 or bf16 data, f32 sums, the output in
//                        the data's type
//
// Plain C interface (bound with ctypes): launches on the stream it is
// given, allocates nothing, never synchronises, and returns
// cudaGetLastError() so the caller sees a refused launch or a tile plan
// that does not cover the data (cudaErrorInvalidValue).
//
// What bounds it on an H100: bytes.  It reads every row once and writes
// each segment once (EquiformerV2's aggregation, 111,360 rows of 6,272 f32
// values into 3,840 segments: 2.89 GB, 0.863 ms at 3.35 TB/s; ogb_products,
// 61.9 M rows of 100 into 2.4 M: 25.9 GB, 7.7 ms) and does one add per
// element read.  The TPU kernel multiplies a one-hot [block, S] matrix into
// the output on the matrix unit, since a TPU has no fast scatter; that
// costs S times the adds and holds [S, D] in VMEM.  Here the reduction is
// segmented instead, and the card is kept busy by the grid's shape:
//
// - The tile plan (ops.py's tile_plan, computed on the host from n, d, the
//   dtype and the data's address) cuts the [n, d] rows into a grid of row
//   tiles x column tiles.  A CTA is 256 threads in lane groups of `lanes`
//   lanes (a power of two up to 32); a group takes `group_rows`
//   consecutive rows of one column tile, which is lanes x V columns wide
//   (V = 16 B / element: 4 f32 or 8 bf16 a lane).  A row narrower than a
//   warp's reach takes a group of fewer lanes, so 32 / lanes rows share a
//   warp; a wider row is cut into column tiles, each a CTA of its own, so
//   a 6,272-wide f32 row is 49 CTAs side by side and not 49 passes of one
//   warp.  `group_rows` is the largest that still gives about four waves
//   of CTAs on 132 SMs, never fewer than make a CTA read 64 KB.
// - 16-byte loads when a row is a whole number of 16-byte vectors and the
//   data is 16-byte aligned (a lane's V columns are adjacent); otherwise V
//   scalar loads a row, each coalesced across the group (a lane's columns
//   `lanes` apart), the ragged tail masked.
// - Bytes in flight: a lane issues the loads of 4 rows before it adds any
//   (1 with scalar bf16 loads), 64 B a lane on the 16-byte path: 16 KB a
//   CTA, 64 KB an SM at the four CTAs an SM that 64 registers a thread
//   allow (__launch_bounds__).  A DRAM read takes about 1 us, so 3.35 TB/s
//   needs about 25 KB in flight an SM.
// - Flushes: a group sums each run of equal ids in f32 registers and adds
//   the run's column sums into the f32 accumulator when the id changes and
//   at its last row, on the 16-byte path as one 16-byte atomicAdd of a
//   float4 for every 4 columns (sm_90's vector `red`), else one f32
//   atomicAdd a column.  Sorted ids cost about (segments + row tiles) x d
//   adds; the adds are atomic, so a run cut by a tile's edge, and ids in
//   any order, still sum right.  Unsorted ids (EquiformerV2's nearest
//   pairs) flush about once a row: there the vector adds, a quarter of the
//   atomics, halve the time.
//
// bf16 data is summed in f32 and rounded once at the end (a second small
// kernel); the order of the atomic adds varies from run to run, so f32 sums
// agree with a sequential sum to rounding, not bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;       // 8 warps a CTA

// The rows a lane loads before it adds: 4 x 16 B on the 16-byte path; 4 x
// 4 f32 or 1 x 8 bf16 values on the scalar one (each scalar load holds an
// address register, and 64 registers a thread allow four CTAs an SM).
template <typename T, bool kVec>
struct Shape {
  static constexpr int V = 16 / sizeof(T);     // columns a lane holds
  static constexpr int U = kVec || sizeof(T) == 4 ? 4 : 1;
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// a's V sums += one row's 16 bytes, as f32 or as bf16
__device__ __forceinline__ void add16(float (&a)[4], uint4 w) {
  a[0] += __uint_as_float(w.x);
  a[1] += __uint_as_float(w.y);
  a[2] += __uint_as_float(w.z);
  a[3] += __uint_as_float(w.w);
}
__device__ __forceinline__ void add16(float (&a)[8], uint4 w) {
  const unsigned v[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {               // element 2k in the low half
    a[2 * k] += __uint_as_float(v[k] << 16);
    a[2 * k + 1] += __uint_as_float(v[k] & 0xffff0000u);
  }
}

// Adds a run's column sums into row `s` of the accumulator: on the 16-byte
// path the lane's V adjacent columns from `col`, else columns `col + k *
// step`, the ragged tail masked.
template <int V, bool kVec>
__device__ __forceinline__ void flush(float* __restrict__ acc, int s,
                                      int n_segments, int d, int col,
                                      int step, const float (&a)[V]) {
  if ((unsigned)s >= (unsigned)n_segments) return;  // dropped, out of range
  float* row = acc + (size_t)s * d;
  if constexpr (kVec) {
    if (col < d) {
#pragma unroll
      for (int k = 0; k < V; k += 4)
        atomicAdd(reinterpret_cast<float4*>(row + col + k),
                  make_float4(a[k], a[k + 1], a[k + 2], a[k + 3]));
    }
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int c = col + k * step;
      if (c < d) atomicAdd(row + c, a[k]);
    }
  }
}

template <typename T, bool kVec>
// repro: grid[concurrent]
__global__ void __launch_bounds__(kThreads, 4)
segsum_kernel(const T* __restrict__ data, const int* __restrict__ seg,
              long long n, int d, int n_segments, int lanes_log2,
              int group_rows, float* __restrict__ acc) {
  constexpr int V = Shape<T, kVec>::V;
  constexpr int U = Shape<T, kVec>::U;
  const int sub = threadIdx.x & ((1 << lanes_log2) - 1);   // lane in group
  const long long group = (long long)blockIdx.x * (kThreads >> lanes_log2)
                          + (threadIdx.x >> lanes_log2);
  const long long r0 = group * group_rows;
  if (r0 >= n) return;            // no shuffles or barriers below
  const long long r1 = min(n, r0 + group_rows);
  const int step = 1 << lanes_log2;
  const int c0 = blockIdx.y * (V << lanes_log2);
  const int col = kVec ? c0 + sub * V : c0 + sub;
  float a[V];
#pragma unroll
  for (int k = 0; k < V; ++k) a[k] = 0.f;
  int cur = __ldg(seg + r0);
  for (long long r = r0; r < r1; r += U) {
    // every load of U rows first (a row past r1 reads nothing, adds 0 to
    // the current run), then the adds
    int ids[U];
    uint4 w[kVec ? U : 1];
    float x[kVec ? 1 : U][V];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const bool ok = r + u < r1;
      ids[u] = ok ? __ldg(seg + r + u) : cur;
      const T* row = data + (size_t)(r + u) * d;
      if constexpr (kVec) {
        w[u] = ok && col < d ? __ldg(reinterpret_cast<const uint4*>(row + col))
                             : make_uint4(0u, 0u, 0u, 0u);
      } else {
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const int c = col + k * step;
          x[u][k] = ok && c < d ? to_float(row[c]) : 0.f;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (ids[u] != cur) {                               // a new run
        flush<V, kVec>(acc, cur, n_segments, d, col, step, a);
#pragma unroll
        for (int k = 0; k < V; ++k) a[k] = 0.f;
        cur = ids[u];
      }
      if constexpr (kVec) {
        add16(a, w[u]);
      } else {
#pragma unroll
        for (int k = 0; k < V; ++k) a[k] += x[u][k];
      }
    }
  }
  flush<V, kVec>(acc, cur, n_segments, d, col, step, a);
}

// repro: grid[concurrent]
__global__ void to_bf16_kernel(const float* __restrict__ in,
                               __nv_bfloat16* __restrict__ out, long long n) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    out[i] = __float2bfloat16_rn(in[i]);
}

template <typename T, bool kVec>
cudaError_t launch_sum(const void* data, const int* seg, long long n, int d,
                       int n_segments, int lanes_log2, int group_rows,
                       long long row_tiles, int col_tiles, float* acc,
                       cudaStream_t s) {
  constexpr int V = Shape<T, kVec>::V;
  const long long groups = row_tiles * (kThreads >> lanes_log2);
  // the plan must cover every row and column, and no tile may be empty
  if (group_rows < 1 || row_tiles > 0x7fffffffLL || col_tiles > 65535 ||
      groups * group_rows < n || (groups - (kThreads >> lanes_log2)) *
      group_rows >= n || (long long)col_tiles * (V << lanes_log2) < d ||
      (long long)(col_tiles - 1) * (V << lanes_log2) >= d)
    return cudaErrorInvalidValue;
  if (kVec && ((d * sizeof(T)) % 16 != 0 ||
               reinterpret_cast<uintptr_t>(data) % 16 != 0))
    return cudaErrorInvalidValue;
  segsum_kernel<T, kVec><<<dim3((unsigned)row_tiles, (unsigned)col_tiles),
                           kThreads, 0, s>>>(
      static_cast<const T*>(data), seg, n, d, n_segments, lanes_log2,
      group_rows, acc);
  return cudaSuccess;
}

}  // namespace

extern "C" {

const char* segsum_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// data [n, d] (dtype 0 = f32, 1 = bf16) and seg [n] int32, contiguous;
// the tile plan (ops.py's tile_plan): 16-byte loads or not, lanes a row
// group, rows a group, row tiles and column tiles; acc is f32
// [n_segments, d] scratch (zeroed here); out [n_segments, d] in the data's
// type, which may be acc itself when the data is f32.
int sorted_segment_sum(const void* data, const int* seg, long long n, int d,
                       int n_segments, int dtype, int vector, int lanes,
                       int group_rows, long long row_tiles, int col_tiles,
                       float* acc, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (lanes < 1 || lanes > 32 || (lanes & (lanes - 1)) || dtype < 0 ||
      dtype > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int lanes_log2 = __builtin_ctz(lanes);
  const long long n_out = (long long)n_segments * d;
  cudaError_t err = cudaMemsetAsync(acc, 0, n_out * sizeof(float), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n > 0 && d > 0) {
    auto sum = dtype == 0
        ? (vector ? launch_sum<float, true> : launch_sum<float, false>)
        : (vector ? launch_sum<__nv_bfloat16, true>
                  : launch_sum<__nv_bfloat16, false>);
    err = sum(data, seg, n, d, n_segments, lanes_log2, group_rows, row_tiles,
              col_tiles, acc, s);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (dtype == 1 && n_out > 0) {
    long long grid = (n_out + kThreads - 1) / kThreads;
    to_bf16_kernel<<<(unsigned)(grid < 65536 ? grid : 65536), kThreads, 0, s>>>(
        acc, static_cast<__nv_bfloat16*>(out), n_out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
