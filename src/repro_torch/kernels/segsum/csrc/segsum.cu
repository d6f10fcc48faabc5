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
// cudaGetLastError() so the caller sees a refused launch.
//
// What bounds it on an H100: bytes.  It reads every row once and writes
// each segment once (at ogb_products' scale, 61.9 M rows of 100 f32 values
// into 2.4 M segments: 25.9 GB, 7.7 ms at 3.35 TB/s) and does one add per
// element read.  The TPU kernel multiplies a one-hot [block, S] matrix
// into the output on the matrix unit, since a TPU has no fast scatter; that
// costs S times the adds and holds [S, D] in VMEM.  Here the reduction is
// segmented instead: a warp takes 256 consecutive rows, its lanes spread
// over the columns (128 at a time, so each row is one coalesced read), sums
// each run of equal ids in registers, and adds the run's sum into an f32
// accumulator with atomicAdd when the id changes.  Sorted ids make a run
// one add per column for the whole run; the adds are atomic, so a run cut
// by a warp's boundary, and ids in any order, still sum right.  Rows are
// read four at a time before they are added, so each lane has 16 loads in
// flight.  bf16 data is summed in f32 and rounded once at the end (a second
// small kernel); the order of the atomic adds varies from run to run, so
// f32 sums agree with a sequential sum to rounding, not bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerWarp = 256;
constexpr int kUnroll = 4;            // rows read before they are added
constexpr int kColsPerLane = 4;       // 128 columns a pass

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Adds a run's column sums into row `seg` of the accumulator.
__device__ __forceinline__ void flush(float* acc, int seg, int n_segments,
                                      int d, int c0, int lane,
                                      const float (&a)[kColsPerLane]) {
  if (seg < 0 || seg >= n_segments) return;   // dropped, as out-of-range ids
#pragma unroll
  for (int j = 0; j < kColsPerLane; ++j) {
    int col = c0 + lane + 32 * j;
    if (col < d) atomicAdd(acc + (size_t)seg * d + col, a[j]);
  }
}

template <typename T>
// repro: grid[concurrent]
__global__ void __launch_bounds__(kThreads)
segsum_kernel(const T* __restrict__ data, const int* __restrict__ seg,
              long long n, int d, int n_segments, float* __restrict__ acc) {
  const int lane = threadIdx.x & 31;
  const long long warp = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const long long r0 = warp * kRowsPerWarp;
  if (r0 >= n) return;                                   // warp-uniform
  const long long r1 = min(n, r0 + kRowsPerWarp);
  for (int c0 = 0; c0 < d; c0 += 32 * kColsPerLane) {
    float a[kColsPerLane] = {0.f, 0.f, 0.f, 0.f};
    int cur = 0;
    bool open = false;                                   // a run is summed
    for (long long r = r0; r < r1; r += 32) {
      const int cnt = (int)min(32LL, r1 - r);
      const int my_id = lane < cnt ? __ldg(seg + r + lane) : 0;
      for (int i = 0; i < cnt; i += kUnroll) {
        float x[kUnroll][kColsPerLane];
        int ids[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          ids[u] = __shfl_sync(0xffffffffu, my_id, (i + u) & 31);
          const T* row = data + (size_t)(r + i + u) * d;
#pragma unroll
          for (int j = 0; j < kColsPerLane; ++j) {
            int col = c0 + lane + 32 * j;
            x[u][j] = (i + u < cnt && col < d) ? to_float(row[col]) : 0.f;
          }
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          if (i + u >= cnt) break;
          if (!open || ids[u] != cur) {                  // a new run
            if (open) flush(acc, cur, n_segments, d, c0, lane, a);
#pragma unroll
            for (int j = 0; j < kColsPerLane; ++j) a[j] = 0.f;
            cur = ids[u];
            open = true;
          }
#pragma unroll
          for (int j = 0; j < kColsPerLane; ++j) a[j] += x[u][j];
        }
      }
    }
    if (open) flush(acc, cur, n_segments, d, c0, lane, a);
  }
}

// repro: grid[concurrent]
__global__ void to_bf16_kernel(const float* __restrict__ in,
                               __nv_bfloat16* __restrict__ out, long long n) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x)
    out[i] = __float2bfloat16_rn(in[i]);
}

}  // namespace

extern "C" {

const char* segsum_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// data [n, d] (dtype 0 = f32, 1 = bf16) and seg [n] int32, contiguous;
// acc is f32 [n_segments, d] scratch (zeroed here); out [n_segments, d] in
// the data's type, which may be acc itself when the data is f32.
int sorted_segment_sum(const void* data, const int* seg, long long n, int d,
                       int n_segments, int dtype, float* acc, void* out,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long n_out = (long long)n_segments * d;
  cudaError_t err = cudaMemsetAsync(acc, 0, n_out * sizeof(float), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long warps = (n + kRowsPerWarp - 1) / kRowsPerWarp;
  const long long blocks = (warps * 32 + kThreads - 1) / kThreads;
  if (blocks > 0) {
    if (dtype == 0)
      segsum_kernel<float><<<(unsigned)blocks, kThreads, 0, s>>>(
          static_cast<const float*>(data), seg, n, d, n_segments, acc);
    else if (dtype == 1)
      segsum_kernel<__nv_bfloat16><<<(unsigned)blocks, kThreads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(data), seg, n, d, n_segments, acc);
    else
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 1 && n_out > 0) {
    long long grid = (n_out + kThreads - 1) / kThreads;
    to_bf16_kernel<<<(unsigned)(grid < 65536 ? grid : 65536), kThreads, 0, s>>>(
        acc, static_cast<__nv_bfloat16*>(out), n_out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
