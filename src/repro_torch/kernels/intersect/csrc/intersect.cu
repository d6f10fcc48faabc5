// Sorted-adjacency intersection counting for Hopper (sm_90a): the CUDA C++
// port of the Pallas kernel in repro/kernels/intersect/intersect.py
// (_intersect_kernel / intersect_count_pallas).
//
//   intersect_count   |col[lo_a:hi_a) ∩ col[lo_b:hi_b)| per pair; over the
//                     DAG edges (a, b) it is |N+(a) ∩ N+(b)|, the hot loop
//                     of the hand-optimised triangle count
//
// Plain C interface (bound with ctypes): launches on the stream it is
// given, allocates nothing, never synchronises, and returns
// cudaGetLastError() so the caller sees a refused launch.
//
// What bounds it on an H100: dependent loads, not bytes.  The compulsory
// traffic is small (the four segment bounds and the count per pair, and
// col_idx once: 21.8 MB at RMAT-16, whose 3.6 MB col_idx stays in the
// 50 MB L2), while every live element of segment A walks n_steps
// dependent probes of segment B.  The TPU kernel expands segment A to
// max_deg padded lanes per pair; here one warp takes one pair and its
// lanes stride over the live part of A only (min(|A|, max_deg) elements),
// so the work is the sum of |A| (67.7 M lanes at RMAT-16), not
// n_pairs x max_deg (224.7 M).  Each lane runs the JAX version's search
// unchanged, a fixed n_steps of branchless halvings, so the count equals
// the plain version's bit for bit, truncation at max_deg and clipping at
// m - 1 included; __reduce_add_sync sums the warp.

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

__global__ void __launch_bounds__(kThreads)
intersect_count_kernel(const int* __restrict__ col, int m,
                       const int* __restrict__ lo_a,
                       const int* __restrict__ hi_a,
                       const int* __restrict__ lo_b,
                       const int* __restrict__ hi_b, int n_pairs,
                       int max_deg, int n_steps, int* __restrict__ out) {
  int pair = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  int lane = threadIdx.x & 31;
  if (pair >= n_pairs) return;            // the whole warp leaves together
  int la = __ldg(lo_a + pair);
  int lb = __ldg(lo_b + pair);
  int hb = __ldg(hi_b + pair);
  long long len = (long long)__ldg(hi_a + pair) - la;
  int n_a = len < 0 ? 0 : (len > max_deg ? max_deg : (int)len);
  int cnt = 0;
  if (lb < hb) {                          // an empty B finds nothing
    for (int off = lane; off < n_a; off += 32) {
      int target = __ldg(col + clampi(la + off, 0, m - 1));
      int low = lb, high = hb - 1;
      for (int s = 0; s < n_steps; ++s) {
        int mid = (low + high) >> 1;
        bool right = __ldg(col + clampi(mid, 0, m - 1)) < target;
        low = right ? mid + 1 : low;
        high = right ? high : mid - 1;
      }
      cnt += low < hb && __ldg(col + clampi(low, 0, m - 1)) == target;
    }
  }
  cnt = __reduce_add_sync(0xffffffffu, cnt);
  if (lane == 0) out[pair] = cnt;
}

}  // namespace

extern "C" {

const char* intersect_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int intersect_count(const int* col, const int* lo_a, const int* hi_a,
                    const int* lo_b, const int* hi_b, int m, int n_pairs,
                    int max_deg, int n_steps, int* out, void* stream) {
  int blocks = (n_pairs + kWarpsPerBlock - 1) / kWarpsPerBlock;
  intersect_count_kernel<<<blocks, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      col, m, lo_a, hi_a, lo_b, hi_b, n_pairs, max_deg, n_steps, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
