// Sorted-adjacency intersection counting for Hopper (sm_90a): the CUDA C++
// port of the Pallas kernel in repro/kernels/intersect/intersect.py
// (_intersect_kernel / intersect_count_pallas).
//
//   intersect_count   per pair, how many of the first min(|A|, max_deg)
//                     elements A' of segment A = col[lo_a:hi_a) n_steps
//                     branchless halvings find in segment B =
//                     col[lo_b:hi_b); over the DAG edges (a, b) it is
//                     |N+(a) ∩ N+(b)|, the hot loop of the hand-optimised
//                     triangle count
//
// Plain C interface (bound with ctypes): launches on the stream it is
// given, allocates nothing, never synchronises, and returns
// cudaGetLastError() so the caller sees a refused launch.
//
// What bounds it on an H100: loads, not bytes.  The compulsory traffic is
// small (the four segment bounds and the count per pair, and col_idx
// once: 21.8 MB at RMAT-16, whose 3.6 MB col_idx stays in the 50 MB L2).
// Searching each element of A' in B, as the TPU kernel does, costs n_steps
// + 2 dependent scattered loads an element (677 M at RMAT-16), and reads
// a source's A' again for each of its pairs.
//
// The design turns the search around.  A warp takes 32 consecutive pairs,
// lane i loading pair i's four bounds.  A run of them with equal (lo_a,
// hi_a) (a source's out-edges, when the pairs follow the CSR) shares one
// copy of A' staged in the warp's 8 KB of shared memory: a bitmap over
// A'[0] .. A'[last] when that span is at most kBits ids (every RMAT-16
// source's), else the sorted list when it holds at most kWords elements.
// For each pair the warp streams B through its lanes in coalesced
// 32-element chunks (the first kChunks loaded at once), probes each
// element in A' (one shared-memory word, branch-free, for the bitmap; a
// binary search of the list), and __reduce_add_sync sums the hits.  The
// global traffic is the sum of |B| words, read in order, and each A' once
// a run; a new run's first chunks of A' load with the pair's B, and stay
// in registers to clear the bitmap's words when the next run is staged.
// Occupancy is what the buffers leave: 8 KB a warp allows 26 warps an SM.
//
// The exact gates.  Counting the elements of B found in A' gives the TPU
// kernel's answer exactly when A' and B are strictly ascending, both lie
// inside col (no clip at m - 1), and |B| <= 2^n_steps - 1: the search then
// converges to B's lower bound, and a later probe at lo_b - 1 cannot move
// it.  Staging checks A' and streaming checks B for strict order, with
// one rotating __shfl_sync a chunk: each lane compares with the lane
// before, lane 0 with the last lane of the chunk before.  A pair
// whose A' is empty, or whose B is empty or reversed (lo_b >= hi_b),
// counts 0 as in the TPU kernel.  Any other pair that fails a gate, and
// every pair of a run whose A' fits neither form, runs the TPU kernel's
// search unchanged on its warp in the same launch (lanes strided over A',
// n_steps halvings of B in global memory, the clip at m - 1 included), so
// the count equals the plain version's bit for bit on every input.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 2;           // warps a CTA, 32 pairs each
constexpr int kThreads = kWarps * 32;
constexpr int kWords = 2048;        // a warp's buffer: 8 KB, and a zero word
constexpr int kBits = kWords * 32;  // ids a bitmap covers
constexpr int kChunks = 4;          // 32-element chunks a warp loads at once
constexpr unsigned kFull = 0xffffffffu;

// how a run's A' is held: nothing to count, a bitmap, the sorted list, or
// not at all (its pairs search B in global memory)
enum Form : int { kEmpty, kBitmap, kList, kSearch };

struct Run {
  int lo;          // A' = col[lo : lo + n)
  int n;
  int first;       // A'[0], the bitmap's id 0
  unsigned span;   // A'[last] - A'[0] + 1, for a bitmap
  int form;
};

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// A' of a pair with A = col[la:ha): empty, or to be searched
__device__ __forceinline__ Run run_of(int la, int ha, int max_deg) {
  long long len = (long long)ha - la;
  int n = len < 0 ? 0 : (len > max_deg ? max_deg : (int)len);
  return Run{la, n, 0, 0u, n == 0 ? kEmpty : kSearch};
}

// v[u] = col[lo + 32u + lane] for the elements below hi and inside col
__device__ __forceinline__ void load_chunks(const int* __restrict__ col,
                                            int m, int lo, int hi, int lane,
                                            int (&v)[kChunks]) {
#pragma unroll
  for (int u = 0; u < kChunks; ++u) {
    int j = lo + 32 * u + lane;
    v[u] = j < hi && (unsigned)j < (unsigned)m ? __ldg(col + j) : 0;
  }
}

// A'[i], lane-strided: from the registers v for the first kChunks chunks
__device__ __forceinline__ int element(const int* __restrict__ col,
                                       const Run& r, const int (&v)[kChunks],
                                       int i) {
  int g = i >> 5, x = v[0];
#pragma unroll
  for (int u = 1; u < kChunks; ++u) x = g == u ? v[u] : x;
  return g < kChunks ? x : __ldg(col + r.lo + i);
}

// the form that can hold a searched run's A' (inside col, its first
// chunks in v) in a buffer: a bitmap over its span, else its list, else
// none (kSearch)
__device__ void shape(const int* __restrict__ col, Run& r,
                      const int (&v)[kChunks], int lane) {
  int last = r.n - 1;
  r.first = __shfl_sync(kFull, v[0], 0);
  int x = __shfl_sync(kFull,
                      element(col, r, v, min((last & ~31) + lane, last)),
                      last & 31);
  long long span = (long long)x - r.first + 1;
  r.span = (unsigned)span;
  r.form = span >= 1 && span <= kBits ? kBitmap
         : (span >= 1 && r.n <= kWords ? kList : kSearch);
}

// The warp stages a bitmap or list run into buf (its first chunks in v);
// false if A' is out of strict order (its pairs then search)
__device__ bool stage(const int* __restrict__ col, const Run& r,
                      const int (&v)[kChunks], unsigned* buf, int lane) {
  bool bad = false;
  int carry = INT_MIN;
  for (int base = 0; base < r.n; base += 32) {
    int i = base + lane;
    bool live = i < r.n;
    int x = live ? element(col, r, v, i) : INT_MAX;
    int rot = __shfl_sync(kFull, x, lane + 31);       // lane 0: lane 31's
    int prev = lane == 0 ? carry : rot;
    bad |= live && prev >= x;
    carry = rot;
    if (!live) continue;
    if (r.form == kList) {
      buf[i] = (unsigned)x;
    } else {
      unsigned d = (unsigned)x - (unsigned)r.first;
      if (d < r.span) atomicOr(buf + (d >> 5), 1u << (d & 31));
    }
  }
  return !__any_sync(kFull, bad);
}

// The warp zeroes the words that staging run r (its first chunks in v)
// wrote
__device__ void clear(const int* __restrict__ col, const Run& r,
                      const int (&v)[kChunks], unsigned* buf, int lane) {
  for (int i = lane; i < r.n; i += 32) {
    if (r.form == kList) {
      buf[i] = 0;
    } else if (r.form == kBitmap) {
      unsigned d = (unsigned)element(col, r, v, i) - (unsigned)r.first;
      if (d < r.span) buf[d >> 5] = 0;
    }
  }
}

// is b in the staged A'?  A bitmap reads one word (past the span, the zero
// word at kWords, or a zero bit); a list is searched for b's lower bound
template <int kForm>
__device__ __forceinline__ unsigned probe(const Run& r, const unsigned* buf,
                                          int b) {
  if (kForm == kBitmap) {
    unsigned d = (unsigned)b - (unsigned)r.first;
    return (buf[min(d >> 5, (unsigned)kWords)] >> (d & 31)) & 1u;
  }
  const int* list = reinterpret_cast<const int*>(buf);
  int lo = 0, len = r.n;
  while (len > 0) {
    int half = len >> 1;
    bool right = list[lo + half] < b;
    lo = right ? lo + half + 1 : lo;
    len = right ? len - half - 1 : half;
  }
  return lo < r.n && list[lo] == b;
}

// The warp streams B = col[lb:hb) (inside col; its first chunks in b) in
// coalesced chunks, probes each element in the staged A', and checks B's
// strict order; returns the lane's hits, with *bad set if it saw B out of
// order
template <int kForm>
__device__ int stream(const int* __restrict__ col, int m, const Run& r,
                      const unsigned* buf, int lb, int hb, int lane,
                      int (&b)[kChunks], bool* bad) {
  int cnt = 0, carry = INT_MIN;
  for (int base = lb;;) {
#pragma unroll
    for (int u = 0; u < kChunks; ++u) {
      if (base + 32 * u >= hb) break;
      bool live = base + 32 * u + lane < hb;
      int rot = __shfl_sync(kFull, b[u], lane + 31);   // lane 0: lane 31's
      int prev = lane == 0 ? carry : rot;
      *bad |= live && prev >= b[u];
      carry = rot;
      cnt += probe<kForm>(r, buf, b[u]) & (unsigned)live;
    }
    base += 32 * kChunks;
    if (base >= hb) return cnt;
    load_chunks(col, m, base, hb, lane, b);
  }
}

// The TPU kernel's search on one warp: lanes strided over A', each element
// found by n_steps branchless halvings of B in global memory
__device__ int search_count(const int* __restrict__ col, int m, int la,
                            int n_a, int lb, int hb, int n_steps,
                            int lane) {
  int cnt = 0;
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
  return __reduce_add_sync(kFull, cnt);
}

// One pair on one warp: B probed in the staged A' when every gate holds,
// else the search
__device__ int pair_count(const int* __restrict__ col, int m, const Run& r,
                          bool staged, const unsigned* buf, int lb, int hb,
                          int n_steps, int lane, int (&b)[kChunks]) {
  if (r.form == kEmpty || lb >= hb) return 0;
  int max_b = n_steps >= 31 ? INT_MAX : (1 << n_steps) - 1;
  if (staged && lb >= 0 && hb <= m && hb - lb <= max_b) {
    bool bad = false;
    int cnt = r.form == kBitmap
        ? stream<kBitmap>(col, m, r, buf, lb, hb, lane, b, &bad)
        : stream<kList>(col, m, r, buf, lb, hb, lane, b, &bad);
    if (!__any_sync(kFull, bad)) return __reduce_add_sync(kFull, cnt);
  }
  return search_count(col, m, r.lo, r.n, lb, hb, n_steps, lane);
}

// A warp takes 32 consecutive pairs, lane i holding pair i's bounds, and
// stages each run's A' in its own buffer.  It loads a pair's first chunks
// of B, and a new run's of A', before it waits on either.
// repro: grid[concurrent]
__global__ void __launch_bounds__(kThreads)
intersect_count_kernel(const int* __restrict__ col, int m,
                       const int* __restrict__ lo_a,
                       const int* __restrict__ hi_a,
                       const int* __restrict__ lo_b,
                       const int* __restrict__ hi_b, int n_pairs,
                       int max_deg, int n_steps, int* __restrict__ out) {
  __shared__ unsigned bufs[kWarps][kWords + 1];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned* buf = bufs[warp];
  const int q0 = (blockIdx.x * kWarps + warp) * 32;
  if (q0 >= n_pairs) return;              // the whole warp leaves together
  const int n = min(32, n_pairs - q0);
  int la = 0, ha = 0, lb = 0, hb = 0;
  if (lane < n) {
    la = __ldg(lo_a + q0 + lane);
    ha = __ldg(hi_a + q0 + lane);
    lb = __ldg(lo_b + q0 + lane);
    hb = __ldg(hi_b + q0 + lane);
  }
  for (int i = lane; i <= kWords; i += 32) buf[i] = 0;
  // the runs: pairs whose (lo_a, hi_a) differs from the pair before
  int up_la = __shfl_up_sync(kFull, la, 1);
  int up_ha = __shfl_up_sync(kFull, ha, 1);
  const unsigned heads = __ballot_sync(kFull, lane == 0 || la != up_la ||
                                              ha != up_ha);
  Run r = run_of(0, 0, 0), held = r;      // held: the run buf holds
  int held_v[kChunks] = {};               // and its first chunks
  bool staged = false;
  int count = 0;                          // lane i: pair i's
  for (int i = 0; i < n; ++i) {
    const int pair_lb = __shfl_sync(kFull, lb, i);
    const int pair_hb = __shfl_sync(kFull, hb, i);
    int b[kChunks];
    load_chunks(col, m, pair_lb, pair_hb, lane, b);
    if (heads >> i & 1) {
      r = run_of(__shfl_sync(kFull, la, i), __shfl_sync(kFull, ha, i),
                 max_deg);
      staged = false;
      if (r.form == kSearch && r.lo >= 0 && (long long)r.lo + r.n <= m) {
        int v[kChunks];
        load_chunks(col, m, r.lo, r.lo + r.n, lane, v);
        shape(col, r, v, lane);
        if (r.form == kBitmap || r.form == kList) {
          __syncwarp();                   // every lane is past held's probes
          clear(col, held, held_v, buf, lane);
          __syncwarp();
          held = r;
#pragma unroll
          for (int u = 0; u < kChunks; ++u) held_v[u] = v[u];
          staged = stage(col, r, v, buf, lane);
          __syncwarp();
        }
      }
    }
    int cnt = pair_count(col, m, r, staged, buf, pair_lb, pair_hb, n_steps,
                         lane, b);
    count = lane == i ? cnt : count;
  }
  if (lane < n) out[q0 + lane] = count;
}

}  // namespace

extern "C" {

const char* intersect_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int intersect_count(const int* col, const int* lo_a, const int* hi_a,
                    const int* lo_b, const int* hi_b, int m, int n_pairs,
                    int max_deg, int n_steps, int* out, void* stream) {
  int blocks = (n_pairs + kThreads - 1) / kThreads;
  intersect_count_kernel<<<blocks, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      col, m, lo_a, hi_a, lo_b, hi_b, n_pairs, max_deg, n_steps, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
