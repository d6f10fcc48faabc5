// Fused EXTEND kernels for Hopper (sm_90a): the CUDA C++ port of the Pallas
// kernels in repro/kernels/extend_fused/extend.py.
//
//   extend_candidates   unpruned enumeration for cold inspection
//                       (replaces _fused_extend_kernel / fused_extend_pallas)
//   extend_count        pass 1 of the two-pass pruned extend
//   extend_scatter      pass 2 of the two-pass pruned extend
//                       (replace _mp_count_kernel / _mp_scatter_kernel /
//                        fused_extend_pruned_mp_pallas; both passes share
//                        enumerate_slot, the port of _tile_enumerate)
//   extend_edge         edge-induced enumeration with the canonical-edge
//                       test and the per-vertex eager mask (replaces
//                       _edge_extend_kernel / fused_extend_edge_pallas)
//   extend_pruned_1p    the single-pass pruned extend (replaces
//                       _pruned_extend_kernel / fused_extend_pruned_pallas)
//
// Each entry point has a plain C interface (bound with ctypes), launches on
// the stream it is given, allocates nothing, never synchronises, and returns
// cudaGetLastError() so the caller sees a refused launch.
//
// What bounds them on an H100: none does arithmetic worth counting; all are
// memory-latency bound.  Per candidate slot a thread runs a binary search of
// the parent prefix sum (log2 of cap*k dependent loads), one CSR gather, and
// up to k connectivity probes (a binary search of a CSR row, or one word of
// the bit-packed adjacency; see the probe modes below).  The compulsory traffic is the parent tables
// (5 x 4 B per parent slot), col_idx (3.6 MB at RMAT-16, which stays in the
// 50 MB L2) and the outputs: 16 B per slot for extend_candidates, 4 B per
// tile for extend_count, 8 B per survivor for extend_scatter.  The simple
// design here runs one thread per slot so neighbouring threads walk nearly
// the same search path (the top of each search hits L1/L2), skips the probes
// of a slot once its predicate is already false, and does not enumerate dead
// slots in the pruned pair.  Making them fast (a per-CTA parent window in
// shared memory, warp-cooperative probes) is later work.
//
// extend_pruned_1p enumerates once where the pair enumerates twice.  The TPU
// kernel carries the running survivor offset from tile to tile in SMEM,
// which only a sequential grid allows; here each CTA takes its tile from an
// atomic ticket (so every tile it waits on is already running), publishes
// its survivor count, and finds its base by a decoupled look-back over the
// predecessors' 64-bit status words (flag and value in one word, so one
// store publishes both).  The in-tile rank is the pair's
// own lane-order scan (tile_rank), so the output order, and the buffers,
// are the pair's bit for bit.  Its compulsory traffic is the pair's reads
// plus 8 B per survivor and 8 B per tile of status.  A tile waits until
// every earlier tile has counted, and the work per tile is uneven (search
// depths, dead slots), so a CTA takes four 512-slot sub-tiles: a quarter
// of the look-backs, and less spread in the time per tile.
//
// The pruned kernels evaluate four kinds of predicate (the spec kinds of
// repro_torch/core/api.py), each a template instantiation of
// enumerate_slot, so the clique rules compile to the code they always had:
//   clique       a conjunction of slot masks (required, distinct, greater,
//                src_slot_eq), probing only while the conjunction holds;
//   conjunction  the same with forbidden slots (induced matching) and,
//                when labeled, the candidate's and first extension's label
//                equations (one gather each, clipped to the table);
//   canonical    the automorphism-canonical test, the connectivity bit of
//                every slot in slot order (is_auto_canonical_kernel);
//   branches     a pattern-set trie level: up to 32 branches, each with a
//                parent bit of the parent's i32 state, an anchor slot,
//                required/forbidden/distinct/smaller masks and first_pair.
//                The lane first keeps the branches whose parent bit and
//                anchor match; with none it probes nothing.  Otherwise it
//                probes each slot that a kept branch names once, builds
//                its connectivity, equality and order masks once, and
//                tests each kept branch against them with a few integer
//                ops.  The bitmap is the keep mask (!= 0) and the new
//                state, which extend_scatter and extend_pruned_1p compact
//                through the same tile_rank as row and u (8 B more per
//                survivor: the parent's state read, the new state written).
// The branch table travels by value in the kernel parameters (about 0.9
// KB of the 4 KB); every lane reads the same entry, so the reads are
// constant-bank broadcasts.
//
// K1 probes connectivity in one of three modes (conn_mode, a template
// parameter of every pruned kernel, so each mode compiles to its own code):
//   search  a binary search of the parent's CSR row;
//   bitmap  the full pack: one word of row ev, rows indexed by vertex id;
//   mixed   a partial or core pack (port of extend.py:244-267): the parent
//           vertex's row is row_slot[ev]; a packed row, and for a core pack
//           (n_cols < n_vertices) a candidate below n_cols, answers from
//           word row * n_words + (u >> 5) (64-bit index); anything else
//           searches the CSR as in search mode.  The TPU kernel evaluates
//           both and selects per lane; here the lane branches, since either
//           branch gives the same answer.  The row_slot gather adds one
//           dependent load (4 B per parent slot, from L1/L2) before each
//           probe; a hit saves the search's log2(degree) dependent loads.
//
// extend_edge writes five int32 outputs per candidate slot (20 B), which is
// its compulsory traffic and its bound: the parent tables are 16 B per slot
// parent, and the row's E edge uids and their endpoints are read per slot
// from L1/L2.  One thread per slot, E a template parameter, stores
// coalesced.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kTile = 512;            // slots per CTA in the pruned pair
constexpr int kWarps = kTile / 32;
constexpr int kItems1p = 4;           // 512-slot sub-tiles per CTA, 1p
constexpr int kCandThreads = 256;     // threads per CTA in extend_candidates

// The kinds of spec (KINDS in repro_torch/core/api.py).
enum Kind { kClique = 0, kConjunction = 1, kCanonical = 2, kBranches = 3 };
constexpr int kMaxBranches = 32;

// The clique predicate, PredicateSpec with no forbidden slot and no label.
struct Spec {
  int required;     // conn bit j must be set
  int distinct;     // u != emb_j
  int greater;      // u > emb_j
  int src_slot_eq;  // src_slot == this, when >= 0
};

struct Tables {
  const int* offsets;   // inclusive prefix sum of per-parent counts
  const int* starts;    // exclusive prefix sum
  const int* emb;       // parent vertices, [cap * k]
  const int* vlo;       // row_ptr[emb]
  const int* vhi;       // row_ptr[emb + 1]
  const int* col;       // CSR column array, [m]
  int n_parents;
  int m;
  int k;
};

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// First p with offsets[p] > slot, clipped to n_parents - 1 (extend.py:80-92).
__device__ __forceinline__ int parent_of(const int* __restrict__ offsets,
                                         int n_parents, int slot) {
  int lo = 0, hi = n_parents;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (__ldg(offsets + mid) <= slot) lo = mid + 1; else hi = mid;
  }
  return lo < n_parents - 1 ? lo : n_parents - 1;
}

// Is u in col[lo:hi)?  A lower-bound search; it ends where the JAX kernel's
// fixed count of branchless steps ends (extend.py:99-118).
__device__ __forceinline__ bool csr_contains(const int* __restrict__ col,
                                             int lo, int hi, int u) {
  int l = lo, h = hi - 1;
  while (l <= h) {
    int mid = (l + h) >> 1;
    if (__ldg(col + mid) < u) l = mid + 1; else h = mid - 1;
  }
  return lo < hi && l < hi && __ldg(col + l) == u;
}

// Bit u of packed row `row`, u clamped to the row's n_cols columns
// (extend.py:246-250).
__device__ __forceinline__ bool bitmap_contains(const uint32_t* __restrict__ bits,
                                                int n_words, int n_cols,
                                                int row, int u) {
  int ub = clampi(u, 0, n_cols - 1);
  uint32_t w = __ldg(bits + (long long)row * n_words + (ub >> 5));
  return (w >> (ub & 31)) & 1u;
}

// The probe modes (conn_mode in ops.py).
enum Mode { kSearch = 0, kBitmap = 1, kMixed = 2 };

// The bit-packed adjacency as K1 reads it.  In bitmap mode row v is vertex
// v's; in mixed mode row_slot maps a vertex to its row (-1: not packed),
// and each of the n_rows rows covers the columns below n_cols.
struct Pack {
  const uint32_t* bits;
  const int* row_slot;
  int n_words;
  int n_vertices;
  int n_rows;
  int n_cols;
};

// Is u adjacent to the parent slot at flat index pj, whose vertex ev >= 0?
template <int M>
__device__ __forceinline__ bool probe(const Tables& t, const Pack& pk, int pj,
                                      int ev, int u) {
  if (M == kBitmap)
    return bitmap_contains(pk.bits, pk.n_words, pk.n_vertices,
                           clampi(ev, 0, pk.n_vertices - 1), u);
  if (M == kMixed) {
    int r = __ldg(pk.row_slot + clampi(ev, 0, pk.n_vertices - 1));
    if (r >= 0 && (pk.n_cols == pk.n_vertices || u < pk.n_cols))
      return bitmap_contains(pk.bits, pk.n_words, pk.n_cols,
                             r < pk.n_rows ? r : pk.n_rows - 1, u);
  }
  return csr_contains(t.col, t.vlo[pj], t.vhi[pj], u);
}

struct Cand {
  int row;
  int u;
  bool keep;
  int bits;         // a branch set's bitmap (the new state); 0 otherwise
};

// The predicates.  Each eval() gets the lane's parent row, source slot and
// candidate, and conn(pj, ev): is u adjacent to the parent slot at flat
// index pj, whose vertex is ev (a bitmap bit or a CSR search, false for a
// dead slot).  Every
// predicate probes only once u >= 0 is established (the plain version's
// connectivity bits also require it): the clique and conjunction test it
// first, the canonical test's u > emb_0 >= -1 implies it, and a branch
// set keeps no branch for u < 0.

struct CliquePred {
  static constexpr bool kWritesState = false;
  Spec spec;

  template <class F>
  __device__ __forceinline__ Cand eval(const Tables& t, int row, int src_slot,
                                       int u, F conn) const {
    bool ok = u >= 0;
    if (spec.src_slot_eq >= 0) ok = ok && src_slot == spec.src_slot_eq;
    int base = row * t.k;
    for (int j = 0; j < t.k && ok; ++j) {
      int pj = clampi(base + j, 0, t.n_parents - 1);
      int ev = t.emb[pj];
      if ((spec.distinct >> j) & 1) ok = ok && u != ev;
      if ((spec.greater >> j) & 1) ok = ok && u > ev;
      if (ok && ((spec.required >> j) & 1)) ok = conn(pj, ev);
    }
    return Cand{row, u, ok, 0};
  }
};

// A conjunction with forbidden slots and, if Labeled, label equations: the
// candidate's label is `label` (when >= 0), and on the first extension
// (lab0 >= 0) the parent's slots 0 and 1 carry lab0 and lab1.
template <bool Labeled>
struct ConjPred {
  static constexpr bool kWritesState = false;
  Spec spec;
  int forbidden;
  int label, lab0, lab1;
  const int* labels;
  int n_labels;

  __device__ __forceinline__ int lab(int v) const {
    return __ldg(labels + clampi(v, 0, n_labels - 1));
  }

  template <class F>
  __device__ __forceinline__ Cand eval(const Tables& t, int row, int src_slot,
                                       int u, F conn) const {
    bool ok = u >= 0;
    int base = row * t.k;
    if (Labeled) {
      if (label >= 0) ok = ok && lab(u) == label;
      if (ok && lab0 >= 0)
        ok = lab(t.emb[clampi(base, 0, t.n_parents - 1)]) == lab0
             && lab(t.emb[clampi(base + 1, 0, t.n_parents - 1)]) == lab1;
    }
    if (spec.src_slot_eq >= 0) ok = ok && src_slot == spec.src_slot_eq;
    for (int j = 0; j < t.k && ok; ++j) {
      int pj = clampi(base + j, 0, t.n_parents - 1);
      int ev = t.emb[pj];
      if ((spec.distinct >> j) & 1) ok = ok && u != ev;
      if ((spec.greater >> j) & 1) ok = ok && u > ev;
      bool rq = (spec.required >> j) & 1, fb = (forbidden >> j) & 1;
      if (ok && (rq || fb)) {
        bool c = conn(pj, ev);
        ok = (!rq || c) && (!fb || !c);
      }
    }
    return Cand{row, u, ok, 0};
  }
};

// is_auto_canonical_kernel: u > emb_0; for each slot in order, reject when
// an earlier slot was adjacent and u < emb_j, when u == emb_j, or when u
// is adjacent to a slot before its source slot; accept iff some slot is
// adjacent.  Once a term fails the answer is false, so probing stops.
struct CanonPred {
  static constexpr bool kWritesState = false;

  template <class F>
  __device__ __forceinline__ Cand eval(const Tables& t, int row, int src_slot,
                                       int u, F conn) const {
    int base = row * t.k;
    bool ok = u > t.emb[clampi(base, 0, t.n_parents - 1)];
    bool found = false;
    for (int j = 0; j < t.k && ok; ++j) {
      int pj = clampi(base + j, 0, t.n_parents - 1);
      int ev = t.emb[pj];
      ok = !(found && u < ev) && u != ev;
      if (!ok) break;
      bool adj = conn(pj, ev);
      found = found || adj;
      ok = !(adj && j < src_slot);
    }
    return Cand{row, u, ok && found, 0};
  }
};

struct Branch {
  int parent, anchor, required, forbidden, distinct, smaller, first_pair;
};

struct BranchPred {
  static constexpr bool kWritesState = true;
  int n;
  Branch b[kMaxBranches];
  const int* state;     // the parents' state, [n_rows]
  int n_rows;

  template <class F>
  __device__ __forceinline__ Cand eval(const Tables& t, int row, int src_slot,
                                       int u, F conn) const {
    int st = __ldg(state + clampi(row, 0, n_rows - 1));
    unsigned live = 0;
    int need = 0;                       // slots a live branch probes
    // The branch loops are unrolled to constant indices, so each read of
    // the table is a constant-bank load (a dynamic index would copy the
    // table to local memory).
    if (u >= 0) {
#pragma unroll
      for (int i = 0; i < kMaxBranches; ++i) {
        if (i < n && ((st >> b[i].parent) & 1) && src_slot == b[i].anchor) {
          live |= 1u << i;
          need |= b[i].required | b[i].forbidden;
        }
      }
    }
    if (!live) return Cand{row, u, false, 0};
    int base = row * t.k;
    int cm = 0, eq = 0, gt = 0, ev0 = 0, ev1 = 0;
    for (int j = 0; j < t.k; ++j) {
      int pj = clampi(base + j, 0, t.n_parents - 1);
      int ev = t.emb[pj];
      if (j == 0) ev0 = ev;
      if (j == 1) ev1 = ev;
      eq |= int(u == ev) << j;
      gt |= int(u > ev) << j;
      if (((need >> j) & 1) && conn(pj, ev)) cm |= 1 << j;
    }
    unsigned out = 0;
#pragma unroll
    for (int i = 0; i < kMaxBranches; ++i) {
      bool ok = ((live >> i) & 1)
                && (cm & b[i].required) == b[i].required
                && (cm & b[i].forbidden) == 0 && (eq & b[i].distinct) == 0
                && (gt & b[i].smaller) == b[i].smaller
                && (!b[i].first_pair || ev0 < ev1);
      out |= unsigned(ok) << i;
    }
    return Cand{row, u, out != 0, int(out)};
  }
};

// K1, the shared stage of all pruned kernels (port of _tile_enumerate):
// parent search, CSR gather, then the predicate with its connectivity
// probes in mode M, for one live slot.  Every pass calls this one
// function, so pass 2 replays pass 1.
template <int M, class P>
__device__ __forceinline__ Cand enumerate_slot(const Tables& t, int slot,
                                               const Pack& pk, const P& pred) {
  int p = parent_of(t.offsets, t.n_parents, slot);
  int row = p / t.k;
  int src_slot = p - row * t.k;
  int ptr = clampi(t.vlo[p] + (slot - t.starts[p]), 0, t.m - 1);
  int u = __ldg(t.col + ptr);
  auto conn = [&](int pj, int ev) -> bool {
    return ev >= 0 && probe<M>(t, pk, pj, ev, u);
  };
  return pred.eval(t, row, src_slot, u, conn);
}

__global__ void __launch_bounds__(kCandThreads)
extend_candidates_kernel(Tables t, int cand_cap, int* __restrict__ row_out,
                         int* __restrict__ u_out, int* __restrict__ slot_out,
                         int* __restrict__ conn_out) {
  int slot = blockIdx.x * kCandThreads + threadIdx.x;
  if (slot >= cand_cap) return;
  int p = parent_of(t.offsets, t.n_parents, slot);
  int row = p / t.k;
  int ptr = clampi(t.vlo[p] + (slot - t.starts[p]), 0, t.m - 1);
  int u = __ldg(t.col + ptr);
  int conn = 0;
  for (int j = 0; j < t.k; ++j) {
    int pj = clampi(row * t.k + j, 0, t.n_parents - 1);
    bool found = t.emb[pj] >= 0 && u >= 0
        && csr_contains(t.col, t.vlo[pj], t.vhi[pj], u);
    conn |= int(found) << j;
  }
  row_out[slot] = row;
  u_out[slot] = u;
  slot_out[slot] = p - row * t.k;
  conn_out[slot] = conn;
}

template <int M, class P>
__global__ void __launch_bounds__(kTile)
extend_count_kernel(Tables t, int cand_cap, Pack pk, P pred,
                    int* __restrict__ counts) {
  int slot = blockIdx.x * kTile + threadIdx.x;
  int total = t.offsets[t.n_parents - 1];
  bool keep = false;
  if (slot < cand_cap && slot < total)
    keep = enumerate_slot<M>(t, slot, pk, pred).keep;
  int cnt = __syncthreads_count(keep);
  if (threadIdx.x == 0) counts[blockIdx.x] = cnt;
}

// The lane-order exclusive rank of `keep` within the CTA's tile (stable
// compaction; port of _tile_compact, extend.py:296): a warp ballot, then a
// scan of the warp counts in warp 0.  `warp_base` is the caller's shared
// int[kWarps + 1]; `*count` gets the tile's survivors.  Every compacting
// kernel calls this one function, so their orders cannot drift apart.
__device__ __forceinline__ int tile_rank(bool keep, int* warp_base,
                                         int* count) {
  int lane = threadIdx.x & 31;
  int warp = threadIdx.x >> 5;
  unsigned ballot = __ballot_sync(0xffffffffu, keep);
  if (lane == 0) warp_base[warp] = __popc(ballot);
  __syncthreads();
  if (warp == 0) {
    int v = lane < kWarps ? warp_base[lane] : 0;
    int x = v;
    for (int d = 1; d < 32; d <<= 1) {
      int y = __shfl_up_sync(0xffffffffu, x, d);
      if (lane >= d) x += y;
    }
    if (lane < kWarps) warp_base[lane] = x - v;
    if (lane == kWarps - 1) warp_base[kWarps] = x;
  }
  __syncthreads();
  *count = warp_base[kWarps];
  return warp_base[warp] + __popc(ballot & ((1u << lane) - 1u));
}

template <int M, class P>
__global__ void __launch_bounds__(kTile)
extend_scatter_kernel(Tables t, int cand_cap, Pack pk, P pred,
                      const int* __restrict__ bases, int out_cap,
                      int* __restrict__ row_out, int* __restrict__ u_out,
                      int* __restrict__ state_out) {
  __shared__ int warp_base[kWarps + 1];
  int slot = blockIdx.x * kTile + threadIdx.x;
  int total = t.offsets[t.n_parents - 1];
  Cand c{0, -1, false, 0};
  if (slot < cand_cap && slot < total)
    c = enumerate_slot<M>(t, slot, pk, pred);
  int count;
  int r = tile_rank(c.keep, warp_base, &count);
  if (c.keep) {
    long long dest = (long long)bases[blockIdx.x] + r;
    if (dest < out_cap) {
      row_out[dest] = c.row;
      u_out[dest] = c.u;
      if constexpr (P::kWritesState) state_out[dest] = c.bits;
    }
  }
}

// A tile's status word: the flag in the high half, the survivor count in
// the low half, so one 64-bit store publishes both.
constexpr unsigned long long kAggregate = 1ull << 32;  // this tile's count
constexpr unsigned long long kInclusive = 2ull << 32;  // count of tiles 0..i

// The status words are read and written as relaxed 64-bit atomics at GPU
// scope: coherent across SMs, never torn, and nothing else is published
// through them, so no acquire/release ordering is needed.  (An acquire load
// in the spin also discards the SM's L1 lines, which the other CTAs' binary
// searches live on, and slowed the whole kernel down markedly.)
__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_status(unsigned long long* p,
                                             unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

// Decoupled look-back, run by warp 0 of tile `tile` whose survivors number
// `count`: publish the aggregate, then sum the predecessors' published
// values 32 tiles at a time, nearest first, up to and including the nearest
// inclusive prefix; publish this tile's inclusive prefix.  Returns the
// tile's exclusive base.  A lane waits only on a tile with a smaller ticket,
// which is running and publishes its aggregate before it waits on anyone.
__device__ int lookback(unsigned long long* status, int tile, int count) {
  int lane = threadIdx.x & 31;
  if (tile == 0) {
    if (lane == 0) store_status(status, kInclusive | (unsigned)count);
    return 0;
  }
  if (lane == 0) store_status(status + tile, kAggregate | (unsigned)count);
  int base = 0;
  for (int j = tile - 1;; j -= 32) {
    int i = j - lane;
    unsigned long long s = kInclusive;             // before tile 0: zero
    if (i >= 0) {
      do {
        s = load_status(status + i);
      } while ((s >> 32) == 0);
    }
    unsigned incl = __ballot_sync(0xffffffffu,
                                  (s >> 32) == (kInclusive >> 32));
    int stop = incl ? __ffs(incl) - 1 : 31;         // nearest inclusive lane
    int v = lane <= stop ? (int)(unsigned)s : 0;
    base += __reduce_add_sync(0xffffffffu, v);
    if (incl) break;
  }
  if (lane == 0)
    store_status(status + tile, kInclusive | (unsigned)(base + count));
  return base;
}

// Port of _pruned_extend_kernel (extend.py:322): enumerate, predicate and
// compact in one pass.  A CTA's tile is kItems1p consecutive 512-slot
// sub-tiles, each ranked by tile_rank (double-buffered, so one barrier per
// sub-tile suffices) and held in registers; one look-back per tile gives
// its base.  The tile that takes the last ticket writes the true survivor
// total (which may exceed out_cap: writes at dest >= out_cap are dropped,
// as in the pair).  `status` (n_tiles words) and `ticket` are zero at
// launch.
template <int M, class P>
__global__ void __launch_bounds__(kTile)
extend_pruned_1p_kernel(Tables t, int cand_cap, Pack pk, P pred, int out_cap,
                        unsigned long long* status, unsigned int* ticket,
                        int* __restrict__ row_out, int* __restrict__ u_out,
                        int* __restrict__ state_out,
                        int* __restrict__ n_surv) {
  __shared__ int warp_base[2][kWarps + 1];
  __shared__ int tile_s, base_s;
  if (threadIdx.x == 0) tile_s = (int)atomicAdd(ticket, 1u);
  __syncthreads();
  int tile = tile_s;
  int total = t.offsets[t.n_parents - 1];
  Cand c[kItems1p];
  int rank[kItems1p];
  int count = 0;
#pragma unroll
  for (int j = 0; j < kItems1p; ++j) {
    int slot = (tile * kItems1p + j) * kTile + threadIdx.x;
    c[j] = Cand{0, -1, false, 0};
    if (slot < cand_cap && slot < total)
      c[j] = enumerate_slot<M>(t, slot, pk, pred);
    int n;
    rank[j] = count + tile_rank(c[j].keep, warp_base[j & 1], &n);
    count += n;
  }
  if (threadIdx.x < 32) {
    int base = lookback(status, tile, count);
    if (threadIdx.x == 0) {
      base_s = base;
      if (tile == (int)gridDim.x - 1) *n_surv = base + count;
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kItems1p; ++j) {
    if (c[j].keep) {
      long long dest = (long long)base_s + rank[j];
      if (dest < out_cap) {
        row_out[dest] = c[j].row;
        u_out[dest] = c[j].u;
        if constexpr (P::kWritesState) state_out[dest] = c[j].bits;
      }
    }
  }
}

// The parent tables of an edge level: per slot-parent ([cap * (E+1)]) the
// prefix sums of candidate counts, the slot's vertex and its CSR row
// start; per row the E existing edge uids ([cap * E]); the CSR with the
// undirected uid of each directed edge; the endpoints of each uid.
struct EdgeTables {
  const int* offsets;   // inclusive prefix sum of per-slot counts
  const int* starts;    // exclusive prefix sum
  const int* slots;     // the slot's vertex
  const int* vlo;       // row_ptr[slot vertex]
  const int* col;       // CSR column array, [m]
  const int* edge_uid;  // undirected uid per directed edge, [m]
  const int* eids;      // existing edge uids, [cap * E]
  const int* usrc;      // uid endpoints, [n_uedges]
  const int* udst;
  const int* vmask;     // per-vertex eager toAdd mask, or null
  int n_parents;
  int m;
  int n_uedges;
  int n_vertices;
};

constexpr int kEdgeThreads = 256;

// Port of _edge_extend_kernel (extend.py:658): one thread per candidate
// slot.  A dead lane (slot past the total) keeps the last parent's row and
// s, with u = new_eid = -1 and add = 0, as the plain version does.
template <int E>
__global__ void __launch_bounds__(kEdgeThreads)
extend_edge_kernel(EdgeTables t, int cand_cap, int* __restrict__ row_out,
                   int* __restrict__ s_out, int* __restrict__ u_out,
                   int* __restrict__ eid_out, int* __restrict__ add_out) {
  constexpr int kSlots = E + 1;
  int slot = blockIdx.x * kEdgeThreads + threadIdx.x;
  if (slot >= cand_cap) return;
  // stage 1: parent search over the [cap * (E+1)] slot-parent table
  int p = parent_of(t.offsets, t.n_parents, slot);
  int row = p / kSlots;
  int s = p - row * kSlots;
  int u = -1, new_eid = -1, add = 0;
  if (slot < __ldg(t.offsets + t.n_parents - 1)) {
    // stage 2: candidate vertex and new edge uid from the CSR
    long long ptr = (long long)__ldg(t.vlo + p) + (slot - __ldg(t.starts + p));
    ptr = ptr < 0 ? 0 : (ptr > t.m - 1 ? t.m - 1 : ptr);
    u = __ldg(t.col + ptr);
    new_eid = __ldg(t.edge_uid + ptr);
    int w = __ldg(t.slots + p);                 // source vertex
    // stage 3: canonical-edge test against the row's E edges; a
    // neighbour is an edge sharing an endpoint with (w, u)
    int e_rows = t.n_parents / kSlots * E;
    long long base = (long long)row * E;
    int last_uid = t.n_uedges > 0 ? t.n_uedges - 1 : 0;
    int eid0 = __ldg(t.eids + (base < e_rows - 1 ? base : e_rows - 1));
    bool ok = new_eid > eid0;
    bool found = false;
#pragma unroll
    for (int j = 0; j < E; ++j) {
      long long ej = base + j < e_rows - 1 ? base + j : e_rows - 1;
      int eidj = __ldg(t.eids + ej);
      int ec = clampi(eidj, 0, last_uid);
      int es = __ldg(t.usrc + ec);
      int ed = __ldg(t.udst + ec);
      bool shares = w == es || w == ed || u == es || u == ed;
      ok = ok && !(found && new_eid < eidj);
      found = found || shares;
      ok = ok && new_eid != eidj;
    }
    bool keep = ok && found;
    // stage 4: the app's per-vertex eager toAdd mask
    if (keep && t.vmask != nullptr)
      keep = __ldg(t.vmask + clampi(u, 0, t.n_vertices - 1)) != 0;
    add = keep;
  }
  row_out[slot] = row;
  s_out[slot] = s;
  u_out[slot] = u;
  eid_out[slot] = new_eid;
  add_out[slot] = add;
}

Tables make_tables(const int* offsets, const int* starts, const int* emb,
                   const int* vlo, const int* vhi, const int* col,
                   int n_parents, int m, int k) {
  return Tables{offsets, starts, emb, vlo, vhi, col, n_parents, m, k};
}

// Whether `mode` is a probe mode and `pk` the pack it reads: bitmap needs
// the words; mixed also the vertex -> row map, 1 <= n_rows and
// 1 <= n_cols <= n_vertices with n_words covering n_cols.  Checked before
// any launch.
cudaError_t check_pack(int mode, const Pack& pk) {
  if (mode == kSearch) return cudaSuccess;
  if (mode != kBitmap && mode != kMixed) return cudaErrorInvalidValue;
  if (pk.bits == nullptr || pk.n_vertices < 1 || pk.n_words < 1)
    return cudaErrorInvalidValue;
  if (mode == kMixed
      && (pk.row_slot == nullptr || pk.n_rows < 1 || pk.n_cols < 1
          || pk.n_cols > pk.n_vertices
          || (long long)pk.n_words * 32 < pk.n_cols))
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

// Call launch(std::integral_constant<int, mode>{}) for a checked mode, so
// each mode is its own instantiation.
template <class F>
void with_mode(int mode, F&& launch) {
  if (mode == kBitmap) launch(std::integral_constant<int, kBitmap>{});
  else if (mode == kMixed) launch(std::integral_constant<int, kMixed>{});
  else launch(std::integral_constant<int, kSearch>{});
}

// Build the predicate a spec's host words describe (PredicateSpec.words(),
// CanonicalSpec.words(), BranchSetSpec.words() in repro_torch/core/api.py)
// and call launch(pred).  Words: kind, labeled, then for a conjunction
// required, forbidden, distinct, greater, src_slot_eq, label, lab0, lab1,
// and for a branch set n, then parent, anchor, required, forbidden,
// distinct, smaller, first_pair per branch.  A malformed spec, or one that
// lacks the state or labels it reads, is refused before any launch.
template <class F>
cudaError_t with_pred(const int* w, int n_words, const int* state,
                      const int* labels, int n_labels, int n_rows,
                      F&& launch) {
  if (n_words < 2) return cudaErrorInvalidValue;
  int kind = w[0];
  bool labeled = w[1] != 0;
  if (kind == kClique || kind == kConjunction) {
    if (n_words != 10) return cudaErrorInvalidValue;
    Spec spec{w[2], w[4], w[5], w[6]};
    if (kind == kClique) {
      if (labeled || w[3] != 0) return cudaErrorInvalidValue;
      launch(CliquePred{spec});
    } else if (labeled) {
      if (labels == nullptr || n_labels < 1) return cudaErrorInvalidValue;
      launch(ConjPred<true>{spec, w[3], w[7], w[8], w[9], labels, n_labels});
    } else {
      launch(ConjPred<false>{spec, w[3], -1, -1, -1, nullptr, 0});
    }
  } else if (kind == kCanonical) {
    if (n_words != 2 || labeled) return cudaErrorInvalidValue;
    launch(CanonPred{});
  } else if (kind == kBranches) {
    if (n_words < 3 || labeled || state == nullptr)
      return cudaErrorInvalidValue;
    BranchPred pred{};
    pred.n = w[2];
    if (pred.n < 1 || pred.n > kMaxBranches || n_words != 3 + 7 * pred.n)
      return cudaErrorInvalidValue;
    for (int i = 0; i < pred.n; ++i) {
      const int* x = w + 3 + 7 * i;
      if (x[0] < 0 || x[0] > 31) return cudaErrorInvalidValue;
      pred.b[i] = Branch{x[0], x[1], x[2], x[3], x[4], x[5], x[6]};
    }
    pred.state = state;
    pred.n_rows = n_rows;
    launch(pred);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* extend_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

int extend_candidates(const int* offsets, const int* starts, const int* emb,
                      const int* vlo, const int* vhi, const int* col,
                      int n_parents, int m, int k, int cand_cap, int* row,
                      int* u, int* src_slot, int* conn, void* stream) {
  Tables t = make_tables(offsets, starts, emb, vlo, vhi, col, n_parents, m, k);
  int blocks = (cand_cap + kCandThreads - 1) / kCandThreads;
  extend_candidates_kernel<<<blocks, kCandThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      t, cand_cap, row, u, src_slot, conn);
  return static_cast<int>(cudaGetLastError());
}

// The pruned entry points share their leading arguments: the parent
// tables and CSR, the pack (bits, row_slot), the state and labels, the
// sizes, the probe mode (kSearch, kBitmap, kMixed) with the pack's shape,
// and the spec's words.
#define PRUNED_PARAMS                                                       \
    const int *offsets, const int *starts, const int *emb, const int *vlo,  \
    const int *vhi, const int *col, const uint32_t *bits,                   \
    const int *row_slot, const int *state, const int *labels,               \
    int n_parents, int m, int k, int cand_cap, int conn_mode, int n_words,  \
    int n_vertices, int n_rows, int n_cols, int n_labels, const int *spec,  \
    int n_spec

int extend_count(PRUNED_PARAMS, int* counts, void* stream) {
  Tables t = make_tables(offsets, starts, emb, vlo, vhi, col, n_parents, m, k);
  Pack pk{bits, row_slot, n_words, n_vertices, n_rows, n_cols};
  if (cudaError_t e = check_pack(conn_mode, pk)) return static_cast<int>(e);
  int n_tiles = (cand_cap + kTile - 1) / kTile;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(with_pred(
      spec, n_spec, state, labels, n_labels, n_parents / k, [&](auto pred) {
        with_mode(conn_mode, [&](auto mode) {
          extend_count_kernel<decltype(mode)::value>
              <<<n_tiles, kTile, 0, st>>>(t, cand_cap, pk, pred, counts);
        });
      }));
}

int extend_scatter(PRUNED_PARAMS, const int* bases, int out_cap, int* row,
                   int* u, int* state_out, void* stream) {
  Tables t = make_tables(offsets, starts, emb, vlo, vhi, col, n_parents, m, k);
  Pack pk{bits, row_slot, n_words, n_vertices, n_rows, n_cols};
  if (cudaError_t e = check_pack(conn_mode, pk)) return static_cast<int>(e);
  int n_tiles = (cand_cap + kTile - 1) / kTile;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_spec > 0 && spec[0] == kBranches && state_out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(with_pred(
      spec, n_spec, state, labels, n_labels, n_parents / k, [&](auto pred) {
        with_mode(conn_mode, [&](auto mode) {
          extend_scatter_kernel<decltype(mode)::value>
              <<<n_tiles, kTile, 0, st>>>(t, cand_cap, pk, pred, bases,
                                          out_cap, row, u, state_out);
        });
      }));
}

int extend_pruned_1p(PRUNED_PARAMS, int out_cap, void* scratch, int* row,
                     int* u, int* state_out, int* n_surv, void* stream) {
  // scratch: n_tiles status words, then the ticket; both must start at
  // zero, or a stale status from the last launch corrupts the bases
  Tables t = make_tables(offsets, starts, emb, vlo, vhi, col, n_parents, m, k);
  Pack pk{bits, row_slot, n_words, n_vertices, n_rows, n_cols};
  if (cudaError_t e = check_pack(conn_mode, pk)) return static_cast<int>(e);
  int n_tiles = (cand_cap + kTile * kItems1p - 1) / (kTile * kItems1p);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_spec > 0 && spec[0] == kBranches && state_out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaMemsetAsync(scratch, 0, (size_t)(n_tiles + 1) * 8, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  unsigned long long* status = static_cast<unsigned long long*>(scratch);
  unsigned int* ticket = reinterpret_cast<unsigned int*>(status + n_tiles);
  return static_cast<int>(with_pred(
      spec, n_spec, state, labels, n_labels, n_parents / k, [&](auto pred) {
        with_mode(conn_mode, [&](auto mode) {
          extend_pruned_1p_kernel<decltype(mode)::value>
              <<<n_tiles, kTile, 0, st>>>(t, cand_cap, pk, pred, out_cap,
                                          status, ticket, row, u, state_out,
                                          n_surv);
        });
      }));
}

#undef PRUNED_PARAMS

int extend_edge(const int* offsets, const int* starts, const int* slots,
                const int* vlo, const int* col, const int* edge_uid,
                const int* eids, const int* usrc, const int* udst,
                const int* vmask, int n_parents, int m, int n_slots,
                int n_uedges, int n_vertices, int cand_cap, int* row, int* s,
                int* u, int* new_eid, int* add, void* stream) {
  EdgeTables t{offsets, starts, slots, vlo, col, edge_uid, eids, usrc, udst,
               vmask, n_parents, m, n_uedges, n_vertices};
  int blocks = (cand_cap + kEdgeThreads - 1) / kEdgeThreads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (n_slots - 1) {
#define EXTEND_EDGE_CASE(E)                                               \
    case E:                                                               \
      extend_edge_kernel<E><<<blocks, kEdgeThreads, 0, st>>>(             \
          t, cand_cap, row, s, u, new_eid, add);                          \
      break;
    EXTEND_EDGE_CASE(1)
    EXTEND_EDGE_CASE(2)
    EXTEND_EDGE_CASE(3)
    EXTEND_EDGE_CASE(4)
    EXTEND_EDGE_CASE(5)
    EXTEND_EDGE_CASE(6)
    EXTEND_EDGE_CASE(7)
#undef EXTEND_EDGE_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
