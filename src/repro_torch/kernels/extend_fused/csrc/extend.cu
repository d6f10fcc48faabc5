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
// What bounds them on an H100: none does arithmetic worth counting, and
// none waits on DRAM.  The compulsory traffic is the parent tables (5 x 4 B
// per parent slot), col_idx (3.6 MB at RMAT-16, which stays in the 50 MB
// L2) and the outputs: 16 B per slot for extend_candidates, 4 B per tile
// for extend_count, 8 B per survivor for extend_scatter (12 B with a
// state).  The pruned kernels take 15-600x that bound, bound by the
// instructions and the chains of dependent loads each slot takes (the
// parent search, the CSR gather, the predicate's probes) and each CTA's
// prologue: on an H100 80GB HBM3 at 700 W they enumerate 5-10e10 live
// slots/s, and the same launch costs 3-28% more in search mode than in
// mixed mode (a CSR search per probe against, mostly, one bitmap word), so
// the probes' searches are a part of the time, not its pace.  Hence the
// design of the pruned kernels:
//   the parent window  A CTA takes consecutive 512-slot tiles (eight in the
//                pair, four in extend_pruned_1p), whose live slots come
//                from a short run of parents: two warps
//                find its first and last parent by 32-way searches of the
//                prefix sum (log32 of cap*k dependent loads, once per CTA),
//                and the CTA stages the rows' parent tables
//                (offsets, starts, emb, vlo, vhi, a branch set's state) in
//                shared memory when they fit kWin entries.  Each slot finds
//                its parent by a short search of the window, and the
//                gather, the predicate and the probes read the parent
//                tables from there.  A longer span (many parents without
//                candidates between two live ones) is read from global
//                memory, each search bounded to the span: the same answers.
//                A hub whose candidates fill many tiles gives a window of
//                one row.  The CTA's prologue (the two searches, the
//                staging) costs a fifth to a third of a tile, so a window
//                serves several: on an H100 four tiles a window beat one,
//                and eight beat four by 5-9% in the pair; extend_pruned_1p
//                keeps four (eight doubles its survivor buffer and was
//                slower on the branch set at 3-MC's level 2).
//   the sliced branch set  See BranchPred: masks over the branches, so a
//                lane tests every branch at once and probes only the slots
//                a surviving branch still names.
// Only the slots below cand_cap and the true total are enumerated.
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
// depths, dead slots), so its CTA's four 512-slot tiles make one tile of
// the look-back: a quarter of the look-backs, and less spread in the time
// per tile.  Each survivor's (row, u[, state]) waits
// for the tile's base in shared memory at its rank, not in registers, so
// no thread holds a result through the look-back (32-40 registers, no
// spill), and the CTA writes its survivors out coalesced.
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
//                required/forbidden/distinct/smaller masks and first_pair,
//                evaluated as masks over the branches (BranchPred).  The
//                bitmap is the keep mask (!= 0) and the new state, which
//                extend_scatter and extend_pruned_1p compact through the
//                same tile_rank as row and u (8 B more per survivor: the
//                parent's state read, the new state written).
// Each kernel takes its predicate as a __grid_constant__ parameter, so a
// branch set's 58-word table is staged into shared memory from the
// parameter space without a copy to local memory.
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
// The enumerators, extend_candidates (K3) and extend_edge (K5, E a template
// parameter), write every slot below cand_cap: 16 B (K3) or 20 B (K5) a
// slot, which with the parent tables is their compulsory traffic and their
// bound.  Both take several 512-slot tiles a CTA under the pruned kernels'
// parent window (with_window; K5's slot-parents, E + 1 a row, as the parent
// tables, and a staged window also stages its rows' E edge uids and their
// endpoints, so the canonical-edge test reads shared memory).  On an H100
// K3 with sixteen tiles beat eight by 1-2% and four by 5-9%; K5's times
// with four, eight and sixteen lie within their run-to-run spread (it
// keeps eight), and its window gains 12-25% over each lane searching the
// whole prefix sum.  Both skip what a slot's position alone decides:
//   the dead tail  past the total every K5 slot carries the same constants
//                (the last parent's row and s, -1, -1, 0) and every K3 slot
//                the clipped last parent; once that parent's CSR pointer
//                reaches its clamp at m - 1 (uniform_from), every K3 output
//                is one constant too.  A CTA wholly in that tail evaluates
//                the one slot (K3: on one thread; K5: nothing) and only
//                stores it, as int4; the CTA that straddles the bound runs
//                per lane.
//                At the main paths' cand_caps, powers of two, the tail
//                holds 17-46% of the slots.
//   the source slot  K3's bit for the slot a candidate came from needs no
//                search when the CSR pointer lies inside that slot's own
//                row: u is then an entry of the row, which its search (the
//                rows are sorted) would find.  One of k searches goes.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kTile = 512;            // slots per tile, threads per CTA
constexpr int kWarps = kTile / 32;
constexpr int kPairTiles = 8;         // 512-slot tiles per CTA, the pair
constexpr int kPairSpan = kPairTiles * kTile;
constexpr int k1pTiles = 4;           // 512-slot tiles per CTA, 1p
constexpr int k1pSpan = k1pTiles * kTile;
constexpr int kCandTiles = 16;        // 512-slot tiles per CTA, candidates
constexpr int kCandSpan = kCandTiles * kTile;
constexpr int kEdgeTiles = 8;         // 512-slot tiles per CTA, edge
constexpr int kEdgeSpan = kEdgeTiles * kTile;
// Parent entries a CTA stages in shared memory: the flat parent indices of
// the rows its live slots (kPairTiles or k1pTiles tiles) come from, when
// they number at most this.
constexpr int kWin = 1024;

// The kinds of spec (KINDS in repro_torch/core/api.py).
enum Kind { kClique = 0, kConjunction = 1, kCanonical = 2, kBranches = 3 };

// A branch set's sliced table (BranchSetSpec.slices() in
// repro_torch/core/api.py), one 32-bit mask over the branches per word:
// first_pair, then P_b for each parent bit b (the branches whose parent is
// b), then per slot j < k the branches anchored at j, and those that
// require, forbid, are distinct from and exceed slot j.
constexpr int kMaxSlots = 5;          // parent width: MAX_PATTERN_SIZE - 1
constexpr int kTabFirstPair = 0;
constexpr int kTabParent = 1;
constexpr int kTabSlot = kTabParent + 32;
enum SlotMask { kAnchor = 0, kRequired, kForbidden, kDistinct, kSmaller,
                kSlotMasks };
constexpr int kTabWords = kTabSlot + kSlotMasks * kMaxSlots;

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
  const int* state;     // the parents' state, [n_rows] (a branch set's)
  int n_parents;
  int m;
  int k;
  int n_rows;
};

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
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

// ---------------------------------------------------------------------------
// The parent window.  A CTA's live slots [s0, s1) come from a contiguous run
// of parents, first..last (the parents of s0 and of s1 - 1), and their
// predicates read the rows first / k .. last / k.  Two warps find first and
// last with a 32-way search of the prefix sum; when the rows' entries number
// at most kWin, the CTA stages them (offsets, starts, emb, vlo, vhi, and a
// branch set's state) in shared memory, and each slot's parent search and
// every read of the parent tables after it go there.  A longer span (many
// parents without candidates between two live ones) is read from global
// memory, each search bounded to [first, last]: the same answer either way.

template <bool State>
struct Window {
  int off[kWin], sta[kWin], emb[kWin], vlo[kWin], vhi[kWin];
  int st[State ? kWin : 1];   // state of rows first / k ..
  unsigned tab[State ? kTabWords : 1];   // a branch set's sliced table
  int p_first, p_last;
};

// First p in [lo, hi) with a[p] > s, or hi if none; a sorted.  Run by a
// whole warp: each round reads 32 evenly spaced entries and keeps the part
// where the first of them above s lies, so a search of n entries takes
// log32(n) dependent loads where a thread's binary search takes log2(n).
__device__ __forceinline__ int warp_upper_bound(const int* __restrict__ a,
                                                int lo, int hi, int s) {
  const int lane = threadIdx.x & 31;
  while (hi - lo > 32) {
    int step = (hi - lo + 31) >> 5;
    int e = min(lo + (lane + 1) * step, hi) - 1;
    unsigned gt = __ballot_sync(0xffffffffu, __ldg(a + e) > s);
    if (!gt) return hi;
    int c = __ffs(gt) - 1;
    hi = min(lo + (c + 1) * step, hi);         // a[hi - 1] > s
    lo += c * step;
  }
  unsigned gt = __ballot_sync(0xffffffffu,
                              lo + lane < hi && __ldg(a + lo + lane) > s);
  return gt ? lo + __ffs(gt) - 1 : hi;
}

// The parent tables read from the window: entry i is flat index wb + i,
// row r's state entry r - rf.
template <bool State>
struct SmemView {
  const Window<State>* w;
  int wb, rf;

  // first p in [first, last] with offsets[p] > slot
  __device__ __forceinline__ int parent(int slot) const {
    int lo = w->p_first - wb, hi = w->p_last - wb;
    while (lo < hi) {
      int mid = (lo + hi) >> 1;
      if (w->off[mid] <= slot) lo = mid + 1; else hi = mid;
    }
    return lo + wb;
  }
  __device__ __forceinline__ int start(int p) const { return w->sta[p - wb]; }
  __device__ __forceinline__ int emb(int pj) const { return w->emb[pj - wb]; }
  __device__ __forceinline__ int vlo(int pj) const { return w->vlo[pj - wb]; }
  __device__ __forceinline__ int vhi(int pj) const { return w->vhi[pj - wb]; }
  __device__ __forceinline__ int state(int row) const {
    return w->st[row - rf];
  }
  __device__ __forceinline__ const unsigned* tab() const { return w->tab; }
};

// The same reads from global memory, indices clamped to the tables.
template <bool State>
struct GlobalView {
  const Tables& t;
  const Window<State>* w;
  int p_first, p_last;

  __device__ __forceinline__ int parent(int slot) const {
    int lo = p_first, hi = p_last;
    while (lo < hi) {
      int mid = (lo + hi) >> 1;
      if (__ldg(t.offsets + mid) <= slot) lo = mid + 1; else hi = mid;
    }
    return lo;
  }
  __device__ __forceinline__ int at(const int* a, int pj) const {
    return __ldg(a + clampi(pj, 0, t.n_parents - 1));
  }
  __device__ __forceinline__ int start(int p) const { return at(t.starts, p); }
  __device__ __forceinline__ int emb(int pj) const { return at(t.emb, pj); }
  __device__ __forceinline__ int vlo(int pj) const { return at(t.vlo, pj); }
  __device__ __forceinline__ int vhi(int pj) const { return at(t.vhi, pj); }
  __device__ __forceinline__ int state(int row) const {
    return __ldg(t.state + clampi(row, 0, t.n_rows - 1));
  }
  __device__ __forceinline__ const unsigned* tab() const { return w->tab; }
};

// Run body(view) for the CTA's slots [s0, s1), s0 < s1 (a slot past the
// total has the last parent), the view reading the window when the span
// fits it and global memory otherwise; the predicate's table is staged
// either way.  Every thread of the CTA calls it (it synchronises).
template <class P, bool State, class B>
__device__ __forceinline__ void with_window(const Tables& t, const P& pred,
                                            Window<State>& w, int s0, int s1,
                                            B&& body) {
  int warp = threadIdx.x >> 5;
  if (warp < 2) {
    int p = warp_upper_bound(t.offsets, 0, t.n_parents, warp ? s1 - 1 : s0);
    p = min(p, t.n_parents - 1);
    if ((threadIdx.x & 31) == 0) (warp ? w.p_last : w.p_first) = p;
  }
  pred.stage(w);
  __syncthreads();
  int rf = w.p_first / t.k, rl = w.p_last / t.k;
  int wb = rf * t.k, wl = (rl + 1) * t.k - wb;
  if (wl > kWin) {
    body(GlobalView<State>{t, &w, w.p_first, w.p_last});
    return;
  }
  for (int i = threadIdx.x; i < wl; i += blockDim.x) {
    int g = min(wb + i, t.n_parents - 1);
    w.off[i] = __ldg(t.offsets + g);
    w.sta[i] = __ldg(t.starts + g);
    w.emb[i] = __ldg(t.emb + g);
    w.vlo[i] = __ldg(t.vlo + g);
    w.vhi[i] = __ldg(t.vhi + g);
  }
  if constexpr (State) {
    for (int r = threadIdx.x; r <= rl - rf; r += blockDim.x)
      w.st[r] = __ldg(t.state + clampi(rf + r, 0, t.n_rows - 1));
  }
  __syncthreads();
  body(SmemView<State>{&w, wb, rf});
}

// Is u adjacent to the parent slot at flat index pj, whose vertex ev >= 0?
template <int M, class V>
__device__ __forceinline__ bool probe(const Tables& t, const V& v,
                                      const Pack& pk, int pj, int ev, int u) {
  if (M == kBitmap)
    return bitmap_contains(pk.bits, pk.n_words, pk.n_vertices,
                           clampi(ev, 0, pk.n_vertices - 1), u);
  if (M == kMixed) {
    int r = __ldg(pk.row_slot + clampi(ev, 0, pk.n_vertices - 1));
    if (r >= 0 && (pk.n_cols == pk.n_vertices || u < pk.n_cols))
      return bitmap_contains(pk.bits, pk.n_words, pk.n_cols,
                             r < pk.n_rows ? r : pk.n_rows - 1, u);
  }
  return csr_contains(t.col, v.vlo(pj), v.vhi(pj), u);
}

struct Cand {
  int row;
  int u;
  bool keep;
  int bits;         // a branch set's bitmap (the new state); 0 otherwise
};

// The predicates.  Each eval() gets the view of the parent tables, the
// parent width k, the lane's parent row, source slot and candidate, and
// conn(pj, ev): is u adjacent to the parent slot at flat index pj, whose
// vertex is ev (a bitmap bit or a CSR search, false for a dead slot).
// Every predicate probes only once u >= 0 is established (the plain
// version's connectivity bits also require it): the clique and
// conjunction test it first, the canonical test's u > emb_0 >= -1 implies
// it, and a branch set keeps no branch for u < 0.

struct CliquePred {
  static constexpr bool kWritesState = false;
  template <class W> __device__ void stage(W&) const {}
  Spec spec;

  template <class V, class F>
  __device__ __forceinline__ Cand eval(const V& v, int k, int row,
                                       int src_slot, int u, F conn) const {
    bool ok = u >= 0;
    if (spec.src_slot_eq >= 0) ok = ok && src_slot == spec.src_slot_eq;
    int base = row * k;
    for (int j = 0; j < k && ok; ++j) {
      int ev = v.emb(base + j);
      if ((spec.distinct >> j) & 1) ok = ok && u != ev;
      if ((spec.greater >> j) & 1) ok = ok && u > ev;
      if (ok && ((spec.required >> j) & 1)) ok = conn(base + j, ev);
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
  template <class W> __device__ void stage(W&) const {}
  Spec spec;
  int forbidden;
  int label, lab0, lab1;
  const int* labels;
  int n_labels;

  __device__ __forceinline__ int lab(int v) const {
    return __ldg(labels + clampi(v, 0, n_labels - 1));
  }

  template <class V, class F>
  __device__ __forceinline__ Cand eval(const V& v, int k, int row,
                                       int src_slot, int u, F conn) const {
    bool ok = u >= 0;
    int base = row * k;
    if (Labeled) {
      if (label >= 0) ok = ok && lab(u) == label;
      if (ok && lab0 >= 0)
        ok = lab(v.emb(base)) == lab0 && lab(v.emb(base + 1)) == lab1;
    }
    if (spec.src_slot_eq >= 0) ok = ok && src_slot == spec.src_slot_eq;
    for (int j = 0; j < k && ok; ++j) {
      int ev = v.emb(base + j);
      if ((spec.distinct >> j) & 1) ok = ok && u != ev;
      if ((spec.greater >> j) & 1) ok = ok && u > ev;
      bool rq = (spec.required >> j) & 1, fb = (forbidden >> j) & 1;
      if (ok && (rq || fb)) {
        bool c = conn(base + j, ev);
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
  template <class W> __device__ void stage(W&) const {}

  template <class V, class F>
  __device__ __forceinline__ Cand eval(const V& v, int k, int row,
                                       int src_slot, int u, F conn) const {
    int base = row * k;
    bool ok = u > v.emb(base);
    bool found = false;
    for (int j = 0; j < k && ok; ++j) {
      int ev = v.emb(base + j);
      ok = !(found && u < ev) && u != ev;
      if (!ok) break;
      bool adj = conn(base + j, ev);
      found = found || adj;
      ok = !(adj && j < src_slot);
    }
    return Cand{row, u, ok && found, 0};
  }
};

// A pattern-set trie level: up to 32 branches, sliced into masks over the
// branches (kTab*), which the CTA stages in shared memory, since lanes index
// them by their own state bits and source slot.  A lane keeps the branches
// whose parent bit its parent's state carries and which are anchored at its
// source slot (live), clears those that the cheap tests fail (u == emb_j
// for a distinct slot, u <= emb_j for a smaller one, first_pair), then
// probes slot j, in slot order, only while a surviving branch requires or
// forbids it, clearing the branches the answer fails; it stops once none
// survives.  A cleared bit never returns, and a slot that no surviving
// branch names changes no surviving bit, so the answer is every branch's
// conjunction, as the plain version evaluates it.
struct BranchPred {
  static constexpr bool kWritesState = true;
  unsigned tab[kTabWords];

  template <class W>
  __device__ __forceinline__ void stage(W& w) const {
    if (threadIdx.x < kTabWords) w.tab[threadIdx.x] = tab[threadIdx.x];
  }

  template <class V, class F>
  __device__ __forceinline__ Cand eval(const V& v, int k, int row,
                                       int src_slot, int u, F conn) const {
    if (u < 0) return Cand{row, u, false, 0};
    const unsigned* T = v.tab();
    unsigned live = 0;
    for (unsigned s = (unsigned)v.state(row); s; s &= s - 1)
      live |= T[kTabParent + __ffs(s) - 1];
    live &= T[kTabSlot + kSlotMasks * src_slot + kAnchor];
    if (!live) return Cand{row, u, false, 0};
    int base = row * k;
    int ev[kMaxSlots] = {0, 0, 0, 0, 0};
    unsigned out = live;
#pragma unroll
    for (int j = 0; j < kMaxSlots; ++j) {
      if (j < k) {
        const unsigned* S = T + kTabSlot + kSlotMasks * j;
        ev[j] = v.emb(base + j);
        if (u == ev[j]) out &= ~S[kDistinct];
        if (!(u > ev[j])) out &= ~S[kSmaller];
      }
    }
    if (!(ev[0] < ev[1])) out &= ~T[kTabFirstPair];
#pragma unroll
    for (int j = 0; j < kMaxSlots; ++j) {
      if (j < k && out) {
        const unsigned* S = T + kTabSlot + kSlotMasks * j;
        unsigned rq = S[kRequired], fb = S[kForbidden];
        if (out & (rq | fb)) out &= conn(base + j, ev[j]) ? ~fb : ~rq;
      }
    }
    return Cand{row, u, out != 0, int(out)};
  }
};

// K1, the shared stage of all pruned kernels (port of _tile_enumerate):
// parent search, CSR gather, then the predicate with its connectivity
// probes in mode M, for one live slot, reading the parent tables through
// view v.  Every pass calls this one function, so pass 2 replays pass 1.
template <int M, class V, class P>
__device__ __forceinline__ Cand enumerate_slot(const Tables& t, const V& v,
                                               int slot, const Pack& pk,
                                               const P& pred) {
  int p = v.parent(slot);
  int row = p / t.k;
  int src_slot = p - row * t.k;
  int ptr = clampi(v.vlo(p) + (slot - v.start(p)), 0, t.m - 1);
  int u = __ldg(t.col + ptr);
  auto conn = [&](int pj, int ev) -> bool {
    return ev >= 0 && probe<M>(t, v, pk, pj, ev, u);
  };
  return pred.eval(v, t.k, row, src_slot, u, conn);
}

// extend_candidates evaluates no predicate: its window stages the parent
// tables alone.
struct Unpruned {
  template <class W> __device__ void stage(W&) const {}
};

// Port of _fused_extend_kernel (extend.py:65), one slot through view v:
// (row, u, src_slot, conn), conn's bit j set when u lies in the CSR row of
// the parent's slot j.
template <class V>
__device__ __forceinline__ int4 candidate(const Tables& t, const V& v,
                                          int slot) {
  int p = v.parent(slot);
  int row = p / t.k;
  int src = p - row * t.k;
  int lo = v.vlo(p);
  int raw = lo + (slot - v.start(p));
  int ptr = clampi(raw, 0, t.m - 1);
  int u = __ldg(t.col + ptr);
  // when the pointer lies inside the source slot's own CSR row, u is an
  // entry of that row, which its search (the rows are sorted) would find:
  // that bit needs no search
  bool own = raw == ptr && lo <= raw && raw < v.vhi(p);
  int conn = 0;
  for (int j = 0; j < t.k; ++j) {
    int pj = row * t.k + j;
    bool found = v.emb(pj) >= 0 && u >= 0
        && ((j == src && own)
            || csr_contains(t.col, v.vlo(pj), v.vhi(pj), u));
    conn |= int(found) << j;
  }
  return make_int4(row, u, src, conn);
}

// The first slot from which every output of extend_candidates is one
// constant.  Past the total, every slot's parent is the last, p =
// n_parents - 1, and its CSR pointer vlo[p] + slot - starts[p] grows with
// the slot until the clamp holds it at m - 1: from there on row, u =
// col[m - 1], src_slot and conn no longer depend on the slot.
__device__ __forceinline__ long long uniform_from(const Tables& t) {
  int p = t.n_parents - 1;
  long long total = __ldg(t.offsets + p);
  long long clamped = (long long)__ldg(t.starts + p) + (t.m - 1)
      - __ldg(t.vlo + p);
  return total > clamped ? total : clamped;
}

// out[s0, s1) = x, by the CTA: int4 stores, then a scalar tail.  out + s0
// is 16-byte aligned: s0 is a multiple of the CTA's span, and the wrappers
// allocate every output.
__device__ __forceinline__ void fill(int* out, int s0, int s1, int x) {
  int n4 = (s1 - s0) >> 2;
  int4* o4 = reinterpret_cast<int4*>(out + s0);
  for (int i = threadIdx.x; i < n4; i += blockDim.x)
    o4[i] = make_int4(x, x, x, x);
  int b = s0 + 4 * n4;
  if (b + (int)threadIdx.x < s1) out[b + threadIdx.x] = x;
}

// K3: a CTA takes kCandTiles consecutive 512-slot tiles under one parent
// window, one slot per thread and tile; every slot below cand_cap is
// written, those past the true total with the clipped last parent's
// values, as the plain version writes them.  A CTA wholly in the uniform
// tail (uniform_from) evaluates that one slot on one thread and only
// stores it.
// repro: grid[concurrent]
__global__ void __launch_bounds__(kTile)
extend_candidates_kernel(Tables t, int cand_cap, int* __restrict__ row_out,
                         int* __restrict__ u_out, int* __restrict__ slot_out,
                         int* __restrict__ conn_out) {
  __shared__ Window<false> w;
  __shared__ int4 tail;
  int s0 = blockIdx.x * kCandSpan;
  int s1 = min(cand_cap, s0 + kCandSpan);
  if (s0 >= uniform_from(t)) {
    if (threadIdx.x == 0) {
      int p = t.n_parents - 1;
      tail = candidate(t, GlobalView<false>{t, &w, p, p}, s0);
    }
    __syncthreads();
    fill(row_out, s0, s1, tail.x);
    fill(u_out, s0, s1, tail.y);
    fill(slot_out, s0, s1, tail.z);
    fill(conn_out, s0, s1, tail.w);
    return;
  }
  with_window(t, Unpruned{}, w, s0, s1, [&](const auto& v) {
    for (int slot = s0 + threadIdx.x; slot < s1; slot += kTile) {
      int4 c = candidate(t, v, slot);
      row_out[slot] = c.x;
      u_out[slot] = c.y;
      slot_out[slot] = c.z;
      conn_out[slot] = c.w;
    }
  });
}

// The end of the live slots of the CTA whose first slot is s0 and which
// covers `span` slots: below cand_cap and the true total.
__device__ __forceinline__ int live_end(const Tables& t, int cand_cap,
                                        int s0, int span) {
  int total = __ldg(t.offsets + t.n_parents - 1);
  return min(min(cand_cap, total), s0 + span);
}

// Pass 1: the survivors of each 512-slot tile.  A CTA takes kPairTiles
// consecutive tiles under one parent window, one slot per thread and tile.
template <int M, class P>
// repro: grid[concurrent]
__global__ void __launch_bounds__(kTile)
extend_count_kernel(Tables t, int cand_cap, Pack pk,
                    const __grid_constant__ P pred,
                    int* __restrict__ counts) {
  __shared__ Window<P::kWritesState> w;
  int s0 = blockIdx.x * kPairSpan;
  int s1 = live_end(t, cand_cap, s0, kPairSpan);
  int tile0 = blockIdx.x * kPairTiles;
  int n_tiles = min(kPairTiles, (cand_cap + kTile - 1) / kTile - tile0);
  if (s0 >= s1) {                         // no live slot: every count 0
    if ((int)threadIdx.x < n_tiles) counts[tile0 + threadIdx.x] = 0;
    return;
  }
  with_window(t, pred, w, s0, s1, [&](const auto& v) {
    for (int j = 0; j < n_tiles; ++j) {
      int slot = s0 + j * kTile + threadIdx.x;
      bool keep = slot < s1 && enumerate_slot<M>(t, v, slot, pk, pred).keep;
      int cnt = __syncthreads_count(keep);
      if (threadIdx.x == 0) counts[tile0 + j] = cnt;
    }
  });
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

// Pass 2: tile i's survivors at bases[i] + their rank in the tile, the
// tiles taken as in pass 1.
template <int M, class P>
// repro: grid[concurrent]
__global__ void __launch_bounds__(kTile)
extend_scatter_kernel(Tables t, int cand_cap, Pack pk,
                      const __grid_constant__ P pred,
                      const int* __restrict__ bases, int out_cap,
                      int* __restrict__ row_out, int* __restrict__ u_out,
                      int* __restrict__ state_out) {
  __shared__ Window<P::kWritesState> w;
  __shared__ int warp_base[2][kWarps + 1];
  int s0 = blockIdx.x * kPairSpan;
  int s1 = live_end(t, cand_cap, s0, kPairSpan);
  if (s0 >= s1) return;                   // no live slot, no survivor
  with_window(t, pred, w, s0, s1, [&](const auto& v) {
    for (int j = 0; j < kPairTiles && s0 + j * kTile < s1; ++j) {
      int slot = s0 + j * kTile + threadIdx.x;
      Cand c{0, -1, false, 0};
      if (slot < s1) c = enumerate_slot<M>(t, v, slot, pk, pred);
      int count;
      int r = tile_rank(c.keep, warp_base[j & 1], &count);
      if (c.keep) {
        long long dest = (long long)bases[blockIdx.x * kPairTiles + j] + r;
        if (dest < out_cap) {
          row_out[dest] = c.row;
          u_out[dest] = c.u;
          if constexpr (P::kWritesState) state_out[dest] = c.bits;
        }
      }
    }
  });
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
// compact in one pass.  A CTA's tile is k1pTiles consecutive 512-slot
// sub-tiles under one parent window, each ranked by tile_rank
// (double-buffered, so one barrier per sub-tile suffices); each survivor's
// (row, u[, state]) goes to shared memory at its rank in the tile, so no
// thread holds a result through the look-back.  One look-back per tile
// gives its base, and the CTA copies its survivors to base + rank,
// coalesced.  The tile that takes the last ticket writes the true
// survivor total (which may exceed out_cap: writes at dest >= out_cap are
// dropped, as in the pair).  `status` (n_tiles words) and `ticket` are
// zero at launch; the survivors take surv_bytes<P>() of dynamic shared
// memory.
template <class P>
constexpr int surv_bytes() {
  return (P::kWritesState ? 3 : 2) * k1pSpan * (int)sizeof(int);
}

template <int M, class P>
// repro: grid[lookback]
__global__ void __launch_bounds__(kTile)
extend_pruned_1p_kernel(Tables t, int cand_cap, Pack pk,
                        const __grid_constant__ P pred, int out_cap,
                        unsigned long long* status, unsigned int* ticket,
                        int* __restrict__ row_out, int* __restrict__ u_out,
                        int* __restrict__ state_out,
                        int* __restrict__ n_surv) {
  __shared__ Window<P::kWritesState> w;
  __shared__ int warp_base[2][kWarps + 1];
  __shared__ int tile_s, base_s;
  extern __shared__ int surv[];   // row, u[, state]: k1pSpan entries each
  if (threadIdx.x == 0) tile_s = (int)atomicAdd(ticket, 1u);
  __syncthreads();
  int tile = tile_s;
  int s0 = tile * k1pSpan;
  int s1 = live_end(t, cand_cap, s0, k1pSpan);
  int count = 0;
  if (s0 < s1) {
    with_window(t, pred, w, s0, s1, [&](const auto& v) {
      for (int j = 0; j < k1pTiles && s0 + j * kTile < s1; ++j) {
        int slot = s0 + j * kTile + threadIdx.x;
        Cand c{0, -1, false, 0};
        if (slot < s1) c = enumerate_slot<M>(t, v, slot, pk, pred);
        int n;
        int r = count + tile_rank(c.keep, warp_base[j & 1], &n);
        if (c.keep) {
          surv[r] = c.row;
          surv[k1pSpan + r] = c.u;
          if constexpr (P::kWritesState) surv[2 * k1pSpan + r] = c.bits;
        }
        count += n;
      }
    });
  }
  if (threadIdx.x < 32) {
    int base = lookback(status, tile, count);
    if (threadIdx.x == 0) {
      base_s = base;
      if (tile == (int)gridDim.x - 1) *n_surv = base + count;
    }
  }
  __syncthreads();
  int base = base_s;
  for (int i = threadIdx.x; i < count; i += kTile) {
    long long dest = (long long)base + i;
    if (dest >= out_cap) break;
    row_out[dest] = surv[i];
    u_out[dest] = surv[k1pSpan + i];
    if constexpr (P::kWritesState) state_out[dest] = surv[2 * k1pSpan + i];
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

// A row's E edge uids from global memory, each index clamped to the eids
// table, and their endpoints, each uid clamped to the endpoint tables, as
// the plain version gathers them.
template <int E>
struct EdgeGlobal {
  const EdgeTables& t;

  __device__ __forceinline__ int eid(int row, int j) const {
    long long e_rows = (long long)(t.n_parents / (E + 1)) * E;
    long long e = (long long)row * E + j;
    return __ldg(t.eids + (e < e_rows - 1 ? e : e_rows - 1));
  }
  __device__ __forceinline__ int end(const int* a, int e) const {
    return __ldg(a + clampi(e, 0, t.n_uedges > 0 ? t.n_uedges - 1 : 0));
  }
  __device__ __forceinline__ int src(int row, int j) const {
    return end(t.usrc, eid(row, j));
  }
  __device__ __forceinline__ int dst(int row, int j) const {
    return end(t.udst, eid(row, j));
  }
};

// The same for the rows of a parent window, staged in shared memory: edge
// j of row r at (r - rf) * E + j.  The window's rows hold at most kWin
// slot-parents, E + 1 a row, so their edges fit.
struct EdgeRows {
  int eid[kWin], src[kWin], dst[kWin];
};

template <int E>
struct EdgeSmem {
  const EdgeRows* r;
  int rf;

  __device__ __forceinline__ int eid(int row, int j) const {
    return r->eid[(row - rf) * E + j];
  }
  __device__ __forceinline__ int src(int row, int j) const {
    return r->src[(row - rf) * E + j];
  }
  __device__ __forceinline__ int dst(int row, int j) const {
    return r->dst[(row - rf) * E + j];
  }
};

// One slot's outputs of extend_edge.
struct EdgeOut {
  int row, s, u, eid, add;
};

// Port of _edge_extend_kernel (extend.py:658) for one live slot: the
// slot-parent from view v (the parent window over K5's slot-parents), the
// row's edges from r.
template <int E, class V, class R>
__device__ __forceinline__ EdgeOut edge_slot(const EdgeTables& t,
                                             const V& v, const R& r,
                                             int slot) {
  constexpr int kSlots = E + 1;
  // stage 1: the slot-parent, from the window's search
  int p = v.parent(slot);
  int row = p / kSlots;
  // stage 2: candidate vertex and new edge uid from the CSR
  long long ptr = (long long)v.vlo(p) + (slot - v.start(p));
  ptr = ptr < 0 ? 0 : (ptr > t.m - 1 ? t.m - 1 : ptr);
  int u = __ldg(t.col + ptr);
  int new_eid = __ldg(t.edge_uid + ptr);
  int w = v.emb(p);                           // source vertex
  // stage 3: canonical-edge test against the row's E edges; a neighbour
  // is an edge sharing an endpoint with (w, u)
  bool ok = new_eid > r.eid(row, 0);
  bool found = false;
#pragma unroll
  for (int j = 0; j < E; ++j) {
    int eidj = r.eid(row, j);
    int es = r.src(row, j), ed = r.dst(row, j);
    bool shares = w == es || w == ed || u == es || u == ed;
    ok = ok && !(found && new_eid < eidj);
    found = found || shares;
    ok = ok && new_eid != eidj;
  }
  bool keep = ok && found;
  // stage 4: the app's per-vertex eager toAdd mask
  if (keep && t.vmask != nullptr)
    keep = __ldg(t.vmask + clampi(u, 0, t.n_vertices - 1)) != 0;
  return EdgeOut{row, p - row * kSlots, u, new_eid, keep};
}

// K5: a CTA takes kEdgeTiles consecutive 512-slot tiles under one parent
// window, with_window over the slot-parents as K3's parent tables (E + 1 a
// row, emb the slot vertices), one slot per thread and tile.  A window
// staged in shared memory also stages its rows' E edges with their
// endpoints (EdgeRows), so the canonical-edge test reads shared memory.  A
// dead lane (slot past the total) keeps the last parent's row and s, with
// u = new_eid = -1 and add = 0, as the plain version does: constants,
// which need no search, and which a CTA wholly past the total only stores.
template <int E>
// repro: grid[concurrent]
__global__ void __launch_bounds__(kTile)
extend_edge_kernel(EdgeTables t, int cand_cap, int* __restrict__ row_out,
                   int* __restrict__ s_out, int* __restrict__ u_out,
                   int* __restrict__ eid_out, int* __restrict__ add_out) {
  constexpr int kSlots = E + 1;
  __shared__ Window<false> w;
  __shared__ EdgeRows rows;
  int s0 = blockIdx.x * kEdgeSpan;
  int s1 = min(cand_cap, s0 + kEdgeSpan);
  int total = __ldg(t.offsets + t.n_parents - 1);
  int last = t.n_parents - 1;
  const EdgeOut dead{last / kSlots, last % kSlots, -1, -1, 0};
  int live = min(s1, total);
  if (s0 >= live) {
    fill(row_out, s0, s1, dead.row);
    fill(s_out, s0, s1, dead.s);
    fill(u_out, s0, s1, dead.u);
    fill(eid_out, s0, s1, dead.eid);
    fill(add_out, s0, s1, dead.add);
    return;
  }
  auto slots = [&](const auto& v, const auto& r) {
    for (int slot = s0 + threadIdx.x; slot < s1; slot += kTile) {
      EdgeOut o = slot < live ? edge_slot<E>(t, v, r, slot) : dead;
      row_out[slot] = o.row;
      s_out[slot] = o.s;
      u_out[slot] = o.u;
      eid_out[slot] = o.eid;
      add_out[slot] = o.add;
    }
  };
  Tables pt{t.offsets, t.starts, t.slots, t.vlo, t.vlo, t.col, nullptr,
            t.n_parents, t.m, kSlots, 0};
  with_window(pt, Unpruned{}, w, s0, live, [&](const auto& v) {
    using View = std::decay_t<decltype(v)>;
    if constexpr (std::is_same_v<View, SmemView<false>>) {
      EdgeGlobal<E> g{t};
      int n = (w.p_last / kSlots - v.rf + 1) * E;
      for (int i = threadIdx.x; i < n; i += blockDim.x) {
        int e = g.eid(v.rf + i / E, i % E);
        rows.eid[i] = e;
        rows.src[i] = g.end(t.usrc, e);
        rows.dst[i] = g.end(t.udst, e);
      }
      __syncthreads();
      slots(v, EdgeSmem<E>{&rows, v.rf});
    } else {
      slots(v, EdgeGlobal<E>{t});
    }
  });
}

Tables make_tables(const int* offsets, const int* starts, const int* emb,
                   const int* vlo, const int* vhi, const int* col,
                   const int* state, int n_parents, int m, int k) {
  return Tables{offsets, starts, emb, vlo, vhi, col, state, n_parents, m, k,
                k > 0 ? n_parents / k : 0};
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
cudaError_t with_pred(const int* w, int n_words, const Tables& t,
                      const int* labels, int n_labels, F&& launch) {
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
    // n, k, then the sliced table; every mask within the n branches
    if (n_words < 4 || labeled || t.state == nullptr)
      return cudaErrorInvalidValue;
    int n = w[2];
    if (n < 1 || n > 32 || w[3] != t.k || t.k < 1 || t.k > kMaxSlots
        || n_words != 4 + kTabSlot + kSlotMasks * t.k)
      return cudaErrorInvalidValue;
    unsigned valid = n == 32 ? ~0u : (1u << n) - 1u;
    BranchPred pred{};
    for (int i = 0; i < n_words - 4; ++i) {
      unsigned x = static_cast<unsigned>(w[4 + i]);
      if (x & ~valid) return cudaErrorInvalidValue;
      pred.tab[i] = x;
    }
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
  Tables t = make_tables(offsets, starts, emb, vlo, vhi, col, nullptr,
                         n_parents, m, k);
  int blocks = (cand_cap + kCandSpan - 1) / kCandSpan;
  extend_candidates_kernel<<<blocks, kTile, 0,
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
  Tables t = make_tables(offsets, starts, emb, vlo, vhi, col, state,
                         n_parents, m, k);
  Pack pk{bits, row_slot, n_words, n_vertices, n_rows, n_cols};
  if (cudaError_t e = check_pack(conn_mode, pk)) return static_cast<int>(e);
  int n_ctas = (cand_cap + kPairSpan - 1) / kPairSpan;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(with_pred(
      spec, n_spec, t, labels, n_labels, [&](auto pred) {
        with_mode(conn_mode, [&](auto mode) {
          extend_count_kernel<decltype(mode)::value>
              <<<n_ctas, kTile, 0, st>>>(t, cand_cap, pk, pred, counts);
        });
      }));
}

int extend_scatter(PRUNED_PARAMS, const int* bases, int out_cap, int* row,
                   int* u, int* state_out, void* stream) {
  Tables t = make_tables(offsets, starts, emb, vlo, vhi, col, state,
                         n_parents, m, k);
  Pack pk{bits, row_slot, n_words, n_vertices, n_rows, n_cols};
  if (cudaError_t e = check_pack(conn_mode, pk)) return static_cast<int>(e);
  int n_ctas = (cand_cap + kPairSpan - 1) / kPairSpan;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_spec > 0 && spec[0] == kBranches && state_out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(with_pred(
      spec, n_spec, t, labels, n_labels, [&](auto pred) {
        with_mode(conn_mode, [&](auto mode) {
          extend_scatter_kernel<decltype(mode)::value>
              <<<n_ctas, kTile, 0, st>>>(t, cand_cap, pk, pred, bases,
                                          out_cap, row, u, state_out);
        });
      }));
}

int extend_pruned_1p(PRUNED_PARAMS, int out_cap, void* scratch, int* row,
                     int* u, int* state_out, int* n_surv, void* stream) {
  // scratch: n_tiles status words, then the ticket; both must start at
  // zero, or a stale status from the last launch corrupts the bases
  Tables t = make_tables(offsets, starts, emb, vlo, vhi, col, state,
                         n_parents, m, k);
  Pack pk{bits, row_slot, n_words, n_vertices, n_rows, n_cols};
  if (cudaError_t e = check_pack(conn_mode, pk)) return static_cast<int>(e);
  int n_tiles = (cand_cap + k1pSpan - 1) / k1pSpan;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_spec > 0 && spec[0] == kBranches && state_out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaMemsetAsync(scratch, 0, (size_t)(n_tiles + 1) * 8, st);
  if (e != cudaSuccess) return static_cast<int>(e);
  unsigned long long* status = static_cast<unsigned long long*>(scratch);
  unsigned int* ticket = reinterpret_cast<unsigned int*>(status + n_tiles);
  return static_cast<int>(with_pred(
      spec, n_spec, t, labels, n_labels, [&](auto pred) {
        using P = decltype(pred);
        with_mode(conn_mode, [&](auto mode) {
          auto kernel = extend_pruned_1p_kernel<decltype(mode)::value, P>;
          cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               surv_bytes<P>());
          kernel<<<n_tiles, kTile, surv_bytes<P>(), st>>>(
              t, cand_cap, pk, pred, out_cap, status, ticket, row, u,
              state_out, n_surv);
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
  int blocks = (cand_cap + kEdgeSpan - 1) / kEdgeSpan;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (n_slots - 1) {
#define EXTEND_EDGE_CASE(E)                                               \
    case E:                                                               \
      extend_edge_kernel<E><<<blocks, kTile, 0, st>>>(                    \
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
