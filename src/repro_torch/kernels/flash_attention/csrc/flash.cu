// Flash attention for Hopper (sm_90a): the CUDA C++ port of the Pallas kernel
// in repro/kernels/flash_attention/flash.py (_flash_kernel /
// flash_attention_pallas).
//
//   flash_attention   o = softmax(q k^T * sm_scale, masked) v per (batch,
//                     query head), online softmax over key tiles; causal
//                     with the queries at the end of the key sequence
//                     (off = lk - lq), GQA (key/value head h / group serves
//                     query head h), f32 or bf16 in, f32 sums, the output
//                     in the input's type
//
// Plain C interface (bound with ctypes): launches on the stream it is
// given, allocates nothing, never synchronises, and returns
// cudaGetLastError() (or kEncodeFailed for a tensor map the driver
// refused) so the caller sees a refused launch.
//
// Two variants, chosen by the input's type and by nothing else:
//
// bf16: flash_tc, on the tensor cores.  What bounds it on an H100:
// operations.  At Qwen3-0.6B's prefill (16 query heads, d_head 128, 4096
// tokens) a query head does 4 * d * (causal pairs) = 4.3 GFLOP while it
// reads q, k and v and writes o, 4 MB in bf16: over 1,000 flops per byte,
// far above the card's 295 bf16 flops per byte.  So the products go to
// wgmma, the only way to the card's bf16 rate, and everything else is
// arranged to keep it fed:
//   - A CTA of three warpgroups owns 128 query rows of one (batch, query
//     head).  Warpgroup 0 is the producer: one thread issues every copy, and
//     setmaxnreg gives its registers to the two consumer warpgroups, which
//     own 64 rows each.  (The alternative, 64 rows of each head of a GQA
//     group sharing one K/V tile, would tie the CTA's shape to the group;
//     128 rows of one head takes any group, and K/V tiles are read from L2
//     by the group's CTAs.)  The consumers share the K/V ring and run
//     unsynchronised, so one's softmax overlaps the other's products.
//   - Copies are TMA loads (cp.async.bulk.tensor.3d) through 3-D tensor
//     maps over [b*h, l, d], so a box past lq or lk is zero-filled by the
//     hardware and never reads the next head.  Rows are 128-byte swizzled
//     (64-byte at d = 32), the layout wgmma reads without bank conflicts;
//     a d = 128 tile is two 64-column boxes.  Completion is counted in
//     bytes on mbarriers: Q once, then a ring of kStages K and V stages
//     (K and V with a barrier each, so S = Q K^T starts before V lands),
//     each stage released by the 8 consumer warps.
//   - S = Q K^T is wgmma.mma_async m64n128k16 with both operands in shared
//     memory (Q and K are both K-major, nothing is transposed).  bf16 x
//     bf16 products are exact in the f32 accumulator.
//   - The online softmax runs in registers on the accumulator's layout: a
//     row's 128 scores sit in 4 threads (a quad), reduced with 2 shuffles.
//     Only tiles that cross the diagonal or the ragged lk edge are masked.
//   - O += P V is wgmma m64n{d}k16 with P from registers (the f32
//     accumulator of S maps onto the A fragment of the k16 slices, 8 values
//     a thread a slice) and V in shared memory through the transposed-B bit
//     (V is [keys, d], N-major).  P is split into two bf16 halves, P_hi =
//     bf16(p) and P_lo = bf16(p - P_hi), and O += P_hi V + P_lo V: a single
//     bf16 P would err by about 2^-9 / sqrt(n) of |v|, past assert_close's
//     bf16 tolerance (atol 1e-5) wherever an output is near zero; the two
//     halves carry p to about 2^-17.  This costs 1.5x the tensor work of a
//     kernel with one bf16 P.  l sums the f32 p, not the halves.
//   - Each tile's P V goes into a fresh wgmma accumulator (16 k16 steps)
//     and is added to O on the FMA pipes, O = O * alpha + PV, rounded to
//     nearest.  The tensor cores' f32 additions truncate: with O kept in
//     their accumulator across all 256 tiles of a 32k prompt, the drift of
//     the large running sums passed the bf16 atol on near-zero outputs;
//     one tile's sum is small, and its truncation errors cancel across
//     tiles.
//   - The epilogue divides O by l in f32 (l == 0 divides by 1), rounds once
//     to bf16 and stores rows < lq with 4-byte stores.
//   Shared memory at d = 128: Q 32 KB and kStages = 2 stages of 128-key K
//   and V tiles (128 KB), 161 KB a CTA, one CTA an SM.  The grid's slowest
//   dimension is the query tile, longest rows (most key tiles) first.
//
// f32: flash_fma.  What bounds it on an H100: operations.  On the FMA
// pipes, 4 d flops a (query, key) pair at 67 TFLOP/s, but shared memory
// feeds an SM 32 words a clock against 128 FMAs, and a 16-byte load costs
// 16 bytes a thread even where lanes share the address: a first design on
// the FMA pipes, S as 8 x 4 and O as 8 x 8 a thread, reached 0.55 of that
// bound (PERF.md).  No one-pass tensor-core product holds f32's
// 2e-5, so the products are 3xTF32 (hi hi + hi lo + lo hi, each operand
// split into two tf32 halves) on mma.sync m16n8k8: three products at
// 495 TFLOP/s are 0.41 of the FMA pipes' time.  And Qwen3's 1 x 512 f32
// prefill layer is 1.08 GFLOP in 8 x 16 = 128 tiles of 64 query rows,
// 1-8 key tiles long when causal.  So:
//   - A work list cut on the host (ops.fma_plan): where the (batch, head,
//     query tile)s number fewer than two CTAs an SM (264), each tile's key
//     range is cut into chunks of nearly equal numbers of 64-key tiles, so
//     that the list holds at least 264 items wherever the work allows, and
//     items run longest first (the grid's slowest dimension is the item,
//     the same for every head; the list is copied to the device once a
//     shape and read from there, so a call makes no copy and no sync).  A tile with more than one chunk writes its
//     chunks' running max m (log2 domain), sum l and unnormalised 64 x d
//     accumulator to an f32 workspace, and flash_fma_merge adds them in
//     chunk order: exp2(m_c - max m) weights, then / l.  No atomics, so the
//     same inputs give the same bits.  A chunk in which a row sees no key
//     keeps m = -1e30 and garbage l and acc (exp(-1e30 + 1e30) = 1 a key);
//     its weight exp2(-1e30 - max m) is 0, and the chunk holding key 0
//     always has a real score.  A shape with enough tiles keeps one chunk a
//     tile, writes O itself and runs no merge.
//   - A CTA of 4 warps owns 64 query rows, 16 a warp: S = Q K^T for its 16
//     rows x 64 keys in 8 accumulators of m16n8, the online softmax on
//     them (a row's scores in the 4 lanes of a quad), and P V with P's A
//     fragments taken from S's accumulators by renaming keys (no shuffle)
//     into a fresh accumulator a group of 4 column blocks, added to O on
//     the FMA pipes: the tensor cores' f32 sums truncate.  Operands are
//     split on the fly with an integer add and mask and a float subtract:
//     cvt.rna.tf32 runs at a fraction of the FMA rate.
//   - Q, K and V in shared memory with 16-byte chunks swizzled (chunk c of
//     row r at c ^ (r % 8)), so every fragment read hits 32 banks.  One K
//     and one V buffer of 64 keys, filled by 16-byte cp.async (rows past lk
//     zero-filled): V of tile j lands during Q K^T of tile j, K of tile
//     j + 1 during P V of tile j.  Two block barriers a tile: before Q K^T
//     (K landed; V free) and before P V (V landed; K free).
//   Shared memory at d = 128: Q, K and V 32 KB each, 96 KB a CTA: two CTAs
//   an SM (double-buffered 64-key stages would not fit two).

// Masking as the TPU kernel, in both: a masked score is -1e30 and the key
// tiles start at key 0, so every row's first tile holds a real score (key 0
// is visible to every row when lq <= lk) and a masked score adds
// exp(-1e30 - m) = 0.  The ragged key edge (keys >= lk) is masked too, and
// its rows of K and V are zeros, so any lk is taken; rows past lq are
// computed on zeros and not stored.

#include <cuda.h>           // CUtensorMap and its enums; no driver library
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

namespace {

constexpr float kMaskValue = -1e30f;
constexpr int kEncodeFailed = 100000;   // + the driver's CUresult

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel

constexpr int kTcRows = 128;            // query rows a CTA (2 x 64)
constexpr int kTcKeys = 128;            // keys a tile
constexpr int kStages = 2;              // K/V ring depth
constexpr int kTcThreads = 384;         // producer + 2 consumer warpgroups
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;      // 128 * 40 + 256 * 232 <= 65,536

template <int D>
struct TcShape {
  static constexpr int kSwizzle = D * 2 < 128 ? D * 2 : 128;   // row bytes
  static constexpr int kBoxCols = kSwizzle / 2;
  static constexpr int kBoxes = D * 2 / kSwizzle;
  static constexpr int kQBytes = kTcRows * D * 2;
  static constexpr int kKVBytes = kTcKeys * D * 2;
  static constexpr int kBarBytes = 8 * (1 + 3 * kStages);
  // + 1024: the base is rounded up to the swizzle pattern's period
  static constexpr int kSmem =
      1024 + kQBytes + 2 * kStages * kKVBytes + kBarBytes;
  // wgmma descriptor layout type: 1 = 128-byte swizzle, 2 = 64-byte
  static constexpr uint64_t kLayout = kSwizzle == 128 ? 1 : 2;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Spin until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One box of a 3-D tensor map into shared memory, counted on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// A wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units) and the swizzle layout.
template <int D>
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         TcShape<D>::kLayout << 62;
}

// Keeps the compiler from moving register reads or writes across a wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

#define F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define F16(i) F4(i), F4(i + 4), F4(i + 8), F4(i + 12)
#define F32(i) F16(i), F16(i + 16)
#define F64(i) F32(i), F32(i + 32)
#define REGS16                                                   \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, " \
  "%14, %15"
#define REGS32                                                        \
  REGS16 ", %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, " \
         "%27, %28, %29, %30, %31"
#define REGS64                                                        \
  REGS32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, " \
         "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "   \
         "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63"

// S[64 x 128] (+)= Q[64 x 16] K[128 x 16]^T, both K-major in shared memory;
// scale_d == 0 overwrites S.
__device__ __forceinline__ void wgmma_qk(float (&d)[64], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" REGS64
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : F64(0)
      : "l"(da), "l"(db), "r"(scale_d));
}

// O[64 x N] (+)= P[64 x 16] V[16 x N]: P's A fragment in 4 registers of
// two bf16 each, V N-major in shared memory (transposed B); scale_d == 0
// overwrites O.
template <int N>
__device__ __forceinline__ void wgmma_pv(float (&d)[N / 2], const uint32_t* a,
                                         uint64_t db, int scale_d);

template <>
__device__ __forceinline__ void wgmma_pv<32>(float (&d)[16], const uint32_t* a,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {" REGS16
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : F16(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&d)[32], const uint32_t* a,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" REGS32
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : F32(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&d)[64],
                                              const uint32_t* a, uint64_t db,
                                              int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" REGS64
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : F64(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

#undef F4
#undef F16
#undef F32
#undef F64
#undef REGS16
#undef REGS32
#undef REGS64

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Two f32 values as two bf16 (the first in the low half): the high part
// rounded to nearest, and the low part, the rounding's remainder, too.
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  __nv_bfloat162 l = __floats2bfloat162_rn(x - __low2float(h),
                                           y - __high2float(h));
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = *reinterpret_cast<uint32_t*>(&l);
}

// The accumulator layout of wgmma m64nN (f32), for thread t of a warpgroup:
// register c * 4 + i * 2 + j holds row 16 * (t / 32) + (t % 32) / 4 + 8 * i
// and column 8 * c + 2 * (t % 4) + j.
template <int D>
// repro: grid[concurrent]
__global__ void __launch_bounds__(kTcThreads, 1)
flash_tc(const __grid_constant__ CUtensorMap tm_q,
         const __grid_constant__ CUtensorMap tm_k,
         const __grid_constant__ CUtensorMap tm_v,
         __nv_bfloat16* __restrict__ o, int hq, int group, int lq, int lk,
         int causal, float scale_log2) {
  using S = TcShape<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t q_s = (raw + 1023) & ~1023u;
  const uint32_t kv_s = q_s + S::kQBytes;     // stage s: K, then V
  const uint32_t bars = kv_s + 2 * kStages * S::kKVBytes;
  const uint32_t q_full = bars;
  auto k_full = [&](int s) { return bars + 8 * (1 + s); };
  auto v_full = [&](int s) { return bars + 8 * (1 + kStages + s); };
  auto empty = [&](int s) { return bars + 8 * (1 + 2 * kStages + s); };
  auto k_tile = [&](int s) { return kv_s + 2 * s * S::kKVBytes; };
  auto v_tile = [&](int s) { return k_tile(s) + S::kKVBytes; };

  const int n_qt = (lq + kTcRows - 1) / kTcRows;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.z)) * kTcRows;
  const int h = blockIdx.x, b = blockIdx.y;
  const int off = lk - lq;
  const int q_plane = b * hq + h;
  const int kv_plane = b * (hq / group) + h / group;
  // causal: no row of this tile sees a key past its last valid row's
  // diagonal, so the tiles above it are never loaded
  const int last_row = min(q0 + kTcRows, lq) - 1;
  const int k_end = causal ? min(lk, last_row + off + 1) : lk;
  const int n_tiles = (k_end + kTcKeys - 1) / kTcKeys;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(empty(s), 8);                 // the consumers' 8 warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // producer: one thread issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x != 0) return;
    mbar_expect_tx(q_full, S::kQBytes);
#pragma unroll
    for (int x = 0; x < S::kBoxes; ++x)
      tma_load(q_s + x * kTcRows * S::kSwizzle, &tm_q, q_full,
               x * S::kBoxCols, q0, q_plane);
    for (int t = 0; t < n_tiles; ++t) {
      const int s = t % kStages;
      // the stage's previous tile released (a fresh barrier passes)
      mbar_wait(empty(s), ((t / kStages) & 1) ^ 1);
      mbar_expect_tx(k_full(s), S::kKVBytes);
#pragma unroll
      for (int x = 0; x < S::kBoxes; ++x)
        tma_load(k_tile(s) + x * kTcKeys * S::kSwizzle, &tm_k, k_full(s),
                 x * S::kBoxCols, t * kTcKeys, kv_plane);
      mbar_expect_tx(v_full(s), S::kKVBytes);
#pragma unroll
      for (int x = 0; x < S::kBoxes; ++x)
        tma_load(v_tile(s) + x * kTcKeys * S::kSwizzle, &tm_v, v_full(s),
                 x * S::kBoxCols, t * kTcKeys, kv_plane);
    }
    return;
  }

  // consumers: warpgroup 1 owns rows q0 .. q0 + 63, warpgroup 2 the next 64
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int cw = wg - 1;
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const int row0 = q0 + cw * 64 + 16 * (tid / 32) + lane / 4;   // + 8 * i
  const int col0 = 2 * (lane % 4);                               // + 8c + j
  constexpr int kSlices = D / 16;             // k16 slices of Q K^T
  constexpr int kPerBox = S::kSwizzle / 32;   // of them in one box
  constexpr int kPSlices = kTcKeys / 16;      // k16 slices of P V

  float acc[D / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) acc[e] = 0.f;
  float m[2] = {kMaskValue, kMaskValue}, l[2] = {0.f, 0.f}, alpha[2];

  const uint32_t q_wg = q_s + cw * 64 * S::kSwizzle;
  mbar_wait(q_full, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    const uint32_t parity = (t / kStages) & 1;
    const int k0 = t * kTcKeys;

    float sc[kTcKeys / 2];
    mbar_wait(k_full(s), parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kSlices; ++kk) {
      const uint32_t in_box = (kk / kPerBox), at = (kk % kPerBox) * 32;
      wgmma_qk(sc,
               gmma_desc<D>(q_wg + in_box * kTcRows * S::kSwizzle + at, 16,
                            8 * S::kSwizzle),
               gmma_desc<D>(k_tile(s) + in_box * kTcKeys * S::kSwizzle + at,
                            16, 8 * S::kSwizzle),
               kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // scale to the log2 domain; mask the tiles that cross the diagonal of
    // this warpgroup's rows or the ragged key edge
    const bool masked = k0 + kTcKeys > lk ||
                        (causal && k0 + kTcKeys - 1 > q0 + cw * 64 + off);
    if (masked) {
#pragma unroll
      for (int e = 0; e < kTcKeys / 2; ++e) {
        const int key = k0 + 8 * (e / 4) + col0 + (e % 2);
        const int row = row0 + 8 * ((e / 2) % 2) + off;
        const bool keep = key < lk && (!causal || key <= row);
        sc[e] = keep ? sc[e] * scale_log2 : kMaskValue;
      }
    } else {
#pragma unroll
      for (int e = 0; e < kTcKeys / 2; ++e) sc[e] *= scale_log2;
    }

    // the online softmax of each of the thread's two rows
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = kMaskValue;
#pragma unroll
      for (int c = 0; c < kTcKeys / 8; ++c)
        mx = fmaxf(mx, fmaxf(sc[c * 4 + i * 2], sc[c * 4 + i * 2 + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[i], mx);
      alpha[i] = fast_exp2(m[i] - m_new);
      m[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < kTcKeys / 8; ++c)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float p = fast_exp2(sc[c * 4 + i * 2 + j] - m_new);
          sc[c * 4 + i * 2 + j] = p;
          sum += p;
        }
      l[i] = alpha[i] * l[i] + sum;
    }

    // P's A fragments: slice kk's 8 values are sc[8 kk .. 8 kk + 7]
    uint32_t p_hi[kTcKeys / 4], p_lo[kTcKeys / 4];
#pragma unroll
    for (int r = 0; r < kTcKeys / 4; ++r)
      split_bf16(sc[2 * r], sc[2 * r + 1], p_hi[r], p_lo[r]);

    // this tile's P V in a fresh accumulator, added to O on the FMA pipes
    float pv[D / 2];
    mbar_wait(v_full(s), parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kPSlices; ++kk)
      wgmma_pv<D>(pv, p_hi + 4 * kk,
                  gmma_desc<D>(v_tile(s) + kk * 16 * S::kSwizzle,
                               kTcKeys * S::kSwizzle, 8 * S::kSwizzle),
                  kk > 0);
#pragma unroll
    for (int kk = 0; kk < kPSlices; ++kk)
      wgmma_pv<D>(pv, p_lo + 4 * kk,
                  gmma_desc<D>(v_tile(s) + kk * 16 * S::kSwizzle,
                               kTcKeys * S::kSwizzle, 8 * S::kSwizzle),
                  1);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(pv);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));
#pragma unroll
    for (int e = 0; e < D / 2; ++e)
      acc[e] = fmaf(acc[e], alpha[(e / 2) % 2], pv[e]);
  }

  // epilogue: O / l in f32, one rounding to bf16, rows < lq only
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    const float den = li == 0.f ? 1.f : li;
    const int row = row0 + 8 * i;
    if (row >= lq) continue;
    __nv_bfloat16* out = o + (static_cast<size_t>(q_plane) * lq + row) * D;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) {
      __nv_bfloat162 v2 = __floats2bfloat162_rn(acc[c * 4 + i * 2] / den,
                                                acc[c * 4 + i * 2 + 1] / den);
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * c + col0) = v2;
    }
  }
}

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library needs no -lcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 3-D map over a contiguous [planes, rows, D] bf16 tensor, boxes of
// [1, box_rows, kBoxCols], swizzled as wgmma reads them; out-of-bounds
// elements read as zeros.
template <int D>
int encode(CUtensorMap* map, const void* ptr, int planes, int rows,
           int box_rows) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  using S = TcShape<D>;
  cuuint64_t dims[3] = {D, static_cast<cuuint64_t>(rows),
                        static_cast<cuuint64_t>(planes)};
  cuuint64_t strides[2] = {D * 2, static_cast<cuuint64_t>(rows) * D * 2};
  cuuint32_t box[3] = {S::kBoxCols, static_cast<cuuint32_t>(box_rows), 1};
  cuuint32_t unit[3] = {1, 1, 1};
  CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                  const_cast<void*>(ptr), dims, strides, box, unit,
                  CU_TENSOR_MAP_INTERLEAVE_NONE,
                  S::kSwizzle == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : CU_TENSOR_MAP_SWIZZLE_64B,
                  CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                  CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeFailed + static_cast<int>(r);
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, void* o, int b,
              int hq, int hkv, int lq, int lk, int causal, float sm_scale,
              cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v;
  int rc = encode<D>(&tm_q, q, b * hq, lq, kTcRows);
  if (rc == 0) rc = encode<D>(&tm_k, k, b * hkv, lk, kTcKeys);
  if (rc == 0) rc = encode<D>(&tm_v, v, b * hkv, lk, kTcKeys);
  if (rc != 0) return rc;
  constexpr int kSmem = TcShape<D>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      flash_tc<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(hq, b, (lq + kTcRows - 1) / kTcRows);
  flash_tc<D><<<grid, kTcThreads, kSmem, stream>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(o), hq, hq / hkv, lq, lk,
      causal, sm_scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// f32: the FMA kernel and its merge

constexpr int kBQ = 64;          // query rows a CTA, 16 a warp
constexpr int kBK = 64;          // keys a key tile
constexpr int kThreads = 128;    // 4 warps
constexpr int kMergeThreads = 256;

template <int D>
struct FmaShape {
  static constexpr int kSmem = (kBQ + 2 * kBK) * D * 4;   // Q, K, V
};

// The key tiles query tile t sees: to its last row's diagonal if causal.
__host__ __device__ __forceinline__ int key_tiles(int t, int lq, int lk,
                                                  int causal) {
  const int rows = lq < (t + 1) * kBQ ? lq : (t + 1) * kBQ;
  return ((causal ? rows + lk - lq : lk) + kBK - 1) / kBK;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const float* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's newest copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Element (r, d) of a [64][D] tile in shared memory: 16-byte chunk d / 4
// of row r lands at chunk (d / 4) ^ (r % 8), so a fragment's 8 rows x 4
// columns (or 4 rows x 8 columns, V's) fall on 32 distinct banks.
template <int D>
__device__ __forceinline__ int swz(int r, int d) {
  return r * D + (((d >> 2) ^ (r & 7)) << 2) + (d & 3);
}

// Rows 0 .. 63 of a contiguous [rows, D] block into shared memory,
// swizzled, 16 bytes a copy, neighbouring threads on neighbouring
// addresses; rows from n_valid on are zero-filled and not read.
template <int D>
__device__ __forceinline__ void copy_tile(uint32_t sm, const float* g,
                                          int n_valid) {
  constexpr int kVec = D / 4;
  static_assert(kBQ == kBK && kBK * kVec % kThreads == 0,
                "Q, K and V tiles of 64 rows, whole rounds of copies");
#pragma unroll
  for (int i = 0; i < kBK * kVec / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int r = e / kVec, d = (e % kVec) * 4;
    const bool valid = r < n_valid;
    cp_async16(sm + swz<D>(r, d) * 4, valid ? g + r * D + d : g, valid);
  }
}

__device__ __forceinline__ void fma4(float4& a, float p, const float4& v) {
  a.x = fmaf(p, v.x, a.x);
  a.y = fmaf(p, v.y, a.y);
  a.z = fmaf(p, v.z, a.z);
  a.w = fmaf(p, v.w, a.w);
}

// x as hi + lo for tf32 products: hi is x with its low 13 bits cleared, lo
// = x - hi exactly; a product reads lo's top 19 bits alone, so the pair
// carries x to within 2^-20 |x|.  One integer and one float operation at
// the full rate: cvt.rna.tf32 runs at a fraction of it, and the kernel
// splits every operand it reads (rounding hi too took 7% longer, PERF.md).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a b on the tensor cores, m16n8k8, tf32 operands, f32 sums.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b as three tf32 products (3xTF32), the small ones first; the
// dropped lo lo term is under 2^-20 of a b.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4],
                                           const uint32_t (&ah)[4],
                                           const uint32_t (&al)[4],
                                           const uint32_t (&bh)[2],
                                           const uint32_t (&bl)[2]) {
  mma_tf32(d, al, bh);
  mma_tf32(d, ah, bl);
  mma_tf32(d, ah, bh);
}

// The workspace slot of (batch x head bh, query tile t, chunk c): chunks
// [max_chunks] per tile, tiles [n_qt] per head.
__device__ __forceinline__ size_t fma_slot(int bh, int t, int c, int n_qt,
                                           int max_chunks) {
  return (static_cast<size_t>(bh) * n_qt + t) * max_chunks + c;
}

// The fragments of mma m16n8k8, for lane (g = lane / 4, t4 = lane % 4):
// A (16 x 8) a0 (g, t4), a1 (g + 8, t4), a2 (g, t4 + 4), a3 (g + 8, t4 + 4);
// B (8 x 8) b0 (t4, g), b1 (t4 + 4, g); C (16 x 8) c0 (g, 2 t4), c1 (g,
// 2 t4 + 1), c2 (g + 8, 2 t4), c3 (g + 8, 2 t4 + 1).
template <int D>
// repro: grid[concurrent]
__global__ void __launch_bounds__(kThreads, 2)
flash_fma(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, float* __restrict__ o,
          float* __restrict__ ws_acc, float2* __restrict__ ws_ml, int hq,
          int group, int lq, int lk, int causal, float scale_log2,
          int chunk_tiles, const uint32_t* __restrict__ items) {
  constexpr int kNB = kBK / 8;             // 8-key blocks of S
  constexpr int kNO = D / 8;               // 8-column blocks of O, and
                                           // 8-wide k-steps of Q K^T
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                        // [kBQ][D], swizzled
  float* ks = qs + kBQ * D;                // [kBK][D], swizzled
  float* vs = ks + kBK * D;                // [kBK][D], swizzled

  const int n_qt = (lq + kBQ - 1) / kBQ;
  int t = n_qt - 1 - static_cast<int>(blockIdx.z), c = 0;
  if (items) {                             // one head's work list
    const uint32_t it = items[blockIdx.z];
    t = it & 0xFFFF;
    c = it >> 16;
  }
  // the merge, launched after this grid, may start its launch now; it
  // waits for this grid's end before it reads the workspace
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = t * kBQ, off = lk - lq;
  const int n_kt = key_tiles(t, lq, lk, causal);
  const int n_c = (n_kt + chunk_tiles - 1) / chunk_tiles;
  const int kt0 = c * n_kt / n_c, kt1 = (c + 1) * n_kt / n_c;
  const size_t q_base = ((static_cast<size_t>(b) * hq + h) * lq + q0) * D;
  const float* kh = k + (static_cast<size_t>(b) * (hq / group) + h / group) *
                            lk * D;
  const float* vh = v + (kh - k);
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int ra = 16 * (threadIdx.x >> 5) + g;   // this lane's rows ra, ra + 8

  const uint32_t qs_u = smem_u32(qs), ks_u = smem_u32(ks),
                 vs_u = smem_u32(vs);
  // copy groups: Q and K of the first tile, then its V
  copy_tile<D>(qs_u, q + q_base, lq - q0);
  copy_tile<D>(ks_u, kh + static_cast<size_t>(kt0) * kBK * D,
               lk - kt0 * kBK);
  cp_async_commit();
  copy_tile<D>(vs_u, vh + static_cast<size_t>(kt0) * kBK * D,
               lk - kt0 * kBK);
  cp_async_commit();

  float m[2] = {kMaskValue, kMaskValue}, l[2] = {0.f, 0.f};
  float acc[kNO][4];
#pragma unroll
  for (int n = 0; n < kNO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int kt = kt0; kt < kt1; ++kt) {
    const int k0 = kt * kBK;
    if (kt == kt0)
      cp_async_wait<1>();                  // Q and K landed, V may not have
    else
      cp_async_wait<0>();                  // this tile's K landed
    __syncthreads();                       // ... for every thread; V free
    if (kt > kt0) {                        // V lands during Q K^T
      copy_tile<D>(vs_u, vh + static_cast<size_t>(k0) * D, lk - k0);
      cp_async_commit();
    }

    // S = Q K^T: this warp's 16 rows x 64 keys in 8 blocks of 8 keys
    float sc[kNB][4];
#pragma unroll
    for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[nb][e] = 0.f;
#pragma unroll 2
    for (int kq = 0; kq < kNO; ++kq) {
      const int d0 = 8 * kq + t4;
      uint32_t ah[4], al[4];
      split_tf32(qs[swz<D>(ra, d0)], ah[0], al[0]);
      split_tf32(qs[swz<D>(ra + 8, d0)], ah[1], al[1]);
      split_tf32(qs[swz<D>(ra, d0 + 4)], ah[2], al[2]);
      split_tf32(qs[swz<D>(ra + 8, d0 + 4)], ah[3], al[3]);
#pragma unroll
      for (int nb = 0; nb < kNB; ++nb) {
        uint32_t bh[2], bl[2];
        split_tf32(ks[swz<D>(8 * nb + g, d0)], bh[0], bl[0]);
        split_tf32(ks[swz<D>(8 * nb + g, d0 + 4)], bh[1], bl[1]);
        mma_3xtf32(sc[nb], ah, al, bh, bl);
      }
    }

    // scale to the log2 domain, mask the tiles that cross the diagonal or
    // the ragged key edge, and the online softmax of rows ra + 8 hh; l
    // keeps this lane's keys only, summed over the row's 4 lanes at the end
    const bool edge = k0 + kBK > lk || (causal && k0 + kBK - 1 > q0 + off);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = q0 + ra + 8 * hh + off;   // the query's key position
      float mx = kMaskValue;
#pragma unroll
      for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int key = k0 + 8 * nb + 2 * t4 + e;
          const bool keep = !edge || (key < lk && (!causal || key <= row));
          float& x = sc[nb][2 * hh + e];
          x = keep ? x * scale_log2 : kMaskValue;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[hh], mx);
      const float alpha = fast_exp2(m[hh] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int nb = 0; nb < kNB; ++nb)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sc[nb][2 * hh + e];
          x = fast_exp2(x - m_new);
          sum += x;
        }
      l[hh] = fmaf(alpha, l[hh], sum);
      m[hh] = m_new;
#pragma unroll
      for (int n = 0; n < kNO; ++n) {
        acc[n][2 * hh] *= alpha;
        acc[n][2 * hh + 1] *= alpha;
      }
    }
    // P's A fragments from S's C fragments, no shuffle: k-step kk is key
    // block kk, its k index t4 standing for key 2 t4 and t4 + 4 for key
    // 2 t4 + 1 (V's B fragments read those rows)
    uint32_t ph[kNB][4], pl[kNB][4];
#pragma unroll
    for (int kk = 0; kk < kNB; ++kk) {
      split_tf32(sc[kk][0], ph[kk][0], pl[kk][0]);
      split_tf32(sc[kk][2], ph[kk][1], pl[kk][1]);
      split_tf32(sc[kk][1], ph[kk][2], pl[kk][2]);
      split_tf32(sc[kk][3], ph[kk][3], pl[kk][3]);
    }
    cp_async_wait<0>();                    // this tile's V landed
    __syncthreads();                       // ... for every thread; K free
    if (kt + 1 < kt1) {                    // K lands during P V
      copy_tile<D>(ks_u, kh + static_cast<size_t>(k0 + kBK) * D,
                   lk - k0 - kBK);
      cp_async_commit();
    }

    // O += P V: each group of 4 column blocks in a fresh accumulator,
    // added to O on the FMA pipes (the tensor cores' f32 sums truncate)
#pragma unroll
    for (int n0 = 0; n0 < kNO; n0 += 4) {
      float f[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) f[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kNB; ++kk) {
        const int key = 8 * kk + 2 * t4;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = 8 * (n0 + j) + g;
          uint32_t bh[2], bl[2];
          split_tf32(vs[swz<D>(key, col)], bh[0], bl[0]);
          split_tf32(vs[swz<D>(key + 1, col)], bh[1], bl[1]);
          mma_3xtf32(f[j], ph[kk], pl[kk], bh, bl);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n0 + j][e] += f[j][e];
    }
  }

  // one chunk: O / l (l == 0 divides by 1); else the chunk's m, l and
  // accumulator to its workspace slot.  Rows < lq only.
  const int max_chunks =
      (key_tiles(n_qt - 1, lq, lk, causal) + chunk_tiles - 1) / chunk_tiles;
  const size_t slot = fma_slot(b * hq + h, t, c, n_qt, max_chunks);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float li = l[hh];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    const int r = ra + 8 * hh;
    if (q0 + r >= lq) continue;
    const bool one = n_c == 1;
    const float den = !one ? 1.f : li == 0.f ? 1.f : li;
    float* out = one ? o + q_base + r * D : ws_acc + (slot * kBQ + r) * D;
#pragma unroll
    for (int n = 0; n < kNO; ++n)
      *reinterpret_cast<float2*>(out + 8 * n + 2 * t4) =
          make_float2(acc[n][2 * hh] / den, acc[n][2 * hh + 1] / den);
    if (!one && t4 == 0) ws_ml[slot * kBQ + r] = make_float2(m[hh], li);
  }
}

// O of the query tiles cut into chunks: each row's chunks weighted by
// exp2(m_c - max m) and added in chunk order, then / l.  A thread an
// output float4: CTAs of kMergeThreads / (D / 4) rows, (row block, query
// tile x head, batch); a tile of one chunk was written by flash_fma.
template <int D>
// repro: grid[concurrent]
__global__ void __launch_bounds__(kMergeThreads)
flash_fma_merge(const float* __restrict__ ws_acc,
                const float2* __restrict__ ws_ml, float* __restrict__ o,
                int hq, int lq, int lk, int causal, int chunk_tiles) {
  constexpr int kVec = D / 4, kRows = kMergeThreads / kVec;
  // launched as flash_fma's programmatic dependent: wait for its end
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  const int n_qt = (lq + kBQ - 1) / kBQ;
  const int t = blockIdx.y % n_qt, h = blockIdx.y / n_qt, b = blockIdx.z;
  const int n_c = (key_tiles(t, lq, lk, causal) + chunk_tiles - 1) /
                  chunk_tiles;
  const int r = blockIdx.x * kRows + threadIdx.x / kVec, c4 = threadIdx.x % kVec;
  const int q0 = t * kBQ;
  if (n_c == 1 || q0 + r >= lq) return;
  const int max_chunks =
      (key_tiles(n_qt - 1, lq, lk, causal) + chunk_tiles - 1) / chunk_tiles;
  const size_t slot0 = fma_slot(b * hq + h, t, 0, n_qt, max_chunks);
  const float2* ml = ws_ml + slot0 * kBQ + r;
  const float4* acc4 =
      reinterpret_cast<const float4*>(ws_acc) + (slot0 * kBQ + r) * kVec + c4;
  float mx = kMaskValue;
#pragma unroll 4
  for (int c = 0; c < n_c; ++c) mx = fmaxf(mx, ml[c * kBQ].x);
  float l = 0.f;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
  for (int c = 0; c < n_c; ++c) {
    const float2 mlc = ml[c * kBQ];
    const float w = fast_exp2(mlc.x - mx);
    l = fmaf(w, mlc.y, l);
    fma4(a, w, acc4[c * kBQ * kVec]);
  }
  const float den = l == 0.f ? 1.f : l;
  reinterpret_cast<float4*>(
      o + ((static_cast<size_t>(b) * hq + h) * lq + q0 + r) * D)[c4] =
      make_float4(a.x / den, a.y / den, a.z / den, a.w / den);
}

// items == nullptr: one chunk a tile, grid item z is query tile n_qt - 1 -
// z, and ws is not read.  Else items (device memory) holds n_items work
// items a head (t | c << 16, longest first), chunk_tiles key tiles at most
// a chunk, and ws b * hq * n_qt * max_chunks slots of 64 x D accumulator
// floats, then as many of 64 (m, l) pairs.
template <int D>
int launch_fma(const void* q, const void* k, const void* v, void* o, void* ws,
               int b, int hq, int hkv, int lq, int lk, int causal,
               float sm_scale, int chunk_tiles, int n_items,
               const uint32_t* items, cudaStream_t stream) {
  using S = FmaShape<D>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_qt = (lq + kBQ - 1) / kBQ;
  const int longest = key_tiles(n_qt - 1, lq, lk, causal);
  const bool split = items != nullptr;
  if (!split) {
    n_items = n_qt;
    chunk_tiles = longest;
  } else if (n_items < 1 || chunk_tiles < 1 || ws == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int max_chunks = (longest + chunk_tiles - 1) / chunk_tiles;
  float* ws_acc = static_cast<float*>(ws);
  float2* ws_ml = split ? reinterpret_cast<float2*>(
                              ws_acc + static_cast<size_t>(b) * hq * n_qt *
                                           max_chunks * kBQ * D)
                        : nullptr;
  flash_fma<D><<<dim3(hq, b, n_items), kThreads, S::kSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), ws_acc, ws_ml,
      hq, hq / hkv, lq, lk, causal, sm_scale * 1.4426950408889634f,
      chunk_tiles, items);
  err = cudaGetLastError();
  if (err != cudaSuccess || !split) return static_cast<int>(err);
  // a programmatic dependent launch: its launch overlaps flash_fma's tail
  cudaLaunchAttribute pdl[1];
  pdl[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  pdl[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kBQ / (kMergeThreads / (D / 4)), n_qt * hq, b);
  cfg.blockDim = dim3(kMergeThreads);
  cfg.stream = stream;
  cfg.attrs = pdl;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, flash_fma_merge<D>, static_cast<const float*>(ws_acc),
      static_cast<const float2*>(ws_ml), static_cast<float*>(o), hq, lq, lk,
      causal, chunk_tiles));
}

template <int D>
int launch(int dtype, const void* q, const void* k, const void* v, void* o,
           void* ws, int b, int hq, int hkv, int lq, int lk, int causal,
           float sm_scale, int chunk_tiles, int n_items,
           const uint32_t* items, cudaStream_t stream) {
  if (dtype == 0)
    return launch_fma<D>(q, k, v, o, ws, b, hq, hkv, lq, lk, causal,
                         sm_scale, chunk_tiles, n_items, items, stream);
  if (dtype == 1)
    return launch_tc<D>(q, k, v, o, b, hq, hkv, lq, lk, causal, sm_scale,
                        stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

const char* flash_error_string(int code) {
  static char msg[96];
  if (code >= kEncodeFailed) {
    snprintf(msg, sizeof msg, "cuTensorMapEncodeTiled failed (CUresult %d)",
             code - kEncodeFailed);
    return msg;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Dynamic shared memory of flash_fma at head dim d (bytes), or 0.
int flash_fma_smem(int d) {
  switch (d) {
    case 32:
      return FmaShape<32>::kSmem;
    case 64:
      return FmaShape<64>::kSmem;
    case 128:
      return FmaShape<128>::kSmem;
    default:
      return 0;
  }
}

// q [b, hq, lq, d], k and v [b, hkv, lk, d], o [b, hq, lq, d], contiguous,
// 16-byte aligned; dtype 0 = f32 (the FMA kernel), 1 = bf16 (the
// tensor-core kernel); d in {32, 64, 128}; lq <= lk.  f32 only: items
// (device memory, n_items of them) is ops.fma_plan's work list of one
// head, or null for one chunk a tile; chunk_tiles its chunk length and ws
// its workspace, or null where items is (launch_fma).  A split call runs flash_fma, then
// flash_fma_merge.
int flash_attention(const void* q, const void* k, const void* v, void* o,
                    void* ws, int dtype, int b, int hq, int hkv, int lq,
                    int lk, int d, int causal, float sm_scale,
                    int chunk_tiles, int n_items, const uint32_t* items,
                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32:
      return launch<32>(dtype, q, k, v, o, ws, b, hq, hkv, lq, lk, causal,
                        sm_scale, chunk_tiles, n_items, items, s);
    case 64:
      return launch<64>(dtype, q, k, v, o, ws, b, hq, hkv, lq, lk, causal,
                        sm_scale, chunk_tiles, n_items, items, s);
    case 128:
      return launch<128>(dtype, q, k, v, o, ws, b, hq, hkv, lq, lk, causal,
                         sm_scale, chunk_tiles, n_items, items, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
