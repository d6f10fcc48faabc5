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
// f32: flash_fma, the f32 FMA pipes (no one-pass tensor-core product holds
// f32's 2e-5): one CTA of 256 threads per (batch, query head, 64-row query
// tile), looping over 64-key tiles from key 0 to the tile's diagonal, with
// the running max, normaliser and the 64 x d accumulator in registers (4
// rows x d/16 columns a thread) and the tiles in shared memory, K and V
// taking turns in one buffer (86 KB at d = 128, two CTAs an SM).
//
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
// f32: the FMA kernel

constexpr int kBQ = 64;          // query rows per CTA
constexpr int kBK = 64;          // keys per tile
constexpr int kThreads = 256;    // 16 x 16: rows ty + 16 i, columns tx + 16 j
constexpr int kPStride = kBK + 16;
static_assert(kBQ == kBK, "load_tile moves 64-row tiles of Q, K and V");

// Rows 0 .. 63 of a [rows, D] block into shared memory (row stride D + 4),
// rows from n_valid on as zeros.  The block is contiguous in device memory,
// so neighbouring threads read neighbouring addresses.
template <int D>
__device__ __forceinline__ void load_tile(float* sm, const float* g,
                                          int n_valid) {
  constexpr int kVec = D / 4;
  for (int e = threadIdx.x; e < kBK * kVec; e += kThreads) {
    int r = e / kVec, c = (e % kVec) * 4;
    float4 f = r < n_valid
                   ? *reinterpret_cast<const float4*>(g + (size_t)r * D + c)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(sm + r * (D + 4) + c) = f;
  }
}

// Reductions over the 16 lanes that share a row (lanes 0-15 or 16-31).
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int s = 8; s > 0; s >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, s));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int s = 8; s > 0; s >>= 1) x += __shfl_xor_sync(0xffffffffu, x, s);
  return x;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_fma(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, float* __restrict__ o, int hq,
          int group, int lq, int lk, int causal, float sm_scale) {
  constexpr int kCols = D / 16;            // accumulator columns a thread
  extern __shared__ float smem[];
  float* qs = smem;                        // [kBQ][D + 4]
  float* kvs = qs + kBQ * (D + 4);         // [kBK][D + 4], K then V
  float* ps = kvs + kBK * (D + 4);         // [kBQ][kPStride]

  const int n_qt = (lq + kBQ - 1) / kBQ;
  const int q0 = (n_qt - 1 - blockIdx.x) * kBQ;   // longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int off = lk - lq;
  const size_t q_base = (((size_t)b * hq + h) * lq + q0) * D;
  const size_t kv_base = ((size_t)b * (hq / group) + h / group) * lk * D;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;

  load_tile<D>(qs, q + q_base, lq - q0);

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMaskValue;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  const int last_row = min(q0 + kBQ, lq) - 1;
  const int k_end = causal ? min(lk, last_row + off + 1) : lk;
  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();                       // the last tile's V is read
    load_tile<D>(kvs, k + kv_base + (size_t)k0 * D, lk - k0);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(
            qs + (ty + 16 * i) * (D + 4) + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(
            kvs + (tx + 16 * j) * (D + 4) + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }

    // scale, mask, and the online softmax update of each row
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i + off;      // the query's key position
      float mx = kMaskValue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const bool keep = col < lk && (!causal || col <= row);
        s[i][j] = keep ? s[i][j] * sm_scale : kMaskValue;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        ps[(ty + 16 * i) * kPStride + tx + 16 * j] = p;
        sum += p;
      }
      l[i] = alpha * l[i] + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();                       // K is read and P written
    load_tile<D>(kvs, v + kv_base + (size_t)k0 * D, lk - k0);
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float p[4], vv[kCols];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(ty + 16 * i) * kPStride + kk];
#pragma unroll
      for (int c = 0; c < kCols; ++c) vv[c] = kvs[kk * (D + 4) + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c)
          acc[i][c] = fmaf(p[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (q0 + r >= lq) continue;
    const float den = l[i] == 0.f ? 1.f : l[i];
    float* out = o + q_base + (size_t)r * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) out[tx + 16 * c] = acc[i][c] / den;
  }
}

template <int D>
int launch_fma(const void* q, const void* k, const void* v, void* o, int b,
               int hq, int hkv, int lq, int lk, int causal, float sm_scale,
               cudaStream_t stream) {
  constexpr int kSmem =
      (kBQ * (D + 4) + kBK * (D + 4) + kBQ * kPStride) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((lq + kBQ - 1) / kBQ, hq, b);
  flash_fma<D><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), hq, hq / hkv, lq,
      lk, causal, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(int dtype, const void* q, const void* k, const void* v, void* o,
           int b, int hq, int hkv, int lq, int lk, int causal, float sm_scale,
           cudaStream_t stream) {
  if (dtype == 0)
    return launch_fma<D>(q, k, v, o, b, hq, hkv, lq, lk, causal, sm_scale,
                         stream);
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

// q [b, hq, lq, d], k and v [b, hkv, lk, d], o [b, hq, lq, d], contiguous,
// 16-byte aligned; dtype 0 = f32 (the FMA kernel), 1 = bf16 (the
// tensor-core kernel); d in {32, 64, 128}; lq <= lk.
int flash_attention(const void* q, const void* k, const void* v, void* o,
                    int dtype, int b, int hq, int hkv, int lq, int lk, int d,
                    int causal, float sm_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32:
      return launch<32>(dtype, q, k, v, o, b, hq, hkv, lq, lk, causal,
                        sm_scale, s);
    case 64:
      return launch<64>(dtype, q, k, v, o, b, hq, hkv, lq, lk, causal,
                        sm_scale, s);
    case 128:
      return launch<128>(dtype, q, k, v, o, b, hq, hkv, lq, lk, causal,
                         sm_scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
