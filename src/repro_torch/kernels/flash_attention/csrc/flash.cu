// Flash attention for Hopper (sm_90a): the CUDA C++ port of the Pallas kernel
// in repro/kernels/flash_attention/flash.py (_flash_kernel /
// flash_attention_pallas).
//
//   flash_attention   o = softmax(q k^T * sm_scale, masked) v per (batch,
//                     query head), online softmax over key tiles; causal
//                     with the queries at the end of the key sequence
//                     (off = lk - lq), GQA (key/value head h / group serves
//                     query head h), f32 or bf16 in, f32 arithmetic, the
//                     output in the input's type
//
// Plain C interface (bound with ctypes): launches on the stream it is
// given, allocates nothing, never synchronises, and returns
// cudaGetLastError() so the caller sees a refused launch.
//
// What bounds it on an H100: operations.  At Qwen3-0.6B's prefill (16 query
// heads, d_head 128, 4096 tokens) a query head does 4 * d * (causal pairs)
// = 4.3 GFLOP while it reads q, k and v and writes o, 4 MB in bf16: over
// 1,000 flops per byte, far above the card's 295 bf16 flops per byte.
// This first version is the simple design: one CTA of 256 threads per
// (batch, query head, 64-row query tile), looping over 64-key tiles from
// key 0 to the tile's diagonal (tiles wholly above it are never loaded),
// with the running max, normaliser and the 64 x d accumulator in registers
// (4 rows x d/16 columns a thread).  Tiles are kept in shared memory as f32
// (bf16 widened at the load), K and V taking turns in one buffer, so a CTA
// needs 86 KB at d = 128 and two fit on an SM.  The products run on the
// f32 FMA pipes (67 TFLOP/s peak), not the tensor cores: every sum is f32
// as in the TPU kernel and the plain version, and the kernel is right
// before it is fast.  The tensor cores (mma.sync or wgmma with TMA) are the
// next step.
//
// Masking as the TPU kernel: a masked score is -1e30 and the key tiles
// start at key 0, so every row's first tile holds a real score (key 0 is
// visible to every row when lq <= lk) and a masked score adds exp(-1e30 -
// m) = 0.  The ragged key edge (keys >= lk) is masked here too, and its
// rows of K and V are zero-filled, so any lk is taken; rows past lq are
// computed on zeros and not stored.  l == 0 still divides by 1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;          // query rows per CTA
constexpr int kBK = 64;          // keys per tile
constexpr int kThreads = 256;    // 16 x 16: rows ty + 16 i, columns tx + 16 j
constexpr int kPStride = kBK + 16;
constexpr float kMaskValue = -1e30f;
static_assert(kBQ == kBK, "load_tile moves 64-row tiles of Q, K and V");

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Four bf16 values widened to f32: a bf16 is the high half of an f32.
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  uint2 raw = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(raw.x << 16),
                     __uint_as_float(raw.x & 0xffff0000u),
                     __uint_as_float(raw.y << 16),
                     __uint_as_float(raw.y & 0xffff0000u));
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Rows 0 .. 63 of a [rows, D] block into shared memory (row stride D + 4),
// rows from n_valid on as zeros.  The block is contiguous in device memory,
// so neighbouring threads read neighbouring addresses.
template <int D, typename T>
__device__ __forceinline__ void load_tile(float* sm, const T* g, int n_valid) {
  constexpr int kVec = D / 4;
  for (int e = threadIdx.x; e < kBK * kVec; e += kThreads) {
    int r = e / kVec, c = (e % kVec) * 4;
    float4 f = r < n_valid ? load4(g + (size_t)r * D + c)
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

template <int D, typename T>
__global__ void __launch_bounds__(kThreads, 2)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int hq, int group,
             int lq, int lk, int causal, float sm_scale) {
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

  // causal: no row of this tile sees a key past its last valid row's
  // diagonal, so the tiles above it are skipped
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
    T* out = o + q_base + (size_t)r * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) store(out + tx + 16 * c, acc[i][c] / den);
  }
}

template <int D, typename T>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int hq, int hkv, int lq, int lk, int causal, float sm_scale,
           cudaStream_t stream) {
  constexpr int kSmem =
      (kBQ * (D + 4) + kBK * (D + 4) + kBQ * kPStride) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((lq + kBQ - 1) / kBQ, hq, b);
  flash_kernel<D, T><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), hq, hq / hkv, lq, lk,
      causal, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(int d, const void* q, const void* k, const void* v, void* o,
             int b, int hq, int hkv, int lq, int lk, int causal,
             float sm_scale, cudaStream_t stream) {
  switch (d) {
    case 32:
      return launch<32, T>(q, k, v, o, b, hq, hkv, lq, lk, causal, sm_scale,
                           stream);
    case 64:
      return launch<64, T>(q, k, v, o, b, hq, hkv, lq, lk, causal, sm_scale,
                           stream);
    case 128:
      return launch<128, T>(q, k, v, o, b, hq, hkv, lq, lk, causal, sm_scale,
                            stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

const char* flash_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q [b, hq, lq, d], k and v [b, hkv, lk, d], o [b, hq, lq, d], contiguous,
// 16-byte aligned; dtype 0 = f32, 1 = bf16; d in {32, 64, 128}; lq <= lk.
int flash_attention(const void* q, const void* k, const void* v, void* o,
                    int dtype, int b, int hq, int hkv, int lq, int lk, int d,
                    int causal, float sm_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float>(d, q, k, v, o, b, hq, hkv, lq, lk, causal,
                           sm_scale, s);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(d, q, k, v, o, b, hq, hkv, lq, lk, causal,
                                   sm_scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
