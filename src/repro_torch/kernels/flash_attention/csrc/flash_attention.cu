// Flash attention forward for Hopper (sm_90a), plain CUDA C++.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/flash_attention.py::flash_attention_fwd
//   (body _attn_kernel): online-softmax attention with GQA (kv head = h / group),
//   causal mask col <= row, window mask col > row - window (row counted from
//   q_offset), logit softcap c*tanh(s/c) before the mask, fp32 running max / sum
//   / accumulator, and 0 for a query row that sees no key.
//
// Bound on this card: at the serving shapes (head_dim 256, thousands of keys
// per row) the work is ~4*D multiply-adds per visible (query, key) pair against
// reading q, k, v and writing o once, far above the H100's ~295 flop/byte
// ridge, so the bound is the operations (989 TFLOP/s for bf16 inputs on the
// tensor cores).
//
// What this design does about it, and what it leaves for later: the TPU grid's
// sequential KV axis becomes a loop inside one block per (q tile, q head,
// batch), so the running max / sum / accumulator stay in registers for the
// whole row band and only q, k, v are read and o written once per block. KV
// tiles that lie wholly outside the causal / window band of the q tile are
// never loaded. Ragged tails (S not a multiple of 64) are masked, so no shape
// shrinks the tile. Products run in fp32 on the CUDA cores (4x4 and 4x(D/16)
// register tiles per thread over fp32 tiles in shared memory); wgmma, TMA and
// a KV-tile ring that overlaps loads with math are for a later change, which
// is where the gap to the tensor-core bound closes.
//
// Since the tensor-core kernel (flash_attention_sm90.cu) took bf16 at head_dim
// 64, 128 and 256, this kernel serves fp32 inputs (the card-vs-CPU checks and
// fp32 training: TF32 would break the fp32 comparison) and head_dim 16 and 32;
// ops.kernel_for picks between the two.
//
// Layout: the model's [B, S, H, D], contiguous, read in place (no transpose).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;   // query rows per block
constexpr int BK = 64;   // keys per KV tile
constexpr int NT = 256;  // threads: 16 (tx) x 16 (ty)
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Copy 64 rows of D elements (row r at src + r * row_stride) into dst[r * ld + d]
// as fp32 times `mul`; rows >= n_valid become 0. 16-byte loads along d.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* __restrict__ src,
                                          long row_stride, int n_valid, float mul) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int VPR = D / VEC;
  for (int i = threadIdx.x; i < 64 * VPR; i += NT) {
    const int r = i / VPR;
    const int c = (i % VPR) * VEC;
    float vals[VEC];
    if (r < n_valid) {
      const uint4 raw = *reinterpret_cast<const uint4*>(src + r * row_stride + c);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < VEC; ++j) vals[j] = to_f32(e[j]) * mul;
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) vals[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < VEC; j += 4)
      *reinterpret_cast<float4*>(dst + r * ld + c + j) =
          make_float4(vals[j], vals[j + 1], vals[j + 2], vals[j + 3]);
  }
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(BQ * (D + 4) + BK * (D + 4) + BK * D + BQ * (BK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, int Sq, int Sk, int Hq, int Hkv, int causal, int has_window,
    int window, int has_softcap, float softcap, float scale, int q_offset) {
  static_assert(D % 16 == 0 && D <= 256, "head_dim must be a multiple of 16, <= 256");
  constexpr int LDQ = D + 4;   // padded: float4 reads of 16 K rows hit distinct banks
  constexpr int LDV = D;
  constexpr int LDP = BK + 1;
  constexpr int DPT = D / 16;  // output columns per thread
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + BQ * LDQ;
  float* Vs = Ks + BK * LDQ;
  float* Ps = Vs + BK * LDV;

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (Hq / Hkv);
  const int tx = threadIdx.x & 15;  // key column / output column group
  const int ty = threadIdx.x >> 4;  // query row group
  const int nq = min(BQ, Sq - q0);

  const long q_stride = (long)Hq * D;
  const long kv_stride = (long)Hkv * D;
  const T* kb = k + (long)b * Sk * kv_stride + (long)hk * D;
  const T* vb = v + (long)b * Sk * kv_stride + (long)hk * D;
  load_tile<T, D>(Qs, LDQ, q + ((long)b * Sq + q0) * q_stride + (long)h * D, q_stride, nq,
                  scale);

  // Keys any row of this tile can see: [kv_lo, kv_hi).
  const int row_lo = q0 + q_offset;
  const int row_hi = q0 + nq - 1 + q_offset;
  int kv_lo = 0, kv_hi = Sk;
  if (causal) kv_hi = min(Sk, row_hi + 1);
  if (has_window) kv_lo = max(0, row_lo - window + 1);
  const int t_lo = kv_lo / BK;
  const int t_hi = kv_hi > kv_lo ? (kv_hi + BK - 1) / BK : t_lo;

  float acc[4][DPT];
  float m[4], l[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[r][j] = 0.f;
  }

  for (int t = t_lo; t < t_hi; ++t) {
    const int k0 = t * BK;
    const int nk = min(BK, Sk - k0);
    __syncthreads();  // the previous tile's K, V and P are no longer read
    load_tile<T, D>(Ks, LDQ, kb + k0 * kv_stride, kv_stride, nk, 1.f);
    load_tile<T, D>(Vs, LDV, vb + k0 * kv_stride, kv_stride, nk, 1.f);
    __syncthreads();

    // s[r][c] = q[ty + 16r] . k[tx + 16c]
    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        qv[r] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * r) * LDQ + d);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        kv[c] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * c) * LDQ + d);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          s[r][c] += qv[r].x * kv[c].x + qv[r].y * kv[c].y + qv[r].z * kv[c].z +
                     qv[r].w * kv[c].w;
    }

    // Softcap, mask and the online-softmax update; a row's 16 threads are
    // lanes of one half-warp, so row reductions are xor shuffles over 1..8.
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = q0 + ty + 16 * r + q_offset;
      bool ok[4];
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = k0 + tx + 16 * c;
        bool keep = col < Sk;
        if (causal) keep = keep && col <= row;
        if (has_window) keep = keep && col > row - window;
        float x = s[r][c];
        if (has_softcap) x = softcap * tanhf(x / softcap);
        ok[c] = keep;
        s[r][c] = keep ? x : NEG_INF;
        mx = fmaxf(mx, s[r][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      const float m_use = m_new <= NEG_INF / 2 ? 0.f : m_new;  // fully-masked guard
      float rs = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = ok[c] ? expf(s[r][c] - m_use) : 0.f;
        Ps[(ty + 16 * r) * LDP + tx + 16 * c] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      const float alpha = m[r] <= NEG_INF / 2 ? 0.f : expf(m[r] - m_use);
      l[r] = alpha * l[r] + rs;
      m[r] = m_new;
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[r][j] *= alpha;
    }
    __syncthreads();

    // acc[r][j] += sum_kk P[ty + 16r][kk] * V[kk][tx + 16j]
    for (int kk = 0; kk < nk; ++kk) {
      float vv[DPT];
#pragma unroll
      for (int j = 0; j < DPT; ++j) vv[j] = Vs[kk * LDV + tx + 16 * j];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float p = Ps[(ty + 16 * r) * LDP + kk];
#pragma unroll
        for (int j = 0; j < DPT; ++j) acc[r][j] += p * vv[j];
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = q0 + ty + 16 * r;
    if (row < Sq) {
      const float inv = 1.f / (l[r] == 0.f ? 1.f : l[r]);
      T* orow = o + ((long)b * Sq + row) * q_stride + (long)h * D;
#pragma unroll
      for (int j = 0; j < DPT; ++j) orow[tx + 16 * j] = from_f32<T>(acc[r][j] * inv);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                   int Sk, int Hq, int Hkv, int causal, int has_window, int window,
                   int has_softcap, float softcap, float scale, int q_offset,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((Sq + BQ - 1) / BQ, Hq, B);
  flash_fwd_kernel<T, D><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Sq, Sk, Hq, Hkv, causal, has_window, window, has_softcap, softcap,
      scale, q_offset);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v, void* o, int B,
                       int Sq, int Sk, int Hq, int Hkv, int causal, int has_window,
                       int window, int has_softcap, float softcap, float scale,
                       int q_offset, cudaStream_t s) {
#define FA_CASE(DD)                                                                        \
  case DD:                                                                                 \
    return launch<T, DD>(q, k, v, o, B, Sq, Sk, Hq, Hkv, causal, has_window, window,      \
                         has_softcap, softcap, scale, q_offset, s);
  switch (D) {
    FA_CASE(16)
    FA_CASE(32)
    FA_CASE(64)
    FA_CASE(128)
    FA_CASE(256)
    default:
      return cudaErrorInvalidValue;
  }
#undef FA_CASE
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t after the launch.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                        int Sk, int Hq, int Hkv, int D, int causal, int has_window,
                        int window, int has_softcap, float softcap, float scale,
                        int q_offset, int dtype, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || B <= 0 || Sq <= 0 || Sk <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_d<float>(D, q, k, v, o, B, Sq, Sk, Hq, Hkv, causal, has_window,
                                  window, has_softcap, softcap, scale, q_offset, s);
  if (dtype == 1)
    return (int)dispatch_d<__nv_bfloat16>(D, q, k, v, o, B, Sq, Sk, Hq, Hkv, causal,
                                          has_window, window, has_softcap, softcap, scale,
                                          q_offset, s);
  return (int)cudaErrorInvalidValue;
}

const char* kernel_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
