// RWKV-6 (Finch) WKV recurrence for Hopper (sm_90a), plain CUDA C++.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/rwkv6/rwkv6.py::wkv6 (body _wkv6_kernel): per (b, h),
//   with an fp32 state S[K, V] (optionally s0),
//     y_t[v] = sum_k r_t[k] * (S[k, v] + u[k] * k_t[k] * v_t[v])
//     S[k, v] <- w_t[k] * S[k, v] + k_t[k] * v_t[v]
//   over r/k/w [B, T, H, K], v [B, T, H, V], u [H, K], returning y [B, T, H, V]
//   in the input dtype and s_final [B, H, K, V] in fp32. K = V = 64.
//
// Bound on this card: 5 floating-point operations per state element per step
// (r*S accumulated into y, 2 as a fused multiply-add; w*S + k*v, 3), against
// reading r, k, v, w once and writing y once, so the operations bound it
// (5 * B*T*H*K*V at the 67 TFLOP/s fp32 rate of the CUDA cores), by about
// 1.6x over the bytes at the serving shape. The bonus term adds nothing per
// state element: sum_k r[k] u[k] k[k] v[v] = v[v] * (sum_k r[k] u[k] k[k]) is
// O(K + V) work per step.
//
// What this design does about it: the Pallas kernel carries S in VMEM scratch
// across a sequential time-block grid axis; CUDA blocks run in no order, so
// one block per (h, b) walks all of T itself, with V = 64 threads and thread v
// holding column S[:, v] in 64 registers from the first step to the last.
// A chunk of 16 steps of r, k, w and v is loaded (all loads issued before any
// is used) and staged in shared memory per __syncthreads; each thread then
// reads r_t, k_t, w_t as 16-byte broadcasts. The bonus term's scalar
// sum_k r[k] u[k] k[k] is reduced once per step while the chunk is staged,
// which leaves four instructions (the 5 operations above) per state element
// per step. The state update is a separate fp32 multiply and add and k*v one
// product (no fused multiply-add), rounding exactly as the plain PyTorch loop
// does, so s_final is bit-identical to it;
// only y's K-sum runs in another order. T needs no tiling: the last chunk is
// masked, and T = 1 (a decode step with a carried s0) is one short chunk.
// s_final may be s0 itself (decode updates its cache in place): each thread
// reads its column of s0 before the first step and writes the same elements
// of s_final after the last, so s0 and s_final are not __restrict__.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int N = 64;      // head size: K = V = N, and threads per block
constexpr int CHUNK = 16;  // time steps staged per __syncthreads
constexpr int WARPS = N / 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(N) wkv6_kernel(
    const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ w, const T* __restrict__ u, const float* s0, T* __restrict__ y,
    float* s_final, int T_len, int H) {
  __shared__ __align__(16) float r_s[CHUNK][N];
  __shared__ __align__(16) float k_s[CHUNK][N];
  __shared__ __align__(16) float w_s[CHUNK][N];
  __shared__ float v_s[CHUNK][N];
  __shared__ float ruk_s[CHUNK][WARPS];

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const long state = ((long)b * H + h) * N * N + tid;  // S[0, tid] of this (b, h)
  const long step = (long)H * N;                       // stride of t in [B, T, H, N]
  const long base = (long)b * T_len * step + (long)h * N + tid;

  float S[N];
#pragma unroll
  for (int i = 0; i < N; ++i) S[i] = s0 != nullptr ? s0[state + (long)i * N] : 0.f;
  const float u_mine = to_f32(u[h * N + tid]);

  for (int t0 = 0; t0 < T_len; t0 += CHUNK) {
    const int n = min(CHUNK, T_len - t0);
    float rv[CHUNK], kv[CHUNK], wv[CHUNK], vv[CHUNK];
#pragma unroll
    for (int i = 0; i < CHUNK; ++i) {
      if (i < n) {
        const long off = base + (long)(t0 + i) * step;
        rv[i] = to_f32(r[off]);
        kv[i] = to_f32(k[off]);
        wv[i] = to_f32(w[off]);
        vv[i] = to_f32(v[off]);
      } else {
        rv[i] = kv[i] = wv[i] = vv[i] = 0.f;
      }
    }
    __syncthreads();  // every thread is done reading the previous chunk
#pragma unroll
    for (int i = 0; i < CHUNK; ++i) {
      r_s[i][tid] = rv[i];
      k_s[i][tid] = kv[i];
      w_s[i][tid] = wv[i];
      v_s[i][tid] = vv[i];
      float p = rv[i] * u_mine * kv[i];  // this thread's k-term of sum_k r u k
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) p += __shfl_xor_sync(0xffffffffu, p, o);
      if ((tid & 31) == 0) ruk_s[i][tid >> 5] = p;
    }
    __syncthreads();

#pragma unroll 1
    for (int i = 0; i < n; ++i) {
      const float4* r4 = reinterpret_cast<const float4*>(r_s[i]);
      const float4* k4 = reinterpret_cast<const float4*>(k_s[i]);
      const float4* w4 = reinterpret_cast<const float4*>(w_s[i]);
      const float vi = v_s[i][tid];
      float y0 = 0.f, y1 = 0.f, y2 = 0.f, y3 = 0.f;
#pragma unroll
      for (int j = 0; j < N / 4; ++j) {
        const float4 rr = r4[j], kk = k4[j], ww = w4[j];
        y0 = fmaf(rr.x, S[4 * j + 0], y0);
        y1 = fmaf(rr.y, S[4 * j + 1], y1);
        y2 = fmaf(rr.z, S[4 * j + 2], y2);
        y3 = fmaf(rr.w, S[4 * j + 3], y3);
        S[4 * j + 0] = __fadd_rn(__fmul_rn(ww.x, S[4 * j + 0]), __fmul_rn(kk.x, vi));
        S[4 * j + 1] = __fadd_rn(__fmul_rn(ww.y, S[4 * j + 1]), __fmul_rn(kk.y, vi));
        S[4 * j + 2] = __fadd_rn(__fmul_rn(ww.z, S[4 * j + 2]), __fmul_rn(kk.z, vi));
        S[4 * j + 3] = __fadd_rn(__fmul_rn(ww.w, S[4 * j + 3]), __fmul_rn(kk.w, vi));
      }
      float ruk = 0.f;
#pragma unroll
      for (int q = 0; q < WARPS; ++q) ruk += ruk_s[i][q];
      const float yv = fmaf(vi, ruk, (y0 + y1) + (y2 + y3));
      y[base + (long)(t0 + i) * step] = from_f32<T>(yv);
    }
  }

#pragma unroll
  for (int i = 0; i < N; ++i) s_final[state + (long)i * N] = S[i];
}

template <typename T>
cudaError_t launch(const void* r, const void* k, const void* v, const void* w,
                   const void* u, const void* s0, void* y, void* s_final, int B,
                   int T_len, int H, cudaStream_t stream) {
  const dim3 grid(H, B);
  wkv6_kernel<T><<<grid, N, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(w), static_cast<const T*>(u), static_cast<const float*>(s0),
      static_cast<T*>(y), static_cast<float*>(s_final), T_len, H);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype of r, k, v, w, u and y: 0 = float32, 1 = bfloat16. s0 and s_final are
// float32; s0 may be null (zero initial state) or equal to s_final, never a
// partial overlap of it. Only K = V = 64 is taken.
// Returns the cudaError_t after the launch.
int wkv6_fwd(const void* r, const void* k, const void* v, const void* w, const void* u,
             const void* s0, void* y, void* s_final, int B, int T_len, int H, int K,
             int V, int dtype, void* stream) {
  if (B <= 0 || T_len <= 0 || H <= 0 || B > 65535 || K != N || V != N)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch<float>(r, k, v, w, u, s0, y, s_final, B, T_len, H, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(r, k, v, w, u, s0, y, s_final, B, T_len, H, s);
  return (int)cudaErrorInvalidValue;
}

const char* kernel_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
