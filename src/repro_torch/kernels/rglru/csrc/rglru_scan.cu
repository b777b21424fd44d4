// RG-LRU diagonal linear scan for Hopper (sm_90a), plain CUDA C++.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/rglru/rglru.py::rglru_scan (body _rglru_kernel):
//   h_t = a_t * h_{t-1} + b_t over [B, T, C], an fp32 carry, optional h0 [B, C],
//   returning h [B, T, C] and h_final [B, C], both in the input dtype.
//
// Bound on this card: two multiply-adds' worth of work per element against
// reading a and b and writing h once, so the bound is the bytes
// (3 * B*T*C * sizeof(T) over 3.35 TB/s).
//
// What this design does about it: one thread per (b, c) channel walks t with
// the carry in a register; neighbouring threads hold neighbouring channels, so
// every load and store of a warp is one contiguous row segment. The time loop
// is unrolled by 16 with all loads of a chunk issued before its arithmetic,
// which keeps 32 loads per thread in flight to cover memory latency with only
// B*C threads. The carry update is a separate multiply and add (no fused
// multiply-add), rounding exactly as the plain PyTorch version does.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 64;
constexpr int UNROLL = 16;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(THREADS) rglru_scan_kernel(
    const T* __restrict__ a, const T* __restrict__ b, const T* __restrict__ h0,
    T* __restrict__ h, T* __restrict__ h_final, int T_len, int C) {
  const int c = blockIdx.x * THREADS + threadIdx.x;
  const int bi = blockIdx.y;
  if (c >= C) return;
  const long base = (long)bi * T_len * C + c;
  float carry = h0 != nullptr ? to_f32(h0[(long)bi * C + c]) : 0.f;

  int t = 0;
  for (; t + UNROLL <= T_len; t += UNROLL) {
    float av[UNROLL], bv[UNROLL];
#pragma unroll
    for (int i = 0; i < UNROLL; ++i) {
      av[i] = to_f32(a[base + (long)(t + i) * C]);
      bv[i] = to_f32(b[base + (long)(t + i) * C]);
    }
#pragma unroll
    for (int i = 0; i < UNROLL; ++i) {
      carry = __fadd_rn(__fmul_rn(av[i], carry), bv[i]);
      h[base + (long)(t + i) * C] = from_f32<T>(carry);
    }
  }
  for (; t < T_len; ++t) {
    carry = __fadd_rn(__fmul_rn(to_f32(a[base + (long)t * C]), carry),
                      to_f32(b[base + (long)t * C]));
    h[base + (long)t * C] = from_f32<T>(carry);
  }
  h_final[(long)bi * C + c] = from_f32<T>(carry);
}

template <typename T>
cudaError_t launch(const void* a, const void* b, const void* h0, void* h, void* h_final,
                   int B, int T_len, int C, cudaStream_t stream) {
  const dim3 grid((C + THREADS - 1) / THREADS, B);
  rglru_scan_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<const T*>(h0),
      static_cast<T*>(h), static_cast<T*>(h_final), T_len, C);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. h0 may be null (zero initial state).
// Returns the cudaError_t after the launch.
int rglru_scan_fwd(const void* a, const void* b, const void* h0, void* h, void* h_final,
                   int B, int T_len, int C, int dtype, void* stream) {
  if (B <= 0 || T_len <= 0 || C <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(a, b, h0, h, h_final, B, T_len, C, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(a, b, h0, h, h_final, B, T_len, C, s);
  return (int)cudaErrorInvalidValue;
}

const char* kernel_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
