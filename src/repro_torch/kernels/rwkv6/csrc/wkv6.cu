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
// 1.6x over the bytes at the serving shape. An exact state update issues 4
// instructions per element (a fused multiply-add for y; w*S, k*v and their
// sum rounded separately), so its own floor is 4 * B*T*H*K*V lane-instructions
// at 128 lanes per SM per cycle, about 1.6x that bound. The bonus term adds
// nothing per state element: sum_k r[k] u[k] k[k] v[v] = v[v] * (sum_k r[k]
// u[k] k[k]) is O(K + V) work per step.
//
// What this design does about it:
//   * The columns of S are independent, so the state is split over many
//     threads: grid (H, B, V / VS), (VS / VT) * KSPLIT threads a block, and
//     thread (cg, kq) holds the KS x VT tile S[kq*KS : (kq+1)*KS,
//     cg*VT : (cg+1)*VT] (KS = K / KSPLIT) in registers from the first step to
//     the last. At the serving shape (VS 64, KSPLIT 8, VT 4) that is 256
//     blocks of 4 warps, two blocks an SM, each thread walking 32 state
//     elements a step.
//   * Why a tile and not one column a thread: a thread reads r, k and w of
//     its KS rows once a step for all VT columns, so shared-memory traffic
//     per state element falls by VT; and with KSPLIT 8 a block holds all 64
//     columns, so a (b, h) is staged and widened once, not once per slice.
//   * No lane waits on another within a step: each thread stores its VT
//     partial K-sums of y to shared memory (a 16-byte store), and the block
//     sums the KSPLIT partials of a chunk's steps in one sweep, four columns a
//     thread, writing whole rows of y. A quarter-warp reads at most two r/k/w
//     addresses (a broadcast) and the partial-y rows are padded, so no access
//     has a bank conflict; a warp's s0 loads and s_final stores are 16-byte
//     vectors covering whole 32-byte sectors.
//   * Two steps' operands are in registers at a time: step t + 1's r, k, w, v
//     are read from shared memory while step t's arithmetic runs.
//   * Time is staged in chunks of CHUNK steps through a ring of NSTAGE chunks
//     in shared memory, filled with 16-byte cp.async NSTAGE - 1 chunks ahead
//     of the math (each thread always copies the same piece of a step), so no
//     thread waits on device memory at a chunk boundary. The block widens
//     each staged value to fp32 once, into one of two fp32 buffers, and
//     reduces the bonus scalar sum_k r u k once per step there, while the
//     previous chunk's y is swept from the other buffer: two barriers a chunk.
//   * The state update is a separate fp32 multiply and add and k*v one
//     product (no fused multiply-add), rounding exactly as the plain PyTorch
//     loop does, so s_final is bit-identical to it; only y's K-sum runs in
//     another order.
// T needs no tiling: steps past T are zero-filled and not computed, and T = 1
// (a decode step with a carried s0) is one short chunk. s_final may be s0
// itself (decode updates its cache in place): each thread reads its elements
// of s0 before the first step and writes the same elements of s_final after
// the last, so s0 and s_final are not __restrict__.
//
// WKV_VS, WKV_KSPLIT, WKV_VT, WKV_CHUNK and WKV_NSTAGE may be defined before
// this file is compiled (scripts/ablate_wkv6_sm90.py does); the defaults are
// the design that ships, chosen from its measurements.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef WKV_VS
#define WKV_VS 64
#endif
#ifndef WKV_KSPLIT
#define WKV_KSPLIT 8
#endif
#ifndef WKV_VT
#define WKV_VT 4
#endif
#ifndef WKV_CHUNK
#define WKV_CHUNK 16
#endif
#ifndef WKV_NSTAGE
#define WKV_NSTAGE 3
#endif

namespace {

constexpr int N = 64;                 // head size: K = V = N
constexpr int VS = WKV_VS;            // columns of S a block holds
constexpr int KSPLIT = WKV_KSPLIT;    // threads sharing one column group
constexpr int VT = WKV_VT;            // columns a thread holds
constexpr int KS = N / KSPLIT;        // rows a thread holds
constexpr int CGW = 32 / KSPLIT;      // column groups a warp holds
constexpr int NT = VS / VT * KSPLIT;  // threads a block
constexpr int CHUNK = WKV_CHUNK;      // steps staged together
constexpr int NSTAGE = WKV_NSTAGE;    // chunks in the ring
constexpr int ROW = 3 * N + VS;       // one step: r, k, w (N each), v (VS)
constexpr int YROW = VS + 16;         // a k slice's partial y of one step (padded)
constexpr int G = NT / CHUNK;         // threads reducing one step's sum_k r u k
constexpr int VQ = VS / 4;            // groups of 4 columns in y's sweep

static_assert(N % KSPLIT == 0 && 32 % KSPLIT == 0 && KS % 4 == 0, "k split");
static_assert(VT % 4 == 0, "columns a thread: whole 16-byte vectors");
static_assert(N % VS == 0 && VS % VT == 0 && (VS / VT) % CGW == 0 && VS % 16 == 0,
              "column slice");
static_assert(NT <= 1024 && NT % 32 == 0 && NT % VQ == 0, "block size");
static_assert(NT % CHUNK == 0 && G <= 32 && (G & (G - 1)) == 0 && N % G == 0, "sum_k r u k");
static_assert(NSTAGE >= 2, "ring");

template <typename T> constexpr size_t smem_bytes() {
  // the raw ring, two fp32 chunks and a row past them (read, never used, by
  // the step loop's last prefetch), the partial y, two chunks' sum_k r u k, u
  return (size_t)NSTAGE * CHUNK * ROW * sizeof(T) + (size_t)(2 * CHUNK + 1) * ROW * 4 +
         (size_t)CHUNK * KSPLIT * YROW * 4 + 2 * CHUNK * 4 + N * 4;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// 16 bytes of T at src (shared) to fp32 at dst: 4 floats copied, or 8 bf16
// widened (a bf16 is the high half of the fp32 with the same value).
__device__ __forceinline__ void widen16(const float* src, float* dst) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
}
__device__ __forceinline__ void widen16(const __nv_bfloat16* src, float* dst) {
  const uint4 x = *reinterpret_cast<const uint4*>(src);
  *reinterpret_cast<float4*>(dst) =
      make_float4(__uint_as_float(x.x << 16), __uint_as_float(x.x & 0xffff0000u),
                  __uint_as_float(x.y << 16), __uint_as_float(x.y & 0xffff0000u));
  *reinterpret_cast<float4*>(dst + 4) =
      make_float4(__uint_as_float(x.z << 16), __uint_as_float(x.z & 0xffff0000u),
                  __uint_as_float(x.w << 16), __uint_as_float(x.w & 0xffff0000u));
}

// 4 floats rounded to T, to dst (global, aligned to 4 elements).
__device__ __forceinline__ void store4(float* dst, float4 x) {
  *reinterpret_cast<float4*>(dst) = x;
}
__device__ __forceinline__ void store4(__nv_bfloat16* dst, float4 x) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(x.x, x.y), hi = __floats2bfloat162_rn(x.z, x.w);
  *reinterpret_cast<uint2*>(dst) =
      make_uint2(*reinterpret_cast<const uint32_t*>(&lo), *reinterpret_cast<const uint32_t*>(&hi));
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// 16 bytes global -> shared, or 16 zero bytes when !valid (nothing is read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int n> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

template <typename T>
__global__ void __launch_bounds__(NT) wkv6_kernel(
    const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ w, const T* __restrict__ u, const float* s0, T* __restrict__ y,
    float* s_final, int T_len, int H) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* raw = reinterpret_cast<T*>(smem);                                  // [NSTAGE][CHUNK][ROW]
  float* fs0 = reinterpret_cast<float*>(smem + (size_t)NSTAGE * CHUNK * ROW * sizeof(T));
  float* yp = fs0 + (2 * CHUNK + 1) * ROW;   // [CHUNK][KSPLIT][YROW], after [2][CHUNK][ROW] + a row
  float* ruk0 = yp + CHUNK * KSPLIT * YROW;  // [2][CHUNK]
  float* u_s = ruk0 + 2 * CHUNK;             // [N]

  const int h = blockIdx.x, b = blockIdx.y, v0 = blockIdx.z * VS, tid = threadIdx.x;
  const int lane = tid & 31;
  const int cg = (tid >> 5) * CGW + (lane % CGW);  // column group within the slice
  const int kq = lane / CGW;                       // row slice
  const long step = (long)H * N;                   // stride of t in [B, T, H, N]
  const long row0 = (long)b * T_len * step + (long)h * N;
  const int n_chunks = (T_len + CHUNK - 1) / CHUNK;

  // Chunk c into ring stage st: per step, r, k, w rows of N and v's slice,
  // PS pieces of 16 bytes; piece q of step t comes from its array at
  // t * step and goes to column `col_q` of the step's row in the stage. NT is
  // a multiple of PS, so a thread always copies the same piece of a step.
  constexpr int EP = 16 / (int)sizeof(T);       // elements a piece
  constexpr int PR = N / EP;                    // pieces of a row
  constexpr int PS = 3 * PR + VS / EP;          // of one step
  constexpr int PIECES = CHUNK * PS;            // of a chunk
  static_assert(NT % PS == 0 && PIECES % NT == 0 && (CHUNK * ROW / EP) % NT == 0,
                "a chunk's pieces fall evenly on the block's threads");
  const int q = tid % PS;
  const int a_q = min(q / PR, 3);               // 0 r, 1 k, 2 w, 3 v
  const int off_q = (q - a_q * PR) * EP;        // element within its row
  const int col_q = a_q * N + off_q;
  const T* src_q = (a_q == 0 ? r : a_q == 1 ? k : a_q == 2 ? w : v + v0) + row0 + off_q;
  auto issue = [&](int c, int st) {
    T* dst = raw + (size_t)st * CHUNK * ROW;
#pragma unroll
    for (int m = 0; m < PIECES / NT; ++m) {
      const int i = (tid + m * NT) / PS, t = c * CHUNK + i;
      const bool valid = t < T_len;
      cp_async16(dst + i * ROW + col_q, src_q + (long)(valid ? t : 0) * step, valid);
    }
  };

#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s) {
    if (s < n_chunks) issue(s, s);
    cp_async_commit();  // empty groups keep the count uniform
  }
  if (tid < N) u_s[tid] = to_f32(u[h * N + tid]);

  // S[kq*KS + i][v0 + cg*VT + j] of this (b, h) at state + i*N + j
  const long state = ((long)b * H + h) * N * N + (long)(kq * KS) * N + v0 + cg * VT;
  float S[KS][VT];
#pragma unroll
  for (int i = 0; i < KS; ++i) {
#pragma unroll
    for (int j = 0; j < VT; j += 4) {
      const float4 x = s0 != nullptr
          ? *reinterpret_cast<const float4*>(s0 + state + (long)i * N + j)
          : make_float4(0.f, 0.f, 0.f, 0.f);
      S[i][j] = x.x, S[i][j + 1] = x.y, S[i][j + 2] = x.z, S[i][j + 3] = x.w;
    }
  }

  // one step's operands of this thread: r, k, w of its rows, v of its columns
  struct Operands {
    float r[KS], k[KS], w[KS], v[VT];
  };
  auto fetch = [&](const float* row, Operands& o) {
#pragma unroll
    for (int i = 0; i < KS; i += 4) {
      const float4 r4 = load4(row + kq * KS + i);
      const float4 k4 = load4(row + N + kq * KS + i);
      const float4 w4 = load4(row + 2 * N + kq * KS + i);
      o.r[i] = r4.x, o.r[i + 1] = r4.y, o.r[i + 2] = r4.z, o.r[i + 3] = r4.w;
      o.k[i] = k4.x, o.k[i + 1] = k4.y, o.k[i + 2] = k4.z, o.k[i + 3] = k4.w;
      o.w[i] = w4.x, o.w[i + 1] = w4.y, o.w[i + 2] = w4.z, o.w[i + 3] = w4.w;
    }
#pragma unroll
    for (int j = 0; j < VT; j += 4) {
      const float4 v4 = load4(row + 3 * N + cg * VT + j);
      o.v[j] = v4.x, o.v[j + 1] = v4.y, o.v[j + 2] = v4.z, o.v[j + 3] = v4.w;
    }
  };
  // one step: y's partial sum over this thread's rows, then the state update
  auto advance = [&](const Operands& o, float* y_part) {
    float yv[VT];
#pragma unroll
    for (int j = 0; j < VT; ++j) yv[j] = 0.f;
#pragma unroll
    for (int i = 0; i < KS; ++i) {
#pragma unroll
      for (int j = 0; j < VT; ++j) {
        yv[j] = fmaf(o.r[i], S[i][j], yv[j]);
        S[i][j] = __fadd_rn(__fmul_rn(o.w[i], S[i][j]), __fmul_rn(o.k[i], o.v[j]));
      }
    }
#pragma unroll
    for (int j = 0; j < VT; j += 4)
      *reinterpret_cast<float4*>(y_part + j) = make_float4(yv[j], yv[j + 1], yv[j + 2], yv[j + 3]);
  };

  // y of chunk c (n steps): the k slices' partial sums, plus v * sum_k r u k,
  // four columns a thread; a warp writes whole rows of the slice
  const int vc = (tid % VQ) * 4;
  auto sweep = [&](int c, int n) {
    const float* fs = fs0 + (c & 1) * CHUNK * ROW;
    const float* ruk_s = ruk0 + (c & 1) * CHUNK;
#pragma unroll
    for (int m = 0; m < (CHUNK * VQ + NT - 1) / NT; ++m) {
      const int t = tid / VQ + m * (NT / VQ);
      if (t >= n) break;
      const float* part = yp + t * KSPLIT * YROW + vc;
      float4 acc = load4(part);
#pragma unroll
      for (int q = 1; q < KSPLIT; ++q) {
        const float4 x = load4(part + q * YROW);
        acc.x += x.x, acc.y += x.y, acc.z += x.z, acc.w += x.w;
      }
      const float4 vv = load4(fs + t * ROW + 3 * N + vc);
      const float ruk = ruk_s[t];
      store4(y + row0 + (long)(c * CHUNK + t) * step + v0 + vc,
             make_float4(fmaf(vv.x, ruk, acc.x), fmaf(vv.y, ruk, acc.y),
                         fmaf(vv.z, ruk, acc.z), fmaf(vv.w, ruk, acc.w)));
    }
  };

  // Per chunk c, two barriers: after the first, chunk c is widened into one
  // fp32 buffer while chunk c - 1's y is swept from the other; after the
  // second, chunk c's steps run.
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<NSTAGE - 2>();  // this thread's pieces of chunk c are in
    __syncthreads();              // everyone's are; everyone is done with chunk c - 1's steps
    if (c + NSTAGE - 1 < n_chunks) issue(c + NSTAGE - 1, (c + NSTAGE - 1) % NSTAGE);
    cp_async_commit();

    // one sweep: the chunk to fp32, and sum_k r u k per step
    const T* src = raw + (size_t)(c % NSTAGE) * CHUNK * ROW;
    float* fs = fs0 + (c & 1) * CHUNK * ROW;
#pragma unroll
    for (int m = 0; m < CHUNK * ROW / EP / NT; ++m) {
      const int e = tid + m * NT;
      widen16(src + e * EP, fs + e * EP);
    }
    {
      const int i = tid / G, j = tid % G;
      float p = 0.f;
#pragma unroll
      for (int kk = j; kk < N; kk += G)
        p += to_f32(src[i * ROW + kk]) * u_s[kk] * to_f32(src[i * ROW + N + kk]);
#pragma unroll
      for (int o = G / 2; o > 0; o >>= 1) p += __shfl_xor_sync(0xffffffffu, p, o);
      if (j == 0) ruk0[(c & 1) * CHUNK + i] = p;
    }
    if (c > 0) sweep(c - 1, CHUNK);
    __syncthreads();

    // the chunk's steps: the state update, and each k slice's partial y into
    // shared memory (no lane waits on another within a step). Two steps'
    // operands are in registers at a time: step t + 1's are read from shared
    // memory while step t's arithmetic runs.
    const int n = min(CHUNK, T_len - c * CHUNK);
    Operands a, b2;
    fetch(fs, a);
    for (int t = 0; t < n; t += 2) {
      fetch(fs + (t + 1) * ROW, b2);  // past n it reads rows nobody writes now
      advance(a, yp + (t * KSPLIT + kq) * YROW + cg * VT);
      if (t + 1 < n) {
        fetch(fs + (t + 2) * ROW, a);
        advance(b2, yp + ((t + 1) * KSPLIT + kq) * YROW + cg * VT);
      }
    }
  }
  __syncthreads();
  sweep(n_chunks - 1, T_len - (n_chunks - 1) * CHUNK);
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < KS; ++i) {
#pragma unroll
    for (int j = 0; j < VT; j += 4)
      *reinterpret_cast<float4*>(s_final + state + (long)i * N + j) =
          make_float4(S[i][j], S[i][j + 1], S[i][j + 2], S[i][j + 3]);
  }
}

template <typename T>
cudaError_t launch(const void* r, const void* k, const void* v, const void* w,
                   const void* u, const void* s0, void* y, void* s_final, int B,
                   int T_len, int H, cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      wkv6_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes<T>());
  if (e != cudaSuccess) return e;
  const dim3 grid(H, B, N / VS);
  wkv6_kernel<T><<<grid, NT, smem_bytes<T>(), stream>>>(
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

// The design's constants: [VS, KSPLIT, VT, CHUNK, NSTAGE, threads a block].
void wkv6_design(int* out) {
  out[0] = VS;
  out[1] = KSPLIT;
  out[2] = VT;
  out[3] = CHUNK;
  out[4] = NSTAGE;
  out[5] = NT;
}

// Dynamic shared memory a block takes (dtype as for wkv6_fwd; 0 otherwise).
int wkv6_smem_bytes(int dtype) {
  return dtype == 0 ? (int)smem_bytes<float>()
                    : dtype == 1 ? (int)smem_bytes<__nv_bfloat16>() : 0;
}

const char* kernel_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
