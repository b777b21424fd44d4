// RG-LRU diagonal linear scan for Hopper (sm_90a), plain CUDA C++.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/rglru/rglru.py::rglru_scan (body _rglru_kernel):
//   h_t = a_t * h_{t-1} + b_t over [B, T, C], an fp32 carry, optional h0 [B, C],
//   returning h [B, T, C] and h_final [B, C], both in a's dtype. Each input is
//   read in its own dtype, as the Pallas kernel does: the pairs (a, b) taken are
//   (fp32, fp32), (bf16, bf16) and (bf16, fp32). The last is the training
//   backward under bf16 compute, the scan run again on the reversed bf16 decay
//   and the fp32 upstream gradient (src/repro/kernels/rglru/ops.py::_scan_bwd).
//
// Bound on this card: two operations per element against reading a and b and
// writing h once, so the bound is the bytes ((2 sizeof(a) + sizeof(b)) * B*T*C
// over 3.35 TB/s). Reaching it takes about 3 MB of loads in flight across the card
// (3.35 TB/s times a memory round trip of about 1 us).
//
// What this design does about it (the ring path):
//   * One thread per (b, c) channel still walks t with the carry in a
//     register: a separate fp32 multiply and add (no fused multiply-add),
//     rounding exactly as the plain PyTorch loop does, so h is bit-identical.
//   * A block holds CT neighbouring channels of one batch row. Its thread 0
//     issues TMA loads through 3-D tensor maps over (C, T, B) -- the [B, T, C]
//     tensors read in place, zero-filled past T and C -- of [TS steps x CT
//     channels] boxes of a and b into a ring of NST stages in shared memory,
//     one mbarrier a stage, and refills a stage as soon as the block is done
//     with it. At the serving shape (B 4, C 4096, bf16) that is 256 blocks
//     with up to NST - 1 = 5 stages of 8 KB each in flight, about 10 MB.
//   * The channel threads read a_t and b_t from the ring (a warp reads one
//     contiguous 64-byte row) and write h into one of two shared-memory
//     stages, which thread 0 drains by TMA stores (clipped at T and C).
//   * A row stride that is not a multiple of 16 bytes (bf16 with C % 8 != 0,
//     in a or in b) cannot be mapped by TMA; such a C takes the simple path below, one
//     thread per channel loading its own chunks of 16 steps into registers.
//     The caller picks the path (ops.route_for) and passes it to
//     rglru_scan_fwd.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CT = 64;        // channels (threads) a block, ring path
constexpr int TS = 32;        // steps a ring stage
constexpr int NST = 6;        // ring stages
constexpr int THREADS = 64;   // simple path
constexpr int UNROLL = 16;    // simple path: steps loaded before their arithmetic

static_assert(CT % 32 == 0 && CT <= 256 && TS <= 256 && NST >= 2, "ring shape");

template <typename TA, typename TB> constexpr size_t smem_bytes() {
  // 128 for aligning the tiles, the a and b ring, two h stages (a's dtype), the
  // barriers. Every tile is a multiple of 128 bytes, so each stays aligned.
  return 128 + (size_t)NST * TS * CT * (sizeof(TA) + sizeof(TB)) +
         (size_t)2 * TS * CT * sizeof(TA) + 8 * NST;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// A wait that has not ended after ~2^34 cycles (seconds) traps, so a broken
// pipeline ends in a launch error instead of a hung card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long t0 = clock64();
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > (1ll << 34)) __trap();
  }
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, uint32_t src, int c0,
                                             int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

template <typename TA, typename TB>
__global__ void __launch_bounds__(CT) rglru_scan_kernel_ring(
    const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_b,
    const __grid_constant__ CUtensorMap tm_h, const TA* __restrict__ h0,
    TA* __restrict__ h_final, int T_len, int C) {
  extern __shared__ unsigned char smem_raw[];
  constexpr int TILE = TS * CT;  // elements of one box
  constexpr uint32_t STAGE_BYTES = TILE * (sizeof(TA) + sizeof(TB));  // a and b
  TA* a_s = reinterpret_cast<TA*>((reinterpret_cast<uintptr_t>(smem_raw) + 127) &
                                  ~uintptr_t(127));
  TB* b_s = reinterpret_cast<TB*>(a_s + NST * TILE);  // [NST][TS][CT] each
  TA* h_s = reinterpret_cast<TA*>(b_s + NST * TILE);  // [2][TS][CT]
  uint64_t* full = reinterpret_cast<uint64_t*>(h_s + 2 * TILE);

  const int tid = threadIdx.x, c0 = blockIdx.x * CT, bi = blockIdx.y, c = c0 + tid;
  const int n_chunks = (T_len + TS - 1) / TS;
  auto load = [&](int chunk, int st) {
    const uint32_t bar = smem_u32(full + st);
    mbar_expect_tx(bar, STAGE_BYTES);
    tma_load_3d(smem_u32(a_s + st * TILE), &tm_a, bar, c0, chunk * TS, bi);
    tma_load_3d(smem_u32(b_s + st * TILE), &tm_b, bar, c0, chunk * TS, bi);
  };

  if (tid == 0) {
    for (int st = 0; st < NST; ++st) mbar_init(smem_u32(full + st), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int st = 0; st < min(NST, n_chunks); ++st) load(st, st);
  }
  float carry = h0 != nullptr && c < C ? to_f32(h0[(long)bi * C + c]) : 0.f;
  __syncthreads();

  for (int ch = 0; ch < n_chunks; ++ch) {
    const int st = ch % NST;
    mbar_wait(smem_u32(full + st), (ch / NST) & 1);
    const TA* as = a_s + st * TILE + tid;
    const TB* bs = b_s + st * TILE + tid;
    TA* hs = h_s + (ch & 1) * TILE + tid;
    const int n = min(TS, T_len - ch * TS);
    if (n == TS) {
#pragma unroll
      for (int i = 0; i < TS; ++i) {
        carry = __fadd_rn(__fmul_rn(to_f32(as[i * CT]), carry), to_f32(bs[i * CT]));
        hs[i * CT] = from_f32<TA>(carry);
      }
    } else {
      for (int i = 0; i < n; ++i) {
        carry = __fadd_rn(__fmul_rn(to_f32(as[i * CT]), carry), to_f32(bs[i * CT]));
        hs[i * CT] = from_f32<TA>(carry);
      }
    }
    // the store of chunk ch - 1 has read its h stage, which chunk ch + 1 reuses
    if (tid == 0) asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");  // h_s to the TMA unit
    __syncthreads();  // every thread is done with stage st and has written its h
    if (tid == 0) {
      tma_store_3d(&tm_h, smem_u32(h_s + (ch & 1) * TILE), c0, ch * TS, bi);
      if (ch + NST < n_chunks) load(ch + NST, st);
    }
  }
  if (c < C) h_final[(long)bi * C + c] = from_f32<TA>(carry);
  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

template <typename TA, typename TB>
__global__ void __launch_bounds__(THREADS) rglru_scan_kernel_simple(
    const TA* __restrict__ a, const TB* __restrict__ b, const TA* __restrict__ h0,
    TA* __restrict__ h, TA* __restrict__ h_final, int T_len, int C) {
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
      h[base + (long)(t + i) * C] = from_f32<TA>(carry);
    }
  }
  for (; t < T_len; ++t) {
    carry = __fadd_rn(__fmul_rn(to_f32(a[base + (long)t * C]), carry),
                      to_f32(b[base + (long)t * C]));
    h[base + (long)t * C] = from_f32<TA>(carry);
  }
  h_final[(long)bi * C + c] = from_f32<TA>(carry);
}

// ---- host side -------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver function: fetch it through the runtime,
// so the library needs no link against libcuda.
EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &res);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                            &res);
#endif
    if (e == cudaSuccess && res == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

// A [B, T, C] tensor as a 3-D map over (C, T, B), boxes of CT channels x TS
// steps of one batch row, no swizzle, zero fill past the edges.
template <typename T>
bool make_map(CUtensorMap* map, const void* ptr, int B, int T_len, int C) {
  EncodeTiled enc = encode_fn();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)C, (cuuint64_t)T_len, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)C * sizeof(T), (cuuint64_t)T_len * C * sizeof(T)};
  const cuuint32_t box[3] = {(cuuint32_t)CT, (cuuint32_t)TS, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUtensorMapDataType type =
      sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  return enc(map, type, 3, const_cast<void*>(ptr), dims, strides, box, elem,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename TA, typename TB>
cudaError_t launch(const void* a, const void* b, const void* h0, void* h, void* h_final,
                   int B, int T_len, int C, int ring, cudaStream_t stream) {
  if (ring) {
    // TMA cannot map a row that is not a multiple of 16 bytes
    if ((long)C * sizeof(TA) % 16 != 0 || (long)C * sizeof(TB) % 16 != 0)
      return cudaErrorInvalidValue;
    CUtensorMap ta, tb, th;
    if (!make_map<TA>(&ta, a, B, T_len, C) || !make_map<TB>(&tb, b, B, T_len, C) ||
        !make_map<TA>(&th, h, B, T_len, C))
      return cudaErrorInvalidValue;
    const cudaError_t e = cudaFuncSetAttribute(rglru_scan_kernel_ring<TA, TB>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem_bytes<TA, TB>());
    if (e != cudaSuccess) return e;
    const dim3 grid((C + CT - 1) / CT, B);
    rglru_scan_kernel_ring<TA, TB><<<grid, CT, smem_bytes<TA, TB>(), stream>>>(
        ta, tb, th, static_cast<const TA*>(h0), static_cast<TA*>(h_final), T_len, C);
    return cudaGetLastError();
  }
  const dim3 grid((C + THREADS - 1) / THREADS, B);
  rglru_scan_kernel_simple<TA, TB><<<grid, THREADS, 0, stream>>>(
      static_cast<const TA*>(a), static_cast<const TB*>(b), static_cast<const TA*>(h0),
      static_cast<TA*>(h), static_cast<TA*>(h_final), T_len, C);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype, dtype_b: a's and b's dtype, 0 = float32, 1 = bfloat16; the pairs
// (0, 0), (1, 1) and (1, 0). h0, h and h_final are in a's dtype; h0 may be null
// (zero initial state). ring: 1 the TMA ring path (a row of C elements of a and
// of b must be a multiple of 16 bytes), 0 the simple path. Returns the
// cudaError_t after the launch.
int rglru_scan_fwd(const void* a, const void* b, const void* h0, void* h, void* h_final,
                   int B, int T_len, int C, int dtype, int dtype_b, int ring, void* stream) {
  if (B <= 0 || T_len <= 0 || C <= 0 || B > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && dtype_b == 0)
    return (int)launch<float, float>(a, b, h0, h, h_final, B, T_len, C, ring, s);
  if (dtype == 1 && dtype_b == 1)
    return (int)launch<__nv_bfloat16, __nv_bfloat16>(a, b, h0, h, h_final, B, T_len, C,
                                                     ring, s);
  if (dtype == 1 && dtype_b == 0)
    return (int)launch<__nv_bfloat16, float>(a, b, h0, h, h_final, B, T_len, C, ring, s);
  return (int)cudaErrorInvalidValue;
}

// The ring's constants: [channels a block, steps a stage, stages].
void rglru_scan_design(int* out) {
  out[0] = CT;
  out[1] = TS;
  out[2] = NST;
}

// Dynamic shared memory a ring block takes (dtype pair as above; 0 otherwise).
int rglru_scan_smem_bytes(int dtype, int dtype_b) {
  if (dtype == 0 && dtype_b == 0) return (int)smem_bytes<float, float>();
  if (dtype == 1 && dtype_b == 1) return (int)smem_bytes<__nv_bfloat16, __nv_bfloat16>();
  if (dtype == 1 && dtype_b == 0) return (int)smem_bytes<__nv_bfloat16, float>();
  return 0;
}

const char* kernel_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
