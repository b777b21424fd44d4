// Flash attention forward for Hopper (sm_90a) on the tensor cores: bf16
// wgmma on TMA-fed tiles in a shared-memory ring.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/flash_attention.py:103 flash_attention_fwd
//   (body _attn_kernel): online-softmax attention with GQA (kv head = h / group),
//   causal mask col <= row, window mask col > row - window (row counted from
//   q_offset), logit softcap c*tanh(s/c) before the mask, fp32 running max / sum
//   / accumulator, and 0 for a query row that sees no key.
// It takes bf16 inputs with head_dim 64, 128 or 256; flash_attention.cu keeps
// fp32 inputs and head_dim 16 and 32.
//
// Bound on this card: at the serving shapes (thousands of keys per row) the
// work is 4*D operations per visible (query, key) pair against reading q, k,
// v and writing o once, far above the H100's ~295 flop/byte ridge, so the
// bound is the operations at the bf16 tensor-core rate (989 TFLOP/s). Only
// wgmma reaches that rate; the fp32 CUDA cores top out at 67 TFLOP/s, which
// is why the older kernel cannot come near it.
//
// What the design does about it:
//   * One block per (q tile of 128 rows, q head, batch): two warpgroups of 64
//     query rows each, 256 threads. At D 256 a warpgroup holds its O rows
//     (64 x D fp32, 128 registers a thread), one S tile and P: ptxas takes 237
//     registers and keeps the wgmmas in flight, one block an SM. At D 64 the
//     O rows take 32 registers a thread, so the block is built for
//     FA_D64_BLOCKS_PER_SM blocks an SM (at most 128 registers a thread at
//     2): the second block's wgmmas cover the first's softmax, which at D 64
//     costs as much as its products (4 * 64 operations a score on the
//     tensor cores against an exp2 and a few fp32 operations).
//     (A third, producer warpgroup with setmaxnreg 24 / 240 left the
//     consumers spilling and their wgmmas serialised under nvcc 12.9.)
//   * TMA with a 4-D tensor map over the model's [B, S, H, D] layout, read in
//     place, 128-byte swizzle, one box per 64-column slab of D. A tile past S
//     is zero-filled, never the next batch's rows. Q is loaded once; K and V
//     tiles of 64 keys go through a ring (2 stages at D 256, 4 at D 128,
//     FA_D64_STAGES at D 64, where a stage is 16 KB): a full mbarrier per
//     stage, and the last of the 8 warps to finish with a stage issues its
//     refill, so loads run STAGES - 1 tiles ahead of the math without a
//     producer warp.
//   * q tiles are scheduled heaviest first (the tile index is the slowest grid
//     dimension, walked down), which shortens the causal tail of the grid.
//   * S = Q K^T with wgmma m64n64k16, both operands K-major in shared memory.
//     The scale 1/sqrt(D) (times log2 e, for exp2) goes on the fp32
//     accumulator, not on bf16 q.
//   * Softcap, masks and the online max / sum in registers, in the wgmma
//     accumulator layout (a row's 16 values per thread sit in one quad of
//     lanes); masks only on tiles that cross the causal diagonal, the window
//     edge or S_k; tiles wholly outside the band are neither loaded nor used.
//     Ragged S_q and S_k (whisper's 1500 frames: 11 q tiles and 92 rows, 23
//     key tiles and 28 keys) are zero-filled by TMA and masked, never padded.
//   * O += P V with P as bf16 A fragments straight from the S registers
//     (wgmma's register-A form) and V as an MN-major B operand, one
//     m64n64k16 per 64-column slab of V.
//   * The two warpgroups of a block run their softmax and their products out
//     of step, so one warpgroup's tensor-core work covers the other's
//     softmax.
//   * Not done: a cluster of 2 CTAs (two q heads of one kv head) with the K/V
//     tiles multicast by TMA was correct but slower at every serving shape:
//     a stage can be refilled only when all 16 warps of both CTAs are done
//     with it, and that wait cost more than the halved L2 reads saved.
//
// FA_D64_STAGES and FA_D64_BLOCKS_PER_SM may be defined before this file to
// build another design point at D 64 (scripts/ablate_flash_sm90.py times
// them against the defaults below).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef FA_D64_STAGES
#define FA_D64_STAGES 4
#endif
#ifndef FA_D64_BLOCKS_PER_SM
#define FA_D64_BLOCKS_PER_SM 2
#endif

namespace {

constexpr int BQ = 128;        // query rows per block (64 per warpgroup)
constexpr int BK = 64;         // keys per K/V tile
constexpr int NTHREADS = 256;  // 2 warpgroups of 64 query rows each
constexpr float NEG = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

#define HD __host__ __device__
HD constexpr int slab_q_bytes() { return BQ * 128; }  // 128 rows x 64 bf16
HD constexpr int slab_kv_bytes() { return BK * 128; }  // 64 rows x 64 bf16
template <int D> HD constexpr int stages() { return D == 256 ? 2 : D == 128 ? 4 : FA_D64_STAGES; }
template <int D> HD constexpr int q_bytes() { return (D / 64) * slab_q_bytes(); }
template <int D> HD constexpr int kv_bytes() { return (D / 64) * slab_kv_bytes(); }
template <int D> HD constexpr size_t smem_bytes() {
  // 1024 for aligning the swizzled tiles, then Q, the ring, the barriers
  return 1024 + q_bytes<D>() + 2 * stages<D>() * kv_bytes<D>() + 8 * (1 + stages<D>()) +
         4 * stages<D>();
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers -------------------------------------------------------------

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

// ---- TMA -------------------------------------------------------------------

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// ---- wgmma -----------------------------------------------------------------

// Shared-memory matrix descriptor, 128-byte swizzle. lbo / sbo in bytes.
__device__ __forceinline__ uint64_t make_desc(uint32_t saddr, uint32_t lbo, uint32_t sbo) {
  uint64_t d = (uint64_t)((saddr & 0x3FFFF) >> 4);
  d |= (uint64_t)((lbo >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)((sbo >> 4) & 0x3FFF) << 32;
  d |= (uint64_t)1 << 62;
  return d;
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

// A value the compiler cannot see through: descriptors derived from it are
// computed where they are used, not hoisted out of the KV loop into registers
// that the accumulators need.
__device__ __forceinline__ uint64_t opaque(uint64_t x) {
  asm volatile("" : "+l"(x));
  return x;
}

// Keep the compiler from touching accumulators while a wgmma is in flight.
__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define ACC32_OUT(d)                                                                          \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),        \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),              \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),           \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),           \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),           \
      "+f"(d[31])
#define ACC32_REGS                                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d (+)= A B, A and B K-major in shared memory (64 x 16 and 64 x 16 bf16).
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " ACC32_REGS
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : ACC32_OUT(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A B, A (64 x 16 bf16) in registers, B (16 x 64) MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " ACC32_REGS
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : ACC32_OUT(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// ---- the kernel ------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(NTHREADS, D == 64 ? FA_D64_BLOCKS_PER_SM : 1)
    flash_fwd_sm90(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o,
                   int Sq, int Sk, int Hq, int Hkv, int causal, int has_window, int window,
                   int has_softcap, float softcap, float scale, int q_offset) {
  constexpr int SLABS = D / 64;
  constexpr int STAGES = stages<D>();
  constexpr int QB = q_bytes<D>();
  constexpr int KVB = kv_bytes<D>();

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzled tiles sit on 1024 B
  const uint32_t q_s = base;
  const uint32_t ring = base + QB;               // stage st: K at +2*st*KVB, V after it
  const uint32_t bars = ring + 2 * STAGES * KVB;
  const uint32_t q_full = bars;
  auto full = [&](int st) { return bars + 8u * (1 + st); };
  // per stage, the warps that are done with it; the last one refills it
  unsigned int* released =
      reinterpret_cast<unsigned int*>(smem_raw + (bars - raw) + 8 * (1 + STAGES));

  // Heaviest q tiles first: the tile index is the slowest grid dimension,
  // walked from the last tile (the most keys under a causal mask) down, so
  // the short tiles fill the tail of the grid.
  const int q0 = (gridDim.z - 1 - blockIdx.z) * BQ;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int hk = h / (Hq / Hkv);

  // Keys any row of this block can see: [kv_lo, kv_hi), in 64-key tiles.
  const int row_lo = q0 + q_offset;
  const int row_hi = min(q0 + BQ, Sq) - 1 + q_offset;
  int kv_lo = 0, kv_hi = Sk;
  if (causal) kv_hi = min(Sk, row_hi + 1);
  if (has_window) kv_lo = max(0, row_lo - window + 1);
  const int t_lo = kv_lo / BK;
  const int t_hi = kv_hi > kv_lo ? (kv_hi + BK - 1) / BK : t_lo;

  // Load tile t into stage st: K and V, one box per 64-column slab.
  const CUtensorMap* map_k = &tm_k;
  const CUtensorMap* map_v = &tm_v;
  auto load_kv = [&](int t, int st) {
    const uint32_t k_s = ring + 2 * st * KVB;
    mbar_expect_tx(full(st), 2 * KVB);
#pragma unroll
    for (int s = 0; s < SLABS; ++s) {
      tma_load_4d(k_s + s * slab_kv_bytes(), map_k, full(st), 64 * s, hk, t * BK, b);
      tma_load_4d(k_s + KVB + s * slab_kv_bytes(), map_v, full(st), 64 * s, hk, t * BK, b);
    }
  };

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full(st), 1);
      released[st] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(q_full, QB);
#pragma unroll
    for (int s = 0; s < SLABS; ++s)
      tma_load_4d(q_s + s * slab_q_bytes(), &tm_q, q_full, 64 * s, h, q0, b);
    for (int t = t_lo; t < min(t_hi, t_lo + STAGES); ++t) load_kv(t, t - t_lo);
  }
  __syncthreads();

  {
    const int c = threadIdx.x / 128;         // warpgroup: query rows 64c .. 64c+63
    const int tid = threadIdx.x % 128;
    const int w = tid / 32;
    const int lane = tid % 32;
    const int cq0 = q0 + 64 * c;             // this warpgroup's first query
    const bool active = cq0 < Sq;
    const int crow_lo = cq0 + q_offset;      // its rows, counted from q_offset
    const int crow_hi = min(cq0 + 64, Sq) - 1 + q_offset;
    const int row_a = cq0 + 16 * w + (lane >> 2) + q_offset;  // this thread's two rows
    const int row_b = row_a + 8;
    const int col_in = 2 * (lane & 3);
    // keys [vis_lo, vis_hi) are visible to a row: the causal, window and S_k masks
    const int vis_lo_a = has_window ? row_a - window + 1 : 0;
    const int vis_lo_b = has_window ? row_b - window + 1 : 0;
    const int vis_hi_a = causal ? min(Sk, row_a + 1) : Sk;
    const int vis_hi_b = causal ? min(Sk, row_b + 1) : Sk;

    float scale_log2, cap_log2 = 0.f, scale_over_cap = 0.f;
    if (has_softcap) {
      cap_log2 = softcap * LOG2E;
      scale_over_cap = scale / softcap;
    }
    scale_log2 = scale * LOG2E;

    float acc[SLABS][32];
#pragma unroll
    for (int s = 0; s < SLABS; ++s)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[s][i] = 0.f;
    float m_a = NEG, m_b = NEG, l_a = 0.f, l_b = 0.f;

    // K-major operands: 8-row groups 1024 B apart; a k-step of 16 is 32 B.
    const uint64_t q_desc = make_desc(q_s + 64 * 128 * c, 16, 1024);
    mbar_wait(q_full, 0);

    int st = 0;
    uint32_t phase = 0;
    for (int t = t_lo; t < t_hi; ++t) {
      const int k0 = t * BK;
      mbar_wait(full(st), phase);
      const bool skip = !active || (causal && k0 > crow_hi) ||
                        (has_window && k0 + BK - 1 <= crow_lo - window);
      if (!skip) {
        const uint32_t k_s = ring + 2 * st * KVB;
        const uint32_t v_s = k_s + KVB;
        const uint64_t qd = opaque(q_desc);
        const uint64_t kd = opaque(make_desc(k_s, 16, 1024));

        float sc[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) sc[i] = 0.f;
        fence_acc(sc);
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < SLABS; ++s)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_ss(sc, qd + ((s * slab_q_bytes() + kk * 32) >> 4),
                     kd + ((s * slab_kv_bytes() + kk * 32) >> 4), (s | kk) != 0);
        wgmma_commit();
        wgmma_wait_all();
        fence_acc(sc);

        // scale (and softcap) into log2 units
        if (has_softcap) {
#pragma unroll
          for (int i = 0; i < 32; ++i) sc[i] = cap_log2 * tanhf(sc[i] * scale_over_cap);
        } else {
#pragma unroll
          for (int i = 0; i < 32; ++i) sc[i] *= scale_log2;
        }
        const bool need_mask = k0 + BK > Sk || (causal && k0 + BK - 1 > crow_lo) ||
                               (has_window && k0 <= crow_hi - window);
        if (need_mask) {
          // this thread's columns are k0 + col_in + 8j + e: compare 8j + e
          // (a constant) with each row's visible range shifted by k0 + col_in
          const int sh = k0 + col_in;
          const int lo_a = vis_lo_a - sh, hi_a = vis_hi_a - sh;
          const int lo_b = vis_lo_b - sh, hi_b = vis_hi_b - sh;
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int x = 8 * j + e;
              if (x < lo_a || x >= hi_a) sc[4 * j + e] = NEG;
              if (x < lo_b || x >= hi_b) sc[4 * j + 2 + e] = NEG;
            }
        }

        // online softmax: a row's 16 values per thread, 4 threads per row
        float mx_a = NEG, mx_b = NEG;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          mx_a = fmaxf(mx_a, fmaxf(sc[4 * j], sc[4 * j + 1]));
          mx_b = fmaxf(mx_b, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
        }
#pragma unroll
        for (int off = 1; off <= 2; off <<= 1) {
          mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
          mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
        }
        const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
        // fully-masked guard: a row with no key so far subtracts 0, so its
        // masked scores give exp2(-1e30) = 0, never exp2(0) = 1
        const float mu_a = mn_a <= NEG / 2 ? 0.f : mn_a;
        const float mu_b = mn_b <= NEG / 2 ? 0.f : mn_b;
        const float al_a = exp2f(m_a - mu_a), al_b = exp2f(m_b - mu_b);
        m_a = mn_a;
        m_b = mn_b;
        float rs_a = 0.f, rs_b = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          sc[4 * j] = exp2f(sc[4 * j] - mu_a);
          sc[4 * j + 1] = exp2f(sc[4 * j + 1] - mu_a);
          sc[4 * j + 2] = exp2f(sc[4 * j + 2] - mu_b);
          sc[4 * j + 3] = exp2f(sc[4 * j + 3] - mu_b);
          rs_a += sc[4 * j] + sc[4 * j + 1];
          rs_b += sc[4 * j + 2] + sc[4 * j + 3];
        }
        l_a = l_a * al_a + rs_a;  // per-thread partial sums; the quad adds them at the end
        l_b = l_b * al_b + rs_b;
#pragma unroll
        for (int s = 0; s < SLABS; ++s)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            acc[s][4 * j] *= al_a;
            acc[s][4 * j + 1] *= al_a;
            acc[s][4 * j + 2] *= al_b;
            acc[s][4 * j + 3] *= al_b;
          }

        // P as bf16 A fragments: k-step kk holds S columns 16kk .. 16kk+15,
        // which are accumulator registers 8kk .. 8kk+7 in order.
        uint32_t pa[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r)
            pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);

        // V as an MN-major B: 8 key rows 1024 B apart, a k-step of 16 keys is
        // 2048 B; the 64-column slabs are KV slab bytes apart.
        const uint64_t vd = opaque(make_desc(v_s, slab_kv_bytes(), 1024));
#pragma unroll
        for (int s = 0; s < SLABS; ++s) fence_acc(acc[s]);
        wgmma_fence();
#pragma unroll
        for (int s = 0; s < SLABS; ++s)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_rs(acc[s], pa[kk], vd + ((s * slab_kv_bytes() + kk * 2048) >> 4));
        wgmma_commit();
        wgmma_wait_all();
#pragma unroll
        for (int s = 0; s < SLABS; ++s) fence_acc(acc[s]);
      }
      // The last of the 8 warps done with this stage (their wgmma reads have
      // completed) refills it with tile t + STAGES.
      __syncwarp();
      if (lane == 0) {
        __threadfence_block();
        if (atomicInc(&released[st], 7u) == 7u && t + STAGES < t_hi) load_kv(t + STAGES, st);
      }
      if (++st == STAGES) {
        st = 0;
        phase ^= 1;
      }
    }

    // epilogue: O / l (l == 0 -> 1), rounded to bf16, rows < Sq only
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
      l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
    }
    const float inv_a = 1.f / (l_a == 0.f ? 1.f : l_a);
    const float inv_b = 1.f / (l_b == 0.f ? 1.f : l_b);
    const int qa = row_a - q_offset, qb = qa + 8;
    const long q_stride = (long)Hq * D;
    __nv_bfloat16* oa = o + ((long)b * Sq + qa) * q_stride + (long)h * D + col_in;
    __nv_bfloat16* ob = oa + 8 * q_stride;
#pragma unroll
    for (int s = 0; s < SLABS; ++s)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * s + 8 * j;
        if (qa < Sq)
          *reinterpret_cast<__nv_bfloat162*>(oa + col) =
              __floats2bfloat162_rn(acc[s][4 * j] * inv_a, acc[s][4 * j + 1] * inv_a);
        if (qb < Sq)
          *reinterpret_cast<__nv_bfloat162*>(ob + col) =
              __floats2bfloat162_rn(acc[s][4 * j + 2] * inv_b, acc[s][4 * j + 3] * inv_b);
      }
  }
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

// A [B, S, H, D] bf16 tensor as a 4-D map over (D, H, S, B), boxes of 64
// columns x `rows` positions of one head, 128-byte swizzle, zero fill.
bool make_map(CUtensorMap* map, const void* ptr, int B, int S, int H, int D, int rows) {
  EncodeTiled enc = encode_fn();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                                 (cuuint64_t)S * H * D * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
             box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int Sq,
                   int Sk, int Hq, int Hkv, int causal, int has_window, int window,
                   int has_softcap, float softcap, float scale, int q_offset,
                   cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, B, Sq, Hq, D, BQ) || !make_map(&tk, k, B, Sk, Hkv, D, BK) ||
      !make_map(&tv, v, B, Sk, Hkv, D, BK))
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_sm90<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  const dim3 grid(Hq, B, (Sq + BQ - 1) / BQ);
  flash_fwd_sm90<D><<<grid, NTHREADS, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), Sq, Sk, Hq, Hkv, causal, has_window, window,
      has_softcap, softcap, scale, q_offset);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// bf16 q [B, Sq, Hq, D], k / v [B, Sk, Hkv, D], o like q; D 64, 128 or 256.
// Returns the cudaError_t after the launch.
int flash_attention_sm90_fwd(const void* q, const void* k, const void* v, void* o, int B,
                             int Sq, int Sk, int Hq, int Hkv, int D, int causal,
                             int has_window, int window, int has_softcap, float softcap,
                             float scale, int q_offset, void* stream) {
  if (Hkv <= 0 || Hq % Hkv != 0 || B <= 0 || Sq <= 0 || Sk <= 0 || B > 65535 ||
      (Sq + BQ - 1) / BQ > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 256)
    return (int)launch<256>(q, k, v, o, B, Sq, Sk, Hq, Hkv, causal, has_window, window,
                            has_softcap, softcap, scale, q_offset, s);
  if (D == 128)
    return (int)launch<128>(q, k, v, o, B, Sq, Sk, Hq, Hkv, causal, has_window, window,
                            has_softcap, softcap, scale, q_offset, s);
  if (D == 64)
    return (int)launch<64>(q, k, v, o, B, Sq, Sk, Hq, Hkv, causal, has_window, window,
                           has_softcap, softcap, scale, q_offset, s);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory a block takes at head_dim D (0 for a D it does not take).
int flash_attention_sm90_smem_bytes(int D) {
  return D == 256   ? (int)smem_bytes<256>()
         : D == 128 ? (int)smem_bytes<128>()
         : D == 64  ? (int)smem_bytes<64>()
                    : 0;
}

const char* kernel_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
