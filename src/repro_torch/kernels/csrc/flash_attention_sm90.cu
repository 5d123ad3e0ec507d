// K4 on Hopper's tensor cores: forward flash attention for bf16 at head
// dims 64, 112, 128 and 256, for sm_90a.
//
// Replaces the Pallas TPU kernel `flash_attention_bhsd` (`_flash_kernel`,
// src/repro/kernels/flash_attention.py) for bf16 inputs at D 64, 112, 128
// and 256; float32 at every head dim and bf16 at D 16/32 stay on the
// CUDA-core kernel in flash_attention.cu, since a float32 product on tensor
// cores would be TF32. Same function as the plain version (kernels/ref.py):
// S = QK^T in float32, scaled by D^-0.5 with the true D (112^-0.5 at D 112),
// causal keys kpos > qpos masked (positions from 0 for both), a running max
// and sum in float32, P rounded to bf16 before the PV product, which
// accumulates in float32, out = acc / max(l, 1e-30) in bf16. GQA reads kv
// head h / G and never repeats K/V.
//
// What bounds it on the H100: at the serving shapes it is bound by
// operations. llama3.2-1b (B 4, T 2048, H 32, KV 8, D 64, causal): 68.75
// GFLOP against 83.9 MB, about 800 FLOP per byte, above the card's ~295
// FLOP/byte balance: 0.0695 ms at the 989 TFLOP/s bf16 tensor-core rate.
// recurrentgemma-9b (B 4, T 2048, H 16, KV 1, D 256): 137.4 GFLOP, 0.139
// ms. kimi-k2 (B 1, T 256, H 64, KV 8, D 112): 0.94 GFLOP against 8.3 MB,
// bound by its bytes (0.0025 ms). Only `wgmma` reaches the tensor-core rate,
// so both products run there:
//   * one block per (batch*head, 128-row q tile): two consumer warpgroups
//     of 64 rows each and a producer. Blocks run head-fastest and from the
//     last q tile down, so the heaviest causal tiles of every head go first;
//   * the producer's lane 0 loads the Q tile once by TMA, then the K and V
//     tiles (64 keys) by TMA into a ring of STAGES shared-memory stages:
//     full barriers carry the bytes (mbarrier complete_tx), an empty
//     barrier per stage collects the 256 consumer threads' release. Tiles
//     above the causal diagonal are never loaded;
//   * a row of D columns is HALVES = ceil(D / 64) boxes of 64 columns, each
//     one 128-byte swizzle atom (64 bf16), side by side in shared memory.
//     The tensor maps declare the true D, so at D 112 the second box's
//     columns 112-127 lie outside the tensor: TMA fills them with zeros on
//     load (and still counts the whole box's bytes on the barrier) and
//     clips them on the store, as it does for rows at or past T. No copy
//     pads anything;
//   * S = QK^T is `wgmma.mma_async` m64n64k16, D / 16 steps (7 at D 112:
//     the zero columns are never multiplied), both operands read from
//     shared memory through descriptors that match TMA's 128-byte swizzle;
//   * the online softmax stays in float32 registers in the accumulator's
//     own fragment layout: a thread holds two rows, each spread over the 4
//     lanes of a quad, so row max and sum take two shuffles. Keys at or
//     past S are masked explicitly (TMA fills them with zeros, and a zero
//     score is not a masked one), and the causal mask is applied only on
//     tiles that cross the diagonal;
//   * P, rounded to bf16, is the register A operand of the PV wgmma: the
//     S accumulator's layout is the A fragment's, so P never touches
//     shared memory. V is the shared-memory B operand read with the
//     transpose bit (MN-major), so V is never copied transposed. PV runs
//     m64n64k16 per 64-column box (at D 112 the second box's last 16
//     columns multiply V's zeros and are clipped on the store);
//   * the output tile goes through the warpgroup's own (consumed) Q rows in
//     shared memory and out by a TMA store, which clips rows at or past T
//     and columns at or past D.
//
// Budget per head dim (2 stages; + 1 KB alignment slack and the barriers):
//   D 64:       Q 16 KB + 2 x (K 8 + V 8) KB = 48 KB; 288 threads (the
//               producer one warp); two blocks an SM by both shared memory
//               and registers (the launch bounds ask for it).
//   D 112, 128: Q 32 KB + 2 x 32 KB = 96 KB; 288 threads; the two
//               64-column O accumulators (64 floats a thread) make it one
//               block an SM by registers.
//   D 256:      Q 64 KB + 2 x 64 KB = 192 KB of the 227 KB a block may
//               take, so a third stage does not fit and one block runs an
//               SM. The O accumulator alone is 128 floats a consumer
//               thread, plus S (32), P (16 bf16 pairs) and the softmax
//               state. The SM's registers sit in four quarters of 16,384,
//               one per scheduler, and 9 warps put 3 on one quarter, so 288
//               threads get at most 168 registers each: that build spills
//               (404 bytes) and runs 1.8x slower. So the producer is a
//               whole warpgroup (384 threads, still 3 warps a quarter at
//               168) that gives its registers back (`setmaxnreg.dec` to
//               24) while the two consumer warpgroups take 240 each
//               (`setmaxnreg.inc`): 32 x (24 + 2 x 240) = 16,128 of a
//               quarter's 16,384, and no spill. `setmaxnreg` needs sm_90a,
//               the build's target; tools/k4_producer_variants.py builds
//               and times both designs.
// The ptxas report of each instance is kept in the build's build.log;
// chip_smoke.py prints it, and PERF.md has the measured times.
//
// Tensor maps are encoded on the host for each call (cuTensorMapEncodeTiled
// of libcuda, found through the runtime's entry-point query, so nothing
// links against libcuda) over the 4-D (D, H, T, B) views of q and o and the
// (D, KV, S, B) views of k and v through their strides: the model's
// (B, T, H, D) tensors and the (BH, T, D) Pallas interface go in with no
// copy. TMA needs a 16-byte aligned base and strides that are multiples of
// 16 bytes; the Python wrapper raises on anything else.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 128;               // query rows per block
constexpr int BK = 64;                // keys per K/V tile
constexpr int STAGES = 2;             // K/V ring depth
constexpr int CONSUMERS = 256;        // warpgroups 0 and 1
constexpr int ATOM = 128;             // bytes of a 64-column bf16 row: one swizzle atom

template <int D>
struct Smem {
  // D 256: a producer warpgroup that hands its registers to the consumers.
  static constexpr bool WIDE_PRODUCER = D == 256;
  static constexpr int THREADS = CONSUMERS + (WIDE_PRODUCER ? 128 : 32);
  static constexpr int HALVES = (D + 63) / 64;              // 64-column boxes a row takes
  static constexpr int Q_BYTES = HALVES * BQ * ATOM;         // 16 KB at D 64
  static constexpr int KV_BYTES = HALVES * BK * ATOM;        // one K or V tile, 8 KB at D 64
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  static constexpr int BAR_OFF = Q_BYTES + STAGES * STAGE_BYTES;
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 3 * STAGES) + 1024;  // + alignment slack
  static_assert(BYTES <= 232448, "a block may take at most 227 KB of shared memory");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Returns once the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
      "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, const void* src, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// A wgmma shared-memory descriptor for a 128-byte-swizzled tile whose
// 8-row groups lie 1024 bytes apart. That one stride serves both fields:
// K-major operands (Q, K) read 16 of a row's 64 columns per instruction and
// never leave their atom, and V (MN-major, one 64-column atom per
// instruction) steps 1024 bytes from one group of 8 keys to the next.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  constexpr uint64_t group = 1024 >> 4;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (group << 16) | (group << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving register reads or writes across a wgmma.
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void fence_regs(uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// d (+)= A B, m64n64k16, A and B from shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += A B, m64n64k16, A (bf16 pairs) from registers, B from shared memory
// MN-major (the transpose bit).
__device__ __forceinline__ void wgmma_rs_t(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<const uint32_t*>(&x);
}

// K/V tiles a 64-row group of queries starting at row0 reads.
__device__ __forceinline__ int tiles_for(int row0, int Tq, int S, int causal) {
  if (row0 >= Tq) return 0;
  const int n_s = (S + BK - 1) / BK;
  if (!causal) return n_s;
  const int last = min(row0 + 63, Tq - 1);
  return min(n_s, last / BK + 1);
}

// The consumer warpgroups' part of the block: QK^T, the online softmax and
// PV over the K/V ring, then the output tile by TMA.
template <int D>
__device__ __forceinline__ void consume(uint8_t* smem, uint64_t* q_full, uint64_t* k_full,
                                        uint64_t* v_full, uint64_t* empty, const CUtensorMap* to,
                                        int warp, int lane, int q0, int n_blk, int h, int b,
                                        int Tq, int S, float scale_log2, int causal) {
  using SM = Smem<D>;
  constexpr int HALVES = SM::HALVES;
  // Warpgroup wg owns query rows row0 .. row0 + 63; this thread
  // owns rows r_lo and r_lo + 8 of them, at columns 8j + 2(lane%4) + {0, 1}
  // of every n8 block j of an accumulator.
  const int wg = warp / 4;
  const int row0 = q0 + 64 * wg;
  const int r_lo = row0 + 16 * (warp % 4) + lane / 4;
  const int col = 2 * (lane % 4);
  const int n_wg = tiles_for(row0, Tq, S, causal);
  const uint32_t q_base = smem_u32(smem) + 64 * wg * ATOM;

  float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f};
  float acc[HALVES][32];
#pragma unroll
  for (int hh = 0; hh < HALVES; ++hh)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[hh][i] = 0.f;

  mbar_wait(q_full, 0);
  for (int kt = 0; kt < n_blk; ++kt) {
    const int s = kt % STAGES;
    const uint32_t parity = (kt / STAGES) & 1;
    const uint32_t k_base = smem_u32(smem + SM::Q_BYTES + s * SM::STAGE_BYTES);
    const uint32_t v_base = k_base + SM::KV_BYTES;
    mbar_wait(k_full + s, parity);
    if (kt < n_wg) {
      float sc[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk % 4) * 32;  // 16 columns = 32 bytes into the atom
        wgmma_ss(sc, desc_sw128(q_base + (kk / 4) * BQ * ATOM + off),
                 desc_sw128(k_base + (kk / 4) * BK * ATOM + off), kk > 0);
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs(sc);

      const int k0 = kt * BK;
      const bool edge = k0 + BK > S || (causal && k0 + BK - 1 > row0);
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        float x = sc[i] * scale_log2;
        if (edge) {
          const int kpos = k0 + 8 * (i / 4) + col + (i & 1);
          const int qpos = r_lo + 8 * ((i >> 1) & 1);
          if (kpos >= S || (causal && kpos > qpos)) x = -INFINITY;
        }
        sc[i] = x;
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
      }
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        corr[r] = exp2f(m[r] - m_new);
        m[r] = m_new;
        l[r] *= corr[r];
      }
      // P in the PV product's A layout: k16 step t takes n8 blocks 2t, 2t+1.
      uint32_t pa[4][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = exp2f(sc[4 * j + e] - m[e >> 1]);
          l[e >> 1] += p[e];
        }
        pa[j / 2][2 * (j & 1)] = pack_bf16(p[0], p[1]);
        pa[j / 2][2 * (j & 1) + 1] = pack_bf16(p[2], p[3]);
      }
#pragma unroll
      for (int hh = 0; hh < HALVES; ++hh)
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[hh][i] *= corr[(i >> 1) & 1];

      mbar_wait(v_full + s, parity);
#pragma unroll
      for (int hh = 0; hh < HALVES; ++hh) fence_regs(acc[hh]);
#pragma unroll
      for (int t = 0; t < 4; ++t) fence_regs(pa[t]);
      wgmma_fence();
#pragma unroll
      for (int hh = 0; hh < HALVES; ++hh)
#pragma unroll
        for (int t = 0; t < 4; ++t)
          wgmma_rs_t(acc[hh], pa[t], desc_sw128(v_base + hh * BK * ATOM + t * 16 * ATOM));
      wgmma_commit();
      wgmma_wait();
#pragma unroll
      for (int hh = 0; hh < HALVES; ++hh) fence_regs(acc[hh]);
    } else {
      // Past this warpgroup's last tile (the other one still reads it):
      // release the stage only once it is full, so that the empty
      // barrier's phases stay in tile order.
      mbar_wait(v_full + s, parity);
    }
    mbar_arrive(empty + s);
  }
  if (n_wg == 0) return;  // every row of this warpgroup lies at or past T

  float den[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    den[r] = fmaxf(l[r], 1e-30f);
  }
  // The output tile into this warpgroup's Q rows (read by no wgmma any
  // more), in the 128-byte swizzle the O tensor map stores from.
  const int rw = r_lo - row0;  // row within the warpgroup's 64
#pragma unroll
  for (int hh = 0; hh < HALVES; ++hh) {
    uint8_t* region = smem + hh * BQ * ATOM + 64 * wg * ATOM;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = rw + 8 * r;
        const int c = 8 * j + col;
        uint8_t* dst = region + row * ATOM + (((c >> 3) ^ (row & 7)) << 4) + (c & 7) * 2;
        *reinterpret_cast<uint32_t*>(dst) =
            pack_bf16(acc[hh][4 * j + 2 * r] / den[r], acc[hh][4 * j + 2 * r + 1] / den[r]);
      }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
  if (threadIdx.x % 128 == 0) {
    for (int hh = 0; hh < HALVES; ++hh)
      tma_store(to, smem + hh * BQ * ATOM + 64 * wg * ATOM, 64 * hh, h, row0, b);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

template <int D>
__global__ void __launch_bounds__(Smem<D>::THREADS, D == 64 ? 2 : 1)
flash_fwd_sm90(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap to,
               int H, int G, int Tq, int S, float scale_log2, int causal) {
  using SM = Smem<D>;
  constexpr int HALVES = SM::HALVES;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + SM::BAR_OFF);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* empty = v_full + STAGES;

  const int bh = blockIdx.x, b = bh / H, h = bh % H, kvh = h / G;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // heaviest q tiles first
  const int n_blk = max(tiles_for(q0, Tq, S, causal), tiles_for(q0 + 64, Tq, S, causal));

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full + s, 1);
      mbar_init(v_full + s, 1);
      mbar_init(empty + s, CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp >= CONSUMERS / 32) {
    // Producer: lane 0 of its first warp keeps the ring full; the other
    // lanes (and warps) have no work.
    if constexpr (SM::WIDE_PRODUCER) asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (warp == CONSUMERS / 32 && lane == 0) {
      mbar_expect_tx(q_full, SM::Q_BYTES);
      for (int hh = 0; hh < HALVES; ++hh)
        tma_load(smem + hh * BQ * ATOM, &tq, q_full, 64 * hh, h, q0, b);
      for (int kt = 0; kt < n_blk; ++kt) {
        const int s = kt % STAGES, round = kt / STAGES;
        if (round > 0) mbar_wait(empty + s, (round - 1) & 1);  // both warpgroups let go
        uint8_t* ks = smem + SM::Q_BYTES + s * SM::STAGE_BYTES;
        uint8_t* vs = ks + SM::KV_BYTES;
        mbar_expect_tx(k_full + s, SM::KV_BYTES);
        for (int hh = 0; hh < HALVES; ++hh)
          tma_load(ks + hh * BK * ATOM, &tk, k_full + s, 64 * hh, kvh, kt * BK, b);
        mbar_expect_tx(v_full + s, SM::KV_BYTES);
        for (int hh = 0; hh < HALVES; ++hh)
          tma_load(vs + hh * BK * ATOM, &tv, v_full + s, 64 * hh, kvh, kt * BK, b);
      }
    }
  } else {
    if constexpr (SM::WIDE_PRODUCER) asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    consume<D>(smem, q_full, k_full, v_full, empty, &to, warp, lane, q0, n_blk, h, b, Tq, S,
               scale_log2, causal);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A map over the 4-D view (D, N, L, B) of a (B, L, N, D) bf16 tensor with
// element strides sn, sl, sb; boxes of 64 columns x 1 x `rows` x 1. D is
// the true head dim, so a box that reaches past it (columns 112-127 at D
// 112) is zero-filled on load and clipped on store. A dimension of size 1
// is never stepped, so it gets a stride past the whole view.
bool encode(EncodeTiled fn, CUtensorMap* map, const void* base, int D, int N, int L, int B,
            long long sn, long long sl, long long sb, int rows) {
  const long long span = 2 * (sn * (N - 1) + sl * (L - 1) + sb * (B - 1) + D);
  const long long past = (span + 15) / 16 * 16;
  cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)N, (cuuint64_t)L, (cuuint64_t)B};
  cuuint64_t strides[3] = {(cuuint64_t)(N > 1 ? 2 * sn : past),
                           (cuuint64_t)(L > 1 ? 2 * sl : past),
                           (cuuint64_t)(B > 1 ? 2 * sb : past)};
  cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H, int KV, int Tq,
           int S, const long long* st, float scale_log2, int causal, cudaStream_t stream) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap mq, mk, mv, mo;
  if (!encode(fn, &mq, q, D, H, Tq, B, st[2], st[1], st[0], BQ) ||
      !encode(fn, &mk, k, D, KV, S, B, st[5], st[4], st[3], BK) ||
      !encode(fn, &mv, v, D, KV, S, B, st[5], st[4], st[3], BK) ||
      !encode(fn, &mo, o, D, H, Tq, B, st[8], st[7], st[6], 64))
    return (int)cudaErrorInvalidValue;
  // Every call: the attribute belongs to the current device's context.
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_sm90<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<D>::BYTES);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (Tq + BQ - 1) / BQ);
  flash_fwd_sm90<D><<<grid, Smem<D>::THREADS, Smem<D>::BYTES, stream>>>(
      mq, mk, mv, mo, H, H / KV, Tq, S, scale_log2, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// q, o: (B, Tq, H, D) and k, v: (B, S, KV, D), bf16, through the element
// strides `strides` = {q_b, q_t, q_h, kv_b, kv_t, kv_h, o_b, o_t, o_h}; the
// last dimension is contiguous, D is 64, 112, 128 or 256, every base is
// 16-byte aligned and every stride of a dimension longer than 1 a multiple
// of 8.
// `scale_log2` is D^-0.5 * log2(e). Launches on `stream` and returns a
// cudaError_t (cudaErrorInvalidValue when a tensor map cannot be encoded).
extern "C" int flash_attention_sm90_fwd(const void* q, const void* k, const void* v, void* o,
                                        int d, int B, int H, int KV, int Tq, int S,
                                        const long long* strides, float scale_log2, int causal,
                                        void* stream) {
  if (KV <= 0 || H % KV != 0 || Tq <= 0 || S <= 0 || (Tq + BQ - 1) / BQ > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d == 64) return launch<64>(q, k, v, o, B, H, KV, Tq, S, strides, scale_log2, causal, s);
  if (d == 112) return launch<112>(q, k, v, o, B, H, KV, Tq, S, strides, scale_log2, causal, s);
  if (d == 128) return launch<128>(q, k, v, o, B, H, KV, Tq, S, strides, scale_log2, causal, s);
  if (d == 256) return launch<256>(q, k, v, o, B, H, KV, Tq, S, strides, scale_log2, causal, s);
  return (int)cudaErrorInvalidValue;
}
