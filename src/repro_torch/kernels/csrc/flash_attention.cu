// K4 on the CUDA cores: forward flash attention (online softmax) for sm_90a.
//
// Replaces the Pallas TPU kernel `flash_attention_bhsd` (`_flash_kernel`,
// src/repro/kernels/flash_attention.py) for float32 at every head dim and
// bf16 at head dims 16 and 32; bf16 at 64, 112 (kimi-k2), 128 and 256
// (recurrentgemma-9b) goes to the tensor-core kernel in
// flash_attention_sm90.cu (kernels/flash_attention.py:kernel_for chooses).
// This kernel keeps its bf16 code at 112 and 256, which no path sends here
// any more (chip_smoke.py times it beside the tensor-core kernel). A float32 product on tensor cores would be TF32, which the
// float32 tolerances and the float32 card-vs-CPU serving check exclude, so
// float32 stays here. Same function: q and k in float32,
// q scaled by D^-0.5 before QK^T, causal keys kpos > qpos masked (positions
// start at 0 for both), a running max m and sum l in float32, p rounded to
// v's type before the PV product, acc / max(l, 1e-30) cast to q's type. GQA
// reads kv head h / G and never repeats K/V.
//
// What bounds it on the H100: at the serving shape (B 4, T 2048, H 32, KV 8,
// D 64, bf16, causal) one launch is 68.7 GFLOP against 83.9 MB, about 800
// FLOP per byte: far above the card's ~295 FLOP/byte balance, so it is
// bound by operations. The tensor cores (wgmma) make that 0.07 ms, and
// flash_attention_sm90.cu runs bf16 there; this kernel runs its products
// on the CUDA cores in float32, whose rate (67 TFLOP/s) puts its floor near
// 1 ms.
//
// What the design does about it, for the card rather than tile for tile
// after the Pallas grid (whose kv axis is sequential and carries VMEM
// scratch; on the GPU blocks run in no order):
//   * one thread block per (batch*head, 64-row q tile); a loop inside the
//     block walks the 64-key k/v tiles, staged through shared memory as
//     float32, and the running max, sum and accumulator stay in registers;
//   * tiles above the causal diagonal are never loaded; the heaviest q
//     tiles are scheduled first (blockIdx.x counts from the last tile);
//   * each of the 256 threads computes a 4x4 block of scores from float4
//     shared-memory reads (16 FMAs per 8 reads) and owns the same 4 rows of
//     the output, so m, l and the rescale need no exchange beyond a
//     16-lane shuffle; row stride D+4 keeps the float4 reads conflict-free;
//   * ragged edges are masked, so any T and S work (the Pallas "T must
//     divide the block" rule is a TPU tiling rule);
//   * inputs are read through their strides, so the (B, T, H, D) tensors of
//     the model and the (BH, T, D) tensors of the Pallas interface both go
//     in without a copy.
// The PV product accumulates in float32. (In the Pallas kernel the bf16
// product `p.astype(v.dtype) @ v` of each tile is rounded to bf16 before it
// is added to the accumulator, by JAX's dtype rule; this kernel does not
// round it.)

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per k/v tile
constexpr int THREADS = 256;  // 16 x 16: ty owns rows ty + 16 i, tx keys tx + 16 j
constexpr int PS = BK + 4;    // row stride of the P tile in shared memory
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ void load4(const float* p, float* out) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  out[0] = x.x; out[1] = x.y; out[2] = x.z; out[3] = x.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* out) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  // bf16 -> float is exact: the 16 bits are the float's high half.
  out[0] = __uint_as_float(raw.x << 16);
  out[1] = __uint_as_float(raw.x & 0xffff0000u);
  out[2] = __uint_as_float(raw.y << 16);
  out[3] = __uint_as_float(raw.y & 0xffff0000u);
}

__device__ __forceinline__ float round_to(float x, float) { return x; }
__device__ __forceinline__ float round_to(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float max16(float x) {
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// A butterfly: every lane of the 16 ends with the same bits.
__device__ __forceinline__ float sum16(float x) {
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int D>
struct Dims {
  // Output columns of thread tx: NV chunks of VEC neighbours,
  // column = h * 16 * VEC + tx * VEC + e, so 16 lanes read 16*VEC
  // contiguous floats of a V row. VEC is the widest of 4, 2, 1 whose
  // 16-lane chunk divides D: 4 at D 64, 128 and 256 (NV 1, 2, 4), 2 at 32,
  // 1 at 16 and at 112 (7 chunks of 16 columns).
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  static constexpr int VEC = D % 64 == 0 ? 4 : D % 32 == 0 ? 2 : 1;
  static constexpr int NV = D / (16 * VEC);
  static constexpr int PER_THREAD = NV * VEC;  // = D / 16
  static constexpr int KS = D + 4;             // row stride of the K tile
  static constexpr size_t SMEM = sizeof(float) * (BQ * D + BK * KS + BK * D + BQ * PS);
  // 210 KiB at D 256, under the H100's 227 KiB of shared memory per block.
  static_assert(SMEM <= 227 * 1024, "K/V/Q/P tiles exceed the shared memory of a block");
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, int H, int G, int Tq, int S,
                 long long q_sb, long long q_st, long long q_sh,
                 long long kv_sb, long long kv_st, long long kv_sh,
                 long long o_sb, long long o_st, long long o_sh,
                 float scale, int causal) {
  using DM = Dims<D>;
  constexpr int VEC = DM::VEC, NV = DM::NV, DPT = DM::PER_THREAD, KS = DM::KS;

  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);  // [BQ][D], scaled
  float* Ks = Qs + BQ * D;                      // [BK][KS]
  float* Vs = Ks + BK * KS;                     // [BK][D]
  float* Ps = Vs + BK * D;                      // [BQ][PS]

  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * kv_sb + (h / G) * kv_sh;
  const T* vb = v + b * kv_sb + (h / G) * kv_sh;
  T* ob = o + b * o_sb + h * o_sh;

  for (int idx = tid * 4; idx < BQ * D; idx += THREADS * 4) {
    const int r = idx / D, c = idx % D;
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (q0 + r < Tq) load4(qb + (q0 + r) * q_st + c, x);
#pragma unroll
    for (int e = 0; e < 4; ++e) Qs[r * D + c + e] = x[e] * scale;
  }

  float m[4], l[4], acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;
  }

  int n_tiles = (S + BK - 1) / BK;
  if (causal) {
    const int last_row = min(q0 + BQ, Tq) - 1;
    n_tiles = min(n_tiles, last_row / BK + 1);
  }

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's K, V and P are no longer read
    for (int idx = tid * 4; idx < BK * D; idx += THREADS * 4) {
      const int r = idx / D, c = idx % D;
      float kx[4] = {0.f, 0.f, 0.f, 0.f}, vx[4] = {0.f, 0.f, 0.f, 0.f};
      if (k0 + r < S) {
        load4(kb + (k0 + r) * kv_st + c, kx);
        load4(vb + (k0 + r) * kv_st + c, vx);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        Ks[r * KS + c + e] = kx[e];
        Vs[r * D + c + e] = vx[e];
      }
    }
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
      for (int i = 0; i < 4; ++i) qv[i] = *reinterpret_cast<const float4*>(&Qs[(ty + 16 * i) * D + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = *reinterpret_cast<const float4*>(&Ks[(tx + 16 * j) * KS + d]);
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

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty + 16 * i, qpos = q0 + row;
      bool ok[4];
      float mt = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        ok[j] = kpos < S && (!causal || kpos <= qpos);
        if (!ok[j]) s[i][j] = NEG_INF;
        mt = fmaxf(mt, s[i][j]);
      }
      const float m_new = fmaxf(m[i], max16(mt));
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        rs += p;
        Ps[row * PS + tx + 16 * j] = round_to(p, T());
      }
      l[i] = l[i] * corr + sum16(rs);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

#pragma unroll 2
    for (int c = 0; c < BK; c += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = *reinterpret_cast<const float4*>(&Ps[(ty + 16 * i) * PS + c]);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        float vv[DPT];
        const float* vrow = Vs + (c + cc) * D + tx * VEC;
#pragma unroll
        for (int hh = 0; hh < NV; ++hh) {
          if constexpr (VEC == 4) {
            const float4 x = *reinterpret_cast<const float4*>(vrow + hh * 64);
            vv[hh * 4 + 0] = x.x; vv[hh * 4 + 1] = x.y; vv[hh * 4 + 2] = x.z; vv[hh * 4 + 3] = x.w;
          } else if constexpr (VEC == 2) {
            const float2 x = *reinterpret_cast<const float2*>(vrow + hh * 32);
            vv[hh * 2 + 0] = x.x; vv[hh * 2 + 1] = x.y;
          } else {
            vv[hh] = vrow[hh * 16];
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = cc == 0 ? pv[i].x : cc == 1 ? pv[i].y : cc == 2 ? pv[i].z : pv[i].w;
#pragma unroll
          for (int j = 0; j < DPT; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= Tq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* orow = ob + qpos * o_st;
#pragma unroll
    for (int hh = 0; hh < NV; ++hh)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        store(orow + hh * 16 * VEC + tx * VEC + e, acc[i][hh * VEC + e] / denom);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H, int KV,
           int Tq, int S, const long long* st, float scale, int causal, cudaStream_t stream) {
  const size_t smem = Dims<D>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Tq + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), H, H / KV, Tq, S, st[0], st[1], st[2], st[3], st[4], st[5],
      st[6], st[7], st[8], scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int d, const void* q, const void* k, const void* v, void* o, int B, int H,
             int KV, int Tq, int S, const long long* st, float scale, int causal,
             cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, o, B, H, KV, Tq, S, st, scale, causal, stream);
    case 32: return launch<T, 32>(q, k, v, o, B, H, KV, Tq, S, st, scale, causal, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, H, KV, Tq, S, st, scale, causal, stream);
    case 112: return launch<T, 112>(q, k, v, o, B, H, KV, Tq, S, st, scale, causal, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, H, KV, Tq, S, st, scale, causal, stream);
    case 256: return launch<T, 256>(q, k, v, o, B, H, KV, Tq, S, st, scale, causal, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, o: (B, Tq, H, D) and k, v: (B, S, KV, D) through the element strides
// `strides` = {q_b, q_t, q_h, kv_b, kv_t, kv_h, o_b, o_t, o_h}; the last
// dimension is contiguous. dtype 0 is float32, 1 bfloat16. Launches on
// `stream` and returns cudaGetLastError().
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int dtype, int d, int B, int H, int KV, int Tq, int S,
                                   const long long* strides, float scale, int causal,
                                   void* stream) {
  if (B * H > 65535 || KV <= 0 || H % KV != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(d, q, k, v, o, B, H, KV, Tq, S, strides, scale, causal, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(d, q, k, v, o, B, H, KV, Tq, S, strides, scale, causal, s);
  return (int)cudaErrorInvalidValue;
}
