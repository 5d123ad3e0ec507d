// Hand-written Hopper (sm_90a) kernels for the compression hot path.
//
// They replace the three Pallas TPU kernels of the JAX package's
// src/repro/kernels/gmf_compress.py, plus the glue that fed the first:
//
//   gmf_momentum_multi <- momentum_correction_flat / _momentum_kernel
//                    U <- alpha*U + g ; V <- V + U, over every leaf of a tree
//                    in one launch; reads u, v, g, writes u', v': 20 bytes
//                    per element
//   gmf_select     <- the per-leaf norms, fusion score and torch.topk that fed
//                    gmf_compress_flat: per (client, leaf) segment, ||V||,
//                    ||M||, z = |((1-tau)*V)*inv_nv + (tau*M)*inv_nm| and the
//                    exact k-th largest z; reads v, m: 8 bytes per element
//   gmf_select_abs <- the per-leaf torch.topk of |V| (DGC's top-k mask): the
//                    exact k-th largest |z| of each segment and the mask;
//                    reads z, writes the mask: 8 bytes per element
//   gmf_compress   <- gmf_compress_flat / _gmf_kernel
//                    z as above ; mask = z >= thr
//                    G = V*mask ; U <- U*(1-mask) ; V <- V*(1-mask) ; emits mask
//                    reads u, v, m, writes g, u', v', mask: 28 bytes per element
//   gmf_apply_mask <- apply_mask_flat / _mask_kernel
//                    G = V*mask ; U <- U*(1-mask) ; V <- V*(1-mask)
//                    reads u, v, mask, writes g, u', v': 24 bytes per element
//
// Layout: the compression state is flat. A params tree of L leaves becomes
// N = sum(n_i) columns, leaf i at [o_i, o_i + n_i), with no padding, and
// every operand is a client-major [rows, N] stack, contiguous, so each
// (client, leaf) segment is contiguous. All offsets are 64-bit: one row of
// a 1.5e9-element model is 3 GB in bfloat16.
//
// Element types: each operand is float32 or bfloat16 (dtype code 0 or 1
// at the C interface), as the reference keeps the state in the leaves'
// dtype and promotes it as jnp does. Every kernel computes in float32 and
// rounds each result to the type the reference's op would give it, op by
// op: bfloat16 op bfloat16 is bfloat16, and float32 with anything is
// float32. Momentum (K2) takes the state type S of u and v and the type G
// of g: alpha arrives rounded to S (a weakly typed scalar), alpha*u rounds
// to S, + g and v + u' to promote(S, G), and the outputs are stored as O,
// promote(S, G) under jnp's semantics or S under the Pallas kernel's (it
// writes u.dtype). apply_mask (K3) takes S for u, v and M for the mask and
// writes O = promote(S, M) or S; the mask is 0 or 1, so every product is
// exact. gmf_select and gmf_compress (K1) read v as S and m as M, form the
// norms and z in float32 from them, and K1 writes g, u', v' and the mask
// as S. The float32 instance of each is the kernel as it was. Per-segment scalars (inverse
// norms, thresholds) are [rows, L] arrays, row-major; tau and the FedNova
// weight w are [rows]; the offsets o_0..o_L are an int64 device array made
// once per layout, and the keep counts an int64 [rows, L] table read with a
// row stride: L for per-client counts (adaptive rates), 0 for counts shared
// by every row (one [L] array made once per layout and rate). Every kernel
// takes a whole round's stacks in one launch.
//
// Bound: each does a handful of float operations per element against 8 to
// 28 bytes of traffic, far below the card's operations-per-byte balance, so
// all are bound by device-memory bandwidth. At ResNet-56 with 20 clients
// (17.1 M elements) one round moves 342 MB (momentum), 137 MB (select),
// 479 MB (compress) and 411 MB (apply_mask).
//
// The elementwise kernels stream every byte once: each thread moves one
// 16-byte float4 per operand with neighbouring threads on neighbouring
// addresses. The TPU version padded to (512, 128) blocks; here the ragged
// end is a scalar tail and nothing is padded. Operands whose addresses are
// not 16-byte aligned take the scalar loop for every element. gmf_compress
// takes kChunk elements a block: each thread finds the (row, leaf) of its
// first element by a binary search of the offsets (held in shared memory)
// and walks forward from there; a quad that straddles a segment boundary
// takes each element's own scalars.
//
// gmf_select runs one block per (client, leaf) segment. The block sums the
// squares of V and M in a fixed order (strided per-thread partials in
// float64, then a fixed shuffle tree; no atomics, so every run gives the
// same bits),
// forms inv_nv = w / (sqrt(||V||^2) + eps) and inv_nm = 1 / (sqrt(||M||^2)
// + eps) correctly rounded, and finds the k_i-th largest z by a radix
// select on the float's bits: z >= 0, so its bits order as its values.
// Three passes of 11, 11 and 10 bits each count the candidates that match
// the digits found so far in a 2,048-bin shared-memory histogram (the lanes
// of a warp that hit one bin add once, __match_any_sync), and a block scan
// from the top bin finds the bin that holds the k-th largest. z is
// recomputed from V and M in each pass: the segment's reads after the
// first come from L2. The k-th largest value of a multiset does not depend
// on the algorithm, so the threshold is bitwise torch.topk's on the same z.
//
// K2 is one multi-tensor launch per tree (a tree of one [rows, N] leaf on
// the path): gmf_momentum_multi takes a table of leaves -- five pointers,
// an element count, the leaf's first block and whether all five pointers
// are 16-byte aligned -- by value as a __grid_constant__ parameter: no
// host-to-device copy, no sync, capturable by a CUDA graph. Each block takes
// kChunk elements of one leaf and finds its leaf by a binary search over the
// table's first-block prefix. The table holds kTableCap leaves (512 where
// the toolkit allows 32 KB of kernel parameters, CUDA 12.1 on; 64, under
// 4 KB, before); gmf_momentum_limits reports that capacity and kChunk so
// the Python side plans one launch per kTableCap leaves.
//
// Arithmetic: gmf_compress's z must be bitwise the z gmf_select took its
// threshold from, and both must be the plain version's z (kernels/ref.py):
// every product and sum is an explicit round-to-nearest intrinsic (no fused
// multiply-add), in the JAX package's association, and the file is built
// with -fmad=false too. Each entry point returns the cudaError_t of its
// launch (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

// Loads, stores and rounding of one element type, in float32 registers.
// A quad is 4 consecutive elements: a float4 (16 bytes) or 4 bfloat16
// (8 bytes), read and written at once where the pointer is so aligned.
template <class T>
struct Num;

template <>
struct Num<float> {
  static __device__ __forceinline__ float get(const void* p, int64_t i) {
    return static_cast<const float*>(p)[i];
  }
  static __device__ __forceinline__ void put(void* p, int64_t i, float x) {
    static_cast<float*>(p)[i] = x;
  }
  static __device__ __forceinline__ float4 get4(const void* p, int64_t q) {
    return static_cast<const float4*>(p)[q];
  }
  static __device__ __forceinline__ void put4(void* p, int64_t q, float4 x) {
    static_cast<float4*>(p)[q] = x;
  }
  static __device__ __forceinline__ float round(float x) { return x; }
};

template <>
struct Num<bf16> {
  static __device__ __forceinline__ float get(const void* p, int64_t i) {
    return __bfloat162float(static_cast<const bf16*>(p)[i]);
  }
  static __device__ __forceinline__ void put(void* p, int64_t i, float x) {
    static_cast<bf16*>(p)[i] = __float2bfloat16_rn(x);
  }
  static __device__ __forceinline__ float4 get4(const void* p, int64_t q) {
    const uint2 r = static_cast<const uint2*>(p)[q];
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&r.y));
    return make_float4(a.x, a.y, b.x, b.y);
  }
  static __device__ __forceinline__ void put4(void* p, int64_t q, float4 x) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(x.x, x.y);
    const __nv_bfloat162 b = __floats2bfloat162_rn(x.z, x.w);
    uint2 r;
    r.x = *reinterpret_cast<const unsigned*>(&a);
    r.y = *reinterpret_cast<const unsigned*>(&b);
    static_cast<uint2*>(p)[q] = r;
  }
  static __device__ __forceinline__ float round(float x) {
    return __bfloat162float(__float2bfloat16_rn(x));
  }
};

// The type jnp gives a binary op of an A and a B array.
template <class A, class B>
struct Promote {
  using type = float;
};
template <>
struct Promote<bf16, bf16> {
  using type = bf16;
};

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;  // 8 blocks of 256 per SM fill an H100

// U <- alpha*U + g ; V <- V + U with u, v of type S and g of type G: alpha*u
// rounds to S, both sums to P = promote(S, G); the caller stores them as O.
template <class S, class G>
__device__ __forceinline__ void momentum_one(float u, float v, float g, float alpha,
                                             float& uo, float& vo) {
  using P = typename Promote<S, G>::type;
  const float un = Num<P>::round(__fadd_rn(Num<S>::round(__fmul_rn(alpha, u)), g));
  uo = un;
  vo = Num<P>::round(__fadd_rn(v, un));
}

// G = V*mask ; U <- U*(1-mask) ; V <- V*(1-mask), the mask of type M; the
// caller stores the products (exact: the mask is 0 or 1).
template <class M>
__device__ __forceinline__ void mask_one(float u, float v, float mask,
                                         float& go, float& uo, float& vo) {
  const float keep = Num<M>::round(__fsub_rn(1.0f, mask));
  go = __fmul_rn(v, mask);
  uo = __fmul_rn(u, keep);
  vo = __fmul_rn(v, keep);
}

// z = |((1-tau)*v)*inv_nv + (tau*m)*inv_nm|, in the JAX package's association.
__device__ __forceinline__ float gmf_score(float v, float m, float tau, float inv_nv,
                                          float inv_nm) {
  const float a = __fmul_rn(__fmul_rn(__fsub_rn(1.0f, tau), v), inv_nv);
  const float b = __fmul_rn(__fmul_rn(tau, m), inv_nm);
  return fabsf(__fadd_rn(a, b));
}

__device__ __forceinline__ float gmf_mask(float v, float m, float tau, float inv_nv,
                                          float inv_nm, float thr) {
  return gmf_score(v, m, tau, inv_nv, inv_nm) >= thr ? 1.0f : 0.0f;
}

constexpr int kChunk = kThreads * 4 * 4;  // elements per block: 4 float4 a thread
// gmf_compress holds the offsets in the default 48 KB of shared memory.
constexpr int kMaxLeaves = 48 * 1024 / 8 - 1;
#if CUDART_VERSION >= 12010
constexpr int kTableCap = 512;  // 8 + 512 * 56 bytes: under 32 KB of parameters
#else
constexpr int kTableCap = 64;  // 8 + 64 * 56 bytes: under the classic 4 KB
#endif

struct MomentumLeaf {
  const void* u;  // S
  const void* v;  // S
  const void* g;  // G
  void* uo;       // O
  void* vo;       // O
  long long n;    // elements
  int block0;     // first block of this leaf
  int vec;        // all five pointers aligned to a quad of their type
};

// A table of CAP leaves: the launch copies all of it, so a tree takes the
// smallest of the capacities 8, 64 and kTableCap that holds it.
template <int CAP>
struct MomentumTable {
  int count;
  float alpha;
  MomentumLeaf leaf[CAP];
};
static_assert(sizeof(MomentumLeaf) == 56, "table entry layout");
static_assert(sizeof(MomentumTable<kTableCap>) <= (CUDART_VERSION >= 12010 ? 32764 : 4096),
              "the table must fit the kernel parameter space");

template <int CAP, class S, class G, class O>
__global__ void __launch_bounds__(kThreads)
momentum_multi_kernel(const __grid_constant__ MomentumTable<CAP> t) {
  const int b = blockIdx.x;
  int lo = 0, hi = t.count - 1;  // the last leaf whose first block is <= b
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.leaf[mid].block0 <= b) lo = mid; else hi = mid - 1;
  }
  const MomentumLeaf& e = t.leaf[lo];
  const float alpha = t.alpha;
  const long long begin = (long long)(b - e.block0) * kChunk;
  const long long end = begin + kChunk < e.n ? begin + kChunk : e.n;
  long long i = begin + threadIdx.x;
  if (e.vec) {  // kChunk is a multiple of 4: the quads of [begin, end)
    const long long qend = end / 4;
    for (long long q = begin / 4 + threadIdx.x; q < qend; q += kThreads) {
      const float4 a = Num<S>::get4(e.u, q);
      const float4 c = Num<S>::get4(e.v, q);
      const float4 d = Num<G>::get4(e.g, q);
      float4 x, y;
      momentum_one<S, G>(a.x, c.x, d.x, alpha, x.x, y.x);
      momentum_one<S, G>(a.y, c.y, d.y, alpha, x.y, y.y);
      momentum_one<S, G>(a.z, c.z, d.z, alpha, x.z, y.z);
      momentum_one<S, G>(a.w, c.w, d.w, alpha, x.w, y.w);
      Num<O>::put4(e.uo, q, x);
      Num<O>::put4(e.vo, q, y);
    }
    i = qend * 4 + threadIdx.x;
  }
  for (; i < end; i += kThreads) {
    float x, y;
    momentum_one<S, G>(Num<S>::get(e.u, i), Num<S>::get(e.v, i), Num<G>::get(e.g, i), alpha,
                       x, y);
    Num<O>::put(e.uo, i, x);
    Num<O>::put(e.vo, i, y);
  }
}

template <int CAP, class S, class G, class O>
int launch_momentum(const long long* leaves, int count, int blocks, float alpha,
                    cudaStream_t stream) {
  MomentumTable<CAP> t;
  t.count = count;
  t.alpha = alpha;
  for (int i = 0; i < count; ++i) {
    const long long* r = leaves + 8 * i;
    MomentumLeaf& e = t.leaf[i];
    e.u = reinterpret_cast<const void*>(r[0]);
    e.v = reinterpret_cast<const void*>(r[1]);
    e.g = reinterpret_cast<const void*>(r[2]);
    e.uo = reinterpret_cast<void*>(r[3]);
    e.vo = reinterpret_cast<void*>(r[4]);
    e.n = r[5];
    e.block0 = (int)r[6];
    e.vec = (int)r[7];
  }
  momentum_multi_kernel<CAP, S, G, O><<<blocks, kThreads, 0, stream>>>(t);
  return (int)cudaGetLastError();
}

template <class S, class G, class O>
int launch_momentum_cap(const long long* leaves, int count, int blocks, float alpha,
                        cudaStream_t s) {
  if (count <= 8) return launch_momentum<8, S, G, O>(leaves, count, blocks, alpha, s);
  if (count <= 64) return launch_momentum<64, S, G, O>(leaves, count, blocks, alpha, s);
  return launch_momentum<kTableCap, S, G, O>(leaves, count, blocks, alpha, s);
}

// u, v of type S, the mask of type M, the outputs of type O.
template <class S, class M, class O>
__global__ void apply_mask_kernel(const void* __restrict__ u, const void* __restrict__ v,
                                  const void* __restrict__ mk, void* __restrict__ go,
                                  void* __restrict__ uo, void* __restrict__ vo,
                                  int64_t total, int vec) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t nvec = vec ? total / 4 : 0;
  for (int64_t q = tid; q < nvec; q += stride) {
    const float4 a = Num<S>::get4(u, q);
    const float4 b = Num<S>::get4(v, q);
    const float4 c = Num<M>::get4(mk, q);
    float4 x, y, z;
    mask_one<M>(a.x, b.x, c.x, x.x, y.x, z.x);
    mask_one<M>(a.y, b.y, c.y, x.y, y.y, z.y);
    mask_one<M>(a.z, b.z, c.z, x.z, y.z, z.z);
    mask_one<M>(a.w, b.w, c.w, x.w, y.w, z.w);
    Num<O>::put4(go, q, x);
    Num<O>::put4(uo, q, y);
    Num<O>::put4(vo, q, z);
  }
  for (int64_t i = nvec * 4 + tid; i < total; i += stride) {
    float x, y, z;
    mask_one<M>(Num<S>::get(u, i), Num<S>::get(v, i), Num<M>::get(mk, i), x, y, z);
    Num<O>::put(go, i, x);
    Num<O>::put(uo, i, y);
    Num<O>::put(vo, i, z);
  }
}

// Per-segment scalars of flat element e of a [rows, n] stack: the (row,
// leaf) found once by a binary search of the offsets and walked forward.
struct SegScalars {
  const long long* off;  // o_0..o_L in shared memory
  const float* tau;
  const float* inv_nv;
  const float* inv_nm;
  const float* thr;
  int leaves;
  int64_t n;
  int64_t row;
  int leaf;
  int64_t end;  // first flat element past the current segment
  float t, a, b, c;

  __device__ __forceinline__ void load() {
    const int64_t s = row * leaves + leaf;
    t = tau[row];
    a = inv_nv[s];
    b = inv_nm[s];
    c = thr[s];
  }
  __device__ __forceinline__ void seek(int64_t e) {
    row = e / n;
    const long long col = e - row * n;
    int lo = 0, hi = leaves - 1;  // the last leaf whose offset is <= col
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (off[mid] <= col) lo = mid; else hi = mid - 1;
    }
    leaf = lo;
    end = row * n + off[leaf + 1];
    load();
  }
  __device__ __forceinline__ float mask(int64_t e, float v, float m) {
    if (e >= end) {
      do {
        if (++leaf == leaves) {
          leaf = 0;
          ++row;
        }
        end = row * n + off[leaf + 1];
      } while (e >= end);
      load();
    }
    return gmf_mask(v, m, t, a, b, c);
  }
};

// u, v and the outputs (the mask too) of type S, m of type M.
template <class S, class M>
__global__ void __launch_bounds__(kThreads)
gmf_compress_kernel(const void* __restrict__ u, const void* __restrict__ v,
                    const void* __restrict__ m, const float* __restrict__ inv_nv,
                    const float* __restrict__ inv_nm, const float* __restrict__ thr,
                    const float* __restrict__ tau, const long long* __restrict__ offsets,
                    int leaves, int64_t n, void* __restrict__ go, void* __restrict__ uo,
                    void* __restrict__ vo, void* __restrict__ mo, int64_t total, int vec) {
  extern __shared__ long long s_off[];
  for (int i = threadIdx.x; i <= leaves; i += kThreads) s_off[i] = offsets[i];
  __syncthreads();
  const int64_t begin = (int64_t)blockIdx.x * kChunk;
  const int64_t end = begin + kChunk < total ? begin + kChunk : total;
  SegScalars s{s_off, tau, inv_nv, inv_nm, thr, leaves, n};
  int64_t i = begin + threadIdx.x;
  if (vec) {  // kChunk is a multiple of 4: the quads of [begin, end)
    const int64_t qend = end / 4;
    int64_t q = begin / 4 + threadIdx.x;
    if (q < qend) s.seek(4 * q);
    for (; q < qend; q += kThreads) {
      const int64_t e = 4 * q;
      const float4 a = Num<S>::get4(u, q);
      const float4 b = Num<S>::get4(v, q);
      const float4 c = Num<M>::get4(m, q);
      float4 mk;
      mk.x = s.mask(e, b.x, c.x);
      mk.y = s.mask(e + 1, b.y, c.y);
      mk.z = s.mask(e + 2, b.z, c.z);
      mk.w = s.mask(e + 3, b.w, c.w);
      float4 x, y, z;
      mask_one<S>(a.x, b.x, mk.x, x.x, y.x, z.x);
      mask_one<S>(a.y, b.y, mk.y, x.y, y.y, z.y);
      mask_one<S>(a.z, b.z, mk.z, x.z, y.z, z.z);
      mask_one<S>(a.w, b.w, mk.w, x.w, y.w, z.w);
      Num<S>::put4(go, q, x);
      Num<S>::put4(uo, q, y);
      Num<S>::put4(vo, q, z);
      Num<S>::put4(mo, q, mk);
    }
    i = qend * 4 + threadIdx.x;  // the ragged end of the last block
  }
  if (i < end) s.seek(i);
  for (; i < end; i += kThreads) {
    const float vi = Num<S>::get(v, i);
    const float mk = s.mask(i, vi, Num<M>::get(m, i));
    float x, y, z;
    mask_one<S>(Num<S>::get(u, i), vi, mk, x, y, z);
    Num<S>::put(mo, i, mk);
    Num<S>::put(go, i, x);
    Num<S>::put(uo, i, y);
    Num<S>::put(vo, i, z);
  }
}

// ---------------------------------------------------------------------------
// gmf_select: norms and exact top-k thresholds, one block per segment
// ---------------------------------------------------------------------------

constexpr int kSelThreads = 256;
constexpr int kSelWarps = kSelThreads / 32;
constexpr int kBins = 2048;  // 11-bit digits
constexpr int kBinsPerThread = kBins / kSelThreads;
// Elements a thread loads before it counts them: a segment of 36,864 takes
// 144 elements a thread, and a loop that waits for each load in turn is
// bound by the latency of the largest segment's block, not by bytes.
constexpr int kSelUnroll = 4;

// The sum of x over the block, in a fixed order: a shuffle tree in each warp,
// then one over the warps' sums. Every thread gets the result.
__device__ __forceinline__ double block_sum(double x, double* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = __dadd_rn(x, __shfl_down_sync(0xffffffffu, x, o));
  if (lane == 0) red[warp] = x;
  __syncthreads();
  if (warp == 0) {
    x = lane < kSelWarps ? red[lane] : 0.0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x = __dadd_rn(x, __shfl_down_sync(0xffffffffu, x, o));
    if (lane == 0) red[kSelWarps] = x;
  }
  __syncthreads();
  return red[kSelWarps];
}

struct Select {
  unsigned* hist;   // kBins
  unsigned* warps;  // kSelWarps + 2: warp totals, then the bin and rank found
};

// One radix pass: counts the candidates (bits & pmask) == prefix by their
// digit (bits >> shift) & dmask, and returns the digit of the bin holding
// the rank-th largest candidate; rank becomes its rank inside that bin.
template <class Bits>
__device__ unsigned radix_pass(const Select& sel, int64_t n, Bits bits_of, unsigned prefix,
                               unsigned pmask, int shift, unsigned dmask, unsigned& rank) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = threadIdx.x; i < kBins; i += kSelThreads) sel.hist[i] = 0;
  __syncthreads();
  // j0 is the same in all lanes of a warp, so the warp stays whole for
  // __match_any_sync; element j0 + q * kSelThreads + lane is counted once
  for (int64_t j0 = (int64_t)warp * 32; j0 < n; j0 += kSelThreads * kSelUnroll) {
    unsigned bits[kSelUnroll];
#pragma unroll
    for (int q = 0; q < kSelUnroll; ++q) {
      const int64_t j = j0 + q * kSelThreads + lane;
      bits[q] = j < n ? bits_of(j) : 0u;
    }
#pragma unroll
    for (int q = 0; q < kSelUnroll; ++q) {
      const bool hit = j0 + q * kSelThreads + lane < n && (bits[q] & pmask) == prefix;
      const unsigned d = (bits[q] >> shift) & dmask;
      const unsigned peers = __match_any_sync(0xffffffffu, hit ? d : 0xffffffffu);
      if (hit && lane == __ffs(peers) - 1) atomicAdd(&sel.hist[d], (unsigned)__popc(peers));
    }
  }
  __syncthreads();
  // thread t owns kBinsPerThread bins, thread 0 the top ones
  const int top = kBins - kBinsPerThread * threadIdx.x;
  unsigned own = 0;
#pragma unroll
  for (int i = 1; i <= kBinsPerThread; ++i) own += sel.hist[top - i];
  unsigned incl = own;  // inclusive scan over the threads, in order
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) sel.warps[warp] = incl;
  __syncthreads();
  unsigned above = incl - own;
  for (int w = 0; w < warp; ++w) above += sel.warps[w];
  if (above < rank && rank <= above + own) {
    unsigned acc = above;
    for (int i = 1; i <= kBinsPerThread; ++i) {
      const unsigned c = sel.hist[top - i];
      if (acc + c >= rank) {
        sel.warps[kSelWarps] = top - i;
        sel.warps[kSelWarps + 1] = rank - acc;
        break;
      }
      acc += c;
    }
  }
  __syncthreads();
  const unsigned digit = sel.warps[kSelWarps];
  rank = sel.warps[kSelWarps + 1];
  __syncthreads();  // the next pass clears hist and writes warps again
  return digit;
}

// The bits of the rank-th largest of n scores (bits_of(j) is score j's
// float bits, a non-negative float): three passes of 11, 11 and 10 bits.
template <class Bits>
__device__ unsigned radix_select(const Select& sel, int64_t n, Bits bits_of, unsigned rank) {
  unsigned prefix = 0, pmask = 0;
  const int shifts[3] = {21, 10, 0};
  const unsigned widths[3] = {0x7ffu, 0x7ffu, 0x3ffu};
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    const unsigned d = radix_pass(sel, n, bits_of, prefix, pmask, shifts[p], widths[p], rank);
    prefix |= d << shifts[p];
    pmask |= widths[p] << shifts[p];
  }
  return prefix;
}

// v (or z) of type S, m of type M; the norms, thresholds and |z| mode's
// mask are float32.
template <bool ABS, class S, class M>
__global__ void __launch_bounds__(kSelThreads)
select_kernel(const void* __restrict__ v, const void* __restrict__ m,
              const long long* __restrict__ offsets, const long long* __restrict__ keep,
              int keep_stride, const float* __restrict__ w, const float* __restrict__ tau,
              float eps,
              int leaves, int64_t n, float* __restrict__ inv_nv_out,
              float* __restrict__ inv_nm_out, float* __restrict__ thr_out,
              float* __restrict__ mask_out) {
  __shared__ unsigned hist[kBins];
  __shared__ unsigned warps[kSelWarps + 2];
  __shared__ double red[kSelWarps + 1];
  const int64_t seg = blockIdx.x;  // row * leaves + leaf
  const int64_t row = seg / leaves;
  const int leaf = (int)(seg - row * leaves);
  const int64_t lo = offsets[leaf];
  const int64_t len = offsets[leaf + 1] - lo;
  const unsigned rank = (unsigned)keep[row * keep_stride + leaf];
  const int64_t base = row * n + lo;
  float t = 0.0f, a = 0.0f, b = 0.0f;
  if (!ABS) {
    // float32 squares summed in float64: a segment of 2^24 elements would
    // lose ~1e-6 of its sum in float32 partials of 65,536 terms a thread
    double sv = 0.0, sm = 0.0;
    for (int64_t j0 = threadIdx.x; j0 < len; j0 += kSelThreads * kSelUnroll) {
      float x[kSelUnroll], y[kSelUnroll];
#pragma unroll
      for (int q = 0; q < kSelUnroll; ++q) {
        const int64_t j = j0 + q * kSelThreads;
        x[q] = j < len ? Num<S>::get(v, base + j) : 0.0f;
        y[q] = j < len ? Num<M>::get(m, base + j) : 0.0f;
      }
#pragma unroll
      for (int q = 0; q < kSelUnroll; ++q) {
        sv = __dadd_rn(sv, (double)__fmul_rn(x[q], x[q]));
        sm = __dadd_rn(sm, (double)__fmul_rn(y[q], y[q]));
      }
    }
    sv = block_sum(sv, red);
    __syncthreads();  // red is read by every thread before it is written again
    sm = block_sum(sm, red);
    t = tau[row];
    a = __fdiv_rn(w[row], __fadd_rn(__fsqrt_rn(__double2float_rn(sv)), eps));
    b = __fdiv_rn(1.0f, __fadd_rn(__fsqrt_rn(__double2float_rn(sm)), eps));
  }
  if (len == 0) {  // no element: nothing to select
    if (threadIdx.x == 0) {
      thr_out[seg] = 0.0f;
      if (!ABS) {
        inv_nv_out[seg] = a;
        inv_nm_out[seg] = b;
      }
    }
    return;
  }
  const Select sel{hist, warps};
  unsigned bits;
  if (ABS) {
    bits = radix_select(sel, len, [=](int64_t j) {
      return __float_as_uint(fabsf(Num<S>::get(v, base + j)));
    }, rank);
  } else {
    bits = radix_select(sel, len, [=](int64_t j) {
      return __float_as_uint(gmf_score(Num<S>::get(v, base + j), Num<M>::get(m, base + j), t,
                                       a, b));
    }, rank);
  }
  const float thr = __uint_as_float(bits);
  if (threadIdx.x == 0) {
    thr_out[seg] = thr;
    if (!ABS) {
      inv_nv_out[seg] = a;
      inv_nm_out[seg] = b;
    }
  }
  if (ABS) {
    float* mk = mask_out + base;
    for (int64_t j = threadIdx.x; j < len; j += kSelThreads)
      mk[j] = fabsf(Num<S>::get(v, base + j)) >= thr ? 1.0f : 0.0f;
  }
}

int blocks_for(int64_t total, int vec) {
  const int64_t work = vec ? (total + 3) / 4 : total;
  int64_t b = (work + kThreads - 1) / kThreads;
  if (b > kMaxBlocks) b = kMaxBlocks;
  return b < 1 ? 1 : (int)b;
}

// dtype codes of the C interface
constexpr int kF32 = 0;
constexpr int kBF16 = 1;

bool known(int code) { return code == kF32 || code == kBF16; }

// Calls f(A{}) with A the element type of `code` (float or bf16).
template <class F>
int with_type(int code, F f) {
  if (code == kBF16) return f(bf16{});
  return f(0.0f);
}

template <class S, class M>
int launch_apply_mask_out(int o, const void* u, const void* v, const void* mask, void* go,
                          void* uo, void* vo, long long total, int vec, cudaStream_t st) {
  const int b = blocks_for(total, vec);
  if (o == kBF16)
    apply_mask_kernel<S, M, bf16><<<b, kThreads, 0, st>>>(u, v, mask, go, uo, vo, total, vec);
  else
    apply_mask_kernel<S, M, float><<<b, kThreads, 0, st>>>(u, v, mask, go, uo, vo, total, vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The table's capacity and the elements per block, for the caller's plan.
void gmf_momentum_limits(int* capacity, int* chunk) {
  *capacity = kTableCap;
  *chunk = kChunk;
}

// One launch over `count` <= kTableCap leaves. `leaves` holds eight int64
// a leaf: the pointers u, v, g, u', v', the element count, the leaf's first
// block (a prefix of ceil(n / kChunk)) and 1 where all five pointers are
// aligned to a quad of their type; `blocks` is the grid. u and v are of
// dtype s, g of g_dtype, u' and v' of o (promote(s, g), or s); alpha is
// already rounded to s. Leaves of 0 elements are left out by the caller.
int gmf_momentum_multi(const long long* leaves, int count, int blocks, float alpha, int s,
                       int g, int o, void* stream) {
  if (count < 1 || count > kTableCap || blocks < 1 || !known(s) || !known(g) || !known(o))
    return (int)cudaErrorInvalidValue;
  const bool promoted_bf16 = s == kBF16 && g == kBF16;
  if (o == kBF16 && s != kBF16) return (int)cudaErrorInvalidValue;  // o is promote(s, g) or s
  if (o == kF32 && promoted_bf16) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return with_type(s, [&](auto sv) {
    using S = decltype(sv);
    return with_type(g, [&](auto gv) {
      using G = decltype(gv);
      return with_type(o, [&](auto ov) {
        using O = decltype(ov);
        return launch_momentum_cap<S, G, O>(leaves, count, blocks, alpha, st);
      });
    });
  });
}

// u, v of dtype s, the mask of dtype m, the outputs of dtype o
// (promote(s, m), or s); vec is 1 where every pointer is quad-aligned.
int gmf_apply_mask(const void* u, const void* v, const void* mask, void* go, void* uo,
                   void* vo, long long total, int vec, int s, int m, int o, void* stream) {
  if (!known(s) || !known(m) || !known(o)) return (int)cudaErrorInvalidValue;
  if (o == kBF16 && s != kBF16) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return with_type(s, [&](auto sv) {
    using S = decltype(sv);
    return with_type(m, [&](auto mv) {
      using M = decltype(mv);
      return launch_apply_mask_out<S, M>(o, u, v, mask, go, uo, vo, total, vec, st);
    });
  });
}

// Norms and thresholds of every (row, leaf) segment of v and m ([rows, n]
// stacks over `leaves` leaves, of dtypes s and m_dtype): writes inv_nv,
// inv_nm and thr, [rows, leaves] float32 each. offsets holds leaves + 1
// int64; keep (the k_i) is an int64 table whose row r starts at
// keep + r * keep_stride (keep_stride leaves or 0).
int gmf_select(const void* v, const void* m, const long long* offsets, const long long* keep,
               int keep_stride, const float* w, const float* tau, float eps, int leaves,
               long long rows, long long n, float* inv_nv, float* inv_nm, float* thr, int s,
               int m_dtype, void* stream) {
  if (leaves < 1 || rows < 1 || rows * leaves > 0x7fffffffLL ||
      (keep_stride != 0 && keep_stride != leaves) || !known(s) || !known(m_dtype))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return with_type(s, [&](auto sv) {
    using S = decltype(sv);
    return with_type(m_dtype, [&](auto mv) {
      using M = decltype(mv);
      select_kernel<false, S, M><<<(unsigned)(rows * leaves), kSelThreads, 0, st>>>(
          v, m, offsets, keep, keep_stride, w, tau, eps, leaves, n, inv_nv, inv_nm, thr,
          nullptr);
      return (int)cudaGetLastError();
    });
  });
}

// The k_i-th largest |z| of every segment into thr ([rows, leaves]) and the
// float32 mask |z| >= thr into mask ([rows, n]); z of dtype z_dtype; keep as
// for gmf_select.
int gmf_select_abs(const void* z, const long long* offsets, const long long* keep,
                   int keep_stride, int leaves, long long rows, long long n, float* thr,
                   float* mask, int z_dtype, void* stream) {
  if (leaves < 1 || rows < 1 || rows * leaves > 0x7fffffffLL ||
      (keep_stride != 0 && keep_stride != leaves) || !known(z_dtype))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return with_type(z_dtype, [&](auto zv) {
    using Z = decltype(zv);
    select_kernel<true, Z, Z><<<(unsigned)(rows * leaves), kSelThreads, 0, st>>>(
        z, nullptr, offsets, keep, keep_stride, nullptr, nullptr, 0.0f, leaves, n, nullptr,
        nullptr, thr, mask);
    return (int)cudaGetLastError();
  });
}

// The fused mask pass over [rows, n] stacks of `leaves` leaves, with the
// [rows, leaves] scalars of gmf_select and tau [rows]; total = rows * n.
// u, v and the outputs are of dtype s, m of m_dtype.
int gmf_compress(const void* u, const void* v, const void* m, const float* inv_nv,
                 const float* inv_nm, const float* thr, const float* tau,
                 const long long* offsets, int leaves, long long n, void* go, void* uo,
                 void* vo, void* mo, long long total, int vec, int s, int m_dtype,
                 void* stream) {
  if (leaves < 1 || leaves > kMaxLeaves || !known(s) || !known(m_dtype))
    return (int)cudaErrorInvalidValue;
  const long long blocks = (total + kChunk - 1) / kChunk;
  cudaStream_t st = (cudaStream_t)stream;
  return with_type(s, [&](auto sv) {
    using S = decltype(sv);
    return with_type(m_dtype, [&](auto mv) {
      using M = decltype(mv);
      gmf_compress_kernel<S, M><<<(unsigned)blocks, kThreads, (leaves + 1) * sizeof(long long),
                                  st>>>(u, v, m, inv_nv, inv_nm, thr, tau, offsets, leaves, n,
                                        go, uo, vo, mo, total, vec);
      return (int)cudaGetLastError();
    });
  });
}

}  // extern "C"
