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
//                    gmf_compress_flat (src/repro/core/stages.py:476; no
//                    Pallas kernel): per (client, leaf) segment, ||V||,
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
// gmf_select splits a segment over blocks. A host plan per layout
// (kernels/gmf_compress.py:plan_select) cuts each leaf into tiles of one
// length; a leaf of one tile is "local", a longer one "split". A local
// segment is selected whole by one block: its squares of V and M summed in
// a fixed order (strided per-thread partials in float64, then a fixed
// shuffle tree), inv_nv = w / (sqrt(||V||^2) + eps) and inv_nm = 1 /
// (sqrt(||M||^2) + eps) correctly rounded, then the k_i-th largest z by a
// radix select on the float's bits (z >= 0, so its bits order as its
// values): three passes of 11, 11 and 10 bits each count the candidates
// that match the digits found so far in a 2,048-bin shared histogram, and
// a block scan from the top bin finds the bin that holds the k-th largest.
// A split segment takes one block a tile in each phase of the same
// algorithm: the tiles' float64 partial sums, added in tile order by the
// last tile to finish (so every run gives the same bits); then per radix
// pass each tile's shared histogram added into the segment's global one
// with integer atomics (exact in any order: no floating-point atomic
// anywhere), and the last tile to finish scans it as the local block scans
// its own. The k-th largest value of a multiset does not depend on the
// algorithm, so every threshold is bitwise torch.topk's on the same z.
//
// The phases run in one launch: the blocks (as many as the card holds at
// once, by a cooperative launch) take each phase's items in turn, and a
// grid-wide barrier separates the phases. One launch rather than one per
// phase because the paper's paths are small (a Shakespeare round's select
// is 2.9M elements): there a launch per phase cost more in host time and
// gaps between the kernels than the work itself. Each
// phase rereads v and m (or z): four reads in all, 7.2 ms over
// llama3.2-1b's 3.0 GB row at 3.35 TB/s, against the 1.8 ms bound of one.
// A local leaf's block is the longest item, so the plan lists the local
// leaves largest first and the blocks take them first. A layout with no
// split leaf is one plain launch of one block a local segment. Candidates
// are counted with a shared atomic each (count_one says why).
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
// gmf_select: norms and exact top-k thresholds, a segment split over tiles
// ---------------------------------------------------------------------------

constexpr int kSelThreads = 256;
constexpr int kSelWarps = kSelThreads / 32;
constexpr int kBins = 2048;  // 11-bit digits
constexpr int kBinsPerThread = kBins / kSelThreads;
// Quads a thread loads before it counts them: the loads of a tile are in
// flight together rather than one after the other.
constexpr int kSelUnroll = 4;
// Blocks of select_kernel an SM holds at once (at most 64 registers a
// thread): every block of a cooperative launch is resident, so this is the
// grid's width over the split leaves' tiles.
constexpr int kSelBlocksPerSM = 4;

// The radix passes: pass p counts the digit at bits [shift, shift + width)
// of the candidates whose bits above it match the digits found so far.
__host__ __device__ constexpr int pass_shift(int p) { return p == 0 ? 21 : p == 1 ? 10 : 0; }
__host__ __device__ constexpr unsigned pass_dmask(int p) { return p == 2 ? 0x3ffu : 0x7ffu; }
__host__ __device__ constexpr unsigned pass_pmask(int p) {
  return p == 0 ? 0u : p == 1 ? 0xffe00000u : 0xfffffc00u;
}

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
  const double out = red[kSelWarps];
  __syncthreads();  // red may be written again by the caller's next sum
  return out;
}

// w / (sqrt(sum) + eps), correctly rounded from the float64 sum of squares.
__device__ __forceinline__ float inv_norm(float w, double sum, float eps) {
  return __fdiv_rn(w, __fadd_rn(__fsqrt_rn(__double2float_rn(sum)), eps));
}

// The elements [e0, e1) of a flat stack as aligned quads [qa, qb) between a
// scalar head [e0, head) and tail [tail, e1); no quads unless vec.
struct Span {
  int64_t e0, e1, qa, qb, head, tail;
  __device__ __forceinline__ Span(int64_t b, int64_t e, int vec)
      : e0(b), e1(e), qa(0), qb(0), head(e), tail(e) {
    const int64_t a = (b + 3) >> 2, z = e >> 2;
    if (vec && a < z) {
      qa = a;
      qb = z;
      head = 4 * a;
      tail = 4 * z;
    }
  }
};

// The float bits of the scores of a stack's elements: z, the fusion score of
// v and m under one segment's scalars, or |z| of v alone. Both are
// non-negative floats, whose bits order as their values.
template <bool ABS, class S, class M>
struct Scores {
  const void* v;
  const void* m;
  float t, a, b;
  __device__ __forceinline__ unsigned bits(float x, float y) const {
    return __float_as_uint(ABS ? fabsf(x) : gmf_score(x, y, t, a, b));
  }
  __device__ __forceinline__ unsigned one(int64_t i) const {
    return bits(Num<S>::get(v, i), ABS ? 0.0f : Num<M>::get(m, i));
  }
  __device__ __forceinline__ uint4 quad(int64_t q) const {
    const float4 x = Num<S>::get4(v, q);
    const float4 y = ABS ? make_float4(0.0f, 0.0f, 0.0f, 0.0f) : Num<M>::get4(m, q);
    return make_uint4(bits(x.x, y.x), bits(x.y, y.y), bits(x.z, y.z), bits(x.w, y.w));
  }
};

// Counts one score per lane into hist by its digit, if it is a candidate
// (valid, and its bits match prefix under pmask): one shared atomic a
// candidate. (Warp aggregation, one atomic per distinct digit in a warp by
// __match_any_sync, measured slower on every path the port runs:
// tools/torch_select_tiles.py --variants builds and times it.)
__device__ __forceinline__ void count_one(unsigned* hist, bool valid, unsigned bits,
                                          unsigned prefix, unsigned pmask, int shift,
                                          unsigned dmask) {
  const bool hit = valid && (bits & pmask) == prefix;
  if (hit) atomicAdd(&hist[(bits >> shift) & dmask], 1u);
}

// Pass p's count of the candidates among the scores of [e0, e1) into the
// shared histogram. The loops' trip counts are the same in every lane of a
// warp, so a warp-wide count_one (the aggregated variant) finds it whole.
template <class Sc>
__device__ void count_span(unsigned* hist, const Sc& sc, const Span& sp, unsigned prefix,
                           int p) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned pmask = pass_pmask(p), dmask = pass_dmask(p);
  const int shift = pass_shift(p);
  for (int64_t q0 = sp.qa + warp * 32; q0 < sp.qb; q0 += kSelThreads * kSelUnroll) {
    uint4 r[kSelUnroll];
    bool ok[kSelUnroll];
#pragma unroll
    for (int u = 0; u < kSelUnroll; ++u) {
      const int64_t q = q0 + u * kSelThreads + lane;
      ok[u] = q < sp.qb;
      r[u] = ok[u] ? sc.quad(q) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kSelUnroll; ++u) {
      count_one(hist, ok[u], r[u].x, prefix, pmask, shift, dmask);
      count_one(hist, ok[u], r[u].y, prefix, pmask, shift, dmask);
      count_one(hist, ok[u], r[u].z, prefix, pmask, shift, dmask);
      count_one(hist, ok[u], r[u].w, prefix, pmask, shift, dmask);
    }
  }
  for (int64_t j0 = sp.e0 + warp * 32; j0 < sp.head; j0 += kSelThreads) {
    const int64_t j = j0 + lane;
    count_one(hist, j < sp.head, j < sp.head ? sc.one(j) : 0u, prefix, pmask, shift, dmask);
  }
  for (int64_t j0 = sp.tail + warp * 32; j0 < sp.e1; j0 += kSelThreads) {
    const int64_t j = j0 + lane;
    count_one(hist, j < sp.e1, j < sp.e1 ? sc.one(j) : 0u, prefix, pmask, shift, dmask);
  }
}

// This thread's float64 partial sums of v^2 and m^2 over [e0, e1), in a
// fixed order (the float32 squares summed in float64: a segment of 2^24
// elements would lose ~1e-6 of its sum in float32 partials).
template <class S, class M>
__device__ void sum_squares(const void* v, const void* m, const Span& sp, double& sv,
                            double& sm) {
  for (int64_t q0 = sp.qa + threadIdx.x; q0 < sp.qb; q0 += kSelThreads * kSelUnroll) {
    float4 x[kSelUnroll], y[kSelUnroll];
#pragma unroll
    for (int u = 0; u < kSelUnroll; ++u) {
      const int64_t q = q0 + u * kSelThreads;
      const bool ok = q < sp.qb;
      x[u] = ok ? Num<S>::get4(v, q) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      y[u] = ok ? Num<M>::get4(m, q) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int u = 0; u < kSelUnroll; ++u) {
      sv = __dadd_rn(sv, (double)__fmul_rn(x[u].x, x[u].x));
      sv = __dadd_rn(sv, (double)__fmul_rn(x[u].y, x[u].y));
      sv = __dadd_rn(sv, (double)__fmul_rn(x[u].z, x[u].z));
      sv = __dadd_rn(sv, (double)__fmul_rn(x[u].w, x[u].w));
      sm = __dadd_rn(sm, (double)__fmul_rn(y[u].x, y[u].x));
      sm = __dadd_rn(sm, (double)__fmul_rn(y[u].y, y[u].y));
      sm = __dadd_rn(sm, (double)__fmul_rn(y[u].z, y[u].z));
      sm = __dadd_rn(sm, (double)__fmul_rn(y[u].w, y[u].w));
    }
  }
  for (int64_t j = sp.e0 + threadIdx.x; j < sp.head; j += kSelThreads) {
    const float x = Num<S>::get(v, j), y = Num<M>::get(m, j);
    sv = __dadd_rn(sv, (double)__fmul_rn(x, x));
    sm = __dadd_rn(sm, (double)__fmul_rn(y, y));
  }
  for (int64_t j = sp.tail + threadIdx.x; j < sp.e1; j += kSelThreads) {
    const float x = Num<S>::get(v, j), y = Num<M>::get(m, j);
    sv = __dadd_rn(sv, (double)__fmul_rn(x, x));
    sm = __dadd_rn(sm, (double)__fmul_rn(y, y));
  }
}

// |z| mode's float32 mask |z| >= thr over [e0, e1), a float4 store a quad.
template <class S>
__device__ void write_mask(const void* z, float* mask, const Span& sp, float thr) {
  for (int64_t q = sp.qa + threadIdx.x; q < sp.qb; q += kSelThreads) {
    const float4 x = Num<S>::get4(z, q);
    reinterpret_cast<float4*>(mask)[q] =
        make_float4(fabsf(x.x) >= thr ? 1.0f : 0.0f, fabsf(x.y) >= thr ? 1.0f : 0.0f,
                    fabsf(x.z) >= thr ? 1.0f : 0.0f, fabsf(x.w) >= thr ? 1.0f : 0.0f);
  }
  for (int64_t j = sp.e0 + threadIdx.x; j < sp.head; j += kSelThreads)
    mask[j] = fabsf(Num<S>::get(z, j)) >= thr ? 1.0f : 0.0f;
  for (int64_t j = sp.tail + threadIdx.x; j < sp.e1; j += kSelThreads)
    mask[j] = fabsf(Num<S>::get(z, j)) >= thr ? 1.0f : 0.0f;
}

// Bin j of the kBinsPerThread bins this thread owns in a scan: thread t
// owns bins kBins - 8t - 1 down to kBins - 8t - 8, thread 0 the top ones.
__device__ __forceinline__ int own_bin(int j) {
  return kBins - kBinsPerThread * (int)threadIdx.x - 1 - j;
}

// The bin that holds the rank-th largest candidate of a histogram, counted
// from the top bin, given each thread's own bins c (own_bin order): returns
// its digit and sets rank to the rank inside that bin. Every thread of the
// block calls it; warps holds kSelWarps + 2 words of shared memory.
__device__ unsigned scan_bins(const unsigned (&c)[kBinsPerThread], unsigned& rank,
                              unsigned* warps) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned own = 0;
#pragma unroll
  for (int i = 0; i < kBinsPerThread; ++i) own += c[i];
  unsigned incl = own;  // inclusive scan over the threads, in order
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warps[warp] = incl;
  if (threadIdx.x == 0) {  // a rank past every count finds digit 0
    warps[kSelWarps] = 0u;
    warps[kSelWarps + 1] = 0u;
  }
  __syncthreads();
  unsigned above = incl - own;
  for (int w = 0; w < warp; ++w) above += warps[w];
  if (above < rank && rank <= above + own) {
    unsigned acc = above;
#pragma unroll
    for (int i = 0; i < kBinsPerThread; ++i) {
      if (acc + c[i] >= rank) {
        warps[kSelWarps] = own_bin(i);
        warps[kSelWarps + 1] = rank - acc;
        break;
      }
      acc += c[i];
    }
  }
  __syncthreads();
  const unsigned digit = warps[kSelWarps];
  rank = warps[kSelWarps + 1];
  __syncthreads();  // warps is written again by the next scan
  return digit;
}

// The plan's tables (one int64 array, made once per layout): the local
// leaves [n_local][3] = (leaf, first column, length), largest first; the
// split leaves [n_split]; each split leaf's first tile [n_split + 1]; and
// the tiles [n_tiles][5] = (split index, leaf, first column, length, tiles
// of its leaf). The columns are a row's: a block finds its elements with
// one load, not a chain of them.
struct SelPlan {
  const long long* local;
  const long long* split;
  const long long* first;
  const long long* tiles;
  int n_local, n_split, n_tiles;
  __host__ SelPlan(const long long* p, int nl, int ns, int nt)
      : local(p), split(p + 3 * nl), first(p + 3 * nl + ns), tiles(p + 3 * nl + 2 * ns + 1),
        n_local(nl), n_split(ns), n_tiles(nt) {}
};

// A select's operands and scratch. partials is float64 [rows][n_tiles][2]
// (the tiles' sums of v^2 and m^2); hist is [rows][n_split][kBins] and
// state [rows][n_split][4] = (prefix, rank, tiles done, unused), both zero
// at the first launch: the last tile of a segment to finish a pass zeroes
// its histogram and its count again.
struct SelArgs {
  const void* v;
  const void* m;
  const long long* keep;
  const float* w;
  const float* tau;
  float* inv_nv;
  float* inv_nm;
  float* thr;
  float* mask;
  double* partials;
  unsigned* hist;
  unsigned* state;
  int64_t n;
  int64_t rows;
  float eps;
  int keep_stride, leaves, vec;
};

// The shared memory of a select block.
struct SelShared {
  unsigned hist[kBins];
  unsigned warps[kSelWarps + 2];
  double red[kSelWarps + 1];
  int last;
  unsigned cands;  // the group mode's candidates appended by this block
};

// Local leaf i of the plan in row `row`: a segment of at most one tile,
// selected whole by this block: its norms, three radix passes over its
// scores in the shared histogram (the re-reads come from L2), then |z|
// mode's mask.
template <bool ABS, class S, class M>
__device__ void select_local(int64_t i, int64_t row, const SelArgs& g, const SelPlan& plan,
                             SelShared& sh) {
  const long long* e = plan.local + 3 * i;
  const int leaf = (int)e[0];
  const int64_t seg = row * g.leaves + leaf;
  const Span sp(row * g.n + e[1], row * g.n + e[1] + e[2], g.vec);
  float t = 0.0f, a = 0.0f, b = 0.0f;
  if (!ABS) {
    double sv = 0.0, sm = 0.0;
    sum_squares<S, M>(g.v, g.m, sp, sv, sm);
    sv = block_sum(sv, sh.red);
    sm = block_sum(sm, sh.red);
    t = g.tau[row];
    a = inv_norm(g.w[row], sv, g.eps);
    b = inv_norm(1.0f, sm, g.eps);
  }
  float thr = 0.0f;  // no element: nothing to select
  if (sp.e1 > sp.e0) {
    const Scores<ABS, S, M> sc{g.v, g.m, t, a, b};
    unsigned rank = (unsigned)g.keep[row * g.keep_stride + leaf], prefix = 0u;
#pragma unroll 1
    for (int p = 0; p < 3; ++p) {
      for (int j = threadIdx.x; j < kBins; j += kSelThreads) sh.hist[j] = 0u;
      __syncthreads();
      count_span(sh.hist, sc, sp, prefix, p);
      __syncthreads();
      unsigned c[kBinsPerThread];
#pragma unroll
      for (int j = 0; j < kBinsPerThread; ++j) c[j] = sh.hist[own_bin(j)];
      prefix |= scan_bins(c, rank, sh.warps) << pass_shift(p);
    }
    thr = __uint_as_float(prefix);
  }
  if (threadIdx.x == 0) {
    g.thr[seg] = thr;
    if (!ABS) {
      g.inv_nv[seg] = a;
      g.inv_nm[seg] = b;
    }
  }
  if (ABS) write_mask<S>(g.v, g.mask, sp, thr);
}

// A tile's place: its split leaf s, the leaf, its elements in the stack and
// the tile count of its leaf.
struct Tile {
  int s, leaf;
  unsigned count;
  Span sp;
  __device__ __forceinline__ Tile(const SelPlan& plan, int64_t tile, int64_t row, int64_t n,
                                  int vec)
      : s((int)plan.tiles[5 * tile]),
        leaf((int)plan.tiles[5 * tile + 1]),
        count((unsigned)plan.tiles[5 * tile + 4]),
        sp(row * n + plan.tiles[5 * tile + 2],
           row * n + plan.tiles[5 * tile + 2] + plan.tiles[5 * tile + 3], vec) {}
};

// Called by every thread of a tile block after its writes for a split leaf
// of `tiles` tiles in this row, `done` its segment's ticket count: true in
// the one block that finishes the leaf's tiles last in this launch, which
// then sees every other tile's writes (each thread fences before thread 0
// takes a ticket; the ticket count is reset for the next launch). The
// segment-wide step that follows runs in that block, so no launch of its
// own is needed between the passes.
__device__ bool last_tile(unsigned* done, unsigned tiles, SelShared& sh) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    sh.last = atomicAdd(done, 1u) == tiles - 1;
    if (sh.last) *done = 0u;
  }
  __syncthreads();
  const bool last = sh.last;
  if (last) __threadfence();
  return last;
}

// The norms of a split leaf's tile: its float64 sums of v^2 and m^2 into
// partials; the last tile of the leaf sums the leaf's partials in tile order
// (a fixed order: every run gives the same bits) into its inverse norms.
template <class S, class M>
__device__ void norm_tile(int64_t tile, int64_t row, const SelArgs& g, const SelPlan& plan,
                          SelShared& sh) {
  const Tile tl(plan, tile, row, g.n, g.vec);
  double sv = 0.0, sm = 0.0;
  sum_squares<S, M>(g.v, g.m, tl.sp, sv, sm);
  sv = block_sum(sv, sh.red);
  sm = block_sum(sm, sh.red);
  if (threadIdx.x == 0) {
    double* out = g.partials + 2 * (row * plan.n_tiles + tile);
    out[0] = sv;
    out[1] = sm;
  }
  const int64_t rs = row * plan.n_split + tl.s;
  if (!last_tile(g.state + 4 * rs + 2, tl.count, sh)) return;
  const double* part = g.partials + 2 * row * plan.n_tiles;
  sv = sm = 0.0;
  for (long long i = plan.first[tl.s] + threadIdx.x; i < plan.first[tl.s + 1];
       i += kSelThreads) {
    sv = __dadd_rn(sv, __ldcg(part + 2 * i));
    sm = __dadd_rn(sm, __ldcg(part + 2 * i + 1));
  }
  sv = block_sum(sv, sh.red);
  sm = block_sum(sm, sh.red);
  if (threadIdx.x == 0) {
    const int64_t seg = row * g.leaves + tl.leaf;
    g.inv_nv[seg] = inv_norm(g.w[row], sv, g.eps);
    g.inv_nm[seg] = inv_norm(1.0f, sm, g.eps);
  }
}

// Radix pass p over a split leaf's tile: its candidates counted in shared
// memory, each nonzero bin added to the segment's global histogram
// (integer atomics: exact in any order); the last tile of the segment scans
// that histogram from the top bin, keeps the digit and the rank inside its
// bin in the segment's state, zeroes the histogram, and after the last pass
// writes the threshold.
template <bool ABS, class S, class M>
__device__ void count_tile(int p, int64_t tile, int64_t row, const SelArgs& g,
                           const SelPlan& plan, SelShared& sh) {
  const Tile tl(plan, tile, row, g.n, g.vec);
  const int64_t seg = row * g.leaves + tl.leaf, rs = row * plan.n_split + tl.s;
  Scores<ABS, S, M> sc{g.v, g.m, 0.0f, 0.0f, 0.0f};
  if (!ABS) {
    sc.t = g.tau[row];
    sc.a = __ldcg(g.inv_nv + seg);
    sc.b = __ldcg(g.inv_nm + seg);
  }
  unsigned* st = g.state + 4 * rs;
  unsigned prefix = p == 0 ? 0u : __ldcg(st);
  for (int j = threadIdx.x; j < kBins; j += kSelThreads) sh.hist[j] = 0u;
  __syncthreads();
  count_span(sh.hist, sc, tl.sp, prefix, p);
  __syncthreads();
  unsigned* hist = g.hist + rs * kBins;
  for (int j = threadIdx.x; j < kBins; j += kSelThreads)
    if (sh.hist[j]) atomicAdd(hist + j, sh.hist[j]);
  if (!last_tile(g.state + 4 * rs + 2, tl.count, sh)) return;
  unsigned rank = p == 0 ? (unsigned)g.keep[row * g.keep_stride + tl.leaf] : __ldcg(st + 1);
  unsigned c[kBinsPerThread];
#pragma unroll
  for (int j = 0; j < kBinsPerThread; ++j) {
    c[j] = __ldcg(hist + own_bin(j));
    hist[own_bin(j)] = 0u;
  }
  prefix |= scan_bins(c, rank, sh.warps) << pass_shift(p);
  if (threadIdx.x == 0) {
    st[0] = prefix;
    st[1] = rank;
    if (p == 2) g.thr[seg] = __uint_as_float(prefix);
  }
}

// |z| mode's mask over a split leaf's tile.
template <class S>
__device__ void mask_tile(int64_t tile, int64_t row, const SelArgs& g, const SelPlan& plan) {
  const Tile tl(plan, tile, row, g.n, g.vec);
  write_mask<S>(g.v, g.mask, tl.sp, __ldcg(g.thr + row * g.leaves + tl.leaf));
}

// A barrier over the whole grid, for a grid whose blocks are all resident
// at once (a cooperative launch guarantees it, or refuses the launch).
// bar[0] counts the blocks that arrived and is reset by the last; bar[1]
// is a generation the others wait on.
__device__ void grid_sync(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned* gen = bar + 1;
    const unsigned g0 = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      bar[0] = 0u;
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      while (*gen == g0) __nanosleep(32);
    }
    __threadfence();
  }
  __syncthreads();
}

// The whole select in one launch. Its work comes in phases, each a list of
// items over every row (row varying fastest) that the blocks take in turn:
// phase 0 the local leaves, largest first, then the split leaves' tiles for
// the norms (fused) or for radix pass 0 (|z|); then one phase per remaining
// radix pass; then, in |z| mode, the mask. A segment-wide step (the norms'
// sum, a pass's scan) runs in the last block to finish the segment's tiles
// in a phase, and a grid-wide barrier separates the phases, so nothing is
// read back to the host and nothing else is launched. A layout with no
// split leaf has phase 0 only.
template <bool ABS, class S, class M>
__global__ void __launch_bounds__(kSelThreads, kSelBlocksPerSM)
select_kernel(const SelArgs g, const SelPlan plan, unsigned* bar) {
  __shared__ SelShared sh;
  const int64_t rows = g.rows, locals = plan.n_local * rows, tiles = plan.n_tiles * rows;
  for (int64_t it = blockIdx.x; it < locals + tiles; it += gridDim.x) {
    if (it < locals) {
      select_local<ABS, S, M>(it / rows, it % rows, g, plan, sh);
    } else if (ABS) {
      count_tile<ABS, S, M>(0, (it - locals) / rows, (it - locals) % rows, g, plan, sh);
    } else {
      norm_tile<S, M>((it - locals) / rows, (it - locals) % rows, g, plan, sh);
    }
    __syncthreads();  // the next item reuses the shared memory
  }
  if (!plan.n_split) return;
#pragma unroll 1
  for (int p = ABS ? 1 : 0; p < 3; ++p) {
    grid_sync(bar);
    for (int64_t it = blockIdx.x; it < tiles; it += gridDim.x) {
      count_tile<ABS, S, M>(p, it / rows, it % rows, g, plan, sh);
      __syncthreads();
    }
  }
  if (ABS) {
    grid_sync(bar);
    for (int64_t it = blockIdx.x; it < tiles; it += gridDim.x)
      mask_tile<S>(it / rows, it % rows, g, plan);
  }
}

// One launch of select_kernel on the stream: a plain launch of a block per
// item when there is no split leaf (no barrier), else a cooperative launch
// of as many blocks as the card holds at once (at most one per phase 0
// item). bar is two zeroed words of scratch. The plain launch lets the
// hardware hand each free SM the next segment; the cooperative grid walks
// the items in a fixed stride and balances ResNet-56's 3,380 whole
// segments worse (tools/torch_select_tiles.py --variants times both).
template <bool ABS, class S, class M>
int launch_select(const SelArgs& g, const SelPlan& plan, unsigned* bar, cudaStream_t st) {
  const long long items = ((long long)plan.n_tiles + plan.n_local) * g.rows;
  auto kernel = select_kernel<ABS, S, M>;
  if (!plan.n_split) {
    kernel<<<(unsigned)items, kSelThreads, 0, st>>>(g, plan, bar);
    return (int)cudaGetLastError();
  }
  // the blocks the card holds at once, asked once per device
  static long long resident[64] = {};
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!resident[dev]) {
    int sms, per_sm;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (!err) err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kSelThreads, 0);
    if (err) return (int)err;
    resident[dev] = (long long)sms * per_sm;
  }
  const long long most = resident[dev];
  const unsigned blocks = (unsigned)(items < most ? items : most);
  SelArgs ga = g;
  SelPlan pa = plan;
  void* args[] = {&ga, &pa, &bar};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(blocks), dim3(kSelThreads), args,
                                    0, st);
  return err ? (int)err : (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// gmf_select's group mode: a segment cut over a group of ranks
// ---------------------------------------------------------------------------
//
// The select's steps as launches of their own, so that between them the
// caller can sum over the group what a cut segment's ranks hold apart: the
// float64 sums of v^2 and m^2 (before the score), then each radix pass's
// histogram (before the next pass reads it). The plan puts the cut segments
// first among the split ones, and the group mode indexes the split
// segments' scratch split-major (rs = s * rows + row), so the cut segments'
// sums and histograms are one contiguous prefix of each buffer.
//
// Reading v and m (or z) once for the norms and once for each radix pass
// would be four reads, 7.2 ms over llama3.2-1b's bf16 row against the 1.8 ms
// bound of one. Here a call reads them twice in full, and passes 1 and 2
// read a small share of the scores kept aside in pass 0:
//   0  the local leaves whole (as in the single launch); (fused) the split
//      leaves' tiles' float64 partials, which the last tile of each segment
//      sums in tile order into gsum (the single launch's order); (|z|)
//      step 1's blocks
//   1  the sample (fused: after the norms' sums): one block a split segment
//      zeroes the segment's histograms and draws kSample scores of this
//      rank's piece at a fixed stride. From their top digits it takes a
//      bracket [lo, hi] of pass 0's 2,048 bins: the bins of the sample's
//      ranks k * S / whole -+ (4 standard deviations + 1), whole the
//      segment's size over the group -- with high probability the bin of
//      the k-th largest, one bin, or two where it lies near an edge
//   2  radix pass p over the split leaves' tiles into the pass's own
//      histogram. Pass 0 reads each tile in full (a block a tile) and also
//      appends the bits of each score whose top digit lies in the bracket
//      to the tile's candidate slots: a counter in shared memory, one
//      atomic a warp, room for a quarter of the tile (the plan's; past it
//      the tile has overflowed: the count goes on, the slots do not).
//      Passes 1 and 2 run a block a run of tiles (mostly of one segment,
//      whose counts it sums in shared memory) and scan the previous pass's
//      histogram, summed over the group, once a segment in every block (so
//      no scan launch): where the digit found, d0, lies in this rank's
//      bracket and the tile did not overflow, its slots hold every score of
//      the tile whose top digit is d0, and the pass counts them alone; else
//      it reads the tile in full, as the single launch does. The choice is
//      made per tile and rank on the device (the counter sits in shared
//      memory, and a tile that overflows costs only its own reread); both
//      give the same counts
//   3  (fused) each split segment's threshold and inverse norms; (|z|) the
//      mask over the split leaves' tiles, each block scanning pass 2's
//      histogram itself
// Each segment's sums are taken in the single launch's order and its
// histograms are integers, whatever path a tile took, so at a group of one
// the results are bitwise the single launch's. A fused call is 6 launches,
// a |z| one 5. Where the bracket holds, a fused call moves 2 reads of v and
// m plus about 12 bytes a candidate (a write and two reads of 4).

constexpr int kSample = 16384;  // scores a segment's sample draws at most

// A split segment's words of state in the group mode: its bracket, the
// norms' ticket count, the prefix and rank after passes 0 and 1 (written by
// the segment's first tile), and the tiles that read in full in pass 1.
enum : int { kLo, kHi, kTicket, kPrefix0, kRank0, kPrefix1, kRank1, kFullTiles, kStateWords };

// The group mode's plan and scratch beside SelArgs.
struct GroupArgs {
  const long long* whole;  // [n_split]: each split leaf's size over the group
  const long long* slots;  // [n_tiles + 1]: each tile's first candidate slot in a row
  double* gsum;            // [n_split][rows][2]: the segments' sums of v^2 and m^2
  unsigned* hist;          // [3][n_split][rows][kBins]: each radix pass's histograms
  unsigned* state;         // [n_split][rows][kStateWords]
  unsigned* counts;        // [n_tiles][rows]: the candidates each tile appended
  unsigned* cand;          // tile t of row r: cap_t slots at rows * slots[t] + r * cap_t
};

__device__ __forceinline__ unsigned* tile_slots(const GroupArgs& gr, int64_t tile, int64_t row,
                                                int64_t rows, unsigned& cap) {
  const long long a = gr.slots[tile], b = gr.slots[tile + 1];
  cap = (unsigned)(b - a);
  return gr.cand + rows * a + row * (b - a);
}

// A segment's scores: the fusion score under the norms summed over the
// group, or |z|.
template <bool ABS, class S, class M>
__device__ __forceinline__ Scores<ABS, S, M> group_scores(const SelArgs& g, const GroupArgs& gr,
                                                          int64_t rs, int64_t row) {
  Scores<ABS, S, M> sc{g.v, g.m, 0.0f, 0.0f, 0.0f};
  if (!ABS) {
    sc.t = g.tau[row];
    sc.a = inv_norm(g.w[row], gr.gsum[2 * rs], g.eps);
    sc.b = inv_norm(1.0f, gr.gsum[2 * rs + 1], g.eps);
  }
  return sc;
}

// Step 0's norms over a split leaf's tile: its float64 partials; the last
// tile of the segment sums the segment's in tile order into gsum.
template <class S, class M>
__device__ void group_norm_tile(int64_t tile, int64_t row, const SelArgs& g, const GroupArgs& gr,
                                const SelPlan& plan, SelShared& sh) {
  const Tile tl(plan, tile, row, g.n, g.vec);
  double sv = 0.0, sm = 0.0;
  sum_squares<S, M>(g.v, g.m, tl.sp, sv, sm);
  sv = block_sum(sv, sh.red);
  sm = block_sum(sm, sh.red);
  if (threadIdx.x == 0) {
    double* out = g.partials + 2 * (row * plan.n_tiles + tile);
    out[0] = sv;
    out[1] = sm;
  }
  const int64_t rs = tl.s * g.rows + row;
  if (!last_tile(gr.state + kStateWords * rs + kTicket, tl.count, sh)) return;
  const double* part = g.partials + 2 * row * plan.n_tiles;
  sv = sm = 0.0;
  for (long long i = plan.first[tl.s] + threadIdx.x; i < plan.first[tl.s + 1];
       i += kSelThreads) {
    sv = __dadd_rn(sv, __ldcg(part + 2 * i));
    sm = __dadd_rn(sm, __ldcg(part + 2 * i + 1));
  }
  sv = block_sum(sv, sh.red);
  sm = block_sum(sm, sh.red);
  if (threadIdx.x == 0) {
    gr.gsum[2 * rs] = sv;
    gr.gsum[2 * rs + 1] = sm;
  }
}

// The ranks of the sample of ns scores whose bins bound the bracket: k * ns
// / whole -+ (4 standard deviations of that count + 1), within [1, ns].
__device__ __forceinline__ void sample_ranks(long long k, long long whole, unsigned ns,
                                             unsigned& lo, unsigned& hi) {
  double q = whole > 0 ? __ddiv_rn((double)k, (double)whole) : 1.0;
  q = q < 0.0 ? 0.0 : q > 1.0 ? 1.0 : q;
  const double r = __dmul_rn(q, (double)ns);
  const double sd = __dsqrt_rn(__dmul_rn(__dmul_rn((double)ns, q), __dsub_rn(1.0, q)));
  const double d = __dadd_rn(__dmul_rn(4.0, sd), 1.0);
  const double a = floor(__dsub_rn(r, d)), b = ceil(__dadd_rn(r, d));
  lo = a < 1.0 ? 1u : (unsigned)a;
  hi = b > (double)ns ? ns : (unsigned)b;
}

// Step 1 over split segment rs: its three histograms and its count of
// full-read tiles zeroed, the sample's histogram of top digits, the bracket.
template <bool ABS, class S, class M>
__device__ void group_sample(int64_t rs, const SelArgs& g, const GroupArgs& gr,
                             const SelPlan& plan, SelShared& sh) {
  const int64_t s = rs / g.rows, row = rs % g.rows;
  const long long t0 = plan.first[s], t1 = plan.first[s + 1];
  const int leaf = (int)plan.tiles[5 * t0 + 1];
  const long long c0 = plan.tiles[5 * t0 + 2];
  const long long len = plan.tiles[5 * (t1 - 1) + 2] + plan.tiles[5 * (t1 - 1) + 3] - c0;
  const int64_t pass = (int64_t)plan.n_split * g.rows * kBins;
  unsigned* hist = gr.hist + rs * kBins;
  for (int j = threadIdx.x; j < kBins; j += kSelThreads) {
    sh.hist[j] = 0u;
    hist[j] = 0u;
    hist[pass + j] = 0u;
    hist[2 * pass + j] = 0u;
  }
  unsigned* st = gr.state + kStateWords * rs;
  if (threadIdx.x == 0) st[kFullTiles] = 0u;
  __syncthreads();
  const Scores<ABS, S, M> sc = group_scores<ABS, S, M>(g, gr, rs, row);
  const unsigned ns = (unsigned)(len < kSample ? len : kSample);
  const int64_t e0 = row * g.n + c0;
  constexpr int kLoads = 8;  // the sample's loads in flight together, a thread
  for (unsigned j0 = threadIdx.x; j0 < ns; j0 += kSelThreads * kLoads) {
    unsigned b[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const unsigned j = j0 + u * kSelThreads;
      b[u] = j < ns ? sc.one(e0 + (long long)j * len / ns) : 0u;
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u)
      if (j0 + u * kSelThreads < ns) atomicAdd(&sh.hist[b[u] >> pass_shift(0)], 1u);
  }
  __syncthreads();
  unsigned lo, hi;
  sample_ranks(g.keep[row * g.keep_stride + leaf], gr.whole[s], ns, lo, hi);
  unsigned c[kBinsPerThread];
#pragma unroll
  for (int j = 0; j < kBinsPerThread; ++j) c[j] = sh.hist[own_bin(j)];
  const unsigned top = scan_bins(c, lo, sh.warps);
  const unsigned bottom = scan_bins(c, hi, sh.warps);
  if (threadIdx.x == 0) {
    st[kLo] = bottom;
    st[kHi] = top;
  }
}

// Whether a score's top digit lies in [lo, lo + width].
__device__ __forceinline__ bool in_bracket(unsigned bits, unsigned lo, unsigned width) {
  return (bits >> pass_shift(0)) - lo <= width;
}

// Appends the scores of a warp's lanes whose top digit lies in the bracket
// to the tile's cap slots, in ballot order (every lane of the warp calls it,
// with its N scores and which of them are valid): one ballot a score, one
// shared atomic for the warp's run of slots, each hit written at its
// lane's place among the ballot's hits, so a ballot's hits are written to
// neighbouring slots. Past cap the count goes on, the slots do not.
template <int N>
__device__ __forceinline__ void append_hits(const unsigned (&bits)[N], const bool (&ok)[N],
                                            unsigned lo, unsigned width, unsigned* slots,
                                            unsigned cap, unsigned* cands) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  unsigned hit[N], total = 0u;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    hit[i] = __ballot_sync(0xffffffffu, ok[i] && in_bracket(bits[i], lo, width));
    total += __popc(hit[i]);
  }
  if (!total) return;
  unsigned at = 0u;
  if (lane == 0) at = atomicAdd(cands, total);
  at = __shfl_sync(0xffffffffu, at, 0);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (hit[i] >> lane & 1u) {
      const unsigned slot = at + __popc(hit[i] & below);
      if (slot < cap) slots[slot] = bits[i];
    }
    at += __popc(hit[i]);
  }
}

// Quads a thread loads in pass 0 before it counts and appends them.
constexpr int kAppendUnroll = 2;

// Pass 0 over [e0, e1): every score counted into hist by its top digit, and
// those whose digit lies in [lo, lo + width] appended to the tile's cap
// slots (append_hits). The loops' trip counts are the same in every lane of
// a warp, as the ballots need.
template <class Sc>
__device__ void count_append_span(unsigned* hist, const Sc& sc, const Span& sp, unsigned lo,
                                  unsigned width, unsigned* slots, unsigned cap,
                                  unsigned* cands) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int shift = pass_shift(0);
  constexpr int N = 4 * kAppendUnroll;
  for (int64_t q0 = sp.qa + warp * 32; q0 < sp.qb; q0 += kSelThreads * kAppendUnroll) {
    unsigned b[N];
    bool ok[N];
#pragma unroll
    for (int u = 0; u < kAppendUnroll; ++u) {
      const int64_t q = q0 + u * kSelThreads + lane;
      const bool in = q < sp.qb;
      const uint4 r = in ? sc.quad(q) : make_uint4(0u, 0u, 0u, 0u);
      b[4 * u] = r.x;
      b[4 * u + 1] = r.y;
      b[4 * u + 2] = r.z;
      b[4 * u + 3] = r.w;
      ok[4 * u] = ok[4 * u + 1] = ok[4 * u + 2] = ok[4 * u + 3] = in;
    }
#pragma unroll
    for (int i = 0; i < N; ++i)
      if (ok[i]) atomicAdd(&hist[b[i] >> shift], 1u);
    append_hits<N>(b, ok, lo, width, slots, cap, cands);
  }
  // the scalar head and tail: one score a lane
  const int64_t ends[2][2] = {{sp.e0, sp.head}, {sp.tail, sp.e1}};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    for (int64_t j0 = ends[h][0] + warp * 32; j0 < ends[h][1]; j0 += kSelThreads) {
      const int64_t j = j0 + lane;
      const bool ok[1] = {j < ends[h][1]};
      const unsigned b[1] = {ok[0] ? sc.one(j) : 0u};
      if (ok[0]) atomicAdd(&hist[b[0] >> shift], 1u);
      append_hits<1>(b, ok, lo, width, slots, cap, cands);
    }
  }
}

// Pass p's count of a tile's n candidates (16-byte aligned slots).
__device__ void count_slots(unsigned* hist, const unsigned* slots, unsigned n, unsigned prefix,
                            int p) {
  const unsigned pmask = pass_pmask(p), dmask = pass_dmask(p);
  const int shift = pass_shift(p);
  const unsigned nq = n / 4;
  for (unsigned q = threadIdx.x; q < nq; q += kSelThreads) {
    const uint4 r = reinterpret_cast<const uint4*>(slots)[q];
    count_one(hist, true, r.x, prefix, pmask, shift, dmask);
    count_one(hist, true, r.y, prefix, pmask, shift, dmask);
    count_one(hist, true, r.z, prefix, pmask, shift, dmask);
    count_one(hist, true, r.w, prefix, pmask, shift, dmask);
  }
  for (unsigned j = 4 * nq + threadIdx.x; j < n; j += kSelThreads)
    count_one(hist, true, slots[j], prefix, pmask, shift, dmask);
}

// The digit pass p - 1 (1 or 2) found in segment rs, from its histogram
// summed over the group: returns the prefix of the digits found so far and
// sets rank to the rank inside it. The segment's first tile keeps both in the
// state for the next step.
__device__ unsigned group_digits(int p, int64_t rs, int64_t row, int leaf, bool first,
                                 const SelArgs& g, const GroupArgs& gr, const SelPlan& plan,
                                 unsigned& rank, SelShared& sh) {
  unsigned* st = gr.state + kStateWords * rs;
  unsigned prefix = p == 1 ? 0u : st[kPrefix0];
  rank = p == 1 ? (unsigned)g.keep[row * g.keep_stride + leaf] : st[kRank0];
  const unsigned* h = gr.hist + ((p - 1) * (int64_t)plan.n_split * g.rows + rs) * kBins;
  unsigned c[kBinsPerThread];
#pragma unroll
  for (int j = 0; j < kBinsPerThread; ++j) c[j] = h[own_bin(j)];
  prefix |= scan_bins(c, rank, sh.warps) << pass_shift(p - 1);
  if (first && threadIdx.x == 0) {
    st[p == 1 ? kPrefix0 : kPrefix1] = prefix;
    st[p == 1 ? kRank0 : kRank1] = rank;
  }
  return prefix;
}

// Adds the shared histogram's nonzero bins to split segment rs's histogram
// of pass p and zeroes them.
__device__ void flush_hist(int p, int64_t rs, const SelArgs& g, const GroupArgs& gr,
                           const SelPlan& plan, SelShared& sh) {
  __syncthreads();
  unsigned* hist = gr.hist + (p * (int64_t)plan.n_split * g.rows + rs) * kBins;
  for (int j = threadIdx.x; j < kBins; j += kSelThreads)
    if (sh.hist[j]) {
      atomicAdd(hist + j, sh.hist[j]);
      sh.hist[j] = 0u;
    }
  __syncthreads();
}

// Step 2, radix pass 0 over a split leaf's tile into its segment's
// histogram of the pass, in full, with the candidates' appends.
template <bool ABS, class S, class M>
__device__ void group_pass0(int64_t tile, int64_t row, const SelArgs& g, const GroupArgs& gr,
                            const SelPlan& plan, SelShared& sh) {
  const Tile tl(plan, tile, row, g.n, g.vec);
  const int64_t rs = tl.s * g.rows + row;
  const unsigned* st = gr.state + kStateWords * rs;
  unsigned cap;
  unsigned* slots = tile_slots(gr, tile, row, g.rows, cap);
  const Scores<ABS, S, M> sc = group_scores<ABS, S, M>(g, gr, rs, row);
  const unsigned lo = st[kLo], width = st[kHi] - lo;
  for (int j = threadIdx.x; j < kBins; j += kSelThreads) sh.hist[j] = 0u;
  if (threadIdx.x == 0) sh.cands = 0u;
  __syncthreads();
  count_append_span(sh.hist, sc, tl.sp, lo, width, slots, cap, &sh.cands);
  flush_hist(0, rs, g, gr, plan, sh);
  if (threadIdx.x == 0) gr.counts[tile * g.rows + row] = sh.cands;
}

// Step 2, radix pass p (1 or 2) over the items [i0, i1) of the split
// leaves' tiles (item i: tile i % n_tiles of row i / n_tiles, so a block's
// items are mostly the tiles of one segment): each block scans the previous
// pass's histogram once a segment, and sums its tiles' counts of a segment
// in shared memory, added to the pass's histogram of the segment when it
// leaves it. A tile counts its candidates, or reads in full.
template <bool ABS, class S, class M>
__device__ void group_pass(int p, int64_t i0, int64_t i1, const SelArgs& g, const GroupArgs& gr,
                           const SelPlan& plan, SelShared& sh) {
  for (int j = threadIdx.x; j < kBins; j += kSelThreads) sh.hist[j] = 0u;
  int64_t cur = -1;  // the segment whose counts the shared histogram holds
  Scores<ABS, S, M> sc{g.v, g.m, 0.0f, 0.0f, 0.0f};
  unsigned* st = nullptr;
  unsigned lo = 0u, width = 0u, prefix = 0u, rank = 0u;
  for (int64_t it = i0; it < i1; ++it) {
    const int64_t row = it / plan.n_tiles, tile = it % plan.n_tiles;
    const Tile tl(plan, tile, row, g.n, g.vec);
    const int64_t rs = tl.s * g.rows + row;
    if (rs != cur) {
      if (cur >= 0) flush_hist(p, cur, g, gr, plan, sh);
      cur = rs;
      st = gr.state + kStateWords * rs;
      sc = group_scores<ABS, S, M>(g, gr, rs, row);
      lo = st[kLo];
      width = st[kHi] - lo;
      prefix = group_digits(p, rs, row, tl.leaf, tile == plan.first[tl.s], g, gr, plan, rank, sh);
    }
    unsigned cap;
    const unsigned* slots = tile_slots(gr, tile, row, g.rows, cap);
    const unsigned n = gr.counts[tile * g.rows + row];
    if (!in_bracket(prefix, lo, width) || n > cap) {
      if (p == 1 && threadIdx.x == 0) atomicAdd(st + kFullTiles, 1u);
      count_span(sh.hist, sc, tl.sp, prefix, p);
    } else {
      count_slots(sh.hist, slots, n, prefix, p);
    }
  }
  if (cur >= 0) flush_hist(p, cur, g, gr, plan, sh);
}

// |z| mode's float32 mask |z| >= thr over [e0, e1), kSelUnroll quads a
// thread in flight together.
template <class S>
__device__ void group_write_mask(const void* z, float* mask, const Span& sp, float thr) {
  for (int64_t q0 = sp.qa + threadIdx.x; q0 < sp.qb; q0 += kSelThreads * kSelUnroll) {
    float4 x[kSelUnroll];
#pragma unroll
    for (int u = 0; u < kSelUnroll; ++u) {
      const int64_t q = q0 + u * kSelThreads;
      x[u] = q < sp.qb ? Num<S>::get4(z, q) : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int u = 0; u < kSelUnroll; ++u) {
      const int64_t q = q0 + u * kSelThreads;
      if (q < sp.qb)
        reinterpret_cast<float4*>(mask)[q] = make_float4(
            fabsf(x[u].x) >= thr ? 1.0f : 0.0f, fabsf(x[u].y) >= thr ? 1.0f : 0.0f,
            fabsf(x[u].z) >= thr ? 1.0f : 0.0f, fabsf(x[u].w) >= thr ? 1.0f : 0.0f);
    }
  }
  for (int64_t j = sp.e0 + threadIdx.x; j < sp.head; j += kSelThreads)
    mask[j] = fabsf(Num<S>::get(z, j)) >= thr ? 1.0f : 0.0f;
  for (int64_t j = sp.tail + threadIdx.x; j < sp.e1; j += kSelThreads)
    mask[j] = fabsf(Num<S>::get(z, j)) >= thr ? 1.0f : 0.0f;
}

// The threshold of split segment rs after pass 2's histogram.
__device__ float group_threshold(int64_t rs, const SelArgs& g, const GroupArgs& gr,
                                 const SelPlan& plan, SelShared& sh) {
  const unsigned* st = gr.state + kStateWords * rs;
  unsigned rank = st[kRank1];
  const unsigned* h = gr.hist + (2 * (int64_t)plan.n_split * g.rows + rs) * kBins;
  unsigned c[kBinsPerThread];
#pragma unroll
  for (int j = 0; j < kBinsPerThread; ++j) c[j] = h[own_bin(j)];
  return __uint_as_float(st[kPrefix1] | scan_bins(c, rank, sh.warps) << pass_shift(2));
}

template <bool ABS, class S, class M>
__global__ void __launch_bounds__(kSelThreads)
group_first_kernel(const SelArgs g, const GroupArgs gr, const SelPlan plan) {
  __shared__ SelShared sh;
  const int64_t rows = g.rows, locals = plan.n_local * rows, it = blockIdx.x;
  if (it < locals) {
    select_local<ABS, S, M>(it / rows, it % rows, g, plan, sh);
  } else if (ABS) {
    group_sample<ABS, S, M>(it - locals, g, gr, plan, sh);
  } else {
    group_norm_tile<S, M>((it - locals) / rows, (it - locals) % rows, g, gr, plan, sh);
  }
}

template <bool ABS, class S, class M>
__global__ void __launch_bounds__(kSelThreads)
group_sample_kernel(const SelArgs g, const GroupArgs gr, const SelPlan plan) {
  __shared__ SelShared sh;
  group_sample<ABS, S, M>(blockIdx.x, g, gr, plan, sh);
}

// Radix pass 0 is bound by its instructions (the counts and the appends):
// six blocks an SM (at most 40 registers a thread) hide more of their
// latency than the four its registers would otherwise allow.
template <bool ABS, class S, class M>
__global__ void __launch_bounds__(kSelThreads, 6)
group_pass0_kernel(const SelArgs g, const GroupArgs gr, const SelPlan plan) {
  __shared__ SelShared sh;
  group_pass0<ABS, S, M>(blockIdx.x / g.rows, blockIdx.x % g.rows, g, gr, plan, sh);
}

template <bool ABS, class S, class M>
__global__ void __launch_bounds__(kSelThreads)
group_pass_kernel(int p, const SelArgs g, const GroupArgs gr, const SelPlan plan,
                  long long chunk) {
  __shared__ SelShared sh;
  const int64_t items = (int64_t)plan.n_tiles * g.rows, i0 = blockIdx.x * chunk;
  group_pass<ABS, S, M>(p, i0, i0 + chunk < items ? i0 + chunk : items, g, gr, plan, sh);
}

// Step 3: (fused) a block a split segment writes its threshold and inverse
// norms; (|z|) a block a tile writes its mask, the segment's first tile the
// threshold.
template <bool ABS, class S>
__global__ void __launch_bounds__(kSelThreads)
group_last_kernel(const SelArgs g, const GroupArgs gr, const SelPlan plan) {
  __shared__ SelShared sh;
  if constexpr (ABS) {
    const int64_t tile = blockIdx.x / g.rows, row = blockIdx.x % g.rows;
    const Tile tl(plan, tile, row, g.n, g.vec);
    const float thr = group_threshold(tl.s * g.rows + row, g, gr, plan, sh);
    if (threadIdx.x == 0 && tile == plan.first[tl.s]) g.thr[row * g.leaves + tl.leaf] = thr;
    group_write_mask<S>(g.v, g.mask, tl.sp, thr);
  } else {
    const int64_t rs = blockIdx.x, s = rs / g.rows, row = rs % g.rows;
    const float thr = group_threshold(rs, g, gr, plan, sh);
    if (threadIdx.x == 0) {
      const int64_t seg = row * g.leaves + plan.tiles[5 * plan.first[s] + 1];
      g.thr[seg] = thr;
      g.inv_nv[seg] = inv_norm(g.w[row], gr.gsum[2 * rs], g.eps);
      g.inv_nm[seg] = inv_norm(1.0f, gr.gsum[2 * rs + 1], g.eps);
    }
  }
}

// Blocks a launch of radix passes 1 and 2 runs for each SM: a few waves,
// so that a block's items are many tiles of one segment on a long row and
// the waves still balance.
constexpr int kChunkBlocksPerSM = 16;

// One step of the group mode on the stream (a step with nothing to do
// launches nothing): 0 the first launch, 1 (fused) the sample, 2 radix pass
// p, 3 the last launch.
template <bool ABS, class S, class M>
int launch_group_step(int step, int p, const SelArgs& g, const GroupArgs& gr,
                      const SelPlan& plan, cudaStream_t st) {
  const long long rows = g.rows;
  const unsigned splits = (unsigned)(plan.n_split * rows), tiles = (unsigned)(plan.n_tiles * rows);
  if (p < 0 || p > 2) return (int)cudaErrorInvalidValue;
  static int sms[64] = {};  // the SMs of each device, asked once
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!sms[dev]) {
    err = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (err) return (int)err;
  }
  const long long most = (long long)sms[dev] * kChunkBlocksPerSM;
  const long long chunk = (tiles + most - 1) / most;  // items a block
  const unsigned chunks = (unsigned)(chunk ? (tiles + chunk - 1) / chunk : 0);
  switch (step) {
    case 0: {
      const long long items = ((long long)plan.n_local + (ABS ? plan.n_split : plan.n_tiles)) * rows;
      if (items)
        group_first_kernel<ABS, S, M><<<(unsigned)items, kSelThreads, 0, st>>>(g, gr, plan);
      break;
    }
    case 1:
      if (!ABS && splits) group_sample_kernel<ABS, S, M><<<splits, kSelThreads, 0, st>>>(g, gr, plan);
      break;
    case 2:
      if (p == 0 && tiles)
        group_pass0_kernel<ABS, S, M><<<tiles, kSelThreads, 0, st>>>(g, gr, plan);
      if (p > 0 && chunks)
        group_pass_kernel<ABS, S, M><<<chunks, kSelThreads, 0, st>>>(p, g, gr, plan, chunk);
      break;
    case 3:
      if (ABS ? tiles : splits)
        group_last_kernel<ABS, S><<<ABS ? tiles : splits, kSelThreads, 0, st>>>(g, gr, plan);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
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

// A plan the select kernels take: every leaf local or split, a grid of at
// most 2^31 - 1 blocks, keep counts shared or one row each.
bool plan_ok(int leaves, long long rows, int n_local, int n_split, int n_tiles,
             int keep_stride) {
  return leaves >= 1 && rows >= 1 && n_local >= 0 && n_split >= 0 && n_tiles >= 0 &&
         n_local + n_split == leaves && (n_split > 0) == (n_tiles > 0) &&
         ((long long)n_tiles + n_local) * rows <= 0x7fffffffLL &&
         (keep_stride == 0 || keep_stride == leaves);
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
// inv_nm and thr, [rows, leaves] float32 each. keep (the k_i) is an int64
// table whose row r starts at keep + r * keep_stride (keep_stride leaves or
// 0). plan is the layout's
// select plan (n_local local leaves, n_split split leaves over n_tiles
// tiles; SelPlan says how it is laid out); partials (float64 [rows,
// n_tiles, 2]), hist ([rows, n_split, 2048]) and state ([rows, n_split, 4]
// and then 2 words for the grid barrier) are the caller's scratch, hist and
// state zero, and left zero; vec is 1 where v and m are quad-aligned.
int gmf_select(const void* v, const void* m, const long long* plan, int n_local, int n_split,
               int n_tiles, const long long* keep, int keep_stride,
               const float* w, const float* tau, float eps, int leaves, long long rows,
               long long n, int vec, float* inv_nv, float* inv_nm, float* thr, double* partials,
               unsigned* hist, unsigned* state, int s, int m_dtype, void* stream) {
  if (!plan_ok(leaves, rows, n_local, n_split, n_tiles, keep_stride) || !known(s) ||
      !known(m_dtype))
    return (int)cudaErrorInvalidValue;
  const SelPlan p(plan, n_local, n_split, n_tiles);
  const SelArgs g{v,     m,     keep, w, tau,          inv_nv, inv_nm, thr, nullptr, partials,
                  hist,  state, n,    rows, eps, keep_stride, leaves, vec};
  unsigned* bar = state + 4 * rows * n_split;
  cudaStream_t st = (cudaStream_t)stream;
  return with_type(s, [&](auto sv) {
    using S = decltype(sv);
    return with_type(m_dtype, [&](auto mv) {
      using M = decltype(mv);
      return launch_select<false, S, M>(g, p, bar, st);
    });
  });
}

// The k_i-th largest |z| of every segment into thr ([rows, leaves]) and the
// float32 mask |z| >= thr into mask ([rows, n]); z of dtype z_dtype; keep,
// plan, hist and state as for gmf_select; vec is 1 where z and the mask are
// quad-aligned.
int gmf_select_abs(const void* z, const long long* plan, int n_local, int n_split,
                   int n_tiles, const long long* keep, int keep_stride, int leaves,
                   long long rows, long long n, int vec, float* thr, float* mask,
                   unsigned* hist, unsigned* state, int z_dtype, void* stream) {
  if (!plan_ok(leaves, rows, n_local, n_split, n_tiles, keep_stride) || !known(z_dtype))
    return (int)cudaErrorInvalidValue;
  const SelPlan p(plan, n_local, n_split, n_tiles);
  const SelArgs g{z,    nullptr, keep, nullptr, nullptr,     nullptr, nullptr, thr, mask, nullptr,
                  hist, state,   n,    rows,    0.0f,        keep_stride, leaves, vec};
  unsigned* bar = state + 4 * rows * n_split;
  cudaStream_t st = (cudaStream_t)stream;
  return with_type(z_dtype, [&](auto zv) {
    using Z = decltype(zv);
    return launch_select<true, Z, Z>(g, p, bar, st);
  });
}

// One step (0-3, pass p for step 2) of gmf_select's group mode (see
// launch_group_step), its arguments gmf_select's and the group mode's own:
// gplan, each split leaf's whole size [n_split] and each tile's first
// candidate slot in a row [n_tiles + 1] (int64, on the device); gsum, the
// split segments' float64 sums of v^2 and m^2 [n_split][rows][2]; hist,
// three passes' histograms [3][n_split][rows][2048]; state [n_split][rows]
// [8], its ticket counts zero at the first call and left zero; counts
// [n_tiles][rows] and cand, the candidate slots.
int gmf_select_group(int step, int p, const void* v, const void* m, const long long* plan,
                     int n_local, int n_split, int n_tiles, const long long* gplan,
                     const long long* keep, int keep_stride, const float* w, const float* tau,
                     float eps, int leaves, long long rows, long long n, int vec,
                     float* inv_nv, float* inv_nm, float* thr, double* partials, double* gsum,
                     unsigned* hist, unsigned* state, unsigned* counts, unsigned* cand, int s,
                     int m_dtype, void* stream) {
  if (!plan_ok(leaves, rows, n_local, n_split, n_tiles, keep_stride) || !known(s) ||
      !known(m_dtype) || (n_split && !gplan))
    return (int)cudaErrorInvalidValue;
  const SelPlan pl(plan, n_local, n_split, n_tiles);
  const SelArgs g{v,     m,     keep, w, tau,          inv_nv, inv_nm, thr, nullptr, partials,
                  hist,  state, n,    rows, eps, keep_stride, leaves, vec};
  const GroupArgs gr{gplan, gplan + n_split, gsum, hist, state, counts, cand};
  cudaStream_t st = (cudaStream_t)stream;
  return with_type(s, [&](auto sv) {
    using S = decltype(sv);
    return with_type(m_dtype, [&](auto mv) {
      using M = decltype(mv);
      return launch_group_step<false, S, M>(step, p, g, gr, pl, st);
    });
  });
}

// gmf_select_abs's group mode, one step as for gmf_select_group (step 1
// has nothing to launch: the sample runs in step 0).
int gmf_select_abs_group(int step, int p, const void* z, const long long* plan, int n_local,
                         int n_split, int n_tiles, const long long* gplan, const long long* keep,
                         int keep_stride, int leaves, long long rows, long long n, int vec,
                         float* thr, float* mask, unsigned* hist, unsigned* state,
                         unsigned* counts, unsigned* cand, int z_dtype, void* stream) {
  if (!plan_ok(leaves, rows, n_local, n_split, n_tiles, keep_stride) || !known(z_dtype) ||
      (n_split && !gplan))
    return (int)cudaErrorInvalidValue;
  const SelPlan pl(plan, n_local, n_split, n_tiles);
  const SelArgs g{z,    nullptr, keep, nullptr, nullptr,     nullptr, nullptr, thr, mask, nullptr,
                  hist, state,   n,    rows,    0.0f,        keep_stride, leaves, vec};
  const GroupArgs gr{gplan, gplan + n_split, nullptr, hist, state, counts, cand};
  cudaStream_t st = (cudaStream_t)stream;
  return with_type(z_dtype, [&](auto zv) {
    using Z = decltype(zv);
    return launch_group_step<true, Z, Z>(step, p, g, gr, pl, st);
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
