// Hand-written Hopper (sm_90a) kernels for the compression hot path.
//
// They replace the three Pallas TPU kernels of the JAX package's
// src/repro/kernels/gmf_compress.py:
//
//   gmf_momentum_multi <- momentum_correction_flat / _momentum_kernel
//                    U <- alpha*U + g ; V <- V + U, over every leaf of a tree
//                    in one launch; reads u, v, g, writes u', v': 20 bytes
//                    per element
//   gmf_compress  <- gmf_compress_flat / _gmf_kernel
//                    z = |((1-tau)*V)*inv_nv + (tau*M)*inv_nm| ; mask = z >= thr
//                    G = V*mask ; U <- U*(1-mask) ; V <- V*(1-mask) ; emits mask
//                    reads u, v, m, writes g, u', v', mask: 28 bytes per element
//   gmf_apply_mask <- apply_mask_flat / _mask_kernel
//                    G = V*mask ; U <- U*(1-mask) ; V <- V*(1-mask)
//                    reads u, v, mask, writes g, u', v': 24 bytes per element
//
// Bound: each does a handful of float operations per element against 20 to
// 28 bytes of traffic, far below the card's operations-per-byte balance, so
// all three are bound by device-memory bandwidth. At ResNet-56 with 20
// clients one round moves 342 MB (momentum), 479 MB (compress) and 411 MB
// (apply_mask). The design streams every byte exactly once: each thread
// moves one 16-byte float4 per operand with neighbouring threads on
// neighbouring addresses, with a grid-stride loop. The TPU version padded
// to (512, 128) blocks; here the ragged end is a scalar tail inside the
// kernel and nothing is padded. Operands whose addresses are not 16-byte
// aligned take the scalar loop for every element.
//
// K2 is one multi-tensor launch per tree. The Pallas kernel runs once per
// leaf; on the card a launch per leaf costs tens of microseconds of host
// time against about a microsecond of work (ResNet-56 has 169 leaves), so
// gmf_momentum_multi takes a table of leaves -- five pointers, an element
// count, the leaf's first block and whether all five pointers are 16-byte
// aligned -- by value as a __grid_constant__ parameter: no host-to-device
// copy, no sync, capturable by a CUDA graph. Each block takes kChunk
// elements of one leaf and finds its leaf by a binary search over the
// table's first-block prefix. The table holds kTableCap leaves (512 where
// the toolkit allows 32 KB of kernel parameters, CUDA 12.1 on; 64, under
// 4 KB, before); gmf_momentum_limits reports that capacity and kChunk so
// the Python side plans one launch per kTableCap leaves. On an NVIDIA H100
// 80GB HBM3 at 700 W a ResNet-56 round's tree (169 leaves, 20 clients,
// 342 MB) takes 0.12 ms on the card, 2.8 TB/s; the rest of a tree call is
// host time (PERF.md).
//
// Layout: every operand is a [rows, n] float32 stack (one row per client),
// contiguous. gmf_compress takes its four scalars per row as device
// pointers ([rows] each), so a tau that changes every round never needs a
// host sync or a rebuild. A thread finds its row with one division and
// walks forward from there.
//
// Arithmetic: the fused path computes its top-k threshold from a z built
// outside the kernel, in this exact association, so z here must be that z
// bitwise. Every product and sum is an explicit round-to-nearest intrinsic
// (no fused multiply-add), and the file is built with -fmad=false too.
// Each function returns the cudaError_t of its launch (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;  // 8 blocks of 256 per SM fill an H100

__device__ __forceinline__ void momentum_one(float u, float v, float g, float alpha,
                                             float& uo, float& vo) {
  const float un = __fadd_rn(__fmul_rn(alpha, u), g);
  uo = un;
  vo = __fadd_rn(v, un);
}

__device__ __forceinline__ void mask_one(float u, float v, float mask,
                                         float& go, float& uo, float& vo) {
  const float keep = __fsub_rn(1.0f, mask);
  go = __fmul_rn(v, mask);
  uo = __fmul_rn(u, keep);
  vo = __fmul_rn(v, keep);
}

__device__ __forceinline__ float gmf_mask(float v, float m, float tau, float inv_nv,
                                          float inv_nm, float thr) {
  const float a = __fmul_rn(__fmul_rn(__fsub_rn(1.0f, tau), v), inv_nv);
  const float b = __fmul_rn(__fmul_rn(tau, m), inv_nm);
  const float z = fabsf(__fadd_rn(a, b));
  return z >= thr ? 1.0f : 0.0f;
}

constexpr int kChunk = kThreads * 4 * 4;  // elements per block: 4 float4 a thread
#if CUDART_VERSION >= 12010
constexpr int kTableCap = 512;  // 8 + 512 * 56 bytes: under 32 KB of parameters
#else
constexpr int kTableCap = 64;  // 8 + 64 * 56 bytes: under the classic 4 KB
#endif

struct MomentumLeaf {
  const float* u;
  const float* v;
  const float* g;
  float* uo;
  float* vo;
  long long n;    // elements
  int block0;     // first block of this leaf
  int vec;        // all five pointers 16-byte aligned
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

template <int CAP>
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
  if (e.vec) {  // kChunk is a multiple of 4: the float4 quads of [begin, end)
    const long long qend = end / 4;
    for (long long q = begin / 4 + threadIdx.x; q < qend; q += kThreads) {
      const float4 a = reinterpret_cast<const float4*>(e.u)[q];
      const float4 c = reinterpret_cast<const float4*>(e.v)[q];
      const float4 d = reinterpret_cast<const float4*>(e.g)[q];
      float4 x, y;
      momentum_one(a.x, c.x, d.x, alpha, x.x, y.x);
      momentum_one(a.y, c.y, d.y, alpha, x.y, y.y);
      momentum_one(a.z, c.z, d.z, alpha, x.z, y.z);
      momentum_one(a.w, c.w, d.w, alpha, x.w, y.w);
      reinterpret_cast<float4*>(e.uo)[q] = x;
      reinterpret_cast<float4*>(e.vo)[q] = y;
    }
    i = qend * 4 + threadIdx.x;
  }
  for (; i < end; i += kThreads) momentum_one(e.u[i], e.v[i], e.g[i], alpha, e.uo[i], e.vo[i]);
}

template <int CAP>
int launch_momentum(const long long* leaves, int count, int blocks, float alpha,
                    cudaStream_t stream) {
  MomentumTable<CAP> t;
  t.count = count;
  t.alpha = alpha;
  for (int i = 0; i < count; ++i) {
    const long long* r = leaves + 8 * i;
    MomentumLeaf& e = t.leaf[i];
    e.u = reinterpret_cast<const float*>(r[0]);
    e.v = reinterpret_cast<const float*>(r[1]);
    e.g = reinterpret_cast<const float*>(r[2]);
    e.uo = reinterpret_cast<float*>(r[3]);
    e.vo = reinterpret_cast<float*>(r[4]);
    e.n = r[5];
    e.block0 = (int)r[6];
    e.vec = (int)r[7];
  }
  momentum_multi_kernel<CAP><<<blocks, kThreads, 0, stream>>>(t);
  return (int)cudaGetLastError();
}

__global__ void apply_mask_kernel(const float* __restrict__ u, const float* __restrict__ v,
                                  const float* __restrict__ mk, float* __restrict__ go,
                                  float* __restrict__ uo, float* __restrict__ vo,
                                  int64_t total, int vec) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t nvec = vec ? total / 4 : 0;
  for (int64_t q = tid; q < nvec; q += stride) {
    const float4 a = reinterpret_cast<const float4*>(u)[q];
    const float4 b = reinterpret_cast<const float4*>(v)[q];
    const float4 c = reinterpret_cast<const float4*>(mk)[q];
    float4 x, y, z;
    mask_one(a.x, b.x, c.x, x.x, y.x, z.x);
    mask_one(a.y, b.y, c.y, x.y, y.y, z.y);
    mask_one(a.z, b.z, c.z, x.z, y.z, z.z);
    mask_one(a.w, b.w, c.w, x.w, y.w, z.w);
    reinterpret_cast<float4*>(go)[q] = x;
    reinterpret_cast<float4*>(uo)[q] = y;
    reinterpret_cast<float4*>(vo)[q] = z;
  }
  for (int64_t i = nvec * 4 + tid; i < total; i += stride) {
    mask_one(u[i], v[i], mk[i], go[i], uo[i], vo[i]);
  }
}

// Per-row scalars of element i, with the row found once and walked forward.
struct RowScalars {
  const float* tau;
  const float* inv_nv;
  const float* inv_nm;
  const float* thr;
  int64_t n;
  int64_t row;
  int64_t end;  // first element past the current row
  float t, a, b, c;

  __device__ __forceinline__ void load() {
    t = tau[row];
    a = inv_nv[row];
    b = inv_nm[row];
    c = thr[row];
  }
  __device__ __forceinline__ void seek(int64_t i) {
    row = i / n;
    end = (row + 1) * n;
    load();
  }
  __device__ __forceinline__ float mask(int64_t i, float v, float m) {
    if (i >= end) seek(i);
    return gmf_mask(v, m, t, a, b, c);
  }
};

__global__ void gmf_compress_kernel(const float* __restrict__ u, const float* __restrict__ v,
                                    const float* __restrict__ m,
                                    const float* __restrict__ inv_nv,
                                    const float* __restrict__ inv_nm,
                                    const float* __restrict__ thr,
                                    const float* __restrict__ tau, float* __restrict__ go,
                                    float* __restrict__ uo, float* __restrict__ vo,
                                    float* __restrict__ mo, int64_t total, int64_t n,
                                    int vec) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t nvec = vec ? total / 4 : 0;
  RowScalars s{tau, inv_nv, inv_nm, thr, n, 0, 0};
  for (int64_t q = tid; q < nvec; q += stride) {
    const int64_t i = 4 * q;
    const float4 a = reinterpret_cast<const float4*>(u)[q];
    const float4 b = reinterpret_cast<const float4*>(v)[q];
    const float4 c = reinterpret_cast<const float4*>(m)[q];
    float4 mk;
    mk.x = s.mask(i, b.x, c.x);
    mk.y = s.mask(i + 1, b.y, c.y);
    mk.z = s.mask(i + 2, b.z, c.z);
    mk.w = s.mask(i + 3, b.w, c.w);
    float4 x, y, z;
    mask_one(a.x, b.x, mk.x, x.x, y.x, z.x);
    mask_one(a.y, b.y, mk.y, x.y, y.y, z.y);
    mask_one(a.z, b.z, mk.z, x.z, y.z, z.z);
    mask_one(a.w, b.w, mk.w, x.w, y.w, z.w);
    reinterpret_cast<float4*>(go)[q] = x;
    reinterpret_cast<float4*>(uo)[q] = y;
    reinterpret_cast<float4*>(vo)[q] = z;
    reinterpret_cast<float4*>(mo)[q] = mk;
  }
  for (int64_t i = nvec * 4 + tid; i < total; i += stride) {
    const float mk = s.mask(i, v[i], m[i]);
    mo[i] = mk;
    mask_one(u[i], v[i], mk, go[i], uo[i], vo[i]);
  }
}

int blocks_for(int64_t total, int vec) {
  const int64_t work = vec ? (total + 3) / 4 : total;
  int64_t b = (work + kThreads - 1) / kThreads;
  if (b > kMaxBlocks) b = kMaxBlocks;
  return b < 1 ? 1 : (int)b;
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
// 16-byte aligned; `blocks` is the grid. Leaves of 0 elements are left out
// by the caller.
int gmf_momentum_multi(const long long* leaves, int count, int blocks, float alpha,
                       void* stream) {
  if (count < 1 || count > kTableCap || blocks < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (count <= 8) return launch_momentum<8>(leaves, count, blocks, alpha, s);
  if (count <= 64) return launch_momentum<64>(leaves, count, blocks, alpha, s);
  return launch_momentum<kTableCap>(leaves, count, blocks, alpha, s);
}

int gmf_apply_mask(const float* u, const float* v, const float* mask, float* go, float* uo,
                   float* vo, long long total, int vec, void* stream) {
  apply_mask_kernel<<<blocks_for(total, vec), kThreads, 0, (cudaStream_t)stream>>>(
      u, v, mask, go, uo, vo, total, vec);
  return (int)cudaGetLastError();
}

int gmf_compress(const float* u, const float* v, const float* m, const float* inv_nv,
                 const float* inv_nm, const float* thr, const float* tau, float* go,
                 float* uo, float* vo, float* mo, long long total, long long n, int vec,
                 void* stream) {
  gmf_compress_kernel<<<blocks_for(total, vec), kThreads, 0, (cudaStream_t)stream>>>(
      u, v, m, inv_nv, inv_nm, thr, tau, go, uo, vo, mo, total, n, vec);
  return (int)cudaGetLastError();
}

}  // extern "C"
