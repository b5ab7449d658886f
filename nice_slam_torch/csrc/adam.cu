// The group-masked Adam step, for Hopper (sm_90a).
//
// Replaces the JAX package's group_adam_update (nice_slam_tpu/slam/optim.py:49,
// with the frustum mask multiplied into the grid gradients first at
// nice_slam_tpu/slam/mapper.py:648-650), which XLA fuses into a pass per
// leaf, and the port's plain version (nice_slam_torch/slam/optim.py
// _adam_update: ten torch._foreach calls per group and device, plus an
// allocating mask multiply) as K9 group_adam: ONE launch per device and
// optimizer step over every active group's leaves on that device.
//
// Per leaf the launch's table holds the pointers of p, g, m and v, the
// leaf's length, its group's bias corrections bc1 = 1 - b1^t and
// bc2 = 1 - b2^t (float32, from the host, each group with its own step
// count) and lr, an optional mask (one float per `inner` consecutive
// elements: a grid's nodes broadcast over its C channels) and an optional
// lr vector over the leaf's last dimension (the tracker's per-entry lr).
// A null gradient is a zero gradient (nothing is read or allocated for
// it).  The update keeps the plain chain's order of operations, each
// rounded on its own (__fmul_rn and friends keep nvcc from fusing them):
//   g <- g * mask
//   m <- b1 m + (1 - b1) g
//   v <- b2 v + (1 - b2) g g
//   p <- p - lr ((m / bc1) / (sqrt(v / bc2) + eps))
//
// Bound by bytes: 28 bytes an element (p, m, v read and written, g read),
// ~12 M elements at the Replica room's color stage.  A CTA takes one
// chunk of kChunk elements of one leaf (CTA -> leaf by a binary search of
// the table's first CTAs), 16-byte loads where the leaf's pointers allow.
// The table travels as the kernel's parameter: up to kSmall leaves in the
// classic 4 KB parameter space, up to kLarge (the card's tracker, mapper
// and pretrainer take 1-60) where the toolkit allows 32 KB (CUDA 12.1).

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 16;  // elements a thread walks in a chunk
constexpr int kChunk = kThreads * kPerThread;
constexpr float kB1 = 0.9f, kB2 = 0.999f, kEps = 1e-8f;
constexpr float kOneMinusB1 = 1.0 - 0.9, kOneMinusB2 = 1.0 - 0.999;
constexpr int kDesc = 12;  // int64 values per leaf in the host's table

struct Leaf {
  float* p;
  const float* g;       // null: a zero gradient
  float* m;
  float* v;
  const float* mask;    // null: none; else one float per `inner` elements
  const float* lr_vec;  // null: the scalar lr; else lr_vec[e % lr_len]
  int n, inner, lr_len, first;
  float bc1, bc2, lr;
};

template <int kCap>
struct Table {
  Leaf leaf[kCap];
  int count;
};

constexpr int kSmall = 44;  // 44 x 80 bytes + 8 < 4096
#if CUDART_VERSION >= 12010
constexpr int kLarge = 360;  // < 32764 bytes of parameters
#else
constexpr int kLarge = kSmall;
#endif

float from_bits(long long b) {
  const int i = (int)b;
  float f;
  memcpy(&f, &i, sizeof f);
  return f;
}

__device__ __forceinline__ void update(float& p, float g, float& m, float& v, float mask,
                                       float lr, float bc1, float bc2) {
  g = __fmul_rn(g, mask);
  m = __fadd_rn(__fmul_rn(m, kB1), __fmul_rn(kOneMinusB1, g));
  v = __fadd_rn(__fmul_rn(v, kB2), __fmul_rn(kOneMinusB2, __fmul_rn(g, g)));
  const float denom = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, bc2)), kEps);
  const float u = __fdiv_rn(__fdiv_rn(m, bc1), denom);
  p = __fsub_rn(p, __fmul_rn(lr, u));
}

__device__ __forceinline__ void one(const Leaf& L, int e) {
  float p = L.p[e], m = L.m[e], v = L.v[e];
  const float g = L.g ? L.g[e] : 0.f;
  const float mask = L.mask ? L.mask[e / L.inner] : 1.f;
  const float lr = L.lr_vec ? L.lr_vec[L.lr_len == 1 ? 0 : e % L.lr_len] : L.lr;
  update(p, g, m, v, mask, lr, L.bc1, L.bc2);
  L.p[e] = p;
  L.m[e] = m;
  L.v[e] = v;
}

template <int kCap>
__global__ void __launch_bounds__(kThreads) group_adam_kernel(const Table<kCap> t) {
  int lo = 0, hi = t.count - 1;  // the last leaf whose first CTA <= blockIdx.x
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (t.leaf[mid].first <= (int)blockIdx.x) lo = mid; else hi = mid - 1;
  }
  const Leaf L = t.leaf[lo];
  const int base = ((int)blockIdx.x - L.first) * kChunk;
  const int end = min(L.n, base + kChunk);
  const uintptr_t bits = (uintptr_t)L.p | (uintptr_t)L.g | (uintptr_t)L.m | (uintptr_t)L.v;
  if ((bits & 15) == 0) {
    for (int e = base + 4 * (int)threadIdx.x; e < end; e += 4 * kThreads) {
      if (e + 4 > end) {
        for (int k = e; k < end; ++k) one(L, k);
        continue;
      }
      float4 p = *reinterpret_cast<const float4*>(L.p + e);
      float4 m = *reinterpret_cast<const float4*>(L.m + e);
      float4 v = *reinterpret_cast<const float4*>(L.v + e);
      const float4 g = L.g ? *reinterpret_cast<const float4*>(L.g + e)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
      float* pp = &p.x;
      float* mm = &m.x;
      float* vv = &v.x;
      const float* gg = &g.x;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float mask = L.mask ? L.mask[(e + k) / L.inner] : 1.f;
        const float lr = L.lr_vec ? L.lr_vec[L.lr_len == 1 ? 0 : (e + k) % L.lr_len] : L.lr;
        update(pp[k], gg[k], mm[k], vv[k], mask, lr, L.bc1, L.bc2);
      }
      *reinterpret_cast<float4*>(L.p + e) = p;
      *reinterpret_cast<float4*>(L.m + e) = m;
      *reinterpret_cast<float4*>(L.v + e) = v;
    }
  } else {
    for (int e = base + (int)threadIdx.x; e < end; e += kThreads) one(L, e);
  }
}

template <int kCap>
int launch(const long long* desc, int count, cudaStream_t st) {
  Table<kCap> t;
  t.count = count;
  int blocks = 0;
  for (int i = 0; i < count; ++i) {
    const long long* d = desc + kDesc * i;
    Leaf& L = t.leaf[i];
    L.p = reinterpret_cast<float*>(d[0]);
    L.g = reinterpret_cast<const float*>(d[1]);
    L.m = reinterpret_cast<float*>(d[2]);
    L.v = reinterpret_cast<float*>(d[3]);
    L.mask = reinterpret_cast<const float*>(d[4]);
    L.lr_vec = reinterpret_cast<const float*>(d[5]);
    if (d[6] < 1 || d[6] >= (1LL << 31) - kChunk || d[7] < 1 || d[8] < 1)
      return (int)cudaErrorInvalidValue;
    L.n = (int)d[6];
    L.inner = (int)d[7];
    L.lr_len = (int)d[8];
    L.bc1 = from_bits(d[9]);
    L.bc2 = from_bits(d[10]);
    L.lr = from_bits(d[11]);
    L.first = blocks;
    const long long more = (d[6] + kChunk - 1) / kChunk;
    if (blocks + more >= (1LL << 31)) return (int)cudaErrorInvalidValue;
    blocks += (int)more;
  }
  group_adam_kernel<kCap><<<blocks, kThreads, 0, st>>>(t);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// desc: per leaf kDesc int64 values -- p, g (0: zero), m, v, mask (0:
// none), lr vector (0: the scalar lr) pointers, n, inner, lr_len, and the
// float bits of bc1, bc2 and lr.  count: 1..group_adam_capacity() leaves,
// all on the current device.
int group_adam(const long long* desc, int count, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (count < 1 || count > kLarge) return (int)cudaErrorInvalidValue;
  if (count <= kSmall) return launch<kSmall>(desc, count, st);
  return launch<kLarge>(desc, count, st);
}

// the most leaves one launch takes
int group_adam_capacity() { return kLarge; }

// K9's resources into out[3]: registers, local (spill) bytes, threads
int group_adam_info(int* out) {
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, group_adam_kernel<kSmall>);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = kThreads;
  return 0;
}

}  // extern "C"
