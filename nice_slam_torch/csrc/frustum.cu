// Frustum feature selection: the mask of the grid nodes a camera sees, for
// Hopper (sm_90a).
//
// Replaces the JAX package's frustum_mask (nice_slam_tpu/slam/mapper.py:328,
// with its depth lookup ops/interp.py:335 bilinear_sample_2d), a chain of
// XLA ops there and of about 40 PyTorch kernels in the port's plain version
// (nice_slam_torch/ops/frustum.py), as K10: ONE cooperative launch over the
// distinct grids of a mapping call (middle and fine; color has fine's shape
// and bound, so its mask is fine's and the wrapper hands out one tensor).
// A node is kept if it projects inside the image with 0 <= -z <= d + 0.5,
// d its bilinear depth lookup (0 outside the image; a 0 lookup replaced by
// the grid's largest), or lies within 0.5 m of the camera.
//
// Only a node whose lookup is 0 depends on the grid's largest lookup, so
// the launch runs in two phases around one grid-wide barrier
// (cooperative_groups::this_grid().sync(): the launch is one round of
// resident CTAs, sized from the occupancy API by ops/frustum.py
// frustum_geometry, and the cooperative launch guarantees that they are
// co-resident also beside other streams' kernels, where a hand-rolled spin
// barrier could hang):
//   phase 1  each thread projects its nodes (a grid stride over the
//            distinct grids' nodes, one a thread at the Replica room) and
//            writes each node's final mask (1 or +0), or, where it waits for
//            the largest lookup, a PENDING value: z with its sign bit set
//            (finished values never have it; -0 for z = 0); each CTA reduces
//            its lookups per grid and writes one slot per (grid, CTA), 0
//            where it holds none of the grid's nodes (lookups are >= 0, so
//            the float's bits order as ints) -- no atomic, no memset;
//   phase 2  a CTA with pending nodes reduces the slots of their grids (a
//            few hundred ints from L2; the largest is exact in any order)
//            and each thread resolves its own pending nodes from registers
//            (its first two) or by reading its mask back (past two).  CTA 0
//            also writes each grid's largest lookup to `top`.
// The mask may be written already in the slab layout (rows >= nx planes,
// plane i holding node plane min(i, nx - 1)), which the sharded grids cut
// into views (parallel/grid_sharding.py mask_to_slabs).
//
// Each node's arithmetic is the previous two-kernel K10's, operation by
// operation: the node's point is the port's linspace/meshgrid lattice
// point, lo (1 - t) + hi t with t = i * (1 / (n - 1)) and the last node
// exactly hi, each operation rounded on its own as the plain version's
// separate kernels round it (__fmul_rn and friends keep nvcc from fusing
// them); the projection and the bilinear taps likewise.  Only the camera
// transform (a 3x3 product the plain version hands to a GEMM) may round
// otherwise, so a node that lies within rounding of a test boundary may
// flip.  Bound by bytes: the depth image read once and the distinct masks
// written once, about a microsecond at the Replica room's grids.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGrids = 4;
constexpr int kDesc = 5;  // per grid: mask pointer, nx, ny, nz, rows
constexpr unsigned kSign = 0x80000000u;

struct Grids {
  float* out[kMaxGrids];
  int nx[kMaxGrids], ny[kMaxGrids], nz[kMaxGrids];
  int first[kMaxGrids];  // each grid's first item of the walk; `total` past the last grid
  int total;             // items: sum of rows x ny x nz
  int count;
};

struct Camera {
  const float* depth;  // (H, W)
  const float* bound;  // (3, 2)
  const float* w2c;    // (4, 4)
  const float* c2w;    // (4, 4)
  float fx, fy, cx, cy;
  int H, W;
};

// a[g] by branches: a dynamic index into the parameter struct would copy
// it to local memory
template <class T>
__device__ __forceinline__ T pick(const T (&a)[kMaxGrids], int g) {
  static_assert(kMaxGrids == 4, "one branch per grid");
  return g == 0 ? a[0] : g == 1 ? a[1] : g == 2 ? a[2] : a[3];
}

// node i of n evenly spaced values from lo to hi (ops/geometry.py linspace)
__device__ __forceinline__ float lattice(float lo, float hi, int n, int i) {
  if (i == n - 1) return hi;
  const float recip = __double2float_rn(1.0 / (double)(n > 1 ? n - 1 : 1));
  const float t = __fmul_rn((float)i, recip);
  return __fadd_rn(__fmul_rn(lo, __fsub_rn(1.f, t)), __fmul_rn(hi, t));
}

__device__ __forceinline__ float tap(const Camera& c, float xf, float yf, float w) {
  const bool valid = xf >= 0.f && xf < (float)c.W && yf >= 0.f && yf < (float)c.H;
  const float val = valid ? c.depth[(int)yf * c.W + (int)xf] : 0.f;
  return __fmul_rn(val, w);
}

struct Node {
  float u, v, zc, lookup, dist2;
};

// the node (ix, iy, iz) of an (nx, ny, nz) lattice: its projection, depth
// lookup and squared distance to the camera
__device__ __forceinline__ Node project(const Camera& c, int nx, int ny, int nz, int ix,
                                        int iy, int iz) {
  const float px = lattice(c.bound[0], c.bound[1], nx, ix);
  const float py = lattice(c.bound[2], c.bound[3], ny, iy);
  const float pz = lattice(c.bound[4], c.bound[5], nz, iz);
  const float* m = c.w2c;
  const float cam0 = px * m[0] + py * m[1] + pz * m[2] + m[3];
  const float cam1 = px * m[4] + py * m[5] + pz * m[6] + m[7];
  const float cam2 = px * m[8] + py * m[9] + pz * m[10] + m[11];
  Node o;
  o.zc = __fadd_rn(cam2, 1e-5f);
  o.u = __fdiv_rn(__fadd_rn(__fmul_rn(c.fx, -cam0), __fmul_rn(c.cx, cam2)), o.zc);
  o.v = __fdiv_rn(__fadd_rn(__fmul_rn(c.fy, cam1), __fmul_rn(c.cy, cam2)), o.zc);
  const float x0 = floorf(o.u), y0 = floorf(o.v);
  const float fx = __fsub_rn(o.u, x0), fy = __fsub_rn(o.v, y0);
  const float gx = __fsub_rn(1.f, fx), gy = __fsub_rn(1.f, fy);
  float d = tap(c, x0, y0, __fmul_rn(gx, gy));
  d = __fadd_rn(d, tap(c, __fadd_rn(x0, 1.f), y0, __fmul_rn(fx, gy)));
  d = __fadd_rn(d, tap(c, x0, __fadd_rn(y0, 1.f), __fmul_rn(gx, fy)));
  d = __fadd_rn(d, tap(c, __fadd_rn(x0, 1.f), __fadd_rn(y0, 1.f), __fmul_rn(fx, fy)));
  o.lookup = d;
  const float dx = __fsub_rn(px, c.c2w[3]), dy = __fsub_rn(py, c.c2w[7]),
              dz = __fsub_rn(pz, c.c2w[11]);
  o.dist2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
  return o;
}

// the grid of walk item k (< s.total), and k's index in that grid's mask
__device__ __forceinline__ int locate(const Grids& s, int k, int* j) {
  const int g = (k >= s.first[1]) + (k >= s.first[2]) + (k >= s.first[3]);
  *j = k - pick(s.first, g);
  return g;
}

// one item's mask: final (1 or +0), or pending (z with its sign bit set)
__device__ __forceinline__ float item(const Grids& s, const Camera& c, int g, int j,
                                      float* lookup) {
  const int nx = pick(s.nx, g), ny = pick(s.ny, g), nz = pick(s.nz, g);
  const int plane = j / (ny * nz), rest = j - plane * (ny * nz);
  const Node o = project(c, nx, ny, nz, min(plane, nx - 1), rest / nz, rest % nz);
  *lookup = o.lookup;
  if (o.dist2 < 0.25f) return 1.f;
  const bool in_img = o.u < (float)c.W && o.u > 0.f && o.v < (float)c.H && o.v > 0.f;
  const float z = -o.zc;
  if (!(in_img && z >= 0.f)) return 0.f;
  if (o.lookup != 0.f) return z <= __fadd_rn(o.lookup, 0.5f) ? 1.f : 0.f;
  return __uint_as_float(__float_as_uint(z) | kSign);
}

__device__ __forceinline__ bool pending(float v) { return __float_as_uint(v) & kSign; }

// a CTA's largest value of each of the 4 ints over its threads, into
// s_out[0..3] (every thread of the CTA calls it)
__device__ __forceinline__ void cta_max4(int a0, int a1, int a2, int a3,
                                         int (*s_warp)[kMaxGrids], int* s_out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  a0 = __reduce_max_sync(0xffffffffu, a0);
  a1 = __reduce_max_sync(0xffffffffu, a1);
  a2 = __reduce_max_sync(0xffffffffu, a2);
  a3 = __reduce_max_sync(0xffffffffu, a3);
  if (lane == 0) {
    s_warp[warp][0] = a0;
    s_warp[warp][1] = a1;
    s_warp[warp][2] = a2;
    s_warp[warp][3] = a3;
  }
  __syncthreads();
  if (threadIdx.x < kMaxGrids) {
    int m = 0;
    for (int w = 0; w < kWarps; ++w) m = max(m, s_warp[w][threadIdx.x]);
    s_out[threadIdx.x] = m;
  }
  __syncthreads();
}

__device__ __forceinline__ int keep_max(int m, int g, int want, int bits) {
  return g == want ? max(m, bits) : m;
}

__global__ void __launch_bounds__(kThreads)
frustum_mask_kernel(const Grids s, const Camera c, int* slots, float* __restrict__ top) {
  __shared__ int s_warp[kWarps][kMaxGrids];
  __shared__ int s_max[kMaxGrids];
  __shared__ unsigned s_need;
  const int stride = (int)gridDim.x * kThreads;
  const int first = (int)blockIdx.x * kThreads + (int)threadIdx.x;

  // phase 1: every item's final or pending mask, the lookups' maxima
  int m0 = 0, m1 = 0, m2 = 0, m3 = 0;  // float bits of the largest lookup per grid
  unsigned mine = 0;                   // bit g: this thread holds a pending node of grid g
  float v0 = 0.f, v1 = 0.f;            // its first two items' values
  int it = 0;
  for (int k = first; k < s.total; k += stride, ++it) {
    int j;
    const int g = locate(s, k, &j);
    float lookup;
    const float v = item(s, c, g, j, &lookup);
    pick(s.out, g)[j] = v;
    const int bits = __float_as_int(lookup);
    m0 = keep_max(m0, g, 0, bits);
    m1 = keep_max(m1, g, 1, bits);
    m2 = keep_max(m2, g, 2, bits);
    m3 = keep_max(m3, g, 3, bits);
    if (pending(v)) mine |= 1u << g;
    if (it == 0) v0 = v;
    else if (it == 1) v1 = v;
  }
  if (threadIdx.x == 0) s_need = 0;
  cta_max4(m0, m1, m2, m3, s_warp, s_max);
  if (threadIdx.x < s.count) slots[threadIdx.x * gridDim.x + blockIdx.x] = s_max[threadIdx.x];
  const unsigned warp_need = __reduce_or_sync(0xffffffffu, mine);
  if ((threadIdx.x & 31) == 0 && warp_need) atomicOr(&s_need, warp_need);  // shared memory
  cg::this_grid().sync();  // also a CTA barrier: s_need is final

  // phase 2: the largest lookups of the grids this CTA waits for (CTA 0:
  // of every grid, for `top`), then the pending nodes resolved
  const unsigned need = s_need | (blockIdx.x == 0 ? (1u << s.count) - 1u : 0u);
  if (!need) return;
  int r0 = 0, r1 = 0, r2 = 0, r3 = 0;
  for (int b = threadIdx.x; b < (int)gridDim.x; b += kThreads) {
    if (need & 1u) r0 = max(r0, __ldcg(slots + b));
    if (need & 2u) r1 = max(r1, __ldcg(slots + gridDim.x + b));
    if (need & 4u) r2 = max(r2, __ldcg(slots + 2 * gridDim.x + b));
    if (need & 8u) r3 = max(r3, __ldcg(slots + 3 * gridDim.x + b));
  }
  cta_max4(r0, r1, r2, r3, s_warp, s_max);
  if (blockIdx.x == 0 && threadIdx.x < s.count) top[threadIdx.x] = __int_as_float(s_max[threadIdx.x]);
  if (!mine) return;
  it = 0;
  for (int k = first; k < s.total; k += stride, ++it) {
    int j;
    const int g = locate(s, k, &j);
    if (!(mine & (1u << g))) continue;
    float* out = pick(s.out, g) + j;
    const float v = it == 0 ? v0 : it == 1 ? v1 : *out;
    if (pending(v))
      *out = fabsf(v) <= __fadd_rn(__int_as_float(s_max[g]), 0.5f) ? 1.f : 0.f;
  }
}

bool make_grids(const long long* desc, int count, Grids* s) {
  if (count < 1 || count > kMaxGrids) return false;
  *s = {};
  s->count = count;
  long long total = 0;
  for (int g = 0; g < count; ++g) {
    const long long* d = desc + kDesc * g;
    s->out[g] = reinterpret_cast<float*>(d[0]);
    s->nx[g] = (int)d[1];
    s->ny[g] = (int)d[2];
    s->nz[g] = (int)d[3];
    if (d[1] < 1 || d[2] < 1 || d[3] < 1 || d[4] < d[1]) return false;
    s->first[g] = (int)total;
    total += d[4] * d[2] * d[3];
    if (total >= (1LL << 31) - (1LL << 24)) return false;  // k + stride stays an int
  }
  for (int g = count; g < kMaxGrids; ++g) s->first[g] = (int)total;
  s->total = (int)total;
  return true;
}

}  // namespace

extern "C" {

// desc: per distinct grid kDesc values -- its float mask pointer (rows * ny
// * nz), nx, ny, nz, rows (>= nx).  depth (H, W), bound (3, 2), w2c and c2w
// (4, 4) on the device.  slots: count * ctas ints of scratch, written
// before they are read; top: count floats, each grid's largest lookup.
// One cooperative launch of `ctas` CTAs (ops/frustum.py frustum_geometry);
// a launch the card refuses returns its error.
int frustum_mask(const long long* desc, int count, const float* depth, int H, int W,
                 const float* bound, const float* w2c, const float* c2w, float fx,
                 float fy, float cx, float cy, int* slots, float* top, int ctas,
                 void* stream) {
  Grids s;
  if (!make_grids(desc, count, &s) || H < 1 || W < 1 || ctas < 1)
    return (int)cudaErrorInvalidValue;
  Camera c{depth, bound, w2c, c2w, fx, fy, cx, cy, H, W};
  void* args[] = {&s, &c, &slots, &top};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)frustum_mask_kernel, dim3(ctas), dim3(kThreads), args, 0,
      (cudaStream_t)stream);
  const cudaError_t last = cudaGetLastError();
  return (int)(e != cudaSuccess ? e : last);
}

// the kernel's resources into out[4]: registers, local bytes, threads,
// resident CTAs per SM
int frustum_info(int* out) {
  const void* f = (const void*)frustum_mask_kernel;
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, f);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, f, kThreads, 0);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = kThreads;
  out[3] = blocks;
  return 0;
}

}  // extern "C"
