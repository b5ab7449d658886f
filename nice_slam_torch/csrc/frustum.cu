// Frustum feature selection: the mask of the grid nodes a camera sees, for
// Hopper (sm_90a).
//
// Replaces the JAX package's frustum_mask (nice_slam_tpu/slam/mapper.py:328,
// with its depth lookup ops/interp.py:335 bilinear_sample_2d), a chain of
// XLA ops there and of about 40 PyTorch kernels in the port's plain version
// (nice_slam_torch/ops/frustum.py), as K10 in two launches over every grid
// of a mapping call (middle, fine and color together):
//   frustum_depth_max  each node's depth lookup, reduced to each grid's
//                      largest lookup (atomicMax on the float's bits: the
//                      depths are >= 0, where the int order is the float
//                      order);
//   frustum_mask       each node's mask, written as the float (1 or 0) the
//                      Adam step (K9) reads as its gradient mask.
// A node is kept if it projects inside the image with 0 <= -z <= d + 0.5,
// d its bilinear depth lookup (0 outside the image; a 0 lookup replaced by
// the grid's largest), or lies within 0.5 m of the camera.
//
// A thread per node: the node's point is the port's linspace/meshgrid
// lattice point, lo (1 - t) + hi t with t = i * (1 / (n - 1)) and the last
// node exactly hi, each operation rounded on its own as the plain version's
// separate kernels round it (__fmul_rn and friends keep nvcc from fusing
// them); the projection and the bilinear taps likewise.  Only the camera
// transform (a 3x3 product the plain version hands to a GEMM) may round
// otherwise, so a node that lies within rounding of a test boundary may
// flip.  A CTA covers nodes of one grid only, so a warp reduces its lookups
// to one atomicMax.  Bound by bytes: the depth image read once and the mask
// written, a few microseconds at the Replica room's grids.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGrids = 4;

struct Grids {
  float* out[kMaxGrids];
  int nx[kMaxGrids], ny[kMaxGrids], nz[kMaxGrids];
  int first[kMaxGrids];  // each grid's first CTA
  int first_block[kMaxGrids + 1];
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

// the grid g's node k: its projection, depth lookup and squared distance
// to the camera
__device__ __forceinline__ Node project(const Camera& c, const Grids& s, int g, int k) {
  const int nx = pick(s.nx, g), ny = pick(s.ny, g), nz = pick(s.nz, g);
  const int iz = k % nz, iy = (k / nz) % ny, ix = k / (nz * ny);
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

// the CTA's grid and its node (-1: past the grid's last node)
__device__ __forceinline__ int locate(const Grids& s, int* node) {
  const int b = (int)blockIdx.x;
  const int g = (s.count > 1 && b >= s.first_block[1]) + (s.count > 2 && b >= s.first_block[2])
                + (s.count > 3 && b >= s.first_block[3]);
  const int k = (b - pick(s.first, g)) * kThreads + (int)threadIdx.x;
  *node = k < pick(s.nx, g) * pick(s.ny, g) * pick(s.nz, g) ? k : -1;
  return g;
}

__global__ void __launch_bounds__(kThreads)
frustum_depth_max_kernel(const Grids s, const Camera c, int* __restrict__ max_bits) {
  int k;
  const int g = locate(s, &k);
  const int bits = k >= 0 ? __float_as_int(project(c, s, g, k).lookup) : 0;
  const int top = __reduce_max_sync(0xffffffffu, bits);
  if ((threadIdx.x & 31) == 0) atomicMax(max_bits + g, top);
}

__global__ void __launch_bounds__(kThreads)
frustum_mask_kernel(const Grids s, const Camera c, const int* __restrict__ max_bits) {
  int k;
  const int g = locate(s, &k);
  if (k < 0) return;
  const Node o = project(c, s, g, k);
  const float d = o.lookup == 0.f ? __int_as_float(max_bits[g]) : o.lookup;
  const bool in_img = o.u < (float)c.W && o.u > 0.f && o.v < (float)c.H && o.v > 0.f;
  const float z = -o.zc;
  const bool seen = in_img && z >= 0.f && z <= __fadd_rn(d, 0.5f);
  pick(s.out, g)[k] = (seen || o.dist2 < 0.25f) ? 1.f : 0.f;
}

bool make_grids(const long long* desc, int count, Grids* s) {
  if (count < 1 || count > kMaxGrids) return false;
  *s = {};
  s->count = count;
  s->first_block[0] = 0;
  for (int g = 0; g < count; ++g) {
    const long long* d = desc + 4 * g;
    s->out[g] = reinterpret_cast<float*>(d[0]);
    s->nx[g] = (int)d[1];
    s->ny[g] = (int)d[2];
    s->nz[g] = (int)d[3];
    const long long nodes = d[1] * d[2] * d[3];
    if (nodes < 1 || nodes >= (1LL << 31) - kThreads) return false;
    s->first[g] = s->first_block[g];
    s->first_block[g + 1] = s->first_block[g] + (int)((nodes + kThreads - 1) / kThreads);
  }
  return true;
}

}  // namespace

extern "C" {

// desc: per grid its float mask (nx * ny * nz) pointer, nx, ny, nz.
// depth (H, W), bound (3, 2), w2c and c2w (4, 4) on the device.  max_bits:
// count ints, zeroed by the caller; the first launch writes each grid's
// largest lookup there, the second reads it.
int frustum_mask(const long long* desc, int count, const float* depth, int H, int W,
                 const float* bound, const float* w2c, const float* c2w, float fx,
                 float fy, float cx, float cy, int* max_bits, int which, void* stream) {
  Grids s;
  if (!make_grids(desc, count, &s) || H < 1 || W < 1) return (int)cudaErrorInvalidValue;
  const Camera c{depth, bound, w2c, c2w, fx, fy, cx, cy, H, W};
  const cudaStream_t st = (cudaStream_t)stream;
  if (which == 0)
    frustum_depth_max_kernel<<<s.first_block[count], kThreads, 0, st>>>(s, c, max_bits);
  else
    frustum_mask_kernel<<<s.first_block[count], kThreads, 0, st>>>(s, c, max_bits);
  return (int)cudaGetLastError();
}

// the two kernels' resources into out[3]: registers, local bytes, threads
int frustum_info(int which, int* out) {
  cudaFuncAttributes a;
  const cudaError_t e = which == 0 ? cudaFuncGetAttributes(&a, frustum_depth_max_kernel)
                                   : cudaFuncGetAttributes(&a, frustum_mask_kernel);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = kThreads;
  return 0;
}

}  // extern "C"
