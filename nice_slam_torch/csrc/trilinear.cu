// Trilinear feature-grid lookup and its two gradients, for Hopper (sm_90a).
//
// Replaces the hand-written device code of the JAX package's ops/interp.py:
//   K1 trilinear_fwd        <- _trilinear_impl            (interp.py:141-179)
//   K2 trilinear_bwd_dgrid  <- _dgrid_block_scatter and
//                              _dgrid_block_matmul         (interp.py:186-280;
//                              the same per-row accumulate as the Pallas
//                              experiment scripts/exp_scatter.py:pallas_rmw)
//   K3 trilinear_bwd_dp     <- the dp half of _trilinear_bwd (interp.py:292-333)
//
// Layout: a grid is channels-last (Nx, Ny, Nz, C) f32, contiguous, C a
// multiple of 4 with L = C/4 a power of two <= 32.  Points are (N, 3) f32
// already normalized to [-1, 1] (x, y, z).  Numerics follow
// grid_sample(bilinear, border, align_corners=True): u = (p+1)/2*(S-1),
// clamped to [0, S-1]; i1 = min(i0+1, S-1).
//
// K1, K2 and K3 each take every grid of a decoder stage (up to kMaxGrids,
// looked up at the same points) in ONE launch: one stage's lookup is one
// K1, and its backward one K2 and/or one K3.
//
// The slab window.  Each grid of a launch may be one x-slab of a grid that
// is spatially sharded over D devices (nice_slam_torch/parallel/
// grid_sharding.py; the JAX function it replaces is _local_interp,
// nice_slam_tpu/parallel/grid_sharding.py:108): the slab stores the full
// grid's x-planes [x_lo, x_lo + planes] (one halo plane past its own
// `planes`), and answers only the points whose base x-plane it owns,
// owner = min(i0x / planes, D - 1).  Every launch runs the window: a dense
// grid is the slab x_lo = 0, planes = nx - 1, D = 1, which owns every
// point and shifts nothing, so the dense path and the slab path are one
// code path.  The corners and weights are computed on the FULL grid (its
// nx, its border clamp of i1 at nx - 1), and only the integer x indices are
// then shifted by x_lo and clipped to [0, planes]: renormalising a point
// into the slab's box would round differently, and an owned point's
// lookup would no longer equal the dense one bit for bit.  A point the
// slab does not own reads nothing: K1 writes its feature as 0 (so the D
// slabs' features sum to the dense feature exactly), K2 adds nothing and
// K3 adds nothing to its dp.  The per-slab bound is the slab's own bytes:
// the points, the rows the owned points touch, and the outputs.
//
// K1, the lookup.  Bound by bytes: it gathers 8 corner rows per point and
// grid, mostly from L1 and L2, and writes an (n, C) feature per grid.  An
// item is a (grid, point, float4 of channels): the L lanes of a point read
// one corner row as L contiguous 16-byte loads (a 128-byte transaction at
// C = 32).  The launch is one round of resident CTAs (ops/interp.py
// k1_geometry, from the occupancy API through trilinear_fwd_info), not one
// thread per item in as many rounds as the items take (tracking's 900 CTAs
// of 256 in two rounds before): a thread walks items with a grid stride,
// or from 16 items a thread on (a mesh or render chunk) each CTA walks a
// contiguous chunk, whose consecutive rays or lattice rows find their rows
// in the SM's L1; it loads its next item's point while it gathers for the
// current one, and the features go out with streaming stores.  What it was
// chosen over (PERF.md, its K1 findings; tools/k1_sweep.py keeps the kernel it
// replaced and the register walk to time it against):
//  * a cap of 32 registers (8 CTAs a SM, one round at tracking) spilled or
//    held half the loads back, and lost to the uncapped build at every
//    main-path case; ptxas is asked for 5 CTAs a SM (48 registers), all 8
//    loads of an item in flight;
//  * 2 or 4 items in flight a thread took 105-190 registers and lost;
//  * two float4s a lane (half the lanes locating a point) lost outside
//    the mesh chunk; L2 evict-last loads of the grids gained nothing
//    measurable;
//  * loads under a branch per half of the corners cost a second memory
//    round trip, so an item's 8 loads are one block.
// The store floor of a render chunk (its 1.84 GB of features written with
// nothing computed) is 0.57 ms of K1's ~1.0: the rest is the gathers.  The
// first design launched once per grid; a register walk over runs of
// consecutive points as K2 does (183 registers at three grids) lost by 40 %
// or more on the main path's three-grid lookups.  L is a template
// argument, as in K2 and K3; the lerp order is the JAX forward's, z, then
// y, then x, each lerp rounded as the kernel it replaced was compiled
// (lerp1).
//
// K3, the point gradient.  Bound by bytes like K1 (8 corner rows per
// point and grid), but at tracking's 9.6k points one launch per grid is
// too small to fill 132 SMs and each launch pays its own host call.  The
// first design launched once per grid (3 per tracking iteration) and had
// every lane reduce all 8 corner dot products g.c_k across the point's L
// lanes (8 x log2 L shuffles) before lane 0 formed dp.  Now: one launch
// walks all the grids, and by linearity each lane keeps its own partial
// of the three components of df/dfrac (its 4 channels of g.c_k times
// dw_k/dfrac, summed over k and over grids, scaled by each grid's du/dp),
// so only 3 width-L reductions remain.  The clamp-derivative mask is the
// JAX one: du/dp is 1 inside, 0.5 at exact ties, 0 outside.
//
// K2, the grid gradient dgrid[row(k)] += w_k * g.  Bound by atomics: the
// first design issued one f32 atomic per (point, corner, channel), 8 x 32
// per point, and on the 616-cell coarse grid hundreds of them hit every
// address in series at the L2.  The renderer's samples are coherent: a
// ray's 48 samples are consecutive and sorted by depth, so neighbouring
// points share a cell.  Now:
//  * register run-length accumulation: a warp takes a run of kRun = 32
//    consecutive points (one warp-wide batch: lane i locates point i and
//    the warp walks them with shuffles).  A team of P = min(32, 8L) lanes
//    owns one point stream; each lane owns one float4 of channels of
//    8L/P corners.  The corner accumulators of the current cell stay in
//    registers and are flushed only when the cell changes, as 16-byte
//    vector atomics (atomicAdd on float4, sm_90) -- a 128-byte row per
//    corner at C = 32.  kRun = 32: at 48k points it still gives ~1500
//    warps per grid to fill the card, and a run boundary costs at most one
//    extra flush per 32 points.
//  * shared-memory privatization: a grid whose f32 gradient fits in one
//    block's shared memory (the device's opt-in limit, 227 KB on an H100;
//    the coarse grid takes 616 x 32 x 4 = 78,848 B) is accumulated by one
//    block per SM, each over a contiguous chunk of the points, into a
//    block-private copy with shared-memory atomics; each block then adds
//    the cells it touched (non-zero float4s) to the global gradient once.
//    At most one global atomic per address per block.  A launch that mixes
//    such a grid with larger ones gives every block the same dynamic
//    shared memory; the main path never mixes them (the coarse stage looks
//    up one grid, and the middle, fine and color grids are all larger).
//  The border clamp stays exact: a run is keyed by its cell's base row,
//  each corner's row is rebuilt from the clamped integer coordinates, and
//  accumulators that are exactly zero (a clamped +1 corner has weight 0)
//  are never flushed.  Accumulation is f32 throughout (the JAX default
//  buffer is bf16, interp.py:37-44).  Atomics make the summation order
//  vary from run to run, so K2 is held to 32 f32 ulps of the largest
//  per-cell sum of |w_k g| against its plain version summed in float64,
//  not bitwise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGrids = 3;
constexpr int kRun = 32;  // K2: consecutive points per warp run

struct Cell {
  int i0[3];
  int i1[3];
  float f[3];     // fractional lerp weights
  float dudp[3];  // du/dp with the clamp-derivative mask (0.5 at exact ties)
};

__device__ __forceinline__ Cell locate(const float* __restrict__ p, int pt,
                                       int nx, int ny, int nz) {
  Cell c;
  const int sizes[3] = {nx, ny, nz};
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float s1 = (float)(sizes[a] - 1);
    const float raw = (p[3 * pt + a] + 1.0f) * 0.5f * s1;
    const float u = fminf(fmaxf(raw, 0.0f), s1);
    const float fl = floorf(u);
    c.f[a] = u - fl;
    c.i0[a] = (int)fl;
    c.i1[a] = min(c.i0[a] + 1, sizes[a] - 1);
    float live = 0.0f;
    if (raw > 0.0f && raw < s1) live = 1.0f;
    else if (raw == 0.0f || raw == s1) live = 0.5f;
    c.dudp[a] = 0.5f * s1 * live;
  }
  return c;
}

// corner k: bit0 -> x uses i1, bit1 -> y uses i1, bit2 -> z uses i1
__device__ __forceinline__ int corner_row(const Cell& c, int k, int ny, int nz) {
  const int ix = (k & 1) ? c.i1[0] : c.i0[0];
  const int iy = (k & 2) ? c.i1[1] : c.i0[1];
  const int iz = (k & 4) ? c.i1[2] : c.i0[2];
  return (ix * ny + iy) * nz + iz;
}

// Keep a located point in the slab window (x_lo, planes, D), shifting its
// x indices into the slab; false when another slab owns it.
__device__ __forceinline__ bool in_window(Cell& c, int x_lo, int planes, int D) {
  if (D > 1 && min(c.i0[0] / planes, D - 1) * planes != x_lo) return false;
  c.i0[0] = min(max(c.i0[0] - x_lo, 0), planes);
  c.i1[0] = min(max(c.i1[0] - x_lo, 0), planes);
  return true;
}

__device__ __forceinline__ float corner_weight(float fx, float fy, float fz,
                                               int k) {
  const float wx = (k & 1) ? fx : 1.0f - fx;
  const float wy = (k & 2) ? fy : 1.0f - fy;
  const float wz = (k & 4) ? fz : 1.0f - fz;
  return wx * wy * wz;
}

// a (1 - t) + b t rounded as the K1 before this one was compiled: b t
// rounded, then fused into a (1 - t).  Written out, because nvcc paired the products the
// other way in a build that kept two items in flight.
__device__ __forceinline__ float lerp1(float a, float b, float s, float t) {
  return __fmaf_rn(a, s, __fmul_rn(b, t));
}

__device__ __forceinline__ float4 lerp4(float4 a, float4 b, float t) {
  const float s = 1.0f - t;
  return make_float4(lerp1(a.x, b.x, s, t), lerp1(a.y, b.y, s, t),
                     lerp1(a.z, b.z, s, t), lerp1(a.w, b.w, s, t));
}

__device__ __forceinline__ float4 fma4(float w, float4 g, float4 acc) {
  return make_float4(fmaf(w, g.x, acc.x), fmaf(w, g.y, acc.y),
                     fmaf(w, g.z, acc.z), fmaf(w, g.w, acc.w));
}

__device__ __forceinline__ bool nonzero4(float4 v) {
  return v.x != 0.0f || v.y != 0.0f || v.z != 0.0f || v.w != 0.0f;
}

// ---------------------------------------------------------------------------
// K1
// ---------------------------------------------------------------------------

struct FwdGrids {
  const float4* grid[kMaxGrids];  // (planes + 1, ny, nz, L) slab of a grid
  float4* out[kMaxGrids];         // (n, L) its features
  int dims[kMaxGrids][3];         // the full grid's nx, ny, nz
  int win[kMaxGrids][3];          // its window: x_lo, planes, D
};

// item t's grid m, lane q and point (t below count x n x L)
template <int L>
__device__ __forceinline__ int item_point(unsigned t, unsigned per_grid, int& m, int& q) {
  m = 0;
  if (t >= per_grid) { t -= per_grid; m = 1; }
  if (t >= per_grid) { t -= per_grid; m = 2; }
  q = (int)(t % L);
  return (int)(t / L);
}

// Items (grid m, point, lane q) in grid-major order, item t = (m * n + pt)
// * L + q.  With chunk 0 thread g walks items g, g + S, g + 2S, ... (S: the
// launch's threads); else CTA b walks its own `chunk` items from b x chunk
// in steps of 256 (ops/interp.py k1_geometry picks).  A thread loads its
// next item's point while it gathers for the current one.  A point another
// slab owns reads no row and stores 0.  ptxas is asked for 5 CTAs a SM (at
// most 48 registers), so all 8 loads of an item are in flight at once.
template <int L>
__global__ void __launch_bounds__(kThreads, 5)
trilinear_fwd_kernel(FwdGrids s, const float* __restrict__ p, int n, int count,
                     unsigned chunk) {
  static_assert(kMaxGrids == 3, "one branch per grid");
  const unsigned per_grid = (unsigned)n * L;
  const unsigned items = per_grid * (unsigned)count;  // < 2^31 (the wrapper's check)
  // this thread's first item, end and step
  unsigned first = blockIdx.x * kThreads + threadIdx.x, end = items,
           step = gridDim.x * kThreads;
  if (chunk) {
    first = blockIdx.x * chunk + threadIdx.x;
    end = min(items, (blockIdx.x + 1) * chunk);
    step = kThreads;
  }
  float xn[3];  // the point of the thread's next item (point 0 past the end)
  {
    int m, q;
    const int pn = item_point<L>(first < end ? first : 0, per_grid, m, q);
#pragma unroll
    for (int a = 0; a < 3; ++a) xn[a] = p[3 * pn + a];
  }
  for (unsigned t = first; t < end; t += step) {
    int m, q;
    const int pt = item_point<L>(t, per_grid, m, q);
    const float x[3] = {xn[0], xn[1], xn[2]};
    {  // the next item's point, in flight with this one's gathers
      int mm, qq;
      const unsigned r = t + step;
      const int pn = item_point<L>(r < end ? r : 0, per_grid, mm, qq);
#pragma unroll
      for (int a = 0; a < 3; ++a) xn[a] = p[3 * pn + a];
    }
    // the item's grid, picked with constant indices: a loop over m (even
    // unrolled) copied the parameters to an 88-byte local-memory frame and
    // ran at half the speed on an H100, and an else-if chain compiled to
    // code 5-10 % slower than these two ifs
    const float4* grid = s.grid[0];
    float4* out = s.out[0];
    int nx = s.dims[0][0], ny = s.dims[0][1], nz = s.dims[0][2];
    int x_lo = s.win[0][0], planes = s.win[0][1], D = s.win[0][2];
    if (m == 1) {
      grid = s.grid[1];
      out = s.out[1];
      nx = s.dims[1][0];
      ny = s.dims[1][1];
      nz = s.dims[1][2];
      x_lo = s.win[1][0];
      planes = s.win[1][1];
      D = s.win[1][2];
    }
    if (m == 2) {
      grid = s.grid[2];
      out = s.out[2];
      nx = s.dims[2][0];
      ny = s.dims[2][1];
      nz = s.dims[2][2];
      x_lo = s.win[2][0];
      planes = s.win[2][1];
      D = s.win[2][2];
    }
    Cell c = locate(x, 0, nx, ny, nz);
    const bool own = in_window(c, x_lo, planes, D);
    // 32-bit offsets (ops/interp.py _check_launch keeps a grid below 2^31
    // floats, the wrapper the launch below 2^31 items): 64-bit ones took a
    // render chunk's lookup from 0.99 to 1.04 ms on an H100 (PERF.md)
    float4* dst = out + (pt * L + q);
    float4 v[8];
    if (own) {  // all 8 in one block, so ptxas issues them together
#pragma unroll
      for (int k = 0; k < 8; ++k) v[k] = __ldg(grid + (corner_row(c, k, ny, nz) * L + q));
    }
    float4 val = make_float4(0.0f, 0.0f, 0.0f, 0.0f);  // another slab's point
    if (own) {
      // same lerp order as the JAX forward: z, then y, then x
      const float4 c00 = lerp4(v[0], v[4], c.f[2]);
      const float4 c01 = lerp4(v[2], v[6], c.f[2]);
      const float4 c10 = lerp4(v[1], v[5], c.f[2]);
      const float4 c11 = lerp4(v[3], v[7], c.f[2]);
      const float4 c0 = lerp4(c00, c01, c.f[1]);
      const float4 c1 = lerp4(c10, c11, c.f[1]);
      val = lerp4(c0, c1, c.f[0]);
    }
    __stcs(dst, val);  // streaming: the features are not read again here
  }
}

// ---------------------------------------------------------------------------
// K3
// ---------------------------------------------------------------------------

struct DpGrids {
  const float4* grid[kMaxGrids];  // (planes + 1, ny, nz, L) slab of a grid
  const float4* g[kMaxGrids];     // (n, L) cotangent of its lookup
  int dims[kMaxGrids][3];         // the full grid's nx, ny, nz
  int win[kMaxGrids][3];          // its window: x_lo, planes, D
  int count;
};

template <int L>
__global__ void __launch_bounds__(kThreads)
trilinear_bwd_dp_kernel(DpGrids s, const float* __restrict__ p,
                        float* __restrict__ dp, int n) {
  const long t = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const int pt_raw = (int)(t / L);
  const int q = (int)(t % L);
  // every lane of a full warp takes part in the shuffles below; lanes past
  // the end work on the last point and write nothing
  const bool valid = pt_raw < n;
  const int pt = valid ? pt_raw : n - 1;
  float d[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int m = 0; m < kMaxGrids; ++m) {
    if (m >= s.count) break;
    const int ny = s.dims[m][1], nz = s.dims[m][2];
    Cell c = locate(p, pt, s.dims[m][0], ny, nz);
    if (!in_window(c, s.win[m][0], s.win[m][1], s.win[m][2])) continue;
    const float4 gv = __ldg(&s.g[m][(long)pt * L + q]);
    float4 v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      v[k] = __ldg(&s.grid[m][(long)corner_row(c, k, ny, nz) * L + q]);
    // this lane's 4 channels of g.c_k, times dw_k/dfrac, summed over k
    float e[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float gc = gv.x * v[k].x + gv.y * v[k].y + gv.z * v[k].z + gv.w * v[k].w;
      const float wx = (k & 1) ? c.f[0] : 1.0f - c.f[0];
      const float wy = (k & 2) ? c.f[1] : 1.0f - c.f[1];
      const float wz = (k & 4) ? c.f[2] : 1.0f - c.f[2];
      const float sx = (k & 1) ? 1.0f : -1.0f;
      const float sy = (k & 2) ? 1.0f : -1.0f;
      const float sz = (k & 4) ? 1.0f : -1.0f;
      e[0] += gc * (sx * wy * wz);
      e[1] += gc * (wx * sy * wz);
      e[2] += gc * (wx * wy * sz);
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) d[a] += e[a] * c.dudp[a];
  }
#pragma unroll
  for (int off = L >> 1; off > 0; off >>= 1) {
#pragma unroll
    for (int a = 0; a < 3; ++a) d[a] += __shfl_xor_sync(0xffffffffu, d[a], off, L);
  }
  if (!valid || q != 0) return;
  dp[3 * pt + 0] = d[0];
  dp[3 * pt + 1] = d[1];
  dp[3 * pt + 2] = d[2];
}

// ---------------------------------------------------------------------------
// K2
// ---------------------------------------------------------------------------

struct DgridGrid {
  const float4* g;  // (n, L) cotangent of this grid's lookup
  float4* dgrid;    // (planes + 1, ny, nz, L) zeroed f32 gradient of the slab
  int nx, ny, nz;   // the full grid's
  int x_lo, planes, D;  // the slab window
  int shared;       // 1: accumulate in a block-private shared-memory copy
                    //    (set here from the grid's size)
  int first_block;  // this grid's first block in the launch
  int chunk;        // consecutive points per block
};

struct DgridGrids {
  DgridGrid grid[kMaxGrids];
  int count;
};

template <int L>
struct Team {
  static constexpr int P = 8 * L < 32 ? 8 * L : 32;  // lanes per point stream
  static constexpr int NK = 8 * L / P;               // corners per lane
  static constexpr int KS = P / L;                   // stride of a lane's corners
};

__device__ __forceinline__ void add4_global(float4* dst, float4 v) {
  atomicAdd(dst, v);  // sm_90 16-byte vector atomic (red.global.v4.f32)
}

__device__ __forceinline__ void add4_shared(float4* dst, float4 v) {
  atomicAdd(&dst->x, v.x);
  atomicAdd(&dst->y, v.y);
  atomicAdd(&dst->z, v.z);
  atomicAdd(&dst->w, v.w);
}

// Add the current cell's corner accumulators to dst (global gradient or
// the block's shared copy).  cur is the cell's base row (i0 corner).
template <int L, bool kShared>
__device__ __forceinline__ void flush(float4* dst, int cur,
                                      const float4 (&acc)[Team<L>::NK], int q,
                                      int kb, int nx, int ny, int nz, int x_lo) {
  const int iz = cur % nz;
  const int rest = cur / nz;
  const int iy = rest % ny;
  const int ix = rest / ny;  // in the slab; x_lo + ix on the full grid
  // a clamped +1 corner (i0 on the full grid's last node) reuses the i0
  // row; its weight, and so its accumulator, is exactly 0 and is skipped
  const int dx = x_lo + ix < nx - 1 ? ny * nz : 0;
  const int dy = iy < ny - 1 ? nz : 0;
  const int dz = iz < nz - 1 ? 1 : 0;
#pragma unroll
  for (int j = 0; j < Team<L>::NK; ++j) {
    const int k = kb + j * Team<L>::KS;
    if (!nonzero4(acc[j])) continue;
    const int row = cur + ((k & 1) ? dx : 0) + ((k & 2) ? dy : 0) + ((k & 4) ? dz : 0);
    float4* a = dst + (long)row * L + q;
    if (kShared) add4_shared(a, acc[j]);
    else add4_global(a, acc[j]);
  }
}

// One warp, one run of points [start, end) (end - start <= kRun = 32).
// Lane i locates point start + i; team tau (lanes tau*P .. tau*P+P-1)
// walks points start + tau*P .. start + tau*P + P-1 in order.
template <int L, bool kShared>
__device__ __forceinline__ void dgrid_run(const float* __restrict__ p,
                                          const DgridGrid& d, float4* dst,
                                          int start, int end, int lane) {
  using T = Team<L>;
  const int t = lane % T::P;
  const int team_first = start + (lane - t);
  const int q = t % L;
  const int kb = t / L;

  int key = -1;
  float fx = 0.0f, fy = 0.0f, fz = 0.0f;
  if (start + lane < end) {
    Cell c = locate(p, start + lane, d.nx, d.ny, d.nz);
    if (in_window(c, d.x_lo, d.planes, d.D)) {  // else key -1: adds nothing
      key = (c.i0[0] * d.ny + c.i0[1]) * d.nz + c.i0[2];
      fx = c.f[0];
      fy = c.f[1];
      fz = c.f[2];
    }
  }

  float4 acc[T::NK];
#pragma unroll
  for (int j = 0; j < T::NK; ++j) acc[j] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  int cur = -1;

#pragma unroll
  for (int j0 = 0; j0 < T::P; j0 += 4) {
    float4 gv[4];  // four cotangent rows in flight
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int pt = team_first + j0 + u;
      gv[u] = pt < end ? __ldg(&d.g[(long)pt * L + q])
                       : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int src = j0 + u;
      const int kj = __shfl_sync(0xffffffffu, key, src, T::P);
      const float ax = __shfl_sync(0xffffffffu, fx, src, T::P);
      const float ay = __shfl_sync(0xffffffffu, fy, src, T::P);
      const float az = __shfl_sync(0xffffffffu, fz, src, T::P);
      if (kj < 0) continue;  // past the end of the run
      if (kj != cur) {
        if (cur >= 0) flush<L, kShared>(dst, cur, acc, q, kb, d.nx, d.ny, d.nz, d.x_lo);
        cur = kj;
#pragma unroll
        for (int j = 0; j < T::NK; ++j) acc[j] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
#pragma unroll
      for (int j = 0; j < T::NK; ++j)
        acc[j] = fma4(corner_weight(ax, ay, az, kb + j * T::KS), gv[u], acc[j]);
    }
  }
  if (cur >= 0) flush<L, kShared>(dst, cur, acc, q, kb, d.nx, d.ny, d.nz, d.x_lo);
}

template <int L>
__global__ void __launch_bounds__(kThreads)
trilinear_bwd_dgrid_kernel(DgridGrids s, const float* __restrict__ p, int n) {
  extern __shared__ float4 priv[];
  DgridGrid d = s.grid[0];
#pragma unroll
  for (int m = 1; m < kMaxGrids; ++m)
    if (m < s.count && (int)blockIdx.x >= s.grid[m].first_block) d = s.grid[m];
  const int lo = ((int)blockIdx.x - d.first_block) * d.chunk;
  const int hi = min(n, lo + d.chunk);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (!d.shared) {
    for (int s0 = lo + warp * kRun; s0 < hi; s0 += kWarps * kRun)
      dgrid_run<L, false>(p, d, d.dgrid, s0, min(hi, s0 + kRun), lane);
    return;
  }
  const int cells = (d.planes + 1) * d.ny * d.nz * L;  // float4s of the slab's copy
  for (int i = threadIdx.x; i < cells; i += kThreads)
    priv[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  __syncthreads();
  for (int s0 = lo + warp * kRun; s0 < hi; s0 += kWarps * kRun)
    dgrid_run<L, true>(p, d, priv, s0, min(hi, s0 + kRun), lane);
  __syncthreads();
  for (int i = threadIdx.x; i < cells; i += kThreads) {
    const float4 v = priv[i];
    if (nonzero4(v)) add4_global(d.dgrid + i, v);
  }
}

constexpr int kDesc = 8;  // descriptor values per grid

// A window the kernels can run: D >= 1 slabs of planes >= 1 owned planes
// each (a dense grid of one plane: planes 0, D 1), x_lo on a slab start.
bool window_ok(const long long* e) {
  const long long nx = e[2], x_lo = e[5], planes = e[6], D = e[7];
  if (D < 1 || planes < 0 || x_lo < 0 || (D > 1 && planes < 1)) return false;
  if (D == 1) return x_lo == 0 && planes == nx - 1;
  return x_lo % planes == 0 && x_lo / planes < D && planes * D + 1 >= nx;
}

int device_attribute(cudaDeviceAttr attr) {
  int dev = 0, value = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&value, attr, dev);
  return value;
}

// A K1 launch's grids from its descriptor (kDesc values per grid); false
// if a window is not one the kernels can run.
bool fwd_grids(const long long* desc, int count, FwdGrids* s) {
  *s = {};
  for (int m = 0; m < count; ++m) {
    const long long* e = desc + kDesc * m;
    if (!window_ok(e)) return false;
    s->grid[m] = (const float4*)e[0];
    s->out[m] = (float4*)e[1];
    for (int a = 0; a < 3; ++a) {
      s->dims[m][a] = (int)e[2 + a];
      s->win[m][a] = (int)e[5 + a];
    }
  }
  return true;
}

template <int L>
int launch_fwd(const FwdGrids& s, int count, const float* p, int n, int ctas,
               unsigned chunk, cudaStream_t stream) {
  trilinear_fwd_kernel<L><<<ctas, kThreads, 0, stream>>>(s, p, n, count, chunk);
  return (int)cudaGetLastError();
}

// K1's resources at L float4s a row: registers, local (spill) bytes,
// threads per CTA and resident CTAs per SM (the occupancy API).
template <int L>
int fwd_info(int* out) {
  const void* f = (const void*)trilinear_fwd_kernel<L>;
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

template <int L>
int launch_dgrid(const DgridGrids& s, const float* p, int n, int blocks,
                 int smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        trilinear_bwd_dgrid_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  trilinear_bwd_dgrid_kernel<L><<<blocks, kThreads, smem, stream>>>(s, p, n);
  return (int)cudaGetLastError();
}

template <int L>
int launch_dp(const DpGrids& s, const float* p, float* dp, int n,
              cudaStream_t stream) {
  const unsigned blocks = (unsigned)(((long)n * L + kThreads - 1) / kThreads);
  trilinear_bwd_dp_kernel<L><<<blocks, kThreads, 0, stream>>>(s, p, dp, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// desc: per grid kDesc values -- grid (slab) ptr, output ptr, then the
// full grid's nx, ny, nz and the slab window x_lo, planes, D (a dense grid:
// 0, nx - 1, 1).  ctas, chunk: the launch's CTAs and the items each walks
// (0: a grid stride), from ops/interp.py k1_geometry.  The kernel's offsets
// are 32-bit: the wrapper keeps count x n x L and each grid's floats below
// 2^31.
int trilinear_fwd(const long long* desc, int count, const float* p, int n, int c,
                  int ctas, int chunk, void* stream) {
  if (count < 1 || count > kMaxGrids || n < 1 || ctas < 1 || chunk < 0 ||
      chunk % kThreads || (long long)count * n * (c / 4) >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  FwdGrids s;
  if (!fwd_grids(desc, count, &s)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (c / 4) {
    case 1: return launch_fwd<1>(s, count, p, n, ctas, chunk, st);
    case 2: return launch_fwd<2>(s, count, p, n, ctas, chunk, st);
    case 4: return launch_fwd<4>(s, count, p, n, ctas, chunk, st);
    case 8: return launch_fwd<8>(s, count, p, n, ctas, chunk, st);
    case 16: return launch_fwd<16>(s, count, p, n, ctas, chunk, st);
    case 32: return launch_fwd<32>(s, count, p, n, ctas, chunk, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K1's resources at c channels into out[4] (fwd_info).
int trilinear_fwd_info(int c, int* out) {
  switch (c / 4) {
    case 1: return fwd_info<1>(out);
    case 2: return fwd_info<2>(out);
    case 4: return fwd_info<4>(out);
    case 8: return fwd_info<8>(out);
    case 16: return fwd_info<16>(out);
    case 32: return fwd_info<32>(out);
    default: return (int)cudaErrorInvalidValue;
  }
}

// desc: per grid kDesc values -- cotangent ptr, zeroed slab gradient ptr,
// the full grid's nx, ny, nz, and the slab window x_lo, planes, D.
int trilinear_bwd_dgrid(const long long* desc, int count, const float* p, int n,
                        int c, void* stream) {
  if (count < 1 || count > kMaxGrids || n < 1) return (int)cudaErrorInvalidValue;
  const long smem_max = device_attribute(cudaDevAttrMaxSharedMemoryPerBlockOptin);
  const int sms = max(1, device_attribute(cudaDevAttrMultiProcessorCount));
  DgridGrids s = {};
  s.count = count;
  int blocks = 0, smem = 0;
  for (int m = 0; m < count; ++m) {
    const long long* e = desc + kDesc * m;
    if (!window_ok(e)) return (int)cudaErrorInvalidValue;
    DgridGrid& d = s.grid[m];
    d.g = (const float4*)e[0];
    d.dgrid = (float4*)e[1];
    d.nx = (int)e[2];
    d.ny = (int)e[3];
    d.nz = (int)e[4];
    d.x_lo = (int)e[5];
    d.planes = (int)e[6];
    d.D = (int)e[7];
    // the slab's rows: a coarse slab of 3-4 planes, not the whole grid
    const long bytes = (long)(d.planes + 1) * d.ny * d.nz * c * 4;
    d.shared = bytes <= smem_max;
    d.first_block = blocks;
    int nb;
    if (d.shared) {
      // one block per SM, each over a contiguous chunk of whole runs
      nb = min(sms, (n + kWarps * kRun - 1) / (kWarps * kRun));
      const int per = (n + nb - 1) / nb;
      d.chunk = (per + kRun - 1) / kRun * kRun;
      nb = (n + d.chunk - 1) / d.chunk;
      if (bytes > smem) smem = (int)bytes;
    } else {
      d.chunk = kWarps * kRun;
      nb = (n + d.chunk - 1) / d.chunk;
    }
    blocks += nb;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  switch (c / 4) {
    case 1: return launch_dgrid<1>(s, p, n, blocks, smem, st);
    case 2: return launch_dgrid<2>(s, p, n, blocks, smem, st);
    case 4: return launch_dgrid<4>(s, p, n, blocks, smem, st);
    case 8: return launch_dgrid<8>(s, p, n, blocks, smem, st);
    case 16: return launch_dgrid<16>(s, p, n, blocks, smem, st);
    case 32: return launch_dgrid<32>(s, p, n, blocks, smem, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// desc: per grid kDesc values -- grid (slab) ptr, cotangent ptr, the full
// grid's nx, ny, nz, and the slab window x_lo, planes, D.  dp is written
// (not accumulated): the sum over the grids of each one's dp from the
// points the slab owns.
int trilinear_bwd_dp(const long long* desc, int count, const float* p, float* dp,
                     int n, int c, void* stream) {
  if (count < 1 || count > kMaxGrids || n < 1) return (int)cudaErrorInvalidValue;
  DpGrids s = {};
  s.count = count;
  for (int m = 0; m < count; ++m) {
    const long long* e = desc + kDesc * m;
    if (!window_ok(e)) return (int)cudaErrorInvalidValue;
    s.grid[m] = (const float4*)e[0];
    s.g[m] = (const float4*)e[1];
    for (int a = 0; a < 3; ++a) {
      s.dims[m][a] = (int)e[2 + a];
      s.win[m][a] = (int)e[5 + a];
    }
  }
  const cudaStream_t st = (cudaStream_t)stream;
  switch (c / 4) {
    case 1: return launch_dp<1>(s, p, dp, n, st);
    case 2: return launch_dp<2>(s, p, dp, n, st);
    case 4: return launch_dp<4>(s, p, dp, n, st);
    case 8: return launch_dp<8>(s, p, dp, n, st);
    case 16: return launch_dp<16>(s, p, dp, n, st);
    case 32: return launch_dp<32>(s, p, dp, n, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
