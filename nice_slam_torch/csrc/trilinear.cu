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
// K1 (unchanged): one thread per (point, float4 of channels), so the L
// lanes of a point read one corner row as L contiguous 16-byte loads -- a
// 128-byte coalesced transaction at C = 32.  Bound by bytes: it gathers 8
// corner rows per point, mostly from L2 (the 22.8 MB fine grid fits the
// 50 MB L2).
//
// K2 and K3 take every grid of a decoder stage (up to kMaxGrids, looked up
// at the same points) in ONE launch; the backward of one stage's lookups
// is one K2 and/or one K3.
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

__device__ __forceinline__ float corner_weight(float fx, float fy, float fz,
                                               int k) {
  const float wx = (k & 1) ? fx : 1.0f - fx;
  const float wy = (k & 2) ? fy : 1.0f - fy;
  const float wz = (k & 4) ? fz : 1.0f - fz;
  return wx * wy * wz;
}

__device__ __forceinline__ float4 lerp4(float4 a, float4 b, float t) {
  const float s = 1.0f - t;
  return make_float4(a.x * s + b.x * t, a.y * s + b.y * t,
                     a.z * s + b.z * t, a.w * s + b.w * t);
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

__global__ void __launch_bounds__(kThreads)
trilinear_fwd_kernel(const float4* __restrict__ grid, const float* __restrict__ p,
                     float4* __restrict__ out, int n, int nx, int ny, int nz,
                     int L) {
  const long t = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const int pt = (int)(t / L);
  const int q = (int)(t % L);
  if (pt >= n) return;
  const Cell c = locate(p, pt, nx, ny, nz);
  float4 v[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = __ldg(&grid[(long)corner_row(c, k, ny, nz) * L + q]);
  // same lerp order as the JAX forward: z, then y, then x
  const float4 c00 = lerp4(v[0], v[4], c.f[2]);
  const float4 c01 = lerp4(v[2], v[6], c.f[2]);
  const float4 c10 = lerp4(v[1], v[5], c.f[2]);
  const float4 c11 = lerp4(v[3], v[7], c.f[2]);
  const float4 c0 = lerp4(c00, c01, c.f[1]);
  const float4 c1 = lerp4(c10, c11, c.f[1]);
  out[(long)pt * L + q] = lerp4(c0, c1, c.f[0]);
}

// ---------------------------------------------------------------------------
// K3
// ---------------------------------------------------------------------------

struct DpGrids {
  const float4* grid[kMaxGrids];  // (V, L) feature grid
  const float4* g[kMaxGrids];     // (n, L) cotangent of its lookup
  int dims[kMaxGrids][3];
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
    const Cell c = locate(p, pt, s.dims[m][0], ny, nz);
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
  float4* dgrid;    // (V, L) zeroed f32 gradient
  int nx, ny, nz;
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
                                      int kb, int nx, int ny, int nz) {
  const int iz = cur % nz;
  const int rest = cur / nz;
  const int iy = rest % ny;
  const int ix = rest / ny;
  // a clamped +1 corner (i0 on the last node) reuses the i0 row; its
  // weight, and so its accumulator, is exactly 0 and is skipped
  const int dx = ix < nx - 1 ? ny * nz : 0;
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
    const Cell c = locate(p, start + lane, d.nx, d.ny, d.nz);
    key = (c.i0[0] * d.ny + c.i0[1]) * d.nz + c.i0[2];
    fx = c.f[0];
    fy = c.f[1];
    fz = c.f[2];
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
        if (cur >= 0) flush<L, kShared>(dst, cur, acc, q, kb, d.nx, d.ny, d.nz);
        cur = kj;
#pragma unroll
        for (int j = 0; j < T::NK; ++j) acc[j] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
#pragma unroll
      for (int j = 0; j < T::NK; ++j)
        acc[j] = fma4(corner_weight(ax, ay, az, kb + j * T::KS), gv[u], acc[j]);
    }
  }
  if (cur >= 0) flush<L, kShared>(dst, cur, acc, q, kb, d.nx, d.ny, d.nz);
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
  const int cells = d.nx * d.ny * d.nz * L;  // float4s of the private copy
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

int device_attribute(cudaDeviceAttr attr) {
  int dev = 0, value = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&value, attr, dev);
  return value;
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

int trilinear_fwd(const float* grid, const float* p, float* out, int n, int nx,
                  int ny, int nz, int c, void* stream) {
  const int L = c / 4;
  const unsigned blocks = (unsigned)(((long)n * L + kThreads - 1) / kThreads);
  trilinear_fwd_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float4*)grid, p, (float4*)out, n, nx, ny, nz, L);
  return (int)cudaGetLastError();
}

// desc: per grid 5 values -- cotangent ptr, zeroed gradient ptr, nx, ny,
// nz.
int trilinear_bwd_dgrid(const long long* desc, int count, const float* p, int n,
                        int c, void* stream) {
  if (count < 1 || count > kMaxGrids || n < 1) return (int)cudaErrorInvalidValue;
  const long smem_max = device_attribute(cudaDevAttrMaxSharedMemoryPerBlockOptin);
  const int sms = max(1, device_attribute(cudaDevAttrMultiProcessorCount));
  DgridGrids s = {};
  s.count = count;
  int blocks = 0, smem = 0;
  for (int m = 0; m < count; ++m) {
    const long long* e = desc + 5 * m;
    DgridGrid& d = s.grid[m];
    d.g = (const float4*)e[0];
    d.dgrid = (float4*)e[1];
    d.nx = (int)e[2];
    d.ny = (int)e[3];
    d.nz = (int)e[4];
    const long bytes = (long)d.nx * d.ny * d.nz * c * 4;
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

// desc: per grid 5 values -- grid ptr, cotangent ptr, nx, ny, nz.  dp is
// written (not accumulated): the sum over the grids of each one's dp.
int trilinear_bwd_dp(const long long* desc, int count, const float* p, float* dp,
                     int n, int c, void* stream) {
  if (count < 1 || count > kMaxGrids || n < 1) return (int)cudaErrorInvalidValue;
  DpGrids s = {};
  s.count = count;
  for (int m = 0; m < count; ++m) {
    const long long* e = desc + 5 * m;
    s.grid[m] = (const float4*)e[0];
    s.g[m] = (const float4*)e[1];
    s.dims[m][0] = (int)e[2];
    s.dims[m][1] = (int)e[3];
    s.dims[m][2] = (int)e[4];
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
