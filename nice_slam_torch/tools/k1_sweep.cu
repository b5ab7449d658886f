// K1 designs that the lookup kernel of csrc/trilinear.cu was measured
// against (sm_90a).  Not on the main path: only tools/k1_sweep.py builds
// and launches them.
//
//   k1_write      not a K1: a lookup's features written with nothing
//                 computed, the store floor the sweep reports beside K1.
//   k1_baseline   the K1 the port shipped before csrc/trilinear.cu's: one
//                 thread per (grid, point, float4), blockIdx.y the grid, one
//                 launch over a stage's grids in as many rounds of resident
//                 CTAs as the items take, with the slab window; any C.
//   k1_walk       the register walk, K2's run structure applied to the
//                 lookup (C = 32).  A warp takes a run of consecutive
//                 points; lane i loads point i once and locates it once per
//                 distinct grid shape (the fine and color grids share one
//                 locate).  A team of L lanes (one float4 of channels each)
//                 walks per_team consecutive points of the run, the cell and
//                 fractions broadcast by shuffles.  Each lane keeps the 8
//                 corner float4s of the current cell of every grid in
//                 registers and gathers again only when the cell changes
//                 (keyed by the base row, as K2 keys runs; the +1 corners
//                 rebuilt from the clamped integer coordinates), so with
//                 three grids up to 24 independent 16-byte loads are in
//                 flight per lane.  Block of 128 or 256 threads, with or
//                 without a cap of 128 registers (4 blocks of 128 per SM).
//   k1_runtime_l  k1_baseline with L a run-time argument, as the per-grid K1
//                 before it had it (no slab window).
//
// The lerp order of all is the JAX forward's: z, then y, then x.

#include "../csrc/trilinear.cu"

namespace {

constexpr int kL = 8;  // float4s per grid row at C = 32

// the lerp with the products' pairing left to nvcc (for these kernels, as
// trilinear.cu's lerp4 pairs them)
__device__ __forceinline__ float4 lerp4_nvcc(float4 a, float4 b, float t) {
  const float s = 1.0f - t;
  return make_float4(a.x * s + b.x * t, a.y * s + b.y * t,
                     a.z * s + b.z * t, a.w * s + b.w * t);
}

struct WalkGrids {
  const float4* grid[kMaxGrids];  // (V, L) feature grid
  float4* out[kMaxGrids];         // (n, L) its features
  int dims[kMaxGrids][3];
  int same[kMaxGrids];            // first grid of the same dims (shares its locate)
};

// corner k's row of the cell whose base (i0 corner) row is base; a +1
// corner clamped onto the last node stays on the base row
__device__ __forceinline__ int step_row(int base, int k, int nx, int ny, int nz) {
  const int iz = base % nz;
  const int rest = base / nz;
  const int iy = rest % ny;
  const int ix = rest / ny;
  return base + ((k & 1) && ix < nx - 1 ? ny * nz : 0) +
         ((k & 2) && iy < ny - 1 ? nz : 0) + ((k & 4) && iz < nz - 1 ? 1 : 0);
}

// One warp, one run of (32 / L) * per_team consecutive points from start
// (per_team <= L, so the run fits the warp's 32 lanes).  Lane i locates
// point start + i; team tau (lanes tau*L .. tau*L+L-1) walks points
// start + tau*per_team .. start + tau*per_team + per_team-1.
template <int NG, int kBlock, int kMinBlocks>
__global__ void __launch_bounds__(kBlock, kMinBlocks)
k1_walk_kernel(WalkGrids s, const float* __restrict__ p, int n, int per_team) {
  constexpr int kTeams = 32 / kL;
  const int run = kTeams * per_team;
  const int start = (int)(((long)blockIdx.x * kBlock + threadIdx.x) / 32) * run;
  if (start >= n) return;  // the whole warp: every lane below takes part in the shuffles
  const int end = min(n, start + run);
  const int lane = threadIdx.x % 32;
  const int q = lane % kL;
  const int team_first = (lane / kL) * per_team;

  // key: the cell's base row, -1 past the end of the run
  int key[NG];
  float f[NG][3];
#pragma unroll
  for (int m = 0; m < NG; ++m) {
    key[m] = -1;
    f[m][0] = f[m][1] = f[m][2] = 0.0f;
  }
  if (start + lane < end) {
    const int pt = start + lane;
    const float x[3] = {p[3 * pt], p[3 * pt + 1], p[3 * pt + 2]};
#pragma unroll
    for (int m = 0; m < NG; ++m) {
      bool shared = false;
#pragma unroll
      for (int k = 0; k < m; ++k) {
        if (!shared && s.same[m] == k) {
          key[m] = key[k];
          f[m][0] = f[k][0];
          f[m][1] = f[k][1];
          f[m][2] = f[k][2];
          shared = true;
        }
      }
      if (!shared) {
        const int ny = s.dims[m][1], nz = s.dims[m][2];
        const Cell c = locate(x, 0, s.dims[m][0], ny, nz);
        key[m] = (c.i0[0] * ny + c.i0[1]) * nz + c.i0[2];
        f[m][0] = c.f[0];
        f[m][1] = c.f[1];
        f[m][2] = c.f[2];
      }
    }
  }

  int cur[NG];
  float4 v[NG][8];  // corner rows of the current cell (corner k as in corner_row)
#pragma unroll
  for (int m = 0; m < NG; ++m) cur[m] = -1;

  for (int j = 0; j < per_team; ++j) {
    const int src = team_first + j;
    int kj[NG];
    float a[NG][3];
#pragma unroll
    for (int m = 0; m < NG; ++m) {
      kj[m] = __shfl_sync(0xffffffffu, key[m], src);
      if (s.same[m] == m) {  // uniform: a grid of its own shape
        a[m][0] = __shfl_sync(0xffffffffu, f[m][0], src);
        a[m][1] = __shfl_sync(0xffffffffu, f[m][1], src);
        a[m][2] = __shfl_sync(0xffffffffu, f[m][2], src);
      }
#pragma unroll
      for (int k = 0; k < m; ++k) {
        if (s.same[m] == k) {
          a[m][0] = a[k][0];
          a[m][1] = a[k][1];
          a[m][2] = a[k][2];
        }
      }
    }
    if (kj[0] < 0) continue;  // past the end of the run
    // gather the grids whose cell changed, all loads before any use
#pragma unroll
    for (int m = 0; m < NG; ++m) {
      if (kj[m] != cur[m]) {
        cur[m] = kj[m];
#pragma unroll
        for (int k = 0; k < 8; ++k)
          v[m][k] = __ldg(&s.grid[m][(long)step_row(cur[m], k, s.dims[m][0], s.dims[m][1],
                                                    s.dims[m][2]) * kL + q]);
      }
    }
    const long row = (long)(start + src) * kL + q;
#pragma unroll
    for (int m = 0; m < NG; ++m) {
      const float4 c00 = lerp4_nvcc(v[m][0], v[m][4], a[m][2]);
      const float4 c01 = lerp4_nvcc(v[m][2], v[m][6], a[m][2]);
      const float4 c10 = lerp4_nvcc(v[m][1], v[m][5], a[m][2]);
      const float4 c11 = lerp4_nvcc(v[m][3], v[m][7], a[m][2]);
      const float4 c0 = lerp4_nvcc(c00, c01, a[m][1]);
      const float4 c1 = lerp4_nvcc(c10, c11, a[m][1]);
      s.out[m][row] = lerp4_nvcc(c0, c1, a[m][0]);
    }
  }
}

template <int kBlock, int kMinBlocks>
int launch_walk(const WalkGrids& s, int count, const float* p, int n, int per_team,
                cudaStream_t stream) {
  const int run = 32 / kL * per_team;
  const long warps = (n + run - 1) / run;
  const unsigned blocks = (unsigned)((warps * 32 + kBlock - 1) / kBlock);
  static_assert(kMaxGrids == 3, "one instantiation per grid count");
  switch (count) {
    case 1: k1_walk_kernel<1, kBlock, kMinBlocks><<<blocks, kBlock, 0, stream>>>(s, p, n, per_team); break;
    case 2: k1_walk_kernel<2, kBlock, kMinBlocks><<<blocks, kBlock, 0, stream>>>(s, p, n, per_team); break;
    case 3: k1_walk_kernel<3, kBlock, kMinBlocks><<<blocks, kBlock, 0, stream>>>(s, p, n, per_team); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

__global__ void __launch_bounds__(kThreads)
k1_runtime_l_kernel(FwdGrids s, const float* __restrict__ p, int n, int L) {
  const long t = (long)blockIdx.x * kThreads + threadIdx.x;
  const int pt = (int)(t / L);
  const int q = (int)(t % L);
  if (pt >= n) return;
  const float4* grid = s.grid[0];
  float4* out = s.out[0];
  int nx = s.dims[0][0], ny = s.dims[0][1], nz = s.dims[0][2];
  if (blockIdx.y == 1) {
    grid = s.grid[1];
    out = s.out[1];
    nx = s.dims[1][0];
    ny = s.dims[1][1];
    nz = s.dims[1][2];
  }
  if (blockIdx.y == 2) {
    grid = s.grid[2];
    out = s.out[2];
    nx = s.dims[2][0];
    ny = s.dims[2][1];
    nz = s.dims[2][2];
  }
  const Cell c = locate(p, pt, nx, ny, nz);
  float4 v[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = __ldg(&grid[(long)corner_row(c, k, ny, nz) * L + q]);
  const float4 c00 = lerp4_nvcc(v[0], v[4], c.f[2]);
  const float4 c01 = lerp4_nvcc(v[2], v[6], c.f[2]);
  const float4 c10 = lerp4_nvcc(v[1], v[5], c.f[2]);
  const float4 c11 = lerp4_nvcc(v[3], v[7], c.f[2]);
  const float4 c0 = lerp4_nvcc(c00, c01, c.f[1]);
  const float4 c1 = lerp4_nvcc(c10, c11, c.f[1]);
  out[(long)pt * L + q] = lerp4_nvcc(c0, c1, c.f[0]);
}

template <int L>
__global__ void __launch_bounds__(kThreads)
k1_baseline_kernel(FwdGrids s, const float* __restrict__ p, int n) {
  const long t = (long)blockIdx.x * kThreads + threadIdx.x;
  const int pt = (int)(t / L);
  const int q = (int)(t % L);
  if (pt >= n) return;
  const float4* grid = s.grid[0];
  float4* out = s.out[0];
  int nx = s.dims[0][0], ny = s.dims[0][1], nz = s.dims[0][2];
  int x_lo = s.win[0][0], planes = s.win[0][1], D = s.win[0][2];
  if (blockIdx.y == 1) {
    grid = s.grid[1];
    out = s.out[1];
    nx = s.dims[1][0];
    ny = s.dims[1][1];
    nz = s.dims[1][2];
    x_lo = s.win[1][0];
    planes = s.win[1][1];
    D = s.win[1][2];
  }
  if (blockIdx.y == 2) {
    grid = s.grid[2];
    out = s.out[2];
    nx = s.dims[2][0];
    ny = s.dims[2][1];
    nz = s.dims[2][2];
    x_lo = s.win[2][0];
    planes = s.win[2][1];
    D = s.win[2][2];
  }
  Cell c = locate(p, pt, nx, ny, nz);
  if (!in_window(c, x_lo, planes, D)) {
    out[(long)pt * L + q] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    return;
  }
  float4 v[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = __ldg(&grid[(long)corner_row(c, k, ny, nz) * L + q]);
  const float4 c00 = lerp4_nvcc(v[0], v[4], c.f[2]);
  const float4 c01 = lerp4_nvcc(v[2], v[6], c.f[2]);
  const float4 c10 = lerp4_nvcc(v[1], v[5], c.f[2]);
  const float4 c11 = lerp4_nvcc(v[3], v[7], c.f[2]);
  const float4 c0 = lerp4_nvcc(c00, c01, c.f[1]);
  const float4 c1 = lerp4_nvcc(c10, c11, c.f[1]);
  out[(long)pt * L + q] = lerp4_nvcc(c0, c1, c.f[0]);
}

template <int L>
int launch_baseline(const FwdGrids& s, int count, const float* p, int n, cudaStream_t stream) {
  const dim3 blocks((unsigned)(((long)n * L + kThreads - 1) / kThreads), count);
  k1_baseline_kernel<L><<<blocks, kThreads, 0, stream>>>(s, p, n);
  return (int)cudaGetLastError();
}

// the store floor of a lookup: its (n, C) features written as K1 writes
// them (streaming 16-byte stores, a grid stride), with nothing to compute
__global__ void __launch_bounds__(kThreads)
k1_write_kernel(float4* __restrict__ out, unsigned n4) {
  for (unsigned i = blockIdx.x * kThreads + threadIdx.x; i < n4; i += gridDim.x * kThreads)
    __stcs(out + i, make_float4(0.0f, 0.0f, 0.0f, 0.0f));
}

}  // namespace

extern "C" {

// desc: per grid 5 values -- grid ptr, output ptr, nx, ny, nz.  per_team
// in {1, 2, 4, 8}; (block, min_blocks) in {(128, 1), (128, 4), (256, 1)}.
int k1_walk(const long long* desc, int count, const float* p, int n, int c, int per_team,
            int block, int min_blocks, void* stream) {
  if (count < 1 || count > kMaxGrids || n < 1 || c != 4 * kL || per_team < 1 ||
      per_team > kL || (per_team & (per_team - 1)))
    return (int)cudaErrorInvalidValue;
  WalkGrids s = {};
  for (int m = 0; m < count; ++m) {
    const long long* e = desc + 5 * m;
    s.grid[m] = (const float4*)e[0];
    s.out[m] = (float4*)e[1];
    s.dims[m][0] = (int)e[2];
    s.dims[m][1] = (int)e[3];
    s.dims[m][2] = (int)e[4];
    s.same[m] = m;
    for (int k = m - 1; k >= 0; --k)
      if (s.dims[k][0] == s.dims[m][0] && s.dims[k][1] == s.dims[m][1] &&
          s.dims[k][2] == s.dims[m][2])
        s.same[m] = k;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  if (block == 128 && min_blocks == 1) return launch_walk<128, 1>(s, count, p, n, per_team, st);
  if (block == 128 && min_blocks == 4) return launch_walk<128, 4>(s, count, p, n, per_team, st);
  if (block == 256 && min_blocks == 1) return launch_walk<256, 1>(s, count, p, n, per_team, st);
  return (int)cudaErrorInvalidValue;
}

// desc as k1_walk's; any C of the shipped K1.
int k1_runtime_l(const long long* desc, int count, const float* p, int n, int c,
                 void* stream) {
  if (count < 1 || count > kMaxGrids || n < 1 || c % 4) return (int)cudaErrorInvalidValue;
  FwdGrids s = {};
  for (int m = 0; m < count; ++m) {
    const long long* e = desc + 5 * m;
    s.grid[m] = (const float4*)e[0];
    s.out[m] = (float4*)e[1];
    s.dims[m][0] = (int)e[2];
    s.dims[m][1] = (int)e[3];
    s.dims[m][2] = (int)e[4];
  }
  const int L = c / 4;
  const dim3 blocks((unsigned)(((long)n * L + kThreads - 1) / kThreads), count);
  k1_runtime_l_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(s, p, n, L);
  return (int)cudaGetLastError();
}

// desc: per grid kDesc values, as trilinear_fwd's; any C.
int k1_baseline(const long long* desc, int count, const float* p, int n, int c, void* stream) {
  if (count < 1 || count > kMaxGrids || n < 1) return (int)cudaErrorInvalidValue;
  FwdGrids s;
  if (!fwd_grids(desc, count, &s)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (c / 4) {
    case 1: return launch_baseline<1>(s, count, p, n, st);
    case 2: return launch_baseline<2>(s, count, p, n, st);
    case 4: return launch_baseline<4>(s, count, p, n, st);
    case 8: return launch_baseline<8>(s, count, p, n, st);
    case 16: return launch_baseline<16>(s, count, p, n, st);
    case 32: return launch_baseline<32>(s, count, p, n, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// k1_write_kernel over n4 float4s at out, `ctas` CTAs.
int k1_write(void* out, int n4, int ctas, void* stream) {
  k1_write_kernel<<<ctas, kThreads, 0, (cudaStream_t)stream>>>((float4*)out, (unsigned)n4);
  return (int)cudaGetLastError();
}

}  // extern "C"
