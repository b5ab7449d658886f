// The volume-render integrator and its gradient, for Hopper (sm_90a).
//
// Replaces the JAX package's integrator, nice_slam_tpu/ops/geometry.py:259
// raw2outputs_nerf_color (a chain of elementwise XLA ops there, about 20
// kernels forward and 30 backward in the port's plain PyTorch version):
//   K7 integrate_fwd  alpha, the exclusive product of (1 - alpha + 1e-10),
//                     the weights, depth, depth variance and rgb of each ray;
//   K8 integrate_bwd  the gradients of raw and (density mode) rays_d by a
//                     reverse scan without division.
//
// Layout: raw (N, S, 4) f32 (rgb + occupancy or density), z (N, S), rays_d
// (N, 3), all contiguous; outputs depth (N), var (N), rgb (N, 3), weights
// (N, S).  Occupancy mode: a_i = sigmoid(10 o_i).  Density mode:
// a_i = 1 - exp(-relu(sigma_i) delta_i), delta_i = (z_{i+1} - z_i) |d|, the
// last interval 1e10 |d|.  T_0 = 1, T_{i+1} = T_i f_i, f_i = (1 - a_i) + 1e-10,
// w_i = a_i T_i, D = sum w z, V = sum w (z - D)^2, rgb = sum w c.
//
// The design: a group of L lanes per ray (L = 16 or 32, chosen per launch
// by ops/integrator.py integrate_geometry), 4 warps a CTA.  A ray's samples
// come in blocks of L: lane k holds sample b L + k of each block b, up to
// kRun blocks (a tile) in registers, so each load instruction reads L
// neighbouring 16-byte samples of a ray (coalesced) and each sample is read
// once.  Bound by bytes: a ray reads 20 bytes a sample and writes 4 (K7) or
// 16 (K8); at tracking's 200 rays the launch is 50 CTAs of 4 warps (L = 32),
// where a thread per ray gave 2, and the time is one round trip of loads
// plus the shuffles.  Products and sums combine across the group with warp
// shuffles: T is each block's exclusive product scan (__shfl_up_sync,
// log2 L steps) times the carry from the blocks before; depth, rgb, the
// variance, M and |d|'s gradient are __shfl_xor_sync butterflies, which give
// every lane the ray's sum.  So the sums run in a tree order, not the plain
// version's sequential one.  K7 makes one pass: the variance sum w (z - D)^2
// is a second butterfly over the registers (not sum w z^2 - D^2, which
// cancels).  A ray longer than L kRun samples walks tiles of L kRun, carrying
// T from tile to tile; K7 then reloads its tiles (raw and z, from L2) for the
// variance once D is known.
//
// K8.  With g_i = dL/dw_i (through rgb, depth and variance:
//   g_i = gc . c_i + gD z_i + gV ((z_i - D)^2 - 2 z_i M), M = sum w_k (z_k - D)),
// dL/da_i = T_i (g_i - R_i), R_i = sum_{k>i} g_k a_k prod_{i<j<k} f_j,
// kept by the reverse recurrence R_{i-1} = g_i a_i + f_i R_i.  Recovering
// T_i from T_{i+1} / f_i would divide by 1e-10 where sigmoid(10 o) rounds to
// 1 in float32 (o above about 1.7), so T comes from the same product scan as
// in K7, and R from a suffix scan (__shfl_down_sync) of the affine maps
// x -> b + f x, composed as (f, b) o (f', b') = (f f', b + f b'), with the
// carry from the blocks after: no division by f.  One load: T, M, g, R and
// the gradient come from the registers, and the gradient is written once.
// In the tiled path a first pass stores each tile's T carry in a scratch row
// of the ray (the wrapper's), and the reverse pass reloads each tile.
// relu's gradient at 0 is 0, as in JAX, and the gate is applied before the
// 1e10 interval enters a product, so no inf * 0 arises.  The one division
// is |d|'s gradient over |d|.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // 4 warps a CTA
constexpr int kRun = 4;        // blocks of L samples a lane holds (one tile)
constexpr float kLast = 1e10f;  // the last interval before the |d| scale
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float alpha_occ(float o) {
  return 1.f / (1.f + expf(-10.f * o));
}

// The sum of x over the group of L lanes, in every lane of it.
template <int L>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int d = L / 2; d > 0; d >>= 1) x += __shfl_xor_sync(kFull, x, d, L);
  return x;
}

// A tile of a ray in a lane's registers: its sample b L + k of each block b
// of the tile (k the lane), with alpha and f; samples past the ray (or of a
// ray past n) hold a = 0, f = 1.  Density mode also keeps e = exp(-relu(sigma)
// delta) and the unscaled interval.
template <int K>
struct Tile {
  float4 v[K];
  float z[K], a[K], f[K], e[K], len[K];
};

// Sample index of block j of tile t in lane k.
template <int L, int K>
__device__ __forceinline__ int sample(int t, int j, int k) {
  return (t * K + j) * L + k;
}

// Load tile t (its first nb blocks) of a ray and compute alpha and f.
// All loads are issued before the first use.
template <int L, int K, bool kOcc>
__device__ __forceinline__ void load_tile(Tile<K>& tl, const float4* rr, const float* zr,
                                          int s, int t, int nb, int k, bool live,
                                          float norm) {
#pragma unroll
  for (int j = 0; j < K; ++j) {
    tl.v[j] = make_float4(0.f, 0.f, 0.f, 0.f);
    tl.z[j] = 0.f;
    if (j < nb) {
      const int i = sample<L, K>(t, j, k);
      if (live && i < s) {
        tl.v[j] = rr[i];
        tl.z[j] = zr[i];
      }
    }
  }
#pragma unroll
  for (int j = 0; j < K; ++j) {
    tl.a[j] = 0.f;
    tl.f[j] = 1.f;
    tl.e[j] = 1.f;
    tl.len[j] = 0.f;
    if (j >= nb) continue;
    const int i = sample<L, K>(t, j, k);
    const bool in = live && i < s;
    if (kOcc) {
      if (in) tl.a[j] = alpha_occ(tl.v[j].w);
    } else {
      // z_{i+1}: the next lane's, or for the last lane the next block's first
      float zn = __shfl_down_sync(kFull, tl.z[j], 1, L);
      const float first = __shfl_sync(kFull, j + 1 < K ? tl.z[j + 1] : 0.f, 0, L);
      if (k == L - 1) zn = j + 1 < nb ? first : (in && i + 1 < s ? zr[i + 1] : 0.f);
      if (in) {
        tl.len[j] = i + 1 < s ? zn - tl.z[j] : kLast;
        tl.e[j] = expf(-fmaxf(tl.v[j].w, 0.f) * (tl.len[j] * norm));
        tl.a[j] = 1.f - tl.e[j];
      }
    }
    if (in) tl.f[j] = (1.f - tl.a[j]) + 1e-10f;
  }
}

// T of the tile's samples: each block's exclusive product scan of f over the
// group, times the carry (T at the block's first sample).  Returns the carry
// past the tile's last sample.
template <int L, int K>
__device__ __forceinline__ float transmit(const Tile<K>& tl, float (&T)[K], float carry,
                                          int nb, int k) {
  float p[K];
#pragma unroll
  for (int j = 0; j < K; ++j) p[j] = tl.f[j];
#pragma unroll
  for (int d = 1; d < L; d <<= 1) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      if (j >= nb) break;
      const float y = __shfl_up_sync(kFull, p[j], d, L);
      if (k >= d) p[j] *= y;
    }
  }
#pragma unroll
  for (int j = 0; j < K; ++j) {
    T[j] = 0.f;
    if (j >= nb) continue;
    const float ex = __shfl_up_sync(kFull, p[j], 1, L);
    const float all = __shfl_sync(kFull, p[j], L - 1, L);
    T[j] = k ? carry * ex : carry;
    carry *= all;
  }
  return carry;
}

// R of the tile's samples: each block's exclusive suffix scan of the maps
// x -> b + f x over the group, applied to the carry (R at the block's last
// sample), from the last block.  Returns the carry before the tile's first
// sample.
template <int L, int K>
__device__ __forceinline__ float reverse(const Tile<K>& tl, const float (&b)[K],
                                         float (&R)[K], float carry, int nb, int k) {
  float F[K], B[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    F[j] = tl.f[j];
    B[j] = b[j];
  }
#pragma unroll
  for (int d = 1; d < L; d <<= 1) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      if (j >= nb) break;
      const float fy = __shfl_down_sync(kFull, F[j], d, L);
      const float by = __shfl_down_sync(kFull, B[j], d, L);
      if (k + d < L) {
        B[j] = B[j] + F[j] * by;
        F[j] *= fy;
      }
    }
  }
#pragma unroll
  for (int j = K - 1; j >= 0; --j) {
    R[j] = 0.f;
    if (j >= nb) continue;
    const float fe = __shfl_down_sync(kFull, F[j], 1, L);
    const float be = __shfl_down_sync(kFull, B[j], 1, L);
    const float f0 = __shfl_sync(kFull, F[j], 0, L);
    const float b0 = __shfl_sync(kFull, B[j], 0, L);
    R[j] = k == L - 1 ? carry : be + fe * carry;
    carry = b0 + f0 * carry;
  }
  return carry;
}

__device__ __forceinline__ float ray_norm(const float* rays_d, int r) {
  const float dx = rays_d[3 * r], dy = rays_d[3 * r + 1], dz = rays_d[3 * r + 2];
  return sqrtf(dx * dx + dy * dy + dz * dz);
}

template <int L, int K, bool kOcc>
__global__ void __launch_bounds__(kThreads)
integrate_fwd_kernel(const float4* __restrict__ raw, const float* __restrict__ z,
                     const float* __restrict__ rays_d, int n, int s,
                     float* __restrict__ depth, float* __restrict__ var,
                     float* __restrict__ rgb, float* __restrict__ weights) {
  const int k = threadIdx.x & (L - 1);
  const int r = (int)(((long long)blockIdx.x * kThreads + threadIdx.x) / L);
  const bool live = r < n;  // a lane past n still takes part in the shuffles
  const int blocks = (s + L - 1) / L;
  const int tiles = (blocks + K - 1) / K;
  const float4* rr = raw + (size_t)r * s;
  const float* zr = z + (size_t)r * s;
  float* wr = weights + (size_t)r * s;
  const float norm = !kOcc && live ? ray_norm(rays_d, r) : 0.f;
  Tile<K> tl;
  float T[K], w[K];
  float carry = 1.f, d = 0.f, c0 = 0.f, c1 = 0.f, c2 = 0.f;
  for (int t = 0; t < tiles; ++t) {
    const int nb = min(K, blocks - t * K);
    load_tile<L, K, kOcc>(tl, rr, zr, s, t, nb, k, live, norm);
    carry = transmit<L, K>(tl, T, carry, nb, k);
#pragma unroll
    for (int j = 0; j < K; ++j) {
      w[j] = tl.a[j] * T[j];
      if (j >= nb) continue;
      const int i = sample<L, K>(t, j, k);
      if (live && i < s) wr[i] = w[j];
      c0 += w[j] * tl.v[j].x;
      c1 += w[j] * tl.v[j].y;
      c2 += w[j] * tl.v[j].z;
      d += w[j] * tl.z[j];
    }
  }
  d = group_sum<L>(d);
  float vs = 0.f;
  if (tiles == 1) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const float e = tl.z[j] - d;
      vs += w[j] * e * e;  // w = 0 past the ray
    }
  } else {  // the tiles again, from L2: T from the first tile on
    carry = 1.f;
    for (int t = 0; t < tiles; ++t) {
      const int nb = min(K, blocks - t * K);
      load_tile<L, K, kOcc>(tl, rr, zr, s, t, nb, k, live, norm);
      carry = transmit<L, K>(tl, T, carry, nb, k);
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const float e = tl.z[j] - d;
        vs += (tl.a[j] * T[j]) * e * e;
      }
    }
  }
  vs = group_sum<L>(vs);
  c0 = group_sum<L>(c0);
  c1 = group_sum<L>(c1);
  c2 = group_sum<L>(c2);
  if (live && k == 0) {
    depth[r] = d;
    var[r] = vs;
    rgb[3 * r] = c0;
    rgb[3 * r + 1] = c1;
    rgb[3 * r + 2] = c2;
  }
}

// gdep, gvar (N) and grgb (N, 3): the outputs' cotangents; graw (N, S, 4)
// the raw gradient; gd (N, 3) the rays_d gradient (density mode; null: not
// wanted); tc (N, tiles) each tile's T carry (the tiled path; else null).
template <int L, int K, bool kOcc>
__global__ void __launch_bounds__(kThreads)
integrate_bwd_kernel(const float4* __restrict__ raw, const float* __restrict__ z,
                     const float* __restrict__ rays_d, const float* __restrict__ depth,
                     const float* __restrict__ gdep, const float* __restrict__ gvar,
                     const float* __restrict__ grgb, int n, int s,
                     float4* __restrict__ graw, float* __restrict__ gd,
                     float* __restrict__ tc) {
  const int k = threadIdx.x & (L - 1);
  const int r = (int)(((long long)blockIdx.x * kThreads + threadIdx.x) / L);
  const bool live = r < n;
  const int blocks = (s + L - 1) / L;
  const int tiles = (blocks + K - 1) / K;
  const float4* rr = raw + (size_t)r * s;
  const float* zr = z + (size_t)r * s;
  float4* gr = graw + (size_t)r * s;
  float* tr = tc + (size_t)r * tiles;
  const float norm = !kOcc && live ? ray_norm(rays_d, r) : 0.f;
  float D = 0.f, gD = 0.f, gV = 0.f, g0 = 0.f, g1 = 0.f, g2 = 0.f;
  if (live) {
    D = depth[r];
    gD = gdep[r];
    gV = gvar[r];
    g0 = grgb[3 * r];
    g1 = grgb[3 * r + 1];
    g2 = grgb[3 * r + 2];
  }
  Tile<K> tl;
  float T[K];
  // M = sum w (z - D), and in the tiled path each tile's T carry
  float carry = 1.f, m = 0.f;
  for (int t = 0; t < tiles; ++t) {
    const int nb = min(K, blocks - t * K);
    load_tile<L, K, kOcc>(tl, rr, zr, s, t, nb, k, live, norm);
    if (tiles > 1 && live && k == 0) tr[t] = carry;
    carry = transmit<L, K>(tl, T, carry, nb, k);
#pragma unroll
    for (int j = 0; j < K; ++j) m += (tl.a[j] * T[j]) * (tl.z[j] - D);
  }
  m = group_sum<L>(m);
  // g, R and the gradients, from the last tile (one tile: still in registers)
  float Rc = 0.f, gnorm = 0.f;
  for (int t = tiles - 1; t >= 0; --t) {
    const int nb = min(K, blocks - t * K);
    if (tiles > 1) {
      load_tile<L, K, kOcc>(tl, rr, zr, s, t, nb, k, live, norm);
      const float c = __shfl_sync(kFull, live && k == 0 ? tr[t] : 0.f, 0, L);
      transmit<L, K>(tl, T, c, nb, k);
    }
    float g[K], b[K], R[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const float ez = tl.z[j] - D;
      g[j] = g0 * tl.v[j].x + g1 * tl.v[j].y + g2 * tl.v[j].z + gD * tl.z[j]
             + gV * (ez * ez - 2.f * tl.z[j] * m);
      b[j] = g[j] * tl.a[j];
    }
    Rc = reverse<L, K>(tl, b, R, Rc, nb, k);
#pragma unroll
    for (int j = 0; j < K; ++j) {
      if (j >= nb) continue;
      const int i = sample<L, K>(t, j, k);
      const float a = tl.a[j];
      const float w = a * T[j];
      const float da = T[j] * (g[j] - R[j]);
      float dsig;
      if (kOcc) {
        dsig = da * 10.f * a * (1.f - a);
      } else if (tl.v[j].w > 0.f) {
        dsig = da * tl.e[j] * (tl.len[j] * norm);
        gnorm += da * tl.e[j] * tl.v[j].w * tl.len[j];
      } else {
        dsig = 0.f;
      }
      if (live && i < s) gr[i] = make_float4(w * g0, w * g1, w * g2, dsig);
    }
  }
  if (!kOcc && gd != nullptr) {
    gnorm = group_sum<L>(gnorm);
    if (live && k == 0) {
      const float q = gnorm / norm;
      gd[3 * r] = q * rays_d[3 * r];
      gd[3 * r + 1] = q * rays_d[3 * r + 1];
      gd[3 * r + 2] = q * rays_d[3 * r + 2];
    }
  }
}

// K7's and K8's instance at `lanes` lanes per ray (16, else 32) in one mode.
template <bool kOcc>
auto fwd_kernel(int lanes) {
  return lanes == 16 ? integrate_fwd_kernel<16, kRun, kOcc> : integrate_fwd_kernel<32, kRun, kOcc>;
}

template <bool kOcc>
auto bwd_kernel(int lanes) {
  return lanes == 16 ? integrate_bwd_kernel<16, kRun, kOcc> : integrate_bwd_kernel<32, kRun, kOcc>;
}

// The launch's checks: a lane count with an instance and CTAs that cover
// the rays.
bool valid(int n, int s, int lanes, int ctas) {
  return n >= 1 && s >= 1 && (lanes == 16 || lanes == 32) &&
         (long long)ctas * (kThreads / lanes) >= n;
}

}  // namespace

extern "C" {

// K7: raw (n, s, 4), z (n, s), rays_d (n, 3) -> depth, var (n), rgb (n, 3),
// weights (n, s).  occ: occupancy mode (rays_d unread).  lanes per ray and
// ctas from ops/integrator.py integrate_geometry.
int integrate_fwd(const float* raw, const float* z, const float* rays_d, int n, int s,
                  int occ, int lanes, int ctas, float* depth, float* var, float* rgb,
                  float* weights, void* stream) {
  if (!valid(n, s, lanes, ctas)) return (int)cudaErrorInvalidValue;
  const auto kernel = occ ? fwd_kernel<true>(lanes) : fwd_kernel<false>(lanes);
  kernel<<<ctas, kThreads, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(raw), z, rays_d, n, s, depth, var, rgb, weights);
  return (int)cudaGetLastError();
}

// K8: the cotangents of depth, var (n) and rgb (n, 3) -> graw (n, s, 4) and,
// in density mode where gd is not null, the rays_d gradient gd (n, 3).  tc:
// (n, tiles) floats of scratch where s > lanes * kRun (the tiled path), else
// null.
int integrate_bwd(const float* raw, const float* z, const float* rays_d,
                  const float* depth, const float* gdep, const float* gvar,
                  const float* grgb, int n, int s, int occ, int lanes, int ctas,
                  float* graw, float* gd, float* tc, void* stream) {
  if (!valid(n, s, lanes, ctas) || (s > lanes * kRun && tc == nullptr))
    return (int)cudaErrorInvalidValue;
  const auto kernel = occ ? bwd_kernel<true>(lanes) : bwd_kernel<false>(lanes);
  kernel<<<ctas, kThreads, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(raw), z, rays_d, depth, gdep, gvar, grgb, n, s,
      reinterpret_cast<float4*>(graw), gd, tc);
  return (int)cudaGetLastError();
}

// K7's (or K8's) resources at `lanes` lanes per ray in one mode into out[5]:
// registers, local (spill) bytes, threads per CTA, resident CTAs per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor) and the blocks a lane holds
// (kRun).
int integrate_info(int bwd, int occ, int lanes, int* out) {
  if (lanes != 16 && lanes != 32) return (int)cudaErrorInvalidValue;
  const void* f = bwd ? (occ ? (const void*)bwd_kernel<true>(lanes)
                             : (const void*)bwd_kernel<false>(lanes))
                      : (occ ? (const void*)fwd_kernel<true>(lanes)
                             : (const void*)fwd_kernel<false>(lanes));
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
  out[4] = kRun;
  return 0;
}

}  // extern "C"
