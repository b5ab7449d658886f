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
// last interval 1e10 |d|.  T_0 = 1, T_{i+1} = T_i (1 - a_i + 1e-10),
// w_i = a_i T_i, D = sum w z, V = sum w (z - D)^2, rgb = sum w c.
//
// The design is the simple one: a thread per ray, which walks its samples
// in order, so the products and sums run in the plain version's order
// (sequential here, torch.cumprod's on the CPU).  Bound by bytes: a ray
// reads 20 bytes a sample and writes 4 (K7) or 16 (K8).  A thread loads
// its samples kBatch at a time (128 contiguous bytes of raw) before it
// uses them: loaded one at a time, a 48-sample ray was 48 memory round
// trips in a row, 27 us at tracking's 200 rays (PERF.md).  At tracking
// the launch is 2 CTAs, so most SMs idle; a warp per ray with shuffled
// product scans would fill the card at small N and is left for a later
// change.
//
// K8.  With g_i = dL/dw_i (through rgb, depth and variance:
//   g_i = gc . c_i + gD z_i + gV ((z_i - D)^2 - 2 z_i M), M = sum w_k (z_k - D)),
// dL/da_i = T_i (g_i - R_i), R_i = sum_{k>i} g_k a_k prod_{i<j<k} f_j,
// f_j = 1 - a_j + 1e-10, kept by the reverse recurrence
// R_{i-1} = g_i a_i + f_i R_i.  Recovering T_i from T_{i+1} / f_i would
// divide by 1e-10 where sigmoid(10 o) rounds to 1 in float32 (o above
// about 1.7), so a first forward pass stores T_i in the sigma slot of the
// raw gradient (the thread's own memory) and the reverse pass reads it
// back before it overwrites it.  relu's gradient at 0 is 0, as in JAX, and
// the gate is applied before the 1e10 interval enters a product, so no
// inf * 0 arises.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // rays per CTA
constexpr int kBatch = 8;      // samples a thread loads at once
constexpr float kLast = 1e10f;  // the last interval before the |d| scale

__device__ __forceinline__ float alpha_occ(float o) {
  return 1.f / (1.f + expf(-10.f * o));
}

// A batch of kBatch samples of a ray in registers: raw, z, and the next
// sample's z (the batch's last interval).  Loading a batch before using
// it keeps kBatch loads of a thread in flight instead of one.
struct Batch {
  float4 v[kBatch];
  float z[kBatch + 1];
};

__device__ __forceinline__ void load(Batch& b, const float4* rr, const float* zr, int i0,
                                     int s) {
#pragma unroll
  for (int j = 0; j < kBatch; ++j) {
    const bool in = i0 + j < s;
    b.v[j] = in ? rr[i0 + j] : make_float4(0.f, 0.f, 0.f, 0.f);
    b.z[j] = in ? zr[i0 + j] : 0.f;
  }
  b.z[kBatch] = i0 + kBatch < s ? zr[i0 + kBatch] : 0.f;
}

// sample i0 + j's interval before the |d| scale: z_{i+1} - z_i, 1e10 last
__device__ __forceinline__ float interval(const Batch& b, int j, int i, int s) {
  return i + 1 < s ? b.z[j + 1] - b.z[j] : kLast;
}

template <bool kOcc>
__device__ __forceinline__ float alpha(const Batch& b, int j, int i, int s, float norm) {
  if (kOcc) return alpha_occ(b.v[j].w);
  return 1.f - expf(-fmaxf(b.v[j].w, 0.f) * (interval(b, j, i, s) * norm));
}

template <bool kOcc>
__global__ void __launch_bounds__(kThreads)
integrate_fwd_kernel(const float4* __restrict__ raw, const float* __restrict__ z,
                     const float* __restrict__ rays_d, int n, int s,
                     float* __restrict__ depth, float* __restrict__ var,
                     float* __restrict__ rgb, float* __restrict__ weights) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= n) return;
  const float4* rr = raw + (size_t)r * s;
  const float* zr = z + (size_t)r * s;
  float* wr = weights + (size_t)r * s;
  float norm = 0.f;
  if (!kOcc) {
    const float dx = rays_d[3 * r], dy = rays_d[3 * r + 1], dz = rays_d[3 * r + 2];
    norm = sqrtf(dx * dx + dy * dy + dz * dz);
  }
  float t = 1.f, d = 0.f, c0 = 0.f, c1 = 0.f, c2 = 0.f;
  Batch b;
  for (int i0 = 0; i0 < s; i0 += kBatch) {
    load(b, rr, zr, i0, s);
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = i0 + j;
      if (i >= s) break;
      const float a = alpha<kOcc>(b, j, i, s, norm);
      const float w = a * t;
      wr[i] = w;
      c0 += w * b.v[j].x;
      c1 += w * b.v[j].y;
      c2 += w * b.v[j].z;
      d += w * b.z[j];
      t *= (1.f - a) + 1e-10f;
    }
  }
  float vs = 0.f;
  for (int i0 = 0; i0 < s; i0 += kBatch) {
    float w[kBatch], e[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const bool in = i0 + j < s;
      w[j] = in ? wr[i0 + j] : 0.f;
      e[j] = in ? zr[i0 + j] - d : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      if (i0 + j >= s) break;
      vs += w[j] * e[j] * e[j];
    }
  }
  depth[r] = d;
  var[r] = vs;
  rgb[3 * r] = c0;
  rgb[3 * r + 1] = c1;
  rgb[3 * r + 2] = c2;
}

// gdep, gvar (N) and grgb (N, 3): the outputs' cotangents; graw (N, S, 4)
// the raw gradient; gd (N, 3) the rays_d gradient (density mode; null: not
// wanted).
template <bool kOcc>
__global__ void __launch_bounds__(kThreads)
integrate_bwd_kernel(const float4* __restrict__ raw, const float* __restrict__ z,
                     const float* __restrict__ rays_d, const float* __restrict__ depth,
                     const float* __restrict__ gdep, const float* __restrict__ gvar,
                     const float* __restrict__ grgb, int n, int s,
                     float4* __restrict__ graw, float* __restrict__ gd) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= n) return;
  const float4* rr = raw + (size_t)r * s;
  const float* zr = z + (size_t)r * s;
  float4* gr = graw + (size_t)r * s;
  float norm = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  if (!kOcc) {
    dx = rays_d[3 * r];
    dy = rays_d[3 * r + 1];
    dz = rays_d[3 * r + 2];
    norm = sqrtf(dx * dx + dy * dy + dz * dz);
  }
  const float D = depth[r];
  // forward again: T_i into the sigma slot, M = sum w (z - D)
  float t = 1.f, m = 0.f;
  Batch b;
  for (int i0 = 0; i0 < s; i0 += kBatch) {
    load(b, rr, zr, i0, s);
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = i0 + j;
      if (i >= s) break;
      const float a = alpha<kOcc>(b, j, i, s, norm);
      gr[i].w = t;
      m += (a * t) * (b.z[j] - D);
      t *= (1.f - a) + 1e-10f;
    }
  }
  const float gD = gdep[r], gV = gvar[r];
  const float g0 = grgb[3 * r], g1 = grgb[3 * r + 1], g2 = grgb[3 * r + 2];
  float R = 0.f, gnorm = 0.f;
  // backward, batch by batch from the last
  for (int i0 = (s - 1) / kBatch * kBatch; i0 >= 0; i0 -= kBatch) {
    load(b, rr, zr, i0, s);
    float ts[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) ts[j] = i0 + j < s ? gr[i0 + j].w : 0.f;
#pragma unroll
    for (int j = kBatch - 1; j >= 0; --j) {
      const int i = i0 + j;
      if (i >= s) continue;
      const float4 v = b.v[j];
      const float ti = ts[j];
      const float zi = b.z[j];
      float a, e = 0.f, len = 0.f;
      if (kOcc) {
        a = alpha_occ(v.w);
      } else {
        len = interval(b, j, i, s);
        e = expf(-fmaxf(v.w, 0.f) * (len * norm));
        a = 1.f - e;
      }
      const float w = a * ti;
      const float ez = zi - D;
      const float g = g0 * v.x + g1 * v.y + g2 * v.z + gD * zi
                      + gV * (ez * ez - 2.f * zi * m);
      const float da = ti * (g - R);
      R = g * a + ((1.f - a) + 1e-10f) * R;
      float dsig;
      if (kOcc) {
        dsig = da * 10.f * a * (1.f - a);
      } else if (v.w > 0.f) {
        dsig = da * e * (len * norm);
        gnorm += da * e * v.w * len;
      } else {
        dsig = 0.f;
      }
      gr[i] = make_float4(w * g0, w * g1, w * g2, dsig);
    }
  }
  if (!kOcc && gd != nullptr) {
    const float k = gnorm / norm;
    gd[3 * r] = k * dx;
    gd[3 * r + 1] = k * dy;
    gd[3 * r + 2] = k * dz;
  }
}

int ctas(int n) { return (n + kThreads - 1) / kThreads; }

}  // namespace

extern "C" {

// K7: raw (n, s, 4), z (n, s), rays_d (n, 3) -> depth, var (n), rgb (n, 3),
// weights (n, s).  occ: occupancy mode (rays_d unread).
int integrate_fwd(const float* raw, const float* z, const float* rays_d, int n, int s,
                  int occ, float* depth, float* var, float* rgb, float* weights,
                  void* stream) {
  if (n < 1 || s < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const float4* r4 = reinterpret_cast<const float4*>(raw);
  if (occ)
    integrate_fwd_kernel<true><<<ctas(n), kThreads, 0, st>>>(r4, z, rays_d, n, s, depth,
                                                             var, rgb, weights);
  else
    integrate_fwd_kernel<false><<<ctas(n), kThreads, 0, st>>>(r4, z, rays_d, n, s, depth,
                                                              var, rgb, weights);
  return (int)cudaGetLastError();
}

// K8: the cotangents of depth, var (n) and rgb (n, 3) -> graw (n, s, 4) and,
// in density mode where gd is not null, the rays_d gradient gd (n, 3).
int integrate_bwd(const float* raw, const float* z, const float* rays_d,
                  const float* depth, const float* gdep, const float* gvar,
                  const float* grgb, int n, int s, int occ, float* graw, float* gd,
                  void* stream) {
  if (n < 1 || s < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const float4* r4 = reinterpret_cast<const float4*>(raw);
  float4* g4 = reinterpret_cast<float4*>(graw);
  if (occ)
    integrate_bwd_kernel<true><<<ctas(n), kThreads, 0, st>>>(
        r4, z, rays_d, depth, gdep, gvar, grgb, n, s, g4, gd);
  else
    integrate_bwd_kernel<false><<<ctas(n), kThreads, 0, st>>>(
        r4, z, rays_d, depth, gdep, gvar, grgb, n, s, g4, gd);
  return (int)cudaGetLastError();
}

// K7's and K8's resources into out[3]: registers, local (spill) bytes and
// threads per CTA, for occupancy mode (occ) or density mode.
int integrate_info(int bwd, int occ, int* out) {
  cudaFuncAttributes a;
  cudaError_t e;
  if (bwd)
    e = occ ? cudaFuncGetAttributes(&a, integrate_bwd_kernel<true>)
            : cudaFuncGetAttributes(&a, integrate_bwd_kernel<false>);
  else
    e = occ ? cudaFuncGetAttributes(&a, integrate_fwd_kernel<true>)
            : cudaFuncGetAttributes(&a, integrate_fwd_kernel<false>);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = kThreads;
  return 0;
}

}  // extern "C"
