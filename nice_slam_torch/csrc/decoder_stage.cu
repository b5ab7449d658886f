// The NICE decoder stage, for Hopper (sm_90a): the forward, the backward
// and a deterministic weight-gradient sum of 1-3 grid decoders over the
// same points.
//
// Replaces the JAX package's decoder device code (its models/decoders.py):
//   K4 decoder_fwd        <- apply_nice_stage_batched (:371; the fine and
//                            color stages), apply_mlp (:250; the middle
//                            stage, and one decoder alone) and
//                            apply_mlp_no_xyz (:298; the coarse decoder)
//   K5 decoder_bwd        <- their gradients (XLA's autodiff of the same
//                            functions)
//   K6 decoder_wgrad_sum  <- the cross-point sum of the weight gradient in
//                            that autodiff
//
// Per decoder (one packed f32 buffer, nice_slam_torch/ops/decoder_stage.py
// `layout`): the lead input, the Fourier embedding sin(p @ B) with B
// (3, 93) or the coarse decoder's grid feature; five 32-wide blocks
// h = relu(x W_k + b_k) [+ f Wc_k + bc_k], where f is the decoder's grid
// feature (fine: [fine, middle], the middle half detached) and after block
// 2 the input is [lead, h]; a head 32 -> 1 (occupancy) or 4 (rgb + occ).
// The output (N, 4) composes the heads: occupancy heads add into column 3
// (occ = middle + fine residual), a color head writes rgb (and, with occ3,
// adds its own occupancy).  Everything is f32 with FMA: no TF32.
//
// What bounds it: operations.  One color-stage point is 51,653 MAC (middle
// 15,479, fine 20,599, color 15,575) against 4 x 4 + 3 x 32 x 4 bytes of
// output and features, so at the main path's sizes the f32 FMA rate
// (67 TFLOP/s) is the bound, well above HBM's; the weights (about 21k
// floats per decoder) are read by every CTA from L1/L2.
//
// Design (the first right one; tensor cores are a later step):
//  * one thread per point, a CTA a tile of T = 64 points; the thread runs
//    every decoder of the call on its point in turn.  A block's 32 outputs
//    live in registers; its inputs are per-thread columns of shared memory
//    (column i of thread t at [i * TS + t], TS = T + 1: odd, so a warp's
//    own-column accesses and a CTA reduction's row reads are both free of
//    bank conflicts).  The weights are read with __ldg as 16-byte loads
//    that every lane of a warp shares (one broadcast transaction from L1);
//  * K5 recomputes the forward instead of reading saved activations: the
//    inference paths (mesh, render) then write nothing extra, the autograd
//    Function saves only its inputs, and the recompute is a third of the
//    backward's work.  The relu masks stay in registers (a 32-bit word per
//    block).  A decoder that does not train needs no activation of another
//    point: its backward is a per-thread chain (dh -> dz -> dx).  A decoder
//    that trains writes its blocks' outputs to a per-CTA global scratch and
//    forms each weight gradient as a CTA reduction over the tile's points
//    (dW_k = X_k^T dZ_k, dWc_k = F^T dH_k, dB = P^T dA, and the bias sums);
//  * where a decoder trains, K5 runs at most two CTAs per SM, each walking
//    its tiles in a fixed order and adding each tile's sums into its own row
//    of partials; K6 sums the rows in a fixed order.  The weight gradient
//    is therefore bit-identical from run to run on one card (K2, the grid
//    gradient, sums with atomics and is not).
//
// Every kernel launches on the caller's stream and returns
// cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int H = 32;       // hidden width
constexpr int NB = 5;       // blocks
constexpr int SKIP = 2;     // after block SKIP the input is [lead, h]
constexpr int EMB = 93;     // Fourier embedding width
constexpr int T = 64;       // points (threads) per CTA
constexpr int TS = T + 1;   // shared column stride
constexpr int kMaxDec = 3;
constexpr int kDesc = 9;    // long longs per decoder in the descriptor table
constexpr int kMaxC = 32;   // feature width

struct Dec {
  const float* w;   // packed weights
  float* part;      // K5: this decoder's weight-gradient partials [grid][count], or null
  const float* fp;  // primary feature (N, c)
  const float* fs;  // secondary (detached) feature (N, c), or null
  float* dfp;       // K5: gradient of the primary feature, or null
  int emb, fw, out, occ3, lead;
  int oW[NB], ob, oWc, obc, oWo, obo, oB, count;
};

struct Launch {
  Dec d[kMaxDec];
  int n_dec, c, n;
  int lm, fm;       // widest lead and feature-injection input
  int dlead, train; // K5: some decoder needs the lead's gradient / trains
};

__host__ __device__ inline int in_rows(const Dec& d, int k) {
  return k == 0 ? d.lead : (k == SKIP + 1 ? d.lead + H : H);
}

// the packed buffer: W_0..W_4, b_0..b_4, Wc_0..Wc_4, bc_0..bc_4, W_o, b_o, B
// (decoder_stage.py `layout`); every W row is 32 floats at a multiple of 4
void layout(Dec& d) {
  int o = 0;
  for (int k = 0; k < NB; ++k) {
    d.oW[k] = o;
    o += in_rows(d, k) * H;
  }
  d.ob = o;
  o += NB * H;
  d.oWc = o;
  o += NB * d.fw * H;
  d.obc = o;
  o += d.fw ? NB * H : 0;
  d.oWo = o;
  o += H * d.out;
  d.obo = o;
  o += d.out;
  d.oB = o;
  o += d.emb ? 3 * EMB : 0;
  d.count = o;
}

// acc[j] += sum_i xs[i * TS] * W[i * H + j], i < K
__device__ __forceinline__ void gemv(float (&acc)[H], const float* xs, int K,
                                     const float* __restrict__ W) {
#pragma unroll 2
  for (int i = 0; i < K; ++i) {
    const float x = xs[i * TS];
    const float4* w = reinterpret_cast<const float4*>(W + i * H);
#pragma unroll
    for (int q = 0; q < H / 4; ++q) {
      const float4 v = __ldg(w + q);
      acc[4 * q] = fmaf(x, v.x, acc[4 * q]);
      acc[4 * q + 1] = fmaf(x, v.y, acc[4 * q + 1]);
      acc[4 * q + 2] = fmaf(x, v.z, acc[4 * q + 2]);
      acc[4 * q + 3] = fmaf(x, v.w, acc[4 * q + 3]);
    }
  }
}

// sum_j W[j] * v[j], j < H (one weight row against a register vector)
__device__ __forceinline__ float dot_row(const float* __restrict__ W, const float (&v)[H]) {
  const float4* w = reinterpret_cast<const float4*>(W);
  float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int q = 0; q < H / 4; ++q) {
    const float4 a = __ldg(w + q);
    s[0] = fmaf(a.x, v[4 * q], s[0]);
    s[1] = fmaf(a.y, v[4 * q + 1], s[1]);
    s[2] = fmaf(a.z, v[4 * q + 2], s[2]);
    s[3] = fmaf(a.w, v[4 * q + 3], s[3]);
  }
  return (s[0] + s[1]) + (s[2] + s[3]);
}

// One decoder's forward on thread t's point.  lead_s, f_s, h_s: the
// thread's shared columns.  Leaves the head in o[0..out), the relu masks in
// mask, and (hs non-null) block k's output j at hs[(k * H + j) * T].
__device__ __forceinline__ void forward_point(const Dec& d, int c, int n, bool valid,
                                              float p0, float p1, float p2,
                                              float* lead_s, float* f_s, float* h_s,
                                              unsigned (&mask)[NB], float* hs,
                                              float (&o)[4]) {
  const float* __restrict__ w = d.w;
  if (d.emb) {
    const float* __restrict__ B = w + d.oB;
    for (int i = 0; i < EMB; ++i)
      lead_s[i * TS] = sinf(fmaf(p2, __ldg(B + 2 * EMB + i),
                                 fmaf(p1, __ldg(B + EMB + i), p0 * __ldg(B + i))));
  } else {
    for (int i = 0; i < c; ++i) lead_s[i * TS] = valid ? d.fp[(size_t)n * c + i] : 0.f;
  }
  if (d.fw) {
    for (int i = 0; i < c; ++i) f_s[i * TS] = valid ? d.fp[(size_t)n * c + i] : 0.f;
    if (d.fw > c)
      for (int i = 0; i < c; ++i) f_s[(c + i) * TS] = valid ? d.fs[(size_t)n * c + i] : 0.f;
  }
  float acc[H];
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    const float* __restrict__ W = w + d.oW[k];
    const float* __restrict__ b = w + d.ob + k * H;
#pragma unroll
    for (int j = 0; j < H; ++j) acc[j] = __ldg(b + j);
    const int lead_in = (k == 0 || k == SKIP + 1) ? d.lead : 0;
    if (lead_in) gemv(acc, lead_s, lead_in, W);
    if (k > 0) gemv(acc, h_s, H, W + lead_in * H);
    unsigned m = 0u;
#pragma unroll
    for (int j = 0; j < H; ++j) {
      if (acc[j] > 0.f) m |= 1u << j;
      acc[j] = fmaxf(acc[j], 0.f);
    }
    mask[k] = m;
    if (d.fw) {
      float inj[H];
      const float* __restrict__ bc = w + d.obc + k * H;
#pragma unroll
      for (int j = 0; j < H; ++j) inj[j] = __ldg(bc + j);
      gemv(inj, f_s, d.fw, w + d.oWc + k * d.fw * H);
#pragma unroll
      for (int j = 0; j < H; ++j) acc[j] += inj[j];
    }
#pragma unroll
    for (int j = 0; j < H; ++j) h_s[j * TS] = acc[j];
    if (hs)
#pragma unroll
      for (int j = 0; j < H; ++j) hs[(k * H + j) * T] = acc[j];
  }
  const float* __restrict__ Wo = w + d.oWo;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    float s = 0.f;
    if (q < d.out) {
      s = __ldg(w + d.obo + q);
#pragma unroll
      for (int j = 0; j < H; ++j) s = fmaf(acc[j], __ldg(Wo + j * d.out + q), s);
    }
    o[q] = s;
  }
}

__global__ void __launch_bounds__(T) decoder_fwd_kernel(const Launch L,
                                                        const float* __restrict__ p,
                                                        float4* __restrict__ out) {
  extern __shared__ float sm[];
  const int t = threadIdx.x;
  const int n = blockIdx.x * T + t;
  const bool valid = n < L.n;
  float* lead_s = sm + t;
  float* f_s = lead_s + L.lm * TS;
  float* h_s = f_s + L.fm * TS;
  const float p0 = valid ? p[3 * n] : 0.f, p1 = valid ? p[3 * n + 1] : 0.f,
              p2 = valid ? p[3 * n + 2] : 0.f;
  float res[4] = {0.f, 0.f, 0.f, 0.f};
  for (int di = 0; di < L.n_dec; ++di) {
    const Dec& d = L.d[di];
    unsigned mask[NB];
    float o[4];
    forward_point(d, L.c, n, valid, p0, p1, p2, lead_s, f_s, h_s, mask, nullptr, o);
    if (d.out == 1) {
      res[3] += o[0];
    } else {
      res[0] = o[0];
      res[1] = o[1];
      res[2] = o[2];
      if (d.occ3) res[3] += o[3];
    }
  }
  if (valid) out[n] = make_float4(res[0], res[1], res[2], res[3]);
}

// A CTA reduction over the tile's T points into this CTA's row of
// partials: out[r * J + j] (= on the CTA's first tile, += after)
// sum_t A[r * as + t] * Bm[j * TS + t], r < R, j < J.  A is shared (as = TS)
// or the CTA's global scratch (as = T); Bm is shared.  Each output belongs
// to one thread, which sums its T products in a fixed order.
__device__ void cta_dot(float* out, bool first, const float* A, int as, int R,
                        const float* Bm, int J) {
  for (int o = threadIdx.x; o < R * J; o += T) {
    const int r = o / J, j = o - r * J;
    const float* a = A + r * as;
    const float* b = Bm + j * TS;
    float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll 4
    for (int u = 0; u < T; u += 4) {
      s0 = fmaf(a[u], b[u], s0);
      s1 = fmaf(a[u + 1], b[u + 1], s1);
      s2 = fmaf(a[u + 2], b[u + 2], s2);
      s3 = fmaf(a[u + 3], b[u + 3], s3);
    }
    const float s = (s0 + s1) + (s2 + s3);
    out[o] = first ? s : out[o] + s;
  }
}

// out[j] (= or +=) sum_t Bm[j * TS + t], j < J
__device__ void cta_sum(float* out, bool first, const float* Bm, int J) {
  for (int j = threadIdx.x; j < J; j += T) {
    const float* b = Bm + j * TS;
    float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
    for (int u = 0; u < T; u += 4) {
      s0 += b[u];
      s1 += b[u + 1];
      s2 += b[u + 2];
      s3 += b[u + 3];
    }
    const float s = (s0 + s1) + (s2 + s3);
    out[j] = first ? s : out[j] + s;
  }
}

// shared floats of K5 per column: lead, feature, hidden, [lead gradient],
// feature gradient, [dz, dh, head cotangent, points]
__host__ __device__ inline int bwd_columns(const Launch& L) {
  return L.lm + L.fm + H + (L.dlead ? L.lm : 0) + (L.fm ? L.c : 0) +
         (L.train ? 2 * H + 4 + 3 : 0);
}

__global__ void __launch_bounds__(T) decoder_bwd_kernel(const Launch L,
                                                        const float* __restrict__ p,
                                                        const float* __restrict__ g,
                                                        float* __restrict__ dp,
                                                        float* hsave, int tiles) {
  extern __shared__ float sm[];
  const int t = threadIdx.x;
  float* lead_b = sm;
  float* f_b = lead_b + L.lm * TS;
  float* h_b = f_b + L.fm * TS;
  float* dlead_b = h_b + H * TS;
  float* df_b = dlead_b + (L.dlead ? L.lm : 0) * TS;
  float* dz_b = df_b + (L.fm ? L.c : 0) * TS;
  float* dh_b = dz_b + H * TS;
  float* dout_b = dh_b + H * TS;
  float* p_b = dout_b + 4 * TS;
  float* hs_cta = L.train ? hsave + (size_t)blockIdx.x * NB * H * T : nullptr;
  const int c = L.c;

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const bool first = tile == (int)blockIdx.x;
    const int n = tile * T + t;
    const bool valid = n < L.n;
    const float p0 = valid ? p[3 * n] : 0.f, p1 = valid ? p[3 * n + 1] : 0.f,
                p2 = valid ? p[3 * n + 2] : 0.f;
    float gc[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) gc[q] = valid ? g[4 * n + q] : 0.f;
    float dp0 = 0.f, dp1 = 0.f, dp2 = 0.f;

    for (int di = 0; di < L.n_dec; ++di) {
      const Dec& d = L.d[di];
      const float* __restrict__ w = d.w;
      const bool train = d.part != nullptr;
      const bool want_lead = d.emb ? (dp != nullptr || train) : d.dfp != nullptr;
      if (!train && !want_lead && !d.dfp) continue;
      __syncthreads();  // the shared columns' earlier readers are done
      unsigned mask[NB];
      float o[4];
      forward_point(d, c, n, valid, p0, p1, p2, lead_b + t, f_b + t, h_b + t, mask,
                    train ? hs_cta + t : nullptr, o);
      float dout[4] = {0.f, 0.f, 0.f, 0.f};
      if (d.out == 1) {
        dout[0] = gc[3];
      } else {
        dout[0] = gc[0];
        dout[1] = gc[1];
        dout[2] = gc[2];
        dout[3] = d.occ3 ? gc[3] : 0.f;
      }
      float* part = train ? d.part + (size_t)blockIdx.x * d.count : nullptr;
      if (train) {
        for (int q = 0; q < d.out; ++q) dout_b[q * TS + t] = dout[q];
        p_b[t] = p0;
        p_b[TS + t] = p1;
        p_b[2 * TS + t] = p2;
        __syncthreads();
        cta_dot(part + d.oWo, first, hs_cta + (NB - 1) * H * T, T, H, dout_b, d.out);
        cta_sum(part + d.obo, first, dout_b, d.out);
      }
      float dh[H];
#pragma unroll
      for (int j = 0; j < H; ++j) {
        float s = 0.f;
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (q < d.out) s = fmaf(__ldg(w + d.oWo + j * d.out + q), dout[q], s);
        dh[j] = s;
      }
      const bool want_f = d.fw && d.dfp;
      if (want_f)
        for (int i = 0; i < c; ++i) df_b[i * TS + t] = 0.f;
#pragma unroll
      for (int k = NB - 1; k >= 0; --k) {
        const float* __restrict__ W = w + d.oW[k];
        if (d.fw) {
          const float* __restrict__ Wc = w + d.oWc + k * d.fw * H;
          if (want_f)  // the secondary half is detached: no gradient
            for (int i = 0; i < c; ++i) df_b[i * TS + t] += dot_row(Wc + i * H, dh);
          if (train) {
#pragma unroll
            for (int j = 0; j < H; ++j) dh_b[j * TS + t] = dh[j];
            __syncthreads();
            cta_dot(part + d.oWc + k * d.fw * H, first, f_b, TS, d.fw, dh_b, H);
            cta_sum(part + d.obc + k * H, first, dh_b, H);
          }
        }
        float dz[H];
#pragma unroll
        for (int j = 0; j < H; ++j) dz[j] = (mask[k] >> j) & 1u ? dh[j] : 0.f;
        const int lead_in = (k == 0 || k == SKIP + 1) ? d.lead : 0;
        if (train) {
#pragma unroll
          for (int j = 0; j < H; ++j) dz_b[j * TS + t] = dz[j];
          __syncthreads();
          if (lead_in) cta_dot(part + d.oW[k], first, lead_b, TS, lead_in, dz_b, H);
          if (k > 0)
            cta_dot(part + d.oW[k] + lead_in * H, first, hs_cta + (k - 1) * H * T, T, H,
                    dz_b, H);
          cta_sum(part + d.ob + k * H, first, dz_b, H);
          __syncthreads();  // before dz_b and dh_b are written again
        }
        if (lead_in && want_lead) {
          for (int i = 0; i < lead_in; ++i) {
            const float v = dot_row(W + i * H, dz);
            dlead_b[i * TS + t] = k == 0 ? dlead_b[i * TS + t] + v : v;
          }
        }
        if (k > 0) {
#pragma unroll
          for (int i = 0; i < H; ++i) dh[i] = dot_row(W + (lead_in + i) * H, dz);
        }
      }
      if (d.emb && want_lead) {
        const float* __restrict__ B = w + d.oB;
        for (int i = 0; i < EMB; ++i) {
          const float b0 = __ldg(B + i), b1 = __ldg(B + EMB + i), b2 = __ldg(B + 2 * EMB + i);
          const float da = dlead_b[i * TS + t] * cosf(fmaf(p2, b2, fmaf(p1, b1, p0 * b0)));
          dp0 = fmaf(da, b0, dp0);
          dp1 = fmaf(da, b1, dp1);
          dp2 = fmaf(da, b2, dp2);
          dlead_b[i * TS + t] = da;
        }
        if (train) {
          __syncthreads();
          cta_dot(part + d.oB, first, p_b, TS, 3, dlead_b, EMB);
        }
      }
      if (d.dfp && valid) {
        for (int i = 0; i < c; ++i)
          d.dfp[(size_t)n * c + i] =
              (d.emb ? 0.f : dlead_b[i * TS + t]) + (d.fw ? df_b[i * TS + t] : 0.f);
      }
    }
    if (dp && valid) {
      dp[3 * n] = dp0;
      dp[3 * n + 1] = dp1;
      dp[3 * n + 2] = dp2;
    }
  }
}

// out[w] = sum_r part[r * cols + w] in a fixed order
__global__ void decoder_wgrad_sum_kernel(const float* __restrict__ part, int rows,
                                         int cols, float* __restrict__ out) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= cols) return;
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  int r = 0;
  for (; r + 4 <= rows; r += 4) {
#pragma unroll
    for (int q = 0; q < 4; ++q) s[q] += part[(size_t)(r + q) * cols + w];
  }
  for (; r < rows; ++r) s[0] += part[(size_t)r * cols + w];
  out[w] = (s[0] + s[1]) + (s[2] + s[3]);
}

// the largest shared memory either kernel asks for (c <= kMaxC)
constexpr int kFwdMaxSmem = (EMB + 2 * kMaxC + H) * TS * 4;
constexpr int kBwdMaxSmem = (EMB + 2 * kMaxC + H + EMB + kMaxC + 2 * H + 4 + 3) * TS * 4;

bool make_launch(Launch& L, const long long* desc, int n_dec, int c, int n) {
  if (n_dec < 1 || n_dec > kMaxDec || c < 1 || c > kMaxC || n < 1) return false;
  L = Launch{};
  L.n_dec = n_dec;
  L.c = c;
  L.n = n;
  for (int i = 0; i < n_dec; ++i) {
    const long long* e = desc + kDesc * i;
    Dec& d = L.d[i];
    d.w = (const float*)e[0];
    d.part = (float*)e[1];
    d.fp = (const float*)e[2];
    d.fs = (const float*)e[3];
    d.dfp = (float*)e[4];
    d.emb = (int)e[5];
    d.fw = (int)e[6];
    d.out = (int)e[7];
    d.occ3 = (int)e[8];
    d.lead = d.emb ? EMB : c;
    if (!d.w || !d.fp || (d.out != 1 && d.out != 4) ||
        (d.fw != 0 && d.fw != c && d.fw != 2 * c) || (d.fw == 2 * c && !d.fs))
      return false;
    layout(d);
    L.lm = L.lm > d.lead ? L.lm : d.lead;
    L.fm = L.fm > d.fw ? L.fm : d.fw;
  }
  return true;
}

}  // namespace

extern "C" {

// desc: per decoder kDesc values -- weights, weight-gradient partials (0:
// none), primary feature, secondary feature (0: none), primary feature's
// gradient (0: none), emb, fw, out, occ3.
int decoder_fwd(const long long* desc, int n_dec, int c, const float* p, float* out,
                int n, void* stream) {
  Launch L;
  if (!make_launch(L, desc, n_dec, c, n)) return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(decoder_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       kFwdMaxSmem);
  const int smem = (L.lm + L.fm + H) * TS * 4;
  decoder_fwd_kernel<<<(n + T - 1) / T, T, smem, (cudaStream_t)stream>>>(
      L, p, reinterpret_cast<float4*>(out));
  return (int)cudaGetLastError();
}

// g: the (n, 4) cotangent; dp: (n, 3) or null; hsave: grid * NB * H * T
// floats where a decoder trains; grid: the CTAs (each decoder's partials
// have grid rows).
int decoder_bwd(const long long* desc, int n_dec, int c, const float* p, const float* g,
                float* dp, float* hsave, int grid, int n, void* stream) {
  Launch L;
  if (!make_launch(L, desc, n_dec, c, n) || grid < 1) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < n_dec; ++i) {
    const Dec& d = L.d[i];
    L.train |= d.part != nullptr;
    L.dlead |= d.emb ? (dp != nullptr || d.part != nullptr) : d.dfp != nullptr;
  }
  if (L.train && !hsave) return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(decoder_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       kBwdMaxSmem);
  const int tiles = (n + T - 1) / T;
  const int smem = bwd_columns(L) * TS * 4;
  decoder_bwd_kernel<<<grid, T, smem, (cudaStream_t)stream>>>(L, p, g, dp, hsave, tiles);
  return (int)cudaGetLastError();
}

int decoder_wgrad_sum(const float* part, int rows, int cols, float* out, void* stream) {
  if (rows < 1 || cols < 1) return (int)cudaErrorInvalidValue;
  decoder_wgrad_sum_kernel<<<(cols + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      part, rows, cols, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
