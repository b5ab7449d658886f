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
// Design.  K4 (the first design; a tiled redesign comes next):
//  * one thread per point, a CTA a tile of T = 64 points; the thread runs
//    every decoder of the call on its point in turn.  A block's 32 outputs
//    live in registers; its inputs are per-thread columns of shared memory
//    (column i of thread t at [i * TS + t], TS = T + 1: odd, so a warp's
//    own-column accesses are free of bank conflicts).  The weights are read
//    with __ldg as 16-byte loads that every lane of a warp shares (one
//    broadcast transaction from L1).
//
// K5 (redesigned for Hopper):
//  * several threads per point: a warp owns 8 points, and a thread a 2 x 4
//    register micro-tile of them (points 2 pg, 2 pg + 1; outputs 4 og ..
//    4 og + 3; pg = lane & 3, og = lane >> 2).  Each block's product is a
//    small GEMM over the warp's points.  The forward reads the block input
//    as float4 rows of shared memory and the weight row's quad as one
//    coalesced 16-byte __ldg (the 8 og lanes read the whole 128-byte row),
//    and sums every output in the order of K4's gemv.  Its sin and cos
//    (sincos_emb) are within ~2 ulp of K4's sinf but not equal to it, so a
//    pre-activation within rounding of 0 can take the other relu branch
//    than in K4 (the smoke reports these points as kink_points).  The
//    backward products that reduce over the hidden units (dx = dz W^T,
//    dfeat = dh Wc^T) read the same coalesced quads: each thread forms the
//    partial dot products over its own four units for 8 rows at a time,
//    and a fixed butterfly of shuffles over the 8 og lanes (reduce-scatter)
//    leaves each lane the whole sum of one row, so dz and dh stay in
//    registers in the layout the next product reads (at 128 registers and
//    no spill: 8 CTAs of 2 warps per SM);
//  * a warp's points depend on no other warp: where no decoder trains, a
//    CTA is 2 warps (16 points) running one decoder of the call on one
//    tile (grid: tiles x decoders), and no __syncthreads runs but in
//    finish_dp.  At tracking's 9,600 points and 3 decoders that is 1,800
//    CTAs, 16 warps resident on each of 132 SMs;
//  * everything of a tile stays on chip: each point has one shared row
//    (lead, injected feature, block outputs, point; where a decoder trains
//    also the head cotangent, dh and dz of the current block, ping-pong,
//    and the lead's gradient), rows padded to a stride of 4 mod 8 floats,
//    so the float4 accesses of a quarter-warp hit distinct banks;
//  * where a decoder trains, the launch is one persistent CTA of 8 warps
//    (64 points) per SM, walking tiles blockIdx.x, + gridDim.x, ... in
//    order, decoder by decoder.  The weight gradients are products over the
//    tile's points in 4 x 4 micro-tiles (dW_k = X_k^T dZ_k, dWc_k = F^T
//    dH_k, dB = P^T dA, dWo = h_4^T dout, and the bias sums), each output
//    summed over the tile's points in order by the one thread that owns
//    it and added into the CTA's shared sums, which it writes once as its
//    row of partials.  The rows and the order depend only on (n, SMs), so
//    the weight gradient is bit-identical from run to run on one card;
//  * the point gradient sums over decoders in their order: in a persistent
//    CTA (or a call of one decoder) each decoder adds its share into dp
//    (zeroed by the wrapper) from the thread that owns the point; where the
//    decoders ran in CTAs of their own, each writes its share and the last
//    CTA of the tile to count itself in a counter (zeroed by the wrapper)
//    adds the shares in decoder order (finish_dp).
//
// K6: a CTA sums 32 adjacent columns over all rows with 8 row groups: the
// thread of group g adds rows g, g + 8, ... in increasing order (loads
// coalesced, several in flight), then a fixed shared-memory tree adds the
// 8 group sums.  The order depends only on (rows, cols).
//
// Every kernel launches on the caller's stream and returns
// cudaGetLastError(); the large shared-memory attributes are set once per
// device.

#include <cuda_runtime.h>

#include <atomic>
#include <mutex>

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
  int train;        // K5: some decoder trains
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

// ---------------------------------------------------------------------------
// K5 decoder_bwd
// ---------------------------------------------------------------------------

constexpr int WPTS = 8;      // points per warp
constexpr int NT_WARPS = 2;  // warps per CTA where no decoder trains
constexpr int TR_WARPS = 8;  // warps per persistent CTA where a decoder trains
constexpr int LEADW = 96;    // the lead's shared width (EMB padded to a quad)

// A point's shared row (floats).  Where nothing trains, the block outputs
// ping-pong in two slots, and the lead's gradient and the feature's reuse
// the lead and the feature (dead once the forward is done); where a
// decoder trains, the row keeps what the
// CTA's weight-gradient products read: all five block outputs, the head
// cotangent, dh and dz of the current block (ping-pong) and the lead's
// gradient, then dA.  The stride is 4 mod 8 floats: the float4 accesses of
// a quarter-warp (rows 2 pg or 2 pg + 1, quads 4 og) then hit distinct banks.
template <bool TRAIN>
struct Row {
  static constexpr int LEAD = 0;
  static constexpr int F = LEADW;               // injected feature, up to 2 x kMaxC
  static constexpr int HID = F + 2 * kMaxC;     // block outputs
  static constexpr int P = HID + (TRAIN ? NB : 2) * H;
  static constexpr int DO = P + 4;              // head cotangent (TRAIN)
  static constexpr int DH = DO + 4;
  static constexpr int DZ = DH + (TRAIN ? 2 * H : 0);
  static constexpr int DL = TRAIN ? DZ + 2 * H : LEAD;
  static constexpr int END = TRAIN ? DL + LEADW : DH;
  static constexpr int S = END + 4;
  static_assert(S % 8 == 4, "row stride must be 4 mod 8 floats");
  __device__ static constexpr int hid(int k) { return HID + (TRAIN ? k : (k & 1)) * H; }
};

// offset of block k's weight in the packed buffer (layout's oW[k], from the
// lead's width: indexing the descriptor's array with a loop's k would copy
// it to local memory)
__device__ __forceinline__ int w_off(const Dec& d, int k) {
  return k == 0 ? 0 : d.lead * H + (k - 1) * H * H + (k == NB - 1 ? d.lead * H : 0);
}

// sin x and cos x for |x| < 2^13 (the embedding's |p B| stays below ~10^3):
// Cody-Waite reduction by pi/2 in three parts, then Cephes' minimax
// polynomials on [-pi/4, pi/4]; within ~2 ulp of sinf and cosf, whose
// Payne-Hanek path for huge arguments keeps a 28-byte array in local memory.
__device__ __forceinline__ void sincos_emb(float x, float& sn, float& cs) {
  const float j = rintf(x * 0.636619772f);
  float r = fmaf(-j, 1.5703125f, x);
  r = fmaf(-j, 4.837512969970703125e-4f, r);
  r = fmaf(-j, 7.54978995489188216e-8f, r);
  const float z = r * r;
  const float ps = fmaf(fmaf(fmaf(-1.9515295891e-4f, z, 8.3321608736e-3f), z,
                             -1.6666654611e-1f) * z, r, r);
  const float pc = fmaf(fmaf(fmaf(2.443315711809948e-5f, z, -1.388731625493765e-3f), z,
                             4.166664568298827e-2f) * z, z, fmaf(-0.5f, z, 1.f));
  const int q = (int)j & 3;  // x = r + q pi/2
  sn = q == 0 ? ps : q == 1 ? pc : q == 2 ? -ps : -pc;
  cs = q == 0 ? pc : q == 1 ? -ps : q == 2 ? -pc : ps;
}

__device__ __forceinline__ void fma4(float (&a)[4], float x, const float4 w) {
  a[0] = fmaf(x, w.x, a[0]);
  a[1] = fmaf(x, w.y, a[1]);
  a[2] = fmaf(x, w.z, a[2]);
  a[3] = fmaf(x, w.w, a[3]);
}

// acc[p][q] += sum_{i<K} x_p[i] * W[i * H + 4 og + q] for the thread's two
// points (shared rows xa, xb): each output summed in order of i, as gemv.
__device__ __forceinline__ void gemm2x4(float (&acc)[2][4], const float* xa, const float* xb,
                                        int K, const float* __restrict__ W, int og) {
  const float4* w4 = reinterpret_cast<const float4*>(W) + og;
  int i = 0;
  for (; i + 4 <= K; i += 4) {
    const float4 a = *reinterpret_cast<const float4*>(xa + i);
    const float4 b = *reinterpret_cast<const float4*>(xb + i);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float4 w = __ldg(w4 + (i + r) * (H / 4));
      fma4(acc[0], av[r], w);
      fma4(acc[1], bv[r], w);
    }
  }
  for (; i < K; ++i) {
    const float4 w = __ldg(w4 + i * (H / 4));
    fma4(acc[0], xa[i], w);
    fma4(acc[1], xb[i], w);
  }
}

// The 8 og lanes of a point group each hold v[o], a partial sum of output
// o (o < 8).  A fixed butterfly (lane bits 4, 3, 2 are og's bits 2, 1, 0)
// leaves lane og the sum of output og over the 8 lanes.
__device__ __forceinline__ float reduce_scatter8(const float (&v)[8], int og) {
  const bool b2 = og & 4, b1 = og & 2, b0 = og & 1;
  float k4[4], k2[2];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const float send = b2 ? v[t] : v[4 + t];
    k4[t] = (b2 ? v[4 + t] : v[t]) + __shfl_xor_sync(0xffffffffu, send, 16);
  }
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const float send = b1 ? k4[u] : k4[2 + u];
    k2[u] = (b1 ? k4[2 + u] : k4[u]) + __shfl_xor_sync(0xffffffffu, send, 8);
  }
  const float send = b0 ? k2[0] : k2[1];
  return (b0 ? k2[1] : k2[0]) + __shfl_xor_sync(0xffffffffu, send, 4);
}

// out[p] = sum_j x[p][j] * W[(base + 4 og + s) * H + j] for the thread's two
// points, where 4 og + s < lim (else 0): each lane dots its quad x[p][0..4)
// (units 4 og ..) with 8 rows base + 4 o + s, then reduce_scatter8.
__device__ __forceinline__ void rows_dot(float (&out)[2], const float (&x)[2][4],
                                         const float* __restrict__ W, int base, int s,
                                         int lim, int og) {
  float v[2][8];
#pragma unroll
  for (int o = 0; o < 8; ++o) {
    const int i = 4 * o + s;
    float4 w = make_float4(0.f, 0.f, 0.f, 0.f);
    if (i < lim) w = __ldg(reinterpret_cast<const float4*>(W + (base + i) * H) + og);
#pragma unroll
    for (int p = 0; p < 2; ++p)
      v[p][o] = fmaf(x[p][3], w.w, fmaf(x[p][2], w.z, fmaf(x[p][1], w.y, x[p][0] * w.x)));
  }
  out[0] = reduce_scatter8(v[0], og);
  out[1] = reduce_scatter8(v[1], og);
}

// One weight-gradient product of a CTA tile of TP points into the shared
// sums: acc[out + r * J + j] += sum_pt A[pt][r] * Bm[pt][j] (r < R, j < J;
// a < 0: A = 1, the bias sums, R = 1) with A and Bm at offsets a and b of
// the points' rows.  4 x 4 micro-tiles; micro-tile m of the phase (base +
// its index here) belongs to thread m mod blockDim.x, which sums it over
// the tile's points in order.  Returns the next task's base.
template <int S, int TP>
__device__ __forceinline__ int product(float* acc, const float* rows, int a, int b, int R,
                                       int J, int out, int base) {
  const int jq = (J + 3) >> 2, cnt = ((R + 3) >> 2) * jq;
  const int nt = blockDim.x;
  int m = ((int)threadIdx.x - base) % nt;
  if (m < 0) m += nt;
  for (; m < cnt; m += nt) {
    const int r0 = (m / jq) * 4, j0 = (m % jq) * 4;
    float s[4][4] = {};
    for (int pt = 0; pt < TP; ++pt) {
      const float* row = rows + pt * S;
      const float4 bq = *reinterpret_cast<const float4*>(row + b + j0);
      const float4 aq = a < 0 ? make_float4(1.f, 1.f, 1.f, 1.f)
                              : *reinterpret_cast<const float4*>(row + a + r0);
      const float av[4] = {aq.x, aq.y, aq.z, aq.w};
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) fma4(s[rr], av[rr], bq);
    }
#pragma unroll
    for (int rr = 0; rr < 4; ++rr)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        if (r0 + rr < R && j0 + jj < J) acc[out + (r0 + rr) * J + j0 + jj] += s[rr][jj];
  }
  return base + cnt;
}

// The point gradient of a tile whose decoders ran in separate CTAs (dpart:
// each decoder's share, (n_dec, n, 3)): every CTA of the tile counts itself
// in counter[tile], and the last one sums the shares in decoder order, as
// one CTA running the decoders in turn would.
template <int TP>
__device__ void finish_dp(const Launch& L, float* dp, const float* dpart, int* counter,
                          int tile) {
  __shared__ int last;
  __threadfence();  // this CTA's shares, before it counts itself
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(counter + tile, 1) == (int)gridDim.y - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int i = threadIdx.x; i < TP * 3; i += blockDim.x) {
    const int n = tile * TP + i / 3, q = i - (i / 3) * 3;
    if (n >= L.n) continue;
    float s = 0.f;
    for (int d = 0; d < L.n_dec; ++d)
      if (L.d[d].emb) s += __ldcg(dpart + ((size_t)d * L.n + n) * 3 + q);
    dp[3 * n + q] = s;
  }
}

// Where a decoder trains (TRAIN): persistent CTAs, each running every
// decoder on its tiles in turn.  Otherwise CTA (x, y) runs decoder y on tile
// x; with several decoders and dp, their shares meet in finish_dp.
template <bool TRAIN, int WARPS>
__global__ void __launch_bounds__(WARPS * 32, TRAIN ? 1 : 8)
    decoder_bwd_kernel(const Launch L, const float* __restrict__ p,
                       const float* __restrict__ g, float* __restrict__ dp,
                       float* __restrict__ dpart, int* __restrict__ counter, int tiles) {
  using R = Row<TRAIN>;
  constexpr int S = R::S, TP = WARPS * WPTS;
  extern __shared__ float4 sm4[];
  float* sm = reinterpret_cast<float*>(sm4);
  float* acc = sm + TP * S;  // TRAIN: the training decoder's weight-gradient sums
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int pg = lane & 3, og = lane >> 2;
  float* wrows = sm + warp * WPTS * S;  // the warp's 8 points
  float* const ra = wrows + 2 * pg * S;  // this thread's points: rows ra, ra + S
  const int c = L.c;

  const int d_end = TRAIN ? L.n_dec : blockIdx.y + 1;
  for (int di = TRAIN ? 0 : blockIdx.y; di < d_end; ++di) {
    const Dec& d = L.d[di];
    const float* __restrict__ w = d.w;
    const bool train = TRAIN && d.part != nullptr;
    const bool want_lead = d.emb ? (dp != nullptr || train) : d.dfp != nullptr;
    if (!train && !want_lead && !d.dfp) {
      if (!TRAIN && dpart) finish_dp<TP>(L, dp, dpart, counter, blockIdx.x);
      continue;
    }
    const bool want_f = d.fw && d.dfp;
    if (train) {
      __syncthreads();  // the previous decoder's sums are written out
      for (int i = threadIdx.x; i < d.count; i += blockDim.x) acc[i] = 0.f;
    }
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      if (TRAIN) __syncthreads();  // the previous tile's products are done with the rows
      __syncwarp();                // the warp's lanes are done with its rows
      const int n0 = tile * TP + warp * WPTS;
      if (lane < WPTS) {
        const int n = n0 + lane;
        const bool v = n < L.n;
        float* r = wrows + lane * S;
#pragma unroll
        for (int q = 0; q < 3; ++q) r[R::P + q] = v ? p[3 * n + q] : 0.f;
        if (TRAIN) {
          float gq[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) gq[q] = v ? g[4 * n + q] : 0.f;
          r[R::DO] = d.out == 1 ? gq[3] : gq[0];
          r[R::DO + 1] = d.out == 1 ? 0.f : gq[1];
          r[R::DO + 2] = d.out == 1 ? 0.f : gq[2];
          r[R::DO + 3] = d.out == 1 || !d.occ3 ? 0.f : gq[3];
        }
      }
      __syncwarp();
      if (d.emb) {
        const float* __restrict__ B = w + d.oB;
        for (int idx = lane; idx < WPTS * EMB; idx += 32) {
          const int pt = idx / EMB, i = idx - pt * EMB;
          float* r = wrows + pt * S;
          float sn, cs;
          sincos_emb(fmaf(r[R::P + 2], __ldg(B + 2 * EMB + i),
                          fmaf(r[R::P + 1], __ldg(B + EMB + i), r[R::P] * __ldg(B + i))),
                     sn, cs);
          r[R::LEAD + i] = sn;
        }
      } else {
        for (int idx = lane; idx < WPTS * c; idx += 32) {
          const int pt = idx / c, i = idx - pt * c, n = n0 + pt;
          wrows[pt * S + R::LEAD + i] = n < L.n ? d.fp[(size_t)n * c + i] : 0.f;
        }
      }
      if (d.fw) {
        for (int idx = lane; idx < WPTS * c; idx += 32) {
          const int pt = idx / c, i = idx - pt * c, n = n0 + pt;
          float* r = wrows + pt * S + R::F;
          r[i] = n < L.n ? d.fp[(size_t)n * c + i] : 0.f;
          if (d.fw > c) r[c + i] = n < L.n ? d.fs[(size_t)n * c + i] : 0.f;
        }
      }
      __syncwarp();

      // the forward, in K4's summation order; relu masks: bit 8 k + 4 p + q
      unsigned long long mask = 0ull;
#pragma unroll
      for (int k = 0; k < NB; ++k) {
        float a[2][4];
        const float4 bk = __ldg(reinterpret_cast<const float4*>(w + d.ob + k * H) + og);
#pragma unroll
        for (int pp = 0; pp < 2; ++pp) {
          a[pp][0] = bk.x;
          a[pp][1] = bk.y;
          a[pp][2] = bk.z;
          a[pp][3] = bk.w;
        }
        const int lead_in = (k == 0 || k == SKIP + 1) ? d.lead : 0;
        if (lead_in) gemm2x4(a, ra + R::LEAD, ra + S + R::LEAD, lead_in, w + w_off(d, k), og);
        if (k > 0)
          gemm2x4(a, ra + R::hid(k - 1), ra + S + R::hid(k - 1), H,
                  w + w_off(d, k) + lead_in * H, og);
#pragma unroll
        for (int pp = 0; pp < 2; ++pp)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            if (a[pp][q] > 0.f) mask |= 1ull << (8 * k + 4 * pp + q);
            a[pp][q] = fmaxf(a[pp][q], 0.f);
          }
        if (d.fw) {
          float inj[2][4];
          const float4 bc = __ldg(reinterpret_cast<const float4*>(w + d.obc + k * H) + og);
#pragma unroll
          for (int pp = 0; pp < 2; ++pp) {
            inj[pp][0] = bc.x;
            inj[pp][1] = bc.y;
            inj[pp][2] = bc.z;
            inj[pp][3] = bc.w;
          }
          gemm2x4(inj, ra + R::F, ra + S + R::F, d.fw, w + d.oWc + k * d.fw * H, og);
#pragma unroll
          for (int pp = 0; pp < 2; ++pp)
#pragma unroll
            for (int q = 0; q < 4; ++q) a[pp][q] += inj[pp][q];
        }
#pragma unroll
        for (int pp = 0; pp < 2; ++pp)
          *reinterpret_cast<float4*>(ra + pp * S + R::hid(k) + 4 * og) =
              make_float4(a[pp][0], a[pp][1], a[pp][2], a[pp][3]);
        __syncwarp();
      }

      // the head's cotangent and dh of block 4 (units 4 og .. 4 og + 3)
      float dh[2][4];
      {
        float dout[2][4];
#pragma unroll
        for (int pp = 0; pp < 2; ++pp) {
          const int n = n0 + 2 * pg + pp;
          const bool v = n < L.n;
          float gq[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) gq[q] = v ? g[4 * n + q] : 0.f;
          dout[pp][0] = d.out == 1 ? gq[3] : gq[0];
          dout[pp][1] = d.out == 1 ? 0.f : gq[1];
          dout[pp][2] = d.out == 1 ? 0.f : gq[2];
          dout[pp][3] = d.out == 1 || !d.occ3 ? 0.f : gq[3];
        }
        const float* __restrict__ Wo = w + d.oWo;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int j = 4 * og + q;
#pragma unroll
          for (int pp = 0; pp < 2; ++pp) {
            float s = 0.f;
#pragma unroll
            for (int qq = 0; qq < 4; ++qq)
              if (qq < d.out) s = fmaf(__ldg(Wo + j * d.out + qq), dout[pp][qq], s);
            dh[pp][q] = s;
          }
        }
      }
      if (train) {
        __syncthreads();  // every warp's block outputs and head cotangents
        int t = product<S, TP>(acc, sm, R::hid(NB - 1), R::DO, H, d.out, d.oWo, 0);
        product<S, TP>(acc, sm, -1, R::DO, 1, d.out, d.obo, t);
      }

      // the primary feature's gradient, units 4 og + s: in registers where a
      // decoder trains (its products read the feature), else in the thread's
      // own slots of the feature's shared row, which the backward no longer reads
      float df[2][4] = {};
#pragma unroll
      for (int k = NB - 1; k >= 0; --k) {
        if (want_f) {  // the secondary half is detached: rows < c only
          const float* __restrict__ Wc = w + d.oWc + k * d.fw * H;
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            float v[2];
            rows_dot(v, dh, Wc, 0, s, c, og);
#pragma unroll
            for (int pp = 0; pp < 2; ++pp) {
              if constexpr (TRAIN) {
                df[pp][s] += v[pp];
              } else {
                float* f = ra + pp * S + R::F + 4 * og + s;
                *f = k == NB - 1 ? v[pp] : *f + v[pp];
              }
            }
          }
        }
        float dz[2][4];
#pragma unroll
        for (int pp = 0; pp < 2; ++pp)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            dz[pp][q] = (mask >> (8 * k + 4 * pp + q)) & 1ull ? dh[pp][q] : 0.f;
        const int lead_in = (k == 0 || k == SKIP + 1) ? d.lead : 0;
        if (train) {
          const int dhk = R::DH + (k & 1) * H, dzk = R::DZ + (k & 1) * H;
#pragma unroll
          for (int pp = 0; pp < 2; ++pp) {
            *reinterpret_cast<float4*>(ra + pp * S + dhk + 4 * og) =
                make_float4(dh[pp][0], dh[pp][1], dh[pp][2], dh[pp][3]);
            *reinterpret_cast<float4*>(ra + pp * S + dzk + 4 * og) =
                make_float4(dz[pp][0], dz[pp][1], dz[pp][2], dz[pp][3]);
          }
          __syncthreads();  // the tile's dh and dz of block k
          int t = 0;
          if (d.fw) {
            t = product<S, TP>(acc, sm, R::F, dhk, d.fw, H, d.oWc + k * d.fw * H, t);
            t = product<S, TP>(acc, sm, -1, dhk, 1, H, d.obc + k * H, t);
          }
          if (lead_in) t = product<S, TP>(acc, sm, R::LEAD, dzk, lead_in, H, w_off(d, k), t);
          if (k > 0)
            t = product<S, TP>(acc, sm, R::hid(k - 1), dzk, H, H, w_off(d, k) + lead_in * H, t);
          product<S, TP>(acc, sm, -1, dzk, 1, H, d.ob + k * H, t);
        }
        const float* __restrict__ W = w + w_off(d, k);
        if (lead_in && want_lead) {  // the lead's gradient, rows 32 r + 4 og + s
#pragma unroll
          for (int r = 0; r < LEADW / 32; ++r) {
            if (32 * r >= lead_in) break;
#pragma unroll
            for (int s = 0; s < 4; ++s) {
              float v[2];
              rows_dot(v, dz, W, 32 * r, s, lead_in - 32 * r, og);
              const int i = 32 * r + 4 * og + s;
              if (i < lead_in)
#pragma unroll
                for (int pp = 0; pp < 2; ++pp) {
                  float* dl = ra + pp * S + R::DL + i;
                  *dl = k == 0 ? *dl + v[pp] : v[pp];
                }
            }
          }
        }
        if (k > 0) {  // dh of block k - 1
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            float v[2];
            rows_dot(v, dz, W, lead_in, s, H, og);
            dh[0][s] = v[0];
            dh[1][s] = v[1];
          }
        }
      }

      if (d.emb && want_lead) {  // dA = dlead cos(p B); dp += dA B^T; dB = P^T dA
        const float* __restrict__ B = w + d.oB;
        float dq[2][3] = {};
#pragma unroll
        for (int r = 0; r < LEADW / 32; ++r)
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            const int i = 32 * r + 4 * og + s;
            if (i < EMB) {
              const float b0 = __ldg(B + i), b1 = __ldg(B + EMB + i), b2 = __ldg(B + 2 * EMB + i);
#pragma unroll
              for (int pp = 0; pp < 2; ++pp) {
                const float* pr = ra + pp * S + R::P;
                float* dl = ra + pp * S + R::DL + i;
                float sn, cs;
                sincos_emb(fmaf(pr[2], b2, fmaf(pr[1], b1, pr[0] * b0)), sn, cs);
                const float da = *dl * cs;
                dq[pp][0] = fmaf(da, b0, dq[pp][0]);
                dq[pp][1] = fmaf(da, b1, dq[pp][1]);
                dq[pp][2] = fmaf(da, b2, dq[pp][2]);
                if (train) *dl = da;
              }
            }
          }
        if (dp) {
#pragma unroll
          for (int pp = 0; pp < 2; ++pp)
#pragma unroll
            for (int q = 0; q < 3; ++q) {
              float x = dq[pp][q];
              x += __shfl_xor_sync(0xffffffffu, x, 16);
              x += __shfl_xor_sync(0xffffffffu, x, 8);
              x += __shfl_xor_sync(0xffffffffu, x, 4);
              dq[pp][q] = x;
            }
          if (og < 2) {
            const int n = n0 + 2 * pg + og;
            if (n < L.n)
#pragma unroll
              for (int q = 0; q < 3; ++q) {
                const float v = og ? dq[1][q] : dq[0][q];
                if (!TRAIN && dpart)
                  dpart[((size_t)di * L.n + n) * 3 + q] = v;
                else
                  dp[3 * n + q] += v;
              }
          }
        }
        if (train) {
          __syncthreads();  // the tile's dA
          product<S, TP>(acc, sm, R::P, R::DL, 3, EMB, d.oB, 0);
        }
      }
      if (d.dfp) {
#pragma unroll
        for (int pp = 0; pp < 2; ++pp) {
          const int n = n0 + 2 * pg + pp;
          if (n >= L.n) continue;
#pragma unroll
          for (int s = 0; s < 4; ++s) {
            const int i = 4 * og + s;
            if (i < c)
              d.dfp[(size_t)n * c + i] =
                  (d.emb ? 0.f : ra[pp * S + R::DL + i]) +
                  (d.fw ? (TRAIN ? df[pp][s] : ra[pp * S + R::F + i]) : 0.f);
          }
        }
      }
      if (!TRAIN && dpart) finish_dp<TP>(L, dp, dpart, counter, tile);
    }
    if (train) {
      __syncthreads();  // the last tile's products
      float* part = d.part + (size_t)blockIdx.x * d.count;
      for (int i = threadIdx.x; i < d.count; i += blockDim.x) part[i] = acc[i];
    }
  }
}

// ---------------------------------------------------------------------------
// K6 decoder_wgrad_sum
// ---------------------------------------------------------------------------

constexpr int K6_COLS = 32;   // adjacent columns per CTA
constexpr int K6_GROUPS = 8;  // row groups

// out[w] = sum_r part[r * cols + w]: group g sums rows g, g + 8, ... in
// order, then a fixed tree adds the 8 group sums
__global__ void __launch_bounds__(K6_COLS * K6_GROUPS)
    decoder_wgrad_sum_kernel(const float* __restrict__ part, int rows, int cols,
                             float* __restrict__ out) {
  __shared__ float sums[K6_GROUPS][K6_COLS];
  const int col = threadIdx.x % K6_COLS, grp = threadIdx.x / K6_COLS;
  const int w = blockIdx.x * K6_COLS + col;
  float s = 0.f;
  if (w < cols) {
    const float* src = part + w;
    int r = grp;
    for (; r + 3 * K6_GROUPS < rows; r += 4 * K6_GROUPS) {
      const float v0 = __ldg(src + (size_t)r * cols);
      const float v1 = __ldg(src + (size_t)(r + K6_GROUPS) * cols);
      const float v2 = __ldg(src + (size_t)(r + 2 * K6_GROUPS) * cols);
      const float v3 = __ldg(src + (size_t)(r + 3 * K6_GROUPS) * cols);
      s = (((s + v0) + v1) + v2) + v3;
    }
    for (; r < rows; r += K6_GROUPS) s += __ldg(src + (size_t)r * cols);
  }
  sums[grp][col] = s;
  __syncthreads();
#pragma unroll
  for (int h = K6_GROUPS / 2; h >= 1; h >>= 1) {
    if (grp < h) sums[grp][col] += sums[grp + h][col];
    __syncthreads();
  }
  if (grp == 0 && w < cols) out[w] = sums[0][col];
}

// the largest shared memory each kernel asks for (c <= kMaxC)
constexpr int kFwdMaxSmem = (EMB + 2 * kMaxC + H) * TS * 4;
// the largest packed buffer: the 93-wide lead, a 64-wide feature, 4 outputs
constexpr int kMaxCount = (EMB + 3 * H + EMB + H) * H + NB * H + NB * 2 * kMaxC * H +
                          NB * H + H * 4 + 4 + 3 * EMB;
constexpr int kBwdTrainMaxSmem = (TR_WARPS * WPTS * Row<true>::S + kMaxCount) * 4;
static_assert(kBwdTrainMaxSmem <= 232448, "K5's training CTA exceeds Hopper's shared memory");

int bwd_smem(bool train, int max_count) {
  return train ? (TR_WARPS * WPTS * Row<true>::S + max_count) * 4
               : NT_WARPS * WPTS * Row<false>::S * 4;
}

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

// The shared-memory attributes above 48 KB, once per device: three threads
// (tracker, mapper, coarse mapper) may launch on one card at once.
constexpr int kMaxDevices = 64;
std::mutex g_attr_lock;
std::atomic<unsigned long long> g_attr_done{0};

int set_attributes_once() {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const unsigned long long bit = 1ull << (dev % kMaxDevices);
  if (g_attr_done.load(std::memory_order_acquire) & bit) return 0;
  std::lock_guard<std::mutex> lock(g_attr_lock);
  if (g_attr_done.load(std::memory_order_relaxed) & bit) return 0;
  e = cudaFuncSetAttribute(decoder_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kFwdMaxSmem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(decoder_bwd_kernel<true, TR_WARPS>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kBwdTrainMaxSmem);
  if (e != cudaSuccess) return (int)e;
  g_attr_done.fetch_or(bit, std::memory_order_release);
  return 0;
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
  const int rc = set_attributes_once();
  if (rc) return rc;
  const int smem = (L.lm + L.fm + H) * TS * 4;
  decoder_fwd_kernel<<<(n + T - 1) / T, T, smem, (cudaStream_t)stream>>>(
      L, p, reinterpret_cast<float4*>(out));
  return (int)cudaGetLastError();
}

// g: the (n, 4) cotangent; dp: (n, 3), zeroed unless dpart, or null; grid:
// the CTAs walking the tiles (8 points a warp; 2 warps a CTA, or 8 where a
// decoder trains: then each training decoder's partials have grid rows).
// Where none trains, each decoder has its own grid CTAs (grid = the
// tiles); with dp and several decoders, dpart (n_dec, n, 3) holds their
// shares and counter (the tiles) is zeroed.
int decoder_bwd(const long long* desc, int n_dec, int c, const float* p, const float* g,
                float* dp, float* dpart, int* counter, int grid, int n, void* stream) {
  Launch L;
  if (!make_launch(L, desc, n_dec, c, n) || grid < 1) return (int)cudaErrorInvalidValue;
  int max_count = 0;
  for (int i = 0; i < n_dec; ++i) {
    const Dec& d = L.d[i];
    L.train |= d.part != nullptr;
    if (d.part && d.count > max_count) max_count = d.count;
  }
  const int rc = set_attributes_once();
  if (rc) return rc;
  const int smem = bwd_smem(L.train, max_count);
  if (!L.train && dp && n_dec > 1 && (!dpart || !counter)) return (int)cudaErrorInvalidValue;
  if (L.train) {
    const int tiles = (n + TR_WARPS * WPTS - 1) / (TR_WARPS * WPTS);
    decoder_bwd_kernel<true, TR_WARPS><<<grid, TR_WARPS * 32, smem, (cudaStream_t)stream>>>(
        L, p, g, dp, nullptr, nullptr, tiles);
  } else {
    const int tiles = (n + NT_WARPS * WPTS - 1) / (NT_WARPS * WPTS);
    decoder_bwd_kernel<false, NT_WARPS><<<dim3(grid, n_dec), NT_WARPS * 32, smem,
                                          (cudaStream_t)stream>>>(
        L, p, g, dp, dp && n_dec > 1 ? dpart : nullptr, counter, tiles);
  }
  return (int)cudaGetLastError();
}

int decoder_wgrad_sum(const float* part, int rows, int cols, float* out, void* stream) {
  if (rows < 1 || cols < 1) return (int)cudaErrorInvalidValue;
  decoder_wgrad_sum_kernel<<<(cols + K6_COLS - 1) / K6_COLS, K6_COLS * K6_GROUPS, 0,
                             (cudaStream_t)stream>>>(part, rows, cols, out);
  return (int)cudaGetLastError();
}

// K5's dynamic shared memory for a launch: train, and the largest packed
// buffer among the decoders that train
int decoder_bwd_smem(int train, int max_count) { return bwd_smem(train != 0, max_count); }

// A kernel's compiled resources (which: 0 K4, 1 K5 where nothing trains,
// 2 K5 where a decoder trains, 3 K6) and its resident CTAs per SM at
// dyn_smem bytes of dynamic shared memory: out = registers per thread,
// local bytes per thread, static shared bytes, threads per CTA, CTAs per SM.
int decoder_kernel_info(int which, int dyn_smem, int* out) {
  const void* f;
  int threads;
  switch (which) {
    case 0: f = (const void*)decoder_fwd_kernel; threads = T; break;
    case 1: f = (const void*)decoder_bwd_kernel<false, NT_WARPS>; threads = NT_WARPS * 32; break;
    case 2: f = (const void*)decoder_bwd_kernel<true, TR_WARPS>; threads = TR_WARPS * 32; break;
    case 3: f = (const void*)decoder_wgrad_sum_kernel; threads = K6_COLS * K6_GROUPS; break;
    default: return (int)cudaErrorInvalidValue;
  }
  int rc = set_attributes_once();
  if (rc) return rc;
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, f);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, f, threads, dyn_smem);
  if (e != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)a.sharedSizeBytes;
  out[3] = threads;
  out[4] = blocks;
  return 0;
}

}  // extern "C"
