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
// (67 TFLOP/s) is the bound, well above HBM's.  The weights (16-21k floats
// a decoder) are K4's and K5's only other traffic: K5 reads them from
// L1/L2, K4 copies them once per CTA into shared memory.
//
// One forward for K4 and K5 (forward_rows): the points of a warp are
// tiled, a thread owning a 2 x 4 register micro-tile of each block's
// product (2 points, 4 consecutive hidden units).  Each output is summed
// from its bias, then over the lead rows, then over the hidden rows, in
// order of i; then relu; then the injection (bc, then the feature rows in
// order) is added.  The block input is read as float4 rows of shared
// memory (each point one row, its stride 4 mod 8 floats) and the weight
// row's quads as 16-byte loads (the 8 lanes of a point group read the
// whole 128-byte row, the 4 point groups share it).  The embedding's sines
// come from sincos_emb, which keeps nothing in local memory.  K4 and K5 run
// this code at the same tile; which thread owns a point never changes the
// order of an output's sum, so K4's block outputs and relu masks are K5's
// recomputed ones bit for bit.
//
// K4 (redesigned for Hopper): what bounds it is the f32 FMA rate; what
// kept a first design (a thread per point, every weight an L1 broadcast)
// at 23-65x that bound was the load instructions around each FMA, the
// weights' trips through L1 and L2, and a card the small calls left
// empty.  So:
//  * K5's 2 x 4 micro-tile (a warp owns 8 points, a thread 2 of them,
//    strided: rows pg and pg + 4, so a quarter-warp's loads hit distinct
//    banks); 4 x 4 and 4 x 8 tiles measured slower on an H100;
//  * one persistent CTA per SM (fewer where the call has fewer tiles): for
//    each decoder of the call in turn, one thread copies its packed
//    weights (at most ~84 KB) into shared memory with cp.async.bulk,
//    completing on an mbarrier, and the CTA walks tiles blockIdx.x,
//    + gridDim.x, ... reading every weight from shared memory (1.3-1.8x
//    faster on an H100 than reading them with __ldg as K5 does);
//  * the CTA's warps (up to 16, 8 points each) are sized from (n, SMs) so
//    a small call spreads over the SMs in one round (fwd_geometry in
//    decoder_stage.py; tracking: 120 CTAs of 10 warps);
//  * after the blocks each warp writes its points' heads (each a sum from
//    b_o over the 32 units in order) into the rows' dead lead, and the lane
//    of each point composes them into the output in decoder order, reading
//    back what it wrote for the decoder before, as one thread running the
//    decoders in turn would: bit-identical run to run, no memset, no
//    atomics.
//
// K5 (redesigned for Hopper):
//  * the forward as above with a 2 x 4 micro-tile (a warp owns 8 points,
//    points 2 pg, 2 pg + 1; outputs 4 og .. 4 og + 3; pg = lane & 3, og =
//    lane >> 2), the weights read with __ldg, keeping the relu masks.  The
//    backward products that reduce over the hidden units (dx = dz W^T,
//    dfeat = dh Wc^T) read the same
//    coalesced quads: each thread forms the partial dot products over its
//    own four units for 8 rows at a time, and a fixed butterfly of shuffles
//    over the 8 og lanes (reduce-scatter) leaves each lane the whole sum of
//    one row, so dz and dh stay in registers in the layout the next product
//    reads (at 128 registers and no spill: 8 CTAs of 2 warps per SM);
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
constexpr int LEADW = 96;   // the lead's shared width (EMB padded to a quad)
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
  int ob, oWc, obc, oWo, obo, oB, count;
};

struct Launch {
  Dec d[kMaxDec];
  int n_dec, c, n;
  int train;        // K5: some decoder trains
};

// The packed buffer: W_0..W_4, b_0..b_4, Wc_0..Wc_4, bc_0..bc_4, W_o, b_o, B
// (decoder_stage.py `layout`); every W row is 32 floats at a multiple of 4.
// Offset of block k's weight (k = NB: the end of the weights), from the
// lead's width: W_0 is (lead, H), W_{SKIP+1} (lead + H, H), the others
// (H, H).  Arithmetic, not a table: a table indexed with a loop's k would
// go to local memory.
__host__ __device__ __forceinline__ int w_off(const Dec& d, int k) {
  return k == 0 ? 0 : d.lead * H + (k - 1) * H * H + (k > SKIP + 1 ? d.lead * H : 0);
}

void layout(Dec& d) {
  int o = w_off(d, NB);
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

// ---------------------------------------------------------------------------
// The forward of K4 and K5
// ---------------------------------------------------------------------------

// The 2 x 4 micro-tile: 8 lanes (og) cover a block's 32 outputs, 4 point
// groups (pg) a warp's 8 points; lane = 4 og + pg.
constexpr int WPTS = 8;  // points per warp

// K4's point row: lead, injected feature (up to 2 x kMaxC), block outputs
// (ping-pong), point; the lead's first four floats take the head once the
// blocks are done.  Stride 4 mod 8 floats.
struct FwdRow {
  static constexpr int LEAD = 0;
  static constexpr int F = LEADW;
  static constexpr int HID = F + 2 * kMaxC;
  static constexpr int P = HID + 2 * H;
  static constexpr int S = P + 4;
  static_assert(S % 8 == 4, "row stride must be 4 mod 8 floats");
  __device__ static constexpr int hid(int k) { return HID + (k & 1) * H; }
};

// K5's point row.  Where nothing trains, the block outputs ping-pong in two
// slots, and the lead's gradient and the feature's reuse the lead and the
// feature (dead once the forward is done); where a decoder trains, the row
// keeps what the CTA's weight-gradient products read: all five block
// outputs, the head cotangent, dh and dz of the current block (ping-pong)
// and the lead's gradient, then dA.  The stride is 4 mod 8 floats: the
// float4 accesses of a quarter-warp (rows 2 pg or 2 pg + 1, quads 4 og)
// then hit distinct banks.
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

// reads of the packed weights: through the read-only data cache
struct Ldg {
  __device__ static float4 q(const float4* a) { return __ldg(a); }
  __device__ static float f(const float* a) { return __ldg(a); }
};

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

__device__ __forceinline__ void fma4(float* a, float x, const float4 w) {
  a[0] = fmaf(x, w.x, a[0]);
  a[1] = fmaf(x, w.y, a[1]);
  a[2] = fmaf(x, w.z, a[2]);
  a[3] = fmaf(x, w.w, a[3]);
}

// A warp's WPTS point rows (wrows + pt * R::S, points n0 + pt): the point,
// then the lead (the embedding sin(p B), or the primary feature), then the
// injected feature; zeros past the last point.  Starts and ends with a
// __syncwarp (the warp's lanes are done with the rows, then the rows are
// written).
template <class R, class W>
__device__ __forceinline__ void fill_rows(const Launch& L, const Dec& d,
                                          const float* __restrict__ w,
                                          const float* __restrict__ p, float* wrows, int n0,
                                          int lane) {
  const int c = L.c;
  __syncwarp();
  for (int pt = lane; pt < WPTS; pt += 32) {
    const int n = n0 + pt;
#pragma unroll
    for (int q = 0; q < 3; ++q) wrows[pt * R::S + R::P + q] = n < L.n ? p[3 * n + q] : 0.f;
  }
  __syncwarp();
  if (d.emb) {
    const float* __restrict__ B = w + d.oB;
    for (int idx = lane; idx < WPTS * EMB; idx += 32) {
      const int pt = idx / EMB, i = idx - pt * EMB;
      float* r = wrows + pt * R::S;
      const float x = fmaf(r[R::P + 2], W::f(B + 2 * EMB + i),
                           fmaf(r[R::P + 1], W::f(B + EMB + i), r[R::P] * W::f(B + i)));
      float sn, cs;
      sincos_emb(x, sn, cs);
      r[R::LEAD + i] = sn;
    }
  } else {
    for (int idx = lane; idx < WPTS * c; idx += 32) {
      const int pt = idx / c, i = idx - pt * c, n = n0 + pt;
      wrows[pt * R::S + R::LEAD + i] = n < L.n ? d.fp[(size_t)n * c + i] : 0.f;
    }
  }
  if (d.fw) {
    for (int idx = lane; idx < WPTS * c; idx += 32) {
      const int pt = idx / c, i = idx - pt * c, n = n0 + pt;
      float* r = wrows + pt * R::S + R::F;
      r[i] = n < L.n ? d.fp[(size_t)n * c + i] : 0.f;
      if (d.fw > c) r[c + i] = n < L.n ? d.fs[(size_t)n * c + i] : 0.f;
    }
  }
  __syncwarp();
}

// acc[pp][o] += sum_{i<K} x_pp[i] * Wt[i * H + 4 og + o] for the thread's
// 2 points (rows x, x + ps) and 4 outputs, each output summed in order of i
template <class W>
__device__ __forceinline__ void gemm(float (&acc)[2][4], const float* x, int ps, int K,
                                     const float* __restrict__ Wt, int og) {
  const float4* w4 = reinterpret_cast<const float4*>(Wt) + og;
  int i = 0;
  for (; i + 4 <= K; i += 4) {
    const float4 a = *reinterpret_cast<const float4*>(x + i);
    const float4 b = *reinterpret_cast<const float4*>(x + ps + i);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float4 wv = W::q(w4 + (i + r) * (H / 4));
      fma4(acc[0], av[r], wv);
      fma4(acc[1], bv[r], wv);
    }
  }
  for (; i < K; ++i) {
    const float4 wv = W::q(w4 + i * (H / 4));
    fma4(acc[0], x[i], wv);
    fma4(acc[1], x[ps + i], wv);
  }
}

// a[pp][..] = the quad og of a 32-float bias
template <class W>
__device__ __forceinline__ void bias(float (&a)[2][4], const float* __restrict__ b, int og) {
  const float4 v = W::q(reinterpret_cast<const float4*>(b) + og);
#pragma unroll
  for (int pp = 0; pp < 2; ++pp) {
    a[pp][0] = v.x;
    a[pp][1] = v.y;
    a[pp][2] = v.z;
    a[pp][3] = v.w;
  }
}

// One decoder's five blocks on the thread's 2 points (rows x, x + ps,
// filled by fill_rows), outputs 4 og .. 4 og + 3 of each block, into
// R::hid(k) of the rows.  MASK: the relu masks, bit 8 k + 4 pp + o of mask.
template <class R, bool MASK, class W>
__device__ __forceinline__ void forward_rows(const Dec& d, const float* __restrict__ w, float* x,
                                             int ps, int og, unsigned long long& mask) {
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    float a[2][4];
    bias<W>(a, w + d.ob + k * H, og);
    const int lead_in = (k == 0 || k == SKIP + 1) ? d.lead : 0;
    if (lead_in) gemm<W>(a, x + R::LEAD, ps, lead_in, w + w_off(d, k), og);
    if (k > 0) gemm<W>(a, x + R::hid(k - 1), ps, H, w + w_off(d, k) + lead_in * H, og);
#pragma unroll
    for (int pp = 0; pp < 2; ++pp)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (MASK && a[pp][q] > 0.f) mask |= 1ull << (8 * k + 4 * pp + q);
        a[pp][q] = fmaxf(a[pp][q], 0.f);
      }
    if (d.fw) {
      float inj[2][4];
      bias<W>(inj, w + d.obc + k * H, og);
      gemm<W>(inj, x + R::F, ps, d.fw, w + d.oWc + k * d.fw * H, og);
#pragma unroll
      for (int pp = 0; pp < 2; ++pp)
#pragma unroll
        for (int q = 0; q < 4; ++q) a[pp][q] += inj[pp][q];
    }
#pragma unroll
    for (int pp = 0; pp < 2; ++pp)
      *reinterpret_cast<float4*>(x + pp * ps + R::hid(k) + 4 * og) =
          make_float4(a[pp][0], a[pp][1], a[pp][2], a[pp][3]);
    __syncwarp();
  }
}

// The heads of a warp's WPTS points (rows wrows + pt * R::S, block 4's output
// in R::hid(NB - 1)) into each row's first four floats: lane l takes the
// (point, column) pairs l, l + 32, ...; o_q = b_o[q] + sum_j h_j W_o[j][q]
// in order of j, one FMA at a time.
template <class R, class W>
__device__ __forceinline__ void head_rows(const Dec& d, const float* __restrict__ w,
                                          float* wrows, int lane) {
  const int out = d.out;
  for (int idx = lane; idx < WPTS * out; idx += 32) {
    const int pt = out == 1 ? idx : idx >> 2, q = idx - pt * out;
    float* r = wrows + pt * R::S;
    float s = W::f(w + d.obo + q);
#pragma unroll 8
    for (int j = 0; j < H; ++j) s = fmaf(r[R::hid(NB - 1) + j], W::f(w + d.oWo + j * out + q), s);
    r[R::LEAD + q] = s;
  }
  __syncwarp();
}

// ---------------------------------------------------------------------------
// K4 decoder_fwd
// ---------------------------------------------------------------------------

constexpr int K4_MAX_WARPS = 16;
constexpr int kChunk = 16384;  // bytes per bulk copy

// reads of the packed weights from the CTA's shared copy
struct Lds {
  __device__ static float4 q(const float4* a) { return *a; }
  __device__ static float f(const float* a) { return *a; }
};

__device__ __forceinline__ unsigned smem_addr(const void* a) {
  return static_cast<unsigned>(__cvta_generic_to_shared(a));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// the one arrival of the barrier's phase, which also waits for `bytes`
__device__ __forceinline__ void mbar_arrive_expect(unsigned long long* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// global -> shared, `bytes` a multiple of 16 at 16-byte aligned addresses
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, int bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// this thread's generic accesses of shared memory, before the async proxy's
// later writes there (the next decoder's bulk copy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar, int parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred P;\n mbarrier.try_wait.parity.shared::cta.b64 P, [%1], %2;\n"
        " selp.u32 %0, 1, 0, P;\n}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
}

// Persistent CTAs of 8-point warps walking tiles blockIdx.x, + gridDim.x,
// ... (`tiles` of warps x 8 points), decoder by decoder: the decoder's
// weights into the first wsm floats of shared memory, the warps' point
// rows after them.  A thread's points are rows pg and pg + 4 of its warp.
__global__ void __launch_bounds__(K4_MAX_WARPS * 32, 1)
    decoder_fwd_kernel(const Launch L, const float* __restrict__ p, float4* __restrict__ out,
                       int wsm, int tiles) {
  using R = FwdRow;
  extern __shared__ float4 sm4[];
  __shared__ unsigned long long bar;
  float* w = reinterpret_cast<float*>(sm4);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int pg = lane & 3, og = lane >> 2;
  const int tp = (blockDim.x >> 5) * WPTS;
  float* wrows = w + wsm + warp * WPTS * R::S;
  if (threadIdx.x == 0) mbar_init(&bar);
  __syncthreads();
  unsigned long long no_mask = 0ull;
  for (int di = 0; di < L.n_dec; ++di) {
    const Dec& d = L.d[di];
    if (threadIdx.x == 0) {
      const int bytes = d.count * 4 & ~15;
      mbar_arrive_expect(&bar, bytes);
      for (int off = 0; off < bytes; off += kChunk)
        bulk_copy(w + off / 4, d.w + off / 4, min(kChunk, bytes - off), &bar);
      for (int i = bytes / 4; i < d.count; ++i) w[i] = d.w[i];
    }
    mbar_wait(&bar, di & 1);
    __syncthreads();  // the tail's plain stores
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int n0 = tile * tp + warp * WPTS;
      fill_rows<R, Lds>(L, d, w, p, wrows, n0, lane);
      forward_rows<R, false, Lds>(d, w, wrows + pg * R::S, 4 * R::S, og, no_mask);
      head_rows<R, Lds>(d, w, wrows, lane);
      for (int pt = lane; pt < WPTS; pt += 32) {
        const int n = n0 + pt;
        if (n >= L.n) break;
        const float* o = wrows + pt * R::S + R::LEAD;
        float4 r = di ? out[n] : make_float4(0.f, 0.f, 0.f, 0.f);
        if (d.out == 1) {
          r.w += o[0];
        } else {
          r.x = o[0];
          r.y = o[1];
          r.z = o[2];
          if (d.occ3) r.w += o[3];
        }
        out[n] = r;
      }
    }
    fence_proxy_async();
    __syncthreads();  // every warp is done with this decoder's weights
  }
}

// ---------------------------------------------------------------------------
// K5 decoder_bwd
// ---------------------------------------------------------------------------

constexpr int NT_WARPS = 2;  // warps per CTA where no decoder trains
constexpr int TR_WARPS = 8;  // warps per persistent CTA where a decoder trains

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
      const int n0 = tile * TP + warp * WPTS;
      fill_rows<R, Ldg>(L, d, w, p, wrows, n0, lane);
      if (TRAIN && lane < WPTS) {
        const int n = n0 + lane;
        const bool v = n < L.n;
        float* r = wrows + lane * S;
        float gq[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) gq[q] = v ? g[4 * n + q] : 0.f;
        r[R::DO] = d.out == 1 ? gq[3] : gq[0];
        r[R::DO + 1] = d.out == 1 ? 0.f : gq[1];
        r[R::DO + 2] = d.out == 1 ? 0.f : gq[2];
        r[R::DO + 3] = d.out == 1 || !d.occ3 ? 0.f : gq[3];
      }

      // the forward, K4's; relu masks: bit 8 k + 4 p + q
      unsigned long long mask = 0ull;
      forward_rows<R, true, Ldg>(d, w, ra, S, og, mask);

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
// the largest packed buffer: the 93-wide lead, a 64-wide feature, 4 outputs
constexpr int kMaxCount = (EMB + 3 * H + EMB + H) * H + NB * H + NB * 2 * kMaxC * H +
                          NB * H + H * 4 + 4 + 3 * EMB;
constexpr int kBwdTrainMaxSmem = (TR_WARPS * WPTS * Row<true>::S + kMaxCount) * 4;
static_assert(kBwdTrainMaxSmem <= 232448, "K5's training CTA exceeds Hopper's shared memory");

// K4: the weights (max_count floats, padded to a quad), then the rows
int fwd_smem(int max_count, int warps) {
  return ((max_count + 3) / 4 * 4 + warps * WPTS * FwdRow::S) * 4;
}
constexpr int kFwdMaxSmem = ((kMaxCount + 3) / 4 * 4 + K4_MAX_WARPS * WPTS * FwdRow::S) * 4;
static_assert(kFwdMaxSmem + 16 <= 232448, "K4's CTA exceeds Hopper's shared memory");

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
  e = cudaFuncSetAttribute(decoder_fwd_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, kFwdMaxSmem);
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
// gradient (0: none), emb, fw, out, occ3.  warps, grid: K4's CTAs and their
// warps of 8 points (decoder_stage.py `fwd_geometry`).
int decoder_fwd(const long long* desc, int n_dec, int c, const float* p, float* out,
                int warps, int grid, int n, void* stream) {
  Launch L;
  if (!make_launch(L, desc, n_dec, c, n) || warps < 1 || warps > K4_MAX_WARPS || grid < 1)
    return (int)cudaErrorInvalidValue;
  const int rc = set_attributes_once();
  if (rc) return rc;
  int max_count = 0;
  for (int i = 0; i < n_dec; ++i)
    if (L.d[i].count > max_count) max_count = L.d[i].count;
  const int tile = warps * WPTS;
  decoder_fwd_kernel<<<grid, 32 * warps, fwd_smem(max_count, warps),
                       (cudaStream_t)stream>>>(
      L, p, reinterpret_cast<float4*>(out), (max_count + 3) / 4 * 4, (n + tile - 1) / tile);
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

// K4's dynamic shared memory: the largest packed buffer of the call's
// decoders, warps per CTA
int decoder_fwd_smem(int max_count, int warps) { return fwd_smem(max_count, warps); }

// K5's dynamic shared memory for a launch: train, and the largest packed
// buffer among the decoders that train
int decoder_bwd_smem(int train, int max_count) { return bwd_smem(train != 0, max_count); }

// A kernel's compiled resources (which: 0 K4, 1 K5 where nothing trains,
// 2 K5 where a decoder trains, 3 K6) and its resident CTAs per SM at
// dyn_smem bytes of dynamic shared memory and threads per CTA (0: the
// kernel's own block size; K4's depends on the call): out = registers per
// thread, local bytes per thread, static shared bytes, threads per CTA,
// CTAs per SM.
int decoder_kernel_info(int which, int dyn_smem, int threads, int* out) {
  const void* f;
  switch (which) {
    case 0:
      f = (const void*)decoder_fwd_kernel;
      threads = threads ? threads : K4_MAX_WARPS * 32;
      break;
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
