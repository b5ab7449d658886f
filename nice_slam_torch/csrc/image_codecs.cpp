// Host image codecs of the PyTorch port: a baseline JPEG decoder, PNG row
// unfiltering and a fixed-point bilinear remap (host C++, not device code).
//
// The machines the port runs on need not have an imaging library, so the
// dataset readers decode their files with this.  The JPEG decoder aims at
// the pixels libjpeg(-turbo) gives with its default settings, which is what
// OpenCV's imread returns:
//
//   * Huffman-coded sequential DCT (SOF0, and SOF1 at 8 bits), 1 or 3
//     components at any integer sampling ratio, restart markers, several
//     scans; APPn and COM segments are skipped;
//   * the integer "islow" inverse DCT (libjpeg's jidctint.c) with its
//     range-limit table;
//   * "fancy" triangular chroma upsampling for 2h1v, 1h2v and 2h2v
//     (jdsample.c), edge samples replicated as libjpeg's context rows do,
//     plain replication for other ratios;
//   * the fixed-point YCbCr -> RGB tables of jdcolor.c.
//
// Progressive, arithmetic-coded, lossless, hierarchical and 12-bit files
// are refused with the marker named.  PNG inflating stays in Python (the
// standard library's zlib); only the per-row filters are undone here.
//
// Exposed with a plain C ABI for ctypes.  Every entry returns 0 on success,
// else a nonzero code with a message written to ``err``.
//
// Build: nice_slam_torch/ops/kernels.py compiles it with g++ -O3 -shared
// -fPIC -std=c++17 on first use into build/nice_slam_torch/.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

const int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

struct Error {
  std::string msg;
};

struct Huffman {
  bool defined = false;
  int32_t maxcode[18];
  int32_t valptr[17];
  int32_t mincode[17];
  uint8_t vals[256];
  uint8_t look_len[512];  // 9-bit lookahead: code length, 0 = longer code
  uint8_t look_val[512];
};

void build_huffman(Huffman& h, const uint8_t* bits, const uint8_t* vals,
                   int nvals) {
  std::memset(h.look_len, 0, sizeof(h.look_len));
  std::memcpy(h.vals, vals, nvals);
  int code = 0, k = 0;
  for (int l = 1; l <= 16; ++l) {
    h.valptr[l] = k;
    h.mincode[l] = code;
    for (int i = 0; i < bits[l - 1]; ++i, ++k, ++code) {
      // a canonical code that outgrows its length (libjpeg: "bad Huffman
      // table") would also index past the lookahead tables
      if (code >= (1 << l)) throw Error{"bad Huffman table"};
      if (l <= 9) {
        int lo = code << (9 - l), n = 1 << (9 - l);
        for (int j = 0; j < n; ++j) {
          h.look_len[lo + j] = (uint8_t)l;
          h.look_val[lo + j] = vals[k];
        }
      }
    }
    h.maxcode[l] = bits[l - 1] ? code - 1 : -1;
    code <<= 1;
  }
  h.maxcode[17] = 0x7fffffff;
  h.defined = true;
}

// Entropy-coded data reader: removes the 0x00 after each 0xFF and, like
// libjpeg, feeds zeros once a marker is reached.
struct BitReader {
  const uint8_t* data;
  int64_t n, pos;
  uint64_t buf = 0;
  int bits = 0;
  bool at_marker = false;

  void fill() {
    while (bits <= 56) {
      uint8_t b = 0;
      if (!at_marker && pos < n) {
        b = data[pos];
        if (b == 0xFF) {
          uint8_t nxt = pos + 1 < n ? data[pos + 1] : 0xD9;
          if (nxt == 0x00) {
            pos += 2;
          } else {
            at_marker = true;
            b = 0;
          }
        } else {
          pos += 1;
        }
      }
      buf |= (uint64_t)b << (56 - bits);
      bits += 8;
    }
  }
  uint32_t peek(int k) {
    if (bits < k) fill();
    return (uint32_t)(buf >> (64 - k));
  }
  void skip(int k) {
    buf <<= k;
    bits -= k;
  }
  int get(int k) {
    if (k == 0) return 0;
    uint32_t v = peek(k);
    skip(k);
    return (int)v;
  }
  void reset() {  // byte-align and drop the lookahead before a marker
    buf = 0;
    bits = 0;
    at_marker = false;
  }
};

int decode_huff(BitReader& br, const Huffman& h) {
  uint32_t p = br.peek(16);
  int l = h.look_len[p >> 7];
  if (l) {
    br.skip(l);
    return h.look_val[p >> 7];
  }
  for (l = 10; l <= 16; ++l) {
    int32_t code = (int32_t)(p >> (16 - l));
    if (code <= h.maxcode[l]) {
      br.skip(l);
      return h.vals[h.valptr[l] + code - h.mincode[l]];
    }
  }
  throw Error{"corrupt JPEG data: bad Huffman code"};
}

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

// libjpeg's jidctint.c jpeg_idct_islow: the integer inverse DCT with its
// range-limited output (x + 128 clamped to 0..255 for |x| < 512, wrapping
// as libjpeg's table does beyond).
constexpr int CONST_BITS = 13, PASS1_BITS = 2;
constexpr int64_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196,
                  FIX_0_541196100 = 4433, FIX_0_765366865 = 6270,
                  FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
                  FIX_1_501321110 = 12299, FIX_1_847759065 = 15137,
                  FIX_1_961570560 = 16069, FIX_2_053119869 = 16819,
                  FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) {
  return (x + ((int64_t)1 << (n - 1))) >> n;
}

uint8_t kRangeLimit[1024];

void init_range_limit() {
  for (int i = 0; i < 1024; ++i) {
    int x = i < 512 ? i : i - 1024;
    int v = x + 128;
    kRangeLimit[i] = (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
  }
}

void idct_islow(const int32_t* coef, uint8_t* out, int stride) {
  int64_t ws[64];
  for (int c = 0; c < 8; ++c) {
    const int32_t* in = coef + c;
    int64_t* w = ws + c;
    if (!in[8] && !in[16] && !in[24] && !in[32] && !in[40] && !in[48] &&
        !in[56]) {
      int64_t dc = (int64_t)in[0] * (1 << PASS1_BITS);
      for (int r = 0; r < 8; ++r) w[8 * r] = dc;
      continue;
    }
    int64_t z2 = in[16], z3 = in[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * (-FIX_1_847759065);
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = in[0];
    z3 = in[32];
    int64_t tmp0 = (z2 + z3) * (1 << CONST_BITS);
    int64_t tmp1 = (z2 - z3) * (1 << CONST_BITS);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = in[56];
    tmp1 = in[40];
    tmp2 = in[24];
    tmp3 = in[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = CONST_BITS - PASS1_BITS;
    w[0] = (int32_t)descale(tmp10 + tmp3, sh);
    w[56] = (int32_t)descale(tmp10 - tmp3, sh);
    w[8] = (int32_t)descale(tmp11 + tmp2, sh);
    w[48] = (int32_t)descale(tmp11 - tmp2, sh);
    w[16] = (int32_t)descale(tmp12 + tmp1, sh);
    w[40] = (int32_t)descale(tmp12 - tmp1, sh);
    w[24] = (int32_t)descale(tmp13 + tmp0, sh);
    w[32] = (int32_t)descale(tmp13 - tmp0, sh);
  }
  for (int r = 0; r < 8; ++r) {
    const int64_t* w = ws + 8 * r;
    uint8_t* o = out + (int64_t)r * stride;
    const int sh = CONST_BITS + PASS1_BITS + 3;
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * (-FIX_1_847759065);
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = (w[0] + w[4]) * (1 << CONST_BITS);
    int64_t tmp1 = (w[0] - w[4]) * (1 << CONST_BITS);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 *= FIX_0_298631336;
    tmp1 *= FIX_2_053119869;
    tmp2 *= FIX_3_072711026;
    tmp3 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    o[0] = kRangeLimit[descale(tmp10 + tmp3, sh) & 1023];
    o[7] = kRangeLimit[descale(tmp10 - tmp3, sh) & 1023];
    o[1] = kRangeLimit[descale(tmp11 + tmp2, sh) & 1023];
    o[6] = kRangeLimit[descale(tmp11 - tmp2, sh) & 1023];
    o[2] = kRangeLimit[descale(tmp12 + tmp1, sh) & 1023];
    o[5] = kRangeLimit[descale(tmp12 - tmp1, sh) & 1023];
    o[3] = kRangeLimit[descale(tmp13 + tmp0, sh) & 1023];
    o[4] = kRangeLimit[descale(tmp13 - tmp0, sh) & 1023];
  }
}

struct Component {
  int id, h, v, tq;
  int td = 0, ta = 0;
  int pred = 0;
  int stride = 0, rows = 0;  // decoded sample plane (MCU-padded)
  std::vector<uint8_t> plane;
};

struct Jpeg {
  Jpeg(const uint8_t* data, int64_t size) : d(data), n(size) {}
  const uint8_t* d;
  int64_t n, pos = 0;
  int H = 0, W = 0, ncomp = 0, hmax = 1, vmax = 1, restart = 0;
  bool frame = false;
  int32_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  std::vector<Component> comps;

  uint16_t u16(int64_t p) {
    if (p + 2 > n) throw Error{"truncated JPEG file"};
    return (uint16_t)((d[p] << 8) | d[p + 1]);
  }

  // the next marker code at or after pos (skipping fill bytes)
  int next_marker() {
    while (pos < n && d[pos] != 0xFF) ++pos;
    while (pos < n && d[pos] == 0xFF) ++pos;
    if (pos >= n) throw Error{"truncated JPEG file: no EOI marker"};
    return d[pos++];
  }

  void read_dqt(int64_t p, int64_t end) {
    while (p < end) {
      int pq = d[p] >> 4, tq = d[p] & 15;
      ++p;
      if (pq > 1 || tq > 3) throw Error{"bad DQT table id"};
      if (p + (pq ? 128 : 64) > end) throw Error{"bad DQT segment"};
      for (int i = 0; i < 64; ++i) {
        int v = pq ? u16(p + 2 * i) : d[p + i];
        qt[tq][kZigzag[i]] = v;
      }
      p += pq ? 128 : 64;
      qt_defined[tq] = true;
    }
  }

  void read_dht(int64_t p, int64_t end) {
    while (p < end) {
      int tc = d[p] >> 4, th = d[p] & 15;
      if (tc > 1 || th > 3) throw Error{"bad DHT table id"};
      if (p + 17 > end) throw Error{"bad DHT segment"};
      const uint8_t* bits = d + p + 1;
      int total = 0;
      for (int i = 0; i < 16; ++i) total += bits[i];
      if (total > 256 || p + 17 + total > end)
        throw Error{"bad DHT segment"};
      build_huffman(tc ? ac[th] : dc[th], bits, d + p + 17, total);
      p += 17 + total;
    }
  }

  void read_sof(int64_t p, int64_t end, int marker) {
    if (frame) throw Error{"more than one frame header"};
    if (p + 6 > end) throw Error{"bad JPEG frame header"};
    int precision = d[p];
    if (precision != 8)
      throw Error{"unsupported JPEG: " + std::to_string(precision) +
                  "-bit samples (SOF" + std::to_string(marker - 0xC0) + ")"};
    H = u16(p + 1);
    W = u16(p + 3);
    ncomp = d[p + 5];
    if (H == 0) throw Error{"unsupported JPEG: height defined by DNL"};
    if (W == 0) throw Error{"bad JPEG width 0"};
    if (ncomp != 1 && ncomp != 3)
      throw Error{"unsupported JPEG: " + std::to_string(ncomp) +
                  " components (1 or 3 supported)"};
    if (p + 6 + 3 * ncomp > end) throw Error{"bad JPEG frame header"};
    for (int i = 0; i < ncomp; ++i) {
      Component c;
      c.id = d[p + 6 + 3 * i];
      c.h = d[p + 7 + 3 * i] >> 4;
      c.v = d[p + 7 + 3 * i] & 15;
      c.tq = d[p + 8 + 3 * i];
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
        throw Error{"bad JPEG frame header"};
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
      comps.push_back(c);
    }
    int mcux = (W + 8 * hmax - 1) / (8 * hmax);
    int mcuy = (H + 8 * vmax - 1) / (8 * vmax);
    for (auto& c : comps) {
      if (hmax % c.h || vmax % c.v)
        throw Error{"unsupported JPEG: non-integer sampling ratio"};
      c.stride = mcux * c.h * 8;
      c.rows = mcuy * c.v * 8;
      c.plane.assign((size_t)c.stride * c.rows, 0);
    }
    frame = true;
  }

  void decode_block(BitReader& br, Component& c, int32_t* coef) {
    std::memset(coef, 0, 64 * sizeof(int32_t));
    const Huffman& hd = dc[c.td];
    const Huffman& ha = ac[c.ta];
    int t = decode_huff(br, hd);
    if (t > 11) throw Error{"corrupt JPEG data: bad DC category"};
    int diff = t ? extend(br.get(t), t) : 0;
    c.pred += diff;
    const int32_t* q = qt[c.tq];
    coef[0] = c.pred * q[0];
    for (int k = 1; k < 64; ++k) {
      int rs = decode_huff(br, ha);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        if (k > 63) throw Error{"corrupt JPEG data: AC run past the block"};
        coef[kZigzag[k]] = extend(br.get(s), s) * q[kZigzag[k]];
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  // one scan's entropy-coded segment, starting at pos
  void read_scan(int64_t p, int64_t end) {
    if (p >= end) throw Error{"bad SOS segment"};
    int ns = d[p];
    if (ns < 1 || ns > ncomp || p + 1 + 2 * ns + 3 > end)
      throw Error{"bad SOS segment"};
    std::vector<Component*> sc;
    for (int i = 0; i < ns; ++i) {
      int cid = d[p + 1 + 2 * i], t = d[p + 2 + 2 * i];
      Component* found = nullptr;
      for (auto& c : comps)
        if (c.id == cid) found = &c;
      if (!found) throw Error{"SOS names an unknown component"};
      found->td = t >> 4;
      found->ta = t & 15;
      if (found->td > 3 || found->ta > 3 || !dc[found->td].defined ||
          !ac[found->ta].defined)
        throw Error{"SOS uses an undefined Huffman table"};
      if (!qt_defined[found->tq])
        throw Error{"frame uses an undefined quantization table"};
      sc.push_back(found);
    }
    int ss = d[p + 1 + 2 * ns], se = d[p + 2 + 2 * ns], a = d[p + 3 + 2 * ns];
    if (ss != 0 || se != 63 || a != 0)
      throw Error{"bad SOS spectral selection for a sequential JPEG"};
    pos = end;
    BitReader br{d, n, pos};
    int32_t coef[64];
    int64_t nmcux, nmcuy;
    if (ns == 1) {
      Component& c = *sc[0];
      int cw = (W * c.h + hmax - 1) / hmax, ch = (H * c.v + vmax - 1) / vmax;
      nmcux = (cw + 7) / 8;
      nmcuy = (ch + 7) / 8;
    } else {
      nmcux = (W + 8 * hmax - 1) / (8 * hmax);
      nmcuy = (H + 8 * vmax - 1) / (8 * vmax);
    }
    for (auto* c : sc) c->pred = 0;
    int64_t total = nmcux * nmcuy, todo = restart;
    for (int64_t m = 0; m < total; ++m) {
      if (restart && todo == 0) {
        // byte-align, then expect RSTn
        br.reset();
        int64_t q = br.pos;
        while (q < n && d[q] != 0xFF) ++q;
        while (q < n && d[q] == 0xFF) ++q;
        if (q >= n || d[q] < 0xD0 || d[q] > 0xD7)
          throw Error{"corrupt JPEG data: missing restart marker"};
        br.pos = q + 1;
        for (auto* c : sc) c->pred = 0;
        todo = restart;
      }
      int64_t mx = m % nmcux, my = m / nmcux;
      if (ns == 1) {
        Component& c = *sc[0];
        decode_block(br, c, coef);
        idct_islow(coef, c.plane.data() + my * 8 * c.stride + mx * 8,
                   c.stride);
      } else {
        for (auto* c : sc)
          for (int by = 0; by < c->v; ++by)
            for (int bx = 0; bx < c->h; ++bx) {
              decode_block(br, *c, coef);
              int64_t y0 = (my * c->v + by) * 8, x0 = (mx * c->h + bx) * 8;
              idct_islow(coef, c->plane.data() + y0 * c->stride + x0,
                         c->stride);
            }
      }
      if (restart) --todo;
    }
    // continue at the marker that ends the entropy-coded data
    int64_t q = br.pos;
    while (q < n && !(d[q] == 0xFF && q + 1 < n && d[q + 1] != 0x00 &&
                      !(d[q + 1] >= 0xD0 && d[q + 1] <= 0xD7)))
      ++q;
    pos = q;
  }

  void parse(bool header_only) {
    if (n < 4 || d[0] != 0xFF || d[1] != 0xD8) throw Error{"not a JPEG file"};
    pos = 2;
    bool scanned = false;
    for (;;) {
      if (scanned && pos >= n) break;  // no EOI after the last scan
      int m = next_marker();
      if (m == 0xD9) break;                                   // EOI
      if (m == 0x01 || (m >= 0xD0 && m <= 0xD7)) continue;    // TEM, RSTn
      int64_t len = u16(pos);
      int64_t p = pos + 2, end = pos + len;
      if (len < 2 || end > n) throw Error{"truncated JPEG segment"};
      pos = end;
      switch (m) {
        case 0xC0:
        case 0xC1:
          read_sof(p, end, m);
          if (header_only) return;
          break;
        case 0xC2:
          throw Error{"unsupported JPEG: progressive DCT (SOF2)"};
        case 0xC3:
          throw Error{"unsupported JPEG: lossless (SOF3)"};
        case 0xC5:
        case 0xC6:
        case 0xC7:
          throw Error{"unsupported JPEG: hierarchical (SOF" +
                      std::to_string(m - 0xC0) + ")"};
        case 0xC9:
        case 0xCA:
        case 0xCB:
        case 0xCD:
        case 0xCE:
        case 0xCF:
          throw Error{"unsupported JPEG: arithmetic coding (SOF" +
                      std::to_string(m - 0xC0) + ")"};
        case 0xCC:
          throw Error{"unsupported JPEG: arithmetic coding (DAC)"};
        case 0xC4:
          read_dht(p, end);
          break;
        case 0xDB:
          read_dqt(p, end);
          break;
        case 0xDD:
          if (p + 2 > end) throw Error{"bad DRI segment"};
          restart = u16(p);
          break;
        case 0xDA:
          if (!frame) throw Error{"SOS before the frame header"};
          read_scan(p, end);
          scanned = true;
          break;
        case 0xDC:
          throw Error{"unsupported JPEG: DNL marker"};
        default:  // APPn, COM and others: skipped
          break;
      }
    }
    if (!frame) throw Error{"JPEG file has no frame header"};
  }

  // component ci upsampled to (H, W), as libjpeg's upsampler gives it
  void upsample(const Component& c, uint8_t* out) {
    int hs = hmax / c.h, vs = vmax / c.v;
    int dw = (W * c.h + hmax - 1) / hmax, dh = (H * c.v + vmax - 1) / vmax;
    const uint8_t* in = c.plane.data();
    auto at = [&](int y, int x) -> int {
      y = y < 0 ? 0 : y >= dh ? dh - 1 : y;
      x = x < 0 ? 0 : x >= dw ? dw - 1 : x;
      return in[(int64_t)y * c.stride + x];
    };
    if (hs == 1 && vs == 1) {
      for (int y = 0; y < H; ++y)
        std::memcpy(out + (int64_t)y * W, in + (int64_t)y * c.stride, W);
    } else if (hs == 2 && vs == 1 && dw > 2) {  // h2v1_fancy_upsample
      for (int y = 0; y < H; ++y)
        for (int x = 0; x < W; ++x) {
          int j = x >> 1, nb = (x & 1) ? j + 1 : j - 1;
          int bias = (x & 1) ? 2 : 1;
          out[(int64_t)y * W + x] =
              (uint8_t)((3 * at(y, j) + at(y, nb) + bias) >> 2);
        }
    } else if (hs == 1 && vs == 2) {  // h1v2_fancy_upsample
      for (int y = 0; y < H; ++y) {
        int i = y >> 1, nb = (y & 1) ? i + 1 : i - 1, bias = (y & 1) ? 2 : 1;
        for (int x = 0; x < W; ++x)
          out[(int64_t)y * W + x] =
              (uint8_t)((3 * at(i, x) + at(nb, x) + bias) >> 2);
      }
    } else if (hs == 2 && vs == 2 && dw > 2) {  // h2v2_fancy_upsample
      for (int y = 0; y < H; ++y) {
        int i = y >> 1, nb = (y & 1) ? i + 1 : i - 1;
        for (int x = 0; x < W; ++x) {
          int j = x >> 1, nj = (x & 1) ? j + 1 : j - 1;
          int cur = 3 * at(i, j) + at(nb, j);
          int other = 3 * at(i, nj) + at(nb, nj);
          int bias = (x & 1) ? 7 : 8;
          out[(int64_t)y * W + x] = (uint8_t)((3 * cur + other + bias) >> 4);
        }
      }
    } else {  // replication (int_upsample, and the narrow-image cases)
      for (int y = 0; y < H; ++y)
        for (int x = 0; x < W; ++x)
          out[(int64_t)y * W + x] = in[(int64_t)(y / vs) * c.stride + x / hs];
    }
  }

  void to_pixels(uint8_t* out) {
    if (ncomp == 1) {
      upsample(comps[0], out);
      return;
    }
    std::vector<uint8_t> planes((size_t)3 * H * W);
    for (int c = 0; c < 3; ++c)
      upsample(comps[c], planes.data() + (size_t)c * H * W);
    // jdcolor.c build_ycc_rgb_table / ycc_rgb_convert
    const int SCALEBITS = 16;
    const int64_t ONE_HALF = (int64_t)1 << (SCALEBITS - 1);
    auto fix = [](double x) { return (int64_t)(x * 65536.0 + 0.5); };
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    for (int i = 0; i < 256; ++i) {
      int64_t x = i - 128;
      cr_r[i] = (int)((fix(1.40200) * x + ONE_HALF) >> SCALEBITS);
      cb_b[i] = (int)((fix(1.77200) * x + ONE_HALF) >> SCALEBITS);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + ONE_HALF;
    }
    auto clamp = [](int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); };
    const uint8_t* Y = planes.data();
    const uint8_t* Cb = Y + (size_t)H * W;
    const uint8_t* Cr = Cb + (size_t)H * W;
    for (int64_t i = 0; i < (int64_t)H * W; ++i) {
      int y = Y[i], cb = Cb[i], cr = Cr[i];
      out[3 * i + 0] = clamp(y + cr_r[cr]);
      out[3 * i + 1] = clamp(y + (int)((cb_g[cb] + cr_g[cr]) >> SCALEBITS));
      out[3 * i + 2] = clamp(y + cb_b[cb]);
    }
  }
};

void set_err(char* err, int errlen, const std::string& msg) {
  if (err && errlen > 0) std::snprintf(err, errlen, "%s", msg.c_str());
}

struct RangeInit {
  RangeInit() { init_range_limit(); }
} range_init;

}  // namespace

extern "C" {

// Frame size of a baseline JPEG: dims = (H, W, components).
int jpeg_header(const uint8_t* data, int64_t n, int32_t* dims, char* err,
                int errlen) {
  try {
    Jpeg j(data, n);
    j.parse(true);
    dims[0] = j.H;
    dims[1] = j.W;
    dims[2] = j.ncomp;
    return 0;
  } catch (const Error& e) {
    set_err(err, errlen, e.msg);
    return 1;
  } catch (const std::bad_alloc&) {
    set_err(err, errlen, "out of memory");
    return 2;
  }
}

// Decode into out: (H, W) gray or (H, W, 3) RGB, uint8.
int jpeg_decode(const uint8_t* data, int64_t n, uint8_t* out, char* err,
                int errlen) {
  try {
    Jpeg j(data, n);
    j.parse(false);
    j.to_pixels(out);
    return 0;
  } catch (const Error& e) {
    set_err(err, errlen, e.msg);
    return 1;
  } catch (const std::bad_alloc&) {
    set_err(err, errlen, "out of memory");
    return 2;
  }
}

// Undo PNG's per-row filters: raw holds H rows of (1 filter byte + rowbytes),
// out receives H rows of rowbytes; bpp is bytes per complete pixel (>= 1).
int png_unfilter(const uint8_t* raw, int64_t H, int64_t rowbytes, int bpp,
                 uint8_t* out, char* err, int errlen) {
  std::vector<uint8_t> zero(rowbytes, 0);
  for (int64_t y = 0; y < H; ++y) {
    const uint8_t* src = raw + y * (rowbytes + 1);
    int ft = src[0];
    ++src;
    uint8_t* cur = out + y * rowbytes;
    const uint8_t* up = y ? out + (y - 1) * rowbytes : zero.data();
    switch (ft) {
      case 0:
        std::memcpy(cur, src, rowbytes);
        break;
      case 1:
        for (int64_t i = 0; i < rowbytes; ++i)
          cur[i] = (uint8_t)(src[i] + (i >= bpp ? cur[i - bpp] : 0));
        break;
      case 2:
        for (int64_t i = 0; i < rowbytes; ++i) cur[i] = (uint8_t)(src[i] + up[i]);
        break;
      case 3:
        for (int64_t i = 0; i < rowbytes; ++i) {
          int a = i >= bpp ? cur[i - bpp] : 0;
          cur[i] = (uint8_t)(src[i] + ((a + up[i]) >> 1));
        }
        break;
      case 4:
        for (int64_t i = 0; i < rowbytes; ++i) {
          int a = i >= bpp ? cur[i - bpp] : 0, b = up[i];
          int c = i >= bpp ? up[i - bpp] : 0;
          int p = a + b - c;
          int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
          int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          cur[i] = (uint8_t)(src[i] + pred);
        }
        break;
      default:
        set_err(err, errlen,
                "corrupt PNG data: filter type " + std::to_string(ft) +
                    " on row " + std::to_string(y));
        return 1;
    }
  }
  return 0;
}

// Bilinear remap of an (H, W, C) uint8 image at fixed-point source
// coordinates (1/32 px: ix, iy per output pixel), with 15-bit weights
// wtab[32 * 32][4] (corners (0,0), (0,1), (1,0), (1,1)) and a constant-0
// border: a corner outside the image reads 0.
void remap_bilinear_u8(const uint8_t* src, int H, int W, int C,
                       const int32_t* ix, const int32_t* iy, int64_t n,
                       const int32_t* wtab, uint8_t* out) {
  for (int64_t p = 0; p < n; ++p) {
    int sx = ix[p] >> 5, sy = iy[p] >> 5;
    const int32_t* w = wtab + 4 * ((iy[p] & 31) * 32 + (ix[p] & 31));
    for (int c = 0; c < C; ++c) {
      int64_t acc = 0;
      for (int k = 0; k < 4; ++k) {
        int yy = sy + (k >> 1), xx = sx + (k & 1);
        if (yy >= 0 && yy < H && xx >= 0 && xx < W)
          acc += (int64_t)w[k] * src[((int64_t)yy * W + xx) * C + c];
      }
      int64_t v = (acc + (1 << 14)) >> 15;
      out[p * C + c] = (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v);
    }
  }
}

}  // extern "C"
