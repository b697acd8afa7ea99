// Host image codec of the port's dataset readers (utils/imageio.py).
//
// - A baseline JPEG decoder (SOF0/SOF1, Huffman, DRI restarts, 1 or 3
//   components, luma sampling 1x1, 2x1 or 2x2 over 1x1 chroma) whose output
//   equals libjpeg-turbo's default decode (what cv2.imread and PIL give):
//   the integer "islow" IDCT (jidctint.c jpeg_idct_islow), "fancy"
//   triangle upsampling of the chroma (jdsample.c h2v1_fancy_upsample,
//   h2v2_fancy_upsample, with the edge rows and columns repeated as
//   jdmainct.c's context pointers repeat them) and the fixed-point
//   YCbCr->RGB tables (jdcolor.c build_ycc_rgb_table, ycc_rgb_convert).
//   libjpeg-turbo's SIMD paths are bit-exact with these C algorithms.
//   Progressive, lossless, hierarchical and arithmetic-coded files, and an
//   EXIF orientation other than 1 (which cv2.imread would apply), raise.
// - A baseline JPEG encoder: 4:2:0, the Annex K quantisation tables scaled
//   by the IJG quality rule and the Annex K Huffman tables.
// - PNG unfiltering (None, Sub, Up, Average, Paeth) of an inflated,
//   non-interlaced image; the inflate and the chunk parsing are Python's.
//
// C interface for ctypes; each entry returns 0, or -1 with a message in
// `err` (errlen bytes).

#include <algorithm>
#include <cmath>
#include <cstdarg>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct CodecError {
  std::string msg;
};

[[noreturn]] void fail(const char* fmt, ...) {
  char buf[256];
  va_list ap;
  va_start(ap, fmt);
  vsnprintf(buf, sizeof buf, fmt, ap);
  va_end(ap);
  throw CodecError{buf};
}

int report(const CodecError& e, char* err, int errlen) {
  if (err && errlen > 0) {
    snprintf(err, errlen, "%s", e.msg.c_str());
  }
  return -1;
}

// zigzag index -> natural index; 16 extra entries keep a corrupt run
// inside the block, as libjpeg's jpeg_natural_order does
const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// ---------------------------------------------------------------------------
// JPEG decoder

struct Huffman {
  bool defined = false;
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];

  void build(const uint8_t counts[17], const uint8_t* v, int nv) {
    memcpy(vals, v, nv);
    int32_t code = 0;
    int p = 0;
    for (int l = 1; l <= 16; l++) {
      if (counts[l]) {
        valoffset[l] = p - code;
        p += counts[l];
        code += counts[l];
        maxcode[l] = code - 1;
      } else {
        maxcode[l] = -1;
      }
      if (code > (1 << l)) fail("bad Huffman table");
      code <<= 1;
    }
    maxcode[17] = 0x7fffffff;
    defined = true;
  }
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;
  int dsw = 0, dsh = 0;  // downsampled width and height (samples)
  int pw = 0, ph = 0;    // plane: MCU-padded width and height
  int dc_pred = 0;
  std::vector<uint8_t> plane;
};

class BitReader {
 public:
  BitReader(const uint8_t* d, size_t n, size_t pos) : d_(d), n_(n), pos_(pos) {}

  int bits(int s) {
    while (cnt_ < s) fill();
    int v = int((buf_ >> (cnt_ - s)) & ((1u << s) - 1));
    cnt_ -= s;
    return v;
  }

  int bit() { return bits(1); }

  // discard the rest of the byte and expect RSTn
  void restart(int expect) {
    cnt_ = 0;
    buf_ = 0;
    marker_ = false;
    while (pos_ + 1 < n_ && d_[pos_] == 0xFF && d_[pos_ + 1] == 0xFF) pos_++;
    if (pos_ + 1 >= n_ || d_[pos_] != 0xFF ||
        d_[pos_ + 1] != 0xD0 + expect) {
      fail("restart marker RST%d missing", expect);
    }
    pos_ += 2;
  }

  size_t pos() const { return pos_; }

 private:
  void fill() {
    // past a marker (or the end) the decoder reads zeros, as libjpeg does
    uint32_t byte = 0;
    if (!marker_ && pos_ < n_) {
      uint8_t b = d_[pos_];
      if (b == 0xFF) {
        uint8_t b2 = pos_ + 1 < n_ ? d_[pos_ + 1] : 0xD9;
        if (b2 == 0x00) {
          byte = 0xFF;
          pos_ += 2;
        } else {
          marker_ = true;
        }
      } else {
        byte = b;
        pos_++;
      }
    }
    buf_ = (buf_ << 8) | byte;
    cnt_ += 8;
  }

  const uint8_t* d_;
  size_t n_, pos_;
  uint32_t buf_ = 0;
  int cnt_ = 0;
  bool marker_ = false;
};

int decode_huff(BitReader& br, const Huffman& t) {
  int32_t code = br.bit();
  int l = 1;
  while (code > t.maxcode[l]) {
    code = (code << 1) | br.bit();
    if (++l > 16) fail("corrupt Huffman code");
  }
  int idx = code + t.valoffset[l];
  if (idx < 0 || idx > 255) fail("corrupt Huffman code");
  return t.vals[idx];
}

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

// jidctint.c jpeg_idct_islow: CONST_BITS 13, PASS1_BITS 2
const int64_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196,
              FIX_0_541196100 = 4433, FIX_0_765366865 = 6270,
              FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
              FIX_1_501321110 = 12299, FIX_1_847759065 = 15137,
              FIX_1_961570560 = 16069, FIX_2_053119869 = 16819,
              FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

inline int64_t descale(int64_t x, int n) {
  return (x + (int64_t(1) << (n - 1))) >> n;
}

// the post-IDCT range limit of jdmaster.c prepare_range_limit_table:
// idx = value & 1023, values in [-128, 127] + 128, larger 255, smaller 0
inline uint8_t idct_limit(int64_t v) {
  int idx = int(v) & 1023;
  if (idx < 128) return uint8_t(idx + 128);
  if (idx < 512) return 255;
  if (idx < 896) return 0;
  return uint8_t(idx - 896);
}

void idct_islow(const int16_t* coef, const uint16_t* q, uint8_t* out,
                int stride) {
  const int CB = 13, P1 = 2;
  int ws[64];
  for (int c = 0; c < 8; c++) {
    const int16_t* in = coef + c;
    const uint16_t* qp = q + c;
    int* w = ws + c;
    if (in[8] == 0 && in[16] == 0 && in[24] == 0 && in[32] == 0 &&
        in[40] == 0 && in[48] == 0 && in[56] == 0) {
      int dc = (int(in[0]) * int(qp[0])) * (1 << P1);
      for (int r = 0; r < 8; r++) w[8 * r] = dc;
      continue;
    }
    int64_t z2 = int64_t(in[16]) * qp[16], z3 = int64_t(in[48]) * qp[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = int64_t(in[0]) * qp[0];
    z3 = int64_t(in[32]) * qp[32];
    int64_t tmp0 = (z2 + z3) * (int64_t(1) << CB);
    int64_t tmp1 = (z2 - z3) * (int64_t(1) << CB);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;

    tmp0 = int64_t(in[56]) * qp[56];
    tmp1 = int64_t(in[40]) * qp[40];
    tmp2 = int64_t(in[24]) * qp[24];
    tmp3 = int64_t(in[8]) * qp[8];
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
    w[0] = int(descale(tmp10 + tmp3, CB - P1));
    w[56] = int(descale(tmp10 - tmp3, CB - P1));
    w[8] = int(descale(tmp11 + tmp2, CB - P1));
    w[48] = int(descale(tmp11 - tmp2, CB - P1));
    w[16] = int(descale(tmp12 + tmp1, CB - P1));
    w[40] = int(descale(tmp12 - tmp1, CB - P1));
    w[24] = int(descale(tmp13 + tmp0, CB - P1));
    w[32] = int(descale(tmp13 - tmp0, CB - P1));
  }
  for (int r = 0; r < 8; r++) {
    const int* w = ws + 8 * r;
    uint8_t* o = out + size_t(r) * stride;
    if (w[1] == 0 && w[2] == 0 && w[3] == 0 && w[4] == 0 && w[5] == 0 &&
        w[6] == 0 && w[7] == 0) {
      uint8_t dc = idct_limit(descale(int64_t(w[0]), P1 + 3));
      for (int c = 0; c < 8; c++) o[c] = dc;
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = (int64_t(w[0]) + w[4]) * (int64_t(1) << CB);
    int64_t tmp1 = (int64_t(w[0]) - w[4]) * (int64_t(1) << CB);
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
    const int S = CB + P1 + 3;
    o[0] = idct_limit(descale(tmp10 + tmp3, S));
    o[7] = idct_limit(descale(tmp10 - tmp3, S));
    o[1] = idct_limit(descale(tmp11 + tmp2, S));
    o[6] = idct_limit(descale(tmp11 - tmp2, S));
    o[2] = idct_limit(descale(tmp12 + tmp1, S));
    o[5] = idct_limit(descale(tmp12 - tmp1, S));
    o[3] = idct_limit(descale(tmp13 + tmp0, S));
    o[4] = idct_limit(descale(tmp13 - tmp0, S));
  }
}

struct Jpeg {
  const uint8_t* d;
  size_t n;
  int width = 0, height = 0, hmax = 1, vmax = 1;
  bool have_frame = false, saw_jfif = false, saw_adobe = false;
  int adobe_transform = 1;
  int restart_interval = 0;
  int orientation = 1;
  std::vector<Component> comps;
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  Huffman dc[4], ac[4];

  Jpeg(const uint8_t* data, size_t size) : d(data), n(size) {}

  int u16(size_t p) const {
    if (p + 1 >= n) fail("truncated JPEG");
    return (d[p] << 8) | d[p + 1];
  }

  void parse_sof(size_t p, int len) {
    if (have_frame) fail("more than one frame header");
    if (len < 8) fail("short SOF segment");
    if (d[p] != 8) fail("sample precision %d is not 8", d[p]);
    height = u16(p + 1);
    width = u16(p + 3);
    int nc = d[p + 5];
    if (height == 0) fail("height 0 (DNL) not supported");
    if (width == 0) fail("width 0");
    if (nc != 1 && nc != 3) fail("%d components (1 or 3 supported)", nc);
    if (len < 6 + 3 * nc) fail("short SOF segment");
    comps.resize(nc);
    hmax = vmax = 1;
    for (int i = 0; i < nc; i++) {
      Component& c = comps[i];
      c.id = d[p + 6 + 3 * i];
      c.h = d[p + 7 + 3 * i] >> 4;
      c.v = d[p + 7 + 3 * i] & 15;
      c.tq = d[p + 8 + 3 * i];
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
        fail("bad component parameters");
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    if (nc == 1) {
      comps[0].h = comps[0].v = hmax = vmax = 1;
    } else {
      bool ok = comps[0].h == hmax && comps[0].v == vmax &&
                ((hmax == 1 && vmax == 1) || (hmax == 2 && vmax == 1) ||
                 (hmax == 2 && vmax == 2));
      for (int i = 1; i < nc; i++) ok = ok && comps[i].h == 1 && comps[i].v == 1;
      if (!ok)
        fail("sampling %dx%d,%dx%d,%dx%d not supported (luma 1x1, 2x1 or "
             "2x2 over 1x1 chroma)", comps[0].h, comps[0].v, comps[1].h,
             comps[1].v, comps[2].h, comps[2].v);
    }
    int mcux = (width + 8 * hmax - 1) / (8 * hmax);
    int mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (Component& c : comps) {
      c.dsw = (width * c.h + hmax - 1) / hmax;
      c.dsh = (height * c.v + vmax - 1) / vmax;
      c.pw = mcux * c.h * 8;
      c.ph = mcuy * c.v * 8;
      c.plane.assign(size_t(c.pw) * c.ph, 0);
    }
    have_frame = true;
  }

  void parse_dht(size_t p, int len) {
    size_t end = p + len;
    while (p < end) {
      int tc = d[p] >> 4, th = d[p] & 15;
      if (tc > 1 || th > 3) fail("bad Huffman table id");
      if (p + 17 > end) fail("short DHT segment");
      uint8_t counts[17] = {0};
      int total = 0;
      for (int i = 1; i <= 16; i++) {
        counts[i] = d[p + i];
        total += counts[i];
      }
      if (total > 256 || p + 17 + total > end) fail("bad DHT segment");
      (tc == 0 ? dc[th] : ac[th]).build(counts, d + p + 17, total);
      p += 17 + total;
    }
  }

  void parse_dqt(size_t p, int len) {
    size_t end = p + len;
    while (p < end) {
      int pq = d[p] >> 4, tq = d[p] & 15;
      if (tq > 3 || pq > 1) fail("bad quantisation table");
      if (p + 1 + 64 * (pq + 1) > end) fail("short DQT segment");
      for (int k = 0; k < 64; k++) {
        int v = pq ? (d[p + 1 + 2 * k] << 8) | d[p + 2 + 2 * k]
                   : d[p + 1 + k];
        qt[tq][kNatural[k]] = uint16_t(v);
      }
      qt_defined[tq] = true;
      p += 1 + 64 * (pq + 1);
    }
  }

  // the orientation tag (0x0112) of an Exif APP1's first IFD
  void parse_exif(size_t p, int len) {
    if (len < 14 || memcmp(d + p, "Exif\0\0", 6) != 0) return;
    const uint8_t* t = d + p + 6;
    size_t tn = size_t(len) - 6;
    bool le;
    if (t[0] == 'I' && t[1] == 'I') le = true;
    else if (t[0] == 'M' && t[1] == 'M') le = false;
    else return;
    auto rd16 = [&](size_t o) -> uint32_t {
      return le ? t[o] | (t[o + 1] << 8) : (t[o] << 8) | t[o + 1];
    };
    auto rd32 = [&](size_t o) -> uint32_t {
      return le ? t[o] | (t[o + 1] << 8) | (t[o + 2] << 16) |
                      (uint32_t(t[o + 3]) << 24)
                : (uint32_t(t[o]) << 24) | (t[o + 1] << 16) |
                      (t[o + 2] << 8) | t[o + 3];
    };
    uint32_t ifd = rd32(4);
    if (size_t(ifd) + 2 > tn) return;
    uint32_t count = rd16(ifd);
    for (uint32_t i = 0; i < count; i++) {
      size_t e = size_t(ifd) + 2 + 12 * size_t(i);
      if (e + 12 > tn) return;
      if (rd16(e) == 0x0112) orientation = int(rd16(e + 8));
    }
  }

  void decode_block(BitReader& br, Component& c, int bx, int by) {
    const Huffman& hd = dc[c.td];
    const Huffman& ha = ac[c.ta];
    int16_t coef[64] = {0};
    int s = decode_huff(br, hd);
    if (s > 16) fail("corrupt DC code");
    int diff = s ? extend(br.bits(s), s) : 0;
    c.dc_pred += diff;
    coef[0] = int16_t(c.dc_pred);
    for (int k = 1; k < 64; k++) {
      int rs = decode_huff(br, ha);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        coef[kNatural[k]] = int16_t(extend(br.bits(s), s));
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
    idct_islow(coef, qt[c.tq],
               c.plane.data() + size_t(by) * 8 * c.pw + size_t(bx) * 8, c.pw);
  }

  size_t decode_scan(size_t p, int len) {
    if (!have_frame) fail("scan before the frame header");
    int ns = d[p];
    if (ns < 1 || ns > 4 || len < 4 + 2 * ns) fail("bad SOS segment");
    std::vector<Component*> sc;
    for (int i = 0; i < ns; i++) {
      int cid = d[p + 1 + 2 * i];
      Component* c = nullptr;
      for (Component& k : comps)
        if (k.id == cid) c = &k;
      if (!c) fail("scan names an unknown component %d", cid);
      c->td = d[p + 2 + 2 * i] >> 4;
      c->ta = d[p + 2 + 2 * i] & 15;
      if (c->td > 3 || c->ta > 3 || !dc[c->td].defined ||
          !ac[c->ta].defined)
        fail("scan uses an undefined Huffman table");
      if (!qt_defined[c->tq]) fail("undefined quantisation table");
      sc.push_back(c);
    }
    int ss = d[p + 1 + 2 * ns], se = d[p + 2 + 2 * ns],
        ahal = d[p + 3 + 2 * ns];
    if (ss != 0 || se != 63 || ahal != 0)
      fail("not a sequential scan (Ss %d, Se %d)", ss, se);
    for (Component* c : sc) c->dc_pred = 0;

    BitReader br(d, n, p + len);
    int mcux, mcuy;
    if (ns == 1) {
      mcux = (sc[0]->dsw + 7) / 8;
      mcuy = (sc[0]->dsh + 7) / 8;
    } else {
      mcux = (width + 8 * hmax - 1) / (8 * hmax);
      mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    }
    long total = long(mcux) * mcuy;
    int rst = 0;
    for (long m = 0; m < total; m++) {
      if (restart_interval && m > 0 && m % restart_interval == 0) {
        br.restart(rst);
        rst = (rst + 1) & 7;
        for (Component* c : sc) c->dc_pred = 0;
      }
      int mx = int(m % mcux), my = int(m / mcux);
      if (ns == 1) {
        decode_block(br, *sc[0], mx, my);
      } else {
        for (Component* c : sc)
          for (int y = 0; y < c->v; y++)
            for (int x = 0; x < c->h; x++)
              decode_block(br, *c, mx * c->h + x, my * c->v + y);
      }
    }
    // the next marker
    size_t q = br.pos();
    while (q + 1 < n && !(d[q] == 0xFF && d[q + 1] != 0 &&
                          !(d[q + 1] >= 0xD0 && d[q + 1] <= 0xD7)))
      q++;
    return q;
  }

  void parse() {
    if (n < 4 || d[0] != 0xFF || d[1] != 0xD8) fail("not a JPEG (no SOI)");
    size_t p = 2;
    bool scanned = false;
    while (true) {
      while (p < n && d[p] != 0xFF) p++;
      while (p < n && d[p] == 0xFF) p++;
      if (p >= n) {
        if (scanned) return;  // libjpeg accepts a missing EOI
        fail("truncated JPEG");
      }
      int m = d[p++];
      if (m == 0xD9) return;
      if (m == 0x01 || (m >= 0xD0 && m <= 0xD7)) continue;
      int len = u16(p);
      if (len < 2 || p + len > n) fail("bad segment length");
      size_t body = p + 2;
      int blen = len - 2;
      switch (m) {
        case 0xC0:
        case 0xC1:
          parse_sof(body, blen);
          break;
        case 0xC2:
        case 0xC6:
        case 0xCA:
        case 0xCE:
          fail("progressive JPEG not supported");
        case 0xC3:
        case 0xC5:
        case 0xC7:
        case 0xCB:
        case 0xCF:
          fail("lossless or hierarchical JPEG not supported");
        case 0xC9:
        case 0xCD:
        case 0xCC:
          fail("arithmetic-coded JPEG not supported");
        case 0xC4:
          parse_dht(body, blen);
          break;
        case 0xDB:
          parse_dqt(body, blen);
          break;
        case 0xDD:
          if (blen < 2) fail("short DRI segment");
          restart_interval = u16(body);
          break;
        case 0xE0:
          if (blen >= 5 && memcmp(d + body, "JFIF\0", 5) == 0) saw_jfif = true;
          break;
        case 0xE1:
          parse_exif(body, blen);
          if (orientation != 1)
            fail("EXIF orientation %d (only 1 is supported)", orientation);
          break;
        case 0xEE:
          if (blen >= 12 && memcmp(d + body, "Adobe", 5) == 0) {
            saw_adobe = true;
            adobe_transform = d[body + 11];
          }
          break;
        case 0xDA:
          p = decode_scan(body, blen);
          scanned = true;
          continue;
        default:
          break;
      }
      p += len;
    }
  }

  // jdapimin.c default_decompress_parms: is a 3-component file RGB?
  bool is_rgb() const {
    if (saw_jfif) return false;
    if (saw_adobe) return adobe_transform == 0;
    return comps[0].id == 'R' && comps[1].id == 'G' && comps[2].id == 'B';
  }
};

// one component upsampled to the image's width and height
std::vector<uint8_t> upsample(const Jpeg& j, const Component& c) {
  const int W = j.width, H = j.height;
  std::vector<uint8_t> out(size_t(W) * H);
  const int rx = j.hmax / c.h, ry = j.vmax / c.v;
  const int dw = c.dsw, dh = c.dsh;
  auto in = [&](int r) { return c.plane.data() + size_t(r) * c.pw; };
  std::vector<uint8_t> row(size_t(2) * dw + 2);
  if (rx == 1 && ry == 1) {
    for (int y = 0; y < H; y++) memcpy(out.data() + size_t(y) * W, in(y), W);
  } else if (ry == 1) {  // h2v1
    for (int y = 0; y < H; y++) {
      const uint8_t* ip = in(y);
      uint8_t* op = row.data();
      if (dw > 2) {
        int v = ip[0];
        op[0] = uint8_t(v);
        op[1] = uint8_t((v * 3 + ip[1] + 2) >> 2);
        for (int x = 1; x < dw - 1; x++) {
          v = ip[x] * 3;
          op[2 * x] = uint8_t((v + ip[x - 1] + 1) >> 2);
          op[2 * x + 1] = uint8_t((v + ip[x + 1] + 2) >> 2);
        }
        v = ip[dw - 1];
        op[2 * dw - 2] = uint8_t((v * 3 + ip[dw - 2] + 1) >> 2);
        op[2 * dw - 1] = uint8_t(v);
      } else {
        for (int x = 0; x < dw; x++) op[2 * x] = op[2 * x + 1] = ip[x];
      }
      memcpy(out.data() + size_t(y) * W, op, W);
    }
  } else {  // h2v2
    for (int r = 0; r < dh; r++) {
      for (int v = 0; v < 2; v++) {
        int y = 2 * r + v;
        if (y >= H) break;
        const uint8_t* i0 = in(r);
        uint8_t* op = row.data();
        if (dw > 2) {
          const uint8_t* i1 = in(v == 0 ? std::max(r - 1, 0)
                                        : std::min(r + 1, dh - 1));
          int thiscol = i0[0] * 3 + i1[0];
          int nextcol = i0[1] * 3 + i1[1];
          op[0] = uint8_t((thiscol * 4 + 8) >> 4);
          op[1] = uint8_t((thiscol * 3 + nextcol + 7) >> 4);
          int lastcol = thiscol;
          thiscol = nextcol;
          for (int x = 1; x < dw - 1; x++) {
            nextcol = i0[x + 1] * 3 + i1[x + 1];
            op[2 * x] = uint8_t((thiscol * 3 + lastcol + 8) >> 4);
            op[2 * x + 1] = uint8_t((thiscol * 3 + nextcol + 7) >> 4);
            lastcol = thiscol;
            thiscol = nextcol;
          }
          op[2 * dw - 2] = uint8_t((thiscol * 3 + lastcol + 8) >> 4);
          op[2 * dw - 1] = uint8_t((thiscol * 4 + 7) >> 4);
        } else {
          for (int x = 0; x < dw; x++) op[2 * x] = op[2 * x + 1] = i0[x];
        }
        memcpy(out.data() + size_t(y) * W, op, W);
      }
    }
  }
  return out;
}

void to_rgb(const Jpeg& j, uint8_t* out) {
  const size_t npix = size_t(j.width) * j.height;
  if (j.comps.size() == 1) {
    std::vector<uint8_t> y = upsample(j, j.comps[0]);
    for (size_t i = 0; i < npix; i++)
      out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = y[i];
    return;
  }
  std::vector<uint8_t> p0 = upsample(j, j.comps[0]);
  std::vector<uint8_t> p1 = upsample(j, j.comps[1]);
  std::vector<uint8_t> p2 = upsample(j, j.comps[2]);
  if (j.is_rgb()) {
    for (size_t i = 0; i < npix; i++) {
      out[3 * i] = p0[i];
      out[3 * i + 1] = p1[i];
      out[3 * i + 2] = p2[i];
    }
    return;
  }
  // jdcolor.c build_ycc_rgb_table (SCALEBITS 16)
  const int64_t ONE_HALF = int64_t(1) << 15;
  auto fix = [](double x) { return int64_t(x * 65536.0 + 0.5); };
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  for (int i = 0, x = -128; i < 256; i++, x++) {
    cr_r[i] = int((fix(1.40200) * x + ONE_HALF) >> 16);
    cb_b[i] = int((fix(1.77200) * x + ONE_HALF) >> 16);
    cr_g[i] = -fix(0.71414) * x;
    cb_g[i] = -fix(0.34414) * x + ONE_HALF;
  }
  auto lim = [](int v) { return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v); };
  for (size_t i = 0; i < npix; i++) {
    int y = p0[i], cb = p1[i], cr = p2[i];
    out[3 * i] = lim(y + cr_r[cr]);
    out[3 * i + 1] = lim(y + int((cb_g[cb] + cr_g[cr]) >> 16));
    out[3 * i + 2] = lim(y + cb_b[cb]);
  }
}

// ---------------------------------------------------------------------------
// JPEG encoder (baseline, 4:2:0)

const uint8_t kStdLumQ[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const uint8_t kStdChromQ[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

// Annex K.3 tables: counts of codes of length 1..16, then the symbols
const uint8_t kDcLumBits[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromBits[16] = {0, 3, 1, 1, 1, 1, 1, 1,
                                  1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumBits[16] = {0, 2, 1, 3, 3, 2, 4, 3,
                                5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromBits[16] = {0, 2, 1, 2, 4, 4, 3, 4,
                                  7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct Code {
  uint16_t code = 0;
  uint8_t len = 0;
};

void build_codes(const uint8_t bits[16], const uint8_t* vals, Code out[256]) {
  int code = 0, k = 0;
  for (int l = 1; l <= 16; l++) {
    for (int i = 0; i < bits[l - 1]; i++) {
      out[vals[k++]] = Code{uint16_t(code), uint8_t(l)};
      code++;
    }
    code <<= 1;
  }
}

class BitWriter {
 public:
  explicit BitWriter(std::vector<uint8_t>& out) : out_(out) {}
  void put(uint32_t bits, int n) {
    acc_ = (acc_ << n) | (bits & ((1u << n) - 1));
    cnt_ += n;
    while (cnt_ >= 8) {
      uint8_t b = uint8_t(acc_ >> (cnt_ - 8));
      out_.push_back(b);
      if (b == 0xFF) out_.push_back(0);
      cnt_ -= 8;
    }
  }
  void flush() {
    if (cnt_ > 0) put((1u << (8 - cnt_)) - 1, 8 - cnt_);
  }

 private:
  std::vector<uint8_t>& out_;
  uint64_t acc_ = 0;
  int cnt_ = 0;
};

int bit_size(int v) {
  v = v < 0 ? -v : v;
  int s = 0;
  while (v) {
    s++;
    v >>= 1;
  }
  return s;
}

void encode_block(BitWriter& bw, const float* blk, const float* qdiv,
                  int& dc_pred, const Code* dct, const Code* act) {
  struct CosTable {
    float v[8][8];
    CosTable() {
      for (int x = 0; x < 8; x++)
        for (int u = 0; u < 8; u++)
          v[x][u] = float(std::cos((2 * x + 1) * u * M_PI / 16.0));
    }
  };
  static const CosTable table;  // initialised once, thread-safe
  const auto& cosv = table.v;
  float tmp[64];
  for (int y = 0; y < 8; y++)
    for (int u = 0; u < 8; u++) {
      float s = 0;
      for (int x = 0; x < 8; x++) s += blk[y * 8 + x] * cosv[x][u];
      tmp[y * 8 + u] = s * (u == 0 ? float(M_SQRT1_2) : 1.0f) * 0.5f;
    }
  int q[64];
  for (int v = 0; v < 8; v++)
    for (int u = 0; u < 8; u++) {
      float s = 0;
      for (int y = 0; y < 8; y++) s += tmp[y * 8 + u] * cosv[y][v];
      s *= (v == 0 ? float(M_SQRT1_2) : 1.0f) * 0.5f;
      q[v * 8 + u] = int(std::lround(s / qdiv[v * 8 + u]));
    }
  int diff = q[0] - dc_pred;
  dc_pred = q[0];
  int s = bit_size(diff);
  bw.put(dct[s].code, dct[s].len);
  if (s) bw.put(diff < 0 ? diff - 1 : diff, s);
  int run = 0;
  for (int k = 1; k < 64; k++) {
    int v = q[kNatural[k]];
    if (v == 0) {
      run++;
      continue;
    }
    while (run > 15) {
      bw.put(act[0xF0].code, act[0xF0].len);
      run -= 16;
    }
    s = bit_size(v);
    int sym = (run << 4) | s;
    bw.put(act[sym].code, act[sym].len);
    bw.put(v < 0 ? v - 1 : v, s);
    run = 0;
  }
  if (run) bw.put(act[0].code, act[0].len);
}

void scale_table(const uint8_t* base, int quality, uint8_t* out) {
  quality = std::min(std::max(quality, 1), 100);
  int scale = quality < 50 ? 5000 / quality : 200 - 2 * quality;
  for (int k = 0; k < 64; k++) {
    int v = (base[k] * scale + 50) / 100;
    out[k] = uint8_t(std::min(std::max(v, 1), 255));
  }
}

void put16(std::vector<uint8_t>& o, int v) {
  o.push_back(uint8_t(v >> 8));
  o.push_back(uint8_t(v & 255));
}

std::vector<uint8_t> encode(const uint8_t* rgb, int H, int W, int quality) {
  if (H < 1 || W < 1 || H > 65535 || W > 65535) fail("bad image size");
  uint8_t ql[64], qc[64];
  scale_table(kStdLumQ, quality, ql);
  scale_table(kStdChromQ, quality, qc);
  std::vector<uint8_t> o;
  o.reserve(size_t(H) * W / 2 + 1024);
  const uint8_t app0[] = {0xFF, 0xD8, 0xFF, 0xE0, 0, 16, 'J', 'F', 'I', 'F',
                          0, 1, 1, 0, 0, 1, 0, 1, 0, 0};
  o.insert(o.end(), app0, app0 + sizeof app0);
  for (int t = 0; t < 2; t++) {
    o.push_back(0xFF);
    o.push_back(0xDB);
    put16(o, 67);
    o.push_back(uint8_t(t));
    const uint8_t* q = t ? qc : ql;
    for (int k = 0; k < 64; k++) o.push_back(q[kNatural[k]]);
  }
  o.push_back(0xFF);
  o.push_back(0xC0);
  put16(o, 17);
  o.push_back(8);
  put16(o, H);
  put16(o, W);
  o.push_back(3);
  const uint8_t comps[9] = {1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1};
  o.insert(o.end(), comps, comps + 9);
  struct T {
    int cls, id;
    const uint8_t* bits;
    const uint8_t* vals;
    int nv;
  } tables[4] = {{0, 0, kDcLumBits, kDcVals, 12},
                 {1, 0, kAcLumBits, kAcLumVals, 162},
                 {0, 1, kDcChromBits, kDcVals, 12},
                 {1, 1, kAcChromBits, kAcChromVals, 162}};
  for (const T& t : tables) {
    o.push_back(0xFF);
    o.push_back(0xC4);
    put16(o, 2 + 1 + 16 + t.nv);
    o.push_back(uint8_t(t.cls << 4 | t.id));
    o.insert(o.end(), t.bits, t.bits + 16);
    o.insert(o.end(), t.vals, t.vals + t.nv);
  }
  const uint8_t sos[] = {0xFF, 0xDA, 0, 12, 3, 1, 0x00, 2, 0x11, 3, 0x11,
                         0, 63, 0};
  o.insert(o.end(), sos, sos + sizeof sos);

  Code dcl[256], acl[256], dcc[256], acc[256];
  build_codes(kDcLumBits, kDcVals, dcl);
  build_codes(kAcLumBits, kAcLumVals, acl);
  build_codes(kDcChromBits, kDcVals, dcc);
  build_codes(kAcChromBits, kAcChromVals, acc);
  float qdl[64], qdc[64];
  for (int k = 0; k < 64; k++) {
    qdl[k] = ql[k];
    qdc[k] = qc[k];
  }

  // YCbCr planes padded to whole MCUs by repeating the last row and column
  const int H16 = (H + 15) / 16 * 16, W16 = (W + 15) / 16 * 16;
  std::vector<float> Y(size_t(H16) * W16), Cb(size_t(H16) * W16),
      Cr(size_t(H16) * W16);
  for (int y = 0; y < H16; y++)
    for (int x = 0; x < W16; x++) {
      const uint8_t* px =
          rgb + (size_t(std::min(y, H - 1)) * W + std::min(x, W - 1)) * 3;
      float r = px[0], g = px[1], b = px[2];
      size_t i = size_t(y) * W16 + x;
      Y[i] = 0.299f * r + 0.587f * g + 0.114f * b - 128.0f;
      Cb[i] = -0.168736f * r - 0.331264f * g + 0.5f * b;
      Cr[i] = 0.5f * r - 0.418688f * g - 0.081312f * b;
    }
  BitWriter bw(o);
  int py = 0, pcb = 0, pcr = 0;
  float blk[64];
  for (int my = 0; my < H16; my += 16)
    for (int mx = 0; mx < W16; mx += 16) {
      for (int b = 0; b < 4; b++) {
        int oy = my + (b >> 1) * 8, ox = mx + (b & 1) * 8;
        for (int y = 0; y < 8; y++)
          for (int x = 0; x < 8; x++)
            blk[y * 8 + x] = Y[size_t(oy + y) * W16 + ox + x];
        encode_block(bw, blk, qdl, py, dcl, acl);
      }
      for (int c = 0; c < 2; c++) {
        const std::vector<float>& P = c ? Cr : Cb;
        for (int y = 0; y < 8; y++)
          for (int x = 0; x < 8; x++) {
            size_t i = size_t(my + 2 * y) * W16 + mx + 2 * x;
            blk[y * 8 + x] = 0.25f * (P[i] + P[i + 1] + P[i + W16] +
                                      P[i + W16 + 1]);
          }
        encode_block(bw, blk, qdc, c ? pcr : pcb, dcc, acc);
      }
    }
  bw.flush();
  o.push_back(0xFF);
  o.push_back(0xD9);
  return o;
}

// ---------------------------------------------------------------------------
// PNG unfiltering

inline int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

}  // namespace

extern "C" {

// the image size and component count of a JPEG
int jpeg_info(const uint8_t* data, int64_t n, int32_t* height,
              int32_t* width, int32_t* ncomp, char* err, int errlen) {
  try {
    Jpeg j(data, size_t(n));
    j.parse();
    if (!j.have_frame) fail("no frame header");
    *height = j.height;
    *width = j.width;
    *ncomp = int32_t(j.comps.size());
    return 0;
  } catch (const CodecError& e) {
    return report(e, err, errlen);
  }
}

// decode to out (height x width x 3 RGB, uint8); gray is repeated
int jpeg_decode(const uint8_t* data, int64_t n, uint8_t* out, int64_t out_size,
                char* err, int errlen) {
  try {
    Jpeg j(data, size_t(n));
    j.parse();
    if (!j.have_frame) fail("no frame header");
    if (int64_t(j.width) * j.height * 3 != out_size)
      fail("output buffer of %lld bytes for a %dx%d image",
           (long long)out_size, j.height, j.width);
    to_rgb(j, out);
    return 0;
  } catch (const CodecError& e) {
    return report(e, err, errlen);
  }
}

// encode height x width x 3 RGB; *out_len gets the file's size, which
// must not exceed cap
int jpeg_encode(const uint8_t* rgb, int32_t height, int32_t width,
                int32_t quality, uint8_t* out, int64_t cap, int64_t* out_len,
                char* err, int errlen) {
  try {
    std::vector<uint8_t> o = encode(rgb, height, width, quality);
    if (int64_t(o.size()) > cap) fail("JPEG larger than its buffer");
    memcpy(out, o.data(), o.size());
    *out_len = int64_t(o.size());
    return 0;
  } catch (const CodecError& e) {
    return report(e, err, errlen);
  }
}

// undo the per-row filters of an inflated PNG image: raw holds height rows
// of 1 + rowbytes bytes, out gets height x rowbytes; bpp is the filter's
// byte distance (bytes per pixel, at least 1)
int png_unfilter(const uint8_t* raw, int64_t n, int32_t height,
                 int64_t rowbytes, int32_t bpp, uint8_t* out, char* err,
                 int errlen) {
  try {
    if (n < int64_t(height) * (rowbytes + 1)) fail("truncated PNG image data");
    for (int32_t y = 0; y < height; y++) {
      const uint8_t* in = raw + y * (rowbytes + 1);
      int f = in[0];
      in++;
      uint8_t* o = out + y * rowbytes;
      const uint8_t* up = y ? o - rowbytes : nullptr;
      for (int64_t x = 0; x < rowbytes; x++) {
        int a = x >= bpp ? o[x - bpp] : 0;
        int b = up ? up[x] : 0;
        int c = (up && x >= bpp) ? up[x - bpp] : 0;
        int pred;
        switch (f) {
          case 0: pred = 0; break;
          case 1: pred = a; break;
          case 2: pred = b; break;
          case 3: pred = (a + b) >> 1; break;
          case 4: pred = paeth(a, b, c); break;
          default: fail("PNG filter type %d in row %d", f, y);
        }
        o[x] = uint8_t(in[x] + pred);
      }
    }
    return 0;
  } catch (const CodecError& e) {
    return report(e, err, errlen);
  }
}

}  // extern "C"
