// The port's host image loader: threaded batch JPEG/PNG decode, the
// counterpart of dream_tpu's native/dream_loader.cpp.
//
// Decoding compressed frames into raw uint8 RGB buffers is the one job of
// the input pipeline left on the host; everything after it runs on the
// card.  A pool of C++ threads decodes a batch without the GIL.
//
// native/dream_loader.cpp decodes through libjpeg and libpng.  The card's
// machine has neither library (only zlib), so both decoders are written
// here and held bit-equal to those libraries on the CPU
// (tests/test_torch_image_loader.py):
// - JPEG: baseline and extended sequential Huffman scans, interleaved or
//   not, with restart intervals; libjpeg's defaults for what it outputs
//   as JCS_RGB: the accurate integer IDCT (jidctint.c jpeg_idct_islow),
//   fancy upsampling (jdsample.c h2v1/h1v2/h2v2 triangle filters, box
//   replication for other factors) and the fixed-point YCbCr->RGB of
//   jdcolor.c.  Progressive, lossless and arithmetic-coded files, 12-bit
//   samples and CMYK fail to decode.
// - PNG: every bit depth and colour type, Adam7 interlacing, normalized to
//   8-bit RGB as native/dream_loader.cpp asks libpng to (16-bit samples
//   keep their high byte, palette and gray expand, alpha and tRNS are
//   dropped), inflated with zlib.
//
// C interface, bound with ctypes (dream_tpu_torch/data/native_loader.py):
//   dl_decode_batch(paths, n, out, H, W, n_threads) -> number of failed frames
//   dl_decode_probe(path, &w, &h)                   -> 0, or -1 on failure
//   dl_decode_memory(bytes, len, out, H, W)         -> 0, or -1 on failure
//   dl_probe_memory(bytes, len, &w, &h)             -> 0, or -1 on failure
//
// Frames are written into a caller's [n, H, W, 3] uint8 buffer; a frame of
// another size is resized by ResizeBilinear, operation for operation the
// one of native/dream_loader.cpp, so the device receives a fixed shape.
// A failed frame is zero-filled.  A file is read into memory and decoded
// by the same code as bytes handed over from Python (an HTTP body), so the
// two routes decode alike.

#include <zlib.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct Image {
  std::vector<uint8_t> data;  // RGB8
  int width = 0;
  int height = 0;
};

// Images larger than this many pixels (134 million; PIL refuses above 179
// million) are refused: a corrupt or hostile header (an HTTP body).
constexpr int64_t kMaxPixels = int64_t(1) << 27;

bool IsJpeg(const uint8_t* bytes, size_t len) {
  return len >= 2 && bytes[0] == 0xFF && bytes[1] == 0xD8;
}

// ===========================================================================
// JPEG
// ===========================================================================

constexpr int kZigzag[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54,
    47, 55, 62, 63,
    // Extra entries for safety against a run past 63 (libjpeg's jpeg_natural_order).
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

constexpr int kLookahead = 9;

struct HuffTable {
  bool present = false;
  uint8_t vals[256] = {};
  int32_t maxcode[18] = {};
  int32_t valoffset[18] = {};
  uint8_t look_len[1 << kLookahead] = {};  // 0: code longer than the lookahead
  uint8_t look_val[1 << kLookahead] = {};
};

// jdhuff.c jpeg_make_d_derived_tbl.
bool BuildHuffTable(const uint8_t* counts, const uint8_t* symbols, int n_symbols, HuffTable* t) {
  int huffsize[257];
  uint32_t huffcode[257];
  int p = 0;
  for (int l = 1; l <= 16; ++l)
    for (int i = 0; i < counts[l - 1]; ++i) huffsize[p++] = l;
  huffsize[p] = 0;
  if (p != n_symbols) return false;
  uint32_t code = 0;
  int si = huffsize[0];
  p = 0;
  while (huffsize[p]) {
    while (huffsize[p] == si) huffcode[p++] = code++;
    if (code >= (uint32_t(1) << si)) return false;
    code <<= 1;
    ++si;
  }
  p = 0;
  for (int l = 1; l <= 16; ++l) {
    if (counts[l - 1]) {
      t->valoffset[l] = p - int32_t(huffcode[p]);
      p += counts[l - 1];
      t->maxcode[l] = int32_t(huffcode[p - 1]);
    } else {
      t->maxcode[l] = -1;
    }
  }
  t->valoffset[17] = 0;
  t->maxcode[17] = 0xFFFFF;
  memset(t->look_len, 0, sizeof(t->look_len));
  p = 0;
  for (int l = 1; l <= kLookahead; ++l) {
    for (int i = 1; i <= counts[l - 1]; ++i, ++p) {
      int look = int(huffcode[p]) << (kLookahead - l);
      for (int ctr = 1 << (kLookahead - l); ctr > 0; --ctr, ++look) {
        t->look_len[look] = uint8_t(l);
        t->look_val[look] = symbols[p];
      }
    }
  }
  memcpy(t->vals, symbols, size_t(n_symbols));
  t->present = true;
  return true;
}

// The entropy-coded segment's bits.  At a marker (or the end of the data)
// zero bits follow, as libjpeg inserts them; `insufficient` says a decode
// needed bits past that point.
struct BitReader {
  const uint8_t* data;
  size_t len;
  size_t pos;
  uint64_t buf = 0;  // bits at the top
  int bits = 0;      // bits in buf
  int real_bits = 0;  // of those, bits read from the data
  bool at_marker = false;
  bool insufficient = false;

  void Fill() {
    while (bits <= 56) {
      uint32_t byte = 0;
      bool real = false;
      if (!at_marker && pos < len) {
        uint32_t b = data[pos];
        if (b == 0xFF) {
          size_t q = pos + 1;
          while (q < len && data[q] == 0xFF) ++q;
          if (q < len && data[q] == 0x00) {
            byte = 0xFF;
            real = true;
            pos = q + 1;
          } else {
            at_marker = true;  // pos stays on the marker's first 0xFF
          }
        } else {
          byte = b;
          real = true;
          ++pos;
        }
      } else {
        at_marker = true;
      }
      buf |= uint64_t(byte) << (56 - bits);
      bits += 8;
      if (real) real_bits += 8;
    }
  }

  uint32_t Peek(int n) {
    if (bits < n) Fill();
    return uint32_t(buf >> (64 - n));
  }

  void Skip(int n) {
    if (n > real_bits) insufficient = true;
    buf <<= n;
    bits -= n;
    real_bits = std::max(0, real_bits - n);
  }

  uint32_t Get(int n) {
    if (n == 0) return 0;
    uint32_t v = Peek(n);
    Skip(n);
    return v;
  }

  // Drop the buffered bits and move past the next RSTn marker.
  void Restart() {
    buf = 0;
    bits = real_bits = 0;
    at_marker = false;
    while (pos + 1 < len) {
      if (data[pos] == 0xFF && data[pos + 1] >= 0xD0 && data[pos + 1] <= 0xD7) {
        pos += 2;
        return;
      }
      if (data[pos] == 0xFF && data[pos + 1] != 0x00 && data[pos + 1] != 0xFF) return;
      ++pos;
    }
  }

  // The position of the marker that ended the segment.
  size_t MarkerPos() {
    size_t q = pos;
    while (q + 1 < len && !(data[q] == 0xFF && data[q + 1] != 0x00 && data[q + 1] != 0xFF)) ++q;
    return q;
  }
};

int DecodeHuff(BitReader* br, const HuffTable& t) {
  uint32_t look = br->Peek(kLookahead);
  int l = t.look_len[look];
  if (l) {
    br->Skip(l);
    return t.look_val[look];
  }
  l = kLookahead + 1;
  int32_t code = int32_t(br->Get(l));
  while (l <= 16 && code > t.maxcode[l]) {
    code = (code << 1) | int32_t(br->Get(1));
    ++l;
  }
  if (l > 16) return 0;  // a corrupt code: libjpeg warns and returns 0
  return t.vals[(code + t.valoffset[l]) & 0xFF];
}

inline int Extend(int r, int s) { return r < (1 << (s - 1)) ? r - (1 << s) + 1 : r; }

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;
  int dw = 0, dh = 0;              // downsampled size
  int width_in_blocks = 0, height_in_blocks = 0;
  int blocks_w = 0, blocks_h = 0;  // blocks held (a whole number of MCUs)
  std::vector<int16_t> coefs;      // blocks_w * blocks_h * 64
  int16_t quant[64] = {};          // latched at the component's first scan
  bool quant_latched = false;
  int pred = 0;
};

struct JpegDecoder {
  const uint8_t* data = nullptr;
  size_t len = 0;
  size_t pos = 2;
  uint16_t qt[4][64] = {};
  bool qt_present[4] = {};
  HuffTable dc[4], ac[4];
  int restart_interval = 0;
  bool saw_jfif = false, saw_adobe = false;
  int adobe_transform = 0;
  int width = 0, height = 0;
  int hmax = 1, vmax = 1;
  std::vector<Component> comps;
  bool frame_seen = false;

  bool Segment(size_t* body, size_t* body_len) {
    if (pos + 2 > len) return false;
    size_t seg = (size_t(data[pos]) << 8) | data[pos + 1];
    if (seg < 2 || pos + seg > len) return false;
    *body = pos + 2;
    *body_len = seg - 2;
    pos += seg;
    return true;
  }

  bool ReadDqt(size_t b, size_t n) {
    size_t end = b + n;
    while (b < end) {
      int pq = data[b] >> 4, tq = data[b] & 15;
      ++b;
      if (tq > 3 || pq > 1 || b + (pq ? 128 : 64) > end) return false;
      for (int i = 0; i < 64; ++i) {
        qt[tq][kZigzag[i]] = pq ? uint16_t((data[b + 2 * i] << 8) | data[b + 2 * i + 1]) : data[b + i];
      }
      b += pq ? 128 : 64;
      qt_present[tq] = true;
    }
    return true;
  }

  bool ReadDht(size_t b, size_t n) {
    size_t end = b + n;
    while (b < end) {
      if (b + 17 > end) return false;
      int tc = data[b] >> 4, th = data[b] & 15;
      if (tc > 1 || th > 3) return false;
      const uint8_t* counts = data + b + 1;
      int total = 0;
      for (int i = 0; i < 16; ++i) total += counts[i];
      if (total > 256 || b + 17 + size_t(total) > end) return false;
      if (!BuildHuffTable(counts, data + b + 17, total, tc ? &ac[th] : &dc[th])) return false;
      b += 17 + size_t(total);
    }
    return true;
  }

  bool ReadSof(size_t b, size_t n) {
    if (frame_seen || n < 6 || data[b] != 8) return false;  // 8-bit samples only
    height = (data[b + 1] << 8) | data[b + 2];
    width = (data[b + 3] << 8) | data[b + 4];
    int nc = data[b + 5];
    if (width <= 0 || height <= 0 || int64_t(width) * height > kMaxPixels) return false;
    if (nc < 1 || nc > 4 || n < 6 + size_t(3 * nc)) return false;
    comps.resize(nc);
    for (int i = 0; i < nc; ++i) {
      Component& c = comps[i];
      c.id = data[b + 6 + 3 * i];
      c.h = data[b + 7 + 3 * i] >> 4;
      c.v = data[b + 7 + 3 * i] & 15;
      c.tq = data[b + 8 + 3 * i];
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3) return false;
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
    }
    int mcus_x = (width + 8 * hmax - 1) / (8 * hmax);
    int mcus_y = (height + 8 * vmax - 1) / (8 * vmax);
    for (Component& c : comps) {
      c.dw = int((int64_t(width) * c.h + hmax - 1) / hmax);
      c.dh = int((int64_t(height) * c.v + vmax - 1) / vmax);
      c.width_in_blocks = int((int64_t(width) * c.h + 8 * hmax - 1) / (8 * hmax));
      c.height_in_blocks = int((int64_t(height) * c.v + 8 * vmax - 1) / (8 * vmax));
      c.blocks_w = mcus_x * c.h;
      c.blocks_h = mcus_y * c.v;
      c.coefs.assign(size_t(c.blocks_w) * c.blocks_h * 64, 0);
    }
    frame_seen = true;
    return true;
  }

  bool DecodeBlock(BitReader* br, Component& c, int16_t* block) {
    const HuffTable& dct = dc[c.td];
    const HuffTable& act = ac[c.ta];
    int s = DecodeHuff(br, dct);
    int diff = 0;
    if (s) {
      if (s > 16) return false;
      diff = Extend(int(br->Get(s)), s);
    }
    c.pred += diff;
    block[0] = int16_t(c.pred);
    for (int k = 1; k < 64; ++k) {
      int rs = DecodeHuff(br, act);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        block[kZigzag[k]] = int16_t(Extend(int(br->Get(s)), s));
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
    return true;
  }

  bool ReadScan(size_t b, size_t n) {
    if (!frame_seen || n < 1) return false;
    int ns = data[b];
    if (ns < 1 || ns > 4 || n < 4 + size_t(2 * ns)) return false;
    std::vector<Component*> scan;
    for (int i = 0; i < ns; ++i) {
      int id = data[b + 1 + 2 * i];
      Component* found = nullptr;
      for (Component& c : comps)
        if (c.id == id) found = &c;
      if (!found) return false;
      found->td = data[b + 2 + 2 * i] >> 4;
      found->ta = data[b + 2 + 2 * i] & 15;
      if (found->td > 3 || found->ta > 3 || !dc[found->td].present || !ac[found->ta].present)
        return false;
      if (!found->quant_latched) {
        if (!qt_present[found->tq]) return false;
        for (int k = 0; k < 64; ++k) found->quant[k] = int16_t(qt[found->tq][k]);
        found->quant_latched = true;
      }
      scan.push_back(found);
    }
    size_t p = b + 1 + 2 * size_t(ns);
    int ss = data[p], se = data[p + 1], ah = data[p + 2] >> 4, al = data[p + 2] & 15;
    if (ss != 0 || se != 63 || ah != 0 || al != 0) return false;  // sequential scans only

    BitReader br{data, len, pos};
    for (Component* c : scan) c->pred = 0;
    int restarts_to_go = restart_interval;
    auto restart = [&]() {
      br.Restart();
      for (Component* c : scan) c->pred = 0;
      restarts_to_go = restart_interval;
      br.insufficient = false;
    };
    if (ns == 1) {
      Component& c = *scan[0];
      for (int by = 0; by < c.height_in_blocks; ++by) {
        for (int bx = 0; bx < c.width_in_blocks; ++bx) {
          if (restart_interval) {
            if (restarts_to_go == 0) restart();
            --restarts_to_go;
          }
          if (br.insufficient) continue;  // out of data: the block stays zero
          int16_t* block = &c.coefs[(size_t(by) * c.blocks_w + bx) * 64];
          if (!DecodeBlock(&br, c, block)) return false;
        }
      }
    } else {
      int mcus_x = (width + 8 * hmax - 1) / (8 * hmax);
      int mcus_y = (height + 8 * vmax - 1) / (8 * vmax);
      for (int my = 0; my < mcus_y; ++my) {
        for (int mx = 0; mx < mcus_x; ++mx) {
          if (restart_interval) {
            if (restarts_to_go == 0) restart();
            --restarts_to_go;
          }
          if (br.insufficient) continue;
          for (Component* c : scan) {
            for (int v = 0; v < c->v; ++v) {
              for (int h = 0; h < c->h; ++h) {
                int by = my * c->v + v, bx = mx * c->h + h;
                int16_t* block = &c->coefs[(size_t(by) * c->blocks_w + bx) * 64];
                if (!DecodeBlock(&br, *c, block)) return false;
              }
            }
          }
        }
      }
    }
    pos = br.MarkerPos();
    return true;
  }

  // Parse the whole stream; every scan's coefficients land in `comps`.
  bool Parse(bool header_only) {
    while (pos + 2 <= len) {
      if (data[pos] != 0xFF) {
        ++pos;  // garbage between markers: libjpeg skips it with a warning
        continue;
      }
      uint8_t m = data[pos + 1];
      pos += 2;
      if (m == 0xFF) {
        --pos;
        continue;
      }
      if (m == 0xD9) return frame_seen && !header_only;  // EOI
      if (m == 0x01 || (m >= 0xD0 && m <= 0xD7)) continue;
      size_t b, n;
      if (!Segment(&b, &n)) return false;
      switch (m) {
        case 0xC0:
        case 0xC1:
          if (!ReadSof(b, n)) return false;
          if (header_only) return true;
          break;
        case 0xC4:
          if (!ReadDht(b, n)) return false;
          break;
        case 0xDB:
          if (!ReadDqt(b, n)) return false;
          break;
        case 0xDD:
          if (n < 2) return false;
          restart_interval = (data[b] << 8) | data[b + 1];
          break;
        case 0xDA:
          if (!ReadScan(b, n)) return false;
          break;
        case 0xE0:
          if (n >= 5 && memcmp(data + b, "JFIF\0", 5) == 0) saw_jfif = true;
          break;
        case 0xEE:
          if (n >= 12 && memcmp(data + b, "Adobe", 5) == 0) {
            saw_adobe = true;
            adobe_transform = data[b + 11];
          }
          break;
        default:
          // Progressive (C2), lossless (C3), hierarchical and arithmetic
          // coding (C5-CF but C8 and CC) and DNL are not decoded.
          if ((m >= 0xC2 && m <= 0xCF && m != 0xC4 && m != 0xC8 && m != 0xCC) || m == 0xDC)
            return false;
          break;  // APPn, COM and others are skipped
      }
    }
    // The data ended without EOI: libjpeg inserts one (with a warning).
    return frame_seen && !header_only;
  }
};

// The IDCT's output range limit (jdmaster.c prepare_range_limit_table as
// IDCT_range_limit indexes it, by x & 1023 for x the descaled sample less
// 128): x + 128 for x in [-128, 127], 255 above, 0 below, wrapping beyond.
struct RangeLimit {
  uint8_t idct[1024];
  RangeLimit() {
    for (int i = 0; i < 128; ++i) idct[i] = uint8_t(i + 128);
    for (int i = 128; i < 512; ++i) idct[i] = 255;
    for (int i = 512; i < 896; ++i) idct[i] = 0;
    for (int i = 896; i < 1024; ++i) idct[i] = uint8_t(i - 896);
  }
};
const RangeLimit kRange;

constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int64_t FIX_0_298631336 = 2446;
constexpr int64_t FIX_0_390180644 = 3196;
constexpr int64_t FIX_0_541196100 = 4433;
constexpr int64_t FIX_0_765366865 = 6270;
constexpr int64_t FIX_0_899976223 = 7373;
constexpr int64_t FIX_1_175875602 = 9633;
constexpr int64_t FIX_1_501321110 = 12299;
constexpr int64_t FIX_1_847759065 = 15137;
constexpr int64_t FIX_1_961570560 = 16069;
constexpr int64_t FIX_2_053119869 = 16819;
constexpr int64_t FIX_2_562915447 = 20995;
constexpr int64_t FIX_3_072711026 = 25172;

inline int64_t Descale(int64_t x, int n) { return (x + (int64_t(1) << (n - 1))) >> n; }

// jidctint.c jpeg_idct_islow: one dequantized 8x8 block to samples.
void IdctIslow(const int16_t* coef, const int16_t* quant, uint8_t* out, size_t stride) {
  int ws[64];
  for (int col = 0; col < 8; ++col) {
    const int16_t* in = coef + col;
    const int16_t* q = quant + col;
    int* w = ws + col;
    if (!in[8] && !in[16] && !in[24] && !in[32] && !in[40] && !in[48] && !in[56]) {
      int dcval = int(int32_t(in[0]) * q[0]) * (1 << kPass1Bits);
      for (int k = 0; k < 8; ++k) w[8 * k] = dcval;
      continue;
    }
    int64_t z2 = int32_t(in[16]) * q[16], z3 = int32_t(in[48]) * q[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = int32_t(in[0]) * q[0];
    z3 = int32_t(in[32]) * q[32];
    int64_t tmp0 = (z2 + z3) * (int64_t(1) << kConstBits);
    int64_t tmp1 = (z2 - z3) * (int64_t(1) << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;

    tmp0 = int32_t(in[56]) * q[56];
    tmp1 = int32_t(in[40]) * q[40];
    tmp2 = int32_t(in[24]) * q[24];
    tmp3 = int32_t(in[8]) * q[8];
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
    constexpr int s = kConstBits - kPass1Bits;
    w[0] = int(Descale(tmp10 + tmp3, s));
    w[56] = int(Descale(tmp10 - tmp3, s));
    w[8] = int(Descale(tmp11 + tmp2, s));
    w[48] = int(Descale(tmp11 - tmp2, s));
    w[16] = int(Descale(tmp12 + tmp1, s));
    w[40] = int(Descale(tmp12 - tmp1, s));
    w[24] = int(Descale(tmp13 + tmp0, s));
    w[32] = int(Descale(tmp13 - tmp0, s));
  }
  constexpr int s2 = kConstBits + kPass1Bits + 3;
  for (int row = 0; row < 8; ++row) {
    const int* w = ws + 8 * row;
    uint8_t* o = out + size_t(row) * stride;
    if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
      uint8_t v = kRange.idct[int(Descale(w[0], kPass1Bits + 3)) & 1023];
      for (int k = 0; k < 8; ++k) o[k] = v;
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = (int64_t(w[0]) + w[4]) * (int64_t(1) << kConstBits);
    int64_t tmp1 = (int64_t(w[0]) - w[4]) * (int64_t(1) << kConstBits);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;

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
    o[0] = kRange.idct[int(Descale(tmp10 + tmp3, s2)) & 1023];
    o[7] = kRange.idct[int(Descale(tmp10 - tmp3, s2)) & 1023];
    o[1] = kRange.idct[int(Descale(tmp11 + tmp2, s2)) & 1023];
    o[6] = kRange.idct[int(Descale(tmp11 - tmp2, s2)) & 1023];
    o[2] = kRange.idct[int(Descale(tmp12 + tmp1, s2)) & 1023];
    o[5] = kRange.idct[int(Descale(tmp12 - tmp1, s2)) & 1023];
    o[3] = kRange.idct[int(Descale(tmp13 + tmp0, s2)) & 1023];
    o[4] = kRange.idct[int(Descale(tmp13 - tmp0, s2)) & 1023];
  }
}

// jdcolor.c build_ycc_rgb_table, for ycc_rgb_convert.
struct YccTables {
  static constexpr int kScale = 16;
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  YccTables() {
    const int64_t half = int64_t(1) << (kScale - 1);
    auto fix = [](double x) { return int64_t(x * (1 << kScale) + 0.5); };
    for (int i = 0; i < 256; ++i) {
      int64_t x = i - 128;
      cr_r[i] = int((fix(1.40200) * x + half) >> kScale);
      cb_b[i] = int((fix(1.77200) * x + half) >> kScale);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + half;
    }
  }
};
const YccTables kYcc;

// A component's samples at full size (hmax*dw/h x vmax*dh/v, at least the
// image's size), by libjpeg's upsampler for its sampling factors.
std::vector<uint8_t> Upsample(const std::vector<uint8_t>& plane, size_t stride, const Component& c,
                              int hmax, int vmax, int out_w, int out_h) {
  const int fh = hmax / c.h, fv = vmax / c.v;
  const int dw = c.dw, dh = c.dh;
  std::vector<uint8_t> out(size_t(out_w) * out_h);
  auto in_row = [&](int r) { return plane.data() + size_t(std::min(std::max(r, 0), dh - 1)) * stride; };
  const bool fancy_h2 = fh == 2 && dw > 2;
  std::vector<uint8_t> row(size_t(dw) * fh + 2);
  for (int oy = 0; oy < out_h; ++oy) {
    uint8_t* o = out.data() + size_t(oy) * out_w;
    if (fh == 2 && fv == 2 && fancy_h2) {
      // h2v2_fancy_upsample: rows 2r and 2r+1 mix row r with r-1 and r+1.
      int r = oy / 2;
      const uint8_t* in0 = in_row(r);
      const uint8_t* in1 = in_row(oy % 2 == 0 ? r - 1 : r + 1);
      int thiscolsum = in0[0] * 3 + in1[0];
      int nextcolsum = in0[1] * 3 + in1[1];
      uint8_t* t = row.data();
      *t++ = uint8_t((thiscolsum * 4 + 8) >> 4);
      *t++ = uint8_t((thiscolsum * 3 + nextcolsum + 7) >> 4);
      int lastcolsum = thiscolsum;
      thiscolsum = nextcolsum;
      for (int x = 2; x < dw; ++x) {
        nextcolsum = in0[x] * 3 + in1[x];
        *t++ = uint8_t((thiscolsum * 3 + lastcolsum + 8) >> 4);
        *t++ = uint8_t((thiscolsum * 3 + nextcolsum + 7) >> 4);
        lastcolsum = thiscolsum;
        thiscolsum = nextcolsum;
      }
      *t++ = uint8_t((thiscolsum * 3 + lastcolsum + 8) >> 4);
      *t++ = uint8_t((thiscolsum * 4 + 7) >> 4);
    } else if (fh == 2 && fv == 1 && fancy_h2) {
      // h2v1_fancy_upsample.
      const uint8_t* in = in_row(oy);
      uint8_t* t = row.data();
      int invalue = in[0];
      *t++ = uint8_t(invalue);
      *t++ = uint8_t((invalue * 3 + in[1] + 2) >> 2);
      for (int x = 1; x < dw - 1; ++x) {
        invalue = in[x] * 3;
        *t++ = uint8_t((invalue + in[x - 1] + 1) >> 2);
        *t++ = uint8_t((invalue + in[x + 1] + 2) >> 2);
      }
      invalue = in[dw - 1];
      *t++ = uint8_t((invalue * 3 + in[dw - 2] + 1) >> 2);
      *t++ = uint8_t(invalue);
    } else if (fh == 1 && fv == 2) {
      // h1v2_fancy_upsample.
      int r = oy / 2;
      const uint8_t* in0 = in_row(r);
      const uint8_t* in1 = in_row(oy % 2 == 0 ? r - 1 : r + 1);
      int bias = oy % 2 == 0 ? 1 : 2;
      for (int x = 0; x < dw; ++x) row[x] = uint8_t((in0[x] * 3 + in1[x] + bias) >> 2);
    } else {
      // Box replication (fullsize, h2v1/h2v2 at widths <= 2, int_upsample).
      const uint8_t* in = in_row(oy / fv);
      for (int x = 0; x < dw; ++x)
        for (int k = 0; k < fh; ++k) row[size_t(x) * fh + k] = in[x];
    }
    memcpy(o, row.data(), size_t(out_w));
  }
  return out;
}

bool DecodeJpeg(const uint8_t* bytes, size_t len, Image* out, int* width, int* height) {
  JpegDecoder d;
  d.data = bytes;
  d.len = len;
  if (!out) {
    if (!d.Parse(true)) return false;
    *width = d.width;
    *height = d.height;
    return true;
  }
  if (!d.Parse(false)) return false;
  const int nc = int(d.comps.size());
  enum { kSpaceGray, kSpaceYcc, kSpaceRgb } space;
  if (nc == 1) {
    space = kSpaceGray;
  } else if (nc == 3) {
    // jdapimin.c default_decompress_parms.
    if (d.saw_jfif) {
      space = kSpaceYcc;
    } else if (d.saw_adobe) {
      space = d.adobe_transform == 0 ? kSpaceRgb : kSpaceYcc;
    } else if (d.comps[0].id == 82 && d.comps[1].id == 71 && d.comps[2].id == 66) {
      space = kSpaceRgb;
    } else {
      space = kSpaceYcc;
    }
  } else {
    return false;  // two or four components: no conversion to RGB
  }
  for (const Component& c : d.comps) {
    if (d.hmax % c.h || d.vmax % c.v) return false;  // fractional sampling
    if (!c.quant_latched) return false;             // a component no scan carried
  }

  const int W = d.width, H = d.height;
  std::vector<std::vector<uint8_t>> full(nc);
  for (int ci = 0; ci < nc; ++ci) {
    const Component& c = d.comps[ci];
    size_t stride = size_t(c.blocks_w) * 8;
    std::vector<uint8_t> plane(stride * size_t(c.blocks_h) * 8);
    for (int by = 0; by < c.height_in_blocks; ++by)
      for (int bx = 0; bx < c.width_in_blocks; ++bx)
        IdctIslow(&c.coefs[(size_t(by) * c.blocks_w + bx) * 64], c.quant,
                  plane.data() + size_t(by) * 8 * stride + size_t(bx) * 8, stride);
    if (nc == 1) {
      full[ci].resize(size_t(W) * H);
      for (int y = 0; y < H; ++y) memcpy(&full[ci][size_t(y) * W], &plane[size_t(y) * stride], size_t(W));
    } else {
      full[ci] = Upsample(plane, stride, c, d.hmax, d.vmax, W, H);
    }
  }

  out->width = W;
  out->height = H;
  out->data.resize(size_t(W) * H * 3);
  uint8_t* o = out->data.data();
  const size_t n = size_t(W) * H;
  if (space == kSpaceGray) {
    for (size_t i = 0; i < n; ++i) o[3 * i] = o[3 * i + 1] = o[3 * i + 2] = full[0][i];
  } else if (space == kSpaceRgb) {
    for (size_t i = 0; i < n; ++i) {
      o[3 * i] = full[0][i];
      o[3 * i + 1] = full[1][i];
      o[3 * i + 2] = full[2][i];
    }
  } else {
    const YccTables& t = kYcc;
    auto clamp = [](int v) { return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v); };
    const uint8_t *Y = full[0].data(), *Cb = full[1].data(), *Cr = full[2].data();
    for (size_t i = 0; i < n; ++i) {
      int y = Y[i], cb = Cb[i], cr = Cr[i];
      o[3 * i] = clamp(y + t.cr_r[cr]);
      o[3 * i + 1] = clamp(y + int((t.cb_g[cb] + t.cr_g[cr]) >> YccTables::kScale));
      o[3 * i + 2] = clamp(y + t.cb_b[cb]);
    }
  }
  return true;
}

// ===========================================================================
// PNG
// ===========================================================================

inline uint32_t Be32(const uint8_t* p) {
  return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) | (uint32_t(p[2]) << 8) | p[3];
}

bool Unfilter(uint8_t* rows, size_t rowbytes, int n_rows, int bpp) {
  std::vector<uint8_t> zero(rowbytes, 0);
  const uint8_t* prev = zero.data();
  for (int y = 0; y < n_rows; ++y) {
    uint8_t* line = rows + size_t(y) * (rowbytes + 1);
    int kind = line[0];
    uint8_t* cur = line + 1;
    switch (kind) {
      case 0:
        break;
      case 1:
        for (size_t i = size_t(bpp); i < rowbytes; ++i) cur[i] = uint8_t(cur[i] + cur[i - bpp]);
        break;
      case 2:
        for (size_t i = 0; i < rowbytes; ++i) cur[i] = uint8_t(cur[i] + prev[i]);
        break;
      case 3:
        for (size_t i = 0; i < rowbytes; ++i) {
          int a = i >= size_t(bpp) ? cur[i - bpp] : 0;
          cur[i] = uint8_t(cur[i] + ((a + prev[i]) >> 1));
        }
        break;
      case 4:
        for (size_t i = 0; i < rowbytes; ++i) {
          int a = i >= size_t(bpp) ? cur[i - bpp] : 0;
          int b = prev[i];
          int c = i >= size_t(bpp) ? prev[i - bpp] : 0;
          int p = a + b - c;
          int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
          cur[i] = uint8_t(cur[i] + (pa <= pb && pa <= pc ? a : pb <= pc ? b : c));
        }
        break;
      default:
        return false;
    }
    prev = cur;
  }
  return true;
}

bool DecodePng(const uint8_t* bytes, size_t len, Image* out, int* width_out, int* height_out) {
  static const uint8_t kSig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1A, '\n'};
  if (len < 8 || memcmp(bytes, kSig, 8) != 0) return false;
  size_t pos = 8;
  int width = 0, height = 0, depth = 0, colour = 0, interlace = 0;
  bool have_header = false;
  uint8_t palette[256][3] = {};
  bool have_palette = false;
  std::vector<uint8_t> idat;
  bool ended = false;
  while (pos + 12 <= len) {
    uint32_t n = Be32(bytes + pos);
    const uint8_t* type = bytes + pos + 4;
    if (n > len - pos - 12) return false;
    const uint8_t* body = bytes + pos + 8;
    const bool critical = !(type[0] & 0x20);
    uint32_t crc = uint32_t(crc32(0, type, 4 + n));
    if (crc != Be32(body + n)) {
      if (critical) return false;
      pos += 12 + n;  // libpng drops an ancillary chunk with a bad CRC
      continue;
    }
    pos += 12 + n;
    if (!memcmp(type, "IHDR", 4)) {
      if (have_header || n != 13) return false;
      width = int(Be32(body));
      height = int(Be32(body + 4));
      depth = body[8];
      colour = body[9];
      interlace = body[12];
      if (width <= 0 || height <= 0 || int64_t(width) * height > kMaxPixels) return false;
      if (body[10] != 0 || body[11] != 0 || interlace > 1) return false;
      bool ok = (colour == 0 && (depth == 1 || depth == 2 || depth == 4 || depth == 8 || depth == 16)) ||
                (colour == 3 && (depth == 1 || depth == 2 || depth == 4 || depth == 8)) ||
                ((colour == 2 || colour == 4 || colour == 6) && (depth == 8 || depth == 16));
      if (!ok) return false;
      have_header = true;
      if (!out) {
        *width_out = width;
        *height_out = height;
        return true;
      }
    } else if (!have_header) {
      return false;
    } else if (!memcmp(type, "PLTE", 4)) {
      if (n % 3 || n > 768) return false;
      for (uint32_t i = 0; i < n / 3; ++i)
        for (int k = 0; k < 3; ++k) palette[i][k] = body[3 * i + k];
      have_palette = true;
    } else if (!memcmp(type, "IDAT", 4)) {
      idat.insert(idat.end(), body, body + n);
    } else if (!memcmp(type, "IEND", 4)) {
      ended = true;
      break;
    } else if (critical) {
      return false;  // an unknown critical chunk
    }
  }
  if (!have_header || idat.empty()) return false;
  (void)ended;  // libpng reads the image before IEND; a missing IEND is not checked
  if (colour == 3 && !have_palette) return false;

  const int channels = colour == 0 || colour == 3 ? 1 : colour == 4 ? 2 : colour == 2 ? 3 : 4;
  const int bits_per_pixel = channels * depth;
  const int bpp = std::max(1, bits_per_pixel / 8);
  struct Pass {
    int x0, y0, dx, dy;
  };
  const Pass adam7[7] = {{0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8}, {2, 0, 4, 4},
                         {0, 2, 2, 4}, {1, 0, 2, 2}, {0, 1, 1, 2}};
  const Pass whole[1] = {{0, 0, 1, 1}};
  const Pass* passes = interlace ? adam7 : whole;
  const int n_passes = interlace ? 7 : 1;
  size_t total = 0;
  int pw[7], ph[7];
  for (int p = 0; p < n_passes; ++p) {
    pw[p] = width > passes[p].x0 ? (width - passes[p].x0 + passes[p].dx - 1) / passes[p].dx : 0;
    ph[p] = height > passes[p].y0 ? (height - passes[p].y0 + passes[p].dy - 1) / passes[p].dy : 0;
    if (pw[p] && ph[p]) total += size_t(ph[p]) * ((size_t(pw[p]) * bits_per_pixel + 7) / 8 + 1);
  }
  std::vector<uint8_t> raw(total);
  z_stream zs{};
  if (inflateInit(&zs) != Z_OK) return false;
  zs.next_in = idat.data();
  zs.avail_in = uInt(idat.size());
  zs.next_out = raw.data();
  zs.avail_out = uInt(raw.size());
  int zr = inflate(&zs, Z_FINISH);
  size_t produced = raw.size() - zs.avail_out;
  inflateEnd(&zs);
  if (produced != raw.size() || (zr != Z_STREAM_END && zr != Z_OK && zr != Z_BUF_ERROR)) return false;

  out->width = width;
  out->height = height;
  out->data.assign(size_t(width) * height * 3, 0);
  size_t offset = 0;
  for (int p = 0; p < n_passes; ++p) {
    if (!pw[p] || !ph[p]) continue;
    size_t rowbytes = (size_t(pw[p]) * bits_per_pixel + 7) / 8;
    uint8_t* rows = raw.data() + offset;
    offset += size_t(ph[p]) * (rowbytes + 1);
    if (!Unfilter(rows, rowbytes, ph[p], bpp)) return false;
    for (int y = 0; y < ph[p]; ++y) {
      const uint8_t* line = rows + size_t(y) * (rowbytes + 1) + 1;
      int oy = passes[p].y0 + y * passes[p].dy;
      for (int x = 0; x < pw[p]; ++x) {
        int ox = passes[p].x0 + x * passes[p].dx;
        uint8_t* o = &out->data[(size_t(oy) * width + ox) * 3];
        auto sample = [&](int i) -> int {  // channel i of pixel x, at its bit depth
          if (depth == 8) return line[size_t(x) * channels + i];
          if (depth == 16) return line[(size_t(x) * channels + i) * 2];  // the high byte
          size_t bit = size_t(x) * depth;
          return (line[bit / 8] >> (8 - depth - int(bit % 8))) & ((1 << depth) - 1);
        };
        if (colour == 3) {
          int index = sample(0);
          o[0] = palette[index][0];
          o[1] = palette[index][1];
          o[2] = palette[index][2];
        } else if (colour == 0 || colour == 4) {
          int g = sample(0);
          if (depth < 8) g = g * (depth == 1 ? 0xFF : depth == 2 ? 0x55 : 0x11);
          o[0] = o[1] = o[2] = uint8_t(g);
        } else {
          o[0] = uint8_t(sample(0));
          o[1] = uint8_t(sample(1));
          o[2] = uint8_t(sample(2));
        }
      }
    }
  }
  return true;
}

// ===========================================================================
// Files, resize, batches
// ===========================================================================

bool Decode(const uint8_t* bytes, size_t len, Image* out) {
  return IsJpeg(bytes, len) ? DecodeJpeg(bytes, len, out, nullptr, nullptr)
                            : DecodePng(bytes, len, out, nullptr, nullptr);
}

bool Probe(const uint8_t* bytes, size_t len, int* width, int* height) {
  return IsJpeg(bytes, len) ? DecodeJpeg(bytes, len, nullptr, width, height)
                            : DecodePng(bytes, len, nullptr, width, height);
}

bool ReadFile(const char* path, std::vector<uint8_t>* bytes) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  bool ok = fseek(f, 0, SEEK_END) == 0;
  long size = ok ? ftell(f) : -1;
  ok = size >= 0 && fseek(f, 0, SEEK_SET) == 0;
  if (ok) {
    bytes->resize(size_t(size));
    ok = fread(bytes->data(), 1, bytes->size(), f) == bytes->size();
  }
  fclose(f);
  return ok;
}

bool DecodeFile(const char* path, std::vector<uint8_t>* bytes, Image* out) {
  return ReadFile(path, bytes) && Decode(bytes->data(), bytes->size(), out);
}

// native/dream_loader.cpp's ResizeBilinear, operation for operation
// (half-pixel centres, edge-clamped taps, float weights, +0.5 truncation).
// That library is built with -O3 -march=native, and on a host with FMA the
// compiler fuses its multiply-adds: the source coordinate as one fused
// multiply-add, the sum of the four taps as a product and three fused
// multiply-adds in the order written below.  They are written out as
// fmaf calls here, so the result does not depend on the build host.
void ResizeBilinear(const Image& src, uint8_t* dst, int dst_h, int dst_w) {
  const float sx = float(src.width) / dst_w;
  const float sy = float(src.height) / dst_h;
  for (int y = 0; y < dst_h; ++y) {
    float fy = std::fmaf(y + 0.5f, sy, -0.5f);
    int y0 = std::max(0, std::min(src.height - 2, int(fy)));
    float ty = std::max(0.0f, std::min(1.0f, fy - y0));
    for (int x = 0; x < dst_w; ++x) {
      float fx = std::fmaf(x + 0.5f, sx, -0.5f);
      int x0 = std::max(0, std::min(src.width - 2, int(fx)));
      float tx = std::max(0.0f, std::min(1.0f, fx - x0));
      for (int c = 0; c < 3; ++c) {
        const float v00 = src.data[(size_t(y0) * src.width + x0) * 3 + c];
        const float v01 = src.data[(size_t(y0) * src.width + x0 + 1) * 3 + c];
        const float v10 = src.data[(size_t(y0 + 1) * src.width + x0) * 3 + c];
        const float v11 = src.data[(size_t(y0 + 1) * src.width + x0 + 1) * 3 + c];
        float v = std::fmaf(v00 * (1 - tx), 1 - ty, v01 * tx * (1 - ty));
        v = std::fmaf(v10 * (1 - tx), ty, v);
        v = std::fmaf(v11 * tx, ty, v);
        dst[(size_t(y) * dst_w + x) * 3 + c] = uint8_t(v + 0.5f);
      }
    }
  }
}

// A decoded frame into its [H, W, 3] slot: copied at its size, else resized.
void Place(const Image& im, uint8_t* dst, int out_h, int out_w) {
  if (im.width == out_w && im.height == out_h) {
    memcpy(dst, im.data.data(), size_t(out_h) * out_w * 3);
  } else {
    ResizeBilinear(im, dst, out_h, out_w);
  }
}

}  // namespace

extern "C" {

// The dimensions of an image file (decoded in full, as the reference does).
int dl_decode_probe(const char* path, int* width, int* height) {
  std::vector<uint8_t> bytes;
  Image im;
  if (!DecodeFile(path, &bytes, &im)) return -1;
  *width = im.width;
  *height = im.height;
  return 0;
}

// The dimensions of an image in memory, from its header alone.
int dl_probe_memory(const uint8_t* bytes, size_t len, int* width, int* height) {
  return Probe(bytes, len, width, height) ? 0 : -1;
}

// Decode one image in memory into out[H, W, 3]; zero-filled on failure.
int dl_decode_memory(const uint8_t* bytes, size_t len, uint8_t* out, int out_h, int out_w) {
  Image im;
  if (!Decode(bytes, len, &im)) {
    memset(out, 0, size_t(out_h) * out_w * 3);
    return -1;
  }
  Place(im, out, out_h, out_w);
  return 0;
}

// Decode `n` files into out[n, H, W, 3] uint8 with `n_threads` workers.
// Returns the number of failed frames (zero-filled), 0 on success.
int dl_decode_batch(const char** paths, int n, uint8_t* out, int out_h, int out_w,
                    int n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::atomic<int> next(0);
  std::atomic<int> failures(0);
  const size_t frame_size = size_t(out_h) * out_w * 3;

  auto worker = [&]() {
    std::vector<uint8_t> bytes;
    Image im;
    for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1)) {
      uint8_t* dst = out + size_t(i) * frame_size;
      if (!DecodeFile(paths[i], &bytes, &im)) {
        memset(dst, 0, frame_size);
        failures.fetch_add(1);
        continue;
      }
      Place(im, dst, out_h, out_w);
    }
  };

  std::vector<std::thread> threads;
  int n_workers = std::min(n_threads, n);
  threads.reserve(n_workers);
  for (int t = 0; t < n_workers; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return failures.load();
}

}  // extern "C"
