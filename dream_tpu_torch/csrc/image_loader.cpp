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
// - JPEG: every frame libjpeg decodes: baseline, extended sequential and
//   progressive, Huffman- or arithmetic-coded (SOF0-2, SOF9-10), scans
//   interleaved or not, restart intervals, DAC conditioning, the standard
//   Huffman tables where a sequential file defines none, and a file cut
//   short as libjpeg reads it (zero bits past the data).  The output is
//   libjpeg-turbo's for JCS_RGB at its defaults: block smoothing of a
//   progressive file whose coefficients miss their last bits (jdcoefct.c
//   as libjpeg-turbo 2.1 has it), the accurate integer IDCT (jidctint.c)
//   in the arithmetic of its x86 SIMD code, fancy upsampling (jdsample.c
//   h2v1/h1v2/h2v2 triangle filters, box replication for other factors)
//   and the fixed-point YCbCr->RGB of jdcolor.c.  What libjpeg refuses
//   fails here too: lossless and hierarchical frames, 12-bit samples, two
//   or four components (CMYK), reserved markers.
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
#include <memory>
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

constexpr int kLookahead = 8;     // jdhuff.h HUFF_LOOKAHEAD
constexpr int kMaxBlocksInMcu = 10;  // jpeglib.h D_MAX_BLOCKS_IN_MCU
constexpr int kArithTables = 16;  // jpeglib.h NUM_ARITH_TBLS

struct HuffTable {
  bool present = false;
  int n_symbols = 0;
  uint8_t vals[256] = {};
  int32_t maxcode[18] = {};
  int32_t valoffset[18] = {};
  uint8_t look_len[1 << kLookahead] = {};  // kLookahead + 1: the code is longer
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
  memset(t->look_len, kLookahead + 1, sizeof(t->look_len));
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
  memset(t->vals, 0, sizeof(t->vals));
  memcpy(t->vals, symbols, size_t(n_symbols));
  t->n_symbols = n_symbols;
  t->present = true;
  return true;
}

// The tables of the JPEG standard's Annex K.3 (jstdhuff.c), which libjpeg
// puts in the Huffman slots 0 and 1 of a sequential file that no DHT
// filled before its first scan: Motion-JPEG frames leave them out.
constexpr uint8_t kStdDcLumaCounts[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
constexpr uint8_t kStdDcChromaCounts[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
constexpr uint8_t kStdDcValues[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
constexpr uint8_t kStdAcLumaCounts[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
constexpr uint8_t kStdAcLumaValues[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61,
    0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52,
    0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25,
    0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64,
    0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83,
    0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99,
    0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3,
    0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8,
    0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
constexpr uint8_t kStdAcChromaCounts[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
constexpr uint8_t kStdAcChromaValues[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61,
    0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33,
    0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18,
    0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63,
    0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a,
    0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97,
    0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca,
    0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7,
    0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

// The compressed data as libjpeg's source manager hands it out: past its
// end come fake EOI markers (jdatasrc.c fill_input_buffer), so every read
// ends at a marker.
struct Source {
  const uint8_t* data = nullptr;
  size_t len = 0;
  size_t pos = 0;
  size_t fake = 0;
  int unread_marker = 0;  // a marker read but not yet acted on (jdmarker.c)
  int next_restart_num = 0;

  int Byte() {
    if (pos < len) return data[pos++];
    return (fake++ & 1) ? 0xD9 : 0xFF;
  }

  // jdmarker.c next_marker: skip to the next marker (garbage and stuffed
  // FF/00 pairs included) and read its code.
  int NextMarker() {
    for (;;) {
      int c = Byte();
      while (c != 0xFF) c = Byte();
      do c = Byte();
      while (c == 0xFF);
      if (c != 0) {
        unread_marker = c;
        return c;
      }
    }
  }

  // jdmarker.c read_restart_marker and jpeg_resync_to_restart.  A marker
  // left unread makes the entropy decoder treat the segment as empty.
  void ReadRestartMarker() {
    if (unread_marker == 0) NextMarker();
    const int desired = next_restart_num;
    if (unread_marker == 0xD0 + desired) {
      unread_marker = 0;
    } else {
      for (;;) {
        const int m = unread_marker;
        int action;
        if (m < 0xC0) {
          action = 2;  // not a valid marker: scan on
        } else if (m < 0xD0 || m > 0xD7) {
          action = 3;  // a valid marker that is not a restart: leave it
        } else if (m == 0xD0 + ((desired + 1) & 7) || m == 0xD0 + ((desired + 2) & 7)) {
          action = 3;  // one of the next two restarts
        } else if (m == 0xD0 + ((desired - 1) & 7) || m == 0xD0 + ((desired - 2) & 7)) {
          action = 2;  // an earlier restart: scan on
        } else {
          action = 1;  // the desired restart, or one too far away
        }
        if (action == 1) {
          unread_marker = 0;
          break;
        }
        if (action == 3) break;
        NextMarker();
      }
    }
    next_restart_num = (next_restart_num + 1) & 7;
  }
};

// Huffman-coded bits (jdhuff.c jpeg_fill_bit_buffer, HUFF_DECODE and
// jpeg_huff_decode).  At a marker zero bits follow, and `insufficient` is
// raised the first time a read goes past the data.
struct HuffBits {
  static constexpr int kMinGetBits = 57;  // BIT_BUF_SIZE - 7
  Source* src;
  bool* insufficient;
  uint64_t buf = 0;  // the low `bits` bits are unread
  int bits = 0;

  void Fill(int nbits) {
    if (src->unread_marker == 0) {
      while (bits < kMinGetBits) {
        int c = src->Byte();
        if (c == 0xFF) {
          do c = src->Byte();
          while (c == 0xFF);
          if (c == 0) {
            c = 0xFF;
          } else {
            src->unread_marker = c;
            break;
          }
        }
        buf = (buf << 8) | uint64_t(c);
        bits += 8;
      }
      if (src->unread_marker == 0) return;
    }
    if (nbits > bits) {
      *insufficient = true;
      buf <<= kMinGetBits - bits;
      bits = kMinGetBits;
    }
  }

  int Get(int n) {
    if (bits < n) Fill(n);
    bits -= n;
    return int((buf >> bits) & ((uint64_t(1) << n) - 1));
  }

  int Decode(const HuffTable& t) {
    int nb = 1;
    if (bits < kLookahead) Fill(0);
    if (bits >= kLookahead) {
      int look = int((buf >> (bits - kLookahead)) & ((1 << kLookahead) - 1));
      nb = t.look_len[look];
      if (nb <= kLookahead) {
        bits -= nb;
        return t.look_val[look];
      }
    }
    int32_t code = Get(nb);
    while (code > t.maxcode[nb]) {
      code = (code << 1) | Get(1);
      ++nb;
    }
    if (nb > 16) return 0;  // a corrupt code: libjpeg warns and returns 0
    return t.vals[(code + t.valoffset[nb]) & 0xFF];
  }

  void Discard() { bits = 0; }
};

inline int Extend(int r, int s) { return r < (1 << (s - 1)) ? r - (1 << s) + 1 : r; }

// jaricom.c jpeg_aritab: Table D.2 of the JPEG standard packed as Qe << 16
// | Next_Index_MPS << 8 | Switch_MPS << 7 | Next_Index_LPS; the last entry
// is the fixed probability 0.5.
#define ARITAB(qe, nlps, nmps, sw) ((int32_t(qe) << 16) | (int32_t(nmps) << 8) | (int32_t(sw) << 7) | (nlps))
constexpr int32_t kArithTable[113 + 1] = {
    ARITAB(0x5a1d, 1, 1, 1),     ARITAB(0x2586, 14, 2, 0),    ARITAB(0x1114, 16, 3, 0),
    ARITAB(0x080b, 18, 4, 0),    ARITAB(0x03d8, 20, 5, 0),    ARITAB(0x01da, 23, 6, 0),
    ARITAB(0x00e5, 25, 7, 0),    ARITAB(0x006f, 28, 8, 0),    ARITAB(0x0036, 30, 9, 0),
    ARITAB(0x001a, 33, 10, 0),   ARITAB(0x000d, 35, 11, 0),   ARITAB(0x0006, 9, 12, 0),
    ARITAB(0x0003, 10, 13, 0),   ARITAB(0x0001, 12, 13, 0),   ARITAB(0x5a7f, 15, 15, 1),
    ARITAB(0x3f25, 36, 16, 0),   ARITAB(0x2cf2, 38, 17, 0),   ARITAB(0x207c, 39, 18, 0),
    ARITAB(0x17b9, 40, 19, 0),   ARITAB(0x1182, 42, 20, 0),   ARITAB(0x0cef, 43, 21, 0),
    ARITAB(0x09a1, 45, 22, 0),   ARITAB(0x072f, 46, 23, 0),   ARITAB(0x055c, 48, 24, 0),
    ARITAB(0x0406, 49, 25, 0),   ARITAB(0x0303, 51, 26, 0),   ARITAB(0x0240, 52, 27, 0),
    ARITAB(0x01b1, 54, 28, 0),   ARITAB(0x0144, 56, 29, 0),   ARITAB(0x00f5, 57, 30, 0),
    ARITAB(0x00b7, 59, 31, 0),   ARITAB(0x008a, 60, 32, 0),   ARITAB(0x0068, 62, 33, 0),
    ARITAB(0x004e, 63, 34, 0),   ARITAB(0x003b, 32, 35, 0),   ARITAB(0x002c, 33, 9, 0),
    ARITAB(0x5ae1, 37, 37, 1),   ARITAB(0x484c, 64, 38, 0),   ARITAB(0x3a0d, 65, 39, 0),
    ARITAB(0x2ef1, 67, 40, 0),   ARITAB(0x261f, 68, 41, 0),   ARITAB(0x1f33, 69, 42, 0),
    ARITAB(0x19a8, 70, 43, 0),   ARITAB(0x1518, 72, 44, 0),   ARITAB(0x1177, 73, 45, 0),
    ARITAB(0x0e74, 74, 46, 0),   ARITAB(0x0bfb, 75, 47, 0),   ARITAB(0x09f8, 77, 48, 0),
    ARITAB(0x0861, 78, 49, 0),   ARITAB(0x0706, 79, 50, 0),   ARITAB(0x05cd, 48, 51, 0),
    ARITAB(0x04de, 50, 52, 0),   ARITAB(0x040f, 50, 53, 0),   ARITAB(0x0363, 51, 54, 0),
    ARITAB(0x02d4, 52, 55, 0),   ARITAB(0x025c, 53, 56, 0),   ARITAB(0x01f8, 54, 57, 0),
    ARITAB(0x01a4, 55, 58, 0),   ARITAB(0x0160, 56, 59, 0),   ARITAB(0x0125, 57, 60, 0),
    ARITAB(0x00f6, 58, 61, 0),   ARITAB(0x00cb, 59, 62, 0),   ARITAB(0x00ab, 61, 63, 0),
    ARITAB(0x008f, 61, 32, 0),   ARITAB(0x5b12, 65, 65, 1),   ARITAB(0x4d04, 80, 66, 0),
    ARITAB(0x412c, 81, 67, 0),   ARITAB(0x37d8, 82, 68, 0),   ARITAB(0x2fe8, 83, 69, 0),
    ARITAB(0x293c, 84, 70, 0),   ARITAB(0x2379, 86, 71, 0),   ARITAB(0x1edf, 87, 72, 0),
    ARITAB(0x1aa9, 87, 73, 0),   ARITAB(0x174e, 72, 74, 0),   ARITAB(0x1424, 72, 75, 0),
    ARITAB(0x119c, 74, 76, 0),   ARITAB(0x0f6b, 74, 77, 0),   ARITAB(0x0d51, 75, 78, 0),
    ARITAB(0x0bb6, 77, 79, 0),   ARITAB(0x0a40, 77, 48, 0),   ARITAB(0x5832, 80, 81, 1),
    ARITAB(0x4d1c, 88, 82, 0),   ARITAB(0x438e, 89, 83, 0),   ARITAB(0x3bdd, 90, 84, 0),
    ARITAB(0x34ee, 91, 85, 0),   ARITAB(0x2eae, 92, 86, 0),   ARITAB(0x299a, 93, 87, 0),
    ARITAB(0x2516, 86, 71, 0),   ARITAB(0x5570, 88, 89, 1),   ARITAB(0x4ca9, 95, 90, 0),
    ARITAB(0x44d9, 96, 91, 0),   ARITAB(0x3e22, 97, 92, 0),   ARITAB(0x3824, 99, 93, 0),
    ARITAB(0x32b4, 99, 94, 0),   ARITAB(0x2e17, 93, 86, 0),   ARITAB(0x56a8, 95, 96, 1),
    ARITAB(0x4f46, 101, 97, 0),  ARITAB(0x47e5, 102, 98, 0),  ARITAB(0x41cf, 103, 99, 0),
    ARITAB(0x3c3d, 104, 100, 0), ARITAB(0x375e, 99, 93, 0),   ARITAB(0x5231, 105, 102, 0),
    ARITAB(0x4c0f, 106, 103, 0), ARITAB(0x4639, 107, 104, 0), ARITAB(0x415e, 103, 99, 0),
    ARITAB(0x5627, 105, 106, 1), ARITAB(0x50e7, 108, 107, 0), ARITAB(0x4b85, 109, 103, 0),
    ARITAB(0x5597, 110, 109, 0), ARITAB(0x504f, 111, 107, 0), ARITAB(0x5a10, 110, 111, 1),
    ARITAB(0x5522, 112, 109, 0), ARITAB(0x59eb, 112, 111, 1), ARITAB(0x5a1d, 113, 113, 0)};
#undef ARITAB

// The QM decoder (jdarith.c arith_decode and get_byte).  A marker inside
// the data ends it: zero bytes follow.
struct ArithBits {
  Source* src;
  int64_t c = 0, a = 0;
  int ct = -16;  // -16: two bytes to read into C first; -1: a decoding error

  void Reset() {
    c = a = 0;
    ct = -16;
  }

  int Decode(uint8_t* st) {
    while (a < 0x8000) {
      if (--ct < 0) {
        int data = 0;
        if (src->unread_marker == 0) {
          data = src->Byte();
          if (data == 0xFF) {
            do data = src->Byte();
            while (data == 0xFF);
            if (data == 0) {
              data = 0xFF;
            } else {
              src->unread_marker = data;
              data = 0;
            }
          }
        }
        c = (c << 8) | data;
        if ((ct += 8) < 0)
          if (++ct == 0) a = 0x8000;  // two initial bytes read: A becomes 0x10000 below
      }
      a <<= 1;
    }
    int sv = *st;
    int32_t qe = kArithTable[sv & 0x7F];
    const int nl = qe & 0xFF;
    qe >>= 8;
    const int nm = qe & 0xFF;
    qe >>= 8;
    int64_t temp = a - qe;
    a = temp;
    temp <<= ct;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {
        a = qe;
        *st = uint8_t((sv & 0x80) ^ nm);
      } else {
        a = qe;
        *st = uint8_t((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {
      if (a < qe) {
        *st = uint8_t((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = uint8_t((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;
  int dw = 0, dh = 0;              // downsampled size
  int width_in_blocks = 0, height_in_blocks = 0;
  int blocks_w = 0, blocks_h = 0;  // blocks held (a whole number of MCUs)
  std::vector<int16_t> coefs;      // blocks_w * blocks_h * 64
  int16_t quant[64] = {};          // latched at the component's first scan
  bool quant_latched = false;
  // Progressive files: the successive-approximation bit each coefficient
  // is known to (-1: none yet), and its value before the component's
  // latest scan (jdphuff.c / jdarith.c cinfo->coef_bits).
  int coef_bits[64];
  int prev_coef_bits[64];

  int16_t* Block(int by, int bx) { return &coefs[(size_t(by) * blocks_w + bx) * 64]; }
};

// A scan's entropy decoder state, for all four procedures of both codings.
struct ScanState {
  int ns = 0;
  Component* comp[4] = {};
  int ss = 0, se = 63, ah = 0, al = 0;
  // Huffman.
  bool insufficient = false;
  HuffBits huff;
  const HuffTable* dc_tbl[4] = {};
  const HuffTable* ac_tbl[4] = {};
  unsigned eobrun = 0;
  // Arithmetic.
  ArithBits arith;
  uint8_t dc_stats[kArithTables][64];
  uint8_t ac_stats[kArithTables][256];
  uint8_t fixed_bin = 113;
  int dc_context[4] = {};
  // Both.
  int last_dc[4] = {};
};

struct JpegDecoder {
  Source src;
  uint16_t qt[4][64] = {};
  bool qt_present[4] = {};
  HuffTable dc[4], ac[4];
  uint8_t arith_dc_l[kArithTables], arith_dc_u[kArithTables], arith_ac_k[kArithTables];
  int restart_interval = 0;
  bool saw_jfif = false, saw_adobe = false;
  int adobe_transform = 0;
  int width = 0, height = 0;
  int hmax = 1, vmax = 1;
  int mcus_x = 0, mcus_y = 0;  // of an interleaved scan
  std::vector<Component> comps;
  bool frame_seen = false;
  bool progressive = false, arithmetic = false;
  bool multiple_scans = false;  // jdinput.c has_multiple_scans
  int scans = 0;                // jdmarker.c input_scan_number
  int last_good_imcu_row = 0;   // jdmaster.c last_good_iMCU_row
  ScanState scan;

  JpegDecoder() {
    // jdmarker.c get_soi.
    for (int i = 0; i < kArithTables; ++i) {
      arith_dc_l[i] = 0;
      arith_dc_u[i] = 1;
      arith_ac_k[i] = 5;
    }
  }

  int TotalImcuRows() const { return (height + 8 * vmax - 1) / (8 * vmax); }

  // A marker segment's body.  One the data cuts short is read on into the
  // fake EOI bytes, as libjpeg reads it.  A length below 2 leaves the body
  // empty: libjpeg skips nothing more of a segment it skips (APPn, COM,
  // DNL) and fails any other on its length.
  std::vector<uint8_t> cut_segment;
  bool Segment(bool skipped, const uint8_t** body, size_t* body_len) {
    const int hi = src.Byte(), lo = src.Byte();
    const size_t seg = size_t(hi << 8 | lo);
    if (seg < 2) {
      *body = nullptr;
      *body_len = 0;
      return skipped;
    }
    *body_len = seg - 2;
    if (src.pos + *body_len <= src.len) {
      *body = src.data + src.pos;
      src.pos += *body_len;
    } else {
      cut_segment.resize(*body_len);
      for (uint8_t& b : cut_segment) b = uint8_t(src.Byte());
      *body = cut_segment.data();
    }
    return true;
  }

  bool ReadDqt(const uint8_t* data, size_t n) {
    size_t b = 0, end = n;
    while (b < end) {
      int pq = (data[b] >> 4) != 0, tq = data[b] & 15;  // any nonzero precision: 16-bit
      ++b;
      if (tq > 3 || b + (pq ? 128 : 64) > end) return false;
      for (int i = 0; i < 64; ++i) {
        qt[tq][kZigzag[i]] = pq ? uint16_t((data[b + 2 * i] << 8) | data[b + 2 * i + 1]) : data[b + i];
      }
      b += pq ? 128 : 64;
      qt_present[tq] = true;
    }
    return true;
  }

  bool ReadDht(const uint8_t* data, size_t n) {
    size_t b = 0, end = n;
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

  // jdmarker.c get_dac: arithmetic conditioning, two bytes a table.
  bool ReadDac(const uint8_t* data, size_t n) {
    if (n % 2) return false;
    for (size_t i = 0; i < n; i += 2) {
      int index = data[i], val = data[i + 1];
      if (index >= 2 * kArithTables) return false;
      if (index >= kArithTables) {
        arith_ac_k[index - kArithTables] = uint8_t(val);
      } else {
        arith_dc_l[index] = uint8_t(val & 0x0F);
        arith_dc_u[index] = uint8_t(val >> 4);
        if (arith_dc_l[index] > arith_dc_u[index]) return false;
      }
    }
    return true;
  }

  bool ReadSof(const uint8_t* data, size_t n) {
    if (frame_seen || n < 6 || data[0] != 8) return false;  // 8-bit samples only
    height = (data[1] << 8) | data[2];
    width = (data[3] << 8) | data[4];
    int nc = data[5];
    if (width <= 0 || height <= 0 || int64_t(width) * height > kMaxPixels) return false;
    if (nc < 1 || nc > 4 || n != 6 + size_t(3 * nc)) return false;
    comps.resize(nc);
    for (int i = 0; i < nc; ++i) {
      Component& c = comps[i];
      c.id = data[6 + 3 * i];
      c.h = data[7 + 3 * i] >> 4;
      c.v = data[7 + 3 * i] & 15;
      c.tq = data[8 + 3 * i];
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3) return false;
      hmax = std::max(hmax, c.h);
      vmax = std::max(vmax, c.v);
      std::fill(c.coef_bits, c.coef_bits + 64, -1);
      std::fill(c.prev_coef_bits, c.prev_coef_bits + 64, 0);
    }
    mcus_x = (width + 8 * hmax - 1) / (8 * hmax);
    mcus_y = (height + 8 * vmax - 1) / (8 * vmax);
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

  // --- Huffman: sequential (jdhuff.c decode_mcu) and the four progressive
  // procedures (jdphuff.c).  Each returns false only on a fatal error.

  void HuffSequential(ScanState& s, int16_t** blocks, const int* member, int n) {
    for (int i = 0; i < n; ++i) {
      const int ci = member[i];
      int16_t* block = blocks[i];
      int t = s.huff.Decode(*s.dc_tbl[ci]);
      if (t) t = Extend(s.huff.Get(t), t);
      s.last_dc[ci] = int(unsigned(s.last_dc[ci]) + unsigned(t));
      block[0] = int16_t(s.last_dc[ci]);
      const HuffTable& act = *s.ac_tbl[ci];
      for (int k = 1; k < 64; ++k) {
        int rs = s.huff.Decode(act);
        int r = rs >> 4;
        t = rs & 15;
        if (t) {
          k += r;
          block[kZigzag[k]] = int16_t(Extend(s.huff.Get(t), t));
        } else {
          if (r != 15) break;
          k += 15;
        }
      }
    }
  }

  bool HuffDcFirst(ScanState& s, int16_t** blocks, const int* member, int n) {
    for (int i = 0; i < n; ++i) {
      const int ci = member[i];
      int t = s.huff.Decode(*s.dc_tbl[ci]);
      if (t) t = Extend(s.huff.Get(t), t);
      const int last = s.last_dc[ci];
      if ((last >= 0 && t > INT32_MAX - last) || (last < 0 && t < INT32_MIN - last)) return false;
      s.last_dc[ci] = last + t;
      blocks[i][0] = int16_t(unsigned(s.last_dc[ci]) << s.al);
    }
    return true;
  }

  void HuffDcRefine(ScanState& s, int16_t** blocks, int n) {
    const int p1 = 1 << s.al;
    for (int i = 0; i < n; ++i)
      if (s.huff.Get(1)) blocks[i][0] = int16_t(blocks[i][0] | p1);
  }

  void HuffAcFirst(ScanState& s, int16_t* block) {
    if (s.eobrun > 0) {
      --s.eobrun;
      return;
    }
    const HuffTable& t = *s.ac_tbl[0];
    for (int k = s.ss; k <= s.se; ++k) {
      int v = s.huff.Decode(t);
      int r = v >> 4;
      v &= 15;
      if (v) {
        k += r;
        v = Extend(s.huff.Get(v), v);
        block[kZigzag[k]] = int16_t(unsigned(v) << s.al);
      } else if (r == 15) {
        k += 15;
      } else {
        s.eobrun = 1u << r;
        if (r) s.eobrun += unsigned(s.huff.Get(r));
        --s.eobrun;
        break;
      }
    }
  }

  void HuffAcRefine(ScanState& s, int16_t* block) {
    const int p1 = 1 << s.al;
    const int m1 = int(~0u << s.al);
    const HuffTable& t = *s.ac_tbl[0];
    int k = s.ss;
    auto correct = [&](int16_t* coef) {
      if (s.huff.Get(1) && (*coef & p1) == 0) *coef = int16_t(*coef >= 0 ? *coef + p1 : *coef + m1);
    };
    if (s.eobrun == 0) {
      for (; k <= s.se; ++k) {
        int v = s.huff.Decode(t);
        int r = v >> 4;
        v &= 15;
        if (v) {
          v = s.huff.Get(1) ? p1 : m1;  // a newly nonzero coefficient of size 1
        } else if (r != 15) {
          s.eobrun = 1u << r;
          if (r) s.eobrun += unsigned(s.huff.Get(r));
          break;  // the rest of the block is the EOB run's
        }
        // Skip r zero coefficients, correcting the nonzero ones passed.
        do {
          int16_t* coef = block + kZigzag[k];
          if (*coef != 0) {
            correct(coef);
          } else if (--r < 0) {
            break;
          }
          ++k;
        } while (k <= s.se);
        if (v) block[kZigzag[k]] = int16_t(v);
      }
    }
    if (s.eobrun > 0) {
      for (; k <= s.se; ++k) {
        int16_t* coef = block + kZigzag[k];
        if (*coef != 0) correct(coef);
      }
      --s.eobrun;
    }
  }

  // --- Arithmetic (jdarith.c): sequential and the four progressive
  // procedures.  A decoding error (ct = -1) stops the scan's output until
  // the next restart, as libjpeg's does.

  // Figures F.19-F.24: a DC difference (0, or its sign, magnitude category
  // and bits); returns false on a magnitude overflow.
  bool ArithDc(ScanState& s, int ci, int* diff) {
    const int tbl = s.comp[ci]->td;
    uint8_t* st = s.dc_stats[tbl] + s.dc_context[ci];
    if (s.arith.Decode(st) == 0) {
      s.dc_context[ci] = 0;
      *diff = 0;
      return true;
    }
    const int sign = s.arith.Decode(st + 1);
    st += 2 + sign;
    int m = s.arith.Decode(st);
    if (m != 0) {
      st = s.dc_stats[tbl] + 20;  // X1
      while (s.arith.Decode(st)) {
        if ((m <<= 1) == 0x8000) {
          s.arith.ct = -1;
          return false;
        }
        st += 1;
      }
    }
    if (m < int((1L << arith_dc_l[tbl]) >> 1))
      s.dc_context[ci] = 0;
    else if (m > int((1L << arith_dc_u[tbl]) >> 1))
      s.dc_context[ci] = 12 + sign * 4;
    else
      s.dc_context[ci] = 4 + sign * 4;
    int v = m;
    st += 14;
    while (m >>= 1)
      if (s.arith.Decode(st)) v |= m;
    v += 1;
    *diff = sign ? -v : v;
    return true;
  }

  // One AC coefficient's value after its position is known (k, st at S0).
  bool ArithAcValue(ScanState& s, int tbl, int k, uint8_t* st, int* out) {
    const int sign = s.arith.Decode(&s.fixed_bin);
    st += 2;
    int m = s.arith.Decode(st);
    if (m != 0) {
      if (s.arith.Decode(st)) {
        m <<= 1;
        st = s.ac_stats[tbl] + (k <= arith_ac_k[tbl] ? 189 : 217);
        while (s.arith.Decode(st)) {
          if ((m <<= 1) == 0x8000) {
            s.arith.ct = -1;
            return false;
          }
          st += 1;
        }
      }
    }
    int v = m;
    st += 14;
    while (m >>= 1)
      if (s.arith.Decode(st)) v |= m;
    v += 1;
    *out = sign ? -v : v;
    return true;
  }

  // Figure F.20: a block's AC coefficients ss..se, each shifted left by al.
  // A spectral or magnitude overflow sets ct to -1.
  void ArithAcBand(ScanState& s, int tbl, int16_t* block, int ss, int se, int al) {
    for (int k = ss; k <= se; ++k) {
      uint8_t* st = s.ac_stats[tbl] + 3 * (k - 1);
      if (s.arith.Decode(st)) break;  // EOB
      while (s.arith.Decode(st + 1) == 0) {
        st += 3;
        if (++k > se) {
          s.arith.ct = -1;  // spectral overflow
          return;
        }
      }
      int v;
      if (!ArithAcValue(s, tbl, k, st, &v)) return;
      block[kZigzag[k]] = int16_t(unsigned(v) << al);
    }
  }

  void ArithSequential(ScanState& s, int16_t** blocks, const int* member, int n) {
    if (s.arith.ct == -1) return;
    for (int i = 0; i < n; ++i) {
      const int ci = member[i];
      int diff;
      if (!ArithDc(s, ci, &diff)) return;
      s.last_dc[ci] = int(unsigned(s.last_dc[ci]) + unsigned(diff));
      blocks[i][0] = int16_t(s.last_dc[ci]);
      ArithAcBand(s, s.comp[ci]->ta, blocks[i], 1, 63, 0);
      if (s.arith.ct == -1) return;
    }
  }

  void ArithDcFirst(ScanState& s, int16_t** blocks, const int* member, int n) {
    if (s.arith.ct == -1) return;
    for (int i = 0; i < n; ++i) {
      const int ci = member[i];
      int diff;
      if (!ArithDc(s, ci, &diff)) return;
      s.last_dc[ci] = int(unsigned(s.last_dc[ci]) + unsigned(diff));
      blocks[i][0] = int16_t(unsigned(s.last_dc[ci]) << s.al);
    }
  }

  void ArithDcRefine(ScanState& s, int16_t** blocks, int n) {
    const int p1 = 1 << s.al;
    for (int i = 0; i < n; ++i)
      if (s.arith.Decode(&s.fixed_bin)) blocks[i][0] = int16_t(blocks[i][0] | p1);
  }

  void ArithAcFirst(ScanState& s, int16_t* block) {
    if (s.arith.ct != -1) ArithAcBand(s, s.comp[0]->ta, block, s.ss, s.se, s.al);
  }

  void ArithAcRefine(ScanState& s, int16_t* block) {
    if (s.arith.ct == -1) return;
    const int tbl = s.comp[0]->ta;
    const int p1 = 1 << s.al;
    const int m1 = int(~0u << s.al);
    int kex = s.se;  // the previous stage's end of block
    for (; kex > 0; --kex)
      if (block[kZigzag[kex]]) break;
    for (int k = s.ss; k <= s.se; ++k) {
      uint8_t* st = s.ac_stats[tbl] + 3 * (k - 1);
      if (k > kex && s.arith.Decode(st)) break;  // EOB
      for (;;) {
        int16_t* coef = block + kZigzag[k];
        if (*coef) {
          if (s.arith.Decode(st + 2)) *coef = int16_t(*coef < 0 ? *coef + m1 : *coef + p1);
          break;
        }
        if (s.arith.Decode(st + 1)) {
          *coef = int16_t(s.arith.Decode(&s.fixed_bin) ? m1 : p1);
          break;
        }
        st += 3;
        ++k;
        if (k > s.se) {
          s.arith.ct = -1;
          return;
        }
      }
    }
  }

  // jdhuff.c / jdphuff.c / jdarith.c process_restart.
  void Restart(ScanState& s) {
    if (arithmetic) {
      src.ReadRestartMarker();
      for (int ci = 0; ci < s.ns; ++ci) {
        if (!progressive || (s.ss == 0 && s.ah == 0)) {
          memset(s.dc_stats[s.comp[ci]->td], 0, 64);
          s.last_dc[ci] = 0;
          s.dc_context[ci] = 0;
        }
        if (!progressive || s.ss) memset(s.ac_stats[s.comp[ci]->ta], 0, 256);
      }
      s.arith.Reset();
    } else {
      s.huff.Discard();
      src.ReadRestartMarker();
      for (int ci = 0; ci < s.ns; ++ci) s.last_dc[ci] = 0;
      s.eobrun = 0;
      if (src.unread_marker == 0) s.insufficient = false;
    }
  }

  // One MCU by the scan's procedure.  Returns false on a fatal error.
  bool DecodeMcu(ScanState& s, int16_t** blocks, const int* member, int n) {
    if (arithmetic) {
      if (!progressive) {
        ArithSequential(s, blocks, member, n);
      } else if (s.ss == 0) {
        if (s.ah == 0)
          ArithDcFirst(s, blocks, member, n);
        else
          ArithDcRefine(s, blocks, n);
      } else if (s.ah == 0) {
        ArithAcFirst(s, blocks[0]);
      } else {
        ArithAcRefine(s, blocks[0]);
      }
      return true;
    }
    if (!progressive) {
      if (!s.insufficient) HuffSequential(s, blocks, member, n);
    } else if (s.ss == 0) {
      if (s.ah != 0) {
        HuffDcRefine(s, blocks, n);  // zero bits past the data change nothing
      } else if (!s.insufficient && !HuffDcFirst(s, blocks, member, n)) {
        return false;
      }
    } else if (!s.insufficient) {
      if (s.ah == 0)
        HuffAcFirst(s, blocks[0]);
      else
        HuffAcRefine(s, blocks[0]);
    }
    return true;
  }

  // The scan header's checks and set-up (jdmarker.c get_sos, jdinput.c
  // start_input_pass, the entropy decoders' start_pass).
  bool StartScan(const uint8_t* data, size_t n, ScanState& s) {
    if (!frame_seen || n < 1) return false;
    const int ns = data[0];
    if (ns < 1 || ns > 4 || n != 4 + size_t(2 * ns)) return false;
    s.ns = ns;
    bool taken[4] = {};
    for (int i = 0; i < ns; ++i) {
      int id = data[1 + 2 * i];
      int found = -1;
      for (int ci = 0; ci < int(comps.size()) && ci < 4; ++ci)
        if (comps[ci].id == id && !taken[ci]) {
          found = ci;
          break;
        }
      if (found < 0) return false;
      taken[found] = true;
      Component* c = &comps[found];
      c->td = data[2 + 2 * i] >> 4;
      c->ta = data[2 + 2 * i] & 15;
      s.comp[i] = c;
    }
    const size_t p = 1 + 2 * size_t(ns);
    s.ss = data[p];
    s.se = data[p + 1];
    s.ah = data[p + 2] >> 4;
    s.al = data[p + 2] & 15;
    src.next_restart_num = 0;
    ++scans;
    if (scans == 1) {
      multiple_scans = progressive || ns < int(comps.size());
      if (!arithmetic && !progressive) {
        // jdhuff.c jinit_huff_decoder's std_huff_tables (jdphuff.c has none).
        if (!dc[0].present) BuildHuffTable(kStdDcLumaCounts, kStdDcValues, 12, &dc[0]);
        if (!ac[0].present) BuildHuffTable(kStdAcLumaCounts, kStdAcLumaValues, 162, &ac[0]);
        if (!dc[1].present) BuildHuffTable(kStdDcChromaCounts, kStdDcValues, 12, &dc[1]);
        if (!ac[1].present) BuildHuffTable(kStdAcChromaCounts, kStdAcChromaValues, 162, &ac[1]);
      }
    } else if (!multiple_scans) {
      return false;  // JERR_EOI_EXPECTED: one scan held every component
    }
    if (ns > 1) {
      int blocks = 0;
      for (int i = 0; i < ns; ++i) blocks += s.comp[i]->h * s.comp[i]->v;
      if (blocks > kMaxBlocksInMcu) return false;
    }
    // jdinput.c latch_quant_tables.
    for (int i = 0; i < ns; ++i) {
      Component* c = s.comp[i];
      if (c->quant_latched) continue;
      if (!qt_present[c->tq]) return false;
      for (int k = 0; k < 64; ++k) c->quant[k] = int16_t(qt[c->tq][k]);
      c->quant_latched = true;
    }
    if (progressive) {
      bool bad = false;
      if (s.ss == 0) {
        bad = s.se != 0;
      } else {
        bad = s.ss > s.se || s.se > 63 || ns != 1;
      }
      if (s.ah != 0 && s.al != s.ah - 1) bad = true;
      if (s.al > 13) bad = true;
      if (bad) return false;  // JERR_BAD_PROGRESSION
      // Progression status; inconsistencies between scans are warnings.
      for (int i = 0; i < ns; ++i) {
        Component* c = s.comp[i];
        for (int k = std::min(s.ss, 1); k <= std::max(s.se, 9); ++k)
          c->prev_coef_bits[k] = scans > 1 ? c->coef_bits[k] : 0;
        for (int k = s.ss; k <= s.se; ++k) c->coef_bits[k] = s.al;
      }
    }
    s.last_dc[0] = s.last_dc[1] = s.last_dc[2] = s.last_dc[3] = 0;
    s.eobrun = 0;
    s.insufficient = false;
    if (arithmetic) {
      for (int i = 0; i < ns; ++i) {
        const Component* c = s.comp[i];
        if (!progressive || (s.ss == 0 && s.ah == 0)) {
          memset(s.dc_stats[c->td], 0, 64);
          s.dc_context[i] = 0;
        }
        if (!progressive || s.ss) memset(s.ac_stats[c->ta], 0, 256);
      }
      s.fixed_bin = 113;
      s.arith.src = &src;
      s.arith.Reset();
    } else {
      for (int i = 0; i < ns; ++i) {
        const Component* c = s.comp[i];
        const bool dc_needed = !progressive || (s.ss == 0 && s.ah == 0);
        const bool ac_needed = !progressive || s.ss != 0;
        if (dc_needed) {
          if (c->td > 3 || !dc[c->td].present) return false;
          for (int k = 0; k < dc[c->td].n_symbols; ++k)
            if (dc[c->td].vals[k] > 15) return false;  // JERR_BAD_HUFF_TABLE
          s.dc_tbl[i] = &dc[c->td];
        }
        if (ac_needed) {
          if (c->ta > 3 || !ac[c->ta].present) return false;
          s.ac_tbl[i] = &ac[c->ta];
        }
      }
      s.huff = HuffBits{&src, &s.insufficient};
    }
    return true;
  }

  // One scan: its header (`data`, n bytes), then its entropy-coded data.
  bool ReadScan(const uint8_t* data, size_t n) {
    ScanState& s = scan;
    if (!StartScan(data, n, s)) return false;
    int restarts_to_go = restart_interval;
    int16_t* blocks[kMaxBlocksInMcu];
    int member[kMaxBlocksInMcu];
    auto mcu = [&](int imcu_row, int n_blocks) {
      if (!s.insufficient) last_good_imcu_row = imcu_row;
      if (restart_interval) {
        if (restarts_to_go == 0) {
          Restart(s);
          restarts_to_go = restart_interval;
        }
        --restarts_to_go;
      }
      return DecodeMcu(s, blocks, member, n_blocks);
    };
    if (s.ns == 1) {
      Component& c = *s.comp[0];
      member[0] = 0;
      for (int by = 0; by < c.height_in_blocks; ++by) {
        for (int bx = 0; bx < c.width_in_blocks; ++bx) {
          blocks[0] = c.Block(by, bx);
          if (!mcu(by / c.v, 1)) return false;
        }
      }
    } else {
      for (int my = 0; my < mcus_y; ++my) {
        for (int mx = 0; mx < mcus_x; ++mx) {
          int k = 0;
          for (int i = 0; i < s.ns; ++i) {
            Component* c = s.comp[i];
            for (int v = 0; v < c->v; ++v)
              for (int h = 0; h < c->h; ++h) {
                blocks[k] = c->Block(my * c->v + v, mx * c->h + h);
                member[k++] = i;
              }
          }
          if (!mcu(my, k)) return false;
        }
      }
    }
    return true;
  }

  // Parse the whole stream; every scan's coefficients land in `comps`.
  bool Parse(bool header_only) {
    src.pos = 2;  // past SOI
    for (;;) {
      // The marker that ended a scan, else the next one.  Past the end of
      // the data comes a fake EOI, as libjpeg inserts one (with a warning).
      const int m = src.unread_marker ? src.unread_marker : src.NextMarker();
      src.unread_marker = 0;
      if (m == 0xD9) return scans > 0 && !header_only;  // EOI
      if (m == 0x01 || (m >= 0xD0 && m <= 0xD7)) continue;  // TEM, RSTn
      if (m == 0xD8) return false;                           // a second SOI
      const uint8_t* b;
      size_t n;
      if (!Segment((m >= 0xE0 && m <= 0xEF) || m == 0xFE || m == 0xDC, &b, &n)) return false;
      switch (m) {
        case 0xC0:  // baseline
        case 0xC1:  // extended sequential, Huffman
        case 0xC2:  // progressive, Huffman
        case 0xC9:  // extended sequential, arithmetic
        case 0xCA:  // progressive, arithmetic
          progressive = m == 0xC2 || m == 0xCA;
          arithmetic = m >= 0xC9;
          if (!ReadSof(b, n)) return false;
          if (header_only) return true;
          break;
        case 0xC4:
          if (!ReadDht(b, n)) return false;
          break;
        case 0xCC:
          if (!ReadDac(b, n)) return false;
          break;
        case 0xDB:
          if (!ReadDqt(b, n)) return false;
          break;
        case 0xDD:
          if (n != 2) return false;
          restart_interval = (b[0] << 8) | b[1];
          break;
        case 0xDA:
          if (header_only || !ReadScan(b, n)) return false;
          break;
        case 0xDC:  // DNL: skipped, as libjpeg skips it
          break;
        case 0xE0:
          if (n >= 14 && memcmp(b, "JFIF\0", 5) == 0) saw_jfif = true;
          break;
        case 0xEE:
          if (n >= 12 && memcmp(b, "Adobe", 5) == 0) {
            saw_adobe = true;
            adobe_transform = b[11];
          }
          break;
        default:
          // APPn and COM are skipped.  Lossless (C3), differential (C5-C7,
          // CD-CF), lossless arithmetic (CB) and JPG (C8) frames, and the
          // reserved markers, fail as they fail in libjpeg.
          if ((m >= 0xE0 && m <= 0xEF) || m == 0xFE) break;
          return false;
      }
    }
  }
};

constexpr int kConstBits = 13;
constexpr int kPass1Bits = 2;
constexpr int32_t FIX_0_298631336 = 2446;
constexpr int32_t FIX_0_390180644 = 3196;
constexpr int32_t FIX_0_541196100 = 4433;
constexpr int32_t FIX_0_765366865 = 6270;
constexpr int32_t FIX_0_899976223 = 7373;
constexpr int32_t FIX_1_175875602 = 9633;
constexpr int32_t FIX_1_501321110 = 12299;
constexpr int32_t FIX_1_847759065 = 15137;
constexpr int32_t FIX_1_961570560 = 16069;
constexpr int32_t FIX_2_053119869 = 16819;
constexpr int32_t FIX_2_562915447 = 20995;
constexpr int32_t FIX_3_072711026 = 25172;

inline int16_t Saturate16(int32_t x) { return int16_t(std::min(32767, std::max(-32768, x))); }

// One 8-point pass of jidctint.c's accurate integer IDCT, in the
// arithmetic of libjpeg-turbo's SSE2/AVX2 jsimd_idct_islow, which is what
// libjpeg decodes with on x86: 16-bit inputs whose sums in0+in4, in0-in4,
// in3+in7 and in1+in5 wrap at 16 bits, products summed in 32 bits that
// wrap, then descaled with rounding.  On the data of a valid file nothing
// wraps and this is jidctint.c's own result.
inline void IdctPass(const int16_t* in, int32_t* out, int descale) {
  auto madd = [](int16_t a, int32_t fa, int16_t b, int32_t fb) { return int64_t(a) * fa + int64_t(b) * fb; };
  const int64_t tmp3 = madd(in[2], FIX_0_541196100 + FIX_0_765366865, in[6], FIX_0_541196100);
  const int64_t tmp2 = madd(in[2], FIX_0_541196100, in[6], FIX_0_541196100 - FIX_1_847759065);
  const int64_t t0 = int64_t(int16_t(in[0] + in[4])) * (1 << kConstBits);
  const int64_t t1 = int64_t(int16_t(in[0] - in[4])) * (1 << kConstBits);
  const int64_t tmp10 = t0 + tmp3, tmp13 = t0 - tmp3, tmp11 = t1 + tmp2, tmp12 = t1 - tmp2;
  const int16_t z3 = int16_t(in[3] + in[7]), z4 = int16_t(in[1] + in[5]);
  const int64_t z3f = madd(z3, FIX_1_175875602 - FIX_1_961570560, z4, FIX_1_175875602);
  const int64_t z4f = madd(z3, FIX_1_175875602, z4, FIX_1_175875602 - FIX_0_390180644);
  const int64_t o0 = madd(in[7], FIX_0_298631336 - FIX_0_899976223, in[1], -FIX_0_899976223) + z3f;
  const int64_t o3 = madd(in[7], -FIX_0_899976223, in[1], FIX_1_501321110 - FIX_0_899976223) + z4f;
  const int64_t o1 = madd(in[5], FIX_2_053119869 - FIX_2_562915447, in[3], -FIX_2_562915447) + z4f;
  const int64_t o2 = madd(in[5], -FIX_2_562915447, in[3], FIX_3_072711026 - FIX_2_562915447) + z3f;
  const int64_t round = int64_t(1) << (descale - 1);
  auto put = [&](int64_t x) { return int32_t(uint32_t(uint64_t(x + round))) >> descale; };
  out[0] = put(tmp10 + o3);
  out[7] = put(tmp10 - o3);
  out[1] = put(tmp11 + o2);
  out[6] = put(tmp11 - o2);
  out[2] = put(tmp12 + o1);
  out[5] = put(tmp12 - o1);
  out[3] = put(tmp13 + o0);
  out[4] = put(tmp13 - o0);
}

// jidctint.c jpeg_idct_islow as libjpeg-turbo's SIMD computes it: one
// block dequantized with 16-bit products, columns then rows, each pass's
// results saturated to 16 bits, the samples to [-128, 127] and then
// centred.  Where rows 1-7 of every column are zero, the column pass is
// the DC term shifted left in 16 bits.
void IdctIslow(const int16_t* coef, const int16_t* quant, uint8_t* out, size_t stride) {
  int16_t ws[64];  // transposed: ws[8 * col + row]
  bool ac_zero = true;
  for (int i = 8; i < 64 && ac_zero; ++i) ac_zero = coef[i] == 0;
  if (ac_zero) {
    for (int col = 0; col < 8; ++col) {
      const int16_t dc = int16_t(uint16_t(int16_t(coef[col] * quant[col])) << kPass1Bits);
      for (int row = 0; row < 8; ++row) ws[8 * col + row] = dc;
    }
  } else {
    for (int col = 0; col < 8; ++col) {
      int16_t in[8];
      int32_t o[8];
      for (int k = 0; k < 8; ++k) in[k] = int16_t(coef[8 * k + col] * quant[8 * k + col]);
      IdctPass(in, o, kConstBits - kPass1Bits);
      for (int k = 0; k < 8; ++k) ws[8 * col + k] = Saturate16(o[k]);
    }
  }
  for (int row = 0; row < 8; ++row) {
    int16_t in[8];
    int32_t o[8];
    for (int k = 0; k < 8; ++k) in[k] = ws[8 * k + row];
    IdctPass(in, o, kConstBits + kPass1Bits + 3);
    uint8_t* dst = out + size_t(row) * stride;
    for (int k = 0; k < 8; ++k) dst[k] = uint8_t(std::min(127, std::max(-128, int(Saturate16(o[k])))) + 128);
  }
}

// jdcoefct.c (libjpeg-turbo 2.1) smoothing_ok: whether a progressive
// file's output pass smooths its blocks, and the coefficient bits it
// reads, latched per component (and those before each component's latest
// scan, for the rows its last scan did not reach).
constexpr int kSavedCoefs = 10;
constexpr int kSmoothPos[kSavedCoefs] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};

bool SmoothingOk(const JpegDecoder& d, int (*latch)[kSavedCoefs], int (*prev_latch)[kSavedCoefs]) {
  if (!d.progressive) return false;
  bool useful = false;
  for (size_t ci = 0; ci < d.comps.size(); ++ci) {
    const Component& c = d.comps[ci];
    if (!c.quant_latched) return false;
    for (int pos : kSmoothPos)
      if (c.quant[pos] == 0) return false;
    if (c.coef_bits[0] < 0) return false;
    latch[ci][0] = c.coef_bits[0];
    for (int k = 1; k < kSavedCoefs; ++k) {
      prev_latch[ci][k] = d.scans > 1 ? c.prev_coef_bits[k] : -1;
      latch[ci][k] = c.coef_bits[k];
      if (c.coef_bits[k] != 0) useful = true;
    }
  }
  return useful;
}

// The estimate of a coefficient from `num` (jdcoefct.c): rounded, and
// below the bit the coefficient is known to.
inline int16_t SmoothEstimate(int64_t num, int64_t q, int al) {
  int pred;
  if (num >= 0) {
    pred = int(((q << 7) + num) / (q << 8));
    if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
  } else {
    pred = int(((q << 7) - num) / (q << 8));
    if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
    pred = -pred;
  }
  return int16_t(pred);
}

// jdcoefct.c decompress_smooth_data (libjpeg-turbo 2.1): each block's
// first 9 AC coefficients still zero and not known in full are estimated
// from the DC values of the 5x5 blocks around it, and where no AC
// coefficient has arrived the DC too; then the IDCT.  Rows and columns
// past the edges repeat as libjpeg repeats them, by iMCU row.
void SmoothAndIdct(const Component& c, const int* bits, const int* prev_bits, int last_good_row,
                   int total_imcu_rows, uint8_t* plane, size_t stride) {
  const int v = c.v;
  const int last_row = total_imcu_rows - 1;
  const int last_col = c.width_in_blocks - 1;
  auto dc = [&](int by, int bx) { return int(c.coefs[(size_t(by) * c.blocks_w + bx) * 64]); };
  const int64_t Q00 = c.quant[0], Q01 = c.quant[1], Q10 = c.quant[8], Q20 = c.quant[16], Q11 = c.quant[9],
                Q02 = c.quant[2], Q03 = c.quant[3], Q12 = c.quant[10], Q21 = c.quant[17], Q30 = c.quant[24];
  int16_t ws[64];
  for (int row = 0; row < total_imcu_rows; ++row) {
    int block_rows = v;
    if (row == last_row) {
      block_rows = c.height_in_blocks % v;
      if (block_rows == 0) block_rows = v;
    }
    const int* cb = row > last_good_row ? prev_bits : bits;
    bool change_dc = true;
    for (int k = 1; k <= 9; ++k) change_dc = change_dc && cb[k] == -1;
    for (int br = 0; br < block_rows; ++br) {
      const int r = row * v + br;
      const int prev = br > 0 || row > 0 ? r - 1 : r;
      const int prev_prev = br > 1 || row > 1 ? r - 2 : prev;
      const int next = br < block_rows - 1 || row < last_row ? r + 1 : r;
      const int next_next = br < block_rows - 2 || row + 1 < last_row ? r + 2 : next;
      const int rows[5] = {prev_prev, prev, r, next, next_next};
      int DC[26];  // DC[1..25]: the 5x5 window, row by row
      for (int i = 0; i < 5; ++i)
        for (int j = 1; j <= 5; ++j) DC[5 * i + j] = dc(rows[i], 0);
      for (int bx = 0; bx <= last_col; ++bx) {
        memcpy(ws, &c.coefs[(size_t(r) * c.blocks_w + bx) * 64], sizeof(ws));
        if (bx == 0 && bx < last_col)
          for (int i = 0; i < 5; ++i) DC[5 * i + 4] = dc(rows[i], bx + 1);
        if (bx + 1 < last_col)
          for (int i = 0; i < 5; ++i) DC[5 * i + 5] = dc(rows[i], bx + 2);
        int al;
        if ((al = cb[1]) != 0 && ws[1] == 0) {  // AC01
          int64_t num = Q00 * (change_dc ? (-DC[1] - DC[2] + DC[4] + DC[5] - 3 * DC[6] + 13 * DC[7] -
                                            13 * DC[9] + 3 * DC[10] - 3 * DC[11] + 38 * DC[12] - 38 * DC[14] +
                                            3 * DC[15] - 3 * DC[16] + 13 * DC[17] - 13 * DC[19] + 3 * DC[20] -
                                            DC[21] - DC[22] + DC[24] + DC[25])
                                         : (-7 * DC[11] + 50 * DC[12] - 50 * DC[14] + 7 * DC[15]));
          ws[1] = SmoothEstimate(num, Q01, al);
        }
        if ((al = cb[2]) != 0 && ws[8] == 0) {  // AC10
          int64_t num = Q00 * (change_dc ? (-DC[1] - 3 * DC[2] - 3 * DC[3] - 3 * DC[4] - DC[5] - DC[6] +
                                            13 * DC[7] + 38 * DC[8] + 13 * DC[9] - DC[10] + DC[16] -
                                            13 * DC[17] - 38 * DC[18] - 13 * DC[19] + DC[20] + DC[21] +
                                            3 * DC[22] + 3 * DC[23] + 3 * DC[24] + DC[25])
                                         : (-7 * DC[3] + 50 * DC[8] - 50 * DC[18] + 7 * DC[23]));
          ws[8] = SmoothEstimate(num, Q10, al);
        }
        if ((al = cb[3]) != 0 && ws[16] == 0) {  // AC20
          int64_t num = Q00 * (change_dc ? (DC[3] + 2 * DC[7] + 7 * DC[8] + 2 * DC[9] - 5 * DC[12] - 14 * DC[13] -
                                            5 * DC[14] + 2 * DC[17] + 7 * DC[18] + 2 * DC[19] + DC[23])
                                         : (-DC[3] + 13 * DC[8] - 24 * DC[13] + 13 * DC[18] - DC[23]));
          ws[16] = SmoothEstimate(num, Q20, al);
        }
        if ((al = cb[4]) != 0 && ws[9] == 0) {  // AC11
          int64_t num = Q00 * (change_dc ? (-DC[1] + DC[5] + 9 * DC[7] - 9 * DC[9] - 9 * DC[17] + 9 * DC[19] +
                                            DC[21] - DC[25])
                                         : (DC[10] + DC[16] - 10 * DC[17] + 10 * DC[19] - DC[2] - DC[20] +
                                            DC[22] - DC[24] + DC[4] - DC[6] + 10 * DC[7] - 10 * DC[9]));
          ws[9] = SmoothEstimate(num, Q11, al);
        }
        if ((al = cb[5]) != 0 && ws[2] == 0) {  // AC02
          int64_t num = Q00 * (change_dc ? (2 * DC[7] - 5 * DC[8] + 2 * DC[9] + DC[11] + 7 * DC[12] -
                                            14 * DC[13] + 7 * DC[14] + DC[15] + 2 * DC[17] - 5 * DC[18] +
                                            2 * DC[19])
                                         : (-DC[11] + 13 * DC[12] - 24 * DC[13] + 13 * DC[14] - DC[15]));
          ws[2] = SmoothEstimate(num, Q02, al);
        }
        if (change_dc) {
          if ((al = cb[6]) != 0 && ws[3] == 0)  // AC03
            ws[3] = SmoothEstimate(Q00 * (DC[7] - DC[9] + 2 * DC[12] - 2 * DC[14] + DC[17] - DC[19]), Q03, al);
          if ((al = cb[7]) != 0 && ws[10] == 0)  // AC12
            ws[10] = SmoothEstimate(Q00 * (DC[7] - 3 * DC[8] + DC[9] - DC[17] + 3 * DC[18] - DC[19]), Q12, al);
          if ((al = cb[8]) != 0 && ws[17] == 0)  // AC21
            ws[17] = SmoothEstimate(Q00 * (DC[7] - DC[9] - 3 * DC[12] + 3 * DC[14] + DC[17] - DC[19]), Q21, al);
          if ((al = cb[9]) != 0 && ws[24] == 0)  // AC30
            ws[24] = SmoothEstimate(Q00 * (DC[7] + 2 * DC[8] + DC[9] - DC[17] - 2 * DC[18] - DC[19]), Q30, al);
          // The DC value, by a Gaussian-like kernel that keeps the average.
          int64_t num = Q00 * (-2 * DC[1] - 6 * DC[2] - 8 * DC[3] - 6 * DC[4] - 2 * DC[5] - 6 * DC[6] +
                               6 * DC[7] + 42 * DC[8] + 6 * DC[9] - 6 * DC[10] - 8 * DC[11] + 42 * DC[12] +
                               152 * DC[13] + 42 * DC[14] - 8 * DC[15] - 6 * DC[16] + 6 * DC[17] +
                               42 * DC[18] + 6 * DC[19] - 6 * DC[20] - 2 * DC[21] - 6 * DC[22] - 8 * DC[23] -
                               6 * DC[24] - 2 * DC[25]);
          ws[0] = SmoothEstimate(num, Q00, 0);
        }
        IdctIslow(ws, c.quant, plane + size_t(r) * 8 * stride + size_t(bx) * 8, stride);
        for (int i = 0; i < 5; ++i)
          for (int j = 1; j <= 4; ++j) DC[5 * i + j] = DC[5 * i + j + 1];
      }
    }
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
  std::unique_ptr<JpegDecoder> owner(new JpegDecoder());
  JpegDecoder& d = *owner;
  d.src.data = bytes;
  d.src.len = len;
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
  for (const Component& c : d.comps)
    if (d.hmax % c.h || d.vmax % c.v) return false;  // fractional sampling

  int latch[4][kSavedCoefs], prev_latch[4][kSavedCoefs];
  const bool smooth = SmoothingOk(d, latch, prev_latch);
  const int W = d.width, H = d.height;
  std::vector<std::vector<uint8_t>> full(nc);
  for (int ci = 0; ci < nc; ++ci) {
    Component& c = d.comps[ci];
    // A component no scan carried has no quantization table latched: its
    // blocks dequantize to zero, mid-gray (jddctmgr.c).
    if (!c.quant_latched) std::fill(c.quant, c.quant + 64, int16_t(0));
    size_t stride = size_t(c.blocks_w) * 8;
    std::vector<uint8_t> plane(stride * size_t(c.blocks_h) * 8);
    if (smooth) {
      SmoothAndIdct(c, latch[ci], prev_latch[ci], d.last_good_imcu_row, d.TotalImcuRows(), plane.data(),
                    stride);
    } else {
      for (int by = 0; by < c.height_in_blocks; ++by)
        for (int bx = 0; bx < c.width_in_blocks; ++bx)
          IdctIslow(c.Block(by, bx), c.quant, plane.data() + size_t(by) * 8 * stride + size_t(bx) * 8, stride);
    }
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

// A frame that fails, or whose buffers cannot be allocated, is a failed
// frame: no exception leaves the library.
bool Decode(const uint8_t* bytes, size_t len, Image* out) {
  try {
    return IsJpeg(bytes, len) ? DecodeJpeg(bytes, len, out, nullptr, nullptr)
                              : DecodePng(bytes, len, out, nullptr, nullptr);
  } catch (...) {
    return false;
  }
}

bool Probe(const uint8_t* bytes, size_t len, int* width, int* height) {
  try {
    return IsJpeg(bytes, len) ? DecodeJpeg(bytes, len, nullptr, width, height)
                              : DecodePng(bytes, len, nullptr, width, height);
  } catch (...) {
    return false;
  }
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
  try {
    return ReadFile(path, bytes) && Decode(bytes->data(), bytes->size(), out);
  } catch (...) {
    return false;
  }
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
