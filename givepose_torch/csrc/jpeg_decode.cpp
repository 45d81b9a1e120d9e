// Sequential Huffman JPEG decoding for givepose_torch/data/jpeg.py.
//
// A host library, built with g++ (ops/_build.py build_host).  The Python
// side parses the markers (tables, frame, scans, EXIF); this file does
// what is serial per byte or per block:
//
//   * jpeg_decode_scan: the entropy-coded segment of one scan (baseline
//     or extended-sequential Huffman, interleaved or not, restart
//     intervals, byte stuffing) into each component's quantized
//     coefficients, natural order, one int16[64] per block;
//   * jpeg_reconstruct: the ISLOW inverse DCT of every block, the
//     upsampling of subsampled components and the colour conversion to
//     interleaved BGR.
//
// The arithmetic is libjpeg-turbo's, which OpenCV's imread decodes with:
// the ISLOW IDCT of jidctint.c (CONST_BITS 13, PASS1_BITS 2, the post-IDCT
// range-limit table), the "fancy" triangle upsamplers of jdsample.c
// (h2v1, h1v2, h2v2, with their alternating rounding biases; the last real
// row and column stand for those past the image) and box replication
// otherwise, and the fixed-point YCbCr->RGB tables of jdcolor.c (SCALEBITS
// 16).  All of it is integer arithmetic, so the output is bitwise
// libjpeg-turbo's.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

const int kNaturalOrder[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    // extra entries: a corrupt run past 63 lands on the last coefficient
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Huffman {
  // jdhuff.c jpeg_make_d_derived_tbl: maxcode[l] is the largest code of
  // length l (-1 if none), valoffset[l] maps a code of length l to its
  // index in vals.
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];
  // 8-bit lookahead: (length << 8) | value, or 0 for a longer code
  uint16_t look[256];

  void build(const uint16_t* bits, const uint16_t* huffval) {
    int count = 0;
    for (int l = 1; l <= 16; ++l) count += bits[l];
    if (count > 256) count = 256;
    for (int i = 0; i < count; ++i) vals[i] = uint8_t(huffval[i]);
    int32_t code = 0, p = 0;
    uint8_t sizes[257];
    uint32_t codes[257];
    for (int l = 1; l <= 16; ++l)
      for (int i = 0; i < bits[l] && p < 256; ++i) sizes[p++] = uint8_t(l);
    sizes[p] = 0;
    p = 0;
    int si = sizes[0];
    while (sizes[p]) {
      while (sizes[p] == si) codes[p++] = uint32_t(code++);
      code <<= 1;
      ++si;
    }
    p = 0;
    for (int l = 1; l <= 16; ++l) {
      if (bits[l]) {
        valoffset[l] = p - int32_t(codes[p]);
        p += bits[l];
        maxcode[l] = int32_t(codes[p - 1]);
      } else {
        maxcode[l] = -1;
      }
    }
    maxcode[17] = 0x7FFFFFFF;  // ends a corrupt code's search
    std::memset(look, 0, sizeof(look));
    p = 0;
    for (int l = 1; l <= 8; ++l)
      for (int i = 0; i < bits[l]; ++i, ++p) {
        const int lookbits = int(codes[p] << (8 - l));
        for (int ctr = 1 << (8 - l); ctr > 0; --ctr)
          look[lookbits + ctr - 1] = uint16_t((l << 8) | vals[p]);
      }
  }
};

struct BitReader {
  const uint8_t* data;
  int64_t n;
  int64_t pos;
  uint64_t buf = 0;
  int bits = 0;
  int64_t marker = -1;  // position of the marker code byte that stopped us

  // The next data byte, undoing 0xFF00 stuffing; at a marker (or the end
  // of the data) zeros, as libjpeg-turbo pads a truncated segment.
  int next_byte() {
    if (marker >= 0) return 0;
    if (pos >= n) {
      marker = n;
      return 0;
    }
    int c = data[pos];
    if (c != 0xFF) {
      ++pos;
      return c;
    }
    int64_t q = pos + 1;
    while (q < n && data[q] == 0xFF) ++q;  // fill bytes
    if (q < n && data[q] == 0) {
      pos = q + 1;
      return 0xFF;
    }
    marker = q;
    return 0;
  }

  void fill() {
    while (bits <= 56) {
      buf |= uint64_t(next_byte()) << (56 - bits);
      bits += 8;
    }
  }

  int peek(int k) {
    if (bits < k) fill();
    return int(buf >> (64 - k));
  }

  void skip(int k) {
    buf <<= k;
    bits -= k;
  }

  int get(int k) {
    if (k == 0) return 0;
    const int v = peek(k);
    skip(k);
    return v;
  }

  int decode(const Huffman& h) {
    const int look = h.look[peek(8)];
    if (look) {
      skip(look >> 8);
      return look & 0xFF;
    }
    int l = 9;
    int32_t code = get(9);
    while (code > h.maxcode[l]) {
      code = (code << 1) | get(1);
      if (++l > 16) return 0;  // corrupt: libjpeg-turbo decodes 0 too
    }
    return h.vals[(h.valoffset[l] + code) & 0xFF];
  }

  // Discard the rest of the segment up to its marker; the marker's code
  // byte position, or n at the end of the data.
  int64_t to_marker() {
    buf = 0;
    bits = 0;
    while (marker < 0) next_byte();
    return marker;
  }
};

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

// jidctint.c jpeg_idct_islow, with its post-IDCT range limit
// (range_limit[x & RANGE_MASK], RANGE_MASK 1023, centred on 128).
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

inline int64_t descale(int64_t x, int n) {
  return (x + (int64_t(1) << (n - 1))) >> n;
}

inline uint8_t idct_limit(int64_t x) {
  int v = int(x & 1023);
  v = v >= 512 ? v - 1024 : v;  // the table's wrap: 512..1023 are negative
  v += 128;
  return uint8_t(v < 0 ? 0 : (v > 255 ? 255 : v));
}

void idct_islow(const int16_t* coef, const uint16_t* quant, uint8_t* out,
                int64_t stride) {
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* in = coef + c;
    const uint16_t* q = quant + c;
    if (in[8] == 0 && in[16] == 0 && in[24] == 0 && in[32] == 0 &&
        in[40] == 0 && in[48] == 0 && in[56] == 0) {
      const int dc = int((int64_t(in[0]) * q[0]) * (1 << kPass1Bits));
      for (int r = 0; r < 8; ++r) ws[r * 8 + c] = dc;
      continue;
    }
    int64_t z2 = int64_t(in[16]) * q[16];
    int64_t z3 = int64_t(in[48]) * q[48];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = int64_t(in[0]) * q[0];
    z3 = int64_t(in[32]) * q[32];
    int64_t tmp0 = (z2 + z3) * (1 << kConstBits);
    int64_t tmp1 = (z2 - z3) * (1 << kConstBits);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = int64_t(in[56]) * q[56];
    tmp1 = int64_t(in[40]) * q[40];
    tmp2 = int64_t(in[24]) * q[24];
    tmp3 = int64_t(in[8]) * q[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * FIX_1_175875602;
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
    const int sh = kConstBits - kPass1Bits;
    ws[0 * 8 + c] = int(descale(tmp10 + tmp3, sh));
    ws[7 * 8 + c] = int(descale(tmp10 - tmp3, sh));
    ws[1 * 8 + c] = int(descale(tmp11 + tmp2, sh));
    ws[6 * 8 + c] = int(descale(tmp11 - tmp2, sh));
    ws[2 * 8 + c] = int(descale(tmp12 + tmp1, sh));
    ws[5 * 8 + c] = int(descale(tmp12 - tmp1, sh));
    ws[3 * 8 + c] = int(descale(tmp13 + tmp0, sh));
    ws[4 * 8 + c] = int(descale(tmp13 - tmp0, sh));
  }
  for (int r = 0; r < 8; ++r) {
    const int* w = ws + r * 8;
    uint8_t* o = out + r * stride;
    if (w[1] == 0 && w[2] == 0 && w[3] == 0 && w[4] == 0 && w[5] == 0 &&
        w[6] == 0 && w[7] == 0) {
      const uint8_t v = idct_limit(descale(w[0], kPass1Bits + 3));
      for (int c = 0; c < 8; ++c) o[c] = v;
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * FIX_0_541196100;
    int64_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int64_t tmp3 = z1 + z2 * FIX_0_765366865;
    int64_t tmp0 = (int64_t(w[0]) + w[4]) * (1 << kConstBits);
    int64_t tmp1 = (int64_t(w[0]) - w[4]) * (1 << kConstBits);
    const int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    const int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    const int64_t z5 = (z3 + z4) * FIX_1_175875602;
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
    const int sh = kConstBits + kPass1Bits + 3;
    o[0] = idct_limit(descale(tmp10 + tmp3, sh));
    o[7] = idct_limit(descale(tmp10 - tmp3, sh));
    o[1] = idct_limit(descale(tmp11 + tmp2, sh));
    o[6] = idct_limit(descale(tmp11 - tmp2, sh));
    o[2] = idct_limit(descale(tmp12 + tmp1, sh));
    o[5] = idct_limit(descale(tmp12 - tmp1, sh));
    o[3] = idct_limit(descale(tmp13 + tmp0, sh));
    o[4] = idct_limit(descale(tmp13 - tmp0, sh));
  }
}

inline int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// One component's samples at full resolution (width x height), from its
// plane (stride pw) of dw x dh real samples, by jdsample.c's method for
// its factors (hx, vy).
void upsample(const uint8_t* plane, int64_t pw, int dw, int dh, int hx,
              int vy, int width, int height, uint8_t* out) {
  const bool fancy_h2 = hx == 2 && dw > 2;
  for (int y = 0; y < height; ++y) {
    uint8_t* o = out + int64_t(y) * width;
    if (hx == 1 && vy == 1) {
      std::memcpy(o, plane + int64_t(y) * pw, width);
    } else if (hx == 2 && vy == 1 && fancy_h2) {  // h2v1_fancy_upsample
      const uint8_t* r = plane + int64_t(y) * pw;
      for (int x = 0; x < width; ++x) {
        const int c = x >> 1;
        const int v3 = 3 * r[c];
        o[x] = (x & 1) ? uint8_t((v3 + r[clampi(c + 1, 0, dw - 1)] + 2) >> 2)
                       : uint8_t((v3 + r[clampi(c - 1, 0, dw - 1)] + 1) >> 2);
      }
    } else if (hx == 1 && vy == 2) {  // h1v2_fancy_upsample
      const int row = y >> 1;
      const uint8_t* r0 = plane + int64_t(row) * pw;
      const bool below = y & 1;
      const uint8_t* r1 =
          plane + int64_t(clampi(row + (below ? 1 : -1), 0, dh - 1)) * pw;
      const int bias = below ? 2 : 1;
      for (int x = 0; x < width; ++x)
        o[x] = uint8_t((3 * r0[x] + r1[x] + bias) >> 2);
    } else if (hx == 2 && vy == 2 && fancy_h2) {  // h2v2_fancy_upsample
      const int row = y >> 1;
      const uint8_t* r0 = plane + int64_t(row) * pw;
      const uint8_t* r1 =
          plane + int64_t(clampi(row + ((y & 1) ? 1 : -1), 0, dh - 1)) * pw;
      for (int x = 0; x < width; ++x) {
        const int c = x >> 1;
        const int cs = 3 * r0[c] + r1[c];
        const int n = (x & 1) ? clampi(c + 1, 0, dw - 1) : clampi(c - 1, 0, dw - 1);
        const int ns = 3 * r0[n] + r1[n];
        o[x] = (x & 1) ? uint8_t((3 * cs + ns + 7) >> 4)
                       : uint8_t((3 * cs + ns + 8) >> 4);
      }
    } else {  // box replication (h2v1/h2v2 of narrow images, int_upsample)
      const uint8_t* r = plane + int64_t(y / vy) * pw;
      for (int x = 0; x < width; ++x) o[x] = r[x / hx];
    }
  }
}

}  // namespace

extern "C" {

// Decode the entropy-coded segment of one scan that starts at data[pos].
//
// scan: [ns, restart_interval, mcus_x, mcus_y, then for each of the ns
//        scan components: component index, H, V, blocks_w (the
//        coefficient buffer's width in blocks), dc table, ac table,
//        blocks_x, blocks_y (the component's own size in blocks, for a
//        non-interleaved scan)];
// huff: 8 tables (DC 0-3, then AC 0-3), each 17 counts (index 0 unused)
//       and 256 values, as uint16;
// coefs: one int16 buffer per frame component, 64 per block, row-major
//        blocks.
// Returns the position of the 0xFF that starts the marker after the scan
// (the data's length if it ends first), or -1 on a bad table index.
int64_t jpeg_decode_scan(const uint8_t* data, int64_t n, int64_t pos,
                         const int32_t* scan, const uint16_t* huff,
                         int16_t** coefs) {
  Huffman tables[8];
  for (int t = 0; t < 8; ++t)
    tables[t].build(huff + t * 273, huff + t * 273 + 17);
  const int ns = scan[0];
  const int restart = scan[1];
  const int64_t mcus_x = scan[2], mcus_y = scan[3];
  const int32_t* comp = scan + 4;
  for (int i = 0; i < ns; ++i) {
    const int32_t* c = comp + 8 * i;
    if (c[4] < 0 || c[4] > 3 || c[5] < 0 || c[5] > 3) return -1;
  }
  BitReader br{data, n, pos};
  int pred[4] = {0, 0, 0, 0};
  int64_t total, units_x;
  if (ns == 1) {  // non-interleaved: one block a unit
    units_x = comp[6];
    total = units_x * int64_t(comp[7]);
  } else {
    units_x = mcus_x;
    total = mcus_x * mcus_y;
  }
  auto decode_block = [&](int i, int16_t* blk) {
    const int32_t* c = comp + 8 * i;
    const Huffman& dc = tables[c[4]];
    const Huffman& ac = tables[4 + c[5]];
    std::memset(blk, 0, 64 * sizeof(int16_t));
    const int s = br.decode(dc);
    if (s) pred[i] += extend(br.get(s), s);
    blk[0] = int16_t(pred[i]);
    for (int k = 1; k < 64; ++k) {
      const int rs = br.decode(ac);
      const int r = rs >> 4, sz = rs & 15;
      if (sz) {
        k += r;
        blk[kNaturalOrder[k]] = int16_t(extend(br.get(sz), sz));
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  };
  for (int64_t u = 0; u < total; ++u) {
    if (restart && u && u % restart == 0) {
      const int64_t m = br.to_marker();
      br.pos = m < n ? m + 1 : n;  // past RSTn
      br.marker = -1;
      for (int i = 0; i < 4; ++i) pred[i] = 0;
    }
    const int64_t uy = u / units_x, ux = u % units_x;
    if (ns == 1) {
      const int32_t* c = comp;
      decode_block(0, coefs[c[0]] + (uy * c[3] + ux) * 64);
      continue;
    }
    for (int i = 0; i < ns; ++i) {
      const int32_t* c = comp + 8 * i;
      const int h = c[1], v = c[2];
      for (int yy = 0; yy < v; ++yy)
        for (int xx = 0; xx < h; ++xx) {
          const int64_t by = uy * v + yy, bx = ux * h + xx;
          decode_block(i, coefs[c[0]] + (by * c[3] + bx) * 64);
        }
    }
  }
  const int64_t m = br.to_marker();
  return m < n ? m - 1 : n;
}

// The image from every component's coefficients.
//
// frame: [ncomp, width, height, hmax, vmax, transform, then for each
//         component: H, V, blocks_w, blocks_h];
//         transform: 0 gray, 1 YCbCr, 2 RGB;
// quant: one uint16[64] table per component, natural order;
// out:   height x width x 3 uint8, BGR.
// Returns 0, or 1 for sampling factors that do not divide the largest.
int32_t jpeg_reconstruct(const int32_t* frame, int16_t** coefs,
                         const uint16_t* quant, uint8_t* out) {
  const int ncomp = frame[0], width = frame[1], height = frame[2];
  const int hmax = frame[3], vmax = frame[4], transform = frame[5];
  std::vector<std::vector<uint8_t>> full(ncomp);
  for (int ci = 0; ci < ncomp; ++ci) {
    const int32_t* c = frame + 6 + 4 * ci;
    const int h = c[0], v = c[1];
    const int64_t bw = c[2], bh = c[3];
    if (hmax % h || vmax % v) return 1;
    const int64_t pw = bw * 8;
    std::vector<uint8_t> plane(size_t(pw * bh * 8));
    for (int64_t by = 0; by < bh; ++by)
      for (int64_t bx = 0; bx < bw; ++bx)
        idct_islow(coefs[ci] + (by * bw + bx) * 64, quant + 64 * ci,
                   plane.data() + by * 8 * pw + bx * 8, pw);
    // the component's real size (jdinput.c downsampled_width/height)
    const int dw = int((int64_t(width) * h + hmax - 1) / hmax);
    const int dh = int((int64_t(height) * v + vmax - 1) / vmax);
    full[ci].resize(size_t(width) * height);
    upsample(plane.data(), pw, dw, dh, hmax / h, vmax / v, width, height,
             full[ci].data());
  }
  const int64_t npix = int64_t(width) * height;
  if (transform == 0) {
    const uint8_t* g = full[0].data();
    for (int64_t p = 0; p < npix; ++p)
      out[3 * p] = out[3 * p + 1] = out[3 * p + 2] = g[p];
  } else if (transform == 2) {
    for (int64_t p = 0; p < npix; ++p) {
      out[3 * p] = full[2][p];
      out[3 * p + 1] = full[1][p];
      out[3 * p + 2] = full[0][p];
    }
  } else {
    // jdcolor.c build_ycc_rgb_table
    constexpr int kScale = 16;
    constexpr int64_t kHalf = int64_t(1) << (kScale - 1);
    auto fix = [](double x) {
      return int64_t(x * double(int64_t(1) << kScale) + 0.5);
    };
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    for (int i = 0; i < 256; ++i) {
      const int64_t x = i - 128;
      cr_r[i] = int((fix(1.40200) * x + kHalf) >> kScale);
      cb_b[i] = int((fix(1.77200) * x + kHalf) >> kScale);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + kHalf;
    }
    const uint8_t *Y = full[0].data(), *Cb = full[1].data(),
                  *Cr = full[2].data();
    for (int64_t p = 0; p < npix; ++p) {
      const int y = Y[p], cb = Cb[p], cr = Cr[p];
      out[3 * p + 2] = uint8_t(clampi(y + cr_r[cr], 0, 255));
      out[3 * p + 1] =
          uint8_t(clampi(y + int((cb_g[cb] + cr_g[cr]) >> kScale), 0, 255));
      out[3 * p] = uint8_t(clampi(y + cb_b[cb], 0, 255));
    }
  }
  return 0;
}

}  // extern "C"
