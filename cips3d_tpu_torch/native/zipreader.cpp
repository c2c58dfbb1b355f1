// Native image IO for the PyTorch port's data path: zip members, PNG and
// JPEG decode to RGB8, and PIL's fixed-point resize.
//
// The port's own copy of `cips3d_tpu/native/zipreader.cpp` (the zip parser
// and the PNG decoder), bound through ctypes by `native/__init__.py`, with:
//   * a lock per archive held only over the seek and read of its FILE*:
//     inflate and decode run outside it, so reader threads decode in
//     parallel (ctypes releases the GIL for the call);
//   * `zr_decode_image`, the same decode for a byte buffer (files outside a
//     zip, MJPEG frames);
//   * a baseline / extended-sequential Huffman JPEG decoder (SOF0/SOF1,
//     8-bit, grey or YCbCr/RGB, sampling 4:4:4, 4:2:2, 4:2:0, restart
//     intervals) written to give what libjpeg(-turbo) gives with its
//     defaults, and so PIL: the `islow` integer IDCT (jidctint.c), "fancy"
//     triangle upsampling (jdsample.c h2v1/h2v2_fancy_upsample) and the
//     fixed-point YCbCr->RGB tables of jdcolor.c.  Progressive, lossless,
//     arithmetic-coded, 12-bit and CMYK files are refused with an error;
//   * `zr_resize`: PIL's Image.resize for uint8 images (Resample.c for
//     LANCZOS and BILINEAR: 22-bit coefficients, the horizontal pass first;
//     Geometry.c's affine scale for NEAREST), coefficients cached per size.
//
// Errors return a non-zero code; `zr_last_error` gives the calling
// thread's message.
//
// Build: g++ -O3 -shared -fPIC -o libzipreader.so zipreader.cpp -lz

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <exception>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <tuple>
#include <vector>
#include <zlib.h>

namespace {

thread_local std::string g_err;

int fail(int code, const std::string& msg) {
  g_err = msg;
  return code;
}

uint16_t rd16(const uint8_t* p) { return (uint16_t)(p[0] | (p[1] << 8)); }
uint32_t rd32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}
uint32_t be32(const uint8_t* p) {
  return ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) | ((uint32_t)p[2] << 8) | p[3];
}

// ---------------------------------------------------------------- zip

struct Entry {
  std::string name;
  uint64_t offset;  // local header offset
  uint32_t comp_size;
  uint32_t uncomp_size;
  uint16_t method;  // 0 = stored, 8 = deflate
};

struct Archive {
  FILE* f = nullptr;
  std::mutex mu;  // guards the FILE*'s position
  std::vector<Entry> entries;
};

bool parse_central_directory(Archive* ar) {
  // the end-of-central-directory record lies in the last 64 KB + 22 bytes
  if (fseek(ar->f, 0, SEEK_END) != 0) return false;
  long fsize = ftell(ar->f);
  long scan = fsize < 65557 ? fsize : 65557;
  std::vector<uint8_t> tail(scan);
  if (fseek(ar->f, fsize - scan, SEEK_SET) != 0) return false;
  if ((long)fread(tail.data(), 1, scan, ar->f) != scan) return false;
  long eocd = -1;
  for (long i = scan - 22; i >= 0; --i) {
    if (tail[i] == 0x50 && tail[i + 1] == 0x4b && tail[i + 2] == 0x05 && tail[i + 3] == 0x06) {
      eocd = i;
      break;
    }
  }
  if (eocd < 0) return false;
  uint16_t n_entries = rd16(&tail[eocd + 10]);
  uint32_t cd_size = rd32(&tail[eocd + 12]);
  uint32_t cd_offset = rd32(&tail[eocd + 16]);
  std::vector<uint8_t> cd(cd_size);
  if (fseek(ar->f, cd_offset, SEEK_SET) != 0) return false;
  if (fread(cd.data(), 1, cd_size, ar->f) != cd_size) return false;
  size_t pos = 0;
  for (int i = 0; i < n_entries; ++i) {
    if (pos + 46 > cd_size) return false;
    const uint8_t* h = &cd[pos];
    if (rd32(h) != 0x02014b50) return false;
    Entry e;
    e.method = rd16(h + 10);
    e.comp_size = rd32(h + 20);
    e.uncomp_size = rd32(h + 24);
    uint16_t name_len = rd16(h + 28);
    uint16_t extra_len = rd16(h + 30);
    uint16_t comment_len = rd16(h + 32);
    if (pos + 46 + name_len > cd_size) return false;
    e.offset = rd32(h + 42);
    e.name.assign((const char*)(h + 46), name_len);
    ar->entries.push_back(std::move(e));
    pos += 46 + name_len + extra_len + comment_len;
  }
  return true;
}

// Read and inflate one entry; only the seek and read hold the archive's lock.
int read_entry(Archive* ar, const Entry& e, std::vector<uint8_t>* out) {
  std::vector<uint8_t> comp(e.comp_size);
  {
    std::lock_guard<std::mutex> lock(ar->mu);
    uint8_t lh[30];  // local header: 30 bytes + name + extra (may differ from the CD's)
    if (fseek(ar->f, (long)e.offset, SEEK_SET) != 0 || fread(lh, 1, 30, ar->f) != 30 ||
        rd32(lh) != 0x04034b50)
      return fail(2, e.name + ": bad local header");
    if (fseek(ar->f, rd16(lh + 26) + rd16(lh + 28), SEEK_CUR) != 0 ||
        fread(comp.data(), 1, e.comp_size, ar->f) != e.comp_size)
      return fail(2, e.name + ": short read");
  }
  out->resize(e.uncomp_size);
  if (e.method == 0) {
    if (e.comp_size != e.uncomp_size) return fail(2, e.name + ": stored sizes differ");
    memcpy(out->data(), comp.data(), e.comp_size);
    return 0;
  }
  if (e.method != 8) return fail(2, e.name + ": compression method " + std::to_string(e.method));
  z_stream zs;
  memset(&zs, 0, sizeof(zs));
  if (inflateInit2(&zs, -15) != Z_OK) return fail(2, "inflateInit2 failed");  // raw deflate
  zs.next_in = comp.data();
  zs.avail_in = e.comp_size;
  zs.next_out = out->data();
  zs.avail_out = e.uncomp_size;
  int rc = inflate(&zs, Z_FINISH);
  inflateEnd(&zs);
  if (!(rc == Z_STREAM_END || (rc == Z_OK && zs.avail_out == 0)))
    return fail(2, e.name + ": inflate failed");
  return 0;
}

// ---------------------------------------------------------------- PNG

int paeth(int a, int b, int c) {
  int p = a + b - c;
  int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

// 8-bit PNG -> RGB8 (grey repeated, alpha dropped, palette looked up).
// With rgb == nullptr only the header is read.
int decode_png(const uint8_t* data, size_t size, uint8_t* rgb, uint32_t* out_w, uint32_t* out_h) {
  uint32_t w = 0, h = 0;
  int bit_depth = 0, color_type = -1, interlace = 0;
  std::vector<uint8_t> idat, palette;
  size_t pos = 8;
  while (pos + 8 <= size) {
    uint32_t len = be32(&data[pos]);
    const char* type = (const char*)&data[pos + 4];
    const uint8_t* body = &data[pos + 8];
    if (pos + 12 + (size_t)len > size) return fail(12, "PNG: truncated chunk");
    if (memcmp(type, "IHDR", 4) == 0) {
      if (len < 13) return fail(12, "PNG: short IHDR");
      w = be32(body);
      h = be32(body + 4);
      bit_depth = body[8];
      color_type = body[9];
      interlace = body[12];
      if (!rgb) break;
    } else if (memcmp(type, "PLTE", 4) == 0) {
      palette.assign(body, body + len);
    } else if (memcmp(type, "IDAT", 4) == 0) {
      idat.insert(idat.end(), body, body + len);
    } else if (memcmp(type, "IEND", 4) == 0) {
      break;
    }
    pos += 12 + len;
  }
  int channels = 0;
  switch (color_type) {
    case 0: channels = 1; break;  // grey
    case 2: channels = 3; break;  // RGB
    case 3: channels = 1; break;  // palette index
    case 4: channels = 2; break;  // grey + alpha
    case 6: channels = 4; break;  // RGBA
  }
  if (w == 0 || h == 0 || bit_depth != 8 || interlace != 0 || channels == 0)
    return fail(13, "PNG: only 8-bit non-interlaced grey, RGB, palette, grey+alpha or RGBA "
                    "is supported (bit depth " + std::to_string(bit_depth) + ", colour type " +
                    std::to_string(color_type) + ", interlace " + std::to_string(interlace) + ")");
  *out_w = w;
  *out_h = h;
  if (!rgb) return 0;

  size_t stride = (size_t)w * channels;
  std::vector<uint8_t> raw((stride + 1) * h);
  z_stream zs;
  memset(&zs, 0, sizeof(zs));
  if (inflateInit(&zs) != Z_OK) return fail(15, "PNG: inflateInit failed");
  zs.next_in = idat.data();
  zs.avail_in = (uInt)idat.size();
  zs.next_out = raw.data();
  zs.avail_out = (uInt)raw.size();
  int rc = inflate(&zs, Z_FINISH);
  inflateEnd(&zs);
  if (!(rc == Z_STREAM_END || (rc == Z_OK && zs.avail_out == 0)))
    return fail(16, "PNG: image data does not inflate");

  std::vector<uint8_t> img(stride * h);
  const size_t bpp = channels;
  std::vector<uint8_t> zero(stride, 0);
  for (uint32_t y = 0; y < h; ++y) {
    uint8_t filter = raw[y * (stride + 1)];
    const uint8_t* src = &raw[y * (stride + 1) + 1];
    uint8_t* dst = &img[y * stride];
    const uint8_t* up = y > 0 ? &img[(y - 1) * stride] : zero.data();
    switch (filter) {
      case 0: memcpy(dst, src, stride); break;
      case 1:
        for (size_t x = 0; x < stride; ++x) dst[x] = src[x] + (x >= bpp ? dst[x - bpp] : 0);
        break;
      case 2:
        for (size_t x = 0; x < stride; ++x) dst[x] = src[x] + up[x];
        break;
      case 3:
        for (size_t x = 0; x < stride; ++x)
          dst[x] = src[x] + (((x >= bpp ? dst[x - bpp] : 0) + up[x]) >> 1);
        break;
      case 4:
        for (size_t x = 0; x < bpp; ++x) dst[x] = src[x] + up[x];
        for (size_t x = bpp; x < stride; ++x)
          dst[x] = src[x] + paeth(dst[x - bpp], up[x], up[x - bpp]);
        break;
      default: return fail(17, "PNG: unknown filter type " + std::to_string(filter));
    }
  }

  uint8_t* o = rgb;
  const uint8_t* p = img.data();
  size_t n = (size_t)w * h;
  switch (color_type) {
    case 0:
      for (size_t i = 0; i < n; ++i) o[3 * i] = o[3 * i + 1] = o[3 * i + 2] = p[i];
      break;
    case 2: memcpy(o, p, n * 3); break;
    case 3:
      for (size_t i = 0; i < n; ++i) {
        size_t idx = (size_t)p[i] * 3;
        if (idx + 2 >= palette.size()) return fail(18, "PNG: palette index out of range");
        memcpy(o + 3 * i, &palette[idx], 3);
      }
      break;
    case 4:
      for (size_t i = 0; i < n; ++i) o[3 * i] = o[3 * i + 1] = o[3 * i + 2] = p[2 * i];
      break;
    case 6:
      for (size_t i = 0; i < n; ++i) memcpy(o + 3 * i, p + 4 * i, 3);
      break;
  }
  return 0;
}

// ---------------------------------------------------------------- JPEG

// zigzag -> natural order, with libjpeg's 16 guard entries for corrupt runs
const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54,
    47, 55, 62, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

const int kLookBits = 9;

struct Huffman {
  bool present = false;
  uint8_t vals[256];
  int32_t maxcode[18];
  int32_t valoffset[17];
  uint8_t look_len[1 << kLookBits];  // 0: code longer than kLookBits
  uint8_t look_val[1 << kLookBits];
};

// jdhuff.c jpeg_make_d_derived_tbl
bool build_huffman(Huffman* t, const uint8_t* bits /* [1..16] */, const uint8_t* vals, int nvals) {
  uint8_t size[257];
  uint32_t code_of[257];
  int p = 0;
  for (int l = 1; l <= 16; ++l)
    for (int i = 0; i < bits[l]; ++i) {
      if (p >= 256) return false;
      size[p++] = (uint8_t)l;
    }
  size[p] = 0;
  if (p != nvals) return false;
  uint32_t code = 0;
  int si = size[0];
  p = 0;
  while (size[p]) {
    while (size[p] == si) code_of[p++] = code++;
    if (code >= (1u << si)) return false;
    code <<= 1;
    si++;
  }
  p = 0;
  for (int l = 1; l <= 16; ++l) {
    if (bits[l]) {
      t->valoffset[l] = p - (int32_t)code_of[p];
      p += bits[l];
      t->maxcode[l] = (int32_t)code_of[p - 1];
    } else {
      t->maxcode[l] = -1;
    }
  }
  t->maxcode[17] = 0xFFFFF;
  memcpy(t->vals, vals, nvals);
  memset(t->look_len, 0, sizeof(t->look_len));
  p = 0;
  for (int l = 1; l <= kLookBits; ++l)
    for (int i = 0; i < bits[l]; ++i, ++p) {
      int base = code_of[p] << (kLookBits - l);
      for (int j = 0; j < (1 << (kLookBits - l)); ++j) {
        t->look_len[base + j] = (uint8_t)l;
        t->look_val[base + j] = vals[p];
      }
    }
  t->present = true;
  return true;
}

// Entropy-coded bytes: 0xFF00 is a stuffed 0xFF; at a marker the reader
// stops and feeds zeros, as libjpeg does on "insufficient data".
struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t buf = 0;
  int bits = 0;
  bool at_marker = false;
  long past_end = 0;  // zero bytes fed after the data ran out (not at a marker)

  void fill() {
    while (bits <= 56) {
      uint32_t byte = 0;
      if (!at_marker && p >= end) past_end++;
      if (!at_marker && p < end) {
        if (*p == 0xFF) {
          if (p + 1 < end && p[1] == 0x00) {
            byte = 0xFF;
            p += 2;
          } else {
            at_marker = true;
          }
        } else {
          byte = *p++;
        }
      }
      buf |= (uint64_t)byte << (56 - bits);
      bits += 8;
    }
  }
  uint32_t peek(int n) {
    if (bits < n) fill();
    return (uint32_t)(buf >> (64 - n));
  }
  void skip(int n) {
    buf <<= n;
    bits -= n;
  }
  uint32_t get(int n) {
    if (n == 0) return 0;
    uint32_t v = peek(n);
    skip(n);
    return v;
  }
  // jdhuff.c jpeg_huff_decode; a code longer than 16 bits decodes as 0
  int decode(const Huffman& t) {
    uint32_t look = peek(kLookBits);
    int len = t.look_len[look];
    if (len) {
      skip(len);
      return t.look_val[look];
    }
    int l = kLookBits + 1;
    int32_t code = (int32_t)get(l);
    while (l <= 16 && code > t.maxcode[l]) {
      code = (code << 1) | (int32_t)get(1);
      l++;
    }
    if (l > 16) return 0;
    return t.vals[(code + t.valoffset[l]) & 0xFF];
  }
  // drop the buffered bits and step over the next RSTn marker
  void restart() {
    buf = 0;
    bits = 0;
    while (p + 1 < end && !(p[0] == 0xFF && p[1] >= 0xD0 && p[1] <= 0xD7)) p++;
    if (p + 1 < end) p += 2;
    at_marker = false;
  }
};

inline int extend(int v, int s) { return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v; }

// the post-IDCT range limit of jdmaster.c, indexed by x & 1023 (x before the +128 shift)
struct RangeLimit {
  uint8_t t[1024];
  RangeLimit() {
    for (int i = 0; i < 1024; ++i)
      t[i] = i < 128 ? i + 128 : i < 512 ? 255 : i < 896 ? 0 : i - 896;
  }
};
const RangeLimit kRange;

// jidctint.c jpeg_idct_islow: CONST_BITS 13, PASS1_BITS 2
void idct_islow(const int16_t* coef, const uint16_t* q, uint8_t* out, int stride) {
  const int64_t F0_298 = 2446, F0_390 = 3196, F0_541 = 4433, F0_765 = 6270, F0_899 = 7373,
                F1_175 = 9633, F1_501 = 12299, F1_847 = 15137, F1_961 = 16069,
                F2_053 = 16819, F2_562 = 20995, F3_072 = 25172;
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* in = coef + c;
    const uint16_t* qt = q + c;
    if (!(in[8] | in[16] | in[24] | in[32] | in[40] | in[48] | in[56])) {
      int dc = (in[0] * (int)qt[0]) * 4;
      for (int r = 0; r < 8; ++r) ws[r * 8 + c] = dc;
      continue;
    }
    int64_t z2 = in[16] * (int)qt[16], z3 = in[48] * (int)qt[48];
    int64_t z1 = (z2 + z3) * F0_541;
    int64_t tmp2 = z1 + z3 * -F1_847;
    int64_t tmp3 = z1 + z2 * F0_765;
    z2 = in[0] * (int)qt[0];
    z3 = in[32] * (int)qt[32];
    int64_t tmp0 = (z2 + z3) * 8192;
    int64_t tmp1 = (z2 - z3) * 8192;
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = in[56] * (int)qt[56];
    tmp1 = in[40] * (int)qt[40];
    tmp2 = in[24] * (int)qt[24];
    tmp3 = in[8] * (int)qt[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * F1_175;
    tmp0 *= F0_298;
    tmp1 *= F2_053;
    tmp2 *= F3_072;
    tmp3 *= F1_501;
    z1 *= -F0_899;
    z2 *= -F2_562;
    z3 *= -F1_961;
    z4 *= -F0_390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int sh = 11, rnd = 1 << 10;
    ws[0 * 8 + c] = (int)((tmp10 + tmp3 + rnd) >> sh);
    ws[7 * 8 + c] = (int)((tmp10 - tmp3 + rnd) >> sh);
    ws[1 * 8 + c] = (int)((tmp11 + tmp2 + rnd) >> sh);
    ws[6 * 8 + c] = (int)((tmp11 - tmp2 + rnd) >> sh);
    ws[2 * 8 + c] = (int)((tmp12 + tmp1 + rnd) >> sh);
    ws[5 * 8 + c] = (int)((tmp12 - tmp1 + rnd) >> sh);
    ws[3 * 8 + c] = (int)((tmp13 + tmp0 + rnd) >> sh);
    ws[4 * 8 + c] = (int)((tmp13 - tmp0 + rnd) >> sh);
  }
  for (int r = 0; r < 8; ++r) {
    const int* w = ws + r * 8;
    uint8_t* o = out + r * stride;
    const int sh = 18;
    const int64_t rnd = (int64_t)1 << 17;
    if (!(w[1] | w[2] | w[3] | w[4] | w[5] | w[6] | w[7])) {
      uint8_t v = kRange.t[(int)(((int64_t)w[0] + 16) >> 5) & 1023];
      memset(o, v, 8);
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * F0_541;
    int64_t tmp2 = z1 + z3 * -F1_847;
    int64_t tmp3 = z1 + z2 * F0_765;
    int64_t tmp0 = ((int64_t)w[0] + w[4]) * 8192;
    int64_t tmp1 = ((int64_t)w[0] - w[4]) * 8192;
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * F1_175;
    tmp0 *= F0_298;
    tmp1 *= F2_053;
    tmp2 *= F3_072;
    tmp3 *= F1_501;
    z1 *= -F0_899;
    z2 *= -F2_562;
    z3 *= -F1_961;
    z4 *= -F0_390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    o[0] = kRange.t[(int)((tmp10 + tmp3 + rnd) >> sh) & 1023];
    o[7] = kRange.t[(int)((tmp10 - tmp3 + rnd) >> sh) & 1023];
    o[1] = kRange.t[(int)((tmp11 + tmp2 + rnd) >> sh) & 1023];
    o[6] = kRange.t[(int)((tmp11 - tmp2 + rnd) >> sh) & 1023];
    o[2] = kRange.t[(int)((tmp12 + tmp1 + rnd) >> sh) & 1023];
    o[5] = kRange.t[(int)((tmp12 - tmp1 + rnd) >> sh) & 1023];
    o[3] = kRange.t[(int)((tmp13 + tmp0 + rnd) >> sh) & 1023];
    o[4] = kRange.t[(int)((tmp13 - tmp0 + rnd) >> sh) & 1023];
  }
}

// jdcolor.c build_ycc_rgb_table: SCALEBITS 16
struct YccTables {
  int cr_r[256], cb_b[256];
  int64_t cr_g[256], cb_g[256];
  YccTables() {
    const int64_t half = (int64_t)1 << 15;
    auto fix = [](double x) { return (int64_t)(x * 65536.0 + 0.5); };
    for (int i = 0, x = -128; i < 256; ++i, ++x) {
      cr_r[i] = (int)((fix(1.40200) * x + half) >> 16);
      cb_b[i] = (int)((fix(1.77200) * x + half) >> 16);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + half;
    }
  }
};
const YccTables kYcc;

inline uint8_t clamp255(int v) { return v < 0 ? 0 : v > 255 ? 255 : (uint8_t)v; }

struct Component {
  int id = 0, h = 1, v = 1, tq = 0, td = 0, ta = 0;
  int cw = 0, ch = 0;  // downsampled width and height
  int stride = 0, rows = 0;
  bool decoded = false;
  std::vector<uint8_t> plane;
};

struct Jpeg {
  int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  int restart = 0;
  bool frame = false, jfif = false, adobe = false;
  int adobe_transform = -1;
  Component comp[3];
  uint16_t qt[4][64];
  bool qt_set[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
};

const char* sof_name(int m) {
  switch (m) {
    case 0xC2: return "SOF2, progressive";
    case 0xC3: return "SOF3, lossless";
    case 0xC5: return "SOF5, differential sequential";
    case 0xC6: return "SOF6, differential progressive";
    case 0xC7: return "SOF7, differential lossless";
    case 0xC9: return "SOF9, arithmetic sequential";
    case 0xCA: return "SOF10, arithmetic progressive";
    case 0xCB: return "SOF11, arithmetic lossless";
    case 0xCD: return "SOF13, arithmetic differential sequential";
    case 0xCE: return "SOF14, arithmetic differential progressive";
    case 0xCF: return "SOF15, arithmetic differential lossless";
  }
  return "unknown SOF";
}

int parse_sof(Jpeg* j, int marker, const uint8_t* s, int len) {
  if (j->frame) return fail(31, "JPEG: a second frame header");
  if (len < 6) return fail(31, "JPEG: short frame header");
  int precision = s[0];
  j->height = (s[1] << 8) | s[2];
  j->width = (s[3] << 8) | s[4];
  j->ncomp = s[5];
  const char* kind = marker == 0xC0 ? "SOF0" : "SOF1";
  if (precision != 8)
    return fail(32, std::string("JPEG: ") + std::to_string(precision) + "-bit samples (" + kind +
                        ") are not supported, only 8-bit");
  if (j->ncomp != 1 && j->ncomp != 3)
    return fail(33, std::string("JPEG: ") + std::to_string(j->ncomp) + " components (" + kind +
                        (j->ncomp == 4 ? ", CMYK/YCCK" : "") +
                        ") are not supported, only grey or YCbCr/RGB");
  if (j->width == 0 || j->height == 0)
    return fail(34, "JPEG: zero width or height (a DNL marker is not supported)");
  if (len < 6 + 3 * j->ncomp) return fail(31, "JPEG: short frame header");
  for (int i = 0; i < j->ncomp; ++i) {
    Component& c = j->comp[i];
    c.id = s[6 + 3 * i];
    c.h = s[7 + 3 * i] >> 4;
    c.v = s[7 + 3 * i] & 15;
    c.tq = s[8 + 3 * i] & 3;
    if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4) return fail(35, "JPEG: bad sampling factor");
    if (j->ncomp == 1) c.h = c.v = 1;  // one component: its factors do not matter
    j->hmax = std::max(j->hmax, c.h);
    j->vmax = std::max(j->vmax, c.v);
  }
  for (int i = 0; i < j->ncomp; ++i) {
    Component& c = j->comp[i];
    int rh = j->hmax / c.h, rv = j->vmax / c.v;
    bool ok = j->hmax % c.h == 0 && j->vmax % c.v == 0 &&
              ((rh == 1 && rv == 1) || (rh == 2 && rv == 1) || (rh == 2 && rv == 2));
    if (!ok) {
      std::string samp;
      for (int k = 0; k < j->ncomp; ++k)
        samp += (k ? "," : "") + std::to_string(j->comp[k].h) + "x" + std::to_string(j->comp[k].v);
      return fail(36, "JPEG: sampling " + samp +
                          " is not supported, only 4:4:4, 4:2:2 and 4:2:0");
    }
  }
  j->mcux = (j->width + 8 * j->hmax - 1) / (8 * j->hmax);
  j->mcuy = (j->height + 8 * j->vmax - 1) / (8 * j->vmax);
  for (int i = 0; i < j->ncomp; ++i) {
    Component& c = j->comp[i];
    c.cw = (j->width * c.h + j->hmax - 1) / j->hmax;
    c.ch = (j->height * c.v + j->vmax - 1) / j->vmax;
    c.stride = j->mcux * c.h * 8;
    c.rows = j->mcuy * c.v * 8;
  }
  j->frame = true;
  return 0;
}

int parse_dht(Jpeg* j, const uint8_t* s, int len) {
  int pos = 0;
  while (pos < len) {
    if (pos + 17 > len) return fail(37, "JPEG: short DHT");
    int tc = s[pos] >> 4, th = s[pos] & 15;
    uint8_t bits[17];
    int n = 0;
    for (int l = 1; l <= 16; ++l) n += bits[l] = s[pos + l];
    if (tc > 1 || th > 3 || n > 256 || pos + 17 + n > len) return fail(37, "JPEG: bad DHT");
    Huffman* t = tc == 0 ? &j->dc[th] : &j->ac[th];
    if (!build_huffman(t, bits, s + pos + 17, n)) return fail(37, "JPEG: bad Huffman table");
    pos += 17 + n;
  }
  return 0;
}

int parse_dqt(Jpeg* j, const uint8_t* s, int len) {
  int pos = 0;
  while (pos < len) {
    int pq = s[pos] >> 4, tq = s[pos] & 15;
    int need = 1 + 64 * (pq ? 2 : 1);
    if (tq > 3 || pq > 1 || pos + need > len) return fail(38, "JPEG: bad DQT");
    for (int k = 0; k < 64; ++k)
      j->qt[tq][kNatural[k]] =
          pq ? (uint16_t)((s[pos + 1 + 2 * k] << 8) | s[pos + 2 + 2 * k]) : s[pos + 1 + k];
    j->qt_set[tq] = true;
    pos += need;
  }
  return 0;
}

// jdhuff.c decode_mcu for one block: coefficients in natural order
inline void decode_block(BitReader& br, const Huffman& dct, const Huffman& act, int* pred,
                         int16_t* blk) {
  memset(blk, 0, 64 * sizeof(int16_t));
  int s = br.decode(dct);
  int diff = s ? extend((int)br.get(s), s) : 0;
  *pred += diff;
  blk[0] = (int16_t)*pred;
  for (int k = 1; k < 64; ++k) {
    int rs = br.decode(act);
    int r = rs >> 4;
    s = rs & 15;
    if (s) {
      k += r;
      blk[kNatural[k]] = (int16_t)extend((int)br.get(s), s);
    } else {
      if (r != 15) break;
      k += 15;
    }
  }
}

int decode_scan(Jpeg* j, const uint8_t* s, int len, const uint8_t** p, const uint8_t* end) {
  if (!j->frame) return fail(39, "JPEG: scan before the frame header");
  int ns = len > 0 ? s[0] : 0;
  if (ns < 1 || ns > j->ncomp || len < 4 + 2 * ns) return fail(39, "JPEG: bad scan header");
  int sc[3];
  for (int i = 0; i < ns; ++i) {
    int cid = s[1 + 2 * i], k = 0;
    while (k < j->ncomp && j->comp[k].id != cid) k++;
    if (k == j->ncomp) return fail(39, "JPEG: scan names an unknown component");
    Component& c = j->comp[k];
    c.td = s[2 + 2 * i] >> 4;
    c.ta = s[2 + 2 * i] & 15;
    if (c.td > 3 || c.ta > 3 || !j->dc[c.td].present || !j->ac[c.ta].present)
      return fail(39, "JPEG: scan uses a missing Huffman table");
    if (!j->qt_set[c.tq]) return fail(39, "JPEG: component uses a missing quantization table");
    if (c.plane.empty()) c.plane.assign((size_t)c.stride * c.rows, 0);
    c.decoded = true;
    sc[i] = k;
  }
  int ss = s[1 + 2 * ns], se = s[2 + 2 * ns], ahal = s[3 + 2 * ns];
  if (ss != 0 || se != 63 || ahal != 0) return fail(39, "JPEG: not a sequential scan");
  int mx_n, my_n;
  if (ns == 1) {  // non-interleaved: one block an MCU, over the component's own extent
    const Component& c = j->comp[sc[0]];
    mx_n = (c.cw + 7) / 8;
    my_n = (c.ch + 7) / 8;
  } else {
    mx_n = j->mcux;
    my_n = j->mcuy;
  }
  BitReader br{*p, end};
  int pred[3] = {0, 0, 0};
  alignas(16) int16_t blk[64];
  long total = (long)mx_n * my_n;
  for (long m = 0; m < total; ++m) {
    if (j->restart && m > 0 && m % j->restart == 0) {
      br.restart();
      pred[0] = pred[1] = pred[2] = 0;
    }
    int mx = (int)(m % mx_n), my = (int)(m / mx_n);
    for (int i = 0; i < ns; ++i) {
      Component& c = j->comp[sc[i]];
      int bh = ns == 1 ? 1 : c.h, bv = ns == 1 ? 1 : c.v;
      for (int by = 0; by < bv; ++by)
        for (int bx = 0; bx < bh; ++bx) {
          decode_block(br, j->dc[c.td], j->ac[c.ta], &pred[i], blk);
          int row = (my * bv + by) * 8, col = (mx * bh + bx) * 8;
          idct_islow(blk, j->qt[c.tq], &c.plane[(size_t)row * c.stride + col], c.stride);
        }
    }
  }
  if (br.past_end * 8 > br.bits) return fail(43, "JPEG: the file is truncated");
  *p = br.p;
  return 0;
}

// One output row of a component at full resolution (jdsample.c, fancy).
void upsample_row(const Jpeg& j, const Component& c, int y, int* tmp, uint8_t* out) {
  int rh = j.hmax / c.h, rv = j.vmax / c.v;
  int w = c.cw;
  if (rh == 1) {
    memcpy(out, &c.plane[(size_t)y * c.stride], j.width);
    return;
  }
  if (w <= 2) {  // libjpeg uses box replication for such narrow components
    const uint8_t* in = &c.plane[(size_t)(y / rv) * c.stride];
    for (int x = 0; x < j.width; ++x) out[x] = in[x / 2];
    return;
  }
  if (rv == 1) {  // h2v1_fancy_upsample
    const uint8_t* in = &c.plane[(size_t)y * c.stride];
    for (int i = 0; i < w; ++i) {
      int a = in[i] * 3, l = in[i > 0 ? i - 1 : 0], r = in[i < w - 1 ? i + 1 : w - 1];
      if (2 * i < j.width) out[2 * i] = (uint8_t)((a + l + 1) >> 2);
      if (2 * i + 1 < j.width) out[2 * i + 1] = (uint8_t)((a + r + 2) >> 2);
    }
    return;
  }
  // h2v2_fancy_upsample: the nearer row times 3 plus the further one, per column;
  // rows and columns beyond the component's extent repeat its edge
  int r0 = y / 2, r1 = (y & 1) ? std::min(r0 + 1, c.ch - 1) : std::max(r0 - 1, 0);
  const uint8_t* in0 = &c.plane[(size_t)r0 * c.stride];
  const uint8_t* in1 = &c.plane[(size_t)r1 * c.stride];
  for (int i = 0; i < w; ++i) tmp[i] = in0[i] * 3 + in1[i];
  for (int i = 0; i < w; ++i) {
    int a = tmp[i] * 3, l = tmp[i > 0 ? i - 1 : 0], r = tmp[i < w - 1 ? i + 1 : w - 1];
    if (2 * i < j.width) out[2 * i] = (uint8_t)((a + l + 8) >> 4);
    if (2 * i + 1 < j.width) out[2 * i + 1] = (uint8_t)((a + r + 7) >> 4);
  }
}

int decode_jpeg(const uint8_t* data, size_t size, uint8_t* rgb, uint32_t* out_w,
                uint32_t* out_h) {
  std::unique_ptr<Jpeg> jp(new Jpeg());
  Jpeg* j = jp.get();
  const uint8_t* p = data + 2;
  const uint8_t* end = data + size;
  bool eoi = false;
  while (p < end && !eoi) {
    if (*p != 0xFF) {  // stray bytes between segments
      p++;
      continue;
    }
    while (p < end && *p == 0xFF) p++;
    if (p >= end) break;
    int m = *p++;
    if (m == 0xD9) {
      eoi = true;
      break;
    }
    // a stuffed 0xFF00 left over from a scan, and the markers without a length
    if (m == 0x00 || m == 0x01 || (m >= 0xD0 && m <= 0xD8)) continue;
    if (p + 2 > end) return fail(30, "JPEG: truncated marker segment");
    int len = (p[0] << 8) | p[1];
    if (len < 2 || p + len > end) return fail(30, "JPEG: truncated marker segment");
    const uint8_t* s = p + 2;
    int slen = len - 2;
    p += len;
    int rc = 0;
    switch (m) {
      case 0xC0:
      case 0xC1:
        rc = parse_sof(j, m, s, slen);
        if (rc == 0 && !rgb) {
          *out_w = j->width;
          *out_h = j->height;
          return 0;
        }
        break;
      case 0xC2: case 0xC3: case 0xC5: case 0xC6: case 0xC7: case 0xC9: case 0xCA:
      case 0xCB: case 0xCD: case 0xCE: case 0xCF: {
        char hex[8];
        snprintf(hex, sizeof(hex), "%02X", m);
        return fail(40, std::string("JPEG: ") + sof_name(m) + " (marker FF" + hex +
                            ") is not supported, only baseline and extended sequential "
                            "Huffman (SOF0, SOF1)");
      }
      case 0xC4: rc = parse_dht(j, s, slen); break;
      case 0xDB: rc = parse_dqt(j, s, slen); break;
      case 0xDD:
        if (slen < 2) return fail(30, "JPEG: short DRI");
        j->restart = (s[0] << 8) | s[1];
        break;
      case 0xDA:
        if (!rgb) return fail(39, "JPEG: scan before the frame header");
        rc = decode_scan(j, s, slen, &p, end);
        break;
      case 0xE0:
        if (slen >= 5 && memcmp(s, "JFIF\0", 5) == 0) j->jfif = true;
        break;
      case 0xEE:
        if (slen >= 12 && memcmp(s, "Adobe", 5) == 0) {
          j->adobe = true;
          j->adobe_transform = s[11];
        }
        break;
      default: break;  // APPn, COM, DAC and others: skipped
    }
    if (rc) return rc;
  }
  if (!j->frame) return fail(41, "JPEG: no frame header (SOF0/SOF1)");
  *out_w = j->width;
  *out_h = j->height;
  if (!rgb) return 0;
  for (int i = 0; i < j->ncomp; ++i)
    if (!j->comp[i].decoded) return fail(42, "JPEG: a component has no scan");

  // jdapimin.c default_decompress_parms: which colour space three components hold
  bool ycc = true;
  if (j->ncomp == 3) {
    if (j->jfif) ycc = true;
    else if (j->adobe) ycc = j->adobe_transform != 0;
    else ycc = !(j->comp[0].id == 82 && j->comp[1].id == 71 && j->comp[2].id == 66);
  }
  const int W = j->width;
  std::vector<uint8_t> rows((size_t)3 * W + 2);
  std::vector<int> tmp(W + 2);
  for (int y = 0; y < j->height; ++y) {
    uint8_t* o = rgb + (size_t)y * W * 3;
    if (j->ncomp == 1) {
      const uint8_t* g = &j->comp[0].plane[(size_t)y * j->comp[0].stride];
      for (int x = 0; x < W; ++x) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = g[x];
      continue;
    }
    uint8_t* r[3] = {rows.data(), rows.data() + W, rows.data() + 2 * W};
    for (int i = 0; i < 3; ++i) upsample_row(*j, j->comp[i], y, tmp.data(), r[i]);
    if (!ycc) {
      for (int x = 0; x < W; ++x) {
        o[3 * x] = r[0][x];
        o[3 * x + 1] = r[1][x];
        o[3 * x + 2] = r[2][x];
      }
      continue;
    }
    for (int x = 0; x < W; ++x) {  // jdcolor.c ycc_rgb_convert
      int yy = r[0][x], cb = r[1][x], cr = r[2][x];
      o[3 * x] = clamp255(yy + kYcc.cr_r[cr]);
      o[3 * x + 1] = clamp255(yy + (int)((kYcc.cb_g[cb] + kYcc.cr_g[cr]) >> 16));
      o[3 * x + 2] = clamp255(yy + kYcc.cb_b[cb]);
    }
  }
  return 0;
}

int decode_image(const uint8_t* data, size_t size, uint8_t* rgb, uint32_t* w, uint32_t* h) {
  static const uint8_t png_magic[8] = {137, 80, 78, 71, 13, 10, 26, 10};
  g_err.clear();
  try {
    if (size >= 8 && memcmp(data, png_magic, 8) == 0) return decode_png(data, size, rgb, w, h);
    if (size >= 3 && data[0] == 0xFF && data[1] == 0xD8 && data[2] == 0xFF)
      return decode_jpeg(data, size, rgb, w, h);
  } catch (const std::exception& e) {  // allocation failures on absurd sizes
    return fail(3, std::string("decode failed: ") + e.what());
  }
  return fail(1, "neither a PNG nor a JPEG file");
}

// ---------------------------------------------------------------- resize

const int kPrecisionBits = 32 - 8 - 2;

double sinc(double x) {
  if (x == 0.0) return 1.0;
  x = x * M_PI;
  return sin(x) / x;
}
double lanczos(double x) { return (-3.0 <= x && x < 3.0) ? sinc(x) * sinc(x / 3) : 0.0; }
double bilinear(double x) {
  if (x < 0.0) x = -x;
  return x < 1.0 ? 1.0 - x : 0.0;
}

struct Coeffs {
  int ksize;
  std::vector<int> xmin, xlen;
  std::vector<int32_t> k;  // out x ksize fixed-point weights
};

// Resample.c precompute_coeffs + normalize_coeffs_8bpc (box = the whole image)
std::shared_ptr<Coeffs> coefficients(int in_size, int out_size, int filter) {
  static std::mutex mu;
  static std::map<std::tuple<int, int, int>, std::shared_ptr<Coeffs>> cache;
  auto key = std::make_tuple(in_size, out_size, filter);
  {
    std::lock_guard<std::mutex> lock(mu);
    auto it = cache.find(key);
    if (it != cache.end()) return it->second;
  }
  double (*fn)(double) = filter == 1 ? lanczos : bilinear;
  double fsupport = filter == 1 ? 3.0 : 1.0;
  double scale = (double)in_size / out_size, filterscale = scale < 1.0 ? 1.0 : scale;
  double support = fsupport * filterscale;
  auto c = std::make_shared<Coeffs>();
  c->ksize = (int)ceil(support) * 2 + 1;
  c->xmin.resize(out_size);
  c->xlen.resize(out_size);
  c->k.assign((size_t)out_size * c->ksize, 0);
  std::vector<double> kk(c->ksize);
  for (int xx = 0; xx < out_size; ++xx) {
    double center = (xx + 0.5) * scale, ww = 0.0, ss = 1.0 / filterscale;
    int xmin = (int)(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = (int)(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    for (int x = 0; x < xmax; ++x) {
      double w = fn((x + xmin - center + 0.5) * ss);
      kk[x] = w;
      ww += w;
    }
    for (int x = 0; x < xmax; ++x) {
      double w = ww != 0.0 ? kk[x] / ww : kk[x];
      c->k[(size_t)xx * c->ksize + x] =
          w < 0 ? (int32_t)(-0.5 + w * (1 << kPrecisionBits))
                : (int32_t)(0.5 + w * (1 << kPrecisionBits));
    }
    c->xmin[xx] = xmin;
    c->xlen[xx] = xmax;
  }
  std::lock_guard<std::mutex> lock(mu);
  return cache.emplace(key, c).first->second;
}

inline uint8_t clip8(int32_t in) {
  int32_t v = in >> kPrecisionBits;
  return v < 0 ? 0 : v > 255 ? 255 : (uint8_t)v;
}

void resample_horizontal(const uint8_t* in, int h, int w, int ch, uint8_t* out, int ow,
                         const Coeffs& c) {
  for (int y = 0; y < h; ++y) {
    const uint8_t* row = in + (size_t)y * w * ch;
    uint8_t* o = out + (size_t)y * ow * ch;
    for (int xx = 0; xx < ow; ++xx) {
      const int32_t* k = &c.k[(size_t)xx * c.ksize];
      const uint8_t* src = row + (size_t)c.xmin[xx] * ch;
      for (int cc = 0; cc < ch; ++cc) {
        int32_t ss = 1 << (kPrecisionBits - 1);
        for (int x = 0; x < c.xlen[xx]; ++x) ss += src[x * ch + cc] * k[x];
        o[xx * ch + cc] = clip8(ss);
      }
    }
  }
}

void resample_vertical(const uint8_t* in, int w, int ch, uint8_t* out, int oh,
                       const Coeffs& c) {
  size_t n = (size_t)w * ch;
  std::vector<int32_t> acc(n);
  for (int yy = 0; yy < oh; ++yy) {
    const int32_t* k = &c.k[(size_t)yy * c.ksize];
    std::fill(acc.begin(), acc.end(), 1 << (kPrecisionBits - 1));
    for (int y = 0; y < c.xlen[yy]; ++y) {
      const uint8_t* row = in + (size_t)(c.xmin[yy] + y) * n;
      int32_t kv = k[y];
      for (size_t i = 0; i < n; ++i) acc[i] += row[i] * kv;
    }
    uint8_t* o = out + (size_t)yy * n;
    for (size_t i = 0; i < n; ++i) o[i] = clip8(acc[i]);
  }
}

// Geometry.c ImagingScaleAffine: positions accumulate in double, as PIL's do
void resize_nearest(const uint8_t* in, int h, int w, int ch, uint8_t* out, int oh, int ow) {
  std::vector<int> xin(ow);
  double a0 = (double)w / ow, a4 = (double)h / oh;
  double xo = a0 * 0.5;
  for (int x = 0; x < ow; ++x) {
    xin[x] = xo < 0.0 ? -1 : (int)xo;
    if (xin[x] >= w) xin[x] = -1;
    xo += a0;
  }
  double yo = a4 * 0.5;
  for (int y = 0; y < oh; ++y) {
    int yi = yo < 0.0 ? -1 : (int)yo;
    uint8_t* o = out + (size_t)y * ow * ch;
    if (yi < 0 || yi >= h) {
      memset(o, 0, (size_t)ow * ch);
    } else {
      const uint8_t* row = in + (size_t)yi * w * ch;
      for (int x = 0; x < ow; ++x) {
        if (xin[x] < 0) memset(o + x * ch, 0, ch);
        else memcpy(o + x * ch, row + (size_t)xin[x] * ch, ch);
      }
    }
    yo += a4;
  }
}

// the two passes of Resample.c (ImagingResample): the horizontal first
void resize_filtered(const uint8_t* in, int h, int w, int ch, uint8_t* out, int oh, int ow,
                     int filter) {
  std::vector<uint8_t> tmp;
  const uint8_t* src = in;
  int cw = w;
  if (ow != w) {
    uint8_t* dst = out;
    if (oh != h) {
      tmp.resize((size_t)h * ow * ch);
      dst = tmp.data();
    }
    resample_horizontal(in, h, w, ch, dst, ow, *coefficients(w, ow, filter));
    src = dst;
    cw = ow;
  }
  if (oh != h) resample_vertical(src, cw, ch, out, oh, *coefficients(h, oh, filter));
}

}  // namespace

extern "C" {

const char* zr_last_error(void) { return g_err.c_str(); }

void* zr_open(const char* path) {
  Archive* ar = new Archive();
  ar->f = fopen(path, "rb");
  bool ok = false;
  try {
    ok = ar->f && parse_central_directory(ar);
  } catch (const std::exception&) {
  }
  if (!ok) {
    if (ar->f) fclose(ar->f);
    delete ar;
    g_err = std::string(path) + ": cannot open as a zip";
    return nullptr;
  }
  return ar;
}

void zr_close(void* h) {
  Archive* ar = (Archive*)h;
  if (ar) {
    if (ar->f) fclose(ar->f);
    delete ar;
  }
}

int64_t zr_count(void* h) { return (int64_t)((Archive*)h)->entries.size(); }

const char* zr_name(void* h, int64_t i) {
  Archive* ar = (Archive*)h;
  if (i < 0 || (size_t)i >= ar->entries.size()) return nullptr;
  return ar->entries[i].name.c_str();
}

// Uncompressed size of entry i, or -1.
int64_t zr_entry_size(void* h, int64_t i) {
  Archive* ar = (Archive*)h;
  if (i < 0 || (size_t)i >= ar->entries.size()) return -1;
  return ar->entries[i].uncomp_size;
}

// Entry i's bytes into buf (zr_entry_size bytes); 0 = ok.
int zr_read_raw(void* h, int64_t i, uint8_t* buf) {
  Archive* ar = (Archive*)h;
  if (i < 0 || (size_t)i >= ar->entries.size()) return fail(1, "entry index out of range");
  try {
    std::vector<uint8_t> out;
    int rc = read_entry(ar, ar->entries[i], &out);
    if (rc) return rc;
    memcpy(buf, out.data(), out.size());
  } catch (const std::exception& e) {
    return fail(2, std::string("read failed: ") + e.what());
  }
  return 0;
}

// Decode PNG or JPEG entry i to RGB8.  query = 1 only fills w and h (from
// the header); otherwise buf holds w * h * 3 bytes.  0 = ok.
int zr_read_image(void* h, int64_t i, uint8_t* buf, uint32_t* w, uint32_t* out_h, int query) {
  Archive* ar = (Archive*)h;
  if (i < 0 || (size_t)i >= ar->entries.size()) return fail(1, "entry index out of range");
  std::vector<uint8_t> raw;
  try {
    int rc = read_entry(ar, ar->entries[i], &raw);
    if (rc) return rc;
  } catch (const std::exception& e) {
    return fail(2, std::string("read failed: ") + e.what());
  }
  return decode_image(raw.data(), raw.size(), query ? nullptr : buf, w, out_h);
}

// The same decode for a PNG or JPEG held in memory.
int zr_decode_image(const uint8_t* data, int64_t size, uint8_t* buf, uint32_t* w,
                    uint32_t* out_h, int query) {
  return decode_image(data, (size_t)size, query ? nullptr : buf, w, out_h);
}

// PIL's Image.resize of an (h, w, ch) uint8 image to (oh, ow, ch).
// filter: 0 NEAREST, 1 LANCZOS, 2 BILINEAR (PIL's numbering).  0 = ok.
int zr_resize(const uint8_t* in, int h, int w, int ch, uint8_t* out, int oh, int ow,
              int filter) {
  g_err.clear();
  if (h <= 0 || w <= 0 || oh <= 0 || ow <= 0 || ch <= 0) return fail(1, "resize: empty size");
  if (filter < 0 || filter > 2) return fail(1, "resize: unknown filter");
  try {
    if (oh == h && ow == w) memcpy(out, in, (size_t)h * w * ch);
    else if (filter == 0) resize_nearest(in, h, w, ch, out, oh, ow);
    else resize_filtered(in, h, w, ch, out, oh, ow, filter);
  } catch (const std::exception& e) {
    return fail(3, std::string("resize failed: ") + e.what());
  }
  return 0;
}

}  // extern "C"

