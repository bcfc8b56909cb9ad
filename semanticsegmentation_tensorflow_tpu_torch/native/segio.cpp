// segio: native host-side image IO for the TPU training/inference pipeline.
//
// The reference's host path decodes/encodes PNGs and resizes on the host
// (SURVEY.md §3.1/§3.2 — its data layer is scipy/PIL on CPU). This is the
// TPU-native rebuild's equivalent of that C-backed host runtime: a small
// C++ library doing
//
//   * PNG decode (libpng, any color type -> RGB8),
//   * PNG encode: "sub" row filter + either (a) a literal-only fixed-Huffman
//     DEFLATE written here (no LZ matching — ~4x faster than zlib level 1 on
//     this 1-core host, ~15-25% larger files; the inference sweep's encoder
//     was 97% of e2e time in round 1, see utils/fastpng.py) or (b) zlib at a
//     chosen level,
//   * resize: bilinear in fixed point (16.16 weights, 32.32 accumulation,
//     round-half-up) bit-matching the numpy oracle in native/__init__.py;
//     nearest bit-matching PIL's NEAREST exactly (double-accumulation index
//     rule, see segio_resize_nearest_u8) so the native GT loader produces
//     identical training batches to the PIL fallback.
//
// Built lazily by native/__init__.py:  g++ -O3 -shared -fPIC segio.cpp -lpng -lz
// All functions return 0 on success, negative on error; no global state.

#ifndef SEGIO_NO_LIBPNG
#include <png.h>
#endif  // SEGIO_NO_LIBPNG
#include <zlib.h>

#include <cstdint>
#include <cstring>
#include <cstdlib>

extern "C" {

int segio_version() { return 1; }

// ---------------------------------------------------------------------------
// PNG decode (libpng). Two-call protocol: probe dims, then decode into a
// caller-allocated h*w*3 buffer. Any color type is normalized to RGB8
// (palette expanded, 16-bit stripped, gray promoted, alpha dropped).
// ---------------------------------------------------------------------------

#ifndef SEGIO_NO_LIBPNG
struct MemReader {
  const uint8_t* data;
  size_t len;
  size_t pos;
  bool failed;
};

static void mem_read(png_structp png, png_bytep out, png_size_t n) {
  MemReader* r = static_cast<MemReader*>(png_get_io_ptr(png));
  if (r->pos + n > r->len) {
    r->failed = true;
    png_error(png, "segio: truncated PNG");
  }
  std::memcpy(out, r->data + r->pos, n);
  r->pos += n;
}

static int decode_common(const uint8_t* data, size_t len, uint8_t* out,
                         int32_t* h, int32_t* w) {
  if (len < 8 || png_sig_cmp(data, 0, 8)) return -1;
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return -2;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return -2;
  }
  MemReader reader = {data, len, 0, false};
  // libpng error handling is longjmp-based; `rows` must be volatile so its
  // post-setjmp value is well-defined in the handler (libpng's documented
  // pattern — a plain local modified after setjmp is indeterminate there).
  png_bytep* volatile rows = nullptr;
  if (setjmp(png_jmpbuf(png))) {
    std::free(rows);
    png_destroy_read_struct(&png, &info, nullptr);
    return -3;
  }
  png_set_read_fn(png, &reader, mem_read);
  png_read_info(png, info);

  png_uint_32 width, height;
  int bit_depth, color_type;
  png_get_IHDR(png, info, &width, &height, &bit_depth, &color_type, nullptr,
               nullptr, nullptr);
  *h = static_cast<int32_t>(height);
  *w = static_cast<int32_t>(width);
  if (out == nullptr) {  // probe-only call
    png_destroy_read_struct(&png, &info, nullptr);
    return 0;
  }

  // Normalize to 8-bit RGB, matching PIL's convert("RGB") pixel values:
  // palette->rgb, gray->rgb, <8bit expanded, 16bit stripped, alpha dropped.
  if (color_type == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color_type == PNG_COLOR_TYPE_GRAY && bit_depth < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (bit_depth == 16) png_set_strip_16(png);
  if (color_type == PNG_COLOR_TYPE_GRAY ||
      color_type == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(png);
  png_set_strip_alpha(png);
  png_set_interlace_handling(png);
  png_read_update_info(png, info);
  if (png_get_rowbytes(png, info) != width * 3) {
    png_destroy_read_struct(&png, &info, nullptr);
    return -4;
  }

  rows = static_cast<png_bytep*>(std::malloc(height * sizeof(png_bytep)));
  if (!rows) {
    png_destroy_read_struct(&png, &info, nullptr);
    return -2;
  }
  for (png_uint_32 y = 0; y < height; ++y) rows[y] = out + y * width * 3;
  png_read_image(png, rows);
  std::free(rows);
  rows = nullptr;
  png_destroy_read_struct(&png, &info, nullptr);
  return 0;
}

int segio_png_info(const uint8_t* data, size_t len, int32_t* h, int32_t* w) {
  return decode_common(data, len, nullptr, h, w);
}

int segio_decode_png(const uint8_t* data, size_t len, uint8_t* out_rgb,
                     int32_t* h, int32_t* w) {
  return decode_common(data, len, out_rgb, h, w);
}
#else  // SEGIO_NO_LIBPNG
// Built without libpng (a host with no png.h): the two decode entries
// return -100, which native/__init__.py reports as "no PNG decode in this
// build"; encode, resize and the overlay LUT need zlib only.
int segio_png_info(const uint8_t*, size_t, int32_t*, int32_t*) {
  return -100;
}

int segio_decode_png(const uint8_t*, size_t, uint8_t*, int32_t*, int32_t*) {
  return -100;
}
#endif  // SEGIO_NO_LIBPNG

// ---------------------------------------------------------------------------
// PNG encode. Row filter: type 1 ("sub") — same choice as utils/fastpng.py,
// where it was validated as the best speed/size point for overlay images.
// ---------------------------------------------------------------------------

static void sub_filter(const uint8_t* rgb, int h, int w, uint8_t* raw) {
  const int stride = w * 3;
  for (int y = 0; y < h; ++y) {
    const uint8_t* src = rgb + static_cast<size_t>(y) * stride;
    uint8_t* dst = raw + static_cast<size_t>(y) * (stride + 1);
    dst[0] = 1;  // sub
    dst[1] = src[0];
    dst[2] = src[1];
    dst[3] = src[2];
    for (int i = 3; i < stride; ++i)
      dst[1 + i] = static_cast<uint8_t>(src[i] - src[i - 3]);
  }
}

// --- literal-only fixed-Huffman DEFLATE (RFC 1951 §3.2.6) -----------------
// One final block, no LZ77 matching: each byte is emitted as its fixed
// literal code (8 bits for 0..143, 9 bits for 144..255). On sub-filtered
// natural images this entropy-codes to ~60-70% of raw at memory speed —
// the match search is what makes zlib slow, not the bit packing.

struct BitWriter {
  uint8_t* out;
  size_t cap;
  size_t pos;
  uint64_t acc;
  int nbits;
  bool overflow;
};

static inline void bw_put(BitWriter* bw, uint32_t bits, int n) {
  bw->acc |= static_cast<uint64_t>(bits) << bw->nbits;
  bw->nbits += n;
  while (bw->nbits >= 8) {
    if (bw->pos >= bw->cap) {
      bw->overflow = true;
      bw->nbits = 0;
      return;
    }
    bw->out[bw->pos++] = static_cast<uint8_t>(bw->acc);
    bw->acc >>= 8;
    bw->nbits -= 8;
  }
}

static inline uint32_t bit_reverse(uint32_t v, int n) {
  uint32_t r = 0;
  for (int i = 0; i < n; ++i) {
    r = (r << 1) | (v & 1);
    v >>= 1;
  }
  return r;
}

int segio_encode_png_fixed(const uint8_t* rgb, int32_t h, int32_t w,
                           uint8_t* out, size_t out_cap, size_t* out_len) {
  if (h <= 0 || w <= 0) return -1;
  const size_t stride = static_cast<size_t>(w) * 3;
  const size_t raw_len = static_cast<size_t>(h) * (stride + 1);
  uint8_t* raw = static_cast<uint8_t*>(std::malloc(raw_len));
  if (!raw) return -2;
  sub_filter(rgb, h, w, raw);

  // Fixed literal codes, pre-reversed for LSB-first packing. Function-local
  // static initialization is thread-safe (C++11 magic statics) — writer
  // threads encode concurrently since the ctypes call releases the GIL.
  struct FixedCodes {
    uint16_t code[256];
    uint8_t len[256];
    FixedCodes() {
      for (int v = 0; v < 144; ++v) {
        code[v] = static_cast<uint16_t>(bit_reverse(0x30 + v, 8));
        len[v] = 8;
      }
      for (int v = 144; v < 256; ++v) {
        code[v] = static_cast<uint16_t>(bit_reverse(0x190 + (v - 144), 9));
        len[v] = 9;
      }
    }
  };
  static const FixedCodes fc;
  const uint16_t* code = fc.code;
  const uint8_t* codelen = fc.len;

  // PNG skeleton around one zlib stream. Chunk layout mirrors fastpng.py.
  // Required capacity: 8 sig + 25 IHDR + (12 + zdata) IDAT + 12 IEND.
  size_t p = 0;
  auto put_be32 = [&](uint32_t v) {
    out[p++] = v >> 24; out[p++] = (v >> 16) & 0xff;
    out[p++] = (v >> 8) & 0xff; out[p++] = v & 0xff;
  };
  const size_t zmax = raw_len + raw_len / 8 + 64;  // 9 bits/byte + headers
  if (out_cap < 8 + 25 + 12 + zmax + 12) {
    std::free(raw);
    return -5;
  }
  static const uint8_t sig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
  std::memcpy(out + p, sig, 8); p += 8;
  // IHDR
  put_be32(13);
  const size_t ihdr_tag = p;
  std::memcpy(out + p, "IHDR", 4); p += 4;
  put_be32(static_cast<uint32_t>(w));
  put_be32(static_cast<uint32_t>(h));
  out[p++] = 8; out[p++] = 2; out[p++] = 0; out[p++] = 0; out[p++] = 0;
  put_be32(static_cast<uint32_t>(
      crc32(0, out + ihdr_tag, static_cast<uInt>(p - ihdr_tag))));
  // IDAT: length backpatched after the bitstream is written.
  const size_t idat_len_at = p; p += 4;
  const size_t idat_tag = p;
  std::memcpy(out + p, "IDAT", 4); p += 4;
  // zlib wrapper: CMF/FLG for 32K window, fastest-flag.
  out[p++] = 0x78; out[p++] = 0x01;

  BitWriter bw = {out + p, zmax, 0, 0, 0, false};
  bw_put(&bw, 1, 1);  // BFINAL
  bw_put(&bw, 1, 2);  // BTYPE=01 fixed Huffman
  for (size_t i = 0; i < raw_len; ++i) {
    const uint8_t b = raw[i];
    bw_put(&bw, code[b], codelen[b]);
  }
  bw_put(&bw, 0, 7);  // end-of-block (code 256 = 0000000)
  if (bw.nbits > 0) bw_put(&bw, 0, 8 - bw.nbits);  // byte-align flush
  if (bw.overflow) {
    std::free(raw);
    return -5;
  }
  p += bw.pos;
  const uint32_t adler =
      static_cast<uint32_t>(adler32(1, raw, static_cast<uInt>(raw_len)));
  std::free(raw);
  put_be32(adler);
  const size_t idat_end = p;
  const uint32_t idat_len = static_cast<uint32_t>(idat_end - idat_tag - 4);
  out[idat_len_at] = idat_len >> 24;
  out[idat_len_at + 1] = (idat_len >> 16) & 0xff;
  out[idat_len_at + 2] = (idat_len >> 8) & 0xff;
  out[idat_len_at + 3] = idat_len & 0xff;
  put_be32(static_cast<uint32_t>(
      crc32(0, out + idat_tag, static_cast<uInt>(idat_end - idat_tag))));
  // IEND
  put_be32(0);
  std::memcpy(out + p, "IEND", 4); p += 4;
  put_be32(static_cast<uint32_t>(crc32(0, reinterpret_cast<const Bytef*>("IEND"), 4)));
  *out_len = p;
  return 0;
}

int segio_encode_png_zlib(const uint8_t* rgb, int32_t h, int32_t w,
                          int32_t level, uint8_t* out, size_t out_cap,
                          size_t* out_len) {
  if (h <= 0 || w <= 0 || level < 0 || level > 9) return -1;
  const size_t stride = static_cast<size_t>(w) * 3;
  const size_t raw_len = static_cast<size_t>(h) * (stride + 1);
  uint8_t* raw = static_cast<uint8_t*>(std::malloc(raw_len));
  if (!raw) return -2;
  sub_filter(rgb, h, w, raw);
  uLongf zcap = compressBound(static_cast<uLong>(raw_len));
  uint8_t* z = static_cast<uint8_t*>(std::malloc(zcap));
  if (!z) {
    std::free(raw);
    return -2;
  }
  const int rc = compress2(z, &zcap, raw, static_cast<uLong>(raw_len), level);
  std::free(raw);
  if (rc != Z_OK) {
    std::free(z);
    return -3;
  }
  size_t p = 0;
  if (out_cap < 8 + 25 + 12 + zcap + 12) {
    std::free(z);
    return -5;
  }
  auto put_be32 = [&](uint32_t v) {
    out[p++] = v >> 24; out[p++] = (v >> 16) & 0xff;
    out[p++] = (v >> 8) & 0xff; out[p++] = v & 0xff;
  };
  static const uint8_t sig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
  std::memcpy(out + p, sig, 8); p += 8;
  put_be32(13);
  const size_t ihdr_tag = p;
  std::memcpy(out + p, "IHDR", 4); p += 4;
  put_be32(static_cast<uint32_t>(w));
  put_be32(static_cast<uint32_t>(h));
  out[p++] = 8; out[p++] = 2; out[p++] = 0; out[p++] = 0; out[p++] = 0;
  put_be32(static_cast<uint32_t>(
      crc32(0, out + ihdr_tag, static_cast<uInt>(p - ihdr_tag))));
  put_be32(static_cast<uint32_t>(zcap));
  const size_t idat_tag = p;
  std::memcpy(out + p, "IDAT", 4); p += 4;
  std::memcpy(out + p, z, zcap); p += zcap;
  std::free(z);
  put_be32(static_cast<uint32_t>(
      crc32(0, out + idat_tag, static_cast<uInt>(p - idat_tag))));
  put_be32(0);
  std::memcpy(out + p, "IEND", 4); p += 4;
  put_be32(static_cast<uint32_t>(crc32(0, reinterpret_cast<const Bytef*>("IEND"), 4)));
  *out_len = p;
  return 0;
}

// ---------------------------------------------------------------------------
// Resize. Fixed-point arithmetic chosen so the Python numpy oracle
// (native/__init__.py) reproduces it bit-exactly: per-output-pixel source
// index and 16.16 weight derive from integer-only math; bilinear accumulates
// in 32.32 and rounds half-up. Channels-last u8, any channel count.
// ---------------------------------------------------------------------------

static void axis_coords(int in_n, int out_n, int32_t* idx0, int32_t* wfrac) {
  // src center x = (j + 0.5) * in/out - 0.5, as exact integer math:
  // x*2^17 = (2j+1)*in*2^16/out - 2^16  (floor division; in,out <= ~2^15)
  for (int j = 0; j < out_n; ++j) {
    const int64_t num = ((2 * static_cast<int64_t>(j) + 1) * in_n << 16) /
                            (2 * static_cast<int64_t>(out_n)) -
                        (1 << 15);  // x in 16.16
    int64_t x = num;
    if (x < 0) x = 0;
    int32_t i0 = static_cast<int32_t>(x >> 16);
    int32_t frac = static_cast<int32_t>(x & 0xffff);
    if (i0 >= in_n - 1) {
      i0 = in_n - 1;
      frac = 0;
    }
    idx0[j] = i0;
    wfrac[j] = frac;
  }
}

int segio_resize_bilinear_u8(const uint8_t* src, int32_t h, int32_t w,
                             int32_t c, uint8_t* dst, int32_t oh, int32_t ow) {
  if (h <= 0 || w <= 0 || c <= 0 || oh <= 0 || ow <= 0) return -1;
  int32_t* xi = static_cast<int32_t*>(std::malloc(sizeof(int32_t) * ow * 2));
  int32_t* yi = static_cast<int32_t*>(std::malloc(sizeof(int32_t) * oh * 2));
  if (!xi || !yi) {
    std::free(xi);
    std::free(yi);
    return -2;
  }
  int32_t* xw = xi + ow;
  int32_t* yw = yi + oh;
  axis_coords(w, ow, xi, xw);
  axis_coords(h, oh, yi, yw);
  // horizontal pass into an int32 16.16 row pair, then vertical blend
  int32_t* row0 = static_cast<int32_t*>(std::malloc(sizeof(int32_t) * ow * c));
  int32_t* row1 = static_cast<int32_t*>(std::malloc(sizeof(int32_t) * ow * c));
  if (!row0 || !row1) {
    std::free(xi); std::free(yi); std::free(row0); std::free(row1);
    return -2;
  }
  const size_t sstride = static_cast<size_t>(w) * c;
  int cached0 = -1, cached1 = -1;
  for (int y = 0; y < oh; ++y) {
    const int y0 = yi[y];
    const int y1 = (y0 + 1 < h) ? y0 + 1 : y0;
    const int32_t fy = yw[y];
    auto hpass = [&](int sy, int32_t* row) {
      const uint8_t* s = src + static_cast<size_t>(sy) * sstride;
      for (int x = 0; x < ow; ++x) {
        const int x0 = xi[x];
        const int x1 = (x0 + 1 < w) ? x0 + 1 : x0;
        const int32_t fx = xw[x];
        const uint8_t* a = s + static_cast<size_t>(x0) * c;
        const uint8_t* b = s + static_cast<size_t>(x1) * c;
        int32_t* o = row + static_cast<size_t>(x) * c;
        for (int k = 0; k < c; ++k)
          o[k] = a[k] * (65536 - fx) + b[k] * fx;  // 16.16, < 2^24
      }
    };
    if (cached0 != y0) { hpass(y0, row0); cached0 = y0; }
    if (cached1 != y1) {
      if (y1 == y0) {
        std::memcpy(row1, row0, sizeof(int32_t) * ow * c);
      } else {
        hpass(y1, row1);
      }
      cached1 = y1;
    }
    uint8_t* d = dst + static_cast<size_t>(y) * ow * c;
    for (int i = 0; i < ow * c; ++i) {
      const int64_t v = static_cast<int64_t>(row0[i]) * (65536 - fy) +
                        static_cast<int64_t>(row1[i]) * fy;  // 32.32
      d[i] = static_cast<uint8_t>((v + (1LL << 31)) >> 32);
    }
  }
  std::free(xi); std::free(yi); std::free(row0); std::free(row1);
  return 0;
}

int segio_resize_nearest_u8(const uint8_t* src, int32_t h, int32_t w,
                            int32_t c, uint8_t* dst, int32_t oh, int32_t ow) {
  if (h <= 0 || w <= 0 || c <= 0 || oh <= 0 || ow <= 0) return -1;
  int32_t* xs = static_cast<int32_t*>(std::malloc(sizeof(int32_t) * ow));
  if (!xs) return -2;
  // Bit-exact replication of PIL's NEAREST (ImagingScaleAffine): start at
  // 0.5*scale and ACCUMULATE the double per output pixel (xx += scale),
  // truncating — the accumulated FP rounding decides exact-tie pixels, so
  // closed-form index math would diverge from PIL on ties (fuzz-verified
  // 0/3000 mismatches in tests/test_native.py). The loop-carried FP
  // dependence also keeps -O3 from reassociating it.
  const double ax = static_cast<double>(w) / ow;
  const double ay = static_cast<double>(h) / oh;
  double xx = ax * 0.5;
  for (int x = 0; x < ow; ++x) {
    int32_t v = static_cast<int32_t>(xx);
    xs[x] = v < w ? v : w - 1;
    xx += ax;
  }
  double yy = ay * 0.5;
  for (int y = 0; y < oh; ++y) {
    int32_t sy = static_cast<int32_t>(yy);
    if (sy >= h) sy = h - 1;
    yy += ay;
    const uint8_t* s = src + static_cast<size_t>(sy) * w * c;
    uint8_t* d = dst + static_cast<size_t>(y) * ow * c;
    for (int x = 0; x < ow; ++x)
      std::memcpy(d + static_cast<size_t>(x) * c,
                  s + static_cast<size_t>(xs[x]) * c, c);
  }
  std::free(xs);
  return 0;
}

// ---------------------------------------------------------------------------
// Overlay blend via lookup table. The blend in ops/overlay.host_overlay is a
// pure function of (image byte, class id, channel) — the caller precomputes
// lut[class][channel][256] with the EXACT numpy f32 arithmetic, so this walk
// is bit-equal to the vectorized f32 blend it replaces (50 ms -> ~2 ms at
// 1242x375 on this host; the blend became the sweep's largest host cost once
// the fixed-Huffman encoder landed).
// ---------------------------------------------------------------------------

int segio_overlay_lut_u8(const uint8_t* img, const uint8_t* labels,
                         int64_t npix, const uint8_t* lut, int32_t nc,
                         uint8_t* out) {
  if (npix < 0 || nc <= 0 || nc > 256) return -1;
  for (int64_t i = 0; i < npix; ++i) {
    const uint8_t c = labels[i];
    if (c >= nc) return -3;  // matches the numpy path's fancy-index bounds error
    const uint8_t* t = lut + static_cast<size_t>(c) * 768;
    const uint8_t* s = img + i * 3;
    uint8_t* d = out + i * 3;
    d[0] = t[s[0]];
    d[1] = t[256 + s[1]];
    d[2] = t[512 + s[2]];
  }
  return 0;
}

}  // extern "C"
