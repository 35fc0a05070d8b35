// Native host-side JPEG decode for the data loader.
//
// The reference's input path leans on PIL/cv2 (dataset/voc.py:96-139,
// Test_coco.py:52-105) — i.e. on their bundled native decoders driven
// one Python call at a time.  This is the port's native
// loader: libjpeg decode straight into the fixed uint8 tile that the
// device-side resize consumes (data/pipeline.decode_to_tile semantics:
// content top-left, last content row/col replicated once, oversize
// content top-left-cropped), with a C++ thread pool for batch decode
// (the GIL is released for the whole batch — scales with host cores,
// unlike per-image Python decode calls).
//
// Exposed as a plain C ABI for ctypes (no pybind11).
// Grayscale streams are decoded as gray and replicated to RGB. CMYK and
// YCCK streams are decoded to CMYK (libjpeg converts YCCK itself) and
// converted to RGB as PIL's Image.convert("RGB") does after its JPEG
// plugin reads them: the stored values are inverted first (PIL always
// assumes the Adobe polarity, "CMYK;I"), then R = nk - nk * C / 255 with
// nk = 255 - K and PIL's rounding of the product. Streams libjpeg cannot
// read return an error code; the Python wrapper raises for those (it has
// no PIL fallback).

#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <csetjmp>
#include <algorithm>
#include <thread>
#include <vector>

#include <jpeglib.h>

namespace {

struct ErrorTrap {
  jpeg_error_mgr mgr;
  jmp_buf jump;
};

void on_error(j_common_ptr cinfo) {
  ErrorTrap* trap = reinterpret_cast<ErrorTrap*>(cinfo->err);
  longjmp(trap->jump, 1);
}

void on_message(j_common_ptr, int) {}  // swallow warnings

// One decoded scanline of `comps` components (1 gray, 3 RGB, 4 CMYK as
// stored) to `w` RGB pixels.
void row_to_rgb(const uint8_t* in, uint8_t* out, int w, int comps) {
  if (comps == 3) {
    std::memcpy(out, in, static_cast<size_t>(w) * 3);
  } else if (comps == 1) {
    for (int x = 0; x < w; ++x) out[3 * x] = out[3 * x + 1] = out[3 * x + 2] = in[x];
  } else {
    for (int x = 0; x < w; ++x) {
      const uint8_t* p = in + 4 * x;
      const int nk = p[3];  // 255 - (255 - stored K): the inverted K's complement
      for (int c = 0; c < 3; ++c) {
        const int t = (255 - p[c]) * nk + 128;  // PIL's MULDIV255(C, nk)
        out[3 * x + c] = static_cast<uint8_t>(nk - (((t >> 8) + t) >> 8));
      }
    }
  }
}

// Decode `buf` into `tile` (th x tw x 3, row-major uint8). Content lands
// top-left; rows/cols past the content are zero except one replicated
// edge row/col (linear resampling past the edge then sees clamp
// semantics, matching data/pipeline.decode_to_tile). Content larger than
// the tile is cropped to the top-left th x tw window. hw_out gets the
// tile-clipped content (h, w).
int decode_tile_impl(const uint8_t* buf, size_t len, uint8_t* tile, int th,
                     int tw, int32_t* hw_out) {
  jpeg_decompress_struct cinfo;
  ErrorTrap trap;
  cinfo.err = jpeg_std_error(&trap.mgr);
  trap.mgr.error_exit = on_error;
  trap.mgr.emit_message = on_message;
  std::vector<uint8_t> rowbuf;
  if (setjmp(trap.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;  // corrupt stream / libjpeg hard error
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(buf),
               static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  if (cinfo.jpeg_color_space == JCS_CMYK || cinfo.jpeg_color_space == JCS_YCCK) {
    cinfo.out_color_space = JCS_CMYK;  // libjpeg turns YCCK into CMYK
  } else if (cinfo.jpeg_color_space == JCS_GRAYSCALE) {
    cinfo.out_color_space = JCS_GRAYSCALE;
  } else {
    cinfo.out_color_space = JCS_RGB;
  }
  jpeg_start_decompress(&cinfo);
  const int comps = cinfo.output_components;
  if (comps != 1 && comps != 3 && comps != 4) {
    jpeg_destroy_decompress(&cinfo);
    return 2;
  }
  const int full_h = static_cast<int>(cinfo.output_height);
  const int full_w = static_cast<int>(cinfo.output_width);
  const int h = std::min(full_h, th);
  const int w = std::min(full_w, tw);
  const bool direct = (comps == 3 && full_w == tw);  // decode rows in place, no copy
  if (!direct) rowbuf.resize(static_cast<size_t>(full_w) * comps);
  while (cinfo.output_scanline < cinfo.output_height) {
    const int y = static_cast<int>(cinfo.output_scanline);
    if (y >= h) break;  // tile-cropped: skip the remaining scanlines
    uint8_t* dst = tile + static_cast<size_t>(y) * tw * 3;
    JSAMPROW row = direct ? dst : rowbuf.data();
    jpeg_read_scanlines(&cinfo, &row, 1);
    if (!direct) row_to_rgb(rowbuf.data(), dst, w, comps);
  }
  if (cinfo.output_scanline < cinfo.output_height) {
    jpeg_abort_decompress(&cinfo);  // cropped: discard the rest cleanly
  } else {
    jpeg_finish_decompress(&cinfo);
  }
  jpeg_destroy_decompress(&cinfo);
  // zero the padding, then replicate the content edge once
  for (int y = 0; y < h; ++y) {
    uint8_t* r = tile + static_cast<size_t>(y) * tw * 3;
    if (w < tw) std::memset(r + static_cast<size_t>(w) * 3, 0, static_cast<size_t>(tw - w) * 3);
  }
  for (int y = h; y < th; ++y)
    std::memset(tile + static_cast<size_t>(y) * tw * 3, 0, static_cast<size_t>(tw) * 3);
  if (h < th)
    std::memcpy(tile + static_cast<size_t>(h) * tw * 3,
                tile + static_cast<size_t>(h - 1) * tw * 3,
                static_cast<size_t>(w) * 3);
  if (w < tw) {
    const int yend = std::min(h + 1, th);
    for (int y = 0; y < yend; ++y) {
      uint8_t* r = tile + static_cast<size_t>(y) * tw * 3;
      std::memcpy(r + static_cast<size_t>(w) * 3, r + static_cast<size_t>(w - 1) * 3, 3);
    }
  }
  hw_out[0] = h;
  hw_out[1] = w;
  return 0;
}

}  // namespace

extern "C" {

// The libjpeg ABI this file was compiled against, and whether the linked
// library agrees: jpeg_create_decompress checks the version and the size of
// the struct, and raises through error_exit on a mismatch. Returns 0 when
// they agree.
int jpeg_selftest(int32_t* version_out) {
  version_out[0] = JPEG_LIB_VERSION;
  jpeg_decompress_struct cinfo;
  ErrorTrap trap;
  cinfo.err = jpeg_std_error(&trap.mgr);
  trap.mgr.error_exit = on_error;
  trap.mgr.emit_message = on_message;
  if (setjmp(trap.jump)) return 1;
  jpeg_create_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// Header-only parse: writes (height, width) without decoding. Returns 0
// on success, nonzero on corrupt/unsupported streams.
int jpeg_peek(const uint8_t* buf, size_t len, int32_t* hw_out) {
  jpeg_decompress_struct cinfo;
  ErrorTrap trap;
  cinfo.err = jpeg_std_error(&trap.mgr);
  trap.mgr.error_exit = on_error;
  trap.mgr.emit_message = on_message;
  if (setjmp(trap.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, const_cast<unsigned char*>(buf),
               static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return 1;
  }
  hw_out[0] = static_cast<int32_t>(cinfo.image_height);
  hw_out[1] = static_cast<int32_t>(cinfo.image_width);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

int jpeg_decode_tile(const uint8_t* buf, size_t len, uint8_t* tile, int th,
                     int tw, int32_t* hw_out) {
  return decode_tile_impl(buf, len, tile, th, tw, hw_out);
}

// Batch decode with a C++ thread pool. bufs/lens give n in-memory JPEG
// streams; tiles is n contiguous th*tw*3 tiles; hw_out is n (h, w)
// pairs; status_out[i] gets the per-image decode_tile return code.
void jpeg_decode_batch(const uint8_t* const* bufs, const size_t* lens, int n,
                       uint8_t* tiles, int th, int tw, int32_t* hw_out,
                       int n_threads, int32_t* status_out) {
  const size_t tile_bytes = static_cast<size_t>(th) * tw * 3;
  n_threads = std::max(1, std::min(n_threads, n));
  if (n_threads == 1) {
    for (int i = 0; i < n; ++i)
      status_out[i] = decode_tile_impl(bufs[i], lens[i], tiles + i * tile_bytes,
                                       th, tw, hw_out + 2 * i);
    return;
  }
  std::vector<std::thread> workers;
  workers.reserve(n_threads);
  for (int t = 0; t < n_threads; ++t) {
    workers.emplace_back([=]() {
      for (int i = t; i < n; i += n_threads)
        status_out[i] = decode_tile_impl(
            bufs[i], lens[i], tiles + i * tile_bytes, th, tw, hw_out + 2 * i);
    });
  }
  for (auto& w : workers) w.join();
}

}  // extern "C"
