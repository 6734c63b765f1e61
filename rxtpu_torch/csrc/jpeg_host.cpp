// Host JPEG batch decoder and encoder over libjpeg: the port's JPEG input on
// the CPU.
//
// A copy of the JPEG half of rxtpu's native decoder
// (rxtpu/native/decoder.cpp: rxtpu_decode_batch, rxtpu_decode_files,
// rxtpu_encode_batch, their std::thread pool and setjmp error manager), so
// that the port never reads a file of the JAX package. The same libjpeg with
// its default JDCT_ISLOW integer IDCT decodes bit-equal to rxtpu. Added:
// rxtpu_jpeg_size, which reads only the header (the source-size probe).
// Left out: the inflate/deflate functions (compressed packs).
//
// Build (rxtpu_torch/ops/_build.py, at first use):
//   g++ -O3 -std=c++17 -shared -fPIC jpeg_host.cpp -o libjpeg_host.so \
//       -ljpeg -lpthread
// No -march=native: libjpeg carries its own SIMD, and the build directory may
// be shared by hosts of different CPU families.

#include <atomic>
#include <csetjmp>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

#include <jpeglib.h>

namespace {

struct ErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf jump;
};

void error_exit(j_common_ptr cinfo) {
  ErrorMgr* err = reinterpret_cast<ErrorMgr*>(cinfo->err);
  longjmp(err->jump, 1);
}

void silent_output(j_common_ptr) {}  // keep libjpeg warnings off stderr

// Decode one grayscale JPEG buffer into out[h*w]; 0 on success, negative on
// failure.
int decode_one(const uint8_t* buf, size_t len, uint8_t* out, int out_h,
               int out_w) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  jerr.pub.output_message = silent_output;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;  // corrupt stream
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, buf, len);
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return -2;
  }
  // reject wrong dimensions before start_decompress: a header declaring
  // 65500x65500 would otherwise drive full-width buffer allocation first.
  // No scaling is configured, so header dims == output dims.
  if (static_cast<int>(cinfo.image_height) != out_h ||
      static_cast<int>(cinfo.image_width) != out_w) {
    jpeg_destroy_decompress(&cinfo);
    return -3;
  }
  cinfo.out_color_space = JCS_GRAYSCALE;
  jpeg_start_decompress(&cinfo);
  if (static_cast<int>(cinfo.output_height) != out_h ||
      static_cast<int>(cinfo.output_width) != out_w) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return -3;
  }
  while (cinfo.output_scanline < cinfo.output_height) {
    JSAMPROW row = out + static_cast<size_t>(cinfo.output_scanline) * out_w;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

// Encode one grayscale plane into a libjpeg-allocated buffer (*mem), which
// the caller frees (also on failure, if non-null). *mem and *mem_size live in
// the caller's frame: locals of a function that calls setjmp must not change
// between setjmp and longjmp.
int encode_one(const uint8_t* src, int h, int w, int quality,
               unsigned char** mem, unsigned long* mem_size) {
  jpeg_compress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  jerr.pub.output_message = silent_output;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_compress(&cinfo);
    return -1;
  }
  jpeg_create_compress(&cinfo);
  jpeg_mem_dest(&cinfo, mem, mem_size);
  cinfo.image_width = w;
  cinfo.image_height = h;
  cinfo.input_components = 1;
  cinfo.in_color_space = JCS_GRAYSCALE;
  jpeg_set_defaults(&cinfo);
  jpeg_set_quality(&cinfo, quality, TRUE);
  jpeg_start_compress(&cinfo, TRUE);
  while (cinfo.next_scanline < cinfo.image_height) {
    JSAMPROW row = const_cast<uint8_t*>(src) +
                   static_cast<size_t>(cinfo.next_scanline) * w;
    jpeg_write_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_compress(&cinfo);
  jpeg_destroy_compress(&cinfo);
  return 0;
}

// The pool: clamp nthreads, hand out items by an atomic counter, count
// failures. fn(i, scratch) returns true on success; scratch is a per-thread
// byte buffer (file reads).
template <typename F>
int run_pool(int n, int nthreads, F&& fn) {
  if (nthreads <= 0) nthreads = static_cast<int>(std::thread::hardware_concurrency());
  if (nthreads < 1) nthreads = 1;
  if (nthreads > n) nthreads = n;
  std::atomic<int> next(0), failures(0);
  auto worker = [&]() {
    std::vector<uint8_t> scratch;
    int i;
    while ((i = next.fetch_add(1)) < n) {
      if (!fn(i, scratch)) failures.fetch_add(1);
    }
  };
  if (nthreads == 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    pool.reserve(nthreads);
    for (int t = 0; t < nthreads; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
  return failures.load();
}

}  // namespace

extern "C" {

// Decode n grayscale JPEGs (concatenated in `data` at offsets/lengths) into
// out[n, out_h, out_w]. Returns the number of failures; failed slots are
// zero-filled. nthreads <= 0 selects the hardware concurrency.
int rxtpu_decode_batch(const uint8_t* data, const int64_t* offsets,
                       const int64_t* lengths, int n, uint8_t* out, int out_h,
                       int out_w, int nthreads) {
  const size_t plane = static_cast<size_t>(out_h) * out_w;
  return run_pool(n, nthreads, [&](int i, std::vector<uint8_t>&) {
    uint8_t* dst = out + plane * i;
    int rc = decode_one(data + offsets[i], static_cast<size_t>(lengths[i]),
                        dst, out_h, out_w);
    if (rc != 0) std::memset(dst, 0, plane);
    return rc == 0;
  });
}

// Read and decode n grayscale JPEG files into out[n, out_h, out_w], the
// open/read/decode all inside the pool. paths = concatenated NUL-terminated
// strings. Returns the failure count; failed slots are zero-filled.
int rxtpu_decode_files(const char* paths, const int64_t* path_offsets, int n,
                       uint8_t* out, int out_h, int out_w, int nthreads) {
  const size_t plane = static_cast<size_t>(out_h) * out_w;
  return run_pool(n, nthreads, [&](int i, std::vector<uint8_t>& buf) {
    uint8_t* dst = out + plane * i;
    FILE* f = fopen(paths + path_offsets[i], "rb");
    bool ok = false;
    if (f) {
      fseek(f, 0, SEEK_END);
      long sz = ftell(f);
      fseek(f, 0, SEEK_SET);
      if (sz > 0) {
        buf.resize(static_cast<size_t>(sz));
        if (fread(buf.data(), 1, static_cast<size_t>(sz), f) ==
            static_cast<size_t>(sz)) {
          ok = decode_one(buf.data(), static_cast<size_t>(sz), dst, out_h,
                          out_w) == 0;
        }
      }
      fclose(f);
    }
    if (!ok) std::memset(dst, 0, plane);
    return ok;
  });
}

// Encode n grayscale planes in[n, h, w] at quality q into per-slot buffers
// out + i*cap; out_lengths[i] gets the encoded size (0 on failure or
// overflow). Returns the number of failures.
int rxtpu_encode_batch(const uint8_t* in, int n, int h, int w, int quality,
                       uint8_t* out, int64_t cap, int64_t* out_lengths,
                       int nthreads) {
  const size_t plane = static_cast<size_t>(h) * w;
  return run_pool(n, nthreads, [&](int i, std::vector<uint8_t>&) {
    unsigned char* mem = nullptr;
    unsigned long mem_size = 0;
    int rc = encode_one(in + plane * i, h, w, quality, &mem, &mem_size);
    bool ok = rc == 0 && static_cast<int64_t>(mem_size) <= cap;
    if (ok) {
      std::memcpy(out + static_cast<size_t>(cap) * i, mem, mem_size);
      out_lengths[i] = static_cast<int64_t>(mem_size);
    } else {
      out_lengths[i] = 0;
    }
    if (mem) free(mem);
    return ok;
  });
}

// Read only the header of one JPEG: *height and *width of the image. 0 on
// success, negative on a corrupt or non-JPEG stream.
int rxtpu_jpeg_size(const uint8_t* data, int64_t len, int* height,
                    int* width) {
  jpeg_decompress_struct cinfo;
  ErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = error_exit;
  jerr.pub.output_message = silent_output;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    return -1;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_mem_src(&cinfo, data, static_cast<unsigned long>(len));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return -2;
  }
  *height = static_cast<int>(cinfo.image_height);
  *width = static_cast<int>(cinfo.image_width);
  jpeg_destroy_decompress(&cinfo);
  return 0;
}

}  // extern "C"
