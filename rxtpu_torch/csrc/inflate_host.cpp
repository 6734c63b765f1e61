// Host inflate, deflate and PNG reader: the port's compressed packs and PNG
// input, on the CPU and on the card's host alike.
//
// A copy of the compressed-pack half of rxtpu's native decoder
// (rxtpu/native/decoder.cpp: filter_plane, unfilter_plane, compress_any,
// decompress_any, run_pool, rxtpu_inflate_batch,
// rxtpu_deflate_filtered_batch, rxtpu_inflate_unfilter_batch), so that the
// port never reads a file of the JAX package, plus a PNG reader: a PNG
// file's pixel data is a zlib stream of rows, each led by one filter byte
// (none, sub, up, avg, paeth), which is exactly the pack's "png" filter for
// 8-bit gray (one byte per pixel, so the predictor looks one byte back),
// and streams of any sizes each (rxtpu_inflate_each, rxtpu_compress_each:
// the chunks of an orbax checkpoint and the nodes of its OCDBT store).
//
// zlib and zstd are not linked: the few functions used here have plain C
// signatures, declared below, and are bound at first use by dlopen of
// their sonames, libz.so.1 and libzstd.so.1 (rxtpu_codec_load, which the
// Python wrapper calls with the soname). So the source builds
// without zlib.h or zstd.h (the card's host has no zstd.h), and a host that
// lacks one of the libraries fails only when that codec is asked for, with
// dlopen's message.
//
// Build (rxtpu_torch/ops/_build.py, at first use):
//   g++ -O3 -std=c++17 -shared -fPIC inflate_host.cpp -o libinflate_host.so -ldl -lpthread

#include <dlfcn.h>

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

namespace {

// ---- zlib and zstd, bound by dlopen ---------------------------------------
// zlib: uLong = unsigned long, uInt = unsigned int, Bytef = unsigned char;
// Z_OK = 0.
using Compress2 = int (*)(uint8_t*, unsigned long*, const uint8_t*,
                          unsigned long, int);
using Uncompress = int (*)(uint8_t*, unsigned long*, const uint8_t*,
                           unsigned long);
using Crc32 = unsigned long (*)(unsigned long, const uint8_t*, unsigned int);
using ZstdCompress = size_t (*)(void*, size_t, const void*, size_t, int);
using ZstdDecompress = size_t (*)(void*, size_t, const void*, size_t);
using ZstdIsError = unsigned (*)(size_t);

Compress2 z_compress2 = nullptr;
Uncompress z_uncompress = nullptr;
Crc32 z_crc32 = nullptr;
ZstdCompress zstd_compress = nullptr;
ZstdDecompress zstd_decompress = nullptr;
ZstdIsError zstd_is_error = nullptr;
std::atomic<bool> loaded[2];  // codec 0 = zlib, 1 = zstd
std::mutex load_mutex;

bool codec_ready(int codec) {
  return (codec == 0 || codec == 1) && loaded[codec].load(std::memory_order_acquire);
}

// ---- PNG-style row pre-filter ---------------------------------------------
// The filtered layout per plane is h rows of [1 filter-id byte][w residual
// bytes]; planes of a view are concatenated.

inline int paeth_pred(int a, int b, int c) {
  int p = a + b - c;
  int pa = p > a ? p - a : a - p;
  int pb = p > b ? p - b : b - p;
  int pc = p > c ? p - c : c - p;
  if (pa <= pb && pa <= pc) return a;
  if (pb <= pc) return b;
  return c;
}

// Filter one plane (h x w) into dst[h*(w+1)], choosing per row among the
// five PNG filters by the least sum of absolute residuals (libpng's
// heuristic). Predictors reference the raw previous row and column.
void filter_plane(const uint8_t* src, int64_t h, int64_t w, uint8_t* dst,
                  std::vector<uint8_t>& cand) {
  cand.resize(static_cast<size_t>(5) * w);
  for (int64_t y = 0; y < h; ++y) {
    const uint8_t* row = src + y * w;
    const uint8_t* up = y ? src + (y - 1) * w : nullptr;
    uint8_t* c[5];
    for (int f = 0; f < 5; ++f) c[f] = cand.data() + static_cast<size_t>(f) * w;
    for (int64_t x = 0; x < w; ++x) {
      int v = row[x];
      int a = x ? row[x - 1] : 0;
      int b = up ? up[x] : 0;
      int d = (x && up) ? up[x - 1] : 0;
      c[0][x] = static_cast<uint8_t>(v);
      c[1][x] = static_cast<uint8_t>(v - a);
      c[2][x] = static_cast<uint8_t>(v - b);
      c[3][x] = static_cast<uint8_t>(v - ((a + b) >> 1));
      c[4][x] = static_cast<uint8_t>(v - paeth_pred(a, b, d));
    }
    int best = 0;
    long best_cost = -1;
    for (int f = 0; f < 5; ++f) {
      long s = 0;
      for (int64_t x = 0; x < w; ++x) {
        int8_t sv = static_cast<int8_t>(c[f][x]);
        s += sv < 0 ? -static_cast<long>(sv) : sv;
      }
      if (best_cost < 0 || s < best_cost) { best_cost = s; best = f; }
    }
    uint8_t* d = dst + y * (w + 1);
    d[0] = static_cast<uint8_t>(best);
    std::memcpy(d + 1, c[best], static_cast<size_t>(w));
  }
}

// Reconstruct one plane from its filtered rows; false on a filter id above
// 4. Sequential per row (sub, avg and paeth carry the left neighbour), so
// the parallelism is the pool's, one item per thread.
bool unfilter_plane(const uint8_t* f, int64_t h, int64_t w, uint8_t* dst) {
  for (int64_t y = 0; y < h; ++y) {
    const uint8_t* src = f + y * (w + 1);
    int ft = src[0];
    const uint8_t* row = src + 1;
    uint8_t* out = dst + y * w;
    const uint8_t* up = y ? dst + (y - 1) * w : nullptr;
    switch (ft) {
      case 0:
        std::memcpy(out, row, static_cast<size_t>(w));
        break;
      case 1: {
        int a = 0;
        for (int64_t x = 0; x < w; ++x) {
          a = (row[x] + a) & 0xFF;
          out[x] = static_cast<uint8_t>(a);
        }
        break;
      }
      case 2:
        if (up) {
          for (int64_t x = 0; x < w; ++x)
            out[x] = static_cast<uint8_t>(row[x] + up[x]);
        } else {
          std::memcpy(out, row, static_cast<size_t>(w));
        }
        break;
      case 3: {
        int a = 0;
        for (int64_t x = 0; x < w; ++x) {
          int b = up ? up[x] : 0;
          a = (row[x] + ((a + b) >> 1)) & 0xFF;
          out[x] = static_cast<uint8_t>(a);
        }
        break;
      }
      case 4: {
        int a = 0, c = 0;
        for (int64_t x = 0; x < w; ++x) {
          int b = up ? up[x] : 0;
          a = (row[x] + paeth_pred(a, b, c)) & 0xFF;
          c = b;
          out[x] = static_cast<uint8_t>(a);
        }
        break;
      }
      default:
        return false;
    }
  }
  return true;
}

// ---- codec dispatch: zlib (codec 0) or zstd (codec 1) ---------------------
// Level scales differ: zlib 1-9, zstd 1-22.

// Compress src[n] into dst[cap]; the compressed size, or 0 on failure.
size_t compress_any(int codec, uint8_t* dst, size_t cap, const uint8_t* src,
                    size_t n, int level) {
  if (codec == 1) {
    size_t r = zstd_compress(dst, cap, src, n, level);
    return zstd_is_error(r) ? 0 : r;
  }
  unsigned long dst_len = static_cast<unsigned long>(cap);
  if (z_compress2(dst, &dst_len, src, static_cast<unsigned long>(n), level) != 0)
    return 0;
  return static_cast<size_t>(dst_len);
}

// Decompress src[n] into dst[cap]; the decompressed size, 0 on failure.
size_t decompress_any(int codec, uint8_t* dst, size_t cap, const uint8_t* src,
                      size_t n) {
  if (codec == 1) {
    size_t r = zstd_decompress(dst, cap, src, n);
    return zstd_is_error(r) ? 0 : r;
  }
  unsigned long dst_len = static_cast<unsigned long>(cap);
  if (z_uncompress(dst, &dst_len, src, static_cast<unsigned long>(n)) != 0) return 0;
  return static_cast<size_t>(dst_len);
}

// Per-thread work buffers: a file's bytes, joined IDAT data, filtered rows,
// the filter's candidate rows.
struct Scratch {
  std::vector<uint8_t> file, idat, rows, cand;
};

// The pool: clamp nthreads, hand out items by an atomic counter, count
// failures. fn(i, scratch) returns true on success.
template <typename F>
int run_pool(int n, int nthreads, F&& fn) {
  if (nthreads <= 0) nthreads = static_cast<int>(std::thread::hardware_concurrency());
  if (nthreads < 1) nthreads = 1;
  if (nthreads > n) nthreads = n;
  std::atomic<int> next(0), failures(0);
  auto worker = [&]() {
    Scratch scratch;
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

// ---- PNG reader ------------------------------------------------------------
// Per-item status of the PNG batch calls (rxtpu_torch/data/decode.py reads
// these codes; kUnsupported raises there, the others zero-fill and count).
enum PngStatus {
  kOk = 0,
  kCorrupt = 1,      // not a PNG, truncated, a bad or missing chunk
  kCrc = 2,          // a critical chunk's CRC does not match
  kSize = 3,         // IHDR's size is not the expected one
  kUnsupported = 4,  // not 8-bit grayscale, or interlaced
  kInflate = 5,      // the IDAT stream does not inflate to h*(w+1) bytes
  kFilter = 6,       // a row's filter id is above 4
  kRead = 7,         // the file cannot be opened or read
};

const uint8_t kPngSignature[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};

inline uint32_t be32(const uint8_t* p) {
  return (static_cast<uint32_t>(p[0]) << 24) | (static_cast<uint32_t>(p[1]) << 16) |
         (static_cast<uint32_t>(p[2]) << 8) | p[3];
}

// Walk the chunks of buf[len]. Checks the signature, IHDR first (gray, 8
// bits, compression and filter method 0, no interlace, out_h x out_w), the
// CRC of every critical chunk, and IEND; joins the IDAT data, inflates it
// into exactly out_h*(out_w+1) bytes and unfilters into out.
int png_decode_one(const uint8_t* buf, size_t len, uint8_t* out, int64_t out_h,
                   int64_t out_w, Scratch& s) {
  if (len < 8 || std::memcmp(buf, kPngSignature, 8) != 0) return kCorrupt;
  size_t pos = 8;
  bool have_ihdr = false, have_iend = false;
  std::vector<const uint8_t*> idat_ptr;
  std::vector<size_t> idat_len;
  while (!have_iend) {
    if (len - pos < 12) return kCorrupt;
    const size_t clen = be32(buf + pos);
    const uint8_t* type = buf + pos + 4;
    const uint8_t* data = type + 4;
    if (clen > 0x7fffffffu || clen > len - pos - 12) return kCorrupt;
    const bool critical = !(type[0] & 0x20);
    if (critical && z_crc32(0, type, static_cast<unsigned int>(clen + 4)) !=
                        be32(data + clen))
      return kCrc;
    if (!have_ihdr) {
      if (std::memcmp(type, "IHDR", 4) != 0 || clen != 13) return kCorrupt;
      if (data[8] != 8 || data[9] != 0 || data[12] != 0) return kUnsupported;
      if (data[10] != 0 || data[11] != 0) return kCorrupt;
      if (be32(data) != static_cast<uint32_t>(out_w) ||
          be32(data + 4) != static_cast<uint32_t>(out_h))
        return kSize;
      have_ihdr = true;
    } else if (std::memcmp(type, "IDAT", 4) == 0) {
      idat_ptr.push_back(data);
      idat_len.push_back(clen);
    } else if (std::memcmp(type, "IEND", 4) == 0) {
      have_iend = true;
    } else if (critical) {
      return kCorrupt;  // PLTE (not allowed for gray), IHDR again, unknown
    }
    pos += clen + 12;
  }
  if (idat_ptr.empty()) return kCorrupt;
  const uint8_t* stream = idat_ptr[0];
  size_t stream_len = idat_len[0];
  if (idat_ptr.size() > 1) {  // libpng splits IDAT into chunks of 8 KB
    s.idat.clear();
    for (size_t k = 0; k < idat_ptr.size(); ++k)
      s.idat.insert(s.idat.end(), idat_ptr[k], idat_ptr[k] + idat_len[k]);
    stream = s.idat.data();
    stream_len = s.idat.size();
  }
  const size_t filtered = static_cast<size_t>(out_h) * (out_w + 1);
  s.rows.resize(filtered);
  if (decompress_any(0, s.rows.data(), filtered, stream, stream_len) != filtered)
    return kInflate;
  return unfilter_plane(s.rows.data(), out_h, out_w, out) ? kOk : kFilter;
}

// Read a whole file into buf; false if it cannot be opened or read or is empty.
bool read_file(const char* path, std::vector<uint8_t>& buf) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  bool ok = false;
  if (fseek(f, 0, SEEK_END) == 0) {
    long sz = ftell(f);
    if (sz > 0 && fseek(f, 0, SEEK_SET) == 0) {
      buf.resize(static_cast<size_t>(sz));
      ok = fread(buf.data(), 1, buf.size(), f) == buf.size();
    }
  }
  fclose(f);
  return ok;
}

}  // namespace

extern "C" {

// Bind codec 0 (zlib, soname libz.so.1) or 1 (zstd, libzstd.so.1) by
// dlopen of `soname`, once per process. 0 on success; -1 with dlopen's or
// dlsym's message in err[errlen].
int rxtpu_codec_load(int codec, const char* soname, char* err, int errlen) {
  if (codec != 0 && codec != 1) {
    snprintf(err, errlen, "unknown codec id %d", codec);
    return -1;
  }
  std::lock_guard<std::mutex> guard(load_mutex);
  if (loaded[codec].load(std::memory_order_relaxed)) return 0;
  void* handle = dlopen(soname, RTLD_NOW | RTLD_LOCAL);
  if (!handle) {
    snprintf(err, errlen, "%s", dlerror());
    return -1;
  }
  const char* names[3] = {"compress2", "uncompress", "crc32"};
  if (codec == 1) {
    names[0] = "ZSTD_compress";
    names[1] = "ZSTD_decompress";
    names[2] = "ZSTD_isError";
  }
  void* fns[3];
  for (int k = 0; k < 3; ++k) {
    fns[k] = dlsym(handle, names[k]);
    if (!fns[k]) {
      snprintf(err, errlen, "%s lacks %s", soname, names[k]);
      dlclose(handle);
      return -1;
    }
  }
  if (codec == 0) {
    z_compress2 = reinterpret_cast<Compress2>(fns[0]);
    z_uncompress = reinterpret_cast<Uncompress>(fns[1]);
    z_crc32 = reinterpret_cast<Crc32>(fns[2]);
  } else {
    zstd_compress = reinterpret_cast<ZstdCompress>(fns[0]);
    zstd_decompress = reinterpret_cast<ZstdDecompress>(fns[1]);
    zstd_is_error = reinterpret_cast<ZstdIsError>(fns[2]);
  }
  loaded[codec].store(true, std::memory_order_release);
  return 0;
}

// Inflate n zlib/zstd streams (in `data` at offsets/lengths) into
// out[n * item_bytes]. Every stream must decompress to exactly item_bytes;
// short, long or corrupt streams count as failures and zero-fill. Returns
// the failure count, or -1 if the codec is not loaded.
int rxtpu_inflate_batch(const uint8_t* data, const int64_t* offsets,
                        const int64_t* lengths, int n, uint8_t* out,
                        int64_t item_bytes, int codec, int nthreads) {
  if (!codec_ready(codec)) return -1;
  const size_t item = static_cast<size_t>(item_bytes);
  return run_pool(n, nthreads, [&](int i, Scratch&) {
    uint8_t* dst = out + item * i;
    size_t got = decompress_any(codec, dst, item, data + offsets[i],
                                static_cast<size_t>(lengths[i]));
    bool ok = (got == item);
    if (!ok) std::memset(dst, 0, item);
    return ok;
  });
}

// Filter (optionally, per plane) and compress n views in[n, c, h, w] into
// slots out + i*cap; out_lengths[i] gets the compressed size (0 on failure
// or overflow). Returns the failure count, or -1 if the codec is not loaded.
int rxtpu_deflate_filtered_batch(const uint8_t* in, int n, int64_t c,
                                 int64_t h, int64_t w, int level,
                                 int use_filter, uint8_t* out, int64_t cap,
                                 int64_t* out_lengths, int codec,
                                 int nthreads) {
  if (!codec_ready(codec)) return -1;
  const size_t view = static_cast<size_t>(c) * h * w;
  const size_t filtered = static_cast<size_t>(c) * h * (w + 1);
  return run_pool(n, nthreads, [&](int i, Scratch& s) {
    const uint8_t* src = in + view * i;
    uint8_t* dst = out + static_cast<size_t>(cap) * i;
    size_t got;
    if (use_filter) {
      s.rows.resize(filtered);
      for (int64_t p = 0; p < c; ++p)
        filter_plane(src + p * h * w, h, w,
                     s.rows.data() + static_cast<size_t>(p) * h * (w + 1), s.cand);
      got = compress_any(codec, dst, static_cast<size_t>(cap), s.rows.data(),
                         filtered, level);
    } else {
      got = compress_any(codec, dst, static_cast<size_t>(cap), src, view, level);
    }
    out_lengths[i] = static_cast<int64_t>(got);
    return got != 0;
  });
}

// Inflate and unfilter n filtered streams into out[n, c, h, w], the inverse
// of rxtpu_deflate_filtered_batch(use_filter=1): each stream must
// decompress to exactly c*h*(w+1) bytes. Failures zero-fill; returns the
// failure count, or -1 if the codec is not loaded.
int rxtpu_inflate_unfilter_batch(const uint8_t* data, const int64_t* offsets,
                                 const int64_t* lengths, int n, uint8_t* out,
                                 int64_t c, int64_t h, int64_t w, int codec,
                                 int nthreads) {
  if (!codec_ready(codec)) return -1;
  const size_t view = static_cast<size_t>(c) * h * w;
  const size_t filtered = static_cast<size_t>(c) * h * (w + 1);
  return run_pool(n, nthreads, [&](int i, Scratch& s) {
    uint8_t* dst = out + view * i;
    s.rows.resize(filtered);
    size_t got = decompress_any(codec, s.rows.data(), filtered, data + offsets[i],
                                static_cast<size_t>(lengths[i]));
    bool ok = (got == filtered);
    for (int64_t p = 0; ok && p < c; ++p)
      ok = unfilter_plane(s.rows.data() + static_cast<size_t>(p) * h * (w + 1), h,
                          w, dst + p * h * w);
    if (!ok) std::memset(dst, 0, view);
    return ok;
  });
}

// Decode n 8-bit grayscale PNGs (in `data` at offsets/lengths) into
// out[n, out_h, out_w]; status[i] gets item i's PngStatus. Failed items
// zero-fill. Returns the failure count, or -1 if zlib is not loaded.
int rxtpu_png_decode_batch(const uint8_t* data, const int64_t* offsets,
                           const int64_t* lengths, int n, uint8_t* out,
                           int out_h, int out_w, int nthreads, int32_t* status) {
  if (!codec_ready(0)) return -1;
  const size_t plane = static_cast<size_t>(out_h) * out_w;
  return run_pool(n, nthreads, [&](int i, Scratch& s) {
    uint8_t* dst = out + plane * i;
    status[i] = png_decode_one(data + offsets[i], static_cast<size_t>(lengths[i]),
                               dst, out_h, out_w, s);
    if (status[i] != kOk) std::memset(dst, 0, plane);
    return status[i] == kOk;
  });
}

// Read and decode n PNG files into out[n, out_h, out_w], the open, read and
// decode inside the pool. paths = concatenated NUL-terminated strings.
// status[i] as above; returns the failure count, or -1 if zlib is not loaded.
int rxtpu_png_decode_files(const char* paths, const int64_t* path_offsets, int n,
                           uint8_t* out, int out_h, int out_w, int nthreads,
                           int32_t* status) {
  if (!codec_ready(0)) return -1;
  const size_t plane = static_cast<size_t>(out_h) * out_w;
  return run_pool(n, nthreads, [&](int i, Scratch& s) {
    uint8_t* dst = out + plane * i;
    status[i] = read_file(paths + path_offsets[i], s.file)
                    ? png_decode_one(s.file.data(), s.file.size(), dst, out_h,
                                     out_w, s)
                    : kRead;
    if (status[i] != kOk) std::memset(dst, 0, plane);
    return status[i] == kOk;
  });
}

// The size in a PNG's IHDR (the first 33 bytes suffice): 0 on success, -1
// if data is not a PNG signature and IHDR, -2 on IHDR's CRC, -3 if zlib is
// not loaded.
int rxtpu_png_size(const uint8_t* data, int64_t len, int* height, int* width) {
  if (!codec_ready(0)) return -3;
  if (len < 33 || std::memcmp(data, kPngSignature, 8) != 0 ||
      be32(data + 8) != 13 || std::memcmp(data + 12, "IHDR", 4) != 0)
    return -1;
  if (z_crc32(0, data + 12, 17) != be32(data + 29)) return -2;
  *width = static_cast<int>(be32(data + 16));
  *height = static_cast<int>(be32(data + 20));
  return 0;
}

// Decompress n streams of any sizes: srcs[i] (src_lengths[i] bytes) into
// dsts[i] (dst_caps[i] bytes); out_lengths[i] gets the decompressed size,
// or -1 when the stream is corrupt or does not fit. Returns the failure
// count, or -1 if the codec is not loaded.
int rxtpu_inflate_each(const uint8_t* const* srcs, const int64_t* src_lengths, int n,
                       uint8_t* const* dsts, const int64_t* dst_caps, int64_t* out_lengths,
                       int codec, int nthreads) {
  if (!codec_ready(codec)) return -1;
  return run_pool(n, nthreads, [&](int i, Scratch&) {
    const size_t cap = static_cast<size_t>(dst_caps[i]);
    const size_t len = static_cast<size_t>(src_lengths[i]);
    bool ok;
    size_t got;
    if (codec == 1) {  // zstd tells an empty result from an error
      got = zstd_decompress(dsts[i], cap, srcs[i], len);
      ok = !zstd_is_error(got);
    } else {
      unsigned long dst_len = static_cast<unsigned long>(cap);
      ok = z_uncompress(dsts[i], &dst_len, srcs[i], static_cast<unsigned long>(len)) == 0;
      got = static_cast<size_t>(dst_len);
    }
    out_lengths[i] = ok ? static_cast<int64_t>(got) : -1;
    return ok;
  });
}

// Compress n buffers of any sizes at `level`: srcs[i] (src_lengths[i]
// bytes) into dsts[i] (dst_caps[i] bytes); out_lengths[i] gets the
// compressed size (0 on failure). Returns the failure count, or -1 if the
// codec is not loaded.
int rxtpu_compress_each(const uint8_t* const* srcs, const int64_t* src_lengths, int n,
                        uint8_t* const* dsts, const int64_t* dst_caps,
                        int64_t* out_lengths, int level, int codec, int nthreads) {
  if (!codec_ready(codec)) return -1;
  return run_pool(n, nthreads, [&](int i, Scratch&) {
    size_t got = compress_any(codec, dsts[i], static_cast<size_t>(dst_caps[i]), srcs[i],
                              static_cast<size_t>(src_lengths[i]), level);
    out_lengths[i] = static_cast<int64_t>(got);
    return got != 0;
  });
}

}  // extern "C"
