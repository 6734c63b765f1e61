// JPEG batch decoder and encoder on the card over nvJPEG: the port's JPEG
// input on a CUDA device.
//
// rxtpu decodes its grayscale JPEGs on the host with libjpeg in a
// std::thread pool (rxtpu/native/decoder.cpp: rxtpu_decode_batch,
// rxtpu_decode_files, rxtpu_encode_batch). The card's host has no libjpeg,
// so on the card the port decodes with the CUDA toolkit's nvJPEG straight
// into device memory. The pool keeps rxtpu's shape: `nthreads` host threads
// take images by an atomic counter, and each owns a hybrid decoder (the
// Huffman decode runs on its host thread, dequantization and IDCT on the
// card) with two pinned staging buffers and its own stream, so that one
// image's host phase overlaps the previous image's device phase (the
// decoupled-API pattern of NVIDIA's nvJPEG samples). Failed images are
// zero-filled and counted, as in rxtpu.
//
// What bounds it: the Huffman decode on the host threads; the card's part is
// a few small kernels per 512^2 plane. nvJPEG's IDCT is not libjpeg's
// JDCT_ISLOW, so its planes may differ slightly from rxtpu's; they are
// deterministic, and chip_smoke.py holds them, by a stated limit, to a
// reference that rxtpu's decode_batch made (tests/data/jpeg_ref).
//
// Streams: the calling thread's stream (PyTorch's current stream) is where
// the output was allocated. Every worker stream first waits on an event
// recorded there, so no write lands before the work already queued on it,
// and each worker synchronizes its stream before the call returns: the
// planes are complete when the call returns, as after rxtpu's host decode.
// Encode runs on the caller's stream. One mutex per context serializes
// calls.
//
// Build (rxtpu_torch/ops/_build.py, at first use):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC jpeg_nv.cu -o libjpeg_nv.so -lnvjpeg

#include <cuda_runtime.h>
#include <nvjpeg.h>

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <mutex>
#include <thread>
#include <vector>

namespace {

// Negative return codes name the failing layer: -(1000 + nvjpegStatus_t)
// or -(2000 + cudaError_t).
int nv_code(nvjpegStatus_t s) { return -(1000 + static_cast<int>(s)); }
int cu_code(cudaError_t e) { return -(2000 + static_cast<int>(e)); }

#define NV_TRY(x)                                        \
  do {                                                   \
    nvjpegStatus_t s_ = (x);                             \
    if (s_ != NVJPEG_STATUS_SUCCESS) return nv_code(s_); \
  } while (0)
#define CU_TRY(x)                              \
  do {                                         \
    cudaError_t e_ = (x);                      \
    if (e_ != cudaSuccess) return cu_code(e_); \
  } while (0)

struct Worker {
  nvjpegJpegDecoder_t decoder = nullptr;
  nvjpegJpegState_t state = nullptr;
  nvjpegBufferPinned_t pinned[2] = {nullptr, nullptr};
  nvjpegBufferDevice_t device_buf = nullptr;
  nvjpegJpegStream_t jstream[2] = {nullptr, nullptr};
  nvjpegDecodeParams_t params = nullptr;
  cudaStream_t stream = nullptr;
  std::vector<unsigned char> file;  // one file's bytes (decode_files)
  int slot = 0;                     // the pinned buffer of the next image
};

struct Context {
  int device = 0;
  nvjpegHandle_t handle = nullptr;
  std::vector<Worker> workers;
  cudaEvent_t ready = nullptr;
  nvjpegEncoderState_t enc_state = nullptr;
  nvjpegEncoderParams_t enc_params = nullptr;
  int enc_quality = -1;
  std::mutex mutex;
};

void destroy(Context* c) {
  for (Worker& w : c->workers) {
    if (w.params) nvjpegDecodeParamsDestroy(w.params);
    for (int b = 0; b < 2; ++b) {
      if (w.jstream[b]) nvjpegJpegStreamDestroy(w.jstream[b]);
    }
    if (w.state) nvjpegJpegStateDestroy(w.state);
    for (int b = 0; b < 2; ++b) {
      if (w.pinned[b]) nvjpegBufferPinnedDestroy(w.pinned[b]);
    }
    if (w.device_buf) nvjpegBufferDeviceDestroy(w.device_buf);
    if (w.decoder) nvjpegDecoderDestroy(w.decoder);
    if (w.stream) cudaStreamDestroy(w.stream);
  }
  if (c->enc_params) nvjpegEncoderParamsDestroy(c->enc_params);
  if (c->enc_state) nvjpegEncoderStateDestroy(c->enc_state);
  if (c->ready) cudaEventDestroy(c->ready);
  if (c->handle) nvjpegDestroy(c->handle);
  delete c;
}

int init_worker(Context* c, Worker& w) {
  NV_TRY(nvjpegDecoderCreate(c->handle, NVJPEG_BACKEND_HYBRID, &w.decoder));
  NV_TRY(nvjpegDecoderStateCreate(c->handle, w.decoder, &w.state));
  for (int b = 0; b < 2; ++b) {
    NV_TRY(nvjpegBufferPinnedCreate(c->handle, nullptr, &w.pinned[b]));
    NV_TRY(nvjpegJpegStreamCreate(c->handle, &w.jstream[b]));
  }
  NV_TRY(nvjpegBufferDeviceCreate(c->handle, nullptr, &w.device_buf));
  NV_TRY(nvjpegStateAttachDeviceBuffer(w.state, w.device_buf));
  NV_TRY(nvjpegDecodeParamsCreate(c->handle, &w.params));
  NV_TRY(nvjpegDecodeParamsSetOutputFormat(w.params, NVJPEG_OUTPUT_Y));
  CU_TRY(cudaStreamCreateWithFlags(&w.stream, cudaStreamNonBlocking));
  return 0;
}

// Decode one JPEG into the device plane dst[h*w]. 0 on success, 1 for a
// stream that does not decode to an h x w plane (the caller zero-fills and
// counts it), negative for a failure of the card or the library.
int decode_one(Context* c, Worker& w, const unsigned char* data, size_t len,
               unsigned char* dst, int h, int wd) {
  nvjpegJpegStream_t js = w.jstream[w.slot];
  if (len == 0 ||
      nvjpegJpegStreamParse(c->handle, data, len, 0, 0, js) != NVJPEG_STATUS_SUCCESS)
    return 1;
  unsigned int fw = 0, fh = 0;
  if (nvjpegJpegStreamGetFrameDimensions(js, &fw, &fh) != NVJPEG_STATUS_SUCCESS ||
      static_cast<int>(fw) != wd || static_cast<int>(fh) != h)
    return 1;
  NV_TRY(nvjpegStateAttachPinnedBuffer(w.state, w.pinned[w.slot]));
  if (nvjpegDecodeJpegHost(c->handle, w.decoder, w.state, w.params, js) !=
      NVJPEG_STATUS_SUCCESS)
    return 1;
  // the previous image's transfer read the other pinned buffer, and its
  // device phase used this state: both are done after this wait
  CU_TRY(cudaStreamSynchronize(w.stream));
  if (nvjpegDecodeJpegTransferToDevice(c->handle, w.decoder, w.state, js,
                                       w.stream) != NVJPEG_STATUS_SUCCESS)
    return 1;
  w.slot = 1 - w.slot;
  nvjpegImage_t out = {};
  out.channel[0] = dst;
  out.pitch[0] = static_cast<size_t>(wd);
  if (nvjpegDecodeJpegDevice(c->handle, w.decoder, w.state, &out, w.stream) !=
      NVJPEG_STATUS_SUCCESS)
    return 1;
  return 0;
}

// rxtpu's pool policy over the context's workers: nthreads <= 0 takes them
// all, never more threads than items. fn(i, worker) returns decode_one's
// code. Returns the failure count, or the first negative code.
template <typename F>
int run_pool(Context* c, int n, int nthreads, cudaStream_t caller, F&& fn) {
  if (n <= 0) return 0;
  const int size = static_cast<int>(c->workers.size());
  if (nthreads <= 0 || nthreads > size) nthreads = size;
  if (nthreads > n) nthreads = n;
  int prev = 0;
  CU_TRY(cudaGetDevice(&prev));
  CU_TRY(cudaSetDevice(c->device));
  cudaError_t rec = cudaEventRecord(c->ready, caller);
  cudaSetDevice(prev);
  if (rec != cudaSuccess) return cu_code(rec);
  std::atomic<int> next(0), failures(0), fatal(0);
  auto body = [&](int t) {
    Worker& w = c->workers[t];
    cudaError_t e = cudaSetDevice(c->device);
    if (e == cudaSuccess) e = cudaStreamWaitEvent(w.stream, c->ready, 0);
    if (e != cudaSuccess) {
      fatal.store(cu_code(e));
      return;
    }
    int i;
    while (fatal.load() == 0 && (i = next.fetch_add(1)) < n) {
      int rc = fn(i, w);
      if (rc < 0) {
        fatal.store(rc);
      } else if (rc > 0) {
        failures.fetch_add(1);
      }
    }
    e = cudaStreamSynchronize(w.stream);
    if (e != cudaSuccess) fatal.store(cu_code(e));
  };
  std::vector<std::thread> pool;
  pool.reserve(nthreads);
  for (int t = 0; t < nthreads; ++t) pool.emplace_back(body, t);
  for (auto& th : pool) th.join();
  return fatal.load() != 0 ? fatal.load() : failures.load();
}

// A decode that failed after its device phase was queued may have written
// part of the plane: zero it on the worker's stream, behind that work.
int zero_fill(Worker& w, unsigned char* dst, size_t plane) {
  CU_TRY(cudaMemsetAsync(dst, 0, plane, w.stream));
  return 1;
}

}  // namespace

extern "C" {

// nvJPEG's version, through the library.
int rxtpu_nvjpeg_version(int* major, int* minor, int* patch) {
  NV_TRY(nvjpegGetProperty(MAJOR_VERSION, major));
  NV_TRY(nvjpegGetProperty(MINOR_VERSION, minor));
  NV_TRY(nvjpegGetProperty(PATCH_LEVEL, patch));
  return 0;
}

// A context on `device` with n_workers decoders. *out receives it.
int rxtpu_nvjpeg_create(int device, int n_workers, void** out) {
  if (n_workers < 1) n_workers = 1;
  int prev = 0;
  CU_TRY(cudaGetDevice(&prev));
  CU_TRY(cudaSetDevice(device));
  Context* c = new Context();
  c->device = device;
  c->workers.resize(static_cast<size_t>(n_workers));
  int rc = 0;
  nvjpegStatus_t s = nvjpegCreateEx(NVJPEG_BACKEND_DEFAULT, nullptr, nullptr, 0,
                                    &c->handle);
  if (s != NVJPEG_STATUS_SUCCESS) rc = nv_code(s);
  if (rc == 0) {
    cudaError_t e = cudaEventCreateWithFlags(&c->ready, cudaEventDisableTiming);
    if (e != cudaSuccess) rc = cu_code(e);
  }
  for (Worker& w : c->workers) {
    if (rc == 0) rc = init_worker(c, w);
  }
  cudaSetDevice(prev);
  if (rc != 0) {
    destroy(c);
    return rc;
  }
  *out = c;
  return 0;
}

// Decode n grayscale JPEGs (host bytes, concatenated in `data` at
// offsets/lengths) into the device array out[n, out_h, out_w]. Returns the
// number of failures (zero-filled slots), or a negative code.
int rxtpu_nvjpeg_decode_batch(void* ctx, const uint8_t* data,
                              const int64_t* offsets, const int64_t* lengths,
                              int n, uint8_t* out, int out_h, int out_w,
                              int nthreads, void* stream) {
  Context* c = static_cast<Context*>(ctx);
  std::lock_guard<std::mutex> lock(c->mutex);
  const size_t plane = static_cast<size_t>(out_h) * out_w;
  return run_pool(c, n, nthreads, static_cast<cudaStream_t>(stream),
                  [&](int i, Worker& w) {
    unsigned char* dst = out + plane * i;
    int rc = decode_one(c, w, data + offsets[i], static_cast<size_t>(lengths[i]),
                        dst, out_h, out_w);
    return rc > 0 ? zero_fill(w, dst, plane) : rc;
  });
}

// Read and decode n grayscale JPEG files (paths = concatenated NUL-terminated
// strings) into the device array out[n, out_h, out_w], the reads inside the
// pool. Returns the failure count, or a negative code.
int rxtpu_nvjpeg_decode_files(void* ctx, const char* paths,
                              const int64_t* path_offsets, int n, uint8_t* out,
                              int out_h, int out_w, int nthreads, void* stream) {
  Context* c = static_cast<Context*>(ctx);
  std::lock_guard<std::mutex> lock(c->mutex);
  const size_t plane = static_cast<size_t>(out_h) * out_w;
  return run_pool(c, n, nthreads, static_cast<cudaStream_t>(stream),
                  [&](int i, Worker& w) {
    unsigned char* dst = out + plane * i;
    FILE* f = fopen(paths + path_offsets[i], "rb");
    bool read = false;
    if (f) {
      fseek(f, 0, SEEK_END);
      long sz = ftell(f);
      fseek(f, 0, SEEK_SET);
      if (sz > 0) {
        w.file.resize(static_cast<size_t>(sz));
        read = fread(w.file.data(), 1, static_cast<size_t>(sz), f) ==
               static_cast<size_t>(sz);
      }
      fclose(f);
    }
    int rc = read ? decode_one(c, w, w.file.data(), w.file.size(), dst, out_h,
                               out_w)
                  : 1;
    return rc > 0 ? zero_fill(w, dst, plane) : rc;
  });
}

// Encode n grayscale device planes in[n, h, w] at quality q, on the caller's
// stream, into host slots out + i*cap; out_lengths[i] gets the encoded size
// (0 on overflow). Returns the number of failures, or a negative code.
int rxtpu_nvjpeg_encode_batch(void* ctx, const uint8_t* in, int n, int h,
                              int w, int quality, uint8_t* out, int64_t cap,
                              int64_t* out_lengths, void* stream) {
  Context* c = static_cast<Context*>(ctx);
  std::lock_guard<std::mutex> lock(c->mutex);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int prev = 0;
  CU_TRY(cudaGetDevice(&prev));
  CU_TRY(cudaSetDevice(c->device));
  int rc = 0, failures = 0;
  auto step = [&]() -> int {
    if (c->enc_state == nullptr) {
      NV_TRY(nvjpegEncoderStateCreate(c->handle, &c->enc_state, st));
      NV_TRY(nvjpegEncoderParamsCreate(c->handle, &c->enc_params, st));
      NV_TRY(nvjpegEncoderParamsSetSamplingFactors(c->enc_params, NVJPEG_CSS_GRAY, st));
    }
    if (c->enc_quality != quality) {
      NV_TRY(nvjpegEncoderParamsSetQuality(c->enc_params, quality, st));
      c->enc_quality = quality;
    }
    const size_t plane = static_cast<size_t>(h) * w;
    for (int i = 0; i < n; ++i) {
      nvjpegImage_t src = {};
      src.channel[0] = const_cast<unsigned char*>(in + plane * i);
      src.pitch[0] = static_cast<size_t>(w);
      NV_TRY(nvjpegEncodeYUV(c->handle, c->enc_state, c->enc_params, &src,
                             NVJPEG_CSS_GRAY, w, h, st));
      size_t len = 0;
      NV_TRY(nvjpegEncodeRetrieveBitstream(c->handle, c->enc_state, nullptr, &len, st));
      CU_TRY(cudaStreamSynchronize(st));
      if (static_cast<int64_t>(len) > cap) {
        out_lengths[i] = 0;
        ++failures;
        continue;
      }
      NV_TRY(nvjpegEncodeRetrieveBitstream(c->handle, c->enc_state,
                                           out + static_cast<size_t>(cap) * i,
                                           &len, st));
      CU_TRY(cudaStreamSynchronize(st));
      out_lengths[i] = static_cast<int64_t>(len);
    }
    return 0;
  };
  rc = step();
  cudaSetDevice(prev);
  return rc != 0 ? rc : failures;
}

// Read only the header of one JPEG (host bytes): *height and *width. 0 on
// success, negative otherwise.
int rxtpu_nvjpeg_size(void* ctx, const uint8_t* data, int64_t len, int* height,
                      int* width) {
  Context* c = static_cast<Context*>(ctx);
  int n_comp = 0;
  nvjpegChromaSubsampling_t ss;
  int widths[NVJPEG_MAX_COMPONENT] = {0}, heights[NVJPEG_MAX_COMPONENT] = {0};
  NV_TRY(nvjpegGetImageInfo(c->handle, data, static_cast<size_t>(len), &n_comp,
                            &ss, widths, heights));
  *height = heights[0];
  *width = widths[0];
  return 0;
}

}  // extern "C"
