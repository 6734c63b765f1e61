// K5: the fused eval stem. Center crop + per-(view, channel) normalize +
// zero pad 3 + conv 7x7/2 (bf16 operands, f32 sums) + folded-BN bias + ReLU +
// max pool 3x3/2 (pad 1), from raw uint8 planes to the pooled maps, in one
// pass per tile.
//
// Replaces rxtpu/ops/fused_stem.py:_stem_kernel (the Pallas TPU kernel behind
// fused_stem, used by the eval and predict steps with fused_stem=True).
//
// out[n, m, p, q] = max over the 3x3/2 window (pad 1) of
//   relu(conv_bias[m] + sum_{c, ky, kx} w[m, c, ky, kx] * x[n, c, 2r-3+ky, 2s-3+kx])
// with x = bf16(x_u8 * scale[n, c] + bias[n, c]) on the crop and 0 outside it
// (the pad comes after the normalize).
//
// Bound: operations. Each conv output is 294 multiply-adds; at the validation
// shape (N = 48 views, crop 364: 48 x 64 x 182^2 outputs) that is 59.8 GFLOP,
// 0.0605 ms at the bf16 tensor-core rate of 989 TFLOP/s, against 89.0 MB
// (0.0266 ms at 3.35 TB/s) of uint8 crop in and bf16 maps out; at the test
// shape (N = 96, no crop, 64 x 256^2 conv outputs) 236.8 GFLOP, 0.2394 ms,
// against 352.3 MB (0.105 ms). This first kernel runs the products on the
// CUDA cores in f32, whose rate (67 TFLOP/s) puts the same work at 0.89 ms
// and 3.53 ms; mma.sync / wgmma on an im2col tile in shared memory is the way
// to the first pair.
//
// Design: one block per (view, 8x8 tile of pooled outputs). The block stages
// the 39x39 source window of its 17x17 conv outputs, all 6 channels, in
// shared memory after the crop, the normalize, the zero mask and the bf16
// rounding, stored as f32 with even and odd columns apart, so that the
// stride-2 reads of a warp fall on consecutive words. The weights go in as
// f32 [tap][channel] (75 KB): one float4 load serves four channels to the
// whole warp. Each thread holds 16 channels x 5 conv outputs in registers and
// runs the 294 taps in (c, ky, kx) order. The conv rows and columns at the
// tile's edge are recomputed by the neighbouring tile. After the taps the
// ReLU'd sums go to shared memory (over the staged inputs and weights) and
// each pooled output is the max of its 3x3 window. Conv positions outside the
// image count as 0 in the pool: the ReLU makes every real value >= 0 and each
// window holds at least one real value, so this equals the -inf padding.
//
// Rounding matches the plain PyTorch version: the normalize rounds the
// product and the sum separately (__fmul_rn / __fadd_rn), then to bf16 by
// nearest even; a bf16 x bf16 product is exact in f32, so only the order of
// the 294 f32 additions differs from the plain version's convolution.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kC = 6;                    // input channels
constexpr int kM = 64;                   // output channels
constexpr int kTaps = kC * 49;           // 294
constexpr int kTP = 8;                   // pooled rows (and columns) per tile
constexpr int kCR = 2 * kTP + 1;         // conv rows (and columns) per tile: 17
constexpr int kCPix = kCR * kCR;         // 289 conv outputs per channel
constexpr int kIn = 4 * kTP + 7;         // staged source rows (and columns): 39
constexpr int kHalf = (kIn + 1) / 2;     // 20 even columns, then the 19 odd ones
constexpr int kPitch = 2 * kHalf;        // floats per staged row
constexpr int kThreads = 256;
constexpr int kMaxDevices = 64;
constexpr int kChan = 16;                // channels per thread
constexpr int kGroups = kM / kChan;      // 4 channel groups, two warps each
constexpr int kPixThreads = kThreads / kGroups;                   // 64
constexpr int kSlots = (kCPix + kPixThreads - 1) / kPixThreads;  // 5 conv outputs per thread

constexpr int kInBytes = kC * kIn * kPitch * 4;      // 37,440
constexpr int kRawBytes = kM * kTaps * 2;            // 37,632: the bf16 weights as given
constexpr int kRegionA = kInBytes > kRawBytes ? kInBytes : kRawBytes;
constexpr int kWBytes = kTaps * kM * 4;              // 75,264
constexpr int kSmem = kRegionA + kWBytes;            // 112,896: two blocks per SM
static_assert(kRegionA % 16 == 0, "the weights must start 16-byte aligned");
static_assert(kM * kCPix * 4 <= kSmem, "the conv outputs must fit over the staged data");

template <typename OutT> __device__ __forceinline__ OutT convert(float x);
template <> __device__ __forceinline__ __nv_bfloat16 convert<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ float convert<float>(float x) { return x; }

template <typename OutT>
__global__ void __launch_bounds__(kThreads, 2)
fused_stem_kernel(const uint8_t* __restrict__ img, const float* __restrict__ scale,
                  const float* __restrict__ bias, const __nv_bfloat16* __restrict__ weight,
                  const float* __restrict__ conv_bias, OutT* __restrict__ out, int h,
                  int w, int offset, int crop, int conv_o, int pool_o, int tiles_x) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* in_s = reinterpret_cast<float*>(smem);                     // [c][row][even|odd col]
  __nv_bfloat16* raw_s = reinterpret_cast<__nv_bfloat16*>(smem);    // [m][tap], first
  float* w_s = reinterpret_cast<float*>(smem + kRegionA);           // [tap][m]
  float* conv_s = reinterpret_cast<float*>(smem);                   // [m][pixel], last

  const int n = blockIdx.y;
  const int py0 = static_cast<int>(blockIdx.x) / tiles_x * kTP;
  const int px0 = static_cast<int>(blockIdx.x) % tiles_x * kTP;
  const int tid = threadIdx.x;

  // weights: a coalesced copy of the bf16 [m][tap] rows, then the transpose
  // to f32 [tap][m] (the reads stride 147 words: no bank conflicts)
  for (int i = tid; i < kM * kTaps; i += kThreads) raw_s[i] = weight[i];
  __syncthreads();
  for (int i = tid; i < kM * kTaps; i += kThreads) {
    w_s[i] = __bfloat162float(raw_s[(i % kM) * kTaps + i / kM]);
  }
  __syncthreads();

  // source window: crop coordinates (4*py0 - 5, 4*px0 - 5) onward
  const int y0 = 4 * py0 - 5, x0 = 4 * px0 - 5;
  for (int i = tid; i < kC * kIn * kIn; i += kThreads) {
    const int c = i / (kIn * kIn);
    const int r = i / kIn % kIn;
    const int col = i % kIn;
    const int y = y0 + r, x = x0 + col;
    float v = 0.0f;
    if (y >= 0 && y < crop && x >= 0 && x < crop) {
      const int nc = n * kC + c;
      const uint8_t p = img[(static_cast<int64_t>(nc) * h + offset + y) * w + offset + x];
      v = __bfloat162float(__float2bfloat16_rn(
          __fadd_rn(__fmul_rn(static_cast<float>(p), scale[nc]), bias[nc])));
    }
    in_s[(c * kIn + r) * kPitch + (col & 1) * kHalf + (col >> 1)] = v;
  }
  __syncthreads();

  // conv: channels [16 g, 16 g + 16) at conv positions pt + 64 k of the tile
  const int g = tid / kPixThreads;   // the same for a whole warp
  const int pt = tid % kPixThreads;
  int base[kSlots];
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int l = min(pt + k * kPixThreads, kCPix - 1);  // spare slots repeat the last
    base[k] = 2 * (l / kCR) * kPitch + l % kCR;
  }
  float acc[kChan][kSlots];
#pragma unroll
  for (int j = 0; j < kChan; ++j) {
#pragma unroll
    for (int k = 0; k < kSlots; ++k) acc[j][k] = 0.0f;
  }
  const float* wg = w_s + g * kChan;
  for (int c = 0; c < kC; ++c) {
    for (int ky = 0; ky < 7; ++ky) {
      const float* row = in_s + (c * kIn + ky) * kPitch;
      const float* wt = wg + (c * 7 + ky) * 7 * kM;
#pragma unroll
      for (int kx = 0; kx < 7; ++kx) {
        float wv[kChan];
#pragma unroll
        for (int q = 0; q < kChan / 4; ++q) {
          const float4 w4 = *reinterpret_cast<const float4*>(wt + kx * kM + 4 * q);
          wv[4 * q] = w4.x;
          wv[4 * q + 1] = w4.y;
          wv[4 * q + 2] = w4.z;
          wv[4 * q + 3] = w4.w;
        }
        const int coff = (kx & 1) * kHalf + (kx >> 1);
        float xv[kSlots];
#pragma unroll
        for (int k = 0; k < kSlots; ++k) xv[k] = row[base[k] + coff];
#pragma unroll
        for (int j = 0; j < kChan; ++j) {
#pragma unroll
          for (int k = 0; k < kSlots; ++k) acc[j][k] = fmaf(wv[j], xv[k], acc[j][k]);
        }
      }
    }
  }
  __syncthreads();  // every thread is done with the staged inputs and weights

  // bias + ReLU into shared memory; positions outside the conv output are 0
  const int cr0 = 2 * py0 - 1, cc0 = 2 * px0 - 1;
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int l = pt + k * kPixThreads;
    if (l < kCPix) {
      const int r = cr0 + l / kCR, s = cc0 + l % kCR;
      const bool inside = r >= 0 && r < conv_o && s >= 0 && s < conv_o;
#pragma unroll
      for (int j = 0; j < kChan; ++j) {
        const int m = g * kChan + j;
        const float v = fmaxf(__fadd_rn(acc[j][k], conv_bias[m]), 0.0f);
        conv_s[m * kCPix + l] = inside ? v : 0.0f;
      }
    }
  }
  __syncthreads();

  // max pool 3x3/2: pooled (py, px) of the tile reads conv rows/cols 2py..2py+2
  for (int i = tid; i < kM * kTP * kTP; i += kThreads) {
    const int m = i / (kTP * kTP);
    const int py = i / kTP % kTP, px = i % kTP;
    const int oy = py0 + py, ox = px0 + px;
    if (oy >= pool_o || ox >= pool_o) continue;
    const float* cs = conv_s + m * kCPix + 2 * py * kCR + 2 * px;
    float v = cs[0];
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) v = fmaxf(v, cs[dy * kCR + dx]);
    }
    out[(static_cast<int64_t>(n * kM + m) * pool_o + oy) * pool_o + ox] = convert<OutT>(v);
  }
}

template <typename OutT>
int launch(const uint8_t* img, const float* scale, const float* bias,
           const __nv_bfloat16* weight, const float* conv_bias, void* out, int n, int h,
           int w, int offset, int crop, cudaStream_t stream) {
  const int conv_o = (crop - 1) / 2 + 1;   // (crop + 2*3 - 7) / 2 + 1
  const int pool_o = (conv_o - 1) / 2 + 1;  // (conv + 2*1 - 3) / 2 + 1
  const int tiles = (pool_o + kTP - 1) / kTP;
  // the shared-memory limit is set once per device and output type
  static bool smem_set[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!smem_set[dev]) {
    err = cudaFuncSetAttribute(fused_stem_kernel<OutT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set[dev] = true;
  }
  const dim3 grid(tiles * tiles, n);
  fused_stem_kernel<OutT><<<grid, kThreads, kSmem, stream>>>(
      img, scale, bias, weight, conv_bias, static_cast<OutT*>(out), h, w, offset, crop,
      conv_o, pool_o, tiles);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// images uint8 [n, 6, h, w]; scale, bias f32 [n, 6]; weight bf16 [64, 294]
// ((c, ky, kx) order); conv_bias f32 [64]; out [n, 64, po, po], out_kind 0 =
// bf16, 2 = f32. Returns cudaGetLastError() after the launch (0 = cudaSuccess);
// an unknown out_kind returns cudaErrorInvalidValue.
extern "C" int rxtpu_fused_stem(const void* images, const void* scale, const void* bias,
                                const void* weight, const void* conv_bias, void* out, int n,
                                int h, int w, int offset, int crop, int out_kind,
                                void* stream) {
  const uint8_t* img = static_cast<const uint8_t*>(images);
  const float* s = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(bias);
  const __nv_bfloat16* wt = static_cast<const __nv_bfloat16*>(weight);
  const float* cb = static_cast<const float*>(conv_bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n == 0) return static_cast<int>(cudaSuccess);
  switch (out_kind) {
    case 0: return launch<__nv_bfloat16>(img, s, b, wt, cb, out, n, h, w, offset, crop, st);
    case 2: return launch<float>(img, s, b, wt, cb, out, n, h, w, offset, crop, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
