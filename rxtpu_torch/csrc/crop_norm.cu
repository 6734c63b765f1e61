// K1: fused center-crop + dequantize + per-plane normalize + cast.
//
// Replaces rxtpu/ops/pallas_norm.py:_crop_norm_kernel (the Pallas TPU kernel
// behind crop_normalize / eval_batch_normalize, the val and test normalize).
//
// out[n, i, j] = cast(float(in[n, offset + i, offset + j]) * scale[n] + bias[n])
//
// Bound: bytes. Each uint8 input byte is read once and each output element
// written once; the arithmetic is one multiply and one add per pixel. At the
// test-phase shape (N = 16*6*6 = 576 planes, 512^2, no crop) that is 151.0 MB
// in + 302.0 MB of bf16 out = 453 MB, 135 us at 3.35 TB/s; at the 364 crop
// 76.3 MB in + 152.6 MB out, 68 us.
//
// Design: a 2-D grid of (plane, tile of ROWS output rows). scale/bias are read
// once per plane by each thread. Each thread converts VEC consecutive pixels
// of a row: consecutive threads read consecutive bytes, and when the crop is a
// multiple of VEC the VEC outputs leave in one vector store (8 bytes for bf16).
//
// Rounding matches the plain PyTorch version bit for bit: the product and the
// sum are rounded separately (__fmul_rn / __fadd_rn, never contracted into an
// FMA), bf16 rounds to nearest even, and int8 rounds half to even (rintf, like
// jnp.round; roundf would round half away from zero) before the clamp to +-127.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 8;
constexpr int kVec = 4;

template <int Bytes> struct VecType;
template <> struct VecType<4> { using T = uint32_t; };
template <> struct VecType<8> { using T = uint2; };
template <> struct VecType<16> { using T = uint4; };

// VEC outputs of one thread, aligned for a single vector store.
template <typename OutT> struct alignas(sizeof(OutT) * kVec) Pack {
  OutT v[kVec];
};

template <typename OutT> __device__ __forceinline__ OutT convert(float x);

template <> __device__ __forceinline__ __nv_bfloat16 convert<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <> __device__ __forceinline__ float convert<float>(float x) { return x; }

template <> __device__ __forceinline__ int8_t convert<int8_t>(float x) {
  return static_cast<int8_t>(fminf(fmaxf(rintf(x), -127.0f), 127.0f));
}

template <typename OutT, bool kVecStore>
__global__ void __launch_bounds__(kThreads)
crop_norm_kernel(const uint8_t* __restrict__ in, const float* __restrict__ scale,
                 const float* __restrict__ bias, OutT* __restrict__ out, int h,
                 int w, int offset, int crop) {
  const int n = blockIdx.x;
  const float s = scale[n];
  const float b = bias[n];
  const uint8_t* src = in + static_cast<int64_t>(n) * h * w +
                       static_cast<int64_t>(offset) * w + offset;
  OutT* dst = out + static_cast<int64_t>(n) * crop * crop;
  const int row0 = static_cast<int>(blockIdx.y) * kRows;
  const int row_end = min(crop, row0 + kRows);
  for (int i = row0; i < row_end; ++i) {
    const uint8_t* src_row = src + static_cast<int64_t>(i) * w;
    OutT* dst_row = dst + static_cast<int64_t>(i) * crop;
    for (int j0 = static_cast<int>(threadIdx.x) * kVec; j0 < crop;
         j0 += kThreads * kVec) {
      Pack<OutT> p;
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const int j = min(j0 + k, crop - 1);  // clamped; the tail store masks
        p.v[k] = convert<OutT>(
            __fadd_rn(__fmul_rn(static_cast<float>(src_row[j]), s), b));
      }
      if (kVecStore) {
        using V = typename VecType<sizeof(OutT) * kVec>::T;
        *reinterpret_cast<V*>(dst_row + j0) = *reinterpret_cast<const V*>(&p);
      } else {
#pragma unroll
        for (int k = 0; k < kVec; ++k) {
          if (j0 + k < crop) dst_row[j0 + k] = p.v[k];
        }
      }
    }
  }
}

template <typename OutT>
void launch(const uint8_t* in, const float* scale, const float* bias, void* out,
            int n, int h, int w, int offset, int crop, cudaStream_t stream) {
  const dim3 grid(n, (crop + kRows - 1) / kRows);
  OutT* o = static_cast<OutT*>(out);
  if (crop % kVec == 0) {
    crop_norm_kernel<OutT, true><<<grid, kThreads, 0, stream>>>(
        in, scale, bias, o, h, w, offset, crop);
  } else {
    crop_norm_kernel<OutT, false><<<grid, kThreads, 0, stream>>>(
        in, scale, bias, o, h, w, offset, crop);
  }
}

}  // namespace

// out_kind: 0 = bf16, 1 = int8, 2 = f32. Returns cudaGetLastError() after the
// launch (0 = cudaSuccess); an unknown out_kind returns cudaErrorInvalidValue.
extern "C" int rxtpu_crop_norm(const void* in, const void* scale, const void* bias,
                               void* out, int n, int h, int w, int offset, int crop,
                               int out_kind, void* stream) {
  const uint8_t* src = static_cast<const uint8_t*>(in);
  const float* s = static_cast<const float*>(scale);
  const float* b = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n == 0 || crop == 0) return static_cast<int>(cudaSuccess);
  switch (out_kind) {
    case 0: launch<__nv_bfloat16>(src, s, b, out, n, h, w, offset, crop, st); break;
    case 1: launch<int8_t>(src, s, b, out, n, h, w, offset, crop, st); break;
    case 2: launch<float>(src, s, b, out, n, h, w, offset, crop, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
