// K2-K4: the three shear passes of the train augmentation (Paeth rotation
// R(phi) = Sx(a) . Sy(b) . Sx(a), crop offsets folded into the shifts).
//
// Replaces rxtpu/ops/shear.py:
//   K2 _shear_kernel        (shear_pass,        pass 1 and the v1 pipeline)
//   K3 _shear_rows_kernel   (shear_pass_rows,   pass 2)
//   K4 _shear_finish_kernel (shear_pass_finish, pass 3 + normalize + reversal)
//
// Each output element is a lerp of two neighbours of a reflect-101 padded
// row (K2, K4) or column (K3):
//   out[p, r, j] = (1 - f) * xp[k + j] + f * xp[k + j + 1]
// with xp the padded line, xp[t] = x[reflect101(t - pad)], and the integer
// shift k (already clamped to [0, kmax]) and fraction f per row (K2, K4) or
// per column (K3). The wrapper computes k and f once in torch
// (rxtpu_torch/ops/shear.py); the kernel and the plain version receive the
// same arrays. The Pallas kernels' barrel of rolls, antidiagonal-matmul
// reflect pads, J-matmul reversal and 128-lane padding are TPU workarounds:
// here each output reads its clamped reflect-101 index directly.
//
// Bound: bytes. Each does ~4 f32 operations per output (6 with the
// normalize). At the main-path shapes (P = 16*3*6 = 288 planes, 512^2
// sources, crop 364), counting k and f:
//   K2: uint8 [288,512,512] in (75.5 MB), f32 [288,512,512] out (302.0 MB)
//   K3: f32 [288,512,512] in (302.0 MB), f32 [288,364,512] out (214.7 MB)
//   K4: f32 [288,364,512] in (214.7 MB), bf16 [288,364,364] out (76.3 MB)
// about 113, 155 and 87 us at 3.35 TB/s.
//
// Design:
// - K2: a block per (plane, tile of kRows rows). For each row the block
//   stages the w_out + 1 source values it needs in shared memory, folding
//   the reflect-101 border as it loads (consecutive threads read consecutive
//   source addresses), then each thread writes kVec neighbouring outputs with
//   one vector store (a masked tail when w_out is not a multiple of kVec).
// - K4: a warp per output row, kRowWarpsX rows per block, and no block
//   barrier (K2's staged design held K4 to 40% of its bound: two barriers
//   per row, a few loads in flight per thread between them, 91 of 128
//   threads busy). After the fold one row's reads are one run of w_out + 1
//   floats: each lane reads the kVec + 1 it needs for kVec neighbouring
//   outputs straight from global memory (L1 serves the overlap), for all its
//   kUnroll chunks of the row before any arithmetic, so kUnroll * (kVec + 1)
//   loads are in flight per lane; then one vector store per chunk. Row
//   reversal picks the destination row, column reversal mirrors the chunk
//   and the order of its outputs.
// - K3: a block per (plane, 32 columns, 64 output rows). Each column reads
//   its own run of source rows, offset by its k, so a warp reading one output
//   row directly touches up to 32 different rows. Instead the block stages
//   the span of padded rows its columns need (64 + max k - min k + 1 rows;
//   at most 88 on the main path, where |dk/dcolumn| <= sin 45deg) in shared
//   memory, one coalesced 128-byte row per warp load, reflect-101 folded on
//   the row index; then each warp writes whole output rows (coalesced), lane
//   = column, reading the tile without bank conflicts. A block whose shifts
//   vary faster than the tile holds reads its rows directly instead.
//
// Rounding matches the plain PyTorch version bit for bit: every product and
// sum is rounded on its own (__fmul_rn / __fadd_rn, never contracted into an
// FMA), uint8 -> f32 is exact and bf16 rounds to nearest even.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;     // K2
constexpr int kRows = 4;          // K2: rows of one plane per block
constexpr int kVec = 4;           // K2, K4: outputs per thread and store
constexpr int kRowWarpsX = 8;     // K4: warps (output rows) per block
constexpr int kUnroll = 3;        // K4: chunks of kVec outputs per lane per pass
constexpr int kColTile = 32;      // K3: columns per block, one per lane
constexpr int kRowWarps = 8;      // K3: warps per block
constexpr int kRowTile = 64;      // K3: output rows per block
constexpr int kSpanMax = 128;     // K3: staged padded rows per block

template <int Bytes> struct VecType;
template <> struct VecType<8> { using T = uint2; };
template <> struct VecType<16> { using T = uint4; };

template <typename OutT> struct alignas(sizeof(OutT) * kVec) Pack {
  OutT v[kVec];
};

template <typename OutT> __device__ __forceinline__ OutT convert(float x);
template <> __device__ __forceinline__ float convert<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 convert<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// OpenCV BORDER_REFLECT_101 with a single mirror: the wrapper keeps both
// pads below n - 1, so one fold reaches every index the kernels read.
__device__ __forceinline__ int reflect101(int i, int n) {
  i = i < 0 ? -i : i;
  return i >= n ? 2 * (n - 1) - i : i;
}

// (1 - f) * x + f * n with every operation rounded separately
__device__ __forceinline__ float lerp_rn(float x, float n, float f) {
  return __fadd_rn(__fmul_rn(x, __fsub_rn(1.0f, f)), __fmul_rn(n, f));
}

// kVec outputs at dst_row[j0..]: one vector store, or element by element up
// to w_out when w_out is not a multiple of kVec (rows not aligned)
template <typename OutT, bool kVecStore>
__device__ __forceinline__ void store(OutT* dst_row, int j0, int w_out, const Pack<OutT>& pk) {
  if (kVecStore) {
    using V = typename VecType<sizeof(OutT) * kVec>::T;
    *reinterpret_cast<V*>(dst_row + j0) = *reinterpret_cast<const V*>(&pk);
  } else {
#pragma unroll
    for (int v = 0; v < kVec; ++v) {
      if (j0 + v < w_out) dst_row[j0 + v] = pk.v[v];
    }
  }
}

// K2: per-row shift along W.
template <typename InT, typename OutT, bool kVecStore>
__global__ void __launch_bounds__(kThreads)
shear_x_kernel(const InT* __restrict__ in, const int32_t* __restrict__ kk,
               const float* __restrict__ ff, const float* __restrict__ scale,
               const float* __restrict__ bias, OutT* __restrict__ out, int h, int w,
               int w_out, int pad_left) {
  extern __shared__ float row[];  // w_out + 1 staged source values
  const int p = blockIdx.x;
  const float s = scale[p];
  const float b = bias[p];
  const InT* src = in + static_cast<int64_t>(p) * h * w;
  OutT* dst = out + static_cast<int64_t>(p) * h * w_out;
  const int r0 = static_cast<int>(blockIdx.y) * kRows;
  const int r1 = min(h, r0 + kRows);
  for (int r = r0; r < r1; ++r) {
    const int64_t line = static_cast<int64_t>(p) * h + r;
    const int k = kk[line];
    const float f = ff[line];
    const InT* src_row = src + static_cast<int64_t>(r) * w;
    for (int t = threadIdx.x; t <= w_out; t += kThreads) {
      row[t] = static_cast<float>(src_row[reflect101(k + t - pad_left, w)]);
    }
    __syncthreads();
    OutT* dst_row = dst + static_cast<int64_t>(r) * w_out;
    for (int j0 = static_cast<int>(threadIdx.x) * kVec; j0 < w_out;
         j0 += kThreads * kVec) {
      Pack<OutT> pk;
#pragma unroll
      for (int v = 0; v < kVec; ++v) {
        const int j = min(j0 + v, w_out - 1);  // clamped; the tail store masks
        const float y = lerp_rn(row[j], row[j + 1], f);
        pk.v[v] = convert<OutT>(__fadd_rn(__fmul_rn(y, s), b));
      }
      store<OutT, kVecStore>(dst_row, j0, w_out, pk);
    }
    __syncthreads();  // the next row overwrites the staged values
  }
}

// K4: per-row shift along W of f32 rows, normalize, row / column reversal.
// Warp `warp` of block `blockIdx.x` writes the output of source row
// kRowWarpsX * blockIdx.x + warp of the p * h rows (plane-major).
template <typename OutT, bool kVecStore>
__global__ void __launch_bounds__(32 * kRowWarpsX)
shear_finish_kernel(const float* __restrict__ in, const int32_t* __restrict__ kk,
                    const float* __restrict__ ff, const float* __restrict__ scale,
                    const float* __restrict__ bias, const uint8_t* __restrict__ rrev,
                    const uint8_t* __restrict__ crev, OutT* __restrict__ out, int p_count,
                    int h, int w, int w_out, int pad_left) {
  const int lane = static_cast<int>(threadIdx.x) % 32;
  const int64_t line = static_cast<int64_t>(blockIdx.x) * kRowWarpsX + threadIdx.x / 32;
  if (line >= static_cast<int64_t>(p_count) * h) return;
  const int p = static_cast<int>(line / h), r = static_cast<int>(line % h);
  const int k = kk[line];
  const float f = ff[line];
  const float s = scale[p];
  const float b = bias[p];
  const bool rev_cols = crev[p] != 0;
  const float* src_row = in + line * w;
  OutT* dst_row = out + (static_cast<int64_t>(p) * h + (rrev[p] != 0 ? h - 1 - r : r)) * w_out;
  const int chunks = (w_out + kVec - 1) / kVec;
  for (int c0 = lane; c0 < chunks; c0 += 32 * kUnroll) {
    // every load of the pass first: chunk j0's window is padded indices
    // lo .. lo + kVec, clamped into the row's w_out + 1 (a clamped index
    // feeds only outputs past w_out, which the store masks)
    float x[kUnroll][kVec + 1];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j0 = (c0 + 32 * u) * kVec;
      const int lo = rev_cols ? w_out - kVec - j0 : j0;
#pragma unroll
      for (int v = 0; v <= kVec; ++v) {
        const int t = min(max(lo + v, 0), w_out);
        x[u][v] = __ldg(src_row + reflect101(k + t - pad_left, w));
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j0 = (c0 + 32 * u) * kVec;
      if (j0 < w_out) {
        Pack<OutT> pk;
#pragma unroll
        for (int v = 0; v < kVec; ++v) {
          // reversed, output j0 + v reads padded w_out - 1 - (j0 + v) = lo + kVec - 1 - v
          // (both indices constant, so x stays in registers)
          const float x0 = rev_cols ? x[u][kVec - 1 - v] : x[u][v];
          const float x1 = rev_cols ? x[u][kVec - v] : x[u][v + 1];
          const float y = lerp_rn(x0, x1, f);
          pk.v[v] = convert<OutT>(__fadd_rn(__fmul_rn(y, s), b));
        }
        store<OutT, kVecStore>(dst_row, j0, w_out, pk);
      }
    }
  }
}

// K3: per-column shift along H.
template <typename OutT>
__global__ void __launch_bounds__(kColTile * kRowWarps)
shear_y_kernel(const float* __restrict__ in, const int32_t* __restrict__ kk,
               const float* __restrict__ ff, OutT* __restrict__ out, int h, int w,
               int h_out, int pad_top) {
  __shared__ float tile[kSpanMax][kColTile];
  __shared__ int span[2];  // first staged padded row, number of rows
  const int p = blockIdx.x;
  const int lane = static_cast<int>(threadIdx.x) % 32;
  const int warp = static_cast<int>(threadIdx.x) / 32;
  const int c = static_cast<int>(blockIdx.y) * kColTile + lane;
  const bool live = c < w;
  const int r0 = static_cast<int>(blockIdx.z) * kRowTile;
  const int r1 = min(h_out, r0 + kRowTile);
  const int64_t line = static_cast<int64_t>(p) * w + (live ? c : w - 1);
  const int k = kk[line];
  const float f = ff[line];
  if (warp == 0) {
    int kmin = k, kmax = k;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      kmin = min(kmin, __shfl_xor_sync(0xffffffffu, kmin, o));
      kmax = max(kmax, __shfl_xor_sync(0xffffffffu, kmax, o));
    }
    if (lane == 0) {
      span[0] = r0 + kmin;
      span[1] = (r1 + kmax) - (r0 + kmin) + 1;  // padded rows r0+kmin .. r1-1+kmax+1
    }
  }
  __syncthreads();
  const int lo = span[0];
  const int n = span[1];
  const float* src = in + static_cast<int64_t>(p) * h * w;
  OutT* dst = out + static_cast<int64_t>(p) * h_out * w;
  if (n <= kSpanMax) {  // uniform across the block
    for (int t = warp; t < n; t += kRowWarps) {
      tile[t][lane] =
          live ? src[static_cast<int64_t>(reflect101(lo + t - pad_top, h)) * w + c] : 0.0f;
    }
    __syncthreads();
    if (!live) return;
    for (int r = r0 + warp; r < r1; r += kRowWarps) {
      const int t = r + k - lo;
      dst[static_cast<int64_t>(r) * w + c] =
          convert<OutT>(lerp_rn(tile[t][lane], tile[t + 1][lane], f));
    }
  } else if (live) {
    for (int r = r0 + warp; r < r1; r += kRowWarps) {
      const float x0 = src[static_cast<int64_t>(reflect101(r + k - pad_top, h)) * w + c];
      const float x1 = src[static_cast<int64_t>(reflect101(r + k + 1 - pad_top, h)) * w + c];
      dst[static_cast<int64_t>(r) * w + c] = convert<OutT>(lerp_rn(x0, x1, f));
    }
  }
}

template <typename InT, typename OutT>
void launch_x(const void* in, const int32_t* k, const float* f, const float* scale,
              const float* bias, void* out, int p, int h, int w, int w_out, int pad_left,
              cudaStream_t stream) {
  const dim3 grid(p, (h + kRows - 1) / kRows);
  const size_t smem = sizeof(float) * (w_out + 1);
  const InT* src = static_cast<const InT*>(in);
  OutT* dst = static_cast<OutT*>(out);
  if (w_out % kVec == 0) {
    shear_x_kernel<InT, OutT, true><<<grid, kThreads, smem, stream>>>(
        src, k, f, scale, bias, dst, h, w, w_out, pad_left);
  } else {
    shear_x_kernel<InT, OutT, false><<<grid, kThreads, smem, stream>>>(
        src, k, f, scale, bias, dst, h, w, w_out, pad_left);
  }
}

template <typename OutT>
void launch_finish(const float* in, const int32_t* k, const float* f, const float* scale,
                   const float* bias, const uint8_t* rrev, const uint8_t* crev, void* out,
                   int p, int h, int w, int w_out, int pad_left, cudaStream_t stream) {
  const int64_t rows = static_cast<int64_t>(p) * h;
  const dim3 grid(static_cast<unsigned>((rows + kRowWarpsX - 1) / kRowWarpsX));
  OutT* dst = static_cast<OutT*>(out);
  if (w_out % kVec == 0) {
    shear_finish_kernel<OutT, true><<<grid, 32 * kRowWarpsX, 0, stream>>>(
        in, k, f, scale, bias, rrev, crev, dst, p, h, w, w_out, pad_left);
  } else {
    shear_finish_kernel<OutT, false><<<grid, 32 * kRowWarpsX, 0, stream>>>(
        in, k, f, scale, bias, rrev, crev, dst, p, h, w, w_out, pad_left);
  }
}

}  // namespace

// Each entry point returns cudaGetLastError() after its launch (0 =
// cudaSuccess); an unknown type code returns cudaErrorInvalidValue.

// K2: x [p, h, w] (uint8 or f32) -> out [p, h, w_out]; k, f [p, h]; scale,
// bias [p]. in_kind: 0 = uint8, 2 = f32; out_kind: 0 = bf16, 2 = f32.
extern "C" int rxtpu_shear_pass(const void* in, int in_kind, const void* k,
                                const void* f, const void* scale, const void* bias,
                                void* out, int out_kind, int p, int h, int w,
                                int w_out, int pad_left, void* stream) {
  if (p == 0 || h == 0 || w_out == 0) return static_cast<int>(cudaSuccess);
  // shared memory of one staged row: above 48 KB a launch needs an opt-in
  if (sizeof(float) * (w_out + 1) > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const int32_t* kp = static_cast<const int32_t*>(k);
  const float* fp = static_cast<const float*>(f);
  const float* sp = static_cast<const float*>(scale);
  const float* bp = static_cast<const float*>(bias);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (in_kind == 0 && out_kind == 2) {
    launch_x<uint8_t, float>(in, kp, fp, sp, bp, out, p, h, w, w_out, pad_left, st);
  } else if (in_kind == 0 && out_kind == 0) {
    launch_x<uint8_t, __nv_bfloat16>(in, kp, fp, sp, bp, out, p, h, w, w_out, pad_left, st);
  } else if (in_kind == 2 && out_kind == 2) {
    launch_x<float, float>(in, kp, fp, sp, bp, out, p, h, w, w_out, pad_left, st);
  } else if (in_kind == 2 && out_kind == 0) {
    launch_x<float, __nv_bfloat16>(in, kp, fp, sp, bp, out, p, h, w, w_out, pad_left, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// K4: as K2 on f32 input, then the output rows reversed where rrev[p] and its
// columns where crev[p] (uint8 flags [p]).
extern "C" int rxtpu_shear_pass_finish(const void* in, const void* k, const void* f,
                                       const void* scale, const void* bias,
                                       const void* rrev, const void* crev, void* out,
                                       int out_kind, int p, int h, int w, int w_out,
                                       int pad_left, void* stream) {
  if (p == 0 || h == 0 || w_out == 0) return static_cast<int>(cudaSuccess);
  const float* src = static_cast<const float*>(in);
  const int32_t* kp = static_cast<const int32_t*>(k);
  const float* fp = static_cast<const float*>(f);
  const float* sp = static_cast<const float*>(scale);
  const float* bp = static_cast<const float*>(bias);
  const uint8_t* rp = static_cast<const uint8_t*>(rrev);
  const uint8_t* cp = static_cast<const uint8_t*>(crev);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_kind == 2) {
    launch_finish<float>(src, kp, fp, sp, bp, rp, cp, out, p, h, w, w_out, pad_left, st);
  } else if (out_kind == 0) {
    launch_finish<__nv_bfloat16>(src, kp, fp, sp, bp, rp, cp, out, p, h, w, w_out, pad_left, st);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// K3: x [p, h, w] f32 -> out [p, h_out, w]; k, f [p, w].
extern "C" int rxtpu_shear_pass_rows(const void* in, const void* k, const void* f,
                                     void* out, int out_kind, int p, int h, int w,
                                     int h_out, int pad_top, void* stream) {
  if (p == 0 || h_out == 0 || w == 0) return static_cast<int>(cudaSuccess);
  const dim3 grid(p, (w + kColTile - 1) / kColTile, (h_out + kRowTile - 1) / kRowTile);
  const float* src = static_cast<const float*>(in);
  const int32_t* kp = static_cast<const int32_t*>(k);
  const float* fp = static_cast<const float*>(f);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_kind == 2) {
    shear_y_kernel<float><<<grid, kColTile * kRowWarps, 0, st>>>(
        src, kp, fp, static_cast<float*>(out), h, w, h_out, pad_top);
  } else if (out_kind == 0) {
    shear_y_kernel<__nv_bfloat16><<<grid, kColTile * kRowWarps, 0, st>>>(
        src, kp, fp, static_cast<__nv_bfloat16*>(out), h, w, h_out, pad_top);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
