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
// against 352.3 MB (0.105 ms).
//
// The first kernel (one block per view and 8x8 pooled tile) reached 2.85% of
// that: (1) the products ran as f32 FMAs on the CUDA cores, (2) every block
// staged and transposed the whole weight tensor, some 925 MB of L2 reads per
// test launch, (3) 112.9 KB of shared memory a block, (4) 13% of the conv
// outputs recomputed at tile edges, (5) 16-byte output runs. This design:
// (1) mma.sync on bf16, (2) persistent blocks that stage the weights once,
// (3) 115,700 B a block, still two blocks per SM, (4) 16% recomputed and 8%
// padding (a 4 x 16 tile: the larger 8 x 16 one needs 72 KB of conv tile
// and leaves one block per SM), (5) 32-byte runs.
//
// Design: an implicit GEMM on the tensor cores (mma.sync.m16n8k16, bf16 in,
// f32 sums) in persistent blocks.
// - GEMM: M = a tile's conv outputs, N = the 64 channels, K = 49 taps x 8
//   channels (the 6 input channels padded to 8, so one tap is one 16-byte
//   row), and a zero tap: 25 k16 steps. Each of the 5 warps owns 64 rows (4
//   m16 tiles) and runs the 64 channels in two passes of 32 (64 accumulators
//   a thread, so two blocks fit on an SM; the MMA loop spills nothing): per
//   k step 4 ldmatrix.x4 of A, 2 of B, 16 MMAs.
// - Tile: 4 pooled rows x 16 pooled columns, so each (channel, pooled row)
//   is one 32-byte run of bf16 outputs. It reads 9 x 33 = 297 conv outputs
//   (M padded to 320): the tile's edge row and column are recomputed by
//   its neighbour.
// - The staged window: the tile's 23 x 71 source pixels, cropped,
//   normalized with __fmul_rn / __fadd_rn, rounded to bf16 and zero outside
//   the crop, stored once as one 16-byte cell of 8 channels per pixel, even
//   source columns before the odd ones. The A fragments come straight from it
//   by ldmatrix, one cell address per lane (source pixel (2r+ky, 2s+kx) of
//   the lane's conv output): no im2col buffer, and the 8 conv outputs of one
//   8x8 matrix read 8 consecutive cells (no bank conflicts within a conv row).
// - The weights: each block stages them once, repacked in the kernel from the
//   [64, 294] (c, ky, kx) input to [64][49 taps] cells of 8 channels (an odd
//   row pitch, so the B fragments' ldmatrix reads are free of bank
//   conflicts), and a zero cell that the zero tap reads. Blocks then loop
//   over the (view, tile) pairs, tile = blockIdx.x + i * gridDim.x, as many
//   blocks as fit on the card (two per SM for bf16 output, one for f32). No
//   float atomics and no cross-block sums: the output is deterministic.
// - The epilogue adds the bias (__fadd_rn) in registers and writes the conv
//   tile to shared memory in the output type (16-byte chunks XOR-swizzled by
//   pixel), -inf outside the conv output (each pool window holds at least
//   one real value). RNE rounding is monotone, so bf16(max v) == max bf16(v),
//   and relu(max v) == max relu(v): a bf16 tile halves the shared memory,
//   and the ReLU follows the pool. The pool takes the 3x3/2 max of a
//   channel pair (one lane per pair, 32 pairs of one pixel per warp load)
//   and writes 8 pooled outputs per channel with one 16-byte store (32 bytes
//   for f32) where the rows are 16-byte aligned, else in pairs at even
//   element indices.
// - bf16 output is bit-equal to the plain version. The tensor cores sum in
//   another order than the plain version's f32 convolution (on the card,
//   (c, ky, kx) one FMA at a time), which moves a conv output by a few 1e-6:
//   enough to round about 1 in 10^4 bf16 outputs one ulp the other way, and
//   a bf16 network downstream turns such flips into visibly different
//   losses. So the epilogue lists every conv output whose f32 value lies
//   within kAbs + kRel |v| of a bf16 rounding boundary (or of 0): a small
//   share of a tile's 19,008 (rounding_at_risk; at most kList, past which
//   the rest keep the tensor cores' rounding, within one ulp). After the
//   tile is complete, a listed output at or above the bf16 value below the
//   maximum of a pooled window that holds it is summed again in
//   the plain version's order from the staged window and weights by one
//   thread each, and takes that sum's bf16 value in the tile. Every other
//   output rounds as the plain version's sum does, so the pool's result is
//   the plain version's. f32 output keeps the tensor cores' sums (about
//   1e-6 of max|out| from the plain version's).
// - Shared memory: 50,192 B of weights, 26,128 B of window, 38,016 B of
//   bf16 conv tile (76,032 B in f32) and 1,364 B of list: 115,700 B, two
//   blocks per SM for bf16 output. Four barriers per tile (window staged and
//   the last pool done, conv tile and list complete, decisions taken, exact
//   sums in the tile); the other block on the SM overlaps each block's
//   staging, exact sums, pool and barriers with its MMAs.
//
// Rounding matches the plain PyTorch version: the normalize rounds the
// product and the sum separately, then to bf16 by nearest even; a bf16 x bf16
// product is exact in f32, so only the order of the f32 additions (in the
// tensor cores) differs from the plain version's convolution, and for bf16
// output not even the result.

#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kC = 6;                    // input channels
constexpr int kM = 64;                   // output channels
constexpr int kTaps = 49;                // 7 x 7
constexpr int kKSteps = (kTaps + 1) / 2; // 25 k16 steps: K = 49 taps x 8 channels, then a zero tap
constexpr int kPR = 4;                   // pooled rows per tile
constexpr int kPC = 16;                  // pooled columns per tile
constexpr int kCR = 2 * kPR + 1;         // conv rows per tile: 9
constexpr int kCC = 2 * kPC + 1;         // conv columns per tile: 33
constexpr int kPix = kCR * kCC;          // 297 conv outputs per tile
constexpr int kSR = 4 * kPR + 7;         // window rows: 23
constexpr int kSC = 4 * kPC + 7;         // window columns: 71
constexpr int kEven = (kSC + 1) / 2;     // 36 even columns, then the 35 odd ones
constexpr int kWarps = 5;
constexpr int kThreads = 32 * kWarps;
constexpr int kMT = 4;                   // m16 tiles per warp
constexpr int kMaxDevices = 64;
static_assert(kWarps * kMT * 16 >= kPix, "the warps must cover the tile's conv outputs");

// A conv output v of the tensor cores lies within kAbs + kRel |v| of the
// plain version's sum of the same terms, kAbs = 2^-17 (7.6e-6) and kRel =
// 2^-18 (3.8e-6) (rounding_at_risk): chip_smoke.py prints the largest gap
// as a share of this bound for random stem weights (phase 2) and a trained
// checkpoint's folded stem (phase 4b).
constexpr float kAbs = 1.0f / 131072;
constexpr float kRel = 1.0f / 262144;

constexpr int kWBytes = kM * kTaps * 16 + 16;   // 50,192: [m][tap] cells, then a zero cell
constexpr int kWinBytes = kSR * kSC * 16;       // 26,128
constexpr int kFixedBytes = kWBytes + kWinBytes;
constexpr int kTileBytes = kPix * kM * 2;       // 38,016: the bf16 conv tile
constexpr int kList = 680;                      // conv outputs listed per tile (bf16 output)
static_assert(kFixedBytes % 16 == 0, "the conv tile must start 16-byte aligned");

template <typename T> constexpr int smem_bytes() {  // bf16: 115,700 (two blocks per SM)
  return kFixedBytes + kPix * kM * static_cast<int>(sizeof(T)) +
         (sizeof(T) == 2 ? 4 + 2 * kList : 0);
}

// cell offset of tap (ky, kx) from the cell of a conv output's first source pixel
__host__ __device__ constexpr int tap_offset(int tap) {
  return (tap / 7) * kSC + (tap % 7 & 1) * kEven + (tap % 7 >> 1);
}

// byte offset of the channel pair (2 mp, 2 mp + 1) of conv output p in the
// conv tile: [p][64 channels] in T, 16-byte chunks XOR-swizzled by p & 7
template <typename T> __device__ __forceinline__ int tile_offset(int p, int mp) {
  const int b = mp * 2 * static_cast<int>(sizeof(T));
  return p * kM * static_cast<int>(sizeof(T)) + (((b >> 4) ^ (p & 7)) << 4) + (b & 15);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// four 8x8 bf16 matrices from shared memory, one row address per lane
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// d += a b over one m16n8k16 step (f32 accumulators)
__device__ __forceinline__ void mma16816(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a channel pair of the conv tile in the output type
template <typename T> struct Pair;
template <> struct Pair<__nv_bfloat16> {
  using V = __nv_bfloat162;
  static __device__ __forceinline__ V make(float a, float b) { return __floats2bfloat162_rn(a, b); }
  static __device__ __forceinline__ V max(V a, V b) { return __hmax2(a, b); }
  static __device__ __forceinline__ V relu(V a) { return __hmax2(a, __float2bfloat162_rn(0.0f)); }
  static __device__ __forceinline__ __nv_bfloat16 lo(V v) { return __low2bfloat16(v); }
  static __device__ __forceinline__ __nv_bfloat16 hi(V v) { return __high2bfloat16(v); }
  static __device__ __forceinline__ V join(__nv_bfloat16 a, __nv_bfloat16 b) {
    return __halves2bfloat162(a, b);
  }
};
template <> struct Pair<float> {
  using V = float2;
  static __device__ __forceinline__ V make(float a, float b) { return make_float2(a, b); }
  static __device__ __forceinline__ V max(V a, V b) {
    return make_float2(fmaxf(a.x, b.x), fmaxf(a.y, b.y));
  }
  static __device__ __forceinline__ V relu(V a) {
    return make_float2(fmaxf(a.x, 0.0f), fmaxf(a.y, 0.0f));
  }
  static __device__ __forceinline__ float lo(V v) { return v.x; }
  static __device__ __forceinline__ float hi(V v) { return v.y; }
  static __device__ __forceinline__ V join(float a, float b) { return make_float2(a, b); }
};

// 8 outputs of one channel and pooled row: a 16-byte store for bf16, two for f32
template <typename T> struct alignas(16) Run {
  T v[8];
};

// the first `count` outputs of r at o, a row that is not 16-byte aligned:
// pairs at even element indices (4 bytes for bf16, 8 for f32), the odd
// ends alone
template <typename T>
__device__ __forceinline__ void store_unaligned(T* o, const Run<T>& r, int count) {
  using V = typename Pair<T>::V;
  const int lead = static_cast<int>(reinterpret_cast<uintptr_t>(o) / sizeof(T)) & 1;
  count = count < 8 ? count : 8;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    if (q >= count) break;
    if (((q + lead) & 1) == 0 && q + 1 < count) {  // q starts an aligned pair
      *reinterpret_cast<V*>(o + q) = Pair<T>::join(r.v[q], r.v[q + 1]);
    } else if (((q + lead) & 1) == 0 || q == 0) {  // an unpaired end
      o[q] = r.v[q];
    }
  }
}

// channel m of conv output p in the bf16 conv tile
__device__ __forceinline__ __nv_bfloat16& tile_at(unsigned char* conv_s, int p, int m) {
  return *reinterpret_cast<__nv_bfloat16*>(conv_s + tile_offset<__nv_bfloat16>(p, m >> 1) +
                                           2 * (m & 1));
}

// Conv output p of the tile, channel m, before the ReLU, summed in the plain
// version's order (c, ky, kx), one f32 FMA at a time, from the staged window
// and weights; each row (c, ky) of 7 taps loads while the previous row's
// FMAs run.
__device__ __forceinline__ float exact_conv(const __nv_bfloat16* __restrict__ win_s,
                                            const __nv_bfloat16* __restrict__ w_s,
                                            const float* __restrict__ conv_bias, int p, int m) {
  const __nv_bfloat16* x = win_s + (2 * (p / kCC) * kSC + p % kCC) * 8;
  const __nv_bfloat16* wm = w_s + m * kTaps * 8;
  float acc = 0.0f;
#pragma unroll 1
  for (int c = 0; c < kC; ++c) {
    float xv[2][7], wv[2][7];
#pragma unroll
    for (int r = 0; r <= 7; ++r) {
      if (r < 7) {
#pragma unroll
        for (int kx = 0; kx < 7; ++kx) {
          xv[r & 1][kx] = __bfloat162float(x[tap_offset(7 * r + kx) * 8 + c]);
          wv[r & 1][kx] = __bfloat162float(wm[(7 * r + kx) * 8 + c]);
        }
      }
      if (r > 0) {
#pragma unroll
        for (int kx = 0; kx < 7; ++kx) acc = fmaf(wv[(r - 1) & 1][kx], xv[(r - 1) & 1][kx], acc);
      }
    }
  }
  return __fadd_rn(acc, conv_bias[m]);
}

// Whether the plain version's sum of the terms of v (within kAbs + kRel |v|
// of v) may round to another bf16 value than b = bf16(v), or to another
// sign: v lies within that gap of the midpoint half an ulp away from b
// (half an ulp of v's binade: 2^(e - 135)). A negative v only counts near 0.
__device__ __forceinline__ bool rounding_at_risk(float v, __nv_bfloat16 b) {
  const float gap = fmaf(kRel, fabsf(v), kAbs);
  const float half_ulp = __uint_as_float((__float_as_uint(v) & 0x7F800000u) - (8u << 23));
  return v > -gap && fabsf(v - __bfloat162float(b)) + gap >= half_ulp;
}

// two blocks per SM for bf16 output; f32's conv tile leaves room for one
template <typename OutT>
__global__ void __launch_bounds__(kThreads, sizeof(OutT) == 2 ? 2 : 1)
fused_stem_kernel(const uint8_t* __restrict__ img, const float* __restrict__ scale,
                  const float* __restrict__ bias, const __nv_bfloat16* __restrict__ weight,
                  const float* __restrict__ conv_bias, OutT* __restrict__ out, int h, int w,
                  int offset, int crop, int conv_o, int pool_o, int tiles_y, int tiles_x,
                  int tiles) {
  using P = Pair<OutT>;
  constexpr bool kExact = sizeof(OutT) == 2;  // bf16 output: bit-equal to the plain version
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* w_s = reinterpret_cast<uint4*>(smem);                  // [m][tap] cells, a zero cell
  uint4* win_s = reinterpret_cast<uint4*>(smem + kWBytes);      // [row][even | odd column]
  unsigned char* conv_s = smem + kFixedBytes;                   // [pixel][64] in OutT
  int* list_n = reinterpret_cast<int*>(conv_s + kTileBytes);    // bf16 only: the list's length
  uint16_t* list = reinterpret_cast<uint16_t*>(list_n + 1);     // p | m << 9 | needed << 15
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // the weights, once per block: cell (m, tap) holds w[m, c, tap] for c < 6
  for (int i = tid; i < kM * kTaps + 1; i += kThreads) {
    const int m = i / kTaps, tap = i % kTaps;
    union { uint4 u; __nv_bfloat16 b[8]; } cell;
    cell.u = make_uint4(0, 0, 0, 0);
    if (m < kM) {
#pragma unroll
      for (int c = 0; c < kC; ++c) cell.b[c] = weight[(m * kC + c) * kTaps + tap];
    }
    w_s[i] = cell.u;  // i = kM * kTaps: the zero cell
  }

  // per lane: the A rows' first cells (ldmatrix row lane & 15 of each m16
  // tile, taps 2t + (lane >> 4)) and the B rows (channel 8 (lane >> 4) +
  // (lane & 7) + 16 j, tap 2t + ((lane >> 3) & 1); the zero cell for tap 49)
  const unsigned win_addr = smem_addr(win_s);
  unsigned a_addr[kMT];
#pragma unroll
  for (int i = 0; i < kMT; ++i) {
    int mr = warp * kMT * 16 + i * 16 + (lane & 15);
    mr = mr < kPix ? mr : 0;  // the pad rows read any cell; their sums are dropped
    a_addr[i] = win_addr + 16 * (2 * (mr / kCC) * kSC + mr % kCC);
  }
  const bool a_hi = (lane >> 4) != 0, b_hi = ((lane >> 3) & 1) != 0;
  const unsigned b_addr =
      smem_addr(w_s) + 16 * ((8 * (lane >> 4) + (lane & 7)) * kTaps + (b_hi ? 1 : 0));
  const unsigned zero_addr = smem_addr(w_s) + 16 * kM * kTaps;

  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int n = tile / (tiles_y * tiles_x);
    const int py0 = tile / tiles_x % tiles_y * kPR;
    const int px0 = tile % tiles_x * kPC;
    if (kExact && tid == 0) *list_n = 0;  // read after the next barrier

    // the source window: crop coordinates (4 py0 - 5, 4 px0 - 5) onward
    {
      float s[kC], b[kC];
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        s[c] = scale[n * kC + c];
        b[c] = bias[n * kC + c];
      }
      const int64_t plane = static_cast<int64_t>(h) * w;
      const uint8_t* src = img + n * kC * plane + static_cast<int64_t>(offset) * w + offset;
      const int y0 = 4 * py0 - 5, x0 = 4 * px0 - 5;
#pragma unroll 4
      for (int i = tid; i < kSR * kSC; i += kThreads) {
        const int r = i / kSC, col = i % kSC;
        const int y = y0 + r, x = x0 + col;
        union { uint4 u; __nv_bfloat162 b2[4]; } cell;
        cell.u = make_uint4(0, 0, 0, 0);
        if (y >= 0 && y < crop && x >= 0 && x < crop) {
          const uint8_t* p = src + static_cast<int64_t>(y) * w + x;
          float v[kC];
#pragma unroll
          for (int c = 0; c < kC; ++c) {
            v[c] = __fadd_rn(__fmul_rn(static_cast<float>(__ldg(p + c * plane)), s[c]), b[c]);
          }
#pragma unroll
          for (int q = 0; q < kC / 2; ++q) {
            cell.b2[q] = __floats2bfloat162_rn(v[2 * q], v[2 * q + 1]);
          }
        }
        win_s[r * kSC + (col & 1) * kEven + (col >> 1)] = cell.u;
      }
    }
    __syncthreads();  // the window (and, the first time, the weights) staged; the last pool done

    // the implicit GEMM: rows [64 warp, 64 warp + 64) of the tile, channels
    // [32 nh, 32 nh + 32) per pass; then the bias into the conv tile, the
    // ReLU left to the pool; positions outside the conv output are -inf
    const int cr0 = 2 * py0 - 1, cc0 = 2 * px0 - 1;
#pragma unroll 1
    for (int nh = 0; nh < 2; ++nh) {
      float acc[kMT][4][4];
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
        }
      }
      const unsigned b_half = b_addr + 16 * (32 * nh * kTaps);
      unsigned risk[2] = {0, 0};  // this pass's outputs whose rounding the plain sum may not share
#pragma unroll
      for (int t = 0; t < kKSteps; ++t) {
        const unsigned off = 16 * tap_offset(a_hi && 2 * t + 1 < kTaps ? 2 * t + 1 : 2 * t);
        unsigned a[kMT][4];
#pragma unroll
        for (int i = 0; i < kMT; ++i) ldsm_x4(a[i], a_addr[i] + off);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          unsigned b[4];
          ldsm_x4(b, 2 * t + 1 == kTaps && b_hi ? zero_addr
                                                 : b_half + 16 * (16 * j * kTaps + 2 * t));
#pragma unroll
          for (int i = 0; i < kMT; ++i) {
            mma16816(acc[i][2 * j], a[i], b[0], b[1]);
            mma16816(acc[i][2 * j + 1], a[i], b[2], b[3]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kMT; ++i) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int mr = warp * kMT * 16 + i * 16 + (lane >> 2) + 8 * half;
          if (mr < kPix) {
            const int r = cr0 + mr / kCC, c = cc0 + mr % kCC;
            const bool inside = r >= 0 && r < conv_o && c >= 0 && c < conv_o;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const int mp = 16 * nh + 4 * j + (lane & 3);
              const float2 cb = __ldg(reinterpret_cast<const float2*>(conv_bias) + mp);
              const float v0 = __fadd_rn(acc[i][j][2 * half], cb.x);
              const float v1 = __fadd_rn(acc[i][j][2 * half + 1], cb.y);
              const typename P::V pv = P::make(v0, v1);
              *reinterpret_cast<typename P::V*>(conv_s + tile_offset<OutT>(mr, mp)) =
                  inside ? pv : P::make(-INFINITY, -INFINITY);
              if constexpr (kExact) {  // bit 16 (i & 1) + 8 half + 2 j + e of word i / 2
                const bool r0 = inside && rounding_at_risk(v0, P::lo(pv));
                const bool r1 = inside && rounding_at_risk(v1, P::hi(pv));
                risk[i / 2] |= static_cast<unsigned>(r0) << (16 * (i & 1) + 8 * half + 2 * j);
                risk[i / 2] |= static_cast<unsigned>(r1) << (16 * (i & 1) + 8 * half + 2 * j + 1);
              }
            }
          }
        }
      }
      if (kExact && (risk[0] | risk[1]) != 0) {  // onto the list, one atomic per lane and pass
        unsigned long long bits = risk[0] | static_cast<unsigned long long>(risk[1]) << 32;
        int slot = atomicAdd(list_n, __popcll(bits));
        for (; bits != 0 && slot < kList; bits &= bits - 1, ++slot) {
          const int bit = __ffsll(bits) - 1;
          const int mr = warp * kMT * 16 + (bit >> 4) * 16 + (lane >> 2) + 8 * ((bit >> 3) & 1);
          const int m = 2 * (16 * nh + 4 * ((bit >> 1) & 3) + (lane & 3)) + (bit & 1);
          list[slot] = static_cast<uint16_t>(mr | m << 9);
        }
      }
    }
    __syncthreads();  // the conv tile and the list complete

    if (kExact) {
      // A listed output matters where it is within one bf16 ulp of the
      // maximum of a pooled window that holds it; there it takes the plain
      // version's sum. Every other output rounds as the plain version's
      // does, so then the pool is bit-equal to the plain version's.
      const int listed = min(*list_n, kList);
      for (int i = tid; i < listed; i += kThreads) {
        const int p = list[i] & 511, m = list[i] >> 9;
        const int r = p / kCC, c = p % kCC;
        const float v = __bfloat162float(tile_at(conv_s, p, m));
        bool needed = false;
        for (int py = max(0, (r - 1) / 2); py <= min(kPR - 1, r / 2); ++py) {
          for (int px = max(0, (c - 1) / 2); px <= min(kPC - 1, c / 2); ++px) {
            if (py0 + py >= pool_o || px0 + px >= pool_o) continue;
            __nv_bfloat16 top = __float2bfloat16_rn(-INFINITY);
            for (int d = 0; d < 9; ++d) {
              top = __hmax(top, tile_at(conv_s, (2 * py + d / 3) * kCC + 2 * px + d % 3, m));
            }
            // at or above the bf16 value below the maximum (or above -2 kAbs
            // where the maximum is not positive)
            const unsigned short below = __bfloat16_as_ushort(top) - 1;
            needed |= v >= (__bfloat162float(top) > 0.0f
                                ? __bfloat162float(__ushort_as_bfloat16(below))
                                : -2.0f * kAbs);
          }
        }
        if (needed) list[i] |= 0x8000;
      }
      __syncthreads();  // every decision taken on the tensor cores' tile
      const __nv_bfloat16* w_b = reinterpret_cast<const __nv_bfloat16*>(w_s);
      const __nv_bfloat16* win_b = reinterpret_cast<const __nv_bfloat16*>(win_s);
      for (int i = tid; i < listed; i += kThreads) {
        const unsigned e = list[i];
        if (e & 0x8000) {
          const int p = e & 511, m = (e >> 9) & 63;
          tile_at(conv_s, p, m) = __float2bfloat16_rn(exact_conv(win_b, w_b, conv_bias, p, m));
        }
      }
      __syncthreads();  // the exact sums in the tile
    }

    // ReLU + max pool 3x3/2: one lane per channel pair, 8 pooled columns of one row
    const bool vec = pool_o % 8 == 0;
    for (int item = tid; item < kPR * 2 * 32; item += kThreads) {
      const int mp = item & 31, hc = (item >> 5) & 1, py = item >> 6;
      const int oy = py0 + py, ox0 = px0 + 8 * hc;
      if (oy >= pool_o || ox0 >= pool_o) continue;
      auto col_max = [&](int cc) {  // the 3 conv rows of pooled row py at tile column cc
        const int p = 2 * py * kCC + 16 * hc + cc;
        typename P::V v =
            *reinterpret_cast<const typename P::V*>(conv_s + tile_offset<OutT>(p, mp));
        v = P::max(v, *reinterpret_cast<const typename P::V*>(
                          conv_s + tile_offset<OutT>(p + kCC, mp)));
        return P::max(v, *reinterpret_cast<const typename P::V*>(
                             conv_s + tile_offset<OutT>(p + 2 * kCC, mp)));
      };
      Run<OutT> r0, r1;
      typename P::V prev = col_max(0);
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const typename P::V nxt = col_max(2 * q + 2);
        const typename P::V v = P::relu(P::max(P::max(prev, col_max(2 * q + 1)), nxt));
        prev = nxt;
        r0.v[q] = P::lo(v);  // relu(max) = max(relu)
        r1.v[q] = P::hi(v);
      }
      OutT* o0 = out + (static_cast<int64_t>(n * kM + 2 * mp) * pool_o + oy) * pool_o + ox0;
      OutT* o1 = o0 + static_cast<int64_t>(pool_o) * pool_o;
      if (vec && ox0 + 8 <= pool_o) {
        *reinterpret_cast<Run<OutT>*>(o0) = r0;
        *reinterpret_cast<Run<OutT>*>(o1) = r1;
      } else {
        store_unaligned(o0, r0, pool_o - ox0);
        store_unaligned(o1, r1, pool_o - ox0);
      }
    }
  }
}

// blocks per SM (resident at once) and SMs of the current device, set once
// per device and output type with the kernel's shared-memory limit
template <typename OutT>
cudaError_t residency(int& per_sm, int& sms) {
  static int cached[kMaxDevices][2] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cached[dev][0] == 0) {
    const int smem = smem_bytes<OutT>();
    err = cudaFuncSetAttribute(fused_stem_kernel<OutT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(fused_stem_kernel<OutT>,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    }
    int blocks = 0, count = 0;
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fused_stem_kernel<OutT>,
                                                          kThreads, smem);
    }
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    }
    if (err != cudaSuccess) return err;
    if (blocks == 0) return cudaErrorInvalidConfiguration;
    cached[dev][1] = count;
    cached[dev][0] = blocks;
  }
  per_sm = cached[dev][0];
  sms = cached[dev][1];
  return cudaSuccess;
}

template <typename OutT>
int launch(const uint8_t* img, const float* scale, const float* bias,
           const __nv_bfloat16* weight, const float* conv_bias, void* out, int n, int h,
           int w, int offset, int crop, cudaStream_t stream) {
  const int conv_o = (crop - 1) / 2 + 1;   // (crop + 2*3 - 7) / 2 + 1
  const int pool_o = (conv_o - 1) / 2 + 1;  // (conv + 2*1 - 3) / 2 + 1
  const int tiles_y = (pool_o + kPR - 1) / kPR;
  const int tiles_x = (pool_o + kPC - 1) / kPC;
  const int64_t tiles = static_cast<int64_t>(n) * tiles_y * tiles_x;
  if (tiles > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  int per_sm = 0, sms = 0;
  const cudaError_t err = residency<OutT>(per_sm, sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = static_cast<int>(tiles < static_cast<int64_t>(per_sm) * sms
                                        ? tiles : static_cast<int64_t>(per_sm) * sms);
  fused_stem_kernel<OutT><<<grid, kThreads, smem_bytes<OutT>(), stream>>>(
      img, scale, bias, weight, conv_bias, static_cast<OutT*>(out), h, w, offset, crop,
      conv_o, pool_o, tiles_y, tiles_x, static_cast<int>(tiles));
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

// The persistent kernel's blocks per SM for out_kind (0 = bf16, 2 = f32) on
// the current device, or minus a CUDA error code.
extern "C" int rxtpu_fused_stem_blocks_per_sm(int out_kind) {
  int per_sm = 0, sms = 0;
  cudaError_t err = cudaErrorInvalidValue;
  if (out_kind == 0) err = residency<__nv_bfloat16>(per_sm, sms);
  if (out_kind == 2) err = residency<float>(per_sm, sms);
  return err == cudaSuccess ? per_sm : -static_cast<int>(err);
}
