// K8: int8 convolution (int32 sums) with the W8A8 QuantConv epilogue fused.
//
// Replaces the XLA op behind rxtpu/models/quant.py:QuantConv, its int8 conv
// (lax.conv_general_dilated with preferred_element_type=int32, :167-170)
// and the elementwise epilogue XLA fuses onto it (:172-190). It is not a
// Pallas kernel; torch has no int8 convolution on CUDA.
//
//   acc[m, c] = sum_{ky, kx, ci} x[n, oy*s - p + ky, ox*s - p + kx, ci] * w[c, (ky*kw + kx)*cin + ci]
//   o = float(acc) * scale[c] + bias[c]        scale = w_scale * in_scale, formed by the caller
//   o = o + float(rq) * rs   or   o = o + r    an optional residual, int8 (with its scale) or f32
//   o = max(o, 0)                              optional
//   out = clip(rint(o * inv_out), -127, 127)   int8, or o as bf16 / f32 when there is no out scale
//
// x is NHWC int8 [n, h, w, cin], zero outside the image; w int8 [cout, kh*kw*cin]
// ("K-major": one row of K per output channel, (ky, kx, ci) order); the output
// and the residual are NHWC [n, ho, wo, cout]. int32 sums do not depend on
// their order, and the epilogue rounds op by op (__fmul_rn / __fadd_rn, never
// contracted into an FMA; rintf rounds half to even, as jnp.round), so the
// output is bit-equal to the plain version (F.conv2d in float64 on the same
// int8 values, exact below 2^53, then the same epilogue in torch ops).
//
// Bound: operations at the int8 tensor-core rate (1,979 TOP/s dense) for the
// 3x3 and stem convs, bytes (3.35 TB/s) for the small 1x1 ones; chip_smoke.py
// computes both per shape. A ResNet-50 predict batch (96 views of 512^2) is
// about 2 TMAC over 53 launches.
//
// Design: an implicit GEMM, M = n*ho*wo output pixels, N = cout, K = kh*kw*cin,
// on mma.sync.aligned.m16n8k32 (s8 x s8 -> s32). A block computes a 128 x 64
// tile with four warps of 64 x 32 (4 x 4 MMAs per k32 step); the K loop steps
// 64 bytes at a time through a 3-stage ring in shared memory (rows padded to
// 80 bytes, so the ldmatrix rows of a phase fall on distinct bank groups).
// - cin a multiple of 16 (every conv but the stem): each 16-byte chunk of a
//   row of A is 16 channels of one tap of one input pixel, and each chunk of B
//   16 bytes of a weight row, both copied with cp.async and zero-filled where
//   the tap falls in the padding, past M, past cout or past K.
// - otherwise (the stem: cin 6, K = 294): the block gathers its tile byte by
//   byte with plain loads, zero past the image and past K (K is zero-filled to
//   a multiple of 64), and stores it to the ring; the 64 weight rows alike.
// - One block per output tile (a 1-D grid, the cout tiles of one row block
//   side by side, so they read the same A rows from L2). The epilogue takes
//   each thread's accumulators straight from registers and writes them to
//   global memory element by element; ragged M and cout are masked there.
// A simple first kernel: making it fast (wgmma on s8, TMA, a staged
// epilogue with wide stores, the stem's gather) is later work.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBM = 128;        // output pixels per block
constexpr int kBN = 64;         // output channels per block
constexpr int kBK = 64;         // K bytes per ring stage
constexpr int kStages = 3;
constexpr int kThreads = 128;   // 4 warps, 2 x 2 over the tile
constexpr int kPitch = kBK + 16;
constexpr int kAStage = kBM * kPitch;
constexpr int kBStage = kBN * kPitch;
constexpr int kSmem = kStages * (kAStage + kBStage);  // 46,080 bytes: static shared memory
static_assert(kSmem <= 48 * 1024, "the ring must fit in static shared memory");

struct Params {
  const int8_t* x;
  const int8_t* wt;        // [cout, k]
  const float* scale;      // [cout] w_scale * in_scale
  const float* bias;       // [cout]
  const void* res;         // [m, cout] int8 or f32, or null
  const float* res_scale;  // scalar, for an int8 residual
  const float* inv_out;    // scalar 1 / out_scale, for int8 output
  void* out;               // [m, cout]
  int h, w, cin, cout, kh, kw, stride, pad, ho, wo, k;
  int m;
  int res_kind;  // 0 none, 1 int8 with res_scale, 2 f32
  int out_kind;  // 0 bf16, 1 int8, 2 f32
  int relu;
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; zero-filled where !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 matrices of 16-byte rows, one row address per lane
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const int8_t* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

// d += a b over one m16n8k32 step, int8 operands, int32 sums
__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4], unsigned b0,
                                       unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One output pixel's place in the input: its image and the top-left tap.
struct Pixel {
  const int8_t* img;
  int iy0, ix0;
  bool ok;
};

__device__ __forceinline__ Pixel pixel_of(const Params& p, int m) {
  Pixel px;
  px.ok = m < p.m;
  const int mm = px.ok ? m : 0;
  const int ox = mm % p.wo;
  const int t = mm / p.wo;
  const int oy = t % p.ho;
  const int n = t / p.ho;
  px.img = p.x + static_cast<int64_t>(n) * p.h * p.w * p.cin;
  px.iy0 = oy * p.stride - p.pad;
  px.ix0 = ox * p.stride - p.pad;
  return px;
}

// kVec: cin % 16 == 0, the tiles go by cp.async; else by a byte gather.
template <bool kVec>
__global__ void __launch_bounds__(kThreads) int8_conv_kernel(const Params p) {
  __shared__ __align__(128) int8_t smem[kSmem];
  int8_t* const sa = smem;
  int8_t* const sb = smem + kStages * kAStage;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_tiles = (p.cout + kBN - 1) / kBN;
  const int m0 = static_cast<int>(blockIdx.x / n_tiles) * kBM;
  const int n0 = static_cast<int>(blockIdx.x % n_tiles) * kBN;
  const int k_tiles = (p.k + kBK - 1) / kBK;

  // the loader's rows: with kVec four A rows (tid / 4 + 32 j) and two B rows
  // at chunk tid % 4; gathering, A row tid and half of B row tid / 2
  constexpr int kARows = kVec ? 4 : 1;
  Pixel px[kARows];
#pragma unroll
  for (int j = 0; j < kARows; ++j) {
    px[j] = pixel_of(p, m0 + (kVec ? tid / 4 + 32 * j : tid));
  }

  auto load_stage = [&](int stage, int kt) {
    int8_t* a_dst = sa + stage * kAStage;
    int8_t* b_dst = sb + stage * kBStage;
    if constexpr (kVec) {
      const int chunk = tid & 3;
      const int k0 = kt * kBK + chunk * 16;
      const bool k_ok = k0 < p.k;
      const int tap = k0 / p.cin;
      const int ci = k0 - tap * p.cin;
      const int ky = tap / p.kw;
      const int kx = tap - ky * p.kw;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int iy = px[j].iy0 + ky;
        const int ix = px[j].ix0 + kx;
        const bool ok = k_ok && px[j].ok && static_cast<unsigned>(iy) < static_cast<unsigned>(p.h) &&
                        static_cast<unsigned>(ix) < static_cast<unsigned>(p.w);
        const int8_t* src =
            ok ? px[j].img + (static_cast<int64_t>(iy) * p.w + ix) * p.cin + ci : p.x;
        cp_async16(a_dst + (tid / 4 + 32 * j) * kPitch + chunk * 16, src, ok);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int row = tid / 4 + 32 * j;
        const int n = n0 + row;
        const bool ok = k_ok && n < p.cout;
        const int8_t* src = ok ? p.wt + static_cast<int64_t>(n) * p.k + k0 : p.wt;
        cp_async16(b_dst + row * kPitch + chunk * 16, src, ok);
      }
    } else {
      // A: this thread's output pixel, the stage's 64 K bytes in (ky, kx, ci) order
      const int k0 = kt * kBK;
      const int tap0 = k0 / p.cin;
      int ci = k0 - tap0 * p.cin;
      int ky = tap0 / p.kw;
      int kx = tap0 - ky * p.kw;
      unsigned words[kBK / 4];
#pragma unroll
      for (int b = 0; b < kBK; ++b) {
        int v = 0;
        if (px[0].ok && ky < p.kh) {  // ky == kh: past K
          const int iy = px[0].iy0 + ky;
          const int ix = px[0].ix0 + kx;
          if (static_cast<unsigned>(iy) < static_cast<unsigned>(p.h) &&
              static_cast<unsigned>(ix) < static_cast<unsigned>(p.w)) {
            v = px[0].img[(static_cast<int64_t>(iy) * p.w + ix) * p.cin + ci];
          }
        }
        const unsigned byte = static_cast<unsigned>(v) & 0xffu;
        words[b / 4] = (b % 4 == 0) ? byte : (words[b / 4] | (byte << (8 * (b % 4))));
        if (++ci == p.cin) {
          ci = 0;
          if (++kx == p.kw) {
            kx = 0;
            ++ky;
          }
        }
      }
      uint4* a_row = reinterpret_cast<uint4*>(a_dst + tid * kPitch);
#pragma unroll
      for (int q = 0; q < kBK / 16; ++q) {
        a_row[q] = make_uint4(words[4 * q], words[4 * q + 1], words[4 * q + 2], words[4 * q + 3]);
      }
      // B: half of weight row tid / 2
      const int row = tid >> 1;
      const int n = n0 + row;
      const int kb = k0 + (tid & 1) * (kBK / 2);
      unsigned wb[kBK / 8];
#pragma unroll
      for (int b = 0; b < kBK / 2; ++b) {
        const int k = kb + b;
        const int v = (n < p.cout && k < p.k) ? p.wt[static_cast<int64_t>(n) * p.k + k] : 0;
        const unsigned byte = static_cast<unsigned>(v) & 0xffu;
        wb[b / 4] = (b % 4 == 0) ? byte : (wb[b / 4] | (byte << (8 * (b % 4))));
      }
      uint4* b_row = reinterpret_cast<uint4*>(b_dst + row * kPitch + (tid & 1) * (kBK / 2));
      b_row[0] = make_uint4(wb[0], wb[1], wb[2], wb[3]);
      b_row[1] = make_uint4(wb[4], wb[5], wb[6], wb[7]);
    }
  };

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < k_tiles) load_stage(s, s);
    cp_async_commit();
  }

  const int wm = warp >> 1;  // the warp's 64 rows of the tile
  const int wn = warp & 1;   // and its 32 columns
  for (int kt = 0; kt < k_tiles; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage kt complete; stage kt - 1 free for the next load
    const int next = kt + kStages - 1;
    if (next < k_tiles) load_stage(next % kStages, next);
    cp_async_commit();

    const int8_t* a_s = sa + (kt % kStages) * kAStage;
    const int8_t* b_s = sb + (kt % kStages) * kBStage;
#pragma unroll
    for (int kk = 0; kk < kBK / 32; ++kk) {
      unsigned af[4][4], bfr[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        ldsm_x4(af[mi], a_s + (wm * 64 + mi * 16 + (lane & 15)) * kPitch + kk * 32 +
                            (lane >> 4) * 16);
      }
#pragma unroll
      for (int pj = 0; pj < 2; ++pj) {
        unsigned r[4];
        ldsm_x4(r, b_s + (wn * 32 + pj * 16 + ((lane >> 4) << 3) + (lane & 7)) * kPitch +
                       kk * 32 + ((lane >> 3) & 1) * 16);
        bfr[2 * pj][0] = r[0];
        bfr[2 * pj][1] = r[1];
        bfr[2 * pj + 1][0] = r[2];
        bfr[2 * pj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], af[mi], bfr[ni][0], bfr[ni][1]);
    }
  }
  cp_async_wait<0>();

  // epilogue: accumulator e of (mi, ni) is row g + 8 (e / 2), column 2 t + e % 2
  const int g = lane >> 2;
  const int t = lane & 3;
  const float rs = p.res_kind == 1 ? *p.res_scale : 0.0f;
  const float inv = p.out_kind == 1 ? *p.inv_out : 0.0f;
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      const int c = n0 + wn * 32 + ni * 8 + 2 * t + e2;
      if (c >= p.cout) continue;
      const float sc = p.scale[c];
      const float bi = p.bias[c];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = m0 + wm * 64 + mi * 16 + g + 8 * hh;
          if (row >= p.m) continue;
          const int64_t idx = static_cast<int64_t>(row) * p.cout + c;
          float o = __fadd_rn(__fmul_rn(__int2float_rn(acc[mi][ni][2 * hh + e2]), sc), bi);
          if (p.res_kind == 1) {
            const float r = static_cast<float>(static_cast<const int8_t*>(p.res)[idx]);
            o = __fadd_rn(o, __fmul_rn(r, rs));
          } else if (p.res_kind == 2) {
            o = __fadd_rn(o, static_cast<const float*>(p.res)[idx]);
          }
          if (p.relu) o = o > 0.0f ? o : 0.0f;  // torch.relu's threshold
          if (p.out_kind == 1) {
            const float q = fminf(fmaxf(rintf(__fmul_rn(o, inv)), -127.0f), 127.0f);
            static_cast<int8_t*>(p.out)[idx] = static_cast<int8_t>(q);
          } else if (p.out_kind == 0) {
            static_cast<__nv_bfloat16*>(p.out)[idx] = __float2bfloat16_rn(o);
          } else {
            static_cast<float*>(p.out)[idx] = o;
          }
        }
      }
    }
  }
}

}  // namespace

// x int8 [n, h, w, cin]; weight int8 [cout, kh*kw*cin]; scale, bias f32
// [cout]; res: null (res_kind 0), int8 [n, ho, wo, cout] with res_scale a f32
// scalar (1) or f32 [n, ho, wo, cout] (2); out [n, ho, wo, cout], out_kind 0 =
// bf16, 1 = int8 (inv_out a f32 scalar), 2 = f32. The pointers of x and weight
// must be 16-byte aligned when cin % 16 == 0. Returns cudaGetLastError() after
// the launch (0 = cudaSuccess); invalid arguments return cudaErrorInvalidValue.
extern "C" int rxtpu_int8_conv(const void* x, const void* weight, const void* scale,
                               const void* bias, const void* res, const void* res_scale,
                               const void* inv_out, void* out, int n, int h, int w, int cin,
                               int cout, int kh, int kw, int stride, int pad, int res_kind,
                               int out_kind, int relu, void* stream) {
  if (n < 0 || h <= 0 || w <= 0 || cin <= 0 || cout <= 0 || kh <= 0 || kw <= 0 ||
      stride <= 0 || pad < 0 || res_kind < 0 || res_kind > 2 || out_kind < 0 || out_kind > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int ho = (h + 2 * pad - kh) / stride + 1;
  const int wo = (w + 2 * pad - kw) / stride + 1;
  const int64_t m = static_cast<int64_t>(n) * ho * wo;
  const int64_t k = static_cast<int64_t>(kh) * kw * cin;
  if (ho <= 0 || wo <= 0 || m > INT32_MAX || k > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (m == 0) return static_cast<int>(cudaSuccess);
  Params p;
  p.x = static_cast<const int8_t*>(x);
  p.wt = static_cast<const int8_t*>(weight);
  p.scale = static_cast<const float*>(scale);
  p.bias = static_cast<const float*>(bias);
  p.res = res;
  p.res_scale = static_cast<const float*>(res_scale);
  p.inv_out = static_cast<const float*>(inv_out);
  p.out = out;
  p.h = h;
  p.w = w;
  p.cin = cin;
  p.cout = cout;
  p.kh = kh;
  p.kw = kw;
  p.stride = stride;
  p.pad = pad;
  p.ho = ho;
  p.wo = wo;
  p.k = static_cast<int>(k);
  p.m = static_cast<int>(m);
  p.res_kind = res_kind;
  p.out_kind = out_kind;
  p.relu = relu;
  const int64_t blocks = ((m + kBM - 1) / kBM) * ((cout + kBN - 1) / kBN);
  if (blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cin % 16 == 0) {
    int8_conv_kernel<true><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(p);
  } else {
    int8_conv_kernel<false><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}
