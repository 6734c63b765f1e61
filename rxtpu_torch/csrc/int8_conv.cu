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
//   out = clip(rint(o * inv_out[c]), -127, 127) int8, or o as bf16 / f32 when there is no out scale
//                                              (inv_out a scalar, or one per output channel)
//
// x is NHWC int8 [n, h, w, cin], zero outside the image; w int8 [cout, kh*kw*cin]
// ("K-major": one row of K per output channel, (ky, kx, ci) order); the output
// and the residual are NHWC [n, ho, wo, cout]. int32 sums do not depend on
// their order, and the epilogue rounds op by op (__fmul_rn / __fadd_rn, never
// contracted into an FMA; __float2int_rn rounds half to even, as jnp.round), so the
// output is bit-equal to the plain version (F.conv2d in float64 on the same
// int8 values, exact below 2^53, then the same epilogue in torch ops).
//
// Bound, per launch (chip_smoke.py computes both): bytes at 3.35 TB/s for the
// 1x1 convs and the stem (the input pixels some tap reads, the residual and
// the output; bf16 views for the stem), operations at the int8 tensor-core
// rate (1,979 TOP/s dense) for the 3x3 convs of stages 2-4 and the deep 1x1
// ones. A ResNet-50 predict batch (96 views of 512^2) is 53 launches, about
// 2 TMAC; its bytes bound (about 4.0 ms) is above its operations bound (2.1
// ms), so the design first moves bytes well.
//
// Design: an implicit GEMM, M = n*ho*wo output pixels, N = cout, K = kh*kw*cin,
// on mma.sync.aligned.m16n8k32 (s8 x s8 -> s32), fragments by ldmatrix.
// - int8_conv_kernel (cin a multiple of 16; the wrapper pads other counts
//   with zero channels): one block per 128 x BN tile, BN = 128 (eight warps)
//   when cout >= 128, else 64 (four warps), warps of 64 x 32. Each 16-byte
//   chunk of a row of A is 16 channels of one tap of one input pixel, each
//   chunk of B 16 bytes of a weight row, both copied by cp.async and
//   zero-filled in the padding and past M, cout and K, through a 3-stage
//   ring of 64-byte K steps (rows padded to 80 bytes: the ldmatrix rows of
//   a phase on distinct banks). On the 1x1 convs with cin 64 a tile is one
//   K step: loads, the epilogue's arithmetic and the stores bound them.
// - The staged epilogue: with the first stages the block copies the tile's
//   residual rows (cp.async, 16-byte chunks) and its columns' scale, bias and
//   requantize scale (one for all, or DenseNet's one per channel) into shared
//   memory, so they arrive during the mainloop. Each thread then
//   takes its accumulators through the epilogue, in a body compiled for the
//   launch's residual and output kinds (no branch on them per element),
//   into a shared output tile over the ring; after one barrier the block
//   writes whole tile rows with 16-byte stores. A residual or output whose
//   rows are not whole 16-byte chunks goes element by element instead.
// - int8_stem_kernel (the stem: 7x7/2, pad 3, cin <= 8, from the NCHW views,
//   bf16 or f32 quantized in the kernel at inv_in as quantize_to does, or
//   int8): a tile is 128 output pixels of one output row by 64 channels; its
//   input patch, 7 rows x 262 columns x 8 channels of int8, is built in
//   shared memory from the views' rows, which come in raw by cp.async during
//   the previous tile's mainloop. With the weights packed [cout][7][8][8] (K
//   = 448; tap 7 and channels past cin zero, packed once when the model is
//   prepared) each output pixel's row of A at kernel row ky is 64 contiguous,
//   16-byte aligned bytes of the patch, so ldmatrix reads A straight from it:
//   no im2col copy and no gather. Persistent blocks stage the weights once.
// - Persistent blocks for int8_conv_kernel, walking their tiles as one
//   stream of K steps so the next tile loads during this one's epilogue,
//   measured slower on every ResNet-50 shape (PERF.md), and are not used.
// - Next: wgmma on s8 and TMA for the mainloop.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTileM = 128;  // output pixels per tile
constexpr int kBK = 64;      // K bytes per ring stage
constexpr int kStages = 3;
constexpr int kPitch = kBK + 16;
constexpr int kMaxDevices = 64;

// The epilogue's operands and the output, [m, cout] row-major.
struct Out {
  const float* scale;      // [cout] w_scale * in_scale
  const float* bias;       // [cout]
  const void* res;         // [m, cout] int8 or f32, or null
  const float* res_scale;  // scalar, for an int8 residual
  const float* inv_out;    // 1 / out_scale for int8 output: a scalar, or [cout] (inv_vec)
  void* out;               // [m, cout]
  int m, cout;
  int res_kind;    // 0 none, 1 int8 with res_scale, 2 f32
  int out_kind;    // 0 bf16, 1 int8, 2 f32
  int relu;
  int inv_vec;     // inv_out holds one scale per output channel (DenseNet's requantize)
  int res_vec;     // the residual's rows are whole 16-byte chunks (staged by cp.async)
  int out_vec;     // and the output's (the tile leaves in 16-byte chunks)
  int prm_vec;     // scale, bias (and inv_out's vector) by cp.async: cout % 4 == 0, 16-byte aligned
};

struct Params {
  const int8_t* x;
  const int8_t* wt;  // [cout, k]
  Out o;
  int h, w, cin, kh, kw, stride, pad, ho, wo, k;
  // shared memory: the ring with the output tile over it, the epilogue's
  // parameters at prm_offset, the residual tile at res_offset
  int prm_offset, res_offset;
};

__host__ __device__ constexpr int out_bytes(int kind) { return kind == 1 ? 1 : kind == 0 ? 2 : 4; }
__host__ __device__ constexpr int res_bytes(int kind) { return kind == 1 ? 1 : kind == 2 ? 4 : 0; }
// the shared-memory pitch of a tile row of bn elements of `bytes` each: 16
// bytes of pad keep the epilogue's fragment stores on distinct banks
__host__ __device__ constexpr int tile_pitch(int bn, int bytes) { return bn * bytes + 16; }
constexpr int cmax(int a, int b) { return a > b ? a : b; }

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

// The tile's residual rows [m0, m0 + rows) x [n0, n0 + BN) into sres (pitch
// tile_pitch(BN, rb)), zero past the rows and past cout: by cp.async in
// 16-byte chunks where the residual's rows are whole chunks (res_vec), else
// element by element with plain loads and stores.
template <int BM, int BN, int kThreads>
__device__ __forceinline__ void stage_residual(const Out& o, int8_t* sres, int m0, int rows,
                                               int n0) {
  const int rb = res_bytes(o.res_kind);
  const int pitch = tile_pitch(BN, rb);
  const char* base = static_cast<const char*>(o.res) + (static_cast<int64_t>(m0) * o.cout + n0) * rb;
  const int64_t gpitch = static_cast<int64_t>(o.cout) * rb;
  if (o.res_vec) {
    const int chunks = BN * rb / 16;      // per tile row
    const int live = (o.cout - n0) * rb;  // bytes of a tile row inside cout
    for (int i = threadIdx.x; i < BM * chunks; i += kThreads) {
      const int r = i / chunks;
      const int c = i - r * chunks;
      const bool ok = r < rows && c * 16 < live;
      cp_async16(sres + r * pitch + c * 16, ok ? base + r * gpitch + c * 16 : o.res, ok);
    }
  } else {
    for (int i = threadIdx.x; i < BM * BN; i += kThreads) {
      const int r = i / BN;
      const int e = i - r * BN;
      const bool ok = r < rows && n0 + e < o.cout;
      const char* src = base + r * gpitch + e * rb;
      int8_t* dst = sres + r * pitch + e * rb;
      if (rb == 1) {
        *dst = ok ? *src : 0;
      } else {
        *reinterpret_cast<float*>(dst) = ok ? *reinterpret_cast<const float*>(src) : 0.0f;
      }
    }
  }
}

// The tile's columns' scale, bias and requantize scale, and the residual's
// scalar scale, into shared memory, so the epilogue finds them there:
// prm[0, BN) scale, [BN, 2 BN) bias, [2 BN, 3 BN) inv_out, zero past cout;
// prm[3 BN] res_scale (zero where the launch has none). A scalar inv_out
// fills its whole part; a vector (inv_vec) comes column by column, as scale
// and bias do: by cp.async in 16-byte chunks where cout is a multiple of 4
// (prm_vec), else by plain loads and stores.
__host__ __device__ constexpr int prm_bytes(int bn) { return (3 * bn + 4) * 4; }

template <int BN, int kThreads>
__device__ __forceinline__ void stage_params(const Out& o, float* prm, int n0) {
  const bool inv_col = o.out_kind == 1 && o.inv_vec;
  const int parts = inv_col ? 3 : 2;  // scale, bias, and the inv_out vector
  if (o.prm_vec) {
    for (int i = threadIdx.x; i < parts * BN / 4; i += kThreads) {
      const int part = i / (BN / 4);
      const int c = 4 * (i - part * (BN / 4));
      const float* src = part == 0 ? o.scale : part == 1 ? o.bias : o.inv_out;
      const bool ok = n0 + c < o.cout;
      cp_async16(prm + part * BN + c, ok ? src + n0 + c : src, ok);
    }
  } else {
    for (int i = threadIdx.x; i < parts * BN; i += kThreads) {
      const int part = i / BN;
      const int c = i - part * BN;
      const float* src = part == 0 ? o.scale : part == 1 ? o.bias : o.inv_out;
      prm[i] = n0 + c < o.cout ? src[n0 + c] : 0.0f;
    }
  }
  if (!inv_col) {
    const float inv = o.out_kind == 1 ? *o.inv_out : 0.0f;
    for (int c = threadIdx.x; c < BN; c += kThreads) prm[2 * BN + c] = inv;
  }
  if (threadIdx.x == 0) prm[3 * BN] = o.res_kind == 1 ? *o.res_scale : 0.0f;
}

// The tile's epilogue, first half, for one residual kind kRes and output
// kind kOut (the kinds of Out; one body each, so the element loop carries no
// branch on them): each thread takes its accumulators to acc*scale + bias
// (+ residual) (ReLU) in the output type and writes them into the shared
// tile sout (pitch tile_pitch(BN, ob)). The caller has made the residual
// tile in sres and the parameters in prm visible, and sout free. Warp (wm, wn) holds rows wm*WM.. and
// columns wn*WN..; accumulator e of (mi, ni) is row g + 8 (e / 2), column
// 2 t + e % 2.
template <int kRes, int kOut, int BN, int WM, int WN>
__device__ __forceinline__ void epilogue_body(const Out& o, const int (&acc)[WM / 16][WN / 8][4],
                                              int8_t* sout, const int8_t* sres,
                                              const float* prm) {
  constexpr int kWarpsN = BN / WN;
  constexpr int ob = out_bytes(kOut);
  constexpr int rb = res_bytes(kRes);
  constexpr int opitch = tile_pitch(BN, ob);
  constexpr int rpitch = tile_pitch(BN, rb);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wm = warp / kWarpsN;
  const int wn = warp % kWarpsN;
  const int g = lane >> 2;
  const int t = lane & 3;
  const bool relu = o.relu;
  const float rs = prm[3 * BN];
#pragma unroll
  for (int ni = 0; ni < WN / 8; ++ni) {
    const int col = wn * WN + ni * 8 + 2 * t;
    const float2 sc = *reinterpret_cast<const float2*>(prm + col);
    const float2 bi = *reinterpret_cast<const float2*>(prm + BN + col);
    const float2 inv = *reinterpret_cast<const float2*>(prm + 2 * BN + col);
#pragma unroll
    for (int mi = 0; mi < WM / 16; ++mi) {
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = wm * WM + mi * 16 + g + 8 * hh;
        float v0 = __fadd_rn(__fmul_rn(__int2float_rn(acc[mi][ni][2 * hh]), sc.x), bi.x);
        float v1 = __fadd_rn(__fmul_rn(__int2float_rn(acc[mi][ni][2 * hh + 1]), sc.y), bi.y);
        if constexpr (kRes == 1) {
          const char2 q = *reinterpret_cast<const char2*>(sres + r * rpitch + col);
          v0 = __fadd_rn(v0, __fmul_rn(static_cast<float>(q.x), rs));
          v1 = __fadd_rn(v1, __fmul_rn(static_cast<float>(q.y), rs));
        } else if constexpr (kRes == 2) {
          const float2 f = *reinterpret_cast<const float2*>(sres + r * rpitch + col * 4);
          v0 = __fadd_rn(v0, f.x);
          v1 = __fadd_rn(v1, f.y);
        }
        // torch.relu's threshold, as a select
        v0 = relu && !(v0 > 0.0f) ? 0.0f : v0;
        v1 = relu && !(v1 > 0.0f) ? 0.0f : v1;
        int8_t* d = sout + r * opitch + col * ob;
        if constexpr (kOut == 1) {  // round half to even, then clip: clip(rint(o * inv[c]))
          const int q0 = max(min(__float2int_rn(__fmul_rn(v0, inv.x)), 127), -127);
          const int q1 = max(min(__float2int_rn(__fmul_rn(v1, inv.y)), 127), -127);
          *reinterpret_cast<char2*>(d) =
              make_char2(static_cast<signed char>(q0), static_cast<signed char>(q1));
        } else if constexpr (kOut == 0) {
          *reinterpret_cast<__nv_bfloat162*>(d) =
              __halves2bfloat162(__float2bfloat16_rn(v0), __float2bfloat16_rn(v1));
        } else {
          *reinterpret_cast<float2*>(d) = make_float2(v0, v1);
        }
      }
    }
  }
}

// The tile's epilogue, first half: epilogue_body for the launch's kinds. A
// thread reads the residual bytes of exactly the elements it writes, so
// sout may lie over sres when the two have one element width.
template <int BN, int WM, int WN>
__device__ __forceinline__ void tile_to_smem(const Out& o, const int (&acc)[WM / 16][WN / 8][4],
                                             int8_t* sout, const int8_t* sres, const float* prm) {
  switch (o.res_kind * 3 + o.out_kind) {
    case 0: epilogue_body<0, 0, BN, WM, WN>(o, acc, sout, sres, prm); break;
    case 1: epilogue_body<0, 1, BN, WM, WN>(o, acc, sout, sres, prm); break;
    case 2: epilogue_body<0, 2, BN, WM, WN>(o, acc, sout, sres, prm); break;
    case 3: epilogue_body<1, 0, BN, WM, WN>(o, acc, sout, sres, prm); break;
    case 4: epilogue_body<1, 1, BN, WM, WN>(o, acc, sout, sres, prm); break;
    case 5: epilogue_body<1, 2, BN, WM, WN>(o, acc, sout, sres, prm); break;
    case 6: epilogue_body<2, 0, BN, WM, WN>(o, acc, sout, sres, prm); break;
    case 7: epilogue_body<2, 1, BN, WM, WN>(o, acc, sout, sres, prm); break;
    default: epilogue_body<2, 2, BN, WM, WN>(o, acc, sout, sres, prm); break;
  }
}

// The tile's epilogue, second half: the shared tile's rows [0, rows) to the
// output rows [m0, m0 + rows), columns [n0, n0 + BN) inside cout, in 16-byte
// chunks (out_vec), else element by element.
template <int BM, int BN, int kThreads>
__device__ __forceinline__ void tile_to_global(const Out& o, const int8_t* sout, int m0,
                                               int rows, int n0) {
  const int ob = out_bytes(o.out_kind);
  const int opitch = tile_pitch(BN, ob);
  const int live = (o.cout - n0 < BN ? o.cout - n0 : BN) * ob;  // bytes of a row inside cout
  const int64_t gpitch = static_cast<int64_t>(o.cout) * ob;
  char* const base = static_cast<char*>(o.out) + (static_cast<int64_t>(m0) * o.cout + n0) * ob;
  if (o.out_vec) {
    const int chunks = BN * ob / 16;
    for (int i = threadIdx.x; i < BM * chunks; i += kThreads) {
      const int r = i / chunks;
      const int c = i - r * chunks;
      if (r < rows && c * 16 < live) {
        *reinterpret_cast<uint4*>(base + r * gpitch + c * 16) =
            *reinterpret_cast<const uint4*>(sout + r * opitch + c * 16);
      }
    }
  } else {
    for (int i = threadIdx.x; i < BM * BN; i += kThreads) {
      const int r = i / BN;
      const int e = i - r * BN;
      if (r < rows && e * ob < live) {
        char* d = base + r * gpitch + e * ob;
        const int8_t* s = sout + r * opitch + e * ob;
        if (ob == 1) {
          *d = *s;
        } else if (ob == 2) {
          *reinterpret_cast<uint16_t*>(d) = *reinterpret_cast<const uint16_t*>(s);
        } else {
          *reinterpret_cast<uint32_t*>(d) = *reinterpret_cast<const uint32_t*>(s);
        }
      }
    }
  }
}

// One output pixel's place in the input: its image and the top-left tap.
struct Pixel {
  const int8_t* img;
  int iy0, ix0;
  bool ok;
};

__device__ __forceinline__ Pixel pixel_of(const Params& p, int m) {
  Pixel px;
  px.ok = m < p.o.m;
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

// A 128 x BN tile with 2 * BN threads: warps of 64 x 32, two along M; cin %
// 16 == 0, so every 16-byte chunk of A is 16 channels of one tap. One block
// per tile (the cout tiles of one row block side by side, so they read the
// same A rows from L2). The tile's residual, and its columns' scale and
// bias, go to shared memory with the first stages, so they arrive during the
// mainloop; the output tile lies over the ring, the residual tile past it.
template <int BN>
__global__ void __launch_bounds__(2 * BN, 256 / BN) int8_conv_kernel(const Params p) {
  constexpr int kThreads = 2 * BN;
  constexpr int BM = kTileM;
  constexpr int kWM = BM / 2;                // the warp's rows
  constexpr int kMI = kWM / 16;
  constexpr int kAStage = BM * kPitch;
  constexpr int kBStage = BN * kPitch;
  constexpr int kStep = kThreads / 4;        // the loader's rows of one thread lie kStep apart
  constexpr int kARows = BM * 4 / kThreads;  // and it loads kARows rows of A, two of B
  extern __shared__ __align__(128) int8_t smem[];
  int8_t* const sa = smem;
  int8_t* const sb = smem + kStages * kAStage;
  const Out& o = p.o;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_tiles = (o.cout + BN - 1) / BN;
  const int m0 = static_cast<int>(blockIdx.x / n_tiles) * BM;
  const int n0 = static_cast<int>(blockIdx.x % n_tiles) * BN;
  const int rows = o.m - m0 < BM ? o.m - m0 : BM;
  const int k_tiles = (p.k + kBK - 1) / kBK;

  if (o.res_kind != 0) stage_residual<BM, BN, kThreads>(o, smem + p.res_offset, m0, rows, n0);
  cp_async_commit();

  Pixel px[kARows];
#pragma unroll
  for (int r = 0; r < kARows; ++r) px[r] = pixel_of(p, m0 + tid / 4 + kStep * r);

  // ring slot `stage` <- K bytes [kt * 64, kt * 64 + 64), chunk tid % 4
  auto load_stage = [&](int stage, int kt) {
    int8_t* a_dst = sa + stage * kAStage;
    int8_t* b_dst = sb + stage * kBStage;
    const int chunk = tid & 3;
    const int k0 = kt * kBK + chunk * 16;
    const bool k_ok = k0 < p.k;
    const int tap = k0 / p.cin;
    const int ci = k0 - tap * p.cin;
    const int ky = tap / p.kw;
    const int kx = tap - ky * p.kw;
#pragma unroll
    for (int r = 0; r < kARows; ++r) {
      const int iy = px[r].iy0 + ky;
      const int ix = px[r].ix0 + kx;
      const bool ok = k_ok && px[r].ok && static_cast<unsigned>(iy) < static_cast<unsigned>(p.h) &&
                      static_cast<unsigned>(ix) < static_cast<unsigned>(p.w);
      const int8_t* src =
          ok ? px[r].img + (static_cast<int64_t>(iy) * p.w + ix) * p.cin + ci : p.x;
      cp_async16(a_dst + (tid / 4 + kStep * r) * kPitch + chunk * 16, src, ok);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = tid / 4 + kStep * r;
      const int n = n0 + row;
      const bool ok = k_ok && n < o.cout;
      const int8_t* src = ok ? p.wt + static_cast<int64_t>(n) * p.k + k0 : p.wt;
      cp_async16(b_dst + row * kPitch + chunk * 16, src, ok);
    }
  };

  int acc[kMI][4][4];
#pragma unroll
  for (int i = 0; i < kMI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < k_tiles) load_stage(s, s);
    cp_async_commit();
  }
  // after the first loads: its scalar loads stall the threads that make them
  float* const prm = reinterpret_cast<float*>(smem + p.prm_offset);
  stage_params<BN, kThreads>(o, prm, n0);

  const int wm = warp / (BN / 32);  // the warp's kWM rows of the tile
  const int wn = warp % (BN / 32);  // and its 32 columns
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
      unsigned af[kMI][4], bfr[4][2];
#pragma unroll
      for (int mi = 0; mi < kMI; ++mi) {
        ldsm_x4(af[mi], a_s + (wm * kWM + mi * 16 + (lane & 15)) * kPitch + kk * 32 +
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
      for (int mi = 0; mi < kMI; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], af[mi], bfr[ni][0], bfr[ni][1]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is past the mainloop (the output tile goes over the ring)
  tile_to_smem<BN, kWM, 32>(o, acc, smem, smem + p.res_offset, prm);
  __syncthreads();
  tile_to_global<BM, BN, kThreads>(o, smem, m0, rows, n0);
}

// ---- the stem: 7x7/2, pad 3, cin <= 8, from the NCHW views -------------------
//
// A tile is 128 output pixels of one output row (oy, ox0 .. ox0 + 127) by 64
// output channels. Its input patch is the 7 input rows 2 oy - 3 + ky by 262
// columns 2 ox0 - 3 + c, 8 channels a column (past cin zero), int8, zero
// outside the image: [7][262][8], 14,672 bytes, the views quantized on the
// way in. With the weights packed [cout][ky][kx 0..7][ch 0..7] (K = 448, tap
// 7 zero), output pixel j's 64-byte row of A at ky starts at patch column
// 2 j: byte (ky * 262 + 2 j) * 8, 16-byte aligned, so ldmatrix reads A from
// the patch as it lies, and rows j .. j + 7 of one 8x8 matrix are 128
// contiguous bytes (no bank conflict). The views' rows under the patch (8-
// column groups from column 2 ox0 - 8, one row per ky and channel) come in
// raw by cp.async during the previous tile's mainloop.
constexpr int kStemThreads = 256;  // 8 warps, 4 x 2 over the tile, 32 x 32 each
constexpr int kStemBM = 128;       // output pixels of one output row
constexpr int kStemBN = 64;
constexpr int kStemKy = 7;
constexpr int kStemK = kStemKy * 64;         // bytes of a packed weight row
constexpr int kStemWPitch = kStemK + 16;     // 29 x 16 bytes: ldmatrix rows on distinct banks
constexpr int kStemW = kStemBN * kStemWPitch;
constexpr int kPatchCols = 2 * kStemBM + 6;
constexpr int kPatchBytes = kStemKy * kPatchCols * 8;
constexpr int kPatchGroups = (2 * kStemBM + 16) / 8;  // 8-column groups of the views' rows
// a raw row: the groups' elements of one (ky, channel), and 16 bytes of pad
__host__ __device__ constexpr int raw_pitch(int elem) { return kPatchGroups * 8 * elem + 16; }

struct StemParams {
  const void* x;        // [n, cin, h, w] int8, bf16 or f32
  const int8_t* wt;     // [cout, 7, 8, 8]
  const float* inv_in;  // scalar 1 / in_scale, for float views
  Out o;
  int cin, h, w, ho, wo;
  int tiles_x;   // tiles per output row: ceil(wo / 128)
  int tiles;     // n * ho * tiles_x
  int vec_rows;  // w % 8 == 0 and x 16-byte aligned: the raw rows come by cp.async
  // shared memory: the weights, the patch (and the output tile over it), the
  // raw rows [7][cin] at raw_offset, the epilogue's parameters at prm_offset
  int raw_offset, prm_offset;
};

// bytes global -> shared (4, 8 or 16), zero-filled where !valid
template <int kBytes>
__device__ __forceinline__ void cp_async_n(void* dst, const void* src, bool valid) {
  if constexpr (kBytes == 16) {
    cp_async16(dst, src, valid);
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "n"(kBytes), "r"(valid ? kBytes : 0)
                 : "memory");
  }
}

__device__ __forceinline__ unsigned quant_byte(float v, float inv) {
  return static_cast<unsigned>(max(min(__float2int_rn(__fmul_rn(v, inv)), 127), -127)) & 0xffu;
}
// one element of the views as a patch byte: float views quantized at inv
__device__ __forceinline__ unsigned patch_byte(int8_t v, float) {
  return static_cast<unsigned>(v) & 0xffu;
}
__device__ __forceinline__ unsigned patch_byte(__nv_bfloat16 v, float inv) {
  return quant_byte(__bfloat162float(v), inv);
}
__device__ __forceinline__ unsigned patch_byte(float v, float inv) { return quant_byte(v, inv); }

template <typename T>
struct __align__(16) Vec8 {
  T e[8];
};

// eight elements from shared memory aligned to their 8 * sizeof(T) bytes
template <typename T>
__device__ __forceinline__ Vec8<T> load8(const int8_t* src) {
  Vec8<T> v;
  if constexpr (sizeof(T) == 1) {
    *reinterpret_cast<uint2*>(v.e) = *reinterpret_cast<const uint2*>(src);
  } else {
#pragma unroll
    for (int q = 0; q < static_cast<int>(sizeof(T)) / 2; ++q) {
      reinterpret_cast<uint4*>(v.e)[q] = reinterpret_cast<const uint4*>(src)[q];
    }
  }
  return v;
}

// The raw rows under tile (img, oy, ox0): element i of group grp of row
// (ky, c) is the views' x[img, c, 2 oy - 3 + ky, 2 ox0 - 8 + 8 grp + i], zero
// outside the image. By cp.async where the rows allow it (a group then lies
// wholly inside or outside a row), else by plain loads and stores.
template <typename T>
__device__ __forceinline__ void stage_raw(const StemParams& p, int8_t* raw, int img, int oy,
                                          int ox0) {
  constexpr int kChunk = 8 * sizeof(T) < 16 ? 8 * sizeof(T) : 16;  // bytes a copy
  constexpr int kPerGroup = 8 * sizeof(T) / kChunk;
  constexpr int kElems = kChunk / sizeof(T);
  const T* x = static_cast<const T*>(p.x);
  const int pitch = raw_pitch(sizeof(T));
  const int n = kStemKy * p.cin * kPatchGroups * kPerGroup;
  for (int i = threadIdx.x; i < n; i += kStemThreads) {
    const int q = i % kPerGroup;
    const int grp = i / kPerGroup % kPatchGroups;
    const int row = i / (kPerGroup * kPatchGroups);  // ky * cin + c
    const int ky = row / p.cin;
    const int c = row - ky * p.cin;
    const int iy = 2 * oy - 3 + ky;
    const int ix0 = 2 * ox0 - 8 + 8 * grp + q * kElems;
    const T* src = x + ((static_cast<int64_t>(img) * p.cin + c) * p.h + iy) * p.w + ix0;
    int8_t* dst = raw + row * pitch + (8 * grp + q * kElems) * static_cast<int>(sizeof(T));
    const bool row_ok = static_cast<unsigned>(iy) < static_cast<unsigned>(p.h);
    if (p.vec_rows) {
      const bool ok = row_ok && ix0 >= 0 && ix0 + kElems <= p.w;
      cp_async_n<kChunk>(dst, ok ? src : x, ok);
    } else {
#pragma unroll
      for (int e = 0; e < kElems; ++e) {
        const bool ok = row_ok && static_cast<unsigned>(ix0 + e) < static_cast<unsigned>(p.w);
        reinterpret_cast<T*>(dst)[e] = ok ? src[e] : T{};
      }
    }
  }
}

// The patch from the raw rows: a thread per (ky, group) takes the group's 8
// columns of each channel, quantizes them and writes each column's 8
// channels as one 8-byte word. Raw column 8 grp + i is patch column
// 8 grp + i - 5.
template <typename T>
__device__ __forceinline__ void raw_to_patch(const StemParams& p, const int8_t* raw,
                                             int8_t* patch, float inv) {
  const int pitch = raw_pitch(sizeof(T));
  // ky runs fastest across a warp: its 8-byte stores then spread over the
  // banks (patch rows lie 12 banks apart), where neighbouring groups of one
  // row would put a warp's stores on two
  for (int task = threadIdx.x; task < kStemKy * kPatchGroups; task += kStemThreads) {
    const int grp = task / kStemKy;
    const int ky = task - grp * kStemKy;
    unsigned lo[8], hi[8];  // column i's channels 0-3 and 4-7, a byte each
#pragma unroll
    for (int i = 0; i < 8; ++i) lo[i] = hi[i] = 0u;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      if (c < p.cin) {
        const Vec8<T> v =
            load8<T>(raw + (ky * p.cin + c) * pitch + 8 * grp * static_cast<int>(sizeof(T)));
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const unsigned b = patch_byte(v.e[i], inv) << (8 * (c & 3));
          if (c < 4) {
            lo[i] |= b;
          } else {
            hi[i] |= b;
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int pc = 8 * grp + i - 5;
      if (static_cast<unsigned>(pc) < static_cast<unsigned>(kPatchCols)) {
        *reinterpret_cast<uint2*>(patch + (ky * kPatchCols + pc) * 8) = make_uint2(lo[i], hi[i]);
      }
    }
  }
}

// Persistent blocks: blockIdx.y picks 64 output channels, whose weights the
// block stages once; it then walks the tiles blockIdx.x, + gridDim.x, ...
// (neighbouring output rows run at once, so the input rows they share come
// from L2), along with its scale and bias. Per tile: the patch from the raw
// rows, the next tile's raw rows in flight during 14 k32 steps, the staged
// epilogue with the output tile over the patch. The stem has no residual.
template <typename T>
__global__ void __launch_bounds__(kStemThreads, 2) int8_stem_kernel(const StemParams p) {
  extern __shared__ __align__(128) int8_t smem[];
  int8_t* const sw = smem;
  int8_t* const patch = smem + kStemW;
  int8_t* const raw = smem + p.raw_offset;
  float* const prm = reinterpret_cast<float*>(smem + p.prm_offset);
  const Out& o = p.o;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int wm = warp >> 1;  // the warp's 32 rows
  const int wn = warp & 1;   // and 32 columns
  const int n0 = blockIdx.y * kStemBN;
  const float inv = sizeof(T) == 1 ? 0.0f : *p.inv_in;
  auto stage_tile = [&](int tile) {
    const int t = tile / p.tiles_x;
    stage_raw<T>(p, raw, t / p.ho, t % p.ho, (tile % p.tiles_x) * kStemBM);
  };
  for (int i = tid; i < kStemBN * (kStemK / 16); i += kStemThreads) {
    const int r = i / (kStemK / 16);
    const int c = i - r * (kStemK / 16);
    const bool ok = n0 + r < o.cout;
    const int8_t* src = ok ? p.wt + static_cast<int64_t>(n0 + r) * kStemK + c * 16 : p.wt;
    cp_async16(sw + r * kStemWPitch + c * 16, src, ok);
  }
  stage_tile(blockIdx.x);
  stage_params<kStemBN, kStemThreads>(o, prm, n0);  // last: its scalar loads stall
  cp_async_commit();
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    const int tx = tile % p.tiles_x;
    const int t = tile / p.tiles_x;
    const int ox0 = tx * kStemBM;
    const int rows = p.wo - ox0 < kStemBM ? p.wo - ox0 : kStemBM;
    const int m0 = t * p.wo + ox0;  // (img * ho + oy) * wo + ox0
    cp_async_wait<0>();
    __syncthreads();  // the raw rows are in; the last tile's output has left the patch
    raw_to_patch<T>(p, raw, patch, inv);
    __syncthreads();  // the patch is whole; the raw rows are free
    if (tile + gridDim.x < p.tiles) stage_tile(tile + gridDim.x);
    cp_async_commit();

    int acc[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
#pragma unroll
    for (int ky = 0; ky < kStemKy; ++ky) {
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        unsigned af[2][4], bfr[4][2];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const int j = wm * 32 + mi * 16 + (lane & 15);
          ldsm_x4(af[mi], patch + (ky * kPatchCols + 2 * j) * 8 + kk * 32 + (lane >> 4) * 16);
        }
#pragma unroll
        for (int pj = 0; pj < 2; ++pj) {
          unsigned r[4];
          ldsm_x4(r, sw + (wn * 32 + pj * 16 + ((lane >> 4) << 3) + (lane & 7)) * kStemWPitch +
                         ky * 64 + kk * 32 + ((lane >> 3) & 1) * 16);
          bfr[2 * pj][0] = r[0];
          bfr[2 * pj][1] = r[1];
          bfr[2 * pj + 1][0] = r[2];
          bfr[2 * pj + 1][1] = r[3];
        }
#pragma unroll
        for (int mi = 0; mi < 2; ++mi)
#pragma unroll
          for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], af[mi], bfr[ni][0], bfr[ni][1]);
      }
    }
    __syncthreads();  // every warp is past its mainloop: the output tile goes over the patch
    tile_to_smem<kStemBN, 32, 32>(o, acc, patch, nullptr, prm);
    __syncthreads();
    tile_to_global<kStemBM, kStemBN, kStemThreads>(o, patch, m0, rows, n0);
  }
}

// ---- host side -----------------------------------------------------------------

// the kernel's dynamic shared-memory limit, set once per device
template <typename Kernel>
int set_smem(Kernel kernel, int bytes, bool (&done_on)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!done_on[dev]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    done_on[dev] = true;
  }
  return 0;
}

// blocks of `kernel` that fit on the device at once (all SMs)
template <typename Kernel>
int resident_blocks(Kernel kernel, int threads, int smem, int& blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  blocks = per_sm * sms;
  return 0;
}

// Shared memory: the ring with the output tile over it, the parameters, the
// residual tile.
template <int BN>
int launch_conv(Params p, cudaStream_t st) {
  constexpr int kRing = kStages * (kTileM + BN) * kPitch;
  constexpr int kMaxTile = kTileM * tile_pitch(BN, 4);
  static bool attr_set[kMaxDevices] = {};
  const int err = set_smem(int8_conv_kernel<BN>,
                           cmax(kRing, kMaxTile) + prm_bytes(BN) + kMaxTile, attr_set);
  if (err != 0) return err;
  p.prm_offset = cmax(kRing, kTileM * tile_pitch(BN, out_bytes(p.o.out_kind)));
  p.res_offset = p.prm_offset + prm_bytes(BN);
  const int smem =
      p.res_offset + (p.o.res_kind != 0 ? kTileM * tile_pitch(BN, res_bytes(p.o.res_kind)) : 0);
  const int64_t blocks =
      static_cast<int64_t>((p.o.m + kTileM - 1) / kTileM) * ((p.o.cout + BN - 1) / BN);
  if (blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  int8_conv_kernel<BN><<<static_cast<unsigned>(blocks), 2 * BN, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// Shared memory: the weights, the patch with the output tile over it, the
// raw rows, the parameters. As many blocks as are resident, each walking
// tiles.
template <typename T>
int launch_stem(StemParams p, int cout, cudaStream_t st) {
  constexpr int kMaxTile = kStemBM * tile_pitch(kStemBN, 4);
  constexpr int kMaxSmem = kStemW + cmax(kPatchBytes, kMaxTile) +
                           kStemKy * 8 * raw_pitch(sizeof(T)) + prm_bytes(kStemBN);
  static_assert(kMaxSmem <= 227 * 1024, "a block's shared memory");
  static bool attr_set[kMaxDevices] = {};
  int err = set_smem(int8_stem_kernel<T>, kMaxSmem, attr_set);
  if (err != 0) return err;
  p.raw_offset =
      kStemW + cmax(kPatchBytes, kStemBM * tile_pitch(kStemBN, out_bytes(p.o.out_kind)));
  p.prm_offset = p.raw_offset + kStemKy * p.cin * raw_pitch(sizeof(T));
  const int smem = p.prm_offset + prm_bytes(kStemBN);
  int blocks = 0;
  err = resident_blocks(int8_stem_kernel<T>, kStemThreads, smem, blocks);
  if (err != 0) return err;
  const dim3 grid(static_cast<unsigned>(p.tiles < blocks ? p.tiles : blocks),
                  static_cast<unsigned>((cout + kStemBN - 1) / kStemBN));
  int8_stem_kernel<T><<<grid, kStemThreads, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

bool epilogue_ok(int res_kind, int out_kind) {
  return res_kind >= 0 && res_kind <= 2 && out_kind >= 0 && out_kind <= 2;
}

Out make_out(const void* scale, const void* bias, const void* res, const void* res_scale,
             const void* inv_out, void* out, int64_t m, int cout, int res_kind, int out_kind,
             int relu, int inv_vec) {
  Out o;
  o.scale = static_cast<const float*>(scale);
  o.bias = static_cast<const float*>(bias);
  o.res = res;
  o.res_scale = static_cast<const float*>(res_scale);
  o.inv_out = static_cast<const float*>(inv_out);
  o.out = out;
  o.m = static_cast<int>(m);
  o.cout = cout;
  o.res_kind = res_kind;
  o.out_kind = out_kind;
  o.relu = relu;
  o.inv_vec = out_kind == 1 && inv_vec;
  o.res_vec = res_kind != 0 && (cout * res_bytes(res_kind)) % 16 == 0 && aligned16(res);
  o.out_vec = (cout * out_bytes(out_kind)) % 16 == 0 && aligned16(out);
  o.prm_vec = cout % 4 == 0 && aligned16(scale) && aligned16(bias) &&
              (!o.inv_vec || aligned16(inv_out));
  return o;
}

}  // namespace

// x int8 [n, h, w, cin] with cin % 16 == 0, 16-byte aligned; weight int8
// [cout, kh*kw*cin], 16-byte aligned; scale, bias f32 [cout]; res: null
// (res_kind 0), int8 [n, ho, wo, cout] with res_scale a f32 scalar (1) or f32
// [n, ho, wo, cout] (2); out [n, ho, wo, cout], out_kind 0 = bf16, 1 = int8
// (inv_out a f32 scalar, or f32 [cout] when inv_vec), 2 = f32. Returns
// cudaGetLastError() after the launch (0 = cudaSuccess); invalid arguments
// return cudaErrorInvalidValue.
extern "C" int rxtpu_int8_conv(const void* x, const void* weight, const void* scale,
                               const void* bias, const void* res, const void* res_scale,
                               const void* inv_out, void* out, int n, int h, int w, int cin,
                               int cout, int kh, int kw, int stride, int pad, int res_kind,
                               int out_kind, int relu, int inv_vec, void* stream) {
  if (n < 0 || h <= 0 || w <= 0 || cin <= 0 || cin % 16 != 0 || cout <= 0 || kh <= 0 ||
      kw <= 0 || stride <= 0 || pad < 0 || !epilogue_ok(res_kind, out_kind)) {
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
  p.o = make_out(scale, bias, res, res_scale, inv_out, out, m, cout, res_kind, out_kind, relu,
                 inv_vec);
  p.h = h;
  p.w = w;
  p.cin = cin;
  p.kh = kh;
  p.kw = kw;
  p.stride = stride;
  p.pad = pad;
  p.ho = ho;
  p.wo = wo;
  p.k = static_cast<int>(k);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return cout >= 128 ? launch_conv<128>(p, st) : launch_conv<64>(p, st);
}

// The stem conv (7x7, stride 2, pad 3) from NCHW views x [n, cin, h, w],
// cin <= 8: x_kind 0 = bf16 or 2 = f32, quantized at inv_in (a f32 scalar,
// 1 / in_scale), or 1 = int8. weight int8 [cout, 7, 8, 8], 16-byte aligned;
// the epilogue's operands and the output as rxtpu_int8_conv's, with no
// residual (res_kind 0).
extern "C" int rxtpu_int8_stem_conv(const void* x, const void* weight, const void* inv_in,
                                    const void* scale, const void* bias, const void* res,
                                    const void* res_scale, const void* inv_out, void* out,
                                    int n, int cin, int h, int w, int cout, int x_kind,
                                    int res_kind, int out_kind, int relu, int inv_vec,
                                    void* stream) {
  if (n < 0 || cin <= 0 || cin > 8 || h <= 0 || w <= 0 || cout <= 0 || x_kind < 0 ||
      x_kind > 2 || (x_kind != 1 && inv_in == nullptr) || res_kind != 0 ||
      !epilogue_ok(res_kind, out_kind)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int ho = (h - 1) / 2 + 1;  // (h + 2 * 3 - 7) / 2 + 1
  const int wo = (w - 1) / 2 + 1;
  const int tiles_x = (wo + kStemBM - 1) / kStemBM;
  const int64_t m = static_cast<int64_t>(n) * ho * wo;
  const int64_t tiles = static_cast<int64_t>(n) * ho * tiles_x;
  if (m > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0) return static_cast<int>(cudaSuccess);
  StemParams p;
  p.x = x;
  p.wt = static_cast<const int8_t*>(weight);
  p.inv_in = static_cast<const float*>(inv_in);
  p.o = make_out(scale, bias, res, res_scale, inv_out, out, m, cout, res_kind, out_kind, relu,
                 inv_vec);
  p.cin = cin;
  p.h = h;
  p.w = w;
  p.ho = ho;
  p.wo = wo;
  p.tiles_x = tiles_x;
  p.tiles = static_cast<int>(tiles);
  p.vec_rows = w % 8 == 0 && aligned16(x);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_kind == 1) return launch_stem<int8_t>(p, cout, st);
  if (x_kind == 0) return launch_stem<__nv_bfloat16>(p, cout, st);
  return launch_stem<float>(p, cout, st);
}
