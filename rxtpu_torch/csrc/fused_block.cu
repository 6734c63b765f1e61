// K6 and K7: the fused train-mode ResNet bottleneck, forward and backward.
//
// Replaces the eight Pallas TPU kernels of rxtpu/ops/fused_block.py: the
// forward bodies _k1_kernel (c1 = x w1 with the BN1 sums, and the projection's
// sums), _k2_kernel (the 3x3 SAME conv over a1 = relu(bn1(c1)) with the BN2
// sums), _k3_kernel (the BN3 sums of c3 = relu(bn2(c2)) w3), _k4_kernel
// (y = relu(bn3(c3) + residual)), and the backward bodies _b1_kernel (the
// BN3 sums), _b2_kernel (dc3, dw3, g2 and the BN2 sums), _b3_kernel (dc2,
// dw2, the adjoint 3x3 conv to g1 and the BN1 sums) and _b4_kernel (dc1,
// dw1, dwp and dx). rxtpu_torch/ops/fused_block.py launches them, one body
// as one or more of the launches below.
//
// Layout: a [R, C] bf16 slab, R = V*H*W rows (the pixels of V views, row
// major), channels contiguous. No pad rows: a 3x3 tap reads row
// r + dy*W + dx only where (y+dy, x+dx) lies inside the view's plane, and 0
// elsewhere (SAME padding), so no tap reads across views.
//
// Two kernel templates, launched eight ways:
//
// gemm_kernel<MODE, EPI>: out[r, n] = sum_k A(r, k) W[k, n] over a 64x64 tile
// of rows and output channels, W [K, N] bf16 row major. A(r, k) is
//   kStored      src[r, k];
//   kBnRelu      bf16(relu(src[r, k]*scale[k] + shift[k])) (a1 or a2);
//   kTapBnRelu   the same at the 3x3 neighbour of tap k / kc, channel k % kc
//                (taps in (ky, kx) row-major order, as rxtpu's _OFFSETS);
//   kTapAdjoint  src at the neighbour across the negated offset (the
//                transposed conv: W holds w2[tap] transposed per tap).
// The epilogue (EPI) stores bf16 values, and for the BN sums writes one
// partial sum per (64-row tile, channel), reduced afterwards in a fixed
// order by reduce_kernel.
//
// wgrad_kernel<MODE>: dW[k, n] = sum_r A(r, k) D(r, n) over a chunk of 2048
// rows (A as above with a fixed tap, D a stored bf16 slab); one f32 partial
// per chunk, reduced by reduce_kernel in chunk order.
//
// bn_backward_kernel: dc = bf16(k*(g - da - ((c - mean)*inv)*db)), the BN
// backward of _b3_kernel (dc2) and _b4_kernel (dc1), elementwise.
//
// Every reduction is deterministic: no float atomics; per-tile partials are
// summed in a fixed order. So c3, computed by the same template in K6.3,
// K6.4, K7.1 and K7.2, comes out bit for bit the same each time, as rxtpu's
// recomputation assumes.
//
// Rounding follows the plain PyTorch version op by op: every v*scale + shift
// and every BN-backward term is a separately rounded __fmul_rn / __fadd_rn /
// __fsub_rn (nvcc would otherwise contract them into FMAs), values are
// rounded to bf16 with __float2bfloat16_rn where rxtpu rounds (c1, c2, c3,
// a1, a2, bn3, res, y, dc3, g2, dc2, g1, dc1, dcp, dx), comparisons run on
// the bf16 values promoted to f32, and the BN sums read the bf16-rounded
// values. A bf16 x bf16 product is exact in f32: the products run on the
// tensor cores (wmma 16x16x16, f32 accumulators), so only the order of the
// f32 sums differs from the plain version.
//
// Bound: at ResNet-50's shapes (V = 48 views) most bodies move more bytes
// than their tensor-core time: e.g. K6.1 at a stage-1 identity block reads
// 203.5 MB of x and writes 50.9 MB of c1, 0.076 ms at 3.35 TB/s, against
// 13.0 GFLOP, 0.013 ms at 989 TFLOP/s; the 3x3 bodies (K6.2, K7.3) are near
// the balance. This first version stages its tiles through shared memory
// without a copy pipeline (no cp.async, TMA or wgmma), re-reads A once per
// 64-wide column tile, and materializes dc3, dc2, dc1 and dcp in device
// memory; chip_smoke.py prints each body's time beside its bound.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using bf16 = __nv_bfloat16;
using namespace nvcuda;

constexpr int kBM = 64;           // rows per tile
constexpr int kBN = 64;           // output channels per tile
constexpr int kBK = 32;           // reduction depth per stage
constexpr int kThreads = 128;     // four warps, each a 32x32 quarter of the tile
constexpr int kLdA = kBK + 8;     // staged A row pitch (bf16)
constexpr int kLdW = kBN + 8;     // staged W row pitch (bf16)
constexpr int kLdC = kBN + 4;     // staged result row pitch (f32)
constexpr int kLdT = 64 + 8;      // weight-gradient tiles' row pitch (bf16)
constexpr int kReduceLanes = 8;   // partial sums per output, per reduce block
constexpr int kReduceGroup = 64;  // partials summed by one block before a second pass

enum AMode { kStored = 0, kBnRelu = 1, kTapBnRelu = 2, kTapAdjoint = 3 };
enum Epi {
  kStoreStats = 0,  // store bf16(acc); sums of v and v*v (c1, c2)
  kStats = 1,       // sums of v and v*v of v = bf16(acc), no store (c3, cp)
  kResidual = 2,    // store bf16(bf16(acc)*scale + shift) (the projection's BN)
  kOutput = 3,      // store bf16(max(bf16(bf16(acc)*scale + shift) + res, 0)) (y)
  kBnSums = 4,      // sums of g3 and g3*xhat, xhat = (bf16(acc) - mean)*inv
  kBnBackward = 5,  // store bf16(k*(g3 - da - xhat*db)) (dc3, dcp)
  kReluGrad = 6,    // store g = bf16(acc*[a > 0]), a = bn_relu(c); sums of g and g*xhat(c)
  kInputGrad = 7,   // store bf16(acc [+ g3]) (dx)
};

}  // namespace

// The launch arguments, mirrored by ctypes structures in
// rxtpu_torch/ops/fused_block.py. Outside the anonymous namespace: the
// extern "C" entry points that take them must keep external linkage.
namespace rxtpu_fb {

// A(r, k) of a GEMM over the rows of a slab
struct ASrc {
  const bf16* ptr;      // ptr[r * ld + col + k]
  long long ld;
  int col;
  int kc;               // channels per tap (tap modes)
  const float* scale;   // the prologue's BN scale and shift, by channel
  const float* shift;
  int height;           // the plane (tap modes)
  int width;
};

struct GemmArgs {
  ASrc a;
  const bf16* w;        // [k, n]
  long long rows;
  int k;
  int n;
  int mode;
  int epi;
  bf16* out;            // out[r * ldo + out_col + n]
  long long ldo;
  int out_col;
  int add_g3;           // kInputGrad: add the identity residual's g3
  const bf16* aux0;     // dy (kBnSums, kBnBackward, kInputGrad), res (kOutput) or c (kReluGrad)
  const bf16* aux1;     // y
  long long ldaux;
  const float* e_scale;
  const float* e_shift;
  const float* e_mean;
  const float* e_inv;
  const float* e_k;
  const float* e_da;
  const float* e_db;
  float* part0;         // [ceil(rows / 64), n] partial sums
  float* part1;
};

struct WgradArgs {
  ASrc a;
  int mode;
  int taps;             // 1, or 9: blockIdx.z % taps is the tap (kTapBnRelu)
  const bf16* d;        // d[r * ldd + d_col + n]
  long long ldd;
  long long rows;
  int k;
  int n;
  int d_col;
  int chunk_rows;
  float* part;          // [chunks, taps, k, n]
};

struct BnBwdArgs {
  const bf16* g;        // g, c [rows, n], row pitch ld
  const bf16* c;
  long long ld;
  const float* k;
  const float* da;
  const float* db;
  const float* mean;
  const float* inv;
  bf16* out;            // out[r * ldo + out_col + j]
  long long ldo;
  long long rows;
  int n;
  int out_col;
};

}  // namespace rxtpu_fb

namespace {

using rxtpu_fb::ASrc;
using rxtpu_fb::BnBwdArgs;
using rxtpu_fb::GemmArgs;
using rxtpu_fb::WgradArgs;

union Pack8 {
  uint4 u;
  __nv_bfloat162 h[4];
};

__device__ __forceinline__ float bn_relu(float v, float scale, float shift) {
  return __bfloat162float(__float2bfloat16_rn(fmaxf(__fadd_rn(__fmul_rn(v, scale), shift), 0.0f)));
}

// 8 consecutive channels k..k+7 of A at row r (pixel (y, x)); zero past the
// slab's end and, in the tap modes, where the neighbour lies outside the plane
template <int MODE>
__device__ __forceinline__ uint4 a_chunk(const ASrc& a, long long rows, long long r, int k) {
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  if (r >= rows) return zero;
  long long src = r;
  int f = k;
  if (MODE == kTapBnRelu || MODE == kTapAdjoint) {
    const int tap = k / a.kc;
    f = k - tap * a.kc;
    int dy = tap / 3 - 1, dx = tap % 3 - 1;
    if (MODE == kTapAdjoint) {
      dy = -dy;
      dx = -dx;
    }
    const int plane = a.height * a.width;
    const int p = static_cast<int>(r % plane);
    const int y = p / a.width + dy, x = p % a.width + dx;
    if (y < 0 || y >= a.height || x < 0 || x >= a.width) return zero;
    src = r + dy * a.width + dx;
  }
  Pack8 v;
  v.u = *reinterpret_cast<const uint4*>(a.ptr + src * a.ld + a.col + f);
  if (MODE == kBnRelu || MODE == kTapBnRelu) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 x = __bfloat1622float2(v.h[j]);
      v.h[j] = __floats2bfloat162_rn(bn_relu(x.x, __ldg(a.scale + f + 2 * j), __ldg(a.shift + f + 2 * j)),
                                     bn_relu(x.y, __ldg(a.scale + f + 2 * j + 1),
                                             __ldg(a.shift + f + 2 * j + 1)));
    }
  }
  return v.u;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// g3 = dy * [y > 0] in bf16 (dy or a signed zero), as f32
__device__ __forceinline__ float g3_at(const GemmArgs& g, long long i) {
  const float dy = __bfloat162float(g.aux0[i]);
  return __bfloat162float(g.aux1[i]) > 0.0f ? dy : __fmul_rn(dy, 0.0f);
}

template <int MODE, int EPI>
__global__ void __launch_bounds__(kThreads) gemm_kernel(const GemmArgs g) {
  // the results [64][68] f32, then a second [64][68] f32 array for the sums,
  // which lies over the staged operand tiles
  __shared__ __align__(128) unsigned char smem[2 * kBM * kLdC * 4];
  float* cs = reinterpret_cast<float*>(smem);
  float* ss = cs + kBM * kLdC;
  bf16* as = reinterpret_cast<bf16*>(ss);  // [64][40]
  bf16* ws = as + kBM * kLdA;              // [32][72]

  const int tid = threadIdx.x, warp = tid / 32;
  const int wm = warp / 2, wn = warp % 2;
  const long long m0 = static_cast<long long>(blockIdx.y) * kBM;
  const int n0 = blockIdx.x * kBN;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
  }
  const int a_row = tid / 4, a_kq = (tid % 4) * 8;
  for (int k0 = 0; k0 < g.k; k0 += kBK) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = a_row + 32 * i;
      *reinterpret_cast<uint4*>(as + row * kLdA + a_kq) =
          a_chunk<MODE>(g.a, g.rows, m0 + row, k0 + a_kq);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + kThreads * i;
      const int kr = c / 8, nq = (c % 8) * 8;
      *reinterpret_cast<uint4*>(ws + kr * kLdW + nq) =
          *reinterpret_cast<const uint4*>(g.w + static_cast<long long>(k0 + kr) * g.n + n0 + nq);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        wmma::load_matrix_sync(fa[i], as + (wm * 32 + i * 16) * kLdA + kk, kLdA);
        wmma::load_matrix_sync(fb[i], ws + kk * kLdW + wn * 32 + i * 16, kLdW);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(cs + (wm * 32 + i * 16) * kLdC + wn * 32 + j * 16, acc[i][j], kLdC,
                              wmma::mem_row_major);
    }
  }
  __syncthreads();

  constexpr bool kSums = EPI == kStoreStats || EPI == kStats || EPI == kBnSums || EPI == kReluGrad;
  for (int e = tid; e < kBM * kBN; e += kThreads) {
    const int row = e / kBN, col = e % kBN;
    const long long r = m0 + row;
    const int n = n0 + col;
    float v1 = 0.0f, v2 = 0.0f;
    if (r < g.rows) {
      const float acc_v = cs[row * kLdC + col];
      const long long o = r * g.ldo + g.out_col + n;
      const long long ia = r * g.ldaux + n;
      if (EPI == kStoreStats || EPI == kStats) {
        const bf16 b = __float2bfloat16_rn(acc_v);
        if (EPI == kStoreStats) g.out[o] = b;
        v1 = __bfloat162float(b);
        v2 = __fmul_rn(v1, v1);
      } else if (EPI == kResidual) {
        g.out[o] = __float2bfloat16_rn(
            __fadd_rn(__fmul_rn(round_bf16(acc_v), __ldg(g.e_scale + n)), __ldg(g.e_shift + n)));
      } else if (EPI == kOutput) {
        const float bn3 = round_bf16(
            __fadd_rn(__fmul_rn(round_bf16(acc_v), __ldg(g.e_scale + n)), __ldg(g.e_shift + n)));
        const float res = __bfloat162float(g.aux0[ia]);
        g.out[o] = __float2bfloat16_rn(fmaxf(__fadd_rn(bn3, res), 0.0f));
      } else if (EPI == kBnSums || EPI == kBnBackward) {
        const float g3 = g3_at(g, ia);
        const float xhat = __fmul_rn(__fsub_rn(round_bf16(acc_v), __ldg(g.e_mean + n)),
                                     __ldg(g.e_inv + n));
        if (EPI == kBnSums) {
          v1 = g3;
          v2 = __fmul_rn(g3, xhat);
        } else {
          g.out[o] = __float2bfloat16_rn(__fmul_rn(
              __ldg(g.e_k + n),
              __fsub_rn(__fsub_rn(g3, __ldg(g.e_da + n)), __fmul_rn(xhat, __ldg(g.e_db + n)))));
        }
      } else if (EPI == kReluGrad) {
        const float c = __bfloat162float(g.aux0[ia]);
        const float a = bn_relu(c, __ldg(g.e_scale + n), __ldg(g.e_shift + n));
        const bf16 gb = __float2bfloat16_rn(__fmul_rn(acc_v, a > 0.0f ? 1.0f : 0.0f));
        g.out[o] = gb;
        v1 = __bfloat162float(gb);
        v2 = __fmul_rn(v1, __fmul_rn(__fsub_rn(c, __ldg(g.e_mean + n)), __ldg(g.e_inv + n)));
      } else if (EPI == kInputGrad) {
        const float v = g.add_g3 ? __fadd_rn(acc_v, g3_at(g, ia)) : acc_v;
        g.out[o] = __float2bfloat16_rn(v);
      }
    }
    if (kSums) {
      cs[row * kLdC + col] = v1;
      ss[row * kLdC + col] = v2;
    }
  }
  if (kSums) {
    __syncthreads();
    // one thread per (array, column) sums the tile's 64 rows in order
    const float* src = tid < kBN ? cs : ss;
    const int col = tid % kBN;
    float s = 0.0f;
    for (int row = 0; row < kBM; ++row) s = __fadd_rn(s, src[row * kLdC + col]);
    float* part = tid < kBN ? g.part0 : g.part1;
    part[static_cast<long long>(blockIdx.y) * g.n + n0 + col] = s;
  }
}

template <int MODE>
__global__ void __launch_bounds__(kThreads) wgrad_kernel(const WgradArgs g) {
  __shared__ __align__(128) bf16 at[kBK * kLdT];  // A rows x 64 input channels
  __shared__ __align__(128) bf16 dt[kBK * kLdT];  // D rows x 64 output channels
  const int tid = threadIdx.x, warp = tid / 32;
  const int wm = warp / 2, wn = warp % 2;
  const int n0 = blockIdx.x * 64, k0 = blockIdx.y * 64;
  const int tap = blockIdx.z % g.taps;
  const int chunk = blockIdx.z / g.taps;
  const long long r_begin = static_cast<long long>(chunk) * g.chunk_rows;
  long long r_end = r_begin + g.chunk_rows;
  if (r_end > g.rows) r_end = g.rows;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
  }
  for (long long r0 = r_begin; r0 < r_end; r0 += kBK) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + kThreads * i;
      const int rr = c / 8, q = (c % 8) * 8;
      const long long r = r0 + rr;
      *reinterpret_cast<uint4*>(at + rr * kLdT + q) =
          a_chunk<MODE>(g.a, r_end, r, tap * g.a.kc + k0 + q);
      uint4 d = make_uint4(0u, 0u, 0u, 0u);
      if (r < r_end) d = *reinterpret_cast<const uint4*>(g.d + r * g.ldd + g.d_col + n0 + q);
      *reinterpret_cast<uint4*>(dt + rr * kLdT + q) = d;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        wmma::load_matrix_sync(fa[i], at + kk * kLdT + wm * 32 + i * 16, kLdT);
        wmma::load_matrix_sync(fb[i], dt + kk * kLdT + wn * 32 + i * 16, kLdT);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
    }
    __syncthreads();
  }
  float* part = g.part + (static_cast<long long>(chunk) * g.taps + tap) * g.k * g.n;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(
          part + static_cast<long long>(k0 + wm * 32 + i * 16) * g.n + n0 + wn * 32 + j * 16,
          acc[i][j], g.n, wmma::mem_row_major);
    }
  }
}

// out[g * size + i] = sum over the partials c in [g * per, (g + 1) * per) of
// part[c * size + i], in a fixed order: lane y takes c = y, y + 8, ..., then
// the eight lanes are added in order
__global__ void reduce_kernel(const float* __restrict__ part, float* __restrict__ out, int chunks,
                              long long size, int per) {
  __shared__ float lanes[kReduceLanes][33];
  const long long i = static_cast<long long>(blockIdx.x) * 32 + threadIdx.x;
  const int c0 = blockIdx.y * per;
  int c1 = c0 + per;
  if (c1 > chunks) c1 = chunks;
  float s = 0.0f;
  if (i < size) {
    for (int c = c0 + threadIdx.y; c < c1; c += kReduceLanes) s = __fadd_rn(s, part[c * size + i]);
  }
  lanes[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && i < size) {
    float t = 0.0f;
#pragma unroll
    for (int y = 0; y < kReduceLanes; ++y) t = __fadd_rn(t, lanes[y][threadIdx.x]);
    out[blockIdx.y * size + i] = t;
  }
}

__global__ void bn_backward_kernel(const BnBwdArgs a) {
  const long long total = a.rows * a.n;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < total;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long r = i / a.n;
    const int j = static_cast<int>(i - r * a.n);
    const float c = __bfloat162float(a.c[r * a.ld + j]);
    const float gv = __bfloat162float(a.g[r * a.ld + j]);
    const float xhat = __fmul_rn(__fsub_rn(c, __ldg(a.mean + j)), __ldg(a.inv + j));
    a.out[r * a.ldo + a.out_col + j] = __float2bfloat16_rn(__fmul_rn(
        __ldg(a.k + j), __fsub_rn(__fsub_rn(gv, __ldg(a.da + j)), __fmul_rn(xhat, __ldg(a.db + j)))));
  }
}

int done() { return static_cast<int>(cudaGetLastError()); }

}  // namespace

// One GEMM with its prologue and epilogue; grid (n / 64, ceil(rows / 64)).
// Returns cudaGetLastError() after the launch (0 = cudaSuccess), or
// cudaErrorInvalidValue for a (mode, epi) pair that no body uses.
extern "C" int rxtpu_fb_gemm(const GemmArgs* args, void* stream) {
  const GemmArgs& a = *args;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.rows == 0) return static_cast<int>(cudaSuccess);
  const dim3 grid(a.n / kBN, static_cast<unsigned>((a.rows + kBM - 1) / kBM));
#define RXTPU_FB_CASE(M, E)                                  \
  if (a.mode == M && a.epi == E) {                           \
    gemm_kernel<M, E><<<grid, kThreads, 0, st>>>(a);         \
    return done();                                           \
  }
  RXTPU_FB_CASE(kStored, kStoreStats)      // K6.1 c1
  RXTPU_FB_CASE(kStored, kStats)           // K6.1 projection sums
  RXTPU_FB_CASE(kTapBnRelu, kStoreStats)   // K6.2 c2
  RXTPU_FB_CASE(kBnRelu, kStats)           // K6.3 c3 sums
  RXTPU_FB_CASE(kStored, kResidual)        // K6.4 projection residual
  RXTPU_FB_CASE(kBnRelu, kOutput)          // K6.4 y
  RXTPU_FB_CASE(kBnRelu, kBnSums)          // K7.1 BN3 sums
  RXTPU_FB_CASE(kStored, kBnSums)          // K7.1 projection sum
  RXTPU_FB_CASE(kBnRelu, kBnBackward)      // K7.2 dc3
  RXTPU_FB_CASE(kStored, kReluGrad)        // K7.2 g2
  RXTPU_FB_CASE(kTapAdjoint, kReluGrad)    // K7.3 g1
  RXTPU_FB_CASE(kStored, kBnBackward)      // K7.4 dcp
  RXTPU_FB_CASE(kStored, kInputGrad)       // K7.4 dx
#undef RXTPU_FB_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}

// A weight gradient's per-chunk partials; grid (n / 64, k / 64, chunks * taps).
extern "C" int rxtpu_fb_wgrad(const WgradArgs* args, void* stream) {
  const WgradArgs& a = *args;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long chunks = (a.rows + a.chunk_rows - 1) / a.chunk_rows;
  if (chunks == 0) return static_cast<int>(cudaSuccess);
  const dim3 grid(a.n / 64, a.k / 64, static_cast<unsigned>(chunks * a.taps));
  switch (a.mode) {
    case kStored: wgrad_kernel<kStored><<<grid, kThreads, 0, st>>>(a); return done();
    case kBnRelu: wgrad_kernel<kBnRelu><<<grid, kThreads, 0, st>>>(a); return done();
    case kTapBnRelu: wgrad_kernel<kTapBnRelu><<<grid, kThreads, 0, st>>>(a); return done();
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// out[i] = sum_c part[c * size + i] over c in [0, chunks), in a fixed order;
// above 64 partials a first pass sums groups of 64 into tmp
// [ceil(chunks / 64), size].
extern "C" int rxtpu_fb_reduce(const float* part, float* tmp, float* out, int chunks,
                               long long size, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (size == 0) return static_cast<int>(cudaSuccess);
  const dim3 block(32, kReduceLanes);
  const unsigned bx = static_cast<unsigned>((size + 31) / 32);
  if (chunks > kReduceGroup) {
    const int groups = (chunks + kReduceGroup - 1) / kReduceGroup;
    reduce_kernel<<<dim3(bx, groups), block, 0, st>>>(part, tmp, chunks, size, kReduceGroup);
    const int err = done();
    if (err != 0) return err;
    part = tmp;
    chunks = groups;
  }
  reduce_kernel<<<dim3(bx, 1), block, 0, st>>>(part, out, chunks, size, chunks);
  return done();
}

// dc = bf16(k*(g - da - ((c - mean)*inv)*db)) over [rows, n].
extern "C" int rxtpu_fb_bn_backward(const BnBwdArgs* args, void* stream) {
  const BnBwdArgs& a = *args;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long total = a.rows * a.n;
  if (total == 0) return static_cast<int>(cudaSuccess);
  long long blocks = (total + 255) / 256;
  if (blocks > 65535LL * 8) blocks = 65535LL * 8;
  bn_backward_kernel<<<static_cast<unsigned>(blocks), 256, 0, st>>>(a);
  return done();
}
