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
// One family of kernels, on Hopper's copy engines:
// pipe_gemm_kernel<MODE, EPI, BN, WNK, BM> runs every GEMM of the eight
// bodies, K6.1 (c1 and the projection's sums), K6.2 (c2 over the 3x3
// taps), K6.3 (the c3 sums), K6.4 (the projection's residual and y), K7.1
// (the BN3 sums), K7.2 (dc3, g2), K7.3 (g1 over the 3x3 taps) and K7.4
// (dcp, dx); pipe_wgrad_kernel<MODE, TK, TN> their weight gradients (dw3,
// dw2, dw1, dwp).
//
// pipe_gemm_kernel (kStored, kBnRelu, kTapBnRelu or kTapAdjoint A; the
// store-and-sums, sums, residual, output, BN-sums, BN-backward, ReLU-gradient
// and input-gradient epilogues) and pipe_wgrad_kernel (kStored, kBnRelu or
// kTapBnRelu A): out[r, n] = sum_k A(r, k) W[k, n], A(r, k) src[r, k]
// (kStored) or bf16(relu(src[r, k]*scale[k] + shift[k])) (kBnRelu: a2),
// over a BM x BN tile (BN 256 where N allows, so A and its prologue are
// read N / 256 times; for the 3x3 convs 128 x 128, so stage 4's 512
// channels still make four column tiles), eight warps, a cp.async ring of
// A and W stages, the BN-ReLU prologue applied once per staged 16-byte
// chunk, ldmatrix + mma.sync m16n8k16; the epilogue's aux tiles (dy and y,
// c, or res) come in by bulk copies on an mbarrier while the products run,
// the epilogue works on the accumulator registers with its per-channel
// vectors read once, and the output leaves through shared memory in
// 16-byte rows (kStats and kBnSums store none: K6.3 and K7.1 are dc3's
// GEMM with a sums epilogue, K6.1's projection sums the residual's, and
// K6.4's y GEMM is dc3's with the output epilogue). Epilogues with sums
// write one pair of partials per (BM-row tile, channel), reduced
// afterwards in a fixed order by reduce_kernel. The 3x3 convs read each A
// chunk straight from the slab at its row's neighbour, zero-filled outside
// the plane: each thread works out its rows' pixels once and the stage's
// tap from k (a stage lies in one tap). kTapBnRelu (c2 = sum_tap
// a1[neighbour across offset] w2[tap]) reads w2 as [9 F, F] row major and
// applies the BN-ReLU only to chunks that hold a neighbour, a bit per
// (ring slot, chunk) saying which: a1 is zero-padded after the BN-ReLU,
// and relu(shift) is not 0. kTapAdjoint
// (g1 = sum_tap dc2[neighbour across -offset] w2[tap]^T) reads w2 [9, F,
// F] as stored, W^T per tap. Weight gradients use the same ring over rows,
// 64-128 x 128 output tiles and enough row chunks (times 9 taps for dw2)
// to fill the card; dw2's tap loader follows each row's pixel as the ring
// walks the rows, and its zero-filled chunks skip the BN-ReLU prologue.
//
// bn_backward_kernel: dc = bf16(k*(g - da - ((c - mean)*inv)*db)), the BN
// backward of _b3_kernel (dc2) and _b4_kernel (dc1), 8 channels (16 bytes)
// per thread with the per-channel vectors in registers.
//
// Every reduction is deterministic: no float atomics; per-tile partials are
// summed in a fixed order. c3, computed in K6.3, K6.4, K7.1 and K7.2, comes
// out bit for bit the same each time, as rxtpu's recomputation assumes, and
// so does cp in K6.1, K6.4, K7.1 and K7.4: each output is summed from a
// zero f32 accumulator over k in ascending 16-wide steps, one m16n8k16 HMMA
// per step, whatever the tile (no split over k).
//
// Rounding follows the plain PyTorch version op by op: every v*scale + shift
// and every BN-backward term is a separately rounded __fmul_rn / __fadd_rn /
// __fsub_rn (nvcc would otherwise contract them into FMAs), values are
// rounded to bf16 with __float2bfloat16_rn where rxtpu rounds (c1, c2, c3,
// a1, a2, bn3, res, y, dc3, g2, dc2, g1, dc1, dcp, dx), comparisons run on
// the bf16 values promoted to f32, and the BN sums read the bf16-rounded
// values. A bf16 x bf16 product is exact in f32: the products run on the
// tensor cores (f32 accumulators), so only the order of the f32 sums
// differs from the plain version.
//
// Bound: at ResNet-50's shapes (V = 48 views) most bodies move more bytes
// than their tensor-core time: e.g. K6.1 (rxtpu/ops/fused_block.py:257) at
// a stage-1 identity block reads 203.5 MB of x and writes 50.9 MB of c1,
// 0.076 ms at 3.35 TB/s, against 13.0 GFLOP, 0.013 ms at 989 TFLOP/s; at
// stage 4 37.5 MB (0.011 ms) against 14.5 GFLOP (0.015 ms). K6.3
// (rxtpu/ops/fused_block.py:365) reads c2 and w3 and writes two vectors:
// near the balance at stage 1 (50.9 MB = 0.015 ms against 13.0 GFLOP =
// 0.013 ms), bound by its products past it (stage 4: 9.2 MB against 14.5
// GFLOP). K6.4, K7.1, K7.2 and K7.4 are bound by bytes too (K6.4 at a
// stage-1 identity block reads c2 and res and writes y, 458 MB = 0.137 ms,
// against 13.0 GFLOP = 0.013 ms; K7.1 reads dy, y and c2, as many bytes;
// dc3 alone: c2, dy and y read, dc3 written, 661 MB = 0.197 ms against
// 0.04 ms of products), so their kernels keep copies in flight rather than
// reaching for wgmma's rate. The 3x3 bodies are near the balance or past
// it: K6.2 at a stage-1 block does 29.3 GFLOP (0.030 ms) against 102 MB
// (0.030 ms), at stage 4 32.6 GFLOP (0.033 ms) against 19 MB; K7.3 twice
// the products; mma.sync from a cp.async ring is their rate. K6.1 reads x
// F / BN times (once at stages 1-3, twice at stage 4), K6.3 c2 and its
// BN-ReLU 4F / 256 times; dc2, dc1, dcp and dc3 are materialized in device
// memory. chip_smoke.py prints each body's time beside its bound.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

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
  float* part0;         // [ceil(rows / BM), 2, n] partial sums
  const bf16* w2;       // with W^T [n, k]: rows k >= k_split come from w2 [n, k - k_split]
  int k_split;          // w [n, k_split]
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

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
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

// dc = bf16(k*(g - da - xhat*db)) over [rows, n]: each thread takes 8
// channels (one 16-byte load of g and c, one store), its per-channel vectors
// loaded once, and steps over rows; no per-element index division
__global__ void __launch_bounds__(256) bn_backward_kernel(const BnBwdArgs a) {
  const int cpr = a.n / 8;  // 16-byte chunks per row
  const int rpb = static_cast<int>(blockDim.x) / cpr;
  const int tid = threadIdx.x;
  if (tid >= rpb * cpr) return;
  const int j = (tid % cpr) * 8;
  float mean[8], inv[8], k[8], da[8], db[8];
#pragma unroll
  for (int q = 0; q < 8; q += 4) {
    const float4 m4 = __ldg(reinterpret_cast<const float4*>(a.mean + j + q));
    const float4 i4 = __ldg(reinterpret_cast<const float4*>(a.inv + j + q));
    const float4 k4 = __ldg(reinterpret_cast<const float4*>(a.k + j + q));
    const float4 a4 = __ldg(reinterpret_cast<const float4*>(a.da + j + q));
    const float4 b4 = __ldg(reinterpret_cast<const float4*>(a.db + j + q));
    mean[q] = m4.x; mean[q + 1] = m4.y; mean[q + 2] = m4.z; mean[q + 3] = m4.w;
    inv[q] = i4.x; inv[q + 1] = i4.y; inv[q + 2] = i4.z; inv[q + 3] = i4.w;
    k[q] = k4.x; k[q + 1] = k4.y; k[q + 2] = k4.z; k[q + 3] = k4.w;
    da[q] = a4.x; da[q + 1] = a4.y; da[q + 2] = a4.z; da[q + 3] = a4.w;
    db[q] = b4.x; db[q + 1] = b4.y; db[q + 2] = b4.z; db[q + 3] = b4.w;
  }
  for (long long r = static_cast<long long>(blockIdx.x) * rpb + tid / cpr; r < a.rows;
       r += static_cast<long long>(gridDim.x) * rpb) {
    Pack8 c, gv, o;
    c.u = *reinterpret_cast<const uint4*>(a.c + r * a.ld + j);
    gv.u = *reinterpret_cast<const uint4*>(a.g + r * a.ld + j);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float2 cf = __bfloat1622float2(c.h[q]), gf = __bfloat1622float2(gv.h[q]);
      float v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 2 * q + e;
        const float xhat = __fmul_rn(__fsub_rn(e ? cf.y : cf.x, mean[i]), inv[i]);
        v[e] = __fmul_rn(k[i], __fsub_rn(__fsub_rn(e ? gf.y : gf.x, da[i]), __fmul_rn(xhat, db[i])));
      }
      o.h[q] = __floats2bfloat162_rn(v[0], v[1]);
    }
    *reinterpret_cast<uint4*>(a.out + r * a.ldo + a.out_col + j) = o.u;
  }
}

// ---------------------------------------------------------------------------
// The pipelined mainloop (every body's GEMMs and weight gradients)
// ---------------------------------------------------------------------------

constexpr int kPipeThreads = 256;  // eight warps: 2 along the rows x 4 along the columns
constexpr int kPipeBK = 32;        // GEMM reduction depth per stage
constexpr int kPipeSmem2 = 115712; // a block's shared memory when two share an SM
constexpr int kLdPA = kPipeBK + 8; // staged A row pitch (bf16): ldmatrix without bank conflicts
constexpr int kWgBR = 32;          // weight-gradient rows per stage
constexpr int kWgSmem = 106496;    // weight-gradient ring: two blocks per SM
constexpr int kMaxDevices = 64;

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

// the aux tiles' copy engine: one bulk (TMA) copy per tile row, counted in
// bytes on an mbarrier, so the ring's cp.async groups never wait for them
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               "fence.mbarrier_init.release.cluster;\n" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_bytes(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// four 8x8 bf16 matrices from shared memory, one row address per lane
template <bool TRANS>
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  if (TRANS) {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p))
                 : "memory");
  } else {
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(smem_addr(p))
                 : "memory");
  }
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

// bf16(relu(v*scale + shift)) in place on a staged 16-byte chunk of 8
// channels, scale and shift (global) at its first channel, one pair at a
// time: pipe_gemm_kernel's kBnRelu prologue, where the GEMM's accumulators
// leave few registers (unrolled, <kBnRelu, ..., 256, ...> spills)
__device__ __forceinline__ void bn_relu_chunk(bf16* p, const float* scale, const float* shift) {
#pragma unroll 1
  for (int q = 0; q < 4; ++q) {
    const float2 x = __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(p)[q]);
    const float2 s2 = reinterpret_cast<const float2*>(scale)[q];
    const float2 h2 = reinterpret_cast<const float2*>(shift)[q];
    reinterpret_cast<__nv_bfloat162*>(p)[q] =
        __floats2bfloat162_rn(bn_relu(x.x, s2.x, h2.x), bn_relu(x.y, s2.y, h2.y));
  }
}

// the same on the N staged chunks p[i] whose bit i of `live` is set, which
// share their 8 channels: scale and shift (global or shared) read once, in
// 16-byte loads, and every load issued before the arithmetic (the weight
// gradient's prologue and kTapBnRelu's, where a rolled loop's chain of
// dependent loads sat on every k step)
template <int N>
__device__ __forceinline__ void bn_relu_chunks(bf16* const (&p)[N], unsigned live,
                                               const float* scale, const float* shift) {
  float sc[8], sh[8];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const float4 s4 = reinterpret_cast<const float4*>(scale)[q];
    const float4 h4 = reinterpret_cast<const float4*>(shift)[q];
    sc[4 * q] = s4.x; sc[4 * q + 1] = s4.y; sc[4 * q + 2] = s4.z; sc[4 * q + 3] = s4.w;
    sh[4 * q] = h4.x; sh[4 * q + 1] = h4.y; sh[4 * q + 2] = h4.z; sh[4 * q + 3] = h4.w;
  }
  Pack8 v[N];
#pragma unroll
  for (int i = 0; i < N; ++i) v[i].u = *reinterpret_cast<const uint4*>(p[i]);
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (!((live >> i) & 1u)) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 x = __bfloat1622float2(v[i].h[j]);
      // relu, then one rounding to bf16: bn_relu's value
      v[i].h[j] = __floats2bfloat162_rn(
          fmaxf(__fadd_rn(__fmul_rn(x.x, sc[2 * j]), sh[2 * j]), 0.0f),
          fmaxf(__fadd_rn(__fmul_rn(x.y, sc[2 * j + 1]), sh[2 * j + 1]), 0.0f));
    }
    *reinterpret_cast<uint4*>(p[i]) = v[i].u;
  }
}

// Shared-memory plan of pipe_gemm_kernel<MODE, EPI, BN, WNK, BM>: the ring
// of (A [BM][40], W [32][BN + 8] or W^T [BN][32], its 16-byte chunks
// XOR-swizzled by row) stages, which the epilogue reuses to stage its bf16
// output tile; the aux tiles (dy and y, c, or res; none for kStoreStats,
// kStats and kResidual) [BM][BN + 8]; the two warp rows' column sums (in
// the ring for kStats and kBnSums, which store no tile); the aux tiles'
// mbarrier. The ring takes as many stages as fit, up to four.
// Where the accumulators leave room for two blocks per SM (BM = 64, or BN
// <= 128), a block keeps within half an SM's shared memory, so one block's
// epilogue overlaps the other's copies.
template <int EPI, int BN, bool WNK, int BM>
struct PipeGemmSmem {
  static constexpr bool kTwoPerSm = BM == 64 || BN <= 128;  // registers allow two blocks per SM
  static constexpr bool kStore = EPI != kBnSums && EPI != kStats;  // stores an output tile
  static constexpr int kLdW = WNK ? kPipeBK : BN + 8;
  static constexpr int kLdX = BN + 8;
  static constexpr int kAux = EPI == kBnBackward || EPI == kInputGrad || EPI == kBnSums ? 2
                              : EPI == kReluGrad || EPI == kOutput ? 1 : 0;  // aux tiles
  static constexpr int kStage = BM * kLdPA + (WNK ? BN : kPipeBK) * kLdW;  // bf16 elements
  static constexpr int kAuxTile = BM * kLdX;                               // bf16 elements
  static constexpr int kSumBytes = 2 * 2 * BN * 4;
  // bytes beside the ring
  static constexpr int kSums = EPI == kReluGrad || EPI == kStoreStats ? kSumBytes : 0;
  static constexpr int kFixed = kAux * kAuxTile * 2 + kSums + 8;  // bytes besides the ring
  // as many stages as fit, up to four
  static constexpr int kFit = ((kTwoPerSm ? kPipeSmem2 : 232448) - kFixed) / (kStage * 2);
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static constexpr int kRing = kStages * kStage * 2;  // bytes
  static constexpr int kBar = kRing + kAux * kAuxTile * 2 + kSums;
  static constexpr int kBytes = kBar + 8;
  static_assert(kStages >= 2, "a ring of at least two stages");
  static_assert(kStore ? kAuxTile * 2 <= kRing : kSumBytes <= kRing,
                "the output tile, or kStats's and kBnSums's column sums, lie in the ring");
};

// out[r, n] = sum_k A(r, k) W[k, n] over a BM x BN tile, A stored,
// bf16(relu(c*scale + shift)) (kBnRelu, applied once per staged chunk),
// the 3x3 conv's taps (kTapBnRelu: bf16(relu(c*scale + shift)) at each
// row's neighbour across the offset of tap k / kc, 0 outside the plane:
// the zero-filled chunks skip the prologue, as the plain version pads a1
// after the BN-ReLU) or the 3x3 adjoint's (kTapAdjoint: src at each row's
// neighbour across the negated offset, zero-filled outside the plane); W
// [K, N] row major (w2 as [9 kc, N] for kTapBnRelu) or, with WNK, read as
// stored in W^T [N, K] (w3 for g2; w1 and wp side by side for the
// projection's dx; for kTapAdjoint the tap's w2[tap] [N, kc]), K a
// multiple of 32. Eight warps each own a BM/2 x BN/4 part of the tile:
// ldmatrix fragments, mma.sync m16n8k16 over k in ascending 16-wide steps
// from a zero accumulator. A and W arrive through a cp.async ring; the
// epilogue's aux tiles are requested first, by bulk copies on an
// mbarrier, so their bytes are in flight during the products and the ring
// never waits for them. The epilogue reads its columns' per-channel
// vectors once, works on the accumulator registers, stages the bf16 tile
// in shared memory and stores it in 16-byte rows (no tile for kStats and
// kBnSums); its column sums go lanes (shuffles) -> warp rows -> one pair
// per (BM-row tile, channel), in a fixed order.
template <int MODE, int EPI, int BN, bool WNK, int BM>
__global__ void __launch_bounds__(kPipeThreads, PipeGemmSmem<EPI, BN, WNK, BM>::kTwoPerSm ? 2 : 1)
    pipe_gemm_kernel(const GemmArgs g) {
  using S = PipeGemmSmem<EPI, BN, WNK, BM>;
  static_assert(MODE != kTapAdjoint || WNK, "the adjoint reads w2[tap] as stored");
  static_assert(MODE != kTapBnRelu || !WNK, "the forward tap reads w2 [9 kc, N] row major");
  constexpr bool kTap = MODE == kTapBnRelu || MODE == kTapAdjoint;
  constexpr int MT = BM / 32;  // m16 tiles per warp (BM / 2 rows)
  constexpr int NT = BN / 32;  // n8 tiles per warp (BN / 4 columns)
  constexpr int kCpr = BN / 8; // 16-byte chunks per tile row
  constexpr int kArows = BM * 4 / kPipeThreads;  // A rows this thread copies in every stage
  constexpr bool kSumEpi =
      EPI == kReluGrad || EPI == kBnSums || EPI == kStoreStats || EPI == kStats;
  static_assert(kArows * S::kStages <= 32, "one validity bit per (slot, chunk)");
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  bf16* aux = reinterpret_cast<bf16*>(smem + S::kRing);
  float* sums = reinterpret_cast<float*>(S::kStore ? smem + S::kRing + S::kAux * S::kAuxTile * 2
                                                   : smem);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const long long m0 = static_cast<long long>(blockIdx.y) * BM;
  const int n0 = blockIdx.x * BN;
  const int ktiles = g.k / kPipeBK;
  const int n_aux = EPI == kInputGrad && !g.add_g3 ? 0 : S::kAux;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + S::kBar);

  // the tap modes: the pixels (y, x) of this thread's A rows in their
  // plane, worked out once in 32 bits (y = -2 past the slab, so that no
  // neighbour lies inside); kTapBnRelu: which of its chunks hold a
  // neighbour, one bit per (ring slot, chunk)
  int py[kArows], px[kArows];
  unsigned inside = 0;
  if (kTap) {
    const int plane = g.a.height * g.a.width;
#pragma unroll
    for (int i = 0; i < kArows; ++i) {
      const int r = static_cast<int>(m0) + (tid >> 2) + 64 * i;
      const int p = r % plane, y = p / g.a.width;
      py[i] = r < g.rows ? y : -2;
      px[i] = p - y * g.a.width;
    }
  }

  auto load_stage = [&](int slot, int kt) {
    const int k0 = kt * kPipeBK;
    bf16* as = ring + slot * S::kStage;
    bf16* ws = as + BM * kLdPA;
    // the tap modes: a stage's 32 k lie in one tap (kc a multiple of 64)
    const int tap = kTap ? k0 / g.a.kc : 0;
    const int j0 = k0 - tap * g.a.kc;
    if (kTap) {  // A: each row's neighbour across the tap's offset (the adjoint's negated), or 0
      const int dy = MODE == kTapAdjoint ? 1 - tap / 3 : tap / 3 - 1;
      const int dx = MODE == kTapAdjoint ? 1 - tap % 3 : tap % 3 - 1;
      const long long off = static_cast<long long>(dy * g.a.width + dx) * g.a.ld + g.a.col + j0;
#pragma unroll
      for (int i = 0; i < kArows; ++i) {
        const int row = (tid >> 2) + 64 * i, q = (tid & 3) * 8;
        const bool ok = static_cast<unsigned>(py[i] + dy) < static_cast<unsigned>(g.a.height) &&
                        static_cast<unsigned>(px[i] + dx) < static_cast<unsigned>(g.a.width);
        if (MODE == kTapBnRelu) {
          const unsigned bit = 1u << (slot * kArows + i);
          inside = ok ? inside | bit : inside & ~bit;
        }
        cp_async16(as + row * kLdPA + q, g.a.ptr + (ok ? (m0 + row) * g.a.ld + off + q : 0), ok);
      }
    } else {
#pragma unroll
      for (int i = 0; i < kArows; ++i) {  // A: BM rows x 4 chunks
        const int c = tid + kPipeThreads * i;
        const int row = c >> 2, q = (c & 3) * 8;
        const long long r = m0 + row;
        const bool ok = r < g.rows;
        cp_async16(as + row * kLdPA + q, g.a.ptr + (ok ? r : 0) * g.a.ld + g.a.col + k0 + q, ok);
      }
    }
    if (WNK) {  // W^T: BN rows x 4 chunks, from w or w2, or from w2[tap] [n, kc]
      const bool first = k0 < g.k_split;
      const bf16* src = MODE == kTapAdjoint ? g.w + static_cast<long long>(tap) * g.n * g.a.kc + j0
                        : first             ? g.w + k0
                                            : g.w2 + (k0 - g.k_split);
      const int ld = MODE == kTapAdjoint ? g.a.kc : first ? g.k_split : g.k - g.k_split;
#pragma unroll
      for (int i = 0; i < BN * 4 / kPipeThreads; ++i) {
        const int c = tid + kPipeThreads * i;
        const int nr = c >> 2, q = c & 3;
        cp_async16(ws + nr * S::kLdW + (q ^ ((nr >> 1) & 3)) * 8,
                   src + static_cast<long long>(n0 + nr) * ld + q * 8, true);
      }
    } else {
      // a rolled loop holds fewer addresses: no spills at BN = 256, BM = 64
#pragma unroll 1
      for (int i = 0; i < kPipeBK * kCpr / kPipeThreads; ++i) {  // W: 32 rows x BN/8 chunks
        const int c = tid + kPipeThreads * i;
        const int kr = c / kCpr, q = (c % kCpr) * 8;
        cp_async16(ws + kr * S::kLdW + q, g.w + static_cast<long long>(k0 + kr) * g.n + n0 + q, true);
      }
    }
  };
  if (n_aux > 0) {  // the aux tiles' rows inside the slab: one bulk copy each
    const long long live = g.rows - m0 < BM ? g.rows - m0 : BM;
    if (tid == 0) mbar_init(bar);
    __syncthreads();
    if (tid == 0) mbar_expect_bytes(bar, static_cast<unsigned>(n_aux * live * BN * 2));
    for (int i = tid; i < n_aux * BM; i += kPipeThreads) {
      const int j = i / BM, row = i % BM;
      if (row < live) {
        bulk_copy(aux + j * S::kAuxTile + row * S::kLdX,
                  (j == 0 ? g.aux0 : g.aux1) + (m0 + row) * g.ldaux + n0, BN * 2, bar);
      }
    }
  }

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;
    }
  }
#pragma unroll
  for (int s = 0; s < S::kStages - 1; ++s) {
    if (s < ktiles) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<S::kStages - 2>();
    const int slot = kt % S::kStages;
    bf16* as = ring + slot * S::kStage;
    const bf16* ws = as + BM * kLdPA;
    if (MODE == kBnRelu) {  // this thread's own chunks, landed: the prologue, once
#pragma unroll
      for (int i = 0; i < kArows; ++i) {
        // rows past the slab are transformed too: their outputs are never stored
        const int k = kt * kPipeBK + (tid & 3) * 8;
        bn_relu_chunk(as + ((tid >> 2) + 64 * i) * kLdPA + (tid & 3) * 8, g.a.scale + k,
                      g.a.shift + k);
      }
    }
    if (MODE == kTapBnRelu) {  // the same at channel k within its tap, on the chunks that hold
                               // a neighbour: zero-filled ones stay zero
      const int k = kt * kPipeBK % g.a.kc + (tid & 3) * 8;
      bf16* chunks[kArows];
#pragma unroll
      for (int i = 0; i < kArows; ++i) {
        chunks[i] = as + ((tid >> 2) + 64 * i) * kLdPA + (tid & 3) * 8;
      }
      bn_relu_chunks(chunks, inside >> (slot * kArows), g.a.scale + k, g.a.shift + k);
    }
    __syncthreads();
    const int next = kt + S::kStages - 1;
    if (next < ktiles) load_stage(next % S::kStages, next);
    cp_async_commit();
#pragma unroll
    for (int kk = 0; kk < kPipeBK; kk += 16) {
      unsigned af[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        ldsm_x4<false>(af[mt], as + (wm * (BM / 2) + mt * 16 + (lane & 15)) * kLdPA + kk +
                                   (lane >> 4) * 8);
      }
#pragma unroll
      for (int p = 0; p < NT / 2; ++p) {  // two n8 tiles of B at a time
        unsigned t[4];
        if (WNK) {
          const int nr = wn * (BN / 4) + p * 16 + (lane & 7) + (lane >> 4) * 8;
          const int q = kk / 8 + ((lane >> 3) & 1);
          ldsm_x4<false>(t, ws + nr * S::kLdW + (q ^ ((nr >> 1) & 3)) * 8);
        } else {
          ldsm_x4<true>(t, ws + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * S::kLdW + wn * (BN / 4) +
                               p * 16 + (lane >> 4) * 8);
        }
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma16816(acc[mt][2 * p], af[mt], t[0], t[1]);
          mma16816(acc[mt][2 * p + 1], af[mt], t[2], t[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  if (n_aux > 0) mbar_wait(bar, 0);
  __syncthreads();  // the ring is free for the output tile, the aux tiles have landed

  bf16* stage = ring;  // [128][BN + 8] bf16
  const bf16* aux0 = aux;
  const bf16* aux1 = aux + S::kAuxTile;
  const int gr = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int col = wn * (BN / 4) + nt * 8 + 2 * t;  // this thread's columns col, col + 1
    const int n = n0 + col;
    const float2 zero2 = make_float2(0.0f, 0.0f);
    float2 v_mean = zero2, v_inv = zero2, v_k = zero2, v_da = zero2, v_db = zero2,
           v_scale = zero2, v_shift = zero2;
    if (EPI == kBnBackward || EPI == kReluGrad || EPI == kBnSums) {
      v_mean = __ldg(reinterpret_cast<const float2*>(g.e_mean + n));
      v_inv = __ldg(reinterpret_cast<const float2*>(g.e_inv + n));
    }
    if (EPI == kBnBackward) {
      v_k = __ldg(reinterpret_cast<const float2*>(g.e_k + n));
      v_da = __ldg(reinterpret_cast<const float2*>(g.e_da + n));
      v_db = __ldg(reinterpret_cast<const float2*>(g.e_db + n));
    }
    if (EPI == kReluGrad || EPI == kOutput || EPI == kResidual) {
      v_scale = __ldg(reinterpret_cast<const float2*>(g.e_scale + n));
      v_shift = __ldg(reinterpret_cast<const float2*>(g.e_shift + n));
    }
    float s1[2] = {0.0f, 0.0f}, s2[2] = {0.0f, 0.0f};
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = wm * (BM / 2) + mt * 16 + gr + 8 * h;
        const int o = row * S::kLdX + col;
        const float acc2[2] = {acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]};
        float out2[2];
        if (EPI == kBnBackward || EPI == kInputGrad) {
          float g3[2] = {0.0f, 0.0f};
          if (EPI == kBnBackward || g.add_g3) {
            const float2 dy = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(aux0 + o));
            const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(aux1 + o));
            g3[0] = y.x > 0.0f ? dy.x : __fmul_rn(dy.x, 0.0f);
            g3[1] = y.y > 0.0f ? dy.y : __fmul_rn(dy.y, 0.0f);
          }
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (EPI == kBnBackward) {
              const float mean = e ? v_mean.y : v_mean.x, inv = e ? v_inv.y : v_inv.x;
              const float kk = e ? v_k.y : v_k.x, da = e ? v_da.y : v_da.x, db = e ? v_db.y : v_db.x;
              const float xhat = __fmul_rn(__fsub_rn(round_bf16(acc2[e]), mean), inv);
              out2[e] = __fmul_rn(kk, __fsub_rn(__fsub_rn(g3[e], da), __fmul_rn(xhat, db)));
            } else {
              out2[e] = g.add_g3 ? __fadd_rn(acc2[e], g3[e]) : acc2[e];
            }
          }
          *reinterpret_cast<__nv_bfloat162*>(stage + o) = __floats2bfloat162_rn(out2[0], out2[1]);
        } else if (EPI == kBnSums) {  // sums of g3 and g3*xhat, xhat = (bf16(acc) - mean)*inv
          const float2 dy = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(aux0 + o));
          const float2 y = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(aux1 + o));
          const float g3[2] = {y.x > 0.0f ? dy.x : __fmul_rn(dy.x, 0.0f),
                               y.y > 0.0f ? dy.y : __fmul_rn(dy.y, 0.0f)};
          if (m0 + row < g.rows) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float xhat = __fmul_rn(__fsub_rn(round_bf16(acc2[e]), e ? v_mean.y : v_mean.x),
                                           e ? v_inv.y : v_inv.x);
              s1[e] = __fadd_rn(s1[e], g3[e]);
              s2[e] = __fadd_rn(s2[e], __fmul_rn(g3[e], xhat));
            }
          }
        } else if (EPI == kOutput || EPI == kResidual) {
          // res = bf16(bf16(acc)*scale + shift); y = bf16(max(bn3 + res, 0)), bn3 likewise
          float bn[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            bn[e] = __fadd_rn(__fmul_rn(round_bf16(acc2[e]), e ? v_scale.y : v_scale.x),
                              e ? v_shift.y : v_shift.x);
          }
          if (EPI == kOutput) {
            const float2 res =
                __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(aux0 + o));
            bn[0] = fmaxf(__fadd_rn(round_bf16(bn[0]), res.x), 0.0f);
            bn[1] = fmaxf(__fadd_rn(round_bf16(bn[1]), res.y), 0.0f);
          }
          *reinterpret_cast<__nv_bfloat162*>(stage + o) = __floats2bfloat162_rn(bn[0], bn[1]);
        } else if (EPI == kStoreStats || EPI == kStats) {  // v = bf16(acc); sums of v and v*v
          const __nv_bfloat162 pair = __floats2bfloat162_rn(acc2[0], acc2[1]);
          if (EPI == kStoreStats) *reinterpret_cast<__nv_bfloat162*>(stage + o) = pair;
          if (m0 + row < g.rows) {
            const float2 v = __bfloat1622float2(pair);
            s1[0] = __fadd_rn(s1[0], v.x);
            s1[1] = __fadd_rn(s1[1], v.y);
            s2[0] = __fadd_rn(s2[0], __fmul_rn(v.x, v.x));
            s2[1] = __fadd_rn(s2[1], __fmul_rn(v.y, v.y));
          }
        } else {  // kReluGrad
          const float2 c = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(aux0 + o));
          const float cv[2] = {c.x, c.y};
          bf16 gb[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float a = bn_relu(cv[e], e ? v_scale.y : v_scale.x, e ? v_shift.y : v_shift.x);
            gb[e] = __float2bfloat16_rn(__fmul_rn(acc2[e], a > 0.0f ? 1.0f : 0.0f));
            if (m0 + row < g.rows) {
              const float v1 = __bfloat162float(gb[e]);
              const float xhat = __fmul_rn(__fsub_rn(cv[e], e ? v_mean.y : v_mean.x),
                                           e ? v_inv.y : v_inv.x);
              s1[e] = __fadd_rn(s1[e], v1);
              s2[e] = __fadd_rn(s2[e], __fmul_rn(v1, xhat));
            }
          }
          __nv_bfloat162 pair;
          pair.x = gb[0];
          pair.y = gb[1];
          *reinterpret_cast<__nv_bfloat162*>(stage + o) = pair;
        }
      }
    }
    if (kSumEpi) {
#pragma unroll
      for (int m = 4; m < 32; m <<= 1) {  // the lanes that share these columns
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s1[e] = __fadd_rn(s1[e], __shfl_xor_sync(0xffffffffu, s1[e], m));
          s2[e] = __fadd_rn(s2[e], __shfl_xor_sync(0xffffffffu, s2[e], m));
        }
      }
      if (gr == 0) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          sums[(wm * 2 + 0) * BN + col + e] = s1[e];
          sums[(wm * 2 + 1) * BN + col + e] = s2[e];
        }
      }
    }
  }
  __syncthreads();
  if (kSumEpi) {  // warp row 0, then warp row 1: one partial per tile and channel
    for (int i = tid; i < 2 * BN; i += kPipeThreads) {
      const int which = i / BN, col = i % BN;
      const float v = __fadd_rn(sums[which * BN + col], sums[(2 + which) * BN + col]);
      g.part0[(static_cast<long long>(blockIdx.y) * 2 + which) * g.n + n0 + col] = v;
    }
  }
  if (!S::kStore) return;
#pragma unroll 4
  for (int i = 0; i < BM * kCpr / kPipeThreads; ++i) {
    const int c = tid + kPipeThreads * i;
    const int row = c / kCpr, q = (c % kCpr) * 8;
    const long long r = m0 + row;
    if (r < g.rows) {
      *reinterpret_cast<uint4*>(g.out + r * g.ldo + g.out_col + n0 + q) =
          *reinterpret_cast<const uint4*>(stage + row * S::kLdX + q);
    }
  }
}

// dW[k, n] = sum_r A(r, k) D(r, n) over the rows of one chunk, for a TK x TN
// tile of (k, n): A stored or bf16(relu(c*scale + shift)) (applied once per
// staged chunk), D a stored bf16 slab; with kTapBnRelu, per 3x3 tap
// (blockIdx.z % taps), A is bf16(relu(c*scale + shift)) at each row's
// neighbour across the tap's offset and 0 where that lies outside the
// plane (the zero-filled chunk skips the prologue: zero after the
// BN-ReLU, as the plain version pads a1). Eight warps each own a TK/2 x
// TN/4 part; both operands arrive [rows][channels] through a cp.async ring
// of up to six stages and feed mma.sync through ldmatrix.trans. One f32
// partial per (chunk, tap), written from the registers, reduced by
// reduce_kernel in chunk order.
// its ring: as many stages as fit two blocks to an SM, up to six
template <int TK, int TN>
struct WgradRing {
  static constexpr int kStage = kWgBR * (TK + 8 + TN + 8) * 2;  // bytes
  static constexpr int kStages = kWgSmem / kStage < 6 ? kWgSmem / kStage : 6;
  static constexpr int kBytes = kStages * kStage + 2 * TK * 4;  // + kBnRelu's scale and shift
};

template <int MODE, int TK, int TN>
__global__ void __launch_bounds__(kPipeThreads, 2) pipe_wgrad_kernel(const WgradArgs g) {
  constexpr bool kTap = MODE == kTapBnRelu;
  constexpr bool kPrologue = MODE == kBnRelu || kTap;
  constexpr int kLdA = TK + 8, kLdD = TN + 8;
  constexpr int kWgStages = WgradRing<TK, TN>::kStages;
  constexpr int kStage = kWgBR * (kLdA + kLdD);  // bf16 elements
  constexpr int MT = TK / 32, NT = TN / 32;
  constexpr int kCprA = TK / 8, kCprD = TN / 8;
  constexpr int kArows = kWgBR * kCprA / kPipeThreads;  // A chunks this thread copies per stage
  static_assert(kWgStages * kArows <= 32, "one validity bit per (slot, chunk)");
  static_assert(kPipeThreads % kCprA == 0, "a thread's A chunks share their channels");
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  float* vec = reinterpret_cast<float*>(smem + kWgStages * kStage * 2);  // scale [TK], shift [TK]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int n0 = blockIdx.x * TN, k0 = blockIdx.y * TK;
  if (kPrologue) {  // this tile's channels, read by the prologue of every stage
    for (int i = tid; i < TK; i += kPipeThreads) {
      vec[i] = g.a.scale[k0 + i];
      vec[TK + i] = g.a.shift[k0 + i];
    }
    __syncthreads();
  }
  const int tap = blockIdx.z % g.taps, chunk = blockIdx.z / g.taps;
  const long long r_begin = static_cast<long long>(chunk) * g.chunk_rows;
  long long r_end = r_begin + g.chunk_rows;
  if (r_end > g.rows) r_end = g.rows;
  const int steps = static_cast<int>((r_end - r_begin + kWgBR - 1) / kWgBR);

  // kTapBnRelu: the tap's offset; the pixels (y, x) of this thread's A rows
  // in their plane, in 32 bits (rows < 2^31), advanced by a stage's rows at
  // each load; which of its chunks hold a neighbour, one bit per (slot, chunk)
  const int dy = tap / 3 - 1, dx = tap % 3 - 1;
  int py[kArows], px[kArows];
  unsigned inside = 0;
  if (kTap) {
    const int plane = g.a.height * g.a.width;
#pragma unroll
    for (int i = 0; i < kArows; ++i) {
      const int p = (static_cast<int>(r_begin) + (tid + kPipeThreads * i) / kCprA) % plane;
      py[i] = p / g.a.width;
      px[i] = p - py[i] * g.a.width;
    }
  }

  auto load_stage = [&](int slot, int step) {
    const long long r0 = r_begin + static_cast<long long>(step) * kWgBR;
    bf16* as = ring + slot * kStage;
    bf16* ds = as + kWgBR * kLdA;
#pragma unroll
    for (int i = 0; i < kArows; ++i) {
      const int c = tid + kPipeThreads * i;
      const int rr = c / kCprA, q = (c % kCprA) * 8;
      const long long r = r0 + rr;
      if (kTap) {
        const bool ok = r < r_end &&
                        static_cast<unsigned>(py[i] + dy) < static_cast<unsigned>(g.a.height) &&
                        static_cast<unsigned>(px[i] + dx) < static_cast<unsigned>(g.a.width);
        const unsigned bit = 1u << (slot * kArows + i);
        inside = ok ? inside | bit : inside & ~bit;
        const long long src = ok ? r + dy * g.a.width + dx : 0;
        cp_async16(as + rr * kLdA + q, g.a.ptr + src * g.a.ld + g.a.col + k0 + q, ok);
        px[i] += kWgBR;  // the next stage's row
        while (px[i] >= g.a.width) {
          px[i] -= g.a.width;
          if (++py[i] == g.a.height) py[i] = 0;
        }
      } else {
        const bool ok = r < r_end;
        cp_async16(as + rr * kLdA + q, g.a.ptr + (ok ? r : 0) * g.a.ld + g.a.col + k0 + q, ok);
      }
    }
#pragma unroll
    for (int i = 0; i < kWgBR * kCprD / kPipeThreads; ++i) {
      const int c = tid + kPipeThreads * i;
      const int rr = c / kCprD, q = (c % kCprD) * 8;
      const long long r = r0 + rr;
      const bool ok = r < r_end;
      cp_async16(ds + rr * kLdD + q, g.d + (ok ? r : 0) * g.ldd + g.d_col + n0 + q, ok);
    }
  };

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;
    }
  }
#pragma unroll
  for (int s = 0; s < kWgStages - 1; ++s) {
    if (s < steps) load_stage(s, s);
    cp_async_commit();
  }
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kWgStages - 2>();
    const int slot = step % kWgStages;
    bf16* as = ring + slot * kStage;
    const bf16* ds = as + kWgBR * kLdA;
    if (kPrologue) {  // this thread's own chunks, landed: the prologue, once
      const long long r0 = r_begin + static_cast<long long>(step) * kWgBR;
      const int q = (tid % kCprA) * 8;  // the channels of all of them
      bf16* chunks[kArows];
      unsigned live = 0;
#pragma unroll
      for (int i = 0; i < kArows; ++i) {
        const int rr = (tid + kPipeThreads * i) / kCprA;
        chunks[i] = as + rr * kLdA + q;
        // zero-filled chunks (past the chunk's rows, or no neighbour) stay zero
        const bool ok = kTap ? (inside >> (slot * kArows + i)) & 1u : r0 + rr < r_end;
        live |= static_cast<unsigned>(ok) << i;
      }
      bn_relu_chunks(chunks, live, vec + q, vec + TK + q);
    }
    __syncthreads();
    const int next = step + kWgStages - 1;
    if (next < steps) load_stage(next % kWgStages, next);
    cp_async_commit();
#pragma unroll
    for (int kk = 0; kk < kWgBR; kk += 16) {
      unsigned af[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        ldsm_x4<true>(af[mt], as + (kk + (lane & 7) + (lane >> 4) * 8) * kLdA + wm * (TK / 2) +
                                  mt * 16 + ((lane >> 3) & 1) * 8);
      }
#pragma unroll
      for (int p = 0; p < NT / 2; ++p) {  // two n8 tiles of D at a time
        unsigned t[4];
        ldsm_x4<true>(t, ds + (kk + (lane & 7) + ((lane >> 3) & 1) * 8) * kLdD + wn * (TN / 4) +
                             p * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma16816(acc[mt][2 * p], af[mt], t[0], t[1]);
          mma16816(acc[mt][2 * p + 1], af[mt], t[2], t[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  float* part = g.part + (static_cast<long long>(chunk) * g.taps + tap) * g.k * g.n;
  const int gr = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = k0 + wm * (TK / 2) + mt * 16 + gr + 8 * h;
        const int n = n0 + wn * (TN / 4) + nt * 8 + 2 * t;
        *reinterpret_cast<float2*>(part + static_cast<long long>(k) * g.n + n) =
            make_float2(acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
      }
    }
  }
}

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

int done() { return static_cast<int>(cudaGetLastError()); }

}  // namespace

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
  if (a.rows == 0) return static_cast<int>(cudaSuccess);
  const int cpr = a.n / 8;
  if (a.n % 8 != 0 || cpr > 256 || a.out_col % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long rpb = 256 / cpr;
  long long blocks = (a.rows + rpb - 1) / rpb;
  if (blocks > 132LL * 16) blocks = 132LL * 16;
  bn_backward_kernel<<<static_cast<unsigned>(blocks), 256, 0, st>>>(a);
  return done();
}

namespace {

template <int MODE, int EPI, bool WNK, int BM, int BN>
int launch_pipe_gemm_tile(const GemmArgs& a, cudaStream_t st) {
  constexpr int kBytes = PipeGemmSmem<EPI, BN, WNK, BM>::kBytes;
  static bool smem_set[kMaxDevices] = {};
  const int err = set_smem(pipe_gemm_kernel<MODE, EPI, BN, WNK, BM>, kBytes, smem_set);
  if (err != 0) return err;
  const dim3 grid(a.n / BN, static_cast<unsigned>((a.rows + BM - 1) / BM));
  pipe_gemm_kernel<MODE, EPI, BN, WNK, BM><<<grid, kPipeThreads, kBytes, st>>>(a);
  return done();
}

// the widest column tile up to kMaxBN that divides n: A and its prologue
// are read n / BN times
template <int MODE, int EPI, bool WNK, int BM, int kMaxBN = 256>
int launch_pipe_gemm(const GemmArgs& a, cudaStream_t st) {
  if (WNK && (a.k_split % kPipeBK != 0 || a.k_split > a.k)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if constexpr (kMaxBN >= 256) {
    if (a.n % 256 == 0) return launch_pipe_gemm_tile<MODE, EPI, WNK, BM, 256>(a, st);
  }
  if (a.n % 128 == 0) return launch_pipe_gemm_tile<MODE, EPI, WNK, BM, 128>(a, st);
  return launch_pipe_gemm_tile<MODE, EPI, WNK, BM, 64>(a, st);
}

template <int MODE, int TK, int TN>
int launch_pipe_wgrad(const WgradArgs& a, unsigned chunks, cudaStream_t st) {
  constexpr int kBytes = WgradRing<TK, TN>::kBytes;
  static bool smem_set[kMaxDevices] = {};
  const int err = set_smem(pipe_wgrad_kernel<MODE, TK, TN>, kBytes, smem_set);
  if (err != 0) return err;
  pipe_wgrad_kernel<MODE, TK, TN>
      <<<dim3(a.n / TN, a.k / TK, chunks * a.taps), kPipeThreads, kBytes, st>>>(a);
  return done();
}

template <int MODE>
int launch_pipe_wgrad(const WgradArgs& a, unsigned chunks, cudaStream_t st) {
  if (a.k % 128 == 0) {
    return a.n % 128 == 0 ? launch_pipe_wgrad<MODE, 128, 128>(a, chunks, st)
                          : launch_pipe_wgrad<MODE, 128, 64>(a, chunks, st);
  }
  return a.n % 128 == 0 ? launch_pipe_wgrad<MODE, 64, 128>(a, chunks, st)
                        : launch_pipe_wgrad<MODE, 64, 64>(a, chunks, st);
}

}  // namespace

// One GEMM on the pipelined mainloop (K6.1's c1 and projection sums,
// K6.2's c2, K6.3's c3 sums, K6.4's residual and y, K7.1's BN3 sums, K7.2's
// dc3 and g2, K7.3's g1, K7.4's dcp and dx); grid (n / BN, ceil(rows /
// BM)), BM 128 for c1, c2, g2 and g1 and 64 for the others (c1: 128 was
// faster than 64 at all five ResNet-50 block shapes, PERF.md section 6);
// the epilogues with sums write one pair per (BM-row tile, channel) to
// part0 [tiles, 2, n]. k a multiple of 32, n of 64; c2 reads
// w2 as [k, n] (k = 9 kc, kc a multiple of 64); g2, g1 and dx read W^T
// [n, k] as stored, g1 per tap from w2 [9, n, kc].
extern "C" int rxtpu_fb_pipe_gemm(const GemmArgs* args, void* stream) {
  const GemmArgs& a = *args;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a.rows == 0) return static_cast<int>(cudaSuccess);
  if (a.k % kPipeBK != 0 || a.n % 64 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const bool taps_ok = a.a.kc % 64 == 0 && a.k == 9 * a.a.kc && a.k_split == 0;
  if (a.mode == kStored && a.epi == kStoreStats) {  // K6.1 c1, W = w1
    return launch_pipe_gemm<kStored, kStoreStats, false, 128>(a, st);
  }
  if (a.mode == kStored && a.epi == kStats) {  // K6.1 projection sums: the residual's, W = wp
    return launch_pipe_gemm<kStored, kStats, false, 64>(a, st);
  }
  if (a.mode == kTapBnRelu && a.epi == kStoreStats) {  // K6.2 c2, W = w2 [9 kc, n]
    if (!taps_ok) return static_cast<int>(cudaErrorInvalidValue);
    return launch_pipe_gemm<kTapBnRelu, kStoreStats, false, 128, 128>(a, st);
  }
  if (a.mode == kStored && a.epi == kResidual) {  // K6.4 projection residual, W = wp
    return launch_pipe_gemm<kStored, kResidual, false, 64>(a, st);
  }
  if (a.mode == kBnRelu && a.epi == kStats) {  // K6.3 c3 sums: dc3's mainloop, W = w3
    return launch_pipe_gemm<kBnRelu, kStats, false, 64>(a, st);
  }
  if (a.mode == kBnRelu && a.epi == kOutput) {  // K6.4 y, W = w3
    return launch_pipe_gemm<kBnRelu, kOutput, false, 64>(a, st);
  }
  if (a.mode == kBnRelu && a.epi == kBnSums) {  // K7.1 BN3 sums: dc3's GEMM, W = w3
    return launch_pipe_gemm<kBnRelu, kBnSums, false, 64>(a, st);
  }
  if (a.mode == kStored && a.epi == kBnSums) {  // K7.1 projection sums, W = wp
    return launch_pipe_gemm<kStored, kBnSums, false, 64>(a, st);
  }
  if (a.mode == kTapAdjoint && a.epi == kReluGrad) {  // K7.3 g1, W^T = w2[tap]
    if (!taps_ok) return static_cast<int>(cudaErrorInvalidValue);
    return launch_pipe_gemm<kTapAdjoint, kReluGrad, true, 128, 128>(a, st);
  }
  if (a.mode == kBnRelu && a.epi == kBnBackward) {  // K7.2 dc3, W = w3
    return launch_pipe_gemm<kBnRelu, kBnBackward, false, 64>(a, st);
  }
  if (a.mode == kStored && a.epi == kReluGrad) {  // K7.2 g2, W^T = w3
    return launch_pipe_gemm<kStored, kReluGrad, true, 128>(a, st);
  }
  if (a.mode == kStored && a.epi == kBnBackward) {  // K7.4 dcp, W = wp
    return launch_pipe_gemm<kStored, kBnBackward, false, 64>(a, st);
  }
  if (a.mode == kStored && a.epi == kInputGrad) {  // K7.4 dx, W^T = [w1 | wp]
    return launch_pipe_gemm<kStored, kInputGrad, true, 64>(a, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// A weight gradient on the pipelined mainloop (K7.2's dw3, K7.4's dw1 and
// dwp; K7.3's dw2 per tap, kTapBnRelu with taps = 9): per-(chunk, tap)
// partials [chunks, taps, k, n]; grid (n / TN, k / TK, chunks * taps), k
// and n multiples of 64, chunk_rows of 32.
extern "C" int rxtpu_fb_pipe_wgrad(const WgradArgs* args, void* stream) {
  const WgradArgs& a = *args;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long chunks = (a.rows + a.chunk_rows - 1) / a.chunk_rows;
  if (chunks == 0) return static_cast<int>(cudaSuccess);
  if (a.k % 64 != 0 || a.n % 64 != 0 || a.chunk_rows % kWgBR != 0 ||
      a.taps != (a.mode == kTapBnRelu ? 9 : 1) || chunks * a.taps > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const unsigned c = static_cast<unsigned>(chunks);
  switch (a.mode) {
    case kStored: return launch_pipe_wgrad<kStored>(a, c, st);
    case kBnRelu: return launch_pipe_wgrad<kBnRelu>(a, c, st);
    case kTapBnRelu: return launch_pipe_wgrad<kTapBnRelu>(a, c, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
