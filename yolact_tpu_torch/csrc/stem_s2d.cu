// Space-to-depth stem conv: the 4x4/s1 conv with padding (2, 1) on each
// spatial axis (2 before, 1 after) over a 2x2 space-to-depth input,
//
//     out[b, o, y, x] = sum_{c, i, j} xpad[b, c, y + i, x + j] * w2[o, c, i, j]
//
// with xpad = x padded by 2 rows / columns before and 1 after, x [B, 12, H, W],
// w2 [64, 12, 4, 4], out [B, 64, H, W], float32 or bfloat16, summed in
// float32 and rounded once to the input dtype.  With the weight of
// models/layers.py:s2d_stem_kernel this is the ResNet's 7x7/s2/p3 stem.
// Replaces the Pallas TPU kernel yolact_tpu/kernels/stem.py:_kernel
// (stem_conv_s2d_pallas), whose row windows with duplicated halos and
// 8-lane padded widths exist for the TPU's VMEM and lanes and are not copied.
//
// Bound.  At yolact_base 550^2 b8 the conv has 8 * 275^2 = 605 K output
// pixels of 64 channels and 192 taps, 14.9 GFLOP, and moves 92 MB (77.4 MB
// of bf16 output, 14.5 MB of input): 27 us at 3.35 TB/s, 15 us at the
// tensor cores' 989 TFLOP/s.  So in bf16 the conv is bound by the output
// write, as long as the products run on the tensor cores.
//
// bfloat16: an implicit GEMM on the tensor cores, M = output pixels, N = 64
// channels, K = 192 taps in 12 k-steps of 16, one input channel's 4x4 window
// per k-step (k = c * 16 + i * 4 + j, w2's own order).
//   - one block of 8 warps per tile of 8 output rows x 32 columns; a warp
//     owns one row: two m16 tiles x eight n8 tiles of mma.sync.m16n8k16
//     (bf16 in, float32 sums in registers, 64 per thread);
//   - the whole weight, [64][192] bf16, is copied once per block with
//     16-byte cp.async into rows padded to 200 elements, so the B
//     fragments' 32-bit loads hit 32 distinct banks;
//   - the input halo (12 x 11 x 35) is staged through registers (every
//     load of a thread in flight before its first shared store) as
//     duplicated pairs: word (c, row, col) holds the values at col and
//     col + 1.  An A fragment register is the pair (tap j, j + 1) of one
//     pixel, i.e. the input at columns x + j and x + j + 1, which is one
//     aligned 32-bit load from that layout (a plain halo would need two
//     2-byte loads per register: W is odd, so no pair is 4-byte aligned in
//     device memory either, and cp.async, 4 bytes at least, cannot place
//     it).  Rows are padded to 44 words so the fragment loads of a warp
//     fall on distinct banks;
//   - the epilogue rounds each float32 sum once to bf16, stages the tile
//     as [64][8][32] in the shared memory the halo and weight used, and
//     stores rows of 32 pixels along W: a warp writes 64 contiguous bytes
//     of one channel row.
//   The 45 zero taps of the embedded 7x7 are multiplied like the rest.
//
// float32: the same implicit GEMM on the tensor cores in TF32, with each
// product split in three (one TF32 pass keeps ~11 significant bits, 3e-4
// of max|out| at K = 192, against the 1e-5 criterion): v = hi + lo with
// hi = cvt.rna.tf32(v), lo = cvt.rna.tf32(v - hi), summing lo*hi + hi*lo
// + hi*hi in float32 (the dropped lo*lo and lo's rounding leave ~2^-21 of
// each product), as csrc/mask_assembly.cu does.  As FMAs the conv would be
// bound at 0.22 ms at b8 (14.9 GFLOP at 67 TFLOP/s), above cuDNN's own
// float32 convs; as three TF32 products it is bound at 0.09 ms (494.7
// TFLOP/s); its bytes (184 MB) take 0.055 ms.
//   - a persistent grid, one block of 8 warps per SM (162 KB of shared
//     memory), walks tiles of 16 output rows x 32 columns; a warp owns two
//     rows: four m16 tiles x eight n8 tiles of mma.sync.m16n8k8 (128 float32
//     sums per thread), over 24 k-steps of 8 (one channel, two tap rows);
//   - the weight is split once per block into (hi, lo) pairs, [64][196]
//     float2: a row pitch of 4 mod 16 pairs puts the 8-byte B-fragment
//     loads of a half-warp on 16 distinct bank pairs;
//   - the raw float32 halo (12 x 19 x 36) is double-buffered: the next
//     tile's halo is in flight by 4-byte cp.async (zero-filled outside the
//     image) while this tile is multiplied; A fragments are split as they
//     are loaded;
//   - per k-step a warp loads its eight B fragments, then issues the 96
//     products pass by pass, 32 independent accumulators between two
//     products into the same one;
//   - the sums are stored straight from the fragments: a warp's store
//     covers 8 consecutive pixels of 4 channel rows.
//   Measured on an H100 (probe_stem.py, PERF.md): 0.39-0.40 ms at b8, 4.3x
//   its bound and ahead of cuDNN's float32 4x4 and 7x7/s2 convs in the same
//   process; one product fewer saves 8%, no stores 17%, no halo staging 7%:
//   no single part sets the time.

// Numerics.  The plain version (kernels/stem.py) is cuDNN's float32 conv
// rounded once.  The bf16 products are exact in float32; the tensor cores
// sum them in another order than cuDNN, so bf16 outputs agree within one
// bf16 ulp of the output, plus float32 rounding near zero.  float32
// outputs agree within a few 1e-6 of max|out| (the split's ~2^-21 per
// product and another summation order).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCin = 12;
constexpr int kCout = 64;
constexpr int kTaps = kCin * 16;                 // c * 16 + i * 4 + j
constexpr int kTileH = 8;
constexpr int kTileW = 32;
constexpr int kThreads = kTileH * kTileW;
constexpr int kHaloH = kTileH + 3;
constexpr int kHaloW = kTileW + 3;

// ---- float32: split-TF32 mma.sync on the tensor cores -----------------

constexpr int kF32TileH = 16;                    // 8 warps x 2 output rows
constexpr int kF32HaloH = kF32TileH + 3;         // 19
constexpr int kF32HaloRow = 36;                  // floats per halo row (35 used)
constexpr int kF32HaloUsed = kCin * kF32HaloH * kHaloW;
constexpr int kF32WRow = kTaps + 4;              // float2 per weight row: 196
constexpr size_t kF32WeightBytes = static_cast<size_t>(kCout) * kF32WRow * 8;
constexpr size_t kF32HaloBytes =
    static_cast<size_t>(kCin) * kF32HaloH * kF32HaloRow * 4;
constexpr size_t kTf32SmemBytes = kF32WeightBytes + 2 * kF32HaloBytes;
static_assert(kF32WRow % 16 == 4, "weight rows: B fragments on distinct banks");
static_assert(kF32WeightBytes % 16 == 0, "halo must start 16-byte aligned");

__device__ __forceinline__ float to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return __uint_as_float(r);
}

// v = hi + lo, both TF32 (rounded to nearest, ties away from zero); lo is 0
// where hi is not finite, so an infinite input stays infinite
__device__ __forceinline__ float2 split_tf32(float v) {
  const float hi = to_tf32(v);
  return make_float2(hi, isfinite(hi) ? to_tf32(v - hi) : 0.f);
}

// not volatile: the compiler may interleave the products with the loads
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct F32Tile {
  int b, y0, x0;
};

__device__ __forceinline__ F32Tile f32_tile(int tile, int h, int w) {
  const int tiles_w = (w + kTileW - 1) / kTileW;
  const int tiles_h = (h + kF32TileH - 1) / kF32TileH;
  const int per_image = tiles_w * tiles_h;
  const int r = tile % per_image;
  return {tile / per_image, (r / tiles_w) * kF32TileH, (r % tiles_w) * kTileW};
}

// the raw float32 halo of one tile, [c][row][col], by 4-byte cp.async;
// zero-filled outside the image (the conv's padding)
__device__ __forceinline__ void f32_stage_halo(const float* __restrict__ x,
                                               uint32_t dst_base, int tile,
                                               int h, int w) {
  const F32Tile t = f32_tile(tile, h, w);
  const size_t plane = static_cast<size_t>(h) * w;
  const float* xb = x + static_cast<size_t>(t.b) * kCin * plane;
  for (int e = threadIdx.x; e < kF32HaloUsed; e += kThreads) {
    const int col = e % kHaloW;
    const int row = (e / kHaloW) % kF32HaloH;
    const int c = e / (kHaloW * kF32HaloH);
    const int gy = t.y0 + row - 2, gx = t.x0 + col - 2;
    const bool inside = gy >= 0 && gy < h && gx >= 0 && gx < w;
    const float* src =
        inside ? xb + c * plane + static_cast<size_t>(gy) * w + gx : x;
    const uint32_t dst =
        dst_base + ((c * kF32HaloH + row) * kF32HaloRow + col) * 4;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
                 "l"(src), "r"(inside ? 4 : 0));
  }
}

__global__ void __launch_bounds__(kThreads, 1)
    stem_s2d_tf32_kernel(const float* __restrict__ x,
                         const float* __restrict__ w2,
                         float* __restrict__ out, int n_tiles, int h, int w) {
  extern __shared__ float4 smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
  float2* ws = reinterpret_cast<float2*>(smem);            // [o][k] (hi, lo)
  const float* halo = reinterpret_cast<const float*>(smem + kF32WeightBytes);
  const uint32_t halo_base =
      static_cast<uint32_t>(__cvta_generic_to_shared(smem + kF32WeightBytes));
  const int tid = threadIdx.x;

  f32_stage_halo(x, halo_base, blockIdx.x, h, w);
  asm volatile("cp.async.commit_group;\n" ::);
  // the weight, split once per block; neighbouring threads take
  // neighbouring taps (coalesced reads, conflict-free 8-byte stores)
  for (int e = tid; e < kCout * kTaps; e += kThreads) {
    ws[(e / kTaps) * kF32WRow + e % kTaps] = split_tf32(__ldg(w2 + e));
  }

  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  const size_t plane = static_cast<size_t>(h) * w;
  int buf = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    // the next tile's halo is in flight while this one is multiplied
    const int next = tile + gridDim.x;
    if (next < n_tiles) {
      f32_stage_halo(x, halo_base + (buf ^ 1) * kF32HaloBytes, next, h, w);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::);
    __syncthreads();

    float acc[4][8][4];
#pragma unroll
    for (int m = 0; m < 4; ++m)
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;

    // m tile m: output row 2 * warp + (m >> 1), columns (m & 1) * 16 + 0..15;
    // k-step ks: channel ks / 2, tap rows i0 = (ks & 1) * 2 and i0 + 1;
    // fragment column tig is tap (i0, tig), column tig + 4 is (i0 + 1, tig)
    const float* hb = halo + buf * (kF32HaloBytes / 4) +
                      warp * 2 * kF32HaloRow + g + tig;
#pragma unroll 1
    for (int ks = 0; ks < kTaps / 8; ++ks) {
      const float* p =
          hb + ((ks >> 1) * kF32HaloH + (ks & 1) * 2) * kF32HaloRow;
      uint32_t ahi[4][4], alo[4][4];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const float* q = p + (m >> 1) * kF32HaloRow + (m & 1) * 16;
        const float v[4] = {q[0], q[8], q[kF32HaloRow], q[kF32HaloRow + 8]};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float2 s = split_tf32(v[r]);
          ahi[m][r] = __float_as_uint(s.x);
          alo[m][r] = __float_as_uint(s.y);
        }
      }
      // all eight B fragments first, then the three products pass by pass:
      // 32 independent accumulators between two products into the same one
      uint32_t bh[8][2], bl[8][2];
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float2* wb = ws + (n * 8 + g) * kF32WRow + ks * 8 + tig;
        const float2 b0 = wb[0], b1 = wb[4];
        bh[n][0] = __float_as_uint(b0.x);
        bl[n][0] = __float_as_uint(b0.y);
        bh[n][1] = __float_as_uint(b1.x);
        bl[n][1] = __float_as_uint(b1.y);
      }
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int m = 0; m < 4; ++m) mma_tf32(acc[m][n], alo[m], bh[n][0], bh[n][1]);
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int m = 0; m < 4; ++m) mma_tf32(acc[m][n], ahi[m], bl[n][0], bl[n][1]);
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int m = 0; m < 4; ++m) mma_tf32(acc[m][n], ahi[m], bh[n][0], bh[n][1]);
    }

    // stores straight from the fragments: a warp's store covers 8
    // consecutive pixels of 4 channel rows
    const F32Tile t = f32_tile(tile, h, w);
    float* ob = out + static_cast<size_t>(t.b) * kCout * plane;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int y = t.y0 + warp * 2 + (m >> 1);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int xo = t.x0 + (m & 1) * 16 + g + (e >> 1) * 8;
        if (y < h && xo < w) {
          float* dst = ob + static_cast<size_t>(y) * w + xo;
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            dst[(n * 8 + tig * 2 + (e & 1)) * plane] = acc[m][n][e];
          }
        }
      }
    }
    __syncthreads();    // everyone is done with this halo buffer
    buf ^= 1;
  }
}

// ---- bfloat16: mma.sync on the tensor cores -----------------------------

constexpr int kWRow = kTaps + 8;                 // bf16 per padded weight row
constexpr int kWRowWords = kWRow / 2;            // 100: 4 * n mod 32 banks
constexpr int kPairCols = kTileW + 2;            // pair words used per row
constexpr int kPairRow = 44;                     // words per halo row
constexpr int kHaloWords = kCin * kHaloH * kPairCols;
constexpr int kHaloSteps = (kHaloWords + kThreads - 1) / kThreads;
constexpr int kOutRow = kTileH * kTileW + 8;     // bf16 per staged channel
constexpr size_t kWeightBytes = static_cast<size_t>(kCout) * kWRow * 2;
constexpr size_t kHaloBytes = static_cast<size_t>(kCin) * kHaloH * kPairRow * 4;
constexpr size_t kOutBytes = static_cast<size_t>(kCout) * kOutRow * 2;
constexpr size_t kMmaSmemBytes =
    kWeightBytes + kHaloBytes > kOutBytes ? kWeightBytes + kHaloBytes
                                          : kOutBytes;
static_assert(kWeightBytes % 16 == 0, "halo must start 16-byte aligned");
static_assert(kPairRow % 32 >= 10 && kPairRow % 32 <= 22 &&
                  kPairRow >= kPairCols,
              "halo rows: the two tap rows of a fragment on distinct banks");

__device__ __forceinline__ uint32_t bf16_bits(const __nv_bfloat16* p) {
  return static_cast<uint32_t>(__ldg(reinterpret_cast<const uint16_t*>(p)));
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kThreads, 2)
    stem_s2d_mma_kernel(const __nv_bfloat16* __restrict__ x,
                        const __nv_bfloat16* __restrict__ w2,
                        __nv_bfloat16* __restrict__ out, int h, int w) {
  extern __shared__ float4 smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
  const uint32_t* ws = reinterpret_cast<const uint32_t*>(smem);  // [o][k/2]
  uint32_t* hp = reinterpret_cast<uint32_t*>(smem + kWeightBytes);
  __nv_bfloat16* os = reinterpret_cast<__nv_bfloat16*>(smem);    // epilogue
  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * kTileH;
  const int x0 = blockIdx.x * kTileW;

  // the weight: 64 rows of 384 bytes, 24 chunks of 16 bytes each
  {
    const uint32_t base = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
    for (int k = tid; k < kCout * 24; k += kThreads) {
      const int o = k / 24, q = k % 24;
      const uint32_t dst = base + o * (kWRow * 2) + q * 16;
      const __nv_bfloat16* src = w2 + o * kTaps + q * 8;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                   "l"(src));
    }
    asm volatile("cp.async.commit_group;\n" ::);
  }
  // the halo as duplicated pairs, zero outside the image (the padding):
  // all of a thread's loads are issued before the first shared store, so
  // their latencies overlap
  const size_t plane = static_cast<size_t>(h) * w;
  const __nv_bfloat16* xb = x + static_cast<size_t>(b) * kCin * plane;
  uint32_t pair[kHaloSteps];
#pragma unroll
  for (int q = 0; q < kHaloSteps; ++q) {
    const int k = tid + q * kThreads;
    const int col = k % kPairCols;
    const int row = (k / kPairCols) % kHaloH;
    const int c = k / (kPairCols * kHaloH);
    const int gy = y0 + row - 2, gx = x0 + col - 2;
    uint32_t lo = 0, hi = 0;
    if (k < kHaloWords && gy >= 0 && gy < h) {
      const __nv_bfloat16* src = xb + c * plane + static_cast<size_t>(gy) * w;
      if (gx >= 0 && gx < w) lo = bf16_bits(src + gx);
      if (gx + 1 >= 0 && gx + 1 < w) hi = bf16_bits(src + gx + 1);
    }
    pair[q] = lo | (hi << 16);
  }
#pragma unroll
  for (int q = 0; q < kHaloSteps; ++q) {
    const int k = tid + q * kThreads;
    if (k < kHaloWords) {
      const int col = k % kPairCols;
      const int row = (k / kPairCols) % kHaloH;
      const int c = k / (kPairCols * kHaloH);
      hp[(c * kHaloH + row) * kPairRow + col] = pair[q];
    }
  }
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();

  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, tig = lane & 3;
  // fragment rows: pixel g (+8) of an m16 tile; k pair tig * 2 (+8) of the
  // k-step, i.e. tap row i = tig >> 1 (+2), columns j = (tig & 1) * 2, +1
  const int a_off = ((tig >> 1) + warp) * kPairRow + g + (tig & 1) * 2;
  const int b_off = g * kWRowWords + tig;

  float acc[2][8][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][n][e] = 0.f;

#pragma unroll 2
  for (int c = 0; c < kCin; ++c) {
    uint32_t a[2][4];
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const uint32_t* p = hp + c * kHaloH * kPairRow + a_off + m * 16;
      a[m][0] = p[0];
      a[m][1] = p[8];
      a[m][2] = p[2 * kPairRow];
      a[m][3] = p[2 * kPairRow + 8];
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const uint32_t* q = ws + n * 8 * kWRowWords + b_off + c * 8;
      const uint32_t b0 = q[0], b1 = q[4];
      mma_bf16(acc[0][n], a[0], b0, b1);
      mma_bf16(acc[1][n], a[1], b0, b1);
    }
  }
  __syncthreads();    // everyone is done with the halo and the weight

  // stage [o][ty][tx], rounded once
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int o = n * 8 + tig * 2 + (e & 1);
        const int tx = m * 16 + g + (e >> 1) * 8;
        os[o * kOutRow + warp * kTileW + tx] = __float2bfloat16_rn(acc[m][n][e]);
      }
  __syncthreads();

  // a warp stores one channel row of 32 pixels at a time
  const int tx = lane, xo = x0 + lane;
  __nv_bfloat16* ob = out + static_cast<size_t>(b) * kCout * plane;
#pragma unroll 4
  for (int r = warp; r < kCout * kTileH; r += kThreads / 32) {
    const int o = r / kTileH, ty = r % kTileH;
    const int y = y0 + ty;
    if (y < h && xo < w) {
      ob[o * plane + static_cast<size_t>(y) * w + xo] =
          os[o * kOutRow + ty * kTileW + tx];
    }
  }
}

template <typename T>
int launch(void (*kernel)(const T*, const T*, T*, int, int), size_t smem,
           const void* x, const void* w2, void* out, int b, int h, int w,
           cudaStream_t stream) {
  // above 48 KB of shared memory a block needs the opt-in attribute
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH, b);
  kernel<<<grid, kThreads, smem, stream>>>(static_cast<const T*>(x),
                                           static_cast<const T*>(w2),
                                           static_cast<T*>(out), h, w);
  return static_cast<int>(cudaGetLastError());
}

// float32: a persistent grid of as many blocks as fit on the card (one per
// SM: 162 KB of shared memory each), each walking tiles gridDim.x apart
int launch_tf32(const void* x, const void* w2, void* out, int b, int h, int w,
                cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      stem_s2d_tf32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kTf32SmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, stem_s2d_tf32_kernel, kThreads, kTf32SmemBytes);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long n_tiles = static_cast<long long>(b) *
                            ((h + kF32TileH - 1) / kF32TileH) *
                            ((w + kTileW - 1) / kTileW);
  if (n_tiles >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const long long grid = n_tiles < static_cast<long long>(sms) * per_sm
                             ? n_tiles
                             : static_cast<long long>(sms) * per_sm;
  stem_s2d_tf32_kernel<<<static_cast<unsigned>(grid), kThreads,
                         kTf32SmemBytes, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w2),
      static_cast<float*>(out), static_cast<int>(n_tiles), h, w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (x, w2 and out alike).  In bfloat16 w2 must
// be 16-byte aligned (kernels/stem.py checks it).
extern "C" int yolact_stem_s2d_conv(const void* x, const void* w2, void* out,
                                    int dtype, int b, int h, int w,
                                    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_tf32(x, w2, out, b, h, w, s);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(stem_s2d_mma_kernel, kMmaSmemBytes, x, w2,
                                 out, b, h, w, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
