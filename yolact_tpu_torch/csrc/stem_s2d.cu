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
// float32: plain FMAs, one pixel x 64 channels per thread (TF32 tensor
// cores would round the inputs to 10-bit mantissas and break the float32
// contract): one block of 256 threads per tile of 8 x 32 pixels, the halo
// and the weight as float32 in shared memory, 64 sums in registers, fmaf in
// the order c, i, j.  Bound by the FMA rate (0.22 ms at b8 at 67 TFLOP/s).
//
// Numerics.  The plain version (kernels/stem.py) is cuDNN's float32 conv
// rounded once.  The bf16 products are exact in float32; the tensor cores
// sum them in another order than cuDNN, so bf16 outputs agree within one
// bf16 ulp of the output, plus float32 rounding near zero.  float32
// outputs agree to float32 rounding.

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

// ---- float32: plain FMAs ----------------------------------------------

constexpr int kWeightFloats = kTaps * kCout;     // [tap][o]
constexpr int kHaloFloats = kCin * kHaloH * kHaloW;
constexpr size_t kFmaSmemBytes =
    static_cast<size_t>(kWeightFloats + kHaloFloats) * sizeof(float);

__global__ void __launch_bounds__(kThreads, 2)
    stem_s2d_fma_kernel(const float* __restrict__ x,
                        const float* __restrict__ w2,
                        float* __restrict__ out, int h, int w) {
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);   // [tap][o]
  float* xs = ws + kWeightFloats;                // [c][row][col]
  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * kTileH;
  const int x0 = blockIdx.x * kTileW;

  // weights: neighbouring threads take neighbouring output channels, so the
  // shared-memory stores are conflict-free
  for (int k = tid; k < kWeightFloats; k += kThreads) {
    const int o = k % kCout, t = k / kCout;
    ws[k] = w2[o * kTaps + t];
  }
  // input halo tile, zero outside the image (the conv's padding)
  const size_t plane = static_cast<size_t>(h) * w;
  const float* xb = x + static_cast<size_t>(b) * kCin * plane;
  for (int k = tid; k < kHaloFloats; k += kThreads) {
    const int col = k % kHaloW;
    const int row = (k / kHaloW) % kHaloH;
    const int c = k / (kHaloW * kHaloH);
    const int gy = y0 + row - 2, gx = x0 + col - 2;
    float v = 0.f;
    if (gy >= 0 && gy < h && gx >= 0 && gx < w) {
      v = xb[c * plane + static_cast<size_t>(gy) * w + gx];
    }
    xs[k] = v;
  }
  __syncthreads();

  const int ty = tid / kTileW, tx = tid % kTileW;
  float acc[kCout];
#pragma unroll
  for (int o = 0; o < kCout; ++o) acc[o] = 0.f;

#pragma unroll 1
  for (int c = 0; c < kCin; ++c) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float v = xs[(c * kHaloH + ty + i) * kHaloW + tx + j];
        const float4* wv =
            reinterpret_cast<const float4*>(ws + (c * 16 + i * 4 + j) * kCout);
#pragma unroll
        for (int q = 0; q < kCout / 4; ++q) {
          const float4 wq = wv[q];
          acc[4 * q + 0] = fmaf(v, wq.x, acc[4 * q + 0]);
          acc[4 * q + 1] = fmaf(v, wq.y, acc[4 * q + 1]);
          acc[4 * q + 2] = fmaf(v, wq.z, acc[4 * q + 2]);
          acc[4 * q + 3] = fmaf(v, wq.w, acc[4 * q + 3]);
        }
      }
    }
  }

  const int y = y0 + ty, xo = x0 + tx;
  if (y >= h || xo >= w) return;
  float* dst = out + static_cast<size_t>(b) * kCout * plane +
               static_cast<size_t>(y) * w + xo;
#pragma unroll
  for (int o = 0; o < kCout; ++o) dst[o * plane] = acc[o];
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

}  // namespace

// dtype: 0 float32, 1 bfloat16 (x, w2 and out alike).  In bfloat16 w2 must
// be 16-byte aligned (kernels/stem.py checks it).
extern "C" int yolact_stem_s2d_conv(const void* x, const void* w2, void* out,
                                    int dtype, int b, int h, int w,
                                    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float>(stem_s2d_fma_kernel, kFmaSmemBytes, x, w2, out, b,
                         h, w, s);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(stem_s2d_mma_kernel, kMmaSmemBytes, x, w2,
                                 out, b, h, w, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
