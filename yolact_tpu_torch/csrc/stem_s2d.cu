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
// Bound.  At yolact_base 550^2 b8 the conv has 8 * 64 * 275^2 = 38.7 M
// outputs of 192 multiply-adds each, 14.9 GFLOP, and moves 92 MB (77.4 MB
// of bf16 output, 14.5 MB of input): 27 us at 3.35 TB/s, but at least
// 0.22 ms at the card's float32 FMA rate.  Without tensor cores the kernel
// is bound by arithmetic, so the design keeps the FMA units fed from
// registers and shared memory:
//   - one block of 256 threads per tile of 8 output rows x 32 columns, all
//     64 output channels; each thread owns one pixel and keeps its 64 sums
//     in float32 registers;
//   - the block stages the input halo tile (12 x 11 x 35) and the whole
//     weight (12 * 16 taps x 64 channels, 48 KB as float32) in shared
//     memory, both converted to float32 once;
//   - per tap a thread reads one input value (a warp reads one row of 32
//     consecutive pixels: no bank conflict) and the 64 weights as 16
//     broadcast float4 loads, then does 64 FMAs;
//   - a warp stores one row of 32 consecutive pixels per channel:
//     coalesced along W.
// Tensor-core products (mma / wgmma) over an implicit im2col are later work.
//
// Numerics: fmaf in the order c, i, j, one rounding to the output dtype.
// The plain version (kernels/stem.py) is cuDNN's float32 conv rounded once;
// cuDNN may sum in another order, so the two agree to float32 rounding
// (bit for bit at the yolact_base shapes on an H100), and bf16 outputs
// within 1 ulp.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kCin = 12;
constexpr int kCout = 64;
constexpr int kTaps = kCin * 16;                 // c * 16 + i * 4 + j
constexpr int kTileH = 8;
constexpr int kTileW = 32;
constexpr int kThreads = kTileH * kTileW;
constexpr int kHaloH = kTileH + 3;
constexpr int kHaloW = kTileW + 3;
constexpr int kWeightFloats = kTaps * kCout;     // [tap][o]
constexpr int kHaloFloats = kCin * kHaloH * kHaloW;
constexpr size_t kSmemBytes =
    static_cast<size_t>(kWeightFloats + kHaloFloats) * sizeof(float);

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    stem_s2d_kernel(const T* __restrict__ x, const T* __restrict__ w2,
                    T* __restrict__ out, int h, int w) {
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);   // [tap][o]
  float* xs = ws + kWeightFloats;                // [c][row][col]
  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * kTileH;
  const int x0 = blockIdx.x * kTileW;

  // weights: neighbouring threads take neighbouring output channels, so the
  // shared-memory stores are conflict-free; each thread walks its channel's
  // row of w2 over the loop, which stays in L1
  for (int k = tid; k < kWeightFloats; k += kThreads) {
    const int o = k % kCout, t = k / kCout;
    ws[k] = to_f(w2[o * kTaps + t]);
  }
  // input halo tile, zero outside the image (the conv's padding)
  const size_t plane = static_cast<size_t>(h) * w;
  const T* xb = x + static_cast<size_t>(b) * kCin * plane;
  for (int k = tid; k < kHaloFloats; k += kThreads) {
    const int col = k % kHaloW;
    const int row = (k / kHaloW) % kHaloH;
    const int c = k / (kHaloW * kHaloH);
    const int gy = y0 + row - 2, gx = x0 + col - 2;
    float v = 0.f;
    if (gy >= 0 && gy < h && gx >= 0 && gx < w) {
      v = to_f(xb[c * plane + static_cast<size_t>(gy) * w + gx]);
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
  T* dst = out + static_cast<size_t>(b) * kCout * plane +
           static_cast<size_t>(y) * w + xo;
#pragma unroll
  for (int o = 0; o < kCout; ++o) dst[o * plane] = from_f<T>(acc[o]);
}

template <typename T>
int launch(const void* x, const void* w2, void* out, int b, int h, int w,
           cudaStream_t stream) {
  // above 48 KB of shared memory a block needs the opt-in attribute
  const cudaError_t err = cudaFuncSetAttribute(
      stem_s2d_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH, b);
  stem_s2d_kernel<T><<<grid, kThreads, kSmemBytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w2),
      static_cast<T*>(out), h, w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (x, w2 and out alike).
extern "C" int yolact_stem_s2d_conv(const void* x, const void* w2, void* out,
                                    int dtype, int b, int h, int w,
                                    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(x, w2, out, b, h, w, s);
  if (dtype == 1) return launch<__nv_bfloat16>(x, w2, out, b, h, w, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
