// Modulated deformable im2col (DCNv2 sampling), channels last: for image b,
// output pixel p = (ho, wo), tap t = (i, j) of the K x K kernel and input
// channel c,
//
//     y = (row0 + ho) * stride - pad + i * dil + offset[b, 2t,     ho, wo]
//     x = wo * stride - pad + j * dil + offset[b, 2t + 1, ho, wo]
//     cols[b * Ho * Wo + p, t * C + c] = bilinear(x[b, :, :, c], y, x)
//                                        * mask[b, t, ho, wo]
//
// with per-corner zero outside the map.  row0 is the map's output row of
// the first row computed (0 for the whole map; a spatial rank's first
// output row, the input x being the whole map).  x is NHWC [B, H, W, C]; the columns
// are JAX's own layout [B * Ho * Wo, K * K * C] (yolact_tpu/kernels/dcn.py,
// deform_conv2d), so the GEMM that consumes them is one torch.matmul with
// leading dimensions K * K * C and Cout (kernels/dcn.py).  Replaces the DCN
// bilinear corner gather that the TPU package probed with four Pallas
// kernels (scripts/bench_gather2.py: pallas_kernel, taa_kernel, taa4_kernel;
// scripts/probe_sameshape_gather.py: kernel) and runs in production as
// yolact_tpu/kernels/dcn.py:_bilinear_gather.
//
// Bound.  At yolact_plus_base 550^2 b8 the kernel writes about 606 MB of
// bf16 columns per batch (87.7 MB for each layers.1 block, 45.2 MB for each
// layers.2 block, 23.9 MB for layers.3), 0.18 ms at the data-sheet
// 3.35 TB/s, and reads the feature maps (1.6-4.9 MB per block) and the
// offsets and mask once.  It is bound by the column stores.  So:
//   - one thread per (pixel, group of 8 channels) walks the K * K taps;
//     neighbouring threads take neighbouring channel groups of one pixel,
//     then the next pixel, so for each tap a warp's stores are contiguous
//     runs of the column matrix, and the corners that a pixel's taps and
//     its neighbours' share are read again from L1, not L2;
//   - per tap a thread computes the sample position, the four corner
//     indices and the four weights, loads each corner's 8 channels as one
//     16-byte vector (8 bf16; two of 4 floats in float32) and stores its 8
//     results as one 16-byte vector (two in float32);
//   - when C is not a multiple of 8 (or x is not 16-byte aligned) the same
//     kernel loads and stores channel by channel (kVec = false): the tiny
//     test configs have C = 3 and 5.
// The (pixel, tap) arithmetic is repeated by each of the C / 8 threads of a
// pixel; it is a few dozen instructions against 64 loaded and 16 stored
// bytes.  On the H100 the kernel reaches 30-60% of the store bound: the
// corner loads, four per store, mostly miss L1 once samples are deformed
// and come from L2.  One thread per (pixel, tap, 8 channels) is slower
// still (it loses the L1 reuse between a pixel's taps), and more threads
// per pixel (the kernel's rows over blockIdx.y) or smaller blocks do not
// help (PERF.md; probe_dcn.py).  Keeping the columns out of device memory
// (an implicit GEMM with wgmma) is later work.
//
// Numerics: the same float operations, in the same order, as
// kernels/dcn.py:bilinear_sample_plain + dcn_columns_plain, so the columns
// are bit-equal to the plain version.  With --fmad=false (kernels/_build.py)
// no product is fused into an add.  In bf16, rnd<T>() marks the points
// where the plain version (and JAX's _bilinear_gather_block) rounds to bf16:
// the corner weight (float32 product, then cast), each corner product, the
// float32 sum of the four, and the product with the mask.
// floor(coordinate) is clamped to [-2, n] before the integer conversion (NaN
// to 0, as XLA converts it), as _corner_index does; an invalid corner reads
// the clamped pixel and weighs it by exactly 0.  So a NaN offset gives NaN
// columns and an infinite one zero columns, as in the plain version and in
// JAX.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 8;    // channels per thread

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

// the rounding of one PyTorch op whose result has dtype T
template <typename T>
__device__ __forceinline__ float rnd(float v) {
  return to_f(from_f<T>(v));
}

__device__ __forceinline__ int corner_index(float f, int n) {
  if (f != f) return 0;
  return static_cast<int>(fminf(fmaxf(f, -2.f), static_cast<float>(n)));
}

// 8 consecutive channels, 16-byte aligned
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float2 f = __bfloat1622float2(h[q]);
    v[2 * q] = f.x;
    v[2 * q + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* v) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int q = 0; q < 4; ++q) h[q] = __floats2bfloat162_rn(v[2 * q], v[2 * q + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}
__device__ __forceinline__ void store8(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
    dcn_im2col_kernel(const T* __restrict__ x, const float* __restrict__ offset,
                      const T* __restrict__ mask, T* __restrict__ cols,
                      int n_threads, int c_total, int h, int w, int ho_total,
                      int wo_total, int k, int stride, int pad, int dil,
                      int row0) {
  const int tid = blockIdx.x * kThreads + threadIdx.x;
  if (tid >= n_threads) return;
  const int groups = (c_total + kGroup - 1) / kGroup;
  const int kk = k * k;
  const int n_pix = ho_total * wo_total;
  const int g = tid % groups;
  const int bp = tid / groups;                  // b * n_pix + p
  const int b = bp / n_pix, p = bp % n_pix;
  const int ho = p / wo_total, wo = p % wo_total;
  const int c0 = g * kGroup;
  const float* off = offset + static_cast<size_t>(b) * 2 * kk * n_pix + p;
  const T* msk = mask + static_cast<size_t>(b) * kk * n_pix + p;
  const T* xb = x + static_cast<size_t>(b) * h * w * c_total + c0;
  T* dst = cols + static_cast<size_t>(bp) * kk * c_total + c0;

#pragma unroll 9    // the taps of a 3x3 kernel
  for (int t = 0; t < kk; ++t) {
    const int i = t / k, j = t % k;
    const float ys = static_cast<float>((row0 + ho) * stride - pad + i * dil) +
                     off[(2 * t) * n_pix];
    const float xs = static_cast<float>(wo * stride - pad + j * dil) +
                     off[(2 * t + 1) * n_pix];
    const float m = to_f(msk[t * n_pix]);

    const float y0 = floorf(ys), x0 = floorf(xs);
    const float wy1 = ys - y0, wx1 = xs - x0;
    const float wy0 = 1.f - wy1, wx0 = 1.f - wx1;
    const int y0i = corner_index(y0, h), x0i = corner_index(x0, w);

    // corners in the order top-left, top-right, bottom-left, bottom-right
    const T* src[4];
    float cw[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int yi = y0i + (q >> 1), xi = x0i + (q & 1);
      const bool valid = yi >= 0 && yi < h && xi >= 0 && xi < w;
      const int pix = min(max(yi, 0), h - 1) * w + min(max(xi, 0), w - 1);
      src[q] = xb + static_cast<size_t>(pix) * c_total;
      const float wy = (q >> 1) ? wy1 : wy0;
      const float wx = (q & 1) ? wx1 : wx0;
      cw[q] = rnd<T>(valid ? wy * wx : 0.f);
    }
    T* out = dst + t * c_total;

    if (kVec) {
      float v[4][kGroup];
#pragma unroll
      for (int q = 0; q < 4; ++q) load8(src[q], v[q]);
      float r[kGroup];
#pragma unroll
      for (int c = 0; c < kGroup; ++c) {
        float s = rnd<T>(v[0][c] * cw[0]);
        s += rnd<T>(v[1][c] * cw[1]);
        s += rnd<T>(v[2][c] * cw[2]);
        s += rnd<T>(v[3][c] * cw[3]);
        r[c] = rnd<T>(s) * m;
      }
      store8(out, r);
    } else {
      const int n = min(kGroup, c_total - c0);
      for (int c = 0; c < n; ++c) {
        float s = rnd<T>(to_f(src[0][c]) * cw[0]);
        s += rnd<T>(to_f(src[1][c]) * cw[1]);
        s += rnd<T>(to_f(src[2][c]) * cw[2]);
        s += rnd<T>(to_f(src[3][c]) * cw[3]);
        out[c] = from_f<T>(rnd<T>(s) * m);
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* offset, const void* mask, void* cols,
           int b, int c, int h, int w, int ho, int wo, int k, int stride,
           int pad, int dil, int row0, bool vec, cudaStream_t stream) {
  const long long n = static_cast<long long>(b) * ho * wo *
                      ((c + kGroup - 1) / kGroup);
  if (n >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  const int n_threads = static_cast<int>(n);
  const dim3 grid((n_threads + kThreads - 1) / kThreads);
  auto kernel = vec ? dcn_im2col_kernel<T, true> : dcn_im2col_kernel<T, false>;
  kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(offset),
      static_cast<const T*>(mask), static_cast<T*>(cols), n_threads, c, h, w,
      ho, wo, k, stride, pad, dil, row0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (x, mask and cols); offset is float32.
// x is NHWC; the 16-byte path needs c % 8 == 0 and x and cols 16-byte
// aligned, else the kernel goes channel by channel.  ho output rows from
// row0 on (row0 + ho <= the map's output height; the wrapper checks it).
extern "C" int yolact_dcn_im2col(const void* x, const void* offset,
                                 const void* mask, void* cols, int dtype,
                                 int b, int c, int h, int w, int ho, int wo,
                                 int k, int stride, int pad, int dil,
                                 int row0, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = c % kGroup == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(cols) % 16 == 0;
  if (dtype == 0) {
    return launch<float>(x, offset, mask, cols, b, c, h, w, ho, wo, k, stride,
                         pad, dil, row0, vec, s);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(x, offset, mask, cols, b, c, h, w, ho, wo, k,
                                 stride, pad, dil, row0, vec, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
