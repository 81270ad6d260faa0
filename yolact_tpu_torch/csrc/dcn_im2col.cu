// Modulated deformable im2col (DCNv2 sampling): for image b, input channel
// c, tap t = (i, j) of the K x K kernel and output pixel p = (ho, wo),
//
//     y = ho * stride - pad + i * dil + offset[b, 2t,     ho, wo]
//     x = wo * stride - pad + j * dil + offset[b, 2t + 1, ho, wo]
//     cols[b, c*K*K + t, p] = bilinear(x[b, c], y, x) * mask[b, t, ho, wo]
//
// with per-corner zero outside the map.  Replaces the DCN bilinear corner
// gather that the TPU package probed with four Pallas kernels
// (scripts/bench_gather2.py: pallas_kernel, taa_kernel, taa4_kernel;
// scripts/probe_sameshape_gather.py: kernel) and runs in production as
// yolact_tpu/kernels/dcn.py:_bilinear_gather.  The GEMM that consumes the
// columns stays torch.matmul (kernels/dcn.py).
//
// Bound.  At yolact_plus_base 550^2 b8 the kernel writes the columns,
// 87.7 MB (bf16) for each layers.1 DCN block, 45.2 MB for each layers.2
// block and 23.9 MB for layers.3: about 606 MB per batch, 0.18 ms at the
// data-sheet 3.35 TB/s.  It reads the feature map (1.6-4.9 MB per block),
// mostly from L2, and the offsets and mask once.  It is bound by the
// column stores.  The design therefore makes every store coalesced: a
// thread owns one (image, tap, pixel) and walks a group of kChanGroup
// channels, so the 32 lanes of a warp store 32 consecutive pixels of one
// column row.  The sample position, the four corner indices and weights are
// computed once per thread and reused for every channel of its group; the
// corner reads of neighbouring lanes fall on neighbouring pixels of the
// same rows.  Channel groups give enough threads at b1 (layers.3: 324
// pixels x 9 taps x 32 groups).  Keeping the columns out of device memory
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

namespace {

constexpr int kThreads = 256;
constexpr int kChanGroup = 16;

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

template <typename T>
__global__ void dcn_im2col_kernel(const T* __restrict__ x,
                                  const float* __restrict__ offset,
                                  const T* __restrict__ mask,
                                  T* __restrict__ cols, int c_total, int h,
                                  int w, int ho_total, int wo_total, int k,
                                  int stride, int pad, int dil) {
  const int n_pix = ho_total * wo_total;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= n_pix) return;
  const int kk = k * k;
  const int t = blockIdx.y % kk;
  const int c0 = (blockIdx.y / kk) * kChanGroup;
  const int c1 = min(c0 + kChanGroup, c_total);
  const int b = blockIdx.z;
  const int ho = p / wo_total, wo = p % wo_total;
  const int i = t / k, j = t % k;

  const float* off = offset + (static_cast<size_t>(b) * 2 * kk + 2 * t) * n_pix;
  const float ys = static_cast<float>(ho * stride - pad + i * dil) + off[p];
  const float xs = static_cast<float>(wo * stride - pad + j * dil) + off[n_pix + p];
  const float m = to_f(mask[(static_cast<size_t>(b) * kk + t) * n_pix + p]);

  const float y0 = floorf(ys), x0 = floorf(xs);
  const float wy1 = ys - y0, wx1 = xs - x0;
  const float wy0 = 1.f - wy1, wx0 = 1.f - wx1;
  const int y0i = corner_index(y0, h), x0i = corner_index(x0, w);

  // corners in the order top-left, top-right, bottom-left, bottom-right
  int idx[4];
  float cw[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int yi = y0i + (q >> 1), xi = x0i + (q & 1);
    const bool valid = yi >= 0 && yi < h && xi >= 0 && xi < w;
    idx[q] = min(max(yi, 0), h - 1) * w + min(max(xi, 0), w - 1);
    const float wy = (q >> 1) ? wy1 : wy0;
    const float wx = (q & 1) ? wx1 : wx0;
    cw[q] = rnd<T>(valid ? wy * wx : 0.f);
  }

  const size_t hw = static_cast<size_t>(h) * w;
  const T* xc = x + (static_cast<size_t>(b) * c_total + c0) * hw;
  T* out = cols + ((static_cast<size_t>(b) * c_total + c0) * kk + t) * n_pix + p;
  const size_t out_step = static_cast<size_t>(kk) * n_pix;
#pragma unroll 4
  for (int c = c0; c < c1; ++c) {
    float s = rnd<T>(to_f(xc[idx[0]]) * cw[0]);
    s += rnd<T>(to_f(xc[idx[1]]) * cw[1]);
    s += rnd<T>(to_f(xc[idx[2]]) * cw[2]);
    s += rnd<T>(to_f(xc[idx[3]]) * cw[3]);
    *out = from_f<T>(rnd<T>(s) * m);
    xc += hw;
    out += out_step;
  }
}

template <typename T>
void launch(const void* x, const void* offset, const void* mask, void* cols,
            int b, int c, int h, int w, int ho, int wo, int k, int stride,
            int pad, int dil, cudaStream_t stream) {
  const int n_groups = (c + kChanGroup - 1) / kChanGroup;
  const dim3 grid((ho * wo + kThreads - 1) / kThreads, k * k * n_groups, b);
  dcn_im2col_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(offset),
      static_cast<const T*>(mask), static_cast<T*>(cols), c, h, w, ho, wo, k,
      stride, pad, dil);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (x, mask and cols); offset is float32.
extern "C" int yolact_dcn_im2col(const void* x, const void* offset,
                                 const void* mask, void* cols, int dtype,
                                 int b, int c, int h, int w, int ho, int wo,
                                 int k, int stride, int pad, int dil,
                                 void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    launch<float>(x, offset, mask, cols, b, c, h, w, ho, wo, k, stride, pad,
                  dil, s);
  } else if (dtype == 1) {
    launch<__nv_bfloat16>(x, offset, mask, cols, b, c, h, w, ho, wo, k,
                          stride, pad, dil, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
