// Backward of the modulated deformable im2col (csrc/dcn_im2col.cu): from the
// gradient of the columns, the gradients of the input map, the offsets and
// the modulation mask in one pass.  For image b, output pixel p = (ho, wo),
// tap t and the sample position (y, x) of the forward, with corners q in the
// order top-left, top-right, bottom-left, bottom-right, bilinear weights
// cw_q = valid_q ? wy_q * wx_q : 0 and g = g_cols[b * Ho * Wo + p, t * C + c]:
//
//     a_q            = sum_c g * x[b, corner_q, c]              (float32)
//     grad_mask[b, t, p]        = sum_q cw_q * a_q
//     grad_offset[b, 2t,     p] = m * sum_q valid_q * sy_q * wx_q * a_q
//     grad_offset[b, 2t + 1, p] = m * sum_q valid_q * sx_q * wy_q * a_q
//     grad_x[b, corner_q, c]   += g * m * cw_q     (valid corners only)
//
// with m = mask[b, t, p], sy = -1 for the top corners and +1 for the bottom
// ones, sx = -1 left and +1 right (floor has no gradient).  This is what the
// JAX package computes with XLA scatter-adds and elementwise passes
// (yolact_tpu/kernels/dcn.py:_bilinear_gather_bwd, not a Pallas kernel, plus
// the VJP of the mask product in deform_conv2d); its plain PyTorch version is
// autograd through kernels/dcn.py:dcn_columns_plain.
//
// Validity follows the forward: it is tested on the integer corner indices,
// so corners outside the map, far offsets and infinite offsets add exactly
// nothing to any of the three gradients.  A NaN offset has its corners at
// the origin with NaN weights, as in the forward (NaN columns): its
// gradients are NaN.
//
// Bound.  The kernel reads g_cols (as large as the forward's columns: 87.7 MB
// for a layers.1 block of yolact_plus_base at 550^2 b8 in bf16, twice that
// in float32), x, the offsets and the mask once and writes the three
// gradients; it is bound by the bytes of g_cols.  Design, simple on purpose:
// one warp per (pixel, tap).  Its lanes stride the C channels, so the reads
// of g_cols and of the four corner rows and the float32 atomicAdds into
// grad_x are contiguous runs of C values; the four a_q are warp sums by
// shuffles and lane 0 writes the sample's offset and mask gradients (each
// written once: no atomics, no zero fill).  grad_x is a float32 NHWC buffer
// that the wrapper zero-fills and rounds once to x's dtype.  Sorting
// samples by target pixel to cut atomics, 16-byte accesses and keeping g_cols
// out of device memory are later work.
//
// atomicAdd sums a pixel's contributions in an order that changes from run
// to run, so grad_x differs in its last bits between runs: callers hold it
// to a tolerance, not bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

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

// the forward rounds the corner weight to the input dtype
template <typename T>
__device__ __forceinline__ float rnd(float v) {
  return to_f(from_f<T>(v));
}

__device__ __forceinline__ int corner_index(float f, int n) {
  if (f != f) return 0;
  return static_cast<int>(fminf(fmaxf(f, -2.f), static_cast<float>(n)));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int s = 16; s > 0; s >>= 1) v += __shfl_xor_sync(0xffffffffu, v, s);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    dcn_col2im_kernel(const T* __restrict__ g_cols, const T* __restrict__ x,
                      const float* __restrict__ offset,
                      const T* __restrict__ mask, float* __restrict__ grad_x,
                      float* __restrict__ grad_offset,
                      T* __restrict__ grad_mask, long long n_samples,
                      int c_total, int h, int w, int ho_total, int wo_total,
                      int k, int stride, int pad, int dil) {
  const long long sample =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (sample >= n_samples) return;       // whole warps leave together
  const int lane = threadIdx.x & 31;
  const int kk = k * k;
  const int n_pix = ho_total * wo_total;
  const int t = static_cast<int>(sample % kk);
  const long long bp = sample / kk;               // b * n_pix + p
  const int b = static_cast<int>(bp / n_pix);
  const int p = static_cast<int>(bp % n_pix);
  const int ho = p / wo_total, wo = p % wo_total;
  const int i = t / k, j = t % k;

  const size_t off_base = (static_cast<size_t>(b) * 2 * kk + 2 * t) * n_pix + p;
  const size_t mask_at = (static_cast<size_t>(b) * kk + t) * n_pix + p;
  const float ys = static_cast<float>(ho * stride - pad + i * dil) +
                   offset[off_base];
  const float xs = static_cast<float>(wo * stride - pad + j * dil) +
                   offset[off_base + n_pix];
  const float m = to_f(mask[mask_at]);

  const float y0 = floorf(ys), x0 = floorf(xs);
  const float wy1 = ys - y0, wx1 = xs - x0;
  const float wy0 = 1.f - wy1, wx0 = 1.f - wx1;
  const int y0i = corner_index(y0, h), x0i = corner_index(x0, w);

  size_t pix[4];
  bool valid[4];
  float cw[4], dy[4], dx[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int yi = y0i + (q >> 1), xi = x0i + (q & 1);
    valid[q] = yi >= 0 && yi < h && xi >= 0 && xi < w;
    pix[q] = (static_cast<size_t>(b) * h * w +
              static_cast<size_t>(min(max(yi, 0), h - 1)) * w +
              min(max(xi, 0), w - 1)) * c_total;
    const float wy = (q >> 1) ? wy1 : wy0;
    const float wx = (q & 1) ? wx1 : wx0;
    cw[q] = rnd<T>(valid[q] ? wy * wx : 0.f);
    dy[q] = valid[q] ? ((q >> 1) ? wx : -wx) : 0.f;
    dx[q] = valid[q] ? ((q & 1) ? wy : -wy) : 0.f;
  }

  const T* g_row = g_cols + static_cast<size_t>(bp) * kk * c_total +
                   static_cast<size_t>(t) * c_total;
  float a[4] = {0.f, 0.f, 0.f, 0.f};
  for (int c = lane; c < c_total; c += 32) {
    const float g = to_f(g_row[c]);
    const float gm = g * m;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      a[q] = fmaf(g, to_f(x[pix[q] + c]), a[q]);
      if (valid[q]) atomicAdd(grad_x + pix[q] + c, gm * cw[q]);
    }
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) a[q] = warp_sum(a[q]);
  if (lane == 0) {
    float gm = 0.f, gy = 0.f, gx = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      gm = fmaf(cw[q], a[q], gm);
      gy = fmaf(dy[q], a[q], gy);
      gx = fmaf(dx[q], a[q], gx);
    }
    grad_mask[mask_at] = from_f<T>(gm);
    grad_offset[off_base] = m * gy;
    grad_offset[off_base + n_pix] = m * gx;
  }
}

template <typename T>
int launch(const void* g_cols, const void* x, const void* offset,
           const void* mask, void* grad_x, void* grad_offset, void* grad_mask,
           int b, int c, int h, int w, int ho, int wo, int k, int stride,
           int pad, int dil, cudaStream_t stream) {
  const long long n_samples = static_cast<long long>(b) * ho * wo * k * k;
  const long long blocks = (n_samples + kWarps - 1) / kWarps;
  if (blocks >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  dcn_col2im_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(g_cols), static_cast<const T*>(x),
      static_cast<const float*>(offset), static_cast<const T*>(mask),
      static_cast<float*>(grad_x), static_cast<float*>(grad_offset),
      static_cast<T*>(grad_mask), n_samples, c, h, w, ho, wo, k, stride, pad,
      dil);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (g_cols, x, mask and grad_mask); offset,
// grad_offset and grad_x are float32.  x and grad_x are NHWC; grad_x must be
// zero on entry.
extern "C" int yolact_dcn_col2im(const void* g_cols, const void* x,
                                 const void* offset, const void* mask,
                                 void* grad_x, void* grad_offset,
                                 void* grad_mask, int dtype, int b, int c,
                                 int h, int w, int ho, int wo, int k,
                                 int stride, int pad, int dil, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float>(g_cols, x, offset, mask, grad_x, grad_offset,
                         grad_mask, b, c, h, w, ho, wo, k, stride, pad, dil, s);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(g_cols, x, offset, mask, grad_x, grad_offset,
                                 grad_mask, b, c, h, w, ho, wo, k, stride, pad,
                                 dil, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
