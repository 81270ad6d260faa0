// Prototype mask assembly: for image b, detection d and pixel p,
//
//     out[b, d, p] = sigmoid(sum_k coeffs[b, d, k] * proto[b, p, k]) * keep
//
// where keep is the crop of ops/boxes.py:crop: the relative box scaled to
// the prototype grid, ordered by min/max, padded by `padding` pixels,
// clamped to the grid, and tested as x1 <= x < x2, y1 <= y < y2.
//
// Replaces the Pallas TPU kernel yolact_tpu/kernels/mask_assembly.py:_kernel
// (assemble_masks_batched_pallas, called through assemble_masks_mapped).
//
// Bound.  At yolact_base (B x 100 detections, 138 x 138 prototypes, Md = 32)
// the kernel writes 7.6 MB per frame and reads 2.4 MB of prototypes: it is
// bound by the output write (60.9 MB at b8, 18 us at 3.35 TB/s), so each
// output is written once, at full width, and each prototype row read once:
//
// - Work tile: one image, 128 consecutive pixels, all D detections, in
//   passes of 64 detections.  Each prototype row leaves device memory once.
//   A persistent grid (as many blocks as fit, two per SM at yolact_base)
//   walks a contiguous range of the B x ceil(Hp*Wp / 128) tiles, so a
//   block changes image at most a few times and stages the image's
//   coefficients (split, below) and crop bounds in shared memory once.
// - Prototype tiles are double-buffered in shared memory and loaded by
//   16-byte cp.async copies (one commit group per tile): the next tile is
//   in flight during this tile's products and stores.  Rows are padded to
//   Md rounded up to 8, plus 4 floats, so the mma fragment loads hit 32
//   different banks.  Shapes the 16-byte copy cannot take (Md % 4 != 0, or
//   a base address off 16 bytes) load the tile with plain loads in the
//   same kernel.
// - Products on the tensor cores: mma.sync m16n8k8 in TF32 with the
//   3-pass split x = hi + lo (hi = cvt.rna.tf32(x), lo = x - hi, of which
//   the tensor core reads the top 11 bits), summing lo*hi + hi*lo + hi*hi
//   in float32.  One TF32 pass keeps 11 significant bits, about 3 digits:
//   logits of |32| would be ~1e-2 off and masks ~1e-3 off, against the
//   1e-5 criterion.  The split keeps each product to ~2^-21 relative (the
//   dropped lo*lo term and the truncation of lo), so logits stay within
//   ~1e-5 even at |logit| = 32 and masks within a few 1e-7.  Md is padded
//   with zeros to a multiple of 8.
// - Epilogue: sigmoid by ex2.approx and rcp.approx (within ~5e-7), then
//   the crop as a multiply by 0/1, which keeps the plain version's NaN
//   where the logit is NaN.  Each warp owns 32 pixels of the tile and 32
//   detections of a 64-detection pass; it stages its outputs in shared
//   memory 16 detections at a time and writes each detection's 128-byte
//   segment in 16-byte coalesced stores (4-byte ones when Hp*Wp % 4 != 0).
// - One block-wide barrier per tile (its prototypes are in, the previous
//   tile's buffer is free); within a tile the warps run on their own.
//
// Measured on an H100 (probe_small_kernels.py, PERF.md): 53 us at b8, 2.2x
// the write bound.  Taking out any one part (products, sigmoid and crop,
// stores, coefficient staging, prototype copies) saves 2-8 us: the parts
// do not yet overlap at 16 warps per SM, which is what a faster design has
// to change.

// Numerics.  The crop bounds are the same float operations as
// mask_assembly.py:46-59 / boxes.py:crop; with --fmad=false
// (kernels/_build.py) `box * wp - padding` is two roundings, as in
// PyTorch, because one ulp on a bound can flip a whole mask column.
// min/max propagate NaN like torch.minimum / torch.clamp.  The dot
// products are not the plain version's float32 sums (another order, the
// split's ~2^-21), so masks agree within 1e-5, not bit for bit; the zero
// pattern (the crop) is exact.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;           // 8 warps: 2 x 32 detections, 4 x 32 pixels
constexpr int kSlabP = 32;              // pixels per warp
constexpr int kNT = kSlabP / 8;         // mma n-tiles per warp
constexpr int kTileP = 128;             // pixels per work tile
constexpr int kChunkD = 64;             // detections per pass over a tile
constexpr int kOutStride = 40;          // a warp's staging row: 32 + 8 floats

// Shared-memory carve-up, in floats (each part a multiple of 16 bytes):
// the 2 prototype buffers [kTileP][ks], the coefficients' hi
// and lo parts [dpad][ks], the crop bounds [dpad][4], and each warp's
// staged outputs [16][kOutStride] (a stride of 8 mod 32 words: the float2
// writes of a half-warp hit 16 different bank pairs).
struct Layout {
  int kp, ks, dpad, proto, ahi, alo, bound, out, total;
};

__host__ __device__ inline Layout layout(int md, int d) {
  Layout l;
  l.kp = (md + 7) / 8 * 8;
  l.ks = l.kp + 4;
  l.dpad = (d + 15) / 16 * 16;
  l.proto = 0;
  l.ahi = l.proto + 2 * kTileP * l.ks;
  l.alo = l.ahi + l.dpad * l.ks;
  l.bound = l.alo + l.dpad * l.ks;
  l.out = l.bound + 4 * l.dpad;
  l.total = l.out + (kThreads / 32) * 16 * kOutStride;
  return l;
}

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fminf(a, b));
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fmaxf(a, b));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// x = hi + lo: hi rounded to TF32, lo = x - hi exactly (the tensor core
// reads lo's top 19 bits, 2^-21 of x); lo is 0 where hi is not finite
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  const float h = to_tf32(x);
  hi = __float_as_uint(h);
  lo = isfinite(h) ? __float_as_uint(x - h) : 0u;
}

// 1 / (1 + 2^(-x log2 e)) by the special-function unit, without the
// range fix-ups of expf / __fdividef: within ~5e-7 of the exact sigmoid
__device__ __forceinline__ float sigmoid(float x) {
  float e, r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(x * -1.44269504f));
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(1.f + e));
  return r;
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16-byte asynchronous copy from device to shared memory (L1 bypassed)
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

__global__ void __launch_bounds__(kThreads, 2)
mask_assembly_kernel(const float* __restrict__ proto,
                     const float* __restrict__ coeffs,
                     const float* __restrict__ boxes, float* __restrict__ out,
                     int n_img, int d_total, int hp, int wp, int md,
                     float padding, bool async_copy, bool vec_store) {
  extern __shared__ __align__(16) float smem[];
  const Layout L = layout(md, d_total);
  float* s_proto = smem + L.proto;
  float* s_ahi = smem + L.ahi;
  float* s_alo = smem + L.alo;
  float* s_bound = smem + L.bound;  // x1 x2 y1 y2 per detection

  const int hw = hp * wp;
  const int tiles_per_img = (hw + kTileP - 1) / kTileP;
  const int n_tiles = n_img * tiles_per_img;
  const int t_begin = static_cast<int>(
      static_cast<long long>(n_tiles) * blockIdx.x / gridDim.x);
  const int t_end = static_cast<int>(
      static_cast<long long>(n_tiles) * (blockIdx.x + 1) / gridDim.x);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, q = lane % 4;     // mma group and thread in group
  const int wm = warp / 4, wn = warp % 4;   // 32-detection and 32-pixel slab
  const int ks = L.ks;
  float* s_warp = smem + L.out + warp * 16 * kOutStride;   // [16][kOutStride]

  // zero the pad columns [md, ks) of both prototype buffers once: the
  // copies write [0, md) only
  for (int r = warp; r < 2 * kTileP; r += kThreads / 32) {
    for (int c = md + lane; c < ks; c += 32) s_proto[r * ks + c] = 0.f;
  }

  // starts the 16-byte copies of tile t's prototype rows into `buf`
  auto issue = [&](int t, int buf) {
    const int b = t / tiles_per_img, p0 = (t % tiles_per_img) * kTileP;
    const int np = min(kTileP, hw - p0), vecs = md / 4;
    const float* src = proto + (static_cast<size_t>(b) * hw + p0) * md;
    float* dst = s_proto + buf * kTileP * ks;
    for (int i = tid; i < np * vecs; i += kThreads) {
      const int r = i / vecs, c = 4 * (i % vecs);
      cp_async16(dst + r * ks + c, src + static_cast<size_t>(r) * md + c);
    }
    cp_async_commit();
  };

  if (async_copy && t_begin < t_end) issue(t_begin, 0);
  int cur_b = -1;
  for (int t = t_begin, it = 0; t < t_end; ++t, ++it) {
    const int buf = it & 1;
    const int b = t / tiles_per_img, p0 = (t % tiles_per_img) * kTileP;
    const int np = min(kTileP, hw - p0);
    float* tile = s_proto + buf * kTileP * ks;
    if (!async_copy) {     // buffer `buf` was last read two tiles ago
      const float* src = proto + (static_cast<size_t>(b) * hw + p0) * md;
      for (int i = tid; i < np * md; i += kThreads) {
        tile[(i / md) * ks + i % md] = src[i];
      }
    }
    if (async_copy) cp_async_wait_all();
    // the one block-wide barrier of a tile: its prototypes are in, and
    // every warp is done with the last tile, its buffer and coefficients
    __syncthreads();
    if (async_copy && t + 1 < t_end) issue(t + 1, buf ^ 1);
    if (b != cur_b) {      // the image's split coefficients and crop bounds
      cur_b = b;
      // 16 loads in flight per thread: under the kernel's own write
      // traffic a load waits microseconds
      const float* cb = coeffs + static_cast<size_t>(b) * d_total * md;
      for (int d0 = 0; d0 < L.dpad; d0 += 16 * (kThreads / 32)) {
        for (int k = lane; k < L.kp; k += 32) {
          float v[16];
#pragma unroll
          for (int u = 0; u < 16; ++u) {
            const int d = d0 + u * (kThreads / 32) + warp;
            v[u] = (d < d_total && k < md) ? cb[d * md + k] : 0.f;
          }
#pragma unroll
          for (int u = 0; u < 16; ++u) {
            const int d = d0 + u * (kThreads / 32) + warp;
            if (d < L.dpad) {
              uint32_t hi, lo;
              split_tf32(v[u], hi, lo);
              s_ahi[d * ks + k] = __uint_as_float(hi);
              s_alo[d * ks + k] = __uint_as_float(lo);
            }
          }
        }
      }
      for (int d = tid; d < d_total; d += kThreads) {
        const float* bx = boxes + (static_cast<size_t>(b) * d_total + d) * 4;
        const float fw = static_cast<float>(wp), fh = static_cast<float>(hp);
        const float bx1 = bx[0] * fw, bx2 = bx[2] * fw;
        const float by1 = bx[1] * fh, by2 = bx[3] * fh;
        float* sb = s_bound + 4 * d;
        sb[0] = nan_max(nan_min(bx1, bx2) - padding, 0.f);
        sb[1] = nan_min(nan_max(bx1, bx2) + padding, fw);
        sb[2] = nan_max(nan_min(by1, by2) - padding, 0.f);
        sb[3] = nan_min(nan_max(by1, by2) + padding, fh);
      }
      __syncthreads();
    }

    // From here each warp works alone on its 32 pixels: no block barrier
    // until the next tile, so one warp's products overlap another's
    // epilogue and stores.  The pixel coordinates of its 8 mma columns,
    // from one division:
    float xs[kNT][2], ys[kNT][2];
    {
      const int pb = p0 + wn * kSlabP + 2 * q;
      const int y0 = pb / wp, x0 = pb - y0 * wp;
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          int x = x0 + nt * 8 + e, y = y0;
          while (x >= wp) {
            x -= wp;
            ++y;
          }
          xs[nt][e] = static_cast<float>(x);
          ys[nt][e] = static_cast<float>(y);
        }
      }
    }

    for (int c0 = 0; c0 < d_total; c0 += kChunkD) {
      const int m0 = c0 + wm * 32;   // this warp's first detection row
      if (m0 >= d_total) continue;
      float acc[2][kNT][4] = {};
#pragma unroll 4
      for (int k0 = 0; k0 < L.kp; k0 += 8) {
        uint32_t bh[kNT][2], bl[kNT][2];
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
          const float* pr = tile + (wn * kSlabP + nt * 8 + g) * ks + k0 + q;
          split_tf32(pr[0], bh[nt][0], bl[nt][0]);
          split_tf32(pr[4], bh[nt][1], bl[nt][1]);
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int r = m0 + mt * 16 + g;
          if (r - g >= d_total) continue;       // a whole m16 tile past D
          const float* ph = s_ahi + r * ks + k0 + q;
          const float* pl = s_alo + r * ks + k0 + q;
          const uint32_t ah[4] = {
              __float_as_uint(ph[0]), __float_as_uint(ph[8 * ks]),
              __float_as_uint(ph[4]), __float_as_uint(ph[8 * ks + 4])};
          const uint32_t al[4] = {
              __float_as_uint(pl[0]), __float_as_uint(pl[8 * ks]),
              __float_as_uint(pl[4]), __float_as_uint(pl[8 * ks + 4])};
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt) {
            mma_tf32(acc[mt][nt], al, bh[nt][0], bh[nt][1]);
            mma_tf32(acc[mt][nt], ah, bl[nt][0], bl[nt][1]);
            mma_tf32(acc[mt][nt], ah, bh[nt][0], bh[nt][1]);
          }
        }
      }
      // sigmoid and crop, 16 detections at a time, into the warp's
      // [16 x 32] staging tile, then out: each detection's 128-byte
      // segment as 8 lanes x 16 bytes, 4 detections a step
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        if (m0 + mt * 16 >= d_total) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int rr = h * 8 + g;             // row in the staging tile
          const int d = m0 + mt * 16 + rr;
          if (d >= d_total) continue;
          const float* sb = s_bound + 4 * d;
          const float x1 = sb[0], x2 = sb[1], y1 = sb[2], y2 = sb[3];
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt) {
            float v[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const bool keep = xs[nt][e] >= x1 && xs[nt][e] < x2 &&
                                ys[nt][e] >= y1 && ys[nt][e] < y2;
              v[e] = sigmoid(acc[mt][nt][2 * h + e]) * (keep ? 1.f : 0.f);
            }
            *reinterpret_cast<float2*>(s_warp + rr * kOutStride + nt * 8 +
                                       2 * q) = make_float2(v[0], v[1]);
          }
        }
        __syncwarp();
        const int c = 4 * (lane % 8), p = wn * kSlabP + c;
#pragma unroll
        for (int rr = lane / 8; rr < 16; rr += 4) {
          const int d = m0 + mt * 16 + rr;
          if (d >= d_total || p >= np) continue;
          float* dst =
              out + (static_cast<size_t>(b) * d_total + d) * hw + p0 + p;
          const float* src = s_warp + rr * kOutStride + c;
          if (vec_store) {
            *reinterpret_cast<float4*>(dst) =
                *reinterpret_cast<const float4*>(src);
          } else {
            for (int e = 0; e < 4 && p + e < np; ++e) dst[e] = src[e];
          }
        }
        __syncwarp();      // the staging tile is free again
      }
    }
  }
}

}  // namespace

extern "C" int yolact_mask_assembly(const void* proto, const void* coeffs,
                                    const void* boxes, void* out, int b, int d,
                                    int hp, int wp, int md, float padding,
                                    void* stream) {
  const int shmem = layout(md, d).total * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      mask_assembly_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, shmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, mask_assembly_kernel, kThreads, shmem)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  const int fit = per_sm * sms;     // blocks the card holds at once
  const int hw = hp * wp;
  const int tiles = b * ((hw + kTileP - 1) / kTileP);
  const int grid = tiles < fit ? tiles : fit;
  // the 16-byte copies need Md % 4 == 0 and a 16-byte aligned base
  const bool async_copy = md % 4 == 0 &&
                          reinterpret_cast<uintptr_t>(proto) % 16 == 0;
  const bool vec_store = hw % 4 == 0 &&
                         reinterpret_cast<uintptr_t>(out) % 16 == 0;
  mask_assembly_kernel<<<grid > 0 ? grid : 1, kThreads, shmem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(proto), static_cast<const float*>(coeffs),
      static_cast<const float*>(boxes), static_cast<float*>(out), b, d, hp, wp,
      md, padding, async_copy, vec_store);
  return static_cast<int>(cudaGetLastError());
}
