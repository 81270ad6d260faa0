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
// the kernel writes 100 * 138 * 138 * 4 B = 7.6 MB per frame and reads
// 2.4 MB of prototypes; 0.6 MFLOP of dot products per frame are nothing.
// It is bound by the output write.  The design therefore writes every
// output element exactly once, fully coalesced (consecutive threads own
// consecutive pixels of one mask row), keeps the pre-sigmoid values in
// registers, and makes the prototype reads coalesced too: a block's
// prototype tile ([kThreads, Md], contiguous in device memory) is copied
// to shared memory one row per warp, lanes on consecutive floats, and
// each thread then reads its own pixel's row from there.  (Reading the row
// straight from device memory puts every lane of a warp on another
// 128-byte line: 32 L1 wavefronts per load.)  Rows are padded to Md + 1
// floats so that the 32 lanes reading column k hit 32 different banks.
//
// Grid (pixel tile, detection tile, image); kThreads pixels per block,
// kTileD detections per block.  The tile's coefficients (transposed, zero
// past the ragged end) and crop bounds go to shared memory too; each thread
// accumulates kTileD dot products over k in order with fmaf, then applies
// sigmoid (expf, not __expf; the reciprocal as __frcp_rn, which costs half
// of an IEEE divide and gives the same bits), the crop and the store.

// Numerics.  The crop bounds are the same float operations as
// mask_assembly.py:46-59 / boxes.py:crop; with --fmad=false
// (kernels/_build.py) `box * wp - padding` is two roundings, as in
// PyTorch, because one ulp on a bound can flip a whole mask column.
// min/max propagate NaN like torch.minimum / torch.clamp, and the crop is
// applied as a multiply by 0/1, like the plain version.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileD = 16;

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fminf(a, b));
}
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fmaxf(a, b));
}

__global__ void mask_assembly_kernel(const float* __restrict__ proto,
                                     const float* __restrict__ coeffs,
                                     const float* __restrict__ boxes,
                                     float* __restrict__ out, int d_total,
                                     int hp, int wp, int md, float padding) {
  extern __shared__ float smem[];
  float* s_proto = smem;                          // [kThreads, md + 1]
  float* s_coef = s_proto + kThreads * (md + 1);  // [md, kTileD]
  float* s_bound = s_coef + kTileD * md;          // [kTileD, 4]: x1 x2 y1 y2

  const int b = blockIdx.z;
  const int d0 = blockIdx.y * kTileD;
  const int nd = min(kTileD, d_total - d0);
  const int hw = hp * wp;
  const int pix0 = blockIdx.x * kThreads;
  const int npix = min(kThreads, hw - pix0);
  const int pix = pix0 + threadIdx.x;

  // one warp per prototype row: lanes read consecutive floats of the row
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const float* ptile = proto + (static_cast<size_t>(b) * hw + pix0) * md;
#pragma unroll 4
  for (int r = warp; r < npix; r += kThreads / 32) {
    for (int k = lane; k < md; k += 32) {
      s_proto[r * (md + 1) + k] = ptile[static_cast<size_t>(r) * md + k];
    }
  }
  // coefficients transposed to [k][d]: a thread's kTileD products for one
  // k then read consecutive (broadcast) shared words
  const float* coef_tile = coeffs + (static_cast<size_t>(b) * d_total + d0) * md;
  for (int i = threadIdx.x; i < kTileD * md; i += blockDim.x) {
    const int d = i / md, k = i % md;
    s_coef[k * kTileD + d] = d < nd ? coef_tile[i] : 0.f;
  }
  if (threadIdx.x < nd) {
    const float* bx = boxes + (static_cast<size_t>(b) * d_total + d0 + threadIdx.x) * 4;
    const float fw = static_cast<float>(wp), fh = static_cast<float>(hp);
    const float bx1 = bx[0] * fw, bx2 = bx[2] * fw;
    const float by1 = bx[1] * fh, by2 = bx[3] * fh;
    float* sb = s_bound + 4 * threadIdx.x;
    sb[0] = nan_max(nan_min(bx1, bx2) - padding, 0.f);
    sb[1] = nan_min(nan_max(bx1, bx2) + padding, fw);
    sb[2] = nan_max(nan_min(by1, by2) - padding, 0.f);
    sb[3] = nan_min(nan_max(by1, by2) + padding, fh);
  }
  __syncthreads();
  if (threadIdx.x >= npix) return;

  float acc[kTileD];
#pragma unroll
  for (int d = 0; d < kTileD; ++d) acc[d] = 0.f;

  const float* prow = s_proto + threadIdx.x * (md + 1);
  for (int k = 0; k < md; ++k) {
    const float p = prow[k];
    const float* ck = s_coef + k * kTileD;
#pragma unroll
    for (int d = 0; d < kTileD; ++d) acc[d] = fmaf(ck[d], p, acc[d]);
  }

  const float xs = static_cast<float>(pix % wp);
  const float ys = static_cast<float>(pix / wp);
  float* orow = out + (static_cast<size_t>(b) * d_total + d0) * hw + pix;
#pragma unroll
  for (int d = 0; d < kTileD; ++d) {
    if (d < nd) {
      const float* sb = s_bound + 4 * d;
      const bool keep = xs >= sb[0] && xs < sb[1] && ys >= sb[2] && ys < sb[3];
      // __frcp_rn is the correctly rounded 1/x: the same bits as 1.f / x
      const float m = __frcp_rn(1.f + expf(-acc[d]));
      orow[static_cast<size_t>(d) * hw] = m * (keep ? 1.f : 0.f);
    }
  }
}

}  // namespace

extern "C" int yolact_mask_assembly(const void* proto, const void* coeffs,
                                    const void* boxes, void* out, int b, int d,
                                    int hp, int wp, int md, float padding,
                                    void* stream) {
  const dim3 grid((hp * wp + kThreads - 1) / kThreads,
                  (d + kTileD - 1) / kTileD, b);
  const size_t shmem = (static_cast<size_t>(kThreads) * (md + 1) +
                        static_cast<size_t>(kTileD) * (md + 4)) * sizeof(float);
  mask_assembly_kernel<<<grid, kThreads, shmem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(proto), static_cast<const float*>(coeffs),
      static_cast<const float*>(boxes), static_cast<float*>(out), d, hp, wp,
      md, padding);
  return static_cast<int>(cudaGetLastError());
}
