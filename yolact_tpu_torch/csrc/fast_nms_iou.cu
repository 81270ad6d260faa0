// Fast-NMS suppression statistic: for each row n of score-sorted boxes
// [N, K, 4] (point form, f32), the column max of the strict upper triangle
// of the pairwise IoU matrix:
//
//     iou_max[n, j] = max(0, max_{i < j} IoU(box[n, i], box[n, j]))
//
// Replaces the Pallas TPU kernel yolact_tpu/kernels/nms_pallas.py:_kernel
// (nms_iou_max_pallas), which carries the same step as
// yolact_tpu/detect/detection.py:_triu_max(jaccard(..)).
//
// Design.  One block per row n.  The K boxes and their areas go to shared
// memory (5 floats per box: 4 KB at K = 200), each thread owns a column j
// and walks i < j, so the [K, K] IoU matrix never exists in device memory,
// as on the TPU.  At yolact_base shapes the work is [B*80, 200, 200], under
// 4 M IoUs per frame, and the bytes are few (3.2 KB in, 0.8 KB out per
// row).  What bounds it on the card is latency: the last column's thread
// walks 199 pairs, each a chain of shared loads and an IEEE divide, and at
// batch 1 the 80 blocks leave SMs idle.  The loop is unrolled so that
// independent pairs overlap, and disjoint pairs skip the divide.
//
// Numerics.  The IoU is the guarded formula of ops/boxes.py:jaccard, in the
// same order:  inter = clamp0(ix) * clamp0(iy);  union = (area_i + area_j)
// - inter;  iou = union > 0 ? inter / union : 0.  The library is built with
// --fmad=false (kernels/_build.py), so no product is contracted into an
// FMA and every IoU equals the plain PyTorch version bit for bit; that is
// what keeps `iou_max <= nms_thresh` decisions identical at the threshold.
//
// NaN.  clamp0 keeps a NaN (like torch.clamp / jnp.clip) and the running
// max propagates one (like torch.amax / jnp.max); CUDA's fmaxf would drop
// it.  In practice the guard already maps every NaN to 0: any NaN or
// inf - inf in a coordinate makes that box's area NaN, hence the union
// NaN and `union > 0` false.  fminf/fmaxf on the coordinates may drop a
// NaN for that reason without changing the result.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float clamp0(float v) { return v < 0.f ? 0.f : v; }

__global__ void fast_nms_iou_max_kernel(const float* __restrict__ boxes,
                                        float* __restrict__ out, int k) {
  extern __shared__ float smem[];
  float* sx1 = smem;
  float* sy1 = sx1 + k;
  float* sx2 = sy1 + k;
  float* sy2 = sx2 + k;
  float* sarea = sy2 + k;

  const float* row = boxes + static_cast<size_t>(blockIdx.x) * k * 4;
  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    const float x1 = row[4 * i + 0], y1 = row[4 * i + 1];
    const float x2 = row[4 * i + 2], y2 = row[4 * i + 3];
    sx1[i] = x1;
    sy1[i] = y1;
    sx2[i] = x2;
    sy2[i] = y2;
    sarea[i] = (x2 - x1) * (y2 - y1);
  }
  __syncthreads();

  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    const float x1 = sx1[j], y1 = sy1[j], x2 = sx2[j], y2 = sy2[j];
    const float aj = sarea[j];
    float acc = 0.f;
#pragma unroll 4
    for (int i = 0; i < j; ++i) {
      const float ix = fminf(sx2[i], x2) - fmaxf(sx1[i], x1);
      const float iy = fminf(sy2[i], y2) - fmaxf(sy1[i], y1);
      const float inter = clamp0(ix) * clamp0(iy);
      const float uni = (sarea[i] + aj) - inter;
      // inter > 0 skips the divide for disjoint pairs, whose IoU is 0
      // either way (0 / uni is 0; a NaN inter makes uni NaN)
      const float iou = (uni > 0.f && inter > 0.f) ? inter / uni : 0.f;
      acc = (iou > acc || iou != iou) ? iou : acc;
    }
    out[static_cast<size_t>(blockIdx.x) * k + j] = acc;
  }
}

}  // namespace

extern "C" int yolact_fast_nms_iou_max(const void* boxes, void* out, int n,
                                       int k, void* stream) {
  const int threads = k >= 1024 ? 1024 : ((k + 31) / 32) * 32;
  const size_t shmem = static_cast<size_t>(5) * k * sizeof(float);
  fast_nms_iou_max_kernel<<<n, threads, shmem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boxes), static_cast<float*>(out), k);
  return static_cast<int>(cudaGetLastError());
}
