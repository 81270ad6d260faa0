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
// Bound.  The bytes are few (3.2 KB in, 0.8 KB out per row at K = 200);
// the work is K (K - 1) / 2 pairs per row, 12.7 M at [640, 200].  What
// bounds the kernel on this card is instruction issue: each pair is a chain
// of min/max, subtractions, products and compares on the CUDA cores, one
// warp-instruction per 32 pairs, and the min/max and compares issue at
// half the FP32 rate.  The design cuts instructions per pair and idle
// lanes:
//
// - The row's boxes go to shared memory as float4 with their areas, so a
//   pair loads one 16-byte broadcast and one 4-byte broadcast.
// - No divide in the pair loop.  Each (warp, column) keeps its best pair
//   as a fraction inter / union and takes a new pair when
//   inter * best_union > best_inter * union.  A float product that is
//   larger is the rounding of a larger exact product (rounding is
//   monotone), so only equal float products need more: then the exact
//   rounding errors, fmaf(a, b, -a*b), decide, which are themselves floats
//   while the product is at least 2^-100 and finite; outside that range
//   the pair falls back to comparing IEEE quotients.  The pair loop stays
//   free of branches: it only flags equal products of unequal fractions,
//   and a warp that met one walks its 32 columns again with the exact test
//   (rare: equal IoUs from different boxes).  One IEEE divide per
//   column at the end gives the same bits as the max of the per-pair
//   quotients, because a correctly rounded divide is monotone.
// - Balanced warps.  Lanes own 32 consecutive columns, warps own chunks of
//   rows i; the chunk boundaries (kernels/nms.py:iou_plan, computed on the
//   host once per shape) equalise the warp-iterations each warp runs,
//   idle lanes on the diagonal included.  The partial fractions are merged
//   per column in shared memory by the same rule.
// - At small N a row is split over several blocks at the columns where the
//   pair counts balance (j ~ 142 of 200 for two), so a batch-1 call still
//   gives more blocks than the card has SMs.  Each block owns whole
//   columns: no merge across blocks.
//
// Measured on an H100 (probe_small_kernels.py, PERF.md): 23.8 us at
// [640, 200] and 7.7 us at [80, 200]; the pair loop is ~24 instructions a
// pair in the SASS, 11 of them half-rate min/max and compares.
//
// Numerics.  The IoU operands are the guarded formula of ops/boxes.py:
// jaccard, in the same order:  inter = clamp0(ix) * clamp0(iy);  union =
// (area_i + area_j) - inter;  a pair counts only where ix > 0, iy > 0 and
// union > 0 (elsewhere its IoU is 0, as in the plain version; there the
// clamps are the identity, so they are not computed).  Built with
// --fmad=false (kernels/_build.py), so inter and union round like PyTorch;
// the explicit fmaf of the tie test stays fused.  NaN: any NaN or inf - inf
// in a coordinate makes that box's area NaN, hence the union NaN and the
// pair excluded, so fminf/fmaxf may drop a NaN without changing the result.

#include <cfloat>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kMaxSplits = 4;
// 2^-100: from here up, the rounding error of a float product is a float
constexpr float kExactMin = 7.8886090522101181e-31f;

// The host's plan (kernels/nms.py:iou_plan): split s of a row owns columns
// [cols[s], cols[s + 1]); its warp w walks rows [rows[s][w], rows[s][w + 1]).
struct Plan {
  int splits;
  int cols[kMaxSplits + 1];
  int rows[kMaxSplits][kWarps + 1];
};

// ia / ua > ib / ub, exactly, for positive unions and ia > 0, given that
// the float products ia * ub and ib * ua are equal
__device__ __noinline__ bool tie_greater(float ia, float ua, float ib,
                                         float ub) {
  const float p = ia * ub;
  if (p >= kExactMin && p <= FLT_MAX) {
    return fmaf(ia, ub, -p) > fmaf(ib, ua, -(ib * ua));
  }
  return ia / ua > ib / ub;
}

__device__ __forceinline__ bool greater(float ia, float ua, float ib,
                                        float ub) {
  const float p1 = ia * ub, p2 = ib * ua;
  return p1 > p2 || (p1 == p2 && tie_greater(ia, ua, ib, ub));
}

// One lane's pairs (i, j) for rows [i0, iend), into its best fraction.
// kExact resolves equal cross products by tie_greater; otherwise the pass
// stays free of branches, takes a pair only on a strictly larger product
// and returns whether it met an equal one (then the group is redone).
template <bool kExact>
__device__ __forceinline__ bool walk_rows(const float4* sbox,
                                          const float* sarea, float4 bj,
                                          float aj, int j, int i0, int ifull,
                                          int iend, float& best_i,
                                          float& best_u) {
  bool tied = false;
  auto pair = [&](int i, bool upper) {
    const float4 b = sbox[i];
    const float ix = fminf(b.z, bj.z) - fmaxf(b.x, bj.x);
    const float iy = fminf(b.w, bj.w) - fmaxf(b.y, bj.y);
    // clamp0(ix) * clamp0(iy) wherever the pair counts (ix, iy > 0)
    const float inter = ix * iy;
    const float uni = (sarea[i] + aj) - inter;
    const bool ok = upper & (ix > 0.f) & (iy > 0.f) & (uni > 0.f);
    const float p1 = inter * best_u, p2 = best_i * uni;
    bool take = ok & (p1 > p2);
    if constexpr (kExact) {
      if (ok & (p1 == p2)) take = tie_greater(inter, uni, best_i, best_u);
    } else {
      // equal products of equal fractions (duplicate boxes) need nothing
      tied |= ok & (p1 == p2) & ((inter != best_i) | (uni != best_u));
    }
    best_i = take ? inter : best_i;
    best_u = take ? uni : best_u;
  };
  int i = i0;
#pragma unroll 4
  for (; i < ifull; ++i) pair(i, true);
  for (; i < iend; ++i) pair(i, i < j);
  return tied;
}

__global__ void __launch_bounds__(kWarps * 32)
fast_nms_iou_max_kernel(const float4* __restrict__ boxes,
                        float* __restrict__ out, int k, Plan plan) {
  const int n = blockIdx.x / plan.splits, s = blockIdx.x % plan.splits;
  const int jlo = plan.cols[s], jhi = plan.cols[s + 1];
  const int span = jhi - jlo;
  extern __shared__ float4 smem[];
  float4* sbox = smem;                                          // [jhi]
  float2* spart = reinterpret_cast<float2*>(sbox + jhi);        // [kWarps][span]
  float* sarea = reinterpret_cast<float*>(spart + kWarps * span);  // [jhi]

  const float4* row = boxes + static_cast<size_t>(n) * k;
  for (int i = threadIdx.x; i < jhi; i += blockDim.x) {
    const float4 b = row[i];
    sbox[i] = b;
    sarea[i] = (b.z - b.x) * (b.w - b.y);
  }
  for (int i = threadIdx.x; i < kWarps * span; i += blockDim.x) {
    spart[i] = make_float2(0.f, 1.f);                           // IoU 0
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int i0 = plan.rows[s][warp], i1 = plan.rows[s][warp + 1];
  for (int jb = max(jlo, i0 + 1); jb < jhi && i0 < i1; jb += 32) {
    const int j = jb + lane;
    // a lane past the last column holds a NaN box: its union is NaN
    const float nan = __int_as_float(0x7fc00000);
    float4 bj = make_float4(nan, nan, nan, nan);
    float aj = nan;
    if (j < jhi) {
      bj = sbox[j];
      aj = sarea[j];
    }
    // rows below the group's last column; below jb every lane has i < j
    const int iend = min(i1, min(jhi - 1, jb + 31));
    const int ifull = min(iend, jb);
    float best_i = 0.f, best_u = 1.f;
    const bool tied = walk_rows<false>(sbox, sarea, bj, aj, j, i0, ifull,
                                       iend, best_i, best_u);
    if (__any_sync(0xffffffffu, tied)) {     // rare: equal cross products
      best_i = 0.f;
      best_u = 1.f;
      walk_rows<true>(sbox, sarea, bj, aj, j, i0, ifull, iend, best_i,
                      best_u);
    }
    if (j < jhi) spart[warp * span + (j - jlo)] = make_float2(best_i, best_u);
  }
  __syncthreads();

  for (int t = threadIdx.x; t < span; t += blockDim.x) {
    float2 best = spart[t];
    for (int w = 1; w < kWarps; ++w) {
      const float2 c = spart[w * span + t];
      if (c.x > 0.f && greater(c.x, c.y, best.x, best.y)) best = c;
    }
    out[static_cast<size_t>(n) * k + jlo + t] = best.x / best.y;
  }
}

}  // namespace

// plan: splits, then cols[0..splits], then rows[s][0..kWarps] per split
extern "C" int yolact_fast_nms_iou_max(const void* boxes, void* out, int n,
                                       int k, const int* plan, void* stream) {
  Plan p = {};
  p.splits = plan[0];
  if (p.splits < 1 || p.splits > kMaxSplits) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  size_t shmem = 0;
  for (int s = 0; s <= p.splits; ++s) p.cols[s] = plan[1 + s];
  for (int s = 0; s < p.splits; ++s) {
    for (int w = 0; w <= kWarps; ++w) {
      p.rows[s][w] = plan[2 + p.splits + s * (kWarps + 1) + w];
    }
    const size_t jhi = p.cols[s + 1], span = jhi - p.cols[s];
    const size_t bytes = jhi * (sizeof(float4) + sizeof(float)) +
                         kWarps * span * sizeof(float2);
    shmem = bytes > shmem ? bytes : shmem;
  }
  if (shmem > 48 * 1024) {   // above the default, the kernel must be allowed
    const cudaError_t err = cudaFuncSetAttribute(
        fast_nms_iou_max_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(shmem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  fast_nms_iou_max_kernel<<<n * p.splits, kWarps * 32, shmem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(boxes), static_cast<float*>(out), k, p);
  return static_cast<int>(cudaGetLastError());
}
