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
// autograd through kernels/dcn.py:dcn_columns_plain.  As in the forward,
// output row ho samples at row (row0 + ho) * stride - pad + i * dil.
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
// gradients: 0.48 ms of bytes per float32 train step (11 launches).
//
// Design: tile-private accumulation.  A block (512 threads) owns an 8x8
// tile of output pixels of one image, all 9 taps, and one chunk of up to
// 128 channels; the chunks of a tile are the blocks of one thread-block
// cluster.  The tile's window is its receptive field plus a halo of kHalo
// input pixels, which holds every corner of an offset within the halo.
// kTile, kHalo and kCapSpare below are the whole launch plan's constants:
// the kernel derives the window, the list capacity, the channel chunks and
// the shared-memory layout from them and the call's shapes, and
// kernels/dcn.py:col2im_geometry reads them from this file for its
// diagnostics.
//   1. One thread per sample computes the forward's geometry and files each
//      valid corner inside the window in its window pixel's list in shared
//      memory (a native integer atomicAdd picks the slot).  A corner
//      outside the window, or beyond a full list, is marked for the global
//      path, so any offset stays correct: far, infinite or NaN.
//   2. Global path: 8 lanes per marked sample load its g once (16-byte
//      lanes) and, per marked corner, read x from device memory, sum
//      a_q = <g, x> and reduce g * m * cw into grad_x with 16-byte
//      atomicAdd(float4*) (red.global.add.v4.f32).
//   3. Window: 8 lanes per window pixel walk its list, two entries in
//      flight: each entry's g row (cached: the sample's other corners read
//      it too) is multiplied into the pixel's sum in registers and dotted
//      with the pixel's x (loaded once) for a_q; the sum leaves in one
//      16-byte reduction per 4 channels, and only if non-zero.  A pixel
//      near a tile edge gets one reduction from each window it lies in.
//   4. a_q of the cluster's chunks are added in chunk order through
//      distributed shared memory; grad_offset and grad_mask are written
//      once, with no atomics, so they repeat bit for bit.
// Float32 atomicAdd on shared memory is a compare-and-swap loop on sm_90
// (ATOMS.CAST.SPIN): a window accumulated by shared atomics ran slower than
// the one-atomic-per-channel kernel it replaces at every shape on an H100,
// hence the lists.  Measured (PERF.md): on the in-step inputs the kernel
// cuts the global reductions into grad_x from one per corner and channel
// to under 4% of that, yet runs within 10% of its predecessor: what bounds
// both is the latency of the gathers (g rows, x pixels), not the
// reductions.
//
// Reductions into grad_x sum in an order that changes from run to run, so
// grad_x differs in its last bits between runs (and a pixel whose
// contributions cancel can come out 0 in one run and an ulp of its
// addends in another): callers hold it to a tolerance, not bit for bit.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kInflight = 2;                   // list entries per step
constexpr int kGroup = 8;                      // lanes per sample
constexpr int kGroups = kThreads / kGroup;     // samples in flight per block
constexpr int kMaxChunks = 8;                  // portable cluster size
// An 8x8 tile of output pixels: with k = 3, stride 1 or 2 and a halo of 4
// its lists and per-sample state take 50-70 KB of shared memory.  The halo:
// the in-step offsets of yolact_plus_base (median 1-2 pixels) leave 0.8% of
// a train step's corners outside a halo-4 window (PERF.md).
constexpr int kTile = 8;
constexpr int kHalo = 4;
// list entries per window pixel beyond the ~4 k^2 / stride^2 corners that
// offsets near 0 put there (list_cap)
constexpr int kCapSpare = 12;

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

// elements of T in 16 bytes: a lane's channel vector
template <typename T>
struct Vec {
  static constexpr int n = 16 / sizeof(T);
};

// channel vectors per lane in a block's chunk: 16 channels at most
template <typename T>
struct LanePasses {
  static constexpr int n = 16 / Vec<T>::n;
};

// n = min(VEC, channels left) values of a channel vector as float32, zero
// beyond; `vec`: 16-byte loads (the wrapper checked size and alignment),
// `stream`: evict-first (g_cols is read once)
template <typename T, bool kStream>
__device__ __forceinline__ void load_vec(const T* p, int n, bool vec,
                                         float* out) {
  constexpr int V = Vec<T>::n;
  if (vec) {
    const uint4 raw = kStream ? __ldcs(reinterpret_cast<const uint4*>(p))
                              : __ldg(reinterpret_cast<const uint4*>(p));
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < V; ++i) out[i] = to_f(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) out[i] = i < n ? to_f(p[i]) : 0.f;
  }
}

struct Args {
  const void* g_cols;
  const void* x;
  const float* offset;
  const void* mask;
  float* grad_x;
  float* grad_offset;
  void* grad_mask;
  int c, h, w, ho, wo, k, stride, pad, dil, row0;
  int chunk, cap, window, tiles_w, vec;
  unsigned as_off, cw_off, m_off, row_off, cnt_off, fb_off, list_off;
};

// One sample's bilinear geometry, as the forward computes it
struct Sample {
  float m;
  int yi, xi;                            // top-left corner
  bool valid[4];
  float cw[4], dy[4], dx[4];
};

template <typename T>
__device__ __forceinline__ Sample sample_at(const Args& a, int b, int ho,
                                            int wo, int t) {
  const int kk = a.k * a.k, n_pix = a.ho * a.wo, p = ho * a.wo + wo;
  const int i = t / a.k, j = t % a.k;
  const size_t off_base = (static_cast<size_t>(b) * 2 * kk + 2 * t) * n_pix + p;
  const float ys =
      static_cast<float>((a.row0 + ho) * a.stride - a.pad + i * a.dil) +
                   a.offset[off_base];
  const float xs = static_cast<float>(wo * a.stride - a.pad + j * a.dil) +
                   a.offset[off_base + n_pix];
  Sample s;
  s.m = to_f(static_cast<const T*>(a.mask)[(static_cast<size_t>(b) * kk + t) *
                                               n_pix + p]);
  const float y0 = floorf(ys), x0 = floorf(xs);
  const float wy1 = ys - y0, wx1 = xs - x0;
  const float wy0 = 1.f - wy1, wx0 = 1.f - wx1;
  s.yi = corner_index(y0, a.h);
  s.xi = corner_index(x0, a.w);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int yi = s.yi + (q >> 1), xi = s.xi + (q & 1);
    const bool v = yi >= 0 && yi < a.h && xi >= 0 && xi < a.w;
    const float wy = (q >> 1) ? wy1 : wy0;
    const float wx = (q & 1) ? wx1 : wx0;
    s.valid[q] = v;
    s.cw[q] = rnd<T>(v ? wy * wx : 0.f);
    s.dy[q] = v ? ((q >> 1) ? wx : -wx) : 0.f;
    s.dx[q] = v ? ((q & 1) ? wy : -wy) : 0.f;
  }
  return s;
}

// The sum over a group's 8 lanes; every lane gets it
__device__ __forceinline__ float group_sum(float v, unsigned gmask) {
#pragma unroll
  for (int d = kGroup / 2; d > 0; d >>= 1) {
    v += __shfl_xor_sync(gmask, v, d, kGroup);
  }
  return v;
}

// `n` = min(VEC, channels left) contributions (g * m) * cw into grad_x at
// `dst`: 16-byte reductions where the plan allows them, else one per value
template <int V>
__device__ __forceinline__ void reduce_into(float* dst, const float* v, int n,
                                            bool vec) {
  if (vec) {
#pragma unroll
    for (int i = 0; i < V / 4; ++i) {
      atomicAdd(reinterpret_cast<float4*>(dst) + i,
                make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]));
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      if (i < n) atomicAdd(dst + i, v[i]);
    }
  }
}

// Grid (chunks, tiles, B); a cluster is the chunks of one tile.  Samples of
// a tile are numbered tap-major, s = t * tile^2 + pixel.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    dcn_col2im_kernel(const Args a) {
  constexpr int V = Vec<T>::n;
  extern __shared__ float4 smem4[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem4);
  float* as = reinterpret_cast<float*>(smem + a.as_off);        // [s][4] a_q
  float4* cws = reinterpret_cast<float4*>(smem + a.cw_off);     // [s] cw_q
  float* ms = reinterpret_cast<float*>(smem + a.m_off);         // [s] m
  int* rows = reinterpret_cast<int*>(smem + a.row_off);         // [s] g row
  int* cnt = reinterpret_cast<int*>(smem + a.cnt_off);          // [pix]
  unsigned char* fb = smem + a.fb_off;                          // [s] corners
  uint16_t* lists = reinterpret_cast<uint16_t*>(smem + a.list_off);
  const T* g_cols = static_cast<const T*>(a.g_cols);
  const T* x = static_cast<const T*>(a.x);
  cg::cluster_group cluster = cg::this_cluster();

  const int tid = threadIdx.x;
  const int chunk = blockIdx.x, n_chunks = gridDim.x;
  const int b = blockIdx.z;
  const int ho0 = (blockIdx.y / a.tiles_w) * kTile;
  const int wo0 = (blockIdx.y % a.tiles_w) * kTile;
  const int wy0 = (a.row0 + ho0) * a.stride - a.pad - kHalo;
  const int wx0 = wo0 * a.stride - a.pad - kHalo;
  const int ws = a.window, n_wpix = ws * ws;
  const int tt = kTile * kTile, kk = a.k * a.k, n_samples = tt * kk;
  constexpr int kMaxNv = LanePasses<T>::n;
  const int c0 = chunk * a.chunk, nv = a.chunk / (kGroup * V);
  const bool vec = a.vec != 0;
  const size_t img = static_cast<size_t>(b) * a.h * a.w;
  const T* g_img = g_cols + static_cast<size_t>(b) * a.ho * a.wo * kk * a.c;

  // 1. empty lists and corner sums
  for (int e = tid; e < n_wpix; e += kThreads) cnt[e] = 0;
  for (int e = tid; e < n_samples * 4; e += kThreads) as[e] = 0.f;
  __syncthreads();

  // 2. one thread per sample: its geometry, and each valid corner into the
  //    list of its window pixel (integer shared atomics are native); a
  //    corner outside the window, or beyond a full list, is marked for the
  //    global path
  for (int s = tid; s < n_samples; s += kThreads) {
    const int t = s / tt, p = s % tt;
    const int ho = ho0 + p / kTile, wo = wo0 + p % kTile;
    unsigned char marks = 0;
    if (ho < a.ho && wo < a.wo) {
      const Sample sm = sample_at<T>(a, b, ho, wo, t);
      ms[s] = sm.m;
      cws[s] = make_float4(sm.cw[0], sm.cw[1], sm.cw[2], sm.cw[3]);
      rows[s] = (ho * a.wo + wo) * kk * a.c + t * a.c;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (!sm.valid[q]) continue;
        const int ry = sm.yi + (q >> 1) - wy0, rx = sm.xi + (q & 1) - wx0;
        bool listed = false;
        if (ry >= 0 && ry < ws && rx >= 0 && rx < ws) {
          const int wp = ry * ws + rx;
          const int slot = atomicAdd(cnt + wp, 1);
          if (slot < a.cap) {
            lists[wp * a.cap + slot] = static_cast<uint16_t>(s * 4 + q);
            listed = true;
          }
        }
        if (!listed) marks |= 1 << q;
      }
    }
    fb[s] = marks;
  }
  __syncthreads();

  const int lane = tid % kGroup, group = tid / kGroup;
  const unsigned gmask = 0xffu << (threadIdx.x & 31 & ~(kGroup - 1));

  // 3. the global path, a group of 8 lanes per marked sample: its g loaded
  //    once, x read from device memory, contributions reduced straight
  //    into grad_x
  for (int s = group; s < n_samples; s += kGroups) {
    const int marks = fb[s];
    if (marks == 0) continue;
    const int t = s / tt, p = s % tt;
    const Sample sm = sample_at<T>(a, b, ho0 + p / kTile, wo0 + p % kTile, t);
    float g[kMaxNv][V];
#pragma unroll
    for (int u = 0; u < kMaxNv; ++u) {
      const int ci = c0 + (lane + u * kGroup) * V;
      const int n = (u < nv && ci < a.c) ? min(V, a.c - ci) : 0;
#pragma unroll
      for (int i = 0; i < V; ++i) g[u][i] = 0.f;
      if (n > 0) load_vec<T, true>(g_img + rows[s] + ci, n, vec, g[u]);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (!(marks >> q & 1)) continue;
      const size_t pix =
          (img + static_cast<size_t>(sm.yi + (q >> 1)) * a.w + sm.xi + (q & 1)) *
          a.c;
      float d = 0.f;
#pragma unroll
      for (int u = 0; u < kMaxNv; ++u) {
        const int ci = c0 + (lane + u * kGroup) * V;
        const int n = (u < nv && ci < a.c) ? min(V, a.c - ci) : 0;
        if (n == 0) continue;
        float xv[V], add[V];
        load_vec<T, false>(x + pix + ci, n, vec, xv);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          d = fmaf(g[u][i], xv[i], d);
          add[i] = g[u][i] * sm.m * sm.cw[q];
        }
        reduce_into<V>(a.grad_x + pix + ci, add, n, vec);
      }
      d = group_sum(d, gmask);
      if (lane == 0) as[s * 4 + q] = d;
    }
  }

  // 4. the window, a group per pixel: its listed contributions summed in
  //    registers (lane: the chunk's channel vectors lane, lane + 8, ...),
  //    two list entries in flight at a time; the corner sums a_q from the
  //    same loads; one 16-byte reduction per 4 channels into grad_x
  for (int wp = group; wp < n_wpix; wp += kGroups) {
    const int n_e = min(cnt[wp], a.cap);
    if (n_e == 0) continue;
    const uint16_t* list = lists + wp * a.cap;
    const size_t pix =
        (img + static_cast<size_t>(wy0 + wp / ws) * a.w + wx0 + wp % ws) * a.c;
    int nu[kMaxNv];
    float xv[kMaxNv][V], sum[kMaxNv][V];
#pragma unroll
    for (int u = 0; u < kMaxNv; ++u) {
      const int ci = c0 + (lane + u * kGroup) * V;
      nu[u] = (u < nv && ci < a.c) ? min(V, a.c - ci) : 0;
#pragma unroll
      for (int i = 0; i < V; ++i) xv[u][i] = sum[u][i] = 0.f;
      if (nu[u] > 0) load_vec<T, false>(x + pix + ci, nu[u], vec, xv[u]);
    }
    for (int e = 0; e < n_e; e += kInflight) {
      int id[kInflight];
      float m[kInflight], cw[kInflight], g[kInflight][kMaxNv][V];
#pragma unroll
      for (int j = 0; j < kInflight; ++j) {
        id[j] = list[e + j < n_e ? e + j : e];
        const int s = id[j] >> 2, q = id[j] & 3;
        const float4 cw4 = cws[s];
        cw[j] = q == 0 ? cw4.x : q == 1 ? cw4.y : q == 2 ? cw4.z : cw4.w;
        m[j] = ms[s];
        const T* grow = g_img + rows[s] + c0 + lane * V;
#pragma unroll
        for (int u = 0; u < kMaxNv; ++u) {
#pragma unroll
          for (int i = 0; i < V; ++i) g[j][u][i] = 0.f;
          if (nu[u] > 0) {    // cached: the sample's other corners read it too
            load_vec<T, false>(grow + u * kGroup * V, nu[u], vec, g[j][u]);
          }
        }
      }
      // (g * m) * cw, rounded as the forward's product
      float d[kInflight];
#pragma unroll
      for (int j = 0; j < kInflight; ++j) {
        d[j] = 0.f;
        if (e + j >= n_e) continue;
#pragma unroll
        for (int u = 0; u < kMaxNv; ++u)
#pragma unroll
          for (int i = 0; i < V; ++i) {
            d[j] = fmaf(g[j][u][i], xv[u][i], d[j]);
            sum[u][i] += g[j][u][i] * m[j] * cw[j];
          }
      }
#pragma unroll
      for (int j = 0; j < kInflight; ++j) d[j] = group_sum(d[j], gmask);
      if (lane == 0) {
#pragma unroll
        for (int j = 0; j < kInflight; ++j) {
          if (e + j < n_e) as[id[j]] += d[j];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kMaxNv; ++u) {
      bool any = false;
#pragma unroll
      for (int i = 0; i < V; ++i) any |= sum[u][i] != 0.f;
      const int ci = c0 + (lane + u * kGroup) * V;
      if (nu[u] > 0 && any) reduce_into<V>(a.grad_x + pix + ci, sum[u], nu[u], vec);
    }
  }

  // 5. the chunks' corner sums, added in chunk order through distributed
  //    shared memory; block r of the cluster writes samples r, r + n, ...
  cluster.sync();
  for (int s = tid * n_chunks + chunk; s < n_samples; s += kThreads * n_chunks) {
    const int t = s / tt, p = s % tt;
    const int ho = ho0 + p / kTile, wo = wo0 + p % kTile;
    if (ho >= a.ho || wo >= a.wo) continue;
    float sum[4] = {0.f, 0.f, 0.f, 0.f};
    for (int r = 0; r < n_chunks; ++r) {
      const float4 v = *cluster.map_shared_rank(
          reinterpret_cast<const float4*>(as) + s, r);
      sum[0] += v.x;
      sum[1] += v.y;
      sum[2] += v.z;
      sum[3] += v.w;
    }
    const Sample sm = sample_at<T>(a, b, ho, wo, t);
    float gm = 0.f, gy = 0.f, gx = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      gm = fmaf(sm.cw[q], sum[q], gm);
      gy = fmaf(sm.dy[q], sum[q], gy);
      gx = fmaf(sm.dx[q], sum[q], gx);
    }
    const int n_pix = a.ho * a.wo, pp = ho * a.wo + wo;
    const size_t off_base = (static_cast<size_t>(b) * 2 * kk + 2 * t) * n_pix + pp;
    static_cast<T*>(a.grad_mask)[(static_cast<size_t>(b) * kk + t) * n_pix + pp] =
        from_f<T>(gm);
    a.grad_offset[off_base] = sm.m * gy;
    a.grad_offset[off_base + n_pix] = sm.m * gx;
  }
  cluster.sync();     // no block leaves while another reads its sums
}

// The shared-memory carve-up
struct Layout {
  unsigned as_off, cw_off, m_off, row_off, cnt_off, fb_off, list_off, total;
};

inline unsigned up16(unsigned n) { return (n + 15) / 16 * 16; }

inline Layout layout(int window, int cap, int kk) {
  const unsigned n_samples = static_cast<unsigned>(kTile) * kTile * kk;
  const unsigned npix = static_cast<unsigned>(window) * window;
  Layout l;
  l.as_off = 0;
  l.cw_off = l.as_off + n_samples * 16;
  l.m_off = l.cw_off + n_samples * 16;
  l.row_off = l.m_off + up16(n_samples * 4);
  l.cnt_off = l.row_off + up16(n_samples * 4);
  l.fb_off = l.cnt_off + up16(npix * 4);
  l.list_off = l.fb_off + up16(n_samples);
  l.total = l.list_off + up16(npix * cap * 2);
  return l;
}

// The corners listed per window pixel: with offsets near 0 an input pixel
// is a corner of about 4 k^2 / stride^2 samples, plus kCapSpare for spread
inline int list_cap(int k, int stride) {
  return 4 * k * k / (stride * stride) + kCapSpare;
}

// The launch plan: the fewest channel chunks (one block of the cluster
// each) of at most LanePasses vectors per lane, as even as the vectors
// allow; the window and the lists from kTile, kHalo and list_cap.
template <typename T>
int launch(Args a, int b, cudaStream_t stream) {
  constexpr int per_pass = kGroup * Vec<T>::n;     // channels per lane pass
  const int passes = (a.c + per_pass - 1) / per_pass;
  int n_chunks = (passes + LanePasses<T>::n - 1) / LanePasses<T>::n;
  if (n_chunks > kMaxChunks) return static_cast<int>(cudaErrorInvalidValue);
  a.chunk = per_pass * ((passes + n_chunks - 1) / n_chunks);
  n_chunks = (a.c + a.chunk - 1) / a.chunk;
  a.cap = list_cap(a.k, a.stride);
  a.window = a.stride * (kTile - 1) + (a.k - 1) * a.dil + 2 + 2 * kHalo;
  const int tiles_h = (a.ho + kTile - 1) / kTile;
  a.tiles_w = (a.wo + kTile - 1) / kTile;
  const Layout l = layout(a.window, a.cap, a.k * a.k);
  // list entries (sample * 4 + corner) are 16-bit
  if (4LL * kTile * kTile * a.k * a.k > 65536 ||
      static_cast<long long>(a.ho) * a.wo * a.k * a.k * a.c >= (1LL << 31) ||
      static_cast<long long>(tiles_h) * a.tiles_w > 65535 || b > 65535 ||
      l.total > 227 * 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  a.as_off = l.as_off;
  a.cw_off = l.cw_off;
  a.m_off = l.m_off;
  a.row_off = l.row_off;
  a.cnt_off = l.cnt_off;
  a.fb_off = l.fb_off;
  a.list_off = l.list_off;
  cudaError_t err = cudaFuncSetAttribute(
      dcn_col2im_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(l.total));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_chunks, tiles_h * a.tiles_w, b);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = l.total;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_chunks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, dcn_col2im_kernel<T>, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 float32, 1 bfloat16 (g_cols, x, mask and grad_mask); offset,
// grad_offset and grad_x are float32.  x and grad_x are NHWC; grad_x must be
// zero on entry.  vec: 1 where every channel vector may be read and reduced
// with 16-byte accesses (C a multiple of the vector and 16-byte aligned
// pointers; kernels/dcn.py checks them).  ho output rows from row0 on, as
// in csrc/dcn_im2col.cu.
extern "C" int yolact_dcn_col2im(const void* g_cols, const void* x,
                                 const void* offset, const void* mask,
                                 void* grad_x, void* grad_offset,
                                 void* grad_mask, int dtype, int b, int c,
                                 int h, int w, int ho, int wo, int k,
                                 int stride, int pad, int dil, int row0,
                                 int vec, void* stream) {
  Args a = {};
  a.g_cols = g_cols;
  a.x = x;
  a.offset = static_cast<const float*>(offset);
  a.mask = mask;
  a.grad_x = static_cast<float*>(grad_x);
  a.grad_offset = static_cast<float*>(grad_offset);
  a.grad_mask = grad_mask;
  a.c = c;
  a.h = h;
  a.w = w;
  a.ho = ho;
  a.wo = wo;
  a.k = k;
  a.stride = stride;
  a.pad = pad;
  a.dil = dil;
  a.row0 = row0;
  a.vec = vec;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(a, b, s);
  if (dtype == 1) return launch<__nv_bfloat16>(a, b, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
