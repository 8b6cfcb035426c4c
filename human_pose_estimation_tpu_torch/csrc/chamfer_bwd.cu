// Bidirectional silhouette chamfer, value and gradient in one pass, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_bwd_kernel` in
// human_pose_estimation_tpu/ops/pallas_chamfer.py, reached through
// `_run_bwd_kernel`: with the value output (`l1v_ref`, K2, the training
// path `_chamfer_value_and_grad_pallas` behind the custom VJP
// `chamfer_pallas`) and without it (K3, `_chamfer_grad_pred_pallas`).
// The index-carrier type is a template parameter: `int` is K2/K3, `float`
// is K4 (`_bwd_kernel_f32idx` of benchmarks/chamfer_variant_bench.py, the
// same kernel with every index carried in f32, exact below 2^24).
//
// For each image b, over the exact squared-distance field d = (g - p)^2
// between its gt silhouette pixels g and its projected vertices p:
//   * gt->pred: each pixel's FIRST L2-nearest vertex (exact ties: lowest
//     vertex index); the value is the masked sum of |dx| + |dy| there, the
//     gradient adds -mask * sign(g - p) onto that vertex (sign(0) = 0);
//   * pred->gt: per vertex, the min of d over the pixels with mask > 0 and
//     the coordinates of the FIRST pixel (in index order) that reaches it;
//     the gradient is (p - nearest) / |p - nearest| with a 1e-12 guard, 0
//     where no pixel was found (vmin >= 1e30 / 2).
// The epilogue that needs the whole image (the sum of the block partials,
// the sum of sqrt(vmin), the empty-mask factor, a cotangent) is plain
// torch in the wrapper, as it is XLA in the JAX package.
//
// What bounds it on the H100: arithmetic, as for the forward kernel
// (chamfer_fwd.cu): ~7 f32 operations per (valid pixel, vertex) pair and
// ~1 MB of inputs at the training shape (8 images, ~4.5k valid pixels of
// a 16384 budget, 6890 vertices). Every (P, V) intermediate stays out of
// device memory; loops stop at each image's last active pixel.
//
// Design: the TPU grid walks pixel tiles in order and carries the
// per-vertex state (L1 gradient columns, running min, nearest pixel) from
// one grid step to the next. Hopper blocks run in no order, so the work is
// two kernels, each with a loop inside the thread in place of the
// sequential grid axis:
//   1. assign (pixel-parallel): one thread per pixel scans the vertices in
//      order through shared-memory tiles and keeps its first nearest
//      vertex (update on strict `<`). It writes the pixel's assignment
//      (vertex index, mask * sign(dx), mask * sign(dy)) to an (N, P)
//      scratch and, with the value flag, reduces its block's masked L1 in
//      a fixed tree order into one partial.
//   2. vertex (vertex-parallel): one thread per vertex scans its image's
//      pixels in index order through shared-memory tiles. It sums the
//      signs of the pixels assigned to it (the scatter of the L1 gradient,
//      done as a gather in pixel order: no float atomics, so the sum has
//      one fixed order and runs repeat bit for bit), and keeps the running
//      (vmin, nearest pixel) pair updated on strict `<`, which selects the
//      first pixel in index order that reaches the min, as the Pallas
//      kernel's within-tile first index plus strict cross-tile take. It
//      writes vmin, the L1 gradient and the L2 gradient.
// d is formed with __fsub_rn / __fmul_rn / __fadd_rn (and the build passes
// -fmad=false) so that it is bit-identical to the plain torch version and
// near-ties select the same vertex and pixel.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;     // threads per block, both kernels
constexpr float kBig = 1e30f;     // "no pixel" sentinel (BIG in the JAX code)

__device__ __forceinline__ float sq_dist(float gx, float gy, float px, float py,
                                         float* dx_out, float* dy_out) {
  const float dx = __fsub_rn(gx, px);
  const float dy = __fsub_rn(gy, py);
  *dx_out = dx;
  *dy_out = dy;
  return __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
}

__device__ __forceinline__ float sign_of(float x) {  // jnp.sign: sign(0) = 0
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

// grid (ceil(P / kThreads), N); one thread per pixel.
template <typename IdxT, bool kWithValue>
__global__ void __launch_bounds__(kThreads)
assign_kernel(const float2* __restrict__ gt, const float* __restrict__ mask,
              const float2* __restrict__ pred, const int* __restrict__ counts,
              int p, int v, IdxT* __restrict__ assign_idx,
              float2* __restrict__ assign_sign, float* __restrict__ l1_partial) {
  __shared__ float2 verts[kThreads];
  __shared__ float red[kThreads];

  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int count = counts[b];
  const int pix0 = blockIdx.x * kThreads;
  if (pix0 >= count) {  // the whole tile lies past the last active pixel
    if (kWithValue && tid == 0) l1_partial[(size_t)b * gridDim.x + blockIdx.x] = 0.0f;
    return;
  }

  const int pix = pix0 + tid;
  const bool active = pix < count;
  float2 g = make_float2(0.0f, 0.0f);
  float m = 0.0f;
  if (active) {
    g = gt[(size_t)b * p + pix];
    m = mask[(size_t)b * p + pix];
  }
  const float2* pv = pred + (size_t)b * v;

  float dmin = INFINITY;
  IdxT best = static_cast<IdxT>(-1);
  float bdx = 0.0f, bdy = 0.0f;
  for (int base = 0; base < v; base += kThreads) {
    const int nv = min(kThreads, v - base);
    if (tid < nv) verts[tid] = pv[base + tid];
    __syncthreads();
    if (active) {
      for (int j = 0; j < nv; ++j) {
        const float2 q = verts[j];
        float dx, dy;
        const float d = sq_dist(g.x, g.y, q.x, q.y, &dx, &dy);
        if (d < dmin) {  // strict: the first nearest vertex keeps its place
          dmin = d;
          best = static_cast<IdxT>(base + j);
          bdx = dx;
          bdy = dy;
        }
      }
    }
    __syncthreads();
  }

  if (active) {
    const size_t o = (size_t)b * p + pix;
    assign_idx[o] = best;
    assign_sign[o] = make_float2(__fmul_rn(m, sign_of(bdx)), __fmul_rn(m, sign_of(bdy)));
  }
  if (kWithValue) {
    red[tid] = active ? __fadd_rn(__fmul_rn(m, fabsf(bdx)), __fmul_rn(m, fabsf(bdy))) : 0.0f;
    __syncthreads();
    for (int s = kThreads / 2; s > 0; s >>= 1) {  // fixed-order tree sum
      if (tid < s) red[tid] = __fadd_rn(red[tid], red[tid + s]);
      __syncthreads();
    }
    if (tid == 0) l1_partial[(size_t)b * gridDim.x + blockIdx.x] = red[0];
  }
}

// grid (ceil(V / kThreads), N); one thread per vertex.
template <typename IdxT>
__global__ void __launch_bounds__(kThreads)
vertex_kernel(const float2* __restrict__ gt, const float* __restrict__ mask,
              const float2* __restrict__ pred, const int* __restrict__ counts,
              const IdxT* __restrict__ assign_idx, const float2* __restrict__ assign_sign,
              int p, int v, float* __restrict__ vmin_out, float2* __restrict__ l1_grad,
              float2* __restrict__ l2_grad) {
  __shared__ float2 pix[kThreads];
  __shared__ float pm[kThreads];
  __shared__ IdxT pidx[kThreads];
  __shared__ float2 psgn[kThreads];

  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int vert = blockIdx.x * kThreads + tid;
  const bool active = vert < v;
  const int count = counts[b];
  float2 q = make_float2(0.0f, 0.0f);
  if (active) q = pred[(size_t)b * v + vert];
  const IdxT me = static_cast<IdxT>(vert);
  const size_t row = (size_t)b * p;

  float vmin = kBig;
  float bx = 0.0f, by = 0.0f;  // the first nearest masked pixel
  float gx = 0.0f, gy = 0.0f;  // the L1 gradient, summed in pixel order
  for (int base = 0; base < count; base += kThreads) {
    const int np = min(kThreads, count - base);
    if (tid < np) {
      pix[tid] = gt[row + base + tid];
      pm[tid] = mask[row + base + tid];
      pidx[tid] = assign_idx[row + base + tid];
      psgn[tid] = assign_sign[row + base + tid];
    }
    __syncthreads();
    if (active) {
      for (int i = 0; i < np; ++i) {
        if (pidx[i] == me) {
          gx = __fsub_rn(gx, psgn[i].x);
          gy = __fsub_rn(gy, psgn[i].y);
        }
        if (pm[i] > 0.0f) {
          const float2 g = pix[i];
          float dx, dy;
          const float d = sq_dist(g.x, g.y, q.x, q.y, &dx, &dy);
          if (d < vmin) {  // strict: the first pixel at the min keeps its place
            vmin = d;
            bx = g.x;
            by = g.y;
          }
        }
      }
    }
    __syncthreads();
  }
  if (!active) return;

  const size_t o = (size_t)b * v + vert;
  vmin_out[o] = vmin;
  l1_grad[o] = make_float2(gx, gy);
  float2 l2 = make_float2(0.0f, 0.0f);
  if (vmin < kBig * 0.5f) {
    const float ex = __fsub_rn(q.x, bx);
    const float ey = __fsub_rn(q.y, by);
    const float norm = sqrtf(__fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ey, ey)));
    if (norm > 1e-12f) {
      const float den = fmaxf(norm, 1e-12f);
      l2 = make_float2(__fdiv_rn(ex, den), __fdiv_rn(ey, den));
    }
  }
  l2_grad[o] = l2;
}

template <typename IdxT>
void launch(const float2* gt, const float* mask, const float2* pred, const int* counts,
            int n, int p, int v, bool with_value, IdxT* assign_idx, float2* assign_sign,
            float* l1_partial, float* vmin, float2* l1_grad, float2* l2_grad,
            cudaStream_t s) {
  if (p > 0) {
    dim3 grid_pix((p + kThreads - 1) / kThreads, n);
    if (with_value) {
      assign_kernel<IdxT, true><<<grid_pix, kThreads, 0, s>>>(
          gt, mask, pred, counts, p, v, assign_idx, assign_sign, l1_partial);
    } else {
      assign_kernel<IdxT, false><<<grid_pix, kThreads, 0, s>>>(
          gt, mask, pred, counts, p, v, assign_idx, assign_sign, l1_partial);
    }
  }
  if (v > 0) {
    dim3 grid_vert((v + kThreads - 1) / kThreads, n);
    vertex_kernel<IdxT><<<grid_vert, kThreads, 0, s>>>(
        gt, mask, pred, counts, assign_idx, assign_sign, p, v, vmin, l1_grad, l2_grad);
  }
}

}  // namespace

extern "C" {

// Number of pixel blocks of the assign kernel (the width of l1_partial).
int chamfer_bwd_num_pixel_blocks(int p) { return (p + kThreads - 1) / kThreads; }

// gt (N, P, 2), mask (N, P), pred (N, V, 2), all f32 and contiguous;
// counts (N,) int32 one past the last active pixel of each image.
// Scratch: assign_idx (N, P) int32 (f32_index == 0) or f32 (f32_index != 0),
// assign_sign (N, P, 2) f32. With with_value != 0 writes l1_partial
// (N, chamfer_bwd_num_pixel_blocks(P)); always writes vmin (N, V),
// l1_grad (N, V, 2) and l2_grad (N, V, 2).
// Launches on `stream` and returns cudaGetLastError() as an int.
int chamfer_bwd(const void* gt, const void* mask, const void* pred, const void* counts,
                int n, int p, int v, int with_value, int f32_index, void* assign_idx,
                void* assign_sign, void* l1_partial, void* vmin, void* l1_grad,
                void* l2_grad, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    const float2* g = static_cast<const float2*>(gt);
    const float* m = static_cast<const float*>(mask);
    const float2* q = static_cast<const float2*>(pred);
    const int* c = static_cast<const int*>(counts);
    float2* sg = static_cast<float2*>(assign_sign);
    float* part = static_cast<float*>(l1_partial);
    float* vm = static_cast<float*>(vmin);
    float2* g1 = static_cast<float2*>(l1_grad);
    float2* g2 = static_cast<float2*>(l2_grad);
    if (f32_index) {
      launch<float>(g, m, q, c, n, p, v, with_value != 0, static_cast<float*>(assign_idx),
                    sg, part, vm, g1, g2, s);
    } else {
      launch<int>(g, m, q, c, n, p, v, with_value != 0, static_cast<int*>(assign_idx),
                  sg, part, vm, g1, g2, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
