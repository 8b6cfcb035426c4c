// Bidirectional silhouette chamfer, value-only forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` in
// human_pose_estimation_tpu/ops/pallas_chamfer.py (reached through
// `_chamfer_forward` / the primal of `chamfer_pallas`): for each image b,
// over the exact squared-distance field d = (g - p)^2 between its gt
// silhouette pixels g (masked) and its projected vertices p,
//   * gt->pred: the masked sum over pixels of |dx| + |dy| to the FIRST
//     L2-nearest vertex (exact ties: lowest vertex index wins);
//   * pred->gt: for each vertex, the min of d over the pixels with
//     mask > 0 (1e30 when there is none).
// The epilogue (sum of the block partials, sum of sqrt(vmin) over vertices
// that found a pixel, the empty-mask guard) is plain torch in the wrapper,
// as it is XLA in the JAX package.
//
// What bounds it on the H100: arithmetic. At the eval shape (8 images,
// ~4k valid pixels of a 16384 budget, 6890 vertices) there are ~2.3e8
// (pixel, vertex) pairs per direction and ~7 f32 operations per pair,
// against ~1 MB of inputs: tens of microseconds of f32 (non-tensor-core)
// work and well under a microsecond of memory traffic. The design keeps
// every (P, V) intermediate out of device memory and stops each image's
// loops at its last active pixel (`counts`, computed by the wrapper like
// `_last_active`), so the cost follows the true silhouette size and not
// the padded budget.
//
// Design: the TPU grid walks pixel tiles in order and carries the
// per-vertex min and the L1 sum from one step to the next; Hopper blocks
// run in no order, so the two directions are two kernels, each with a
// loop inside the thread in place of the sequential grid axis.
//   1. gt->pred, pixel-parallel: one thread per pixel, vertex tiles staged
//      through shared memory, a running (dmin, L1 at the nearest) pair
//      updated only on strict `<` (first index wins, as the iota-carrying
//      min of the TPU kernel). Each block reduces its pixels' masked L1 in
//      a fixed tree order and writes one partial; no float atomics, so
//      runs repeat bit for bit.
//   2. pred->gt, vertex-parallel: one thread per vertex, pixel tiles (with
//      their mask) staged through shared memory up to the last active
//      pixel.
// d is formed with __fmul_rn / __fadd_rn (no FMA contraction) so that it
// is bit-identical to the plain torch version and near-ties select the
// same vertex. Vertices need no padding: loops stop at V.

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

// grid (ceil(P / kThreads), N); one thread per pixel.
__global__ void __launch_bounds__(kThreads)
gt_to_pred_kernel(const float2* __restrict__ gt, const float* __restrict__ mask,
                  const float2* __restrict__ pred, const int* __restrict__ counts,
                  int p, int v, float* __restrict__ l1_partial) {
  __shared__ float2 verts[kThreads];
  __shared__ float red[kThreads];

  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int count = counts[b];
  const int pix0 = blockIdx.x * kThreads;
  float* out = l1_partial + (size_t)b * gridDim.x + blockIdx.x;
  if (pix0 >= count) {  // the whole tile lies past the last active pixel
    if (tid == 0) *out = 0.0f;
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
  float l1 = 0.0f;
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
          l1 = __fadd_rn(fabsf(dx), fabsf(dy));
        }
      }
    }
    __syncthreads();
  }

  red[tid] = active ? __fmul_rn(l1, m) : 0.0f;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {  // fixed-order tree sum
    if (tid < s) red[tid] = __fadd_rn(red[tid], red[tid + s]);
    __syncthreads();
  }
  if (tid == 0) *out = red[0];
}

// grid (ceil(V / kThreads), N); one thread per vertex.
__global__ void __launch_bounds__(kThreads)
pred_to_gt_kernel(const float2* __restrict__ gt, const float* __restrict__ mask,
                  const float2* __restrict__ pred, const int* __restrict__ counts,
                  int p, int v, float* __restrict__ vmin_out) {
  __shared__ float2 pix[kThreads];
  __shared__ float pm[kThreads];

  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int vert = blockIdx.x * kThreads + tid;
  const bool active = vert < v;
  const int count = counts[b];
  float2 q = make_float2(0.0f, 0.0f);
  if (active) q = pred[(size_t)b * v + vert];
  const float2* gb = gt + (size_t)b * p;
  const float* mb = mask + (size_t)b * p;

  float vmin = kBig;
  for (int base = 0; base < count; base += kThreads) {
    const int np = min(kThreads, count - base);
    if (tid < np) {
      pix[tid] = gb[base + tid];
      pm[tid] = mb[base + tid];
    }
    __syncthreads();
    if (active) {
      for (int i = 0; i < np; ++i) {
        if (pm[i] > 0.0f) {
          const float2 g = pix[i];
          float dx, dy;
          vmin = fminf(vmin, sq_dist(g.x, g.y, q.x, q.y, &dx, &dy));
        }
      }
    }
    __syncthreads();
  }
  if (active) vmin_out[(size_t)b * v + vert] = vmin;
}

}  // namespace

extern "C" {

// Number of pixel blocks of the gt->pred kernel (the width of l1_partial).
int chamfer_fwd_num_pixel_blocks(int p) { return (p + kThreads - 1) / kThreads; }

// gt (N, P, 2), mask (N, P), pred (N, V, 2), all f32 and contiguous;
// counts (N,) int32 one past the last active pixel of each image.
// Writes l1_partial (N, chamfer_fwd_num_pixel_blocks(P)) and vmin (N, V).
// Launches on `stream` and returns cudaGetLastError() as an int.
int chamfer_fwd(const void* gt, const void* mask, const void* pred, const void* counts,
                int n, int p, int v, void* l1_partial, void* vmin, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0 && p > 0) {
    dim3 grid_pix(chamfer_fwd_num_pixel_blocks(p), n);
    gt_to_pred_kernel<<<grid_pix, kThreads, 0, s>>>(
        static_cast<const float2*>(gt), static_cast<const float*>(mask),
        static_cast<const float2*>(pred), static_cast<const int*>(counts), p, v,
        static_cast<float*>(l1_partial));
  }
  if (n > 0 && v > 0) {
    dim3 grid_vert((v + kThreads - 1) / kThreads, n);
    pred_to_gt_kernel<<<grid_vert, kThreads, 0, s>>>(
        static_cast<const float2*>(gt), static_cast<const float*>(mask),
        static_cast<const float2*>(pred), static_cast<const int*>(counts), p, v,
        static_cast<float*>(vmin));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
