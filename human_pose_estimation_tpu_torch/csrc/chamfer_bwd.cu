// Bidirectional silhouette chamfer, value and gradient in one pass, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_bwd_kernel` in
// human_pose_estimation_tpu/ops/pallas_chamfer.py, reached through
// `_run_bwd_kernel`: with the value output (`l1v_ref`, K2, the training
// path `_chamfer_value_and_grad_pallas` behind the custom VJP
// `chamfer_pallas`) and without it (K3, `_chamfer_grad_pred_pallas`).
// The type that carries each pixel's nearest-vertex index is a template
// parameter: `int` is K2/K3, `float` is K4 (`_bwd_kernel_f32idx` of
// benchmarks/chamfer_variant_bench.py, the same kernel with its indices
// carried in f32, exact below 2^24).
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
// What bounds it on the H100: arithmetic. ~7 f32 operations per (valid
// pixel, vertex) pair (1.9e8 pairs at the training shape: 8 images, ~4.5k
// valid pixels of a 16384 budget, 6890 vertices) against ~1 MB of inputs.
// Both directions evaluate d, so this two-pass design issues about twice
// the bound's operations: 6 instructions per pair in each pass (5 for d
// and one fminf), the shared-memory load, the loop and the group
// bookkeeping amortised over the items each thread holds and the group.
//
// Design: the Pallas kernel is "per-tile partials, merged in tile order".
// Hopper runs the tiles in parallel and merges them afterwards in the same
// order, in four launches:
//   1. assign (gt->pred), grid (pixel tiles, vertex chunks, images): each
//      thread holds kPixelsPerThread pixels in registers, and every vertex
//      of the chunk, staged in shared memory, feeds all of them. The
//      vertices go by groups of kGroup: a group's min is an fminf per pair,
//      and it replaces the running min only on strict `<`, which keeps the
//      first group that reaches the min. Per (pixel, chunk) it writes the
//      min and that group's first vertex. A tile with no weighted pixel
//      (mask != 0) exits: the merge never reads its entries.
//   2. assign merge, one thread per pixel: the chunks in order with strict
//      `<` (the first chunk at the min), then the first vertex of its
//      group whose d equals the min: the first nearest vertex over all
//      vertices, since d is recomputed with the same IEEE operations. It
//      writes the pixel's (vertex index, mask * sign) and, with the value
//      flag, one masked-L1 partial per block in a fixed tree order.
//   3. vertex (pred->gt and the L1 gradient), grid (vertex tiles, pixel
//      chunks, images): each thread holds kVertsPerThread vertices in
//      registers; one shared-memory load of a pixel's (g, assigned vertex)
//      feeds all of them. Pixels go by groups of kGroup as in pass 1, with
//      the pixels of mask <= 0 staged at infinity (their d is never a
//      min). Per (vertex, chunk) it writes the chunk's min, the first pixel
//      of its group, and the sum of the signs assigned to the vertex, taken
//      in pixel order: the scatter of the L1 gradient done as a gather,
//      with no float atomics. Chunks at or past the image's last active
//      pixel exit; a staged tile with no weighted pixel is skipped (its
//      signs are 0 and it holds no d), so a chunk without one writes
//      neutral partials (1e30, 0, 0).
//   4. vertex merge, one thread per vertex: the chunks in order, strict `<`
//      on the min (the earliest chunk wins a tie, the Pallas cross-tile
//      `take`), the signs added in chunk order (the Pallas column sums);
//      then the first pixel of the winning group with mask > 0 whose d
//      equals the min, and vmin, the L1 gradient and the L2 unit vector.
// Tracking the first index pair by pair would cost two more instructions
// per pair; rescanning a whole chunk in the merges instead costs a chain
// of dependent loads per thread. A group of 16 costs neither. Every sum
// has one fixed order, so two runs are bit-identical.
//
// Sizes: kThreads 128, kGroup 16, and the four below, chosen with
// chamfer_bwd_sweep.py (which builds patched copies of this file) on an
// NVIDIA H100 80GB HBM3 at 700.00 W, at chip_smoke.py's kernel-phase
// inputs. K2's device time per call of the parts, mean of two rounds,
// and per launch from torch.profiler; every candidate bit-equal:
//   * as chosen: 0.1841 ms; assign 0.0588, assign merge 0.0111, vertex
//     0.0753, vertex merge 0.0117 ms.
//   * 2 pixels per thread in pass 1: 32 registers, 64 resident warps per
//     SM. 4 and 8 took 0.1868 and 0.1976 ms (pass 1 0.0632 and 0.0671 ms,
//     48 and 36 warps: fewer blocks, a longer tail).
//   * 6 vertices per thread in pass 3: 72 registers, no spills, 28
//     resident warps. Six independent chains per shared load hide its
//     latency with few warps, and 6890 vertices fill 8.97 tiles of 768.
//     4 took 0.1917 ms (pass 3 0.0929 ms; 56 registers, 12 B spilled).
//     8 took 0.1817 ms, within the 2.5% by which its own two rounds
//     differ, with pass 3 slower (0.0770 ms; 96 registers, 20 warps).
//     Asking __launch_bounds__ for 8 blocks per SM (64 registers, 32
//     warps) spilled 24 B and took 0.1896 ms (pass 3 0.0830 ms).
//   * pixel chunk 256: at 128 pass 3 takes 0.0710 ms but the vertex merge
//     0.0219 ms, 0.1866 ms in all.
//   * vertex chunk 128: at 256 pass 1 takes 0.0640 ms (fewer blocks fill
//     the card) for a 0.0094 ms assign merge, 0.1895 ms in all.
// The price of the split is scratch: per image, ceil(V / kVertexChunk)
// x P x 8 B of pass-1 partials and ceil(P / kPixelChunk) x V x 16 B of
// pass-3 partials, 14.3 MB at P = 16384, V = 6890 (115 MB at batch 8;
// the two-pass kernel before the split needed 1.5 MB at batch 8).
//
// d is formed with __fsub_rn / __fmul_rn / __fadd_rn (and the build passes
// -fmad=false) so that it is bit-identical to the plain torch version and
// near-ties select the same vertex and pixel.

#include <cuda_runtime.h>
#include <math.h>

#include <cstddef>

namespace {

constexpr int kThreads = 128;  // threads per block, every kernel
constexpr int kStage = 256;    // pixels or vertices staged in shared memory at a time
constexpr int kGroup = 16;     // pixels or vertices per group of the min's bookkeeping
constexpr int kPixelsPerThread = 2;  // pass 1
constexpr int kVertsPerThread = 6;   // pass 3
constexpr int kPixelChunk = 256;     // pixels per pass-3 block
constexpr int kVertexChunk = 128;    // vertices per pass-1 block
constexpr float kBig = 1e30f;  // "no pixel" sentinel (BIG in the JAX code)
static_assert(kPixelsPerThread >= 1 && kVertsPerThread >= 1, "at least one item per thread");
static_assert(kPixelChunk >= 1 && kVertexChunk >= 1, "chunks are not empty");
static_assert(kStage % kGroup == 0 && kStage % kThreads == 0, "stages hold whole groups");

__device__ __forceinline__ float sq_dist(float gx, float gy, float px, float py) {
  const float dx = __fsub_rn(gx, px);
  const float dy = __fsub_rn(gy, py);
  return __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
}

__device__ __forceinline__ float sign_of(float x) {  // jnp.sign: sign(0) = 0
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

// 1. grid (ceil(P / (kThreads * kPixelsPerThread)), ceil(V / kVertexChunk), N).
// Pixel r of thread t is tile_start + r * kThreads + t (coalesced loads).
__global__ void __launch_bounds__(kThreads)
assign_kernel(const float2* __restrict__ gt, const float* __restrict__ mask,
              const float2* __restrict__ pred, const int* __restrict__ counts, int p, int v,
              float* __restrict__ part_d, int* __restrict__ part_group) {
  __shared__ float2 verts[kStage];

  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int count = counts[b];
  const int pix0 = blockIdx.x * (kThreads * kPixelsPerThread);
  if (pix0 >= count) return;  // the whole tile lies past the last active pixel

  const size_t row = (size_t)b * p;
  float gx[kPixelsPerThread], gy[kPixelsPerThread], dmin[kPixelsPerThread];
  int group[kPixelsPerThread];
  bool weighted = false;
#pragma unroll
  for (int r = 0; r < kPixelsPerThread; ++r) {
    const int pix = pix0 + r * kThreads + tid;
    gx[r] = 0.0f;
    gy[r] = 0.0f;
    if (pix < count) {
      const float2 g = gt[row + pix];
      gx[r] = g.x;
      gy[r] = g.y;
      weighted |= mask[row + pix] != 0.0f;
    }
    dmin[r] = INFINITY;
    group[r] = 0;
  }
  if (!__syncthreads_or(weighted)) return;  // the merge reads no pixel of this tile

  const int v0 = blockIdx.y * kVertexChunk;
  const int v1 = min(v, v0 + kVertexChunk);
  const float2* pv = pred + (size_t)b * v;
  for (int base = v0; base < v1; base += kStage) {
    const int nv = min(kStage, v1 - base);
    // past the chunk: vertices at infinity, whose d is never a min
    for (int k = tid; k < kStage; k += kThreads)
      verts[k] = k < nv ? pv[base + k] : make_float2(INFINITY, INFINITY);
    __syncthreads();
    for (int g0 = 0; g0 < nv; g0 += kGroup) {
      float gmin[kPixelsPerThread];
#pragma unroll
      for (int r = 0; r < kPixelsPerThread; ++r) gmin[r] = INFINITY;
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        const float2 q = verts[g0 + j];
#pragma unroll
        for (int r = 0; r < kPixelsPerThread; ++r)
          gmin[r] = fminf(gmin[r], sq_dist(gx[r], gy[r], q.x, q.y));
      }
#pragma unroll
      for (int r = 0; r < kPixelsPerThread; ++r) {
        if (gmin[r] < dmin[r]) {  // strict: the first group at the min keeps its place
          dmin[r] = gmin[r];
          group[r] = base + g0;
        }
      }
    }
    __syncthreads();
  }

  const size_t o = ((size_t)b * gridDim.y + blockIdx.y) * p;
#pragma unroll
  for (int r = 0; r < kPixelsPerThread; ++r) {
    const int pix = pix0 + r * kThreads + tid;
    if (pix < count) {
      part_d[o + pix] = dmin[r];
      part_group[o + pix] = group[r];
    }
  }
}

// 2. grid (ceil(P / kThreads), N); one thread per pixel.
template <typename IdxT, bool kWithValue>
__global__ void __launch_bounds__(kThreads)
assign_merge_kernel(const float2* __restrict__ gt, const float* __restrict__ mask,
                    const float2* __restrict__ pred, const int* __restrict__ counts, int p,
                    int v, int n_chunks, const float* __restrict__ part_d,
                    const int* __restrict__ part_group, IdxT* __restrict__ assign_idx,
                    float2* __restrict__ assign_sign, float* __restrict__ l1_partial) {
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
  float l1 = 0.0f;
  if (pix < count) {
    const size_t o = (size_t)b * p + pix;
    const float m = mask[o];
    int best = -1;
    float sx = 0.0f, sy = 0.0f;
    if (m != 0.0f) {  // pass 1 wrote this pixel's entries
      float dmin = INFINITY;
      int first = -1;  // the first chunk at the min
#pragma unroll 8
      for (int c = 0; c < n_chunks; ++c) {
        const float d = part_d[((size_t)b * n_chunks + c) * p + pix];
        if (d < dmin) {  // strict: the earlier chunk keeps its place
          dmin = d;
          first = c;
        }
      }
      if (first >= 0) {
        const float2 g = gt[o];
        const float2* pv = pred + (size_t)b * v;
        const int j0 = part_group[((size_t)b * n_chunks + first) * p + pix];
        float bdx = 0.0f, bdy = 0.0f;
#pragma unroll
        for (int j = kGroup - 1; j >= 0; --j) {  // backwards: the first match is kept
          if (j0 + j < v) {
            const float2 q = pv[j0 + j];
            const float dx = __fsub_rn(g.x, q.x);
            const float dy = __fsub_rn(g.y, q.y);
            if (__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)) == dmin) {
              best = j0 + j;
              bdx = dx;
              bdy = dy;
            }
          }
        }
        sx = __fmul_rn(m, sign_of(bdx));
        sy = __fmul_rn(m, sign_of(bdy));
        l1 = __fadd_rn(__fmul_rn(m, fabsf(bdx)), __fmul_rn(m, fabsf(bdy)));
      }
    }
    assign_idx[o] = static_cast<IdxT>(best);
    assign_sign[o] = make_float2(sx, sy);
  }
  if (kWithValue) {
    red[tid] = l1;
    __syncthreads();
    for (int s = kThreads / 2; s > 0; s >>= 1) {  // fixed-order tree sum
      if (tid < s) red[tid] = __fadd_rn(red[tid], red[tid + s]);
      __syncthreads();
    }
    if (tid == 0) l1_partial[(size_t)b * gridDim.x + blockIdx.x] = red[0];
  }
}

// 3. grid (ceil(V / (kThreads * kVertsPerThread)), ceil(P / kPixelChunk), N).
// Vertex r of thread t is tile_start + r * kThreads + t (coalesced loads).
template <typename IdxT>
__global__ void __launch_bounds__(kThreads)
vertex_kernel(const float2* __restrict__ gt, const float* __restrict__ mask,
              const float2* __restrict__ pred, const int* __restrict__ counts,
              const IdxT* __restrict__ assign_idx, const float2* __restrict__ assign_sign,
              int p, int v, float* __restrict__ part_vmin, int* __restrict__ part_group,
              float2* __restrict__ part_l1) {
  // per staged pixel: (gx, gy), at infinity where mask <= 0, and the offset
  // of its assigned vertex in this block's tile (or -1); its signs only
  // where that vertex is one of this block's
  __shared__ float2 pix[kStage];
  __shared__ int pix_off[kStage];
  __shared__ float2 sgn[kStage];

  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int count = counts[b];
  const int p0 = blockIdx.y * kPixelChunk;
  if (p0 >= count) return;  // the chunk lies past the last active pixel
  const int p1 = min(count, p0 + kPixelChunk);
  constexpr int kTile = kThreads * kVertsPerThread;
  const int vbase = blockIdx.x * kTile;

  float qx[kVertsPerThread], qy[kVertsPerThread], vmin[kVertsPerThread];
  float l1x[kVertsPerThread], l1y[kVertsPerThread];
  int group[kVertsPerThread];
#pragma unroll
  for (int r = 0; r < kVertsPerThread; ++r) {
    const int vert = vbase + r * kThreads + tid;
    float2 q = make_float2(0.0f, 0.0f);
    if (vert < v) q = pred[(size_t)b * v + vert];
    qx[r] = q.x;
    qy[r] = q.y;
    vmin[r] = kBig;
    group[r] = 0;
    l1x[r] = 0.0f;
    l1y[r] = 0.0f;
  }

  const size_t row = (size_t)b * p;
  for (int base = p0; base < p1; base += kStage) {
    const int np = min(kStage, p1 - base);
    bool weighted = false;
    for (int k = tid; k < kStage; k += kThreads) {
      float2 g = make_float2(INFINITY, INFINITY);
      int off = -1;
      if (k < np) {
        const size_t o = row + base + k;
        const float m = mask[o];
        if (m > 0.0f) g = gt[o];
        off = static_cast<int>(assign_idx[o]) - vbase;
        if (off >= 0 && off < kTile) {
          sgn[k] = assign_sign[o];
        } else {
          off = -1;
        }
        weighted |= m != 0.0f;
      }
      pix[k] = g;
      pix_off[k] = off;
    }
    if (__syncthreads_or(weighted)) {  // an unweighted tile changes nothing
      for (int g0 = 0; g0 < np; g0 += kGroup) {
        float gmin[kVertsPerThread];
#pragma unroll
        for (int r = 0; r < kVertsPerThread; ++r) gmin[r] = INFINITY;
#pragma unroll
        for (int i = 0; i < kGroup; ++i) {
          const float2 e = pix[g0 + i];
          const int off = pix_off[g0 + i];
          if (off >= 0 && (off % kThreads) == tid) {  // assigned to one of my vertices
            const int slot = off / kThreads;
            const float2 s = sgn[g0 + i];
#pragma unroll
            for (int r = 0; r < kVertsPerThread; ++r) {
              if (r == slot) {
                l1x[r] = __fsub_rn(l1x[r], s.x);
                l1y[r] = __fsub_rn(l1y[r], s.y);
              }
            }
          }
#pragma unroll
          for (int r = 0; r < kVertsPerThread; ++r)
            gmin[r] = fminf(gmin[r], sq_dist(e.x, e.y, qx[r], qy[r]));
        }
#pragma unroll
        for (int r = 0; r < kVertsPerThread; ++r) {
          if (gmin[r] < vmin[r]) {  // strict: the first group at the min keeps its place
            vmin[r] = gmin[r];
            group[r] = base + g0;
          }
        }
      }
    }
    __syncthreads();
  }

  const size_t o = ((size_t)b * gridDim.y + blockIdx.y) * v;
#pragma unroll
  for (int r = 0; r < kVertsPerThread; ++r) {
    const int vert = vbase + r * kThreads + tid;
    if (vert < v) {
      part_vmin[o + vert] = vmin[r];
      part_group[o + vert] = group[r];
      part_l1[o + vert] = make_float2(l1x[r], l1y[r]);
    }
  }
}

// 4. grid (ceil(V / kThreads), N); one thread per vertex.
__global__ void __launch_bounds__(kThreads)
vertex_merge_kernel(const float2* __restrict__ gt, const float* __restrict__ mask,
                    const float2* __restrict__ pred, const int* __restrict__ counts, int p,
                    int v, int n_chunks, const float* __restrict__ part_vmin,
                    const int* __restrict__ part_group, const float2* __restrict__ part_l1,
                    float* __restrict__ vmin_out, float2* __restrict__ l1_grad,
                    float2* __restrict__ l2_grad) {
  const int b = blockIdx.y;
  const int vert = blockIdx.x * kThreads + threadIdx.x;
  if (vert >= v) return;
  const int walked = (counts[b] + kPixelChunk - 1) / kPixelChunk;  // chunks pass 3 wrote

  float vmin = kBig;
  int first = 0;  // the first chunk at the min
  float gx = 0.0f, gy = 0.0f;
#pragma unroll 8
  for (int c = 0; c < walked; ++c) {
    const size_t at = ((size_t)b * n_chunks + c) * v + vert;
    const float d = part_vmin[at];
    if (d < vmin) {  // strict: the earlier chunk keeps its place
      vmin = d;
      first = c;
    }
    const float2 s = part_l1[at];
    gx = __fadd_rn(gx, s.x);
    gy = __fadd_rn(gy, s.y);
  }

  const size_t o = (size_t)b * v + vert;
  vmin_out[o] = vmin;
  l1_grad[o] = make_float2(gx, gy);
  float2 l2 = make_float2(0.0f, 0.0f);
  if (vmin < kBig * 0.5f) {
    const float2 q = pred[o];
    const size_t row = (size_t)b * p;
    const int i0 = part_group[((size_t)b * n_chunks + first) * v + vert];
    float2 g = make_float2(0.0f, 0.0f);
#pragma unroll
    for (int i = kGroup - 1; i >= 0; --i) {  // backwards: the first match is kept
      if (i0 + i < p && mask[row + i0 + i] > 0.0f) {
        const float2 e = gt[row + i0 + i];
        if (sq_dist(e.x, e.y, q.x, q.y) == vmin) g = e;
      }
    }
    const float ex = __fsub_rn(q.x, g.x);
    const float ey = __fsub_rn(q.y, g.y);
    const float norm = sqrtf(__fadd_rn(__fmul_rn(ex, ex), __fmul_rn(ey, ey)));
    if (norm > 1e-12f) {
      const float den = fmaxf(norm, 1e-12f);
      l2 = make_float2(__fdiv_rn(ex, den), __fdiv_rn(ey, den));
    }
  }
  l2_grad[o] = l2;
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

// The scratch buffer, carved into 256-byte aligned regions.
struct Scratch {
  size_t part_d, part_dgroup, assign_idx, assign_sign, part_vmin, part_vgroup, part_l1, total;
};

Scratch scratch_layout(int n, int p, int v) {
  const size_t nn = n, np = p, nv = v;
  const size_t vchunks = ceil_div(v, kVertexChunk), pchunks = ceil_div(p, kPixelChunk);
  const size_t sizes[7] = {
      nn * vchunks * np * 4,  // part_d: (N, V chunks, P) f32
      nn * vchunks * np * 4,  // part_dgroup: (N, V chunks, P) int32
      nn * np * 4,            // assign_idx: (N, P) index
      nn * np * 8,            // assign_sign: (N, P, 2) f32
      nn * pchunks * nv * 4,  // part_vmin: (N, P chunks, V) f32
      nn * pchunks * nv * 4,  // part_vgroup: (N, P chunks, V) int32
      nn * pchunks * nv * 8,  // part_l1: (N, P chunks, V, 2) f32
  };
  size_t offs[7], at = 0;
  for (int i = 0; i < 7; ++i) {
    offs[i] = at;
    at += (sizes[i] + 255) & ~size_t(255);
  }
  return {offs[0], offs[1], offs[2], offs[3], offs[4], offs[5], offs[6], at};
}

template <typename IdxT>
void launch(const float2* gt, const float* mask, const float2* pred, const int* counts, int n,
            int p, int v, bool with_value, char* scratch, float* l1_partial, float* vmin,
            float2* l1_grad, float2* l2_grad, cudaStream_t s) {
  const Scratch at = scratch_layout(n, p, v);
  float* part_d = reinterpret_cast<float*>(scratch + at.part_d);
  int* part_dgroup = reinterpret_cast<int*>(scratch + at.part_dgroup);
  IdxT* assign_idx = reinterpret_cast<IdxT*>(scratch + at.assign_idx);
  float2* assign_sign = reinterpret_cast<float2*>(scratch + at.assign_sign);
  float* part_vmin = reinterpret_cast<float*>(scratch + at.part_vmin);
  int* part_vgroup = reinterpret_cast<int*>(scratch + at.part_vgroup);
  float2* part_l1 = reinterpret_cast<float2*>(scratch + at.part_l1);
  const int vchunks = ceil_div(v, kVertexChunk);
  const int pchunks = ceil_div(p, kPixelChunk);
  if (p > 0) {
    if (v > 0) {
      dim3 grid(ceil_div(p, kThreads * kPixelsPerThread), vchunks, n);
      assign_kernel<<<grid, kThreads, 0, s>>>(gt, mask, pred, counts, p, v, part_d, part_dgroup);
    }
    dim3 grid(ceil_div(p, kThreads), n);
    if (with_value) {
      assign_merge_kernel<IdxT, true><<<grid, kThreads, 0, s>>>(
          gt, mask, pred, counts, p, v, vchunks, part_d, part_dgroup, assign_idx, assign_sign,
          l1_partial);
    } else {
      assign_merge_kernel<IdxT, false><<<grid, kThreads, 0, s>>>(
          gt, mask, pred, counts, p, v, vchunks, part_d, part_dgroup, assign_idx, assign_sign,
          l1_partial);
    }
  }
  if (v > 0) {
    if (p > 0) {
      dim3 grid(ceil_div(v, kThreads * kVertsPerThread), pchunks, n);
      vertex_kernel<IdxT><<<grid, kThreads, 0, s>>>(gt, mask, pred, counts, assign_idx,
                                                    assign_sign, p, v, part_vmin, part_vgroup,
                                                    part_l1);
    }
    dim3 grid(ceil_div(v, kThreads), n);
    vertex_merge_kernel<<<grid, kThreads, 0, s>>>(gt, mask, pred, counts, p, v, pchunks,
                                                  part_vmin, part_vgroup, part_l1, vmin,
                                                  l1_grad, l2_grad);
  }
}

}  // namespace

extern "C" {

// Number of pixel blocks of the assign merge (the width of l1_partial).
int chamfer_bwd_num_pixel_blocks(int p) { return ceil_div(p, kThreads); }

// Bytes of device scratch that chamfer_bwd needs for these sizes.
long long chamfer_bwd_scratch_bytes(int n, int p, int v) {
  return static_cast<long long>(scratch_layout(n, p, v).total);
}

// The compiled sizes: pixel chunk, vertex chunk, pixels per thread (pass
// 1), vertices per thread (pass 3), pixels or vertices per group.
void chamfer_bwd_tiling(int* out) {
  out[0] = kPixelChunk;
  out[1] = kVertexChunk;
  out[2] = kPixelsPerThread;
  out[3] = kVertsPerThread;
  out[4] = kGroup;
}

// Resident warps per SM of K2's four kernels (assign, assign merge,
// vertex, vertex merge), from the occupancy calculator; returns its error.
int chamfer_bwd_resident_warps(int* out) {
  const void* fns[4] = {
      reinterpret_cast<const void*>(assign_kernel),
      reinterpret_cast<const void*>(assign_merge_kernel<int, true>),
      reinterpret_cast<const void*>(vertex_kernel<int>),
      reinterpret_cast<const void*>(vertex_merge_kernel),
  };
  for (int i = 0; i < 4; ++i) {
    int blocks = 0;
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fns[i], kThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    out[i] = blocks * kThreads / 32;
  }
  return 0;
}

// gt (N, P, 2), mask (N, P), pred (N, V, 2), all f32 and contiguous;
// counts (N,) int32 one past the last active pixel of each image.
// scratch: chamfer_bwd_scratch_bytes(N, P, V) bytes of device memory; the
// pixels' nearest-vertex indices in it are int32 (f32_index == 0) or f32
// (f32_index != 0).
// With with_value != 0 writes l1_partial (N, chamfer_bwd_num_pixel_blocks(P));
// always writes vmin (N, V), l1_grad (N, V, 2) and l2_grad (N, V, 2).
// Launches on `stream` and returns cudaGetLastError() as an int.
int chamfer_bwd(const void* gt, const void* mask, const void* pred, const void* counts, int n,
                int p, int v, int with_value, int f32_index, void* scratch, void* l1_partial,
                void* vmin, void* l1_grad, void* l2_grad, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    const float2* g = static_cast<const float2*>(gt);
    const float* m = static_cast<const float*>(mask);
    const float2* q = static_cast<const float2*>(pred);
    const int* c = static_cast<const int*>(counts);
    char* sc = static_cast<char*>(scratch);
    float* part = static_cast<float*>(l1_partial);
    float* vm = static_cast<float*>(vmin);
    float2* g1 = static_cast<float2*>(l1_grad);
    float2* g2 = static_cast<float2*>(l2_grad);
    if (f32_index) {
      launch<float>(g, m, q, c, n, p, v, with_value != 0, sc, part, vm, g1, g2, s);
    } else {
      launch<int>(g, m, q, c, n, p, v, with_value != 0, sc, part, vm, g1, g2, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
