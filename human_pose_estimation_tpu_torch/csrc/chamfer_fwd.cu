// Bidirectional silhouette chamfer, value-only forward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` in
// human_pose_estimation_tpu/ops/pallas_chamfer.py (reached through
// `_chamfer_forward` / the primal of `chamfer_pallas`): for each image b,
// over the exact squared-distance field d = (g - p)^2 between its gt
// silhouette pixels g (masked) and its projected vertices p,
//   * gt->pred: the sum over pixels of (|dx| + |dy|) * mask at the FIRST
//     L2-nearest vertex (exact ties: lowest vertex index wins);
//   * pred->gt: for each vertex, the min of d over the pixels with
//     mask > 0 (1e30 when there is none), then the sum of sqrt(vmin) over
//     the vertices that found a pixel;
// and the image's value is 0 when its mask does not sum above 0. The
// epilogue that XLA computes in the JAX package is here too, so that one
// call of the library is the whole function.
//
// What bounds it on the H100: arithmetic. ~7 f32 operations per (valid
// pixel, vertex) pair (1.9e8 pairs at the evaluation shape: 8 images, ~4k
// valid pixels of a 16384 budget, 6890 vertices) against ~1 MB of inputs.
// Both directions evaluate d, so this two-pass design issues about twice
// the bound's operations: 6 instructions per pair in each pass (5 for d
// and one fminf), with the shared-memory load and the loop amortised over
// the items each thread holds.
//
// Design: the Pallas kernel walks pixel tiles in order and carries the
// per-vertex min and the L1 sum from one grid step to the next. Hopper
// runs the tiles in parallel and merges them afterwards in order, in six
// launches:
//   0. count, one block per image: one past the last pixel with mask > 0
//      (`_last_active`; the passes stop there) and whether the mask sums
//      above 0 (`has_gt`).
//   1. pixel pass (gt->pred), grid (pixel tiles, vertex chunks, images):
//      each thread holds kPixelsPerThread pixels in registers, and every
//      vertex of the chunk, staged in shared memory, feeds all of them. The
//      vertices go by groups of kGroup: a group's min is an fminf per pair,
//      and it replaces the running min only on strict `<`, which keeps the
//      first group that reaches the min. Per (pixel, chunk) it writes the
//      min and that group's first vertex. A tile with no weighted pixel
//      (mask != 0) exits: the merge never reads its entries.
//   2. pixel merge, one thread per pixel: the chunks in order with strict
//      `<` (the first chunk at the min), then the first vertex of its
//      group whose d equals the min: the first nearest vertex over all
//      vertices, since d is recomputed with the same IEEE operations. Each
//      block writes the sum of its pixels' (|dx| + |dy|) * mask in a fixed
//      tree order.
//   3. vertex pass (pred->gt), grid (vertex tiles, pixel chunks, images):
//      each thread holds kVertsPerThread vertices in registers; one
//      shared-memory load of a staged pixel feeds all of them, with an
//      fminf per pair and nothing else: the pixels of mask <= 0 and the
//      stage's tail are staged at infinity (their d is never a min).
//      Chunks at or past the image's last active pixel exit; a staged tile
//      with no pixel of mask > 0 is skipped. Per (vertex, chunk) it writes
//      the chunk's min (1e30 when the chunk holds no such pixel).
//   4. vertex merge, one thread per vertex: the min over the walked chunks
//      (exact and without order, so vmin is bit-equal to the plain
//      version's); each block writes the sum of its vertices' sqrt(vmin)
//      in a fixed tree order.
//   5. finish, one block per image: the two kinds of block partials, each
//      summed in a fixed order, and 0 where the mask does not sum above 0.
// Pixels past the last one with mask > 0 are walked in neither direction,
// as in the Pallas kernel. Every sum has one fixed order and there are no
// float atomics, so two runs are bit-identical; the sums' order differs
// from the plain version's, within rtol 1e-5.
//
// Sizes: kThreads 128, kGroup 16 (K2's), and the four below, chosen with
// `chamfer_bwd_sweep.py --k1` (which builds patched copies of this file)
// on an NVIDIA H100 80GB HBM3 at 700.00 W, at chip_smoke.py's kernel-phase
// inputs. K1's device time per call, mean of two rounds, and per launch
// from torch.profiler; every candidate's vmin bit-equal:
//   * as chosen: 0.1448 ms; count 0.0026, pixel pass 0.0587, pixel merge
//     0.0110, vertex pass 0.0669, vertex merge 0.0040, finish 0.0021 ms.
//   * 6 vertices per thread in pass 3: 40 registers, no spills, 48
//     resident warps per SM, and 6890 vertices fill 8.97 tiles of 768. 8
//     took 0.1524 ms (pass 3 0.0683 ms; 40 registers, but 6.73 tiles of
//     1024 leave a quarter of the last tile idle), 4 took 0.1628 ms (pass
//     3 0.0830 ms; 31 registers, 64 warps: one shared load feeds fewer
//     pairs), 12 and 16 took 0.1596 and 0.1791 ms (60 and 71 registers,
//     32 and 28 warps). The first sweep, of a source with 8, had picked 6.
//   * 2 pixels per thread in pass 1 (K2's): 1 and 4 took 0.1503 and
//     0.1489 ms (pass 1 0.0649 and 0.0618 ms).
//   * pixel chunk 256: at 128 pass 3 takes 0.0575 ms but the vertex merge
//     0.0063 ms, 0.1451 ms in all, a tie, for twice the pass-3 scratch; at
//     512, 0.1560 ms (pass 3 0.0752 ms).
//   * vertex chunk 128: 64 and 256 took 0.1551 and 0.1501 ms (pass 1
//     0.0666 and 0.0638 ms).
// The price of the split is scratch: per image, ceil(V / kVertexChunk) x P
// x 8 B of pass-1 partials and ceil(P / kPixelChunk) x V x 4 B of pass-3
// partials, 7.08 MB and 1.76 MB at P = 16384, V = 6890 (70.7 MB at batch
// 8, against 0.2 MB for the two-kernel design before the split).
//
// d is formed with __fsub_rn / __fmul_rn / __fadd_rn (and the build passes
// -fmad=false) so that it is bit-identical to the plain torch version and
// near-ties select the same vertex.

#include <cuda_runtime.h>
#include <math.h>

#include <cstddef>

namespace {

constexpr int kThreads = 128;  // threads per block, every kernel but the count
constexpr int kCountThreads = 512;  // threads per block of the count
constexpr int kStage = 256;    // pixels or vertices staged in shared memory at a time
constexpr int kGroup = 16;     // vertices per group of the pixel pass's first-index bookkeeping
constexpr int kPixelsPerThread = 2;  // pass 1
constexpr int kVertsPerThread = 6;   // pass 3
constexpr int kPixelChunk = 256;     // pixels per pass-3 block
constexpr int kVertexChunk = 128;    // vertices per pass-1 block
constexpr float kBig = 1e30f;  // "no pixel" sentinel (BIG in the JAX code)
static_assert(kPixelsPerThread >= 1 && kVertsPerThread >= 1, "at least one item per thread");
static_assert(kPixelChunk >= 1 && kVertexChunk >= 1, "chunks are not empty");
static_assert(kStage % kGroup == 0 && kStage % kThreads == 0, "stages hold whole groups");
static_assert((kThreads & (kThreads - 1)) == 0 && (kCountThreads & (kCountThreads - 1)) == 0,
              "the tree sums halve the block");

__device__ __forceinline__ float sq_dist(float gx, float gy, float px, float py) {
  const float dx = __fsub_rn(gx, px);
  const float dy = __fsub_rn(gy, py);
  return __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
}

// The sum of every thread's x in a fixed tree order; every thread of the
// block calls it and gets the sum.
__device__ __forceinline__ float block_sum(float* red, float x) {
  const int tid = threadIdx.x;
  red[tid] = x;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (tid < s) red[tid] = __fadd_rn(red[tid], red[tid + s]);
    __syncthreads();
  }
  return red[0];
}

// 0. grid (N); one block of kCountThreads per image: one past the last
// pixel with mask > 0 (`_last_active`) and whether the mask sums above 0
// (`has_gt`), the sum taken in a fixed order.
__global__ void __launch_bounds__(kCountThreads)
fwd_count(const float* __restrict__ mask, int p, int* __restrict__ counts, int* __restrict__ has_gt) {
  __shared__ float red[kCountThreads];
  __shared__ int last[kCountThreads];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const float* mb = mask + (size_t)b * p;
  float sum = 0.0f;
  int end = 0;
  for (int i = tid; i < p; i += kCountThreads) {
    const float m = mb[i];
    sum = __fadd_rn(sum, m);
    if (m > 0.0f) end = i + 1;
  }
  red[tid] = sum;
  last[tid] = end;
  __syncthreads();
  for (int s = kCountThreads / 2; s > 0; s >>= 1) {  // fixed-order tree
    if (tid < s) {
      red[tid] = __fadd_rn(red[tid], red[tid + s]);
      last[tid] = max(last[tid], last[tid + s]);
    }
    __syncthreads();
  }
  if (tid == 0) {
    counts[b] = last[0];
    has_gt[b] = red[0] > 0.0f;
  }
}

// 1. grid (ceil(P / (kThreads * kPixelsPerThread)), ceil(V / kVertexChunk), N).
// Pixel r of thread t is tile_start + r * kThreads + t (coalesced loads).
__global__ void __launch_bounds__(kThreads)
fwd_pixel_pass(const float2* __restrict__ gt, const float* __restrict__ mask,
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
__global__ void __launch_bounds__(kThreads)
fwd_pixel_merge(const float2* __restrict__ gt, const float* __restrict__ mask,
                const float2* __restrict__ pred, const int* __restrict__ counts, int p, int v,
                int n_chunks, const float* __restrict__ part_d, const int* __restrict__ part_group,
                float* __restrict__ l1_partial) {
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
  float l1 = 0.0f;
  if (pix < count) {
    const size_t o = (size_t)b * p + pix;
    const float m = mask[o];
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
              bdx = dx;
              bdy = dy;
            }
          }
        }
        l1 = __fmul_rn(__fadd_rn(fabsf(bdx), fabsf(bdy)), m);  // the plain version's l1_near * m
      }
    }
  }
  const float sum = block_sum(red, l1);
  if (tid == 0) *out = sum;
}

// 3. grid (ceil(V / (kThreads * kVertsPerThread)), ceil(P / kPixelChunk), N).
// Vertex r of thread t is tile_start + r * kThreads + t (coalesced loads).
__global__ void __launch_bounds__(kThreads)
fwd_vertex_pass(const float2* __restrict__ gt, const float* __restrict__ mask,
                const float2* __restrict__ pred, const int* __restrict__ counts, int p, int v,
                float* __restrict__ part_vmin) {
  __shared__ float2 pix[kStage];  // (gx, gy), at infinity where mask <= 0 and past the chunk

  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int count = counts[b];
  const int p0 = blockIdx.y * kPixelChunk;
  if (p0 >= count) return;  // the chunk lies past the last active pixel
  const int p1 = min(count, p0 + kPixelChunk);
  const int vbase = blockIdx.x * (kThreads * kVertsPerThread);

  float qx[kVertsPerThread], qy[kVertsPerThread], vmin[kVertsPerThread];
#pragma unroll
  for (int r = 0; r < kVertsPerThread; ++r) {
    const int vert = vbase + r * kThreads + tid;
    float2 q = make_float2(0.0f, 0.0f);
    if (vert < v) q = pred[(size_t)b * v + vert];
    qx[r] = q.x;
    qy[r] = q.y;
    vmin[r] = kBig;
  }

  const size_t row = (size_t)b * p;
  for (int base = p0; base < p1; base += kStage) {
    const int np = min(kStage, p1 - base);
    bool found = false;
    for (int k = tid; k < kStage; k += kThreads) {
      float2 g = make_float2(INFINITY, INFINITY);
      if (k < np && mask[row + base + k] > 0.0f) {
        g = gt[row + base + k];
        found = true;
      }
      pix[k] = g;
    }
    if (__syncthreads_or(found)) {  // a tile without a pixel of mask > 0 changes nothing
      // in steps of kGroup pixels; the stage's tail is at infinity
      for (int i0 = 0; i0 < np; i0 += kGroup) {
#pragma unroll
        for (int i = 0; i < kGroup; ++i) {
          const float2 e = pix[i0 + i];
#pragma unroll
          for (int r = 0; r < kVertsPerThread; ++r)
            vmin[r] = fminf(vmin[r], sq_dist(e.x, e.y, qx[r], qy[r]));
        }
      }
    }
    __syncthreads();
  }

  const size_t o = ((size_t)b * gridDim.y + blockIdx.y) * v;
#pragma unroll
  for (int r = 0; r < kVertsPerThread; ++r) {
    const int vert = vbase + r * kThreads + tid;
    if (vert < v) part_vmin[o + vert] = vmin[r];
  }
}

// 4. grid (ceil(V / kThreads), N); one thread per vertex.
__global__ void __launch_bounds__(kThreads)
fwd_vertex_merge(const int* __restrict__ counts, int v, int n_chunks,
                 const float* __restrict__ part_vmin, float* __restrict__ vmin_out,
                 float* __restrict__ l2_partial) {
  __shared__ float red[kThreads];

  const int b = blockIdx.y;
  const int vert = blockIdx.x * kThreads + threadIdx.x;
  float l2 = 0.0f;
  if (vert < v) {
    const int walked = (counts[b] + kPixelChunk - 1) / kPixelChunk;  // chunks pass 3 wrote
    float vmin = kBig;
#pragma unroll 8
    for (int c = 0; c < walked; ++c) vmin = fminf(vmin, part_vmin[((size_t)b * n_chunks + c) * v + vert]);
    if (vmin_out != nullptr) vmin_out[(size_t)b * v + vert] = vmin;
    if (vmin < kBig * 0.5f) l2 = sqrtf(fmaxf(vmin, 0.0f));  // a pixel was found
  }
  const float sum = block_sum(red, l2);
  if (threadIdx.x == 0) l2_partial[(size_t)b * gridDim.x + blockIdx.x] = sum;
}

// 5. grid (N); one block per image: the L1 partials and the sqrt(vmin)
// partials each summed in a fixed order, and 0 where the mask does not sum
// above 0.
__global__ void __launch_bounds__(kThreads)
fwd_finish(const int* __restrict__ has_gt, int n_l1, const float* __restrict__ l1_partial, int n_l2,
           const float* __restrict__ l2_partial, float* __restrict__ value,
           float* __restrict__ l1_out) {
  __shared__ float red[kThreads];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  float a = 0.0f;
  for (int i = tid; i < n_l1; i += kThreads) a = __fadd_rn(a, l1_partial[(size_t)b * n_l1 + i]);
  const float l1 = block_sum(red, a);
  __syncthreads();  // every thread has read red[0] before it is written again
  float c = 0.0f;
  for (int i = tid; i < n_l2; i += kThreads) c = __fadd_rn(c, l2_partial[(size_t)b * n_l2 + i]);
  const float l2 = block_sum(red, c);
  if (tid == 0) {
    value[b] = has_gt[b] ? __fadd_rn(l1, l2) : 0.0f;
    if (l1_out != nullptr) l1_out[b] = l1;
  }
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

// The scratch buffer, carved into 256-byte aligned regions.
struct Scratch {
  size_t counts, has_gt, part_d, part_group, l1_partial, part_vmin, l2_partial, total;
};

Scratch scratch_layout(int n, int p, int v) {
  const size_t nn = n, np = p, nv = v;
  const size_t vchunks = ceil_div(v, kVertexChunk), pchunks = ceil_div(p, kPixelChunk);
  const size_t sizes[7] = {
      nn * 4,                             // counts: (N,) int32
      nn * 4,                             // has_gt: (N,) int32
      nn * vchunks * np * 4,              // part_d: (N, V chunks, P) f32
      nn * vchunks * np * 4,              // part_group: (N, V chunks, P) int32
      nn * ceil_div(p, kThreads) * 4,     // l1_partial: (N, pixel blocks) f32
      nn * pchunks * nv * 4,              // part_vmin: (N, P chunks, V) f32
      nn * ceil_div(v, kThreads) * 4,     // l2_partial: (N, vertex blocks) f32
  };
  size_t offs[7], at = 0;
  for (int i = 0; i < 7; ++i) {
    offs[i] = at;
    at += (sizes[i] + 255) & ~size_t(255);
  }
  return {offs[0], offs[1], offs[2], offs[3], offs[4], offs[5], offs[6], at};
}

}  // namespace

extern "C" {

// Bytes of device scratch that chamfer_fwd needs for these sizes.
long long chamfer_fwd_scratch_bytes(int n, int p, int v) {
  return static_cast<long long>(scratch_layout(n, p, v).total);
}

// The compiled sizes: pixel chunk, vertex chunk, pixels per thread (pass
// 1), vertices per thread (pass 3), vertices per group (pass 1).
void chamfer_fwd_tiling(int* out) {
  out[0] = kPixelChunk;
  out[1] = kVertexChunk;
  out[2] = kPixelsPerThread;
  out[3] = kVertsPerThread;
  out[4] = kGroup;
}

// Resident warps per SM of K1's six kernels (count, pixel pass, pixel
// merge, vertex pass, vertex merge, finish), from the occupancy
// calculator; returns its error.
int chamfer_fwd_resident_warps(int* out) {
  const void* fns[6] = {
      reinterpret_cast<const void*>(fwd_count),       reinterpret_cast<const void*>(fwd_pixel_pass),
      reinterpret_cast<const void*>(fwd_pixel_merge), reinterpret_cast<const void*>(fwd_vertex_pass),
      reinterpret_cast<const void*>(fwd_vertex_merge), reinterpret_cast<const void*>(fwd_finish),
  };
  for (int i = 0; i < 6; ++i) {
    const int threads = i == 0 ? kCountThreads : kThreads;
    int blocks = 0;
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fns[i], threads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    out[i] = blocks * threads / 32;
  }
  return 0;
}

// gt (N, P, 2), mask (N, P), pred (N, V, 2), all f32 and contiguous;
// scratch: chamfer_fwd_scratch_bytes(N, P, V) bytes of device memory.
// Writes value (N,) and, where they are not null, l1 (N,) (the masked
// gt->pred L1 sum) and vmin (N, V) (the pred->gt min, 1e30 where no pixel
// was found). Launches on `stream` and returns cudaGetLastError() as an
// int.
int chamfer_fwd(const void* gt, const void* mask, const void* pred, int n, int p, int v,
                void* scratch, void* value, void* l1, void* vmin, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    const float2* g = static_cast<const float2*>(gt);
    const float* m = static_cast<const float*>(mask);
    const float2* q = static_cast<const float2*>(pred);
    char* sc = static_cast<char*>(scratch);
    const Scratch at = scratch_layout(n, p, v);
    int* counts = reinterpret_cast<int*>(sc + at.counts);
    int* has_gt = reinterpret_cast<int*>(sc + at.has_gt);
    float* part_d = reinterpret_cast<float*>(sc + at.part_d);
    int* part_group = reinterpret_cast<int*>(sc + at.part_group);
    float* l1_partial = reinterpret_cast<float*>(sc + at.l1_partial);
    float* part_vmin = reinterpret_cast<float*>(sc + at.part_vmin);
    float* l2_partial = reinterpret_cast<float*>(sc + at.l2_partial);
    const int vchunks = ceil_div(v, kVertexChunk);
    const int pchunks = ceil_div(p, kPixelChunk);
    const int pixel_blocks = ceil_div(p, kThreads);
    const int vertex_blocks = ceil_div(v, kThreads);
    fwd_count<<<n, kCountThreads, 0, s>>>(m, p, counts, has_gt);
    if (p > 0) {
      if (v > 0) {
        dim3 grid(ceil_div(p, kThreads * kPixelsPerThread), vchunks, n);
        fwd_pixel_pass<<<grid, kThreads, 0, s>>>(g, m, q, counts, p, v, part_d, part_group);
      }
      dim3 grid(pixel_blocks, n);
      fwd_pixel_merge<<<grid, kThreads, 0, s>>>(g, m, q, counts, p, v, vchunks, part_d, part_group,
                                                l1_partial);
    }
    if (v > 0) {
      if (p > 0) {
        dim3 grid(ceil_div(v, kThreads * kVertsPerThread), pchunks, n);
        fwd_vertex_pass<<<grid, kThreads, 0, s>>>(g, m, q, counts, p, v, part_vmin);
      }
      dim3 grid(vertex_blocks, n);
      fwd_vertex_merge<<<grid, kThreads, 0, s>>>(counts, v, pchunks, part_vmin,
                                                 static_cast<float*>(vmin), l2_partial);
    }
    fwd_finish<<<n, kThreads, 0, s>>>(has_gt, pixel_blocks, l1_partial, vertex_blocks, l2_partial,
                                      static_cast<float*>(value), static_cast<float*>(l1));
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
