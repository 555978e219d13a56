// K4: the 3-channel pedestrian map (occupancy, vx, vy) of every robot.
//
// Replaces the Pallas TPU kernel img_env_tpu/ops/pallas_pedmap.py
// (ped_map_pallas / _pedmap_kernel), whose [psub, 128] pixel tiles and
// scalar-prefetched ped table are TPU grid artifacts.
//
// Semantics (yaml_env.py:392-458): robot n's map covers +-3 m; the peds,
// sorted by range^2 (stable), draw their discs in order and later ones
// overwrite earlier pixels.  Without a sort, the winner at a pixel is the
// covering ped with the lexicographically largest (range^2, index): peds
// are visited in ascending index and a covering ped replaces the incumbent
// when range^2 >= best.  Pixel (h, w) is covered by ped i when the ped is in
// the window, the pixel centre ((h + .5) res, (w + .5) res) is strictly
// inside the disc of radius r around (3 - px, 3 - py), and h, w lie in the
// reference's floor-div index box [floor((t - r) / res), floor((t + r) /
// res)).  Every float is rounded as the plain-torch twin rounds it
// (ops/pedmap.py): range^2 is one fused multiply-add, the box bounds
// multiply by the float32 reciprocal of res, the rest is explicit
// round-to-nearest arithmetic (no contraction), so the map is bit-equal.
//
// What bounds it on the H100: compare/select work, N x M x hs^2 pixel tests
// (200 x 200 x 2304 = 92 M per step); inputs (16 B per ped) and the output
// (27 KB per robot) are small.  Design: one block of 512 threads per robot,
// each thread owning up to 8 pixels with (best range^2, vx, vy) in
// registers.  Peds are staged through shared memory in tiles of 256, with
// their derived terms (window centre, index box, range^2) computed once per
// ped; a thread tests only pixels inside a ped's index box.

#include <cuda_runtime.h>
#include <math.h>

#define PM_THREADS 512
#define PM_PIX 8
#define PM_TILE 256

__global__ void pedmap_kernel(const float* __restrict__ px,
                              const float* __restrict__ py,
                              const float* __restrict__ vx,
                              const float* __restrict__ vy, int m, float res,
                              float inv_res, float r_img, float r2, float half,
                              int hs, float* __restrict__ out) {
  __shared__ float s_rsq[PM_TILE], s_tx[PM_TILE], s_ty[PM_TILE];
  __shared__ float s_lox[PM_TILE], s_hix[PM_TILE], s_loy[PM_TILE],
      s_hiy[PM_TILE];
  __shared__ float s_vx[PM_TILE], s_vy[PM_TILE];
  const int robot = blockIdx.x;
  const int tid = threadIdx.x;
  const int npix = hs * hs;
  const size_t row = (size_t)robot * m;

  float hf[PM_PIX], wf[PM_PIX], xc[PM_PIX], yc[PM_PIX];
  float best[PM_PIX], avx[PM_PIX], avy[PM_PIX];
#pragma unroll
  for (int k = 0; k < PM_PIX; ++k) {
    const int p = min(tid + k * PM_THREADS, npix - 1);
    hf[k] = (float)(p / hs);
    wf[k] = (float)(p % hs);
    xc[k] = __fmul_rn(__fadd_rn(hf[k], 0.5f), res);
    yc[k] = __fmul_rn(__fadd_rn(wf[k], 0.5f), res);
    best[k] = -1.f;
    avx[k] = 0.f;
    avy[k] = 0.f;
  }

  for (int base = 0; base < m; base += PM_TILE) {
    const int cnt = min(PM_TILE, m - base);
    __syncthreads();
    if (tid < cnt) {
      const float x = px[row + base + tid], y = py[row + base + tid];
      const bool in_w = x <= half && x >= -half && y <= half && y >= -half;
      const float tx = in_w ? __fadd_rn(-x, half) : 1e9f;
      const float ty = __fadd_rn(-y, half);
      s_rsq[tid] = __fmaf_rn(x, x, __fmul_rn(y, y));
      s_tx[tid] = tx;
      s_ty[tid] = ty;
      s_lox[tid] = floorf(__fmul_rn(__fsub_rn(tx, r_img), inv_res));
      s_hix[tid] = floorf(__fmul_rn(__fadd_rn(tx, r_img), inv_res));
      s_loy[tid] = floorf(__fmul_rn(__fsub_rn(ty, r_img), inv_res));
      s_hiy[tid] = floorf(__fmul_rn(__fadd_rn(ty, r_img), inv_res));
      s_vx[tid] = vx[row + base + tid];
      s_vy[tid] = vy[row + base + tid];
    }
    __syncthreads();
    for (int i = 0; i < cnt; ++i) {
      const float lox = s_lox[i], hix = s_hix[i], loy = s_loy[i],
                  hiy = s_hiy[i];
      const float tx = s_tx[i], ty = s_ty[i], rsq = s_rsq[i];
#pragma unroll
      for (int k = 0; k < PM_PIX; ++k) {
        if (hf[k] >= lox && hf[k] < hix && wf[k] >= loy && wf[k] < hiy) {
          const float dx = __fsub_rn(xc[k], tx);
          const float dy = __fsub_rn(yc[k], ty);
          const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
          if (d2 < r2 && rsq >= best[k]) {
            best[k] = rsq;
            avx[k] = s_vx[i];
            avy[k] = s_vy[i];
          }
        }
      }
    }
  }

  float* o = out + (size_t)robot * 3 * npix;
#pragma unroll
  for (int k = 0; k < PM_PIX; ++k) {
    const int p = tid + k * PM_THREADS;
    if (p < npix) {
      const bool occ = best[k] >= 0.f;
      o[p] = occ ? 1.f : 0.f;
      o[npix + p] = occ ? avx[k] : 0.f;
      o[2 * npix + p] = occ ? avy[k] : 0.f;
    }
  }
}

// px/py/vx/vy [n, m] f32 base-frame ped positions and velocities (unsorted);
// out [n, 3, hs, hs] f32.  hs * hs <= PM_THREADS * PM_PIX.
extern "C" int img_env_ped_map(const float* px, const float* py,
                               const float* vx, const float* vy, int n, int m,
                               float res, float inv_res, float r_img,
                               float r2, float half, int hs, float* out,
                               cudaStream_t stream) {
  if (hs * hs > PM_THREADS * PM_PIX) return (int)cudaErrorInvalidValue;
  if (n > 0)
    pedmap_kernel<<<n, PM_THREADS, 0, stream>>>(px, py, vx, vy, m, res,
                                                inv_res, r_img, r2, half, hs,
                                                out);
  return (int)cudaGetLastError();
}
