// The episode clearance field: the clipped Euclidean distance transform of
// the composed obstacle map that every reset computes (mpc/edt.py,
// edt2d_device), which the MPC cost reads.
//
// Replaces no pallas_call: the JAX package leaves this EDT
// (img_env_tpu/mpc/edt.py, edt2d_device) to XLA, which fuses its passes.
// Added because its plain-torch form (mpc/edt.py, edt2d_twin) issues
// ~1,400 small launches a map at 733^2 with clip 134 (a log-shift column
// pass, then 269 rounds of roll, compare, add, where and minimum over the
// map), which held the host, and the card behind it, through every scene
// redraw.  This kernel takes their place with one launch call.
//
// What it computes, for occupied [S, h, w] (uint8) and clip:
//   gv[i, j] = rows from (i, j) to the nearest occupied cell of column j
//              (+inf in an empty column),
//   g2       = min(gv, clip)^2,
//   d2[i, j] = min over |o| <= clip with 0 <= j - o < w of
//              g2[i, j - o] + o^2,
//   out      = sqrt(d2) * resolution, float32.
// Every intermediate is an integer no larger than clip^2 (d2 <= g2), exact
// in float32, so the order of the minima does not matter and the field is
// bit-equal to the twin's on the card: the square root correctly rounded
// (__fsqrt_rn) and the product with the float32 resolution rounded once
// (__fmul_rn), as torch's CUDA sqrt and mul with a scalar compute them.
//
// What bounds it on the H100: operations.  The full row window is
// h * w * (2 clip + 1) add/min pairs, 289 M operations at 733^2 and clip
// 134 (4.3 us at 67 T/s), 612 M at 1066^2 (9.1 us); its bytes are the map
// read once (1 B a cell) and the field written once (4 B a cell), 2.7 MB
// at 733^2 (0.8 us at 3.35 TB/s).
// Design: two kernels in one launch call, the second launched as a
// programmatic dependent of the first (Hopper's griddepcontrol).
//  1. edt_columns_kernel: a block per (strip of 32 columns, scene).  Its
//     warps pack the strip's occupancy into one shared word a row with a
//     ballot (h x 4 B), so the column pass reads shared memory only.  Each
//     thread owns one column of one of EDT_COL_WARPS row segments: it finds
//     its segment's first and last occupied row, takes the nearest occupied
//     rows above and below the segment from the other segments' (shared),
//     then sweeps down its rows once: at each occupied row (and at the
//     segment's end) it writes min(gv, clip)^2 of the rows since the last
//     one, whose nearest occupied rows above and below are now both known.
//     So each cell is stored once and nothing is read back.
//  2. edt_rows_kernel: a block per (row, scene) stages the row's g2 in
//     shared memory between clip cells of +inf on either side (no bounds
//     tests; an +inf candidate never wins), and each thread takes its
//     columns' minimum outward from o = 0, stopping at the first o whose o^2
//     reaches the minimum so far: no farther candidate can be smaller, so
//     the early stop changes no bit, and cells near an obstacle cost a few
//     rounds instead of 2 clip + 1.  It writes the field over the same row
//     of out: each block reads and writes only its own row.  It fills its
//     padding before it waits for the column pass.

#include <climits>
#include <cuda_runtime.h>
#include <math_constants.h>

#define EDT_COL_WARPS 32
#define EDT_ROW_THREADS 256

__device__ __forceinline__ bool bit_of(const unsigned* rows, int i,
                                       int lane) {
  return (rows[i] >> lane) & 1u;
}

// out[i, j] = min(gv, clip)^2 of column j; lets the row pass launch at once.
__global__ void __launch_bounds__(32 * EDT_COL_WARPS)
    edt_columns_kernel(const unsigned char* __restrict__ occ, int h, int w,
                       int clip, float* __restrict__ out) {
  extern __shared__ unsigned rows[];  // [h]: bit c = column j0 + c occupied
  __shared__ int seg_first[EDT_COL_WARPS][32], seg_last[EDT_COL_WARPS][32];
  asm volatile("griddepcontrol.launch_dependents;");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j = blockIdx.x * 32 + lane;
  const bool in_map = j < w;
  const size_t plane = (size_t)h * w;
  occ += blockIdx.y * plane;
  out += blockIdx.y * plane;

#pragma unroll 4
  for (int i = warp; i < h; i += EDT_COL_WARPS) {
    const unsigned b =
        __ballot_sync(0xffffffffu, in_map && occ[(size_t)i * w + j]);
    if (lane == 0) rows[i] = b;
  }
  __syncthreads();

  const int len = (h + EDT_COL_WARPS - 1) / EDT_COL_WARPS;
  const int r0 = min(h, warp * len), r1 = min(h, r0 + len);
  const int none_above = INT_MIN / 2, none_below = INT_MAX / 2;
  int first = none_below, last = none_above;
  for (int i = r0; i < r1; ++i)
    if (bit_of(rows, i, lane)) {
      first = min(first, i);
      last = i;
    }
  seg_first[warp][lane] = first;
  seg_last[warp][lane] = last;
  __syncthreads();
  if (!in_map) return;

  int above = none_above, below = none_below;
  for (int k = 0; k < warp; ++k) above = max(above, seg_last[k][lane]);
  for (int k = warp + 1; k < EDT_COL_WARPS; ++k)
    below = min(below, seg_first[k][lane]);
  // rows [start, next] lie between the occupied rows above and next: each
  // is written once, when next is found (or at the segment's end)
  int start = r0;
  for (int i = r0; i <= r1; ++i) {
    const int next = i < r1 ? (bit_of(rows, i, lane) ? i : -1) : below;
    if (next < 0) continue;
    for (int k = start; k < min(r1, next + 1); ++k) {
      const int g = min(min(k - above, next - k), clip);
      out[(size_t)k * w + j] = (float)(g * g);
    }
    above = next;
    start = next + 1;
  }
}

// out[i, :] = sqrt(d2[i, :]) * res from g2[i, :] in place.
__global__ void __launch_bounds__(EDT_ROW_THREADS)
    edt_rows_kernel(int h, int w, int clip, float res,
                    float* __restrict__ out) {
  extern __shared__ float row[];  // [clip + w + clip]
  out += ((size_t)blockIdx.y * h + blockIdx.x) * w;
  for (int k = threadIdx.x; k < clip; k += EDT_ROW_THREADS) {
    row[k] = CUDART_INF_F;
    row[clip + w + k] = CUDART_INF_F;
  }
  asm volatile("griddepcontrol.wait;" ::: "memory");
  for (int k = threadIdx.x; k < w; k += EDT_ROW_THREADS)
    row[clip + k] = out[k];
  __syncthreads();
  const float* g = row + clip;
  for (int j = threadIdx.x; j < w; j += EDT_ROW_THREADS) {
    float best = g[j];
    for (int o = 1; o <= clip; ++o) {
      const float o2 = (float)(o * o);
      if (o2 >= best) break;
      best = fminf(best, fminf(g[j - o], g[j + o]) + o2);
    }
    out[j] = __fmul_rn(__fsqrt_rn(best), res);
  }
}

static int allow_smem(const void* kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// occ [scenes, h, w] uint8 (bool), out [scenes, h, w] f32, 0 <= clip with
// clip^2 < 2^24; the wrapper (mpc/edt.py) checks that the column pass's h
// words and the row pass's w + 2 clip floats fit a block's shared memory.
// The column pass, then the row pass as its programmatic dependent: one
// launch call for every scene.
extern "C" int img_env_edt(const unsigned char* occ, int scenes, int h,
                           int w, int clip, float res, float* out,
                           cudaStream_t stream) {
  if (scenes <= 0 || h <= 0 || w <= 0) return 0;
  const size_t col_smem = (size_t)h * sizeof(unsigned);
  const size_t row_smem = ((size_t)w + 2 * (size_t)clip) * sizeof(float);
  int err = allow_smem((const void*)edt_columns_kernel, col_smem);
  if (err) return err;
  err = allow_smem((const void*)edt_rows_kernel, row_smem);
  if (err) return err;
  edt_columns_kernel<<<dim3((w + 31) / 32, scenes), 32 * EDT_COL_WARPS,
                       col_smem, stream>>>(occ, h, w, clip, out);
  err = (int)cudaGetLastError();
  if (err) return err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(h, scenes);
  cfg.blockDim = dim3(EDT_ROW_THREADS);
  cfg.dynamicSmemBytes = row_smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  void* args[] = {(void*)&h, (void*)&w, (void*)&clip, (void*)&res,
                  (void*)&out};
  err = (int)cudaLaunchKernelExC(&cfg, (const void*)edt_rows_kernel, args);
  if (err) return err;
  return (int)cudaGetLastError();
}
