// K2: FOV fill of the sorted view slots from the id-packed world map.
//
// Replaces the Pallas TPU kernel img_env_tpu/ops/pallas_fill.py
// (fill_values_pallas / _fill_kernel, entered via fill_sorted_pallas),
// which turns the pose-dependent gather into block slices of a
// VMEM-resident decoded map plus int8 one-hot MXU contractions, because
// scalar gathers are slow on the TPU.
//
// Per robot i and gated slot j: rotate and translate the slot's base-frame
// coordinate by the pose, round half away from zero to a cell (m, n), and
// decode the packed map of scene i / nps there with self-exclusion
// (polar.decode_packed, rid = i % nps + 1, or rids[i] where the caller
// passes in-scene ids: a sensor group's robots are a subset of their
// scene's, each excluded by its own id); out-of-map cells and the
// ungated suffix [n_fill, n_slots) are 0.  The decode splits as
//   decode(v, rid) = anyocc(v) & ~own(v, rid),
//   anyocc(v) = static | count != 0,
//   own(v, rid) = ~static & count == 1 & id == rid,
// and own cells are cells robot rid alone covers.
//
// What bounds it on the H100: output bytes set its least time (the kernel
// itself is held back by instruction issue, below).  At bench200 the
// output is 200 robots x 176,128 slots x 1 B = 35.2 MB; the packed map
// (1066^2 x 4 B = 4.5 MB) and the gated prefix's slot coordinates (92,672
// x 8 B = 0.74 MB; the suffix is written as 0 unread) add 5.3 MB, so the
// least time is ~12.1 us at 3.35 TB/s.  Counted as ~10 f32 operations
// per gated slot (18.5 M slots), the arithmetic is far below it.  The
// kernel this replaces (one thread per (robot, slot), one scattered int32
// map read and one byte store each) took 0.114 ms: each thread waited on
// its own dependent gather.
//
// Design: two kernels in one launch call.
//  1. occupancy_bits_kernel packs anyocc into a bitmap [S, h, words]
//     (words = 4 * ceil(w / 128), rows padded to 16 bytes; bit k of word q
//     is cell q * 32 + k): a warp reads 4 words' cells, 4 loads in flight
//     per lane, and packs each word with a ballot; 4.5 MB read and 153 KB
//     written at 1066^2.
//  2. fill_bits_kernel: one block of 1024 threads per SM and scene stages
//     the scene's bitmap in shared memory with 16-byte loads (when it fits
//     the 227 KB a block may use; else it reads the bitmap through L1) and
//     loops over work items (chunk of 8,192 slots, robot), chunk-major so
//     that every block gets its share of gated chunks.  A thread owns 8
//     consecutive slots, 4 at a time: it reads their coordinates as
//     float4s, tests one bit per slot (no branch: the out-of-map test and
//     the bit select a predicated load), reads the packed map only where
//     the bit is set (~9% of gated slots at bench200) to apply own(), and
//     stores the 8 bytes as one streaming store: a warp writes 256
//     contiguous bytes of one robot's row.  Rounding half away from zero is
//     trunc(x + copysign(0.5, x)): one add and one conversion, equal to
//     floor(x + 0.5) / ceil(x - 0.5).
//  At bench200 the slot arithmetic (two rotations, two roundings, the
//  bounds, bit and id tests, for 18.5 M gated slots) dominates: the kernel
//  is bound by instruction issue, not by its bytes (tools/kernel_ablations.py
//  times it without the map reads and without the arithmetic).

// The coordinate math uses explicit round-to-nearest intrinsics, so nvcc
// contracts nothing on its own: the rotation is exactly the form XLA's CPU
// build computes for the JAX package, fma(c, bx, -(s*by)) + px and
// fma(s, bx, c*by) + py (one fused multiply-add on the other product, then
// the translation), as the plain torch twin computes it, so a coordinate
// on a cell border lands in the same cell.  "/ res" is a product with the
// f32 reciprocal inv_res, which is how XLA compiles the JAX package's
// division by the constant resolution.

#include <cuda_runtime.h>
#include <stdint.h>

#define BITS_THREADS 256
#define FILL_THREADS 1024
#define FILL_SPT 8                                // slots per thread
#define FILL_CHUNK (FILL_THREADS * FILL_SPT)      // slots per work item

// bits[q] for q = 4 consecutive words of one row (words is a multiple of
// 4): lane l of the warp reads cell q * 32 + l of each, a ballot packs it.
__global__ void occupancy_bits_kernel(const int* __restrict__ packed,
                                      long long rows, int w, int words,
                                      unsigned* __restrict__ bits) {
  const long long q0 =
      (((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5) * 4;
  if (q0 >= rows * words) return;                   // whole warps
  const int lane = threadIdx.x & 31;
  const long long row = q0 / words;
  const int col0 = (int)(q0 - row * words) * 32 + lane;
  const int* src = packed + row * w;
  int v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = col0 + 32 * k < w ? __ldg(src + col0 + 32 * k) : 0;
  unsigned b[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    b[k] = __ballot_sync(0xffffffffu, ((v[k] & 1) | ((v[k] >> 1) & 3)) != 0);
  if (lane == 0)
    *reinterpret_cast<uint4*>(bits + q0) = make_uint4(b[0], b[1], b[2], b[3]);
}

// round half away from zero, then to int: trunc(x + copysign(0.5, x))
__device__ __forceinline__ int round_half_away(float x) {
  return __float2int_rz(__fadd_rn(x, copysignf(0.5f, x)));
}

template <bool kStage>
__device__ __forceinline__ unsigned fill_one(
    float bx, float by, float c, float s, float x0, float y0, float inv_res,
    int h, int w, int words, const unsigned* staged,
    const unsigned* __restrict__ bits, const int* __restrict__ map, int rid) {
  const float wx = __fadd_rn(__fmaf_rn(c, bx, -__fmul_rn(s, by)), x0);
  const float wy = __fadd_rn(__fmaf_rn(s, bx, __fmul_rn(c, by)), y0);
  const int cm = round_half_away(__fmul_rn(wx, inv_res));
  const int cn = round_half_away(__fmul_rn(wy, inv_res));
  const bool in = (unsigned)cm < (unsigned)h && (unsigned)cn < (unsigned)w;
  const int q = in ? cm * words + (cn >> 5) : 0;
  const unsigned word = kStage ? staged[q] : __ldg(bits + q);
  const bool set = in && ((word >> (cn & 31)) & 1u);
  const int v = set ? __ldg(map + (size_t)cm * w + cn) : 1;
  const bool own = !(v & 1) && ((v >> 1) & 3) == 1 && ((v >> 3) & 0xFFF) == rid;
  return set && !own;
}

template <bool kStage>
__global__ void __launch_bounds__(FILL_THREADS, 1)
fill_bits_kernel(const unsigned* __restrict__ bits_g,
                 const int* __restrict__ packed, int h, int w, int words,
                 const float* __restrict__ cosv,
                 const float* __restrict__ sinv, const float* __restrict__ px,
                 const float* __restrict__ py,
                 const int* __restrict__ rids, int nps, int n_fill,
                 int n_slots, float inv_res, const float* __restrict__ pix_x,
                 const float* __restrict__ pix_y,
                 unsigned char* __restrict__ out) {
  extern __shared__ uint4 staged4[];
  const unsigned* staged = reinterpret_cast<const unsigned*>(staged4);
  const int scene = blockIdx.y;
  const size_t map_words = (size_t)h * words;       // a multiple of 4
  const unsigned* bits = bits_g + scene * map_words;
  if (kStage) {
    const uint4* src = reinterpret_cast<const uint4*>(bits);
#pragma unroll 4
    for (size_t k = threadIdx.x; k < map_words / 4; k += FILL_THREADS)
      staged4[k] = __ldg(src + k);
    __syncthreads();
  }
  const int* map = packed + (size_t)scene * h * w;
  const int items = nps * ((n_slots + FILL_CHUNK - 1) / FILL_CHUNK);
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int chunk = it / nps, local = it - chunk * nps;
    const int i = scene * nps + local;
    const int j0 = chunk * FILL_CHUNK + threadIdx.x * FILL_SPT;
    if (j0 >= n_slots) continue;
    uint2 res = make_uint2(0u, 0u);
    if (j0 < n_fill) {                  // n_fill % 8 == 0: all 8 gated
      const float c = cosv[i], s = sinv[i], x0 = px[i], y0 = py[i];
      const int rid = rids ? __ldg(rids + i) : local + 1;
#pragma unroll 1
      for (int q = 0; q < 2; ++q) {
        const float4 bx = __ldg(reinterpret_cast<const float4*>(pix_x + j0) + q);
        const float4 by = __ldg(reinterpret_cast<const float4*>(pix_y + j0) + q);
        const unsigned wq =
            fill_one<kStage>(bx.x, by.x, c, s, x0, y0, inv_res, h, w, words, staged, bits, map, rid) |
            fill_one<kStage>(bx.y, by.y, c, s, x0, y0, inv_res, h, w, words, staged, bits, map, rid) << 8 |
            fill_one<kStage>(bx.z, by.z, c, s, x0, y0, inv_res, h, w, words, staged, bits, map, rid) << 16 |
            fill_one<kStage>(bx.w, by.w, c, s, x0, y0, inv_res, h, w, words, staged, bits, map, rid) << 24;
        if (q == 0) res.x = wq; else res.y = wq;
      }
    }
    __stcs(reinterpret_cast<uint2*>(out + (size_t)i * n_slots + j0), res);
  }
}

// packed [S, h, w] int32; bits [S, h, 4 * ceil(w / 128)] int32 scratch
// that the pre-pass writes; cosv/sinv/px/py [n] f32 (robot i reads scene
// i / nps, n = S * nps); rids [n] int32 in-scene ids (1..4095) or null
// for i % nps + 1; pix_x/pix_y [n_slots] f32, 16-byte aligned, of
// which the gated prefix [0, n_fill) is filled; out [n, n_slots] bool
// (uint8); n_fill and n_slots multiples of 8.
extern "C" int img_env_fill_sorted(const int* packed, unsigned* bits,
                                   int scenes, int h, int w,
                                   const float* cosv, const float* sinv,
                                   const float* px, const float* py,
                                   const int* rids, int nps,
                                   int n_fill, int n_slots, float inv_res,
                                   const float* pix_x, const float* pix_y,
                                   unsigned char* out, cudaStream_t stream) {
  if (scenes <= 0 || nps <= 0 || n_slots <= 0 || h <= 0 || w <= 0) return 0;
  const int words = (w + 127) / 128 * 4;
  const long long rows = (long long)scenes * h;
  const long long threads = rows * words * 8;
  occupancy_bits_kernel<<<(unsigned)((threads + BITS_THREADS - 1) / BITS_THREADS),
                          BITS_THREADS, 0, stream>>>(packed, rows, w, words, bits);
  int err = (int)cudaGetLastError();
  if (err) return err;

  int dev = 0, n_sm = 0, smem_max = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const size_t smem = (size_t)h * words * sizeof(unsigned);
  const bool stage = smem <= (size_t)smem_max;
  if (stage && smem > 48 * 1024) {
    err = (int)cudaFuncSetAttribute(fill_bits_kernel<true>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)smem);
    if (err) return err;
  }
  const int items = nps * ((n_slots + FILL_CHUNK - 1) / FILL_CHUNK);
  int per_scene = (n_sm + scenes - 1) / scenes;
  if (per_scene > items) per_scene = items;
  dim3 grid(per_scene, scenes);
  if (stage)
    fill_bits_kernel<true><<<grid, FILL_THREADS, smem, stream>>>(
        bits, packed, h, w, words, cosv, sinv, px, py, rids, nps, n_fill,
        n_slots, inv_res, pix_x, pix_y, out);
  else
    fill_bits_kernel<false><<<grid, FILL_THREADS, 0, stream>>>(
        bits, packed, h, w, words, cosv, sinv, px, py, rids, nps, n_fill,
        n_slots, inv_res, pix_x, pix_y, out);
  return (int)cudaGetLastError();
}
