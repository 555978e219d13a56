// K3: exact laser view-map painter over slot-order tiles.
//
// Replaces the Pallas TPU kernel img_env_tpu/ops/pallas_paint_t.py
// (paint_sorted_pallas_t / _paint_t_kernel, one pallas_call per width
// class), whose robots-in-lanes layout, width buckets, 128-robot chunks and
// class-major output (reordered afterwards by inv_idx) are TPU grid
// artifacts; its dense "wide" near-sensor rows run there on the XLA path.
//
// Semantics (agent.cpp:511-624): per robot and slot, the highest-index beam
// whose Bresenham walk visits the slot and writes decides the value.  With
// T = step+1 of the visit, code 2 (T <= s_hit, before the hit) -> 255, code
// 3 (T == s_hit + 1, the hit) -> 0, code 1 (T > s_tail, after the
// minor-run) -> 200, code 0 -> no write; no writer -> 200 (CELL_UNSEEN).
// The twin max-reduces the key (beam << 2) | code over the visitors; a
// slot's visitors have distinct beams, so the first writing visitor in
// descending beam order is that maximum.  Integer arithmetic only:
// bit-equal to the twin (ops/painter.py paint_sorted).
//
// What bounds it on the H100: output bytes.  At bench200 the output is
// 200 robots x 176,128 slots x 4 B = 140.9 MB; the inputs (s_hit / s_tail
// int16 [200, 960], 0.77 MB; the slot offsets, 0.70 MB; 192,718 packed
// visits, 0.77 MB) add 2.2 MB, so the least time is ~43 us at 3.35 TB/s.
// The work is ~79 k visit tests per robot (each a threshold read and at
// most three integer compares), far below the byte bound.  The slot-row
// kernel this replaces took 0.94 ms: a warp per row and 32 robots walked
// every beam of the row's window serially (two dense rows over all 960
// beams alone took 0.31 ms), and each store touched 32 robots' rows.
//
// Design: the layout (painter.PaintSlots) lists, per slot in slot order,
// the visiting beams in descending order as (beam << 16) | T (CSR offsets
// per slot).  A block of 256 threads owns a tile of 1024 consecutive slots
// and a chunk of 4 robots; the robot chunk is the grid's fast index, so
// the heavy near-sensor tiles (the first in slot order) run first and the
// empty tiles last.  Each thread owns 4 consecutive slots and reads their
// offsets and first two visits once; the block finds the tile's beam range
// (each slot's first and last visit bound it) and stages its robots' s_hit
// / s_tail over that range in shared memory, packed into one int32 per
// beam, so a test costs one shared-memory read.  Per robot a thread tests
// each slot's first (highest) visit, which decides at least 97% of (robot,
// visited slot) pairs at bench200 (78,821 tests per robot for 76,731
// visited slots), then its second; slots no beam visits get 200 with no
// test.  The slots still undecided in a warp are then walked one at a time
// by all 32 lanes together, 32 visits per step with the next step's visits
// already loading, the lowest writing lane deciding (warp ballot): a
// near-sensor slot with 960 visitors, or a slot behind a robot's hit whose
// top beams all fall in their minor runs, costs a few steps instead of a
// serial walk.  Each thread stores its 4 values as one 16-byte streaming
// store: a warp writes 512 contiguous bytes of one robot's row.  At
// bench200 the stores alone (no visit tested) take ~0.051 ms.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

#define PAINT_THREADS 256
#define PAINT_WARPS (PAINT_THREADS / 32)
#define PAINT_SPT 4                               // slots per thread
#define PAINT_TILE (PAINT_THREADS * PAINT_SPT)    // slots per block
#define PAINT_ROBOTS 4                            // robots per block
#define FULL_MASK 0xffffffffu

// value written by visit pk = (beam << 16) | T under the packed thresholds
// th[beam] = s_hit | s_tail << 16, or -1 (no write)
__device__ __forceinline__ float visit_value(int pk, const int* th) {
  const int t = th[pk >> 16], T = pk & 0xFFFF;
  const int h = (short)(t & 0xFFFF);
  if (T <= h) return 255.f;
  if (T == h + 1) return 0.f;
  return T > (t >> 16) ? 200.f : -1.f;
}

__global__ void __launch_bounds__(PAINT_THREADS)
paint_slots_kernel(const short* __restrict__ s_hit,
                   const short* __restrict__ s_tail, int n, int n_beams,
                   const int* __restrict__ slot_off,
                   const int* __restrict__ visits, float* __restrict__ out,
                   int n_slots) {
  extern __shared__ int thr[];            // [robots][span] packed thresholds
  __shared__ int red[2][PAINT_WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j0 = blockIdx.y * PAINT_TILE + threadIdx.x * PAINT_SPT;
  const bool live = j0 < n_slots;         // every lane stays for the ballots
  int lo[PAINT_SPT + 1], first[PAINT_SPT], second[PAINT_SPT];
  int bmin = INT_MAX, bmax = -1;
#pragma unroll
  for (int k = 0; k <= PAINT_SPT; ++k) lo[k] = live ? __ldg(slot_off + j0 + k) : 0;
#pragma unroll
  for (int k = 0; k < PAINT_SPT; ++k) {
    first[k] = 0;
    second[k] = 0;
    if (lo[k] < lo[k + 1]) {
      first[k] = __ldg(visits + lo[k]);
      if (lo[k] + 1 < lo[k + 1]) second[k] = __ldg(visits + lo[k] + 1);
      bmax = max(bmax, first[k] >> 16);
      bmin = min(bmin, __ldg(visits + lo[k + 1] - 1) >> 16);
    }
  }
  bmin = __reduce_min_sync(FULL_MASK, bmin);
  bmax = __reduce_max_sync(FULL_MASK, bmax);
  if (lane == 0) {
    red[0][warp] = bmin;
    red[1][warp] = bmax;
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < PAINT_WARPS; ++q) {
    bmin = min(bmin, red[0][q]);
    bmax = max(bmax, red[1][q]);
  }
  const int span = bmax >= bmin ? bmax - bmin + 1 : 0;
  if (!span) bmin = 0;                          // a tile no beam visits
  const int r0 = blockIdx.x * PAINT_ROBOTS;
  const int nr = min(PAINT_ROBOTS, n - r0);
  for (int q = threadIdx.x; q < nr * span; q += PAINT_THREADS) {
    const int rr = q / span;
    const size_t g = (size_t)(r0 + rr) * n_beams + bmin + (q - rr * span);
    thr[q] = (int)(unsigned short)s_hit[g] |
             (int)((unsigned)(unsigned short)s_tail[g] << 16);
  }
  __syncthreads();

  for (int rr = 0; rr < nr; ++rr) {
    const int* th = thr + rr * span - bmin;     // indexed by beam
    float v[PAINT_SPT];
    unsigned pend = 0;                          // slots still undecided
#pragma unroll
    for (int k = 0; k < PAINT_SPT; ++k) {
      v[k] = 200.f;
      if (lo[k] < lo[k + 1]) {
        float x = visit_value(first[k], th);
        if (x < 0.f && lo[k] + 1 < lo[k + 1]) x = visit_value(second[k], th);
        if (x >= 0.f) v[k] = x;
        else if (lo[k] + 2 < lo[k + 1]) pend |= 1u << k;
      }
    }
    for (unsigned todo = __ballot_sync(FULL_MASK, pend != 0); todo;
         todo = __ballot_sync(FULL_MASK, pend != 0)) {
      const int src = __ffs(todo) - 1;
      const int k = __ffs(pend) - 1;            // meaningful on lane src
      int a = 0, b = 0;
#pragma unroll
      for (int q = 0; q < PAINT_SPT; ++q)
        if (q == k) { a = lo[q] + 2; b = lo[q + 1]; }
      a = __shfl_sync(FULL_MASK, a, src);
      b = __shfl_sync(FULL_MASK, b, src);
      float res = 200.f;                        // no writer
      int nxt = a + lane < b ? __ldg(visits + a + lane) : 0;
      for (int e0 = a; e0 < b; e0 += 32) {
        const int e = e0 + lane;
        const int cur = nxt;
        nxt = e + 32 < b ? __ldg(visits + e + 32) : 0;
        const float x = e < b ? visit_value(cur, th) : -1.f;
        const unsigned wr = __ballot_sync(FULL_MASK, x >= 0.f);
        if (wr) {
          res = __shfl_sync(FULL_MASK, x, __ffs(wr) - 1);
          break;
        }
      }
      if (lane == src) {
#pragma unroll
        for (int q = 0; q < PAINT_SPT; ++q)
          if (q == k) v[q] = res;
        pend &= pend - 1;
      }
    }
    if (live)
      __stcs(reinterpret_cast<float4*>(out + (size_t)(r0 + rr) * n_slots + j0),
             make_float4(v[0], v[1], v[2], v[3]));
  }
}

// s_hit / s_tail [n, n_beams] int16; slot_off [n_slots + 1] int32 CSR
// offsets into visits [nv] int32 (beam << 16) | (step + 1), each slot's
// visits in descending beam order; out [n, n_slots] f32, n_slots a multiple
// of 4.
extern "C" int img_env_paint_slots(const short* s_hit, const short* s_tail,
                                   int n, int n_beams, const int* slot_off,
                                   const int* visits, float* out, int n_slots,
                                   cudaStream_t stream) {
  if (n <= 0 || n_slots <= 0) return 0;
  const size_t smem = (size_t)PAINT_ROBOTS * n_beams * sizeof(int);
  // past 48 KB a block's shared memory, the kernel's static arrays
  // counted, needs the opt-in attribute
  cudaFuncAttributes fa;
  int err = (int)cudaFuncGetAttributes(&fa, paint_slots_kernel);
  if (err) return err;
  if (smem + fa.sharedSizeBytes > 48 * 1024) {
    err = (int)cudaFuncSetAttribute(
        paint_slots_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err) return err;
  }
  dim3 grid((n + PAINT_ROBOTS - 1) / PAINT_ROBOTS,
            (n_slots + PAINT_TILE - 1) / PAINT_TILE);
  paint_slots_kernel<<<grid, PAINT_THREADS, smem, stream>>>(
      s_hit, s_tail, n, n_beams, slot_off, visits, out, n_slots);
  return (int)cudaGetLastError();
}
