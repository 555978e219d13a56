// K5: exact laser view-map painter over the gen-1 64-slot block layout.
//
// Replaces the Pallas TPU kernel img_env_tpu/ops/pallas_paint.py
// (paint_sorted_pallas / _paint_class, one pallas_call per window-width
// class), whose pairing of two 64-slot blocks into 128 lanes, 32-robot
// unrolled loop and aliased class-by-class accumulator are TPU grid
// artifacts; its dense near-sensor "wide" slots run there on the XLA path.
//
// Semantics: the same view map as K3 (csrc/paint.cu, agent.cpp:511-624).
// For slot j of a block whose beam window starts at beam rb, window
// position w reads T = step+1 of the visit (0 = not visited) and the
// thresholds of beam min(rb + w, R - 1); code 2 (T <= s_hit) -> 255, code
// 3 (T == s_hit + 1) -> 0, code 1 (T > s_tail) -> 200, else no write.  The
// max of (w << 2) | code over the window picks the last writing beam and
// its value; no writer -> 200.  Integer arithmetic only: bit-equal to the
// twin (ops/painter.py paint_sorted, the dense decode over regions).
//
// What bounds it on the H100: integer compare/select over the blocks'
// window entries (64 slots x W beams per block, read once per 32 robots)
// and broadcast reads of the transposed s_hit / s_tail rows, which stay in
// L1/L2.  Design: a block of 64 x 4 threads per (64-slot block, 32-robot
// chunk); a thread owns one slot and 8 robots, keeps their 8 running max
// keys in registers, and reads each window entry once for all 8.  The warp
// shares its 8 robots, so each threshold read is a broadcast.  One launch
// covers every block: the gen-1 regions' blocks, packs of 64 near-sensor
// "wide" slots over all beams (painted here rather than on a separate
// pass), and the constant-200 regions (window width 0).  Each slot is
// written by exactly one block, straight into slot order.

#include <cuda_runtime.h>
#include <stdint.h>

#define PB_SLOTS 64
#define PB_GROUPS 4
#define PB_RPT 8
#define PB_ROBOTS (PB_GROUPS * PB_RPT)

__device__ __forceinline__ float pb_decode(int key) {
  if (key < 0) return 200.f;
  const int c = key & 3;
  return c == 2 ? 255.f : (c == 3 ? 0.f : 200.f);
}

__global__ void paint_blocks_kernel(const int* __restrict__ sh_t,
                                    const int* __restrict__ st_t, int n,
                                    int n_beams,
                                    const int* __restrict__ blk_slots,
                                    const int* __restrict__ blk_rb,
                                    const int* __restrict__ blk_w,
                                    const long long* __restrict__ blk_off,
                                    const short* __restrict__ table,
                                    float* __restrict__ out, int n_slots) {
  const int blk = blockIdx.x;
  const int j = threadIdx.x;
  const int r0 = blockIdx.y * PB_ROBOTS + threadIdx.y * PB_RPT;
  const int rb = blk_rb[blk], wlen = blk_w[blk];
  const short* t = table + blk_off[blk] * PB_SLOTS + j;
  int rr[PB_RPT], acc[PB_RPT];
#pragma unroll
  for (int k = 0; k < PB_RPT; ++k) {
    rr[k] = min(r0 + k, n - 1);
    acc[k] = -1;
  }
  for (int wp = 0; wp < wlen; ++wp) {
    const int T = t[(size_t)wp * PB_SLOTS];
    if (T <= 0) continue;
    const size_t beam = (size_t)min(rb + wp, n_beams - 1) * n;
#pragma unroll
    for (int k = 0; k < PB_RPT; ++k) {
      const int sh = sh_t[beam + rr[k]];
      const int st = st_t[beam + rr[k]];
      const int code = T <= sh ? 2 : (T == sh + 1 ? 3 : (T > st ? 1 : 0));
      if (code) acc[k] = max(acc[k], (wp << 2) | code);
    }
  }
  const int slot = blk_slots[(size_t)blk * PB_SLOTS + j];
  if (slot < 0) return;
#pragma unroll
  for (int k = 0; k < PB_RPT; ++k)
    if (r0 + k < n) out[(size_t)(r0 + k) * n_slots + slot] = pb_decode(acc[k]);
}

// sh_t/st_t [n_beams, n] int32 (transposed s_hit / s_tail); blocks: slots
// [nb, 64] int32 (-1 = none), window start rb [nb], width w [nb], table
// offset off [nb] (in units of 64 int16), table [sum(w), 64] int16 visit
// step+1 (0 = not visited); out [n, n_slots] f32, every slot written by one
// block.
extern "C" int img_env_paint_blocks(const int* sh_t, const int* st_t, int n,
                                    int n_beams, const int* blk_slots,
                                    const int* blk_rb, const int* blk_w,
                                    const long long* blk_off,
                                    const short* table, int n_blocks,
                                    float* out, int n_slots,
                                    cudaStream_t stream) {
  if (n > 0 && n_blocks > 0) {
    dim3 block(PB_SLOTS, PB_GROUPS);
    dim3 grid(n_blocks, (n + PB_ROBOTS - 1) / PB_ROBOTS);
    paint_blocks_kernel<<<grid, block, 0, stream>>>(
        sh_t, st_t, n, n_beams, blk_slots, blk_rb, blk_w, blk_off, table, out,
        n_slots);
  }
  return (int)cudaGetLastError();
}
