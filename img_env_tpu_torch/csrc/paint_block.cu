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
// position wp holds T = step+1 of the visit (0 = not visited), read against
// the thresholds of beam min(rb + wp, R - 1): code 2 (T <= s_hit) -> 255,
// code 3 (T == s_hit + 1) -> 0, code 1 (T > s_tail) -> 200, else no write.
// The twin max-reduces (wp << 2) | code over the window; a slot's visits
// have distinct window positions, so the first writing visit in descending
// window order is that maximum.  No writer -> 200.  Integer arithmetic
// only: bit-equal to the twin (ops/painter.py paint_sorted, the dense
// decode over regions).
//
// What bounds it on the H100: output bytes.  At bench200 the output is 200
// robots x 176,128 slots x 4 B = 140.9 MB, half of it in the constant-200
// blocks (window width 0); the dense int16 window tables (5.98 MB, of which
// 6.4% are visits) and s_hit / s_tail (0.77 MB) add ~7.5 MB, so the least
// time is ~44 us at 3.35 TB/s.  The kernel this replaces (a thread per slot
// and 8 robots walking every window position in ascending order, two
// global threshold loads per visit and robot) took 0.94 ms.
//
// Design: one launch; a block of 256 threads takes one 64-slot block (the
// layout lists the widest windows first, so the long ones start first) and
// a chunk of robots (the grid's fast index): 64, or 4 for a wide window.
//  * A constant-200 block (w = 0) reads no table and no thresholds: its
//    robots' 64 values are one contiguous 256 B run each, written as 16-byte
//    streaming stores (scalar stores where a slot is masked).
//  * Any other block compacts its table once for all 64 robots: each warp
//    takes w / 8 consecutive window positions (the first warp the highest),
//    its lanes two slots each as one int32 read per row (a warp reads a
//    whole 128 B row); a count pass, a prefix over (slot, warp) and a fill
//    pass leave each slot's visits in shared memory as (wp << 16) | T in
//    descending window order, ~140 per block at bench200 (at most 2,618).
//  * The block stages its robots' thresholds over the window in shared
//    memory, s_hit | s_tail << 16 in one int32, so a test costs one shared
//    read.  The few blocks with windows wider than 128 positions (at
//    bench200 the 1024-wide blocks, the 960-wide pack of wide slots and
//    four of 256) take 4 robots at a time, so that their thresholds fit
//    and their long walks spread over many blocks; they come first.
//  * The walk: a thread owns one slot and every fourth robot of the chunk.
//    Per robot it tests the slot's first and second visits; a slot they
//    leave undecided is walked by the whole warp, 32 visits a step, the
//    lowest writing lane deciding (warp ballot), as in K3.  Stores are
//    streaming: a warp writes 128 contiguous bytes of one robot's row.

#include <cuda_runtime.h>
#include <stdint.h>

#define PB_SLOTS 64
#define PB_THREADS 256
#define PB_WARPS (PB_THREADS / 32)
#define PB_GROUPS (PB_THREADS / PB_SLOTS)     // robots walked side by side
#define PB_ROBOTS 64                          // robots per block
#define PB_WIDE_ROBOTS PB_GROUPS              // robots per wide block
#define FULL_MASK 0xffffffffu

// value written by a visit with step+1 T under the packed thresholds
// th = s_hit | s_tail << 16, or -1 (no write)
__device__ __forceinline__ float pb_value(int T, int th) {
  const int h = (short)(th & 0xFFFF);
  if (T <= h) return 255.f;
  if (T == h + 1) return 0.f;
  return T > (th >> 16) ? 200.f : -1.f;
}

__device__ __forceinline__ int pb_pack(const short* s_hit,
                                       const short* s_tail, size_t g) {
  return (int)(unsigned short)s_hit[g] |
         (int)((unsigned)(unsigned short)s_tail[g] << 16);
}

// a constant-200 block: every robot of the chunk reads 200 in every slot
__device__ void paint_constant(const int* slots, int r0, int nr,
                               float* __restrict__ out, int n_slots) {
  const int t = threadIdx.x, s0 = slots[0];
  const bool run = __syncthreads_and(t >= PB_SLOTS || slots[t] == s0 + t) &&
                   (s0 & 3) == 0 && (n_slots & 3) == 0;
  if (run) {
    const float4 v = make_float4(200.f, 200.f, 200.f, 200.f);
    for (int q = t; q < nr * (PB_SLOTS / 4); q += PB_THREADS) {
      const int rr = q / (PB_SLOTS / 4), c = q % (PB_SLOTS / 4);
      __stcs(reinterpret_cast<float4*>(out + (size_t)(r0 + rr) * n_slots + s0) + c, v);
    }
  } else {
    for (int q = t; q < nr * PB_SLOTS; q += PB_THREADS) {
      const int s = slots[q % PB_SLOTS];
      if (s >= 0) __stcs(out + (size_t)(r0 + q / PB_SLOTS) * n_slots + s, 200.f);
    }
  }
}

__global__ void __launch_bounds__(PB_THREADS)
paint_blocks_kernel(const short* __restrict__ s_hit,
                    const short* __restrict__ s_tail, int n, int n_beams,
                    int n_wide, int thr_ints,
                    const int* __restrict__ blk_slots,
                    const int* __restrict__ blk_rb,
                    const int* __restrict__ blk_w,
                    const long long* __restrict__ blk_off,
                    const short* __restrict__ table,
                    float* __restrict__ out, int n_slots) {
  extern __shared__ int smem[];
  int* thr = smem;                        // [robots][w] packed thresholds
  int* list = smem + thr_ints;            // the block's visits, by slot
  __shared__ int cnt[PB_WARPS][PB_SLOTS];
  __shared__ int start[PB_SLOTS + 1];
  // work items: the n_wide widest blocks PB_WIDE_ROBOTS robots at a time,
  // then the others PB_ROBOTS robots at a time; robots are the fast index
  const int wide_chunks = (n + PB_WIDE_ROBOTS - 1) / PB_WIDE_ROBOTS;
  const bool wide = blockIdx.x < n_wide * wide_chunks;
  const int per = wide ? PB_WIDE_ROBOTS : PB_ROBOTS;
  const int chunks = wide ? wide_chunks : (n + PB_ROBOTS - 1) / PB_ROBOTS;
  const int item = wide ? blockIdx.x : blockIdx.x - n_wide * wide_chunks;
  const int blk = (wide ? 0 : n_wide) + item / chunks;
  const int r0 = (item % chunks) * per;
  const int nr = min(per, n - r0);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int w = blk_w[blk], rb = blk_rb[blk];
  const int* slots = blk_slots + (size_t)blk * PB_SLOTS;
  if (w == 0) {
    paint_constant(slots, r0, nr, out, n_slots);
    return;
  }

  for (int q = t; q < nr * w; q += PB_THREADS) {
    const int rr = q / w, wp = q - rr * w;
    thr[q] = pb_pack(s_hit, s_tail,
                     (size_t)(r0 + rr) * n_beams + min(rb + wp, n_beams - 1));
  }
  // compaction: warp k scans rows [lo, hi) downwards, lane l slots 2l, 2l+1
  const int span = (w + PB_WARPS - 1) / PB_WARPS;
  const int hi = max(w - warp * span, 0), lo = max(hi - span, 0);
  const int* rows =
      reinterpret_cast<const int*>(table + (size_t)blk_off[blk] * PB_SLOTS) + lane;
  int c0 = 0, c1 = 0;
#pragma unroll 4
  for (int row = hi - 1; row >= lo; --row) {
    const int v = __ldg(rows + (size_t)row * (PB_SLOTS / 2));
    c0 += (v & 0xFFFF) != 0;
    c1 += (v >> 16) != 0;
  }
  cnt[warp][2 * lane] = c0;
  cnt[warp][2 * lane + 1] = c1;
  __syncthreads();
  if (warp == 0) {        // offsets: slot-major, then warp by warp
    int tot[2];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      int run = 0;
#pragma unroll
      for (int k = 0; k < PB_WARPS; ++k) {
        const int c = cnt[k][2 * lane + s];
        cnt[k][2 * lane + s] = run;
        run += c;
      }
      tot[s] = run;
    }
    int incl = tot[0] + tot[1];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(FULL_MASK, incl, d);
      if (lane >= d) incl += y;
    }
    start[2 * lane] = incl - tot[0] - tot[1];
    start[2 * lane + 1] = incl - tot[1];
    if (lane == 31) start[PB_SLOTS] = incl;
  }
  __syncthreads();
  {
    int p0 = start[2 * lane] + cnt[warp][2 * lane];
    int p1 = start[2 * lane + 1] + cnt[warp][2 * lane + 1];
#pragma unroll 4
    for (int row = hi - 1; row >= lo; --row) {
      const int v = __ldg(rows + (size_t)row * (PB_SLOTS / 2));
      if (v & 0xFFFF) list[p0++] = (row << 16) | (v & 0xFFFF);
      if (v >> 16) list[p1++] = (row << 16) | ((v >> 16) & 0xFFFF);
    }
  }
  __syncthreads();

  // the walk: slot j, robots grp, grp + 4, ... (one robot per warp a turn)
  const int j = t % PB_SLOTS, grp = t / PB_SLOTS;
  const int a = start[j], b = start[j + 1];
  const int first = a < b ? list[a] : 0, second = a + 1 < b ? list[a + 1] : 0;
  const int slot = slots[j];
  for (int rr = grp; rr < nr; rr += PB_GROUPS) {
    const int r = r0 + rr;
    const int* th = thr + rr * w;
    auto value = [&](int pk) { return pb_value(pk & 0xFFFF, th[pk >> 16]); };
    float v = 200.f;
    bool pend = false;
    if (a < b) {
      float x = value(first);
      if (x < 0.f && a + 1 < b) x = value(second);
      if (x >= 0.f) v = x;
      else pend = a + 2 < b;
    }
    for (unsigned todo = __ballot_sync(FULL_MASK, pend); todo;
         todo &= todo - 1) {
      const int src = __ffs(todo) - 1;
      const int e0 = __shfl_sync(FULL_MASK, a, src) + 2;
      const int e1 = __shfl_sync(FULL_MASK, b, src);
      float res = 200.f;                        // no writer
      for (int e = e0; e < e1; e += 32) {
        const float x = e + lane < e1 ? value(list[e + lane]) : -1.f;
        const unsigned wr = __ballot_sync(FULL_MASK, x >= 0.f);
        if (wr) {
          res = __shfl_sync(FULL_MASK, x, __ffs(wr) - 1);
          break;
        }
      }
      if (lane == src) v = res;
    }
    if (slot >= 0) __stcs(out + (size_t)r * n_slots + slot, v);
  }
}

// s_hit / s_tail [n, n_beams] int16; blocks, widest window first: slots
// [nb, 64] int32 (-1 = none), window start rb [nb], width w [nb], table
// offset off [nb] (in units of 64 int16), table [sum(w), 64] int16 visit
// step+1 (0 = not visited); the first n_wide blocks have windows of at most
// wide_w positions, the others of at most narrow_w; cap >= the visits of
// any one block; out [n, n_slots] f32, every slot written by one block.
extern "C" int img_env_paint_blocks(const short* s_hit, const short* s_tail,
                                    int n, int n_beams, const int* blk_slots,
                                    const int* blk_rb, const int* blk_w,
                                    const long long* blk_off,
                                    const short* table, int n_blocks,
                                    int n_wide, int wide_w, int narrow_w,
                                    int cap, float* out, int n_slots,
                                    cudaStream_t stream) {
  if (n <= 0 || n_blocks <= 0) return 0;
  if (n_wide < 0 || n_wide > n_blocks) return (int)cudaErrorInvalidValue;
  const int thr_ints = max(PB_WIDE_ROBOTS * wide_w, PB_ROBOTS * narrow_w);
  const size_t smem = ((size_t)thr_ints + cap) * sizeof(int);
  // past 48 KB a block's shared memory, the kernel's static arrays
  // counted, needs the opt-in attribute
  cudaFuncAttributes fa;
  int err = (int)cudaFuncGetAttributes(&fa, paint_blocks_kernel);
  if (err) return err;
  if (smem + fa.sharedSizeBytes > 48 * 1024) {
    err = (int)cudaFuncSetAttribute(
        paint_blocks_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err) return err;
  }
  const long long items =
      (long long)n_wide * ((n + PB_WIDE_ROBOTS - 1) / PB_WIDE_ROBOTS) +
      (long long)(n_blocks - n_wide) * ((n + PB_ROBOTS - 1) / PB_ROBOTS);
  paint_blocks_kernel<<<(unsigned)items, PB_THREADS, smem, stream>>>(
      s_hit, s_tail, n, n_beams, n_wide, thr_ints, blk_slots, blk_rb, blk_w,
      blk_off, table, out, n_slots);
  return (int)cudaGetLastError();
}
