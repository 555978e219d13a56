// K1: robot-footprint raster into the id-packed presence map.
//
// Replaces the Pallas TPU kernel img_env_tpu/ops/pallas_raster.py:105
// (robot_maps_pallas / _raster_kernel), which rasterizes each robot as an
// int8 one-hot MXU contraction over a [40, 256] block and accumulates
// ((r + 1) << 12) | 1 per covered cell in a VMEM-resident map, relying on
// the TPU's sequential grid for race-free read-modify-write.
//
// What bounds it on the H100: its bytes are the [H, W] int32 map (4.5 MB
// at 1066^2, written once) and the footprint cells (200 robots x ~900
// points); its work (~0.2 M point tests, ~0.1 M atomics) is small, so its
// time is the clear, load latency and launch gaps.  Measured on the
// earlier design (a cudaMemsetAsync, then one block per robot): the clear and its
// separate device operation took ~3 us of ~7, the raster kernel's ~3 us
// was mostly load latency; its corner pass (~0.3 us) and global atomics
// (~0.1 us) cost little.  A single cooperative launch with a grid barrier
// between the clear and the atomics was no faster (the barrier and the
// launch cost what the clear's own operation had).
// Design: two kernels, the second launched as a programmatic dependent
// (Hopper's griddepcontrol).  The clear kernel lets the raster kernel
// start at once and zeroes the map with 16-byte stores.  Meanwhile each
// raster block (one per robot) takes its robot's points into registers
// (up to RASTER_PRELOAD per thread), finds the robot's bounding-box corner
// (a warp min, then one shared atomicMin per warp) and deduplicates its
// cells in a shared 128x128-bit window (several 0.01 m points fall into
// one cell); only then does it wait for the clear to finish and add
// ((r + 1) << 12) | 1 with one global atomicAdd per distinct in-map cell.
// So the loads and the dedup overlap the clear, and the raster launch's
// latency hides behind it.  A scene batch is one launch: the clear covers
// every scene's map, the raster grid has a block per robot of any scene
// (scene r / nps, in-scene id r % nps + 1), and griddepcontrol.wait
// waits for the whole clear grid, so no scene's atomics precede its
// clear.  A robot with more points than registers hold
// takes the same steps after the wait.  Integer atomics commute, so the
// map is deterministic whatever the block order.  Out-of-map and invalid
// points never write.  The host checks that every footprint spans at most
// RASTER_MAX_SPAN cells under any rotation
// (ops/raster.check_footprint_span); points outside the bitmap window,
// which that check excludes, are skipped rather than written out of
// bounds.

#include <climits>
#include <cuda_runtime.h>

#define RASTER_MAX_SPAN 128
#define RASTER_THREADS 256
#define RASTER_PRELOAD 4
#define RASTER_WORDS (RASTER_MAX_SPAN * RASTER_MAX_SPAN / 32)
#define CLEAR_THREADS 256
#define CLEAR_BLOCKS 264  // two per SM of an H100

__device__ __forceinline__ bool in_map(int2 a, int h, int w) {
  return a.x >= 0 && a.x < h && a.y >= 0 && a.y < w;
}

// The robot's corner (min row, min col over its in-map points) into *m0 /
// *n0, which hold INT_MAX: a warp min, then one shared atomicMin per warp.
__device__ __forceinline__ void corner_min(int mloc, int nloc, int* m0,
                                           int* n0) {
  const int wm = __reduce_min_sync(0xffffffffu, mloc);
  const int wn = __reduce_min_sync(0xffffffffu, nloc);
  if ((threadIdx.x & 31) == 0 && wm != INT_MAX) {
    atomicMin(m0, wm);
    atomicMin(n0, wn);
  }
}

// Sets in-map cell a's bit in the window at (m0, n0); true where it was
// clear, i.e. for the first of the robot's points in that cell.
__device__ __forceinline__ bool first_in_cell(unsigned* bits, int2 a, int m0,
                                              int n0) {
  const int da = a.x - m0, db = a.y - n0;
  if (da >= RASTER_MAX_SPAN || db >= RASTER_MAX_SPAN) return false;
  const int bit = da * RASTER_MAX_SPAN + db;
  const unsigned mask = 1u << (bit & 31);
  return !(atomicOr(&bits[bit >> 5], mask) & mask);
}

// Zeroes out[total]; lets the dependent raster kernel launch at once.
__global__ void __launch_bounds__(CLEAR_THREADS)
    clear_map_kernel(int* __restrict__ out, size_t total) {
  asm volatile("griddepcontrol.launch_dependents;");
  const size_t stride = (size_t)gridDim.x * CLEAR_THREADS;
  const size_t start = (size_t)blockIdx.x * CLEAR_THREADS + threadIdx.x;
  int4* out4 = reinterpret_cast<int4*>(out);
  for (size_t q = start; q < total / 4; q += stride)
    out4[q] = make_int4(0, 0, 0, 0);
  for (size_t q = total / 4 * 4 + start; q < total; q += stride) out[q] = 0;
}

// Waits until the clear kernel has finished and its stores are visible.
__device__ __forceinline__ void wait_for_clear() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

__global__ void __launch_bounds__(RASTER_THREADS)
    raster_robots_kernel(const int2* __restrict__ cells,
                         const unsigned char* __restrict__ valid, int nps,
                         int p, int h, int w, int* __restrict__ out) {
  __shared__ unsigned bits[RASTER_WORDS];
  __shared__ int m0, n0;
  const int tid = threadIdx.x, r = blockIdx.x;
  const int scene = r / nps, local = r - scene * nps;
  const int contrib = ((local + 1) << 12) | 1;
  const int2* c = cells + (size_t)r * p;
  const unsigned char* v = valid + (size_t)local * p;
  out += (size_t)scene * h * w;

  for (int i = tid; i < RASTER_WORDS; i += RASTER_THREADS) bits[i] = 0u;
  if (tid == 0) {
    m0 = INT_MAX;
    n0 = INT_MAX;
  }
  if (p <= RASTER_PRELOAD * RASTER_THREADS) {
    int2 a[RASTER_PRELOAD];
    int mloc = INT_MAX, nloc = INT_MAX;
#pragma unroll
    for (int k = 0; k < RASTER_PRELOAD; ++k) {
      const int i = tid + k * RASTER_THREADS;
      a[k] = make_int2(-1, -1);
      if (i < p) {
        const int2 b = c[i];
        if (v[i]) a[k] = b;
      }
      if (in_map(a[k], h, w)) {
        mloc = min(mloc, a[k].x);
        nloc = min(nloc, a[k].y);
      }
    }
    __syncthreads();
    corner_min(mloc, nloc, &m0, &n0);
    __syncthreads();
    unsigned add = 0u;  // bit k: a[k] is the first point of its cell
#pragma unroll
    for (int k = 0; k < RASTER_PRELOAD; ++k)
      if (in_map(a[k], h, w) && first_in_cell(bits, a[k], m0, n0))
        add |= 1u << k;
    wait_for_clear();
#pragma unroll
    for (int k = 0; k < RASTER_PRELOAD; ++k)
      if ((add >> k) & 1u)
        atomicAdd(&out[(size_t)a[k].x * w + a[k].y], contrib);
    return;
  }
  int mloc = INT_MAX, nloc = INT_MAX;
  for (int i = tid; i < p; i += RASTER_THREADS) {
    const int2 b = c[i];
    if (v[i] && in_map(b, h, w)) {
      mloc = min(mloc, b.x);
      nloc = min(nloc, b.y);
    }
  }
  __syncthreads();
  corner_min(mloc, nloc, &m0, &n0);
  __syncthreads();
  wait_for_clear();
  for (int i = tid; i < p; i += RASTER_THREADS) {
    const int2 b = c[i];
    if (v[i] && in_map(b, h, w) && first_in_cell(bits, b, m0, n0))
      atomicAdd(&out[(size_t)b.x * w + b.y], contrib);
  }
}

// cells [scenes, nps, p, 2] int32 world cells (row, col); valid [nps, p]
// bool, the same in every scene;
// out [scenes, h, w] int32: per scene, the sum over its robots r covering
// the cell of ((r + 1) << 12) | 1, r the in-scene index.  The clear kernel
// over every scene's map, then the raster kernel as its programmatic
// dependent (one block per robot of any scene): one launch for the batch.
extern "C" int img_env_raster_robots(const int* cells,
                                     const unsigned char* valid, int scenes,
                                     int nps, int p, int h, int w, int* out,
                                     cudaStream_t stream) {
  const size_t total = (size_t)scenes * h * w;
  const int n = scenes * nps;
  clear_map_kernel<<<CLEAR_BLOCKS, CLEAR_THREADS, 0, stream>>>(out, total);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n <= 0 || p <= 0) return (int)err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n);
  cfg.blockDim = dim3(RASTER_THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  const int2* cells2 = reinterpret_cast<const int2*>(cells);
  void* args[] = {(void*)&cells2, (void*)&valid, (void*)&nps, (void*)&p,
                  (void*)&h,      (void*)&w,     (void*)&out};
  err = cudaLaunchKernelExC(&cfg, (const void*)raster_robots_kernel, args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
