// The grid backward's fixed-order scatter, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves the backward of its grid
// interpolation to XLA (the `.at[].add` scatter that autodiff of the corner
// gather gives, nice_slam_tpu/ops/grid.py), and so did the port until this
// kernel (ops/grid.scatter_rows: the eight weighted corner rows built as a
// tensor, gathered by the sort's permutation and summed by two
// torch.segment_reduce launches).  It was added because that composition
// led the device time of the benchmark's traced run of room0.strict:
// segment_reduce alone took 0.624 s of the profiled 10-frame sub-window,
// about 48% of the card's busy time there.
//
// What it computes, for the interpolation's cotangent g (N x C), the
// points' fractional offsets f (N x 3) and their corner rows (8 x N):
//   d_grid[r] = sum over the entries e = j * N + p with rows[j][p] == r of
//               g[p] * w_j(f[p]),  w_j = (wx * wy) * wz,
// wx = fx if bit 2 of j is set, else 1 - fx (bit 1: y, bit 0: z), every
// operation a rounded fp32 one (__fsub_rn, __fmul_rn, __fadd_rn: nothing
// contracts into an fma), the products of the plain route.  Rows equal to
// n_rows (the sink row of the slab form) are dropped.
//
// What bounds it on the H100: bytes.  It has to read the cotangent once
// from device memory (the eight corners re-read it from L2), f, the sorted
// keys (int32) and the permutation (int64), and write the dense gradient
// once: at 48,000 points, C = 32 and the fine grid's ~182k rows that is
// ~35 MB, ~10 us at 3.35 TB/s.  Its arithmetic is a multiply and an add a
// value.
//
// Design: a fixed summation order with no atomics, so a call repeats bit
// for bit, graphed or eager.  The wrapper sorts the corner rows stably
// (torch.sort), which puts every row's entries in entry order.  The sorted
// sequence is cut into chunks of CHUNK = 64 entries at fixed positions, one
// warp a chunk, lanes over channels (a loop over blocks of 32 channels, the
// last one masked).  A warp loads its 64 keys and entries with a lane each,
// computes each entry's corner weight on its lane, and hands them out by
// shuffles; the cotangent values of 32 entries are loaded ahead of their
// sums.  Each run of equal keys inside the chunk is summed in sorted order
// from +0: a run that starts and ends in the chunk is written to d_grid;
// the chunk's first run, if it began in an earlier chunk, and its last
// run, if it goes on into the next, go to a scratch slot each (part[2c],
// part[2c + 1]).  A second pass sums each row that spans chunks from the
// chunk where it starts: its tail slot, then the head slots of the chunks
// it goes on into, in chunk order.  Rows with no entries are zero
// (cudaMemsetAsync first).  The pieces summed are those of
// scatter_rows(block=64), every row start and every 64th entry, summed in
// the same order, so the kernel equals the plain route bit for bit.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int CHUNK = 64;      // entries a chunk (scatter_rows' block)
constexpr int WARPS = 8;       // chunks a block
constexpr int FIX_BATCH = 8;   // head slots a fix-up step loads ahead
constexpr unsigned FULL = 0xffffffffu;

struct Args {
  const int* keys;      // [m] corner rows, sorted
  const int64_t* perm;  // [m] entry j * n + p at each sorted position
  const float* f;       // [n][3]
  const float* g;       // [n][c]
  float* part;          // [2 * chunks][c]
  float* out;           // [n_rows][c]
  int m, n, n_rows, c, chunks;
};

__device__ __forceinline__ float corner_weight(const float* f, int j) {
  const float fx = f[0], fy = f[1], fz = f[2];
  const float wx = (j & 4) ? fx : __fsub_rn(1.0f, fx);
  const float wy = (j & 2) ? fy : __fsub_rn(1.0f, fy);
  const float wz = (j & 1) ? fz : __fsub_rn(1.0f, fz);
  return __fmul_rn(__fmul_rn(wx, wy), wz);
}

// One warp a chunk: the runs inside it into d_grid, the runs that cross
// its edges into its two scratch slots.
__global__ void __launch_bounds__(32 * WARPS)
    grid_scatter_chunk_kernel(const Args a) {
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (c >= a.chunks) return;
  const int base = c * CHUNK;
  const int cnt = min(CHUNK, a.m - base);
  // lane l holds the entries base + l and base + 32 + l
  int key[2], pt[2];
  float w[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = h * 32 + lane;
    key[h] = INT_MAX;
    pt[h] = 0;
    w[h] = 0.0f;
    if (i < cnt) {
      key[h] = a.keys[base + i];
      const int64_t e = a.perm[base + i];
      const int j = (int)(e / a.n);
      pt[h] = (int)(e - (int64_t)j * a.n);
      w[h] = corner_weight(a.f + 3 * (int64_t)pt[h], j);
    }
  }
  // the entries of grid rows: a prefix of the chunk (the sink row and the
  // padding sort after every grid row)
  const int lim = __popc(__ballot_sync(FULL, key[0] < a.n_rows)) +
                  __popc(__ballot_sync(FULL, key[1] < a.n_rows));
  if (lim == 0) return;
  const int first = __shfl_sync(FULL, key[0], 0);
  const int prev = base > 0 ? a.keys[base - 1] : -1;
  const int next = base + cnt < a.m ? a.keys[base + cnt] : -1;
  for (int ch0 = 0; ch0 < a.c; ch0 += 32) {
    const int ch = ch0 + lane;
    const bool on = ch < a.c;
    float acc = 0.0f;
    bool first_run = true;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v[32];
#pragma unroll
      for (int t = 0; t < 32; ++t) {
        const int p = __shfl_sync(FULL, pt[h], t);
        v[t] = (on && h * 32 + t < lim) ? a.g[(int64_t)p * a.c + ch] : 0.0f;
      }
      const int key_on = __shfl_sync(FULL, key[1], 0);  // entry 32's key
#pragma unroll
      for (int t = 0; t < 32; ++t) {
        const int i = h * 32 + t;
        const int k = __shfl_sync(FULL, key[h], t);
        const float wt = __shfl_sync(FULL, w[h], t);
        const int k_next = t < 31 ? __shfl_sync(FULL, key[h], t + 1)
                                  : (h == 0 ? key_on : INT_MAX);
        if (i < lim) {
          acc = __fadd_rn(acc, __fmul_rn(v[t], wt));
          const bool last = i == cnt - 1;
          if (last || k_next != k) {
            float* dst;
            if (first_run && first == prev)
              dst = a.part + (int64_t)(2 * c) * a.c;      // began earlier
            else if (last && next == k)
              dst = a.part + (int64_t)(2 * c + 1) * a.c;  // goes on
            else
              dst = a.out + (int64_t)k * a.c;
            if (on) dst[ch] = acc;
            acc = 0.0f;
            first_run = false;
          }
        }
      }
    }
  }
}

// One warp a chunk: the row that starts in this chunk and goes on into the
// next, summed from its tail slot and the head slots of the chunks it goes
// on into, in chunk order.
__global__ void __launch_bounds__(32 * WARPS)
    grid_scatter_fixup_kernel(const Args a) {
  const int lane = threadIdx.x & 31;
  const int c = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (c >= a.chunks) return;
  const int base = c * CHUNK;
  const int end = base + CHUNK;
  if (end >= a.m) return;
  const int row = a.keys[end - 1];
  if (row >= a.n_rows || a.keys[end] != row) return;
  if (base > 0 && a.keys[base - 1] == row) return;  // an earlier chunk's
  // the chunks c + 1 .. stop - 1 start with the row
  int stop = c + 1;
  for (;;) {
    const int d = stop + lane;
    const bool ends = d >= a.chunks || a.keys[(int64_t)d * CHUNK] != row;
    const unsigned b = __ballot_sync(FULL, ends);
    if (b) {
      stop += __ffs(b) - 1;
      break;
    }
    stop += 32;
  }
  for (int ch0 = 0; ch0 < a.c; ch0 += 32) {
    const int ch = ch0 + lane;
    const bool on = ch < a.c;
    float acc = on ? a.part[(int64_t)(2 * c + 1) * a.c + ch] : 0.0f;
    for (int d = c + 1; d < stop; d += FIX_BATCH) {
      float v[FIX_BATCH];
#pragma unroll
      for (int u = 0; u < FIX_BATCH; ++u)
        v[u] = (on && d + u < stop) ? a.part[(int64_t)(2 * (d + u)) * a.c + ch]
                                    : 0.0f;
#pragma unroll
      for (int u = 0; u < FIX_BATCH; ++u)
        if (d + u < stop) acc = __fadd_rn(acc, v[u]);
    }
    if (on) a.out[(int64_t)row * a.c + ch] = acc;
  }
}

}  // namespace

extern "C" {

// Entries a chunk: the wrapper sizes the scratch by it.
int grid_scatter_chunk() { return CHUNK; }

const char* grid_scatter_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// keys: [8 n] sorted corner rows; perm: [8 n] the sort's permutation;
// f: [n][3]; g: [n][c]; part: [2 * ceil(8 n / CHUNK)][c] scratch;
// out: [n_rows][c].  Launches on `stream` and returns the CUDA error of
// the memset or of a launch (0 if none).
int grid_scatter(const int* keys, const int64_t* perm, const float* f,
                 const float* g, float* part, float* out, int n, int n_rows,
                 int c, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (n_rows <= 0 || c <= 0) return 0;
  int err = (int)cudaMemsetAsync(out, 0, (size_t)n_rows * c * sizeof(float),
                                 st);
  if (err || n <= 0) return err;
  const int m = 8 * n;
  const int chunks = (m + CHUNK - 1) / CHUNK;
  const Args a = {keys, perm, f, g, part, out, m, n, n_rows, c, chunks};
  const int blocks = (chunks + WARPS - 1) / WARPS;
  grid_scatter_chunk_kernel<<<blocks, 32 * WARPS, 0, st>>>(a);
  err = (int)cudaGetLastError();
  if (err) return err;
  grid_scatter_fixup_kernel<<<blocks, 32 * WARPS, 0, st>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
