// Fused map metrics + CA-CFAR + centroid suppression on a stack of
// delay-Doppler power maps, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel blah2_tpu/ops/pallas_detect.py::_detect_kernel
// (Pallas). Same function, not the same blocking: the TPU kernel held the
// whole map in VMEM; the map (301 x 411 f32 = 0.5 MB at the default config)
// is larger than one SM's 227 KB of shared memory, and the dB sum and max
// reach across every block. So the work is three launches on one stream:
//
//   1. detect_cells, one thread per cell: db = 5*log10(p); the CA-CFAR
//      train sum, added in the JAX kernel's order (for o = g+1..g+t: the
//      left cell j-o if j-o >= 1 -- the reference's k>0 quirk --, then the
//      right cell j+o if j+o < nc); hit = p > scale[j]*train && cell_ok;
//      the hit power (0 where no hit) to a scratch map; one partial dB sum
//      and one partial dB max per block, from a fixed-order shared-memory
//      tree.
//   2. detect_keep, one thread per cell: keep = hit && p >= the max of the
//      hit-power scratch over +-win_rows x +-win_cols, clipped at the map
//      edges (a tie keeps both, as the reference's strict-inequality
//      pairwise scan does). Cells without a hit skip the window.
//   3. detect_finish, one block: the partials in a fixed order to
//      noise = mean(db) and rawmax = max(0, max db).
//
// No float atomics anywhere, so noise is the same on every run.
//
// A (B, nr, nc) stack is one call of the same three launches: in the first
// two the grid's y dimension is the map, the finish has one block per map,
// and every map gets its own partials, noise and rawmax (the scale and the
// cell mask are shared). The sharded pipeline detects its batch of CPIs
// so; a single map is the stack with B = 1.
//
// Bound: the function moves pwr and cell_ok in and db and keep out, about
// 4 x 301 x 411 x 4 B = 2.0 MB (scale and the scalars add 1.7 KB): 0.59 us
// at 3.35 TB/s. Its arithmetic (about 40 f32 operations a cell) is an order
// below that. So it is bound by bytes, and at this size in practice by the
// three launches (a few us each) and not by either. Over the byte bound
// the passes add: the hit-power scratch written and read back (0.5 MB each
// way), the window reads of pass 2 (from L1/L2, only around hit cells), and
// two launch gaps. Making it fast is later work (one persistent launch with
// a grid-wide barrier, or row tiles with halos in shared memory).
//
// Interface: plain C, bound from Python with ctypes. The launcher enqueues
// on the caller's stream, does not synchronise, and returns
// cudaGetLastError() after each launch (0 on success).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void block_sum_max(float* s_sum, float* s_max) {
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
      s_sum[threadIdx.x] += s_sum[threadIdx.x + s];
      s_max[threadIdx.x] = fmaxf(s_max[threadIdx.x], s_max[threadIdx.x + s]);
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
detect_cells(const float* __restrict__ pwr, const float* __restrict__ scale,
             const float* __restrict__ cell_ok, float* __restrict__ db,
             float* __restrict__ hitp, float* __restrict__ part_sum,
             float* __restrict__ part_max, int nr, int nc, int n_guard,
             int n_train) {
  __shared__ float s_sum[kThreads];
  __shared__ float s_max[kThreads];
  const int n = nr * nc;
  const long long map = static_cast<long long>(blockIdx.y) * n;
  pwr += map;
  db += map;
  hitp += map;
  part_sum += blockIdx.y * gridDim.x;
  part_max += blockIdx.y * gridDim.x;
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  float d_sum = 0.0f;
  float d_max = -INFINITY;
  if (idx < n) {
    const int j = idx % nc;
    const float* row = pwr + (idx - j);
    const float p = row[j];
    const float d = 5.0f * log10f(p);
    db[idx] = d;
    d_sum = d;
    d_max = d;
    float train = 0.0f;
    for (int o = n_guard + 1; o <= n_guard + n_train; ++o) {
      if (j - o >= 1) train += row[j - o];
      if (j + o < nc) train += row[j + o];
    }
    const bool hit = (p > scale[j] * train) && (cell_ok[idx] > 0.0f);
    hitp[idx] = hit ? p : 0.0f;
  }
  s_sum[threadIdx.x] = d_sum;
  s_max[threadIdx.x] = d_max;
  __syncthreads();
  block_sum_max(s_sum, s_max);
  if (threadIdx.x == 0) {
    part_sum[blockIdx.x] = s_sum[0];
    part_max[blockIdx.x] = s_max[0];
  }
}

// A hit has p > scale*train >= 0, so hit <=> hitp > 0, and hitp == p there.
__global__ void __launch_bounds__(kThreads)
detect_keep(const float* __restrict__ hitp, float* __restrict__ keep, int nr,
            int nc, int win_rows, int win_cols) {
  const long long map = static_cast<long long>(blockIdx.y) * nr * nc;
  hitp += map;
  keep += map;
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= nr * nc) return;
  const float h = hitp[idx];
  float k = 0.0f;
  if (h > 0.0f) {
    const int i = idx / nc;
    const int j = idx - i * nc;
    const int i0 = max(i - win_rows, 0);
    const int i1 = min(i + win_rows, nr - 1);
    const int j0 = max(j - win_cols, 0);
    const int j1 = min(j + win_cols, nc - 1);
    float wmax = 0.0f;
    for (int r = i0; r <= i1; ++r) {
      const float* row = hitp + r * nc;
      for (int c = j0; c <= j1; ++c) wmax = fmaxf(wmax, row[c]);
    }
    k = (h >= wmax) ? 1.0f : 0.0f;
  }
  keep[idx] = k;
}

__global__ void __launch_bounds__(kThreads)
detect_finish(const float* __restrict__ part_sum,
              const float* __restrict__ part_max, int n_parts,
              float inv_cells, float* __restrict__ noise,
              float* __restrict__ rawmax) {
  __shared__ float s_sum[kThreads];
  __shared__ float s_max[kThreads];
  part_sum += blockIdx.x * n_parts;
  part_max += blockIdx.x * n_parts;
  float a = 0.0f;
  float m = -INFINITY;
  for (int b = threadIdx.x; b < n_parts; b += kThreads) {
    a += part_sum[b];
    m = fmaxf(m, part_max[b]);
  }
  s_sum[threadIdx.x] = a;
  s_max[threadIdx.x] = m;
  __syncthreads();
  block_sum_max(s_sum, s_max);
  if (threadIdx.x == 0) {
    noise[blockIdx.x] = s_sum[0] * inv_cells;
    rawmax[blockIdx.x] = fmaxf(0.0f, s_max[0]);
  }
}

int n_blocks(int nr, int nc) { return (nr * nc + kThreads - 1) / kThreads; }

}  // namespace

// Floats of scratch the launcher needs for a stack of ``batch`` maps: the
// hit-power maps, then the per-block partial sums and maxima of each map.
extern "C" long long detect_scratch_floats(int batch, int nr, int nc) {
  return static_cast<long long>(batch) * (nr * nc + 2 * n_blocks(nr, nc));
}

extern "C" int detect_launch(const void* pwr, const void* scale,
                             const void* cell_ok, void* db, void* keep,
                             void* scratch, void* noise, void* rawmax,
                             int batch, int nr, int nc, int n_guard,
                             int n_train, int win_rows, int win_cols,
                             void* stream) {
  if (batch < 1 || batch > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = n_blocks(nr, nc);
  const dim3 grid(blocks, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* hitp = static_cast<float*>(scratch);
  float* part_sum = hitp + static_cast<long long>(batch) * nr * nc;
  float* part_max = part_sum + static_cast<long long>(batch) * blocks;

  detect_cells<<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(pwr), static_cast<const float*>(scale),
      static_cast<const float*>(cell_ok), static_cast<float*>(db), hitp,
      part_sum, part_max, nr, nc, n_guard, n_train);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  detect_keep<<<grid, kThreads, 0, s>>>(hitp, static_cast<float*>(keep), nr,
                                        nc, win_rows, win_cols);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const float inv_cells = static_cast<float>(1.0 / (double(nr) * nc));
  detect_finish<<<batch, kThreads, 0, s>>>(part_sum, part_max, blocks,
                                           inv_cells,
                                           static_cast<float*>(noise),
                                           static_cast<float*>(rawmax));
  return static_cast<int>(cudaGetLastError());
}
