// Fused map metrics + CA-CFAR + centroid suppression on a stack of
// delay-Doppler maps, for NVIDIA Hopper (sm_90a), in one launch.
//
// Replaces the TPU kernel blah2_tpu/ops/pallas_detect.py::_detect_kernel
// (Pallas). Same function, not the same blocking: the TPU kernel held the
// whole map in VMEM; the map (301 x 411 f32 = 0.5 MB at the default config)
// is larger than one SM's 227 KB of shared memory. So the map is cut into
// tiles of kTileRows x kTileCols cells, one block of kThreads threads each:
// grid (column tiles, row tiles, maps). At 301 x 411 that is 9 x 13 = 117
// blocks, one wave on the H100's 132 SMs. Of the tiles 16 x 72, 24 x 48,
// 32 x 36 and 12 x 96, 24 x 48 was the fastest on an H100
// (tools/torch_detect_probe.py): taller tiles load fewer halo rows,
// narrower ones more halo columns.
//
// Input: a float32 power map, or a complex64 map z whose power the block
// forms itself while it loads, p = re*re + im*im with __fmul_rn/__fadd_rn,
// so nvcc cannot contract it into an FMA and p rounds as the plain twin's
// separate product and sum do.
//
// Per block, in shared memory:
//
//   1. Every load first, in one loop in which a thread issues its loads for
//      kUnroll cells before it stores any, so that it waits on memory about
//      once and not once a cell: the power and cell_ok of the tile with a
//      halo of win_rows rows above and below and n_guard + n_train +
//      win_cols columns left and right (0 outside the map), and scale. At
//      the default config (2 guard, 6 train, 5 x 5 window) that is 34 x 74
//      cells. A row of 411 complex64 values is 3,288 B and of 411 floats
//      1,644 B, neither a multiple of 16 B, so TMA cannot load it (it needs
//      16 B strides); the block loads with coalesced 4 or 8 B loads.
//   2. Hit power M (p where hit, else 0) over the tile with the window
//      halo, in place of cell_ok. CFAR runs along delay only, so the halo's
//      hits need nothing from another block. The train sum is added in the
//      reference order (for o = g+1..g+t: the left cell j-o, then the right
//      cell j+o), with j the map's column, not the tile's; the reference's
//      edges (left cells from column 1, right cells below nc) hold because
//      map column 0 is kept apart and cells outside the map are 0, and
//      adding 0 changes no sum. hit = p > scale[j]*train && cell_ok.
//   3. The window max of M along Doppler (rows), then per cell along delay
//      (columns), as the TPU kernel's separable max; M >= 0 and cells
//      outside the map are 0, which is the window clipped at the edges.
//      Only a hit needs its window max, so the row pass runs only for tile
//      rows that hold a hit, and the column pass only at hit cells.
//      keep = hit && p >= wmax: a tie keeps both cells, as the reference's
//      strict-inequality pairwise scan does.
//   4. db = 5*log10(p) and keep into registers; the block's dB sum and max
//      to one partial per block, in a fixed order (warp shuffles, then the
//      warps in order).
//
// noise = mean(db) and rawmax = max(0, max db) in the same launch: each
// block writes its partials and takes an integer ticket per map with an
// acq_rel atomicAdd; the block that draws the last ticket sums the partials
// in a fixed order, writes noise and rawmax, and resets the counter to 0
// for the next launch on the stream. No float atomics, so the result is the
// same on every run. The cells of db and keep are stored after the ticket,
// so that its release waits for no map store.
//
// Bound: the function reads the map (4 B a cell as float32 power, 8 B as
// complex64) and cell_ok (4 B) and writes db and keep (4 B each): 16 or
// 20 B a cell, 2.0 or 2.5 MB at 301 x 411, 0.59 or 0.74 us at 3.35 TB/s.
// Its arithmetic (about 40 f32 operations a cell) is an order below. The
// halos add reads from L2 (34 x 74 loaded for 24 x 48 kept at the default
// config, 2.2 times), not device memory traffic. At this size the kernel
// is bound by neither: a launch, five dependent phases over one wave of
// blocks, and the last block's reduction set its time. The row-block mode
// reads each block's halo rows too (2 x win_rows of every block's R + 2 x
// win_rows rows) and is bound the same way.
//
// Row-block mode (detect_launch_blocks), for the row-sharded pipeline, in
// which each pulse rank holds R rows of the map: a stack of blocks, block b
// its R kept rows at map rows g0_b .. g0_b + R - 1 with the win_rows rows
// above and below them (the centroid window's reach, which the caller
// brings from the neighbouring ranks), each part read where it lies through
// a table of pointers, one launch for every block of a card. Rows outside
// [0, nr), halo rows past the map's edges and the last rank's phantom rows
// alike, are outside the map: power 0, cell_ok 0, as map mode's edges.
// CFAR runs along delay only, so a block needs no more rows than the
// window's. Out: db and keep of the kept rows (phantom rows: -inf and 0),
// and per block the dB sum over its kept rows inside the map and
// max(0, their max dB), by the same ticket reduction (inv_cells 1): the
// caller reduces those over the ranks. Same arithmetic per cell as map
// mode, so db and keep are the bits map mode gives on the whole map. The
// tile is kBlockTileRows x kTileCols. At 1 x 4 (4 blocks of 76 rows) 24-row
// tiles make 4 x 4 x 9 = 144 blocks, two waves on 132 SMs, and took 11.8
// us; 32-row tiles make 108 blocks, one wave, 8.2 us; 40-row tiles 72
// blocks, 8.6 us (tools/torch_detect_probe.py --block-tiles, NVIDIA H100
// 80GB HBM3 at 700 W): a block's phases cost about the same up to 4,096
// region cells (one load a thread), so a taller tile is nearly free until
// the wave runs short of SMs.
//
// Interface: plain C, bound from Python with ctypes. The launcher makes
// `device` current where it is not, enqueues on the given stream, does not
// synchronise, and returns cudaGetLastError() (0 on success).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;
// The tile, and where a probe build stops (DETECT_CUT = n returns after
// phase n; 0, the default, after none): tools/torch_detect_probe.py builds
// copies with -DDETECT_TILE_ROWS/-DDETECT_TILE_COLS, -DDETECT_CUT or the
// row-block mode's -DDETECT_BLOCK_TILE_ROWS.
#ifndef DETECT_TILE_ROWS
#define DETECT_TILE_ROWS 24
#endif
#ifndef DETECT_TILE_COLS
#define DETECT_TILE_COLS 48
#endif
#ifndef DETECT_CUT
#define DETECT_CUT 0
#endif
#ifndef DETECT_BLOCK_TILE_ROWS
#define DETECT_BLOCK_TILE_ROWS 32
#endif
constexpr int kTileRows = DETECT_TILE_ROWS;
constexpr int kTileCols = DETECT_TILE_COLS;
constexpr int kBlockTileRows = DETECT_BLOCK_TILE_ROWS;
// s_sum, s_max, s_last and s_row_hit of the taller of the two tiles.
constexpr int kStaticSmem =
    2 * kWarps * 4 + 4 +
    4 * (kTileRows > kBlockTileRows ? kTileRows : kBlockTileRows);
// Row blocks of one launch (the pointer table is a kernel parameter: 28 B
// a block, 3,584 B of the 4 KB a launch's parameters may hold).
constexpr int kMaxBlocks = 128;

// A probe cut: every thread returns after phase n, after a store (never
// taken) of a value the phases made, so that the compiler keeps their work.
#define DETECT_CUT_AFTER(n, value)                                    \
  if (DETECT_CUT == (n)) {                                            \
    if (threadIdx.x == 0 && blockIdx.x == 9999) keep[0] = (value);    \
    return;                                                           \
  }

__device__ __forceinline__ float power_of(const float* p, long long i) {
  return p[i];
}

__device__ __forceinline__ float power_of(const float2* z, long long i) {
  const float2 v = z[i];
  return __fadd_rn(__fmul_rn(v.x, v.x), __fmul_rn(v.y, v.y));
}

// The block's sum and max of (a, m), in a fixed order (warp shuffles, then
// the warps' results in warp order): the same on every run. Thread 0 holds
// the result.
__device__ __forceinline__ void block_sum_max(float& a, float& m,
                                              float* s_sum, float* s_max) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, o);
    m = fmaxf(m, __shfl_down_sync(0xffffffffu, m, o));
  }
  if (lane == 0) {
    s_sum[warp] = a;
    s_max[warp] = m;
  }
  __syncthreads();
  if (warp == 0) {
    a = lane < kWarps ? s_sum[lane] : 0.0f;
    m = lane < kWarps ? s_max[lane] : -INFINITY;
    for (int o = 16; o > 0; o >>= 1) {
      a += __shfl_down_sync(0xffffffffu, a, o);
      m = fmaxf(m, __shfl_down_sync(0xffffffffu, m, o));
    }
  }
}

long long smem_floats(int tile_rows, int n_guard, int n_train, int win_rows,
                      int win_cols) {
  const long long rh = tile_rows + 2LL * win_rows;
  const long long pw = kTileCols + 2LL * (win_cols + n_guard + n_train);
  const long long mw = kTileCols + 2LL * win_cols;
  return 2 * rh * pw + pw + rh + tile_rows * mw;
}

// Where the rows of one map (map mode) or one row block lie: local row i of
// [lo, kept + halo) is main's row i for 0 <= i < kept, above's row
// i + halo for i < 0, below's row i - kept for i >= kept; map row g0 + i.
// Map mode: main is the map, kept = nr, halo = 0, g0 = 0.
template <typename In>
struct Src {
  const In* above;
  const In* main;
  const In* below;
  int kept, halo, g0;

  __device__ __forceinline__ const In* row(int i, int nc) const {
    if (i < 0) return above + static_cast<long long>(i + halo) * nc;
    if (i < kept) return main + static_cast<long long>(i) * nc;
    return below + static_cast<long long>(i - kept) * nc;
  }
};

// The row blocks of one launch of the row-block mode.
template <typename In>
struct BlockTable {
  const In* above[kMaxBlocks];
  const In* main[kMaxBlocks];
  const In* below[kMaxBlocks];
  int first_row[kMaxBlocks];
};

// (row, column) of the flat index start, start + step, ... of a region
// `width` wide, kept up to date by adds: no division after the first.
struct Walk {
  int r, c, dr, dc, w;
  __device__ Walk(int start, int step, int width) : w(width) {
    r = start / w;
    c = start - r * w;
    dr = step / w;
    dc = step - dr * w;
  }
  __device__ void next() {
    r += dr;
    c += dc;
    if (c >= w) {
      c -= w;
      ++r;
    }
  }
};

// The detect function on one tile (grid x, y) of one map or row block
// (grid z), whose rows `src` gives; db and keep point at that map's or
// block's output rows.
template <typename In, int Rows>
__device__ __forceinline__ void detect_body(
    const Src<In>& src, const float* __restrict__ scale,
    const float* __restrict__ cell_ok, float* __restrict__ db,
    float* __restrict__ keep, unsigned int* __restrict__ counters,
    float* __restrict__ part_sum, float* __restrict__ part_max,
    float* __restrict__ noise, float* __restrict__ rawmax, int nr, int nc,
    int n_guard, int n_train, int win_rows, int win_cols, float inv_cells) {
  extern __shared__ float smem[];
  __shared__ float s_sum[kWarps];
  __shared__ float s_max[kWarps];
  __shared__ int s_last;
  __shared__ int s_row_hit[Rows];

  const int hp = n_guard + n_train;
  const int rh = Rows + 2 * win_rows;
  const int pw = kTileCols + 2 * (win_cols + hp);
  const int mw = kTileCols + 2 * win_cols;
  const int n_p = rh * pw;
  float* s_p = smem;              // rh x pw power, map column 0 held as 0
  float* s_m = s_p + n_p;         // rh x pw cell_ok, then hit power
  float* s_scale = s_m + n_p;     // pw
  float* s_col0 = s_scale + pw;   // rh: the power of map column 0
  float* s_rm = s_col0 + rh;      // Rows x mw

  const int r0 = blockIdx.y * Rows;
  const int c0 = blockIdx.x * kTileCols;
  const int z = blockIdx.z;
  // Source row and map column of region cell (0, 0); the rows the source
  // holds are [lo, hi).
  const int li0 = r0 - win_rows;
  const int gj0 = c0 - win_cols - hp;
  const int lo = -src.halo;
  const int hi = src.kept + src.halo;

  // 1. Every load of the block first: power and cell_ok over the region
  //    (0 outside the source's rows and outside the map), and scale. Each
  //    thread issues its loads for kUnroll cells before it stores any.
  //    Column 0 of the map is stored as 0 in s_p and its power kept in
  //    s_col0: column 0 is never a train cell (the reference's k>0 quirk on
  //    the left; no right cell reaches it), and cells outside the map are
  //    0, so the train sums below need no bounds tests and add the same
  //    terms in the same order as the reference.
  {
    Walk w(threadIdx.x, kThreads, pw);
    for (int k0 = threadIdx.x; k0 < n_p; k0 += kThreads * kUnroll) {
      float p[kUnroll], ok[kUnroll];
      int at[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int li = li0 + w.r;
        const int gi = src.g0 + li;
        const int gj = gj0 + w.c;
        at[u] = gj == 0 ? w.r : -1;
        p[u] = 0.0f;
        ok[u] = 0.0f;
        if (k0 + u * kThreads < n_p && li >= lo && li < hi && gi >= 0 &&
            gi < nr && gj >= 0 && gj < nc) {
          p[u] = power_of(src.row(li, nc), gj);
          ok[u] = cell_ok[static_cast<long long>(gi) * nc + gj];
        }
        w.next();
      }
      float sc = 0.0f;
      const int gj = gj0 + threadIdx.x;
      if (k0 == threadIdx.x && threadIdx.x < pw && gj >= 0 && gj < nc) {
        sc = scale[gj];
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int k = k0 + u * kThreads;
        if (k < n_p) {
          s_p[k] = at[u] >= 0 ? 0.0f : p[u];
          s_m[k] = ok[u];
          if (at[u] >= 0) s_col0[at[u]] = p[u];
        }
      }
      if (k0 == threadIdx.x && threadIdx.x < pw) s_scale[threadIdx.x] = sc;
    }
    if (threadIdx.x < Rows) s_row_hit[threadIdx.x] = 0;
    // Regions wider than the block (centroid windows of hundreds of
    // columns) take the rest of scale here.
    for (int c = kThreads + threadIdx.x; c < pw; c += kThreads) {
      s_scale[c] = (gj0 + c >= 0 && gj0 + c < nc) ? scale[gj0 + c] : 0.0f;
    }
  }
  __syncthreads();

  DETECT_CUT_AFTER(1, smem[5]);

  // 2. Hit power over the tile and the window halo (region columns hp ..
  //    hp + mw - 1), in place of cell_ok; each thread reads and writes its
  //    own cells. The train sum in the reference order: for o = g+1..g+t,
  //    the left cell, then the right cell.
  {
    Walk w(threadIdx.x, kThreads, mw);
    for (int k = threadIdx.x; k < rh * mw; k += kThreads, w.next()) {
      const int li = li0 + w.r;
      const int gi = src.g0 + li;
      const int gj = c0 - win_cols + w.c;
      const int at = w.r * pw + hp + w.c;
      float m = 0.0f;
      if (li >= lo && li < hi && gi >= 0 && gi < nr && gj >= 0 && gj < nc) {
        const float* row = s_p + at;
        const float p = gj == 0 ? s_col0[w.r] : row[0];
        float train = 0.0f;
#pragma unroll 4
        for (int o = n_guard + 1; o <= hp; ++o) {
          train += row[-o];
          train += row[o];
        }
        const bool hit =
            (p > s_scale[hp + w.c] * train) && (s_m[at] > 0.0f);
        m = hit ? p : 0.0f;
        // A tile row with a hit needs its window max (phases 3 and 4).
        const int i = w.r - win_rows;
        if (hit && i >= 0 && i < Rows && w.c >= win_cols &&
            w.c < win_cols + kTileCols) {
          s_row_hit[i] = 1;
        }
      }
      s_m[at] = m;
    }
  }
  __syncthreads();

  DETECT_CUT_AFTER(2, smem[5]);

  // 3. Window max along rows, for the tile rows that hold a hit.
  {
    Walk w(threadIdx.x, kThreads, mw);
    for (int k = threadIdx.x; k < Rows * mw; k += kThreads, w.next()) {
      if (!s_row_hit[w.r]) continue;
      const float* col = s_m + w.r * pw + hp + w.c;
      float v = 0.0f;
      for (int d = 0; d <= 2 * win_rows; ++d) v = fmaxf(v, col[d * pw]);
      s_rm[k] = v;
    }
  }
  __syncthreads();

  DETECT_CUT_AFTER(3, smem[5]);

  // 4. Window max along columns, keep and dB into registers, and the
  //    block's partials over its cells inside the map.
  constexpr int kPer = (Rows * kTileCols + kThreads - 1) / kThreads;
  float d_out[kPer], k_out[kPer];
  long long at_out[kPer];
  float d_sum = 0.0f;
  float d_max = -INFINITY;
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int k = threadIdx.x + u * kThreads;
    const int i = k / kTileCols;
    const int j = k - i * kTileCols;
    const int li = r0 + i;
    const int gj = c0 + j;
    at_out[u] = -1;
    if (k >= Rows * kTileCols || li >= src.kept || gj >= nc) continue;
    const int gi = src.g0 + li;
    const int at = (i + win_rows) * pw + j + win_cols + hp;
    const float p = gj == 0 ? s_col0[i + win_rows] : s_p[at];
    // A hit has p > scale*train >= 0, so hit <=> m > 0; only a hit needs
    // its window max.
    float kept = 0.0f;
    if (s_m[at] > 0.0f) {
      const float* rm = s_rm + i * mw + j;
      float wmax = 0.0f;
      for (int d = 0; d <= 2 * win_cols; ++d) wmax = fmaxf(wmax, rm[d]);
      kept = p >= wmax ? 1.0f : 0.0f;
    }
    const float d = 5.0f * log10f(p);
    d_out[u] = d;
    k_out[u] = kept;
    at_out[u] = static_cast<long long>(li) * nc + gj;
    if (gi >= 0 && gi < nr) {
      d_sum += d;
      d_max = fmaxf(d_max, d);
    }
  }
  block_sum_max(d_sum, d_max, s_sum, s_max);

  DETECT_CUT_AFTER(4, d_sum + d_out[0] + k_out[0]);

  // 5. The partials, and a ticket per map or row block: the block that
  //    draws the last one reduces the partials. The ticket is an acq_rel
  //    atomic: release publishes this block's partials, acquire lets the
  //    last block read every other block's. The cells are stored after
  //    the ticket, so that no fence waits for them.
  const int n_tiles = gridDim.x * gridDim.y;
  part_sum += static_cast<long long>(z) * n_tiles;
  part_max += static_cast<long long>(z) * n_tiles;
  if (threadIdx.x == 0) {
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    part_sum[tile] = d_sum;
    part_max[tile] = d_max;
    unsigned int ticket;
    asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;"
                 : "=r"(ticket)
                 : "l"(counters + z)
                 : "memory");
    s_last = ticket == static_cast<unsigned int>(n_tiles - 1);
  }
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    if (at_out[u] >= 0) {
      db[at_out[u]] = d_out[u];
      keep[at_out[u]] = k_out[u];
    }
  }
  __syncthreads();
  if (!s_last) return;
  float a = 0.0f;
  float mx = -INFINITY;
  for (int b = threadIdx.x; b < n_tiles; b += kThreads) {
    a += __ldcg(part_sum + b);
    mx = fmaxf(mx, __ldcg(part_max + b));
  }
  block_sum_max(a, mx, s_sum, s_max);
  if (threadIdx.x == 0) {
    noise[z] = a * inv_cells;
    rawmax[z] = fmaxf(0.0f, mx);
    counters[z] = 0u;
  }
}

// Map mode: grid z is the map of the stack.
template <typename In>
__global__ void __launch_bounds__(kThreads)
detect_tile(const In* __restrict__ in, const float* __restrict__ scale,
            const float* __restrict__ cell_ok, float* __restrict__ db,
            float* __restrict__ keep, unsigned int* __restrict__ counters,
            float* __restrict__ part_sum, float* __restrict__ part_max,
            float* __restrict__ noise, float* __restrict__ rawmax, int nr,
            int nc, int n_guard, int n_train, int win_rows, int win_cols,
            float inv_cells) {
  const long long base = static_cast<long long>(blockIdx.z) * nr * nc;
  const Src<In> src{nullptr, in + base, nullptr, nr, 0, 0};
  detect_body<In, kTileRows>(src, scale, cell_ok, db + base, keep + base,
                             counters, part_sum, part_max, noise, rawmax, nr,
                             nc, n_guard, n_train, win_rows, win_cols,
                             inv_cells);
}

// Row-block mode: grid z is the row block; noise and rawmax take the
// block's dB sum and max(0, max dB) (inv_cells 1).
template <typename In>
__global__ void __launch_bounds__(kThreads)
detect_blocks(const BlockTable<In> table, int kept,
              const float* __restrict__ scale,
              const float* __restrict__ cell_ok, float* __restrict__ db,
              float* __restrict__ keep, unsigned int* __restrict__ counters,
              float* __restrict__ part_sum, float* __restrict__ part_max,
              float* __restrict__ sums, float* __restrict__ maxes, int nr,
              int nc, int n_guard, int n_train, int win_rows, int win_cols) {
  const int b = blockIdx.z;
  const Src<In> src{table.above[b], table.main[b], table.below[b], kept,
                    win_rows, table.first_row[b]};
  const long long base = static_cast<long long>(b) * kept * nc;
  detect_body<In, kBlockTileRows>(src, scale, cell_ok, db + base,
                                  keep + base, counters, part_sum, part_max,
                                  sums, maxes, nr, nc, n_guard, n_train,
                                  win_rows, win_cols, 1.0f);
}

int tiles(int n, int tile) { return (n + tile - 1) / tile; }

// The dynamic shared memory a kernel may take beyond 48 KB is a function
// attribute, set per card. It is set on the first launch that needs more
// than the card allows the kernel so far and never again for that size, so
// a launch inside a CUDA graph's stream capture (after a warm-up launch of
// the same size) makes no runtime call but the launch itself.
constexpr int kMaxDevices = 64;

template <typename Kernel>
cudaError_t allow_smem(Kernel* kernel, int smem, int device,
                       int (&allowed)[kMaxDevices]) {
  if (smem <= 48 * 1024) return cudaSuccess;
  if (device >= 0 && device < kMaxDevices && smem <= allowed[device])
    return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess && device >= 0 && device < kMaxDevices)
    allowed[device] = smem;
  return e;
}

template <typename In>
cudaError_t launch(const void* in, const void* scale, const void* cell_ok,
                   void* db, void* keep, void* scratch, void* noise,
                   void* rawmax, int batch, int nr, int nc, int n_guard,
                   int n_train, int win_rows, int win_cols, int smem,
                   int device, cudaStream_t stream) {
  static int allowed[kMaxDevices] = {};
  cudaError_t e = allow_smem(detect_tile<In>, smem, device, allowed);
  if (e != cudaSuccess) return e;
  const dim3 grid(tiles(nc, kTileCols), tiles(nr, kTileRows), batch);
  const int n_tiles = grid.x * grid.y;
  unsigned int* counters = static_cast<unsigned int*>(scratch);
  float* part_sum = reinterpret_cast<float*>(counters + batch);
  float* part_max = part_sum + static_cast<long long>(batch) * n_tiles;
  const float inv_cells = static_cast<float>(1.0 / (double(nr) * nc));
  detect_tile<In><<<grid, kThreads, smem, stream>>>(
      static_cast<const In*>(in), static_cast<const float*>(scale),
      static_cast<const float*>(cell_ok), static_cast<float*>(db),
      static_cast<float*>(keep), counters, part_sum, part_max,
      static_cast<float*>(noise), static_cast<float*>(rawmax), nr, nc,
      n_guard, n_train, win_rows, win_cols, inv_cells);
  return cudaGetLastError();
}

template <typename In>
cudaError_t launch_blocks(int n_blocks, const void* const* parts,
                          const int* first_rows, const void* scale,
                          const void* cell_ok, void* db, void* keep,
                          void* scratch, void* sums, void* maxes, int kept,
                          int nr, int nc, int n_guard, int n_train,
                          int win_rows, int win_cols, int smem,
                          int device, cudaStream_t stream) {
  static int allowed[kMaxDevices] = {};
  cudaError_t e = allow_smem(detect_blocks<In>, smem, device, allowed);
  if (e != cudaSuccess) return e;
  BlockTable<In> table;
  for (int b = 0; b < n_blocks; ++b) {
    table.above[b] = static_cast<const In*>(parts[b]);
    table.main[b] = static_cast<const In*>(parts[n_blocks + b]);
    table.below[b] = static_cast<const In*>(parts[2 * n_blocks + b]);
    table.first_row[b] = first_rows[b];
  }
  const dim3 grid(tiles(nc, kTileCols), tiles(kept, kBlockTileRows),
                  n_blocks);
  const int n_tiles = grid.x * grid.y;
  unsigned int* counters = static_cast<unsigned int*>(scratch);
  float* part_sum = reinterpret_cast<float*>(counters + n_blocks);
  float* part_max = part_sum + static_cast<long long>(n_blocks) * n_tiles;
  detect_blocks<In><<<grid, kThreads, smem, stream>>>(
      table, kept, static_cast<const float*>(scale),
      static_cast<const float*>(cell_ok), static_cast<float*>(db),
      static_cast<float*>(keep), counters, part_sum, part_max,
      static_cast<float*>(sums), static_cast<float*>(maxes), nr, nc, n_guard,
      n_train, win_rows, win_cols);
  return cudaGetLastError();
}

// Makes `device` current where it is not, runs `fn`, and puts the previous
// device back.
template <typename Fn>
int on_device(int device, Fn fn) {
  int current = -1;
  cudaError_t e = cudaGetDevice(&current);
  if (e == cudaSuccess && current != device) e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = fn();
  if (current != device) cudaSetDevice(current);
  return static_cast<int>(e);
}

// 32-bit words of scratch for a stack of ``batch`` maps of ``nr`` rows (or
// ``batch`` row blocks of ``nr`` kept rows, ``tile_rows`` their tile): one
// ticket counter per map (zero before the first launch; the kernel leaves
// it zero), then the per-block partial sums and maxima of each map.
long long scratch_words(int batch, int nr, int nc, int tile_rows) {
  const long long n_tiles =
      static_cast<long long>(tiles(nc, kTileCols)) * tiles(nr, tile_rows);
  return static_cast<long long>(batch) * (1 + 2 * n_tiles);
}

}  // namespace

extern "C" int detect_tile_rows() { return kTileRows; }
extern "C" int detect_tile_cols() { return kTileCols; }
extern "C" int detect_block_tile_rows() { return kBlockTileRows; }
extern "C" int detect_max_blocks() { return kMaxBlocks; }
extern "C" int detect_static_smem() { return kStaticSmem; }

extern "C" long long detect_scratch_words(int batch, int nr, int nc) {
  return scratch_words(batch, nr, nc, kTileRows);
}

extern "C" long long detect_block_scratch_words(int n_blocks, int kept,
                                                int nc) {
  return scratch_words(n_blocks, kept, nc, kBlockTileRows);
}

// ``in`` is a float32 power map (complex_input 0) or a complex64 map
// (complex_input 1); ``smem`` the dynamic shared memory in bytes, at least
// what the window extents need.
extern "C" int detect_launch(const void* in, int complex_input,
                             const void* scale, const void* cell_ok, void* db,
                             void* keep, void* scratch, void* noise,
                             void* rawmax, int batch, int nr, int nc,
                             int n_guard, int n_train, int win_rows,
                             int win_cols, int smem, int device,
                             void* stream) {
  if (batch < 1 || batch > 65535 || nr < 1 || nc < 1 || n_guard < 0 ||
      n_train < 0 || win_rows < 0 || win_cols < 0 ||
      static_cast<long long>(smem) <
          4 * smem_floats(kTileRows, n_guard, n_train, win_rows, win_cols)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return on_device(device, [&] {
    return complex_input
               ? launch<float2>(in, scale, cell_ok, db, keep, scratch, noise,
                                rawmax, batch, nr, nc, n_guard, n_train,
                                win_rows, win_cols, smem, device, s)
               : launch<float>(in, scale, cell_ok, db, keep, scratch, noise,
                               rawmax, batch, nr, nc, n_guard, n_train,
                               win_rows, win_cols, smem, device, s);
  });
}

// The row-block mode. ``parts`` holds 3 x n_blocks pointers: every block's
// win_rows rows above, then every block's ``kept`` rows, then every
// block's win_rows rows below, each part's rows contiguous (nc values a
// row, float32 power or complex64 by ``complex_input``); ``first_rows``
// the map row of each block's first kept row. ``db`` and ``keep`` are
// (n_blocks, kept, nc) float32; ``sums`` and ``maxes`` (n_blocks,) take
// each block's dB sum over its kept rows inside the map's ``nr`` rows and
// max(0, their max dB); ``cell_ok`` is the map's (nr, nc).
extern "C" int detect_launch_blocks(
    int n_blocks, const void* const* parts, const int* first_rows,
    int complex_input, const void* scale, const void* cell_ok, void* db,
    void* keep, void* scratch, void* sums, void* maxes, int kept, int nr,
    int nc, int n_guard, int n_train, int win_rows, int win_cols, int smem,
    int device, void* stream) {
  if (n_blocks < 1 || n_blocks > kMaxBlocks || kept < 1 || nr < 1 ||
      nc < 1 || n_guard < 0 || n_train < 0 || win_rows < 0 || win_cols < 0 ||
      static_cast<long long>(smem) <
          4 * smem_floats(kBlockTileRows, n_guard, n_train, win_rows,
                          win_cols)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return on_device(device, [&] {
    return complex_input
               ? launch_blocks<float2>(n_blocks, parts, first_rows, scale,
                                       cell_ok, db, keep, scratch, sums,
                                       maxes, kept, nr, nc, n_guard, n_train,
                                       win_rows, win_cols, smem, device, s)
               : launch_blocks<float>(n_blocks, parts, first_rows, scale,
                                      cell_ok, db, keep, scratch, sums, maxes,
                                      kept, nr, nc, n_guard, n_train,
                                      win_rows, win_cols, smem, device, s);
  });
}
