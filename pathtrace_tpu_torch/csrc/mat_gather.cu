// The material gather of the replay and its gradient, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package gathers materials with
// jnp.take and XLA writes its transpose. In the port the gather was
// `field[idx]` and its backward PyTorch's index_put_ with accumulation, which
// sorts the indices and then walks each run of equal indices serially: with
// 262,144 lanes gathering from a 38-row table, one row takes 7,000-131,000
// serial adds, about 20 ms a backward and 91% of the train step's device
// time (PERF.md, section 5).
//
// Forward (mat_gather_kernel): one thread a row copies its row of up to six
// tables, (K, 3) or (K,) float32 each, into the gathered outputs: a copy, so
// it is bit-equal to field[idx].
//
// Backward (mat_scatter_kernel, mat_reduce_kernel): the gradient rows of N
// lanes summed into the K rows of their tables. What bounds it: reading the
// gradients (12 floats a lane for a whole Material, 12.6 MB at 262,144 lanes,
// about 4 us at 3.35 TB/s); the table is tiny. The design keeps every sum in
// a fixed order, with no sort, no serial walk and no atomics:
// - the K x cols table is cut into tiles of tile_rows rows, as many as the
//   block's MG_WARPS private copies of a tile fit MG_SMEM_BYTES of shared
//   memory (128 rows for the 12 columns of a whole Material: both Cornell
//   tables are one tile; the mesh gradient step's 81,920-row tables 640);
// - block (t, b) of the grid takes tile t and the b-th range of lanes; each
//   warp takes 32 lanes at a time; lanes with equal indices in the tile find
//   each other with __match_any_sync, each sums its group's values by 32
//   shuffles in ascending lane order, and the group's lowest lane adds the
//   sum into the warp's copy; a slab with no lane in the tile is skipped;
// - the block sums its copies in warp order into its row of the partials,
//   and mat_reduce_kernel sums the partials in range order.
// The tiles and ranges are a function of N, K and cols alone, so two runs
// give bit-identical gradients for every K.
// An index outside [0, K) traps, as PyTorch's indexing asserts.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false, no
// fast math (ops/cuda/build.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace pt {

constexpr int MG_BLOCK = 256;               // threads a block
constexpr int MG_WARPS = MG_BLOCK / 32;     // private copies of a tile a block
constexpr int MG_MAX_FIELDS = 6;            // a Material's fields
constexpr int MG_MAX_WIDTH = 3;             // floats a row of a field
constexpr int MG_SMEM_BYTES = 48 * 1024;    // the warps' copies of a tile, static-launch limit
constexpr unsigned FULL = 0xffffffffu;

// Up to MG_MAX_FIELDS tables with the same K, the layout of the wrapper's
// ctypes.Structure. Forward: src the (K, width) tables, dst the (N, width)
// outputs. Backward: src the (N, width) gradients, dst the (K, width)
// gradient tables. col[i] is field i's first column in a K x cols table.
struct MatFields {
  const float* src[MG_MAX_FIELDS];
  float* dst[MG_MAX_FIELDS];
  int width[MG_MAX_FIELDS];
  int col[MG_MAX_FIELDS];
  int count;
  int cols;
};

template <typename I>
__device__ __forceinline__ long long checked_index(const I* idx, int row, int k_rows) {
  const long long k = static_cast<long long>(idx[row]);
  if (k < 0 || k >= k_rows) __trap();
  return k;
}

template <typename I>
__global__ void __launch_bounds__(MG_BLOCK)
    mat_gather_kernel(int n, int k_rows, const I* __restrict__ idx, const MatFields f) {
  const int row = blockIdx.x * MG_BLOCK + threadIdx.x;
  if (row >= n) return;
  const long long k = checked_index(idx, row, k_rows);
#pragma unroll
  for (int i = 0; i < MG_MAX_FIELDS; ++i) {
    if (i >= f.count) break;
    const int w = f.width[i];
#pragma unroll
    for (int j = 0; j < MG_MAX_WIDTH; ++j)
      if (j < w) f.dst[i][static_cast<long long>(row) * w + j] = f.src[i][k * w + j];
  }
}

// Block (t, b) sums lanes [b * rows_per_block, min(n, (b + 1) * rows_per_block))
// into table rows [t * tile_rows, min(K, (t + 1) * tile_rows)), the tile;
// its warp w takes the 32-lane slabs w, w + MG_WARPS, ... of that range and
// adds into its own copy of the tile, wtab.
template <typename I>
__global__ void __launch_bounds__(MG_BLOCK)
    mat_scatter_kernel(int n, int k_rows, int tile_rows, int rows_per_block,
                       const I* __restrict__ idx, const MatFields f, float* __restrict__ partial) {
  extern __shared__ float tab[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int k0 = blockIdx.x * tile_rows;
  const int tc = min(tile_rows, k_rows - k0) * f.cols;  // entries of this tile
  float* wtab = tab + warp * tc;
  for (int e = threadIdx.x; e < MG_WARPS * tc; e += MG_BLOCK) tab[e] = 0.0f;
  __syncthreads();
  const int start = blockIdx.y * rows_per_block;
  const int end = min(n, start + rows_per_block);
  for (int base = start + warp * 32; base < end; base += MG_BLOCK) {
    const int row = base + lane;
    // the lane's row of the tile, or -1 past the range or outside the tile
    int k = row < end ? static_cast<int>(checked_index(idx, row, k_rows)) - k0 : -1;
    if (k < 0 || k * f.cols >= tc) k = -1;
    const bool mine = k >= 0;
    if (__any_sync(FULL, mine)) {
      // every load of the slab first, so that they are in flight together
      float v[MG_MAX_FIELDS][MG_MAX_WIDTH];
#pragma unroll
      for (int i = 0; i < MG_MAX_FIELDS; ++i)
#pragma unroll
        for (int j = 0; j < MG_MAX_WIDTH; ++j)
          v[i][j] = mine && i < f.count && j < f.width[i]
                        ? f.src[i][static_cast<long long>(row) * f.width[i] + j] : 0.0f;
      // lanes outside the tile share k = -1 and are never a leader
      const unsigned group = __match_any_sync(FULL, k);
      const bool leader = mine && __ffs(group) - 1 == lane;
      const bool alone = __all_sync(FULL, !mine || group == (1u << lane));
#pragma unroll
      for (int i = 0; i < MG_MAX_FIELDS; ++i) {
        if (i >= f.count) break;
#pragma unroll
        for (int j = 0; j < MG_MAX_WIDTH; ++j) {
          if (j >= f.width[i]) break;
          float s = v[i][j];
          if (!alone) {
            s = 0.0f;
#pragma unroll
            for (int l = 0; l < 32; ++l) {
              const float x = __shfl_sync(FULL, v[i][j], l);
              if (group & (1u << l)) s += x;
            }
          }
          if (leader) wtab[k * f.cols + f.col[i] + j] += s;
        }
      }
    }
    // orders this slab's adds to wtab before the next slab's leaders read it
    __syncwarp();
  }
  __syncthreads();
  float* out = partial + static_cast<long long>(blockIdx.y) * k_rows * f.cols +
               static_cast<long long>(k0) * f.cols;
  for (int e = threadIdx.x; e < tc; e += MG_BLOCK) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < MG_WARPS; ++w) s += tab[w * tc + e];
    out[e] = s;
  }
}

// The second pass: entry e of the K x cols table summed over the partials
// in range order, written to its field's gradient table.
__global__ void __launch_bounds__(MG_BLOCK)
    mat_reduce_kernel(int blocks, int k_rows, const float* __restrict__ partial,
                      const MatFields f) {
  const long long kc = static_cast<long long>(k_rows) * f.cols;
  const long long e = static_cast<long long>(blockIdx.x) * MG_BLOCK + threadIdx.x;
  if (e >= kc) return;
  float s = 0.0f;
#pragma unroll 8
  for (int b = 0; b < blocks; ++b) s += partial[b * kc + e];
  const long long k = e / f.cols;
  const int c = static_cast<int>(e - k * f.cols);
#pragma unroll
  for (int i = 0; i < MG_MAX_FIELDS; ++i)
    if (i < f.count && c >= f.col[i] && c < f.col[i] + f.width[i])
      f.dst[i][k * f.width[i] + c - f.col[i]] = s;
}

// Rows of a tile: as many as MG_WARPS float32 copies of them fit
// MG_SMEM_BYTES.
inline int tile_rows(int cols) {
  return MG_SMEM_BYTES / (MG_WARPS * cols * static_cast<int>(sizeof(float)));
}

// Lane ranges of the scatter for n lanes, each a multiple of 32 lanes, at
// most max_ranges: a function of n and max_ranges alone, so the sums run in
// the same order on every run.
inline int scatter_ranges(int n, int max_ranges, int* rows_per_block) {
  const int b = min((n + MG_BLOCK - 1) / MG_BLOCK, max_ranges);
  *rows_per_block = ((n + b - 1) / b + 31) / 32 * 32;
  return (n + *rows_per_block - 1) / *rows_per_block;
}

template <typename I>
int launch_scatter(int n, int k_rows, int max_ranges, const void* idx, const MatFields& f,
                   float* partial, cudaStream_t s) {
  int rows = 0;
  const int ranges = scatter_ranges(n, max_ranges, &rows);
  const int tr = tile_rows(f.cols);
  const dim3 grid((k_rows + tr - 1) / tr, ranges);
  const size_t smem = static_cast<size_t>(MG_WARPS) * min(tr, k_rows) * f.cols * sizeof(float);
  mat_scatter_kernel<I><<<grid, MG_BLOCK, smem, s>>>(n, k_rows, tr, rows,
                                                    static_cast<const I*>(idx), f, partial);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long kc = static_cast<long long>(k_rows) * f.cols;
  mat_reduce_kernel<<<static_cast<unsigned>((kc + MG_BLOCK - 1) / MG_BLOCK), MG_BLOCK, 0, s>>>(
      ranges, k_rows, partial, f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace pt

// One launch: dst[i][r] = src[i][idx[r]] for the f->count tables, n rows.
// idx is int32, or int64 where idx64. Returns the launch's CUDA error.
extern "C" int pt_mat_gather(int n, int k_rows, int idx64, const void* idx,
                             const pt::MatFields* f, void* stream) {
  if (n == 0) return 0;
  const int grid = (n + pt::MG_BLOCK - 1) / pt::MG_BLOCK;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (idx64)
    pt::mat_gather_kernel<long long><<<grid, pt::MG_BLOCK, 0, s>>>(
        n, k_rows, static_cast<const long long*>(idx), *f);
  else
    pt::mat_gather_kernel<int><<<grid, pt::MG_BLOCK, 0, s>>>(
        n, k_rows, static_cast<const int*>(idx), *f);
  return static_cast<int>(cudaGetLastError());
}

// The gradient tables dst[i] (K, width) of the gradients src[i] (n, width)
// at idx, in two launches; partial holds max_ranges x K x cols floats, and
// dst need not be zeroed. K < 1 or max_ranges < 1 is refused
// (cudaErrorInvalidValue). Returns the first CUDA error.
extern "C" int pt_mat_scatter(int n, int k_rows, int idx64, int max_ranges, const void* idx,
                              const pt::MatFields* f, float* partial, void* stream) {
  if (k_rows < 1 || max_ranges < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return idx64 ? pt::launch_scatter<long long>(n, k_rows, max_ranges, idx, *f, partial, s)
               : pt::launch_scatter<int>(n, k_rows, max_ranges, idx, *f, partial, s);
}

// The constants the wrapper must share: out5 = {threads a block, warps a
// block, fields, width, the tile copies' shared memory budget in bytes}.
// Returns sizeof(MatFields).
extern "C" int pt_mat_layout(int* out5) {
  out5[0] = pt::MG_BLOCK;
  out5[1] = pt::MG_WARPS;
  out5[2] = pt::MG_MAX_FIELDS;
  out5[3] = pt::MG_MAX_WIDTH;
  out5[4] = pt::MG_SMEM_BYTES;
  return static_cast<int>(sizeof(pt::MatFields));
}
