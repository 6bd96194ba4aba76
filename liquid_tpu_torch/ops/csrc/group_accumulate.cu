// K2: exact grouped sums of i32 payload columns, for Hopper.
//
// Replaces the TPU kernel `group_accumulate` (body `_kernel`) in
// liquid_tpu/ops/grouphist_pallas.py.  For slot i32[n] and vals i32[n, C]
// (C <= 16) it returns out i64[m + 1, C] with
//     out[s, c] = sum of vals[i, c] over the rows i whose clamped slot is s.
// The clamp is the reference's: a negative slot goes to the trash row m,
// every slot is clipped to [0, mp - 1] with mp = ((m + 1 + 7) / 8) * 8, and
// rows that land in (m, mp - 1] are dropped.  The caller zeroes `out`.
//
// The TPU kernel kept i32 tables in VMEM, rotated them across rows and
// flushed them every `seg` tiles so that no i32 window overflowed.  Hopper
// has native 64-bit atomics, so this kernel adds into the i64 table in
// device memory directly: exact for any i32 input, with no tiling
// contract on n.
//
// Bound: it reads 4n + 4nC bytes and writes 8(m + 1)C; it does one add per
// value, far below the card's integer rate, so it is memory-bound.  For
// the ClickBench grouped query at 4M rows (n = 4,005,888, C = 7) that is
// about 129 MB, or 0.039 ms at 3.35 TB/s (H100 SXM, 700 W).
//
// Design: a grid-stride loop over tiles of 256 rows, one thread per row,
// in two steps per tile.
//  1. Aggregate.  The block copies its tile of vals into shared memory
//     with coalesced loads, widened to i64.  Each warp groups its lanes
//     by slot (__match_any_sync) and sums each group's values by pointer
//     jumping over the group's lanes with shuffles (log2 of the largest
//     group steps); the group's lowest lane keeps the sum in its tile row,
//     the others drop out.  A warp whose 32 slots all differ skips this.
//  2. Flush.  Each warp walks its 32 tile rows as (row, column) pairs, so
//     consecutive lanes add into consecutive columns of one table row and
//     a warp's atomics land on a few sectors instead of 32.
// Skewed keys (ClickBench's RegionID is zipf(1.3): a quarter of all rows
// share one slot) would make same-address atomics serialize at the L2.
// So a slot seen twice in one warp is hot: its group sum goes to a small
// direct-mapped cache of 32 slots in the block's shared memory (claimed
// by atomicCAS, added with shared atomics), which the block flushes once
// at its end.  The full table does not fit in shared memory (16,386 x 7 x
// 8 B is about 0.9 MB).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxCols = 16;
constexpr int kCache = 32;  // hot-slot cache entries per block
constexpr unsigned kFull = 0xFFFFFFFFu;

__global__ void __launch_bounds__(kThreads)
group_accumulate_kernel(const int32_t* __restrict__ slot,
                        const int32_t* __restrict__ vals,
                        unsigned long long* __restrict__ out,
                        int64_t n, int cols, int m, int mp_last) {
  __shared__ long long tile[kThreads * kMaxCols];
  __shared__ int keys[kThreads];
  __shared__ int tag[kCache];
  __shared__ unsigned long long hot[kCache * kMaxCols];
  const int lane = threadIdx.x & 31;
  const int wrow = threadIdx.x & ~31;  // the warp's first tile row
  for (int i = threadIdx.x; i < kCache * cols; i += kThreads) hot[i] = 0ull;
  if (threadIdx.x < kCache) tag[threadIdx.x] = -1;

  const int64_t stride = (int64_t)gridDim.x * kThreads;
  for (int64_t base = (int64_t)blockIdx.x * kThreads; base < n;
       base += stride) {
    const int64_t rows = n - base < kThreads ? n - base : kThreads;
    const int elems = (int)rows * cols;
    const int32_t* src = vals + base * cols;
    for (int k = threadIdx.x; k < elems; k += kThreads) {
      tile[k] = (long long)__ldg(src + k);
    }
    // key -1: no row here, a row clipped beyond m (dropped), or a row
    // whose value went to its group's leader or to the hot cache
    const int64_t i = base + threadIdx.x;
    int key = -1;
    if (i < n) {
      int s = __ldg(slot + i);
      if (s < 0) s = m;
      if (s > mp_last) s = mp_last;
      if (s <= m) key = s;
    }
    __syncthreads();
    long long* row = tile + threadIdx.x * cols;

    const unsigned peers = __match_any_sync(kFull, key);
    if (!__all_sync(kFull, peers == (1u << lane))) {
      // jump[st]: the lane 2^st places after this one in its group (-1
      // past the group's end); 5 steps cover a 32-lane group
      const unsigned above = peers & ~((2u << lane) - 1u);
      int nx = above ? __ffs(above) - 1 : -1;
      int jump[5];
      int steps = 0;
#pragma unroll
      for (int st = 0; st < 5; ++st) {
        if (!__any_sync(kFull, nx >= 0)) break;
        jump[st] = nx;
        steps = st + 1;
        const int far = __shfl_sync(kFull, nx, nx >= 0 ? nx : lane);
        nx = nx >= 0 ? far : -1;
      }
      for (int c = 0; c < cols; ++c) {
        long long v = key >= 0 ? row[c] : 0ll;
#pragma unroll
        for (int st = 0; st < 5; ++st) {
          if (st >= steps) break;
          const long long o =
              __shfl_sync(kFull, v, jump[st] >= 0 ? jump[st] : lane);
          if (jump[st] >= 0) v += o;
        }
        row[c] = v;  // only the leader's row is read from here on
      }
      const bool leader = (peers & ((1u << lane) - 1u)) == 0u;
      if (!leader) {
        key = -1;
      } else if (key >= 0 && __popc(peers) > 1) {
        const int e = key & (kCache - 1);
        const int prev = atomicCAS(tag + e, -1, key);
        if (prev == -1 || prev == key) {
          for (int c = 0; c < cols; ++c) {
            atomicAdd(hot + e * cols + c, (unsigned long long)row[c]);
          }
          key = -1;
        }
      }
    }
    keys[threadIdx.x] = key;
    __syncwarp();
    for (int k = lane; k < 32 * cols; k += 32) {
      const int r = k / cols;
      const int s = keys[wrow + r];
      if (s >= 0) {
        atomicAdd(out + (int64_t)s * cols + (k - r * cols),
                  (unsigned long long)tile[wrow * cols + k]);
      }
    }
    __syncthreads();  // the tile is refilled on the next pass
  }

  __syncthreads();
  for (int k = threadIdx.x; k < kCache * cols; k += kThreads) {
    const int s = tag[k / cols];
    const unsigned long long v = hot[k];
    if (s >= 0 && v != 0ull) {
      atomicAdd(out + (int64_t)s * cols + (k % cols), v);
    }
  }
}

}  // namespace

// Launches K2 on `stream` over a zeroed out[m + 1, cols]; returns
// cudaGetLastError() as an int (0 = ok).
extern "C" int group_accumulate_launch(const void* slot, const void* vals,
                                       void* out, long long n, int cols,
                                       int m, int blocks, void* stream) {
  if (n < 0 || cols <= 0 || cols > kMaxCols || m < 0 || m >= 65536 ||
      blocks <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return 0;
  const int mp_last = ((m + 1 + 7) / 8) * 8 - 1;
  group_accumulate_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const int32_t*>(slot), static_cast<const int32_t*>(vals),
      static_cast<unsigned long long*>(out), (int64_t)n, cols, m, mp_last);
  return (int)cudaGetLastError();
}
