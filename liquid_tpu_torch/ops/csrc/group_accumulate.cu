// K2: exact grouped sums of i32 payload columns, for Hopper.
//
// Replaces the TPU kernel `group_accumulate` (body `_kernel`) in
// liquid_tpu/ops/grouphist_pallas.py.  For slot i32[n] and C separate
// payload columns i32[n] (1 <= C <= 16) it returns the exact sums
//     out[c, s] = sum of col_c[i] over the rows i whose clamped slot is s
// in a column-major i64 buffer out[C, m + 1] that the caller zeroes.  The
// clamp is the reference's: a negative slot goes to the trash row m, every
// slot is clipped to [0, mp - 1] with mp = ((m + 1 + 7) / 8) * 8, and rows
// that land in (m, mp - 1] are dropped.
//
// Bound: it must read 4n + 4nC bytes and write 8(m + 1)C; one add per
// value is far below the card's integer rate, so bytes bound it.  At the
// ClickBench grouped query (n = 4,005,888, C = 7, m + 1 = 16,386) that is
// 129 MB, 0.0385 ms at 3.35 TB/s (H100 SXM, 700 W).
//
// What held the previous Hopper design back: every value went through a
// 64-bit global atomic into one table in the L2 (about 28M of them at
// ClickBench's shape), so it ran at the L2's atomic rate and slowed on the
// skewed key (RegionID is zipf(1.3): a quarter of all rows share one
// slot), and the caller stacked the columns into [n, C] for it.  This
// design keeps the accumulation in each SM's shared memory:
//  - Privatized tables, split by column.  A CTA owns one column c and one
//    range of slots, and keeps that range's table in shared memory (at
//    most 227 KB: 29,056 slots).  When mp slots do not fit, the plan
//    splits [0, mp) into equal ranges; each range's CTAs read every row
//    and skip the slots outside their range.  The grid is (column x range,
//    row chunk), column fastest, with at most one CTA per SM, so all CTAs
//    are resident together and the C CTAs of a chunk stream the same slot
//    words at once: C - 1 of every C reads of `slot` come from the L2.
//  - Columns read in place.  The kernel takes the C column pointers by
//    value and reads `slot` and its column with 16-byte loads (4 rows per
//    thread); the rows past the last multiple of 4 go to one warp.
//  - 32-bit shared atomics.  sm_90 has no native 64-bit shared-memory add:
//    atomicAdd on a shared u64 compiles to a CAS loop (ATOMS.CAST.SPIN.64).
//    So an entry is two u32 words, low and high.  The low word's atomicAdd
//    returns the old word; its wrap is the carry, which is added with the
//    high half of the addend into the high word only when not zero (for a
//    value in [0, 2^31) only on a carry).  Exact modulo 2^64 for any addend.
//  - Skew.  Lanes of one warp that add into the same slot are serialized
//    by the shared-memory unit.  A per-warp merge of equal slots in front
//    of the atomics (__match_any_sync, then __reduce_add_sync of the sums)
//    made the kernel 9.6x slower at ClickBench's shape and 4.4x at TPC-H's
//    supplier sums on an H100 SXM (MATCH.ANY's cost grows with the
//    distinct keys in a warp), so there is none.
//  - Flush.  After its rows a CTA adds each non-zero entry of its table
//    into out[c, s] with one 64-bit global atomic (REDG, native): at most
//    (m + 1) x 8 bytes per CTA, 16.5 MB at ClickBench's shape (126 CTAs),
//    against the 0.9 MB table the bound counts once.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxCols = 16;
constexpr int kMaxSmem = 232448;  // a block's opt-in shared memory on sm_90
constexpr unsigned kFull = 0xFFFFFFFFu;

struct Cols {
  const int32_t* p[kMaxCols];
};

// A range's table: lo[len] then hi[len], the two words of each i64 entry.
struct Table {
  unsigned* lo;
  unsigned* hi;
  __device__ Table(void* smem, int len)
      : lo(static_cast<unsigned*>(smem)), hi(static_cast<unsigned*>(smem) + len) {}
  __device__ void zero(int i) {
    lo[i] = 0u;
    hi[i] = 0u;
  }
  __device__ void add(int i, long long v) {
    const unsigned a = static_cast<unsigned>(v);
    const unsigned old = atomicAdd(lo + i, a);
    const unsigned b = static_cast<unsigned>(static_cast<unsigned long long>(v) >> 32) +
                       (old + a < old ? 1u : 0u);
    if (b != 0u) atomicAdd(hi + i, b);
  }
  __device__ long long get(int i) const {
    return static_cast<long long>((static_cast<unsigned long long>(hi[i]) << 32) | lo[i]);
  }
};

// One row's add: key is its table index (-1: no row, dropped, or outside
// this CTA's range).  A zero adds nothing.
__device__ __forceinline__ void add_row(Table& t, int key, int v) {
  if (key >= 0 && v != 0) t.add(key, v);
}

__global__ void __launch_bounds__(kThreads, 1)
group_accumulate_kernel(const int32_t* __restrict__ slot, Cols cols,
                        unsigned long long* __restrict__ out, int64_t n,
                        int ncols, int m, int range_len,
                        int64_t quads_per_chunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int c = blockIdx.x % ncols;
  const int r0 = (blockIdx.x / ncols) * range_len;
  const int mp_last = ((m + 1 + 7) / 8) * 8 - 1;
  // this CTA's slots: [r0, r0 + len), never past m
  const int len = max(0, min(range_len, m + 1 - r0));
  const int lane = threadIdx.x & 31;
  Table t(smem, range_len);
  for (int i = threadIdx.x; i < range_len; i += kThreads) t.zero(i);
  __syncthreads();

  auto key_of = [&](int s) {
    if (s < 0) s = m;
    if (s > mp_last) s = mp_last;
    s -= r0;  // a slot in (m, mp_last] lies at or past len: dropped
    return static_cast<unsigned>(s) < static_cast<unsigned>(len) ? s : -1;
  };
  // pick the column with constant indices: indexing the by-value struct
  // with c would copy it to the stack
  const int32_t* col = cols.p[0];
#pragma unroll
  for (int i = 1; i < kMaxCols; ++i) {
    if (i == c) col = cols.p[i];
  }
  const int4* slot4 = reinterpret_cast<const int4*>(slot);
  const int4* col4 = reinterpret_cast<const int4*>(col);
  const int64_t n4 = n >> 2;
  const int64_t q0 = static_cast<int64_t>(blockIdx.y) * quads_per_chunk;
  const int64_t q1 = q0 + quads_per_chunk < n4 ? q0 + quads_per_chunk : n4;
  // base is warp-uniform, so whole warps enter and leave the loop
  for (int64_t base = q0 + (threadIdx.x & ~31); base < q1; base += kThreads) {
    const int64_t q = base + lane;
    int4 s = make_int4(-1, -1, -1, -1);
    int4 v = make_int4(0, 0, 0, 0);
    const bool ok = q < q1;
    if (ok) {
      s = __ldg(slot4 + q);
      v = __ldg(col4 + q);
    }
    add_row(t, ok ? key_of(s.x) : -1, v.x);
    add_row(t, ok ? key_of(s.y) : -1, v.y);
    add_row(t, ok ? key_of(s.z) : -1, v.z);
    add_row(t, ok ? key_of(s.w) : -1, v.w);
  }
  if (blockIdx.y == gridDim.y - 1 && threadIdx.x < 32) {
    // the last n % 4 rows
    const int64_t i = 4 * n4 + lane;
    const bool ok = i < n;
    add_row(t, ok ? key_of(__ldg(slot + i)) : -1, ok ? __ldg(col + i) : 0);
  }
  __syncthreads();

  unsigned long long* dst = out + static_cast<int64_t>(c) * (m + 1) + r0;
  for (int i = threadIdx.x; i < len; i += kThreads) {
    const long long v = t.get(i);
    if (v != 0) atomicAdd(dst + i, static_cast<unsigned long long>(v));
  }
}

int launch(const int32_t* slot, const Cols& cols, unsigned long long* out,
           int64_t n, int ncols, int m, int range_len, int ranges,
           int64_t quads_per_chunk, int chunks, int smem,
           cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      group_accumulate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  group_accumulate_kernel<<<dim3(ncols * ranges, chunks), kThreads, smem,
                            stream>>>(slot, cols, out, n, ncols, m, range_len,
                                      quads_per_chunk);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches K2 on `stream` over a zeroed column-major out[cols, m + 1].
// `col_ptrs` holds `cols` device pointers (16-byte aligned, as is `slot`).
// The plan (grouphist_cuda.plan): `ranges` slot ranges of `range_len`
// slots covering [0, mp), `chunks` row chunks of `quads_per_chunk` groups
// of 4 rows.  Returns cudaGetLastError() as an int (0 = ok); n == 0
// launches nothing.
extern "C" int group_accumulate_launch(const void* slot,
                                       const void* const* col_ptrs,
                                       void* out, long long n, int cols,
                                       int m, int range_len, int ranges,
                                       long long quads_per_chunk, int chunks,
                                       void* stream) {
  const int mp = ((m + 1 + 7) / 8) * 8;
  const long long smem = 8ll * range_len;
  if (n < 0 || cols <= 0 || cols > kMaxCols || m < 0 || m >= 65536 ||
      range_len <= 0 || ranges <= 0 ||
      static_cast<long long>(range_len) * ranges < mp ||
      static_cast<long long>(range_len) * (ranges - 1) >= mp ||
      smem > kMaxSmem || chunks <= 0 || chunks > 65535 ||
      quads_per_chunk <= 0 || quads_per_chunk * chunks < (n >> 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  Cols c{};
  for (int i = 0; i < cols; ++i) {
    c.p[i] = static_cast<const int32_t*>(col_ptrs[i]);
  }
  return launch(static_cast<const int32_t*>(slot), c,
                static_cast<unsigned long long*>(out), n, cols, m, range_len,
                ranges, quads_per_chunk, chunks, static_cast<int>(smem),
                static_cast<cudaStream_t>(stream));
}
