// K3 and K4: bit-plane compare of one column against ONE constant, for
// Hopper.
//
// Replaces two TPU kernels in liquid_tpu/ops/bitpack_pallas.py:
//   K3 `count_gt` (body `_cmp_count_kernel`): the number of rows whose
//      value is greater than c;
//   K4 `cmp_const_planes` (body `_cmp_kernel`): the packed (lt, eq) words
//      of every row against c.
// Both run the MSB-first compare of w bit-planes against the unsigned
// 64-bit constant c:
//     lt |= eq & ~p & c_k ;  eq &= ~(p ^ c_k)
// and, when w < 64 and c has a bit at or above w, every stored value is
// smaller than c (lt = all ones, eq = 0; K3's wrapper returns 0 for that
// case without a launch).
//
// Layout: planes u32[w, W] (word j of plane k packs bit k of rows
// 32j..32j+31).  The TPU's [w, W/128, 128] tiling and its TILE_WORDS
// padding do not carry over: the prepped form is the same memory, so
// both kernels read it as [w, W].  PyTorch hands the words over as int32
// tensors with the same bits; c arrives by value, so a loop of launches
// with different constants reads nothing but the planes.
//
// Bound: both read w*W*4 bytes; K4 also writes 2*W*4.  About 5*w word
// operations per 32 rows is far below the card's integer rate, so both
// are memory-bound: at 3.35 TB/s (H100 SXM, 700 W), w = 10 over 2^27
// rows (W = 2^22) reads 168 MB and takes at least ~0.050 ms.
//
// Design: one thread per packed word.  A warp's 32 threads read 32
// neighbouring words of one plane, so each plane load is one coalesced
// 128-byte transaction, and the w loads of a thread are independent (the
// loop is unrolled) so several are in flight.  K3 counts with __popc,
// reduces with warp shuffles, then across the block's warps through
// shared memory, and adds the block's total into one int32 device scalar
// with a single atomicAdd per block.  K4 writes lt and eq directly.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// The compare of word j against c over planes [width, n_words].
__device__ __forceinline__ void cmp_word(const uint32_t* __restrict__ planes,
                                         int64_t n_words, int64_t j,
                                         int width, uint64_t c,
                                         uint32_t& lt, uint32_t& eq) {
  lt = 0u;
  eq = 0xFFFFFFFFu;
#pragma unroll 8
  for (int k = width - 1; k >= 0; --k) {
    const uint32_t pb = __ldg(planes + (int64_t)k * n_words + j);
    const uint32_t cb = ((c >> k) & 1ull) ? 0xFFFFFFFFu : 0u;
    lt |= eq & ~pb & cb;
    eq &= ~(pb ^ cb);
  }
  if (width < 64 && (c >> width) != 0ull) {
    lt = 0xFFFFFFFFu;
    eq = 0u;
  }
}

__global__ void __launch_bounds__(kThreads)
count_gt_kernel(const uint32_t* __restrict__ planes, int64_t n_words,
                int width, uint64_t c, int32_t* __restrict__ out) {
  __shared__ int32_t warp_sums[kWarps];
  const int64_t j = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  int32_t n = 0;
  if (j < n_words) {
    uint32_t lt, eq;
    cmp_word(planes, n_words, j, width, c, lt, eq);
    n = __popc(~(lt | eq));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    n += __shfl_down_sync(0xFFFFFFFFu, n, off);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = n;
  __syncthreads();
  if (warp == 0) {
    n = lane < kWarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int off = kWarps / 2; off > 0; off >>= 1) {
      n += __shfl_down_sync(0xFFFFFFFFu, n, off);
    }
    if (lane == 0 && n != 0) atomicAdd(out, n);
  }
}

__global__ void __launch_bounds__(kThreads)
cmp_const_planes_kernel(const uint32_t* __restrict__ planes, int64_t n_words,
                        int width, uint64_t c, uint32_t* __restrict__ lt_out,
                        uint32_t* __restrict__ eq_out) {
  const int64_t j = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (j >= n_words) return;
  uint32_t lt, eq;
  cmp_word(planes, n_words, j, width, c, lt, eq);
  lt_out[j] = lt;
  eq_out[j] = eq;
}

int grid_for(int64_t n_words) {
  return (int)((n_words + kThreads - 1) / kThreads);
}

}  // namespace

// K3: adds the count of rows > c into *out (an int32 the caller zeroed)
// on `stream`; returns cudaGetLastError() as an int (0 = ok).
extern "C" int count_gt_launch(const void* planes, int64_t n_words,
                               int width, uint64_t c, void* out,
                               void* stream) {
  if (n_words <= 0 || n_words >= (int64_t{1} << 26) || width <= 0 ||
      width > 64) {
    return (int)cudaErrorInvalidValue;
  }
  count_gt_kernel<<<grid_for(n_words), kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const uint32_t*>(planes), n_words, width, c,
      static_cast<int32_t*>(out));
  return (int)cudaGetLastError();
}

// K4: writes the packed (lt, eq) words of every row against c on
// `stream`; returns cudaGetLastError() as an int (0 = ok).
extern "C" int cmp_const_planes_launch(const void* planes, int64_t n_words,
                                       int width, uint64_t c, void* lt,
                                       void* eq, void* stream) {
  if (n_words <= 0 || n_words >= (int64_t{1} << 31) || width <= 0 ||
      width > 64) {
    return (int)cudaErrorInvalidValue;
  }
  cmp_const_planes_kernel<<<grid_for(n_words), kThreads, 0,
                            (cudaStream_t)stream>>>(
      static_cast<const uint32_t*>(planes), n_words, width, c,
      static_cast<uint32_t*>(lt), static_cast<uint32_t*>(eq));
  return (int)cudaGetLastError();
}
