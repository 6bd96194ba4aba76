// K1: batched bit-plane compare against per-block constants, for Hopper.
//
// Replaces the TPU kernel `cmp_const_many_pallas` (body `_cmp_many_kernel`)
// in liquid_tpu/ops/bitpack_pallas.py.  For each 8192-row block b it
// compares the block's w bit-planes MSB-first against the block's own
// unsigned 64-bit constant c_b:
//     lt |= eq & ~p & c_b ;  eq &= ~(p ^ c_b)
// and, when w < 64 and c_b has a bit at or above w, returns lt = all ones
// and eq = 0 (every stored value is smaller than the constant).
//
// Layout: planes u32[B, w, 256] (word j of plane p packs bit p of rows
// 32j..32j+31), cs u64[B], lt/eq u32[B, 256].  PyTorch hands the words
// over as int32 tensors with the same bits.
//
// Bound: the kernel reads B*w*256*4 + B*8 bytes and writes 2*B*256*4;
// it does about 5*w word operations per 32 rows, far below the card's
// integer rate, so it is memory-bound: at 3.35 TB/s (H100 SXM, 700 W)
// one SF1 lineitem column (733 blocks, w = 12) moves about 10 MB and
// takes at least ~3 us.
//
// Design: one CTA per block and one thread per packed word (256 threads).
// A warp's 32 threads read 32 neighbouring words of one plane, so every
// plane load is one coalesced 128-byte transaction; the loop over planes
// is unrolled so several loads are in flight per thread.  The constant's
// bits come straight from cs[b] in a register (the TPU kernel needed an
// SMEM table of per-plane masks).  No shared memory, no atomics, no
// cross-block state: blocks finish in any order.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWords = 256;  // words per 8192-row block

__global__ void __launch_bounds__(kWords)
cmp_const_many_kernel(const uint32_t* __restrict__ planes,
                      const uint64_t* __restrict__ cs,
                      uint32_t* __restrict__ lt_out,
                      uint32_t* __restrict__ eq_out,
                      int width) {
  const int64_t b = blockIdx.x;
  const int j = threadIdx.x;
  const uint64_t c = cs[b];
  const uint32_t* p = planes + b * (int64_t)width * kWords + j;
  uint32_t lt = 0u;
  uint32_t eq = 0xFFFFFFFFu;
#pragma unroll 8
  for (int k = width - 1; k >= 0; --k) {
    const uint32_t pb = __ldg(p + (int64_t)k * kWords);
    const uint32_t cb = ((c >> k) & 1ull) ? 0xFFFFFFFFu : 0u;
    lt |= eq & ~pb & cb;
    eq &= ~(pb ^ cb);
  }
  if (width < 64 && (c >> width) != 0ull) {
    lt = 0xFFFFFFFFu;
    eq = 0u;
  }
  lt_out[b * kWords + j] = lt;
  eq_out[b * kWords + j] = eq;
}

}  // namespace

// Launches K1 on `stream`; returns cudaGetLastError() as an int (0 = ok).
extern "C" int cmp_const_many_launch(const void* planes, const void* cs,
                                     void* lt, void* eq, int nblocks,
                                     int width, void* stream) {
  if (nblocks <= 0 || width <= 0 || width > 64) {
    return (int)cudaErrorInvalidValue;
  }
  cmp_const_many_kernel<<<nblocks, kWords, 0, (cudaStream_t)stream>>>(
      static_cast<const uint32_t*>(planes), static_cast<const uint64_t*>(cs),
      static_cast<uint32_t*>(lt), static_cast<uint32_t*>(eq), width);
  return (int)cudaGetLastError();
}
