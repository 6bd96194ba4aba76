// K1: batched bit-plane compare against per-block constants, for Hopper.
//
// Replaces the TPU kernel `cmp_const_many_pallas` (body `_cmp_many_kernel`)
// in liquid_tpu/ops/bitpack_pallas.py, and the pair of its calls in
// liquid_tpu/sql/fused_agg.py::_in_interval_many.  For each 8192-row
// block b it compares the block's w bit-planes MSB-first against the
// block's own unsigned 64-bit constant c_b:
//     lt |= eq & ~p & c_b ;  eq &= ~(p ^ c_b)
// and, when w < 64 and c_b has a bit at or above w, gives lt = all ones
// and eq = 0 (every stored value is smaller than the constant).  Two
// forms share that compare:
//  - single: (lt, eq) against cs[b];
//  - interval: the packed mask of values in [lo[b], hi[b]],
//    ~lt_lo & (lt_hi | eq_hi), from ONE read of the planes.
//
// Layout: planes u32[B, w, 256] (word j of plane p packs bit p of rows
// 32j..32j+31), constants u64[B], outputs u32[B, 256].  PyTorch hands the
// words over as int32 tensors with the same bits.
//
// Bound: the interval form reads B*w*256*4 + 2*B*8 bytes and writes
// B*256*4; about 10 word operations per plane per word are far below the
// card's integer rate, so it is memory-bound: one SF1 lineitem column
// (733 blocks, w = 12) moves 9.77 MB, 2.9 us at 3.35 TB/s (H100 SXM,
// 700 W).  The single form reads the same planes and writes twice the
// words.  Two single launches per interval (the TPU's form) read the
// planes twice and pay two launches.
//
// Design: one CTA per block and one thread per packed word (256 threads).
// A warp reads 32 neighbouring words of one plane, so every plane load is
// one coalesced 128-byte transaction.  9.77 MB is a latency-bound size:
// the whole read has to be in flight at once, so each thread loads its
// planes 16 at a time into registers (fully unrolled, every load issued
// before the compare chain; w <= 16 is one batch), then runs the compare
// for both constants in one pass over them.  A layout of four words per
// thread (16-byte loads, four blocks per CTA) was not faster at the main
// path's shapes (0.95-1.05x of this one on an H100, PERF.md).  The
// constants' bits come straight from registers.  No shared memory, no
// atomics, no cross-block state.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWords = 256;  // words per 8192-row block
constexpr int kBatch = 16;  // planes loaded per batch

// One MSB-first step: plane word p against bit cb (all ones or zero).
__device__ __forceinline__ void step(uint32_t p, uint32_t cb, uint32_t& lt,
                                     uint32_t& eq) {
  lt |= eq & ~p & cb;
  eq &= ~(p ^ cb);
}

// The compare of planes [k0, k0 + cnt), held in pb, against c0 and, in
// the interval form, c1: one pass over the planes for both constants.
template <bool kTwo>
__device__ __forceinline__ void compare(const uint32_t (&pb)[kBatch], int cnt,
                                        int k0, uint64_t c0, uint64_t c1,
                                        uint32_t& lt0, uint32_t& eq0,
                                        uint32_t& lt1, uint32_t& eq1) {
#pragma unroll
  for (int k = kBatch - 1; k >= 0; --k) {
    if (k < cnt) {
      step(pb[k], 0u - static_cast<uint32_t>((c0 >> (k0 + k)) & 1ull), lt0, eq0);
      if (kTwo) {
        step(pb[k], 0u - static_cast<uint32_t>((c1 >> (k0 + k)) & 1ull), lt1,
             eq1);
      }
    }
  }
}

// Every stored value is below a constant with a bit at or above w.
__device__ __forceinline__ void over_width(uint64_t c, int width, uint32_t& lt,
                                           uint32_t& eq) {
  if (width < 64 && (c >> width) != 0ull) {
    lt = 0xFFFFFFFFu;
    eq = 0u;
  }
}

// kInterval: out0 = mask of [c0, c1]; else out0 = lt, out1 = eq vs c0.
template <bool kInterval>
__global__ void __launch_bounds__(kWords)
cmp_const_many_kernel(const uint32_t* __restrict__ planes,
                      const uint64_t* __restrict__ c0s,
                      const uint64_t* __restrict__ c1s,
                      uint32_t* __restrict__ out0,
                      uint32_t* __restrict__ out1, int width) {
  const int64_t b = blockIdx.x;
  const int j = threadIdx.x;
  const uint32_t* p = planes + b * static_cast<int64_t>(width) * kWords + j;
  const uint64_t c0 = c0s[b];
  const uint64_t c1 = kInterval ? c1s[b] : 0ull;
  uint32_t lt0 = 0u, eq0 = 0xFFFFFFFFu, lt1 = 0u, eq1 = 0xFFFFFFFFu;
  for (int top = width; top > 0; top -= kBatch) {
    const int cnt = top < kBatch ? top : kBatch;
    const int k0 = top - cnt;
    uint32_t pb[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (k < cnt) pb[k] = __ldg(p + static_cast<int64_t>(k0 + k) * kWords);
    }
    compare<kInterval>(pb, cnt, k0, c0, c1, lt0, eq0, lt1, eq1);
  }
  over_width(c0, width, lt0, eq0);
  if (kInterval) {
    over_width(c1, width, lt1, eq1);
    out0[b * kWords + j] = ~lt0 & (lt1 | eq1);
  } else {
    out0[b * kWords + j] = lt0;
    out1[b * kWords + j] = eq0;
  }
}

template <bool kInterval>
int launch(const void* planes, const void* c0, const void* c1, void* out0,
           void* out1, int nblocks, int width, void* stream) {
  if (nblocks <= 0 || width <= 0 || width > 64) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cmp_const_many_kernel<kInterval>
      <<<nblocks, kWords, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const uint32_t*>(planes), static_cast<const uint64_t*>(c0),
          static_cast<const uint64_t*>(c1), static_cast<uint32_t*>(out0),
          static_cast<uint32_t*>(out1), width);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the single form on `stream`: lt/eq u32[nblocks, 256] of the
// planes against cs; returns cudaGetLastError() as an int (0 = ok).
extern "C" int cmp_const_many_launch(const void* planes, const void* cs,
                                     void* lt, void* eq, int nblocks,
                                     int width, void* stream) {
  return launch<false>(planes, cs, nullptr, lt, eq, nblocks, width, stream);
}

// Launches the interval form on `stream`: the mask u32[nblocks, 256] of
// the values in [lo, hi]; returns cudaGetLastError() as an int (0 = ok).
extern "C" int in_interval_many_launch(const void* planes, const void* lo,
                                       const void* hi, void* mask,
                                       int nblocks, int width, void* stream) {
  return launch<true>(planes, lo, hi, mask, nullptr, nblocks, width, stream);
}
