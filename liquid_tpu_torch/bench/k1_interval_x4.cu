// K1's interval form in a second layout, for measurement only:
// liquid_tpu_torch/bench/k1_layouts.py times it against the layout the
// port ships (ops/csrc/cmp_const_many.cu: one word per thread, one block
// per 256-thread CTA).  Nothing in the port calls it.
//
// Layout: four words per thread, one 16-byte load per plane; 64 threads
// per 8192-row block and four blocks per 256-thread CTA.  The compare is
// the shipped kernel's, word by word: MSB-first against lo[b] and hi[b]
// in one pass, the over-width rule per constant, and the mask
// ~lt_lo & (lt_hi | eq_hi).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kWords = 256;  // words per 8192-row block
constexpr int kQuads = kWords / 4;  // threads per block
constexpr int kBlocksPerCta = 4;
constexpr int kBatch = 16;  // planes loaded per batch

__device__ __forceinline__ void step(uint32_t p, uint32_t cb, uint32_t& lt,
                                     uint32_t& eq) {
  lt |= eq & ~p & cb;
  eq &= ~(p ^ cb);
}

__device__ __forceinline__ void over_width(uint64_t c, int width, uint32_t& lt,
                                           uint32_t& eq) {
  if (width < 64 && (c >> width) != 0ull) {
    lt = 0xFFFFFFFFu;
    eq = 0u;
  }
}

__global__ void __launch_bounds__(kQuads * kBlocksPerCta)
in_interval_x4_kernel(const uint4* __restrict__ planes,
                      const uint64_t* __restrict__ los,
                      const uint64_t* __restrict__ his,
                      uint4* __restrict__ mask, int nblocks, int width) {
  const int64_t b =
      static_cast<int64_t>(blockIdx.x) * kBlocksPerCta + threadIdx.x / kQuads;
  if (b >= nblocks) return;
  const int q = threadIdx.x % kQuads;
  const uint4* p = planes + b * static_cast<int64_t>(width) * kQuads + q;
  const uint64_t c0 = los[b];
  const uint64_t c1 = his[b];
  uint32_t lt0[4] = {0u, 0u, 0u, 0u};
  uint32_t lt1[4] = {0u, 0u, 0u, 0u};
  uint32_t eq0[4] = {~0u, ~0u, ~0u, ~0u};
  uint32_t eq1[4] = {~0u, ~0u, ~0u, ~0u};
  for (int top = width; top > 0; top -= kBatch) {
    const int cnt = top < kBatch ? top : kBatch;
    const int k0 = top - cnt;
    uint4 pb[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (k < cnt) pb[k] = __ldg(p + static_cast<int64_t>(k0 + k) * kQuads);
    }
#pragma unroll
    for (int k = kBatch - 1; k >= 0; --k) {
      if (k < cnt) {
        const uint32_t b0 = 0u - static_cast<uint32_t>((c0 >> (k0 + k)) & 1ull);
        const uint32_t b1 = 0u - static_cast<uint32_t>((c1 >> (k0 + k)) & 1ull);
        const uint32_t w[4] = {pb[k].x, pb[k].y, pb[k].z, pb[k].w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          step(w[i], b0, lt0[i], eq0[i]);
          step(w[i], b1, lt1[i], eq1[i]);
        }
      }
    }
  }
  uint32_t r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    over_width(c0, width, lt0[i], eq0[i]);
    over_width(c1, width, lt1[i], eq1[i]);
    r[i] = ~lt0[i] & (lt1[i] | eq1[i]);
  }
  mask[b * kQuads + q] = make_uint4(r[0], r[1], r[2], r[3]);
}

}  // namespace

// Same contract as in_interval_many_launch in ops/csrc/cmp_const_many.cu:
// the mask u32[nblocks, 256] of the values in [lo, hi]; planes and mask
// 16-byte aligned.  Returns cudaGetLastError() as an int (0 = ok).
extern "C" int in_interval_x4_launch(const void* planes, const void* lo,
                                     const void* hi, void* mask, int nblocks,
                                     int width, void* stream) {
  if (nblocks <= 0 || width <= 0 || width > 64) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int ctas = (nblocks + kBlocksPerCta - 1) / kBlocksPerCta;
  in_interval_x4_kernel<<<ctas, kQuads * kBlocksPerCta, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(planes), static_cast<const uint64_t*>(lo),
      static_cast<const uint64_t*>(hi), static_cast<uint4*>(mask), nblocks,
      width);
  return static_cast<int>(cudaGetLastError());
}
