// K4, fused form: one shard's whole bit-plane selection in one launch, for
// Hopper.
//
// Replaces, on the mesh's selection path, the chain of the TPU kernel
// `cmp_const_planes` (liquid_tpu/ops/bitpack_pallas.py, body `_cmp_kernel`)
// that liquid_tpu/parallel/session.py::_selection_body runs once per
// bit-plane predicate through `bp.cmp_const_op`, with the op applied to
// its (lt, eq) and the result ANDed into the selection and then with the
// column's validity.  Here one launch computes, for up to kMaxPreds
// predicate descriptors d,
//
//     sel_out = sel_in & AND_d( op0_d(x, c0_d) & op1_d(x, c1_d) & valid_d )
//
// where x is the column whose planes u32[w_d, W] the descriptor names
// (word j of plane k packs bit k of rows 32j..32j+31), op is one of eq,
// ne, lt, lt_eq, gt, gt_eq, and valid_d is the column's packed validity
// or absent (all ones).  A descriptor holds two compares so that two
// bounds on one column (BETWEEN, or a pair of comparisons) read its
// planes once; a single compare repeats its op and constant.  Each
// compare is the MSB-first walk over the planes
//     lt |= eq & ~p & c_k ;  eq &= ~(p ^ c_k)
// and, when w < 64 and c has a bit at or above w (w = 0 included: an
// all-zero column), every stored value is below c: lt = all ones, eq = 0.
// Both cases are decided here, per descriptor, with no host detour.
//
// Bound: the planes read once (sum of w_d * W * 4 bytes), sel_in, each
// validity and sel_out (W * 4 bytes each); about 10 word operations per
// plane per word (two compares) are far below the card's integer rate,
// so it is memory-bound.  At the mesh's shard shape (TPC-H SF 1
// lineitem over four shards: W = 46,863, a 12-plane date) that is 2.6 MB,
// under a microsecond at 3.35 TB/s: the cost is launches and dependent
// DRAM round trips, not bandwidth.  The single-form chain it replaces
// pays, per predicate, one K4 launch that writes lt and eq (2 * W words
// read back once), one or two op kernels and two AND kernels.
//
// Design:
//  - one launch per shard per table scan: the descriptors arrive by
//    value as a __grid_constant__ kernel parameter (no descriptor buffer
//    is copied to the device), so the host's cost is one launch; the
//    wrapper chains ceil(D / kMaxPreds) launches on sel for more, and
//    hands each launch one packed host block (sel pointers, W and the
//    descriptors) through one pointer;
//  - one thread per packed word, so a warp's plane load is one coalesced
//    128-byte transaction.  Shared memory, TMA and tensor cores buy
//    nothing for a single-use streaming read with no reuse, and K1's
//    16-byte layout (four words per thread) measured 0.95-1.05x of one
//    word per thread on an H100 (PERF.md);
//  - a descriptor's planes come in chunks of kBatch predicated
//    `ld.global.nc` loads, fully unrolled, all issued before the first
//    compare of the chunk; the next chunk (the rest of this column, or
//    the next descriptor's first planes and validity) is issued before
//    this one is compared, so the loads of different predicates overlap;
//  - lt and eq stay in registers; the ops and every AND are applied
//    there, and only sel_out goes back to memory: W words, against 2 * P
//    * W words of (lt, eq) before.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPreds = 16;  // descriptors per launch (the wrapper's cap)
constexpr int kBatch = 16;     // planes loaded per chunk

enum Op : int32_t { kEq = 0, kNe = 1, kLt = 2, kLtEq = 3, kGt = 4, kGtEq = 5 };

// One descriptor, as the wrapper packs it (little-endian "<QQQQiiii").
struct Pred {
  const uint32_t* planes;  // [width, n_words]; unread when width == 0
  const uint32_t* valid;   // [n_words], or null
  uint64_t c0, c1;
  int32_t width;           // 0..64
  int32_t op0, op1;
  int32_t pad;
};
static_assert(sizeof(Pred) == 48, "descriptor layout");

struct Preds {
  Pred p[kMaxPreds];
  int32_t n;
};

// The head of a launch's parameter block ("<QQqi4x"); n descriptors
// follow it.
struct Head {
  const uint32_t* sel_in;
  uint32_t* sel_out;
  int64_t n_words;
  int32_t n;
  int32_t pad;
};
static_assert(sizeof(Head) == 32, "head layout");

__device__ __forceinline__ uint32_t apply(int32_t op, uint32_t lt,
                                          uint32_t eq) {
  switch (op) {
    case kEq: return eq;
    case kNe: return ~eq;
    case kLt: return lt;
    case kLtEq: return lt | eq;
    case kGt: return ~(lt | eq);
    default: return ~lt;  // kGtEq
  }
}

// Planes [k0, k0 + cnt) of word j into pb: every load issued, none used.
__device__ __forceinline__ void load_chunk(const uint32_t* planes,
                                           int64_t n_words, int64_t j, int k0,
                                           int cnt, uint32_t (&pb)[kBatch]) {
#pragma unroll
  for (int k = 0; k < kBatch; ++k) {
    if (k < cnt) pb[k] = __ldg(planes + (int64_t)(k0 + k) * n_words + j);
  }
}

// The MSB-first compare of planes [k0, k0 + cnt), held in pb, against
// both constants in one pass.
__device__ __forceinline__ void compare(const uint32_t (&pb)[kBatch], int cnt,
                                        int k0, uint64_t c0, uint64_t c1,
                                        uint32_t& lt0, uint32_t& eq0,
                                        uint32_t& lt1, uint32_t& eq1) {
#pragma unroll
  for (int k = kBatch - 1; k >= 0; --k) {
    if (k < cnt) {
      const uint32_t p = pb[k];
      const uint32_t b0 = 0u - static_cast<uint32_t>((c0 >> (k0 + k)) & 1ull);
      const uint32_t b1 = 0u - static_cast<uint32_t>((c1 >> (k0 + k)) & 1ull);
      lt0 |= eq0 & ~p & b0;
      eq0 &= ~(p ^ b0);
      lt1 |= eq1 & ~p & b1;
      eq1 &= ~(p ^ b1);
    }
  }
}

// One compare's mask, after the rule for a constant at or above 2^w.
__device__ __forceinline__ uint32_t finish(int32_t op, uint64_t c, int width,
                                          uint32_t lt, uint32_t eq) {
  if (width < 64 && (c >> width) != 0ull) {
    lt = 0xFFFFFFFFu;
    eq = 0u;
  }
  return apply(op, lt, eq);
}

__global__ void __launch_bounds__(kThreads)
select_planes_kernel(const __grid_constant__ Preds preds,
                     const uint32_t* sel_in, uint32_t* sel_out,
                     int64_t n_words) {
  // sel_in may be sel_out (a chained launch): each thread reads its word
  // before it writes it, and no other thread touches that word.
  const int64_t j = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (j >= n_words) return;
  const int n = preds.n;
  // the cursor: descriptor d, its planes [0, top) still to compare
  int d = 0;
  int top = preds.p[0].width;
  int cnt = top < kBatch ? top : kBatch;
  uint32_t cur[kBatch];
  load_chunk(preds.p[0].planes, n_words, j, top - cnt, cnt, cur);
  uint32_t v_cur = preds.p[0].valid ? __ldg(preds.p[0].valid + j) : ~0u;
  uint32_t acc = sel_in[j];
  uint32_t lt0 = 0u, eq0 = 0xFFFFFFFFu, lt1 = 0u, eq1 = 0xFFFFFFFFu;
  while (true) {
    // issue the next chunk before comparing this one
    const int rest = top - cnt;
    int nd = d, ntop = rest;
    if (rest == 0) {
      nd = d + 1;
      ntop = nd < n ? preds.p[nd].width : 0;
    }
    const int ncnt = ntop < kBatch ? ntop : kBatch;
    uint32_t nxt[kBatch];
    uint32_t v_nxt = ~0u;
    if (nd < n) {
      load_chunk(preds.p[nd].planes, n_words, j, ntop - ncnt, ncnt, nxt);
      if (nd != d && preds.p[nd].valid) v_nxt = __ldg(preds.p[nd].valid + j);
    }
    const Pred& p = preds.p[d];
    compare(cur, cnt, rest, p.c0, p.c1, lt0, eq0, lt1, eq1);
    if (rest == 0) {  // descriptor d is complete
      acc &= finish(p.op0, p.c0, p.width, lt0, eq0) &
             finish(p.op1, p.c1, p.width, lt1, eq1) & v_cur;
      lt0 = lt1 = 0u;
      eq0 = eq1 = 0xFFFFFFFFu;
      v_cur = v_nxt;
    }
    if (nd >= n) break;
    d = nd;
    top = ntop;
    cnt = ncnt;
#pragma unroll
    for (int k = 0; k < kBatch; ++k) cur[k] = nxt[k];
  }
  sel_out[j] = acc;
}

}  // namespace

// The fused selection of one shard.  `block` is the host-side parameter
// block the wrapper packs: a Head (sel_in and sel_out, int32[n_words] on
// the card, possibly the same buffer; n_words; n) and n descriptors
// (1 <= n <= kMaxPreds), copied into the kernel's parameter.  One
// pointer and the stream keep the ctypes call short.  Launches on
// `stream`; returns cudaGetLastError() as an int (0 = ok).
extern "C" int select_planes_launch(const void* block, void* stream) {
  Head h;
  std::memcpy(&h, block, sizeof h);
  if (h.n <= 0 || h.n > kMaxPreds || h.n_words <= 0 ||
      h.n_words >= (int64_t{1} << 31)) {
    return (int)cudaErrorInvalidValue;
  }
  Preds preds = {};
  std::memcpy(preds.p, static_cast<const char*>(block) + sizeof h,
              sizeof(Pred) * h.n);
  for (int i = 0; i < h.n; ++i) {
    const Pred& p = preds.p[i];
    if (p.width < 0 || p.width > 64 || (p.width > 0 && !p.planes) ||
        p.op0 < kEq || p.op0 > kGtEq || p.op1 < kEq || p.op1 > kGtEq) {
      return (int)cudaErrorInvalidValue;
    }
  }
  preds.n = h.n;
  const int grid = (int)((h.n_words + kThreads - 1) / kThreads);
  select_planes_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      preds, h.sel_in, h.sel_out, h.n_words);
  return (int)cudaGetLastError();
}
