// The packed flash-attention experiments: a forward kernel
// (flash_variants_fwd.cu) and a backward kernel (flash_variants_bwd.cu),
// each a template instance per variant, built as two sources so that nvcc
// compiles them side by side; this header holds what both share.
//
// Replaces the TPU kernels of benchmarks/flash_variants.py:
// - fv_fwd serves make_fwd (run_fwd: nsplit, exp_bf16), make_fwd2
//   (run_fwd2: the scale inside the kernel, l over bf16 p) and
//   make_fwd_diag (the forward ablations of run_diag);
// - fv_bwd serves make_bwd (run_bwd) and make_bwd_diag (the backward
//   ablations), computing dq, dk and dv in one launch.
// The functions are the experiments' own, written out in
// ops/kernels/flash_variants.py (the plain versions and the variant bits
// below). The TPU's packing of 128 / D heads per 128-lane block exists to
// fill a lane tile; here every block reads one head's [S, D] rows of the
// [B, S, H, D] tensors through a TMA map (sm90_tiles.cuh), and lse
// [B, G, hp, S] is the same memory as [B, H, S].
//
// The reference takes the EXACT row max before any exp2 (the whole row
// sits in VMEM), so p = exp2(s - m) is rounded (to bf16, and with
// exp_bf16 its argument too) against the final max; an online softmax
// rounds against a running max, a different function. Two designs give the
// exact max: keep a row tile's fp32 scores on chip (S 512 x 64 rows x 4 B
// = 128 KiB: one block per SM, and a limit on S), or two passes over the
// keys, the first for the max alone. fv_fwd takes two passes: the extra
// q k^T product costs tensor-core time, of which the products here use a
// small share, and it keeps several blocks per SM and every S. So
// dropping "max" (an ablation) drops the first pass. Both passes issue the
// same wgmma sequence on the same tiles, so their fp32 scores are bit for
// bit the same and s - m never exceeds 0.
//
// Conventions: bf16 q, k, v, do, o; scores, max, sums and accumulators
// fp32; p and ds rounded to bf16 before their products (fp32
// accumulation); outputs rounded once. Where the variant rounds exp2's
// argument (exp_bf16), exp2 is bf16's as XLA computes it: exp(x * ln 2)
// in the argument's type, bf16(exp(bf16(x * bf16(ln 2))).
//
// Schedule knobs. nsplit is a run-time argument: row i computes columns
// [0, R * (i / R + 1)) with R = S / nsplit, so nsplit = 1 computes and
// masks the whole square (the experiment's baseline) and a larger nsplit
// skips whole key tiles past a row tile's extent; inside a tile the extent
// is applied per row (R may be below 64). qblocks (run_fwd2) is a TPU grid
// split: blocks here always split q rows, one 64-row tile each.
//
// What bounds them on the H100: at the experiments' shape (B 44, S 512,
// 12 heads of D 64, causal) the forward moves 4 * 34.6 MB of q, k, v and
// out, 0.042 ms at 3.35 TB/s; the backward 8 * 34.6 MB, 0.083 ms. The work
// a variant does is larger than the function's: nsplit 1 computes the
// whole square, the forward's max pass repeats q k^T (three products per
// (query, key) pair, 53 GFLOP, 0.054 ms at 989 TFLOP/s) and the backward
// recomputes the scores in both roles (seven products, 124 GFLOP, 0.125
// ms), beside 138 M exp2 forward (the MUFU's 16 a clock per SM: 0.036
// ms). So the tensor cores and the per-element softmax work bound them,
// not the bytes, and the design is Hopper's:
// - the tiles arrive by TMA. A producer's single thread loads the block's
//   fixed tiles once, then each step's tiles into a two-stage ring, each
//   stage guarded by a full/empty mbarrier pair; the consumer warpgroup
//   (64 rows: wgmma's M) runs the products on a stage that has arrived
//   while the next one loads. No thread spends registers or instructions
//   on a copy.
// - every product is wgmma with its fp32 accumulator in registers: scores
//   (m64n64k16, or m64n32k16 over half a tile in the backward) from two
//   K-major tiles in shared memory; P (or dS) from registers, packed to
//   bf16 in the accumulator's own layout, times a tile read MN-major (the
//   transpose bit). No score, probability or output tile passes through
//   shared memory; row max and sums are quad shuffles.
// - masks cost per element, so each key tile is classified once for the
//   whole block (tile_kind): wholly visible (no test), wholly past the
//   diagonal (p = 0 without exp2, the products still computed: nsplit 1
//   still computes the whole square), or mixed (the per-row extent and
//   causal tests). The dk/dv role tests a per-row lower bound, not a
//   division by R per element.
// - the backward is one grid whose z index picks the block's role: z = 0
//   blocks own a query tile and write dq (ring: k, v), z = 1 blocks own a
//   key tile and write dk and dv with the keys on the rows (ring: q, do,
//   o and the tile's lse), each recomputing the scores it needs (no
//   atomics, so two calls give the same bits). delta = rowsum(do * o) is
//   computed in the kernel from the o tile, as in the reference.
// - several blocks share an SM, so one block's softmax overlaps another's
//   products: the forward's block is the consumers and a producer warp
//   (~106 registers a thread at D 64, three blocks); the backward's dk/dv
//   role holds 64 accumulators a thread, so its producer is a warpgroup
//   that hands its registers to the consumers (setmaxnreg: 24 and 136 of
//   80 at launch), and three blocks fit too. Overlapping the next tile's
//   scores with this tile's softmax inside one warpgroup needs a second
//   score set: past these budgets ptxas serializes the wgmma and spills.

#pragma once

#include <math.h>

#include "sm90_tiles.cuh"

namespace {

constexpr float LN2_BF16 = 0.69140625f;  // ln 2 rounded to bf16

// variant bits, as ops/kernels/flash_variants.py names them
enum : int {
  CAUSAL = 1, EXP_BF16 = 2, P_BF16 = 4, SCALE_IN = 8, DIAG = 16,
  DROP_MASK = 32, DROP_MAX = 64, DROP_SUM = 128, DROP_EXP = 256,
  DROP_DELTA = 512, DROP_DS = 1024
};

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// exp2 as the variant computes it
template <int F>
__device__ __forceinline__ float vexp2(float a) {
  if (F & EXP_BF16) return bf16r(expf(bf16r(bf16r(a) * LN2_BF16)));
  return exp2f(a);
}

// the last column row i computes: its row block's causal extent
__device__ __forceinline__ int extent(int i, int R) {
  return R * (i / R + 1);
}

// how a key tile meets a block's 64 rows, the same for every thread: every
// element visible (inside each row's extent, none past the diagonal),
// every element past the diagonal (and inside the extents), or mixed
enum : int { TILE_MIXED = 0, TILE_VISIBLE = 1, TILE_MASKED = 2 };

// rows r0 .. r0 + 63 (queries) against keys k0 .. k0 + 63, where row i
// computes the columns below its extent; `causal` masks keys past the row
__device__ __forceinline__ int tile_kind(int r0, int k0, int S, int R,
                                         bool causal) {
  if (k0 + TILE > min(S, extent(r0, R))) return TILE_MIXED;
  if (!causal || k0 + TILE - 1 <= r0) return TILE_VISIBLE;
  return k0 > r0 + TILE - 1 ? TILE_MASKED : TILE_MIXED;
}

bool bad_shape(int B, int H, int S, int D, int nsplit) {
  return B < 1 || H < 1 || (long long)B * H > 65535 || S < TILE ||
         S % TILE || nsplit < 1 || S % nsplit || (D != 64 && D != 128);
}

}  // namespace
