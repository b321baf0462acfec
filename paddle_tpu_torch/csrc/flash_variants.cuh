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
// [B, S, H, D] tensors through their stride (H * D elements), and lse
// [B, G, hp, S] is the same memory as [B, H, S].
//
// The reference takes the EXACT row max before any exp2 (the whole row
// sits in VMEM), so p = exp2(s - m) is rounded (to bf16, and with
// exp_bf16 its argument too) against the final max; an online softmax
// rounds against a running max, a different function. Two designs give the
// exact max: keep a row tile's fp32 scores in shared memory (S 512 x 64
// rows x 4 B = 128 KiB: one block per SM, and a limit on S), or two passes
// over the keys, the first for the max alone. fv_fwd takes two passes: the
// extra q k^T product costs tensor-core time, of which the products here
// use a small share, and it keeps three blocks per SM and every S. So
// dropping "max" (an ablation) drops the first pass.
//
// Conventions: bf16 q, k, v, do, o; scores, max, sums and accumulators
// fp32; p and ds rounded to bf16 before their products (fp32
// accumulation); outputs rounded once. Where the variant rounds exp2's
// argument (exp_bf16), exp2 is bf16's as XLA computes it: exp(x * ln 2)
// in the argument's type, bf16(exp(bf16(x * bf16(ln 2)))).
//
// Schedule knobs. nsplit is a run-time argument: row i computes columns
// [0, R * (i / R + 1)) with R = S / nsplit, so nsplit = 1 computes and
// masks the whole square (the experiment's baseline) and a larger nsplit
// skips whole key tiles past a row tile's extent. qblocks (run_fwd2) is a
// TPU grid split: blocks here always split q rows, one 64-row tile each.
//
// What bounds them on the H100: at the experiments' shape (B 44, S 512,
// 12 heads of D 64, causal) the forward moves 4 * 34.6 MB of q, k, v and
// out, 0.042 ms at 3.35 TB/s, against 0.018 ms for the products over the
// visible (query, key) pairs; the backward moves 8 * 34.6 MB (0.083 ms)
// against 0.045 ms for its five products. Bytes bound both, whatever
// share of the square a variant computes (nsplit 1 computes all of it,
// 0.036 and 0.090 ms of products). The design is
// that of flash_attention.cu, whose tile helpers it shares
// (flash_tiles.cuh: a block of 4 warps per (b * h, 64-row tile), each warp
// 16 rows; nvcuda::wmma bf16 16x16x16 products whose fp32 score tile goes
// through shared memory, where a lane pair applies mask and softmax to one
// row and writes the bf16 probabilities back as the next product's A
// operand), with two changes: the forward's output accumulator stays in
// registers (no running max, so no rescaling), and the backward is one
// grid whose z index picks the block's role: z = 0 blocks own a query tile
// and write dq, z = 1 blocks own a key tile and write dk and dv, each
// recomputing the scores it needs (no atomics). delta = rowsum(do * o) is
// computed in the kernel, as in the reference. wgmma, TMA and cp.async are
// left for later work.

#pragma once

#include <math.h>

#include "flash_tiles.cuh"

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

bool bad_shape(int B, int H, int S, int D, int nsplit) {
  return B < 1 || H < 1 || (long long)B * H > 65535 || S < TILE ||
         S % TILE || nsplit < 1 || S % nsplit || (D != 64 && D != 128);
}

}  // namespace
