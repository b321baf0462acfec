// The tile helpers of the flash kernels (flash_attention.cu and
// flash_variants_{fwd,bwd}.cu): a block of 4 warps over 64-row tiles of
// one head of a [B, S, H, D] bf16 tensor, read through its row stride
// (H * D), and nvcuda::wmma bf16 16x16x16 products with fp32 accumulators
// whose score tiles go through shared memory. Included by each source,
// which builds into its own library.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int TILE = 64;   // rows per block, keys (or queries) per step
constexpr int WARPS = 4;   // each warp owns 16 rows of the tile
constexpr int THREADS = WARPS * 32;
constexpr int LDS = TILE + 4;  // fp32 score tile row stride (floats)
constexpr int LDP = TILE + 8;  // bf16 probability tile row stride

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragBt = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// shared-memory strides of a [TILE, D] bf16 row tile and a [TILE, D] fp32
// accumulator; the padding (16 bytes) staggers rows across banks and keeps
// every 16-row fragment on a 32-byte boundary, as wmma requires
template <int D>
struct Ld {
  static constexpr int B = D + 8;
  static constexpr int O = D + 4;
};

// rows r0 .. r0 + TILE - 1 of one head of a [.., S, H, D] tensor into
// dst [TILE][D + 8]; row r lies at src + r * stride; rows >= n read as 0.
// SCALE: each value times `cst` in fp32, rounded back to bf16
template <int D, bool SCALE = false>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int r0,
                                          int n, size_t stride,
                                          float cst = 1.f) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
  for (int e = threadIdx.x; e < TILE * CH; e += THREADS) {
    const int r = e / CH, c = (e % CH) * 8;
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < n)
      u = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * stride + c);
    if (SCALE) {
      bf16* h = reinterpret_cast<bf16*>(&u);
#pragma unroll
      for (int x = 0; x < 8; ++x)
        h[x] = __float2bfloat16_rn(__bfloat162float(h[x]) * cst);
    }
    *reinterpret_cast<uint4*>(dst + r * Ld<D>::B + c) = u;
  }
}

// S[16, TILE] = A[16, D] @ Bm[TILE, D]^T, for one warp; A and Bm are row
// tiles in shared memory, S an fp32 tile with row stride LDS
template <int D>
__device__ __forceinline__ void abt(float* S, const bf16* A, const bf16* Bm) {
  FragC c[TILE / 16];
#pragma unroll
  for (int j = 0; j < TILE / 16; ++j) wmma::fill_fragment(c[j], 0.f);
#pragma unroll
  for (int kk = 0; kk < D; kk += 16) {
    FragA a;
    wmma::load_matrix_sync(a, A + kk, Ld<D>::B);
#pragma unroll
    for (int j = 0; j < TILE / 16; ++j) {
      FragBt b;
      wmma::load_matrix_sync(b, Bm + j * 16 * Ld<D>::B + kk, Ld<D>::B);
      wmma::mma_sync(c[j], a, b, c[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < TILE / 16; ++j)
    wmma::store_matrix_sync(S + j * 16, c[j], LDS, wmma::mem_row_major);
}

// acc[n] += P[16, TILE] @ Bm[TILE, D] (16 output columns per fragment),
// P a bf16 tile with row stride LDP
template <int D>
__device__ __forceinline__ void ab_acc(FragC (&acc)[D / 16], const bf16* P,
                                       const bf16* Bm) {
#pragma unroll
  for (int kk = 0; kk < TILE; kk += 16) {
    FragA a;
    wmma::load_matrix_sync(a, P + kk, LDP);
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      FragB b;
      wmma::load_matrix_sync(b, Bm + kk * Ld<D>::B + n * 16, Ld<D>::B);
      wmma::mma_sync(acc[n], a, b, acc[n]);
    }
  }
}

// one warp's 16 accumulator rows through fp32 staging (row stride D + 4)
// to bf16 rows of a [.., S, H, D] tensor, times `mul`; the lane pair
// (2r, 2r + 1) writes row r, rows >= n skipped
template <int D>
__device__ __forceinline__ void store_rows(const FragC (&acc)[D / 16],
                                           float* stage, bf16* dst, int r0,
                                           int n, size_t stride, float mul) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < D / 16; ++j)
    wmma::store_matrix_sync(stage + j * 16, acc[j], Ld<D>::O,
                            wmma::mem_row_major);
  __syncwarp();
  const int r = lane >> 1, half = lane & 1;
  if (r0 + r < n) {
    bf16* out = dst + (size_t)(r0 + r) * stride;
    for (int c = 2 * half; c < D; c += 4) {
      const float* s = stage + r * Ld<D>::O + c;
      *reinterpret_cast<__nv_bfloat162*>(out + c) =
          __floats2bfloat162_rn(s[0] * mul, s[1] * mul);
    }
  }
  __syncwarp();
}

// above 48 KB a block's shared memory must be asked for; callers keep the
// result in a function-local static, so it is asked once per kernel
template <typename Kernel>
int prepare(Kernel kernel, size_t smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
}

}  // namespace
