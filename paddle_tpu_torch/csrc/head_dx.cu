// The softmax term of the lm-head activation gradient:
//   out[M, H] = bf16(exp(min(logits - m[:, None], 0)) * scale[:, None]) @ W^T
// with logits [M, V] bf16, m and scale [M] fp32, W [H, V] bf16 (the lm
// head as the model stores it, read through its rows: no transposed copy
// is made), fp32 accumulation over V, out rounded to bf16 once.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/head_dx.py
// (head_dx_softmax, kernel body _dx_kernel), which the custom-VJP CE tail
// of paddle_tpu/models/llama.py calls for dh's softmax term.
//
// What bounds it on the H100: operations. At the training shape (M 22528
// rows, V 32000, H 768) it does 2 * M * V * H = 1.11 TFLOP against 1.44 GB
// of logits, ~770 flops per byte, far above the card's ~295 flops/byte
// ridge. The design, a tensor-core GEMM whose A-operand prologue is the
// softmax:
// - a block of 8 warps computes a 128 x 128 tile of out, each warp a
//   32 x 64 sub-tile as 2 x 4 nvcuda::wmma bf16 16x16x16 fragments whose
//   fp32 accumulators stay in registers across the whole V loop;
// - the V loop steps 32 columns at a time: each thread loads its share of
//   the next logits tile and W tile into registers (16-byte loads) while
//   the warps multiply the current tiles from shared memory, then turns the
//   logits into probabilities in fp32 (its rows' m and scale are held in
//   registers for the whole loop) and stores them, rounded to bf16, into
//   the other of two shared-memory buffers;
// - rows past M and columns past V or H are masked to exact zeros, so any
//   M is taken (the TPU kernel needs M % block == 0);
// - the six column tiles of one row tile are neighbours in the launch
//   order (blockIdx.x), so the logits rows they share are read from L2.
// wgmma, TMA and a deeper pipeline are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int TM = 128, TN = 128, TK = 32;
constexpr int THREADS = 256;       // 8 warps: 4 along M x 2 along N
constexpr int LDT = TK + 8;        // shared row stride (bf16), 80 bytes
constexpr int CHUNKS = TM * TK / 8 / THREADS;  // 16-byte loads per thread

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragBt = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

__global__ void __launch_bounds__(THREADS)
head_dx_kernel(const bf16* __restrict__ logits, const float* __restrict__ m,
               const float* __restrict__ scale, const bf16* __restrict__ w,
               bf16* __restrict__ out, int M, int V, int H) {
  __shared__ __align__(128) bf16 As[2][TM * LDT];
  __shared__ __align__(128) bf16 Bs[2][TN * LDT];

  const int n0 = blockIdx.x * TN, m0 = blockIdx.y * TM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = (warp & 3) * 32, wn = (warp >> 2) * 64;

  // chunk i of this thread: tile row tid / 4 + 64 * i, columns
  // (tid % 4) * 8 .. + 7 of the 32-column step
  const int cc = (tid & 3) * 8;
  int arow[CHUNKS];
  float am[CHUNKS], asc[CHUNKS];
#pragma unroll
  for (int i = 0; i < CHUNKS; ++i) {
    arow[i] = (tid >> 2) + 64 * i;
    const int gm = m0 + arow[i];
    am[i] = gm < M ? m[gm] : 0.f;
    asc[i] = gm < M ? scale[gm] : 0.f;  // a row past M weighs 0
  }

  uint4 ra[CHUNKS], rb[CHUNKS];
  auto load = [&](int v0) {
#pragma unroll
    for (int i = 0; i < CHUNKS; ++i) {
      const int gm = m0 + arow[i], gn = n0 + arow[i], gv = v0 + cc;
      ra[i] = make_uint4(0u, 0u, 0u, 0u);
      rb[i] = make_uint4(0u, 0u, 0u, 0u);
      if (gv < V) {  // V % 8 == 0: a chunk is wholly in or out
        if (gm < M)
          ra[i] = *reinterpret_cast<const uint4*>(logits + (size_t)gm * V + gv);
        if (gn < H)
          rb[i] = *reinterpret_cast<const uint4*>(w + (size_t)gn * V + gv);
      }
    }
  };
  // probabilities exp(min(l - m, 0)) * scale in fp32, rounded to bf16; the
  // clamp is exact for real rows (m is the row max) and a masked chunk
  // (v >= V) stays 0
  auto stash = [&](int buf, int v0) {
    const bool in_v = v0 + cc < V;
#pragma unroll
    for (int i = 0; i < CHUNKS; ++i) {
      const uint32_t u[4] = {ra[i].x, ra[i].y, ra[i].z, ra[i].w};
      uint32_t p[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float lo = __expf(fminf(bf16_lo(u[j]) - am[i], 0.f)) * asc[i];
        const float hi = __expf(fminf(bf16_hi(u[j]) - am[i], 0.f)) * asc[i];
        p[j] = in_v ? pack(lo, hi) : 0u;
      }
      *reinterpret_cast<uint4*>(&As[buf][arow[i] * LDT + cc]) =
          make_uint4(p[0], p[1], p[2], p[3]);
      *reinterpret_cast<uint4*>(&Bs[buf][arow[i] * LDT + cc]) = rb[i];
    }
  };

  FragC acc[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int nk = (V + TK - 1) / TK;
  load(0);
  stash(0, 0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < nk) load((kt + 1) * TK);  // in flight during the products
#pragma unroll
    for (int kk = 0; kk < TK; kk += 16) {
      FragA a[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], &As[buf][(wm + 16 * i) * LDT + kk], LDT);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // B(v, h) = W[h, v]: the W tile's rows, read column-major
        FragBt b;
        wmma::load_matrix_sync(b, &Bs[buf][(wn + 16 * j) * LDT + kk], LDT);
#pragma unroll
        for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], a[i], b, acc[i][j]);
      }
    }
    if (kt + 1 < nk) stash(buf ^ 1, (kt + 1) * TK);
    __syncthreads();
  }

  // epilogue: each warp stages one 16 x 16 fragment at a time in fp32 (in
  // the A buffers, free now) and writes it as bf16, masked at M and H
  float* stage = reinterpret_cast<float*>(&As[0][0]) + warp * 256;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wmma::store_matrix_sync(stage, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      const int r = lane >> 1, c = (lane & 1) * 8;
      const int gm = m0 + wm + 16 * i + r, gn = n0 + wn + 16 * j + c;
      if (gm < M && gn < H) {  // H % 8 == 0: the 8 columns are in or out
        const float* s = stage + r * 16 + c;
        *reinterpret_cast<uint4*>(out + (size_t)gm * H + gn) =
            make_uint4(pack(s[0], s[1]), pack(s[2], s[3]), pack(s[4], s[5]),
                       pack(s[6], s[7]));
      }
      __syncwarp();
    }
  }
}

}  // namespace

// Device pointers, contiguous, 16-byte aligned: logits [M, V] bf16, m and
// scale [M] fp32, w [H, V] bf16, out [M, H] bf16. V and H multiples of 8.
// Returns the cudaError_t of the launch (0 = success),
// cudaErrorInvalidValue for a shape it does not take.
extern "C" int head_dx_softmax(const void* logits, const void* m,
                               const void* scale, const void* w, void* out,
                               int M, int V, int H, void* stream) {
  if (M < 1 || V < 8 || H < 8 || V % 8 != 0 || H % 8 != 0 ||
      (M + TM - 1) / TM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((H + TN - 1) / TN, (M + TM - 1) / TM);
  head_dx_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(logits), static_cast<const float*>(m),
      static_cast<const float*>(scale), static_cast<const bf16*>(w),
      static_cast<bf16*>(out), M, V, H);
  return static_cast<int>(cudaGetLastError());
}
