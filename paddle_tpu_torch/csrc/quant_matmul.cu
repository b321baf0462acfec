// Weight-only quantized matmul: out = x @ (w * scale), dequantized in the
// kernel.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/tick_fusion.py
// (quant_matmul, kernel body _quant_matmul_kernel).
//
// out[b, n] = scale[n] * sum_k float(x[b, k]) * float(w[k, n]), all fp32:
// x [B, K] fp32 or bf16, w [K, N] int8 or fp8-e4m3fn (row-major), scale [N]
// fp32 (one per output channel), out [B, N] fp32. The TPU kernel
// multiplies each weight by its column's scale before the dot; here the
// scale multiplies each column's sum once, after it (the same function;
// the rounding differs by a few fp32 ulps of the sum).
//
// What bounds it on the H100: bytes. On the decode tick B is the number of
// slots (8) and 1 on the admit's lm_head, so each weight byte read feeds
// B multiply-adds, far below the card's ridge; the weight stream is K * N
// narrow bytes, half of bf16's, which is the point of quantized serving.
// The design aims at reading each weight byte once, coalesced, with enough
// blocks in flight:
//
// - a block owns NT = 64 output columns of BM batch rows (BM = 1, 2, 4 or
//   8, the smallest that holds B; more rows take more blocks along y);
// - lane l of a warp owns 8 columns (one 8-byte load of 8 narrow weights)
//   of row l / 8 of each 4-row step, so a warp reads 4 rows x 64 bytes per
//   load; the block's 8 warps split the K rows round-robin, so a 768-wide
//   projection (12 blocks) still puts 8 warps on each of its columns;
// - x is staged through shared memory as fp32 in chunks of KC rows of K,
//   so any K fits; each lane keeps BM x 8 fp32 accumulators in registers;
// - the 4 row-lanes of a column group are summed with shuffles and the 8
//   warps through shared memory, in a fixed order (deterministic output),
//   then scaled and written.
//
// Ragged edges: columns past N and rows past K are masked. When N is not a
// multiple of 8 (or w is not 8-byte aligned) the weights are read one byte
// at a time. Split-K across blocks, cp.async/TMA staging and fp8/int8
// tensor-core products are left for later work.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int COLS = 8;                       // columns per lane
constexpr int LANES_PER_ROW = 8;              // lanes across a row's tile
constexpr int ROWS_PER_STEP = 32 / LANES_PER_ROW;
constexpr int NT = COLS * LANES_PER_ROW;      // columns per block: 64
constexpr int KC = 256;                       // rows of K per x chunk

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// one narrow weight byte as fp32
struct Int8W {
  __device__ __forceinline__ static float cvt(uint32_t b) {
    return static_cast<float>(static_cast<int8_t>(static_cast<uint8_t>(b)));
  }
};
struct Fp8W {
  __device__ __forceinline__ static float cvt(uint32_t b) {
    __nv_fp8_e4m3 v;
    v.__x = static_cast<__nv_fp8_storage_t>(b);
    return static_cast<float>(v);
  }
};

// the 8 weights of columns n0 .. n0 + 7 of one row, as fp32; zeros past N
template <typename WC, bool VEC>
__device__ __forceinline__ void load_w(const uint8_t* row, int n0, int N,
                                       float (&f)[COLS]) {
  if constexpr (VEC) {
    // N % 8 == 0 here, so a group is wholly inside or wholly past N
    if (n0 < N) {
      const uint2 u = *reinterpret_cast<const uint2*>(row + n0);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        f[i] = WC::cvt((u.x >> (8 * i)) & 0xffu);
        f[4 + i] = WC::cvt((u.y >> (8 * i)) & 0xffu);
      }
    } else {
#pragma unroll
      for (int i = 0; i < COLS; ++i) f[i] = 0.f;
    }
  } else {
#pragma unroll
    for (int i = 0; i < COLS; ++i)
      f[i] = (n0 + i < N) ? WC::cvt(row[n0 + i]) : 0.f;
  }
}

template <typename XT, typename WC, int BM, bool VEC>
__global__ void __launch_bounds__(THREADS)
quant_matmul_kernel(const XT* __restrict__ x, const uint8_t* __restrict__ w,
                    const float* __restrict__ scale, float* __restrict__ out,
                    int B, int K, int N) {
  __shared__ float x_s[BM][KC];
  __shared__ float red[WARPS][BM][NT];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int cg = lane % LANES_PER_ROW;   // column group of the lane
  const int rr = lane / LANES_PER_ROW;   // row of the lane in a 4-row step
  const int n0 = blockIdx.x * NT + cg * COLS;
  const int b0 = blockIdx.y * BM;
  const int nb = min(BM, B - b0);

  float acc[BM][COLS];
#pragma unroll
  for (int b = 0; b < BM; ++b) {
#pragma unroll
    for (int c = 0; c < COLS; ++c) acc[b][c] = 0.f;
  }

  for (int k0 = 0; k0 < K; k0 += KC) {
    const int kc = min(KC, K - k0);
    for (int e = tid; e < BM * KC; e += THREADS) {
      const int b = e / KC, k = e % KC;
      x_s[b][k] = (b < nb && k < kc)
                      ? to_f(x[(size_t)(b0 + b) * K + k0 + k]) : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int r = warp * ROWS_PER_STEP + rr; r < kc;
         r += WARPS * ROWS_PER_STEP) {
      float wf[COLS];
      load_w<WC, VEC>(w + (size_t)(k0 + r) * N, n0, N, wf);
#pragma unroll
      for (int b = 0; b < BM; ++b) {
        const float xv = x_s[b][r];
#pragma unroll
        for (int c = 0; c < COLS; ++c) acc[b][c] += xv * wf[c];
      }
    }
    __syncthreads();  // x_s is rewritten by the next chunk
  }

  // the 4 row-lanes of each column group (lanes cg, cg + 8, cg + 16,
  // cg + 24), then the warps in order
#pragma unroll
  for (int b = 0; b < BM; ++b) {
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      float v = acc[b][c];
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (rr == 0) red[warp][b][cg * COLS + c] = v;
    }
  }
  __syncthreads();
  for (int e = tid; e < BM * NT; e += THREADS) {
    const int b = e / NT, c = e % NT;
    const int n = blockIdx.x * NT + c;
    if (b < nb && n < N) {
      float s = 0.f;
#pragma unroll
      for (int wi = 0; wi < WARPS; ++wi) s += red[wi][b][c];
      out[(size_t)(b0 + b) * N + n] = s * scale[n];
    }
  }
}

template <typename XT, typename WC, int BM>
int launch_bm(const void* x, const void* w, const void* scale, void* out,
              int B, int K, int N, bool vec, cudaStream_t stream) {
  const dim3 grid((N + NT - 1) / NT, (B + BM - 1) / BM);
  const XT* xp = static_cast<const XT*>(x);
  const uint8_t* wp = static_cast<const uint8_t*>(w);
  const float* sp = static_cast<const float*>(scale);
  float* op = static_cast<float*>(out);
  if (vec)
    quant_matmul_kernel<XT, WC, BM, true><<<grid, THREADS, 0, stream>>>(
        xp, wp, sp, op, B, K, N);
  else
    quant_matmul_kernel<XT, WC, BM, false><<<grid, THREADS, 0, stream>>>(
        xp, wp, sp, op, B, K, N);
  return static_cast<int>(cudaGetLastError());
}

template <typename XT, typename WC>
int launch(const void* x, const void* w, const void* scale, void* out, int B,
           int K, int N, cudaStream_t stream) {
  const bool vec = N % 8 == 0 && reinterpret_cast<uintptr_t>(w) % 8 == 0;
  if (B <= 1)
    return launch_bm<XT, WC, 1>(x, w, scale, out, B, K, N, vec, stream);
  if (B <= 2)
    return launch_bm<XT, WC, 2>(x, w, scale, out, B, K, N, vec, stream);
  if (B <= 4)
    return launch_bm<XT, WC, 4>(x, w, scale, out, B, K, N, vec, stream);
  return launch_bm<XT, WC, 8>(x, w, scale, out, B, K, N, vec, stream);
}

}  // namespace

// x_code: 0 = float32, 1 = bfloat16; w_code: 1 = int8, 2 = float8_e4m3fn.
// Returns the cudaError_t of the launch (0 = success);
// cudaErrorInvalidValue for a shape or code the kernel does not take.
// x [B, K], w [K, N], scale [N] float32, out [B, N] float32, all
// contiguous device memory.
extern "C" int quant_matmul(const void* x, const void* w, const void* scale,
                            void* out, int B, int K, int N, int x_code,
                            int w_code, void* stream) {
  if (B < 1 || K < 1 || N < 1 || (B + 7) / 8 > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_code == 0 && w_code == 1)
    return launch<float, Int8W>(x, w, scale, out, B, K, N, s);
  if (x_code == 0 && w_code == 2)
    return launch<float, Fp8W>(x, w, scale, out, B, K, N, s);
  if (x_code == 1 && w_code == 1)
    return launch<__nv_bfloat16, Int8W>(x, w, scale, out, B, K, N, s);
  if (x_code == 1 && w_code == 2)
    return launch<__nv_bfloat16, Fp8W>(x, w, scale, out, B, K, N, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
