// A blocked bf16 matmul with an fp32 accumulator:
//   c[M, N] = bf16(a[M, K] @ b[K, N])   (a, b row-major bf16)
//
// Replaces the TPU kernel benchmarks/dot_variants.py pallas_matmul: a
// (M / bm, N / bn, K / bk) grid whose fp32 VMEM accumulator [bm, bn] lives
// across the inner K axis and is rounded to bf16 once. Its blocks (512 x
// 768 x 3200) do not map onto a CTA (a 512 x 768 fp32 accumulator alone is
// 1.5 MB of the 227 KB a block may hold), so each template instance below
// is a CTA tile of its own; the accumulator lives in registers across the
// block's whole K loop, which is the TPU's sequential K axis. M, N and K
// must be multiples of the tile (the TPU grid drops the rest rows).
//
// What bounds it on the H100: operations. At the experiment's shape (the
// lm_head dx, M 22528, K 32000, N 768) it does 2 M N K = 1.107 TFLOP
// against 1.49 GB of a, b and c: 1.120 ms at the dense bf16 rate of 989
// TFLOP/s, 0.45 ms at 3.35 TB/s. The design, a plain tensor-core GEMM:
// - 8 warps per block, 64 x (BN / (8 / (BM / 64))) output per warp as
//   nvcuda::wmma bf16 16x16x16 fragments whose fp32 accumulators stay in
//   registers for the whole K loop;
// - a 3-stage ring of (BM x BK, BK x BN) tiles in shared memory filled by
//   cp.async 16-byte copies, so the next two K steps load while the warps
//   multiply the current one; rows padded by 16 bytes (ldmatrix without
//   bank conflicts);
// - the N / BN column blocks of one row block are neighbours in the launch
//   order (blockIdx.x), so the a rows they share come from L2;
// - the epilogue stages each fragment in shared memory and writes bf16
//   rows in 16-byte stores.
// wgmma with TMA is left for later work: mma.sync peaks well below the
// card's dense rate.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int THREADS = 256;  // 8 warps
constexpr int STAGES = 3;
constexpr int LDE = 20;       // epilogue staging row stride (floats)

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

template <int BM, int BN, int BK>
struct Tile {
  static constexpr int WARPS_M = BM / 64;           // 64 rows per warp
  static constexpr int WARPS_N = 8 / WARPS_M;
  static constexpr int WN = BN / WARPS_N;           // columns per warp
  static constexpr int FM = 4, FN = WN / 16;        // fragments per warp
  static constexpr int LDA = BK + 8, LDB = BN + 8;  // padded row strides
  static constexpr int A_ELEMS = BM * LDA, B_ELEMS = BK * LDB;
  static constexpr size_t SMEM = (size_t)STAGES * (A_ELEMS + B_ELEMS) * 2;
  static_assert(WARPS_M * WARPS_N == 8 && WN % 16 == 0 && BK % 16 == 0,
                "tile does not split over 8 warps");
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// the K step's a tile [BM, BK] and b tile [BK, BN] into one ring slot
template <int BM, int BN, int BK>
__device__ __forceinline__ void load_stage(bf16* sA, bf16* sB, const bf16* a,
                                           const bf16* b, int m0, int n0,
                                           int k0, int K, int N) {
  using T = Tile<BM, BN, BK>;
  for (int e = threadIdx.x; e < BM * BK / 8; e += THREADS) {
    const int r = e / (BK / 8), c = (e % (BK / 8)) * 8;
    cp_async16(sA + r * T::LDA + c, a + (size_t)(m0 + r) * K + k0 + c);
  }
  for (int e = threadIdx.x; e < BK * BN / 8; e += THREADS) {
    const int r = e / (BN / 8), c = (e % (BN / 8)) * 8;
    cp_async16(sB + r * T::LDB + c, b + (size_t)(k0 + r) * N + n0 + c);
  }
}

template <int BM, int BN, int BK>
__global__ void __launch_bounds__(THREADS)
blocked_mm(const bf16* __restrict__ a, const bf16* __restrict__ b,
           bf16* __restrict__ c, int N, int K) {
  using T = Tile<BM, BN, BK>;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = warp / T::WARPS_N, wn = warp % T::WARPS_N;

  FragC acc[T::FM][T::FN];
#pragma unroll
  for (int i = 0; i < T::FM; ++i)
#pragma unroll
    for (int j = 0; j < T::FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int KT = K / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) {
      bf16* sA = ring + s * (T::A_ELEMS + T::B_ELEMS);
      load_stage<BM, BN, BK>(sA, sA + T::A_ELEMS, a, b, m0, n0, s * BK, K,
                             N);
    }
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();  // step kt has landed
    __syncthreads();              // and every warp is done with step kt - 1
    const int nk = kt + STAGES - 1;
    if (nk < KT) {
      bf16* sA = ring + (nk % STAGES) * (T::A_ELEMS + T::B_ELEMS);
      load_stage<BM, BN, BK>(sA, sA + T::A_ELEMS, a, b, m0, n0, nk * BK, K,
                             N);
    }
    cp_async_commit();
    const bf16* sA = ring + (kt % STAGES) * (T::A_ELEMS + T::B_ELEMS);
    const bf16* sB = sA + T::A_ELEMS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      FragA fa[T::FM];
#pragma unroll
      for (int i = 0; i < T::FM; ++i)
        wmma::load_matrix_sync(fa[i], sA + (wm * 64 + i * 16) * T::LDA + kk,
                               T::LDA);
#pragma unroll
      for (int j = 0; j < T::FN; ++j) {
        FragB fb;
        wmma::load_matrix_sync(fb, sB + kk * T::LDB + wn * T::WN + j * 16,
                               T::LDB);
#pragma unroll
        for (int i = 0; i < T::FM; ++i)
          wmma::mma_sync(acc[i][j], fa[i], fb, acc[i][j]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the staging below reuses the ring

  float* stage = reinterpret_cast<float*>(smem) + warp * 16 * LDE;
  const int r = lane >> 1, c8 = (lane & 1) * 8;
#pragma unroll
  for (int i = 0; i < T::FM; ++i)
#pragma unroll
    for (int j = 0; j < T::FN; ++j) {
      wmma::store_matrix_sync(stage, acc[i][j], LDE, wmma::mem_row_major);
      __syncwarp();
      const float* s = stage + r * LDE + c8;
      uint4 u;
      __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
      for (int x = 0; x < 4; ++x)
        h[x] = __floats2bfloat162_rn(s[2 * x], s[2 * x + 1]);
      const size_t row = (size_t)(m0 + wm * 64 + i * 16 + r);
      *reinterpret_cast<uint4*>(c + row * N + n0 + wn * T::WN + j * 16 +
                                c8) = u;
      __syncwarp();
    }
}

template <int BM, int BN, int BK>
int launch(const void* a, const void* b, void* c, int M, int N, int K,
           cudaStream_t s) {
  if (M % BM || N % BN || K % BK || M / BM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  using T = Tile<BM, BN, BK>;
  static const int attr = static_cast<int>(cudaFuncSetAttribute(
      blocked_mm<BM, BN, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)T::SMEM));
  if (attr) return attr;
  const dim3 grid(N / BN, M / BM);
  blocked_mm<BM, BN, BK><<<grid, THREADS, T::SMEM, s>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(b),
      static_cast<bf16*>(c), N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Device pointers, contiguous, 16-byte aligned, bf16: a [M, K], b [K, N],
// c [M, N]. (bm, bn, bk) names the instance (128x128x32, 128x256x32,
// 256x128x32, 128x128x64) and must divide (M, N, K). Returns the
// cudaError_t of the launch (0 = success), or cudaErrorInvalidValue for a
// tile or shape it does not take.
extern "C" int blocked_matmul(const void* a, const void* b, void* c, int M,
                              int N, int K, int bm, int bn, int bk,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (M < 1 || N < 1 || K < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (bm == 128 && bn == 128 && bk == 32)
    return launch<128, 128, 32>(a, b, c, M, N, K, s);
  if (bm == 128 && bn == 256 && bk == 32)
    return launch<128, 256, 32>(a, b, c, M, N, K, s);
  if (bm == 256 && bn == 128 && bk == 32)
    return launch<256, 128, 32>(a, b, c, M, N, K, s);
  if (bm == 128 && bn == 128 && bk == 64)
    return launch<128, 128, 64>(a, b, c, M, N, K, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
