// A blocked bf16 matmul with an fp32 accumulator:
//   c[M, N] = bf16(a[M, K] @ b[K, N])   (a, b row-major bf16)
//
// Replaces the TPU kernel benchmarks/dot_variants.py pallas_matmul: a
// (M / bm, N / bn, K / bk) grid whose fp32 VMEM accumulator [bm, bn] lives
// across the inner K axis and is rounded to bf16 once. Its blocks (512 x
// 768 x 3200) do not map onto a CTA (a 512 x 768 fp32 accumulator alone is
// 1.5 MB of the 227 KB a block may hold), so each template instance below
// is a CTA tile of its own, and bk is the K depth of one stage of the
// block's ring; the accumulator lives in registers across the tile's whole
// K loop, which is the TPU's sequential K axis. M, N and K must be
// multiples of the tile (the TPU grid drops the rest rows).
//
// What bounds it on the H100: operations. At the experiment's shape (the
// lm_head dx, M 22528, K 32000, N 768) it does 2 M N K = 1.107 TFLOP
// against 1.49 GB of a, b and c: 1.120 ms at the dense bf16 rate of 989
// TFLOP/s, 0.45 ms at 3.35 TB/s. The tensor cores reach that rate only
// through wgmma fed from shared memory without the issuing threads doing
// the copies, and only if the next k step's tiles are in place when the
// last one's products retire. The design:
// - a warp-specialised block of three warpgroups: one thread of the first
//   issues every TMA copy into a ring of STAGES (a tile, b tile) stages
//   (about 200 KB: 8 stages at 128 x 256 x 32) on full/empty mbarrier
//   pairs; the other two consume. The a tile [BM x BK] lands K-major in
//   the 64-byte swizzle at BK 32 (128-byte at BK 64), the b tile [BK x BN]
//   MN-major as BN / 64 boxes of 64 columns in the 128-byte swizzle;
// - each consumer warpgroup owns BM / 2 rows x BN of the tile and issues
//   wgmma.mma_async m64n256k16 or m64n128k16 (two m64 products a k16 step
//   at BM 256), bf16 into fp32 registers (up to 128 a thread: setmaxnreg
//   hands the producer's registers to the consumers). One k step's group
//   of products stays in flight (wgmma.wait_group 1), and a stage goes
//   back to the producer only once the products that read it retired;
// - a persistent grid of one block per SM walks the output tiles in a
//   static order in which the N blocks of one row block are neighbours,
//   so the a rows they share come from L2; the producer runs on into the
//   block's next tile while the consumers finish this one;
// - the epilogue rounds to bf16, gathers each row's 8 consecutive values
//   in one thread by a transpose within each quad of lanes, and stores
//   rows in 16-byte stores, while the next tile's stages load.
// What may bound it next: at 128 x 256 each k16 step reads (128 + 256) x
// 32 bytes from L2 for 2 x 128 x 256 x 16 operations, 85 operations a
// byte: at the dense rate that is ~11.6 TB/s of L2 reads, more than L2
// gives. The b tile is shared by the blocks of one column block, so a
// cluster of two blocks along M could load it once and multicast it
// (cp.async.bulk.tensor ... .multicast::cluster), halving the b traffic;
// but then a stage is free only once both blocks' consumers have released
// it (remote mbarrier arrivals), and that lockstep, tried on the H100,
// cost more than the L2 traffic it saved: this one-block design stays.

#include "sm90_tiles.cuh"

namespace {

constexpr int THREADS = 3 * WG_THREADS;  // a producer and two consumers
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
static_assert((PRODUCER_REGS + 2 * CONSUMER_REGS) * WG_THREADS <= 65536,
              "the consumers take more registers than the SM has");

template <int BM, int BN, int BK>
struct Gemm {
  static constexpr int A_BYTES = BM * BK * 2;
  static constexpr int B_BOX = BK * 128;  // BK rows of one 64-column box
  static constexpr int STAGE = A_BYTES + BN / 64 * B_BOX;
  static constexpr int STAGES = 200 * 1024 / STAGE;
  static constexpr int BARS = STAGES * STAGE;
  // 1024 more for the alignment of the swizzled tiles
  static constexpr size_t SMEM = BARS + 2 * STAGES * 8 + 1024;
  static constexpr int WG_ROWS = BM / 2;       // a consumer's rows
  static constexpr int MMAS = WG_ROWS / 64;    // its m64 products a k16 step
  static constexpr int ACC = BN / 2;           // fp32 registers a product
  static_assert(BK == 32 || BK == 64, "the a tile's swizzle spans BK");
  static_assert(BN == 128 || BN == 256, "a product spans BN");
  static_assert(MMAS == 1 || MMAS == 2, "a consumer owns 64 or 128 rows");
  static_assert(SMEM <= 232448, "the ring does not fit a block");
};

// the a operand's descriptor: K-major, 64-byte swizzle at BK 32, 128-byte
// at BK 64
template <int BK>
__device__ __forceinline__ uint64_t desc_a(const void* p) {
  return BK == 32 ? desc_k64(p) : desc_k(p);
}

// rows row0 and row0 + 8 of a 64 x BN fp32 accumulator as bf16, each row's
// 8-column groups stored in 16-byte stores
template <int BN>
__device__ __forceinline__ void store_rows(const float (&d)[BN / 2],
                                           bf16* row0, bf16* row1) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int jb = 0; jb < BN / 32; ++jb)
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      uint32_t w[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const float* x = d + 4 * (4 * jb + g) + 2 * hi;
        w[g] = pack_bf16(__float2bfloat16_rn(x[0]),
                         __float2bfloat16_rn(x[1]));
      }
      const uint4 u = quad_transpose(w);
      *reinterpret_cast<uint4*>((hi ? row1 : row0) + 8 * (4 * jb + t)) = u;
    }
}

template <int BM, int BN, int BK>
__global__ void __launch_bounds__(THREADS, 1)
blocked_mm(const __grid_constant__ CUtensorMap ma,
           const __grid_constant__ CUtensorMap mb, bf16* __restrict__ c,
           int M, int N, int K) {
  using G = Gemm<BM, BN, BK>;
  constexpr int STAGES_ = G::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + G::BARS);
  uint64_t* empty = full + STAGES_;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES_; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * WG_THREADS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int n_blocks = N / BN;
  const int tiles = M / BM * n_blocks;
  const int k_steps = K / BK;

  if (threadIdx.x < WG_THREADS) {  // the producer warpgroup
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      int it = 0;  // the block's k steps so far, over all its tiles
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = t / n_blocks * BM, n0 = t % n_blocks * BN;
        for (int kt = 0; kt < k_steps; ++kt, ++it) {
          const int s = it % STAGES_;
          unsigned char* st = smem + s * G::STAGE;
          mbar_wait(&empty[s], ((it / STAGES_) & 1) ^ 1);
          mbar_expect(&full[s], G::STAGE);
          tma_box2(st, &ma, &full[s], kt * BK, m0);
#pragma unroll
          for (int nb = 0; nb < BN / 64; ++nb)
            tma_box2(st + G::A_BYTES + nb * G::B_BOX, &mb, &full[s],
                     n0 + 64 * nb, kt * BK);
        }
      }
    }
    return;
  }

  setmaxnreg_inc<CONSUMER_REGS>();
  const int wg = threadIdx.x / WG_THREADS - 1;
  const int tid = threadIdx.x % WG_THREADS;
  // this thread's first row of each m64 product, and its row + 8
  const int r0 = (tid >> 5) * 16 + ((tid & 31) >> 2);
  float acc[G::MMAS][G::ACC];
  int it = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int m0 = t / n_blocks * BM, n0 = t % n_blocks * BN;
    for (int kt = 0; kt < k_steps; ++kt, ++it) {
      const int s = it % STAGES_;
      const unsigned char* st = smem + s * G::STAGE;
      mbar_wait(&full[s], (it / STAGES_) & 1);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t b =
            desc_mn_boxes(st + G::A_BYTES + kk * 2048, G::B_BOX);
#pragma unroll
        for (int mi = 0; mi < G::MMAS; ++mi)
          wgmma_ss_mn(acc[mi],
                      desc_a<BK>(st + (wg * G::WG_ROWS + mi * 64) * BK * 2 +
                                 kk * 32),
                      b, kt > 0 || kk > 0);
      }
      wg_commit();
#pragma unroll
      for (int mi = 0; mi < G::MMAS; ++mi) fence_regs(acc[mi]);
      // the products of the step before have retired: its stage is free
      wg_wait<1>();
#pragma unroll
      for (int mi = 0; mi < G::MMAS; ++mi) fence_regs(acc[mi]);
      if (kt > 0) mbar_arrive(&empty[(it - 1) % STAGES_]);
    }
    wg_wait<0>();
#pragma unroll
    for (int mi = 0; mi < G::MMAS; ++mi) fence_regs(acc[mi]);
    mbar_arrive(&empty[(it - 1) % STAGES_]);

#pragma unroll
    for (int mi = 0; mi < G::MMAS; ++mi) {
      const size_t row = (size_t)(m0 + wg * G::WG_ROWS + mi * 64 + r0);
      bf16* base = c + row * N + n0;
      store_rows<BN>(acc[mi], base, base + 8 * (size_t)N);
    }
  }
}

template <int BM, int BN, int BK>
int launch(const void* a, const void* b, void* c, int M, int N, int K,
           cudaStream_t s) {
  if (M % BM || N % BN || K % BK)
    return static_cast<int>(cudaErrorInvalidValue);
  using G = Gemm<BM, BN, BK>;
  static const int attr = prepare(blocked_mm<BM, BN, BK>, G::SMEM);
  if (attr) return attr;
  CUtensorMap ma, mb;
  int err = matrix_box_map(&ma, a, M, K, BM, BK,
                           BK == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                    : CU_TENSOR_MAP_SWIZZLE_128B);
  if (!err)
    err = matrix_box_map(&mb, b, K, N, BK, 64, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err) return err;
  int dev = 0, sms = 0;
  err = static_cast<int>(cudaGetDevice(&dev));
  if (!err)
    err = static_cast<int>(
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  if (err) return err;
  const int tiles = M / BM * (N / BN);
  blocked_mm<BM, BN, BK><<<tiles < sms ? tiles : sms, THREADS, G::SMEM, s>>>(
      ma, mb, static_cast<bf16*>(c), M, N, K);
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

// The dynamic shared memory one block of the (bm, bn, bk) instance asks
// for; 0 for a tile that is no instance.
extern "C" int blocked_matmul_smem(int bm, int bn, int bk) {
  if (bm == 128 && bn == 128 && bk == 32)
    return (int)Gemm<128, 128, 32>::SMEM;
  if (bm == 128 && bn == 256 && bk == 32)
    return (int)Gemm<128, 256, 32>::SMEM;
  if (bm == 256 && bn == 128 && bk == 32)
    return (int)Gemm<256, 128, 32>::SMEM;
  if (bm == 128 && bn == 128 && bk == 64)
    return (int)Gemm<128, 128, 64>::SMEM;
  return 0;
}
