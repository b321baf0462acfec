// The softmax term of the lm-head activation gradient:
//   out[M, H] = bf16(bf16(exp(min(logits - m[:, None], 0)) * scale[:, None])
//                    @ W^T)
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
// ridge: 1.120 ms at the dense bf16 rate of 989 TFLOP/s. Only wgmma reaches
// that rate, fed from shared memory by copies its issuing threads do not
// make. Beside the products it takes one exponential a logit and output
// column tile: with 256-column tiles, H 768 is three of them, 2.16 G
// exponentials, ~0.5 ms of the SFU (16 a clock an SM), so the softmax has
// to run while the tensor cores work. The design, a warp-specialised
// blocked GEMM (as blocked_matmul.cu) whose A operand is made in
// registers:
// - a block computes a 128 x 256 tile of out: one thread of a producer
//   warpgroup issues, into a ring of RING stages, a TMA box of the logits
//   [128 rows x 64 V] and one of W [256 rows of H x 64 V] (K-major: W's
//   rows are V-contiguous), both in the 128-byte swizzle, on full/empty
//   mbarrier pairs; rows past M and past H, and columns past V, land as
//   zeros;
// - two consumer warpgroups each own 64 rows x 256 columns of the tile,
//   their fp32 accumulators in registers (128 a thread; setmaxnreg hands
//   the producer's registers over) for the whole V loop. A consumer reads
//   its rows of the logits box by ldmatrix, whose fragments are exactly
//   the A operand's register layout, turns each pair of logits into
//   probabilities in fp32 and rounds them to bf16 in the same registers,
//   and issues four wgmma m64n256k16 with A from registers and W's box as
//   the shared-memory B operand. A logit costs one FMA (l log2(e) -
//   m log2(e)), one min (the clamp at 0), one ex2 and one multiply by the
//   row's scale, each row's two constants held in registers;
// - overlap: a step's products stay in flight (wgmma.wait_group 1) while
//   the consumer makes the next step's probabilities into a second set of
//   registers; a stage goes back to the producer once the products that
//   read it retired;
// - rows past M weigh 0 (their m and scale are read masked, scale 0), a
//   column past V meets W's zero column, and columns past H are not
//   stored, so any M and any V, H multiples of 8 are taken;
// - one block a tile, the tiles of one row block neighbours in the launch
//   order (at the training shape 176 x 3 = 528 tiles, four waves of one
//   block an SM), so the three column tiles that share a logits box read
//   it from L2 once HBM has served the first.
// TMA maps are kernel parameters (__grid_constant__), encoded by the host
// at each call: the launch holds no host state, so a CUDA graph may
// capture it.

#include "sm90_tiles.cuh"

namespace {

constexpr int BM = 128;  // rows of out a block: two consumers of 64
constexpr int BN = 256;  // columns of out a block: one m64n256 product
constexpr int BK = 64;   // V columns a stage: a 128-byte swizzled row
constexpr int L_BYTES = BM * BK * 2;     // the logits box, 16 KB
constexpr int W_BYTES = BN * BK * 2;     // the W box, 32 KB
constexpr int STAGE = L_BYTES + W_BYTES;
constexpr int RING = 4;
constexpr int BARS = RING * STAGE;
// 1024 more for the alignment of the swizzled boxes
constexpr size_t SMEM = BARS + 2 * RING * 8 + 1024;
constexpr int THREADS = 3 * WG_THREADS;  // a producer and two consumers
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
static_assert((PRODUCER_REGS + 2 * CONSUMER_REGS) * WG_THREADS <= 65536,
              "the consumers take more registers than the SM has");
static_assert(SMEM <= 232448, "the ring does not fit a block");

__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// two fp32 rounded to bf16 in one instruction, lo in the low half
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

constexpr float LOG2E = 1.4426950408889634f;

// A consumer thread's view of its rows: the row it addresses for ldmatrix
// (rows 0-15 of its warp's 16, chunk 2 kk for lanes 0-15 and 2 kk + 1 for
// lanes 16-31 of a k16 step), and m log2(e) and scale of its fragment rows
// r and r + 8 (scale 0 past M)
struct Rows {
  int lrow, lsw, lhalf;
  float mb[2], sc[2];
};

// a step's probabilities as the A registers of its four k16 products:
// register j of step kk holds row (j & 1 ? r + 8 : r), columns 16 kk +
// 8 (j >> 1) + 2 (lane & 3), + 1 of the stage's logits box `lt`
__device__ __forceinline__ void probs(const unsigned char* lt, const Rows& w,
                                      uint32_t (&p)[16]) {
  const unsigned char* row = lt + w.lrow * 128;
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    uint32_t x[4];
    ldsm_x4(x, row + (((2 * kk + w.lhalf) ^ w.lsw) << 4));
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int hr = j & 1;
      const float lo =
          ex2(fminf(fmaf(bf16_lo(x[j]), LOG2E, -w.mb[hr]), 0.f)) * w.sc[hr];
      const float hi =
          ex2(fminf(fmaf(bf16_hi(x[j]), LOG2E, -w.mb[hr]), 0.f)) * w.sc[hr];
      p[4 * kk + j] = pack2(lo, hi);
    }
  }
}

// one V step on stage st with the A registers p; q are the step before's,
// which its products read until the wait. Waits on `full`, then releases
// `empty_before` (the step before's stage; null on the first step).
__device__ __forceinline__ void step(float (&acc)[128], uint32_t (&p)[16],
                                     uint32_t (&q)[16],
                                     const unsigned char* st, uint64_t* full,
                                     uint32_t parity, uint64_t* empty_before,
                                     const Rows& w) {
  mbar_wait(full, parity);
  probs(st, w, p);
  fence_regs(p);
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wgmma_rs_k(acc, p + 4 * kk, desc_k(st + L_BYTES + kk * 32), 1);
  wg_commit();
  fence_regs(acc);
  // the step before's products have retired: its stage and its A
  // registers are free
  wg_wait<1>();
  fence_regs(acc);
  fence_regs(q);
  if (empty_before) mbar_arrive(empty_before);
}

__global__ void __launch_bounds__(THREADS, 1)
head_dx_kernel(const __grid_constant__ CUtensorMap ml,
               const __grid_constant__ CUtensorMap mw,
               const float* __restrict__ m, const float* __restrict__ scale,
               bf16* __restrict__ out, int M, int V, int H, int n_cols) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + BARS);
  uint64_t* empty = full + RING;
  if (threadIdx.x == 0) {
    for (int s = 0; s < RING; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2 * WG_THREADS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int m0 = blockIdx.x / n_cols * BM, n0 = blockIdx.x % n_cols * BN;
  const int k_steps = (V + BK - 1) / BK;

  if (threadIdx.x < WG_THREADS) {  // the producer warpgroup
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      for (int kt = 0; kt < k_steps; ++kt) {
        const int s = kt % RING;
        unsigned char* st = smem + s * STAGE;
        mbar_wait(&empty[s], ((kt / RING) & 1) ^ 1);
        mbar_expect(&full[s], STAGE);
        tma_box2(st, &ml, &full[s], kt * BK, m0);
        tma_box2(st + L_BYTES, &mw, &full[s], kt * BK, n0);
      }
    }
    return;
  }

  setmaxnreg_inc<CONSUMER_REGS>();
  const int wg = threadIdx.x / WG_THREADS - 1;
  const int tid = threadIdx.x % WG_THREADS;
  const int warp = tid >> 5, lane = tid & 31;
  const int r = wg * 64 + warp * 16 + (lane >> 2);  // this thread's rows
  Rows w;
  w.lrow = wg * 64 + warp * 16 + (lane & 15);
  w.lsw = w.lrow & 7;
  w.lhalf = lane >> 4;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int gm = m0 + r + 8 * hr;
    w.mb[hr] = gm < M ? m[gm] * LOG2E : 0.f;
    w.sc[hr] = gm < M ? scale[gm] : 0.f;
  }

  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  uint32_t pa[16], pb[16];  // two steps' A registers, in turn
#pragma unroll
  for (int i = 0; i < 16; ++i) pa[i] = pb[i] = 0u;
  auto on = [&](int kt, uint32_t (&p)[16], uint32_t (&q)[16]) {
    const int s = kt % RING;
    step(acc, p, q, smem + s * STAGE, &full[s], (kt / RING) & 1,
         kt > 0 ? &empty[(kt - 1) % RING] : nullptr, w);
  };
  int kt = 0;
  for (; kt + 1 < k_steps; kt += 2) {
    on(kt, pa, pb);
    on(kt + 1, pb, pa);
  }
  if (kt < k_steps) on(kt, pa, pb);
  wg_wait<0>();
  fence_regs(acc);

  // the epilogue: each row's 8-column groups rounded to bf16 and gathered
  // into one thread of its quad, stored in 16-byte stores, masked at M and
  // H (H % 8 == 0: a group is wholly in or out)
  const int t = lane & 3;
#pragma unroll
  for (int jb = 0; jb < BN / 32; ++jb)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      uint32_t v[4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        const float* x = acc + 4 * (4 * jb + g) + 2 * hr;
        v[g] = pack2(x[0], x[1]);
      }
      const uint4 u = quad_transpose(v);
      const int gm = m0 + r + 8 * hr, gn = n0 + 8 * (4 * jb + t);
      if (gm < M && gn < H)
        *reinterpret_cast<uint4*>(out + (size_t)gm * H + gn) = u;
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
  if (M < 1 || V < 8 || H < 8 || V % 8 != 0 || H % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long n_cols = (H + BN - 1) / BN;
  const long long tiles = (M + (long long)BM - 1) / BM * n_cols;
  if (tiles > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  static const int attr = prepare(head_dx_kernel, SMEM);
  if (attr) return attr;
  CUtensorMap ml, mw;
  int err = matrix_box_map(&ml, logits, M, V, BM, BK,
                           CU_TENSOR_MAP_SWIZZLE_128B);
  if (!err)
    err = matrix_box_map(&mw, w, H, V, BN, BK, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err) return err;
  head_dx_kernel<<<(unsigned)tiles, THREADS, SMEM,
                   static_cast<cudaStream_t>(stream)>>>(
      ml, mw, static_cast<const float*>(m), static_cast<const float*>(scale),
      static_cast<bf16*>(out), M, V, H, (int)n_cols);
  return static_cast<int>(cudaGetLastError());
}

// The dynamic shared memory one block asks for.
extern "C" int head_dx_smem() { return (int)SMEM; }
