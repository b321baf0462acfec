// Weight-only quantized matmul: out = x @ (w * scale), dequantized in the
// kernel.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/tick_fusion.py
// (quant_matmul, kernel body _quant_matmul_kernel).
//
// out[b, n] = scale[n] * sum_k x[b, k] * w[k, n]: x [B, K] fp32 or bf16,
// w [K, N] int8 or fp8-e4m3fn (row-major), scale [N] fp32 (one per output
// channel), out [B, N] fp32. The TPU kernel multiplies each weight by its
// column's scale before the dot; here the scale multiplies each column's
// full sum once, after it (the same function; the rounding differs by a
// few fp32 ulps of the sum).
//
// What bounds it on the H100: bytes. The decode tick calls it with B = 8
// slots (1 on the admit's lm_head), so each narrow weight byte feeds at
// most 8 multiply-adds, far below the card's ridge; the weight stream,
// K * N bytes, should run at the HBM rate: ~14.5 weights a clock per SM.
// At 8 fp32 FMAs a weight that is ~116 FMAs a clock of the SM's 128,
// before the conversions and the x reads, and the first version put the
// 768-wide projections on 12 blocks of 132 SMs, each with one 8-byte load
// a lane in flight. The tick's projections (0.6-2.4 MB) take less than
// 1 us of HBM time, so a launch, one trip to memory and the merge bound
// them; lm_head (24.6 MB) is the one that streams. The design:
//
// - split K across blocks so every projection fills the card: a block owns
//   32 output columns of up to 8 batch rows over one of `splits` (<= 8)
//   ranges of K, or, for lm_head's wide weights, a 128-column strip over
//   all of K; the wrapper picks the tiling from (K, N) alone (every tick
//   shape on >= 132 blocks). The splits of a column tile are one
//   thread-block cluster: each block leaves its fp32 partial in its own
//   shared memory, and after a cluster barrier the blocks sum the partials
//   through distributed shared memory in rank order, each block a share of
//   the columns, so the output is deterministic and no workspace or state
//   outlives a launch (safe to capture in a CUDA graph). scale[n]
//   multiplies each column's full sum once. More than 8 batch rows take
//   more blocks along z;
// - stream the weights through a shared-memory ring: stages of 64 rows x
//   the tile's columns, copied by 16-byte cp.async, up to 8 stages (96 KB)
//   in flight a block (the block's whole range of K on the projections), a
//   commit group a stage; each stage also carries the 64 rows of x (<= 8
//   batch rows, in x's own type, rows past B zero-filled), so nothing is
//   staged through registers and a block's first products wait for one
//   stage only. cp.async and not TMA: a map per weight would be encoded on
//   the host at every call of a host-bound tick;
// - products on tensor cores, "swap AB": out^T[32, 8] = W^T x^T for each
//   warp's 32 columns, the dequantized weight tile the 16-row A operand of
//   mma.sync.m16n8k16 (bf16 in, fp32 accumulate; two m-tiles) and x^T the
//   n = 8 B operand, so B <= 8 fills one n-tile. On 32-column tiles the
//   block's 4 warps take the stage's 4 k-steps of 16 rows (their sums
//   joined in shared memory); on 128-column strips each warp takes its own
//   32 columns over all 4 k-steps, so a block reads 128 contiguous bytes a
//   row and a warp's stage holds four times the work. In a k-step, lane
//   (g, t) reads 4 bytes (columns 4 g .. 4 g + 3) of rows t, t + 4, t + 8,
//   t + 12 (conflict-free: the 128-byte rows swizzle their 16-byte
//   pieces) and pairs the rows with byte permutes: mma row g of m-tile j is
//   column 4 g + j, row g + 8 column 4 g + 2 + j, and k slots (2t, 2t + 1,
//   2t + 8, 2t + 9) are rows (t, t + 4, t + 8, t + 12) of the weights and
//   of x (x's padded rows keep those reads free of bank conflicts).
//   Conversions take two weights an instruction where they can: int8
//   through fp32's 2^23 magic number (a permute places the byte, one
//   subtract, one permute packs two exact bf16); e4m3 moves its sign and
//   its 7 exponent and mantissa bits into bf16's place (one permute, a
//   shift and two masks for two weights) and multiplies the pair by 2^120
//   in one bf16x2 FMA, exact, subnormals included (quantize_weight clamps
//   to +-448: no NaN).
//
// Numerics: int8 and e4m3 are exact in bf16, and the products of bf16 x by
// them exact in fp32, so for bf16 x the result differs from the plain
// version's fp32 sum by accumulation order only. fp32 x (no engine caller)
// is split into three bf16 parts, hi + mid + lo = x exactly (24 bits of
// mantissa in three 8-bit pieces), each multiplied into the same fp32
// accumulator.
//
// Ragged edges: rows past K are zero-filled (weights and x); columns past N
// are not written. When a row of w or of x does not start on a 16-byte
// boundary (N no multiple of 16, or K times x's size no multiple of 16),
// the stages are copied a byte at a time.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int KSTEP = 16;             // rows of K per mma
constexpr int SROWS = WARPS * KSTEP;  // rows of K per ring stage: 64
constexpr int BT = 8;                 // batch rows per block: the mma's n
constexpr int MAX_RING = 8;           // ring stages
constexpr int RING_BYTES = 96 * 1024; // the ring's shared memory, at most
constexpr int MAX_SPLITS = 8;         // blocks of a cluster along K

// x's type by its code: 0 fp32 (split into three bf16 parts), 1 bf16
template <int XC>
struct XType {
  typedef float type;
  static constexpr int PARTS = 3;
};
template <>
struct XType<1> {
  typedef __nv_bfloat16 type;
  static constexpr int PARTS = 1;
};

// a ring stage: 64 rows x NT weight bytes, then x's 64 rows of BT batch
// rows in x's type, each x row padded by 16 bytes. A warp owns 32 columns:
// NT 32 (the tick's projections) puts the block's 4 warps on the tile's
// columns, a k-step of the stage each; NT 128 (lm_head's wide strips) gives
// each warp its own 32 columns over the stage's 4 k-steps
template <int XC, int NT>
struct Tile {
  typedef typename XType<XC>::type XT;
  static constexpr int WN = NT / 32;      // warps across the columns
  static constexpr int KS = WN;           // k-steps a warp a stage
  static constexpr int MT = 2;            // m-tiles a warp: 32 columns
  static constexpr int PIECES = NT / 16;  // 16-byte pieces a weight row
  static constexpr int XPIECES = SROWS * (int)sizeof(XT) / 16;  // an x row
  static constexpr int XROW = SROWS * (int)sizeof(XT) + 16;
  static constexpr int W = SROWS * NT;    // the weights' bytes
  static constexpr int BYTES = W + BT * XROW;
  static_assert(NT == 32 || NT == 128, "32 or 128 columns a block");
  static_assert(SROWS * PIECES % THREADS == 0, "whole pieces a thread");
  static_assert(BT * XPIECES <= THREADS, "an x piece a thread at most");
};

// the 16-byte piece c of row r, as stored. A k-step's lanes read 4 bytes
// each (columns 4 g .. 4 g + 3 of the warp's 32) of rows t, t + 4, t + 8,
// t + 12: 32-byte rows put four rows on a bank line, free of conflicts; a
// 128-byte row fills the line, so row r moves its pieces by 2 (r mod 4)
template <int NT>
__device__ __forceinline__ int swz(int r, int c) {
  if constexpr (NT == 128) return c ^ ((r & 3) << 1);
  return c;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes, of which the first n (0 or 16) are read and the rest zeroed
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// wait until at most n (0 .. MAX_RING - 2) groups are pending
__device__ __forceinline__ void cp_async_wait_n(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    default: cp_async_wait<6>(); break;
  }
}

// c += a b: a the m16 x k16 bf16 A fragment, b0/b1 the k16 x n8 B fragment
__device__ __forceinline__ void mma_bf16(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// the weight codes: 1 int8, 2 fp8-e4m3fn. pair(w0, w1, bi): byte bi of
// the words w0 (row k) and w1 (row k') as two bf16, row k in the low half
// (bi is a constant once the caller's loops are unrolled)
template <int WC>
struct Weights;

template <>
struct Weights<1> {
  // the words arrive biased (xor 0x80 a byte: v + 128 as an unsigned byte)
  static constexpr uint32_t BIAS = 0x80808080u;
  __device__ __forceinline__ static uint32_t pair(uint32_t w0, uint32_t w1,
                                                  int bi) {
    // 2^23 + (v + 128) as fp32, minus 2^23 + 128: v exactly, whose low 16
    // bits are zero, so the high halves are the exact bf16
    const float f0 =
        __uint_as_float(__byte_perm(w0, 0x4B000000u, 0x7540 | bi)) -
        8388736.f;
    const float f1 =
        __uint_as_float(__byte_perm(w1, 0x4B000000u, 0x7540 | bi)) -
        8388736.f;
    return __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  }
};

template <>
struct Weights<2> {
  static constexpr uint32_t BIAS = 0u;
  __device__ __forceinline__ static uint32_t pair(uint32_t w0, uint32_t w1,
                                                  int bi) {
    // bytes (b0, b0, b1, b1): each sign lands on a bf16 sign bit, and the
    // 7 exponent and mantissa bits, shifted right by 4, on bf16's low 4
    // exponent and high 3 mantissa bits: 2^(e - 127) (1.m), or the
    // subnormal 2^-126 (0.m); times 2^120 that is e4m3's 2^(e - 7) (1.m)
    // or 2^-6 (0.m), exactly
    const uint32_t v = __byte_perm(w0, w1, bi | (bi << 4) | ((4 + bi) << 8) |
                                               ((4 + bi) << 12));
    const uint32_t h = ((v >> 4) & 0x07F007F0u) | (v & 0x80008000u);
    uint32_t d;
    asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
        : "=r"(d)
        : "r"(h), "r"(0x7B807B80u), "r"(0x80008000u));
    return d;
  }
};

// a stage: rows k0 .. k0 + 63 of w's columns n0 .. n0 + NT - 1 and of x's
// rows b0 .. b0 + nb - 1; rows past K, columns past N and x rows past nb
// read as zeros
template <int XC, int NT, bool VEC>
__device__ __forceinline__ void load_stage(
    unsigned char* dst, const uint8_t* __restrict__ w,
    const typename XType<XC>::type* __restrict__ x, int k0, int n0, int b0,
    int nb, int K, int N, int tid) {
  typedef Tile<XC, NT> TL;
  typedef typename TL::XT XT;
#pragma unroll
  for (int i = 0; i < SROWS * TL::PIECES / THREADS; ++i) {
    const int e = tid + i * THREADS;
    const int r = e / TL::PIECES, c = e % TL::PIECES;
    unsigned char* d = dst + r * NT + swz<NT>(r, c) * 16;
    const int k = k0 + r, n = n0 + c * 16;
    if constexpr (VEC) {
      // N % 16 == 0: a piece is wholly inside or wholly past N
      const bool in = k < K && n < N;
      cp_async16(d, in ? w + (size_t)k * N + n : w, in ? 16 : 0);
    } else {
      const uint8_t* src = w + (size_t)k * N + n;
      uint32_t v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        uint32_t word = 0u;
#pragma unroll
        for (int b = 0; b < 4; ++b)
          if (k < K && n + 4 * q + b < N)
            word |= (uint32_t)src[4 * q + b] << (8 * b);
        v[q] = word;
      }
      *reinterpret_cast<uint4*>(d) = make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
  if (tid < BT * TL::XPIECES) {
    constexpr int PER = 16 / (int)sizeof(XT);  // x values a piece
    const int b = tid / TL::XPIECES, c = tid % TL::XPIECES;
    const int k = k0 + c * PER;
    unsigned char* d = dst + TL::W + b * TL::XROW + c * 16;
    const XT* src = x + (size_t)(b0 + b) * K + k;
    if constexpr (VEC) {
      // K % PER == 0: a piece is wholly inside or wholly past K
      const bool in = b < nb && k < K;
      cp_async16(d, in ? src : x, in ? 16 : 0);
    } else {
      const uint8_t* sb = reinterpret_cast<const uint8_t*>(src);
      uint32_t v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        uint32_t word = 0u;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (b < nb && k + (4 * q + j) / (int)sizeof(XT) < K)
            word |= (uint32_t)sb[4 * q + j] << (8 * j);
        v[q] = word;
      }
      *reinterpret_cast<uint4*>(d) = make_uint4(v[0], v[1], v[2], v[3]);
    }
  }
}

// the B fragment of x's row g at stage rows r, r + 4, r + 8, r + 12, as
// PARTS bf16 pairs: bf16 x is itself; fp32 x is split into hi + mid + lo,
// each exact in bf16, whose sum is x
template <int XC>
__device__ __forceinline__ void x_frag(const unsigned char* row, int r,
                                       uint32_t (&bx)[XType<XC>::PARTS][2]) {
  if constexpr (XC == 1) {
    const uint16_t* xr = reinterpret_cast<const uint16_t*>(row) + r;
    bx[0][0] = (uint32_t)xr[0] | ((uint32_t)xr[4] << 16);
    bx[0][1] = (uint32_t)xr[8] | ((uint32_t)xr[12] << 16);
  } else {
    const float* xr = reinterpret_cast<const float*>(row) + r;
    float v[4] = {xr[0], xr[4], xr[8], xr[12]};
    uint16_t part[3][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const __nv_bfloat16 hi = __float2bfloat16_rn(v[j]);
      const float r1 = v[j] - __bfloat162float(hi);
      const __nv_bfloat16 mid = __float2bfloat16_rn(r1);
      const __nv_bfloat16 lo = __float2bfloat16_rn(r1 - __bfloat162float(mid));
      part[0][j] = __bfloat16_as_ushort(hi);
      part[1][j] = __bfloat16_as_ushort(mid);
      part[2][j] = __bfloat16_as_ushort(lo);
    }
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      bx[p][0] = (uint32_t)part[p][0] | ((uint32_t)part[p][1] << 16);
      bx[p][1] = (uint32_t)part[p][2] | ((uint32_t)part[p][3] << 16);
    }
  }
}

template <int XC, int WC, int NT, bool VEC>
__global__ void __launch_bounds__(THREADS)
quant_mm(const typename XType<XC>::type* __restrict__ x,
         const uint8_t* __restrict__ w, const float* __restrict__ scale,
         float* __restrict__ out, int B, int K, int N, int n_stages,
         int ring) {
  typedef Tile<XC, NT> TL;
  typedef Weights<WC> WT;
  constexpr int PARTS = XType<XC>::PARTS;
  constexpr int MT = TL::MT;
  extern __shared__ __align__(16) unsigned char smem[];

  const int splits = gridDim.x, split = blockIdx.x;
  const int n0 = blockIdx.y * NT;
  const int b0 = blockIdx.z * BT;
  const int nb = min(BT, B - b0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wn = warp % TL::WN, wk = warp / TL::WN;  // the warp's role
  // this split's stages of K
  const int s0 = (int)((long long)n_stages * split / splits);
  const int ns = (int)((long long)n_stages * (split + 1) / splits) - s0;
  float* part_s = reinterpret_cast<float*>(smem + ring * TL::BYTES);

  float acc[MT][4];
#pragma unroll
  for (int j = 0; j < MT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  // the ring's first ring - 1 stages, a commit group each
  for (int i = 0; i < ring - 1; ++i) {
    if (i < ns)
      load_stage<XC, NT, VEC>(smem + i * TL::BYTES, w, x, (s0 + i) * SROWS,
                              n0, b0, nb, K, N, tid);
    cp_async_commit();
  }
  int slot = 0, fill = ring - 1;  // the ring slots of stages i, i + ring - 1
  for (int i = 0; i < ns; ++i) {
    // stage i has landed (one group is committed an iteration, so ring - 2
    // may still fly), for every thread; and every warp is done with the
    // slot stage i - 1 used, which stage i + ring - 1 now refills
    cp_async_wait_n(ring - 2);
    __syncthreads();
    if (i + ring - 1 < ns)
      load_stage<XC, NT, VEC>(smem + fill * TL::BYTES, w, x,
                              (s0 + i + ring - 1) * SROWS, n0, b0, nb, K, N,
                              tid);
    cp_async_commit();

    const unsigned char* st = smem + slot * TL::BYTES;
    slot = slot + 1 == ring ? 0 : slot + 1;
    fill = fill + 1 == ring ? 0 : fill + 1;
    const int byte = wn * 32 + g * 4;  // the lane's first column
#pragma unroll
    for (int ks = 0; ks < TL::KS; ++ks) {
      // a k-step: stage rows 16 (wk KS + ks) + (t, t + 4, t + 8, t + 12)
      const int r0 = (wk * TL::KS + ks) * KSTEP + t;
      uint32_t u[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = r0 + 4 * q;
        u[q] = *reinterpret_cast<const uint32_t*>(
                   st + r * NT + swz<NT>(r, byte / 16) * 16 + byte % 16) ^
               WT::BIAS;
      }
      uint32_t bx[PARTS][2];
      x_frag<XC>(st + TL::W + g * TL::XROW, r0, bx);
#pragma unroll
      for (int j = 0; j < MT; ++j) {
        // m-tile j: its row g is byte ba of the lane's bytes of a row, its
        // row g + 8 byte bb
        const int ba = j, bb = MT + j;
        const uint32_t a0 = WT::pair(u[0], u[1], ba);
        const uint32_t a1 = WT::pair(u[0], u[1], bb);
        const uint32_t a2 = WT::pair(u[2], u[3], ba);
        const uint32_t a3 = WT::pair(u[2], u[3], bb);
#pragma unroll
        for (int pp = 0; pp < PARTS; ++pp)
          mma_bf16(acc[j], a0, a1, a2, a3, bx[pp][0], bx[pp][1]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is idle: it holds the warps' sums next

  // the sums of the warps that share columns (4 / WN of them), in warp
  // order
  constexpr int WK = WARPS / TL::WN;
  float* red = reinterpret_cast<float*>(smem);  // [WK][BT][NT]
#pragma unroll
  for (int j = 0; j < MT; ++j) {
    const int ca = wn * 32 + g * 4 + j;
    const int cb = ca + MT;
    float* rw = red + (wk * BT + 2 * t) * NT;
    rw[ca] = acc[j][0];
    rw[NT + ca] = acc[j][1];
    rw[cb] = acc[j][2];
    rw[NT + cb] = acc[j][3];
  }
  __syncthreads();
  for (int e = tid; e < BT * NT; e += THREADS) {
    float s = red[e];
#pragma unroll
    for (int wi = 1; wi < WK; ++wi) s += red[wi * BT * NT + e];
    part_s[e] = s;
  }
  if (splits == 1) {
    __syncthreads();
    for (int e = tid; e < BT * NT; e += THREADS) {
      const int b = e / NT, n = n0 + e % NT;
      if (b < nb && n < N) out[(size_t)(b0 + b) * N + n] = part_s[e] * scale[n];
    }
    return;
  }
  // the cluster's partials, read across its blocks' shared memory in rank
  // order, each block a share of the tile; the second barrier keeps every
  // block's partial alive until the others have read it
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  for (int e = split * THREADS + tid; e < BT * NT; e += splits * THREADS) {
    const int b = e / NT, n = n0 + e % NT;
    if (b < nb && n < N) {
      float s = 0.f;
#pragma unroll
      for (int r = 0; r < MAX_SPLITS; ++r)
        if (r < splits) s += cluster.map_shared_rank(part_s, r)[e];
      out[(size_t)(b0 + b) * N + n] = s * scale[n];
    }
  }
  cluster.sync();
}

// the dynamic shared memory of a launch: the ring, then the block's
// partial
template <int XC, int NT>
int smem_bytes(int ring) {
  return ring * Tile<XC, NT>::BYTES + BT * NT * 4;
}

// the ring's stages: the most a split walks, at least 2, at most MAX_RING
// and RING_BYTES
template <int XC, int NT>
int ring_of(int K, int splits) {
  const int n_stages = (K + SROWS - 1) / SROWS;
  return max(2, min(min(MAX_RING, RING_BYTES / Tile<XC, NT>::BYTES),
                    (n_stages + splits - 1) / splits));
}

template <int XC, int WC, int NT, bool VEC>
int launch(const void* x, const void* w, const void* scale, void* out, int B,
           int K, int N, int splits, cudaStream_t stream) {
  static const int attr = static_cast<int>(cudaFuncSetAttribute(
      quant_mm<XC, WC, NT, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes<XC, NT>(ring_of<XC, NT>(1 << 30, 1))));
  if (attr) return attr;
  const int ring = ring_of<XC, NT>(K, splits);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, (N + NT - 1) / NT, (B + BT - 1) / BT);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem_bytes<XC, NT>(ring);
  cfg.stream = stream;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = splits;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, quant_mm<XC, WC, NT, VEC>,
      static_cast<const typename XType<XC>::type*>(x),
      static_cast<const uint8_t*>(w), static_cast<const float*>(scale),
      static_cast<float*>(out), B, K, N, (K + SROWS - 1) / SROWS, ring);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

template <int XC, int WC>
int launch_nt(const void* x, const void* w, const void* scale, void* out,
              int B, int K, int N, int nt, int splits, cudaStream_t s) {
  // every piece of w and of x on a 16-byte boundary
  const bool vec = N % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
                   (K * (XC == 0 ? 4 : 2)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0;
#define QMM_NT(NT)                                                          \
  if (nt == NT)                                                             \
    return vec ? launch<XC, WC, NT, true>(x, w, scale, out, B, K, N, splits, \
                                          s)                                \
               : launch<XC, WC, NT, false>(x, w, scale, out, B, K, N,       \
                                           splits, s);
  QMM_NT(32)
  QMM_NT(128)
#undef QMM_NT
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x_code: 0 = float32, 1 = bfloat16; w_code: 1 = int8, 2 = float8_e4m3fn.
// nt (32 output columns a block, the warps splitting K; 128, the warps
// splitting the columns) and splits (1 .. 8 blocks along K, at
// most ceil(K / 64)) are the wrapper's tiling. Returns the cudaError_t of
// the launch (0 = success); cudaErrorInvalidValue for a shape, code or
// tiling the kernel does not take. x [B, K], w [K, N], scale [N] float32,
// out [B, N] float32, all contiguous device memory.
extern "C" int quant_matmul(const void* x, const void* w, const void* scale,
                            void* out, int B, int K, int N, int x_code,
                            int w_code, int nt, int splits, void* stream) {
  if (B < 1 || K < 1 || N < 1 ||
      (nt != 32 && nt != 128) || splits < 1 ||
      splits > MAX_SPLITS || splits > (K + SROWS - 1) / SROWS ||
      (N + nt - 1) / nt > 65535 || (B + BT - 1) / BT > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_code == 0 && w_code == 1)
    return launch_nt<0, 1>(x, w, scale, out, B, K, N, nt, splits, s);
  if (x_code == 0 && w_code == 2)
    return launch_nt<0, 2>(x, w, scale, out, B, K, N, nt, splits, s);
  if (x_code == 1 && w_code == 1)
    return launch_nt<1, 1>(x, w, scale, out, B, K, N, nt, splits, s);
  if (x_code == 1 && w_code == 2)
    return launch_nt<1, 2>(x, w, scale, out, B, K, N, nt, splits, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The dynamic shared memory of the launch that serves (x_code, K, nt,
// splits); 0 for a tiling the kernel does not take.
extern "C" int quant_matmul_smem(int x_code, int K, int nt, int splits) {
  if (splits < 1 || K < 1 || (x_code != 0 && x_code != 1)) return 0;
#define QMM_SMEM(XC, NT) \
  if (x_code == XC && nt == NT) return smem_bytes<XC, NT>(ring_of<XC, NT>(K, splits));
  QMM_SMEM(0, 32) QMM_SMEM(0, 128) QMM_SMEM(1, 32) QMM_SMEM(1, 128)
#undef QMM_SMEM
  return 0;
}
