// Flash attention for training in fp32: the forward with its logsumexp,
// and the backward (dq, dk and dv) as one kernel whose grid holds two
// roles. The fp32 instance of flash_attention.cu, which takes bf16 alone.
//
// Replaces the same TPU kernels of paddle_tpu/ops/pallas/flash_attention.py
// as flash_attention.cu does, for fp32 q, k and v: _pallas_flash_attention /
// _pallas_flash_fwd_lse and _pallas_flash_fwd_packed (the forward), and
// _pallas_flash_bwd (its dq and dk/dv pallas_calls) and
// _pallas_flash_bwd_packed (the backward). The JAX entry
// (dot_product_attention) hands those kernels fp32 inputs as they come, as
// the eager layers' MultiHeadAttention does outside auto_cast.
//
// Conventions, as the plain versions in ops/kernels/flash_attention.py:
// q, k, v, do, out and the gradients are fp32 [B, S, H, D]; lse (natural
// log) and delta = rowsum(do * o) are fp32 [B, H, Sq]. Scores are scaled by
// scale * log2(e) and the softmax runs on exp2f; dq and dk take the factor
// `scale` at the end, dv none. Causal masking is the TPU's tril(k = Sk -
// Sq): query row i sees keys j <= i + off, off = Sk - Sq >= 0.
//
// Numerics: 3xTF32 on the tensor cores. Every operand of a product, read
// from shared memory or taken from an accumulator (p, ds), is split in
// registers into hi + lo: hi is x rounded to TF32 to nearest with ties away
// from zero (cvt.rna.tf32.f32's rounding, done as two integer operations
// on the bits, so that its low 13 bits are zero and lo = x - hi is exact),
// and lo goes to the tensor core as it is, which reads the top 19 bits of
// an operand. A product is three mma.sync m16n8k8 TF32 products into one
// fp32 accumulator: hi * lo and lo * hi first, then hi * hi. What is lost
// is lo * lo and lo's rounding, about 2^-21 of a product, where one TF32
// product alone loses 2^-11 (tests/test_torch_flash_f32_split.py holds
// both against the reference). The tensor core rounds its sums toward
// zero, so a chain of products into one accumulator drifts by up to 2^-24
// of its value a product (the most in dk and dv, whose first keys gather a
// causal head's every query): the outputs (o, dq, dk, dv) sum each tile's
// products from zero and add them on the CUDA cores. The softmax, its
// scaling, lse, delta and ds = p (dp - delta) stay fp32 on the CUDA
// cores.
//
// What bounds them on the H100: at BERT's shape (B 8, S 512, 12 heads of
// D 64, not causal) the forward's 2 products of 2 D flops per (query, key)
// pair are 6.4 GFLOP, three TF32 passes 19.3 GFLOP: 0.039 ms at 495
// TFLOP/s, against 0.019 ms for its 4 * 12.6 MB at 3.35 TB/s; the
// backward's 5 products 0.098 ms. So the tensor cores bound them; beside
// the products each tile costs the splits, the fragments' shared-memory
// reads and the softmax's exp2, issued by the same warps. The design:
// - mma.sync and not wgmma: wgmma's TF32 form reads B (and an A in shared
//   memory) only K-major, so p v, ds k, p^T do and ds^T q would need a
//   transposed copy of each tile, split in shared memory; mma.sync reads
//   any layout from padded shared memory. Every tile is stored by rows at a
//   stride of D + 4 floats, so both fragment patterns are free of bank
//   conflicts: x[n][k] (lanes at 4 g + t) and x[k][n] (lanes at 8 t + g).
// - a block is WARPS warps of 16 rows each (query rows in the forward and
//   the dq role, keys in the dk/dv role), their tile loaded once; the
//   other side's tiles of T rows stream through a ring of two stages by
//   16-byte cp.async (zero-filled past S), the next tile's copies issued
//   before this tile's products. D 64: 4 warps (64 rows), T 64, two blocks
//   an SM; D 128: the forward 4 warps and T 32 (two blocks), the backward 8
//   warps (128 rows) and T 32 (one block: 2 x 128 fixed rows and two
//   stages of 2 x 32 rows at a stride of 132 floats are 199 KB).
// - p and ds never leave registers: the m16n8k8 accumulator holds a row's
//   keys 2t and 2t + 1, and the TF32 A fragment wants k slots t and t + 4;
//   taking slot t as key 2t and slot t + 4 as key 2t + 1 makes the
//   accumulator the A fragment as it stands, and the B fragment of v (or
//   k, q, do) reads rows 2t and 2t + 1 to match.
// - the forward's softmax is online in registers: a thread holds two rows'
//   running max m and partial sum l, reduced over the quad that shares the
//   row; the output accumulator is rescaled by alpha = exp2(m_old - m_new)
//   before p v. Key tile 0 holds a key every row sees (off >= 0), so m is
//   finite from the first tile on.
// - code size: the forward unrolls its whole tile (twice: with and without
//   the masks); the backward, whose two roles hold seven products, keeps
//   each role's code small (a loop over D in steps of 32, masks tested on
//   every tile), as a backward unrolled like the forward ran slower.
// - a warp skips a tile its rows see none of, and a causal block walks
//   only the tiles its rows see (forward and dq role up to the last row's
//   diagonal, the dk/dv role from the first query tile that sees its first
//   key). The grid is one-dimensional and issues each head's heaviest
//   blocks first (block_of).
// - the backward is one grid without atomics: dq role blocks (fixed q, do;
//   k, v streamed) compute s = q k^T and dp = do v^T, ds = p (dp - delta)
//   and dq += ds k; dk/dv role blocks (fixed k, v; q, do, lse and delta
//   streamed) compute the transposed tiles k q^T and v do^T, and dv += p^T
//   do and dk += ds^T q. Each role recomputes the scores it needs, so a
//   one-role launch gives the same bits as the two-role one.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// the block of one kernel: WARPS warps own R = 16 WARPS rows, the other
// side streams in tiles of T rows
template <int D, bool BWD>
struct Cfg {
  static constexpr int WARPS = BWD && D == 128 ? 8 : 4;
  static constexpr int T = D == 64 ? 64 : 32;
  static constexpr int MIN_BLOCKS = BWD && D == 128 ? 1 : 2;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int R = 16 * WARPS;
  static constexpr int LD = D + 4;  // row stride of every tile, in floats
  // the fixed tiles (forward: q; backward: q and do, or k and v), then two
  // stages of the two streamed tiles (and, in the backward, the dk/dv
  // role's T values of lse and of delta)
  static constexpr int FIXED = (BWD ? 2 : 1) * R * LD;
  static constexpr int STAGE = 2 * T * LD + (BWD ? 2 * T : 0);
  static constexpr int BYTES = (FIXED + 2 * STAGE) * 4;
  static_assert(BYTES <= 232448 / MIN_BLOCKS - 1024, "shared memory");
};

// ---------------------------------------------------------------------------
// copies
// ---------------------------------------------------------------------------

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

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int n) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every group but the newest has landed (this thread's copies)
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// rows r0 .. r0 + ROWS - 1 of head h of batch b of a [B, S, H, D] tensor
// into shared memory at row stride D + 4, zero past S
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void load_rows(float* dst,
                                          const float* __restrict__ src,
                                          int b, int h, int H, int S,
                                          int r0) {
  constexpr int P = D / 4;  // 16-byte pieces a row
  static_assert(ROWS * P % THREADS == 0, "a whole number of pieces each");
#pragma unroll
  for (int it = 0; it < ROWS * P / THREADS; ++it) {
    const int i = threadIdx.x + it * THREADS;
    const int r = i / P, c = (i % P) * 4, row = r0 + r;
    const bool in = row < S;
    cp_async16(dst + r * (D + 4) + c,
               src + (((size_t)b * S + (in ? row : 0)) * H + h) * D + c,
               in ? 16 : 0);
  }
}

// n values from src[r0 ..] (one head's row of lse or delta), zero past S
template <int N, int THREADS>
__device__ __forceinline__ void load_vals(float* dst,
                                          const float* __restrict__ src,
                                          int S, int r0) {
  for (int i = threadIdx.x; i < N; i += THREADS) {
    const bool in = r0 + i < S;
    cp_async4(dst + i, src + (in ? r0 + i : 0), in ? 4 : 0);
  }
}

// ---------------------------------------------------------------------------
// 3xTF32 fragments and products
// ---------------------------------------------------------------------------

// x = hi + lo: hi is x rounded to TF32 (10 mantissa bits) to nearest with
// ties away from zero, as cvt.rna.tf32.f32 rounds, its low 13 bits zero,
// so lo = x - hi is exact; lo goes to the tensor core as it is, which
// reads the top 19 bits of an operand (lo rounded toward zero)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// the m16 x k8 A fragment and the k8 x n8 B fragment, each split
struct FragA {
  uint32_t h[4], l[4];
};
struct FragB {
  uint32_t h[2], l[2];
};

// lane = 4 g + t
struct Lane {
  int g, t;
};

// A of rows 0 .. 15 and columns k .. k + 7 of a tile x[row][col] at stride
// D + 4: (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)
template <int D>
__device__ __forceinline__ void frag_a(FragA& a, const float* x, int k,
                                       Lane ln) {
  constexpr int LD = D + 4;
  const float* p = x + ln.g * LD + k + ln.t;
  split(p[0], a.h[0], a.l[0]);
  split(p[8 * LD], a.h[1], a.l[1]);
  split(p[4], a.h[2], a.l[2]);
  split(p[8 * LD + 4], a.h[3], a.l[3]);
}

// B = x^T for a tile x[n][k] (scores against its rows): rows n .. n + 7,
// columns k + t and k + t + 4 of row n + g
template <int D>
__device__ __forceinline__ void frag_b_nk(FragB& b, const float* x, int n,
                                          int k, Lane ln) {
  const float* p = x + (n + ln.g) * (D + 4) + k + ln.t;
  split(p[0], b.h[0], b.l[0]);
  split(p[4], b.h[1], b.l[1]);
}

// B = x for a tile x[k][n] whose k slots are permuted as the accumulator
// A fragments' (acc_a): slot t is row k + 2t, slot t + 4 row k + 2t + 1
template <int D>
__device__ __forceinline__ void frag_b_kn(FragB& b, const float* x, int k,
                                          int n, Lane ln) {
  const float* p = x + (k + 2 * ln.t) * (D + 4) + n + ln.g;
  split(p[0], b.h[0], b.l[0]);
  split(p[D + 4], b.h[1], b.l[1]);
}

// the accumulator c of an m16 x n8 product (rows g, g + 8; columns 2t,
// 2t + 1) as the A fragment of the next product, its 8 columns the k
// slots permuted as frag_b_kn's
__device__ __forceinline__ void acc_a(FragA& a, const float (&c)[4]) {
  split(c[0], a.h[0], a.l[0]);
  split(c[2], a.h[1], a.l[1]);
  split(c[1], a.h[2], a.l[2]);
  split(c[3], a.h[3], a.l[3]);
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b in 3xTF32: the small products first, then hi * hi
__device__ __forceinline__ void mma3(float (&c)[4], const FragA& a,
                                     const FragB& b) {
  mma_tf32(c, a.h, b.l[0], b.l[1]);
  mma_tf32(c, a.l, b.h[0], b.h[1]);
  mma_tf32(c, a.h, b.h[0], b.h[1]);
}

// s[j] = x y^T over D for the warp's 16 rows of x (at xw) and the N rows
// of y, in N / 8 column blocks, UNROLL steps of 8 a trip of the loop over
// D. With fewer than 8 blocks the k steps alternate between two sets of
// accumulators, summed at the end, so that at least 8 chains of products
// are in flight
template <int D, int N, int UNROLL>
__device__ __forceinline__ void scores(float (&s)[N / 8][4], const float* xw,
                                       const float* y, Lane ln) {
  constexpr int SETS = N >= 64 ? 1 : 2;
  float acc[SETS][N / 8][4];
#pragma unroll
  for (int u = 0; u < SETS; ++u)
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
      acc[u][j][0] = acc[u][j][1] = acc[u][j][2] = acc[u][j][3] = 0.f;
#pragma unroll 1
  for (int k0 = 0; k0 < D; k0 += 8 * UNROLL) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int kk = k0 + 8 * u;
      FragA a;
      frag_a<D>(a, xw, kk, ln);
#pragma unroll
      for (int j = 0; j < N / 8; ++j) {
        FragB b;
        frag_b_nk<D>(b, y, 8 * j, kk, ln);
        mma3(acc[u % SETS][j], a, b);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[j][e] = SETS == 1 ? acc[0][j][e] : acc[0][j][e] + acc[1][j][e];
}

// acc += p y: p the N / 8 accumulators of an m16 x N product, y a tile
// [N][D]. Each output block's products over the tile are summed from zero
// and then added to acc on the CUDA cores: a chain of 3 N / 8 products
// rounded toward zero, where accumulating in place would chain 3 S / 8 of
// them over a sequence of S (see the header)
template <int D, int N>
__device__ __forceinline__ void apply(float (&acc)[D / 8][4],
                                      const float (&p)[N / 8][4],
                                      const float* y, Lane ln) {
  FragA a[N / 8];
#pragma unroll
  for (int j = 0; j < N / 8; ++j) acc_a(a[j], p[j]);
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    float t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      FragB b;
      frag_b_kn<D>(b, y, 8 * j, 8 * n, ln);
      mma3(t, a[j], b);
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += t[e];
  }
}

// reductions over the quad (4 lanes) that shares a row
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// tiles of T keys that rows up to `last` walk: up to its diagonal under
// causal masking
template <int T>
__device__ __forceinline__ int key_tiles(int last, int Sk, int off,
                                         int causal) {
  const int n = (Sk + T - 1) / T;
  return causal ? min(n, (off + last) / T + 1) : n;
}

struct Shape {
  int H, Sq, Sk, off, causal;
  float c, scale;  // scale * log2(e), scale
  int group;       // heads whose blocks are issued together (block_of)
};

// what the block blockIdx.x of a one-dimensional grid computes: the head
// bh, the rank of its tile (0 the heaviest) and its role. Blocks are issued
// in groups of `group` heads, a group's streamed tensors sized to stay in
// the L2 cache; within a group the rank is the slowest axis, so every
// head's heaviest tiles (the causal ones that walk the most tiles) start
// first, in both roles of the backward. With role_major the role is the
// slowest axis of all: where two blocks share an SM (the backward at D 64),
// a dq block beside a dk/dv block makes the SM fetch both roles' code, and
// the one-launch backward ran slower than its two roles launched apart
struct Block {
  int bh, rank, role;
};

__device__ __forceinline__ Block block_of(int BH, int ranks, int roles,
                                          int group, bool role_major) {
  int idx = blockIdx.x, role = 0;
  if (role_major) {
    role = idx / (BH * ranks);
    idx -= role * BH * ranks;
    roles = 1;
  }
  const int per = group * ranks * roles, grp = idx / per;
  const int rem = idx - grp * per, heads = min(group, BH - grp * group);
  const int rank = rem / (heads * roles), r = rem - rank * heads * roles;
  return {grp * group + r / roles, rank, role_major ? role : r % roles};
}

// ---------------------------------------------------------------------------
// forward: out and lse
// ---------------------------------------------------------------------------

// one key tile of the warp's rows: scores, the online softmax, o += p v.
// lim: the last key each of the thread's two rows sees (CHECK: a tile the
// rows do not see whole)
template <int D, int T, bool CHECK>
__device__ __forceinline__ void fwd_tile(const float* qw, const float* ks,
                                         const float* vs,
                                         float (&o)[D / 8][4], float (&m)[2],
                                         float (&l)[2], int k0,
                                         const int (&lim)[2], float c,
                                         Lane ln) {
  float s[T / 8][4];
  scores<D, T, D / 8>(s, qw, ks, ln);
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < T / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[j][e] * c;
      if (CHECK && k0 + 8 * j + 2 * ln.t + (e & 1) > lim[e >> 1])
        x = -INFINITY;
      s[j][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  float alpha[2], ps[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = quad_max(mx[i]);
    alpha[i] = exp2f(m[i] - mx[i]);  // 0 on the first tile
    m[i] = mx[i];
  }
#pragma unroll
  for (int j = 0; j < T / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2f(s[j][e] - m[e >> 1]);
      s[j][e] = p;
      ps[e >> 1] += p;
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + ps[i];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    o[n][0] *= alpha[0];
    o[n][1] *= alpha[0];
    o[n][2] *= alpha[1];
    o[n][3] *= alpha[1];
  }
  apply<D, T>(o, s, vs, ln);
}

template <int D>
__global__ void __launch_bounds__(Cfg<D, false>::THREADS,
                                  Cfg<D, false>::MIN_BLOCKS)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ out,
              float* __restrict__ lse, int B, Shape sh) {
  using L = Cfg<D, false>;
  constexpr int R = L::R, T = L::T, LD = L::LD;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* ring = smem + L::FIXED;  // stage s: k, then v
  const int H = sh.H, Sq = sh.Sq, Sk = sh.Sk, off = sh.off;
  const int causal = sh.causal;
  const float c = sh.c;
  const int n_q = (Sq + R - 1) / R;
  const Block blk = block_of(B * H, n_q, 1, sh.group, false);
  const int bh = blk.bh, b = bh / H, h = bh % H;
  const int q0 = (n_q - 1 - blk.rank) * R;  // heaviest first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const Lane ln{lane >> 2, lane & 3};
  const int qw = q0 + 16 * warp;  // the warp's first row
  const int n_tiles = key_tiles<T>(q0 + R - 1, Sk, off, causal);
  const int w_tiles = key_tiles<T>(qw + 15, Sk, off, causal);
  // the last key each of the thread's rows sees (every row sees key 0)
  int lim[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    lim[i] = causal ? min(Sk - 1, qw + ln.g + 8 * i + off) : Sk - 1;

  load_rows<D, R, L::THREADS>(qs, q, b, h, H, Sq, q0);
  load_rows<D, T, L::THREADS>(ring, k, b, h, H, Sk, 0);
  load_rows<D, T, L::THREADS>(ring + T * LD, v, b, h, H, Sk, 0);
  cp_async_commit();

  float o[D / 8][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  const float* qw_s = qs + 16 * warp * LD;
  for (int i = 0; i < n_tiles; ++i) {
    if (i + 1 < n_tiles) {  // the next tile into the other stage
      float* st = ring + ((i + 1) & 1) * L::STAGE;
      load_rows<D, T, L::THREADS>(st, k, b, h, H, Sk, (i + 1) * T);
      load_rows<D, T, L::THREADS>(st + T * LD, v, b, h, H, Sk, (i + 1) * T);
    }
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();  // tile i has landed, for every thread
    const float* ks = ring + (i & 1) * L::STAGE;
    const int k0 = i * T;
    if (i < w_tiles) {
      const bool whole = k0 + T <= Sk && (!causal || k0 + T - 1 <= qw + off);
      if (whole)
        fwd_tile<D, T, false>(qw_s, ks, ks + T * LD, o, m, l, k0, lim, c, ln);
      else
        fwd_tile<D, T, true>(qw_s, ks, ks + T * LD, o, m, l, k0, lim, c, ln);
    }
    __syncthreads();  // tile i is consumed: its stage may be refilled
  }

  // out = o / l, lse = (m + log2 l) ln 2; rows past Sq are not stored
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float li = quad_sum(l[i]);
    const int row = qw + ln.g + 8 * i;
    if (row >= Sq) continue;
    float* orow = out + (((size_t)b * Sq + row) * H + h) * D + 2 * ln.t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(orow + 8 * n) =
          make_float2(o[n][2 * i] / li, o[n][2 * i + 1] / li);
    if (ln.t == 0) lse[(size_t)bh * Sq + row] = (m[i] + log2f(li)) * LN2;
  }
}

// ---------------------------------------------------------------------------
// backward: one grid, the dq role and the dk/dv role
// ---------------------------------------------------------------------------

// one key tile of the dq role's warp: p = exp2(s c - lse2), ds = p (dp -
// delta) in place of s, dq += ds k
template <int D, int T>
__device__ __forceinline__ void dq_tile(const float* qw, const float* dow,
                                        const float* ks, const float* vs,
                                        float (&dq)[D / 8][4], int k0,
                                        const int (&lim)[2],
                                        const float (&lse2)[2],
                                        const float (&dl)[2], float c,
                                        Lane ln) {
  float s[T / 8][4], dp[T / 8][4];
  scores<D, T, 4>(s, qw, ks, ln);
  scores<D, T, 4>(dp, dow, vs, ln);
#pragma unroll
  for (int j = 0; j < T / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1;
      float p = exp2f(fmaf(s[j][e], c, -lse2[i]));
      if (k0 + 8 * j + 2 * ln.t + (e & 1) > lim[i]) p = 0.f;
      s[j][e] = p * (dp[j][e] - dl[i]);
    }
  apply<D, T>(dq, s, ks, ln);
}

// dq of the R query rows from q0: the key tiles they see stream through
template <int D>
__device__ __forceinline__ void bwd_dq(float* smem, const float* q,
                                       const float* k, const float* v,
                                       const float* dout, const float* lse,
                                       const float* delta, float* dq,
                                       const Shape& sh, Block blk) {
  using L = Cfg<D, true>;
  constexpr int R = L::R, T = L::T, LD = L::LD;
  const int n_q = (sh.Sq + R - 1) / R;
  if (blk.rank >= n_q) return;
  float* qs = smem;
  float* dos = qs + R * LD;
  float* ring = smem + L::FIXED;  // stage s: k, then v
  const int bh = blk.bh, b = bh / sh.H, h = bh % sh.H;
  const int q0 = (n_q - 1 - blk.rank) * R;  // heaviest first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const Lane ln{lane >> 2, lane & 3};
  const int qw = q0 + 16 * warp;
  const int n_tiles = key_tiles<T>(q0 + R - 1, sh.Sk, sh.off, sh.causal);
  const int w_tiles = key_tiles<T>(qw + 15, sh.Sk, sh.off, sh.causal);

  load_rows<D, R, L::THREADS>(qs, q, b, h, sh.H, sh.Sq, q0);
  load_rows<D, R, L::THREADS>(dos, dout, b, h, sh.H, sh.Sq, q0);
  load_rows<D, T, L::THREADS>(ring, k, b, h, sh.H, sh.Sk, 0);
  load_rows<D, T, L::THREADS>(ring + T * LD, v, b, h, sh.H, sh.Sk, 0);
  cp_async_commit();
  int lim[2];
  float lse2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = qw + ln.g + 8 * i;
    lim[i] = sh.causal ? min(sh.Sk - 1, row + sh.off) : sh.Sk - 1;
    const bool live = row < sh.Sq;
    lse2[i] = live ? lse[(size_t)bh * sh.Sq + row] * LOG2E : 0.f;
    dl[i] = live ? delta[(size_t)bh * sh.Sq + row] : 0.f;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  const float* qw_s = qs + 16 * warp * LD;
  const float* dow_s = dos + 16 * warp * LD;
  for (int i = 0; i < n_tiles; ++i) {
    if (i + 1 < n_tiles) {
      float* st = ring + ((i + 1) & 1) * L::STAGE;
      load_rows<D, T, L::THREADS>(st, k, b, h, sh.H, sh.Sk, (i + 1) * T);
      load_rows<D, T, L::THREADS>(st + T * LD, v, b, h, sh.H, sh.Sk,
                                  (i + 1) * T);
    }
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    const float* ks = ring + (i & 1) * L::STAGE;
    const int k0 = i * T;
    if (i < w_tiles)
      dq_tile<D, T>(qw_s, dow_s, ks, ks + T * LD, acc, k0, lim, lse2, dl,
                    sh.c, ln);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = qw + ln.g + 8 * i;
    if (row >= sh.Sq) continue;
    float* drow = dq + (((size_t)b * sh.Sq + row) * sh.H + h) * D + 2 * ln.t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(drow + 8 * n) = make_float2(
          acc[n][2 * i] * sh.scale, acc[n][2 * i + 1] * sh.scale);
  }
}

// one query tile of the dk/dv role's warp (keys on the rows): p^T and ds^T
// in place of the transposed scores and dp, dv += p^T do, dk += ds^T q.
// key: the thread's two keys; ls, dls: the tile's lse and delta
template <int D, int T>
__device__ __forceinline__ void dkv_tile(const float* kw, const float* vw,
                                         const float* qs, const float* dos,
                                         const float* ls, const float* dls,
                                         float (&dk)[D / 8][4],
                                         float (&dv)[D / 8][4], int q0,
                                         const int (&key)[2], const Shape& sh,
                                         Lane ln) {
  float st[T / 8][4], dpt[T / 8][4];
  scores<D, T, 4>(st, kw, qs, ln);
  scores<D, T, 4>(dpt, vw, dos, ln);
#pragma unroll
  for (int j = 0; j < T / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 8 * j + 2 * ln.t + (e & 1), qi = q0 + col;
      float p = exp2f(fmaf(st[j][e], sh.c, -ls[col] * LOG2E));
      if (qi >= sh.Sq || (sh.causal && qi < key[e >> 1] - sh.off))
        p = 0.f;
      st[j][e] = p;
      dpt[j][e] = p * (dpt[j][e] - dls[col]);
    }
  apply<D, T>(dv, st, dos, ln);
  apply<D, T>(dk, dpt, qs, ln);
}

// dk and dv of the R keys from k0: the query tiles that see them stream
// through with their lse and delta
template <int D>
__device__ __forceinline__ void bwd_dkv(float* smem, const float* q,
                                        const float* k, const float* v,
                                        const float* dout, const float* lse,
                                        const float* delta, float* dk,
                                        float* dv, const Shape& sh,
                                        Block blk) {
  using L = Cfg<D, true>;
  constexpr int R = L::R, T = L::T, LD = L::LD;
  if (blk.rank >= (sh.Sk + R - 1) / R) return;
  float* ks = smem;
  float* vs = ks + R * LD;
  float* ring = smem + L::FIXED;  // stage s: q, do, lse, delta
  const int bh = blk.bh, b = bh / sh.H, h = bh % sh.H;
  const int k0 = blk.rank * R;  // causal: the first blocks are heaviest
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const Lane ln{lane >> 2, lane & 3};
  const int kw0 = k0 + 16 * warp;  // the warp's first key
  // query tiles wholly before a key's diagonal see none of it
  const int first = sh.causal ? max(0, k0 - sh.off) / T : 0;
  const int w_first = sh.causal ? max(0, kw0 - sh.off) / T : 0;
  const int n_tiles = (sh.Sq + T - 1) / T;
  const float* lse_h = lse + (size_t)bh * sh.Sq;
  const float* delta_h = delta + (size_t)bh * sh.Sq;

  auto issue = [&](int tile) {
    float* st = ring + ((tile - first) & 1) * L::STAGE;
    const int r0 = tile * T;
    load_rows<D, T, L::THREADS>(st, q, b, h, sh.H, sh.Sq, r0);
    load_rows<D, T, L::THREADS>(st + T * LD, dout, b, h, sh.H, sh.Sq, r0);
    load_vals<T, L::THREADS>(st + 2 * T * LD, lse_h, sh.Sq, r0);
    load_vals<T, L::THREADS>(st + 2 * T * LD + T, delta_h, sh.Sq, r0);
  };
  load_rows<D, R, L::THREADS>(ks, k, b, h, sh.H, sh.Sk, k0);
  load_rows<D, R, L::THREADS>(vs, v, b, h, sh.H, sh.Sk, k0);
  if (first < n_tiles) issue(first);
  cp_async_commit();
  const int key[2] = {kw0 + ln.g, kw0 + ln.g + 8};

  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[n][e] = dva[n][e] = 0.f;
  const float* kw_s = ks + 16 * warp * LD;
  const float* vw_s = vs + 16 * warp * LD;
  for (int i = first; i < n_tiles; ++i) {
    if (i + 1 < n_tiles) issue(i + 1);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    const float* st = ring + ((i - first) & 1) * L::STAGE;
    const int q0 = i * T;
    if (i >= w_first)
      dkv_tile<D, T>(kw_s, vw_s, st, st + T * LD, st + 2 * T * LD,
                     st + 2 * T * LD + T, dka, dva, q0, key, sh, ln);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (key[i] >= sh.Sk) continue;
    const size_t at = (((size_t)b * sh.Sk + key[i]) * sh.H + h) * D + 2 * ln.t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<float2*>(dk + at + 8 * n) = make_float2(
          dka[n][2 * i] * sh.scale, dka[n][2 * i + 1] * sh.scale);
      *reinterpret_cast<float2*>(dv + at + 8 * n) =
          make_float2(dva[n][2 * i], dva[n][2 * i + 1]);
    }
  }
}

// role 0 (dq) or 1 (dk and dv): role0 plus the block's role (block_of)
template <int D>
__global__ void __launch_bounds__(Cfg<D, true>::THREADS,
                                  Cfg<D, true>::MIN_BLOCKS)
flash_bwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dq, float* __restrict__ dk,
              float* __restrict__ dv, int B, Shape sh, int role0,
              int n_roles) {
  using L = Cfg<D, true>;
  extern __shared__ __align__(16) float smem[];
  const int n_q = (sh.Sq + L::R - 1) / L::R, n_k = (sh.Sk + L::R - 1) / L::R;
  const int ranks = n_roles == 2 ? max(n_q, n_k) : role0 == 0 ? n_q : n_k;
  const Block blk =
      block_of(B * sh.H, ranks, n_roles, sh.group, L::MIN_BLOCKS > 1);
  if (role0 + blk.role == 0)
    bwd_dq<D>(smem, q, k, v, dout, lse, delta, dq, sh, blk);
  else
    bwd_dkv<D>(smem, q, k, v, dout, lse, delta, dk, dv, sh, blk);
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

bool bad_shape(int B, int H, int Sq, int Sk, int D, int causal) {
  return B < 1 || H < 1 || (long long)B * H > 65535 || Sq < 1 || Sk < 1 ||
         (causal && Sq > Sk) || (D != 64 && D != 128);
}

// heads of `head_bytes` of streamed tensors each whose blocks are issued
// together (block_of): as many as fit in 16 MB, a third of the L2 cache
int group_of(int BH, long long head_bytes) {
  const long long g = (16LL << 20) / head_bytes;
  return g < 1 ? 1 : g > BH ? BH : static_cast<int>(g);
}

// above 48 KB a block's shared memory must be asked for, once per kernel
template <typename Kernel>
int prepare(Kernel kernel, size_t smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
}

template <int D>
int fwd(const float* q, const float* k, const float* v, float* out,
        float* lse, int B, int H, int Sq, int Sk, int causal, float scale,
        cudaStream_t s) {
  using L = Cfg<D, false>;
  static const int attr = prepare(flash_fwd_f32<D>, L::BYTES);
  if (attr) return attr;
  // the streamed k and v of a group of heads: up to 16 MB
  const Shape sh{H, Sq, Sk, Sk - Sq, causal, scale * LOG2E, scale,
                 group_of(B * H, 2LL * Sk * D * 4)};
  const int grid = B * H * ((Sq + L::R - 1) / L::R);
  flash_fwd_f32<D><<<grid, L::THREADS, L::BYTES, s>>>(q, k, v, out, lse, B,
                                                       sh);
  return static_cast<int>(cudaGetLastError());
}

// roles role0 .. role0 + n_roles - 1 in one launch
template <int D>
int bwd(const float* q, const float* k, const float* v, const float* dout,
        const float* lse, const float* delta, float* dq, float* dk,
        float* dv, int B, int H, int Sq, int Sk, int causal, float scale,
        int role0, int n_roles, cudaStream_t s) {
  using L = Cfg<D, true>;
  static const int attr = prepare(flash_bwd_f32<D>, L::BYTES);
  if (attr) return attr;
  const int n_q = (Sq + L::R - 1) / L::R, n_k = (Sk + L::R - 1) / L::R;
  const int ranks = n_roles == 2 ? (n_q > n_k ? n_q : n_k)
                   : role0 == 0  ? n_q
                                 : n_k;
  // the streamed tensors of a group of heads (q, do, k, v): up to 16 MB
  const Shape sh{H, Sq, Sk, Sk - Sq, causal, scale * LOG2E, scale,
                 group_of(B * H, 2LL * (Sq + Sk) * D * 4)};
  const int grid = B * H * ranks * n_roles;
  flash_bwd_f32<D><<<grid, L::THREADS, L::BYTES, s>>>(
      q, k, v, dout, lse, delta, dq, dk, dv, B, sh, role0, n_roles);
  return static_cast<int>(cudaGetLastError());
}

int bwd_roles(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, void* dk,
              void* dv, int B, int H, int Sq, int Sk, int D, int causal,
              float scale, int role0, int n_roles, void* stream) {
  if (bad_shape(B, H, Sq, Sk, D, causal))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* f[6] = {static_cast<const float*>(q),
                       static_cast<const float*>(k),
                       static_cast<const float*>(v),
                       static_cast<const float*>(dout),
                       static_cast<const float*>(lse),
                       static_cast<const float*>(delta)};
  float* g[3] = {static_cast<float*>(dq), static_cast<float*>(dk),
                 static_cast<float*>(dv)};
  return D == 64 ? bwd<64>(f[0], f[1], f[2], f[3], f[4], f[5], g[0], g[1],
                           g[2], B, H, Sq, Sk, causal, scale, role0, n_roles,
                           s)
                 : bwd<128>(f[0], f[1], f[2], f[3], f[4], f[5], g[0], g[1],
                            g[2], B, H, Sq, Sk, causal, scale, role0,
                            n_roles, s);
}

}  // namespace

// Device pointers, contiguous, 16-byte aligned, all fp32: q, out, dout, dq
// [B, Sq, H, D]; k, v, dk, dv [B, Sk, H, D]; lse and delta [B, H, Sq]. D
// is 64 or 128; causal (0 or 1) needs Sq <= Sk. Each returns the
// cudaError_t of its one launch (0 = success), cudaErrorInvalidValue for a
// shape it does not take.
extern "C" int flash_attention_f32_fwd(const void* q, const void* k,
                                       const void* v, void* out, void* lse,
                                       int B, int H, int Sq, int Sk, int D,
                                       int causal, float scale,
                                       void* stream) {
  if (bad_shape(B, H, Sq, Sk, D, causal))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fq = static_cast<const float*>(q);
  const float* fk = static_cast<const float*>(k);
  const float* fv = static_cast<const float*>(v);
  float* fo = static_cast<float*>(out);
  float* fl = static_cast<float*>(lse);
  return D == 64
             ? fwd<64>(fq, fk, fv, fo, fl, B, H, Sq, Sk, causal, scale, s)
             : fwd<128>(fq, fk, fv, fo, fl, B, H, Sq, Sk, causal, scale, s);
}

// dq, dk and dv: both roles of flash_bwd_f32 in one launch
extern "C" int flash_attention_f32_bwd(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       void* dq, void* dk, void* dv, int B,
                                       int H, int Sq, int Sk, int D,
                                       int causal, float scale,
                                       void* stream) {
  return bwd_roles(q, k, v, dout, lse, delta, dq, dk, dv, B, H, Sq, Sk, D,
                   causal, scale, 0, 2, stream);
}

// dq alone: the dq role's blocks
extern "C" int flash_attention_f32_bwd_dq(const void* q, const void* k,
                                          const void* v, const void* dout,
                                          const void* lse, const void* delta,
                                          void* dq, int B, int H, int Sq,
                                          int Sk, int D, int causal,
                                          float scale, void* stream) {
  return bwd_roles(q, k, v, dout, lse, delta, dq, nullptr, nullptr, B, H,
                   Sq, Sk, D, causal, scale, 0, 1, stream);
}

// dk and dv alone: the dk/dv role's blocks
extern "C" int flash_attention_f32_bwd_dkv(const void* q, const void* k,
                                           const void* v, const void* dout,
                                           const void* lse,
                                           const void* delta, void* dk,
                                           void* dv, int B, int H, int Sq,
                                           int Sk, int D, int causal,
                                           float scale, void* stream) {
  return bwd_roles(q, k, v, dout, lse, delta, nullptr, dk, dv, B, H, Sq, Sk,
                   D, causal, scale, 1, 1, stream);
}

// The dynamic shared memory one block of the D-wide kernels asks for.
extern "C" int flash_attention_f32_smem(int D, int backward) {
  if (backward) return D == 64 ? Cfg<64, true>::BYTES : Cfg<128, true>::BYTES;
  return D == 64 ? Cfg<64, false>::BYTES : Cfg<128, false>::BYTES;
}
