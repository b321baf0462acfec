// Flash attention for training: the forward with its logsumexp, and the
// backward (dq, dk and dv) as one kernel whose grid holds two roles.
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas/flash_attention.py:
// - flash_fwd serves _pallas_flash_attention / _pallas_flash_fwd_lse
//   (blocked, S > 512) and _pallas_flash_fwd_packed (two 64-wide heads per
//   128-lane cell, S <= 512);
// - flash_bwd serves _pallas_flash_bwd (its dq and its dk/dv pallas_calls)
//   and _pallas_flash_bwd_packed (dq, dk and dv in one call): blockIdx.z
//   (plus the launch's first role) picks the block's role, so one launch
//   computes all three and a launch of one role computes dq or dk/dv.
// The TPU's packed layout exists to fill a 128-lane tile without a
// transpose; here every block reads one head's rows of the model's
// [B, S, H, D] tensors through a TMA map (sm90_tiles.cuh), so one kernel
// serves both regimes.
//
// Conventions, as the TPU kernels and the plain versions in
// ops/kernels/flash_attention.py: bf16 q, k, v, do; scores, the running
// max and sum, the accumulators and lse are fp32; probabilities p and
// ds = p * (dp - delta) are rounded to bf16 before their products, which
// accumulate in fp32; outputs are rounded to bf16 once. Scores are
// computed unscaled and scaled in fp32 (scale * log2(e), so the softmax
// runs on exp2f); l sums the fp32 p; dq and dk each take the factor
// `scale` at the end, dv none. lse is natural-log [B, H, Sq] fp32; delta =
// rowsum(do * o) [B, H, Sq] fp32 comes from the caller. Causal masking
// follows the TPU's tril(k = Sk - Sq): query row i sees keys j <= i + off,
// off = Sk - Sq >= 0.
//
// What bounds them on the H100: at the training shape (B 44, S 512, 12
// heads of D 64, causal) the forward moves 4 * 34.6 MB (q, k, v, out),
// 0.042 ms at 3.35 TB/s, and computes 2 products of 2 D flops per visible
// (query, key) pair, 11 GFLOP, 0.011 ms at 989 TFLOP/s; the backward moves
// 7 * 34.6 MB (q, k, v, do, dq, dk, dv) and lse and delta, 0.073 ms, for 5
// products, 0.045 ms. So the bytes bound both, and what keeps them from
// the bound is latency: each key tile's products wait on their loads and
// on each other, and the softmax between them runs on the CUDA cores. The
// design is Hopper's (the flash-variant kernels' of flash_variants.cuh):
// - tiles arrive by TMA (rows past S read as zeros). A producer's single
//   thread loads the block's fixed tiles once, then each step's tiles into
//   a two-stage ring guarded by full/empty mbarriers; a consumer warpgroup
//   (64 rows, wgmma's M) computes on one stage while the next loads. The
//   forward's block at D 64 holds two consumer warpgroups (128 query rows)
//   sharing one k/v ring, which halves the ring's loads per row and fits
//   four warpgroups on an SM (two blocks) where one-warpgroup blocks fit
//   three; at D 128 a block is one warpgroup, two blocks an SM.
// - every product is wgmma with its fp32 accumulator in registers: scores
//   (m64n64k16 forward; m64n32k16 over half a tile in the backward, whose
//   dk/dv role holds 2 D accumulators a thread) from two K-major tiles in
//   shared memory; P and dS from registers, packed to bf16 in the
//   accumulator's own layout, times a tile read MN-major (the transpose
//   bit). No score, probability or output tile passes through shared
//   memory.
// - the forward's softmax is online, in registers: a thread holds two
//   rows' running max m and partial sum l; per key tile the row max is a
//   quad shuffle, the O accumulator is rescaled in registers by alpha =
//   exp2(m_old - m_new) before P V is issued, and l = l alpha + sum p (a
//   row's alpha is the same on its quad, so l is summed over the quad once,
//   at the end). The epilogue writes O / l rounded to bf16 and lse = (m +
//   log2 l) ln 2. Key tile 0 holds a key every row sees (causal: off >= 0),
//   so m is finite from the first tile on: alpha = exp2(-inf) = 0 there.
// - masks cost per element, so each tile is classified once per block: a
//   tile every row of the block sees whole runs without a test; the
//   diagonal tile and the ragged last tile test each element (a key past
//   Sk is a zero row of the TMA's fill, which would score 0, so it is
//   masked explicitly; so is a query past Sq in the dk/dv role). Causal
//   blocks stop at the diagonal: the forward and the dq role walk key
//   tiles 0 .. (off + q0 + 63) / 64, the dk/dv role query tiles from
//   max(0, k0 - off) / 64 on (the TPU's bounds, :163-167 and :396-401 of
//   the Pallas file). Blocks are issued heaviest first (reversed query
//   tiles in the forward and the dq role).
// - the backward is one grid without atomics: dq role blocks own a query
//   tile (fixed q, do; ring k, v; lse and delta of their two rows read once)
//   and write dq; dk/dv role blocks own a key tile with the keys on the
//   rows (fixed k, v; ring q, do and the tile's lse and delta, which 64
//   threads of the producer warpgroup load beside the TMA, zero past Sq)
//   and write dk and dv. Each role recomputes the scores it needs, so two
//   calls give the same bits, and a one-role launch the same bits as the
//   two-role one. The producer warpgroup hands its registers to the
//   consumers (setmaxnreg), so three blocks share an SM at D 64 and two
//   at D 128 (whose dk/dv role holds 128 accumulators a thread).
// Tried and dropped: issuing the next tile's q k^T beside this tile's P V
// in the forward (a second score set: ptxas serialized the wgmma, C7512 /
// C7520, and spilled at D 64), and a third or fourth ring stage (no gain).

#include <math.h>

#include "sm90_tiles.cuh"

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// the classes of a tile (see above)
enum : int { TILE_MIXED = 0, TILE_VISIBLE = 1 };

// ---------------------------------------------------------------------------
// forward: out and lse
// ---------------------------------------------------------------------------

// the block: WGS consumer warpgroups (64 query rows each) sharing one k/v
// ring, and a producer warp; BLOCKS of them share an SM. A warpgroup walks
// the key tiles its own rows see, at most WGS - 1 fewer than the block's
// last: the producer waits only for the release of tiles at least STAGES
// before the last, which every warpgroup computes.
template <int D>
struct Fwd {
  static constexpr int WGS = D == 64 ? 2 : 1;
  static constexpr int BLOCKS = 2;
  static constexpr int THREADS = WGS * WG_THREADS + 32;
  static constexpr int TB = D / 64 * BOX_BYTES;  // bytes of one tile
  // shared memory: the q tiles, the ring's stages (k and v), barriers
  static constexpr int RING = WGS * TB;
  static constexpr int STAGE = 2 * TB;
  static constexpr int BARS = RING + STAGES * STAGE;
  static constexpr size_t BYTES = 1024 + BARS + 8 * (1 + 2 * STAGES);
  static_assert(WGS - 1 <= STAGES, "a warpgroup may skip too many tiles");
};

// key tiles a block of query rows q0 .. q0 + 63 walks: up to the diagonal
// of its last row under causal masking
__device__ __forceinline__ int key_tiles(int q0, int Sk, int off,
                                         int causal) {
  const int n = (Sk + TILE - 1) / TILE;
  return causal ? min(n, (off + q0 + TILE - 1) / TILE + 1) : n;
}

// key tile k0 against query rows q0 ..: visible to every row, or mixed
__device__ __forceinline__ int query_tile_kind(int q0, int k0, int Sk,
                                               int off, int causal) {
  const int last = causal ? min(Sk - 1, q0 + off) : Sk - 1;
  return k0 + TILE - 1 <= last ? TILE_VISIBLE : TILE_MIXED;
}

// the scaled scores of one tile of this thread's rows, -inf past a row's
// last visible key (lim0, lim1) where the tile is mixed; the row maxima
template <bool CHECK>
__device__ __forceinline__ void fwd_scale(float (&sc)[32], int k0, int lim0,
                                          int lim1, float c, float& mx0,
                                          float& mx1) {
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const bool hi = frag_hi(e);
    float s = sc[e] * c;
    if (CHECK && k0 + frag_col(e) > (hi ? lim1 : lim0)) s = -INFINITY;
    sc[e] = s;
    if (hi)
      mx1 = fmaxf(mx1, s);
    else
      mx0 = fmaxf(mx0, s);
  }
}

template <int D>
__global__ void __launch_bounds__(Fwd<D>::THREADS, Fwd<D>::BLOCKS)
flash_fwd(const __grid_constant__ CUtensorMap mq,
          const __grid_constant__ CUtensorMap mk,
          const __grid_constant__ CUtensorMap mv, bf16* __restrict__ out,
          float* __restrict__ lse, int H, int Sq, int Sk, int causal,
          float c) {
  using L = Fwd<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  const Ring ring = ring_init(smem + L::BARS, 1, L::WGS * WG_THREADS);

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  // the block's first query row, heaviest blocks first
  const int qb = (gridDim.x - 1 - blockIdx.x) * L::WGS * TILE;
  const int off = Sk - Sq;

  if (threadIdx.x >= L::WGS * WG_THREADS) {  // the producer warp
    if (threadIdx.x == L::WGS * WG_THREADS) {
      const int n_tiles = key_tiles(qb + (L::WGS - 1) * TILE, Sk, off,
                                    causal);
      mbar_expect(ring.fixed, L::WGS * L::TB);
      for (int w = 0; w < L::WGS; ++w)
        tma_tile<D>(smem + w * L::TB, &mq, ring.fixed, h, qb + w * TILE, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES;
        unsigned char* st = smem + L::RING + s * L::STAGE;
        mbar_wait(&ring.empty[s], ((t / STAGES) & 1) ^ 1);
        mbar_expect(&ring.full[s], 2 * L::TB);
        tma_tile<D>(st, &mk, &ring.full[s], h, t * TILE, b);
        tma_tile<D>(st + L::TB, &mv, &ring.full[s], h, t * TILE, b);
      }
    }
    return;
  }

  // a consumer warpgroup: its q tile and the key tiles its rows see
  const int w = threadIdx.x / WG_THREADS;
  const unsigned char* Qs = smem + w * L::TB;
  const int q0 = qb + w * TILE;
  const int n_tiles = key_tiles(q0, Sk, off, causal);

  // this thread's rows r0 and r0 + 8 of the tile, and the last key each
  // sees
  const int tid = threadIdx.x % WG_THREADS;
  const int r0 = (tid >> 5) * 16 + ((tid & 31) >> 2);
  const int i0 = q0 + r0, i1 = i0 + 8;
  const int lim0 = causal ? min(Sk - 1, i0 + off) : Sk - 1;
  const int lim1 = causal ? min(Sk - 1, i1 + off) : Sk - 1;

  float o[D / 64][32];
#pragma unroll
  for (int n = 0; n < D / 64; ++n)
#pragma unroll
    for (int e = 0; e < 32; ++e) o[n][e] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  mbar_wait(ring.fixed, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % STAGES;
    const unsigned char* st = smem + L::RING + s * L::STAGE;
    mbar_wait(&ring.full[s], (t / STAGES) & 1);
    float sc[32];
    tile_abt<D, 64>(sc, Qs, st);  // q k^T
    const int k0 = t * TILE;
    float mx0 = m0, mx1 = m1;
    if (query_tile_kind(q0, k0, Sk, off, causal) == TILE_VISIBLE)
      fwd_scale<false>(sc, k0, lim0, lim1, c, mx0, mx1);
    else
      fwd_scale<true>(sc, k0, lim0, lim1, c, mx0, mx1);
    mx0 = quad_max(mx0);
    mx1 = quad_max(mx1);
    // the running state moves to the new max: o and l times alpha
    const float a0 = exp2f(m0 - mx0), a1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
#pragma unroll
    for (int n = 0; n < D / 64; ++n)
#pragma unroll
      for (int e = 0; e < 32; ++e) o[n][e] *= frag_hi(e) ? a1 : a0;
    float p0 = 0.f, p1 = 0.f;
    uint32_t pa[16];
#pragma unroll
    for (int e = 0; e < 32; e += 2) {
      const bool hi = frag_hi(e);
      const float m = hi ? m1 : m0;
      const float x = exp2f(sc[e] - m), y = exp2f(sc[e + 1] - m);
      if (hi)
        p1 += x + y;
      else
        p0 += x + y;
      pa[e / 2] = pack_bf16(__float2bfloat16_rn(x), __float2bfloat16_rn(y));
    }
    l0 = l0 * a0 + p0;
    l1 = l1 * a1 + p1;
    wg_fence();
    fence_regs(pa);
    tile_pv_issue<D, 64>(o, pa, st + L::TB);  // o += bf16(p) v
    wg_commit();
    wg_wait<0>();
#pragma unroll
    for (int n = 0; n < D / 64; ++n) fence_regs(o[n]);
    mbar_arrive(&ring.empty[s]);
  }
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);

  // out = o / l straight from the registers; lse from a lane of each quad;
  // rows past Sq are not stored
  const size_t row = (size_t)H * D;
  bf16* base = out + ((size_t)b * Sq * H + h) * D;
  store_acc<D, true>(o, i0 < Sq ? base + (size_t)i0 * row : nullptr,
                     i1 < Sq ? base + (size_t)i1 * row : nullptr, l0, l1);
  if ((tid & 3) == 0) {
    float* lrow = lse + (size_t)bh * Sq;
    if (i0 < Sq) lrow[i0] = (m0 + log2f(l0)) * LN2;
    if (i1 < Sq) lrow[i1] = (m1 + log2f(l1)) * LN2;
  }
}

// ---------------------------------------------------------------------------
// backward: one grid, the dq role and the dk/dv role
// ---------------------------------------------------------------------------

// consumers and a producer warpgroup: one thread of it issues the TMA
// loads, 64 others (the dk/dv role) load each query tile's lse and delta.
// The producer hands its registers to the consumers: at D 64 three blocks
// share an SM (80 registers a thread at launch; 24 producer, 136
// consumer: the dk/dv role's 64 accumulators beside a half tile's scores
// and dp), at D 128 two (128 at launch; 24 and 232 for 128 accumulators).
constexpr int BWD_THREADS = 2 * WG_THREADS;
constexpr int STAT_THREADS = TILE;  // the producer's last two warps
template <int D>
struct Regs {
  static constexpr int BLOCKS = D == 64 ? 3 : 2;
  static constexpr int PRODUCER = 24;
  static constexpr int CONSUMER = D == 64 ? 136 : 232;
  static_assert((PRODUCER + CONSUMER) * WG_THREADS * BLOCKS <= 65536,
                "the consumers take more registers than the SM has");
};

// columns of a score tile each product step takes: half a tile (the score
// and dp accumulators hold SUB / 2 values a thread)
constexpr int SUB = 32;

template <int D>
__device__ __forceinline__ void producer_regs() {
  setmaxnreg_dec<Regs<D>::PRODUCER>();
}

template <int D>
__device__ __forceinline__ void consumer_regs() {
  setmaxnreg_inc<Regs<D>::CONSUMER>();
}

// shared memory of the two roles, each: its fixed tiles, the ring's stages,
// per-query fp32 stats, then the barriers
template <int D>
struct DqSmem {  // fixed q, do; stages k, v
  static constexpr int TB = D / 64 * BOX_BYTES;
  static constexpr int RING = 2 * TB;
  static constexpr int STAGE = 2 * TB;
  static constexpr int BARS = RING + STAGES * STAGE;
};

template <int D>
struct DkvSmem {  // fixed k, v; stages q, do; lse and delta [STAGES][64]
  static constexpr int TB = D / 64 * BOX_BYTES;
  static constexpr int RING = 2 * TB;
  static constexpr int STAGE = 2 * TB;
  static constexpr int LSE = RING + STAGES * STAGE;
  static constexpr int DELTA = LSE + STAGES * TILE * 4;
  static constexpr int BARS = DELTA + STAGES * TILE * 4;
};

template <int D>
constexpr size_t bwd_smem() {
  return 1024 + 8 * (1 + 2 * STAGES) +
         (size_t)(DqSmem<D>::BARS > DkvSmem<D>::BARS ? DqSmem<D>::BARS
                                                     : DkvSmem<D>::BARS);
}

struct Shape {
  int H, Sq, Sk, off, causal;
  float c, scale;  // scale * log2(e), scale
};

// ds of SUB keys (k0 ..) of the dq role's two rows, packed as the bf16 A
// operand of dS K; CHECK: keys past a row's last visible key have p = 0
template <bool CHECK>
__device__ __forceinline__ void dq_ds(const float (&sc)[SUB / 2],
                                      const float (&dp)[SUB / 2],
                                      uint32_t (&da)[SUB / 4], int k0,
                                      const int (&lim)[2],
                                      const float (&lse2)[2],
                                      const float (&dl)[2], float c) {
#pragma unroll
  for (int e = 0; e < SUB / 2; e += 2) {
    const int hi = frag_hi(e);
    float ds[2];
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const float p = exp2f(sc[e + x] * c - lse2[hi]);
      ds[x] = CHECK && k0 + frag_col(e + x) > lim[hi]
                  ? 0.f
                  : p * (dp[e + x] - dl[hi]);
    }
    da[e / 2] = pack_bf16(__float2bfloat16_rn(ds[0]),
                          __float2bfloat16_rn(ds[1]));
  }
}

// dq of one query tile: the keys stream through the ring
template <int D>
__device__ __forceinline__ void bwd_dq(unsigned char* smem,
                                       const CUtensorMap* mq,
                                       const CUtensorMap* mk,
                                       const CUtensorMap* mv,
                                       const CUtensorMap* mdo,
                                       const float* lse, const float* delta,
                                       bf16* dq, const Shape& sh) {
  using L = DqSmem<D>;
  const int n_q = (sh.Sq + TILE - 1) / TILE;
  if ((int)blockIdx.x >= n_q) return;
  unsigned char* Qs = smem;
  unsigned char* dOs = smem + L::TB;
  const Ring ring = ring_init(smem + L::BARS);

  const int bh = blockIdx.y, b = bh / sh.H, h = bh % sh.H;
  const int q0 = (n_q - 1 - blockIdx.x) * TILE;  // heaviest first
  const int n_tiles = key_tiles(q0, sh.Sk, sh.off, sh.causal);

  if (threadIdx.x >= WG_THREADS) {  // the producer warpgroup
    producer_regs<D>();
    if (threadIdx.x == WG_THREADS) {
      mbar_expect(ring.fixed, 2 * L::TB);
      tma_tile<D>(Qs, mq, ring.fixed, h, q0, b);
      tma_tile<D>(dOs, mdo, ring.fixed, h, q0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES;
        unsigned char* st = smem + L::RING + s * L::STAGE;
        mbar_wait(&ring.empty[s], ((t / STAGES) & 1) ^ 1);
        mbar_expect(&ring.full[s], 2 * L::TB);
        tma_tile<D>(st, mk, &ring.full[s], h, t * TILE, b);
        tma_tile<D>(st + L::TB, mv, &ring.full[s], h, t * TILE, b);
      }
    }
    return;
  }
  consumer_regs<D>();

  const int tid = threadIdx.x;
  const int r0 = (tid >> 5) * 16 + ((tid & 31) >> 2);
  const int i[2] = {q0 + r0, q0 + r0 + 8};
  int lim[2];
  float lse2[2], dl[2];
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    lim[x] = sh.causal ? min(sh.Sk - 1, i[x] + sh.off) : sh.Sk - 1;
    const bool live = i[x] < sh.Sq;
    lse2[x] = live ? lse[(size_t)bh * sh.Sq + i[x]] * LOG2E : 0.f;
    dl[x] = live ? delta[(size_t)bh * sh.Sq + i[x]] : 0.f;
  }

  float acc[D / 64][32];
#pragma unroll
  for (int n = 0; n < D / 64; ++n)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[n][e] = 0.f;
  mbar_wait(ring.fixed, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % STAGES;
    const unsigned char* Ks = smem + L::RING + s * L::STAGE;
    mbar_wait(&ring.full[s], (t / STAGES) & 1);
    const int k0 = t * TILE;
    const int kind = query_tile_kind(q0, k0, sh.Sk, sh.off, sh.causal);
#pragma unroll
    for (int c0 = 0; c0 < TILE; c0 += SUB) {  // SUB keys at a time
      float sc[SUB / 2], dp[SUB / 2];
      const unsigned char* Kc = Ks + c0 * 128;
      tile_abt2<D, SUB>(sc, Qs, Kc, dp, dOs, Kc + L::TB);  // q k^T, do v^T
      uint32_t da[SUB / 4];
      if (kind == TILE_VISIBLE)
        dq_ds<false>(sc, dp, da, k0 + c0, lim, lse2, dl, sh.c);
      else
        dq_ds<true>(sc, dp, da, k0 + c0, lim, lse2, dl, sh.c);
      wg_fence();
      fence_regs(da);
      tile_pv_issue<D, SUB>(acc, da, Ks, c0);  // dq += ds k (k MN-major)
      wg_commit();
      wg_wait<0>();
#pragma unroll
      for (int n = 0; n < D / 64; ++n) fence_regs(acc[n]);
    }
    mbar_arrive(&ring.empty[s]);
  }
  const size_t row = (size_t)sh.H * D;
  bf16* base = dq + ((size_t)b * sh.Sq * sh.H + h) * D;
  store_acc<D, false>(acc, i[0] < sh.Sq ? base + (size_t)i[0] * row : nullptr,
                      i[1] < sh.Sq ? base + (size_t)i[1] * row : nullptr,
                      sh.scale, sh.scale);
}

// p^T and ds^T of SUB queries (q0 ..) of the dk/dv role's two rows (keys;
// a query sees key kp when it is at least lo = kp - off, or any key when
// not causal), their lse and delta from lse_s and dl_s, packed as the bf16
// A operands of P^T dO and dS^T Q; CHECK: queries past Sq or before lo
// have p = 0
template <bool CHECK>
__device__ __forceinline__ void dkv_p_ds(const float (&sc)[SUB / 2],
                                         const float (&dp)[SUB / 2],
                                         uint32_t (&pa)[SUB / 4],
                                         uint32_t (&da)[SUB / 4], int q0,
                                         const float* lse_s,
                                         const float* dl_s, const int (&lo)[2],
                                         int Sq, float c) {
#pragma unroll
  for (int e = 0; e < SUB / 2; e += 2) {
    const int hi = frag_hi(e);
    const int col = frag_col(e);
    const float2 l2 = *reinterpret_cast<const float2*>(lse_s + col);
    const float2 d2 = *reinterpret_cast<const float2*>(dl_s + col);
    const float ls[2] = {l2.x, l2.y}, dl[2] = {d2.x, d2.y};
    float p[2], ds[2];
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int qi = q0 + col + x;
      p[x] = exp2f(sc[e + x] * c - ls[x]);
      if (CHECK && (qi >= Sq || qi < lo[hi])) p[x] = 0.f;
      ds[x] = p[x] * (dp[e + x] - dl[x]);
    }
    pa[e / 2] = pack_bf16(__float2bfloat16_rn(p[0]),
                          __float2bfloat16_rn(p[1]));
    da[e / 2] = pack_bf16(__float2bfloat16_rn(ds[0]),
                          __float2bfloat16_rn(ds[1]));
  }
}

// dk and dv of one key tile: the transposed products (k q^T, v do^T) put
// the keys on the rows; the query tiles that see the key tile stream
// through the ring with their lse and delta
template <int D>
__device__ __forceinline__ void bwd_dkv(unsigned char* smem,
                                        const CUtensorMap* mq,
                                        const CUtensorMap* mk,
                                        const CUtensorMap* mv,
                                        const CUtensorMap* mdo,
                                        const float* lse, const float* delta,
                                        bf16* dk, bf16* dv, const Shape& sh) {
  using L = DkvSmem<D>;
  if ((int)blockIdx.x >= (sh.Sk + TILE - 1) / TILE) return;
  unsigned char* Ks = smem;
  unsigned char* Vs = smem + L::TB;
  float* lse_all = reinterpret_cast<float*>(smem + L::LSE);
  float* dl_all = reinterpret_cast<float*>(smem + L::DELTA);
  const Ring ring = ring_init(smem + L::BARS, 1 + STAT_THREADS);

  const int bh = blockIdx.y, b = bh / sh.H, h = bh % sh.H;
  const int k0 = blockIdx.x * TILE;  // heaviest first under causal masking
  // query tiles wholly before this key tile's diagonal see none of it
  const int first = sh.causal ? max(0, k0 - sh.off) / TILE : 0;
  const int n_tiles = (sh.Sq + TILE - 1) / TILE - first;

  if (threadIdx.x >= WG_THREADS) {  // the producer warpgroup
    producer_regs<D>();
    const int pt = threadIdx.x - WG_THREADS;
    if (pt == 0) {
      mbar_expect(ring.fixed, 2 * L::TB);
      tma_tile<D>(Ks, mk, ring.fixed, h, k0, b);
      tma_tile<D>(Vs, mv, ring.fixed, h, k0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES, q0 = (first + t) * TILE;
        unsigned char* st = smem + L::RING + s * L::STAGE;
        mbar_wait(&ring.empty[s], ((t / STAGES) & 1) ^ 1);
        mbar_expect(&ring.full[s], 2 * L::TB);
        tma_tile<D>(st, mq, &ring.full[s], h, q0, b);
        tma_tile<D>(st + L::TB, mdo, &ring.full[s], h, q0, b);
      }
    } else if (pt >= WG_THREADS - STAT_THREADS) {  // one query's stats each
      const int x = pt - (WG_THREADS - STAT_THREADS);
      const float* lrow = lse + (size_t)bh * sh.Sq;
      const float* drow = delta + (size_t)bh * sh.Sq;
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES, qi = (first + t) * TILE + x;
        const bool live = qi < sh.Sq;
        const float l2 = live ? lrow[qi] * LOG2E : 0.f;
        const float d = live ? drow[qi] : 0.f;
        mbar_wait(&ring.empty[s], ((t / STAGES) & 1) ^ 1);
        lse_all[s * TILE + x] = l2;
        dl_all[s * TILE + x] = d;
        mbar_arrive(&ring.full[s]);
      }
    }
    return;
  }
  consumer_regs<D>();

  const int tid = threadIdx.x;
  const int r0 = (tid >> 5) * 16 + ((tid & 31) >> 2);
  const int kp[2] = {k0 + r0, k0 + r0 + 8};
  const int lo[2] = {sh.causal ? kp[0] - sh.off : 0,
                     sh.causal ? kp[1] - sh.off : 0};

  float dka[D / 64][32], dva[D / 64][32];
#pragma unroll
  for (int n = 0; n < D / 64; ++n)
#pragma unroll
    for (int e = 0; e < 32; ++e) dka[n][e] = dva[n][e] = 0.f;
  mbar_wait(ring.fixed, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % STAGES, q0 = (first + t) * TILE;
    const unsigned char* Qs = smem + L::RING + s * L::STAGE;
    const unsigned char* dOs = Qs + L::TB;
    mbar_wait(&ring.full[s], (t / STAGES) & 1);
    // every query of the tile sees every key of this block's tile
    const bool visible = q0 + TILE <= sh.Sq &&
                         (!sh.causal || k0 + TILE - 1 <= q0 + sh.off);
#pragma unroll
    for (int c0 = 0; c0 < TILE; c0 += SUB) {  // SUB queries at a time
      float sc[SUB / 2], dp[SUB / 2];
      tile_abt2<D, SUB>(sc, Ks, Qs + c0 * 128, dp, Vs,
                        dOs + c0 * 128);  // k q^T, v do^T
      uint32_t pa[SUB / 4], da[SUB / 4];
      const float* ls = lse_all + s * TILE + c0;
      const float* dls = dl_all + s * TILE + c0;
      if (visible)
        dkv_p_ds<false>(sc, dp, pa, da, q0 + c0, ls, dls, lo, sh.Sq, sh.c);
      else
        dkv_p_ds<true>(sc, dp, pa, da, q0 + c0, ls, dls, lo, sh.Sq, sh.c);
      wg_fence();
      fence_regs(pa);
      fence_regs(da);
      tile_pv_issue<D, SUB>(dva, pa, dOs, c0);  // dv += p^T do
      tile_pv_issue<D, SUB>(dka, da, Qs, c0);   // dk += ds^T q
      wg_commit();
      wg_wait<0>();
#pragma unroll
      for (int n = 0; n < D / 64; ++n) {
        fence_regs(dva[n]);
        fence_regs(dka[n]);
      }
    }
    mbar_arrive(&ring.empty[s]);
  }
  const size_t row = (size_t)sh.H * D;
  const size_t base = ((size_t)b * sh.Sk * sh.H + h) * D;
  bf16* k_rows[2] = {nullptr, nullptr};
  bf16* v_rows[2] = {nullptr, nullptr};
#pragma unroll
  for (int x = 0; x < 2; ++x)
    if (kp[x] < sh.Sk) {
      k_rows[x] = dk + base + (size_t)kp[x] * row;
      v_rows[x] = dv + base + (size_t)kp[x] * row;
    }
  store_acc<D, false>(dka, k_rows[0], k_rows[1], sh.scale, sh.scale);
  store_acc<D, false>(dva, v_rows[0], v_rows[1], 1.f, 1.f);
}

// role 0 (dq) or 1 (dk and dv): role0 + blockIdx.z
template <int D>
__global__ void __launch_bounds__(BWD_THREADS, Regs<D>::BLOCKS)
flash_bwd(const __grid_constant__ CUtensorMap mq,
          const __grid_constant__ CUtensorMap mk,
          const __grid_constant__ CUtensorMap mv,
          const __grid_constant__ CUtensorMap mdo,
          const float* __restrict__ lse, const float* __restrict__ delta,
          bf16* __restrict__ dq, bf16* __restrict__ dk,
          bf16* __restrict__ dv, Shape sh, int role0) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  if (role0 + blockIdx.z == 0)
    bwd_dq<D>(smem, &mq, &mk, &mv, &mdo, lse, delta, dq, sh);
  else
    bwd_dkv<D>(smem, &mq, &mk, &mv, &mdo, lse, delta, dk, dv, sh);
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

bool bad_shape(int B, int H, int Sq, int Sk, int D, int causal) {
  return B < 1 || H < 1 || (long long)B * H > 65535 || Sq < 1 || Sk < 1 ||
         (causal && Sq > Sk) || (D != 64 && D != 128);
}

template <int D>
int fwd(const void* q, const void* k, const void* v, void* out, void* lse,
        int B, int H, int Sq, int Sk, int causal, float scale,
        cudaStream_t s) {
  using L = Fwd<D>;
  constexpr size_t smem = L::BYTES;
  static const int attr = prepare(flash_fwd<D>, smem);
  if (attr) return attr;
  CUtensorMap mq, mk, mv;
  int err = head_tile_map(&mq, q, B, Sq, H, D);
  if (!err) err = head_tile_map(&mk, k, B, Sk, H, D);
  if (!err) err = head_tile_map(&mv, v, B, Sk, H, D);
  if (err) return err;
  const dim3 grid((Sq + L::WGS * TILE - 1) / (L::WGS * TILE), B * H);
  flash_fwd<D><<<grid, L::THREADS, smem, s>>>(
      mq, mk, mv, static_cast<bf16*>(out), static_cast<float*>(lse), H, Sq,
      Sk, causal, scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}

// roles role0 .. role0 + n_roles - 1 in one launch
template <int D>
int bwd(const void* q, const void* k, const void* v, const void* dout,
        const void* lse, const void* delta, void* dq, void* dk, void* dv,
        int B, int H, int Sq, int Sk, int causal, float scale, int role0,
        int n_roles, cudaStream_t s) {
  constexpr size_t smem = bwd_smem<D>();
  static const int attr = prepare(flash_bwd<D>, smem);
  if (attr) return attr;
  CUtensorMap mq, mk, mv, mdo;
  int err = head_tile_map(&mq, q, B, Sq, H, D);
  if (!err) err = head_tile_map(&mk, k, B, Sk, H, D);
  if (!err) err = head_tile_map(&mv, v, B, Sk, H, D);
  if (!err) err = head_tile_map(&mdo, dout, B, Sq, H, D);
  if (err) return err;
  const int n_q = (Sq + TILE - 1) / TILE, n_k = (Sk + TILE - 1) / TILE;
  const int nx = n_roles == 2 ? (n_q > n_k ? n_q : n_k)
                : role0 == 0  ? n_q
                              : n_k;
  const Shape sh{H, Sq, Sk, Sk - Sq, causal, scale * LOG2E, scale};
  const dim3 grid(nx, B * H, n_roles);
  flash_bwd<D><<<grid, BWD_THREADS, smem, s>>>(
      mq, mk, mv, mdo, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), sh, role0);
  return static_cast<int>(cudaGetLastError());
}

int bwd_roles(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, void* dk,
              void* dv, int B, int H, int Sq, int Sk, int D, int causal,
              float scale, int role0, int n_roles, void* stream) {
  if (bad_shape(B, H, Sq, Sk, D, causal))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D == 64 ? bwd<64>(q, k, v, dout, lse, delta, dq, dk, dv, B, H, Sq,
                           Sk, causal, scale, role0, n_roles, s)
                 : bwd<128>(q, k, v, dout, lse, delta, dq, dk, dv, B, H, Sq,
                            Sk, causal, scale, role0, n_roles, s);
}

}  // namespace

// Device pointers, contiguous, 16-byte aligned, all bf16 but lse and delta
// (fp32 [B, H, Sq]): q, out, dout, dq [B, Sq, H, D]; k, v, dk, dv
// [B, Sk, H, D]. D is 64 or 128; causal (0 or 1) needs Sq <= Sk. Each
// returns the cudaError_t of its one launch (0 = success),
// cudaErrorInvalidValue for a shape it does not take.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, void* lse,
                                   int B, int H, int Sq, int Sk, int D,
                                   int causal, float scale, void* stream) {
  if (bad_shape(B, H, Sq, Sk, D, causal))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D == 64 ? fwd<64>(q, k, v, out, lse, B, H, Sq, Sk, causal, scale, s)
                 : fwd<128>(q, k, v, out, lse, B, H, Sq, Sk, causal, scale, s);
}

// dq, dk and dv: both roles of flash_bwd in one launch
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   void* dq, void* dk, void* dv, int B, int H,
                                   int Sq, int Sk, int D, int causal,
                                   float scale, void* stream) {
  return bwd_roles(q, k, v, dout, lse, delta, dq, dk, dv, B, H, Sq, Sk, D,
                   causal, scale, 0, 2, stream);
}

// dq alone: the dq role's blocks
extern "C" int flash_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* delta,
                                      void* dq, int B, int H, int Sq, int Sk,
                                      int D, int causal, float scale,
                                      void* stream) {
  return bwd_roles(q, k, v, dout, lse, delta, dq, nullptr, nullptr, B, H,
                   Sq, Sk, D, causal, scale, 0, 1, stream);
}

// dk and dv alone: the dk/dv role's blocks
extern "C" int flash_attention_bwd_dkv(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       void* dk, void* dv, int B, int H,
                                       int Sq, int Sk, int D, int causal,
                                       float scale, void* stream) {
  return bwd_roles(q, k, v, dout, lse, delta, nullptr, dk, dv, B, H, Sq, Sk,
                   D, causal, scale, 1, 1, stream);
}

// The dynamic shared memory one block of the D-wide kernels asks for.
extern "C" int flash_attention_smem(int D, int backward) {
  if (backward) return D == 64 ? (int)bwd_smem<64>() : (int)bwd_smem<128>();
  return D == 64 ? (int)Fwd<64>::BYTES : (int)Fwd<128>::BYTES;
}
