// The flash-variant backward kernel, fv_bwd: dq, dk and dv of run_bwd and
// the backward ablations in one launch. The design, the variant bits and
// what bounds it are in flash_variants.cuh; the Hopper building blocks in
// sm90_tiles.cuh.

#include "flash_variants.cuh"

namespace {

// consumers and a producer warpgroup, one thread of which issues the
// loads. At D 64 the producer hands its registers to the consumers: three
// blocks share an SM (80 registers a thread at launch; 24 producer, 136
// consumer), the dk/dv role's 64 accumulators beside a half tile's scores
// and dp. (Two blocks of 232-register consumers over whole tiles ran
// slower; a 160-thread block with a producer warp spilled under ptxas's
// cap for two blocks.)
constexpr int THREADS = 2 * WG_THREADS;
template <int D>
struct Regs {
  static constexpr int BLOCKS = D == 64 ? 3 : 1;
  static constexpr bool SHIFT = D == 64;
  static constexpr int PRODUCER = 24;
  static constexpr int CONSUMER = 136;
};

// columns of a score tile each product step takes: half a tile (the score
// and dp accumulators hold SUB / 2 values a thread)
constexpr int SUB = 32;

// the role's split: the producer warpgroup gives up its registers and
// returns after its loads; the consumers take them
template <int D>
__device__ __forceinline__ void producer_regs() {
  if constexpr (Regs<D>::SHIFT) setmaxnreg_dec<Regs<D>::PRODUCER>();
}

template <int D>
__device__ __forceinline__ void consumer_regs() {
  if constexpr (Regs<D>::SHIFT) setmaxnreg_inc<Regs<D>::CONSUMER>();
}

// shared memory of the two roles, each: its fixed tiles, the ring's stages,
// per-row fp32 stats, then the barriers (fixed, full[STAGES],
// empty[STAGES])
template <int D>
struct DqSmem {  // fixed q, do, o; stages k, v; delta [64]
  static constexpr int TB = D / 64 * BOX_BYTES;
  static constexpr int RING = 3 * TB;
  static constexpr int STAGE = 2 * TB;
  static constexpr int DELTA = RING + STAGES * STAGE;
  static constexpr int BARS = DELTA + TILE * 4;
};

template <int D>
struct DkvSmem {  // fixed k, v; stages q, do, o; lse and delta [STAGES][64]
  static constexpr int TB = D / 64 * BOX_BYTES;
  static constexpr int RING = 2 * TB;
  static constexpr int STAGE = 3 * TB;
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

// p and ds of one (query, key) pair inside the query's extent, from the
// score s, dp = do . v, the query's lse and delta; `masked`: key past the
// query (p is masked to 0 after exp2, as the reference does)
template <int F>
__device__ __forceinline__ void p_ds(float s, float dp, float lse2, float dl,
                                     bool masked, float& p, float& ds) {
  const float a = s - lse2;
  p = (F & DROP_EXP) ? a : vexp2<F>(a);
  if ((F & CAUSAL) && masked) p = 0.f;
  ds = (F & DROP_DS) ? dp : p * (dp - dl);
}

// the dq role's two rows: query index, extent, lse and delta
struct QRows {
  int i0, i1, cols0, cols1;
  float lse0, lse1, dl0, dl1;
};

// ds of N columns (keys k0 ..) of the dq role, packed as the bf16 A
// operand of dS K. KIND: TILE_MIXED checks each element's extent and mask,
// TILE_VISIBLE knows it visible, TILE_MASKED knows p = 0
template <int F, int KIND, int N>
__device__ __forceinline__ void dq_tile_ds(const float (&sc)[N / 2],
                                           const float (&dp)[N / 2],
                                           uint32_t (&da)[N / 4], int k0,
                                           const QRows& rw) {
#pragma unroll
  for (int e = 0; e < N / 2; e += 2) {
    const bool hi = frag_hi(e);
    float ds[2];
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int kp = k0 + frag_col(e + x);
      const int i = hi ? rw.i1 : rw.i0;
      float p;
      ds[x] = 0.f;
      if (KIND == TILE_MASKED)
        ds[x] = (F & DROP_DS) ? dp[e + x] : 0.f;
      else if (KIND == TILE_VISIBLE || kp < (hi ? rw.cols1 : rw.cols0))
        p_ds<F>(sc[e + x], dp[e + x], hi ? rw.lse1 : rw.lse0,
                hi ? rw.dl1 : rw.dl0, KIND == TILE_MIXED && kp > i, p,
                ds[x]);
    }
    da[e / 2] = pack_bf16(__float2bfloat16_rn(ds[0]),
                          __float2bfloat16_rn(ds[1]));
  }
}

// the dk/dv role's two rows (keys): index and the first query whose
// extent reaches it, R * (kp / R)
struct KRows {
  int kp0, kp1, lo0, lo1;
};

// how query tile q0 meets key tile k0 in the dk/dv role (see tile_kind):
// every query reaches every key when q0 >= R * ((k0 + 63) / R)
__device__ __forceinline__ int key_tile_kind(int k0, int q0, int R,
                                             bool causal) {
  if (q0 < R * ((k0 + TILE - 1) / R)) return TILE_MIXED;
  if (!causal || k0 + TILE - 1 <= q0) return TILE_VISIBLE;
  return k0 > q0 + TILE - 1 ? TILE_MASKED : TILE_MIXED;
}

// p^T and ds^T of N columns of the dk/dv role (keys on the rows, queries
// q0 .. on the columns, their lse and delta in shared memory from lse_s
// and dl_s), packed as the bf16 A operands of P^T dO and dS^T Q
template <int F, int KIND, int N>
__device__ __forceinline__ void dkv_tile_p_ds(
    const float (&sc)[N / 2], const float (&dp)[N / 2],
    uint32_t (&pa)[N / 4], uint32_t (&da)[N / 4], int q0, const float* lse_s,
    const float* dl_s, const KRows& kr) {
#pragma unroll
  for (int e = 0; e < N / 2; e += 2) {
    const bool hi = frag_hi(e);
    const int kp = hi ? kr.kp1 : kr.kp0, lo = hi ? kr.lo1 : kr.lo0;
    const int c = frag_col(e);
    float lse2[2] = {0.f, 0.f}, dl[2] = {0.f, 0.f};
    if (KIND != TILE_MASKED) {
      const float2 l2 = *reinterpret_cast<const float2*>(lse_s + c);
      lse2[0] = l2.x;
      lse2[1] = l2.y;
      if (!(F & DROP_DELTA)) {
        const float2 d2 = *reinterpret_cast<const float2*>(dl_s + c);
        dl[0] = d2.x;
        dl[1] = d2.y;
      }
    }
    float p[2], ds[2];
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int qi = q0 + c + x;
      p[x] = ds[x] = 0.f;
      if (KIND == TILE_MASKED)
        ds[x] = (F & DROP_DS) ? dp[e + x] : 0.f;
      else if (KIND == TILE_VISIBLE || qi >= lo)
        p_ds<F>(sc[e + x], dp[e + x], lse2[x], dl[x],
                KIND == TILE_MIXED && kp > qi, p[x], ds[x]);
    }
    pa[e / 2] = pack_bf16(__float2bfloat16_rn(p[0]),
                          __float2bfloat16_rn(p[1]));
    da[e / 2] = pack_bf16(__float2bfloat16_rn(ds[0]),
                          __float2bfloat16_rn(ds[1]));
  }
}

// dq of one query tile: the keys stream through the ring
template <int D, int F>
__device__ __forceinline__ void bwd_dq(
    unsigned char* smem, const CUtensorMap* mq, const CUtensorMap* mk,
    const CUtensorMap* mv, const CUtensorMap* mdo, const CUtensorMap* mo,
    const float* lse, bf16* dq, int H, int S, int R, float dq_scale) {
  using L = DqSmem<D>;
  unsigned char* Qs = smem;
  unsigned char* dOs = smem + L::TB;
  unsigned char* Os = smem + 2 * L::TB;
  float* dl_s = reinterpret_cast<float*>(smem + L::DELTA);
  const Ring ring = ring_init(smem + L::BARS);

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * TILE;
  const int n_tiles = (min(S, extent(q0 + TILE - 1, R)) + TILE - 1) / TILE;

  if (threadIdx.x >= WG_THREADS) {  // the producer warpgroup
    producer_regs<D>();
    if (threadIdx.x == WG_THREADS) {
      mbar_expect(ring.fixed, 3 * L::TB);
      tma_tile<D>(Qs, mq, ring.fixed, h, q0, b);
      tma_tile<D>(dOs, mdo, ring.fixed, h, q0, b);
      tma_tile<D>(Os, mo, ring.fixed, h, q0, b);
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
  QRows rw;
  rw.i0 = q0 + r0;
  rw.i1 = rw.i0 + 8;
  rw.cols0 = min(S, extent(rw.i0, R));
  rw.cols1 = min(S, extent(rw.i1, R));
  rw.lse0 = lse[(size_t)bh * S + rw.i0];
  rw.lse1 = lse[(size_t)bh * S + rw.i1];
  mbar_wait(ring.fixed, 0);
  if (!(F & DROP_DELTA)) tile_rowdot<D>(dl_s, dOs, Os);
  wg_sync();
  rw.dl0 = (F & DROP_DELTA) ? 0.f : dl_s[r0];
  rw.dl1 = (F & DROP_DELTA) ? 0.f : dl_s[r0 + 8];

  float acc[D / 64][32];
#pragma unroll
  for (int n = 0; n < D / 64; ++n)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[n][e] = 0.f;
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % STAGES;
    const unsigned char* Ks = smem + L::RING + s * L::STAGE;
    mbar_wait(&ring.full[s], (t / STAGES) & 1);
    const int k0 = t * TILE;
    const int kind = tile_kind(q0, k0, S, R, (F & CAUSAL) != 0);
#pragma unroll
    for (int c0 = 0; c0 < TILE; c0 += SUB) {  // SUB keys at a time
      float sc[SUB / 2], dp[SUB / 2];
      const unsigned char* Kc = Ks + c0 * 128;
      tile_abt2<D, SUB>(sc, Qs, Kc, dp, dOs, Kc + L::TB);  // q k^T, do v^T
      uint32_t da[SUB / 4];
      if (kind == TILE_VISIBLE)
        dq_tile_ds<F, TILE_VISIBLE, SUB>(sc, dp, da, k0 + c0, rw);
      else if (kind == TILE_MASKED)
        dq_tile_ds<F, TILE_MASKED, SUB>(sc, dp, da, k0 + c0, rw);
      else
        dq_tile_ds<F, TILE_MIXED, SUB>(sc, dp, da, k0 + c0, rw);
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
  const size_t row = (size_t)H * D;
  bf16* base = dq + ((size_t)b * S * H + h) * D;
  store_acc<D, false>(acc, base + (size_t)rw.i0 * row,
                      base + (size_t)rw.i1 * row, dq_scale, dq_scale);
}

// dk and dv of one key tile: the transposed products (k q^T, v do^T) put
// the keys on the rows; the queries whose extent reaches the tile stream
// through the ring with their lse
template <int D, int F>
__device__ __forceinline__ void bwd_dkv(
    unsigned char* smem, const CUtensorMap* mq, const CUtensorMap* mk,
    const CUtensorMap* mv, const CUtensorMap* mdo, const CUtensorMap* mo,
    const float* lse, bf16* dk, bf16* dv, int H, int S, int R,
    float dk_scale) {
  using L = DkvSmem<D>;
  unsigned char* Ks = smem;
  unsigned char* Vs = smem + L::TB;
  const Ring ring = ring_init(smem + L::BARS);

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * TILE;
  // query rows whose extent reaches this key tile: i >= R * (k0 / R)
  const int first = (R * (k0 / R)) / TILE;
  const int n_tiles = S / TILE - first;

  if (threadIdx.x >= WG_THREADS) {  // the producer warpgroup
    producer_regs<D>();
    if (threadIdx.x == WG_THREADS) {
      mbar_expect(ring.fixed, 2 * L::TB);
      tma_tile<D>(Ks, mk, ring.fixed, h, k0, b);
      tma_tile<D>(Vs, mv, ring.fixed, h, k0, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES, q0 = (first + t) * TILE;
        unsigned char* st = smem + L::RING + s * L::STAGE;
        mbar_wait(&ring.empty[s], ((t / STAGES) & 1) ^ 1);
        mbar_expect(&ring.full[s], 3 * L::TB + TILE * 4);
        tma_tile<D>(st, mq, &ring.full[s], h, q0, b);
        tma_tile<D>(st + L::TB, mdo, &ring.full[s], h, q0, b);
        tma_tile<D>(st + 2 * L::TB, mo, &ring.full[s], h, q0, b);
        bulk_copy(smem + L::LSE + s * TILE * 4, lse + (size_t)bh * S + q0,
                  TILE * 4, &ring.full[s]);
      }
    }
    return;
  }
  consumer_regs<D>();

  const int tid = threadIdx.x;
  const int r0 = (tid >> 5) * 16 + ((tid & 31) >> 2);
  KRows kr;
  kr.kp0 = k0 + r0;
  kr.kp1 = kr.kp0 + 8;
  kr.lo0 = R * (kr.kp0 / R);
  kr.lo1 = R * (kr.kp1 / R);
  mbar_wait(ring.fixed, 0);

  float dka[D / 64][32], dva[D / 64][32];
#pragma unroll
  for (int n = 0; n < D / 64; ++n)
#pragma unroll
    for (int e = 0; e < 32; ++e) dka[n][e] = dva[n][e] = 0.f;
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % STAGES, q0 = (first + t) * TILE;
    const unsigned char* Qs = smem + L::RING + s * L::STAGE;
    const unsigned char* dOs = Qs + L::TB;
    const float* lse_s = reinterpret_cast<const float*>(smem + L::LSE) +
                         s * TILE;
    float* dl_s = reinterpret_cast<float*>(smem + L::DELTA) + s * TILE;
    mbar_wait(&ring.full[s], (t / STAGES) & 1);
    if (!(F & DROP_DELTA)) {  // this query tile's delta
      tile_rowdot<D>(dl_s, dOs, Qs + 2 * L::TB);
      wg_sync();
    }
    const int kind = key_tile_kind(k0, q0, R, (F & CAUSAL) != 0);
#pragma unroll
    for (int c0 = 0; c0 < TILE; c0 += SUB) {  // SUB queries at a time
      float sc[SUB / 2], dp[SUB / 2];
      tile_abt2<D, SUB>(sc, Ks, Qs + c0 * 128, dp, Vs,
                        dOs + c0 * 128);  // k q^T, v do^T
      uint32_t pa[SUB / 4], da[SUB / 4];
      const float* ls = lse_s + c0;
      const float* dls = dl_s + c0;
      if (kind == TILE_VISIBLE)
        dkv_tile_p_ds<F, TILE_VISIBLE, SUB>(sc, dp, pa, da, q0 + c0, ls, dls,
                                            kr);
      else if (kind == TILE_MASKED)
        dkv_tile_p_ds<F, TILE_MASKED, SUB>(sc, dp, pa, da, q0 + c0, ls, dls,
                                           kr);
      else
        dkv_tile_p_ds<F, TILE_MIXED, SUB>(sc, dp, pa, da, q0 + c0, ls, dls,
                                          kr);
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
  const size_t row = (size_t)H * D;
  const size_t off = ((size_t)b * S * H + h) * D;
  store_acc<D, false>(dka, dk + off + (size_t)kr.kp0 * row,
                      dk + off + (size_t)kr.kp1 * row, dk_scale, dk_scale);
  store_acc<D, false>(dva, dv + off + (size_t)kr.kp0 * row,
                      dv + off + (size_t)kr.kp1 * row, 1.f, 1.f);
}

template <int D, int F>
__global__ void __launch_bounds__(THREADS, Regs<D>::BLOCKS)
fv_bwd(const __grid_constant__ CUtensorMap mq,
       const __grid_constant__ CUtensorMap mk,
       const __grid_constant__ CUtensorMap mv,
       const __grid_constant__ CUtensorMap mdo,
       const __grid_constant__ CUtensorMap mo, const float* __restrict__ lse,
       bf16* __restrict__ dq, bf16* __restrict__ dk, bf16* __restrict__ dv,
       int H, int S, int R, float dq_scale, float dk_scale) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  if (blockIdx.z == 0)
    bwd_dq<D, F>(smem, &mq, &mk, &mv, &mdo, &mo, lse, dq, H, S, R, dq_scale);
  else
    bwd_dkv<D, F>(smem, &mq, &mk, &mv, &mdo, &mo, lse, dk, dv, H, S, R,
                  dk_scale);
}

// ---------------------------------------------------------------------------
// launches: one instance per variant the Python side names
// ---------------------------------------------------------------------------

template <int D, int F>
int launch_bwd(const void* q, const void* k, const void* v, const void* dout,
               const void* o, const void* lse, void* dq, void* dk, void* dv,
               int B, int H, int S, int nsplit, float dq_scale,
               float dk_scale, cudaStream_t s) {
  constexpr size_t smem = bwd_smem<D>();
  static const int attr = prepare(fv_bwd<D, F>, smem);
  if (attr) return attr;
  CUtensorMap mq, mk, mv, mdo, mo;
  int err = head_tile_map(&mq, q, B, S, H, D);
  if (!err) err = head_tile_map(&mk, k, B, S, H, D);
  if (!err) err = head_tile_map(&mv, v, B, S, H, D);
  if (!err) err = head_tile_map(&mdo, dout, B, S, H, D);
  if (!err) err = head_tile_map(&mo, o, B, S, H, D);
  if (err) return err;
  const dim3 grid(S / TILE, B * H, 2);
  fv_bwd<D, F><<<grid, THREADS, smem, s>>>(
      mq, mk, mv, mdo, mo, static_cast<const float*>(lse),
      static_cast<bf16*>(dq), static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      H, S, S / nsplit, dq_scale, dk_scale);
  return static_cast<int>(cudaGetLastError());
}

// the instances: run_bwd (causal x exp_bf16), the six backward ablations
#define BWD_INSTANCES(X)                                                   \
  X(0) X(CAUSAL) X(EXP_BF16) X(CAUSAL | EXP_BF16) X(DIAG | CAUSAL)         \
  X(DIAG | DROP_MASK) X(DIAG | CAUSAL | DROP_EXP)                          \
  X(DIAG | CAUSAL | DROP_DELTA) X(DIAG | CAUSAL | DROP_DS)                 \
  X(DIAG | DROP_MASK | DROP_EXP | DROP_DELTA | DROP_DS)

template <int D>
int bwd(int flags, const void* q, const void* k, const void* v,
        const void* dout, const void* o, const void* lse, void* dq, void* dk,
        void* dv, int B, int H, int S, int nsplit, float dq_scale,
        float dk_scale, cudaStream_t s) {
  switch (flags) {
#define CASE(F)                                                          \
  case (F):                                                              \
    return launch_bwd<D, (F)>(q, k, v, dout, o, lse, dq, dk, dv, B, H, S, \
                              nsplit, dq_scale, dk_scale, s);
    BWD_INSTANCES(CASE)
#undef CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Device pointers, contiguous, 16-byte aligned: q, k, v, dout, o, dq, dk,
// dv bf16 [B, S, H, D]; lse fp32 [B, H, S] (base 2). D is 64 or 128, S a
// multiple of 64 and of nsplit; flags one of the instances above. Returns
// the cudaError_t of the launch (0 = success), or cudaErrorInvalidValue
// for a shape or variant it does not take.
extern "C" int flash_variants_bwd(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* o, const void* lse, void* dq,
                                  void* dk, void* dv, int B, int H, int S,
                                  int D, int flags, int nsplit,
                                  float dq_scale, float dk_scale,
                                  void* stream) {
  if (bad_shape(B, H, S, D, nsplit))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D == 64 ? bwd<64>(flags, q, k, v, dout, o, lse, dq, dk, dv, B, H, S,
                           nsplit, dq_scale, dk_scale, s)
                 : bwd<128>(flags, q, k, v, dout, o, lse, dq, dk, dv, B, H,
                            S, nsplit, dq_scale, dk_scale, s);
}

// The dynamic shared memory one block of the D-wide kernel asks for.
extern "C" int flash_variants_bwd_smem(int D) {
  return D == 64 ? (int)bwd_smem<64>() : (int)bwd_smem<128>();
}
