// The flash-variant forward kernel, fv_fwd: out and lse of run_fwd,
// run_fwd2 and the forward ablations. The design, the variant bits and
// what bounds it are in flash_variants.cuh; the Hopper building blocks in
// sm90_tiles.cuh.

#include "flash_variants.cuh"

namespace {

constexpr int THREADS = WG_THREADS + 32;  // consumers and a producer warp

// shared memory: the q tile, then the ring's stages (k and v tiles), then
// the barriers (q, full[STAGES], empty[STAGES])
template <int D>
struct FwdSmem {
  static constexpr int TB = D / 64 * BOX_BYTES;  // bytes of one tile
  static constexpr int RING = TB;
  static constexpr int STAGE = 2 * TB;
  static constexpr int BARS = RING + STAGES * STAGE;
  static constexpr size_t BYTES = 1024 + BARS + 8 * (1 + 2 * STAGES);
};

// the thread's two rows: their query index, extent and max
struct Rows {
  int i0, i1, cols0, cols1;
  float m0, m1;
};

// the masked score: -inf, or 0.0 where the ablation drops exp
template <int F>
__device__ __forceinline__ float fill() {
  return (F & DROP_EXP) ? 0.f : -INFINITY;
}

// the row max over one tile's scores (CHECK: per-element extent and mask)
template <int F, bool CHECK>
__device__ __forceinline__ void tile_max(const float (&sc)[32], int k0,
                                         const Rows& rw, float& m0,
                                         float& m1) {
  constexpr bool MASK = (F & CAUSAL) != 0;
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const int kp = k0 + frag_col(e);
    const bool hi = frag_hi(e);
    const int i = hi ? rw.i1 : rw.i0;
    float& m = hi ? m1 : m0;
    if (!CHECK)
      m = fmaxf(m, sc[e]);
    else if (kp < (hi ? rw.cols1 : rw.cols0))
      m = fmaxf(m, MASK && kp > i ? fill<F>() : sc[e]);
  }
}

// p of one score (0 past the row's extent), rounded to bf16; l sums p (or
// bf16 p)
template <int F, bool CHECK>
__device__ __forceinline__ bf16 fwd_p(float s, int kp, int i, int cols,
                                      float m, float& l) {
  constexpr bool MASK = (F & CAUSAL) != 0;
  if (CHECK && kp >= cols) return __float2bfloat16_rn(0.f);
  const float sv = CHECK && MASK && kp > i ? fill<F>() : s;
  const float a = (F & DROP_MAX) ? sv : sv - m;
  const float p = (F & DROP_EXP) ? a : vexp2<F>(a);
  const bf16 pb = __float2bfloat16_rn(p);
  l += (F & P_BF16) ? __bfloat162float(pb) : p;
  return pb;
}

// p of one tile, packed as the bf16 A operand of P V
template <int F, bool CHECK>
__device__ __forceinline__ void tile_p(const float (&sc)[32],
                                       uint32_t (&pa)[16], int k0,
                                       const Rows& rw, float& l0, float& l1) {
#pragma unroll
  for (int e = 0; e < 32; e += 2) {
    const int kp = k0 + frag_col(e);
    bf16 lo, hi;
    if (frag_hi(e)) {
      lo = fwd_p<F, CHECK>(sc[e], kp, rw.i1, rw.cols1, rw.m1, l1);
      hi = fwd_p<F, CHECK>(sc[e + 1], kp + 1, rw.i1, rw.cols1, rw.m1, l1);
    } else {
      lo = fwd_p<F, CHECK>(sc[e], kp, rw.i0, rw.cols0, rw.m0, l0);
      hi = fwd_p<F, CHECK>(sc[e + 1], kp + 1, rw.i0, rw.cols0, rw.m0, l0);
    }
    pa[e / 2] = pack_bf16(lo, hi);
  }
}

template <int D, int F>
__global__ void __launch_bounds__(THREADS, D == 64 ? 3 : 2)
fv_fwd(const __grid_constant__ CUtensorMap mq,
       const __grid_constant__ CUtensorMap mk,
       const __grid_constant__ CUtensorMap mv, bf16* __restrict__ out,
       float* __restrict__ lse, int H, int S, int R, float cst) {
  using L = FwdSmem<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  unsigned char* Qs = smem;
  uint64_t* qbar = reinterpret_cast<uint64_t*>(smem + L::BARS);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + STAGES;

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * TILE;
  const int n_tiles = (min(S, extent(q0 + TILE - 1, R)) + TILE - 1) / TILE;
  // the ring's sequence: pass 1 (k tiles, for the max) unless dropped,
  // then pass 2 (k and v tiles)
  const int first2 = (F & DROP_MAX) ? 0 : n_tiles;
  const int n_steps = first2 + n_tiles;

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], WG_THREADS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= WG_THREADS) {  // the producer warp
    if (threadIdx.x == WG_THREADS) {
      mbar_expect(qbar, L::TB);
      tma_tile<D>(Qs, &mq, qbar, h, q0, b);
      for (int it = 0; it < n_steps; ++it) {
        const int s = it % STAGES;
        const bool pass2 = it >= first2;
        const int k0 = (pass2 ? it - first2 : it) * TILE;
        unsigned char* st = smem + L::RING + s * L::STAGE;
        mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
        mbar_expect(&full[s], pass2 ? 2 * L::TB : L::TB);
        tma_tile<D>(st, &mk, &full[s], h, k0, b);
        if (pass2) tma_tile<D>(st + L::TB, &mv, &full[s], h, k0, b);
      }
    }
    return;
  }

  // the consumer warpgroup: this thread's rows r0 and r0 + 8 of the tile
  constexpr bool MASK = (F & CAUSAL) != 0;
  const int tid = threadIdx.x;
  const int r0 = (tid >> 5) * 16 + ((tid & 31) >> 2);
  Rows rw;
  rw.i0 = q0 + r0;
  rw.i1 = rw.i0 + 8;
  rw.cols0 = min(S, extent(rw.i0, R));
  rw.cols1 = min(S, extent(rw.i1, R));

  mbar_wait(qbar, 0);
  if (F & SCALE_IN) {  // bf16(q * cst) in place, then visible to wgmma
    uint4* qv = reinterpret_cast<uint4*>(Qs);
    for (int e = tid; e < L::TB / 16; e += WG_THREADS) {
      uint4 u = qv[e];
      bf16* x = reinterpret_cast<bf16*>(&u);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        x[j] = __float2bfloat16_rn(__bfloat162float(x[j]) * cst);
      qv[e] = u;
    }
    fence_async_smem();
    wg_sync();
  }

  // pass 1: the exact row max over the row's extent (a tile wholly past
  // the diagonal adds its -inf fill: nothing)
  float m0 = 0.f, m1 = 0.f;
  int it = 0;
  if (!(F & DROP_MAX)) {
    m0 = m1 = -INFINITY;
    for (int t = 0; t < n_tiles; ++t, ++it) {
      const int s = it % STAGES;
      const unsigned char* st = smem + L::RING + s * L::STAGE;
      mbar_wait(&full[s], (it / STAGES) & 1);
      float sc[32];
      tile_abt<D, 64>(sc, Qs, st);
      mbar_arrive(&empty[s]);
      const int k0 = t * TILE, kind = tile_kind(q0, k0, S, R, MASK);
      if (kind == TILE_VISIBLE)
        tile_max<F, false>(sc, k0, rw, m0, m1);
      else if (kind == TILE_MIXED || (F & DROP_EXP))
        tile_max<F, true>(sc, k0, rw, m0, m1);
    }
    m0 = quad_max(m0);
    m1 = quad_max(m1);
  }
  rw.m0 = m0;
  rw.m1 = m1;

  // pass 2: p in registers, l, and o += bf16(p) @ v (nothing to rescale);
  // a tile wholly past the diagonal has p = exp2(-inf) = 0
  float o[D / 64][32];
#pragma unroll
  for (int n = 0; n < D / 64; ++n)
#pragma unroll
    for (int e = 0; e < 32; ++e) o[n][e] = 0.f;
  float l0 = 0.f, l1 = 0.f;
  for (int t = 0; t < n_tiles; ++t, ++it) {
    const int s = it % STAGES;
    const unsigned char* st = smem + L::RING + s * L::STAGE;
    mbar_wait(&full[s], (it / STAGES) & 1);
    float sc[32];
    tile_abt<D, 64>(sc, Qs, st);
    const int k0 = t * TILE, kind = tile_kind(q0, k0, S, R, MASK);
    uint32_t pa[16];
    if (kind == TILE_VISIBLE) {
      tile_p<F, false>(sc, pa, k0, rw, l0, l1);
    } else if (kind == TILE_MASKED && !(F & DROP_EXP)) {
#pragma unroll
      for (int j = 0; j < 16; ++j) pa[j] = 0u;
    } else {
      tile_p<F, true>(sc, pa, k0, rw, l0, l1);
    }
    wg_fence();
    fence_regs(pa);
    tile_pv_issue<D, 64>(o, pa, st + L::TB);
    wg_commit();
    wg_wait<0>();
#pragma unroll
    for (int n = 0; n < D / 64; ++n) fence_regs(o[n]);
    mbar_arrive(&empty[s]);
  }
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  if (F & DROP_SUM) l0 = l1 = 1.f;

  // out = o / l straight from the registers; lse from a lane of each quad
  const size_t row = (size_t)H * D;
  bf16* base = out + ((size_t)b * S * H + h) * D;
  store_acc<D, true>(o, base + (size_t)rw.i0 * row,
                     base + (size_t)rw.i1 * row, l0, l1);
  if ((tid & 3) == 0) {
    float* lrow = lse + (size_t)bh * S;
    lrow[rw.i0] = (F & DIAG) ? m0 + l0 : m0 + log2f(l0);
    lrow[rw.i1] = (F & DIAG) ? m1 + l1 : m1 + log2f(l1);
  }
}

// ---------------------------------------------------------------------------
// launches: one instance per variant the Python side names
// ---------------------------------------------------------------------------

template <int D, int F>
int launch_fwd(const void* q, const void* k, const void* v, void* out,
               void* lse, int B, int H, int S, int nsplit, float cst,
               cudaStream_t s) {
  constexpr size_t smem = FwdSmem<D>::BYTES;
  static const int attr = prepare(fv_fwd<D, F>, smem);
  if (attr) return attr;
  CUtensorMap mq, mk, mv;
  int err = head_tile_map(&mq, q, B, S, H, D);
  if (!err) err = head_tile_map(&mk, k, B, S, H, D);
  if (!err) err = head_tile_map(&mv, v, B, S, H, D);
  if (err) return err;
  const dim3 grid(S / TILE, B * H);
  fv_fwd<D, F><<<grid, THREADS, smem, s>>>(
      mq, mk, mv, static_cast<bf16*>(out), static_cast<float*>(lse), H, S,
      S / nsplit, cst);
  return static_cast<int>(cudaGetLastError());
}

// the instances: run_fwd (causal x exp_bf16), run_fwd2 (causal x p_bf16 x
// in-kernel scale), the six forward ablations
#define FWD_INSTANCES(X)                                                   \
  X(0) X(CAUSAL) X(EXP_BF16) X(CAUSAL | EXP_BF16) X(P_BF16)                \
  X(CAUSAL | P_BF16) X(SCALE_IN) X(CAUSAL | SCALE_IN) X(P_BF16 | SCALE_IN) \
  X(CAUSAL | P_BF16 | SCALE_IN) X(DIAG | CAUSAL) X(DIAG | DROP_MASK)       \
  X(DIAG | CAUSAL | DROP_MAX) X(DIAG | CAUSAL | DROP_SUM)                  \
  X(DIAG | CAUSAL | DROP_EXP)                                              \
  X(DIAG | DROP_MASK | DROP_MAX | DROP_SUM | DROP_EXP)

template <int D>
int fwd(int flags, const void* q, const void* k, const void* v, void* out,
        void* lse, int B, int H, int S, int nsplit, float cst,
        cudaStream_t s) {
  switch (flags) {
#define CASE(F) \
  case (F):     \
    return launch_fwd<D, (F)>(q, k, v, out, lse, B, H, S, nsplit, cst, s);
    FWD_INSTANCES(CASE)
#undef CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Device pointers, contiguous, 16-byte aligned: q, k, v, out bf16 [B, S,
// H, D]; lse fp32 [B, H, S] (base 2). D is 64 or 128, S a multiple of 64
// and of nsplit; flags one of the instances above. Returns the cudaError_t
// of the launch (0 = success), or cudaErrorInvalidValue for a shape or
// variant it does not take.
extern "C" int flash_variants_fwd(const void* q, const void* k,
                                  const void* v, void* out, void* lse, int B,
                                  int H, int S, int D, int flags, int nsplit,
                                  float cst, void* stream) {
  if (bad_shape(B, H, S, D, nsplit))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D == 64 ? fwd<64>(flags, q, k, v, out, lse, B, H, S, nsplit, cst, s)
                 : fwd<128>(flags, q, k, v, out, lse, B, H, S, nsplit, cst,
                            s);
}

// The dynamic shared memory one block of the D-wide kernel asks for.
extern "C" int flash_variants_fwd_smem(int D) {
  return D == 64 ? (int)FwdSmem<64>::BYTES : (int)FwdSmem<128>::BYTES;
}
