// The flash-variant backward kernel, fv_bwd: dq, dk and dv of run_bwd and
// the backward ablations in one launch. The design, the variant bits and
// what bounds it are in flash_variants.cuh.

#include "flash_variants.cuh"

namespace {

// ---------------------------------------------------------------------------
// backward: one grid, blockIdx.z = 0 blocks write dq, = 1 blocks dk and dv
// ---------------------------------------------------------------------------

template <int D>
constexpr size_t dq_smem() {
  return (size_t)4 * TILE * Ld<D>::B * 2 + (size_t)2 * TILE * LDS * 4 +
         (size_t)TILE * LDP * 2;
}

template <int D>
constexpr size_t dkv_smem() {
  return (size_t)5 * TILE * Ld<D>::B * 2 + (size_t)2 * TILE * LDS * 4 +
         (size_t)2 * TILE * LDP * 2 + (size_t)2 * TILE * 4;
}

template <int D>
constexpr size_t bwd_smem() {
  return dq_smem<D>() > dkv_smem<D>() ? dq_smem<D>() : dkv_smem<D>();
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

// rowsum(do * o) of tile row `row` in fp32 by a lane pair (2r, 2r + 1)
template <int D, int F>
__device__ __forceinline__ float row_delta(const bf16* dOs, const bf16* Os,
                                           int row, int half) {
  float dl = 0.f;
  if (!(F & DROP_DELTA)) {
    const bf16* a = dOs + row * Ld<D>::B;
    const bf16* o = Os + row * Ld<D>::B;
    for (int c = half; c < D; c += 2)
      dl += __bfloat162float(a[c]) * __bfloat162float(o[c]);
    dl += __shfl_xor_sync(0xffffffffu, dl, 1);
  }
  return dl;
}

template <int D, int F>
__device__ __forceinline__ void bwd_dq(
    unsigned char* smem, const bf16* q, const bf16* k, const bf16* v,
    const bf16* dout, const bf16* o, const float* lse, bf16* dq, int H,
    int S, int R, float dq_scale) {
  constexpr int LB = Ld<D>::B;
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + TILE * LB;
  bf16* Ks = dOs + TILE * LB;
  bf16* Vs = Ks + TILE * LB;
  float* Ss = reinterpret_cast<float*>(Vs + TILE * LB);  // [TILE][LDS]
  float* dPs = Ss + TILE * LDS;                          // [TILE][LDS]
  bf16* dSs = reinterpret_cast<bf16*>(dPs + TILE * LDS); // [TILE][LDP]

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * TILE;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t stride = (size_t)H * D;
  const size_t base = ((size_t)b * S * H + h) * D;

  load_tile<D>(Qs, q + base, q0, S, stride);
  load_tile<D>(dOs, dout + base, q0, S, stride);
  load_tile<D>(Ks, o + base, q0, S, stride);  // o, for delta only
  __syncthreads();
  const int r = lane >> 1, half = lane & 1;
  const int row = warp * 16 + r, i = q0 + row;
  const int cols = min(S, extent(i, R));
  const int n_tiles = (min(S, extent(q0 + TILE - 1, R)) + TILE - 1) / TILE;
  const float lse2 = lse[(size_t)bh * S + i];
  const float dl = row_delta<D, F>(dOs, Ks, row, half);

  FragC acc[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) wmma::fill_fragment(acc[n], 0.f);
  const float* srow = Ss + row * LDS;
  const float* dprow = dPs + row * LDS;
  bf16* dsrow = dSs + row * LDP;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * TILE;
    __syncthreads();
    load_tile<D>(Ks, k + base, k0, S, stride);
    load_tile<D>(Vs, v + base, k0, S, stride);
    __syncthreads();
    abt<D>(Ss + warp * 16 * LDS, Qs + warp * 16 * LB, Ks);    // q k^T
    abt<D>(dPs + warp * 16 * LDS, dOs + warp * 16 * LB, Vs);  // do v^T
    __syncwarp();
#pragma unroll 8
    for (int j = 0; j < TILE / 2; ++j) {
      const int c = half + 2 * j, kp = k0 + c;
      float p = 0.f, ds = 0.f;
      if (kp < cols) p_ds<F>(srow[c], dprow[c], lse2, dl, kp > i, p, ds);
      dsrow[c] = __float2bfloat16_rn(ds);
    }
    __syncwarp();
    ab_acc<D>(acc, dSs + warp * 16 * LDP, Ks);  // dq += ds k
    __syncwarp();
  }
  __syncthreads();  // the staging below spans other warps' score rows
  store_rows<D>(acc, Ss + warp * 16 * Ld<D>::O, dq + base, q0 + warp * 16,
                S, stride, dq_scale);
}

// dk and dv of one key tile: the transposed products (k q^T, v do^T) put
// the keys on the rows, so a warp owns 16 rows of dk and dv
template <int D, int F>
__device__ __forceinline__ void bwd_dkv(
    unsigned char* smem, const bf16* q, const bf16* k, const bf16* v,
    const bf16* dout, const bf16* o, const float* lse, bf16* dk, bf16* dv,
    int H, int S, int R, float dk_scale) {
  constexpr int LB = Ld<D>::B;
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + TILE * LB;
  bf16* Qs = Vs + TILE * LB;
  bf16* dOs = Qs + TILE * LB;
  bf16* Os = dOs + TILE * LB;
  float* STs = reinterpret_cast<float*>(Os + TILE * LB);  // [keys][queries]
  float* dPTs = STs + TILE * LDS;
  bf16* PTs = reinterpret_cast<bf16*>(dPTs + TILE * LDS);  // [keys][LDP]
  bf16* dSTs = PTs + TILE * LDP;
  float* lse_s = reinterpret_cast<float*>(dSTs + TILE * LDP);  // [TILE]
  float* dl_s = lse_s + TILE;

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * TILE;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t stride = (size_t)H * D;
  const size_t base = ((size_t)b * S * H + h) * D;

  load_tile<D>(Ks, k + base, k0, S, stride);
  load_tile<D>(Vs, v + base, k0, S, stride);
  const int r = lane >> 1, half = lane & 1;
  const int row = warp * 16 + r, kp = k0 + row;

  FragC dka[D / 16], dva[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    wmma::fill_fragment(dka[n], 0.f);
    wmma::fill_fragment(dva[n], 0.f);
  }
  // query rows whose extent reaches this key tile: i >= R * (k0 / R)
  const int first = (R * (k0 / R)) / TILE;
  const float* srow = STs + row * LDS;
  const float* dprow = dPTs + row * LDS;
  bf16* prow = PTs + row * LDP;
  bf16* dsrow = dSTs + row * LDP;
  for (int t = first; t < S / TILE; ++t) {
    const int q0 = t * TILE;
    __syncthreads();
    load_tile<D>(Qs, q + base, q0, S, stride);
    load_tile<D>(dOs, dout + base, q0, S, stride);
    load_tile<D>(Os, o + base, q0, S, stride);
    __syncthreads();
    {  // this query tile's lse and delta: a thread pair per query row
      const int qr = threadIdx.x >> 1, hf = threadIdx.x & 1;
      const float dl = row_delta<D, F>(dOs, Os, qr, hf);
      if (hf == 0) {
        lse_s[qr] = lse[(size_t)bh * S + q0 + qr];
        dl_s[qr] = dl;
      }
    }
    __syncthreads();
    abt<D>(STs + warp * 16 * LDS, Ks + warp * 16 * LB, Qs);    // k q^T
    abt<D>(dPTs + warp * 16 * LDS, Vs + warp * 16 * LB, dOs);  // v do^T
    __syncwarp();
#pragma unroll 8
    for (int j = 0; j < TILE / 2; ++j) {
      const int c = half + 2 * j, qi = q0 + c;
      float p = 0.f, ds = 0.f;
      if (kp < min(S, extent(qi, R)))
        p_ds<F>(srow[c], dprow[c], lse_s[c], dl_s[c], kp > qi, p, ds);
      prow[c] = __float2bfloat16_rn(p);
      dsrow[c] = __float2bfloat16_rn(ds);
    }
    __syncwarp();
    ab_acc<D>(dva, PTs + warp * 16 * LDP, dOs);  // dv += p^T do
    ab_acc<D>(dka, dSTs + warp * 16 * LDP, Qs);  // dk += ds^T q
    __syncwarp();
  }
  __syncthreads();  // the staging below spans other warps' score rows
  float* stage = STs + warp * 16 * Ld<D>::O;
  store_rows<D>(dka, stage, dk + base, k0 + warp * 16, S, stride, dk_scale);
  store_rows<D>(dva, stage, dv + base, k0 + warp * 16, S, stride, 1.f);
}

template <int D, int F>
__global__ void __launch_bounds__(THREADS)
fv_bwd(const bf16* __restrict__ q, const bf16* __restrict__ k,
       const bf16* __restrict__ v, const bf16* __restrict__ dout,
       const bf16* __restrict__ o, const float* __restrict__ lse,
       bf16* __restrict__ dq, bf16* __restrict__ dk, bf16* __restrict__ dv,
       int H, int S, int R, float dq_scale, float dk_scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  if (blockIdx.z == 0)
    bwd_dq<D, F>(smem, q, k, v, dout, o, lse, dq, H, S, R, dq_scale);
  else
    bwd_dkv<D, F>(smem, q, k, v, dout, o, lse, dk, dv, H, S, R, dk_scale);
}

// ---------------------------------------------------------------------------
// launches: one instance per variant the Python side names
// ---------------------------------------------------------------------------

template <int D, int F>
int launch_bwd(const void* q, const void* k, const void* v, const void* dout,
               const void* o, const void* lse, void* dq, void* dk, void* dv,
               int B, int H, int S, int nsplit, float dq_scale,
               float dk_scale, cudaStream_t s) {
  const size_t smem = bwd_smem<D>();
  static const int attr = prepare(fv_bwd<D, F>, smem);
  if (attr) return attr;
  const dim3 grid(S / TILE, B * H, 2);
  fv_bwd<D, F><<<grid, THREADS, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const bf16*>(o), static_cast<const float*>(lse),
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

// Device pointers, contiguous, 16-byte aligned: q, k, v, out, dout, o, dq,
// dk, dv bf16 [B, S, H, D]; lse fp32 [B, H, S] (base 2). D is 64 or 128, S
// a multiple of 64 and of nsplit; flags one of the instances above. Each
// returns the cudaError_t of its launch (0 = success), or
// cudaErrorInvalidValue for a shape or variant it does not take.
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
