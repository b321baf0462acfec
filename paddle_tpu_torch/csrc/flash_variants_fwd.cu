// The flash-variant forward kernel, fv_fwd: out and lse of run_fwd,
// run_fwd2 and the forward ablations. The design, the variant bits and
// what bounds it are in flash_variants.cuh.

#include "flash_variants.cuh"

namespace {

// ---------------------------------------------------------------------------
// forward: out and lse
// ---------------------------------------------------------------------------

template <int D>
constexpr size_t fwd_smem() {
  return (size_t)3 * TILE * Ld<D>::B * 2 + (size_t)TILE * LDS * 4 +
         (size_t)TILE * LDP * 2;
}

template <int D, int F>
__global__ void __launch_bounds__(THREADS)
fv_fwd(const bf16* __restrict__ q, const bf16* __restrict__ k,
       const bf16* __restrict__ v, bf16* __restrict__ out,
       float* __restrict__ lse, int H, int S, int R, float cst) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int LB = Ld<D>::B;
  constexpr bool MASK = (F & CAUSAL) != 0;
  bf16* Qs = reinterpret_cast<bf16*>(smem);  // [TILE][LB]
  bf16* Ks = Qs + TILE * LB;
  bf16* Vs = Ks + TILE * LB;
  float* Ss = reinterpret_cast<float*>(Vs + TILE * LB);  // [TILE][LDS]
  bf16* Ps = reinterpret_cast<bf16*>(Ss + TILE * LDS);   // [TILE][LDP]

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * TILE;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t stride = (size_t)H * D;
  const size_t base = ((size_t)b * S * H + h) * D;
  load_tile<D, (F & SCALE_IN) != 0>(Qs, q + base, q0, S, stride, cst);

  // the lane pair (2r, 2r + 1) owns tile row `row`; lane `half` takes the
  // columns half, half + 2, ...
  const int r = lane >> 1, half = lane & 1;
  const int row = warp * 16 + r, i = q0 + row;
  const int cols = min(S, extent(i, R));
  const int n_tiles = (min(S, extent(q0 + TILE - 1, R)) + TILE - 1) / TILE;
  // a masked score: -inf, or 0.0 where the ablation drops exp
  const float fill = (F & DROP_EXP) ? 0.f : -INFINITY;
  const float* srow = Ss + row * LDS;

  // pass 1: the exact row max over the row's extent
  float m = 0.f;
  if (!(F & DROP_MAX)) {
    m = -INFINITY;
    for (int t = 0; t < n_tiles; ++t) {
      const int k0 = t * TILE;
      __syncthreads();  // every warp is done with the previous K tile
      load_tile<D>(Ks, k + base, k0, S, stride);
      __syncthreads();
      abt<D>(Ss + warp * 16 * LDS, Qs + warp * 16 * LB, Ks);
      __syncwarp();
#pragma unroll 8
      for (int j = 0; j < TILE / 2; ++j) {
        const int c = half + 2 * j, kp = k0 + c;
        if (kp < cols) m = fmaxf(m, MASK && kp > i ? fill : srow[c]);
      }
      __syncwarp();
    }
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
  }

  // pass 2: p, l and o = bf16(p) @ v in registers (nothing to rescale)
  FragC acc[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) wmma::fill_fragment(acc[n], 0.f);
  float l = 0.f;
  bf16* prow = Ps + row * LDP;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * TILE;
    __syncthreads();
    load_tile<D>(Ks, k + base, k0, S, stride);
    load_tile<D>(Vs, v + base, k0, S, stride);
    __syncthreads();
    abt<D>(Ss + warp * 16 * LDS, Qs + warp * 16 * LB, Ks);
    __syncwarp();
#pragma unroll 8
    for (int j = 0; j < TILE / 2; ++j) {
      const int c = half + 2 * j, kp = k0 + c;
      bf16 pb = __float2bfloat16_rn(0.f);
      if (kp < cols) {
        const float s = MASK && kp > i ? fill : srow[c];
        const float a = (F & DROP_MAX) ? s : s - m;
        const float p = (F & DROP_EXP) ? a : vexp2<F>(a);
        pb = __float2bfloat16_rn(p);
        l += (F & P_BF16) ? __bfloat162float(pb) : p;
      }
      prow[c] = pb;
    }
    __syncwarp();
    ab_acc<D>(acc, Ps + warp * 16 * LDP, Vs);
    __syncwarp();
  }
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  if (F & DROP_SUM) l = 1.f;

  // out = o / l through fp32 staging over the K and V tiles
  __syncthreads();
  float* stage = reinterpret_cast<float*>(Ks) + warp * 16 * Ld<D>::O;
#pragma unroll
  for (int n = 0; n < D / 16; ++n)
    wmma::store_matrix_sync(stage + n * 16, acc[n], Ld<D>::O,
                            wmma::mem_row_major);
  __syncwarp();
  bf16* og = out + base + (size_t)i * stride;
  const float* orow = stage + r * Ld<D>::O;
  for (int c = 2 * half; c < D; c += 4)
    *reinterpret_cast<__nv_bfloat162*>(og + c) =
        __floats2bfloat162_rn(orow[c] / l, orow[c + 1] / l);
  if (half == 0)
    lse[(size_t)bh * S + i] = (F & DIAG) ? m + l : m + log2f(l);
}

// ---------------------------------------------------------------------------
// launches: one instance per variant the Python side names
// ---------------------------------------------------------------------------

template <int D, int F>
int launch_fwd(const void* q, const void* k, const void* v, void* out,
               void* lse, int B, int H, int S, int nsplit, float cst,
               cudaStream_t s) {
  const size_t smem = fwd_smem<D>();
  static const int attr = prepare(fv_fwd<D, F>, smem);
  if (attr) return attr;
  const dim3 grid(S / TILE, B * H);
  fv_fwd<D, F><<<grid, THREADS, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out),
      static_cast<float*>(lse), H, S, S / nsplit, cst);
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

// Device pointers, contiguous, 16-byte aligned: q, k, v, out, dout, o, dq,
// dk, dv bf16 [B, S, H, D]; lse fp32 [B, H, S] (base 2). D is 64 or 128, S
// a multiple of 64 and of nsplit; flags one of the instances above. Each
// returns the cudaError_t of its launch (0 = success), or
// cudaErrorInvalidValue for a shape or variant it does not take.
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
