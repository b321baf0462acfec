// Flash attention for training: the forward with its logsumexp, and the
// backward as a dq kernel and a dk/dv kernel.
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas/flash_attention.py:
// - flash_fwd (this file) serves _pallas_flash_attention /
//   _pallas_flash_fwd_lse (blocked, S > 512) and _pallas_flash_fwd_packed
//   (two 64-wide heads per 128-lane cell, S <= 512);
// - flash_bwd_dq and flash_bwd_dkv serve _pallas_flash_bwd (its dq and
//   dk/dv pallas_calls) and _pallas_flash_bwd_packed (fused dq, dk, dv).
// The TPU's packed layout exists to fill a 128-lane tile without a
// transpose; here every kernel reads the model's [B, S, H, D] rows through
// their stride (H * D elements), so one kernel serves both regimes.
//
// Conventions, as the TPU kernels and the plain versions in
// ops/kernels/flash_attention.py: bf16 q, k, v, do; scores, the running
// max and sum, the accumulators and lse are fp32; probabilities p and
// ds = p * (dp - delta) are rounded to bf16 before their products, which
// accumulate in fp32; outputs are rounded to bf16 once. Scores are
// computed unscaled and scaled in fp32 (scale * log2(e), so the softmax
// runs on exp2f): dq and dk each take the factor `scale` at the end, dv
// none. lse is natural-log [B, H, Sq] fp32; delta = rowsum(do * o) [B, H,
// Sq] fp32 comes from the caller. Causal masking follows the TPU's
// tril(k = Sk - Sq): query row i sees keys j <= i + Sk - Sq (Sq <= Sk).
//
// What bounds them on the H100: at the training shape (S 512, D 64) the
// products, 4 * D flops per visible (query, key) pair in the forward and
// 10 * D in the backward against 2 * D bytes of q, k, v per row, are far
// above the card's ~295 flops/byte ridge, so the tensor cores bound them.
// The design:
// - a block of 4 warps per (b * h, tile of 64 rows); each warp owns 16
//   rows of the block's output, so softmax, rescaling and the products of
//   a tile need only warp-level synchronisation; the block synchronises
//   only around the shared 64-row tiles it loads (16-byte loads, rows past
//   S read as zeros);
// - every product runs on the tensor cores as nvcuda::wmma bf16 16x16x16
//   fragments with fp32 accumulators; the score tile goes through shared
//   memory (fp32), where a lane pair applies the mask and the softmax to
//   one row and writes bf16 probabilities back as the next product's A
//   operand. The forward keeps its output accumulator in shared memory
//   (fp32) so a row can be rescaled by its running max; the backward's
//   accumulators never need rescaling and stay in registers;
// - causal blocks stop at the diagonal: the forward and dq kernels walk
//   key tiles 0 .. (off + q0 + 63) / 64, the dk/dv kernel query tiles
//   from (k0 - off) / 64 on (the TPU's bounds, :163-167 and :399-401 of
//   the Pallas file); edges that 64 does not divide are masked.
// wgmma, TMA and register-resident (mma.sync) softmax are left for later
// work; so is the fused one-kernel backward, which here would need
// atomics for dq.

#include <math.h>

#include "flash_tiles.cuh"

namespace {

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// ---------------------------------------------------------------------------
// forward: out and lse
// ---------------------------------------------------------------------------

template <int D>
constexpr size_t fwd_smem() {
  return (size_t)3 * TILE * Ld<D>::B * 2 + (size_t)TILE * LDS * 4 +
         (size_t)TILE * LDP * 2 + (size_t)TILE * Ld<D>::O * 4;
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd(const bf16* __restrict__ q, const bf16* __restrict__ k,
          const bf16* __restrict__ v, bf16* __restrict__ out,
          float* __restrict__ lse, int H, int Sq, int Sk, int causal,
          float scale_log2) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int LB = Ld<D>::B, LO = Ld<D>::O;
  bf16* Qs = reinterpret_cast<bf16*>(smem);  // [TILE][LB]
  bf16* Ks = Qs + TILE * LB;
  bf16* Vs = Ks + TILE * LB;
  float* Ss = reinterpret_cast<float*>(Vs + TILE * LB);  // [TILE][LDS]
  bf16* Ps = reinterpret_cast<bf16*>(Ss + TILE * LDS);   // [TILE][LDP]
  float* Os = reinterpret_cast<float*>(Ps + TILE * LDP); // [TILE][LO]

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * TILE;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t stride = (size_t)H * D;
  const bf16* qb = q + ((size_t)b * Sq * H + h) * D;
  const bf16* kb = k + ((size_t)b * Sk * H + h) * D;
  const bf16* vb = v + ((size_t)b * Sk * H + h) * D;
  const int off = Sk - Sq;

  load_tile<D>(Qs, qb, q0, Sq, stride);
  for (int e = threadIdx.x; e < TILE * LO; e += THREADS) Os[e] = 0.f;

  // the lane pair (2r, 2r + 1) owns tile row `row`; lane `half` takes the
  // columns half, half + 2, ...
  const int r = lane >> 1, half = lane & 1;
  const int row = warp * 16 + r;
  const int qpos = off + q0 + row;
  float m = -INFINITY, l = 0.f;

  int n_tiles = (Sk + TILE - 1) / TILE;
  if (causal) n_tiles = min(n_tiles, (off + q0 + TILE - 1) / TILE + 1);
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * TILE;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<D>(Ks, kb, k0, Sk, stride);
    load_tile<D>(Vs, vb, k0, Sk, stride);
    __syncthreads();
    abt<D>(Ss + warp * 16 * LDS, Qs + warp * 16 * LB, Ks);
    __syncwarp();

    // online softmax of the row over this tile. Tile 0 holds key 0, which
    // every row sees, so m is finite from the first tile on; a key the row
    // does not see scores -inf and weighs exp2(-inf) = 0.
    const float* srow = Ss + row * LDS;
    float sv[TILE / 2];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < TILE / 2; ++j) {
      const int kp = k0 + half + 2 * j;
      const bool vis = kp < Sk && (!causal || kp <= qpos);
      sv[j] = vis ? srow[half + 2 * j] * scale_log2 : -INFINITY;
      mx = fmaxf(mx, sv[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);
    const float alpha = exp2f(m - m_new);  // first tile: exp2(-inf) = 0
    float sum = 0.f;
    bf16* prow = Ps + row * LDP;
#pragma unroll
    for (int j = 0; j < TILE / 2; ++j) {
      const float p = exp2f(sv[j] - m_new);
      prow[half + 2 * j] = __float2bfloat16_rn(p);
      sum += p;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l = l * alpha + sum;
    m = m_new;
    float* orow = Os + row * LO;
    for (int c = half; c < D; c += 2) orow[c] *= alpha;
    __syncwarp();

    // O[16, D] += P[16, TILE] @ V[TILE, D], accumulated through shared
    // memory because the rows were rescaled there
    float* Ow = Os + warp * 16 * LO;
    FragC acc[D / 16];
#pragma unroll
    for (int n = 0; n < D / 16; ++n)
      wmma::load_matrix_sync(acc[n], Ow + n * 16, LO, wmma::mem_row_major);
    ab_acc<D>(acc, Ps + warp * 16 * LDP, Vs);
#pragma unroll
    for (int n = 0; n < D / 16; ++n)
      wmma::store_matrix_sync(Ow + n * 16, acc[n], LO, wmma::mem_row_major);
    __syncwarp();
  }

  const int qr = q0 + row;
  if (qr < Sq) {
    bf16* og = out + ((size_t)(b * Sq + qr) * H + h) * D;
    const float* orow = Os + row * LO;
    for (int c = 2 * half; c < D; c += 4)
      *reinterpret_cast<__nv_bfloat162*>(og + c) =
          __floats2bfloat162_rn(orow[c] / l, orow[c + 1] / l);
    if (half == 0) lse[(size_t)bh * Sq + qr] = (m + log2f(l)) * LN2;
  }
}

// ---------------------------------------------------------------------------
// backward, dq: a block per (b * h, query tile), key tiles up to the
// diagonal
// ---------------------------------------------------------------------------

template <int D>
constexpr size_t dq_smem() {
  return (size_t)4 * TILE * Ld<D>::B * 2 + (size_t)2 * TILE * LDS * 4 +
         (size_t)TILE * LDP * 2;
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, const bf16* __restrict__ dout,
             const float* __restrict__ lse, const float* __restrict__ delta,
             bf16* __restrict__ dq, int H, int Sq, int Sk, int causal,
             float scale, float scale_log2) {
  extern __shared__ __align__(128) unsigned char smem[];
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
  const size_t qoff = ((size_t)b * Sq * H + h) * D;
  const bf16* kb = k + ((size_t)b * Sk * H + h) * D;
  const bf16* vb = v + ((size_t)b * Sk * H + h) * D;
  const int off = Sk - Sq;

  load_tile<D>(Qs, q + qoff, q0, Sq, stride);
  load_tile<D>(dOs, dout + qoff, q0, Sq, stride);
  const int r = lane >> 1, half = lane & 1;
  const int row = warp * 16 + r;
  const int qr = q0 + row;
  const int qpos = off + qr;
  const bool live = qr < Sq;
  const float lse2 = live ? lse[(size_t)bh * Sq + qr] * LOG2E : 0.f;
  const float dl = live ? delta[(size_t)bh * Sq + qr] : 0.f;

  FragC acc[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) wmma::fill_fragment(acc[n], 0.f);

  int n_tiles = (Sk + TILE - 1) / TILE;
  if (causal) n_tiles = min(n_tiles, (off + q0 + TILE - 1) / TILE + 1);
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * TILE;
    __syncthreads();
    load_tile<D>(Ks, kb, k0, Sk, stride);
    load_tile<D>(Vs, vb, k0, Sk, stride);
    __syncthreads();
    abt<D>(Ss + warp * 16 * LDS, Qs + warp * 16 * LB, Ks);   // q k^T
    abt<D>(dPs + warp * 16 * LDS, dOs + warp * 16 * LB, Vs); // do v^T
    __syncwarp();
    const float* srow = Ss + row * LDS;
    const float* dprow = dPs + row * LDS;
    bf16* dsrow = dSs + row * LDP;
#pragma unroll
    for (int j = 0; j < TILE / 2; ++j) {
      const int c = half + 2 * j, kp = k0 + c;
      const bool vis = live && kp < Sk && (!causal || kp <= qpos);
      const float p = vis ? exp2f(srow[c] * scale_log2 - lse2) : 0.f;
      dsrow[c] = __float2bfloat16_rn(p * (dprow[c] - dl));
    }
    __syncwarp();
    ab_acc<D>(acc, dSs + warp * 16 * LDP, Ks);  // dq += ds k
    __syncwarp();
  }
  __syncthreads();  // the staging below spans other warps' score rows
  store_rows<D>(acc, Ss + warp * 16 * Ld<D>::O, dq + qoff, q0 + warp * 16,
                Sq, stride, scale);
}

// ---------------------------------------------------------------------------
// backward, dk and dv: a block per (b * h, key tile), query tiles from the
// diagonal on; the transposed products (k q^T, v do^T) put this block's
// keys on the rows, so a warp owns 16 rows of dk and dv
// ---------------------------------------------------------------------------

template <int D>
constexpr size_t dkv_smem() {
  return (size_t)4 * TILE * Ld<D>::B * 2 + (size_t)2 * TILE * LDS * 4 +
         (size_t)2 * TILE * LDP * 2 + (size_t)2 * TILE * 4;
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const bf16* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int Sq,
              int Sk, int causal, float scale, float scale_log2) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int LB = Ld<D>::B;
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + TILE * LB;
  bf16* Qs = Vs + TILE * LB;
  bf16* dOs = Qs + TILE * LB;
  float* STs = reinterpret_cast<float*>(dOs + TILE * LB);  // [keys][queries]
  float* dPTs = STs + TILE * LDS;
  bf16* PTs = reinterpret_cast<bf16*>(dPTs + TILE * LDS);  // [keys][LDP]
  bf16* dSTs = PTs + TILE * LDP;
  float* lse2_s = reinterpret_cast<float*>(dSTs + TILE * LDP);  // [TILE]
  float* dl_s = lse2_s + TILE;

  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * TILE;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const size_t stride = (size_t)H * D;
  const size_t koff = ((size_t)b * Sk * H + h) * D;
  const size_t qoff = ((size_t)b * Sq * H + h) * D;
  const int off = Sk - Sq;

  load_tile<D>(Ks, k + koff, k0, Sk, stride);
  load_tile<D>(Vs, v + koff, k0, Sk, stride);
  const int r = lane >> 1, half = lane & 1;
  const int row = warp * 16 + r;
  const int kp = k0 + row;

  FragC dka[D / 16], dva[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    wmma::fill_fragment(dka[n], 0.f);
    wmma::fill_fragment(dva[n], 0.f);
  }

  const int n_q = (Sq + TILE - 1) / TILE;
  // query tiles wholly before this key tile's diagonal see none of it
  const int first = causal && k0 > off ? (k0 - off) / TILE : 0;
  for (int t = first; t < n_q; ++t) {
    const int q0 = t * TILE;
    __syncthreads();
    load_tile<D>(Qs, q + qoff, q0, Sq, stride);
    load_tile<D>(dOs, dout + qoff, q0, Sq, stride);
    for (int i = threadIdx.x; i < TILE; i += THREADS) {
      const bool live = q0 + i < Sq;
      lse2_s[i] = live ? lse[(size_t)bh * Sq + q0 + i] * LOG2E : 0.f;
      dl_s[i] = live ? delta[(size_t)bh * Sq + q0 + i] : 0.f;
    }
    __syncthreads();
    abt<D>(STs + warp * 16 * LDS, Ks + warp * 16 * LB, Qs);    // k q^T
    abt<D>(dPTs + warp * 16 * LDS, Vs + warp * 16 * LB, dOs);  // v do^T
    __syncwarp();
    const float* srow = STs + row * LDS;
    const float* dprow = dPTs + row * LDS;
    bf16* prow = PTs + row * LDP;
    bf16* dsrow = dSTs + row * LDP;
#pragma unroll
    for (int j = 0; j < TILE / 2; ++j) {
      const int c = half + 2 * j, qr = q0 + c;
      const bool vis = qr < Sq && kp < Sk && (!causal || kp <= off + qr);
      const float p = vis ? exp2f(srow[c] * scale_log2 - lse2_s[c]) : 0.f;
      prow[c] = __float2bfloat16_rn(p);
      dsrow[c] = __float2bfloat16_rn(p * (dprow[c] - dl_s[c]));
    }
    __syncwarp();
    ab_acc<D>(dva, PTs + warp * 16 * LDP, dOs);  // dv += p^T do
    ab_acc<D>(dka, dSTs + warp * 16 * LDP, Qs);  // dk += ds^T q
    __syncwarp();
  }
  __syncthreads();  // the staging below spans other warps' score rows
  float* stage = STs + warp * 16 * Ld<D>::O;
  store_rows<D>(dka, stage, dk + koff, k0 + warp * 16, Sk, stride, scale);
  store_rows<D>(dva, stage, dv + koff, k0 + warp * 16, Sk, stride, 1.f);
}

bool bad_shape(int B, int H, int Sq, int Sk, int D, int causal) {
  return B < 1 || H < 1 || (long long)B * H > 65535 || Sq < 1 || Sk < 1 ||
         (causal && Sq > Sk) || (D != 64 && D != 128);
}

template <int D>
int fwd(const void* q, const void* k, const void* v, void* out, void* lse,
        int B, int H, int Sq, int Sk, int causal, float scale,
        cudaStream_t s) {
  const size_t smem = fwd_smem<D>();
  static const int attr = prepare(flash_fwd<D>, smem);
  if (attr) return attr;
  const dim3 grid((Sq + TILE - 1) / TILE, B * H);
  flash_fwd<D><<<grid, THREADS, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out),
      static_cast<float*>(lse), H, Sq, Sk, causal, scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int bwd_dq(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dq, int B, int H,
           int Sq, int Sk, int causal, float scale, cudaStream_t s) {
  const size_t smem = dq_smem<D>();
  static const int attr = prepare(flash_bwd_dq<D>, smem);
  if (attr) return attr;
  const dim3 grid((Sq + TILE - 1) / TILE, B * H);
  flash_bwd_dq<D><<<grid, THREADS, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), H, Sq, Sk, causal, scale, scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
            const void* lse, const void* delta, void* dk, void* dv, int B,
            int H, int Sq, int Sk, int causal, float scale, cudaStream_t s) {
  const size_t smem = dkv_smem<D>();
  static const int attr = prepare(flash_bwd_dkv<D>, smem);
  if (attr) return attr;
  const dim3 grid((Sk + TILE - 1) / TILE, B * H);
  flash_bwd_dkv<D><<<grid, THREADS, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, Sq, Sk, causal,
      scale, scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Device pointers, contiguous, 16-byte aligned, all bf16 but lse and delta
// (fp32 [B, H, Sq]): q, out, dout, dq [B, Sq, H, D]; k, v, dk, dv
// [B, Sk, H, D]. D is 64 or 128; causal (0 or 1) needs Sq <= Sk. Each
// returns the cudaError_t of its launch (0 = success),
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

extern "C" int flash_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* delta,
                                      void* dq, int B, int H, int Sq, int Sk,
                                      int D, int causal, float scale,
                                      void* stream) {
  if (bad_shape(B, H, Sq, Sk, D, causal))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D == 64 ? bwd_dq<64>(q, k, v, dout, lse, delta, dq, B, H, Sq, Sk,
                              causal, scale, s)
                 : bwd_dq<128>(q, k, v, dout, lse, delta, dq, B, H, Sq, Sk,
                               causal, scale, s);
}

extern "C" int flash_attention_bwd_dkv(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       void* dk, void* dv, int B, int H,
                                       int Sq, int Sk, int D, int causal,
                                       float scale, void* stream) {
  if (bad_shape(B, H, Sq, Sk, D, causal))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D == 64 ? bwd_dkv<64>(q, k, v, dout, lse, delta, dk, dv, B, H, Sq,
                               Sk, causal, scale, s)
                 : bwd_dkv<128>(q, k, v, dout, lse, delta, dk, dv, B, H, Sq,
                                Sk, causal, scale, s);
}
