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
// log) and delta = rowsum(do * o) are fp32 [B, H, Sq]. Every product and
// sum is an fp32 FMA on the CUDA cores: no tensor core, so no TF32
// rounding anywhere; probabilities are never rounded. Scores are scaled by
// scale * log2(e) and the softmax runs on exp2f; dq and dk take the factor
// `scale` at the end, dv none. Causal masking is the TPU's tril(k = Sk -
// Sq): query row i sees keys j <= i + off, off = Sk - Sq >= 0.
//
// What bounds them on the H100: with no tensor core the operations do. At
// BERT's shape (B 8, S 512, 12 heads of D 64, not causal) the forward's 2
// products of 2 D flops per (query, key) pair are 6.4 GFLOP, 0.096 ms at
// 67 TFLOP/s, against 0.019 ms for its 4 * 12.6 MB at 3.35 TB/s; the
// backward's 5 products 0.24 ms. The design is the simplest that keeps the
// [S, S] scores out of device memory:
// - a block owns a 64-row tile (query rows in the forward and the dq
//   role, keys in the dk/dv role) and walks the other side's 64-row tiles,
//   each loaded into shared memory by all 256 threads (16-byte global
//   loads, zero rows past S);
// - a product of two tiles is register-tiled: the 16 x 16 threads each
//   hold a 4 x 4 piece of the 64 x 64 score tile, rows ty * 4 + i and
//   columns tx + 16 j, so a warp reads two rows of one operand (a
//   broadcast) and sixteen rows of the other, padded to D + 1 floats so
//   they fall in sixteen banks;
// - the forward's softmax is online: a thread keeps its four rows'
//   running max m and partial sums l (a row's max is reduced over the 16
//   threads that share it, its sum once at the end), rescales its output
//   accumulators by alpha = exp2(m_old - m_new) and writes P into the
//   shared memory K used (K is read by then), from which P V is
//   accumulated, rows ty * 4 + i and columns tx + 16 n of the output;
// - the backward is one grid without atomics, as flash_attention.cu's:
//   dq role blocks (fixed q, do; k, v streamed) recompute p and ds = p (dp
//   - delta), put ds over v in shared memory and accumulate ds k; dk/dv
//   role blocks (fixed k, v; q, do, lse and delta streamed) compute the
//   transposed tiles p^T and ds^T and accumulate p^T do and ds^T q. Each
//   role recomputes the scores it needs, so a one-role launch gives the
//   same bits as the two-role one. Causal blocks skip the tiles wholly
//   past (forward, dq) or before (dk/dv) their diagonal.
// Later work makes it fast (a ring of tiles, more warps on the softmax,
// the wider tiles that the 227 KB of shared memory allow).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TILE = 64;      // rows of a tile
constexpr int THREADS = 256;  // 16 x 16: a 4 x 4 piece of a 64 x 64 tile each
constexpr int PLD = TILE + 1;  // row stride of a shared score tile
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int D>
struct F32 {
  static constexpr int LD = D + 1;        // stride of a tile read by rows
  static constexpr int T = TILE * LD;     // floats of such a tile
  static constexpr int NJ = D / 16;       // output columns a thread holds
  // forward: q, k (then p over it), v unpadded
  static constexpr int FWD = 2 * T + TILE * D;
  // backward: dq role q, do, k, v (then ds over v); dk/dv role k, v, q,
  // do, p^T, ds^T, the query tile's lse and delta
  static constexpr int DQ = 4 * T;
  static constexpr int DKV = 4 * T + 2 * TILE * PLD + 2 * TILE;
  static constexpr int BWD = DQ > DKV ? DQ : DKV;
  static_assert(TILE * PLD <= T, "a score tile must fit over a k tile");
};

// rows r0 .. r0 + 63 of head h of batch b of a [B, S, H, D] tensor into
// shared memory at row stride ld, zero past S
template <int D>
__device__ __forceinline__ void load_tile(float* dst, int ld,
                                          const float* __restrict__ src,
                                          int b, int h, int H, int S,
                                          int r0) {
  constexpr int V4 = D / 4;
  for (int i = threadIdx.x; i < TILE * V4; i += THREADS) {
    const int r = i / V4, c = (i % V4) * 4, row = r0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < S)
      x = *reinterpret_cast<const float4*>(
          src + (((size_t)b * S + row) * H + h) * D + c);
    float* d = dst + r * ld + c;
    d[0] = x.x;
    d[1] = x.y;
    d[2] = x.z;
    d[3] = x.w;
  }
}

// s[i][j] = sum_d A[ty * 4 + i][d] * B[tx + 16 j][d], both at stride D + 1
template <int D>
__device__ __forceinline__ void tile_dot(float (&s)[4][4],
                                         const float* __restrict__ A,
                                         const float* __restrict__ B, int ty,
                                         int tx) {
  constexpr int LD = F32<D>::LD;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float a[4], bb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ty * 4 + i) * LD + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) bb[j] = B[(tx + 16 * j) * LD + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bb[j], s[i][j]);
  }
}

// acc[i][n] += sum_c P[ty * 4 + i][c] * X[c][tx + 16 n] (P at stride PLD,
// X at stride ldx)
template <int D>
__device__ __forceinline__ void tile_pv(float (&acc)[4][D / 16],
                                        const float* __restrict__ P,
                                        const float* __restrict__ X, int ldx,
                                        int ty, int tx) {
#pragma unroll 4
  for (int c = 0; c < TILE; ++c) {
    float p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = P[(ty * 4 + i) * PLD + c];
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      const float x = X[c * ldx + tx + 16 * n];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][n] = fmaf(p[i], x, acc[i][n]);
    }
  }
}

// reductions over the 16 threads (a half warp) that share a row
__device__ __forceinline__ float half_max(float x) {
#pragma unroll
  for (int o = 8; o; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float half_sum(float x) {
#pragma unroll
  for (int o = 8; o; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// key tiles the query rows q0 .. q0 + 63 walk: up to the diagonal of the
// last row under causal masking
__device__ __forceinline__ int key_tiles(int q0, int Sk, int off,
                                         int causal) {
  const int n = (Sk + TILE - 1) / TILE;
  return causal ? min(n, (off + q0 + TILE - 1) / TILE + 1) : n;
}

// ---------------------------------------------------------------------------
// forward: out and lse
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ out,
              float* __restrict__ lse, int H, int Sq, int Sk, int causal,
              float c) {
  using L = F32<D>;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + L::T;  // then P
  float* Vs = Ks + L::T;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * TILE;  // heaviest first
  const int off = Sk - Sq;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  load_tile<D>(Qs, L::LD, q, b, h, H, Sq, q0);
  // this thread's rows and the last key each sees (every row sees key 0)
  int lim[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    lim[i] = causal ? min(Sk - 1, q0 + ty * 4 + i + off) : Sk - 1;

  float o[4][L::NJ], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int n = 0; n < L::NJ; ++n) o[i][n] = 0.f;
  }
  const int n_tiles = key_tiles(q0, Sk, off, causal);
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * TILE;
    __syncthreads();  // the tile before is consumed
    load_tile<D>(Ks, L::LD, k, b, h, H, Sk, k0);
    load_tile<D>(Vs, D, v, b, h, H, Sk, k0);
    __syncthreads();
    float s[4][4];
    tile_dot<D>(s, Qs, Ks, ty, tx);
    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float x = k0 + tx + 16 * j > lim[i] ? -INFINITY : s[i][j] * c;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      mx = half_max(mx);
      alpha[i] = exp2f(m[i] - mx);  // 0 on the first tile
      m[i] = mx;
    }
    __syncthreads();  // every thread has read k: p goes over it
    float* Ps = Ks;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = exp2f(s[i][j] - m[i]);
        ps += p;
        Ps[(ty * 4 + i) * PLD + tx + 16 * j] = p;
      }
      l[i] = l[i] * alpha[i] + ps;
#pragma unroll
      for (int n = 0; n < L::NJ; ++n) o[i][n] *= alpha[i];
    }
    __syncthreads();
    tile_pv<D>(o, Ps, Vs, D, ty, tx);  // o += p v
  }

  // out = o / l; lse from one thread of each row; rows past Sq not stored
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float li = half_sum(l[i]);
    const int row = q0 + ty * 4 + i;
    if (row >= Sq) continue;
    float* orow = out + (((size_t)b * Sq + row) * H + h) * D;
#pragma unroll
    for (int n = 0; n < L::NJ; ++n) orow[tx + 16 * n] = o[i][n] / li;
    if (tx == 0) lse[(size_t)bh * Sq + row] = (m[i] + log2f(li)) * LN2;
  }
}

// ---------------------------------------------------------------------------
// backward: one grid, the dq role and the dk/dv role
// ---------------------------------------------------------------------------

struct Shape {
  int H, Sq, Sk, off, causal;
  float c, scale;  // scale * log2(e), scale
};

// dq of one query tile: the key tiles its rows see stream through
template <int D>
__device__ __forceinline__ void bwd_dq(float* smem, const float* q,
                                       const float* k, const float* v,
                                       const float* dout, const float* lse,
                                       const float* delta, float* dq,
                                       const Shape& sh) {
  using L = F32<D>;
  const int n_q = (sh.Sq + TILE - 1) / TILE;
  if ((int)blockIdx.x >= n_q) return;
  float* Qs = smem;
  float* dOs = Qs + L::T;
  float* Ks = dOs + L::T;
  float* Vs = Ks + L::T;  // then ds
  const int bh = blockIdx.y, b = bh / sh.H, h = bh % sh.H;
  const int q0 = (n_q - 1 - blockIdx.x) * TILE;  // heaviest first
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;

  load_tile<D>(Qs, L::LD, q, b, h, sh.H, sh.Sq, q0);
  load_tile<D>(dOs, L::LD, dout, b, h, sh.H, sh.Sq, q0);
  int lim[4];
  float lse2[4], dl[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    lim[i] = sh.causal ? min(sh.Sk - 1, row + sh.off) : sh.Sk - 1;
    const bool live = row < sh.Sq;
    lse2[i] = live ? lse[(size_t)bh * sh.Sq + row] * LOG2E : 0.f;
    dl[i] = live ? delta[(size_t)bh * sh.Sq + row] : 0.f;
  }

  float acc[4][L::NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int n = 0; n < L::NJ; ++n) acc[i][n] = 0.f;
  const int n_tiles = key_tiles(q0, sh.Sk, sh.off, sh.causal);
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * TILE;
    __syncthreads();
    load_tile<D>(Ks, L::LD, k, b, h, sh.H, sh.Sk, k0);
    load_tile<D>(Vs, L::LD, v, b, h, sh.H, sh.Sk, k0);
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_dot<D>(s, Qs, Ks, ty, tx);   // q k^T
    tile_dot<D>(dp, dOs, Vs, ty, tx);  // do v^T
    __syncthreads();  // every thread has read v: ds goes over it
    float* dSs = Vs;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = exp2f(s[i][j] * sh.c - lse2[i]);
        dSs[(ty * 4 + i) * PLD + tx + 16 * j] =
            k0 + tx + 16 * j > lim[i] ? 0.f : p * (dp[i][j] - dl[i]);
      }
    __syncthreads();
    tile_pv<D>(acc, dSs, Ks, L::LD, ty, tx);  // dq += ds k
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= sh.Sq) continue;
    float* drow = dq + (((size_t)b * sh.Sq + row) * sh.H + h) * D;
#pragma unroll
    for (int n = 0; n < L::NJ; ++n) drow[tx + 16 * n] = acc[i][n] * sh.scale;
  }
}

// dk and dv of one key tile: the transposed products (k q^T, v do^T) put
// the keys on the rows; the query tiles that see the key tile stream
// through with their lse and delta
template <int D>
__device__ __forceinline__ void bwd_dkv(float* smem, const float* q,
                                        const float* k, const float* v,
                                        const float* dout, const float* lse,
                                        const float* delta, float* dk,
                                        float* dv, const Shape& sh) {
  using L = F32<D>;
  if ((int)blockIdx.x >= (sh.Sk + TILE - 1) / TILE) return;
  float* Ks = smem;
  float* Vs = Ks + L::T;
  float* Qs = Vs + L::T;
  float* dOs = Qs + L::T;
  float* Pt = dOs + L::T;
  float* dSt = Pt + TILE * PLD;
  float* lse_s = dSt + TILE * PLD;
  float* dl_s = lse_s + TILE;
  const int bh = blockIdx.y, b = bh / sh.H, h = bh % sh.H;
  const int k0 = blockIdx.x * TILE;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  // query tiles wholly before this key tile's diagonal see none of it
  const int first = sh.causal ? max(0, k0 - sh.off) / TILE : 0;
  const int n_q = (sh.Sq + TILE - 1) / TILE;

  load_tile<D>(Ks, L::LD, k, b, h, sh.H, sh.Sk, k0);
  load_tile<D>(Vs, L::LD, v, b, h, sh.H, sh.Sk, k0);
  // a query sees this thread's key kp when it is at least kp - off
  int lo[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) lo[i] = sh.causal ? k0 + ty * 4 + i - sh.off : 0;

  float dka[4][L::NJ], dva[4][L::NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int n = 0; n < L::NJ; ++n) dka[i][n] = dva[i][n] = 0.f;
  for (int t = first; t < n_q; ++t) {
    const int q0 = t * TILE;
    __syncthreads();
    load_tile<D>(Qs, L::LD, q, b, h, sh.H, sh.Sq, q0);
    load_tile<D>(dOs, L::LD, dout, b, h, sh.H, sh.Sq, q0);
    if (threadIdx.x < TILE) {
      const int qi = q0 + threadIdx.x;
      const bool live = qi < sh.Sq;
      lse_s[threadIdx.x] = live ? lse[(size_t)bh * sh.Sq + qi] * LOG2E : 0.f;
      dl_s[threadIdx.x] = live ? delta[(size_t)bh * sh.Sq + qi] : 0.f;
    }
    __syncthreads();
    float st[4][4], dpt[4][4];
    tile_dot<D>(st, Ks, Qs, ty, tx);    // k q^T
    tile_dot<D>(dpt, Vs, dOs, ty, tx);  // v do^T
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = tx + 16 * j, qi = q0 + col;
      const float ls = lse_s[col], d = dl_s[col];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float p = exp2f(st[i][j] * sh.c - ls);
        if (qi >= sh.Sq || qi < lo[i]) p = 0.f;
        Pt[(ty * 4 + i) * PLD + col] = p;
        dSt[(ty * 4 + i) * PLD + col] = p * (dpt[i][j] - d);
      }
    }
    __syncthreads();
    tile_pv<D>(dva, Pt, dOs, L::LD, ty, tx);  // dv += p^T do
    tile_pv<D>(dka, dSt, Qs, L::LD, ty, tx);  // dk += ds^T q
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kp = k0 + ty * 4 + i;
    if (kp >= sh.Sk) continue;
    const size_t at = (((size_t)b * sh.Sk + kp) * sh.H + h) * D;
#pragma unroll
    for (int n = 0; n < L::NJ; ++n) {
      dk[at + tx + 16 * n] = dka[i][n] * sh.scale;
      dv[at + tx + 16 * n] = dva[i][n];
    }
  }
}

// role 0 (dq) or 1 (dk and dv): role0 + blockIdx.z
template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              float* __restrict__ dq, float* __restrict__ dk,
              float* __restrict__ dv, Shape sh, int role0) {
  extern __shared__ float smem[];
  if (role0 + blockIdx.z == 0)
    bwd_dq<D>(smem, q, k, v, dout, lse, delta, dq, sh);
  else
    bwd_dkv<D>(smem, q, k, v, dout, lse, delta, dk, dv, sh);
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

bool bad_shape(int B, int H, int Sq, int Sk, int D, int causal) {
  return B < 1 || H < 1 || (long long)B * H > 65535 || Sq < 1 || Sk < 1 ||
         (causal && Sq > Sk) || (D != 64 && D != 128);
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
  constexpr size_t smem = F32<D>::FWD * sizeof(float);
  static const int attr = prepare(flash_fwd_f32<D>, smem);
  if (attr) return attr;
  const dim3 grid((Sq + TILE - 1) / TILE, B * H);
  flash_fwd_f32<D><<<grid, THREADS, smem, s>>>(q, k, v, out, lse, H, Sq, Sk,
                                              causal, scale * LOG2E);
  return static_cast<int>(cudaGetLastError());
}

// roles role0 .. role0 + n_roles - 1 in one launch
template <int D>
int bwd(const float* q, const float* k, const float* v, const float* dout,
        const float* lse, const float* delta, float* dq, float* dk,
        float* dv, int B, int H, int Sq, int Sk, int causal, float scale,
        int role0, int n_roles, cudaStream_t s) {
  constexpr size_t smem = F32<D>::BWD * sizeof(float);
  static const int attr = prepare(flash_bwd_f32<D>, smem);
  if (attr) return attr;
  const int n_q = (Sq + TILE - 1) / TILE, n_k = (Sk + TILE - 1) / TILE;
  const int nx = n_roles == 2 ? (n_q > n_k ? n_q : n_k)
                : role0 == 0  ? n_q
                              : n_k;
  const Shape sh{H, Sq, Sk, Sk - Sq, causal, scale * LOG2E, scale};
  const dim3 grid(nx, B * H, n_roles);
  flash_bwd_f32<D><<<grid, THREADS, smem, s>>>(q, k, v, dout, lse, delta, dq,
                                              dk, dv, sh, role0);
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
  if (backward)
    return D == 64 ? F32<64>::BWD * 4 : F32<128>::BWD * 4;
  return D == 64 ? F32<64>::FWD * 4 : F32<128>::FWD * 4;
}
