// Ragged attention over a paged KV pool: decode ticks and prefill chunks
// in one kernel.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/paged_attention.py
// (ragged_paged_attention, kernel body _make_kernel).
//
// Slot b carries Tq query rows; row t sits at virtual position
// ctx[b] + t and attends keys [0, ctx[b] + t]. Key j of the slot lives in
// row j % psz of physical page page_table[b, j / psz] of the flat pool
// kp/vp [P, psz, Hkv, D]: masking is in virtual positions, whatever page
// backs them. GQA: rep = nH / Hkv query heads per kv head, never repeated.
//
// Conventions, as the TPU kernel: q is pre-scaled in its own dtype
// (qs = round_T(q * scale)); scores, the running max / sum and the
// accumulator are fp32; the unnormalised probabilities are rounded to T
// before the P @ V product, which accumulates in fp32; the output is
// acc / l rounded to T, normalised once at the end.
//
// The read bound: a slot reads pages 0 .. last only, with
// last = min((ctx + q_len - 1) / psz, max_pages - 1), so reads scale with
// the slot's position and never touch the table past max_pages (a frozen
// slot may sit at ctx == max_len). The TPU kernel gets the same from the
// clamp in its BlockSpec index map.
//
// What bounds it on the H100: bytes on the decode tick (each visible key
// and value row is read once per block, about 1 flop per byte, far below
// the card's ~295 flops/byte ridge); on a prefill chunk the blocks of one
// kv head re-read the same rows from L2, and the CUDA-core dot products
// bound it. The design:
//
// - one thread block per (kv head, slot, group of ROWS query rows), the
//   rows taken in kv-head-major order (row = t * rep + r, so a decode tick
//   holds the rep heads of one kv head, a prefill chunk ROWS / rep query
//   positions); each row has its own causal limit, and a block walks keys
//   only up to its last row's limit: a prefill block stops at its causal
//   page;
// - the block's WARPS warps split the key tiles round-robin; in a tile,
//   lane t owns key t0 + t: it looks its physical row up in the page
//   table, reads the key in 16-byte loads and dots it with the rows' q in
//   shared memory. For P @ V, lane t owns D / 32 output columns and reads
//   each key's value row (its page row shared through shared memory);
// - each warp keeps its own online-softmax state in registers; the warps
//   merge once, through shared memory, at the end;
// - a block whose rows all sit at or past q_len writes zeros: those rows
//   are padding the caller discards.
//
// Split-K across blocks, cp.async/TMA staging and tensor cores (wgmma for
// the prefill's products) are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int TILE = 32;   // keys per warp step: one lane per key
constexpr int ROWS = 8;    // query rows per block (also the largest rep)
constexpr int MAX_TQ = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T and widened back to fp32
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// the two bf16 halves of a 32-bit word, element 0 in the low half
__device__ __forceinline__ float bf16_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// N consecutive values of T at p (aligned to their size) as fp32;
// N * sizeof(T) is 4, 8 or 16 bytes, read in one load
template <typename T, int N>
__device__ __forceinline__ void load_f(const T* p, float (&f)[N]) {
  if constexpr (sizeof(T) == 4) {
    if constexpr (N == 4) {
      const float4 u = *reinterpret_cast<const float4*>(p);
      f[0] = u.x; f[1] = u.y; f[2] = u.z; f[3] = u.w;
    } else {
      static_assert(N == 2, "fp32 loads of 2 or 4 values");
      const float2 u = *reinterpret_cast<const float2*>(p);
      f[0] = u.x; f[1] = u.y;
    }
  } else {
    if constexpr (N == 8) {
      const uint4 u = *reinterpret_cast<const uint4*>(p);
      const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        f[2 * i] = bf16_lo(w[i]);
        f[2 * i + 1] = bf16_hi(w[i]);
      }
    } else if constexpr (N == 4) {
      const uint2 u = *reinterpret_cast<const uint2*>(p);
      f[0] = bf16_lo(u.x); f[1] = bf16_hi(u.x);
      f[2] = bf16_lo(u.y); f[3] = bf16_hi(u.y);
    } else {
      static_assert(N == 2, "bf16 loads of 2, 4 or 8 values");
      const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
      f[0] = bf16_lo(u); f[1] = bf16_hi(u);
    }
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 2)
ragged_paged_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                    const T* __restrict__ vp,
                    const int32_t* __restrict__ page_table,
                    const int32_t* __restrict__ ctx_len,
                    const int32_t* __restrict__ q_len, T* __restrict__ out,
                    int Tq, int nH, int Hkv, int psz, int P, int max_pages,
                    float scale) {
  constexpr int CH = 16 / sizeof(T);  // values per 16-byte key load
  constexpr int DL = D / 32;          // output columns per lane
  __shared__ __align__(16) float q_s[ROWS][D];
  __shared__ float p_s[WARPS][ROWS][TILE];
  __shared__ int krow_s[WARPS][TILE];
  __shared__ float m_w[WARPS][ROWS];
  __shared__ float l_w[WARPS][ROWS];
  __shared__ float acc_w[WARPS][ROWS][D];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int row0 = blockIdx.z * ROWS;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rep = nH / Hkv;
  const int nr = min(ROWS, Tq * rep - row0);  // rows of this block
  const int ctx = max(ctx_len[b], 0);
  const int ql = q_len ? min(max(q_len[b], 1), Tq) : Tq;

  // out[b, t, h * rep + r] for block row i, with t * rep + r = row0 + i
  auto out_off = [&](int i) {
    const int row = row0 + i;
    return ((size_t)(b * Tq + row / rep) * nH + h * rep + row % rep) * D;
  };
  if (row0 / rep >= ql) {  // every row is padding: finite zeros
    for (int e = tid; e < nr * D; e += THREADS)
      out[out_off(e / D) + e % D] = from_f<T>(0.f);
    return;
  }

  // the last key any row of the slot may read, and each row's limit
  const int last_page = min((ctx + ql - 1) / psz, max_pages - 1);
  const int kmax = last_page * psz + psz - 1;
  int lim[ROWS];
#pragma unroll
  for (int i = 0; i < ROWS; ++i)
    lim[i] = min(ctx + (row0 + min(i, nr - 1)) / rep, kmax);
  const int kend = lim[ROWS - 1];  // the last row's limit is the largest

  for (int e = tid; e < nr * D; e += THREADS)
    q_s[e / D][e % D] = round_to<T>(to_f(q[out_off(e / D) + e % D]) * scale);
  __syncthreads();

  const size_t row_stride = (size_t)Hkv * D;  // elements between pool rows
  const int32_t* pt = page_table + (size_t)b * max_pages;
  const T* kb = kp + (size_t)h * D;
  const T* vb = vp + (size_t)h * D + lane * DL;
  const int n_tiles = kend / TILE + 1;

  float m[ROWS], l[ROWS], acc[ROWS][DL];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < DL; ++e) acc[i][e] = 0.f;
  }

  for (int j = warp; j < n_tiles; j += WARPS) {
    const int t0 = j * TILE;
    const int key = t0 + lane;
    const bool in_range = key <= kend;
    int krow = 0;
    if (in_range) {
      const int phys = min(max(pt[key / psz], 0), P - 1);
      krow = phys * psz + key % psz;
    }
    krow_s[warp][lane] = krow;
    // scores: lane owns one key
    float s[ROWS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) s[i] = 0.f;
    if (in_range) {
      const T* kr = kb + (size_t)krow * row_stride;
#pragma unroll
      for (int c = 0; c < D; c += CH) {
        float kf[CH];
        load_f<T, CH>(kr + c, kf);
#pragma unroll
        for (int i = 0; i < ROWS; ++i) {
          if (i < nr) {
#pragma unroll
            for (int e = 0; e < CH; ++e) s[i] += q_s[i][c + e] * kf[e];
          }
        }
      }
    }
    // online softmax per row across the warp's 32 keys. A row may see no
    // key of a tile (its limit lies before it): m_new is then -inf and
    // the row's state stays as it was.
    float alpha[ROWS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      alpha[i] = 1.f;
      if (i < nr) {
        const bool vis = key <= lim[i];
        const float sr = vis ? s[i] : -INFINITY;
        const float m_new = fmaxf(m[i], warp_max(sr));
        const float m_use = m_new == -INFINITY ? 0.f : m_new;
        const float p = vis ? expf(sr - m_use) : 0.f;
        alpha[i] = expf(m[i] - m_use);  // the row's first visible tile: 0
        l[i] = l[i] * alpha[i] + warp_sum(p);
        m[i] = m_new;
        p_s[warp][i][lane] = round_to<T>(p);
      }
    }
    __syncwarp();
    // P @ V: lane owns DL output columns
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      if (i < nr) {
#pragma unroll
        for (int e = 0; e < DL; ++e) acc[i][e] *= alpha[i];
      }
    }
    const int n_keys = min(TILE, kend - t0 + 1);
#pragma unroll 4
    for (int t = 0; t < n_keys; ++t) {
      float vf[DL];
      load_f<T, DL>(vb + (size_t)krow_s[warp][t] * row_stride, vf);
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        if (i < nr) {
          const float p = p_s[warp][i][t];
#pragma unroll
          for (int e = 0; e < DL; ++e) acc[i][e] += p * vf[e];
        }
      }
    }
    __syncwarp();  // p_s and krow_s are rewritten by the next tile
  }

  // merge the warps' partial states. A warp that walked no tile holds
  // m = -inf, l = 0, acc = 0 and weighs exp(-inf) = 0; warp 0 walks
  // tile 0, whose key 0 every row sees, so each row's max is finite.
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    if (i < nr) {
      if (lane == 0) {
        m_w[warp][i] = m[i];
        l_w[warp][i] = l[i];
      }
#pragma unroll
      for (int e = 0; e < DL; ++e) acc_w[warp][i][lane * DL + e] = acc[i][e];
    }
  }
  __syncthreads();
  for (int e = tid; e < nr * D; e += THREADS) {
    const int i = e / D, d = e % D;
    float mx = m_w[0][i];
    for (int w = 1; w < WARPS; ++w) mx = fmaxf(mx, m_w[w][i]);
    float lsum = 0.f, a = 0.f;
    for (int w = 0; w < WARPS; ++w) {
      const float f = expf(m_w[w][i] - mx);
      lsum += l_w[w][i] * f;
      a += acc_w[w][i][d] * f;
    }
    out[out_off(i) + d] = from_f<T>(a / lsum);  // lsum >= exp(0) > 0
  }
}

template <typename T, int D>
int launch(const void* q, const void* kp, const void* vp, const void* pt,
           const void* ctx, const void* qlen, void* out, int B, int Tq,
           int nH, int Hkv, int psz, int P, int max_pages, float scale,
           cudaStream_t stream) {
  const int groups = (Tq * (nH / Hkv) + ROWS - 1) / ROWS;
  const dim3 grid(Hkv, B, groups);
  ragged_paged_kernel<T, D><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp),
      static_cast<const T*>(vp), static_cast<const int32_t*>(pt),
      static_cast<const int32_t*>(ctx), static_cast<const int32_t*>(qlen),
      static_cast<T*>(out), Tq, nH, Hkv, psz, P, max_pages, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype_code: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the
// launch (0 = success); cudaErrorInvalidValue for a shape or dtype the
// kernel does not take. Device pointers, all contiguous, q/kp/vp/out
// aligned to 16 bytes: q/out [B, Tq, nH, D], kp/vp [P, psz, Hkv, D],
// page_table [B, max_pages] int32, ctx [B] int32, qlen [B] int32 or null
// (every row live).
extern "C" int ragged_paged_attention(const void* q, const void* kp,
                                      const void* vp, const void* page_table,
                                      const void* ctx, const void* qlen,
                                      void* out, int B, int Tq, int nH,
                                      int Hkv, int D, int psz, int P,
                                      int max_pages, int dtype_code,
                                      float scale, void* stream) {
  if (B < 1 || B > 65535 || Tq < 1 || Tq > MAX_TQ || Hkv < 1 ||
      nH % Hkv != 0 || nH / Hkv > ROWS || psz < 1 || psz % 8 != 0 ||
      P < 1 || max_pages < 1 || (long long)P * psz > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype_code == 0 && D == 64)
    return launch<float, 64>(q, kp, vp, page_table, ctx, qlen, out, B, Tq,
                             nH, Hkv, psz, P, max_pages, scale, s);
  if (dtype_code == 0 && D == 128)
    return launch<float, 128>(q, kp, vp, page_table, ctx, qlen, out, B, Tq,
                              nH, Hkv, psz, P, max_pages, scale, s);
  if (dtype_code == 1 && D == 64)
    return launch<__nv_bfloat16, 64>(q, kp, vp, page_table, ctx, qlen, out,
                                     B, Tq, nH, Hkv, psz, P, max_pages,
                                     scale, s);
  if (dtype_code == 1 && D == 128)
    return launch<__nv_bfloat16, 128>(q, kp, vp, page_table, ctx, qlen, out,
                                      B, Tq, nH, Hkv, psz, P, max_pages,
                                      scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
