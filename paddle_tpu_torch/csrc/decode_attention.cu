// Ragged single-token decode attention over a slot-contiguous KV cache.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/decode_attention.py
// (ragged_decode_attention, kernel body _make_kernel).
//
// out[b, h*rep + r, :] = softmax_j(qs[b, h*rep + r] . k[b, j, h]) @ v[b, j, h]
// over keys j in [0, pos[b]] (inclusive: row pos[b] holds the token the
// caller has just scattered), with rep = nH / Hkv query heads per kv head
// (GQA grouped: the cache is never repeated).
//
// Conventions, as the TPU kernel: q is pre-scaled by 1/sqrt(D) in its own
// dtype (qs = round_T(q * scale)); scores, the running max / sum and the
// accumulator are fp32; the unnormalised probabilities are rounded to T
// before the P @ V product, which accumulates in fp32; the output is
// acc / l rounded to T.
//
// Quant mode (the TPU kernel's k_scale / v_scale): the cache holds int8 or
// fp8-e4m3fn rows (KT) with one fp32 scale per row, ks / vs [B, max_len].
// Keys and values are dequantized in fp32 with their row's scale (a key's
// scale multiplies its score once, after the dot; a value's scale is
// folded into its probability), the probabilities stay fp32 (not rounded
// to T), and the output is rounded to T. A row's scale is read only when
// the row is visible, so the bytes read still scale with pos.
//
// What bounds it on the H100: bytes. Each (slot, kv head) reads its
// (pos+1) x D keys and values once; a tick does about 1 flop per byte
// read, far below the card's ~295 flops/byte ridge. So the design aims at
// keeping many loads in flight and at reading nothing past pos:
//
// - one thread block per (kv head, slot), holding that head's rep query
//   rows (pre-scaled, in shared memory);
// - the block's WARPS warps split the slot's key tiles round-robin (warp w
//   takes tiles w, w + WARPS, ...), and only tiles 0 .. pos[b] / TILE
//   exist, so the bytes read scale with pos[b] and not with max_len (the
//   TPU kernel gets the same from its clamped BlockSpec index map). The
//   TPU walks its tiles in order on one core; here the walk is spread over
//   the warps so a long slot does not serialise on one barrier chain;
// - within a tile, lane t owns key t0 + t for the scores: it reads that
//   key's row in 16-byte loads straight into registers and dots it with
//   the shared q rows, so no shuffle is needed per key. For P @ V, lane t
//   owns D / 32 output columns and reads each key's value row coalesced;
// - each warp keeps its own online-softmax state (max, sum, [rep, D / 32]
//   accumulator) in registers; the warps' partial states are merged once,
//   through shared memory, at the end.
//
// Split-K across blocks (flash-decoding), cp.async/TMA staging and tensor
// cores are left for later work.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int TILE = 32;     // keys per warp step: one lane per key
constexpr int MAX_REP = 8;   // query heads per kv head

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// one byte of a narrow cache as fp32
template <typename T>
__device__ __forceinline__ float byte_to_f(uint32_t b);
template <>
__device__ __forceinline__ float byte_to_f<int8_t>(uint32_t b) {
  return static_cast<float>(static_cast<int8_t>(static_cast<uint8_t>(b)));
}
template <>
__device__ __forceinline__ float byte_to_f<__nv_fp8_e4m3>(uint32_t b) {
  __nv_fp8_e4m3 v;
  v.__x = static_cast<__nv_fp8_storage_t>(b);
  return static_cast<float>(v);
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
// N * sizeof(T) is 2, 4, 8 or 16 bytes, read in one load
template <typename T, int N>
__device__ __forceinline__ void load_f(const T* p, float (&f)[N]) {
  if constexpr (sizeof(T) == 1) {
    if constexpr (N == 16) {
      const uint4 u = *reinterpret_cast<const uint4*>(p);
      const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int i = 0; i < 16; ++i)
        f[i] = byte_to_f<T>((w[i / 4] >> (8 * (i % 4))) & 0xffu);
    } else if constexpr (N == 4) {
      const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
#pragma unroll
      for (int i = 0; i < 4; ++i) f[i] = byte_to_f<T>((u >> (8 * i)) & 0xffu);
    } else {
      static_assert(N == 2, "narrow loads of 2, 4 or 16 values");
      const uint32_t u = *reinterpret_cast<const uint16_t*>(p);
      f[0] = byte_to_f<T>(u & 0xffu);
      f[1] = byte_to_f<T>(u >> 8);
    }
  } else if constexpr (sizeof(T) == 4) {
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

// T: q and out; KT: the cache (T, or int8_t / __nv_fp8_e4m3 in quant mode)
template <typename T, typename KT, int D>
__global__ void __launch_bounds__(THREADS, 2)
ragged_decode_kernel(const T* __restrict__ q, const KT* __restrict__ kc,
                     const KT* __restrict__ vc, const float* __restrict__ ks,
                     const float* __restrict__ vs,
                     const int32_t* __restrict__ pos, T* __restrict__ out,
                     int nH, int Hkv, int max_len, float scale) {
  constexpr bool QUANT = !std::is_same<T, KT>::value;
  constexpr int CH = 16 / sizeof(KT);  // values per 16-byte key load
  constexpr int DL = D / 32;          // output columns per lane
  __shared__ __align__(16) float q_s[MAX_REP][D];
  __shared__ float p_s[WARPS][MAX_REP][TILE];
  __shared__ float m_w[WARPS][MAX_REP];
  __shared__ float l_w[WARPS][MAX_REP];
  __shared__ float acc_w[WARPS][MAX_REP][D];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rep = nH / Hkv;
  // a slot past the window (a frozen slot at pos == max_len) attends to
  // the whole window and reads nothing out of bounds
  const int p_b = min(max(pos[b], 0), max_len - 1);

  const T* qb = q + ((size_t)b * nH + (size_t)h * rep) * D;
  for (int e = tid; e < rep * D; e += THREADS)
    q_s[e / D][e % D] = round_to<T>(to_f(qb[e]) * scale);
  __syncthreads();

  const size_t row = (size_t)Hkv * D;  // elements between cache rows
  const KT* kb = kc + (size_t)b * max_len * row + (size_t)h * D;
  const KT* vb = vc + (size_t)b * max_len * row + (size_t)h * D + lane * DL;
  const size_t srow = (size_t)b * max_len;  // this slot's scale rows
  const int n_tiles = p_b / TILE + 1;

  float m[MAX_REP], l[MAX_REP], acc[MAX_REP][DL];
#pragma unroll
  for (int r = 0; r < MAX_REP; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < DL; ++e) acc[r][e] = 0.f;
  }

  for (int j = warp; j < n_tiles; j += WARPS) {
    const int t0 = j * TILE;
    const int key = t0 + lane;
    const bool visible = key <= p_b;
    // scores: lane owns one key
    float s[MAX_REP];
#pragma unroll
    for (int r = 0; r < MAX_REP; ++r) s[r] = 0.f;
    if (visible) {
      const KT* kr = kb + (size_t)key * row;
#pragma unroll
      for (int c = 0; c < D; c += CH) {
        float kf[CH];
        load_f<KT, CH>(kr + c, kf);
#pragma unroll
        for (int r = 0; r < MAX_REP; ++r) {
          if (r < rep) {
#pragma unroll
            for (int e = 0; e < CH; ++e) s[r] += q_s[r][c + e] * kf[e];
          }
        }
      }
      if constexpr (QUANT) {
        const float k_sc = ks[srow + key];
#pragma unroll
        for (int r = 0; r < MAX_REP; ++r) s[r] *= k_sc;
      }
    }
    // the value row's scale, folded into the key's probability
    const float v_sc = (QUANT && visible) ? vs[srow + key] : 1.f;
    // online softmax per query row, across the warp's 32 keys. Key t0 is
    // visible in every tile walked, so the tile max and m_new are finite.
    float alpha[MAX_REP];
#pragma unroll
    for (int r = 0; r < MAX_REP; ++r) {
      if (r < rep) {
        const float sr = visible ? s[r] : -INFINITY;
        const float m_new = fmaxf(m[r], warp_max(sr));
        const float p = visible ? expf(sr - m_new) : 0.f;
        alpha[r] = expf(m[r] - m_new);  // the warp's first tile: 0
        l[r] = l[r] * alpha[r] + warp_sum(p);
        m[r] = m_new;
        p_s[warp][r][lane] = QUANT ? p * v_sc : round_to<T>(p);
      }
    }
    __syncwarp();
    // P @ V: lane owns DL output columns
#pragma unroll
    for (int r = 0; r < MAX_REP; ++r) {
      if (r < rep) {
#pragma unroll
        for (int e = 0; e < DL; ++e) acc[r][e] *= alpha[r];
      }
    }
    const int n_keys = min(TILE, p_b - t0 + 1);
#pragma unroll 4
    for (int t = 0; t < n_keys; ++t) {
      float vf[DL];
      load_f<KT, DL>(vb + (size_t)(t0 + t) * row, vf);
#pragma unroll
      for (int r = 0; r < MAX_REP; ++r) {
        if (r < rep) {
          const float p = p_s[warp][r][t];
#pragma unroll
          for (int e = 0; e < DL; ++e) acc[r][e] += p * vf[e];
        }
      }
    }
    __syncwarp();  // p_s is rewritten by the next tile
  }

  // merge the warps' partial states. A warp that walked no tile holds
  // m = -inf, l = 0, acc = 0 and weighs exp(-inf) = 0; warp 0 always
  // walks tile 0, so the block's max is finite.
#pragma unroll
  for (int r = 0; r < MAX_REP; ++r) {
    if (r < rep) {
      if (lane == 0) {
        m_w[warp][r] = m[r];
        l_w[warp][r] = l[r];
      }
#pragma unroll
      for (int e = 0; e < DL; ++e) acc_w[warp][r][lane * DL + e] = acc[r][e];
    }
  }
  __syncthreads();
  T* ob = out + ((size_t)b * nH + (size_t)h * rep) * D;
  for (int e = tid; e < rep * D; e += THREADS) {
    const int r = e / D, d = e % D;
    float mx = m_w[0][r];
    for (int w = 1; w < WARPS; ++w) mx = fmaxf(mx, m_w[w][r]);
    float lsum = 0.f, a = 0.f;
    for (int w = 0; w < WARPS; ++w) {
      const float f = expf(m_w[w][r] - mx);
      lsum += l_w[w][r] * f;
      a += acc_w[w][r][d] * f;
    }
    // key 0 is always visible, so lsum >= exp(0) > 0
    ob[e] = from_f<T>(a / lsum);
  }
}

template <typename T, typename KT, int D>
int launch(const void* q, const void* kc, const void* vc, const void* ks,
           const void* vs, const void* pos, void* out, int B, int nH, int Hkv,
           int max_len, float scale, cudaStream_t stream) {
  const dim3 grid(Hkv, B);
  ragged_decode_kernel<T, KT, D><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const KT*>(kc),
      static_cast<const KT*>(vc), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int32_t*>(pos),
      static_cast<T*>(out), nH, Hkv, max_len, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename KT>
int launch_d(const void* q, const void* kc, const void* vc, const void* ks,
             const void* vs, const void* pos, void* out, int B, int nH,
             int Hkv, int D, int max_len, float scale, cudaStream_t s) {
  if (D == 64)
    return launch<T, KT, 64>(q, kc, vc, ks, vs, pos, out, B, nH, Hkv,
                             max_len, scale, s);
  if (D == 128)
    return launch<T, KT, 128>(q, kc, vc, ks, vs, pos, out, B, nH, Hkv,
                              max_len, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int launch_kv(const void* q, const void* kc, const void* vc, const void* ks,
              const void* vs, const void* pos, void* out, int B, int nH,
              int Hkv, int D, int max_len, int kv_code, float scale,
              cudaStream_t s) {
  if (kv_code == 0)
    return launch_d<T, T>(q, kc, vc, ks, vs, pos, out, B, nH, Hkv, D,
                          max_len, scale, s);
  if (ks == nullptr || vs == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (kv_code == 1)
    return launch_d<T, int8_t>(q, kc, vc, ks, vs, pos, out, B, nH, Hkv, D,
                               max_len, scale, s);
  if (kv_code == 2)
    return launch_d<T, __nv_fp8_e4m3>(q, kc, vc, ks, vs, pos, out, B, nH,
                                      Hkv, D, max_len, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype_code (q, out): 0 = float32, 1 = bfloat16. kv_code (kc, vc): 0 =
// q's dtype, 1 = int8, 2 = float8_e4m3fn (quant mode: ks / vs are the
// [B, max_len] float32 row scales; unused, and may be null, when kv_code is
// 0). Returns the cudaError_t of the launch (0 = success);
// cudaErrorInvalidValue for a shape or dtype the kernel does not take.
// Pointers are device pointers aligned to 16 bytes; q/out [B, nH, D],
// kc/vc [B, max_len, Hkv, D], pos [B] int32, all contiguous.
extern "C" int ragged_decode_attention(const void* q, const void* kc,
                                       const void* vc, const void* ks,
                                       const void* vs, const void* pos,
                                       void* out, int B, int nH, int Hkv,
                                       int D, int max_len, int dtype_code,
                                       int kv_code, float scale,
                                       void* stream) {
  if (B < 1 || Hkv < 1 || max_len < 1 || nH % Hkv != 0 ||
      nH / Hkv > MAX_REP || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype_code == 0)
    return launch_kv<float>(q, kc, vc, ks, vs, pos, out, B, nH, Hkv, D,
                            max_len, kv_code, scale, s);
  if (dtype_code == 1)
    return launch_kv<__nv_bfloat16>(q, kc, vc, ks, vs, pos, out, B, nH, Hkv,
                                    D, max_len, kv_code, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
