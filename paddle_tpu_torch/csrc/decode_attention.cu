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
// What bounds it on the H100: latency at the serving shape, bytes at
// llama7b width. Each (slot, kv head) reads its (pos + 1) x D keys and
// values once, about 1 flop per byte; at the serving shape (B 8, 12 heads
// of D 64, pos near 192) that is 0.0014 ms at 3.35 TB/s, less than one
// trip to device memory and back plus a launch, so what costs time is the
// chain of dependent steps: a block of one (kv head, slot) walking the
// slot's key tiles in turn waits on each tile's loads, and 96 such blocks
// leave most of the 132 SMs idle. At llama7b width (32 heads of D 128,
// max_len 2048) the bytes are ~40 times more and must stream at the HBM
// rate. So the design shortens the chain, spreads it, and keeps every
// chunk's bytes in flight at once:
//
// - split-KV (flash-decoding): the grid is (Hkv, B, n_chunks), one block
//   of 128 threads per chunk of CHUNK keys, fixed by the shapes alone (a
//   CUDA graph can capture it). A block whose chunk starts past pos[b]
//   exits before it reads anything, so the bytes read scale with pos and
//   not with max_len (the TPU kernel gets the same from its clamped
//   BlockSpec index map);
// - staged loads: each block issues its chunk's K rows, then its V rows,
//   as two groups of 16-byte cp.async copies into shared memory (rows
//   padded by 16 bytes, so 16-byte reads of a column are free of bank
//   conflicts), so every byte of the chunk is in flight before anything
//   waits, and the scores wait only for K. Rows past pos are not copied,
//   and are masked out of the scores and P V (their shared memory is
//   stale). cp.async and not TMA: a map would be encoded on the host for
//   every layer's cache view on every call, on a tick the host bounds;
// - the chunk's softmax in one pass from shared memory, in short chains:
//   scores by two threads a key (half of D each, two partial sums), the
//   chunk's max and sum by a warp a query row, P V by a thread a pair of
//   output columns over a quarter (D 64) or a half (D 128) of the keys,
//   the key groups' sums joined in shared memory; no global load per key.
//   The scratch beyond K and V is sized by rep, so more blocks share an
//   SM, and one query head per kv head has an instance of its own;
// - the merge in the same launch: a chunk's partial (m, l, acc[rep, D]) in
//   fp32 goes to a workspace, then the block takes a ticket for its
//   (slot, kv head) (an acq_rel atomic after the block's barrier); the
//   block that completes the count of live chunks (pos / CHUNK + 1)
//   merges their partials online, eight chunks' loads in flight at a time,
//   writes the output and resets the ticket to 0. A slot whose keys fit
//   one chunk writes its output directly. The ticket buffer is left zeroed
//   by every launch, and one buffer serves one stream at a time (the port
//   runs one).

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int CHUNK = 64;    // keys per block
constexpr int MAX_REP = 8;   // query heads per kv head
static_assert(THREADS == 2 * CHUNK, "two threads score each key");

// dtype codes: q / out (0 fp32, 1 bf16); the cache (0 q's type, 1 int8,
// 2 fp8-e4m3fn)
template <int TC>
struct QType;
template <>
struct QType<0> {
  typedef float type;
};
template <>
struct QType<1> {
  typedef __nv_bfloat16 type;
};
template <int TC, int KC>
struct CacheType {
  typedef typename QType<TC>::type type;
};
template <int TC>
struct CacheType<TC, 1> {
  typedef int8_t type;
};
template <int TC>
struct CacheType<TC, 2> {
  typedef __nv_fp8_e4m3 type;
};

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
    } else {
      static_assert(N == 2, "narrow loads of 2 or 16 values");
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
    } else {
      static_assert(N == 2, "bf16 loads of 2 or 8 values");
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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// add 1 to a ticket and return its old value: a release of the block's
// writes before it (after a barrier) and an acquire of the writes released
// by the tickets before it
__device__ __forceinline__ int ticket_add(int32_t* t) {
  int old;
  asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], 1;\n"
               : "=r"(old)
               : "l"(t)
               : "memory");
  return old;
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the block's shared memory: K rows and V rows (padded by 16 bytes, an odd
// number of 16-byte units a row), the key and value scales, then, sized by
// rep: q rows (fp32), scores then probabilities, each row's chunk max and
// sum, the P V key groups' sums
template <typename KT, int D>
struct Smem {
  static constexpr int ROW = D * (int)sizeof(KT) + 16;
  static constexpr int PIECES = D * (int)sizeof(KT) / 16;  // copies a row
  static constexpr int V = CHUNK * ROW;
  static constexpr int KS = 2 * V;
  static constexpr int VS = KS + CHUNK * 4;
  static constexpr int Q = VS + CHUNK * 4;
  // q, p, m, l and the P V groups' sums (2 THREADS / D of D each) of rep
  // query rows
  static constexpr int per_row() {
    return (D + CHUNK + 2) * 4 + 8 * THREADS;
  }
  static constexpr int bytes(int rep) { return Q + rep * per_row(); }
  static_assert((ROW / 16) % 2 == 1, "a padded row is an odd number of "
                                     "16-byte units");
};

template <int TC, int KC, int D, int REP>
__global__ void __launch_bounds__(THREADS)
decode_split(const typename QType<TC>::type* __restrict__ q,
             const typename CacheType<TC, KC>::type* __restrict__ kc,
             const typename CacheType<TC, KC>::type* __restrict__ vc,
             const float* __restrict__ ks, const float* __restrict__ vs,
             const int32_t* __restrict__ pos,
             typename QType<TC>::type* __restrict__ out,
             float* __restrict__ part, int32_t* __restrict__ tickets, int nH,
             int Hkv, int max_len, int n_chunks, float scale) {
  typedef typename QType<TC>::type T;
  typedef typename CacheType<TC, KC>::type KT;
  typedef Smem<KT, D> S;
  constexpr bool QUANT = KC != 0;
  constexpr int CH = 16 / (int)sizeof(KT);  // values per 16-byte read
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last;

  const int h = blockIdx.x, b = blockIdx.y;
  const int c0 = blockIdx.z * CHUNK;
  // a slot past the window (a frozen slot at pos == max_len) attends to
  // the whole window and reads nothing out of bounds
  const int p_b = min(max(pos[b], 0), max_len - 1);
  if (c0 > p_b) return;  // the chunk holds no visible key
  const int n = min(CHUNK, p_b - c0 + 1);
  const int live = p_b / CHUNK + 1;
  const int rep = REP == 1 ? 1 : nH / Hkv;
  const int tid = threadIdx.x;

  float* ks_s = reinterpret_cast<float*>(smem + S::KS);
  float* vs_s = reinterpret_cast<float*>(smem + S::VS);
  float* q_s = reinterpret_cast<float*>(smem + S::Q);
  float* p_s = q_s + rep * D;
  float* m_s = p_s + rep * CHUNK;
  float* l_s = m_s + rep;
  float* red_s = l_s + rep;  // [THREADS / (D / 2)][rep][D]

  // 1. the chunk's K rows (and both rows' scales), then its V rows, as two
  // groups of copies; q while they fly
  const size_t row = (size_t)Hkv * D;  // elements between cache rows
  const size_t first = ((size_t)b * max_len + c0) * row + (size_t)h * D;
  const unsigned char* kb = reinterpret_cast<const unsigned char*>(kc + first);
  const unsigned char* vb = reinterpret_cast<const unsigned char*>(vc + first);
  const size_t row_bytes = row * sizeof(KT);
  for (int e = tid; e < n * S::PIECES; e += THREADS) {
    const int j = e / S::PIECES, c = e % S::PIECES;
    cp_async16(smem + j * S::ROW + c * 16, kb + j * row_bytes + c * 16);
  }
  if constexpr (QUANT) {
    const size_t srow = (size_t)b * max_len + c0;
    for (int j = tid; j < n; j += THREADS) {
      cp_async4(ks_s + j, ks + srow + j);
      cp_async4(vs_s + j, vs + srow + j);
    }
  }
  cp_async_commit();
  for (int e = tid; e < n * S::PIECES; e += THREADS) {
    const int j = e / S::PIECES, c = e % S::PIECES;
    cp_async16(smem + S::V + j * S::ROW + c * 16, vb + j * row_bytes + c * 16);
  }
  cp_async_commit();
  const T* qb = q + ((size_t)b * nH + (size_t)h * rep) * D;
  for (int e = tid; e < rep * D; e += THREADS)
    q_s[e] = round_to<T>(to_f(qb[e]) * scale);
  cp_async_wait<1>();  // this thread's K copies have landed
  __syncthreads();     // and everyone's

  // 2. scores: two threads a key, each half of D for every row, two
  // partial sums each (short chains), joined by a shuffle
  {
    const int j = tid >> 1, half = tid & 1;
    float s[REP][2];
#pragma unroll
    for (int r = 0; r < REP; ++r) s[r][0] = s[r][1] = 0.f;
    if (j < n) {
      const KT* kr =
          reinterpret_cast<const KT*>(smem + j * S::ROW) + half * (D / 2);
      const float* qh = q_s + half * (D / 2);
#pragma unroll
      for (int c = 0; c < D / 2; c += CH) {
        float kf[CH];
        load_f<KT, CH>(kr + c, kf);
#pragma unroll
        for (int r = 0; r < REP; ++r) {
          if (r < rep) {
#pragma unroll
            for (int e = 0; e < CH; e += 4) {
              const float4 qv =
                  *reinterpret_cast<const float4*>(qh + r * D + c + e);
              float& a = s[r][(c / CH + e / 4) & 1];
              a += qv.x * kf[e];
              a += qv.y * kf[e + 1];
              a += qv.z * kf[e + 2];
              a += qv.w * kf[e + 3];
            }
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      if (r < rep) {
        float x = s[r][0] + s[r][1];
        x += __shfl_xor_sync(0xffffffffu, x, 1);
        if (half == 0 && j < n) p_s[r * CHUNK + j] = QUANT ? x * ks_s[j] : x;
      }
    }
  }
  __syncthreads();

  // 3. the chunk's softmax: a warp per query row. Key c0 is visible, so
  // the chunk's max is finite. l sums the unrounded probabilities.
  const int lane = tid & 31, warp = tid >> 5;
  for (int r = warp; r < rep; r += WARPS) {
    float x[CHUNK / 32];
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < CHUNK / 32; ++i) {
      const int j = lane + 32 * i;
      x[i] = j < n ? p_s[r * CHUNK + j] : -INFINITY;
      mx = fmaxf(mx, x[i]);
    }
    mx = warp_max(mx);
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < CHUNK / 32; ++i) {
      const int j = lane + 32 * i;
      const float p = j < n ? expf(x[i] - mx) : 0.f;
      sum += p;
      // the value row's scale, folded into its probability
      p_s[r * CHUNK + j] = QUANT ? p * (j < n ? vs_s[j] : 0.f)
                                 : round_to<T>(p);
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      m_s[r] = mx;
      l_s[r] = sum;
    }
  }
  cp_async_wait<0>();  // the V copies
  __syncthreads();

  // 4. P V: a thread owns output columns 2 cc, 2 cc + 1 of every row over
  // the keys of its group kg (kg, kg + G2, ...); the groups' sums meet in
  // shared memory, where a thread takes the columns of rows g2, g2 + G2, ...
  constexpr int CP = D / 2;
  constexpr int G2 = THREADS / CP;
  constexpr int RPT = (REP + G2 - 1) / G2;
  const int cc = tid % CP, g2 = tid / CP;
  {
    float a[REP][2];
#pragma unroll
    for (int r = 0; r < REP; ++r) a[r][0] = a[r][1] = 0.f;
#pragma unroll 4
    for (int j = g2; j < n; j += G2) {
      float vf[2];
      load_f<KT, 2>(reinterpret_cast<const KT*>(smem + S::V + j * S::ROW) +
                        2 * cc,
                    vf);
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        if (r < rep) {
          const float p = p_s[r * CHUNK + j];
          a[r][0] += p * vf[0];
          a[r][1] += p * vf[1];
        }
      }
    }
#pragma unroll
    for (int r = 0; r < REP; ++r)
      if (r < rep)
        *reinterpret_cast<float2*>(red_s + (g2 * rep + r) * D + 2 * cc) =
            make_float2(a[r][0], a[r][1]);
  }
  __syncthreads();
  float acc[RPT][2];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = g2 + i * G2;
    acc[i][0] = acc[i][1] = 0.f;
    if (r < rep) {
#pragma unroll
      for (int kg = 0; kg < G2; ++kg) {
        const float2 u = *reinterpret_cast<const float2*>(
            red_s + (kg * rep + r) * D + 2 * cc);
        acc[i][0] += u.x;
        acc[i][1] += u.y;
      }
    }
  }

  T* ob = out + ((size_t)b * nH + (size_t)h * rep) * D + 2 * cc;
  if (live == 1) {  // the slot's keys fit this chunk: no merge
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = g2 + i * G2;
      if (r < rep) {
        // key 0 is visible, so l >= exp(0) > 0
        ob[r * D] = from_f<T>(acc[i][0] / l_s[r]);
        ob[r * D + 1] = from_f<T>(acc[i][1] / l_s[r]);
      }
    }
    return;
  }

  // 5. the chunk's partial: acc [rep, D], then m [rep], then l [rep]
  const int stride = rep * (D + 2);  // floats a chunk's partial
  const int bh = b * Hkv + h;
  float* mine = part + ((size_t)bh * n_chunks + blockIdx.z) * stride;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = g2 + i * G2;
    if (r < rep)
      *reinterpret_cast<float2*>(mine + r * D + 2 * cc) =
          make_float2(acc[i][0], acc[i][1]);
  }
  if (tid < rep) {
    mine[rep * D + tid] = m_s[tid];
    mine[rep * D + rep + tid] = l_s[tid];
  }
  // the block's writes, then its ticket (a release at the GPU's scope
  // after the block's barrier covers every thread's writes)
  __syncthreads();
  if (tid == 0) {
    last = ticket_add(&tickets[bh]) == live - 1;
    if (last) tickets[bh] = 0;  // every live chunk has taken its ticket
  }
  __syncthreads();
  if (!last) return;

  // 6. the last chunk merges the live chunks' partials online, MERGE of
  // them at a time, whose loads are all in flight together (read past L1:
  // other blocks wrote them)
  constexpr int MERGE = 8;
  const float* all = part + (size_t)bh * n_chunks * stride;
#pragma unroll 1
  for (int i = 0; i < RPT; ++i) {
    const int r = g2 + i * G2;
    if (r >= rep) break;
    float mx = -INFINITY, l = 0.f, a0 = 0.f, a1 = 0.f;
    for (int z0 = 0; z0 < live; z0 += MERGE) {
      float mz[MERGE], lz[MERGE];
      float2 u[MERGE];
#pragma unroll
      for (int k = 0; k < MERGE; ++k) {
        const float* pz = all + (z0 + k) * stride;
        const bool in = z0 + k < live;
        mz[k] = in ? __ldcg(pz + rep * D + r) : -INFINITY;
        lz[k] = in ? __ldcg(pz + rep * D + rep + r) : 0.f;
        u[k] = in ? __ldcg(reinterpret_cast<const float2*>(pz + r * D +
                                                           2 * cc))
                  : make_float2(0.f, 0.f);
      }
      float mn = mx;
#pragma unroll
      for (int k = 0; k < MERGE; ++k) mn = fmaxf(mn, mz[k]);
      const float fo = expf(mx - mn);  // 0 on the first group
      l *= fo;
      a0 *= fo;
      a1 *= fo;
#pragma unroll
      for (int k = 0; k < MERGE; ++k) {
        const float f = expf(mz[k] - mn);  // 0 past the live chunks
        l += lz[k] * f;
        a0 += u[k].x * f;
        a1 += u[k].y * f;
      }
      mx = mn;
    }
    ob[r * D] = from_f<T>(a0 / l);
    ob[r * D + 1] = from_f<T>(a1 / l);
  }
}

template <int TC, int KC, int D, int REP>
int launch_rep(const void* q, const void* kc, const void* vc, const void* ks,
               const void* vs, const void* pos, void* out, void* part,
               void* tickets, int B, int nH, int Hkv, int max_len,
               int n_chunks, float scale, cudaStream_t stream) {
  typedef typename QType<TC>::type T;
  typedef typename CacheType<TC, KC>::type KT;
  static const int attr = static_cast<int>(cudaFuncSetAttribute(
      decode_split<TC, KC, D, REP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<KT, D>::bytes(REP)));
  if (attr) return attr;
  const int smem = Smem<KT, D>::bytes(nH / Hkv);
  const dim3 grid(Hkv, B, n_chunks);
  decode_split<TC, KC, D, REP><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const KT*>(kc),
      static_cast<const KT*>(vc), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int32_t*>(pos),
      static_cast<T*>(out), static_cast<float*>(part),
      static_cast<int32_t*>(tickets), nH, Hkv, max_len, n_chunks, scale);
  return static_cast<int>(cudaGetLastError());
}

// one query head per kv head (MHA) has an instance of its own, whose rows'
// loops know their bound when compiled (no branch per row); GQA takes the
// instance of up to MAX_REP rows
template <int TC, int KC, int D>
int launch(const void* q, const void* kc, const void* vc, const void* ks,
           const void* vs, const void* pos, void* out, void* part,
           void* tickets, int B, int nH, int Hkv, int max_len, int n_chunks,
           float scale, cudaStream_t stream) {
  if (nH == Hkv)
    return launch_rep<TC, KC, D, 1>(q, kc, vc, ks, vs, pos, out, part,
                                    tickets, B, nH, Hkv, max_len, n_chunks,
                                    scale, stream);
  return launch_rep<TC, KC, D, MAX_REP>(q, kc, vc, ks, vs, pos, out, part,
                                        tickets, B, nH, Hkv, max_len,
                                        n_chunks, scale, stream);
}

template <int TC, int KC>
int launch_d(const void* q, const void* kc, const void* vc, const void* ks,
             const void* vs, const void* pos, void* out, void* part,
             void* tickets, int B, int nH, int Hkv, int D, int max_len,
             int n_chunks, float scale, cudaStream_t s) {
  if (D == 64)
    return launch<TC, KC, 64>(q, kc, vc, ks, vs, pos, out, part, tickets, B,
                              nH, Hkv, max_len, n_chunks, scale, s);
  if (D == 128)
    return launch<TC, KC, 128>(q, kc, vc, ks, vs, pos, out, part, tickets, B,
                               nH, Hkv, max_len, n_chunks, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int TC>
int launch_kv(const void* q, const void* kc, const void* vc, const void* ks,
              const void* vs, const void* pos, void* out, void* part,
              void* tickets, int B, int nH, int Hkv, int D, int max_len,
              int n_chunks, int kv_code, float scale, cudaStream_t s) {
  if (kv_code == 0)
    return launch_d<TC, 0>(q, kc, vc, ks, vs, pos, out, part, tickets, B, nH,
                           Hkv, D, max_len, n_chunks, scale, s);
  if (ks == nullptr || vs == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (kv_code == 1)
    return launch_d<TC, 1>(q, kc, vc, ks, vs, pos, out, part, tickets, B, nH,
                           Hkv, D, max_len, n_chunks, scale, s);
  if (kv_code == 2)
    return launch_d<TC, 2>(q, kc, vc, ks, vs, pos, out, part, tickets, B, nH,
                           Hkv, D, max_len, n_chunks, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int TC>
int smem_kv(int kv_code, int D, int rep) {
  typedef typename CacheType<TC, 0>::type T;
  if (kv_code == 0)
    return D == 64 ? Smem<T, 64>::bytes(rep) : Smem<T, 128>::bytes(rep);
  return D == 64 ? Smem<int8_t, 64>::bytes(rep)
                 : Smem<int8_t, 128>::bytes(rep);
}

}  // namespace

// dtype_code (q, out): 0 = float32, 1 = bfloat16. kv_code (kc, vc): 0 =
// q's dtype, 1 = int8, 2 = float8_e4m3fn (quant mode: ks / vs are the
// [B, max_len] float32 row scales; unused, and may be null, when kv_code is
// 0). part: float32 workspace of B * Hkv * n_chunks * rep * (D + 2)
// values, n_chunks = ceil(max_len / 64); tickets: B * Hkv int32, zero
// before the launch and left zero by it (one stream at a time). Returns
// the cudaError_t of the launch (0 = success); cudaErrorInvalidValue for a
// shape or dtype the kernel does not take. Pointers are device pointers
// aligned to 16 bytes; q/out [B, nH, D], kc/vc [B, max_len, Hkv, D], pos
// [B] int32, all contiguous.
extern "C" int ragged_decode_attention(const void* q, const void* kc,
                                       const void* vc, const void* ks,
                                       const void* vs, const void* pos,
                                       void* out, void* part, void* tickets,
                                       int B, int nH, int Hkv, int D,
                                       int max_len, int dtype_code,
                                       int kv_code, float scale,
                                       void* stream) {
  const int n_chunks = (max_len + CHUNK - 1) / CHUNK;
  if (B < 1 || Hkv < 1 || max_len < 1 || nH % Hkv != 0 ||
      nH / Hkv > MAX_REP || B > 65535 || n_chunks > 65535 ||
      part == nullptr || tickets == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype_code == 0)
    return launch_kv<0>(q, kc, vc, ks, vs, pos, out, part, tickets, B, nH,
                        Hkv, D, max_len, n_chunks, kv_code, scale, s);
  if (dtype_code == 1)
    return launch_kv<1>(q, kc, vc, ks, vs, pos, out, part, tickets, B, nH,
                        Hkv, D, max_len, n_chunks, kv_code, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The dynamic shared memory one block of the (dtype_code, kv_code, D)
// instance asks for at rep query heads per kv head; 0 for an instance that
// does not exist.
extern "C" int ragged_decode_smem(int dtype_code, int kv_code, int D,
                                  int rep) {
  if ((D != 64 && D != 128) || kv_code < 0 || kv_code > 2 || rep < 1 ||
      rep > MAX_REP)
    return 0;
  if (dtype_code == 0) return smem_kv<0>(kv_code, D, rep);
  if (dtype_code == 1) return smem_kv<1>(kv_code, D, rep);
  return 0;
}
