// Split-KV decode attention (flash-decoding), shared by the slot-contiguous
// decode kernel (decode_attention.cu) and the paged one (paged_attention.cu).
//
// One block of THREADS threads owns one chunk of CHUNK keys of one (kv head,
// slot) and up to ROWS query rows of that kv head: row r is query position
// t = r / rep of query head h * rep + r % rep (rep = nH / Hkv; a decode tick
// has one position, so its rows are the rep heads of the kv head). The grid
// is (Hkv, B, n_chunks), fixed by the shapes alone, so a CUDA graph can
// capture it. Where the keys live, and which of them each row sees, is the
// Keys policy's:
//
// - SlotRows: the slot-contiguous cache [B, max_len, Hkv, D], one position
//   pos[b] per slot (a frozen slot at pos == max_len attends to the whole
//   window);
// - PagedRows (paged_attention.cu): the flat page pool [P, psz, Hkv, D]
//   through page_table [B, max_pages]; position t of the slot's chunk sits
//   at ctx[b] + t and sees keys [0, ctx[b] + t], clamped to the slot's last
//   page inside the table (rows at or past q_len are padding and see what
//   the last live row sees).
//
// A block whose chunk starts past the slot's last visible key exits before
// it reads anything, so the bytes read scale with the slot's position and
// never with the window. The others:
//
// 1. issue the chunk's K rows, then its V rows, as two groups of 16-byte
//    cp.async copies into shared memory (rows padded by 16 bytes, so 16-byte
//    reads of a column are free of bank conflicts); the cache row of each
//    copy is looked up before any copy is issued, so a page table costs one
//    round of loads, not one per copy. Rows past the chunk's last visible
//    key are not copied and are masked out of the scores and P V;
// 2. scores: two threads a key (half of D each, two partial sums);
// 3. the chunk's softmax: a warp a query row, each row masked at its own
//    limit (a row may see no key of a later chunk: its max is then -inf,
//    its sum 0);
// 4. P V: a thread a pair of output columns over a group of keys, the key
//    groups' sums joined in shared memory;
// 5. the merge in the same launch: a chunk's partial (m, l, acc[rows, D]) in
//    fp32 goes to a workspace, then the block takes a ticket for its (slot,
//    kv head) (an acq_rel atomic after the block's barrier); the block that
//    completes the count of live chunks merges their partials online, eight
//    chunks' loads in flight at a time, writes the output and resets the
//    ticket to 0. A slot whose keys fit one chunk writes its output
//    directly. The ticket buffer is left zeroed by every launch, and one
//    buffer serves one stream at a time.
//
// Numerics, as the TPU kernels: q is pre-scaled in its own dtype (qs =
// round_T(q * scale)); scores, the running max / sum and the accumulator
// are fp32; the unnormalised probabilities are rounded to T before P V
// (quant mode: kept fp32, with the value row's scale folded in); the output
// is acc / l rounded to T.
//
// Head dims: an instance is compiled at a width DP (32, 64 or 128,
// padded_dim below). An exact instance (EXACT, D == DP: the main path's 64
// and 128) knows D when compiled. A padded one takes any true D with D % 8
// == 0 and D <= DP at run time: shared-memory rows are DP wide, the copies
// of the pieces past D are zero-filled (cp.async's source size 0), so the
// scores and P V run over DP columns whose tail adds exact zeros, and
// columns past D are neither merged nor stored. A piece is PB bytes: 16,
// or 8 for a padded one-byte cache, whose head rows start on 8-byte
// boundaries only where D % 16 == 8.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int CHUNK = 64;    // keys per block
constexpr int MAX_ROWS = 8;  // query rows per block
constexpr int MAX_D = 128;   // the widest head dim an instance takes
static_assert(THREADS == 2 * CHUNK, "two threads score each key");

// the padded width whose instances serve head dim D (D % 8 == 0, 8 <= D <=
// MAX_D), 0 for a head dim no instance takes
__host__ __device__ constexpr int padded_dim(int D) {
  return D < 8 || D > MAX_D || D % 8 != 0 ? 0
         : D <= 32                         ? 32
         : D <= 64                         ? 64
                                           : 128;
}

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

// 16 bytes, of which the first n (0 or 16) are read and the rest zeroed
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 int n) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(n)
               : "memory");
}

// PB bytes (8 or 16), of which the first n (0 or PB) are read and the rest
// zeroed
template <int PB>
__device__ __forceinline__ void cp_async_zfill(void* dst, const void* src,
                                               int n) {
  if constexpr (PB == 16) {
    cp_async16_zfill(dst, src, n);
  } else {
    static_assert(PB == 8, "pieces of 8 or 16 bytes");
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src), "r"(n)
                 : "memory");
  }
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

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

// the slot-contiguous cache [B, max_len, Hkv, D]: one position a slot
struct SlotRows {
  const int32_t* pos;
  int max_len;

  struct View {
    int p;        // the slot's last visible key, for every row
    size_t base;  // the cache row of the slot's key 0
    __device__ __forceinline__ int lim(int) const { return p; }
    __device__ __forceinline__ size_t row(int key) const {
      return base + key;
    }
  };

  __device__ __forceinline__ View slot(int b, int) const {
    // a slot past the window (a frozen slot at pos == max_len) attends to
    // the whole window and reads nothing out of bounds
    return {min(max(pos[b], 0), max_len - 1), (size_t)b * max_len};
  }
};

// the block's shared memory: K rows and V rows of DP values (padded by 16
// bytes, an odd number of 16-byte units a row), the key and value scales,
// then, sized by the rows: q rows (fp32), scores then probabilities, each
// row's chunk max and sum, the P V key groups' sums
template <typename KT, int DP, int PB = 16>
struct Smem {
  static constexpr int ROW = DP * (int)sizeof(KT) + 16;
  static constexpr int PIECES = DP * (int)sizeof(KT) / PB;  // copies a row
  static constexpr int V = CHUNK * ROW;
  static constexpr int KS = 2 * V;
  static constexpr int VS = KS + CHUNK * 4;
  static constexpr int Q = VS + CHUNK * 4;
  // q, p, m, l and the P V groups' sums (2 THREADS / DP of DP each) of one
  // query row
  static constexpr int per_row() {
    return (DP + CHUNK + 2) * 4 + 8 * THREADS;
  }
  static constexpr int bytes(int rows) { return Q + rows * per_row(); }
  static_assert((ROW / 16) % 2 == 1, "a padded row is an odd number of "
                                     "16-byte units");
  static_assert(THREADS % PIECES == 0, "a thread copies one piece of rows");
};

// q / out [B, Tq, nH, D]; the cache kc / vc [rows, Hkv, D] as the Keys
// policy addresses it (ks / vs its rows' fp32 scales in quant mode); part:
// the fp32 workspace of B * Hkv * n_chunks * rows * (D + 2) values; tickets:
// B * Hkv int32, zero before the launch and left zero by it. d is the true
// head dim (d % 8 == 0, d <= DP; d * sizeof(KT) a multiple of PB), DP
// itself in an EXACT instance.
template <typename Keys, int TC, int KC, int DP, int ROWS, int PB, bool EXACT>
__global__ void __launch_bounds__(THREADS)
decode_split(const typename QType<TC>::type* __restrict__ q,
             const typename CacheType<TC, KC>::type* __restrict__ kc,
             const typename CacheType<TC, KC>::type* __restrict__ vc,
             const float* __restrict__ ks, const float* __restrict__ vs,
             Keys keys, typename QType<TC>::type* __restrict__ out,
             float* __restrict__ part, int32_t* __restrict__ tickets, int nH,
             int Hkv, int d, int Tq, int n_chunks, float scale) {
  const int D = EXACT ? DP : d;
  typedef typename QType<TC>::type T;
  typedef typename CacheType<TC, KC>::type KT;
  typedef Smem<KT, DP, PB> S;
  constexpr bool QUANT = KC != 0;
  constexpr int CH = 16 / (int)sizeof(KT);  // values per 16-byte read
  constexpr int PER = CHUNK * S::PIECES / THREADS;  // copies a thread
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last;

  const int h = blockIdx.x, b = blockIdx.y;
  const int c0 = blockIdx.z * CHUNK;
  const typename Keys::View view = keys.slot(b, Tq);
  const int kend = view.lim(Tq - 1);  // the last row's limit is the largest
  if (c0 > kend) return;              // the chunk holds no visible key
  const int n = min(CHUNK, kend - c0 + 1);
  const int live = kend / CHUNK + 1;
  const int rep = ROWS == 1 ? 1 : nH / Hkv;
  const int rows = ROWS == 1 ? 1 : Tq * rep;
  const int tid = threadIdx.x;

  float* ks_s = reinterpret_cast<float*>(smem + S::KS);
  float* vs_s = reinterpret_cast<float*>(smem + S::VS);
  float* q_s = reinterpret_cast<float*>(smem + S::Q);
  float* p_s = q_s + rows * DP;
  float* m_s = p_s + rows * CHUNK;
  float* l_s = m_s + rows;
  float* red_s = l_s + rows;  // [THREADS / (DP / 2)][rows][DP]

  // q / out row of block row r
  auto qrow = [&](int r) {
    return (((size_t)b * Tq + r / rep) * nH + (size_t)h * rep + r % rep) * D;
  };

  // 1. the cache rows of this thread's copies (each thread copies piece pc
  // of rows j0, j0 + THREADS / PIECES, ...; a piece past D is zero-filled),
  // then the chunk's K rows (and both rows' scales), then its V rows, as
  // two groups of copies; q while they fly
  const int pc = tid % S::PIECES, j0 = tid / S::PIECES;
  const int pb = pc * PB < D * (int)sizeof(KT) ? PB : 0;  // bytes read
  const size_t row_bytes = (size_t)Hkv * D * sizeof(KT);
  size_t off[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int j = j0 + i * (THREADS / S::PIECES);
    off[i] = j < n && pb ? view.row(c0 + j) * row_bytes + pc * PB : 0;
  }
  const unsigned char* kb =
      reinterpret_cast<const unsigned char*>(kc + (size_t)h * D);
  const unsigned char* vb =
      reinterpret_cast<const unsigned char*>(vc + (size_t)h * D);
  // a piece of one of the chunk's rows: read, or past D zero-filled
  auto copy = [&](unsigned char* dst, const unsigned char* src) {
    if constexpr (EXACT)
      cp_async16(dst, src);
    else
      cp_async_zfill<PB>(dst, src, pb);
  };
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int j = j0 + i * (THREADS / S::PIECES);
    if (j < n) copy(smem + j * S::ROW + pc * PB, kb + off[i]);
  }
  if constexpr (QUANT) {
    if (tid < n) {
      const size_t r = view.row(c0 + tid);
      cp_async4(ks_s + tid, ks + r);
      cp_async4(vs_s + tid, vs + r);
    }
  }
  cp_async_commit();
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int j = j0 + i * (THREADS / S::PIECES);
    if (j < n) copy(smem + S::V + j * S::ROW + pc * PB, vb + off[i]);
  }
  cp_async_commit();
  for (int e = tid; e < rows * DP; e += THREADS) {
    const int c = e % DP;
    q_s[e] = c < D ? round_to<T>(to_f(q[qrow(e / DP) + c]) * scale) : 0.f;
  }
  cp_async_wait<1>();  // this thread's K copies have landed
  __syncthreads();     // and everyone's

  // 2. scores: two threads a key, each half of DP for every row, two
  // partial sums each (short chains), joined by a shuffle
  {
    const int j = tid >> 1, half = tid & 1;
    float s[ROWS][2];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) s[r][0] = s[r][1] = 0.f;
    if (j < n) {
      const KT* kr =
          reinterpret_cast<const KT*>(smem + j * S::ROW) + half * (DP / 2);
      const float* qh = q_s + half * (DP / 2);
#pragma unroll
      for (int c = 0; c < DP / 2; c += CH) {
        float kf[CH];
        load_f<KT, CH>(kr + c, kf);
#pragma unroll
        for (int r = 0; r < ROWS; ++r) {
          if (r < rows) {
#pragma unroll
            for (int e = 0; e < CH; e += 4) {
              const float4 qv =
                  *reinterpret_cast<const float4*>(qh + r * DP + c + e);
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
    for (int r = 0; r < ROWS; ++r) {
      if (r < rows) {
        float x = s[r][0] + s[r][1];
        x += __shfl_xor_sync(0xffffffffu, x, 1);
        if (half == 0 && j < n) p_s[r * CHUNK + j] = QUANT ? x * ks_s[j] : x;
      }
    }
  }
  __syncthreads();

  // 3. the chunk's softmax: a warp per query row, keys j <= lr visible. A
  // row that sees no key of the chunk keeps m = -inf and l = 0; every row
  // sees key 0, so chunk 0's max is finite. l sums the unrounded
  // probabilities.
  const int lane = tid & 31, warp = tid >> 5;
  for (int r = warp; r < rows; r += WARPS) {
    const int lr = min(view.lim(r / rep) - c0, n - 1);
    float x[CHUNK / 32];
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < CHUNK / 32; ++i) {
      const int j = lane + 32 * i;
      x[i] = j <= lr ? p_s[r * CHUNK + j] : -INFINITY;
      mx = fmaxf(mx, x[i]);
    }
    mx = warp_max(mx);
    const float mu = mx == -INFINITY ? 0.f : mx;
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < CHUNK / 32; ++i) {
      const int j = lane + 32 * i;
      const float p = j <= lr ? expf(x[i] - mu) : 0.f;
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
  // (a pair past D is computed on zeros and never stored)
  constexpr int CP = DP / 2;
  constexpr int G2 = THREADS / CP;
  constexpr int RPT = (ROWS + G2 - 1) / G2;
  const int cc = tid % CP, g2 = tid / CP;
  {
    float a[ROWS][2];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) a[r][0] = a[r][1] = 0.f;
#pragma unroll 4
    for (int j = g2; j < n; j += G2) {
      float vf[2];
      load_f<KT, 2>(reinterpret_cast<const KT*>(smem + S::V + j * S::ROW) +
                        2 * cc,
                    vf);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        if (r < rows) {
          const float p = p_s[r * CHUNK + j];
          a[r][0] += p * vf[0];
          a[r][1] += p * vf[1];
        }
      }
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
      if (r < rows)
        *reinterpret_cast<float2*>(red_s + (g2 * rows + r) * DP + 2 * cc) =
            make_float2(a[r][0], a[r][1]);
  }
  __syncthreads();
  float acc[RPT][2];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = g2 + i * G2;
    acc[i][0] = acc[i][1] = 0.f;
    if (r < rows) {
#pragma unroll
      for (int kg = 0; kg < G2; ++kg) {
        const float2 u = *reinterpret_cast<const float2*>(
            red_s + (kg * rows + r) * DP + 2 * cc);
        acc[i][0] += u.x;
        acc[i][1] += u.y;
      }
    }
  }

  const bool mine_d = 2 * cc < D;  // this thread's columns are stored
  if (live == 1) {  // the slot's keys fit this chunk: no merge
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = g2 + i * G2;
      if (r < rows && mine_d) {
        // key 0 is visible, so l >= exp(0) > 0
        T* o = out + qrow(r) + 2 * cc;
        o[0] = from_f<T>(acc[i][0] / l_s[r]);
        o[1] = from_f<T>(acc[i][1] / l_s[r]);
      }
    }
    return;
  }

  // 5. the chunk's partial: acc [rows, D], then m [rows], then l [rows]
  const int stride = rows * (D + 2);  // floats a chunk's partial
  const int bh = b * Hkv + h;
  float* mine = part + ((size_t)bh * n_chunks + blockIdx.z) * stride;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = g2 + i * G2;
    if (r < rows && mine_d)
      *reinterpret_cast<float2*>(mine + r * D + 2 * cc) =
          make_float2(acc[i][0], acc[i][1]);
  }
  if (tid < rows) {
    mine[rows * D + tid] = m_s[tid];
    mine[rows * D + rows + tid] = l_s[tid];
  }
  // the block's writes, then its ticket (a release at the GPU's scope
  // after the block's barrier covers every thread's writes)
  __syncthreads();
  if (tid == 0) {
    last = ticket_add(&tickets[bh]) == live - 1;
    if (last) tickets[bh] = 0;  // every live chunk has taken its ticket
  }
  __syncthreads();
  if (!last || !mine_d) return;

  // 6. the last chunk merges the live chunks' partials online, MERGE of
  // them at a time, whose loads are all in flight together (read past L1:
  // other blocks wrote them). The first group holds chunk 0, whose max is
  // finite, so exp(-inf - mn) = 0 weighs a chunk a row does not see.
  constexpr int MERGE = 8;
  const float* all = part + (size_t)bh * n_chunks * stride;
#pragma unroll 1
  for (int i = 0; i < RPT; ++i) {
    const int r = g2 + i * G2;
    if (r >= rows) break;
    float mx = -INFINITY, l = 0.f, a0 = 0.f, a1 = 0.f;
    for (int z0 = 0; z0 < live; z0 += MERGE) {
      float mz[MERGE], lz[MERGE];
      float2 u[MERGE];
#pragma unroll
      for (int k = 0; k < MERGE; ++k) {
        const float* pz = all + (z0 + k) * stride;
        const bool in = z0 + k < live;
        mz[k] = in ? __ldcg(pz + rows * D + r) : -INFINITY;
        lz[k] = in ? __ldcg(pz + rows * D + rows + r) : 0.f;
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
    T* o = out + qrow(r) + 2 * cc;
    o[0] = from_f<T>(a0 / l);
    o[1] = from_f<T>(a1 / l);
  }
}

// the launch of one instance: its dynamic shared memory at this launch's
// rows (the attribute set once, at the instance's largest)
template <typename Keys, int TC, int KC, int DP, int ROWS, int PB, bool EXACT>
int launch_split(const void* q, const void* kc, const void* vc, const void* ks,
                 const void* vs, Keys keys, void* out, void* part,
                 void* tickets, int B, int nH, int Hkv, int D, int Tq,
                 int n_chunks, float scale, cudaStream_t stream) {
  typedef typename QType<TC>::type T;
  typedef typename CacheType<TC, KC>::type KT;
  typedef Smem<KT, DP, PB> S;
  static const int attr = static_cast<int>(cudaFuncSetAttribute(
      decode_split<Keys, TC, KC, DP, ROWS, PB, EXACT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, S::bytes(ROWS)));
  if (attr) return attr;
  const int rows = ROWS == 1 ? 1 : Tq * (nH / Hkv);
  const dim3 grid(Hkv, B, n_chunks);
  decode_split<Keys, TC, KC, DP, ROWS, PB, EXACT>
      <<<grid, THREADS, S::bytes(rows), stream>>>(
          static_cast<const T*>(q), static_cast<const KT*>(kc),
          static_cast<const KT*>(vc), static_cast<const float*>(ks),
          static_cast<const float*>(vs), keys, static_cast<T*>(out),
          static_cast<float*>(part), static_cast<int32_t*>(tickets), nH, Hkv,
          D, Tq, n_chunks, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
