// Ragged attention over a paged KV pool: decode ticks and prefill chunks.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/paged_attention.py
// (ragged_paged_attention, kernel body _make_kernel).
//
// Slot b carries Tq query rows; row t sits at virtual position
// ctx[b] + t and attends keys [0, ctx[b] + t]. Key j of the slot lives in
// row j % psz of physical page page_table[b, j / psz] of the flat pool
// kp/vp [P, psz, Hkv, D]: masking is in virtual positions, whatever page
// backs them. GQA: rep = nH / Hkv query heads per kv head, never repeated;
// the rows of a kv head are taken in kv-head-major order (row = t * rep +
// r), so every row of a block shares the block's K and V.
//
// Conventions, as the TPU kernel: q is pre-scaled in its own dtype
// (qs = round_T(q * scale)); scores, the running max / sum and the
// accumulator are fp32; the unnormalised probabilities are rounded to T
// before the P @ V product, which accumulates in fp32; the output is
// acc / l rounded to T, normalised once at the end. Rows at or past q_len
// are padding: they see what the last live row sees and stay finite.
//
// The read bound: a slot reads pages 0 .. last only, with
// last = min((ctx + q_len - 1) / psz, max_pages - 1), so reads scale with
// the slot's position and never touch the table past max_pages (a frozen
// slot may sit at ctx == max_len). The TPU kernel gets the same from the
// clamp in its BlockSpec index map.
//
// What bounds it on the H100, and the design: two families in one source,
// chosen from the shape alone (Tq * rep rows per (slot, kv head)).
//
// - Decode, Tq * rep <= 8 (a tick: one position, the rep heads of a kv
//   head): latency. Each (slot, kv head) reads its visible K and V rows
//   once, about 1 flop per byte, and at the serving shape the bytes take
//   ~0.0017 ms at 3.35 TB/s, less than one trip to device memory and back
//   plus a launch; the first version's 96 blocks (one a (kv head, slot))
//   each walked up to 24 pages in turn, waiting on each tile's loads. So
//   this family is the split-KV kernel of split_kv.cuh (also the
//   slot-contiguous decode's): one block a 64-key chunk, grid (Hkv, B,
//   ceil(max_pages * psz / 64)), the chunk's pages looked up once (4 pages
//   at psz 16; inside one page when psz > 64), K then V staged by cp.async,
//   the chunks merged in the same launch by tickets. A block whose chunk
//   starts past the slot's last visible key exits before any read.
// - Prefill, Tq * rep > 8, bf16 (an admit: up to max_len rows against up
//   to max_len keys a kv head): the first version's CUDA-core dot products,
//   one
//   key a lane, bound it. Here the products run on tensor cores
//   (mma.sync m16n8k16, bf16 in, fp32 accumulate): one block of four warps
//   a (kv head, slot, 64 rows), each warp 16 rows; K and V gathered 64 keys
//   at a time, page by page, by cp.async into a two-stage ring (keys past
//   the block's last visible one zero-filled); q fragments kept in
//   registers (ldmatrix); S = q k^T, the causal mask per row in virtual
//   positions, the online softmax in registers and in base 2 (each row's
//   max and sum over the quad of lanes that holds it), P rounded to bf16
//   in the same registers as the A operand of P V (V through
//   ldmatrix.trans). A block
//   walks keys only up to its last row's limit, a warp computes only the
//   tiles its rows see, and masks only tiles that pass its first row's
//   limit. mma.sync and not wgmma: at the serving admit the work is small
//   (256 rows x <= 384 keys a head) and latency, not the tensor-core rate,
//   bounds it: an admit's 48 blocks leave one warp on each SM quarter,
//   whose dependent steps show in full (32-row tiles, twice the blocks,
//   measured slower). Nothing in it depends on Tq but the grid's z extent
//   (one block a 64 rows), so it serves any Tq up to 64 x 65535 rows a kv
//   head; a long chunk's blocks each walk their keys alone.
// - Prefill in fp32 (no engine caller): tensor cores would make it TF32,
//   so it keeps the first version's CUDA-core kernel: one block a (kv head,
//   slot, 8 rows), the warps splitting the key tiles, merged at the end.
//
// Head dims: every D % 8 == 0 up to 128. The main path's 64 and 128 have
// exact instances (D known when compiled); the others take instances at
// the padded widths of split_kv.cuh (32, 64, 128; the fp32 prefill at 64
// and 128, a lane owning two or four columns) with the true D at run time.
// Pieces of K and V past D are zero-filled by cp.async's source size, q's
// are zeros, so the padded columns add exact zeros to the scores; a bf16
// prefill skips the k16 steps and n16 tiles wholly past D, and no column
// past D is stored.

#include "split_kv.cuh"

namespace {

// the flat page pool [P, psz, Hkv, D] through page_table [B, max_pages]
struct PagedRows {
  const int32_t* pt;
  const int32_t* ctx;
  const int32_t* qlen;  // null: every row live
  int psz, P, max_pages;

  struct View {
    const int32_t* pt;  // the slot's row of the page table
    int ctx, last_t, kmax, psz, P;
    // the last key position t sees; rows past q_len see the last live
    // row's keys, and no row reads past the slot's last page in the table
    __device__ __forceinline__ int lim(int t) const {
      return min(ctx + min(t, last_t), kmax);
    }
    __device__ __forceinline__ size_t row(int key) const {
      const int phys = min(max(pt[key / psz], 0), P - 1);
      return (size_t)phys * psz + key % psz;
    }
  };

  __device__ __forceinline__ View slot(int b, int Tq) const {
    const int c = max(ctx[b], 0);
    const int ql = qlen ? min(max(qlen[b], 1), Tq) : Tq;
    const int last = min((c + ql - 1) / psz, max_pages - 1);
    return {pt + (size_t)b * max_pages, c, ql - 1, last * psz + psz - 1, psz,
            P};
  }
};

// ---------------------------------------------------------------------------
// bf16 prefill on tensor cores
// ---------------------------------------------------------------------------

constexpr int PF_WARPS = 4;
constexpr int PF_THREADS = PF_WARPS * 32;
constexpr int PF_ROWS = 16 * PF_WARPS;  // query rows a block
constexpr int PF_KEYS = 64;             // keys a tile

// q rows, then two stages of K rows, then two of V rows, DP values each;
// rows padded by 16 bytes, so the eight 16-byte rows of an ldmatrix land in
// distinct banks
template <int DP>
struct PfSmem {
  static constexpr int ROW = DP * 2 + 16;
  static constexpr int PIECES = DP * 2 / 16;  // 16-byte copies a row
  static constexpr int K = PF_ROWS * ROW;
  static constexpr int V = K + 2 * PF_KEYS * ROW;
  static constexpr int BYTES = V + 2 * PF_KEYS * ROW;
  static_assert(PF_THREADS % PIECES == 0, "a thread copies one piece");
};

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// c += a b: a the m16 x k16 bf16 A fragment, b0/b1 the k16 x n8 B fragment
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two fp32 rounded to bf16, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int DP, bool EXACT>
__global__ void __launch_bounds__(PF_THREADS)
paged_prefill(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ kp,
              const __nv_bfloat16* __restrict__ vp, PagedRows keys,
              __nv_bfloat16* __restrict__ out, int Tq, int nH, int Hkv,
              int d, float scale) {
  const int D = EXACT ? DP : d;  // the true head dim
  typedef PfSmem<DP> S;
  constexpr int KD = DP / 16;  // k-steps of q k^T (past D: skipped)
  constexpr int ND = DP / 8;   // n-tiles of the output
  constexpr int PER = PF_KEYS * S::PIECES / PF_THREADS;  // copies a thread
  extern __shared__ __align__(16) unsigned char smem[];

  const int h = blockIdx.x, b = blockIdx.y, row0 = blockIdx.z * PF_ROWS;
  const int rep = nH / Hkv, rows = Tq * rep;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const PagedRows::View view = keys.slot(b, Tq);
  // a row's limit (rows past the slot's last take its limit: finite)
  auto lim_of = [&](int r) { return view.lim(min(r, rows - 1) / rep); };
  const int kend = lim_of(row0 + PF_ROWS - 1);  // the block's last key
  const int n_tiles = kend / PF_KEYS + 1;
  auto qrow = [&](int r) {
    return (((size_t)b * Tq + r / rep) * nH + (size_t)h * rep + r % rep) * D;
  };

  // a tile's K and V rows, piece pc of key rows j0, j0 + PF_THREADS /
  // PIECES, ...: the pages looked up first, then the copies (keys past
  // kend and pieces past D zero-filled: they score 0 and are masked or add
  // 0; V's zeros keep P V finite)
  const int pc = tid % S::PIECES, j0 = tid / S::PIECES;
  const bool in_d = pc * 8 < D;  // the piece's 8 columns hold values
  const size_t row_bytes = (size_t)Hkv * D * 2;
  const unsigned char* kb =
      reinterpret_cast<const unsigned char*>(kp + (size_t)h * D) +
      (in_d ? pc * 16 : 0);
  const unsigned char* vb =
      reinterpret_cast<const unsigned char*>(vp + (size_t)h * D) +
      (in_d ? pc * 16 : 0);
  auto load_tile = [&](int kt, int stage) {
    size_t off[PER];
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int key = kt * PF_KEYS + j0 + i * (PF_THREADS / S::PIECES);
      off[i] = key <= kend && in_d ? view.row(key) * row_bytes : 0;
    }
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int j = j0 + i * (PF_THREADS / S::PIECES);
      cp_async16_zfill(
          smem + S::K + (stage * PF_KEYS + j) * S::ROW + pc * 16,
          kb + off[i], kt * PF_KEYS + j <= kend && in_d ? 16 : 0);
    }
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int j = j0 + i * (PF_THREADS / S::PIECES);
      cp_async16_zfill(
          smem + S::V + (stage * PF_KEYS + j) * S::ROW + pc * 16,
          vb + off[i], kt * PF_KEYS + j <= kend && in_d ? 16 : 0);
    }
    cp_async_commit();
  };
  load_tile(0, 0);

  // q rows pre-scaled in bf16 (rows past the slot's last and columns past
  // D are zeros), then each warp's 16 rows as A fragments
  for (int e = tid; e < PF_ROWS * S::PIECES; e += PF_THREADS) {
    const int i = e / S::PIECES, c = e % S::PIECES;
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + i < rows && c * 8 < D) {
      const uint4 x =
          *reinterpret_cast<const uint4*>(q + qrow(row0 + i) + c * 8);
      u.x = pack_bf16(bf16_lo(x.x) * scale, bf16_hi(x.x) * scale);
      u.y = pack_bf16(bf16_lo(x.y) * scale, bf16_hi(x.y) * scale);
      u.z = pack_bf16(bf16_lo(x.z) * scale, bf16_hi(x.z) * scale);
      u.w = pack_bf16(bf16_lo(x.w) * scale, bf16_hi(x.w) * scale);
    }
    *reinterpret_cast<uint4*>(smem + i * S::ROW + c * 16) = u;
  }
  __syncthreads();
  uint32_t qa[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
    qa[kk][0] = qa[kk][1] = qa[kk][2] = qa[kk][3] = 0u;
    if (kk * 16 < D)
      ldsm_x4(qa[kk], smem + (warp * 16 + (lane & 15)) * S::ROW +
                          (kk * 16 + (lane >> 4) * 8) * 2);
  }

  // this thread's rows: g and g + 8 of the warp's 16
  const int wr0 = row0 + warp * 16;
  const bool wlive = wr0 < rows;
  const int lim0 = lim_of(wr0 + g), lim1 = lim_of(wr0 + g + 8);
  const int wlo = lim_of(wr0), whi = lim_of(wr0 + 15);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[ND][4];
#pragma unroll
  for (int dn = 0; dn < ND; ++dn) o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;

  for (int kt = 0; kt < n_tiles; ++kt) {
    if (kt + 1 < n_tiles) {
      load_tile(kt + 1, (kt + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int k0 = kt * PF_KEYS;
    if (wlive && k0 <= whi) {
      const unsigned char* kst = smem + S::K + (kt & 1) * PF_KEYS * S::ROW;
      const unsigned char* vst = smem + S::V + (kt & 1) * PF_KEYS * S::ROW;
      // S = q k^T: 8 n-tiles of 8 keys
      float s[8][4];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int n2 = 0; n2 < 4; ++n2) {
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
          if (kk * 16 >= D) break;  // the k16 steps wholly past D
          uint32_t kf[4];
          ldsm_x4(kf, kst + (n2 * 16 + (lane & 7) + ((lane >> 4) << 3)) *
                                S::ROW +
                          (kk * 16 + ((lane >> 3) & 1) * 8) * 2);
          mma_bf16(s[2 * n2], qa[kk], kf[0], kf[1]);
          mma_bf16(s[2 * n2 + 1], qa[kk], kf[2], kf[3]);
        }
      }
      // the scores in base 2 (exp2 is one MUFU operation, exp is not), and
      // the causal mask, per row, where the tile passes the warp's first
      // row's limit (keys past kend included)
      const bool edge = k0 + PF_KEYS - 1 > wlo;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + nt * 8 + 2 * tq + (e & 1);
          s[nt][e] = edge && key > (e < 2 ? lim0 : lim1)
                         ? -INFINITY
                         : s[nt][e] * 1.44269504088896341f;
        }
      }
      // the online softmax of rows g (e 0, 1) and g + 8 (e 2, 3), in base
      // 2; every row sees key 0, so after tile 0 each row's max is finite
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        float mx = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
          mx = fmaxf(mx, fmaxf(s[nt][2 * hr], s[nt][2 * hr + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float mn = fmaxf(m[hr], mx);
        const float mu = mn == -INFINITY ? 0.f : mn;
        const float alpha = exp2f(m[hr] - mu);  // 0 on a row's first tile
        float rs = 0.f;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const float p0 = exp2f(s[nt][2 * hr] - mu);
          const float p1 = exp2f(s[nt][2 * hr + 1] - mu);
          s[nt][2 * hr] = p0;
          s[nt][2 * hr + 1] = p1;
          rs += p0 + p1;
        }
        l[hr] = l[hr] * alpha + rs;  // this lane's share of the row's sum
        m[hr] = mn;
#pragma unroll
        for (int dn = 0; dn < ND; ++dn) {
          o[dn][2 * hr] *= alpha;
          o[dn][2 * hr + 1] *= alpha;
        }
      }
      // O += P V: P rounded to bf16 as the A operand, 16 keys a k-step
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int dn = 0; dn < ND / 2; ++dn) {
          if (dn * 16 >= D) break;  // the n16 tiles wholly past D
          uint32_t vf[4];
          ldsm_x4_t(vf, vst + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                  S::ROW +
                            (dn * 16 + (lane >> 4) * 8) * 2);
          mma_bf16(o[2 * dn], pa, vf[0], vf[1]);
          mma_bf16(o[2 * dn + 1], pa, vf[2], vf[3]);
        }
      }
    }
    __syncthreads();  // the stage is refilled by the next tile's copies
  }

  // each row's sum over its quad of lanes, then acc / l rounded to bf16
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 1);
    l[hr] += __shfl_xor_sync(0xffffffffu, l[hr], 2);
  }
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int r = wr0 + g + 8 * hr;
    if (r < rows) {
      __nv_bfloat16* dst = out + qrow(r) + 2 * tq;
#pragma unroll
      for (int dn = 0; dn < ND; ++dn)
        if (dn * 8 < D)
          *reinterpret_cast<uint32_t*>(dst + dn * 8) =
              pack_bf16(o[dn][2 * hr] / l[hr], o[dn][2 * hr + 1] / l[hr]);
    }
  }
}

// ---------------------------------------------------------------------------
// fp32 prefill on CUDA cores (the first version's kernel)
// ---------------------------------------------------------------------------

constexpr int CC_WARPS = 8;
constexpr int CC_THREADS = CC_WARPS * 32;
constexpr int CC_TILE = 32;  // keys per warp step: one lane per key
constexpr int CC_ROWS = 8;   // query rows per block

// one block per (kv head, slot, group of CC_ROWS rows); its warps split the
// key tiles round-robin (lane t owns key t0 + t: it looks its physical row
// up in the page table and dots it with the rows' q in shared memory; for
// P V lane t owns DP / 32 output columns), each warp keeps its own online
// softmax state in registers, and the warps merge once at the end; d <= DP
// is the true head dim (a lane whose columns lie past it reads nothing), DP
// itself in an EXACT instance
template <int DP, bool EXACT>
__global__ void __launch_bounds__(CC_THREADS, 2)
paged_prefill_fp32(const float* __restrict__ q, const float* __restrict__ kp,
                   const float* __restrict__ vp, PagedRows keys,
                   float* __restrict__ out, int Tq, int nH, int Hkv, int d,
                   float scale) {
  const int D = EXACT ? DP : d;
  constexpr int CH = 4;        // values per 16-byte key load
  constexpr int DL = DP / 32;  // output columns per lane
  __shared__ __align__(16) float q_s[CC_ROWS][DP];
  __shared__ float p_s[CC_WARPS][CC_ROWS][CC_TILE];
  __shared__ size_t krow_s[CC_WARPS][CC_TILE];
  __shared__ float m_w[CC_WARPS][CC_ROWS];
  __shared__ float l_w[CC_WARPS][CC_ROWS];
  __shared__ float acc_w[CC_WARPS][CC_ROWS][DP];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int row0 = blockIdx.z * CC_ROWS;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rep = nH / Hkv;
  const int nr = min(CC_ROWS, Tq * rep - row0);  // rows of this block
  const PagedRows::View view = keys.slot(b, Tq);

  // out[b, t, h * rep + r] for block row i, with t * rep + r = row0 + i
  auto out_off = [&](int i) {
    const int row = row0 + i;
    return (((size_t)b * Tq + row / rep) * nH + h * rep + row % rep) * D;
  };
  int lim[CC_ROWS];
#pragma unroll
  for (int i = 0; i < CC_ROWS; ++i)
    lim[i] = view.lim((row0 + min(i, nr - 1)) / rep);
  const int kend = lim[CC_ROWS - 1];  // the last row's limit is the largest

  for (int e = tid; e < nr * DP; e += CC_THREADS) {
    const int c = e % DP;
    q_s[e / DP][c] = c < D ? q[out_off(e / DP) + c] * scale : 0.f;
  }
  __syncthreads();

  const size_t row_stride = (size_t)Hkv * D;  // elements between pool rows
  const bool lane_d = lane * DL < D;  // this lane's output columns hold values
  const float* kb = kp + (size_t)h * D;
  const float* vb = vp + (size_t)h * D + (lane_d ? lane * DL : 0);
  const int n_tiles = kend / CC_TILE + 1;

  float m[CC_ROWS], l[CC_ROWS], acc[CC_ROWS][DL];
#pragma unroll
  for (int i = 0; i < CC_ROWS; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < DL; ++e) acc[i][e] = 0.f;
  }

  for (int j = warp; j < n_tiles; j += CC_WARPS) {
    const int t0 = j * CC_TILE;
    const int key = t0 + lane;
    const bool in_range = key <= kend;
    const size_t krow = in_range ? view.row(key) : 0;
    krow_s[warp][lane] = krow;
    // scores: lane owns one key
    float s[CC_ROWS];
#pragma unroll
    for (int i = 0; i < CC_ROWS; ++i) s[i] = 0.f;
    if (in_range) {
      const float* kr = kb + krow * row_stride;
#pragma unroll
      for (int c = 0; c < DP; c += CH) {
        if (c >= D) break;
        float kf[CH];
        load_f<float, CH>(kr + c, kf);
#pragma unroll
        for (int i = 0; i < CC_ROWS; ++i) {
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
    float alpha[CC_ROWS];
#pragma unroll
    for (int i = 0; i < CC_ROWS; ++i) {
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
        p_s[warp][i][lane] = p;
      }
    }
    __syncwarp();
    // P @ V: lane owns DL output columns
#pragma unroll
    for (int i = 0; i < CC_ROWS; ++i) {
      if (i < nr) {
#pragma unroll
        for (int e = 0; e < DL; ++e) acc[i][e] *= alpha[i];
      }
    }
    const int n_keys = min(CC_TILE, kend - t0 + 1);
#pragma unroll 4
    for (int t = 0; t < n_keys; ++t) {
      float vf[DL];
      if (lane_d) {
        load_f<float, DL>(vb + krow_s[warp][t] * row_stride, vf);
      } else {
#pragma unroll
        for (int e = 0; e < DL; ++e) vf[e] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < CC_ROWS; ++i) {
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
  for (int i = 0; i < CC_ROWS; ++i) {
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
  for (int e = tid; e < nr * D; e += CC_THREADS) {
    const int i = e / D, d = e % D;
    float mx = m_w[0][i];
    for (int w = 1; w < CC_WARPS; ++w) mx = fmaxf(mx, m_w[w][i]);
    float lsum = 0.f, a = 0.f;
    for (int w = 0; w < CC_WARPS; ++w) {
      const float f = expf(m_w[w][i] - mx);
      lsum += l_w[w][i] * f;
      a += acc_w[w][i][d] * f;
    }
    out[out_off(i) + d] = a / lsum;  // lsum >= exp(0) > 0
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <int TC, int DP, bool EXACT>
int launch_decode(const void* q, const void* kp, const void* vp,
                  PagedRows keys, void* out, void* part, void* tickets, int B,
                  int Tq, int nH, int Hkv, int D, int n_chunks, float scale,
                  cudaStream_t s) {
  if constexpr (EXACT) {  // one row a (slot, kv head): its own instance
    if (Tq * (nH / Hkv) == 1)
      return launch_split<PagedRows, TC, 0, DP, 1, 16, true>(
          q, kp, vp, nullptr, nullptr, keys, out, part, tickets, B, nH, Hkv,
          D, Tq, n_chunks, scale, s);
  }
  return launch_split<PagedRows, TC, 0, DP, MAX_ROWS, 16, EXACT>(
      q, kp, vp, nullptr, nullptr, keys, out, part, tickets, B, nH, Hkv, D,
      Tq, n_chunks, scale, s);
}

// blocks of a prefill launch along z: one a PF_ROWS (bf16) or CC_ROWS
// (fp32) rows of a kv head
inline long long prefill_blocks(int dtype_code, long long rows) {
  const int per = dtype_code == 1 ? PF_ROWS : CC_ROWS;
  return (rows + per - 1) / per;
}

template <int DP, bool EXACT>
int launch_prefill(const void* q, const void* kp, const void* vp,
                   PagedRows keys, void* out, int B, int Tq, int nH, int Hkv,
                   int D, float scale, cudaStream_t s) {
  static const int attr = static_cast<int>(
      cudaFuncSetAttribute(paged_prefill<DP, EXACT>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           PfSmem<DP>::BYTES));
  if (attr) return attr;
  const dim3 grid(Hkv, B, (int)prefill_blocks(1, (long long)Tq * (nH / Hkv)));
  paged_prefill<DP, EXACT><<<grid, PF_THREADS, PfSmem<DP>::BYTES, s>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(kp),
      static_cast<const __nv_bfloat16*>(vp), keys,
      static_cast<__nv_bfloat16*>(out), Tq, nH, Hkv, D, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int DP, bool EXACT>
int launch_prefill_fp32(const void* q, const void* kp, const void* vp,
                        PagedRows keys, void* out, int B, int Tq, int nH,
                        int Hkv, int D, float scale, cudaStream_t s) {
  const dim3 grid(Hkv, B, (int)prefill_blocks(0, (long long)Tq * (nH / Hkv)));
  paged_prefill_fp32<DP, EXACT><<<grid, CC_THREADS, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(kp),
      static_cast<const float*>(vp), keys, static_cast<float*>(out), Tq, nH,
      Hkv, D, scale);
  return static_cast<int>(cudaGetLastError());
}

// the instances of width DP: EXACT when D == DP
template <int DP, bool EXACT>
int launch_d(const void* q, const void* kp, const void* vp, PagedRows keys,
             void* out, void* part, void* tickets, int B, int Tq, int nH,
             int Hkv, int D, int n_chunks, int dtype_code, float scale,
             cudaStream_t s) {
  if (Tq * (nH / Hkv) <= MAX_ROWS) {
    if (part == nullptr || tickets == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    if (dtype_code == 0)
      return launch_decode<0, DP, EXACT>(q, kp, vp, keys, out, part, tickets,
                                         B, Tq, nH, Hkv, D, n_chunks, scale,
                                         s);
    return launch_decode<1, DP, EXACT>(q, kp, vp, keys, out, part, tickets, B,
                                       Tq, nH, Hkv, D, n_chunks, scale, s);
  }
  if (dtype_code == 1)
    return launch_prefill<DP, EXACT>(q, kp, vp, keys, out, B, Tq, nH, Hkv, D,
                                     scale, s);
  // the fp32 prefill's lanes own DP / 32 columns, two at least
  constexpr int DF = DP < 64 ? 64 : DP;
  return launch_prefill_fp32<DF, EXACT>(q, kp, vp, keys, out, B, Tq, nH, Hkv,
                                        D, scale, s);
}

}  // namespace

// dtype_code: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the
// launch (0 = success); cudaErrorInvalidValue for a shape or dtype the
// kernel does not take. Device pointers, all contiguous, q/kp/vp/out
// aligned to 16 bytes: q/out [B, Tq, nH, D], kp/vp [P, psz, Hkv, D],
// page_table [B, max_pages] int32, ctx [B] int32, qlen [B] int32 or null
// (every row live); D % 8 == 0 and 8 <= D <= 128; any Tq >= 1 whose Tq *
// nH / Hkv rows a kv head need at most 65535 prefill blocks (8 rows a block
// in fp32, 64 in bf16). The decode family (Tq * nH / Hkv <= 8) needs part,
// a float32 workspace of B * Hkv * n_chunks * Tq * (nH / Hkv) * (D + 2)
// values with n_chunks = ceil(max_pages * psz / 64), and tickets, B * Hkv
// int32, zero before the launch and left zero by it (one stream at a
// time); the prefill families take neither (null).
extern "C" int ragged_paged_attention(const void* q, const void* kp,
                                      const void* vp, const void* page_table,
                                      const void* ctx, const void* qlen,
                                      void* out, void* part, void* tickets,
                                      int B, int Tq, int nH, int Hkv, int D,
                                      int psz, int P, int max_pages,
                                      int dtype_code, float scale,
                                      void* stream) {
  const long long window = (long long)max_pages * psz;
  const long long n_chunks = (window + CHUNK - 1) / CHUNK;
  if (B < 1 || B > 65535 || Tq < 1 || Hkv < 1 || nH % Hkv != 0 ||
      nH / Hkv > MAX_ROWS || psz < 1 || psz % 8 != 0 || P < 1 ||
      max_pages < 1 || (long long)P * psz > 0x7fffffffLL ||
      window > 0x7fffffffLL || n_chunks > 65535 ||
      (dtype_code != 0 && dtype_code != 1) ||
      prefill_blocks(dtype_code, (long long)Tq * (nH / Hkv)) > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const PagedRows keys{static_cast<const int32_t*>(page_table),
                       static_cast<const int32_t*>(ctx),
                       static_cast<const int32_t*>(qlen), psz, P, max_pages};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nc = (int)n_chunks;
  if (D == 64)
    return launch_d<64, true>(q, kp, vp, keys, out, part, tickets, B, Tq, nH,
                              Hkv, D, nc, dtype_code, scale, s);
  if (D == 128)
    return launch_d<128, true>(q, kp, vp, keys, out, part, tickets, B, Tq,
                               nH, Hkv, D, nc, dtype_code, scale, s);
  const int dp = padded_dim(D);
  if (dp == 32)
    return launch_d<32, false>(q, kp, vp, keys, out, part, tickets, B, Tq,
                               nH, Hkv, D, nc, dtype_code, scale, s);
  if (dp == 64)
    return launch_d<64, false>(q, kp, vp, keys, out, part, tickets, B, Tq,
                               nH, Hkv, D, nc, dtype_code, scale, s);
  if (dp == 128)
    return launch_d<128, false>(q, kp, vp, keys, out, part, tickets, B, Tq,
                                nH, Hkv, D, nc, dtype_code, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The dynamic shared memory one block of the instance that serves
// (dtype_code, D, rows = Tq * nH / Hkv) asks for; 0 for the fp32 prefill
// (static shared memory only) and for a shape the kernel does not take.
extern "C" int ragged_paged_smem(int dtype_code, int D, int rows) {
  const int dp = padded_dim(D);
  if (dp == 0 || (dtype_code != 0 && dtype_code != 1) || rows < 1) return 0;
  if (rows <= MAX_ROWS) {
    if (dtype_code == 0)
      return dp == 32   ? Smem<float, 32>::bytes(rows)
             : dp == 64 ? Smem<float, 64>::bytes(rows)
                        : Smem<float, 128>::bytes(rows);
    return dp == 32   ? Smem<__nv_bfloat16, 32>::bytes(rows)
           : dp == 64 ? Smem<__nv_bfloat16, 64>::bytes(rows)
                      : Smem<__nv_bfloat16, 128>::bytes(rows);
  }
  if (dtype_code == 1)
    return dp == 32   ? PfSmem<32>::BYTES
           : dp == 64 ? PfSmem<64>::BYTES
                      : PfSmem<128>::BYTES;
  return 0;
}
