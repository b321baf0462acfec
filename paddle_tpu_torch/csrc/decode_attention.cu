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
//
// The kernel itself lives in split_kv.cuh, shared with the paged decode
// (paged_attention.cu); this file gives it the slot-contiguous addressing
// (SlotRows: key j of slot b is cache row b * max_len + j, one position a
// slot) and the quant mode's narrow caches. Every head dim D % 8 == 0 up to
// 128 is served: 64 and 128 by exact instances, the others by instances at
// the padded widths 32, 64 and 128 that take the true D at run time
// (split_kv.cuh), where a one-byte cache is copied in 8-byte pieces.

#include "split_kv.cuh"

namespace {

// The main path's head dims (64, 128) have exact instances (D known when
// compiled), and among them one query head per kv head (MHA) has an
// instance of its own, whose rows' loops know their bound when compiled (no
// branch per row); GQA takes the instance of up to MAX_ROWS rows. Every
// other head dim takes the padded instance of its width, of up to MAX_ROWS
// rows; a one-byte cache copies 8-byte pieces there (its head rows start
// on 8-byte boundaries where D % 16 == 8), one instance where 8- and
// 16-byte pieces would take two off the main path.
template <int TC, int KC, int DP>
int launch_exact(const void* q, const void* kc, const void* vc,
                 const void* ks, const void* vs, const void* pos, void* out,
                 void* part, void* tickets, int B, int nH, int Hkv,
                 int max_len, int n_chunks, float scale,
                 cudaStream_t stream) {
  const SlotRows keys{static_cast<const int32_t*>(pos), max_len};
  if (nH == Hkv)
    return launch_split<SlotRows, TC, KC, DP, 1, 16, true>(
        q, kc, vc, ks, vs, keys, out, part, tickets, B, nH, Hkv, DP, 1,
        n_chunks, scale, stream);
  return launch_split<SlotRows, TC, KC, DP, MAX_ROWS, 16, true>(
      q, kc, vc, ks, vs, keys, out, part, tickets, B, nH, Hkv, DP, 1,
      n_chunks, scale, stream);
}

template <int TC, int KC, int DP, int PB>
int launch_padded(const void* q, const void* kc, const void* vc,
                  const void* ks, const void* vs, const void* pos, void* out,
                  void* part, void* tickets, int B, int nH, int Hkv, int D,
                  int max_len, int n_chunks, float scale,
                  cudaStream_t stream) {
  const SlotRows keys{static_cast<const int32_t*>(pos), max_len};
  return launch_split<SlotRows, TC, KC, DP, MAX_ROWS, PB, false>(
      q, kc, vc, ks, vs, keys, out, part, tickets, B, nH, Hkv, D, 1,
      n_chunks, scale, stream);
}

template <int TC, int KC>
int launch_d(const void* q, const void* kc, const void* vc, const void* ks,
             const void* vs, const void* pos, void* out, void* part,
             void* tickets, int B, int nH, int Hkv, int D, int max_len,
             int n_chunks, float scale, cudaStream_t s) {
  if (D == 64)
    return launch_exact<TC, KC, 64>(q, kc, vc, ks, vs, pos, out, part,
                                    tickets, B, nH, Hkv, max_len, n_chunks,
                                    scale, s);
  if (D == 128)
    return launch_exact<TC, KC, 128>(q, kc, vc, ks, vs, pos, out, part,
                                     tickets, B, nH, Hkv, max_len, n_chunks,
                                     scale, s);
  constexpr int PB = KC == 0 ? 16 : 8;  // a padded instance's pieces
  const int dp = padded_dim(D);
  if (dp == 32)
    return launch_padded<TC, KC, 32, PB>(q, kc, vc, ks, vs, pos, out, part,
                                         tickets, B, nH, Hkv, D, max_len,
                                         n_chunks, scale, s);
  if (dp == 64)
    return launch_padded<TC, KC, 64, PB>(q, kc, vc, ks, vs, pos, out, part,
                                         tickets, B, nH, Hkv, D, max_len,
                                         n_chunks, scale, s);
  if (dp == 128)
    return launch_padded<TC, KC, 128, PB>(q, kc, vc, ks, vs, pos, out, part,
                                          tickets, B, nH, Hkv, D, max_len,
                                          n_chunks, scale, s);
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

// the piece size does not change the shared memory
template <typename KT>
int smem_dp(int dp, int rep) {
  if (dp == 32) return Smem<KT, 32>::bytes(rep);
  if (dp == 64) return Smem<KT, 64>::bytes(rep);
  return Smem<KT, 128>::bytes(rep);
}

template <int TC>
int smem_kv(int kv_code, int D, int rep) {
  typedef typename CacheType<TC, 0>::type T;
  const int dp = padded_dim(D);
  return kv_code == 0 ? smem_dp<T>(dp, rep) : smem_dp<int8_t>(dp, rep);
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
// [B] int32, all contiguous; D % 8 == 0 and 8 <= D <= 128.
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
      nH / Hkv > MAX_ROWS || B > 65535 || n_chunks > 65535 ||
      padded_dim(D) == 0 || part == nullptr || tickets == nullptr)
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

// The dynamic shared memory one block of the instance that serves
// (dtype_code, kv_code, D) asks for at rep query heads per kv head; 0 for
// an instance that does not exist.
extern "C" int ragged_decode_smem(int dtype_code, int kv_code, int D,
                                  int rep) {
  if (padded_dim(D) == 0 || kv_code < 0 || kv_code > 2 || rep < 1 ||
      rep > MAX_ROWS)
    return 0;
  if (dtype_code == 0) return smem_kv<0>(kv_code, D, rep);
  if (dtype_code == 1) return smem_kv<1>(kv_code, D, rep);
  return 0;
}
