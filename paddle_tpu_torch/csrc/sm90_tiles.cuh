// Hopper building blocks for attention kernels over one head of a
// [B, S, H, D] bf16 tensor and for GEMMs over row-major bf16 matrices,
// written so that any kernel of csrc/ can include them (the production
// flash kernels of flash_attention.cu, the flash-variant kernels,
// blocked_matmul.cu and head_dx.cu do):
//
// - host: the TMA map of one head's 64-row tiles and of a row-major
//   matrix's boxes (cuTensorMapEncodeTiled, looked up at run time with the
//   CUDA runtime's entry-point query, so no library links libcuda);
// - an mbarrier ring: full/empty barrier pairs, TMA tile loads and bulk
//   copies that complete on a barrier;
// - wgmma: shared-memory descriptors for the 128-byte swizzle the TMA
//   writes, m64n64k16 and m64n32k16 bf16 products with fp32 accumulators
//   in registers, A from shared memory or from registers; m64n256k16 and
//   m64n128k16 products of a K-major A and an MN-major B whose 64-column
//   boxes lie a leading byte offset apart; m64n256k16 of a register A and
//   a K-major B (a row-major [N, K] matrix read through its rows);
//   setmaxnreg, to hand a producer warpgroup's registers to the consumers;
// - accumulator-fragment helpers: quad reductions, the packing of an fp32
//   accumulator into the bf16 register A operand of the next product, the
//   store of an accumulator's rows as bf16, and the transpose within a quad
//   that gathers a row's 8 consecutive columns into one thread.
//
// Layouts. A tile is 64 rows of D bf16 values, stored as D / 64 boxes of
// 64 rows x 128 bytes (8 KiB each, 1024-byte aligned) in the TMA's
// 128-byte swizzle: the 16-byte chunk c of row r lies at chunk c ^ (r & 7).
// Read K-major (rows on M or N, D on the product's k), a k16 step is +32
// bytes inside the box; read MN-major (rows on k, D on N), a k16 step is
// +2048 bytes (16 rows) and each box is one 64-wide N chunk.
//
// An m64nN fp32 accumulator of the 128 threads of a warpgroup: thread t
// (warp w = t / 32, lane l) holds element e at row 16 w + l / 4 + 8 ((e >>
// 1) & 1) and column 8 (e >> 2) + 2 (l & 3) + (e & 1). So a row's values
// live in one quad of lanes, and the pairs (e, e + 1) are the bf16x2 halves
// of the register A operand's layout: register j of a k16 step kk is
// pack(d[8 kk + 2 j], d[8 kk + 2 j + 1]), i.e. A register n is pack(d[2 n],
// d[2 n + 1]).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int TILE = 64;                // rows of a tile, keys (or queries) per step
constexpr int BOX_BYTES = TILE * 128;   // one TMA box: 64 rows x 64 bf16
constexpr int WG_THREADS = 128;         // one warpgroup

// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// The map of one head's 64-row tiles of a [B, S, H, D] bf16 tensor: rank 4,
// dims {D, H, S, B}, byte strides {2 D, 2 H D, 2 S H D}, box {64, 1, 64, 1}
// (D 128 takes two boxes per tile), 128-byte swizzle; rows past S read as
// zeros. Returns a cudaError_t.
inline int head_tile_map(CUtensorMap* map, const void* base, int B, int S,
                         int H, int D) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {2ull * D, 2ull * H * D, 2ull * S * H * D};
  const cuuint32_t box[4] = {64, 1, TILE, 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// The map of a row-major [rows, cols] bf16 matrix read in boxes of
// box_rows x box_cols (box_cols * 2 bytes at most the swizzle's span):
// rank 2, dims {cols, rows}, byte stride {2 cols}. Returns a cudaError_t.
inline int matrix_box_map(CUtensorMap* map, const void* base, int rows,
                          int cols, int box_rows, int box_cols,
                          CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {2ull * cols};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

// above 48 KB a block's shared memory must be asked for; callers keep the
// result in a function-local static, so it is asked once per kernel
template <typename Kernel>
int prepare(Kernel kernel, size_t smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem));
}

// ---------------------------------------------------------------------------
// shared memory, barriers, copies
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// the dynamic shared memory rounded up to 1024 bytes (the swizzle's
// period); launches ask for 1024 bytes more than they use
__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  return p + ((1024u - (smem_addr(p) & 1023u)) & 1023u);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// after the barriers are set up, before any other thread uses them
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// the producer's arrival, announcing `bytes` of copies that complete on it
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(a), "r"(parity)
        : "memory");
  } while (!done);
}

// one box {64 values of D from c0, head h, rows s0.., batch b} into dst
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map,
                                        uint64_t* bar, int c0, int h, int s0,
                                        int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(h), "r"(s0), "r"(b)
      : "memory");
}

// rows s0 .. s0 + 63 of one head: D / 64 boxes, BOX_BYTES apart
template <int D>
__device__ __forceinline__ void tma_tile(unsigned char* dst,
                                         const CUtensorMap* map,
                                         uint64_t* bar, int h, int s0,
                                         int b) {
#pragma unroll
  for (int n = 0; n < D / 64; ++n)
    tma_box(dst + n * BOX_BYTES, map, bar, 64 * n, h, s0, b);
}

// one box of a matrix map {columns c0.., rows r0..} into dst
__device__ __forceinline__ void tma_box2(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int r0) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0),
      "r"(r0)
      : "memory");
}

// `bytes` (a multiple of 16, both ends 16-byte aligned) of plain memory
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// a ring of STAGES stages: a barrier for the block's fixed tiles, then
// full[s] (the producer's arrival with its bytes, and `full_count` - 1
// more arrivals of threads that store into the stage) and empty[s] (one
// arrival of each of `empty_count` consumer threads); set up by thread 0
// before any use
constexpr int STAGES = 2;

struct Ring {
  uint64_t* fixed;
  uint64_t* full;
  uint64_t* empty;
};

// the ring's 1 + 2 STAGES barriers at `bars`; a __syncthreads of the block
__device__ __forceinline__ Ring ring_init(unsigned char* bars,
                                          uint32_t full_count = 1,
                                          uint32_t empty_count = WG_THREADS) {
  Ring r;
  r.fixed = reinterpret_cast<uint64_t*>(bars);
  r.full = r.fixed + 1;
  r.empty = r.full + STAGES;
  if (threadIdx.x == 0) {
    mbar_init(r.fixed, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&r.full[s], full_count);
      mbar_init(&r.empty[s], empty_count);
    }
    mbar_init_fence();
  }
  __syncthreads();
  return r;
}

// the consumer warpgroup's own barrier (named barrier 1, 128 threads)
__device__ __forceinline__ void wg_sync() {
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}

// a warpgroup's registers per thread, handed between warpgroups of a block
// (every warp of the warpgroup executes it; N a multiple of 8 in [24, 256])
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// generic-proxy writes to shared memory made visible to wgmma and TMA
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// K-major operand in the 128-byte swizzle: 8-row groups 1024 bytes apart
// (stride byte offset); the leading offset is unused (k16 = 32 bytes sits
// inside one 128-byte row)
__device__ __forceinline__ uint64_t desc_k(const void* p) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}

// MN-major operand in the 128-byte swizzle, N = 64 (one 128-byte chunk):
// 8-row (k) groups 1024 bytes apart. Both offsets are 1024 bytes: the one
// between 64-wide N chunks is never reached at N = 64.
__device__ __forceinline__ uint64_t desc_mn(const void* p) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | (64ull << 16) |
         (64ull << 32) | (1ull << 62);
}

// K-major operand in the 64-byte swizzle (rows of 32 bf16): 8-row groups
// 512 bytes apart; a k16 step is +32 bytes inside the row
__device__ __forceinline__ uint64_t desc_k64(const void* p) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | (1ull << 16) |
         (32ull << 32) | (2ull << 62);
}

// MN-major operand in the 128-byte swizzle, N a multiple of 64: each
// 64-wide N chunk is a box of its own, `box_bytes` after the last (the
// leading byte offset); 8-row (k) groups 1024 bytes apart
__device__ __forceinline__ uint64_t desc_mn_boxes(const void* p,
                                                  uint32_t box_bytes) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(box_bytes >> 4) << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving accumulator reads or writes across the
// asynchronous products
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define SM90_D32(d)                                                        \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),  \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),         \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),     \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),     \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),     \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),     \
      "+f"(d[31])

#define SM90_R32                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"

#define SM90_D16(d)                                                        \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),  \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),         \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])

#define SM90_R16                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"

// d[64 x N] (+)= A[64 x 16] B[16 x N]^T, both K-major in shared memory,
// N 64 or 32; `acc` 0 overwrites d
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SM90_R32
      ", %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : SM90_D32(d)
      : "l"(a), "l"(b), "r"(acc));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t a,
                                         uint64_t b, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 " SM90_R16
      ", %16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : SM90_D16(d)
      : "l"(a), "l"(b), "r"(acc));
}

// d[64 x 64] += A[64 x 16] B[16 x 64], A the four bf16x2 registers of the
// thread's fragment, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a,
                                         uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " SM90_R32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : SM90_D32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[64 x 256] (+)= A[64 x 16] B[16 x 256], A K-major and B MN-major in
// shared memory; `acc` 0 overwrites d
__device__ __forceinline__ void wgmma_ss_mn(float (&d)[128], uint64_t a,
                                            uint64_t b, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127}"
      ", %128, %129, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(acc));
}

// d[64 x 128] (+)= A[64 x 16] B[16 x 128], A K-major and B MN-major in
// shared memory; `acc` 0 overwrites d
__device__ __forceinline__ void wgmma_ss_mn(float (&d)[64], uint64_t a,
                                            uint64_t b, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
      ", %64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(acc));
}

// d[64 x 256] (+)= A[64 x 16] B[16 x 256], A the four bf16x2 registers of
// the thread's fragment, B K-major in shared memory (its 256 N rows of 16 k
// values each, as a row-major [N, K] matrix's rows lie); `acc` 0 overwrites
// d
__device__ __forceinline__ void wgmma_rs_k(float (&d)[128], const uint32_t* a,
                                           uint64_t b, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127"
      "}"
      ", {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

#undef SM90_D32
#undef SM90_R32
#undef SM90_D16
#undef SM90_R16

// d = A[64 x D] B[N x D]^T over tiles in shared memory (both K-major,
// D / 64 boxes each; B's rows may start inside a box, at a multiple of 8);
// the product is complete on return
template <int D, int N>
__device__ __forceinline__ void tile_abt(float (&d)[N / 2],
                                         const unsigned char* A,
                                         const unsigned char* Bm) {
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int off = (kk / 4) * BOX_BYTES + (kk % 4) * 32;
    wgmma_ss(d, desc_k(A + off), desc_k(Bm + off), kk > 0);
  }
  wg_commit();
  wg_wait<0>();
  fence_regs(d);
}

// two such products, issued together
template <int D, int N>
__device__ __forceinline__ void tile_abt2(float (&d)[N / 2],
                                          const unsigned char* A,
                                          const unsigned char* Bm,
                                          float (&e)[N / 2],
                                          const unsigned char* A2,
                                          const unsigned char* B2) {
  wg_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int off = (kk / 4) * BOX_BYTES + (kk % 4) * 32;
    wgmma_ss(d, desc_k(A + off), desc_k(Bm + off), kk > 0);
  }
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int off = (kk / 4) * BOX_BYTES + (kk % 4) * 32;
    wgmma_ss(e, desc_k(A2 + off), desc_k(B2 + off), kk > 0);
  }
  wg_commit();
  wg_wait<0>();
  fence_regs(d);
  fence_regs(e);
}

// acc[n] += P[64 x K] V[K x D] (columns 64 n ..), P the K / 4 bf16x2 A
// registers of a K-wide fragment, V the rows r0 .. r0 + K - 1 of a tile
// read MN-major; issued, not waited for
template <int D, int K>
__device__ __forceinline__ void tile_pv_issue(float (&acc)[D / 64][32],
                                              const uint32_t (&p)[K / 4],
                                              const unsigned char* V,
                                              int r0 = 0) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
#pragma unroll
    for (int n = 0; n < D / 64; ++n)
      wgmma_rs(acc[n], p + 4 * kk,
               desc_mn(V + n * BOX_BYTES + (r0 + kk * 16) * 128));
}

// ---------------------------------------------------------------------------
// fragments
// ---------------------------------------------------------------------------

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// accumulator element e of this thread: its row's offset in the tile (0 or
// 8 past the thread's first row) and its column in the tile
__device__ __forceinline__ int frag_hi(int e) { return (e >> 1) & 1; }
__device__ __forceinline__ int frag_col(int e) {
  return (e >> 2) * 8 + 2 * (threadIdx.x & 3) + (e & 1);
}

// store rows r and r + 8 of a 64 x D fp32 accumulator as bf16 to row0 and
// row1 (each a row of D values; a null row is not stored), each value
// divided by (DIV) or times its row's f0 / f1
template <int D, bool DIV>
__device__ __forceinline__ void store_acc(const float (&acc)[D / 64][32],
                                          bf16* row0, bf16* row1, float f0,
                                          float f1) {
#pragma unroll
  for (int n = 0; n < D / 64; ++n)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float* a = acc[n] + 4 * j;
      const int c = 64 * n + frag_col(4 * j);
      if (row0)
        *reinterpret_cast<__nv_bfloat162*>(row0 + c) =
            DIV ? __floats2bfloat162_rn(a[0] / f0, a[1] / f0)
                : __floats2bfloat162_rn(a[0] * f0, a[1] * f0);
      if (row1)
        *reinterpret_cast<__nv_bfloat162*>(row1 + c) =
            DIV ? __floats2bfloat162_rn(a[2] / f1, a[3] / f1)
                : __floats2bfloat162_rn(a[2] * f1, a[3] * f1);
    }
}

// word i of w, by selects (a dynamic index would put w in local memory)
__device__ __forceinline__ uint32_t pick4(const uint32_t (&w)[4], int i) {
  uint32_t x = w[0];
  x = i == 1 ? w[1] : x;
  x = i == 2 ? w[2] : x;
  return i == 3 ? w[3] : x;
}

// Lane t of a quad holds w[g] = columns 8 g + 2 t, + 1 (bf16x2) of one row
// for four 8-column groups g; returns that row's 8 columns of group t.
// Every lane of the warp takes part (shuffles).
__device__ __forceinline__ uint4 quad_transpose(const uint32_t (&w)[4]) {
  const int t = threadIdx.x & 3;
  uint32_t o[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    // the partner t ^ r sends its pair of group t: columns 2 (t ^ r) ..
    const uint32_t v =
        __shfl_xor_sync(0xffffffffu, pick4(w, t ^ r), r);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (c == (t ^ r)) o[c] = v;
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}

// rowsum(a * b) in fp32 of the 64 rows of two tiles in shared memory (the
// swizzled layout), two threads a row; row r's sum into out[r]
template <int D>
__device__ __forceinline__ void tile_rowdot(float* out, const unsigned char* a,
                                            const unsigned char* b) {
  const int row = threadIdx.x >> 1, half = threadIdx.x & 1;
  float s = 0.f;
#pragma unroll
  for (int n = 0; n < D / 64; ++n)
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const int c = 4 * half + cc;
      const int off = n * BOX_BYTES + row * 128 + ((c ^ (row & 7)) << 4);
      const uint4 u = *reinterpret_cast<const uint4*>(a + off);
      const uint4 w = *reinterpret_cast<const uint4*>(b + off);
      const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&u);
      const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 fx = __bfloat1622float2(x[j]);
        const float2 fy = __bfloat1622float2(y[j]);
        s += fx.x * fy.x;
        s += fx.y * fy.y;
      }
    }
  s += __shfl_xor_sync(0xffffffffu, s, 1);
  if (half == 0) out[row] = s;
}

}  // namespace
