// The decode tick's two norms, rmsnorm and residual add + rmsnorm:
//   fused_rms_norm:      out = round_T(round_T(x * r) * w)
//   fused_add_rms_norm:  s = round_T(x + y), out = the same on s
//   r = rsqrt(ms + eps), ms = (the row's sum of v * v in fp32) * (1 / H),
//   over the values as stored (s rounded to T); x, y, s, out [B, H] and
//   w [H] of one type T (fp32 or bf16), contiguous. Each product and sum is
//   rounded where the plain versions round it (no FMA contraction); the
//   sum's order, 1 / H and rsqrt (the special-function unit's, within 2
//   ulps, as torch.rsqrt on the card) may move out by one ulp of T.
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas/tick_fusion.py:
// fused_rms_norm (kernel body _rms_kernel) and fused_add_rms_norm
// (_add_rms_kernel).
//
// What bounds them on the H100: bytes, and below that the launch. At the
// serving tick (B 8, H 768, bf16) rmsnorm moves 26 KB and the add 51 KB,
// 0.0000078 and 0.0000151 ms at 3.35 TB/s, while an empty kernel takes
// about 0.001 ms back to back in a CUDA graph. What a call costs is the
// launch, one trip to memory and the chain of dependent instructions after
// it, and on the host the path to the launch. The design keeps each short:
// - each thread holds one 16-byte piece of the row (8 bf16 or 4 fp32
//   values) of x, y and w, up to 16 warps (H 4096 in bf16), four pieces
//   past that: a row of one warp with three pieces a lane measured slower
//   than the Triton kernel it replaces, its one warp issuing the whole
//   chain alone;
// - every load (x, y and w) is issued before the first arithmetic, so the
//   three share one trip to memory (the Triton kernel loaded w after its
//   reduction: a second, dependent trip);
// - the sum of squares: pairwise within a piece, 5 __shfl_xor_sync steps
//   in a warp, and in a row of several warps one exchange of the warp
//   sums through shared memory reduced again by shuffles; then 1 / H
//   (rounded on the host), an add and rsqrt;
// - each launch allows programmatic dependent launch (Hopper): the norm's
//   blocks start while the kernel ahead of it drains and wait for it in
//   the kernel (griddepcontrol), which hides part of the launch;
// - one value at a time where H is no multiple of the 16-byte piece or a
//   pointer is not 16-byte aligned (w is a row of the stacked [L, H] layer
//   weights, so at H 100 it starts off a 16-byte boundary);
// - the row stays in registers up to 2048 pieces (16 warps x 32 lanes x 4):
//   H 8192 in fp32, 16384 in bf16, 2048 one value at a time. A longer row
//   takes a strided loop of 512 threads that reads it once for the sum and
//   again, from L2, for the output;
// - on the host, a plain C entry point loaded with ctypes (no Python
//   launcher, no import at each call); it switches to the tensors' device
//   only where that is not already current.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_WARPS = 16;  // a row's warps: 512 threads
constexpr int MAX_THREADS = 32 * MAX_WARPS;

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
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

// VEC values of T: 16 bytes (VEC > 1, aligned) or one value
template <typename T, int VEC>
struct Pack {
  T v[VEC];
};

template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> load(const T* p) {
  Pack<T, VEC> r;
  if constexpr (VEC * sizeof(T) == 16) {
    *reinterpret_cast<uint4*>(r.v) = *reinterpret_cast<const uint4*>(p);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) r.v[i] = p[i];
  }
  return r;
}

template <typename T, int VEC>
__device__ __forceinline__ void store(T* p, const Pack<T, VEC>& r) {
  if constexpr (VEC * sizeof(T) == 16) {
    *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(r.v);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) p[i] = r.v[i];
  }
}

// s = round_T(x + y) piece by piece, in place in x
template <typename T, int VEC>
__device__ __forceinline__ void add_into(Pack<T, VEC>& x,
                                         const Pack<T, VEC>& y) {
#pragma unroll
  for (int i = 0; i < VEC; ++i)
    x.v[i] = from_f<T>(__fadd_rn(to_f<T>(x.v[i]), to_f<T>(y.v[i])));
}

// the sum of a piece's squares, pairwise (a chain of log2 VEC adds)
template <typename T, int VEC>
__device__ __forceinline__ float squares(const Pack<T, VEC>& v) {
  float q[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const float f = to_f<T>(v.v[i]);
    q[i] = __fmul_rn(f, f);
  }
#pragma unroll
  for (int h = VEC / 2; h > 0; h /= 2)
#pragma unroll
    for (int i = 0; i < h; ++i) q[i] = __fadd_rn(q[i], q[i + h]);
  return q[0];
}

// round_T(round_T(v * r) * w)
template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> scaled(const Pack<T, VEC>& v,
                                               const Pack<T, VEC>& w,
                                               float r) {
  Pack<T, VEC> o;
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    const float n = to_f<T>(from_f<T>(__fmul_rn(to_f<T>(v.v[i]), r)));
    o.v[i] = from_f<T>(__fmul_rn(n, to_f<T>(w.v[i])));
  }
  return o;
}

static_assert((MAX_WARPS & (MAX_WARPS - 1)) == 0 && MAX_WARPS <= 32,
              "the warp sums are reduced by xor shuffles in one warp");

// the row's sum of squares to every thread: 5 xor-shuffle steps in each
// warp (every lane of a butterfly ends with the same sum), then, in a row
// of several warps, one exchange of the warp sums through shared memory,
// reduced again by xor shuffles (each warp the same way, so every thread
// holds the same bits)
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warps = blockDim.x >> 5;
  if (warps == 1) return v;
  __shared__ float part[MAX_WARPS];
  const int lane = threadIdx.x & 31;
  if (lane == 0) part[threadIdx.x >> 5] = v;
  __syncthreads();
  const int i = lane & (MAX_WARPS - 1);
  v = i < warps ? part[i] : 0.f;
#pragma unroll
  for (int o = MAX_WARPS / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// 1 / sqrt(mean square + eps); inv_h = 1 / H, rounded on the host, so the
// chain after the reduction is a multiply, an add and the special-function
// unit's rsqrt (within 2 ulps, as torch.rsqrt on the card)
__device__ __forceinline__ float inv_rms(float sum, float inv_h, float eps) {
  return rsqrtf(__fadd_rn(__fmul_rn(sum, inv_h), eps));
}

// Programmatic dependent launch: a kernel launched with programmatic
// stream serialization may start while the kernel ahead of it on the
// stream drains; it waits here, before its first read of memory, for that
// kernel to finish and its writes to show, and lets the next kernel start
// likewise. Without the attribute both are no-ops.
__device__ __forceinline__ void wait_for_previous_kernel() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

// grid (B), block 32 x warps threads; the row's n = H / VEC pieces, piece
// k * blockDim.x + threadIdx.x (k < PIECES) in the thread's registers
template <typename T, int VEC, int PIECES, bool ADD>
__global__ void __launch_bounds__(MAX_THREADS)
norm_regs(const T* __restrict__ x, const T* __restrict__ y,
          const T* __restrict__ w, T* __restrict__ s, T* __restrict__ out,
          int H, float inv_h, float eps) {
  const int n = H / VEC;
  const size_t row = static_cast<size_t>(blockIdx.x) * H;
  Pack<T, VEC> xv[PIECES], yv[PIECES], wv[PIECES];
  // every load after the wait (w too: a caller's w may be a cast or a
  // copy that the kernel ahead of this one wrote) and before any
  // arithmetic: x, y and w in one trip to memory
  wait_for_previous_kernel();
#pragma unroll
  for (int k = 0; k < PIECES; ++k) {
    const int p = k * blockDim.x + threadIdx.x;
    if (p < n) {
      xv[k] = load<T, VEC>(x + row + p * VEC);
      if constexpr (ADD) yv[k] = load<T, VEC>(y + row + p * VEC);
      wv[k] = load<T, VEC>(w + p * VEC);
    }
  }
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < PIECES; ++k) {
    const int p = k * blockDim.x + threadIdx.x;
    if (p < n) {
      if constexpr (ADD) {
        add_into<T, VEC>(xv[k], yv[k]);
        store<T, VEC>(s + row + p * VEC, xv[k]);
      }
      acc = __fadd_rn(acc, squares<T, VEC>(xv[k]));
    }
  }
  const float r = inv_rms(row_sum(acc), inv_h, eps);
#pragma unroll
  for (int k = 0; k < PIECES; ++k) {
    const int p = k * blockDim.x + threadIdx.x;
    if (p < n)
      store<T, VEC>(out + row + p * VEC, scaled<T, VEC>(xv[k], wv[k], r));
  }
}

// a row past 4 pieces a thread: grid (B), MAX_THREADS threads striding
// over it, once for the sum (the add writes s) and once for the output
// (reading back x or the s this thread wrote)
template <typename T, int VEC, bool ADD>
__global__ void __launch_bounds__(MAX_THREADS)
norm_stream(const T* __restrict__ x, const T* __restrict__ y,
            const T* __restrict__ w, T* __restrict__ s, T* __restrict__ out,
            int H, float inv_h, float eps) {
  const int n = H / VEC;
  const size_t row = static_cast<size_t>(blockIdx.x) * H;
  wait_for_previous_kernel();
  float acc = 0.f;
  for (int p = threadIdx.x; p < n; p += MAX_THREADS) {
    Pack<T, VEC> v = load<T, VEC>(x + row + p * VEC);
    if constexpr (ADD) {
      add_into<T, VEC>(v, load<T, VEC>(y + row + p * VEC));
      store<T, VEC>(s + row + p * VEC, v);
    }
    acc = __fadd_rn(acc, squares<T, VEC>(v));
  }
  const float r = inv_rms(row_sum(acc), inv_h, eps);
  const T* src = ADD ? s : x;
  for (int p = threadIdx.x; p < n; p += MAX_THREADS)
    store<T, VEC>(out + row + p * VEC,
                  scaled<T, VEC>(load<T, VEC>(src + row + p * VEC),
                                 load<T, VEC>(w + p * VEC), r));
}

int g_pdl = 1;  // set_pdl

// one launch on `st`, with programmatic stream serialization unless
// set_pdl turned it off
template <typename... Args>
int start(void (*kernel)(Args...), int grid, int threads, cudaStream_t st,
          Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(threads);
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = g_pdl;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, args...));
}

template <typename T, int VEC, bool ADD>
int launch(const void* x, const void* y, const void* w, void* s, void* out,
           int B, int H, float eps, cudaStream_t st) {
  const int n = H / VEC;
  const T* xp = static_cast<const T*>(x);
  const T* yp = static_cast<const T*>(y);
  const T* wp = static_cast<const T*>(w);
  T* sp = static_cast<T*>(s);
  T* op = static_cast<T*>(out);
  const float inv_h = 1.0f / static_cast<float>(H);
  if (n <= MAX_THREADS)  // a piece a thread
    return start(norm_regs<T, VEC, 1, ADD>, B, 32 * ((n + 31) / 32), st, xp,
                 yp, wp, sp, op, H, inv_h, eps);
  if (n <= 4 * MAX_THREADS)  // four pieces a thread
    return start(norm_regs<T, VEC, 4, ADD>, B, 32 * ((n + 127) / 128), st,
                 xp, yp, wp, sp, op, H, inv_h, eps);
  return start(norm_stream<T, VEC, ADD>, B, MAX_THREADS, st, xp, yp, wp, sp,
               op, H, inv_h, eps);
}

// 16-byte pieces where H is a whole number of them and every pointer
// starts on a 16-byte boundary, else one value at a time
template <typename T, bool ADD>
int launch_t(const void* x, const void* y, const void* w, void* s, void* out,
             int B, int H, float eps, cudaStream_t st) {
  constexpr int VEC = 16 / static_cast<int>(sizeof(T));
  const uintptr_t any =
      reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y) |
      reinterpret_cast<uintptr_t>(w) | reinterpret_cast<uintptr_t>(s) |
      reinterpret_cast<uintptr_t>(out);
  if (H % VEC == 0 && any % 16 == 0)
    return launch<T, VEC, ADD>(x, y, w, s, out, B, H, eps, st);
  return launch<T, 1, ADD>(x, y, w, s, out, B, H, eps, st);
}

__global__ void empty_kernel() { wait_for_previous_kernel(); }

// Makes `device` current for its lifetime where it is not already.
class OnDevice {
 public:
  explicit OnDevice(int device) {
    err_ = static_cast<int>(cudaGetDevice(&prev_));
    if (err_ == 0 && prev_ != device)
      err_ = static_cast<int>(cudaSetDevice(device));
    else
      prev_ = -1;
  }
  ~OnDevice() {
    if (prev_ >= 0) cudaSetDevice(prev_);
  }
  int error() const { return err_; }

 private:
  int prev_ = -1;
  int err_ = 0;
};

int norm(const void* x, const void* y, const void* w, void* s, void* out,
         int B, int H, int dtype_code, float eps, int device, void* stream,
         bool add) {
  if (B < 0 || H < 0 || dtype_code < 0 || dtype_code > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || H == 0) return 0;  // empty outputs: nothing to compute
  OnDevice on(device);
  if (on.error()) return on.error();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype_code == 0)
    return add ? launch_t<float, true>(x, y, w, s, out, B, H, eps, st)
               : launch_t<float, false>(x, y, w, s, out, B, H, eps, st);
  return add ? launch_t<__nv_bfloat16, true>(x, y, w, s, out, B, H, eps, st)
             : launch_t<__nv_bfloat16, false>(x, y, w, s, out, B, H, eps,
                                              st);
}

}  // namespace

// dtype_code: 0 = float32, 1 = bfloat16. Device pointers of `device`,
// contiguous: x, out [B, H] and w [H] of the dtype. Launches on `stream`.
// Returns the cudaError_t of the launch (0 = success),
// cudaErrorInvalidValue for a shape or dtype it does not take.
extern "C" int fused_rms_norm(const void* x, const void* w, void* out, int B,
                              int H, int dtype_code, float eps, int device,
                              void* stream) {
  return norm(x, nullptr, w, nullptr, out, B, H, dtype_code, eps, device,
              stream, false);
}

// As fused_rms_norm, with y [B, H] added to x first and the sum written to
// s [B, H].
extern "C" int fused_add_rms_norm(const void* x, const void* y,
                                  const void* w, void* s, void* out, int B,
                                  int H, int dtype_code, float eps,
                                  int device, void* stream) {
  return norm(x, y, w, s, out, B, H, dtype_code, eps, device, stream, true);
}

// An empty kernel, one warp, launched as the norms are: what any launch
// through this path costs (the launch floor the norms are measured
// against).
extern "C" int empty_launch(int device, void* stream) {
  OnDevice on(device);
  if (on.error()) return on.error();
  return start(empty_kernel, 1, 32, static_cast<cudaStream_t>(stream));
}

// Programmatic dependent launch of every launch above: on (1) unless set
// off (0), for measurement. Returns the previous setting.
extern "C" int set_pdl(int on) {
  const int was = g_pdl;
  g_pdl = on ? 1 : 0;
  return was;
}
