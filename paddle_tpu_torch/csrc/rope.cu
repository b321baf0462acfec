// Rotate-half rope on the decode tick's flat q and k projections, both in
// one launch:
//   zq [B, nH * D], zk [B, Hkv * D], each row at its own stride (ldq, ldk
//   values: a fused qkv product's q and k columns are read in place, with
//   no copy); row b at position pos[b]; for each head
//   and i < D / 2, with x1 = z[i], x2 = z[i + D / 2] of the head:
//   out[i] = x1 cos_i - x2 sin_i,  out[i + D / 2] = x1 sin_i + x2 cos_i,
//   angle_i = pos * theta^(-2 i / D) in fp32, cos and sin rounded to the
//   tensor's type T, each product and each sum rounded to T (the
//   reference's order: in fp32 nothing is fused into an FMA).
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/tick_fusion.py
// (fused_rope_qk, kernel body _rope_qk_kernel).
//
// What bounds it on the H100: the launch. At the serving tick (B 8, 12 + 12
// heads of D 64, bf16) it moves 49 KB, 0.000015 ms at 3.35 TB/s; what a
// call costs is the launch and one trip to memory on the device, and the
// host's path to the launch. The design keeps both short:
// - a block covers one row and a group of heads, the grid (B, groups), so
//   the tick's 8 x 24 heads spread over 8 x 2 blocks of 64 threads and no
//   block walks a whole row;
// - each block computes its row's D / 2 angles once, one a thread, with
//   the accurate powf and sincosf (not the __sinf intrinsics: angles reach
//   max_len radians, where the fast units lose the argument's reduction),
//   rounded to T into shared memory (a pow, a cos and a sin for every
//   element would be 1536 a row at the tick for 32 distinct angles);
// - a thread rotates one head's pairs (x1[i..], x2[i..]) from two 16-byte
//   loads (8 bf16 or 4 fp32 values each; one value at a time where D / 2
//   is no multiple of the vector, or a row is not 16-byte aligned), and
//   writes both halves: each value is read once. Its first pair is loaded
//   before the angles are computed, so the loads' trip to memory overlaps
//   the transcendentals;
// - on the host, a plain C entry point loaded with ctypes: no Python
//   launcher and no import at each call.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 64;
constexpr int MAX_D = 8192;  // cos and sin of a row in 64 KB of shared memory

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

// x rounded to T, as fp32
template <typename T>
__device__ __forceinline__ float rnd(float x) {
  return to_f<T>(from_f<T>(x));
}

// VEC values of T at p (16 bytes, aligned, where VEC > 1)
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

// grid (B, ceil((nH + Hkv) / hpb)); block y takes heads y hpb .. of the
// row's nH q heads followed by its Hkv k heads; input rows at strides ldq
// and ldk, output rows contiguous. cs: 2 (D / 2) floats of dynamic shared
// memory.
template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
rope_qk(const T* __restrict__ zq, const T* __restrict__ zk,
        T* __restrict__ oq, T* __restrict__ ok,
        const int32_t* __restrict__ pos, int nH, int Hkv, int D, int hpb,
        int ldq, int ldk, float theta) {
  extern __shared__ float cs[];
  const int b = blockIdx.x;
  const int half = D / 2;
  const int units = half / VEC;  // vectors in a head's half
  const int h0 = blockIdx.y * hpb;
  const int tasks = min(hpb, nH + Hkv - h0) * units;
  // task e: the pairs i0 .. i0 + VEC - 1 of head h0 + e / units, read
  // from its input row (at the row's stride) and written to its output row
  struct Task {
    const T* src;
    T* dst;
    int i0;
  };
  auto at = [&](int e) {
    const int h = h0 + e / units;
    Task t;
    t.i0 = (e % units) * VEC;
    if (h < nH) {
      t.src = zq + (size_t)b * ldq + (size_t)h * D;
      t.dst = oq + ((size_t)b * nH + h) * D;
    } else {
      t.src = zk + (size_t)b * ldk + (size_t)(h - nH) * D;
      t.dst = ok + ((size_t)b * Hkv + (h - nH)) * D;
    }
    return t;
  };
  auto rotate = [&](const Pack<T, VEC>& x1, const Pack<T, VEC>& x2, T* dst,
                    int i0) {
    Pack<T, VEC> y1, y2;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float a = to_f<T>(x1.v[k]), bb = to_f<T>(x2.v[k]);
      const float c = cs[i0 + k], sn = cs[half + i0 + k];
      y1.v[k] = from_f<T>(
          __fsub_rn(rnd<T>(__fmul_rn(a, c)), rnd<T>(__fmul_rn(bb, sn))));
      y2.v[k] = from_f<T>(
          __fadd_rn(rnd<T>(__fmul_rn(a, sn)), rnd<T>(__fmul_rn(bb, c))));
    }
    store<T, VEC>(dst + i0, y1);
    store<T, VEC>(dst + half + i0, y2);
  };

  // the thread's first pair of vectors is loaded before the angles are
  // computed, so their trip to memory overlaps the powf and the sincosf;
  // only the loaded values stay live across that loop (the task's
  // addresses are formed again after it)
  Pack<T, VEC> x1, x2;
  if (threadIdx.x < tasks) {
    const Task t = at(threadIdx.x);
    x1 = load<T, VEC>(t.src + t.i0);
    x2 = load<T, VEC>(t.src + half + t.i0);
  }
  const float p = static_cast<float>(pos[b]);
  for (int i = threadIdx.x; i < half; i += THREADS) {
    // theta^(-(2 i) / D): the exponent as the reference forms it
    const float f = powf(theta, -static_cast<float>(2 * i) /
                                    static_cast<float>(D));
    float sn, c;
    sincosf(__fmul_rn(p, f), &sn, &c);
    cs[i] = rnd<T>(c);
    cs[half + i] = rnd<T>(sn);
  }
  __syncthreads();

  for (int e = threadIdx.x; e < tasks; e += THREADS) {
    const Task t = at(e);
    if (e == (int)threadIdx.x)
      rotate(x1, x2, t.dst, t.i0);
    else
      rotate(load<T, VEC>(t.src + t.i0), load<T, VEC>(t.src + half + t.i0),
             t.dst, t.i0);
  }
}

template <typename T, int VEC>
int launch(const void* zq, const void* zk, void* oq, void* ok,
           const void* pos, int B, int nH, int Hkv, int D, int ldq, int ldk,
           float theta, cudaStream_t s) {
  const int units = D / 2 / VEC;
  const int hpb = units >= THREADS ? 1 : THREADS / units;  // heads a block
  const int groups = (nH + Hkv + hpb - 1) / hpb;
  if (groups > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(B, groups);
  const size_t smem = (size_t)D * sizeof(float);
  if (smem > 48 * 1024) {
    static const int attr = static_cast<int>(cudaFuncSetAttribute(
        rope_qk<T, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        MAX_D * (int)sizeof(float)));
    if (attr) return attr;
  }
  rope_qk<T, VEC><<<grid, THREADS, smem, s>>>(
      static_cast<const T*>(zq), static_cast<const T*>(zk),
      static_cast<T*>(oq), static_cast<T*>(ok),
      static_cast<const int32_t*>(pos), nH, Hkv, D, hpb, ldq, ldk, theta);
  return static_cast<int>(cudaGetLastError());
}

// 16-byte loads where a head's half is a whole number of vectors and every
// row starts on a 16-byte boundary, else one value at a time
template <typename T>
int launch_t(const void* zq, const void* zk, void* oq, void* ok,
             const void* pos, int B, int nH, int Hkv, int D, int ldq,
             int ldk, float theta, cudaStream_t s) {
  constexpr int VEC = 16 / (int)sizeof(T);
  const uintptr_t any = reinterpret_cast<uintptr_t>(zq) |
                        reinterpret_cast<uintptr_t>(zk) |
                        reinterpret_cast<uintptr_t>(oq) |
                        reinterpret_cast<uintptr_t>(ok) |
                        ((uintptr_t)ldq * sizeof(T)) |
                        ((uintptr_t)ldk * sizeof(T));
  if ((D / 2) % VEC == 0 && any % 16 == 0)
    return launch<T, VEC>(zq, zk, oq, ok, pos, B, nH, Hkv, D, ldq, ldk,
                          theta, s);
  return launch<T, 1>(zq, zk, oq, ok, pos, B, nH, Hkv, D, ldq, ldk, theta,
                      s);
}

}  // namespace

// dtype_code: 0 = float32, 1 = bfloat16. Device pointers: zq [B, nH * D]
// with rows ldq values apart, zk [B, Hkv * D] with rows ldk apart (each row
// contiguous), oq / ok contiguous, all of the dtype; pos [B] int32; D even,
// at most 8192. Returns the cudaError_t of the launch (0 = success),
// cudaErrorInvalidValue for a shape, stride or dtype it does not take.
extern "C" int fused_rope_qk(const void* zq, const void* zk, void* oq,
                             void* ok, const void* pos, int B, int nH,
                             int Hkv, int D, int ldq, int ldk, int dtype_code,
                             float theta, void* stream) {
  if (B < 1 || nH < 0 || Hkv < 0 || nH + Hkv < 1 || D < 2 || D % 2 != 0 ||
      D > MAX_D || ldq < nH * D || ldk < Hkv * D)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype_code == 0)
    return launch_t<float>(zq, zk, oq, ok, pos, B, nH, Hkv, D, ldq, ldk,
                           theta, s);
  if (dtype_code == 1)
    return launch_t<__nv_bfloat16>(zq, zk, oq, ok, pos, B, nH, Hkv, D, ldq,
                                   ldk, theta, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
