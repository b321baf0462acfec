// Fused multi-tensor optimizer update over one flat [rows, 128] buffer per
// parameter group, params and moments written in place.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/multi_tensor_update.py
// (_run <- apply_flat_update; bodies _sgd_kernel, _momentum_kernel,
// _adam_kernel, _lamb_kernel pass A, gated by _gate).
//
// Kinds (kind code):
//   0 sgd       p -= lr * g
//   1 momentum  v = mu * v + g; p -= lr * (nesterov ? g + mu * v : v)
//   2 adam      m, v moments; bias-corrected step in fp32; optional fp32
//               master weight; optional decoupled (AdamW) decay
//   3 lamb      pass A: m, v in place and the raw update
//               r = mhat / (sqrt(vhat) + eps) + wd * w out (fp32); the
//               per-tensor trust ratio and the step run after it, outside
//               (torch ops over the plan's segment ids)
//
// Types: params and grads fp32 or bf16 (grads arrive in the param type);
// the velocity and the moments in the param type or fp32 (fp32 beside an
// adam master; lamb's moments are always fp32). The arithmetic follows the Pallas bodies
// operation by operation: in a bf16 kind every product and sum is rounded
// to bf16 before the next (mu and lr are cast to the buffer type first, so
// 0.9 becomes 0.8984375), and the fp32 ones use __fmul_rn / __fadd_rn so
// that no multiply-add is contracted into an FMA with one rounding.
//
// skip: the AMP found_inf gate. When it is > 0 no buffer is written, so
// every param and moment stays bit-identical. It is read from a device
// float (skip != nullptr), so the caller needs no host sync, or taken
// from the host value skip_host.
//
// What bounds it on the H100: bytes. Each element is read and written once
// with a handful of flops: bf16 momentum reads p, g, v and writes p, v
// (10 B per element), bf16 AdamW with an fp32 master reads p, g, m, v, w
// and writes p, m, v, w (30 B), fp32 momentum 20 B. ResNet-50's 25.56 M
// parameters in bf16 momentum are 255.6 MB, 0.076 ms at 3.35 TB/s. The
// design is the simple one that streams at that rate: one thread owns 8
// consecutive elements (one 16-byte load of bf16, two of fp32), the grid
// strides over the buffer, every load and store is coalesced. Offsets are
// 64-bit, so a buffer may hold more than 2^31 elements.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int VEC = 8;  // elements per thread and step

enum Kind { SGD = 0, MOMENTUM = 1, ADAM = 2, LAMB = 3 };
enum Flag { NESTEROV = 1, MASTER = 2, DECOUPLED = 4 };

__device__ __forceinline__ void load8(const float* p, int64_t i, float (&x)[VEC]) {
  const float4* q = reinterpret_cast<const float4*>(p + i);
  const float4 a = q[0], b = q[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, int64_t i,
                                      float (&x)[VEC]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p + i);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < VEC / 2; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    x[2 * k] = f.x;
    x[2 * k + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* p, int64_t i, const float (&x)[VEC]) {
  float4* q = reinterpret_cast<float4*>(p + i);
  q[0] = make_float4(x[0], x[1], x[2], x[3]);
  q[1] = make_float4(x[4], x[5], x[6], x[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, int64_t i,
                                       const float (&x)[VEC]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < VEC / 2; ++k) h[k] = __floats2bfloat162_rn(x[2 * k], x[2 * k + 1]);
  *reinterpret_cast<uint4*>(p + i) = u;
}

// x rounded to T (the value a T operation would have produced)
template <typename T> __device__ __forceinline__ float rnd(float x);
template <> __device__ __forceinline__ float rnd<float>(float x) { return x; }
template <> __device__ __forceinline__ float rnd<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// one operation of type T: the fp32 result, correctly rounded, then to T
template <typename T> __device__ __forceinline__ float mul(float a, float b) {
  return rnd<T>(__fmul_rn(a, b));
}
template <typename T> __device__ __forceinline__ float add(float a, float b) {
  return rnd<T>(__fadd_rn(a, b));
}
template <typename T> __device__ __forceinline__ float sub(float a, float b) {
  return rnd<T>(__fsub_rn(a, b));
}

__device__ __forceinline__ bool skipped(const float* skip, float skip_host) {
  return skip != nullptr ? *skip > 0.f : skip_host > 0.f;
}

struct Hyper {
  float lr, step, b1, b2, eps, wd;  // b1 is mu for momentum
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
sgd_kernel(T* __restrict__ p, const T* __restrict__ g, const float* skip,
           float skip_host, Hyper h, int64_t nvec) {
  if (skipped(skip, skip_host)) return;
  const float lr = rnd<T>(h.lr);
  for (int64_t v = blockIdx.x * (int64_t)THREADS + threadIdx.x; v < nvec;
       v += (int64_t)gridDim.x * THREADS) {
    const int64_t i = v * VEC;
    float pv[VEC], gv[VEC];
    load8(p, i, pv);
    load8(g, i, gv);
#pragma unroll
    for (int k = 0; k < VEC; ++k) pv[k] = sub<T>(pv[k], mul<T>(lr, gv[k]));
    store8(p, i, pv);
  }
}

// T: param/grad type; V: velocity type (T, or fp32)
template <typename T, typename V>
__global__ void __launch_bounds__(THREADS)
momentum_kernel(T* __restrict__ p, const T* __restrict__ g,
                V* __restrict__ vel, const float* skip, float skip_host,
                Hyper h, int flags, int64_t nvec) {
  if (skipped(skip, skip_host)) return;
  const float mu = rnd<V>(h.b1);
  const float lr = rnd<T>(h.lr);
  const bool nesterov = flags & NESTEROV;
  for (int64_t v = blockIdx.x * (int64_t)THREADS + threadIdx.x; v < nvec;
       v += (int64_t)gridDim.x * THREADS) {
    const int64_t i = v * VEC;
    float pv[VEC], gv[VEC], vv[VEC];
    load8(p, i, pv);
    load8(g, i, gv);
    load8(vel, i, vv);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float gf = rnd<V>(gv[k]);
      const float vn = add<V>(mul<V>(mu, vv[k]), gf);
      const float upd = nesterov ? add<V>(gf, mul<V>(mu, vn)) : vn;
      pv[k] = sub<T>(pv[k], mul<T>(lr, rnd<T>(upd)));
      vv[k] = vn;
    }
    store8(p, i, pv);
    store8(vel, i, vv);
  }
}

// T: param/grad type; M: moment type (T, or fp32 with a master)
template <typename T, typename M>
__global__ void __launch_bounds__(THREADS)
adam_kernel(T* __restrict__ p, const T* __restrict__ g, M* __restrict__ m1,
            M* __restrict__ m2, float* __restrict__ master,
            const float* skip, float skip_host, Hyper h, int flags,
            int64_t nvec) {
  if (skipped(skip, skip_host)) return;
  const bool has_master = flags & MASTER;
  const bool decoupled = flags & DECOUPLED;
  const float b1 = rnd<M>(h.b1), omb1 = rnd<M>(__fsub_rn(1.f, h.b1));
  const float b2 = rnd<M>(h.b2), omb2 = rnd<M>(__fsub_rn(1.f, h.b2));
  // bias corrections and the decay coefficient in fp32
  const float bc1 = __fsub_rn(1.f, powf(h.b1, h.step));
  const float bc2 = __fsub_rn(1.f, powf(h.b2, h.step));
  const float lrwd = __fmul_rn(h.lr, h.wd);
  const float lrwd_t = rnd<T>(lrwd);
  for (int64_t v = blockIdx.x * (int64_t)THREADS + threadIdx.x; v < nvec;
       v += (int64_t)gridDim.x * THREADS) {
    const int64_t i = v * VEC;
    float pv[VEC], gv[VEC], mv[VEC], vv[VEC], wv[VEC];
    load8(p, i, pv);
    load8(g, i, gv);
    load8(m1, i, mv);
    load8(m2, i, vv);
    if (has_master) load8(master, i, wv);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float gf = rnd<M>(gv[k]);
      mv[k] = add<M>(mul<M>(b1, mv[k]), mul<M>(omb1, gf));
      vv[k] = add<M>(mul<M>(b2, vv[k]), mul<M>(mul<M>(omb2, gf), gf));
      const float mhat = __fdiv_rn(mv[k], bc1);
      const float vhat = __fdiv_rn(vv[k], bc2);
      const float upd = __fdiv_rn(__fmul_rn(h.lr, mhat),
                                  __fadd_rn(__fsqrt_rn(vhat), h.eps));
      if (has_master) {
        float w = __fsub_rn(wv[k], upd);
        if (decoupled) w = __fsub_rn(w, __fmul_rn(lrwd, wv[k]));
        wv[k] = w;
        pv[k] = rnd<T>(w);
      } else {
        float pn = sub<T>(pv[k], rnd<T>(upd));
        if (decoupled) pn = sub<T>(pn, mul<T>(lrwd_t, pv[k]));
        pv[k] = pn;
      }
    }
    store8(p, i, pv);
    store8(m1, i, mv);
    store8(m2, i, vv);
    if (has_master) store8(master, i, wv);
  }
}

// pass A of lamb: moments (fp32) in place when not skipped, r always
template <typename T>
__global__ void __launch_bounds__(THREADS)
lamb_kernel(const T* __restrict__ p, const T* __restrict__ g,
            float* __restrict__ m1, float* __restrict__ m2,
            const float* __restrict__ master, float* __restrict__ r,
            const float* skip, float skip_host, Hyper h, int flags,
            int64_t nvec) {
  const bool skip_now = skipped(skip, skip_host);
  const bool has_master = flags & MASTER;
  const float omb1 = __fsub_rn(1.f, h.b1), omb2 = __fsub_rn(1.f, h.b2);
  const float bc1 = __fsub_rn(1.f, powf(h.b1, h.step));
  const float bc2 = __fsub_rn(1.f, powf(h.b2, h.step));
  for (int64_t v = blockIdx.x * (int64_t)THREADS + threadIdx.x; v < nvec;
       v += (int64_t)gridDim.x * THREADS) {
    const int64_t i = v * VEC;
    float wv[VEC], gv[VEC], mv[VEC], vv[VEC], rv[VEC];
    if (has_master) load8(master, i, wv);
    else load8(p, i, wv);
    load8(g, i, gv);
    load8(m1, i, mv);
    load8(m2, i, vv);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      mv[k] = __fadd_rn(__fmul_rn(h.b1, mv[k]), __fmul_rn(omb1, gv[k]));
      vv[k] = __fadd_rn(__fmul_rn(h.b2, vv[k]),
                        __fmul_rn(__fmul_rn(omb2, gv[k]), gv[k]));
      const float mhat = __fdiv_rn(mv[k], bc1);
      const float vhat = __fdiv_rn(vv[k], bc2);
      rv[k] = __fadd_rn(__fdiv_rn(mhat, __fadd_rn(__fsqrt_rn(vhat), h.eps)),
                        __fmul_rn(h.wd, wv[k]));
    }
    store8(r, i, rv);
    if (!skip_now) {
      store8(m1, i, mv);
      store8(m2, i, vv);
    }
  }
}

int grid_for(int64_t nvec) {
  // enough blocks to fill 132 SMs several times over; the grid strides
  const int64_t want = (nvec + THREADS - 1) / THREADS;
  const int64_t cap = 132 * 16;
  return static_cast<int>(want < cap ? (want > 0 ? want : 1) : cap);
}

template <typename T>
int launch(int kind, int m_code, int flags, void* p, const void* g, void* s1,
           void* s2, void* master, float* r, const float* skip,
           float skip_host, Hyper h, int64_t nvec, cudaStream_t s) {
  const int grid = grid_for(nvec);
  T* pp = static_cast<T*>(p);
  const T* gp = static_cast<const T*>(g);
  float* wp = static_cast<float*>(master);
  switch (kind) {
    case SGD:
      sgd_kernel<T><<<grid, THREADS, 0, s>>>(pp, gp, skip, skip_host, h, nvec);
      break;
    case MOMENTUM:
      if (m_code == 0)
        momentum_kernel<T, float><<<grid, THREADS, 0, s>>>(
            pp, gp, static_cast<float*>(s1), skip, skip_host, h, flags,
            nvec);
      else
        momentum_kernel<T, T><<<grid, THREADS, 0, s>>>(
            pp, gp, static_cast<T*>(s1), skip, skip_host, h, flags, nvec);
      break;
    case ADAM:
      if (m_code == 0)
        adam_kernel<T, float><<<grid, THREADS, 0, s>>>(
            pp, gp, static_cast<float*>(s1), static_cast<float*>(s2), wp,
            skip, skip_host, h, flags, nvec);
      else
        adam_kernel<T, T><<<grid, THREADS, 0, s>>>(
            pp, gp, static_cast<T*>(s1), static_cast<T*>(s2), wp, skip,
            skip_host, h, flags, nvec);
      break;
    case LAMB:
      lamb_kernel<T><<<grid, THREADS, 0, s>>>(
          pp, gp, static_cast<float*>(s1), static_cast<float*>(s2), wp, r,
          skip, skip_host, h, flags, nvec);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// p_code / m_code: 0 fp32, 1 bf16 (the param and the moment type). n is the
// buffer's element count, a multiple of 8; every pointer is 16-byte
// aligned. s1/s2 are the velocity (momentum) or the two moments (adam,
// lamb); master and r may be null where the kind has none.
extern "C" int multi_tensor_update(int kind, int p_code, int m_code,
                                   int flags, void* p, const void* g,
                                   void* s1, void* s2, void* master,
                                   void* r, const void* skip,
                                   float skip_host, float lr, float step,
                                   float b1, float b2, float eps, float wd,
                                   long long n, void* stream) {
  if (n <= 0 || n % VEC != 0 || p_code < 0 || p_code > 1 || m_code < 0 ||
      m_code > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  // the velocity and adam's moments are the param type or fp32; lamb's
  // moments always fp32
  if ((kind == MOMENTUM || kind == ADAM) && m_code != 0 && m_code != p_code)
    return static_cast<int>(cudaErrorInvalidValue);
  if (kind == LAMB && m_code != 0) return static_cast<int>(cudaErrorInvalidValue);
  const Hyper h{lr, step, b1, b2, eps, wd};
  const int64_t nvec = n / VEC;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sk = static_cast<const float*>(skip);
  float* rp = static_cast<float*>(r);
  if (p_code == 0)
    return launch<float>(kind, m_code, flags, p, g, s1, s2, master, rp, sk,
                         skip_host, h, nvec, s);
  return launch<__nv_bfloat16>(kind, m_code, flags, p, g, s1, s2, master, rp,
                               sk, skip_host, h, nvec, s);
}
