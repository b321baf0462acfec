/* Custom C++ op ABI for paddle_tpu_torch.
 *
 * Reference counterpart: the custom-op header `paddle/phi/api/ext/op_meta_info.h`
 * (`PD_BUILD_OP`). The contract is a plain C ABI: an op is
 * `extern "C" void name(const PTTensor* ins, int n_in, PTMutableTensor* outs,
 * int n_out)`. The function runs on the host: inputs on the card are copied
 * to host memory for the call and its outputs copied back to the inputs'
 * device, so custom C++ ops cover CPU-side logic (tokenisers, samplers,
 * custom IO), as in the JAX package, which calls them from an XLA host
 * callback. The ABI (structs, dtype codes) is that package's, so one source
 * builds against either header.
 */
#ifndef PADDLE_TPU_TORCH_EXT_H
#define PADDLE_TPU_TORCH_EXT_H

#include <cstdint>

extern "C" {

/* dtype codes shared with the Python side */
enum PTDtype : int32_t {
  PT_FLOAT32 = 0,
  PT_FLOAT64 = 1,
  PT_INT32 = 2,
  PT_INT64 = 3,
  PT_BOOL = 4,
};

typedef struct {
  const void* data;
  const int64_t* shape;
  int32_t ndim;
  int32_t dtype;
} PTTensor;

typedef struct {
  void* data;
  const int64_t* shape;
  int32_t ndim;
  int32_t dtype;
} PTMutableTensor;

typedef void (*PTOpFn)(const PTTensor* ins, int32_t n_in,
                       PTMutableTensor* outs, int32_t n_out);

}  /* extern "C" */

static inline int64_t pt_numel(const PTTensor* t) {
  int64_t n = 1;
  for (int32_t i = 0; i < t->ndim; ++i) n *= t->shape[i];
  return n;
}

static inline int64_t pt_numel_mut(const PTMutableTensor* t) {
  int64_t n = 1;
  for (int32_t i = 0; i < t->ndim; ++i) n *= t->shape[i];
  return n;
}

#endif  /* PADDLE_TPU_TORCH_EXT_H */
