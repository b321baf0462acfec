"""Serving-time quantization: int8 / fp8 weights and K/V pages.

Port of ``paddle_tpu/quantization/serving.py``, the numeric side of
quantized serving:

* **Weights.** Every projection matrix (wq/wk/wv/wo, w_gate/w_up/w_down)
  and lm_head is stored int8 or fp8-e4m3fn with a per-output-channel fp32
  scale under a companion ``<name>_scale`` key: absmax over the
  contraction dim, symmetric round-half-even into [-127, 127] for int8, a
  direct e4m3fn cast after scaling the absmax to 448 for fp8. Norm gains
  and the embedding stay in the compute dtype.
* **K/V rows.** Rows written to a quantized paged pool are narrowed with
  one fp32 scale per cache row (absmax over the row's [Hkv, D] tile); the
  scales live in per-page planes ``[L, num_pages, page_size]`` beside the
  pages (``models.llama.init_paged_pool(quant=...)``), so page copies move
  them with the rows.

The bytes equal the JAX package's for both modes: ``torch.round`` rounds
half to even as ``jnp.round`` does, and the division and the casts are
the same IEEE operations. One edge differs and the recipe never reaches
it: ``.to(torch.float8_e4m3fn)`` saturates magnitudes of 464 and above
to 448, where XLA's cast makes NaN; the recipe's scaled values are at most
448 times (1 + a few fp32 ulps), which both round to 448.

Dequantization is the consumers' business: ``ops.kernels.quant_matmul``
on the decode tick's projections, ``models.llama._w`` (dense, before the
dot) on the prefill projections, and the paged gather on attention.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

__all__ = ["QUANT_MODES", "QUANT_CODES", "quant_dtype",
           "quantized_weight_keys", "quantize_weight", "dequantize_weight",
           "quantize_llama_params", "quantize_kv_rows"]

QUANT_MODES = ("int8", "fp8")
# mode -> the int code the JAX package's program keys carry (0 = none)
QUANT_CODES = {"int8": 1, "fp8": 2}

_INT8_QMAX = 127.0
_E4M3_MAX = 448.0  # largest finite e4m3fn magnitude
# a channel or row of zeros still gets a finite scale
_SCALE_FLOOR = 1e-9


def quant_dtype(mode: str) -> torch.dtype:
    """Storage dtype for ``mode`` ('int8' | 'fp8')."""
    if mode == "int8":
        return torch.int8
    if mode == "fp8":
        return torch.float8_e4m3fn
    raise ValueError(f"unknown quant mode {mode!r}; expected one of "
                     f"{QUANT_MODES}")


def quantized_weight_keys(cfg) -> Tuple[str, ...]:
    """The parameter keys quantization narrows: every per-layer matmul
    weight (the fused or the split layout, by ``cfg.fused_weights``) and
    lm_head. Norm gains and the embedding stay in floating point."""
    if cfg.fused_weights:
        layer = ("wqkv", "wo", "w_gate_up", "w_down")
    else:
        layer = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
    return layer + ("lm_head",)


def _narrow(xf: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype):
    """``xf / scale`` (fp32, ``scale`` broadcast) in the narrow dtype."""
    y = xf / scale
    if dtype == torch.int8:
        return torch.clamp(torch.round(y), -_INT8_QMAX,
                           _INT8_QMAX).to(torch.int8)
    return y.to(dtype)


def quantize_weight(w: torch.Tensor, mode: str):
    """(narrow weight, per-output-channel fp32 scale) of ``w`` [..., in,
    out] (stacked [L, in, out] layer weights or the [in, out] lm_head);
    the scale has shape [..., out]."""
    dtype = quant_dtype(mode)
    wf = w.float()
    amax = torch.clamp(wf.abs().amax(dim=-2), min=_SCALE_FLOOR)
    scale = amax / (_INT8_QMAX if mode == "int8" else _E4M3_MAX)
    return _narrow(wf, scale[..., None, :], dtype), scale


def dequantize_weight(q: torch.Tensor, scale: torch.Tensor,
                      dt: torch.dtype = torch.float32) -> torch.Tensor:
    """Dense dequantize: narrow storage times the per-output-channel
    scale, in fp32, then ``dt``."""
    return (q.float() * scale.float()[..., None, :]).to(dt)


def quantize_llama_params(params: Dict[str, torch.Tensor], cfg,
                          mode: str = "int8") -> Dict[str, torch.Tensor]:
    """A serving copy of a LLaMA parameter tree: every key of
    ``quantized_weight_keys`` narrow plus its ``<name>_scale`` plane ([L,
    out] for stacked layer weights, [out] for lm_head); the other entries
    are the same tensors. Quantizing a tree twice raises."""
    quant_dtype(mode)
    out = dict(params)
    for name in quantized_weight_keys(cfg):
        if name + "_scale" in params:
            raise ValueError(f"params already carry {name}_scale — "
                             "refusing to double-quantize")
        out[name], out[name + "_scale"] = quantize_weight(params[name], mode)
    return out


def quantize_kv_rows(x: torch.Tensor, pool_dtype: torch.dtype):
    """Fresh K/V rows ``x`` [B, T, Hkv, D] for a narrow pool: (narrow rows
    of the same shape, fp32 scales [B, T]), one scale per cache row."""
    xf = x.float()
    amax = torch.clamp(xf.abs().amax(dim=(-2, -1)), min=_SCALE_FLOOR)
    scale = amax / (_INT8_QMAX if pool_dtype == torch.int8 else _E4M3_MAX)
    return _narrow(xf, scale[..., None, None], pool_dtype), scale
