"""Parameters and optimizer state from numpy: how they cross from the JAX
package.

The JAX package's LLaMA parameter tree, as ``{key: np.asarray(value)}``,
becomes the port's tree with the same keys and the same stacked ``[L, ...]``
layer weights, a quantized serving tree included; its AdamW state
``{"step", "m", "v"}`` becomes the port's. The JAX BERT's parameters and
AdamW state cross the same way (``bert_params_from_numpy``,
``bert_opt_state_from_numpy``). A JAX ``Layer``'s ``state_dict()`` as numpy loads into the port's layer
of the same structure (``layer_state_from_numpy``). Tests use them to make
both packages compute the same thing, from the start or from the middle of
a trajectory; the port never reproduces ``jax.random``.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..quantization.serving import quantized_weight_keys
from . import bert
from .llama import LlamaConfig, param_shapes

__all__ = ["params_from_numpy", "opt_state_from_numpy",
           "bert_params_from_numpy", "bert_opt_state_from_numpy",
           "layer_state_from_numpy"]


def _narrow(name: str, arr: np.ndarray) -> torch.Tensor:
    """A quantized weight as its torch dtype: int8 as int8; fp8-e4m3fn
    (numpy's ``float8_e4m3fn`` extension type, from ml_dtypes) through its
    bytes, viewed as uint8 and then as ``torch.float8_e4m3fn`` (the same
    OCP format, so nothing is rounded)."""
    if arr.dtype == np.int8:
        return torch.from_numpy(arr.copy())
    if arr.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(arr.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    raise TypeError(f"{name}: a quantized weight must be int8 or "
                    f"float8_e4m3fn, got {arr.dtype}")


def params_from_numpy(np_params: Mapping[str, np.ndarray], cfg: LlamaConfig,
                      device="cuda", dtype: Optional[torch.dtype] = None
                      ) -> Dict[str, torch.Tensor]:
    """Tensors on ``device`` in ``dtype`` (default ``cfg.dtype``, the type
    every use site computes in) from a numpy parameter tree. A quantized
    tree (``quantize_llama_params``: every quantized weight beside its
    ``<name>_scale``) keeps its narrow weights narrow and its scales fp32.
    The tree's layout must be ``cfg``'s (``fused_weights``: ``wqkv`` and
    ``w_gate_up``). Raises on a missing or extra key (a tree of the other
    layout, or a partly quantized one) or a shape that does not match
    ``cfg``."""
    device = resolve_device(device)
    dtype = dtype or cfg.dtype
    shapes = param_shapes(cfg)
    qkeys = quantized_weight_keys(cfg)
    quantized = any(k + "_scale" in np_params for k in qkeys)
    if quantized:
        for k in qkeys:
            shapes[k + "_scale"] = shapes[k][:-2] + shapes[k][-1:]
    if set(np_params) != set(shapes):
        raise KeyError(f"parameter keys {sorted(np_params)} do not match "
                       f"the LLaMA tree {sorted(shapes)}")
    out = {}
    for name, shape in shapes.items():
        arr = np.asarray(np_params[name])
        if arr.shape != shape:
            raise ValueError(f"{name}: shape {arr.shape} != {shape}")
        if quantized and name in qkeys:
            out[name] = _narrow(name, arr).to(device)
        elif name.endswith("_scale"):
            out[name] = torch.tensor(arr, dtype=torch.float32, device=device)
        else:
            out[name] = torch.tensor(arr.astype(np.float32), dtype=dtype,
                                     device=device)
    return out


def opt_state_from_numpy(np_state: Mapping[str, object], cfg: LlamaConfig,
                         device="cuda") -> Dict[str, object]:
    """The port's AdamW state (``init_opt_state``'s layout) from the JAX
    package's ``{"step", "m", "v"}`` as numpy: ``step`` an int32 0-d
    tensor, the moments fp32 trees checked as ``params_from_numpy``
    checks parameters."""
    device = resolve_device(device)
    return {"step": torch.tensor(int(np.asarray(np_state["step"])),
                                 dtype=torch.int32, device=device),
            "m": params_from_numpy(np_state["m"], cfg, device, torch.float32),
            "v": params_from_numpy(np_state["v"], cfg, device, torch.float32)}


def bert_params_from_numpy(np_params: Mapping[str, np.ndarray],
                           cfg: "bert.BertConfig", device="cuda",
                           dtype: Optional[torch.dtype] = None
                           ) -> Dict[str, torch.Tensor]:
    """The JAX BERT's parameter tree (``{key: numpy array}``) as tensors
    on ``device`` in ``dtype`` (default fp32, the master weights), in
    ``bert.param_shapes``' order. Raises on a missing or extra key or a
    shape that does not match ``cfg``."""
    device = resolve_device(device)
    dtype = dtype or torch.float32
    shapes = bert.param_shapes(cfg)
    if set(np_params) != set(shapes):
        raise KeyError(f"parameter keys {sorted(np_params)} do not match "
                       f"the BERT tree {sorted(shapes)}")
    out = {}
    for name, shape in shapes.items():
        arr = np.asarray(np_params[name])
        if arr.shape != shape:
            raise ValueError(f"{name}: shape {arr.shape} != {shape}")
        out[name] = torch.tensor(arr.astype(np.float32), dtype=dtype,
                                 device=device)
    return out


def bert_opt_state_from_numpy(np_state: Mapping[str, object],
                              cfg: "bert.BertConfig", device="cuda"
                              ) -> Dict[str, object]:
    """The port's AdamW state for BERT (``bert.init_opt_state``'s layout
    over fp32 master weights) from the JAX package's ``{"step", "m",
    "v"}`` as numpy, checked as ``bert_params_from_numpy`` checks
    parameters."""
    device = resolve_device(device)
    return {"step": torch.tensor(int(np.asarray(np_state["step"])),
                                 dtype=torch.int32, device=device),
            "m": bert_params_from_numpy(np_state["m"], cfg, device),
            "v": bert_params_from_numpy(np_state["v"], cfg, device)}


def _tensor(name: str, arr) -> torch.Tensor:
    """A numpy array as a tensor of its own type: fp32 and int as they
    are, bf16 (numpy's ``bfloat16`` extension type, from ml_dtypes) through
    its bytes, so nothing is rounded."""
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16).copy()).view(
            torch.bfloat16)
    if arr.dtype.kind not in "fiub":
        raise TypeError(f"{name}: cannot load an array of {arr.dtype}")
    return torch.from_numpy(arr.copy())


def layer_state_from_numpy(model, np_state: Mapping[str, object],
                           device="cuda"):
    """Load a JAX ``Layer``'s ``state_dict()`` (as ``{key: numpy array}``)
    into ``model``, a port ``Layer`` of the same structure, on ``device``:
    every parameter and buffer takes the array's values and type (bf16
    stays bf16) and stays the same object. Raises on a missing or extra
    key or a shape mismatch. Returns ``model``."""
    device = resolve_device(device)
    own = model.state_dict()
    if set(np_state) != set(own):
        raise KeyError(f"state keys differ: missing "
                       f"{sorted(set(own) - set(np_state))}, extra "
                       f"{sorted(set(np_state) - set(own))}")
    with torch.no_grad():
        for key, target in own.items():
            val = _tensor(key, np_state[key])
            if tuple(val.shape) != tuple(target.shape):
                raise ValueError(f"{key}: shape {tuple(val.shape)} != "
                                 f"{tuple(target.shape)}")
            target.data = val.to(device)
    return model
