"""Fused multi-tensor optimizer update over flat ``[rows, 128]`` buffers.

Replaces the TPU kernel ``paddle_tpu/ops/pallas/multi_tensor_update.py``
(``_run`` <- ``apply_flat_update``, bodies ``_sgd_kernel``,
``_momentum_kernel``, ``_adam_kernel``, ``_lamb_kernel``). The CUDA kernel
is ``paddle_tpu_torch/csrc/multi_tensor_update.cu``; its header says what
bounds it on the H100 (bytes: 10 B per element for bf16 momentum) and how
it streams.

Every group of parameters that share a dtype, a state structure and the
optimizer's static extras gets one ``FlatPlan``: tensor i owns rows
``[row_offsets[i], row_offsets[i] + rows[i])`` of a ``[total_rows, 128]``
buffer, tail lanes and tail rows zero. ``apply_flat_update`` packs the
group's params, grads and state into such buffers, updates them in place
with one kernel launch (``multi_tensor_update``), and hands back the params
as views of the updated buffer in their model shapes and the state as row
segments of its buffers, the form the state keeps between steps.

Dispatch: a CPU tensor takes the plain version (``flat_update_plain``); a
CUDA tensor launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["FlatPlan", "fused_update_active", "apply_flat_update",
           "multi_tensor_update", "flat_update_plain", "weak_scalar",
           "bias_corrections"]

KINDS = ("sgd", "momentum", "adam", "lamb")
_KIND_CODES = {k: i for i, k in enumerate(KINDS)}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_NESTEROV, _MASTER, _DECOUPLED = 1, 2, 4
# the state buffers each kind reads, in the kernel's order
_STATE_KEYS = {"sgd": (), "momentum": ("velocity",),
               "adam": ("moment1", "moment2"), "lamb": ("moment1", "moment2")}


class FlatPlan:
    """Flat layout of a tensor group, the JAX package's arithmetic: tensor
    i owns ``rows[i] = ceil(size_i / 128)`` rows starting at
    ``row_offsets[i]``; the total is padded to a multiple of 16 rows;
    ``seg_ids`` maps each row to its tensor (padding rows to
    ``len(shapes)``, which every consumer drops)."""

    LANES = 128

    def __init__(self, shapes: Sequence[Tuple[int, ...]]):
        self.shapes = [tuple(int(d) for d in s) for s in shapes]
        self.sizes = [int(np.prod(s)) if s else 1 for s in self.shapes]
        self.rows = [-(-n // self.LANES) for n in self.sizes]
        self.row_offsets = np.concatenate(
            [[0], np.cumsum(self.rows)]).astype(np.int64)
        used = int(self.row_offsets[-1])
        self.total_rows = -(-used // 16) * 16
        self.block_rows = next(b for b in (512, 256, 128, 64, 32, 16)
                               if self.total_rows % b == 0)
        self.grid = self.total_rows // self.block_rows
        seg = np.full((self.total_rows,), len(self.shapes), np.int32)
        for i in range(len(self.shapes)):
            seg[self.row_offsets[i]:self.row_offsets[i + 1]] = i
        self.seg_ids = seg
        self._zeros: Dict[Tuple[torch.dtype, torch.device], torch.Tensor] = {}
        self._seg: Dict[torch.device, torch.Tensor] = {}

    def _pad(self, dtype, device) -> torch.Tensor:
        # a tensor's tail lanes (< 128) and the tail rows (< 16) come from
        # one zero vector, sliced
        key = (dtype, device)
        z = self._zeros.get(key)
        if z is None:
            z = self._zeros[key] = torch.zeros(16 * self.LANES, dtype=dtype,
                                               device=device)
        return z

    def seg_ids_on(self, device) -> torch.Tensor:
        device = torch.device(device)
        s = self._seg.get(device)
        if s is None:
            s = self._seg[device] = torch.from_numpy(
                self.seg_ids.astype(np.int64)).to(device)
        return s

    def pack(self, vals: Sequence[torch.Tensor], dtype=None) -> torch.Tensor:
        """Shaped (or already flat-segment) tensors -> one new
        ``[total_rows, 128]`` buffer, in ``dtype`` if given (one
        concatenation: each tensor flattened, its tail lanes zero)."""
        dtype = dtype or vals[0].dtype
        zeros = self._pad(dtype, vals[0].device)
        parts: List[torch.Tensor] = []
        for v, rows, n in zip(vals, self.rows, self.sizes):
            # a flat segment's tail lanes are zero: dropped and re-padded
            parts.append(v.reshape(-1)[:n].to(dtype))
            pad = rows * self.LANES - n
            if pad:
                parts.append(zeros[:pad])
        tail = (self.total_rows - int(self.row_offsets[-1])) * self.LANES
        if tail:
            parts.append(zeros[:tail])
        return torch.cat(parts).view(self.total_rows, self.LANES)

    def segment(self, buf: torch.Tensor, i: int) -> torch.Tensor:
        """Tensor i's rows of ``buf``: a view (the form state keeps)."""
        r0 = int(self.row_offsets[i])
        return buf[r0:r0 + self.rows[i]]

    def unpack(self, buf: torch.Tensor, i: int) -> torch.Tensor:
        """Tensor i in its model shape: a view into ``buf``."""
        return self.segment(buf, i).reshape(-1)[:self.sizes[i]].view(
            self.shapes[i])


def fused_update_active(n_tensors: int, kind: Optional[str]) -> bool:
    """True when a parameter group takes the flat update: a supported
    optimizer kind and at least 2 tensors (a singleton updates alone). The
    port takes the flat path on every device: on the CPU it runs the
    kernel's plain version."""
    return kind in KINDS and n_tensors >= 2


def weak_scalar(x, dtype) -> float:
    """A Python number as JAX treats a weak-typed scalar meeting a
    ``dtype`` array: rounded to ``dtype`` first (returned as a Python
    float, so a product with it rounds as one of two ``dtype`` values)."""
    return torch.tensor(float(x), dtype=torch.float32).to(dtype).item()


def _f32(x) -> float:
    return float(np.float32(x))


def bias_corrections(b1, b2, step) -> Tuple[float, float]:
    """Adam's ``1 - b1**step`` and ``1 - b2**step`` in fp32."""
    s = torch.tensor(_f32(step))
    return ((1 - torch.tensor(_f32(b1)) ** s).item(),
            (1 - torch.tensor(_f32(b2)) ** s).item())


def _decoupled(hyper) -> bool:
    return (bool(hyper.get("decoupled"))
            and float(hyper.get("decay", 0.0)) != 0.0)


def flat_update_plain(kind: str, pbuf: torch.Tensor, gbuf: torch.Tensor,
                      sbufs: Dict[str, torch.Tensor], hyper: Dict[str, Any],
                      lr, step, skip=None) -> Optional[torch.Tensor]:
    """The plain PyTorch version of ``multi_tensor_update``, with the
    kernel's arithmetic (one rounding per operation, in the buffer's type):
    updates ``pbuf`` and ``sbufs`` in place unless ``skip`` > 0; returns
    lamb's raw update ``r`` (fp32), else None."""
    _check(kind, pbuf, gbuf, sbufs, hyper)
    pt = pbuf.dtype
    lr = _f32(lr)
    new: Dict[str, torch.Tensor] = {}
    r = None
    if kind == "sgd":
        new["p"] = pbuf - weak_scalar(lr, pt) * gbuf
    elif kind == "momentum":
        v = sbufs["velocity"]
        mu = weak_scalar(hyper["momentum"], v.dtype)
        g = gbuf.to(v.dtype)
        v_new = mu * v + g
        upd = g + mu * v_new if hyper.get("nesterov") else v_new
        new["p"] = pbuf - weak_scalar(lr, pt) * upd.to(pt)
        new["velocity"] = v_new
    else:
        m, v = sbufs["moment1"], sbufs["moment2"]
        b1, b2 = _f32(hyper["beta1"]), _f32(hyper["beta2"])
        eps, wd = _f32(hyper["epsilon"]), _f32(hyper.get("decay", 0.0))
        bc1, bc2 = bias_corrections(b1, b2, step)
        master = sbufs.get("master")
        if kind == "adam":
            dt = m.dtype
            gf = gbuf.to(dt)
            omb1 = weak_scalar(_f32(1 - np.float32(b1)), dt)
            omb2 = weak_scalar(_f32(1 - np.float32(b2)), dt)
            m_new = weak_scalar(b1, dt) * m + omb1 * gf
            v_new = weak_scalar(b2, dt) * v + (omb2 * gf) * gf
            upd = lr * (m_new.float() / bc1) / ((v_new.float() / bc2).sqrt()
                                                + eps)
            lrwd = _f32(np.float32(lr) * np.float32(wd))
            if master is not None:
                w_new = master - upd
                if _decoupled(hyper):
                    w_new = w_new - lrwd * master
                new["master"] = w_new
                new["p"] = w_new.to(pt)
            else:
                p_new = pbuf - upd.to(pt)
                if _decoupled(hyper):
                    p_new = p_new - weak_scalar(lrwd, pt) * pbuf
                new["p"] = p_new
        else:  # lamb, pass A
            pf = master if master is not None else pbuf.float()
            gf = gbuf.float()
            m_new = b1 * m + _f32(1 - np.float32(b1)) * gf
            v_new = b2 * v + (_f32(1 - np.float32(b2)) * gf) * gf
            r = (m_new / bc1) / ((v_new / bc2).sqrt() + eps) + wd * pf
        new["moment1"], new["moment2"] = m_new, v_new
    gate = _skip_gate(skip, pbuf.device)
    for key, val in new.items():
        old = pbuf if key == "p" else sbufs[key]
        old.copy_(val if gate is None else torch.where(gate, old, val))
    return r


def _skip_gate(skip, device):
    """``skip > 0`` as a bool tensor on ``device`` (None without skip)."""
    if skip is None:
        return None
    if isinstance(skip, torch.Tensor):
        return skip.to(device) > 0
    return torch.tensor(float(skip) > 0, device=device)


def _check(kind, pbuf, gbuf, sbufs, hyper):
    if kind not in KINDS:
        raise ValueError(f"unknown update kind {kind!r}; one of {KINDS}")
    if pbuf.dim() != 2 or pbuf.shape[1] != FlatPlan.LANES \
            or gbuf.shape != pbuf.shape:
        raise ValueError(f"params and grads must be one [rows, 128] buffer "
                         f"each, got {tuple(pbuf.shape)}, "
                         f"{tuple(gbuf.shape)}")
    if pbuf.dtype not in _DTYPE_CODES or gbuf.dtype != pbuf.dtype:
        raise TypeError(f"params must be float32 or bfloat16 and grads of "
                        f"the same type, got {pbuf.dtype}, {gbuf.dtype}")
    want = set(_STATE_KEYS[kind])
    have = set(sbufs) - {"master"}
    if have != want or ("master" in sbufs and kind not in ("adam", "lamb")):
        raise ValueError(f"{kind} takes state {sorted(want)} (adam and lamb "
                         f"also a master), got {sorted(sbufs)}")
    for key, buf in sbufs.items():
        if buf.shape != pbuf.shape or buf.device != pbuf.device:
            raise ValueError(f"state {key!r}: {tuple(buf.shape)} on "
                             f"{buf.device}, params {tuple(pbuf.shape)} on "
                             f"{pbuf.device}")
    if kind == "momentum" and sbufs["velocity"].dtype not in (
            pbuf.dtype, torch.float32):
        raise TypeError(f"momentum's velocity must be fp32 or the param "
                        f"type, got {sbufs['velocity'].dtype}")
    if kind in ("adam", "lamb"):
        mdt = sbufs["moment1"].dtype
        master = sbufs.get("master")
        if not (sbufs["moment2"].dtype == mdt
                and (mdt == torch.float32
                     or (kind == "adam" and mdt == pbuf.dtype))
                and (master is None or (mdt == torch.float32
                                        and master.dtype == torch.float32))):
            raise TypeError(f"{kind}: moments {mdt} / "
                            f"{sbufs['moment2'].dtype} do not fit params "
                            f"{pbuf.dtype} (adam: the param type or fp32; "
                            f"lamb: fp32; fp32 beside a master, itself fp32)")
    need = {"momentum": ("momentum",), "adam": ("beta1", "beta2", "epsilon"),
            "lamb": ("beta1", "beta2", "epsilon")}.get(kind, ())
    missing = [k for k in need if k not in hyper]
    if missing:
        raise KeyError(f"{kind} needs hyper {missing}")


def multi_tensor_update(kind: str, pbuf: torch.Tensor, gbuf: torch.Tensor,
                        sbufs: Dict[str, torch.Tensor],
                        hyper: Dict[str, Any], lr, step,
                        skip=None) -> Optional[torch.Tensor]:
    """One group's update, in place: ``pbuf`` (params) and ``sbufs``
    (``velocity``; or ``moment1``, ``moment2`` and an optional fp32
    ``master``) are ``[rows, 128]`` buffers updated where they lie, unless
    ``skip`` (None, a number, or a tensor on the buffers' device, read by
    the kernel without a host sync) is > 0, which leaves every buffer
    bit-identical. ``gbuf`` holds the grads in the param type. ``hyper``:
    ``momentum`` and ``nesterov`` (momentum); ``beta1``, ``beta2``,
    ``epsilon``, ``decay`` and ``decoupled`` (adam, lamb). Returns lamb's
    raw update ``r`` (fp32, ``[rows, 128]``; the trust-scaled step is the
    caller's), else None."""
    if pbuf.device.type == "cpu":
        return flat_update_plain(kind, pbuf, gbuf, sbufs, hyper, lr, step,
                                 skip)
    if pbuf.device.type != "cuda":
        raise ValueError(f"no kernel for device {pbuf.device}")
    _check(kind, pbuf, gbuf, sbufs, hyper)
    bufs = [pbuf, gbuf, *sbufs.values()]
    if not all(b.is_contiguous() and b.data_ptr() % 16 == 0 for b in bufs):
        raise ValueError("the flat buffers must be contiguous and 16-byte "
                         "aligned")
    r = (torch.empty(pbuf.shape, dtype=torch.float32, device=pbuf.device)
         if kind == "lamb" else None)
    skip_ptr, skip_host = None, 0.0
    if isinstance(skip, torch.Tensor):
        if skip.device != pbuf.device or skip.numel() != 1:
            raise ValueError(f"skip must be one value on {pbuf.device}, got "
                             f"{tuple(skip.shape)} on {skip.device}")
        skip = skip.to(torch.float32).contiguous()
        skip_ptr = skip.data_ptr()
    elif skip is not None:
        skip_host = float(skip)
    state = [sbufs.get(k) for k in _STATE_KEYS[kind]]
    state += [None] * (2 - len(state))
    master = sbufs.get("master")
    flags = ((_NESTEROV if hyper.get("nesterov") else 0)
             | (_MASTER if master is not None else 0)
             | (_DECOUPLED if _decoupled(hyper) else 0))
    mdt = state[0].dtype if state[0] is not None else pbuf.dtype
    h3 = hyper.get("momentum", hyper.get("beta1", 0.0))
    with torch.cuda.device(pbuf.device):
        err = _kernel()(
            _KIND_CODES[kind], _DTYPE_CODES[pbuf.dtype], _DTYPE_CODES[mdt],
            flags, pbuf.data_ptr(), gbuf.data_ptr(),
            *(None if s is None else s.data_ptr() for s in state),
            None if master is None else master.data_ptr(),
            None if r is None else r.data_ptr(), skip_ptr, skip_host,
            _f32(lr), _f32(step), _f32(h3), _f32(hyper.get("beta2", 0.0)),
            _f32(hyper.get("epsilon", 0.0)), _f32(hyper.get("decay", 0.0)),
            pbuf.numel(), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"multi_tensor_update launch failed: CUDA error "
                           f"{err}")
    multi_tensor_update.launches += 1
    return r


multi_tensor_update.launches = 0


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry point, built and loaded at first use; every pointer and
    the stream are ``c_void_p`` and the element count ``c_longlong``, so
    none is cut to 32 bits."""
    from ._build import load_library

    fn = load_library("multi_tensor_update").multi_tensor_update
    fn.argtypes = ([ctypes.c_int] * 4 + [ctypes.c_void_p] * 7
                   + [ctypes.c_float] * 7 + [ctypes.c_longlong,
                                             ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def apply_flat_update(kind: str, plan: FlatPlan,
                      pvals: Sequence[torch.Tensor],
                      gvals: Sequence[torch.Tensor],
                      svals: Sequence[Dict[str, torch.Tensor]],
                      hyper: Dict[str, Any], lr, step,
                      skip=None) -> Tuple[List[torch.Tensor],
                                          List[Dict[str, torch.Tensor]]]:
    """One fused update over a whole tensor group.

    ``svals[i][k]`` may be shaped (a first step or restored state) or this
    plan's flat row segment (every later step, the form this function
    returns state in). ``skip`` (optional, > 0 skips the update) is the
    AMP found_inf flag. Returns (new params in their model shapes, views
    into the updated flat buffer; new state as flat row segments)."""
    state_keys = list(svals[0].keys()) if svals and svals[0] else []
    pbuf = plan.pack(pvals)
    gbuf = plan.pack(gvals, dtype=pbuf.dtype)
    sbufs = {k: plan.pack([s[k] for s in svals]) for k in state_keys}
    r = multi_tensor_update(kind, pbuf, gbuf, sbufs, hyper, lr, step, skip)
    if kind == "lamb":
        # the trust-ratio epilogue: per-tensor sums of w^2 and r^2 over the
        # plan's segment ids (padding rows land in the last segment, which
        # is dropped), then the trust-scaled step, all on [rows, 128]
        master = sbufs.get("master")
        pf = master if master is not None else pbuf.float()
        seg = plan.seg_ids_on(pbuf.device)
        nseg = len(plan.shapes) + 1
        zeros = torch.zeros(nseg, dtype=torch.float32, device=pbuf.device)
        w_n = zeros.index_add(0, seg, (pf * pf).sum(1)).sqrt()
        r_n = zeros.index_add(0, seg, (r * r).sum(1)).sqrt()
        trust = torch.where((w_n > 0) & (r_n > 0), w_n / r_n, 1.0)
        pf_new = pf - (_f32(lr) * trust[seg])[:, None] * r
        gate = _skip_gate(skip, pbuf.device)
        if gate is not None:
            pf_new = torch.where(gate, pf, pf_new)
        pbuf = pf_new.to(pbuf.dtype)
        if master is not None:
            sbufs["master"] = pf_new
    new_p = [plan.unpack(pbuf, i) for i in range(len(pvals))]
    new_s = [{k: plan.segment(sbufs[k], i) for k in state_keys}
             for i in range(len(pvals))]
    return new_p, new_s
