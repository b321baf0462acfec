"""The chip fit: will a replica fit its card's memory, before it is built.

Port of the static half of ``paddle_tpu/analysis/memory.py``
(``page_bytes_for``, ``pool_bytes_for``, ``transient_estimate``,
``chip_fit``, ``family_envelopes``): the envelope of one replica is

    weights + the provisioned page pool (and its page table) + a peak
    transient,

each a byte count over the port's tensors (the params dict, the pager's
pool planes and page table) or their geometry, and the transient the JAX
package's analytic model of one tick or admit wave (the fp32 logits, a
working set of hidden-width activations and the attention scores). The
HLO liveness half of that module has no counterpart in the port.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

__all__ = ["page_bytes_for", "pool_bytes_for", "transient_estimate",
           "chip_fit", "family_envelopes"]


def _itemsize(dtype) -> int:
    return torch.empty(0, dtype=dtype).element_size()


def _nbytes(t: torch.Tensor) -> int:
    return int(t.numel()) * t.element_size()


def page_bytes_for(cfg, page_size: int, quant: Optional[str] = None) -> int:
    """Bytes one pool page holds across all layers: the K and V planes
    ``[L, page_size, Hkv, D]``, plus the fp32 row-scale planes of a
    quantized pool."""
    if quant is not None:
        from ..quantization.serving import quant_dtype

        itemsize = _itemsize(quant_dtype(quant))
    else:
        itemsize = _itemsize(cfg.dtype)
    kv = 2 * cfg.num_layers * page_size * cfg.num_kv_heads * cfg.head_dim \
        * itemsize
    scales = (2 * cfg.num_layers * page_size * 4) if quant else 0
    return kv + scales


def pool_bytes_for(cfg, num_pages: int, page_size: int,
                   quant: Optional[str] = None) -> int:
    """Provisioned pool bytes: every page is allocated up front, the trash
    page included (``llama.init_paged_pool``)."""
    return num_pages * page_bytes_for(cfg, page_size, quant)


def transient_estimate(cfg, *, n_pad: int, s_max: int,
                       tokens_per_tick: int = 1) -> int:
    """The analytic peak transient of one tick or admit wave: the fp32
    logits (one per emitted position of a verify tick), six hidden-width
    activations over the admit window and the attention scores. An
    estimate for sizing replicas, not a measurement."""
    itemsize = _itemsize(cfg.dtype)
    logits = n_pad * tokens_per_tick * cfg.vocab_size * 4
    hidden = 6 * n_pad * s_max * cfg.hidden_size * itemsize
    scores = n_pad * cfg.num_heads * s_max * s_max * itemsize
    return int(logits + hidden + scores)


def chip_fit(cfg=None, params=None, *, pool=None, page_size=None,
             num_pages=None, quant=None, mesh_devices: int = 1,
             hbm_bytes: int, weights_bytes: Optional[int] = None,
             transient_bytes: Optional[int] = None,
             n_pad: Optional[int] = None, s_max: Optional[int] = None,
             live_pages: Optional[int] = None,
             trace_stats: Optional[dict] = None,
             program_family: str = "pseg") -> dict:
    """Will this replica fit ``hbm_bytes``: ``envelope_bytes = weights +
    provisioned pool + peak transient``, each per device (weights and pool
    split over ``mesh_devices``). ``params``: the params dict (its tensors'
    bytes); ``pool``: a live ``PagedKVCache`` (its planes and page table
    summed exactly) or the geometry (``page_size``, ``num_pages``).
    ``live_pages`` (or ``trace_stats``) prices the live KV at its high
    water (``kv_live_bytes``)."""
    if weights_bytes is None:
        weights_bytes = sum(_nbytes(t) for t in params.values())
    weights_bytes = -(-int(weights_bytes) // max(1, mesh_devices))

    if pool is not None:
        pool_b = sum(_nbytes(v) for v in pool.pool.values())
        pool_b += _nbytes(pool.page_table)
        page_size = pool.page_size
        num_pages = pool.num_pages
        page_b = page_bytes_for(cfg, page_size, quant)
    else:
        page_b = page_bytes_for(cfg, page_size, quant)
        pool_b = num_pages * page_b
    pool_b = -(-pool_b // max(1, mesh_devices))
    page_b = -(-page_b // max(1, mesh_devices))

    if transient_bytes is None:
        transient_bytes = transient_estimate(
            cfg, n_pad=n_pad if n_pad is not None else 4,
            s_max=s_max if s_max is not None else 4 * (page_size or 16))
    transient_bytes = int(transient_bytes)

    if live_pages is None and trace_stats is not None:
        S = float(trace_stats["mean_prompt_tokens"])
        G = float(trace_stats["mean_new_tokens"])
        span = max(1, math.ceil((S + G - 1) / page_size))
        conc = float(trace_stats.get("concurrency",
                                     trace_stats.get("slots", 1)))
        live_pages = int(math.ceil(conc * span))
    kv_live_bytes = (live_pages * page_b if live_pages is not None
                     else None)

    envelope = weights_bytes + pool_b + transient_bytes
    headroom = hbm_bytes - envelope
    return {
        # the JAX package's label (SCALING.md section 3s is its source)
        "arithmetic": "SCALING §3s static HBM envelope: weights + "
                      "provisioned pool + peak transient",
        "program_family": program_family,
        "mesh_devices": int(mesh_devices),
        "hbm_bytes": int(hbm_bytes),
        "weights_bytes": int(weights_bytes),
        "pool_bytes": int(pool_b),
        "page_bytes": int(page_b),
        "num_pages": int(num_pages) if num_pages else None,
        "transient_bytes": transient_bytes,
        "envelope_bytes": int(envelope),
        "fits": bool(envelope <= hbm_bytes),
        "headroom_bytes": int(headroom),
        "headroom_pages": int(headroom // page_b) if headroom > 0 else 0,
        "utilization": round(envelope / hbm_bytes, 4),
        "predicted_high_water_pages": live_pages,
        "kv_live_bytes": (int(kv_live_bytes)
                          if kv_live_bytes is not None else None),
    }


def family_envelopes(engine, envelope, *, hbm_bytes: Optional[int] = None,
                     mesh_devices: int = 1) -> Dict[str, dict]:
    """Per-family envelopes over the engine's program space: each family
    the workload envelope reaches priced at its widest key (admit rows x
    window x tokens a tick). Weights and pool are shared; only the
    transient differs per family. With ``hbm_bytes`` (and a paged
    engine), each entry carries its ``chip_fit``."""
    from ..inference.program_space import PROGRAM_SPACE

    by_fam = PROGRAM_SPACE.enumerate_by_family(engine, envelope)
    cfg = engine.cfg
    pager = getattr(engine, "pager", None)
    out: Dict[str, dict] = {}
    for fam_name, keys in sorted(by_fam.items()):
        if not keys:
            continue
        # sorted so the widest-key tie-break is the same every run
        keys = sorted(keys, key=repr)
        fam = PROGRAM_SPACE.family(fam_name)
        widest_pad, widest_span, widest_tok = 1, 1, 1
        widest_key = keys[0]
        for key in keys:
            # the JAX package's reading of a key: axes against the
            # positions after the first, tagged or not
            kw = dict(zip(fam.axes, key[1:]))
            n_pad = int(kw.get("n_pad", getattr(engine, "slots", 1)) or 1)
            span = max(int(kw.get(a, 0) or 0)
                       for a in ("s_max", "C", "chunk", "width")) or 1
            tok = int(kw.get("K", 0) or 0) + 1
            if n_pad * span * tok >= widest_pad * widest_span * widest_tok:
                widest_pad, widest_span, widest_tok = n_pad, span, tok
                widest_key = key
        transient = transient_estimate(cfg, n_pad=widest_pad,
                                       s_max=widest_span,
                                       tokens_per_tick=widest_tok)
        entry = {"keys": len(keys), "widest_key": widest_key,
                 "transient_bytes": transient,
                 "budget_program": fam.budget_program}
        if hbm_bytes is not None and pager is not None:
            entry["fit"] = chip_fit(
                cfg, engine.params, page_size=pager.page_size,
                num_pages=pager.num_pages,
                quant=getattr(engine, "quant", None),
                mesh_devices=mesh_devices, hbm_bytes=hbm_bytes,
                transient_bytes=transient, program_family=fam_name)
        out[fam_name] = entry
    return out
