"""LLaMA-family decoder, trained and served, in PyTorch.

Port of ``paddle_tpu/models/llama.py``: the config and its presets,
parameter init, the KV-cache half (the prefill forward, T > 1, plain
torch, and the single-token decode tick, T == 1, over a slot-contiguous
cache, ``forward_with_cache``, or a paged pool, ``forward_with_pages``),
generation (``prompt_kv``; greedy, sampled and top-k/top-p ``generate``;
``beam_search_generate``, whose decode steps are the same tick) and the
single-device training half (``forward``, ``loss_fn`` with its
three cross-entropy branches, ``train_step`` with the global-norm clip and
AdamW, ``make_train_step``). The tick's between-matmul chains, every
attention and the CE tail's dx run as the hand-written kernels of
``ops/kernels``:

- ``fused_rms_norm`` / ``fused_add_rms_norm`` and ``fused_rope_qk``
  (CUDA C++) replace the inline rmsnorm,
  residual+rmsnorm and rope chains;
- ``ragged_decode_attention`` (CUDA C++) reads each slot's cache rows
  [0, pos] only;
- ``ragged_paged_attention`` (CUDA C++) serves the paged decode ticks and
  the paged prefill chunks, reading each slot's pages up to its position;
- ``quant_matmul`` (CUDA C++) runs every projection of the tick and the
  lm_head of a quantized parameter tree (``quantization/serving.py``),
  dequantizing the int8 or fp8 weights in the kernel;
- the flash-attention forward, dq and dk/dv kernels (CUDA C++) serve the
  training attention and its backward, ``head_dx_softmax`` (CUDA C++) the
  softmax term of the custom CE tail's dh.

The config takes every field of the JAX package's. ``fused_weights``
stores wq/wk/wv as one ``wqkv`` [L, H, H + 2 Hkv] and w_gate/w_up as one
``w_gate_up`` [L, H, 2F], so each is one product whose output splits into
q/k/v (gate/up) by columns: the decode tick's rope reads q and k from that
output by its row stride, without a copy. ``bf16_grads`` differentiates
with respect to ``cfg.dtype`` copies of fp32 parameters, so the gradients
stay in that type through the clip; AdamW updates the fp32 masters.
``bwd_barriers`` names cotangents the JAX package fences with an
optimization barrier; eager PyTorch materialises every cotangent once, so
a barrier would be the identity in value and gradient: the names are
validated and change nothing. ``fused_tick_epilogue=False`` runs the
decode tick's rms, add + rms and rope as the inline chains; its attention
keeps the decode kernel on the contiguous cache and the paged kernel on a
pool, whose dispatch the JAX package keys on the shape alone.
``scan_layers`` and ``sharding_stage`` change nothing on one device
(layers always run unrolled; without a mesh the JAX package's sharding
constraints are no-ops), and ``sequence_parallel`` without a ``sep`` axis
computes plain attention, as the JAX package falls back to it.

On a mesh (``param_specs``, ``opt_state_specs``, ``shard_state``,
``gather_state``, ``make_sharded_train_step``) each rank holds its shards
and the step runs the reference's multi-device branch: Megatron's
column- and row-parallel products with ``copy_to`` / ``reduce_from`` over
mp (``distributed.fleet``'s ``mp_layers``), the vocab-parallel embedding
and ``parallel_cross_entropy`` (no custom CE tail, no chunks), the rows
split over sep under ``sequence_parallel`` (rope at global positions;
ring or Ulysses attention), ZeRO 1–3 and the global-norm clip in
``parallel/sharded.py``. The flash kernels serve each rank's local heads.

Layout follows the JAX package so the two are compared like with like:
parameters are a dict with the same keys and stacked ``[L, ...]`` layer
weights, the cache is ``{"k", "v"}`` of ``[L, B, max_len, Hkv, D]``, the
pool ``{"k", "v"}`` of ``[L, num_pages, page_size, Hkv, D]`` (a quantized
pool adds the row-scale planes ``{"ks", "vs"}`` of ``[L, num_pages,
page_size]``), and layers run as an unrolled loop. Cache and pool are
updated in place, and so are parameters and optimizer state in
``train_step``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..distributed.fleet.meta_parallel.parallel_layers.mp_layers import (
    copy_to, parallel_cross_entropy, reduce_from, vocab_parallel_lookup)
from ..ops.kernels import decode_attention as _da
from ..ops.kernels import flash_attention as _fa
from ..ops.kernels import head_dx as _hd
from ..ops.kernels import paged_attention as _pa
from ..ops.kernels import quant_matmul as _qm
from ..ops.kernels import tick_fusion as _tf
from ..quantization.serving import (dequantize_weight, quant_dtype,
                                    quantize_kv_rows)

__all__ = ["LlamaConfig", "LAYER_KEYS", "NO_DECAY_KEYS", "param_shapes",
           "init_params", "fuse_params", "layer_keys", "layer_params",
           "init_kv_cache",
           "init_paged_pool",
           "forward_with_cache", "forward_with_pages", "prompt_kv",
           "sample_filter_logits", "generate", "beam_search_generate",
           "forward_hidden", "forward",
           "loss_fn", "init_opt_state", "adamw_update", "train_step",
           "make_train_step", "param_specs", "opt_state_specs",
           "shard_state", "gather_state", "make_sharded_train_step"]

# stacked [L, ...] per-layer weights, in the JAX package's key names
LAYER_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down",
              "ln_attn", "ln_mlp")
_LAYER_KEYS_FUSED = ("wqkv", "wo", "w_gate_up", "w_down", "ln_attn",
                     "ln_mlp")
SP_IMPLS = ("ring", "ulysses")
BWD_BARRIERS = ("mlp", "qkv", "logits")


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    max_seq_len: int = 2048
    rope_theta: float = 10000.0
    rms_eps: float = 1e-6
    dtype: torch.dtype = torch.bfloat16
    # training: per-layer activation checkpointing (the reference's
    # fleet.recompute); on the flash path the qkv and post halves are
    # checkpointed and attention kept outside, so its O(S) residuals are
    # saved instead of re-running the forward kernel in the backward
    remat: bool = True
    # head + CE over ce_chunks batch chunks, each recomputed in the
    # backward, so the [B, S, V] logits never stay alive (0 = off)
    ce_chunks: int = 0
    # head + CE as one autograd Function whose backward runs the softmax
    # term of dh as the head_dx_softmax kernel and gathers W's gold columns
    ce_tail_custom: bool = False
    # the JAX package's mesh options: on one device ZeRO's stage and the
    # layer scan change nothing (layers run unrolled), and sequence
    # parallelism computes plain attention (no 'sep' axis to shard over);
    # sp_impl must still name one of SP_IMPLS
    sharding_stage: int = 1
    scan_layers: bool = True
    sequence_parallel: bool = False
    sp_impl: str = "ring"
    # comma-joined cotangent barrier sites among BWD_BARRIERS: validated,
    # and nothing to do here (see the module's docstring)
    bwd_barriers: str = ""
    # wq/wk/wv as one [L, H, H + 2 Hkv] "wqkv", w_gate/w_up as one
    # [L, H, 2F] "w_gate_up": one wider product each
    fused_weights: bool = False
    # differentiate with respect to cfg.dtype copies of the fp32 weights:
    # gradients stay in cfg.dtype until AdamW reads them
    bf16_grads: bool = False
    # the decode tick's rms, add + rms and rope as the tick kernels (False:
    # the inline chains; its attention keeps the decode or paged kernel)
    fused_tick_epilogue: bool = True

    def __post_init__(self):
        if self.sp_impl not in SP_IMPLS:
            raise ValueError(f"sp_impl must be one of {SP_IMPLS}, got "
                             f"{self.sp_impl!r}")
        bad = [b for b in self.bwd_barriers.split(",")
               if b.strip() and b.strip() not in BWD_BARRIERS]
        if bad:
            raise ValueError(f"bwd_barriers: unknown sites {bad}; expected "
                             f"a comma-joined subset of {BWD_BARRIERS}")

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @classmethod
    def tiny(cls, **kw):
        """Tiny config for tests."""
        d = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                 num_layers=2, num_heads=4, num_kv_heads=4, max_seq_len=64,
                 dtype=torch.float32, remat=False)
        d.update(kw)
        return cls(**d)

    @classmethod
    def bert_base_equiv(cls, **kw):
        """~110M decoder at the BERT/ERNIE-base budget: the training and
        serving benchmarks' model. No remat (the activations fit) and the
        custom CE tail, as in the JAX package."""
        d = dict(vocab_size=32000, hidden_size=768, intermediate_size=3072,
                 num_layers=12, num_heads=12, num_kv_heads=12,
                 max_seq_len=512, remat=False, scan_layers=False,
                 ce_tail_custom=True)
        d.update(kw)
        return cls(**d)

    @classmethod
    def cpu_small(cls, **kw):
        """~3M-param decoder, fp32: the serving benchmarks' CPU shape."""
        d = dict(vocab_size=2048, hidden_size=128, intermediate_size=512,
                 num_layers=4, num_heads=8, num_kv_heads=8, max_seq_len=512,
                 dtype=torch.float32, remat=False, scan_layers=False)
        d.update(kw)
        return cls(**d)

    @classmethod
    def llama7b(cls, **kw):
        return cls(**kw)  # the defaults are 7B


def _split_shapes(cfg: LlamaConfig) -> Dict[str, tuple]:
    H, F_, V, L = (cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size,
                   cfg.num_layers)
    Hkv = cfg.num_kv_heads * cfg.head_dim
    return {"embed": (V, H), "wq": (L, H, H), "wk": (L, H, Hkv),
            "wv": (L, H, Hkv), "wo": (L, H, H), "w_gate": (L, H, F_),
            "w_up": (L, H, F_), "w_down": (L, F_, H), "ln_attn": (L, H),
            "ln_mlp": (L, H), "ln_f": (H,), "lm_head": (H, V)}


def _fuse(d: dict, join) -> dict:
    """The split tree ``d`` in the fused layout (``fused_weights``): wq, wk,
    wv -> wqkv and w_gate, w_up -> w_gate_up, each ``join``ed in that order
    along the output columns (the JAX package's ``_fuse_keys`` and
    ``init_params``)."""
    out = {k: v for k, v in d.items()
           if k not in ("wq", "wk", "wv", "w_gate", "w_up")}
    out["wqkv"] = join(d["wq"], d["wk"], d["wv"])
    out["w_gate_up"] = join(d["w_gate"], d["w_up"])
    return out


def fuse_params(params) -> Dict[str, torch.Tensor]:
    """A split parameter tree in the fused layout, the same values
    concatenated: the fused model computes the split one's function."""
    return _fuse(params, lambda *ts: torch.cat(ts, dim=-1))


def param_shapes(cfg: LlamaConfig) -> Dict[str, tuple]:
    """Shape of every parameter, keyed as in the JAX package."""
    shapes = _split_shapes(cfg)
    if not cfg.fused_weights:
        return shapes
    return _fuse(shapes, lambda *ss: ss[0][:-1] + (sum(s[-1] for s in ss),))


def layer_keys(cfg: LlamaConfig):
    """The stacked per-layer keys of ``cfg``'s layout."""
    return _LAYER_KEYS_FUSED if cfg.fused_weights else LAYER_KEYS


def init_params(cfg: LlamaConfig, generator: Optional[torch.Generator] = None,
                device="cuda", dtype: Optional[torch.dtype] = None
                ) -> Dict[str, torch.Tensor]:
    """Random parameters with the JAX package's keys, shapes and scales
    (normal * 0.02 for the embedding, normal / sqrt(fan_in) for the
    projections, ones for the norm gains). Numbers are drawn from
    ``generator`` on the generator's device, then stored on ``device`` in
    ``dtype`` (default ``cfg.dtype``: every use site computes in it)."""
    device = resolve_device(device)
    dtype = dtype or cfg.dtype
    g = generator if generator is not None else torch.Generator().manual_seed(0)
    out = {}
    # drawn in the split layout, then fused: a fused tree is the split one
    # with the same generator, concatenated
    for name, shape in _split_shapes(cfg).items():
        if name.startswith("ln"):
            t = torch.ones(shape)
        else:
            scale = 0.02 if name == "embed" else 1.0 / math.sqrt(shape[-2])
            t = torch.randn(shape, generator=g, device=g.device) * scale
        out[name] = t.to(device=device, dtype=dtype)
    return fuse_params(out) if cfg.fused_weights else out


def layer_params(params, cfg: LlamaConfig) -> Dict[str, torch.Tensor]:
    """The stacked per-layer weights of ``cfg``'s layout, with the
    ``<name>_scale`` planes of a quantized tree (stacked on the same [L]
    axis)."""
    out = {}
    for kk in layer_keys(cfg):
        out[kk] = params[kk]
        if kk + "_scale" in params:
            out[kk + "_scale"] = params[kk + "_scale"]
    return out


def _layer(layers, i: int) -> Dict[str, torch.Tensor]:
    return {kk: w[i] for kk, w in layers.items()}


def _w(p, name, dt):
    """Weight ``name`` at compute dtype ``dt``; a quantized weight (with a
    ``<name>_scale`` plane) dequantized densely, as the JAX package's
    ``_w``: narrow times scale in fp32, then ``dt``."""
    sc = p.get(name + "_scale")
    return p[name] if sc is None else dequantize_weight(p[name], sc, dt)


def _mm(h, p, name, dt):
    """``h @ weight[name]``, the projection site shared by fp and quantized
    trees. A 2-D ``h`` (the decode tick, lm_head) against a quantized
    weight runs ``quant_matmul``, which dequantizes in the kernel;
    everything else is the dense ``h @ _w(...)``, as in the JAX package."""
    sc = p.get(name + "_scale")
    if sc is not None and h.dim() == 2 and p[name].dim() == 2:
        return _qm.quant_matmul(h.contiguous(), p[name], sc).to(dt)
    return h @ _w(p, name, dt)


def _heads(cfg: LlamaConfig, m=None):
    """(query heads, kv heads) this rank computes: all of them on one
    device, its mp share on a mesh (``m``, a ``_Shard``)."""
    return (cfg.num_heads, cfg.num_kv_heads) if m is None else (m.heads,
                                                               m.kv_heads)


def _mp(m=None):
    """The mp group of ``m`` (None on one device: Megatron's ``copy_to``
    and ``reduce_from`` are then the identity)."""
    return None if m is None else m.mp


def _qkv_split(cfg: LlamaConfig, h, lp, dt, m=None):
    """The q, k, v projections of ``h`` [..., H], flat ([..., nH D],
    [..., Hkv D], [..., Hkv D]; this rank's heads on a mesh): three
    products, or one product with ``wqkv`` split by columns (views of
    it)."""
    if not cfg.fused_weights:
        return _mm(h, lp, "wq", dt), _mm(h, lp, "wk", dt), _mm(h, lp, "wv", dt)
    nh, nkv = _heads(cfg, m)
    D = cfg.head_dim
    return _mm(h, lp, "wqkv", dt).split([nh * D, nkv * D, nkv * D], dim=-1)


def _mlp(cfg: LlamaConfig, h, lp, dt, mp=None):
    """silu(h @ w_gate) * (h @ w_up) @ w_down, the gate and up products as
    one with ``w_gate_up`` under ``fused_weights``. Over an mp group the
    gate and up columns and w_down's rows are this rank's: ``h`` enters
    through ``copy_to`` and the output leaves through ``reduce_from``."""
    h = copy_to(h, mp)
    if cfg.fused_weights:
        zg, up = _mm(h, lp, "w_gate_up", dt).chunk(2, dim=-1)
    else:
        zg, up = _mm(h, lp, "w_gate", dt), _mm(h, lp, "w_up", dt)
    return reduce_from(_mm(F.silu(zg) * up, lp, "w_down", dt), mp)


# ---------------------------------------------------------------------------
# prefill path (T > 1): plain torch, the reference's inline chains
# ---------------------------------------------------------------------------

def _rope_at(x, theta, positions):
    """Rotate-half rope. x [B, S, H, D] at ``positions`` [S] (shared) or
    [B, S]; angles in fp32, cos/sin rounded to x.dtype."""
    d = x.shape[-1]
    i2 = torch.arange(0, d, 2, dtype=torch.float32, device=x.device)
    freqs = theta ** (-i2 / d)
    ang = positions.float()[..., None] * freqs          # [(B,) S, D/2]
    if ang.dim() == 2:
        ang = ang[None]
    cos = torch.cos(ang)[:, :, None, :].to(x.dtype)
    sin = torch.sin(ang)[:, :, None, :].to(x.dtype)
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def _qkv_proj(cfg: LlamaConfig, x, lp, positions, m=None):
    """rms -> q/k/v projections -> rope. q [B,S,nH,D], k/v [B,S,Hkv,D]
    (on a mesh, this rank's heads: column-parallel after ``copy_to``)."""
    B, S, _ = x.shape
    dt = cfg.dtype
    nh, nkv = _heads(cfg, m)
    h = copy_to(_tf.rms_norm_plain(x, lp["ln_attn"], cfg.rms_eps), _mp(m))
    zq, zk, zv = _qkv_split(cfg, h, lp, dt, m)
    q = zq.reshape(B, S, nh, cfg.head_dim)
    k = zk.reshape(B, S, nkv, cfg.head_dim)
    v = zv.reshape(B, S, nkv, cfg.head_dim)
    return (_rope_at(q, cfg.rope_theta, positions),
            _rope_at(k, cfg.rope_theta, positions), v)


def _layer_post(cfg: LlamaConfig, x, attn, lp, m=None):
    """Output projection, residual, mlp (on a mesh, wo and w_down
    row-parallel before ``reduce_from``)."""
    B, S, _ = x.shape
    dt = cfg.dtype
    x = x + reduce_from(_mm(attn.reshape(B, S, -1), lp, "wo", dt), _mp(m))
    h = _tf.rms_norm_plain(x, lp["ln_mlp"], cfg.rms_eps)
    return x + _mlp(cfg, h, lp, dt, _mp(m))


def _dense_cache_attention(cfg: Optional[LlamaConfig], q, kc, vc, positions,
                           scale: Optional[float] = None):
    """q [B,T,nH,D] against the unrepeated cache kc/vc [B,Smax,Hkv,D],
    keys j > the query's position masked; fp32 scores and products, as
    the reference's ``preferred_element_type=float32`` einsums. ``scale``
    defaults to 1/sqrt(cfg.head_dim); given, ``cfg`` may be None (the head
    counts come from the shapes)."""
    B, T, nH, D = q.shape
    Smax, Hkv = kc.shape[1], kc.shape[2]
    dt = q.dtype
    qg = q.reshape(B, T, Hkv, nH // Hkv, D)
    s = torch.einsum("bthrd,bshd->bhrts", qg.float(), kc.float())
    s = s * (1.0 / math.sqrt(cfg.head_dim) if scale is None else scale)
    visible = (torch.arange(Smax, device=q.device)
               <= positions[..., None])                 # [(B,) T, Smax]
    if visible.dim() == 2:
        visible = visible[None]
    s = s.masked_fill(~visible[:, None, None], float("-inf"))
    probs = torch.softmax(s, dim=-1).to(dt)
    attn = torch.einsum("bhrts,bshd->bthrd", probs.float(), vc.float())
    return attn.to(dt).reshape(B, T, nH, D)


# ---------------------------------------------------------------------------
# decode tick (T == 1): the kernels
# ---------------------------------------------------------------------------

def _decode_qkv(cfg: LlamaConfig, x, lp, pos_b):
    """x [B, H] -> q [B, nH, D], k/v [B, Hkv, D]: one rms launch, the
    projection matmuls (one under ``fused_weights``: the rope reads q and k
    out of its rows by their stride), one rope launch for q and k
    together."""
    B = x.shape[0]
    dt = cfg.dtype
    h = _tf.fused_rms_norm(x, lp["ln_attn"], cfg.rms_eps)
    zq, zk, zv = _qkv_split(cfg, h, lp, dt)
    zq, zk = _tf.fused_rope_qk(zq, zk, pos_b, cfg.head_dim, cfg.rope_theta)
    return (zq.reshape(B, cfg.num_heads, cfg.head_dim),
            zk.reshape(B, cfg.num_kv_heads, cfg.head_dim),
            zv.reshape(B, cfg.num_kv_heads, cfg.head_dim))


def _decode_post(cfg: LlamaConfig, x, attn, lp):
    """x [B, H], attn [B, nH, D]: output projection, then the residual add
    and the mlp pre-norm as one launch, then the mlp."""
    B, H = x.shape
    dt = cfg.dtype
    x2, h = _tf.fused_add_rms_norm(x, _mm(attn.reshape(B, H), lp, "wo", dt),
                                   lp["ln_mlp"], cfg.rms_eps)
    return x2 + _mlp(cfg, h, lp, dt)


def init_kv_cache(cfg: LlamaConfig, batch: int, max_len: int, device
                  ) -> Dict[str, torch.Tensor]:
    """Per-layer stacked K/V cache: [L, B, max_len, Hkv, D], zeros in
    cfg.dtype."""
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}


def forward_with_cache(params, tokens, cfg: LlamaConfig, cache, pos,
                       logit_pos=None):
    """Run ``tokens`` [B, T] at absolute positions pos..pos+T-1 against the
    cache, writing their K/V rows into it in place. Returns (logits
    [B, V] fp32, cache).

    ``pos``: an int (shared), or a [B] int tensor with T == 1 (ragged
    decode: every slot writes and attends at its own position — the
    continuous-batching engine's tick). Logits come from the last
    position, or from ``logit_pos`` (an int, or a [B] tensor: each row's
    true last token of a bucket-padded prompt).

    T == 1 attends through ``ragged_decode_attention``, as the JAX
    package's ``_cache_attention`` dispatches by shape alone; with
    ``cfg.fused_tick_epilogue`` its rms, add + rms and rope run as the tick
    kernels of ``ops/kernels``, without as the inline chains of T > 1.
    T > 1 (prefill) is plain torch with dense cache attention."""
    B, T = tokens.shape
    x = params["embed"][tokens.long()]                  # [B, T, H]
    ragged = torch.is_tensor(pos) and pos.dim() == 1
    if ragged and T != 1:
        raise ValueError("per-slot pos requires single-token decode (T=1)")
    kcs, vcs = cache["k"], cache["v"]
    rows = torch.arange(B, device=x.device)
    layers = layer_params(params, cfg)
    if T == 1:
        pos_b = (pos.to(torch.int32) if ragged else torch.full(
            (B,), int(pos), dtype=torch.int32, device=x.device))
        pos_l = pos_b.long()
    if T == 1 and cfg.fused_tick_epilogue:
        x = x[:, 0]
        for i in range(cfg.num_layers):
            lp = _layer(layers, i)
            q, k_new, v_new = _decode_qkv(cfg, x, lp, pos_b)
            # the scatter runs before the attention kernel reads row pos,
            # in order on the same stream
            kcs[i, rows, pos_l] = k_new.to(kcs.dtype)
            vcs[i, rows, pos_l] = v_new.to(vcs.dtype)
            attn = _da.ragged_decode_attention(q, kcs[i], vcs[i], pos_b)
            x = _decode_post(cfg, x, attn, lp)
        last = _tf.fused_rms_norm(x, params["ln_f"], cfg.rms_eps)
    else:
        positions = (pos_l[:, None] if T == 1
                     else int(pos) + torch.arange(T, device=x.device))
        for i in range(cfg.num_layers):
            lp = _layer(layers, i)
            q, k_new, v_new = _qkv_proj(cfg, x, lp, positions)
            if T == 1:
                kcs[i, rows, pos_l] = k_new[:, 0].to(kcs.dtype)
                vcs[i, rows, pos_l] = v_new[:, 0].to(vcs.dtype)
                attn = _da.ragged_decode_attention(q[:, 0], kcs[i], vcs[i],
                                                   pos_b)[:, None]
            else:
                kcs[i, :, int(pos):int(pos) + T] = k_new.to(kcs.dtype)
                vcs[i, :, int(pos):int(pos) + T] = v_new.to(vcs.dtype)
                attn = _dense_cache_attention(cfg, q, kcs[i], vcs[i],
                                              positions)
            x = _layer_post(cfg, x, attn, lp)
        if logit_pos is None:
            x = x[:, -1]
        elif torch.is_tensor(logit_pos) and logit_pos.dim() == 1:
            x = x[rows, logit_pos.long()]
        else:
            x = x[:, int(logit_pos)]
        # rmsnorm is per row: norming only the rows read equals norming all
        last = _tf.rms_norm_plain(x, params["ln_f"], cfg.rms_eps)
    logits = _mm(last, params, "lm_head", cfg.dtype)
    return logits.float(), cache


def init_paged_pool(cfg: LlamaConfig, num_pages: int, page_size: int,
                    device, dtype: Optional[torch.dtype] = None,
                    quant=None) -> Dict[str, torch.Tensor]:
    """Flat paged K/V pool: [L, num_pages, page_size, Hkv, D], zeros in
    ``dtype`` (default cfg.dtype). Page 0 is the allocator's reserved
    trash page (``inference/paged_kv.py``).

    ``quant`` ('int8' | 'fp8'): the pages hold the narrow dtype and the
    pool gains fp32 row-scale planes ``ks``/``vs`` [L, num_pages,
    page_size], one scale per cache row, keyed by physical page so page
    copies move them with their rows."""
    shape = (cfg.num_layers, num_pages, page_size, cfg.num_kv_heads,
             cfg.head_dim)
    dtype = quant_dtype(quant) if quant is not None else dtype or cfg.dtype
    pool = {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
    if quant is not None:
        for name in ("ks", "vs"):
            pool[name] = torch.zeros(shape[:3], dtype=torch.float32,
                                     device=device)
    return pool


def _gather_attention(cfg: LlamaConfig, q, kc, vc, page_table, positions,
                      ks, vs):
    """Attention over a quantized pool, the JAX package's dequantizing
    gather: each slot's pages and their row scales are gathered into a
    contiguous window, both cast to the compute dtype and multiplied
    (at bf16 the scale is rounded to bf16 first), then the dense cache
    attention. q [B, T, nH, D]; kc/vc [P, page_size, Hkv, D]; ks/vs
    [P, page_size]; positions [B, T]."""
    B = q.shape[0]
    dt = q.dtype
    W = page_table.shape[1] * kc.shape[1]
    idx = page_table.long()
    gk = kc[idx].to(dt) * ks[idx][..., None, None].to(dt)
    gv = vc[idx].to(dt) * vs[idx][..., None, None].to(dt)
    return _dense_cache_attention(
        cfg, q, gk.reshape(B, W, kc.shape[2], kc.shape[3]),
        gv.reshape(B, W, vc.shape[2], vc.shape[3]), positions)


def forward_with_pages(params, tokens, cfg: LlamaConfig, pool, page_table,
                       pos, live=None, logit_pos=None, logits_all=False):
    """``forward_with_cache`` over a paged pool. Returns (logits [B, V]
    fp32, pool), the pool updated in place; with ``logits_all``, the
    logits of every position, [B, T, V] (the speculative verify tick
    scores its K + 1 positions from one pass over the weights).

    tokens [B, T] run at positions ``pos[b] .. pos[b] + T - 1`` (``pos``
    [B] int32, each row at its own base: T == 1 is a ragged decode tick,
    T > 1 a prefill chunk at context offset ``pos[b]``). ``page_table``
    [B, max_pages] int32: virtual page j of row b is physical page
    ``page_table[b, j]``. K/V rows scatter to [page, row] through the
    table; ``live`` ([B] bool) sends dead slots' writes to the trash page
    0, as it does rows past the table. Logits come from the last position
    or from ``logit_pos`` (an int, or a [B] tensor).

    Attention is ``ragged_paged_attention`` for both T == 1 and T > 1
    (the JAX package's ``_paged_attention``): the kernel on a CUDA
    tensor, the gather and dense plain version on a CPU one. T == 1 runs
    the tick kernels as ``forward_with_cache`` does (with
    ``cfg.fused_tick_epilogue``; without, the plain chains of T > 1); T > 1
    the plain projections with per-row positions.

    A quantized pool (``"ks"`` in ``pool``) stores each new row narrow
    with its scale (``quantize_kv_rows``) at the same [page, row], and
    attends through the dequantizing gather (``_gather_attention``) for
    T == 1 and T > 1 alike: the paged kernel has no quant mode, in the
    JAX package as here."""
    B, T = tokens.shape
    psz = pool["k"].shape[2]
    max_pages = page_table.shape[1]
    x = params["embed"][tokens.long()]                  # [B, T, H]
    pos = pos.to(torch.int32).reshape(B)
    positions = pos.long()[:, None] + torch.arange(T, device=x.device)
    # destination of the chunk's K/V rows, shared by every layer
    vpage = positions // psz
    prow = positions % psz
    phys = torch.gather(page_table.long(), 1,
                        vpage.clamp(max=max_pages - 1))
    writable = vpage < max_pages
    if live is not None:
        writable = writable & live[:, None]
    phys = torch.where(writable, phys, 0)
    layers = layer_params(params, cfg)
    quant = "ks" in pool

    def attend(i, q, k_new, v_new):
        """Write the rows ([B, T, Hkv, D]) at [phys, prow] of layer i, then
        attend q [B, T, nH, D]. The scatter runs before the kernel reads
        the rows, in order on the same stream."""
        kc, vc = pool["k"][i], pool["v"][i]
        if not quant:
            kc[phys, prow] = k_new.to(kc.dtype)
            vc[phys, prow] = v_new.to(vc.dtype)
            return _pa.ragged_paged_attention(q, kc, vc, page_table, pos)
        ks, vs = pool["ks"][i], pool["vs"][i]
        kc[phys, prow], ks[phys, prow] = quantize_kv_rows(k_new, kc.dtype)
        vc[phys, prow], vs[phys, prow] = quantize_kv_rows(v_new, vc.dtype)
        return _gather_attention(cfg, q, kc, vc, page_table, positions,
                                 ks, vs)

    if T == 1 and cfg.fused_tick_epilogue:
        x = x[:, 0]
        for i in range(cfg.num_layers):
            lp = _layer(layers, i)
            q, k_new, v_new = _decode_qkv(cfg, x, lp, pos)
            attn = attend(i, q[:, None], k_new[:, None], v_new[:, None])
            x = _decode_post(cfg, x, attn[:, 0], lp)
        last = _tf.fused_rms_norm(x, params["ln_f"], cfg.rms_eps)
        if logits_all:
            return _mm(last, params, "lm_head", cfg.dtype).float()[:, None], \
                pool
    else:
        for i in range(cfg.num_layers):
            lp = _layer(layers, i)
            q, k_new, v_new = _qkv_proj(cfg, x, lp, positions)
            x = _layer_post(cfg, x, attend(i, q, k_new, v_new), lp)
        if logits_all:
            last = _tf.rms_norm_plain(x, params["ln_f"], cfg.rms_eps)
            return _mm(last, params, "lm_head", cfg.dtype).float(), pool
        if logit_pos is None:
            x = x[:, -1]
        elif torch.is_tensor(logit_pos) and logit_pos.dim() == 1:
            x = x[torch.arange(B, device=x.device), logit_pos.long()]
        else:
            x = x[:, int(logit_pos)]
        # rmsnorm is per row: norming only the rows read equals norming all
        last = _tf.rms_norm_plain(x, params["ln_f"], cfg.rms_eps)
    logits = _mm(last, params, "lm_head", cfg.dtype)
    return logits.float(), pool


def _as_prompt(prompt, device) -> torch.Tensor:
    """Token ids (array or tensor, [S] or [B, S]) as [B, S] int64 on
    ``device``."""
    prompt = torch.as_tensor(prompt, device=device).to(torch.int64)
    return prompt[None] if prompt.dim() == 1 else prompt


def _prefill(params, prompt, cfg: LlamaConfig, max_new_tokens: int,
             max_len: Optional[int], device):
    """The prompt's cache and its last logits, at ``max_len`` rows (default
    the S + max_new_tokens - 1 that generation needs: the last token is
    returned but never written back). Returns (prompt, cache, logits)."""
    prompt = _as_prompt(prompt, device)
    S = prompt.shape[1]
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
    max_len = max_len or min(cfg.max_seq_len, S + max_new_tokens - 1)
    if S + max_new_tokens - 1 > max_len:
        raise ValueError(f"prompt ({S}) + max_new_tokens ({max_new_tokens}) "
                         f"needs {S + max_new_tokens - 1} cache slots but "
                         f"max_len is {max_len}")
    cache = init_kv_cache(cfg, prompt.shape[0], max_len, device)
    logits, cache = forward_with_cache(params, prompt, cfg, cache, 0)
    return prompt, cache, logits


@torch.no_grad()
def prompt_kv(params, prompt, cfg: LlamaConfig,
              max_len: Optional[int] = None, device="cuda"):
    """KV rows for a prompt, standalone: the prefix cache's registration
    path (``inference/prefix_cache.py``). Returns ({"k", "v"} [L, B, S_pad,
    Hkv, D], logits [B, V] fp32) where S_pad = ``max_len or S``; rows past
    S are zeros. Rope depends on the absolute position only, so the rows
    serve any prompt that starts with ``prompt``."""
    prompt = _as_prompt(prompt, resolve_device(device))
    B, S = prompt.shape
    cache = init_kv_cache(cfg, B, max_len or S, prompt.device)
    logits, cache = forward_with_cache(params, prompt, cfg, cache, 0)
    return cache, logits


def sample_filter_logits(logits, temperature, top_k=0, top_p=1.0):
    """Temperature, top-k and top-p filtered logits over the last dim:
    tokens outside the kept support are -inf, so the sampling
    distribution is ``softmax(result)``. Top-k keeps every token tied
    with the k-th value; nucleus filtering keeps the shortest prefix of
    the descending sort whose mass reaches ``top_p`` (the first token
    always survives), cut at the smallest kept logit. ``temperature``
    must be > 0: greedy is the caller's argmax."""
    logits = logits / temperature
    if top_k:
        k = min(int(top_k), logits.shape[-1])
        kth = torch.topk(logits, k, dim=-1).values[..., k - 1:k]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        keep = torch.cumsum(probs, dim=-1) - probs < top_p  # mass before
        keep[..., 0] = True
        cutoff = torch.where(keep, sorted_logits, float("inf")).amin(
            dim=-1, keepdim=True)
        logits = logits.masked_fill(logits < cutoff, float("-inf"))
    return logits


def _sample(logits, temperature, top_k, generator, top_p=1.0):
    """One token per row: argmax at temperature 0, else a draw from the
    filtered distribution by the Gumbel-max rule (argmax of the logits
    plus Gumbel noise from ``generator``, which lies on the logits'
    device), so no draw reads the device from the host."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    filt = sample_filter_logits(logits, temperature, top_k, top_p)
    u = torch.rand(filt.shape, generator=generator, device=filt.device)
    gumbel = -torch.log(-torch.log(u.clamp_(min=torch.finfo(u.dtype).tiny)))
    return torch.argmax(filt + gumbel, dim=-1)


@torch.no_grad()
def generate(params, prompt, cfg: LlamaConfig, max_new_tokens: int = 32,
             max_len: Optional[int] = None, temperature: float = 0.0,
             top_k: int = 0, top_p: float = 1.0, seed: int = 0,
             device="cuda") -> torch.Tensor:
    """Autoregressive generation: greedy at temperature 0, else sampling
    at ``temperature`` with optional top-k and nucleus (top-p) filtering
    (``sample_filter_logits``), drawn from one ``torch.Generator`` on the
    device seeded with ``seed``. ``prompt``: [B, S] token ids (array or
    tensor). Returns [B, max_new_tokens] int32 on ``device``.

    One prefill, then one decode tick per token; tokens stay on the
    device, so the loop makes no host round trip."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    prompt, cache, logits = _prefill(params, prompt, cfg, max_new_tokens,
                                     max_len, device)
    S = prompt.shape[1]
    nxt = _sample(logits, temperature, top_k, gen, top_p)
    out = [nxt]
    for step in range(max_new_tokens - 1):
        logits, cache = forward_with_cache(params, nxt[:, None], cfg, cache,
                                           S + step)
        nxt = _sample(logits, temperature, top_k, gen, top_p)
        out.append(nxt)
    return torch.stack(out, dim=1).to(torch.int32)


@torch.no_grad()
def beam_search_generate(params, prompt, cfg: LlamaConfig,
                         max_new_tokens: int = 32, num_beams: int = 4,
                         max_len: Optional[int] = None,
                         eos_token_id: Optional[int] = None,
                         length_penalty: float = 1.0,
                         device="cuda") -> torch.Tensor:
    """Fixed-length beam search over the KV cache; returns the best beam's
    tokens [B, max_new_tokens] int32. ``eos_token_id`` (optional) freezes
    finished beams: their only continuation is another EOS at
    log-probability 0. Final scores are divided by each beam's generated
    length ** ``length_penalty`` (0 disables the normalisation).

    Step 0 runs the prompt's last token again at position S - 1 (its row
    is rewritten with the same token) to get the first logits from a
    decode tick, as the JAX package does; the cache then repeats to
    B * num_beams rows and is reordered along them every step."""
    device = resolve_device(device)
    if num_beams < 1:
        raise ValueError(f"num_beams must be >= 1, got {num_beams}")
    prompt, cache, _ = _prefill(params, prompt, cfg, max_new_tokens, max_len,
                                device)
    B, S = prompt.shape
    nb = num_beams
    logits, cache = forward_with_cache(params, prompt[:, -1:], cfg, cache,
                                       S - 1)
    lp = torch.log_softmax(logits, dim=-1)
    V = lp.shape[-1]
    scores, tok0 = torch.topk(lp, nb, dim=-1)                # [B, nb]
    cache = {k: c.repeat_interleave(nb, dim=1) for k, c in cache.items()}
    hist = torch.zeros((B, nb, max_new_tokens), dtype=torch.int64,
                       device=device)
    hist[:, :, 0] = tok0
    finished = (tok0 == eos_token_id if eos_token_id is not None
                else torch.zeros((B, nb), dtype=torch.bool, device=device))
    lengths = torch.ones((B, nb), dtype=torch.float32, device=device)
    if eos_token_id is not None:
        eos_only = torch.full((V,), float("-inf"), device=device)
        eos_only[eos_token_id] = 0.0
    base = torch.arange(B, device=device)[:, None] * nb
    nxt = tok0.reshape(B * nb)
    for i in range(1, max_new_tokens):
        logits, cache = forward_with_cache(params, nxt[:, None], cfg, cache,
                                           S + i - 1)
        lp = torch.log_softmax(logits, dim=-1)               # [B*nb, V]
        if eos_token_id is not None:
            lp = torch.where(finished.reshape(B * nb)[:, None], eos_only, lp)
        total = scores[:, :, None] + lp.reshape(B, nb, V)
        scores, idx = torch.topk(total.reshape(B, nb * V), nb, dim=-1)
        beam = idx // V                                      # [B, nb]
        tok = idx % V
        src = (base + beam).reshape(B * nb)
        cache = {k: c.index_select(1, src) for k, c in cache.items()}
        hist = torch.gather(hist, 1, beam[:, :, None].expand_as(hist))
        hist[:, :, i] = tok
        lengths = torch.gather(lengths, 1, beam)
        if eos_token_id is not None:
            prev = torch.gather(finished, 1, beam)
            lengths = torch.where(prev, lengths, lengths + 1)
            finished = prev | (tok == eos_token_id)
        else:
            lengths = lengths + 1
        nxt = tok.reshape(B * nb)
    best = torch.argmax(scores / lengths ** length_penalty, dim=-1)   # [B]
    return hist[torch.arange(B, device=device), best].to(torch.int32)


# ---------------------------------------------------------------------------
# training (single device): forward, loss, global-norm clip and AdamW
# ---------------------------------------------------------------------------

# norm gains and the embedding take no weight decay
NO_DECAY_KEYS = ("ln_attn", "ln_mlp", "ln_f", "embed")


def _layer_qkv(cfg: LlamaConfig, x, lp, m=None):
    """Pre-attention half of a block: rms, q/k/v projections, rope at the
    rows' global positions (0..S-1 unless ``m`` splits the sequence), then
    the GQA repeat of the kv heads (``jnp.repeat`` on the head axis: head
    j reads kv head j // rep)."""
    offset = 0 if m is None else m.offset
    positions = torch.arange(offset, offset + x.shape[1], device=x.device)
    q, k, v = _qkv_proj(cfg, x, lp, positions, m)
    nh, nkv = _heads(cfg, m)
    if nkv != nh:
        rep = nh // nkv
        k = k.repeat_interleave(rep, dim=2)
        v = v.repeat_interleave(rep, dim=2)
    # q and k come out of the rope contiguous; under fused_weights v is a
    # view of the fused product's columns, which the flash kernels do not
    # read: one copy (a no-op otherwise)
    return q, k, v.contiguous()


def _attention(cfg: LlamaConfig, q, k, v, m=None):
    """Training attention, causal: on a mesh whose rows are split over
    sep (``m.seq_split``, sequence parallelism), the ring or Ulysses form
    of ``cfg.sp_impl``; else the flash kernels on the card (on one device
    ``sequence_parallel`` computes this too: with no 'sep' axis the JAX
    package's ring and Ulysses forms fall back to it)."""
    if m is not None and m.seq_split:
        from ..ops.ring_attention import ring_attention, ulysses_attention

        fn = {"ring": ring_attention, "ulysses": ulysses_attention}[
            cfg.sp_impl]
        return fn(q, k, v, axis_name="sep", is_causal=True, mesh=m.mesh)
    return _fa.dot_product_attention(q, k, v, is_causal=True)


def _decoder_layer(cfg: LlamaConfig, x, lp, m=None):
    q, k, v = _layer_qkv(cfg, x, lp, m)
    return _layer_post(cfg, x, _attention(cfg, q, k, v, m), lp, m)


def forward_hidden(params, tokens, cfg: LlamaConfig, m=None):
    """Final hidden states (post ln_f). tokens [B, S] -> [B, S, H] in
    cfg.dtype. Parameters may be fp32 master weights: each use site casts
    its weight to cfg.dtype, so gradients reach them in fp32. ``m`` (a
    ``_Shard``, on a mesh): ``params`` are this rank's shards and
    ``tokens`` its rows, the embedding's vocabulary and the blocks' heads
    and columns split over mp."""
    dt = cfg.dtype
    x = vocab_parallel_lookup(params["embed"].to(dt), tokens, _mp(m))
    # on the flash path attention stays outside the checkpointed halves,
    # so its O(S) residuals are saved rather than recomputed
    split = cfg.remat and _fa.flash_path_active(x)
    # one cast and one unbind per stacked weight: their backward is one
    # cast and one stack, where indexing layer i would make autograd add a
    # zero-filled [L, ...] gradient per layer
    keys = layer_keys(cfg)
    layers = {kk: params[kk].to(dt).unbind(0) for kk in keys}
    for i in range(cfg.num_layers):
        lp = {kk: layers[kk][i] for kk in keys}
        if split:
            q, k, v = checkpoint(_layer_qkv, cfg, x, lp, m,
                                 use_reentrant=False)
            attn = _attention(cfg, q, k, v, m)
            x = checkpoint(_layer_post, cfg, x, attn, lp, m,
                           use_reentrant=False)
        elif cfg.remat:
            x = checkpoint(_decoder_layer, cfg, x, lp, m,
                           use_reentrant=False)
        else:
            x = _decoder_layer(cfg, x, lp, m)
    return _tf.rms_norm_plain(x, params["ln_f"], cfg.rms_eps)


def forward(params, tokens, cfg: LlamaConfig):
    """Next-token logits [B, S, V] in cfg.dtype."""
    return forward_hidden(params, tokens, cfg) @ params["lm_head"].to(
        cfg.dtype)


def _nll_terms(logits, targets):
    """Per-row max m (no gradient: the logsumexp's gradient is exact for any
    constant shift), sumexp and gold logit, all fp32. ``logits - m`` is
    promoted to fp32, so it still makes one fp32 temporary of the logits'
    shape (and ``exp`` a second) before the sum; only a separate ``.float()``
    copy of the logits is avoided."""
    m = logits.max(dim=-1).values.float().detach()
    se = torch.exp(logits - m[..., None]).sum(dim=-1)   # promoted to fp32
    gold = logits.gather(-1, targets.long()[..., None])[..., 0].float()
    return m, se, gold


def _nll_sum(logits, targets, weights):
    """Weighted token-nll sum over one logits block."""
    m, se, gold = _nll_terms(logits, targets)
    return ((m + torch.log(se) - gold) * weights).sum()


class _HeadCETail(torch.autograd.Function):
    """lm_head matmul + weighted token-nll sum with a hand-scheduled
    backward (the JAX package's ``_head_ce_tail``): the forward equals
    ``_nll_sum(h2 @ W, targets, wgt)``; the backward runs dh's softmax term
    as ``head_dx_softmax`` and its gold term as a gather of W's columns."""

    @staticmethod
    def forward(ctx, h2, W, targets, wgt):
        logits = h2 @ W.to(h2.dtype)
        m, se, gold = _nll_terms(logits, targets)
        ctx.save_for_backward(h2, W, logits, m, se, targets, wgt)
        return ((m + torch.log(se) - gold) * wgt[None, :]).sum()

    @staticmethod
    def backward(ctx, gs):
        return _head_ce_tail_bwd(ctx.saved_tensors, gs)


_head_ce_tail = _HeadCETail.apply


def _head_ce_tail_bwd(res, gs):
    """(dh, dW, None, None). Per row, gw = gs * weight scales the one-hot
    terms and gw / sumexp the softmax terms.

    dh = head_dx_softmax(logits, m, gw / se, W) - gw * W[:, target]^T.
    dW = h2^T @ ((exp(l - m) / se - onehot) * gw), in JAX's wide-N
    orientation, as one GEMM that accumulates in fp32 and, as JAX's
    ``preferred_element_type=float32``, writes its [H, V] output in fp32
    (``torch.mm(..., out_dtype=...)`` on the card; the CPU has no such
    GEMM for bf16 inputs and rounds dW to cfg.dtype once before the cast
    back to W's type)."""
    h2, W, logits, m, se, targets, wgt = res
    B, T, H = h2.shape
    V = logits.shape[-1]
    dt = h2.dtype
    M = B * T
    lf = logits.reshape(M, V)
    mf, sef = m.reshape(M), se.reshape(M)
    tf = targets.reshape(M).long()
    gw = gs.float() * wgt[None, :].expand(B, T).reshape(M)
    Wd = W.to(dt)
    dh_soft = _hd.head_dx_softmax(lf, mf, gw / sef, Wd)
    gold_rows = (Wd.t()[tf].float() * gw[:, None]).to(dt)        # [M, H]
    dh = (dh_soft - gold_rows).reshape(B, T, H)
    # (exp(l - m) / se - onehot) * gw, in place on one fp32 [M, V] buffer
    e = torch.sub(lf, mf[:, None]).exp_().div_(sef[:, None])
    e[torch.arange(M, device=e.device), tf] -= 1.0
    dlog = e.mul_(gw[:, None]).to(dt)
    del e
    h2t = h2.reshape(M, H).t()
    if h2.is_cuda and dt != W.dtype:
        dW = torch.mm(h2t, dlog, out_dtype=W.dtype)              # [H, V]
    else:
        dW = (h2t @ dlog).to(W.dtype)
    return dh, dW, None, None


def loss_fn(params, tokens, labels, cfg: LlamaConfig):
    """Next-token cross entropy, averaged over B * (S - 1) positions:
    position i's logits are scored against labels[i + 1].

    ``cfg.ce_chunks`` (dividing B): head + CE per batch chunk, each chunk
    checkpointed, so its logits are recomputed in the backward and never
    saved. ``cfg.ce_tail_custom``: the custom tail (``_HeadCETail``), all
    S positions scored with weight 0 on the last. Otherwise the plain
    head matmul on the first S - 1 positions and ``_nll_sum``."""
    h = forward_hidden(params, tokens, cfg)
    dt = cfg.dtype
    B, S, _ = h.shape
    nc = cfg.ce_chunks
    labels = labels.long()
    pad = torch.zeros(B, 1, dtype=labels.dtype, device=labels.device)
    if nc and B % nc == 0:
        W = params["lm_head"].to(dt)
        targets = torch.cat([labels[:, 1:], pad], dim=1)
        wgt = torch.ones(S, dtype=torch.float32, device=h.device)
        wgt[-1] = 0.0
        hc = h.reshape(nc, B // nc, S, h.shape[-1])
        tc = targets.reshape(nc, B // nc, S)

        def body(hcb, tcb):
            return _nll_sum(hcb @ W, tcb, wgt[None, :])

        total = torch.zeros((), dtype=torch.float32, device=h.device)
        for i in range(nc):
            total = total + checkpoint(body, hc[i], tc[i],
                                       use_reentrant=False)
        return total / (B * (S - 1))
    if cfg.ce_tail_custom:
        targets = torch.cat([labels[:, 1:], pad], dim=1)
        wgt = torch.ones(S, dtype=torch.float32, device=h.device)
        wgt[-1] = 0.0
        total = _head_ce_tail(h, params["lm_head"], targets, wgt)
        return total / (B * (S - 1))
    logits = h[:, :-1] @ params["lm_head"].to(dt)
    return _nll_sum(logits, labels[:, 1:], 1.0) / (B * (S - 1))


def init_opt_state(params):
    """AdamW state: ``step`` (int32, 0-d) and zero moments ``m``, ``v``
    shaped and typed as the parameters."""
    p0 = next(iter(params.values()))
    return {"step": torch.zeros((), dtype=torch.int32, device=p0.device),
            "m": {k: torch.zeros_like(p) for k, p in params.items()},
            "v": {k: torch.zeros_like(p) for k, p in params.items()}}


@torch.no_grad()
def adamw_update(params, grads, opt_state, lr=3e-4, beta1=0.9, beta2=0.95,
                 eps=1e-8, weight_decay=0.1, no_decay_keys=None):
    """AdamW with bias correction and decoupled decay, in the JAX package's
    order of operations (``torch.optim.AdamW`` rounds differently):
    m = b1 m + (1 - b1) g; v = b2 v + (1 - b2) g^2;
    p -= lr ((m / c1) / (sqrt(v / c2) + eps) + wd p), c = 1 - b^step.
    Updates ``params`` and ``opt_state`` in place and returns them."""
    opt_state["step"].add_(1)
    t = opt_state["step"].float()
    c1 = 1.0 - torch.pow(beta1, t)
    c2 = 1.0 - torch.pow(beta2, t)
    nd = NO_DECAY_KEYS if no_decay_keys is None else no_decay_keys
    for k, p in params.items():
        wd = 0.0 if k in nd else weight_decay
        g = grads[k].float()
        m, v = opt_state["m"][k], opt_state["v"][k]
        m.mul_(beta1).add_((1 - beta1) * g)
        v.mul_(beta2).add_((1 - beta2) * (g * g))
        p.sub_(lr * ((m / c1) / (torch.sqrt(v / c2) + eps) + wd * p))
    return params, opt_state


def train_step(params, opt_state, tokens, labels, cfg: LlamaConfig,
               lr=3e-4):
    """One step: loss and gradients, the global-norm clip
    ``min(1, 1 / (|g| + 1e-6))``, then AdamW. Updates ``params`` and
    ``opt_state`` in place; returns (params, opt_state, loss).

    ``cfg.bf16_grads``: the gradients are taken with respect to
    ``cfg.dtype`` copies of the fp32 parameters (the forward is the same
    arithmetic: every use site casts to ``cfg.dtype``), so they stay in
    that type through the clip; AdamW reads them as fp32 and updates the
    fp32 masters."""
    keys = list(params)
    if cfg.bf16_grads:
        leaves = {k: (params[k].detach().to(cfg.dtype)
                      if params[k].dtype == torch.float32
                      else params[k].detach()).requires_grad_()
                  for k in keys}
    else:
        leaves = {k: params[k].detach().requires_grad_() for k in keys}
    with torch.enable_grad():
        loss = loss_fn(leaves, tokens, labels, cfg)
        grads = torch.autograd.grad(loss, [leaves[k] for k in keys])
    with torch.no_grad():
        gnorm = torch.sqrt(sum(g.float().square().sum() for g in grads))
        clip = torch.clamp(1.0 / (gnorm + 1e-6), max=1.0)
        grads = {k: g * clip.to(g.dtype) for k, g in zip(keys, grads)}
    adamw_update(params, grads, opt_state, lr=lr)
    return params, opt_state, loss.detach()


def make_train_step(cfg: LlamaConfig, lr=3e-4, device="cuda"):
    """The single-device counterpart of the JAX package's
    ``make_sharded_train_step``: returns ``step(params, opt_state, tokens,
    labels) -> (params, opt_state, loss)`` on ``device`` (the card unless
    the caller names another; raises where CUDA is asked for and absent).

    Parameters are fp32 master weights (``init_params(...,
    dtype=torch.float32)``) and the state ``init_opt_state(params)``, both
    on ``device``. They are updated in place, the counterpart of JAX's
    ``donate_argnums``: the returned dicts are the ones passed in."""
    dev = resolve_device(device)

    def step(params, opt_state, tokens, labels):
        tokens = torch.as_tensor(tokens, device=dev)
        labels = torch.as_tensor(labels, device=dev)
        return train_step(params, opt_state, tokens, labels, cfg, lr=lr)

    return step


# ---------------------------------------------------------------------------
# training on a mesh: the spec tables, explicit shards and Megatron's
# collectives (``parallel/sharded.py`` holds ZeRO and the clip)
# ---------------------------------------------------------------------------

def param_specs(cfg: LlamaConfig):
    """PartitionSpec of every parameter (the reference's table): wq, wk,
    wv, w_gate, w_up and lm_head split by columns over mp, wo and w_down
    by rows, the embedding by vocabulary; ZeRO stage 3 also splits the
    other dimension over ("dp", "sharding")."""
    from ..parallel.mesh import P

    zdim = ("dp", "sharding") if cfg.sharding_stage >= 3 else None
    specs = {
        "embed": P("mp", zdim),
        "wq": P(None, zdim, "mp"),
        "wk": P(None, zdim, "mp"),
        "wv": P(None, zdim, "mp"),
        "wo": P(None, "mp", zdim),
        "w_gate": P(None, zdim, "mp"),
        "w_up": P(None, zdim, "mp"),
        "w_down": P(None, "mp", zdim),
        "ln_attn": P(None, None),
        "ln_mlp": P(None, None),
        "ln_f": P(None),
        "lm_head": P(zdim, "mp"),
    }
    return _fuse_keys(cfg, specs)


def _fuse_keys(cfg: LlamaConfig, d):
    """A per-key table in the fused_weights layout: wqkv takes wq's entry,
    w_gate_up w_gate's."""
    return _fuse(d, lambda first, *rest: first) if cfg.fused_weights else d


def opt_state_specs(cfg: LlamaConfig):
    """The moments' specs: from stage 1 every moment is split over
    ("dp", "sharding") on its first free dimension (the reference's
    table); stage 0 keeps the parameters' specs."""
    from ..parallel.mesh import P

    if cfg.sharding_stage < 1:
        return param_specs(cfg)
    z = ("dp", "sharding")
    return _fuse_keys(cfg, {
        "embed": P("mp", z),
        "wq": P(None, z, "mp"),
        "wk": P(None, z, "mp"),
        "wv": P(None, z, "mp"),
        "wo": P(None, "mp", z),
        "w_gate": P(None, z, "mp"),
        "w_up": P(None, z, "mp"),
        "w_down": P(None, "mp", z),
        "ln_attn": P(None, z),
        "ln_mlp": P(None, z),
        "ln_f": P(z),
        "lm_head": P(z, "mp"),
    })


def _act_spec(cfg: LlamaConfig):
    """Activations: batch over ("dp", "sharding"), the sequence over sep
    under sequence parallelism."""
    from ..parallel.mesh import P

    return P(("dp", "sharding"), "sep" if cfg.sequence_parallel else None,
             None)


def _column_blocks(cfg: LlamaConfig):
    """The fused weights' column blocks, laid out per mp rank by
    ``shard_state``."""
    if not cfg.fused_weights:
        return {}
    Hkv = cfg.num_kv_heads * cfg.head_dim
    F_ = cfg.intermediate_size
    return {"wqkv": (cfg.hidden_size, Hkv, Hkv), "w_gate_up": (F_, F_)}


def shard_state(cfg: LlamaConfig, mesh, params, opt_state=None):
    """Each rank's shards of whole parameters (and AdamW state) under
    ``param_specs`` / ``opt_state_specs``, on the mesh's device: the
    reference's ``device_put`` to the hybrid shardings. The fused weights'
    columns are laid out as Megatron's per-rank [q_r | k_r | v_r]."""
    from ..parallel import sharded

    return sharded.shard_state(mesh, param_specs(cfg), opt_state_specs(cfg),
                               params, opt_state, _column_blocks(cfg))


def gather_state(cfg: LlamaConfig, mesh, params, opt_state=None):
    """Whole host arrays (numpy) from every rank's shards: the inverse of
    ``shard_state``, every rank taking part."""
    from ..parallel import sharded

    return sharded.gather_state(mesh, param_specs(cfg), opt_state_specs(cfg),
                                params, opt_state, _column_blocks(cfg))


class _Shard:
    """One rank's view of the mesh for the forward: its mp group and
    heads, whether the sequence is split over sep, and its rows' global
    offset."""

    def __init__(self, cfg: LlamaConfig, mesh, seq_len: int):
        from ..ops.ring_attention import sp_divides
        from ..parallel.mesh import axis_group, axis_index, axis_size

        self.mesh = mesh
        self.mp = axis_group(mesh, "mp")
        self.mp_size = axis_size(mesh, "mp")
        for name, n in (("num_heads", cfg.num_heads),
                        ("num_kv_heads", cfg.num_kv_heads)):
            if n % self.mp_size:
                raise ValueError(f"{name} {n} does not divide over mp "
                                 f"{self.mp_size}")
        self.heads = cfg.num_heads // self.mp_size
        self.kv_heads = cfg.num_kv_heads // self.mp_size
        # the sequence is split over sep where the reference's attention
        # shards it; where the reference takes its dense branch, the rows
        # stay whole on every sep rank (the same function)
        self.seq_split = cfg.sequence_parallel and sp_divides(
            (1, seq_len, cfg.num_heads), mesh, "sep", head_axes="mp",
            needs_head_divisible=cfg.sp_impl == "ulysses")
        self.sep_size = axis_size(mesh, "sep") if self.seq_split else 1
        self.offset = (axis_index(mesh, "sep") * (seq_len // self.sep_size)
                       if self.seq_split else 0)
        self.data_axes = ("dp", "sharding") + (("sep",) if self.seq_split
                                               else ())


def _mesh_loss(cfg: LlamaConfig, m: _Shard, w, batch):
    """This rank's share of the loss: the weighted token nll of its rows
    over the global B * (S - 1) (the reference's multi-device branch of
    ``loss_fn``: no CE tail, no chunks; under mp the vocab-sharded
    lm_head through ``parallel_cross_entropy``)."""
    tokens, targets, wgt, count = batch
    h = copy_to(forward_hidden(w, tokens, cfg, m), m.mp)
    logits = h @ w["lm_head"].to(cfg.dtype)
    nll = parallel_cross_entropy(logits, targets, m.mp)
    return (nll * wgt).sum() / count


def make_sharded_train_step(cfg: LlamaConfig, mesh, lr=3e-4, device="cuda"):
    """The reference's ``make_sharded_train_step``: ``step(params,
    opt_state, tokens, labels) -> (params, opt_state, loss)`` on each
    rank's shards (``shard_state``), updated in place; ``tokens`` and
    ``labels`` are the global batch, of which each rank takes its rows
    (over ("dp", "sharding"); and its columns over sep under sequence
    parallelism). On a mesh of one rank the step is ``make_train_step``'s,
    as the reference takes the single-device path there. ``device`` (the
    card unless the caller names the CPU) must be the mesh's."""
    dev = resolve_device(device)
    if mesh is None or mesh.device_type != dev.type:
        raise ValueError(f"make_sharded_train_step: the mesh's device "
                         f"{getattr(mesh, 'device_type', None)!r} is not "
                         f"{dev.type!r}")
    if mesh.mesh.numel() == 1:
        return make_train_step(cfg, lr=lr, device=dev)
    from ..parallel.mesh import P, local_shard
    from ..parallel.sharded import ShardedStep

    ctx = {}

    def batch_fn(tokens, labels):
        tokens = torch.as_tensor(tokens).to(dev).long()
        labels = torch.as_tensor(labels).to(dev).long()
        B, S = tokens.shape
        m = ctx.get(S)
        if m is None:
            m = ctx[S] = _Shard(cfg, mesh, S)
        # every position scored against the next label, the last with
        # weight 0: the reference's shift, split like the tokens
        targets = torch.cat([labels[:, 1:], labels.new_zeros(B, 1)], dim=1)
        wgt = torch.ones(S, device=dev)
        wgt[-1] = 0.0
        rows = P(("dp", "sharding"), "sep" if m.seq_split else None)
        cut = (lambda t, s: local_shard(t, s, mesh))
        batch = (cut(tokens, rows), cut(targets, rows),
                 cut(wgt, P(rows[1])), float(B * (S - 1)))
        return m.data_axes, (m, batch)

    def loss_fn(w, mb):
        m, batch = mb
        return _mesh_loss(cfg, m, w, batch)

    leaf = ((lambda p: cfg.dtype if p.dtype == torch.float32 else p.dtype)
            if cfg.bf16_grads else None)
    return ShardedStep(mesh, param_specs(cfg), opt_state_specs(cfg),
                       loss_fn, batch_fn, lr, NO_DECAY_KEYS,
                       leaf_dtype=leaf, clip_in_grad_dtype=True)
