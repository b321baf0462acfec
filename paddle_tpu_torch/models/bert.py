"""BERT/ERNIE encoder: masked-LM pretraining, BASELINE config 2, in
PyTorch.

Port of ``paddle_tpu/models/bert.py``: the config and its presets, the
bidirectional post-LN encoder (learned position and segment embeddings,
tanh-GELU feed-forward), the MLM head tied to the token embedding, the
fp32 loss over every position with an ignore index, and the
single-device ``train_step`` (the global-norm clip to 1.0, then
``llama.adamw_update`` with BERT's ``NO_DECAY_KEYS``). Layout follows the
JAX package: parameters are a dict with its keys and stacked ``[L, ...]``
layer weights, and layers run as an unrolled loop; ``train_step`` updates
parameters and optimizer state in place.

Attention is ``ops.kernels.flash_attention.dot_product_attention`` with
``is_causal=False``: the flash forward and backward kernels on a card
(bf16, or fp32 for an fp32 config), their plain versions on the CPU. A
padded batch (``pad_mask``) takes the dense masked path, as in the JAX
package (its ``flash_path_active`` is False for a mask): that is the
reference's dispatch, not a fallback, and it launches no flash kernel.

On a mesh (``param_specs``, ``opt_state_specs``, ``shard_state``,
``gather_state``, ``make_sharded_train_step``) each rank holds its shards:
qkv and fc-in split by columns over mp (``wqkv``'s q, k and v blocks laid
out per rank, and ``bqkv`` and ``b_in`` with them), proj and fc-out by
rows, the embedding by vocabulary (tied to the MLM decoder, whose
``mlm_bias`` follows it), ZeRO over ("dp", "sharding") by the tables;
the Megatron collectives of ``distributed.fleet``'s ``mp_layers`` and the
sharded step of ``parallel/sharded.py``, as LLaMA's. The batch is split
over ("dp", "sharding"); sep and the other axes replicate it (the
reference's sequence-parallel constraint moves no number: its attention
has no ring branch).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..distributed.fleet.meta_parallel.parallel_layers.mp_layers import (
    copy_to, parallel_cross_entropy, reduce_from, vocab_parallel_lookup)
from ..ops.kernels import flash_attention as _fa
from .llama import adamw_update, init_opt_state

__all__ = ["BertConfig", "IGNORE_INDEX", "LAYER_KEYS", "NO_DECAY_KEYS",
           "param_shapes", "init_params", "encode", "mlm_logits", "forward",
           "loss_fn", "init_opt_state", "adamw_update", "train_step",
           "make_train_step", "random_mlm_batch", "param_specs",
           "opt_state_specs", "shard_state", "gather_state",
           "make_sharded_train_step"]

IGNORE_INDEX = -100


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_layers: int = 12
    num_heads: int = 12
    max_seq_len: int = 512
    type_vocab_size: int = 2
    ln_eps: float = 1e-12
    dtype: torch.dtype = torch.bfloat16
    sharding_stage: int = 1
    # per-layer activation checkpointing; on the flash path the qkv and
    # post halves are checkpointed and attention kept outside, so its O(S)
    # residuals are saved instead of re-running the forward kernel
    remat: bool = True
    sequence_parallel: bool = False

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads

    @classmethod
    def tiny(cls, **kw):
        d = dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                 num_layers=2, num_heads=4, max_seq_len=64,
                 dtype=torch.float32, remat=False)
        d.update(kw)
        return cls(**d)

    @classmethod
    def bert_base(cls, **kw):
        return cls(**kw)  # the defaults are base

    @classmethod
    def bert_large(cls, **kw):
        d = dict(hidden_size=1024, intermediate_size=4096, num_layers=24,
                 num_heads=16)
        d.update(kw)
        return cls(**d)

    @classmethod
    def ernie_base(cls, **kw):
        """ERNIE 1.0/3.0-base: its vocabulary and segment types, BERT-base
        geometry."""
        d = dict(vocab_size=18000, type_vocab_size=4)
        d.update(kw)
        return cls(**d)


# stacked [L, ...] per-layer weights, in the JAX package's key names
LAYER_KEYS = ("wqkv", "bqkv", "wo", "bo", "ln1_g", "ln1_b",
              "w_in", "b_in", "w_out", "b_out", "ln2_g", "ln2_b")

# LayerNorm gains and biases, every bias and the embeddings take no weight
# decay (the reference's ``apply_decay_param_fun``)
NO_DECAY_KEYS = frozenset(
    ("embed", "pos_embed", "type_embed", "ln_embed_g", "ln_embed_b", "bqkv",
     "bo", "ln1_g", "ln1_b", "b_in", "b_out", "ln2_g", "ln2_b", "mlm_b",
     "mlm_ln_g", "mlm_ln_b", "mlm_bias"))


def param_shapes(cfg: BertConfig) -> Dict[str, tuple]:
    """Shape of every parameter, keyed and ordered as in the JAX
    package."""
    H, F_, V, L = (cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size,
                   cfg.num_layers)
    return {"embed": (V, H), "pos_embed": (cfg.max_seq_len, H),
            "type_embed": (cfg.type_vocab_size, H), "ln_embed_g": (H,),
            "ln_embed_b": (H,), "wqkv": (L, H, 3 * H), "bqkv": (L, 3 * H),
            "wo": (L, H, H), "bo": (L, H), "ln1_g": (L, H), "ln1_b": (L, H),
            "w_in": (L, H, F_), "b_in": (L, F_), "w_out": (L, F_, H),
            "b_out": (L, H), "ln2_g": (L, H), "ln2_b": (L, H),
            "mlm_w": (H, H), "mlm_b": (H,), "mlm_ln_g": (H,),
            "mlm_ln_b": (H,), "mlm_bias": (V,)}


_ONES = ("ln_embed_g", "ln1_g", "ln2_g", "mlm_ln_g")
_ZEROS = ("ln_embed_b", "bqkv", "bo", "ln1_b", "b_in", "b_out", "ln2_b",
          "mlm_b", "mlm_ln_b", "mlm_bias")


def init_params(cfg: BertConfig, generator: Optional[torch.Generator] = None,
                device="cuda", dtype: Optional[torch.dtype] = None
                ) -> Dict[str, torch.Tensor]:
    """Random parameters with the JAX package's keys, shapes and scales
    (normal * 0.02 for the embeddings and the matrices, ones for the norm
    gains, zeros for the biases), drawn from ``generator`` on its device,
    stored on ``device`` in ``dtype`` (default fp32, the master weights;
    every use site casts to ``cfg.dtype``)."""
    device = resolve_device(device)
    dtype = dtype or torch.float32
    g = generator if generator is not None else torch.Generator().manual_seed(0)
    out = {}
    for name, shape in param_shapes(cfg).items():
        if name in _ONES:
            t = torch.ones(shape)
        elif name in _ZEROS:
            t = torch.zeros(shape)
        else:
            t = torch.randn(shape, generator=g, device=g.device) * 0.02
        out[name] = t.to(device=device, dtype=dtype)
    return out


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _ln(x, g, b, eps):
    """LayerNorm in fp32 (the population variance), rounded to x's type,
    then the gain and bias in x's type: the JAX package's order."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    dt = x.dtype
    return y.to(dt) * g.to(dt) + b.to(dt)


def _layer_qkv(cfg: BertConfig, x, lp, mp=None):
    """The qkv projection, split into q, k, v of [B, S, heads, D]. Over an
    mp group (``mp``) ``wqkv`` and ``bqkv`` hold this rank's [q_r | k_r |
    v_r] columns, entered through ``copy_to``: q, k, v are its heads."""
    B, S, _ = x.shape
    dt = x.dtype
    qkv = copy_to(x, mp) @ lp["wqkv"].to(dt) + lp["bqkv"].to(dt)
    shape = (B, S, -1, cfg.head_dim)
    q, k, v = qkv.chunk(3, dim=-1)
    return q.reshape(shape), k.reshape(shape), v.reshape(shape)


def _attention(q, k, v, pad_mask):
    """Bidirectional attention; ``pad_mask`` [B, S] (True = a real
    token) masks padding keys, [B, 1, 1, S], on the dense path."""
    mask = None if pad_mask is None else pad_mask[:, None, None, :]
    return _fa.dot_product_attention(q, k, v, mask=mask, is_causal=False)


def _layer_post(cfg: BertConfig, x, attn, lp, mp=None):
    """Output projection, residual and LayerNorm, then the tanh-GELU
    feed-forward, residual and LayerNorm (post-LN). Over an mp group wo
    and w_out are row-parallel (their whole biases added after
    ``reduce_from``), w_in column-parallel after ``copy_to``."""
    B, S, _ = x.shape
    dt = x.dtype
    x = _ln(x + (reduce_from(attn.reshape(B, S, -1) @ lp["wo"].to(dt), mp)
                 + lp["bo"].to(dt)),
            lp["ln1_g"], lp["ln1_b"], cfg.ln_eps)
    h = F.gelu(copy_to(x, mp) @ lp["w_in"].to(dt) + lp["b_in"].to(dt),
               approximate="tanh")
    return _ln(x + (reduce_from(h @ lp["w_out"].to(dt), mp)
                    + lp["b_out"].to(dt)),
               lp["ln2_g"], lp["ln2_b"], cfg.ln_eps)


def _encoder_layer(cfg: BertConfig, x, lp, pad_mask, mp=None):
    q, k, v = _layer_qkv(cfg, x, lp, mp)
    return _layer_post(cfg, x, _attention(q, k, v, pad_mask), lp, mp)


def encode(params, tokens, cfg: BertConfig, token_type_ids=None,
           pad_mask=None, mp=None):
    """Contextual embeddings: tokens [B, S] -> [B, S, H] in cfg.dtype.
    Parameters may be fp32 master weights: each use site casts its weight
    to cfg.dtype, so gradients reach them in fp32. ``mp`` (a process
    group, on a mesh): ``params`` are this rank's shards, the vocabulary
    and the blocks' heads and columns split over it."""
    dt = cfg.dtype
    S = tokens.shape[1]
    x = vocab_parallel_lookup(params["embed"].to(dt), tokens, mp)
    x = x + params["pos_embed"].to(dt)[None, :S]
    if token_type_ids is None:
        token_type_ids = torch.zeros_like(tokens)
    x = x + params["type_embed"].to(dt)[token_type_ids.long()]
    x = _ln(x, params["ln_embed_g"], params["ln_embed_b"], cfg.ln_eps)
    # on the flash path attention stays outside the checkpointed halves,
    # so its O(S) residuals are saved rather than recomputed
    split = cfg.remat and pad_mask is None and _fa.flash_path_active(x)
    # one cast and one unbind per stacked weight (see llama.forward_hidden)
    layers = {kk: params[kk].to(dt).unbind(0) for kk in LAYER_KEYS}
    for i in range(cfg.num_layers):
        lp = {kk: layers[kk][i] for kk in LAYER_KEYS}
        if split:
            q, k, v = checkpoint(_layer_qkv, cfg, x, lp, mp,
                                 use_reentrant=False)
            attn = _attention(q, k, v, None)
            x = checkpoint(_layer_post, cfg, x, attn, lp, mp,
                           use_reentrant=False)
        elif cfg.remat:
            x = checkpoint(_encoder_layer, cfg, x, lp, pad_mask, mp,
                           use_reentrant=False)
        else:
            x = _encoder_layer(cfg, x, lp, pad_mask, mp)
    return x


def mlm_logits(params, x, cfg: BertConfig, mp=None):
    """The MLM head: a tanh-GELU transform and LayerNorm, then the decoder
    tied to the token embedding (``embed.T``) plus ``mlm_bias``.
    x [B, S, H] -> [B, S, V] (over an mp group, this rank's V / mp
    columns)."""
    dt = x.dtype
    h = F.gelu(x @ params["mlm_w"].to(dt) + params["mlm_b"].to(dt),
               approximate="tanh")
    h = _ln(h, params["mlm_ln_g"], params["mlm_ln_b"], cfg.ln_eps)
    return (copy_to(h, mp) @ params["embed"].to(dt).t()
            + params["mlm_bias"].to(dt))


def forward(params, tokens, cfg: BertConfig, token_type_ids=None,
            pad_mask=None, mp=None):
    """MLM logits [B, S, V] in cfg.dtype."""
    x = encode(params, tokens, cfg, token_type_ids, pad_mask, mp)
    return mlm_logits(params, x, cfg, mp)


def loss_fn(params, tokens, labels, cfg: BertConfig):
    """Masked-LM cross entropy in fp32 over the positions whose label is
    not ``IGNORE_INDEX``: the logsumexp is taken at every position, as in
    the JAX package, and the ignored ones score 0."""
    logits = forward(params, tokens, cfg).float()
    labels = labels.long()
    valid = labels != IGNORE_INDEX
    tgt = torch.where(valid, labels, 0)
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, tgt[..., None])[..., 0]
    per_tok = torch.where(valid, logz - gold, 0.0)
    return per_tok.sum() / valid.sum().clamp(min=1)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def train_step(params, opt_state, tokens, labels, cfg: BertConfig, lr=1e-4):
    """One step: loss and gradients, the global-norm clip
    ``min(1, 1 / (|g| + 1e-6))`` applied in fp32, then AdamW with
    ``NO_DECAY_KEYS``. Updates ``params`` and ``opt_state`` in place;
    returns (params, opt_state, loss)."""
    keys = list(params)
    leaves = {k: params[k].detach().requires_grad_() for k in keys}
    with torch.enable_grad():
        loss = loss_fn(leaves, tokens, labels, cfg)
        grads = torch.autograd.grad(loss, [leaves[k] for k in keys])
    with torch.no_grad():
        gnorm = torch.sqrt(sum(g.float().square().sum() for g in grads))
        clip = torch.clamp(1.0 / (gnorm + 1e-6), max=1.0)
        grads = {k: g.float() * clip for k, g in zip(keys, grads)}
    adamw_update(params, grads, opt_state, lr=lr,
                 no_decay_keys=NO_DECAY_KEYS)
    return params, opt_state, loss.detach()


def make_train_step(cfg: BertConfig, lr=1e-4, device="cuda"):
    """``step(params, opt_state, tokens, labels) -> (params, opt_state,
    loss)`` on ``device`` (the card unless the caller names another):
    fp32 master weights (``init_params``) and ``init_opt_state(params)``,
    updated in place. The single-device counterpart of the JAX package's
    ``make_sharded_train_step``."""
    dev = resolve_device(device)

    def step(params, opt_state, tokens, labels):
        tokens = torch.as_tensor(tokens, device=dev)
        labels = torch.as_tensor(labels, device=dev)
        return train_step(params, opt_state, tokens, labels, cfg, lr=lr)

    return step


def random_mlm_batch(cfg: BertConfig, batch: int, seq: int, seed=0,
                     mask_rate=0.15, mask_token=103, device="cuda"):
    """A synthetic MLM batch (tokens with [MASK], labels with the ignore
    index) from the JAX package's ``np.random.RandomState`` draws, so the
    arrays are equal; int32 tensors on ``device``."""
    rng = np.random.RandomState(seed)
    clean = rng.randint(0, cfg.vocab_size, (batch, seq))
    mask = rng.rand(batch, seq) < mask_rate
    mask[:, 0] = True  # at least one masked position a row
    tokens = np.where(mask, mask_token % cfg.vocab_size, clean)
    labels = np.where(mask, clean, IGNORE_INDEX)
    dev = resolve_device(device)
    return (torch.tensor(tokens, dtype=torch.int32, device=dev),
            torch.tensor(labels, dtype=torch.int32, device=dev))


# ---------------------------------------------------------------------------
# training on a mesh
# ---------------------------------------------------------------------------

def param_specs(cfg: BertConfig):
    """The reference's table: qkv and fc-in column-parallel, proj and
    fc-out row-parallel, the embedding vocabulary-parallel; ZeRO stage 3
    splits the remaining dimension over ("dp", "sharding")."""
    from ..parallel.mesh import P

    z = ("dp", "sharding") if cfg.sharding_stage >= 3 else None
    return {
        "embed": P("mp", z), "pos_embed": P(None, z),
        "type_embed": P(None, z), "ln_embed_g": P(z), "ln_embed_b": P(z),
        "wqkv": P(None, z, "mp"), "bqkv": P(None, "mp"),
        "wo": P(None, "mp", z), "bo": P(None, z),
        "ln1_g": P(None, z), "ln1_b": P(None, z),
        "w_in": P(None, z, "mp"), "b_in": P(None, "mp"),
        "w_out": P(None, "mp", z), "b_out": P(None, z),
        "ln2_g": P(None, z), "ln2_b": P(None, z),
        "mlm_w": P(z, None), "mlm_b": P(None),
        "mlm_ln_g": P(None), "mlm_ln_b": P(None),
        "mlm_bias": P("mp"),
    }


def opt_state_specs(cfg: BertConfig):
    """Moments split over ("dp", "sharding") from stage 1 (the
    reference's table; the mp-split biases and the MLM head's vectors
    stay as their parameters)."""
    from ..parallel.mesh import P

    if cfg.sharding_stage < 1:
        return param_specs(cfg)
    z = ("dp", "sharding")
    sp = dict(param_specs(cfg))
    if cfg.sharding_stage < 3:
        sp.update({
            "embed": P("mp", z), "pos_embed": P(None, z),
            "type_embed": P(None, z), "ln_embed_g": P(z), "ln_embed_b": P(z),
            "wqkv": P(None, z, "mp"), "wo": P(None, "mp", z),
            "bo": P(None, z), "ln1_g": P(None, z), "ln1_b": P(None, z),
            "w_in": P(None, z, "mp"), "w_out": P(None, "mp", z),
            "b_out": P(None, z), "ln2_g": P(None, z), "ln2_b": P(None, z),
            "mlm_w": P(z, None),
        })
    return sp


def _column_blocks(cfg: BertConfig):
    H = cfg.hidden_size
    return {"wqkv": (H, H, H), "bqkv": (H, H, H)}


def shard_state(cfg: BertConfig, mesh, params, opt_state=None):
    """Each rank's shards of whole parameters (and AdamW state) under
    ``param_specs`` / ``opt_state_specs``, on the mesh's device: the
    reference's ``device_put`` to the hybrid shardings. ``wqkv`` and
    ``bqkv``'s columns are laid out per rank as [q_r | k_r | v_r]."""
    from ..parallel import sharded

    return sharded.shard_state(mesh, param_specs(cfg), opt_state_specs(cfg),
                               params, opt_state, _column_blocks(cfg))


def gather_state(cfg: BertConfig, mesh, params, opt_state=None):
    """Whole host arrays (numpy) from every rank's shards: the inverse of
    ``shard_state``, every rank taking part."""
    from ..parallel import sharded

    return sharded.gather_state(mesh, param_specs(cfg), opt_state_specs(cfg),
                                params, opt_state, _column_blocks(cfg))


def _mesh_loss(cfg: BertConfig, mp, w, batch):
    """This rank's share of the masked-LM loss: its rows' sum over the
    global count of labelled positions, the vocab-sharded logits through
    ``parallel_cross_entropy``."""
    tokens, labels, count = batch
    logits = forward(w, tokens, cfg, mp=mp)
    return parallel_cross_entropy(logits, labels, mp,
                                  IGNORE_INDEX).sum() / count


def make_sharded_train_step(cfg: BertConfig, mesh, lr=1e-4, device="cuda"):
    """``step(params, opt_state, tokens, labels) -> (params, opt_state,
    loss)`` on each rank's shards (``shard_state``), updated in place;
    ``tokens`` and ``labels`` are the global batch, split over ("dp",
    "sharding"). On a mesh of one rank it is ``make_train_step``'s
    step. ``device`` (the card unless the caller names the CPU) must be
    the mesh's."""
    dev = resolve_device(device)
    if mesh is None or mesh.device_type != dev.type:
        raise ValueError(f"make_sharded_train_step: the mesh's device "
                         f"{getattr(mesh, 'device_type', None)!r} is not "
                         f"{dev.type!r}")
    if mesh.mesh.numel() == 1:
        return make_train_step(cfg, lr=lr, device=dev)
    from ..parallel.mesh import P, axis_group, axis_size, local_shard
    from ..parallel.sharded import ShardedStep

    n = axis_size(mesh, "mp")
    if cfg.num_heads % n:
        raise ValueError(f"num_heads {cfg.num_heads} does not divide over "
                         f"mp {n}")
    mp = axis_group(mesh, "mp")
    rows = P(("dp", "sharding"), None)

    def batch_fn(tokens, labels):
        tokens = torch.as_tensor(tokens).to(dev).long()
        labels = torch.as_tensor(labels).to(dev).long()
        count = float((labels != IGNORE_INDEX).sum().clamp(min=1))
        return ("dp", "sharding"), (local_shard(tokens, rows, mesh),
                                    local_shard(labels, rows, mesh), count)

    return ShardedStep(mesh, param_specs(cfg), opt_state_specs(cfg),
                       lambda w, b: _mesh_loss(cfg, mp, w, b), batch_fn,
                       lr, NO_DECAY_KEYS, clip_in_grad_dtype=False)
