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

The JAX module's ``param_specs``, ``opt_state_specs`` and
``make_sharded_train_step`` wait for the distributed slice.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..device import resolve_device
from ..ops.kernels import flash_attention as _fa
from .llama import adamw_update, init_opt_state

__all__ = ["BertConfig", "IGNORE_INDEX", "LAYER_KEYS", "NO_DECAY_KEYS",
           "param_shapes", "init_params", "encode", "mlm_logits", "forward",
           "loss_fn", "init_opt_state", "adamw_update", "train_step",
           "make_train_step", "random_mlm_batch"]

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


def _layer_qkv(cfg: BertConfig, x, lp):
    """The qkv projection, split into q, k, v of [B, S, heads, D]."""
    B, S, _ = x.shape
    dt = x.dtype
    qkv = x @ lp["wqkv"].to(dt) + lp["bqkv"].to(dt)
    shape = (B, S, cfg.num_heads, cfg.head_dim)
    q, k, v = qkv.chunk(3, dim=-1)
    return q.reshape(shape), k.reshape(shape), v.reshape(shape)


def _attention(q, k, v, pad_mask):
    """Bidirectional attention; ``pad_mask`` [B, S] (True = a real
    token) masks padding keys, [B, 1, 1, S], on the dense path."""
    mask = None if pad_mask is None else pad_mask[:, None, None, :]
    return _fa.dot_product_attention(q, k, v, mask=mask, is_causal=False)


def _layer_post(cfg: BertConfig, x, attn, lp):
    """Output projection, residual and LayerNorm, then the tanh-GELU
    feed-forward, residual and LayerNorm (post-LN)."""
    B, S, H = x.shape
    dt = x.dtype
    x = _ln(x + (attn.reshape(B, S, H) @ lp["wo"].to(dt) + lp["bo"].to(dt)),
            lp["ln1_g"], lp["ln1_b"], cfg.ln_eps)
    h = F.gelu(x @ lp["w_in"].to(dt) + lp["b_in"].to(dt), approximate="tanh")
    return _ln(x + (h @ lp["w_out"].to(dt) + lp["b_out"].to(dt)),
               lp["ln2_g"], lp["ln2_b"], cfg.ln_eps)


def _encoder_layer(cfg: BertConfig, x, lp, pad_mask):
    q, k, v = _layer_qkv(cfg, x, lp)
    return _layer_post(cfg, x, _attention(q, k, v, pad_mask), lp)


def encode(params, tokens, cfg: BertConfig, token_type_ids=None,
           pad_mask=None):
    """Contextual embeddings: tokens [B, S] -> [B, S, H] in cfg.dtype.
    Parameters may be fp32 master weights: each use site casts its weight
    to cfg.dtype, so gradients reach them in fp32."""
    dt = cfg.dtype
    S = tokens.shape[1]
    x = params["embed"].to(dt)[tokens.long()]
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
            q, k, v = checkpoint(_layer_qkv, cfg, x, lp, use_reentrant=False)
            attn = _attention(q, k, v, None)
            x = checkpoint(_layer_post, cfg, x, attn, lp,
                           use_reentrant=False)
        elif cfg.remat:
            x = checkpoint(_encoder_layer, cfg, x, lp, pad_mask,
                           use_reentrant=False)
        else:
            x = _encoder_layer(cfg, x, lp, pad_mask)
    return x


def mlm_logits(params, x, cfg: BertConfig):
    """The MLM head: a tanh-GELU transform and LayerNorm, then the decoder
    tied to the token embedding (``embed.T``) plus ``mlm_bias``.
    x [B, S, H] -> [B, S, V]."""
    dt = x.dtype
    h = F.gelu(x @ params["mlm_w"].to(dt) + params["mlm_b"].to(dt),
               approximate="tanh")
    h = _ln(h, params["mlm_ln_g"], params["mlm_ln_b"], cfg.ln_eps)
    return h @ params["embed"].to(dt).t() + params["mlm_bias"].to(dt)


def forward(params, tokens, cfg: BertConfig, token_type_ids=None,
            pad_mask=None):
    """MLM logits [B, S, V] in cfg.dtype."""
    x = encode(params, tokens, cfg, token_type_ids, pad_mask)
    return mlm_logits(params, x, cfg)


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
