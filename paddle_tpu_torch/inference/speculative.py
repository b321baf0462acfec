"""Speculative and sampled decoding: the draft, the verify rule and the
per-slot sampling streams of the paged engine's ``sseg`` segments.

Port of the in-program pieces of ``paddle_tpu/inference/serving.py``'s
speculative segment (``_build_spec_segment_prog``): every function here
runs on the engine's device and reads nothing back.

* ``ngram_draft``: each slot drafts K tokens from its own token history,
  the K tokens after the latest earlier occurrence of the bigram
  (previous token, next token); no match repeats the next token.
* ``verify``: the tokens a verify tick emits from the target's logits at
  the K + 1 positions. Greedy emits the target's argmax chain (the draft
  decides only how much of it lands). Sampling is rejection sampling
  against the deterministic (delta) draft: draft i is accepted with
  probability p_i(d_i), the first rejection resamples from p_i with d_i
  removed, and full acceptance earns a bonus token from p_K, so the
  emitted tokens are distributed as one-at-a-time sampling.
* The sampling streams. ``jax.random`` cannot be replayed in torch, so
  each slot carries a counter-based stream instead: a key (the request's
  seed, set at every admit) and the count of draws so far. Draw ``d``
  column ``v`` of key ``k`` is an integer hash of ``(k, d, v)``, so a
  stream depends on its key and its own draw count alone: a serve
  replays exactly, a resumed request continues from its re-seeded key,
  and a request's draws do not depend on its neighbours. A categorical
  draw is Gumbel-max over the filtered logits.
"""

from __future__ import annotations

import torch

from ..models.llama import sample_filter_logits

__all__ = ["ngram_draft", "verify", "sample_first", "stream_uniform",
           "draws_a_tick"]

_M32 = 0xFFFFFFFF
# odd multipliers below 2**31, so a product of a 32-bit value never leaves
# int64
_MUL = (0x7FEB352D, 0x5BD1E995)
_GOLD = 0x9E3779B1          # draw index spread
_COL = 0x85EBCA6B           # column spread


def _mix32(x):
    """A 32-bit integer finalizer over int64 values in [0, 2**32)."""
    x = x ^ (x >> 16)
    x = (x * _MUL[0]) & _M32
    x = x ^ (x >> 15)
    x = (x * _MUL[1]) & _M32
    return x ^ (x >> 16)


def stream_uniform(key, draws, cols: int):
    """Uniforms in (0, 1) of the streams: row r's draws ``draws[r, j]``
    (int64 [R, J]) of key ``key[r]`` (int64 [R]), ``cols`` columns each.
    Returns float32 [R, J, cols]: 23-bit values ``(b + 0.5) / 2**23``, so
    neither 0 nor 1 is reached."""
    h = _mix32(key & _M32)[:, None]
    h = _mix32((h + (draws & 0x7FFFFFFF) * _GOLD) & _M32)[..., None]
    v = torch.arange(cols, dtype=torch.int64, device=key.device)
    h = _mix32(_mix32((h + v * _COL) & _M32))
    return ((h >> 9).to(torch.float32) + 0.5) * (2.0 ** -23)


def _gumbel(key, draws, cols: int):
    u = stream_uniform(key, draws, cols)
    return -torch.log(-torch.log(u))


def draws_a_tick(K: int) -> int:
    """Draws a sampled verify tick takes from every slot's stream: K
    acceptance uniforms, K resample rows and the bonus row."""
    return 2 * K + 1


def sample_first(logits, key, sampling):
    """The first token of an admit: one categorical draw (draw 0 of key
    ``key`` [1]) from the filtered ``logits`` [1, V]. Returns [1]."""
    filt = sample_filter_logits(logits, *sampling)
    draws = torch.zeros((1, 1), dtype=torch.int64, device=logits.device)
    return torch.argmax(filt + _gumbel(key, draws, filt.shape[-1])[:, 0],
                        dim=-1)


def ngram_draft(hist, hstart, pos, nxt, K: int):
    """K drafted tokens a slot: match the running bigram ``(hist[pos - 1],
    nxt)`` over history columns ``[hstart + 1, pos)`` and take the K
    tokens after the latest match (clamped below ``pos``); no match
    repeats ``nxt``. hist [slots, max_len + 1] int64, hstart/pos [slots]
    int32, nxt [slots] int64. Returns [slots, K] int64."""
    slots, width = hist.shape
    dev = hist.device
    hcols = torch.arange(width, device=dev)
    last = torch.clamp(pos.long() - 1, min=0)
    prev = torch.gather(hist, 1, last[:, None])[:, 0]
    hprev = torch.cat([torch.zeros((slots, 1), dtype=hist.dtype, device=dev),
                       hist[:, :-1]], dim=1)
    match = ((hist == nxt[:, None]) & (hprev == prev[:, None])
             & (hcols[None] >= hstart.long()[:, None] + 1)
             & (hcols[None] < pos.long()[:, None]))
    found = match.any(dim=1)
    j = torch.argmax(torch.where(match, hcols[None], -1), dim=1)
    didx = torch.minimum(j[:, None] + 1 + torch.arange(K, device=dev)[None],
                         last[:, None])
    drafts = torch.gather(hist, 1, didx)
    return torch.where(found[:, None], drafts, nxt[:, None])


def verify(logits, drafts, nxt, sampling=None, rng=None):
    """The tokens one verify tick emits. logits [B, K+1, V] fp32 at the
    positions of ``[nxt, drafts]``; drafts [B, K]; nxt [B]. Greedy
    (``sampling`` None) or rejection sampling with ``sampling`` =
    (temperature, top_k, top_p) on the streams ``rng`` [B, 2] (key, draws
    so far), which advance by ``draws_a_tick(K)``. Returns (e [B, K+1]
    int64: the accepted drafts then the target's token, a [B]: drafts
    accepted); a slot emits ``e[:, :a + 1]``."""
    K = drafts.shape[1]
    if sampling is None:
        e = torch.argmax(logits, dim=-1)
        ok = drafts == e[:, :K]
    else:
        filt = sample_filter_logits(logits, *sampling)
        V = filt.shape[-1]
        key, first = rng[:, 0], rng[:, 1]
        draws = first[:, None] + torch.arange(
            draws_a_tick(K), dtype=torch.int64, device=logits.device)[None]
        if K:
            probs = torch.softmax(filt[:, :K], dim=-1)
            u = stream_uniform(key, draws[:, :K], 1)[..., 0]
            pd = torch.gather(probs, -1, drafts[..., None])[..., 0]
            ok = u < pd
            removed = filt[:, :K].scatter(-1, drafts[..., None],
                                          float("-inf"))
            res = torch.argmax(removed + _gumbel(key, draws[:, K:2 * K], V),
                               dim=-1)
        else:
            ok = torch.zeros((logits.shape[0], 0), dtype=torch.bool,
                             device=logits.device)
            res = torch.zeros((logits.shape[0], 0), dtype=torch.int64,
                              device=logits.device)
        bonus = torch.argmax(filt[:, K] + _gumbel(key, draws[:, 2 * K:],
                                                  V)[:, 0], dim=-1)
        a0 = torch.cumprod(ok.long(), dim=1).sum(dim=1)
        pad_d = torch.cat([drafts, nxt[:, None]], dim=1)
        res_all = torch.cat([res, bonus[:, None]], dim=1)
        ii = torch.arange(K + 1, device=logits.device)
        e = torch.where(ii[None] < a0[:, None], pad_d, res_all)
        rng[:, 1] += draws_a_tick(K)
    a = torch.cumprod(ok.long(), dim=1).sum(dim=1)
    return e, a
