"""Shadow-diff scoring of one request's two serves.

Port of ``compare_pair`` (with ``_softmax`` and ``_kl``) from
``paddle_tpu/observability/quality.py``: host Python over token lists
and the quality digests a ``ServingEngine(quality_digest=True)`` records,
``(emitted_logit, top_k_ids, top_k_values)`` per generated token. A
quantized serve is scored against its bf16 shadow this way. The
monitor, canary controller and alert rules of the JAX module are not
ported yet.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

__all__ = ["compare_pair"]


def _softmax(vals: Sequence[float]) -> List[float]:
    m = max(vals)
    ex = [math.exp(v - m) for v in vals]
    z = sum(ex)
    return [e / z for e in ex]


def _kl(p_logits: Sequence[float], q_logits: Sequence[float]) -> float:
    """KL(p || q) of the two softmax-renormalised logit vectors, which
    index the same token ids."""
    p = _softmax(p_logits)
    q = _softmax(q_logits)
    return sum(pi * (math.log(pi) - math.log(qi))
               for pi, qi in zip(p, q) if pi > 0.0)


def compare_pair(primary_tokens: Sequence[int],
                 shadow_tokens: Sequence[int],
                 primary_digests: Optional[Sequence[tuple]] = None,
                 shadow_digests: Optional[Sequence[tuple]] = None) -> dict:
    """Diff one request's primary stream against its shadow stream.

    ``first_divergence`` is the position of the first differing token, or
    the shorter length when one stream is a strict prefix of the other;
    None means a full match. Logit statistics cover the matched prefix
    only (past a divergence the two serves decode different contexts):
    the largest |difference| of the emitted token's logit, and the KL of
    the two top-k distributions renormalised over the ids both top-k
    sets share (where they share at least two)."""
    p = list(primary_tokens)
    s = list(shadow_tokens)
    n = min(len(p), len(s))
    first: Optional[int] = None
    for i in range(n):
        if p[i] != s[i]:
            first = i
            break
    if first is None and len(p) != len(s):
        first = n
    matched = first if first is not None else n
    res = {
        "match": first is None,
        "first_divergence": first,
        "compared": n,
        "tokens_matched": matched,
        "len_primary": len(p),
        "len_shadow": len(s),
        "logit_positions": 0, "logit_max_abs_err": None,
        "kl_positions": 0, "kl_max": None, "kl_mean": None,
    }
    if primary_digests and shadow_digests:
        m = min(matched, len(primary_digests), len(shadow_digests))
        abs_errs: List[float] = []
        kls: List[float] = []
        for i in range(m):
            pl, pids, pvals = primary_digests[i]
            sl, sids, svals = shadow_digests[i]
            abs_errs.append(abs(float(pl) - float(sl)))
            sset = set(sids)
            common = [t for t in pids if t in sset]
            if len(common) >= 2:
                kls.append(_kl([pvals[pids.index(t)] for t in common],
                               [svals[sids.index(t)] for t in common]))
        if abs_errs:
            res["logit_positions"] = len(abs_errs)
            res["logit_max_abs_err"] = max(abs_errs)
        if kls:
            res["kl_positions"] = len(kls)
            res["kl_max"] = max(kls)
            res["kl_mean"] = sum(kls) / len(kls)
    return res
