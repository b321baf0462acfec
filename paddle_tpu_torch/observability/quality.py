"""Online output-quality observability: shadow-pair diffing, logit-error
budgets and canary verdicts.

Port of ``paddle_tpu/observability/quality.py``. Every value compared is
a host mirror that the serve loop's counted per-segment fetch already
brought back (tokens and quality digests both ride the event log), so
nothing here reads the device.

* :func:`final_tokens`: the stream-truncation rule both sides of a
  shadow pair are cut by (``ServingEngine.collect_finished``'s): at
  ``max_new_tokens``, and after the first EOS.
* :func:`compare_pair`: one request's primary stream against its shadow
  stream: token match and the exact first-divergence position, plus,
  when both engines carry ``quality_digest``, logit-error statistics
  over the matched prefix (the largest |difference| of the emitted
  token's logit, and a KL over the ids both top-k sets share).
* :class:`QualityMonitor`: pair results aggregated into token-match-rate
  counters, a first-divergence-position histogram, logit-error gauges,
  and ok -> warning -> page alert rules over a fast and a slow window of
  pairs with a hysteretic clear. Level changes emit ``quality_alert``
  flight events; :meth:`QualityMonitor.report` is the operator payload.
* :class:`CanaryController`: a seeded traffic split to a variant replica
  (``assign(rid)`` is a pure crc32 draw), per-class canary-against-
  control latency comparison, and a ``canary_verdict`` whose failure
  holds the canary (routing weight 0, ``canary_hold``).
* :func:`install` / :func:`uninstall`: a monitor's liveness counter on
  ``serving.SEGMENT_HOOKS``.
"""

from __future__ import annotations

import math
import zlib
from typing import Dict, List, Optional, Sequence

from . import flight as _flight
from . import metrics as _metrics
from .metrics import percentile as _pctl

__all__ = ["compare_pair", "final_tokens", "QualityMonitor",
           "CanaryController", "install", "uninstall"]

_LEVELS = ("ok", "warning", "page")
_LEVEL_RANK = {lvl: i for i, lvl in enumerate(_LEVELS)}

# first-divergence-position histogram ladder: powers of two to 512 (a
# divergence at token 0 is a wrong model or wrong weights; at token 40,
# accumulated numeric drift)
_DIVERGENCE_BUCKETS = tuple(float(2 ** i) for i in range(10))


def final_tokens(tokens: Sequence[int], max_new_tokens: int,
                 eos: Optional[int]) -> List[int]:
    """The stream-truncation rule (``ServingEngine.collect_finished``'s):
    cap at ``max_new_tokens``, cut after the first EOS. Both sides of a
    shadow pair are cut alike before diffing, or a length artifact would
    read as a divergence."""
    toks = list(tokens[:max_new_tokens])
    if eos is not None and eos in toks:
        toks = toks[:toks.index(eos) + 1]
    return toks


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


class QualityMonitor:
    """Token-match-rate + logit-error-budget alerting over shadow pairs.

    ``match_rate_warn`` / ``match_rate_page``: token-match-rate floors —
    a window whose mismatch rate exceeds ``1 - floor`` in BOTH the fast
    and slow windows escalates (the SLO monitor's two-window rule: the
    fast window gives reaction time, the slow one suppresses single-pair
    blips; with fewer pairs than a window holds, the available pairs
    ARE the window, so a hard-diverging variant pages within
    ``fast_window`` pairs of the first mirror). ``logit_abs_*`` /
    ``kl_*``: optional logit-error budgets — the fast-window MAX of
    each statistic is compared against them, catching numeric drift
    that has not (yet) flipped a token. De-escalation is hysteretic:
    ``clear_after`` consecutive calm pairs. Windows are counted in
    PAIRS (completed shadow comparisons), the quality analog of the
    SLO monitor's segment windows — deterministic on a replayed
    stream."""

    def __init__(self, match_rate_warn: float = 0.999,
                 match_rate_page: float = 0.99,
                 logit_abs_warn: Optional[float] = None,
                 logit_abs_page: Optional[float] = None,
                 kl_warn: Optional[float] = None,
                 kl_page: Optional[float] = None,
                 fast_window: int = 2, slow_window: int = 8,
                 clear_after: int = 4, pair_log_cap: int = 256):
        if not 0.0 < match_rate_page <= match_rate_warn <= 1.0:
            raise ValueError(
                f"need 0 < match_rate_page <= match_rate_warn <= 1, got "
                f"{match_rate_page}/{match_rate_warn}")
        if not 0 < fast_window <= slow_window:
            raise ValueError(f"need 0 < fast_window <= slow_window, got "
                             f"{fast_window}/{slow_window}")
        for lo, hi, nm in ((logit_abs_warn, logit_abs_page, "logit_abs"),
                           (kl_warn, kl_page, "kl")):
            if (lo is None) != (hi is None):
                raise ValueError(f"{nm}_warn and {nm}_page must be set "
                                 f"together")
            if lo is not None and not 0 < lo <= hi:
                raise ValueError(f"need 0 < {nm}_warn <= {nm}_page, got "
                                 f"{lo}/{hi}")
        self.match_rate_warn = float(match_rate_warn)
        self.match_rate_page = float(match_rate_page)
        self.logit_abs_warn = logit_abs_warn
        self.logit_abs_page = logit_abs_page
        self.kl_warn = kl_warn
        self.kl_page = kl_page
        self.fast_window = int(fast_window)
        self.slow_window = int(slow_window)
        self.clear_after = int(clear_after)
        self.pair_log_cap = int(pair_log_cap)
        self.reset()

    # --- intake -----------------------------------------------------------
    def note_segment(self) -> None:
        """Ambient liveness hook (``install`` routes every engine
        segment here): a host counter only."""
        self.segments += 1

    def note_pair(self, rid: int, primary_tokens: Sequence[int],
                  shadow_tokens: Sequence[int],
                  primary_digests: Optional[Sequence[tuple]] = None,
                  shadow_digests: Optional[Sequence[tuple]] = None,
                  cls: Optional[int] = None) -> dict:
        """One completed shadow pair: diff, account, run the alert
        rules. All inputs are host mirrors of already-fetched event
        logs — recording can never sync."""
        res = compare_pair(primary_tokens, shadow_tokens,
                           primary_digests, shadow_digests)
        res["rid"] = rid
        res["cls"] = cls
        self.pairs += 1
        self.tokens_compared += res["compared"]
        self.tokens_matched += res["tokens_matched"]
        _metrics.counter("quality.pairs").inc()
        _metrics.counter("quality.tokens_compared").inc(res["compared"])
        if not res["match"]:
            self.pairs_mismatched += 1
            bad = res["compared"] - res["tokens_matched"]
            _metrics.counter("quality.pairs_mismatched").inc()
            _metrics.counter("quality.tokens_mismatched").inc(bad)
            _metrics.histogram("quality.first_divergence_pos",
                               buckets=_DIVERGENCE_BUCKETS).observe(
                float(res["first_divergence"]))
            self.divergence_positions.append(res["first_divergence"])
            _flight.record("quality_divergence", rid=rid, cls=cls,
                           first_divergence=res["first_divergence"],
                           compared=res["compared"])
            if len(self.pair_log) < self.pair_log_cap:
                self.pair_log.append(res)
        rate = (self.tokens_matched / self.tokens_compared
                if self.tokens_compared else 1.0)
        _metrics.gauge("quality.token_match_rate").set(rate)
        if cls is not None:
            pc = self._per_class.setdefault(int(cls), [0, 0])
            pc[0] += res["tokens_matched"]
            pc[1] += res["compared"]
            _metrics.gauge(f"quality.token_match_rate[class{cls}]").set(
                pc[0] / pc[1] if pc[1] else 1.0)
        if res["logit_max_abs_err"] is not None:
            self.logit_max_abs_err = max(self.logit_max_abs_err,
                                         res["logit_max_abs_err"])
            _metrics.gauge("quality.logit_max_abs_err").set(
                self.logit_max_abs_err)
        if res["kl_max"] is not None:
            self.kl_sampled_max = max(self.kl_sampled_max, res["kl_max"])
            _metrics.gauge("quality.kl_sampled_max").set(
                self.kl_sampled_max)
        self._window.append((res["tokens_matched"], res["compared"],
                             res["logit_max_abs_err"], res["kl_max"]))
        if len(self._window) > self.slow_window:
            self._window.pop(0)
        self._evaluate()
        return res

    # --- alert rules ------------------------------------------------------
    def _bad_rate(self, n: int) -> float:
        good = tot = 0
        for m, c, _, _ in self._window[-n:]:
            good += m
            tot += c
        return (tot - good) / tot if tot else 0.0

    def _stat_max(self, idx: int, n: int) -> Optional[float]:
        vals = [w[idx] for w in self._window[-n:] if w[idx] is not None]
        return max(vals) if vals else None

    def _target_level(self) -> str:
        bad_fast = self._bad_rate(self.fast_window)
        bad_slow = self._bad_rate(self.slow_window)
        lg = self._stat_max(2, self.fast_window)
        kl = self._stat_max(3, self.fast_window)
        if ((bad_fast > 1.0 - self.match_rate_page
             and bad_slow > 1.0 - self.match_rate_page)
                or (self.logit_abs_page is not None and lg is not None
                    and lg > self.logit_abs_page)
                or (self.kl_page is not None and kl is not None
                    and kl > self.kl_page)):
            return "page"
        if ((bad_fast > 1.0 - self.match_rate_warn
             and bad_slow > 1.0 - self.match_rate_warn)
                or (self.logit_abs_warn is not None and lg is not None
                    and lg > self.logit_abs_warn)
                or (self.kl_warn is not None and kl is not None
                    and kl > self.kl_warn)):
            return "warning"
        return "ok"

    def _evaluate(self) -> None:
        target = self._target_level()
        if _LEVEL_RANK[target] > _LEVEL_RANK[self.level]:
            self._transition(target)            # escalate immediately
            self.clear_streak = 0
        elif _LEVEL_RANK[target] < _LEVEL_RANK[self.level]:
            self.clear_streak += 1              # hysteretic clear
            if self.clear_streak >= self.clear_after:
                self._transition(target)
                self.clear_streak = 0
        else:
            self.clear_streak = 0

    def _transition(self, level: str) -> None:
        prev, self.level = self.level, level
        rec = {"pair": self.pairs, "level": level, "prev": prev,
               "bad_rate_fast": round(self._bad_rate(self.fast_window), 5),
               "bad_rate_slow": round(self._bad_rate(self.slow_window), 5),
               "logit_max_fast": self._stat_max(2, self.fast_window),
               "kl_max_fast": self._stat_max(3, self.fast_window)}
        self.alert_log.append(rec)
        if _LEVEL_RANK[level] > _LEVEL_RANK[prev]:
            _metrics.counter("quality.alerts").inc()
            _metrics.counter(f"quality.alerts[{level}]").inc()
        _flight.record("quality_alert", **rec)

    # --- introspection ----------------------------------------------------
    def worst_level(self) -> str:
        return self.level

    def token_match_rate(self) -> float:
        return (self.tokens_matched / self.tokens_compared
                if self.tokens_compared else 1.0)

    def report(self) -> dict:
        """The operator's quality payload: all host data."""
        return {
            "level": self.level,
            "pairs": self.pairs,
            "pairs_mismatched": self.pairs_mismatched,
            "tokens_compared": self.tokens_compared,
            "token_match_rate": round(self.token_match_rate(), 6),
            "first_divergence_positions": list(self.divergence_positions),
            "logit_max_abs_err": (self.logit_max_abs_err
                                  if self.tokens_compared else None),
            "kl_sampled_max": (self.kl_sampled_max
                               if self.tokens_compared else None),
            "thresholds": {
                "match_rate_warn": self.match_rate_warn,
                "match_rate_page": self.match_rate_page,
                "logit_abs_warn": self.logit_abs_warn,
                "logit_abs_page": self.logit_abs_page,
                "kl_warn": self.kl_warn, "kl_page": self.kl_page,
                "fast_window": self.fast_window,
                "slow_window": self.slow_window,
                "clear_after": self.clear_after},
            "per_class": {str(c): round(m / t, 6) if t else 1.0
                          for c, (m, t) in sorted(self._per_class.items())},
            "alerts": list(self.alert_log),
            "mismatch_log": list(self.pair_log),
            "segments": self.segments,
        }

    def reset(self) -> None:
        self.level = "ok"
        self.clear_streak = 0
        self.pairs = 0
        self.pairs_mismatched = 0
        self.tokens_compared = 0
        self.tokens_matched = 0
        self.logit_max_abs_err = 0.0
        self.kl_sampled_max = 0.0
        self.segments = 0
        self.alert_log: List[dict] = []
        self.pair_log: List[dict] = []
        self.divergence_positions: List[int] = []
        self._window: List[tuple] = []
        self._per_class: Dict[int, list] = {}


class CanaryController:
    """Seeded canary traffic split + per-class verdicts + auto-hold.

    ``assign(rid)`` is a pure crc32 draw on (seed, rid) — stateless, so
    routing decisions are a function of the journal header and the
    rid alone. ``note_outcome``
    collects (kind, class) latencies for the canary and control
    populations from the host stamps the fleet loop already takes;
    every ``verdict_every`` canary finishes (and once at end of serve)
    :meth:`evaluate` compares per-class p50/p90 ratios against
    ``latency_ratio_max`` and — when a :class:`QualityMonitor` is
    linked — folds in its alert level. A failing verdict triggers the
    auto-hold: routing weight → 0 (``canary_hold`` flight + journal
    record), so the variant replica stops taking new traffic while it
    drains its backlog (the suspect-replica semantics).

    A LINKED quality monitor makes the hold depend on shadow-diff
    state that a journal header does not rebuild: ``describe()``
    records ``quality_linked``.
    """

    def __init__(self, replica: int, weight: float = 0.1, seed: int = 0,
                 latency_ratio_max: float = 1.5, min_outcomes: int = 6,
                 verdict_every: int = 8, quality_monitor=None):
        if not 0.0 <= weight <= 1.0:
            raise ValueError(f"canary weight must be in [0, 1], got "
                             f"{weight}")
        self.replica = int(replica)
        self.initial_weight = float(weight)
        self.seed = int(seed)
        self.latency_ratio_max = float(latency_ratio_max)
        self.min_outcomes = int(min_outcomes)
        self.verdict_every = int(verdict_every)
        self.quality_monitor = quality_monitor
        self.reset()

    # --- routing ----------------------------------------------------------
    def assign(self, rid: int) -> bool:
        """Deterministic draw: does fleet rid ``rid`` ride the canary?"""
        if self.held or self.weight <= 0.0:
            return False
        h = zlib.crc32(f"{self.seed}:{rid}".encode()) % 1_000_000
        return h < int(self.weight * 1_000_000)

    # --- outcomes / verdicts ----------------------------------------------
    def note_outcome(self, group: str, kind: str, priority: int,
                     latency_s: float) -> None:
        self._lat[group].setdefault((kind, int(priority)), []).append(
            float(latency_s))
        if group == "canary" and kind == "e2e":
            self._since_verdict += 1
            if self._since_verdict >= self.verdict_every:
                self.evaluate()

    def evaluate(self, final: bool = False) -> dict:
        """Compare canary vs control and journal the verdict. Classes
        without ``min_outcomes`` on BOTH sides are skipped (no verdict
        from noise); with no judgeable class and no quality signal the
        verdict is ``insufficient`` — never a hold."""
        self._since_verdict = 0
        comparisons: List[dict] = []
        any_bad = False
        for key in sorted(self._lat["canary"]):
            can = self._lat["canary"][key]
            ctl = self._lat["control"].get(key, [])
            if len(can) < self.min_outcomes or len(ctl) < self.min_outcomes:
                continue
            r50 = _pctl(can, 0.50) / max(_pctl(ctl, 0.50), 1e-9)
            r90 = _pctl(can, 0.90) / max(_pctl(ctl, 0.90), 1e-9)
            bad = max(r50, r90) > self.latency_ratio_max
            any_bad |= bad
            comparisons.append({"kind": key[0], "cls": key[1],
                                "n_canary": len(can), "n_control": len(ctl),
                                "p50_ratio": round(r50, 4),
                                "p90_ratio": round(r90, 4),
                                "ok": not bad})
        qlevel = (self.quality_monitor.worst_level()
                  if self.quality_monitor is not None else None)
        if not comparisons and qlevel in (None, "ok"):
            verdict = "insufficient"
        elif any_bad or qlevel == "page":
            verdict = "hold"
        else:
            verdict = "pass"
        rec = {"verdict": verdict, "weight": self.weight,
               "replica": self.replica, "final": final,
               "comparisons": comparisons, "quality_level": qlevel,
               "latency_ratio_max": self.latency_ratio_max}
        self.verdicts.append(rec)
        _metrics.counter("quality.canary_verdicts").inc()
        _flight.record("canary_verdict", **rec)
        if verdict == "hold" and not self.held:
            reason = ("quality_page" if qlevel == "page"
                      else "latency_ratio")
            self.hold(reason)
        return rec

    def hold(self, reason: str) -> None:
        """The auto-hold signal: routing weight → 0, journaled."""
        self.held = True
        self.hold_reason = reason
        self.weight = 0.0
        _metrics.counter("quality.canary_holds").inc()
        _metrics.gauge("quality.canary_weight").set(0.0)
        _flight.record("canary_hold", replica=self.replica, reason=reason)

    # --- lifecycle --------------------------------------------------------
    def describe(self) -> dict:
        """Rebuildable config for the journal header (replay rebuilds
        the controller from the INITIAL weight; holds re-derive
        deterministically from the fed clock's latencies)."""
        return {"replica": self.replica, "weight": self.initial_weight,
                "seed": self.seed,
                "latency_ratio_max": self.latency_ratio_max,
                "min_outcomes": self.min_outcomes,
                "verdict_every": self.verdict_every,
                "quality_linked": self.quality_monitor is not None}

    def report(self) -> dict:
        return {"replica": self.replica, "weight": self.weight,
                "initial_weight": self.initial_weight,
                "held": self.held, "hold_reason": self.hold_reason,
                "verdicts": list(self.verdicts),
                "outcomes": {g: {f"{k}/class{c}": len(v)
                                 for (k, c), v in sorted(d.items())}
                             for g, d in self._lat.items()}}

    def reset(self) -> None:
        self.weight = self.initial_weight
        self.held = False
        self.hold_reason: Optional[str] = None
        self.verdicts: List[dict] = []
        self._lat: Dict[str, Dict[tuple, List[float]]] = {
            "canary": {}, "control": {}}
        self._since_verdict = 0


# ---------------------------------------------------------------------------
# Ambient attachment (as capacity.install): route every engine segment
# into the monitor's liveness counter through serving.SEGMENT_HOOKS.
# ---------------------------------------------------------------------------

_INSTALLED: List[tuple] = []


def install(monitor: QualityMonitor) -> None:
    """Attach ``monitor`` process-wide via ``serving.SEGMENT_HOOKS``.
    Idempotent per monitor; pair with :func:`uninstall`."""
    from ..inference import serving as _serving

    for m, _ in _INSTALLED:
        if m is monitor:
            return

    def hook(steps: int, new_tokens: int, finished: int) -> None:
        monitor.note_segment()

    _serving.SEGMENT_HOOKS.append(hook)
    _INSTALLED.append((monitor, hook))


def uninstall(monitor: Optional[QualityMonitor] = None) -> None:
    """Detach ``monitor`` (or every installed monitor when ``None``)."""
    from ..inference import serving as _serving

    keep = []
    for m, hook in _INSTALLED:
        if monitor is None or m is monitor:
            if hook in _serving.SEGMENT_HOOKS:
                _serving.SEGMENT_HOOKS.remove(hook)
        else:
            keep.append((m, hook))
    _INSTALLED[:] = keep
