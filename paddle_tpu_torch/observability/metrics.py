"""Process-wide metrics registry: counters, gauges and fixed-bucket
histograms, recorded from host values only.

Port of ``paddle_tpu/observability/metrics.py``. Every number the serving
stack publishes already exists on the host: the segment replay works on
the event log that the engine's one counted fetch brought back. So the
registry takes host scalars only, and a ``torch.Tensor`` is refused
(``_host_scalar``): reading one would be a device-to-host copy that
synchronises the stream, a fetch the serve loop never counted.

Recording costs one module-flag branch and one float add (counters) or one
``bisect`` (histograms). Creating a metric takes the registry lock once;
recording takes none (one writer per metric in practice).

Several processes merge **snapshots**, not live objects: each writes
``write_snapshot(log_dir)`` (a rank-tagged JSON file) and
``merge_log_dir`` / ``merge_snapshots`` reduce them: counters and
histogram buckets sum, gauges keep a per-rank map with min/max/sum.
Export is Prometheus text (``render_prometheus``) or JSON (``snapshot``).
"""

from __future__ import annotations

import bisect
import contextlib
import glob
import json
import math
import os
import re
import threading
from typing import Dict, List, Optional, Sequence

__all__ = [
    "Counter", "Gauge", "Histogram", "Registry", "registry",
    "counter", "gauge", "histogram", "percentile", "snapshot",
    "render_prometheus", "merge_snapshots", "write_snapshot",
    "merge_log_dir", "set_enabled", "enabled", "reset",
    "scoped_registry", "LATENCY_BUCKETS_S",
]


class _State:
    enabled = True


_STATE = _State()


def set_enabled(on: bool) -> bool:
    """Turn all recording on or off (off: every metric call is a no-op).
    Returns the previous state so callers can restore it."""
    prev = _STATE.enabled
    _STATE.enabled = bool(on)
    return prev


def enabled() -> bool:
    return _STATE.enabled


# Default latency buckets: ~1 ms to 64 s in powers of two.
LATENCY_BUCKETS_S = tuple(0.001 * 2 ** i for i in range(17))


def _host_scalar(v) -> float:
    """``v`` as a float, refusing device values.

    ``float()`` of a ``torch.Tensor`` on a card copies it to the host and
    waits for the stream: telemetry must only consume values a counted
    fetch already delivered, so any tensor (on any device: the check
    cannot depend on where the caller happens to run) is a caller bug,
    reported here."""
    t = type(v)
    if t is float or t is int or t is bool:
        return float(v)
    if _is_tensor(v):
        raise TypeError(
            f"telemetry records host scalars only, got {t.__name__}: read "
            f"the value through the engine's counted fetch first (the "
            f"zero-extra-sync contract of paddle_tpu_torch.observability)")
    return float(v)  # numpy scalars and other host number types


def _is_tensor(v) -> bool:
    """Whether ``v`` is a torch tensor, without importing torch for the
    common host types."""
    mod = type(v).__module__
    if not mod.startswith("torch"):
        return False
    import torch

    return isinstance(v, torch.Tensor)


class Counter:
    """Monotonic count (admissions, backpressure, cache hits)."""

    __slots__ = ("name", "help", "value")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if _STATE.enabled:
            self.value += _host_scalar(n)

    def _reset(self) -> None:
        self.value = 0.0

    def _snap(self) -> dict:
        return {"value": self.value}


class Gauge:
    """Last observed level (queue depth, slot occupancy)."""

    __slots__ = ("name", "help", "value")

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self.value = 0.0

    def set(self, v: float) -> None:
        if _STATE.enabled:
            self.value = _host_scalar(v)

    def _reset(self) -> None:
        self.value = 0.0

    def _snap(self) -> dict:
        return {"value": self.value}


class Histogram:
    """Fixed-bucket histogram (TTFT, end-to-end latency, step time).

    ``buckets`` are ascending upper bounds; an implicit +inf bucket takes
    the tail. ``quantile`` interpolates linearly inside the covering
    bucket; ``percentile`` gives exact small-population percentiles."""

    __slots__ = ("name", "help", "buckets", "counts", "sum", "count",
                 "min", "max")

    def __init__(self, name: str, help: str = "",
                 buckets: Sequence[float] = LATENCY_BUCKETS_S):
        self.name = name
        self.help = help
        self.buckets = tuple(float(b) for b in buckets)
        if list(self.buckets) != sorted(set(self.buckets)):
            raise ValueError(f"buckets must be strictly ascending: "
                             f"{buckets}")
        self.counts = [0] * (len(self.buckets) + 1)  # +1: the +inf tail
        self.sum = 0.0
        self.count = 0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, v: float) -> None:
        if not _STATE.enabled:
            return
        v = _host_scalar(v)
        self.counts[bisect.bisect_left(self.buckets, v)] += 1
        self.sum += v
        self.count += 1
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    def quantile(self, q: float) -> float:
        """Estimated q-quantile (0 <= q <= 1) by in-bucket linear
        interpolation, clamped to the observed [min, max]."""
        if not self.count:
            return 0.0
        rank = q * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            if seen + c >= rank and c:
                lo = self.buckets[i - 1] if i > 0 else min(self.min, 0.0)
                hi = (self.buckets[i] if i < len(self.buckets)
                      else max(self.max, lo))
                frac = (rank - seen) / c
                est = lo + frac * (hi - lo)
                return min(max(est, self.min), self.max)
            seen += c
        return self.max

    def _reset(self) -> None:
        self.counts = [0] * (len(self.buckets) + 1)
        self.sum = 0.0
        self.count = 0
        self.min = math.inf
        self.max = -math.inf

    def _snap(self) -> dict:
        return {"buckets": list(self.buckets), "counts": list(self.counts),
                "sum": self.sum, "count": self.count,
                "min": (None if self.count == 0 else self.min),
                "max": (None if self.count == 0 else self.max)}


def percentile(xs: Sequence[float], q: float) -> float:
    """Nearest-rank percentile over the full sample list: sorted ``xs``,
    index ``min(len - 1, int(len * q))``; 0.0 when empty. The one rule
    every serving report uses."""
    if not xs:
        return 0.0
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(len(xs) * q))]


class Registry:
    """Name to metric map. One process-wide default (``registry()``);
    tests build private ones to stand for ranks."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, object] = {}

    def _get(self, cls, name: str, help: str, **kw):
        m = self._metrics.get(name)
        if m is not None:
            if not isinstance(m, cls):
                raise TypeError(f"metric {name!r} already registered as "
                                f"{type(m).__name__}, not {cls.__name__}")
            return m
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = cls(name, help, **kw)
                self._metrics[name] = m
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, name, help)

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = LATENCY_BUCKETS_S) -> Histogram:
        return self._get(Histogram, name, help, buckets=buckets)

    def reset(self) -> None:
        """Zero every metric in place (handles held by hot paths stay
        registered)."""
        for m in self._metrics.values():
            m._reset()

    def snapshot(self, rank: Optional[int] = None) -> dict:
        if rank is None:
            rank = _default_rank()
        snap = {"rank": rank, "counters": {}, "gauges": {},
                "histograms": {}}
        for name, m in sorted(self._metrics.items()):
            kind = ("counters" if isinstance(m, Counter) else
                    "gauges" if isinstance(m, Gauge) else "histograms")
            snap[kind][name] = m._snap()
        return snap

    def render_prometheus(self) -> str:
        """Prometheus text exposition. A bracket tag in a metric name
        (``request.ttft[class0]``) renders as a label (``class="0"``),
        label values are escaped, other illegal name characters become
        ``_``, series of one family share one ``# TYPE`` line, and
        histogram buckets are cumulative with the ``+Inf`` bucket."""
        families: Dict[str, dict] = {}
        order: List[str] = []
        for name, m in sorted(self._metrics.items()):
            pname, labels = _prom_name(name)
            kind = ("counter" if isinstance(m, Counter) else
                    "gauge" if isinstance(m, Gauge) else "histogram")
            fam = families.get(pname)
            if fam is None:
                fam = families[pname] = {"kind": kind, "help": m.help,
                                         "series": []}
                order.append(pname)
            fam["help"] = fam["help"] or m.help
            fam["series"].append((labels, m))
        lines: List[str] = []
        for pname in order:
            fam = families[pname]
            if fam["help"]:
                lines.append(f"# HELP {pname} {fam['help']}")
            lines.append(f"# TYPE {pname} {fam['kind']}")
            for labels, m in fam["series"]:
                lab = _prom_labels(labels)
                if isinstance(m, Counter):
                    lines.append(f"{pname}_total{lab} {_fmt(m.value)}")
                elif isinstance(m, Gauge):
                    lines.append(f"{pname}{lab} {_fmt(m.value)}")
                else:
                    cum = 0
                    for b, c in zip(m.buckets, m.counts):
                        cum += c
                        lines.append(f"{pname}_bucket" + _prom_labels(
                            labels + [("le", _fmt(b))]) + f" {cum}")
                    cum += m.counts[-1]
                    lines.append(f"{pname}_bucket" + _prom_labels(
                        labels + [("le", "+Inf")]) + f" {cum}")
                    lines.append(f"{pname}_sum{lab} {_fmt(m.sum)}")
                    lines.append(f"{pname}_count{lab} {m.count}")
        return "\n".join(lines) + ("\n" if lines else "")


def _fmt(v: float) -> str:
    return repr(int(v)) if float(v).is_integer() else repr(float(v))


_PROM_BAD = re.compile(r"[^a-zA-Z0-9_:]")
_PROM_TAG = re.compile(r"^(.*)\[([^\[\]]+)\]$")
# ``class0`` / ``req12``: an alpha key fused to a numeric value
_PROM_KEYVAL = re.compile(r"^([A-Za-z_]+?)(\d+)$")


def _prom_name(name: str):
    """(exposition name, labels) of a registry metric name: a bracket tag
    becomes a label (alpha + digits split into key and value, anything
    else under ``tag``), dots become underscores, and other illegal
    characters ``_``."""
    labels: List[tuple] = []
    m = _PROM_TAG.match(name)
    if m:
        name, tag = m.group(1), m.group(2)
        kv = _PROM_KEYVAL.match(tag)
        if kv:
            labels.append((kv.group(1), kv.group(2)))
        else:
            labels.append(("tag", tag))
    return _PROM_BAD.sub("_", name.replace(".", "_")), labels


def _prom_escape(v: str) -> str:
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _prom_labels(labels) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_prom_escape(v)}"' for k, v in labels)
    return "{" + inner + "}"


def _default_rank() -> int:
    """This process's ``torch.distributed`` rank, 0 outside a process
    group."""
    try:
        import torch.distributed as dist

        return (dist.get_rank()
                if dist.is_available() and dist.is_initialized() else 0)
    except Exception:
        return 0


_REGISTRY = Registry()


def registry() -> Registry:
    return _REGISTRY


@contextlib.contextmanager
def scoped_registry(reg: Registry):
    """Route the module-level ``counter`` / ``gauge`` / ``histogram``
    into ``reg`` for the block, so engines sharing one process keep their
    telemetry apart (each writes its own rank-tagged snapshot). Not
    thread-safe across concurrent scopes: the serve loop is one
    thread."""
    global _REGISTRY
    prev = _REGISTRY
    _REGISTRY = reg
    try:
        yield reg
    finally:
        _REGISTRY = prev


def counter(name: str, help: str = "") -> Counter:
    return _REGISTRY.counter(name, help)


def gauge(name: str, help: str = "") -> Gauge:
    return _REGISTRY.gauge(name, help)


def histogram(name: str, help: str = "",
              buckets: Sequence[float] = LATENCY_BUCKETS_S) -> Histogram:
    return _REGISTRY.histogram(name, help, buckets=buckets)


def snapshot(rank: Optional[int] = None,
             registry: Optional[Registry] = None) -> dict:
    return (registry or _REGISTRY).snapshot(rank=rank)


def render_prometheus() -> str:
    return _REGISTRY.render_prometheus()


def reset() -> None:
    _REGISTRY.reset()


def merge_snapshots(snaps: Sequence[dict]) -> dict:
    """Reduce rank-tagged snapshots: counters and histogram buckets sum,
    gauges keep the per-rank levels plus min/max/sum."""
    merged = {"ranks": sorted(int(s.get("rank", 0)) for s in snaps),
              "counters": {}, "gauges": {}, "histograms": {}}
    for s in snaps:
        rank = int(s.get("rank", 0))
        for name, c in s.get("counters", {}).items():
            e = merged["counters"].setdefault(name, {"value": 0.0})
            e["value"] += c["value"]
        for name, g in s.get("gauges", {}).items():
            e = merged["gauges"].setdefault(
                name, {"by_rank": {}, "min": math.inf, "max": -math.inf,
                       "sum": 0.0})
            v = g["value"]
            e["by_rank"][str(rank)] = v
            e["min"] = min(e["min"], v)
            e["max"] = max(e["max"], v)
            e["sum"] += v
        for name, h in s.get("histograms", {}).items():
            e = merged["histograms"].get(name)
            if e is None:
                merged["histograms"][name] = {
                    "buckets": list(h["buckets"]),
                    "counts": list(h["counts"]), "sum": h["sum"],
                    "count": h["count"], "min": h["min"], "max": h["max"]}
                continue
            if e["buckets"] != list(h["buckets"]):
                raise ValueError(
                    f"histogram {name!r}: rank bucket ladders differ — "
                    f"ranks must share one metric definition")
            e["counts"] = [a + b for a, b in zip(e["counts"], h["counts"])]
            e["sum"] += h["sum"]
            e["count"] += h["count"]
            for k, pick in (("min", min), ("max", max)):
                if h[k] is not None:
                    e[k] = h[k] if e[k] is None else pick(e[k], h[k])
    return merged


def write_snapshot(log_dir: str, rank: Optional[int] = None,
                   registry: Optional[Registry] = None) -> str:
    """Write a rank-tagged snapshot (``telemetry_rank<r>.json``) into
    ``log_dir``; returns the path."""
    if rank is None:
        rank = _default_rank()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"telemetry_rank{rank}.json")
    with open(path, "w") as f:
        json.dump(snapshot(rank=rank, registry=registry), f, indent=1)
    return path


def merge_log_dir(log_dir: str) -> dict:
    """Merge every ``telemetry_rank*.json`` under ``log_dir``. A
    truncated or corrupt file (a process killed mid-write) is skipped and
    flagged: counted in ``telemetry.merge_skipped_files``, recorded as a
    ``merge_skipped`` flight event and listed under ``"skipped_files"``.
    Only a directory with no readable snapshot raises."""
    from . import flight as _flight

    snaps = []
    skipped: List[str] = []
    for p in sorted(glob.glob(os.path.join(log_dir,
                                           "telemetry_rank*.json"))):
        try:
            with open(p) as f:
                snap = json.load(f)
            if not isinstance(snap, dict):
                raise ValueError(f"snapshot is {type(snap).__name__}, "
                                 f"not an object")
            snaps.append(snap)
        except (json.JSONDecodeError, ValueError, OSError) as e:
            skipped.append(os.path.basename(p))
            counter("telemetry.merge_skipped_files",
                    "rank snapshots skipped as truncated/corrupt").inc()
            _flight.record("merge_skipped", file=os.path.basename(p),
                           error=f"{type(e).__name__}: {e}")
    if not snaps:
        raise FileNotFoundError(
            f"no readable telemetry_rank*.json under {log_dir}"
            + (f" ({len(skipped)} skipped as corrupt)" if skipped else ""))
    merged = merge_snapshots(snaps)
    if skipped:
        merged["skipped_files"] = skipped
    return merged
