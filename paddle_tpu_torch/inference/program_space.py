"""Program-space registry: the engine's dispatch shapes as a declared,
statically enumerable object.

Port of ``paddle_tpu/inference/program_space.py``. Every segment, admit
wave, decode chunk and fused drain the engine dispatches is named by a
small tuple key, ``("pseg", n_pad, s_max, steps)`` and friends, built at
the dispatch point through ``PROGRAM_SPACE.key`` and nowhere else
(``analysis.coverage`` lints the serving sources for hand-built tagged
tuples). The port compiles nothing, so a key names one shape of device
work: the unit ``ServingEngine.aot_warmup`` runs once ahead of traffic,
and the unit a CUDA-graph capture of the serving step would capture.

* each family registers its key schema (tag + axis names) and an
  enumerator: the closed-form arithmetic mapping an engine's geometry and
  a declared :class:`WorkloadEnvelope` to the exact finite set of keys
  that engine can reach;
* ``ServingEngine.program_space(envelope)`` returns the enumeration and
  ``ServingEngine.aot_warmup(envelope)`` runs every key of it once.

Key tuples are those of the JAX package, tuple for tuple, for the same
engine geometry. The port's engine takes no mesh, so the families the
JAX package gates on ``mesh is None`` apply to every contiguous engine.

The chunk-width arithmetic (``chunk_for``) lives here too: the engine's
``_prefill_chunk_for`` and the ``cseg`` enumerator share its one copy.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, FrozenSet, Iterable, List, Optional, \
    Sequence, Tuple

__all__ = ["WorkloadEnvelope", "ProgramFamily", "ProgramSpace",
           "PROGRAM_SPACE", "FAMILY_TAGS", "MAX_PREFILL_CHUNKS", "chunk_for",
           "sp_rungs"]

# how many chunk steps a full-width prefill may take: a prefill starts only
# while 2 x its chunks fit the segment's step budget, so a finer chunk
# narrows the window in which long prompts can start
MAX_PREFILL_CHUNKS = 4


def chunk_for(prefill_chunks: Sequence[int], s_max: int) -> int:
    """Chunk width for an ``s_max``-wide admit window: the smallest entry
    of the ascending ladder ``prefill_chunks`` that prefills the whole
    window in at most ``MAX_PREFILL_CHUNKS`` chunks, else the largest
    entry."""
    for c in prefill_chunks:
        if c * MAX_PREFILL_CHUNKS >= s_max:
            return int(c)
    return int(prefill_chunks[-1])


def _pow2(n: int, lo: int = 1) -> int:
    p = lo
    while p < n:
        p *= 2
    return p


@dataclass(frozen=True)
class WorkloadEnvelope:
    """The declared workload a serving deployment admits: the finite input
    domain the program-space enumeration closes over.

    * ``max_prompt``: the longest prompt a client may submit (at most the
      engine's largest bucket, which ``add_request`` enforces);
    * ``max_new_tokens``: the largest generation a client may request;
    * ``seg_steps``: every ``max_steps`` the serve loop passes to
      ``run_segment`` / ``dispatch_segment`` (``run()`` uses ``4 *
      chunk``);
    * ``n_pads``: the dispatch ``n_pad`` values; empty means the engine
      default (``pow2(slots)``);
    * ``resume``: whether preempt-resume and failover-requeue admissions
      occur (they prefill prompt + generated tokens, up to ``max_prompt +
      max_new_tokens - 1``, capped at the largest bucket);
    * ``prefix_block``: the prefix cache's block when one is attached
      (hits are block multiples; None: no suffix-bucketed widths);
    * ``offline_batch``: the largest ``run(fused=True)`` drain batch, or
      None when the deployment serves online only (no ``drain`` keys).
    """
    max_prompt: int
    max_new_tokens: int
    seg_steps: Tuple[int, ...]
    n_pads: Tuple[int, ...] = ()
    resume: bool = True
    prefix_block: Optional[int] = None
    offline_batch: Optional[int] = None

    def __post_init__(self):
        if self.max_prompt < 1:
            raise ValueError(f"max_prompt must be >= 1, got "
                             f"{self.max_prompt}")
        if self.max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got "
                             f"{self.max_new_tokens}")
        if not self.seg_steps:
            raise ValueError("envelope needs at least one seg_steps value")
        object.__setattr__(self, "seg_steps",
                           tuple(sorted({int(s) for s in self.seg_steps})))
        object.__setattr__(self, "n_pads",
                           tuple(sorted({int(n) for n in self.n_pads})))

    def admit_lengths(self, buckets: Sequence[int]) -> Tuple[int, int]:
        """(min, max) tokens one admission can prefill: fresh requests up
        to ``max_prompt``; with ``resume``, prompt + generated tokens,
        capped at the largest bucket (``can_preempt`` refuses to preempt
        what could not be admitted again)."""
        hi = self.max_prompt
        if self.resume:
            hi = self.max_prompt + self.max_new_tokens - 1
        return 1, min(hi, max(buckets))


@dataclass(frozen=True)
class ProgramFamily:
    """One program-key family: schema and enumerator.

    ``tag`` leads the key tuple (None for the admit family, whose
    ``(bucket, nb)`` keys carry no tag); ``axes`` name the other
    positions. ``enumerate_fn(engine, envelope)`` yields every key the
    family can reach from that engine under that envelope;
    ``applies(engine)`` says whether the engine dispatches the family.
    ``budget_program`` names the JAX package's canonical gate program for
    the family (kept for the record: the port has no HLO budgets)."""
    name: str
    tag: Optional[str]
    axes: Tuple[str, ...]
    doc: str
    enumerate_fn: Callable
    applies: Callable
    budget_program: Optional[str] = None

    def key(self, **kw) -> tuple:
        missing = [a for a in self.axes if a not in kw]
        extra = [k for k in kw if k not in self.axes]
        if missing or extra:
            raise TypeError(
                f"program family {self.name!r} takes axes {self.axes}; "
                f"missing {missing}, unexpected {extra}")
        vals = tuple(int(kw[a]) for a in self.axes)
        return vals if self.tag is None else (self.tag,) + vals


class ProgramSpace:
    """The registry: families by name, the key constructor and the
    whole-engine enumeration."""

    def __init__(self):
        self._families: Dict[str, ProgramFamily] = {}

    def register(self, family: ProgramFamily) -> ProgramFamily:
        if family.name in self._families:
            raise ValueError(f"program family {family.name!r} already "
                             f"registered")
        self._families[family.name] = family
        return family

    def family(self, name: str) -> ProgramFamily:
        if name not in self._families:
            raise KeyError(f"unknown program family {name!r}; registered: "
                           f"{sorted(self._families)}")
        return self._families[name]

    def families(self) -> List[str]:
        return sorted(self._families)

    def tags(self) -> FrozenSet[str]:
        return frozenset(f.tag for f in self._families.values()
                         if f.tag is not None)

    def key(self, name: str, **axes) -> tuple:
        """The key constructor: every key the engine dispatches is built
        here (``analysis.coverage.lint_registry_only`` holds the serving
        sources to it)."""
        return self.family(name).key(**axes)

    def family_of(self, key: tuple) -> Optional[str]:
        """The registered family a key tuple belongs to (None when it
        matches no schema)."""
        if not isinstance(key, tuple) or not key:
            return None
        if isinstance(key[0], str):
            for f in self._families.values():
                if f.tag == key[0] and len(key) == 1 + len(f.axes):
                    return f.name
            return None
        for f in self._families.values():
            if f.tag is None and len(key) == len(f.axes) \
                    and all(isinstance(v, int) for v in key):
                return f.name
        return None

    def enumerate(self, engine, envelope: WorkloadEnvelope
                  ) -> FrozenSet[tuple]:
        """The exact finite key set ``engine`` can dispatch under
        ``envelope``: the union of every applicable family's
        enumeration."""
        keys: set = set()
        for f in self._families.values():
            if f.applies(engine):
                keys.update(f.enumerate_fn(engine, envelope))
        return frozenset(keys)

    def enumerate_by_family(self, engine, envelope: WorkloadEnvelope
                            ) -> Dict[str, FrozenSet[tuple]]:
        return {f.name: frozenset(f.enumerate_fn(engine, envelope))
                for f in self._families.values() if f.applies(engine)}


PROGRAM_SPACE = ProgramSpace()


# --- shared enumeration arithmetic -----------------------------------------
# These mirror the engine's dispatch-time width arithmetic exactly;
# analysis/coverage.py re-derives the same sets by replaying the admission
# arithmetic over the envelope's integers and checks that the two agree.


def _bucket_for(buckets: Sequence[int], n: int) -> int:
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"no bucket for prompt length {n}")


def _n_pads(engine, env: WorkloadEnvelope) -> Tuple[int, ...]:
    return env.n_pads or (_pow2(engine.slots),)


def _reachable_widths(engine, env: WorkloadEnvelope,
                      spec_pinned: bool) -> FrozenSet[int]:
    """Admit-window widths (s_max) a dispatch can produce. Without a
    prefix cache (or for the width-pinned speculative family) every
    dispatch pins to the largest bucket. With one, a group holding a hit
    buckets its longest suffix, which ranges over [1, L_adm]: every
    bucket covering some admissible length, plus the top bucket."""
    buckets = engine.buckets
    top = buckets[-1]
    if spec_pinned or env.prefix_block is None:
        return frozenset((top,))
    lo, hi = env.admit_lengths(buckets)
    if hi <= env.prefix_block:
        # no admissible length carries a block-aligned hit and a
        # nonempty suffix: suffix bucketing never engages
        return frozenset((top,))
    widths = {top}
    for b in buckets:
        if b >= lo:
            widths.add(b)
        if b >= hi:
            break
    return frozenset(widths)


def _dense_pre_widths(engine, env: WorkloadEnvelope
                      ) -> FrozenSet[Tuple[int, int]]:
    """(pre_max, s_max) pairs the contiguous segment can reach: pre_max 0
    pins s_max to the top bucket; pre_max > 0 is a block-rounded hit
    shorter than the admission, paired with any suffix bucket. Pairs past
    max_len drop to (0, top) at dispatch."""
    buckets = engine.buckets
    top = buckets[-1]
    pairs = {(0, top)}
    blk = env.prefix_block
    if blk is None:
        return frozenset(pairs)
    lo, hi = env.admit_lengths(buckets)
    max_pre = ((hi - 1) // blk) * blk
    widths = _reachable_widths(engine, env, spec_pinned=False)
    pre = blk
    while pre <= max_pre:
        for w in widths:
            if pre + w <= engine.max_len:
                pairs.add((pre, w))
        pre += blk
    return frozenset(pairs)


# --- family predicates ------------------------------------------------------


def _is_dense(engine) -> bool:
    return not engine.paged


def _quant(engine) -> Optional[str]:
    # getattr: coverage's replay probes may run against stand-ins
    return getattr(engine, "quant", None)


def _is_paged_plain(engine) -> bool:
    return (engine.paged and not engine.chunked and not engine.speculative
            and not engine.sampling and not engine.quality_digest
            and not _quant(engine))


def _is_paged_quality(engine) -> bool:
    return engine.paged and engine.quality_digest and not _quant(engine)


def _is_paged_quant(engine) -> bool:
    # a quantized engine's every paged segment (digests included) lives on
    # the qpseg dtype axis
    return engine.paged and bool(_quant(engine))


def _is_paged_chunked(engine) -> bool:
    return (engine.paged and engine.chunked
            and not (engine.speculative or engine.sampling))


def _is_paged_spec(engine) -> bool:
    return engine.paged and bool(engine.speculative or engine.sampling)


def _seq_parallel(engine) -> int:
    return int(getattr(engine, "seq_parallel", 0) or 0)


def _is_paged_sp(engine) -> bool:
    # spseg adds to a sequence-parallel engine's space: regular traffic
    # still rides pseg / cseg
    return engine.paged and _seq_parallel(engine) > 0


def sp_rungs(engine, env: WorkloadEnvelope) -> Tuple[int, ...]:
    """The ``long_buckets`` rungs a sequence-parallel engine can reach
    under ``env``. A long prefill engages past the largest regular bucket;
    continuations shrink its suffix by whole slabs (``sp * C`` rows), so
    the reachable suffixes are those congruent, modulo the slab, to some
    engaging length (coverage's replay walks the chains instead)."""
    lbs = engine.long_buckets
    top_b = engine.buckets[-1]
    cap = min(env.max_prompt, lbs[-1])
    if cap <= top_b:
        return ()
    Cs = _seq_parallel(engine) * engine.prefill_chunks[-1]
    residues = {f % Cs for f in range(top_b + 1,
                                      min(cap, top_b + Cs) + 1)}
    rungs = set()
    for s in range(1, cap + 1):
        if s % Cs not in residues:
            continue
        for b in lbs:
            if s <= b:
                rungs.add(b)
                break
    return tuple(sorted(rungs))


# --- family enumerators -----------------------------------------------------


def _enum_admit(engine, env: WorkloadEnvelope) -> Iterable[tuple]:
    # the windowed path's prefill waves: every bucket x wave width that
    # fits the slots
    from .serving import _WAVE_WIDTHS

    fam = PROGRAM_SPACE.family("admit")
    for b in engine.buckets:
        for nb in _WAVE_WIDTHS:
            if nb <= engine.slots:
                yield fam.key(bucket=b, nb=nb)


def _enum_decode(engine, env: WorkloadEnvelope) -> Iterable[tuple]:
    yield PROGRAM_SPACE.family("decode").key(chunk=engine.chunk)


def _enum_drain(engine, env: WorkloadEnvelope) -> Iterable[tuple]:
    # the offline drain (run(fused=True)): n_pad = pow2(batch), p_max the
    # bucket of the longest prompt, g_max = pow2(longest generation, floor
    # 16); only when the envelope declares an offline batch
    if not env.offline_batch:
        return
    fam = PROGRAM_SPACE.family("drain")
    n_pads = sorted({_pow2(n) for n in range(1, env.offline_batch + 1)})
    p_maxes = sorted({_bucket_for(engine.buckets, ln)
                      for ln in range(1, env.max_prompt + 1)})
    g_maxes = sorted({_pow2(g, lo=16)
                      for g in range(1, env.max_new_tokens + 1)})
    for n_pad in n_pads:
        for p_max in p_maxes:
            for g_max in g_maxes:
                yield fam.key(n_pad=n_pad, p_max=p_max, g_max=g_max)


def _enum_seg(engine, env: WorkloadEnvelope) -> Iterable[tuple]:
    fam = PROGRAM_SPACE.family("seg")
    for n_pad in _n_pads(engine, env):
        for steps in env.seg_steps:
            for pre, w in _dense_pre_widths(engine, env):
                yield fam.key(n_pad=n_pad, s_max=w, pre_max=pre,
                              steps=steps)


def _enum_pseg(engine, env: WorkloadEnvelope) -> Iterable[tuple]:
    fam = PROGRAM_SPACE.family("pseg")
    for n_pad in _n_pads(engine, env):
        for steps in env.seg_steps:
            for w in _reachable_widths(engine, env, spec_pinned=False):
                yield fam.key(n_pad=n_pad, s_max=w, steps=steps)


def _enum_qseg(engine, env: WorkloadEnvelope) -> Iterable[tuple]:
    fam = PROGRAM_SPACE.family("qseg")
    for n_pad in _n_pads(engine, env):
        for steps in env.seg_steps:
            for w in _reachable_widths(engine, env, spec_pinned=False):
                yield fam.key(n_pad=n_pad, s_max=w, steps=steps)


def _enum_qpseg(engine, env: WorkloadEnvelope) -> Iterable[tuple]:
    from ..quantization.serving import QUANT_CODES

    fam = PROGRAM_SPACE.family("qpseg")
    code = QUANT_CODES[_quant(engine)]
    for n_pad in _n_pads(engine, env):
        for steps in env.seg_steps:
            for w in _reachable_widths(engine, env, spec_pinned=False):
                yield fam.key(n_pad=n_pad, s_max=w, steps=steps,
                              dtype=code)


def _enum_cseg(engine, env: WorkloadEnvelope) -> Iterable[tuple]:
    fam = PROGRAM_SPACE.family("cseg")
    for n_pad in _n_pads(engine, env):
        for steps in env.seg_steps:
            for w in _reachable_widths(engine, env, spec_pinned=False):
                C = chunk_for(engine.prefill_chunks, w)
                s_max_c = -(-w // C) * C
                if steps < 2 * (s_max_c // C):
                    continue    # dispatch raises before building this key
                yield fam.key(n_pad=n_pad, s_max=s_max_c, c=C, steps=steps)


def _enum_spseg(engine, env: WorkloadEnvelope) -> Iterable[tuple]:
    fam = PROGRAM_SPACE.family("spseg")
    sp = _seq_parallel(engine)
    C = engine.prefill_chunks[-1]
    Cs = sp * C
    for n_pad in _n_pads(engine, env):
        for steps in env.seg_steps:
            for lb in sp_rungs(engine, env):
                yield fam.key(n_pad=n_pad, s_max=-(-lb // Cs) * Cs,
                              c=C, sp=sp, steps=steps)


def _enum_sseg(engine, env: WorkloadEnvelope) -> Iterable[tuple]:
    fam = PROGRAM_SPACE.family("sseg")
    for n_pad in _n_pads(engine, env):
        for steps in env.seg_steps:
            if steps < 2:
                continue        # dispatch raises before building this key
            yield fam.key(n_pad=n_pad, k=engine.speculative, steps=steps)


PROGRAM_SPACE.register(ProgramFamily(
    name="admit", tag=None, axes=("bucket", "nb"),
    doc="windowed prefill wave of nb requests at a bucket: (bucket, nb)",
    enumerate_fn=_enum_admit, applies=_is_dense,
    budget_program="serving_segment"))

PROGRAM_SPACE.register(ProgramFamily(
    name="decode", tag="decode", axes=("chunk",),
    doc="windowed decode chunk: ('decode', chunk)",
    enumerate_fn=_enum_decode, applies=_is_dense,
    budget_program="decode_tick"))

PROGRAM_SPACE.register(ProgramFamily(
    name="drain", tag="drain", axes=("n_pad", "p_max", "g_max"),
    doc="offline whole-queue drain: ('drain', n_pad, p_max, g_max)",
    enumerate_fn=_enum_drain, applies=_is_dense,
    budget_program="serving_segment"))

PROGRAM_SPACE.register(ProgramFamily(
    name="seg", tag="seg", axes=("n_pad", "s_max", "pre_max", "steps"),
    doc="contiguous re-entrant segment: ('seg', n_pad, s_max, pre_max, "
        "steps)",
    enumerate_fn=_enum_seg, applies=_is_dense,
    budget_program="serving_segment"))

PROGRAM_SPACE.register(ProgramFamily(
    name="pseg", tag="pseg", axes=("n_pad", "s_max", "steps"),
    doc="paged segment: ('pseg', n_pad, s_max, steps)",
    enumerate_fn=_enum_pseg, applies=_is_paged_plain,
    budget_program="paged_serving_segment"))

PROGRAM_SPACE.register(ProgramFamily(
    name="qseg", tag="qseg", axes=("n_pad", "s_max", "steps"),
    doc="quality-digest paged segment: ('qseg', n_pad, s_max, steps)",
    enumerate_fn=_enum_qseg, applies=_is_paged_quality,
    budget_program="quality_serving_segment"))

PROGRAM_SPACE.register(ProgramFamily(
    name="qpseg", tag="qpseg", axes=("n_pad", "s_max", "steps", "dtype"),
    doc="quantized paged segment: ('qpseg', n_pad, s_max, steps, dtype), "
        "dtype the QUANT_CODES code (int8 1, fp8 2); digests compose "
        "without an axis",
    enumerate_fn=_enum_qpseg, applies=_is_paged_quant,
    budget_program="quant_serving_segment"))

PROGRAM_SPACE.register(ProgramFamily(
    name="cseg", tag="cseg", axes=("n_pad", "s_max", "c", "steps"),
    doc="chunked-prefill paged segment: ('cseg', n_pad, s_max_c, C, "
        "steps)",
    enumerate_fn=_enum_cseg, applies=_is_paged_chunked,
    budget_program="chunked_serving_segment"))

PROGRAM_SPACE.register(ProgramFamily(
    name="sseg", tag="sseg", axes=("n_pad", "k", "steps"),
    doc="speculative/sampled paged segment: ('sseg', n_pad, K, steps), "
        "its width pinned to the largest bucket",
    enumerate_fn=_enum_sseg, applies=_is_paged_spec,
    budget_program="spec_serving_segment"))

PROGRAM_SPACE.register(ProgramFamily(
    name="spseg", tag="spseg", axes=("n_pad", "s_max", "c", "sp", "steps"),
    doc="sequence-parallel long-context segment: ('spseg', n_pad, s_max, "
        "C, sp, steps), s_max a slab-rounded long_buckets rung, C the "
        "largest prefill chunk, sp the slab's rows; adds to the engine's "
        "pseg / cseg space",
    enumerate_fn=_enum_spseg, applies=_is_paged_sp,
    budget_program="longctx_serving_segment"))


FAMILY_TAGS: FrozenSet[str] = PROGRAM_SPACE.tags()
