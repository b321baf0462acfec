"""Program-space coverage: the proof that a warmed serve meets no key it
has not run.

Port of ``paddle_tpu/analysis/coverage.py`` (passes 1-3 and ``aot_audit``):

1. **Registry-only lint** (``lint_registry_only``): the serving, scheduler,
   fleet and disagg sources hold no hand-built program-key tuple (a tuple
   literal led by a registered family tag); every key comes from
   ``PROGRAM_SPACE.key``.
2. **Envelope replay** (``reachable_keys_replay``): the reachable key set
   re-derived by brute force over the envelope's integers (bucket mapping,
   prefix-hit suffix widths, the chunk ladder, resume lengths, the
   speculative width pin, the long-context rungs) through the engine's own
   helpers (``_bucket_for``, ``_long_rung``, ``_prefill_chunk_for``);
   ``check_envelope`` holds it equal to the closed-form enumeration.
3. **Enumerated against used** (``coverage_report``): after a serve, a key
   the engine ran outside the enumeration fails; an enumerated key never
   used is dead weight, reported with its warmup seconds.

``aot_audit`` runs the lint, the proof and ``aot_warmup`` in one call.
The JAX package's fourth pass (``lint_budget_coverage``, HLO peak budgets)
has no counterpart here.
"""

from __future__ import annotations

import ast
import inspect
from dataclasses import dataclass
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

__all__ = ["lint_registry_only", "lint_source", "reachable_keys_replay",
           "check_envelope", "coverage_report", "aot_audit",
           "CoverageReport"]


def _registry():
    from ..inference.program_space import PROGRAM_SPACE
    return PROGRAM_SPACE


# --- 1. registry-only construction lint ------------------------------------

def lint_source(source: str, name: str) -> List[str]:
    """Every tuple literal in ``source`` led by a registered family tag
    string (prose naming a family does not parse as a tuple)."""
    tags = _registry().tags()
    out: List[str] = []
    for node in ast.walk(ast.parse(source)):
        if not isinstance(node, ast.Tuple) or not node.elts:
            continue
        head = node.elts[0]
        if isinstance(head, ast.Constant) and head.value in tags:
            out.append(
                f"{name}:{node.lineno}: hand-built ({head.value!r}, ...) "
                f"program-key tuple: construct it via "
                f"PROGRAM_SPACE.key({head.value!r}, ...) so the coverage "
                f"enumeration sees it")
    return out


def lint_registry_only(modules: Sequence = ()) -> List[str]:
    """Lint the modules that dispatch segments (default: serving,
    scheduler, fleet and disagg) for keys built outside the registry.
    Empty list: clean."""
    if not modules:
        from ..inference import disagg, fleet, scheduler, serving
        modules = (serving, scheduler, fleet, disagg)
    out: List[str] = []
    for mod in modules:
        out.extend(lint_source(inspect.getsource(mod), mod.__name__))
    return out


# --- 2. envelope reachability replay ---------------------------------------

def _pow2(n: int, lo: int = 1) -> int:
    p = lo
    while p < n:
        p *= 2
    return p


def reachable_keys_replay(engine, envelope) -> FrozenSet[tuple]:
    """The reachable key set by replaying the admission arithmetic over
    the envelope's integers: for every admissible prefill length L and
    every block-aligned hit h < L, the key a dispatch would build for a
    group whose extremes are (L, h), through the engine's own width
    helpers, so the replay tests the runtime's arithmetic."""
    space = _registry()
    env = envelope
    keys: set = set()
    buckets = engine.buckets
    top = buckets[-1]
    lo, hi = env.admit_lengths(buckets)
    blk = env.prefix_block
    n_pads = env.n_pads or (_pow2(engine.slots),)
    spec = bool(engine.speculative or engine.sampling)

    # suffix widths a group can produce: the top bucket without a hit; with
    # one, the bucket of the longest suffix, where a row without a hit
    # contributes its whole length
    widths = {top}
    pre_widths = {(0, top)}
    hits_possible = blk is not None and hi > blk
    if hits_possible and not spec:
        for L in range(lo, hi + 1):
            for h in range(blk, L, blk):
                widths.add(engine._bucket_for(L - h))
            widths.add(engine._bucket_for(L))
    if hits_possible:
        # contiguous (pre_max, s_max): the group's longest hit with the
        # bucket of its longest suffix, dropped past max_len
        max_hit = ((hi - 1) // blk) * blk
        for h in range(blk, max_hit + 1, blk):
            for w in widths:
                if h + w <= engine.max_len:
                    pre_widths.add((h, w))

    # sequence-parallel rungs: every engaging first suffix walked down its
    # continuation chain one slab (sp * C rows) at a time
    sp = int(getattr(engine, "seq_parallel", 0) or 0)
    sp_widths: set = set()
    if engine.paged and sp:
        C = engine.prefill_chunks[-1]
        Cs = sp * C
        cap = min(env.max_prompt, engine.long_buckets[-1])
        for L in range(top + 1, cap + 1):
            s = L
            while s > 0:
                lb = engine._long_rung(s)
                sp_widths.add((-(-lb // Cs) * Cs, C))
                s -= Cs

    for n_pad in n_pads:
        for steps in env.seg_steps:
            if engine.paged and sp:
                for w, c in sp_widths:
                    keys.add(space.key("spseg", n_pad=n_pad, s_max=w,
                                       c=c, sp=sp, steps=steps))
            if engine.paged:
                if spec:
                    if steps >= 2:
                        keys.add(space.key("sseg", n_pad=n_pad,
                                           k=engine.speculative,
                                           steps=steps))
                elif engine.chunked:
                    for w in widths:
                        C = engine._prefill_chunk_for(w)
                        s_max_c = -(-w // C) * C
                        if steps >= 2 * (s_max_c // C):
                            keys.add(space.key("cseg", n_pad=n_pad,
                                               s_max=s_max_c, c=C,
                                               steps=steps))
                elif getattr(engine, "quant", None):
                    from ..quantization.serving import QUANT_CODES

                    code = QUANT_CODES[engine.quant]
                    for w in widths:
                        keys.add(space.key("qpseg", n_pad=n_pad, s_max=w,
                                           steps=steps, dtype=code))
                else:
                    fam = "qseg" if engine.quality_digest else "pseg"
                    for w in widths:
                        keys.add(space.key(fam, n_pad=n_pad, s_max=w,
                                           steps=steps))
            else:
                for pre, w in pre_widths:
                    keys.add(space.key("seg", n_pad=n_pad, s_max=w,
                                       pre_max=pre, steps=steps))
    if not engine.paged:
        from ..inference.serving import _WAVE_WIDTHS

        keys.add(space.key("decode", chunk=engine.chunk))
        for b in buckets:
            for nb in _WAVE_WIDTHS:
                if nb <= engine.slots:
                    keys.add(space.key("admit", bucket=b, nb=nb))
        if env.offline_batch:
            for n in range(1, env.offline_batch + 1):
                for L in range(1, env.max_prompt + 1):
                    for g in range(1, env.max_new_tokens + 1):
                        keys.add(space.key(
                            "drain", n_pad=_pow2(n),
                            p_max=engine._bucket_for(L),
                            g_max=_pow2(g, lo=16)))
    return frozenset(keys)


def check_envelope(engine, envelope) -> List[str]:
    """The reachability proof: every replayed key is enumerated and every
    enumerated key is replayed. Empty list: the enumeration is exactly
    the reachable set."""
    enumerated = frozenset().union(
        *engine.program_space(envelope).values())
    replayed = reachable_keys_replay(engine, envelope)
    out = [f"reachable key {k} escapes the enumeration (envelope "
           f"replay derived it; program_space did not)"
           for k in sorted(replayed - enumerated, key=repr)]
    out += [f"enumerated key {k} is unreachable (no admission "
            f"arithmetic replay produces it)"
            for k in sorted(enumerated - replayed, key=repr)]
    return out


# --- 3. enumerated against used --------------------------------------------

@dataclass
class CoverageReport:
    program_space_size: int
    families: Dict[str, int]
    lint: List[str]
    envelope_mismatches: List[str]
    unenumerated: List[tuple]          # run or used but not enumerated
    unreached: List[Tuple[tuple, float]]  # enumerated, never used (+ s)
    aot_warmup_s: Optional[float] = None

    @property
    def ok(self) -> bool:
        """Construction lints clean, the proof holds and nothing ran
        outside the enumeration (unreached keys are warnings)."""
        return not (self.lint or self.envelope_mismatches
                    or self.unenumerated)

    def format(self) -> str:
        lines = [f"program space: {self.program_space_size} keys "
                 + "(" + ", ".join(f"{f}: {n}" for f, n in
                                   sorted(self.families.items())) + ")"]
        if self.aot_warmup_s is not None:
            lines.append(f"aot warmup: {self.aot_warmup_s:.3f}s")
        for v in self.lint:
            lines.append(f"LINT: {v}")
        for v in self.envelope_mismatches:
            lines.append(f"ENVELOPE: {v}")
        for k in self.unenumerated:
            lines.append(f"UNENUMERATED KEY: {k}: a program key escaped "
                         f"the declared envelope (gate FAIL)")
        for k, s in self.unreached:
            lines.append(f"dead ladder weight: {k} never used "
                         f"(aot warmup cost {s:.3f}s)")
        return "\n".join(lines)


def coverage_report(engine, envelope=None,
                    lint: bool = True) -> CoverageReport:
    """The enumeration against what the engine ran and, after
    ``aot_warmup``, what its serve used. Call after a serve."""
    env = envelope or engine.default_envelope()
    by_family = engine.program_space(env)
    enumerated = frozenset().union(*by_family.values()) \
        if by_family else frozenset()
    ran = set(engine._progs)
    used = set(engine.prog_key_hits)
    # after a warmup every enumerated key ran: what matters is what the
    # serve touched since
    reached = used if engine.aot_warmup_s is not None else ran
    unreached = [(k, engine.aot_key_seconds.get(k, 0.0))
                 for k in sorted(enumerated - reached, key=repr)]
    return CoverageReport(
        program_space_size=len(enumerated),
        families={f: len(v) for f, v in by_family.items()},
        lint=lint_registry_only() if lint else [],
        envelope_mismatches=check_envelope(engine, env),
        unenumerated=sorted((ran | used) - enumerated, key=repr),
        unreached=unreached,
        aot_warmup_s=engine.aot_warmup_s)


def aot_audit(engine, envelope=None) -> dict:
    """Lint construction, prove the enumeration against the envelope
    replay, run ``aot_warmup`` and return the per-family report. Raises
    AssertionError on a lint or reachability failure."""
    env = envelope or engine.default_envelope()
    lint = lint_registry_only()
    if lint:
        raise AssertionError("program-key construction outside the "
                             "registry:\n" + "\n".join(lint))
    mismatches = check_envelope(engine, env)
    if mismatches:
        raise AssertionError("enumeration/reachability divergence:\n"
                             + "\n".join(mismatches))
    fam_report = engine.aot_warmup(env)
    return {
        "program_space_keys": sum(r["keys"] for r in fam_report.values()),
        "aot_warmup_s": round(engine.aot_warmup_s, 4),
        "families": {f: {"keys": r["keys"],
                         "seconds": round(r["seconds"], 4)}
                     for f, r in fam_report.items()},
    }
