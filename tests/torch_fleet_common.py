"""Shared by ``test_torch_fleet.py``, ``test_torch_disagg.py`` and
``test_torch_quality.py``: the same fleet built on both packages from the
same numpy weights (fp32, ``params_from_numpy``), each serve run on the
JAX side under a recording ``journal.Journal`` and on the port's under
that clock fed back (``journal.feed_clock``), and the comparison of what
the two serves decided.

Wall-clock fields are dropped before reports are compared, by name:
``cold_start_s`` (the report's and each replica's: build to first token,
read on ``perf_counter``, not on the decision clock). Everything else in a
report derives from the fed clock and the event stream.
"""

import numpy as np
import torch

from paddle_tpu.models import llama as jl
from paddle_tpu.observability import journal as jjournal
from paddle_tpu.parallel import set_mesh
from paddle_tpu_torch.models import llama as tl
from paddle_tpu_torch.models.convert import params_from_numpy
from paddle_tpu_torch.observability import journal as tjournal

# journal bookkeeping fields, not decisions
SKIP_KEYS = ("v", "gseq", "rank", "seq", "t")
WALL_CLOCK = ("cold_start_s",)


def port_params(params, tcfg):
    """JAX params -> the port's (fp32 on the CPU), through numpy."""
    return params_from_numpy({k: np.asarray(v) for k, v in params.items()},
                             tcfg, "cpu")


def both_models(tiny_llama):
    set_mesh(None)
    cfg, params = tiny_llama
    tcfg = tl.LlamaConfig.tiny(max_seq_len=cfg.max_seq_len)
    return cfg, params, tcfg, port_params(params, tcfg)


def dense_reference(cfg, params, prompt, n):
    out = jl.generate(params, np.asarray(prompt, np.int32)[None], cfg,
                      max_new_tokens=n, max_len=96)
    return [int(t) for t in np.asarray(out)[0]]


def records(j, kinds=None, shadow=None):
    """A journal's decision records (``DECISION_KINDS``, or ``kinds``),
    header and bookkeeping fields aside. ``shadow``: True keeps only the
    shadow-marked records, False drops them, None keeps both."""
    out = []
    for r in j.records():
        if r["kind"] == "header":
            continue
        if r["kind"] not in (kinds or jjournal.DECISION_KINDS):
            continue
        if shadow is not None and bool(r.get("shadow")) != shadow:
            continue
        out.append({k: v for k, v in r.items() if k not in SKIP_KEYS})
    return out


def report(rep):
    """``FleetReport.as_dict()`` without its wall-clock fields and the
    port's host-tier ``flushes``."""
    d = rep.as_dict()
    for k in WALL_CLOCK:
        d.pop(k)
    d["per_replica"] = [{k: v for k, v in row.items()
                         if k not in WALL_CLOCK}
                        for row in d["per_replica"]]
    for row in d["per_replica"]:
        tier = (row["prefix"] or {}).get("tier")
        if tier is not None:
            # the port's host tier counts its waits on the device; the
            # JAX tier has no such stat
            tier.pop("flushes", None)
    return d


def fed_serve(jrouter, trouter, make_arrivals, jsched, tsched, **kw):
    """Serve the same trace on both routers: JAX recorded, the port under
    its clock. Returns a dict of both reports and both journals."""
    j = jjournal.Journal()
    with jjournal.attach(j):
        jrep = jrouter.serve(make_arrivals(jsched), **kw)
    clock = [r["c"] for r in j.records() if r["kind"] == "clock"]
    t = tjournal.Journal()
    with tjournal.attach(t), tjournal.feed_clock(clock) as feed:
        trep = trouter.serve(make_arrivals(tsched), **kw)
    assert feed.remaining == 0, "the port read the clock fewer times"
    return {"jrep": jrep, "trep": trep, "jj": j, "tj": t}


def assert_same_serve(jrouter, trouter, run, kinds=None):
    """Assignment, tokens, decision records and report (wall clock
    aside) of the port's serve equal the JAX serve's."""
    assert trouter.assignment() == jrouter.assignment()
    assert trouter.results() == jrouter.results()
    want, got = records(run["jj"], kinds), records(run["tj"], kinds)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == w, (i, g, w)
    assert report(run["trep"]) == report(run["jrep"])


def two_threads():
    """The models are tiny: more intra-op threads only spin against the
    suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    return n
