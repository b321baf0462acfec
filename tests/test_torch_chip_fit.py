"""The port's chip fit (``analysis/memory.py``) and
``capacity_plan(hbm_bytes=)`` against the JAX package's, on the CPU.

``page_bytes_for``, ``pool_bytes_for``, ``transient_estimate``,
``chip_fit`` (from a live pager and its engine's params, and from pool
geometry) and ``family_envelopes`` over each engine's program space give
the JAX package's numbers, field for field, for fp32, bf16, int8 and fp8
pools; ``capacity_plan``'s ``chip_fit`` section too. Then the fit's byte
counts against the tensors themselves: weights the params' bytes, the
pool its planes' and page table's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.analysis import memory as jmem
from paddle_tpu.inference.serving import ServingEngine as JaxEngine
from paddle_tpu.models import llama as jl
from paddle_tpu.observability import capacity as jcap
from paddle_tpu.parallel import set_mesh
from paddle_tpu_torch.analysis import memory as tmem
from paddle_tpu_torch.inference.serving import ServingEngine
from paddle_tpu_torch.models import llama as tl
from paddle_tpu_torch.models.convert import params_from_numpy
from paddle_tpu_torch.observability import capacity as tcap

# pool kind -> (config dtype, engine quant)
POOLS = {"fp32": ("float32", None), "bf16": ("bfloat16", None),
         "int8": ("float32", "int8"), "fp8": ("float32", "fp8")}
GEOM = dict(slots=4, max_len=96, prompt_buckets=(8, 16, 32), paged=True,
            page_size=8, num_pages=40)


@pytest.fixture(scope="module")
def models(tiny_llama):
    """(JAX cfg, params, port cfg, params) per config dtype, from the
    same numpy weights."""
    set_mesh(None)
    cfg, params = tiny_llama
    host = {k: np.asarray(v, np.float32) for k, v in params.items()}
    out = {}
    for name in ("float32", "bfloat16"):
        jcfg = jl.LlamaConfig.tiny(max_seq_len=cfg.max_seq_len,
                                   dtype=getattr(jnp, name))
        tcfg = tl.LlamaConfig.tiny(max_seq_len=cfg.max_seq_len,
                                   dtype=getattr(torch, name))
        jp = {k: jnp.asarray(v, getattr(jnp, name)) for k, v in host.items()}
        out[name] = (jcfg, jp, tcfg, params_from_numpy(host, tcfg, "cpu"))
    return out


def _engines(models, kind, **kw):
    dt, quant = POOLS[kind]
    jcfg, jp, tcfg, tp = models[dt]
    geom = {**GEOM, **kw}
    return (JaxEngine(jcfg, jp, quant=quant, **geom),
            ServingEngine(tcfg, tp, device="cpu", quant=quant, **geom))


@pytest.mark.parametrize("kind", sorted(POOLS))
def test_byte_arithmetic_equals_jax(models, kind):
    dt, quant = POOLS[kind]
    jcfg, _, tcfg, _ = models[dt]
    for psz in (8, 16):
        assert tmem.page_bytes_for(tcfg, psz, quant) == \
            jmem.page_bytes_for(jcfg, psz, quant)
        assert tmem.pool_bytes_for(tcfg, 97, psz, quant) == \
            jmem.pool_bytes_for(jcfg, 97, psz, quant)
    for n_pad, s_max, tok in ((1, 8, 1), (4, 32, 1), (8, 64, 3)):
        assert tmem.transient_estimate(tcfg, n_pad=n_pad, s_max=s_max,
                                       tokens_per_tick=tok) == \
            jmem.transient_estimate(jcfg, n_pad=n_pad, s_max=s_max,
                                    tokens_per_tick=tok)


@pytest.mark.parametrize("kind", sorted(POOLS))
def test_chip_fit_equals_jax(models, kind):
    dt, quant = POOLS[kind]
    jeng, teng = _engines(models, kind)
    for hbm in (1 << 16, 80 << 30):
        got = tmem.chip_fit(teng.cfg, teng.params, pool=teng.pager,
                            quant=quant, hbm_bytes=hbm)
        want = jmem.chip_fit(jeng.cfg, jeng.params, pool=jeng.pager,
                             quant=quant, hbm_bytes=hbm)
        assert got == want
        assert got["fits"] == (hbm > 1 << 16)
        kw = dict(page_size=8, num_pages=33, quant=quant, hbm_bytes=hbm,
                  n_pad=4, s_max=40, mesh_devices=2,
                  trace_stats={"mean_prompt_tokens": 20,
                               "mean_new_tokens": 9, "concurrency": 3})
        assert tmem.chip_fit(teng.cfg, teng.params, **kw) == \
            jmem.chip_fit(jeng.cfg, jeng.params, **kw)
        assert tmem.chip_fit(teng.cfg, weights_bytes=12345,
                             transient_bytes=777, live_pages=5, **{
                                 k: v for k, v in kw.items()
                                 if k != "trace_stats"}) == \
            jmem.chip_fit(jeng.cfg, weights_bytes=12345,
                          transient_bytes=777, live_pages=5, **{
                              k: v for k, v in kw.items()
                              if k != "trace_stats"})


@pytest.mark.parametrize("kind", sorted(POOLS))
def test_family_envelopes_equal_jax(models, kind):
    jeng, teng = _engines(models, kind)
    for kw in (dict(), dict(seg_steps=(4, 16), prefix_block=8)):
        tenv, jenv = teng.default_envelope(**kw), jeng.default_envelope(**kw)
        for hbm in (None, 1 << 30):
            got = tmem.family_envelopes(teng, tenv, hbm_bytes=hbm)
            want = jmem.family_envelopes(jeng, jenv, hbm_bytes=hbm)
            assert got == want and got


@pytest.mark.parametrize("kind", sorted(POOLS))
def test_capacity_plan_chip_fit_equals_jax(models, kind):
    dt, quant = POOLS[kind]
    jcfg, jp, tcfg, tp = models[dt]
    stats = {"mean_prompt_tokens": 40, "mean_new_tokens": 24,
             "rate_req_s": 2.0}
    kw = dict(page_size=16, slots=8, headroom=0.1,
              measured={"per_tick_s": 0.008, "slot_occupancy": 0.7},
              quant=quant)
    for extra in (dict(hbm_bytes=80 << 30),
                  dict(hbm_bytes=1 << 20, transient_bytes=4096,
                       mesh_devices=2)):
        got = tcap.capacity_plan(stats, cfg=tcfg, params=tp, **kw, **extra)
        want = jcap.capacity_plan(stats, cfg=jcfg, params=jp, **kw, **extra)
        assert got == want
        assert got["chip_fit"]["num_pages"] == got["pool_pages"]


def test_fit_counts_the_tensors(models):
    """Weights are the params' bytes and the pool its planes' and page
    table's, as allocated; the page arithmetic prices the planes."""
    _, teng = _engines(models, "int8")
    fit = tmem.chip_fit(teng.cfg, teng.params, pool=teng.pager,
                        quant="int8", hbm_bytes=80 << 30)
    assert fit["weights_bytes"] == sum(
        t.numel() * t.element_size() for t in teng.params.values())
    planes = sum(t.numel() * t.element_size()
                 for t in teng.pager.pool.values())
    table = teng.pager.page_table
    assert fit["pool_bytes"] == planes + table.numel() * table.element_size()
    assert planes == tmem.pool_bytes_for(teng.cfg, GEOM["num_pages"], 8,
                                         "int8")
    assert fit["envelope_bytes"] == (fit["weights_bytes"]
                                     + fit["pool_bytes"]
                                     + fit["transient_bytes"])
