"""The port's kernel experiments (``benchmarks/dot_variants.py``'s blocked
matmul and ``benchmarks/flash_variants.py``'s packed forward, backward and
ablations) against the reference's Pallas kernels, on the CPU.

The reference modules are imported by path (``benchmarks/`` is no
package) and their ``pallas_call`` runs in interpret mode, reached by
patching ``jax.experimental.pallas.pallas_call`` (the functions look it up
when they are called). A CPU tensor takes the port's plain version: the
CUDA kernel's function written out in PyTorch. Inputs are numpy from a
seed, the same through both sides.

Tolerances. float32 inputs: 2e-5 (rtol and atol), the two sides summing in
other orders (as ``test_torch_flash.py``). bf16 rounding inside the
function (bf16 inputs, ``exp_bf16``, the matmul's bf16 output): two bf16
ulps, rtol 2^-7 with an atol of 2^-7 of the largest reference value; a
float32 sum that lands on the other side of a bf16 rounding point moves
one rounded value by an ulp, and that value may feed a product. The
ablations' outputs span 1e-3 to 1e9 (exp2 of unscaled scores), and where a
row's only visible key makes ``dp - delta`` cancel to rounding noise both
sides hold noise: there the atol is that tolerance times the largest
reference value.
"""

import functools
import importlib.util
import sys
from pathlib import Path

import jax
import jax.experimental.pallas as pallas
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu_torch.ops.kernels import blocked_matmul as bm
from paddle_tpu_torch.ops.kernels import flash_variants as fv

ROOT = Path(__file__).resolve().parents[1]
F32_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_RTOL = 2.0 ** -7


@pytest.fixture(scope="module")
def ref():
    """``benchmarks/flash_variants.py`` and ``dot_variants.py``, loaded by
    path with ``benchmarks/`` on sys.path for their timing helpers."""
    mods = {}
    sys.path.insert(0, str(ROOT / "benchmarks"))
    try:
        for name in ("flash_variants", "dot_variants"):
            spec = importlib.util.spec_from_file_location(
                f"_ref_{name}", ROOT / "benchmarks" / f"{name}.py")
            mods[name] = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mods[name])
    finally:
        sys.path.remove(str(ROOT / "benchmarks"))
    return mods


@pytest.fixture
def interpret(monkeypatch):
    """Every ``pallas_call`` in interpret mode, on the CPU."""
    monkeypatch.setattr(pallas, "pallas_call", functools.partial(
        pallas.pallas_call, interpret=True))


JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(seed, B, S, H, D, dtype, n=4):
    """n arrays [B, S, H, D] as (JAX, port) pairs, rounded to ``dtype``."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        a = rng.randn(B, S, H, D).astype(np.float32)
        out.append((jnp.asarray(a).astype(JDT[dtype]),
                    torch.from_numpy(a).to(TDT[dtype])))
    return out


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _close(got, want, exact_f32, of_max=False):
    """``exact_f32``: no bf16 rounding inside the function; ``of_max``:
    the fp32 atol scales with the largest reference value."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    if exact_f32:
        tol = dict(F32_TOL)
        if of_max:
            tol["atol"] *= max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got, want, **tol)
    else:
        atol = BF16_RTOL * float(np.abs(want).max())
        np.testing.assert_allclose(got, want, rtol=BF16_RTOL, atol=atol)


def _t(*arrays):
    return [torch.from_numpy(_np(a)) for a in arrays]


# ---------------------------------------------------------------------------
# run_fwd / run_bwd
# ---------------------------------------------------------------------------

FWD_CASES = [  # B, S, H, D, dtype, causal, nsplit, exp_bf16
    *[(1, 128, 4, 64, "float32", c, n, e) for c in (True, False)
      for n in (1, 2, 4) for e in (False, True)],
    (1, 128, 2, 128, "float32", True, 2, False),
    (1, 128, 2, 128, "float32", True, 4, True),
    (1, 128, 2, 128, "bfloat16", False, 1, False),
    (2, 128, 4, 64, "bfloat16", True, 1, False),
    (2, 128, 4, 64, "bfloat16", True, 2, True),
    (1, 128, 4, 64, "bfloat16", False, 4, True),
    # more key tiles than the S 128 cases reach: R = 64 over three tiles,
    # and R = 32, where a 64-row tile holds two extents
    (1, 192, 2, 64, "float32", True, 3, False),
    (1, 256, 2, 64, "float32", True, 8, False),
    (1, 256, 2, 64, "bfloat16", True, 8, True),
    (1, 192, 2, 128, "float32", False, 3, False),
]


@pytest.mark.parametrize("B,S,H,D,dtype,causal,nsplit,exp_bf16", FWD_CASES)
def test_run_fwd_and_bwd_match_pallas(ref, interpret, B, S, H, D, dtype,
                                      causal, nsplit, exp_bf16):
    """out and the base-2 lse [B, G, hp, S]; then dq, dk, dv from the
    reference's own out and lse, so only the backward differs."""
    R = ref["flash_variants"]
    (jq, tq), (jk, tk), (jv, tv), (jdo, tdo) = _inputs(
        S + D + nsplit, B, S, H, D, dtype)
    exact = dtype == "float32" and not exp_bf16
    jout, jlse = R.run_fwd(jq, jk, jv, causal, nsplit, exp_bf16)
    out, lse = fv.run_fwd(tq, tk, tv, causal, nsplit, exp_bf16)
    assert lse.shape == (B, H // (128 // D), 128 // D, S)
    assert lse.dtype == torch.float32 and out.dtype == TDT[dtype]
    _close(out, jout, exact)
    _close(lse, jlse, exact)
    jg = R.run_bwd(jq, jk, jv, jdo, jout, jlse, causal, nsplit, exp_bf16)
    tout, tlse = _t(jout, jlse)
    g = fv.run_bwd(tq, tk, tv, tdo, tout.to(TDT[dtype]), tlse, causal,
                   nsplit, exp_bf16)
    for a, b in zip(g, jg):
        assert a.dtype == TDT[dtype]
        _close(a, b, exact)


# ---------------------------------------------------------------------------
# run_fwd2
# ---------------------------------------------------------------------------

FWD2_CASES = [  # dtype, causal, qblocks, p_bf16, in_kernel_scale
    *[("float32", True, qb, False, s) for qb in (1, 2, 4)
      for s in (True, False)],
    ("float32", False, 2, False, True),
    *[("bfloat16", True, qb, p, s) for qb in (1, 2)
      for p in (False, True) for s in (True, False)],
    ("bfloat16", False, 4, True, True),
]


@pytest.mark.parametrize("dtype,causal,qblocks,p_bf16,scale_in", FWD2_CASES)
def test_run_fwd2_matches_pallas(ref, interpret, dtype, causal, qblocks,
                                 p_bf16, scale_in):
    """The scale folded into the kernel, l over bf16 p, q rows split over
    the grid: the port's result is the same for every ``qblocks``."""
    B, S, H, D = 2, 128, 4, 64
    (jq, tq), (jk, tk), (jv, tv) = _inputs(qblocks + 7, B, S, H, D, dtype,
                                           n=3)
    jout, jlse = ref["flash_variants"].run_fwd2(jq, jk, jv, causal, qblocks,
                                                p_bf16, scale_in)
    out, lse = fv.run_fwd2(tq, tk, tv, causal, qblocks, p_bf16, scale_in)
    exact = dtype == "float32"
    _close(out, jout, exact)
    _close(lse, jlse, exact)
    out1, lse1 = fv.run_fwd2(tq, tk, tv, causal, 1, p_bf16, scale_in)
    assert torch.equal(out, out1) and torch.equal(lse, lse1)


def test_prescale_rounds_like_jax():
    """``bf16(q * c)`` with c in fp32, bit for bit the reference's (c
    rounded to bf16 first would differ on about a third of the values)."""
    x = np.random.RandomState(0).randn(4096).astype(np.float32)
    c = fv._scale(64) * fv.LOG2_E
    jq = jnp.asarray(x).astype(jnp.bfloat16)
    # the reference's prescale, flash_variants.py:148
    want = _np((jq * (1.0 / np.sqrt(64) * float(np.log2(np.e))))
               .astype(jnp.bfloat16))
    got = _np(fv._prescale(torch.from_numpy(x).bfloat16(), c))
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the ablations of run_diag
# ---------------------------------------------------------------------------

def _diag_call(R, make, drop, shapes, n_out, *args):
    """One ablation's ``pallas_call``, built as ``run_diag`` builds it."""
    b, S, h, d = shapes
    hp = 128 // d
    G = h // hp
    hd = h * d
    blk = pallas.BlockSpec((1, S, hp * d), lambda bb, g: (bb, 0, g))
    lse_blk = pallas.BlockSpec((1, 1, hp, S), lambda bb, g: (bb, g, 0, 0))
    flat = [a.reshape(b, S, hd) for a in args[:5]] + list(args[5:])
    in_specs = [blk] * min(len(args), 5) + [lse_blk] * (len(args) - 5)
    if n_out == 2:
        out_specs = [blk, lse_blk]
        out_shape = [jax.ShapeDtypeStruct((b, S, hd), args[0].dtype),
                     jax.ShapeDtypeStruct((b, G, hp, S), jnp.float32)]
    else:
        out_specs = [blk] * 3
        out_shape = [jax.ShapeDtypeStruct((b, S, hd), args[0].dtype)] * 3
    outs = pallas.pallas_call(make(S, d, hp, drop), grid=(b, G),
                              in_specs=in_specs, out_specs=out_specs,
                              out_shape=out_shape)(*flat)
    return [o.reshape(b, S, h, d) if o.ndim == 3 else o for o in outs]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("drop", fv.FWD_DROPS, ids=lambda d: "-".join(d)
                         or "none")
def test_fwd_diag_matches_pallas(ref, interpret, drop, dtype):
    R = ref["flash_variants"]
    shapes = (1, 128, 4, 64)
    (jq, tq), (jk, tk), (jv, tv) = _inputs(11, *shapes, dtype, n=3)
    jout, jlse = _diag_call(R, R.make_fwd_diag, tuple(drop), shapes, 2, jq,
                            jk, jv)
    out, lse = fv.fwd_diag(tq, tk, tv, drop)
    _close(out, jout, dtype == "float32", of_max=True)
    _close(lse, jlse, dtype == "float32", of_max=True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("drop", fv.BWD_DROPS, ids=lambda d: "-".join(d)
                         or "none")
def test_bwd_diag_matches_pallas(ref, interpret, drop, dtype):
    """From a forward's out and base-2 lse (``run_fwd``'s, as
    ``diag_main`` feeds the production forward's), the same to both."""
    R = ref["flash_variants"]
    shapes = (1, 128, 4, 64)
    (jq, tq), (jk, tk), (jv, tv), (jdo, tdo) = _inputs(13, *shapes, dtype)
    tout, tlse = fv.run_fwd_plain(tq, tk, tv)
    jout = jnp.asarray(_np(tout)).astype(JDT[dtype])
    jlse = jnp.asarray(_np(tlse))
    jg = _diag_call(R, R.make_bwd_diag, tuple(drop), shapes, 3, jq, jk, jv,
                    jdo, jout, jlse)
    g = fv.bwd_diag(tq, tk, tv, tdo, tout, tlse, drop)
    for a, b in zip(g, jg):
        _close(a, b, dtype == "float32", of_max=True)


# ---------------------------------------------------------------------------
# pallas_matmul
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tile", bm.TILES)
def test_blocked_matmul_matches_pallas(ref, interpret, dtype, tile):
    """bf16 out of an fp32 accumulator over K chunks of ``bk``, at every
    tile instance of the kernel."""
    rng = np.random.RandomState(5)
    a = rng.randn(256, 192).astype(np.float32)
    b = rng.randn(192, 256).astype(np.float32)
    want = ref["dot_variants"].pallas_matmul(
        jnp.asarray(a).astype(JDT[dtype]), jnp.asarray(b).astype(JDT[dtype]),
        *tile)
    got = bm.blocked_matmul(torch.from_numpy(a).to(TDT[dtype]),
                            torch.from_numpy(b).to(TDT[dtype]), *tile)
    assert got.dtype == torch.bfloat16 and got.shape == (256, 256)
    _close(got, want, False)


# ---------------------------------------------------------------------------
# what the port rejects
# ---------------------------------------------------------------------------

def test_shapes_the_port_rejects():
    """Heads that do not fill packed blocks, S not divisible by nsplit or
    qblocks, an unknown stage, a tile that is no instance or does not
    divide the shape, a wrong lse layout."""
    x = torch.zeros(1, 128, 3, 64)
    with pytest.raises(ValueError, match="packed blocks"):
        fv.run_fwd(x, x, x)
    y = torch.zeros(1, 96, 2, 64)
    with pytest.raises(ValueError, match="nsplit"):
        fv.run_fwd(y, y, y, nsplit=5)
    with pytest.raises(ValueError, match="qblocks"):
        fv.run_fwd2(y, y, y, qblocks=5)
    with pytest.raises(ValueError, match="stage"):
        fv.fwd_diag(y, y, y, ("delta",))
    with pytest.raises(ValueError, match="lse"):
        fv.run_bwd(y, y, y, y, y, torch.zeros(1, 2, 96))
    a = torch.zeros(256, 64)
    with pytest.raises(ValueError, match="instance"):
        bm.blocked_matmul(a, torch.zeros(64, 256), 64, 64, 64)
    with pytest.raises(ValueError, match="divisible"):
        bm.blocked_matmul(a, torch.zeros(64, 192), 128, 128, 32)


def test_ptxas_report_reads_each_kernel():
    """A build's ``-Xptxas -v`` log, kernel by kernel: registers, static
    shared memory, stack and spill bytes (``chip_smoke.py`` phase 7 prints
    them for each flash-variant instance it times and fails on spills)."""
    from paddle_tpu_torch.ops.kernels._build import ptxas_report

    log = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_16fv_fwdILi64ELi1EEEv14CUtensorMap_st' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_16fv_fwdILi64ELi1EEEv14CUtensorMap_st
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 106 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_16fv_bwdILi64ELi17EEEv14CUtensorMap_st' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_16fv_bwdILi64ELi17EEEv14CUtensorMap_st
    8 bytes stack frame, 28 bytes spill stores, 32 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 64 bytes smem, 400 bytes cmem[0]
"""
    rep = ptxas_report(log)
    assert rep == {
        "_ZN12_GLOBAL__N_16fv_fwdILi64ELi1EEEv14CUtensorMap_st": dict(
            registers=106, smem=0, stack=0, spill_stores=0, spill_loads=0),
        "_ZN12_GLOBAL__N_16fv_bwdILi64ELi17EEEv14CUtensorMap_st": dict(
            registers=168, smem=64, stack=8, spill_stores=28,
            spill_loads=32)}
    assert ptxas_report("") == {}


def test_experiments_need_a_gpu(monkeypatch):
    """The experiments' entry points run on the card and raise without
    one."""
    from paddle_tpu_torch.experiments import dot_variants, flash_variants

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (dot_variants.main, flash_variants.main,
                 flash_variants.diag_main):
        with pytest.raises(RuntimeError, match="CUDA"):
            main([])


def test_turns_need_a_gpu_and_another_checkout(monkeypatch):
    """``turns`` names its arguments without one, and raises without a
    card before it starts any turn."""
    from paddle_tpu_torch.experiments import turns

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(turns, "_turn", lambda root: pytest.fail(
        "a turn started without a card"))
    with pytest.raises(SystemExit, match="OTHER_ROOT"):
        turns.main([])
    with pytest.raises(RuntimeError, match="CUDA"):
        turns.main([str(ROOT)])


def test_launch_counters_name_every_counted_wrapper():
    """``launch_counters`` lists every counter a kernel wrapper keeps (a
    function of ``ops/kernels`` with an int ``launches``,
    ``quant_launches`` or ``f32_launches``), each once."""
    import paddle_tpu_torch.ops.kernels as kernels

    listed = {(fn, attr) for fn, attr in kernels.launch_counters().values()}
    found = set()
    for path in (ROOT / "paddle_tpu_torch/ops/kernels").glob("*.py"):
        if path.stem.startswith("_"):
            continue
        mod = importlib.import_module(f"{kernels.__name__}.{path.stem}")
        for fn in vars(mod).values():
            if callable(fn) and getattr(fn, "__module__", "") == mod.__name__:
                for attr in ("launches", "quant_launches", "f32_launches"):
                    if isinstance(getattr(fn, attr, None), int):
                        found.add((fn, attr))
    assert listed == found
    assert len(kernels.launch_counters()) == len(found)


def test_graph_replays_count_the_launches(monkeypatch):
    """A call captured into a CUDA graph launches nothing until the graph
    replays: the timer takes the capture's count back and adds it at each
    replay (the graph is a stand-in here, the count logic is the
    timer's)."""
    import contextlib

    from paddle_tpu_torch.experiments import _timing

    class Graph:
        def replay(self):
            pass

    monkeypatch.setattr(torch.cuda, "graph",
                        lambda graph, pool=None: contextlib.nullcontext())
    monkeypatch.setattr(bm.blocked_matmul, "launches", 5)
    monkeypatch.setattr(fv.variant_fwd, "launches", 0)

    def body():
        for _ in range(3):
            bm.blocked_matmul.launches += 1  # a launch the wrapper counts

    graph = Graph()
    captured = _timing._capture(graph, body)
    assert captured == [(bm.blocked_matmul, "launches", 3)]
    assert bm.blocked_matmul.launches == 5
    for _ in range(2):
        _timing._replay(graph, captured)
    assert bm.blocked_matmul.launches == 5 + 2 * 3
    assert fv.variant_fwd.launches == 0
