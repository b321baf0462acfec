"""The port's ring and Ulysses attention (``paddle_tpu_torch/ops/
ring_attention.py``) against the JAX package's, on the CPU.

The JAX side runs ``ring_attention`` / ``ulysses_attention`` under
``shard_map`` on the 8 virtual CPU devices (one jitted program a case:
output and the vector-Jacobian product of a seeded cotangent); the
port's runs on each rank's rows in one world of 4 spawned gloo ranks
(``experiments.mesh_train.attention_cases``), sep 4 over the world and
sep 2 on a dp 2 x sep 2 mesh, outputs and q/k/v gradients gathered whole.
fp32, within 1e-5. The whole-array entries are held to the JAX entries
on dp 2 x sep 2, and their dense branch (a sequence that does not divide
over sep) to the JAX package's, with a spy on ``fallback``.
"""

import functools

import jax
import numpy as np
import pytest
from jax.sharding import PartitionSpec as JP

from paddle_tpu.ops.pallas import ring_attention as jra
from paddle_tpu.parallel import create_hybrid_mesh as jmesh
from paddle_tpu.parallel import set_mesh as jset_mesh
from paddle_tpu.parallel import shard_map_compat
from paddle_tpu_torch.experiments import mesh_train

TOL = dict(rtol=1e-5, atol=1e-5)
LOCAL = [(impl, causal, sep) for impl in ("ring", "ulysses")
         for causal in (False, True) for sep in (2, 4)]
# whole-array entries on dp 2 x sep 2: S 16 shards over sep; S 5 does not
# divide, and both packages take the dense branch
ENTRY = [("ring", True, 16), ("ulysses", False, 16), ("ring", True, 5),
         ("ulysses", True, 5)]


def _qkvc(seed, s=16):
    r = np.random.RandomState(seed)
    return [r.standard_normal((2, s, 4, 8)).astype(np.float32)
            for _ in range(4)]


def _layout(sep):
    return dict(sep=4) if sep == 4 else dict(dp=2, sep=2)


def _jax_local(impl, causal, sep, q, k, v, cot):
    mesh = jmesh(**_layout(sep), devices=jax.devices()[:4])
    jset_mesh(None)
    fn = {"ring": jra.ring_attention, "ulysses": jra.ulysses_attention}[impl]
    spec = JP(None, "sep", None, None)
    f = shard_map_compat(functools.partial(fn, axis_name="sep",
                                           is_causal=causal),
                         mesh, (spec,) * 3, spec)

    @jax.jit
    def run(q, k, v, cot):
        out, vjp = jax.vjp(f, q, k, v)
        return out, vjp(cot)

    out, grads = run(q, k, v, cot)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _jax_entry(impl, causal, q, k, v, cot):
    mesh = jmesh(dp=2, sep=2, devices=jax.devices()[:4])
    jset_mesh(None)
    fn = {"ring": jra.context_parallel_attention,
          "ulysses": jra.ulysses_parallel_attention}[impl]

    @jax.jit
    def run(q, k, v, cot):
        f = functools.partial(fn, mesh=mesh, is_causal=causal,
                              batch_axes=("dp",))
        out, vjp = jax.vjp(f, q, k, v)
        return out, vjp(cot)

    out, grads = run(q, k, v, cot)
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.fixture(scope="module")
def run():
    cases, refs = [], []
    for i, (impl, causal, sep) in enumerate(LOCAL):
        q, k, v, cot = _qkvc(i)
        cases.append(dict(impl=impl, causal=causal, layout=_layout(sep),
                          q=q, k=k, v=v, cot=cot))
        refs.append(_jax_local(impl, causal, sep, q, k, v, cot))
    for i, (impl, causal, s) in enumerate(ENTRY):
        q, k, v, cot = _qkvc(100 + i, s)
        cases.append(dict(impl=impl, causal=causal, layout=dict(dp=2, sep=2),
                          q=q, k=k, v=v, cot=cot, entry=True,
                          batch_axes=("dp",)))
        refs.append(_jax_entry(impl, causal, q, k, v, cot))
    port = mesh_train.spawn(mesh_train.attention_cases, 4, args=(cases,),
                            timeout=120)[0]
    return refs, port


def _close(got, want):
    out, grads = want
    np.testing.assert_allclose(got["out"], out, **TOL)
    for g, w in zip(got["grads"], grads):
        np.testing.assert_allclose(g, w, **TOL)


@pytest.mark.parametrize("i", range(len(LOCAL)),
                         ids=[f"{a}-{'causal' if c else 'full'}-sep{s}"
                              for a, c, s in LOCAL])
def test_local_function_matches_shard_map(run, i):
    refs, port = run
    _close(port[i], refs[i])


@pytest.mark.parametrize("j", range(len(ENTRY)),
                         ids=[f"{a}-{'causal' if c else 'full'}-S{s}"
                              for a, c, s in ENTRY])
def test_whole_array_entry_and_its_dense_branch(run, j):
    """The entries shard S 16 over sep (``fallback`` not called) and take
    the dense branch for S 5 (``fallback`` called), as the JAX entries
    do; outputs and gradients equal JAX's either way."""
    refs, port = run
    i = len(LOCAL) + j
    _close(port[i], refs[i])
    assert port[i]["fallback"] is (ENTRY[j][2] % 2 != 0)


def test_sp_divides_tests_the_shapes():
    """The dense branch is chosen by the shapes, never by an error: the
    axis absent, the sequence, batch or heads not dividing, or (Ulysses)
    the per-shard head count not dividing by the axis."""
    from paddle_tpu_torch.ops import ring_attention as pra

    m = _FakeMesh()
    assert pra.sp_divides((2, 6, 4, 8), m, "sep")
    assert not pra.sp_divides((2, 5, 4, 8), m, "sep")
    assert not pra.sp_divides((3, 6, 4, 8), m, "sep", batch_axes="dp")
    assert not pra.sp_divides((2, 6, 2, 8), m, "sep", head_axes="dp",
                              needs_head_divisible=True)
    assert pra.sp_divides((2, 6, 4, 8), m, "sep", head_axes="dp",
                          needs_head_divisible=True)
    assert not pra.sp_divides((2, 6, 4, 8), m, "mp")
    assert not pra.sp_divides((2, 6, 4, 8), None, "sep")


class _FakeMesh:
    """dp 2 x sep 2, for ``sp_divides``'s shape test alone."""
    mesh_dim_names = ("dp", "pp", "sharding", "mp", "sep", "sp", "ep")

    class mesh:
        shape = (2, 1, 1, 1, 2, 1, 1)
