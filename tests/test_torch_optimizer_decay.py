"""The port's optimizers on ``weight_decay`` against the JAX package's.

The reference's ``Optimizer`` takes its L2 coefficient from a ``float``
or an ``L2Decay`` and leaves it at 0.0 for anything else, an ``int``
included (``paddle_tpu/optimizer/optimizer.py``). The port refuses a
nonzero ``int`` with a ``TypeError`` rather than decaying where the
reference silently does not; 0 stays 0.0 and floats decay as L2 folded
into the gradient. SGD, Momentum and Adam pass ``weight_decay`` to the
base class: each steps the same numpy parameters and gradients on both
packages, three times, for ``weight_decay`` 0, 0.0 and 0.01, and the
results agree to fp32 rounding (rtol 1e-5, atol 1e-7, as in
``test_torch_multi_tensor.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.ops.pallas import multi_tensor_update as jmtu
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt

SHAPES = [(4, 8), (8,), (3, 3, 2, 4)]
OPTS = {
    "sgd": (paddle.optimizer.SGD, topt.SGD, dict(learning_rate=0.1)),
    "momentum": (paddle.optimizer.Momentum, topt.Momentum,
                 dict(learning_rate=0.1, momentum=0.9)),
    "adam": (paddle.optimizer.Adam, topt.Adam, dict(learning_rate=0.01)),
}
DECAYS = [0, 0.0, 0.01]


def _rand(seed, scale):
    rng = np.random.RandomState(seed)
    return [(rng.randn(*s) * scale).astype(np.float32) for s in SHAPES]


def _jax_run(cls, kw, wd, steps=3):
    params = [jnn.Parameter(jnp.asarray(a)) for a in _rand(0, 0.1)]
    opt = cls(parameters=params, weight_decay=wd, **kw)
    prev = jmtu.FORCE_INTERPRET
    jmtu.FORCE_INTERPRET = True
    try:
        for s in range(steps):
            for p, g in zip(params, _rand(s + 1, 0.01)):
                p.grad = paddle.to_tensor(jnp.asarray(g))
            opt.step()
            opt.clear_grad()
    finally:
        jmtu.FORCE_INTERPRET = prev
    return [np.asarray(p._value, np.float32) for p in params], opt


def _port_run(cls, kw, wd, steps=3):
    params = [tnn.Parameter(torch.from_numpy(a)) for a in _rand(0, 0.1)]
    opt = cls(parameters=params, weight_decay=wd, **kw)
    for s in range(steps):
        for p, g in zip(params, _rand(s + 1, 0.01)):
            p.grad = torch.from_numpy(g)
        opt.step()
        opt.clear_grad()
    return [p.detach().numpy() for p in params], opt


@pytest.mark.parametrize("wd", DECAYS, ids=["int0", "float0", "float001"])
@pytest.mark.parametrize("name", sorted(OPTS))
def test_steps_match_reference(name, wd):
    jcls, tcls, kw = OPTS[name]
    jp, jopt = _jax_run(jcls, kw, wd)
    tp, topt_ = _port_run(tcls, kw, wd)
    assert topt_._l2_coeff == jopt._l2_coeff == (0.01 if wd == 0.01
                                                 else 0.0)
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("name", sorted(OPTS))
def test_nonzero_int_refused_where_reference_ignores_it(name):
    jcls, tcls, kw = OPTS[name]
    jparams = [jnn.Parameter(jnp.asarray(a)) for a in _rand(0, 0.1)]
    assert jcls(parameters=jparams, weight_decay=1, **kw)._l2_coeff == 0.0
    tparams = [tnn.Parameter(torch.from_numpy(a)) for a in _rand(0, 0.1)]
    with pytest.raises(TypeError, match="ignores an integer weight_decay"):
        tcls(parameters=tparams, weight_decay=1, **kw)
