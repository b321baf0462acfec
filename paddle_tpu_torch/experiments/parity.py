"""The checks that hold the port's optimizers and losses on a device
against the CPU (``chip_smoke.py`` phase 6e(c) and (d), and the card
tests of ``tests/test_torch_cuda.py``).

- ``OPTIMIZERS`` and ``optimizer_parity``: each optimizer that steps
  parameters one by one, ``STEPS`` full-batch steps on ``UCIHousing`` from
  the same weights on a device and on the CPU, and the device's losses
  over ``FALL_STEPS`` steps.
- ``LOSS_SWEEP`` and ``loss_parity``: every loss of ``nn.functional``
  forward and backward on a device and on the CPU on the same inputs.

Both hold the device within ``TOL`` (absolute and relative) of the CPU,
from inputs and weights made under ``SEED``.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import optimizer
from ..device import set_device
from ..nn import functional as F
from ..nn.initializer import seed as seed_all
from ..text import UCIHousing
from ..text.recipes import housing_mlp

__all__ = ["OPTIMIZERS", "optimizer_parity", "LOSS_SWEEP", "loss_parity"]

STEPS, FALL_STEPS, TOL, SEED = 3, 50, 1e-5, 0

# name -> (class, keyword arguments)
OPTIMIZERS = {
    "Adagrad": (optimizer.Adagrad, dict(learning_rate=0.01,
                                        initial_accumulator_value=0.1)),
    "Adadelta": (optimizer.Adadelta, dict(learning_rate=1.0)),
    "RMSProp": (optimizer.RMSProp, dict(learning_rate=0.001, centered=True,
                                        momentum=0.9)),
    "ASGD": (optimizer.ASGD, dict(learning_rate=0.01, batch_num=4)),
    "Rprop": (optimizer.Rprop, dict(learning_rate=0.001)),
    "Lion": (optimizer.Lion, dict(learning_rate=3e-4, weight_decay=0.01)),
    "Adamax": (optimizer.Adamax, dict(learning_rate=0.002)),
    "NAdam": (optimizer.NAdam, dict(learning_rate=0.002)),
    "RAdam": (optimizer.RAdam, dict(learning_rate=0.001)),
    "LBFGS": (optimizer.LBFGS, dict(learning_rate=1.0, max_iter=4,
                                    line_search_fn="strong_wolfe")),
}


def _housing_run(name, state, data, device, steps):
    """``steps`` full-batch steps of optimizer ``name`` from the MLP
    weights ``state`` on ``device``: the final parameters (numpy, by key)
    and the loss before each step."""
    prev = set_device(device)
    try:
        model = housing_mlp()
    finally:
        set_device(prev)
    model.set_state_dict(state)
    cls, kw = OPTIMIZERS[name]
    opt = cls(parameters=model.parameters(), **kw)
    x, y = (torch.from_numpy(a).to(device) for a in data)
    losses = []

    def closure():
        loss = F.mse_loss(model(x), y)
        loss.backward()
        return loss
    for _ in range(steps):
        losses.append(closure().item())
        if name == "LBFGS":
            opt.clear_grad()
            opt.step(closure)
        else:
            opt.step()
        opt.clear_grad()
    return ({k: v.detach().cpu().numpy() for k, v in
             model.state_dict().items()}, losses)


def optimizer_parity(device):
    """For each of ``OPTIMIZERS``: ``STEPS`` full-batch steps on
    ``UCIHousing`` on ``device`` and on the CPU from the same seeded
    weights, every parameter within ``TOL``; then ``FALL_STEPS`` on
    ``device``, whose last loss must be below its first. Returns ``{name: {"max_abs_err", "losses": [first, last]}}``;
    raises on a mismatch or a loss that does not fall."""
    housing = UCIHousing()
    data = (housing.x, housing.y)
    seed_all(SEED)
    prev = set_device("cpu")
    try:
        state = {k: v.detach().clone() for k, v in
                 housing_mlp().state_dict().items()}
    finally:
        set_device(prev)
    out = {}
    for name in OPTIMIZERS:
        got, _ = _housing_run(name, state, data, device, STEPS)
        want, _ = _housing_run(name, state, data, "cpu", STEPS)
        err = 0.0
        for k, w in want.items():
            np.testing.assert_allclose(got[k], w, rtol=TOL, atol=TOL,
                                       err_msg=f"{name} {k}")
            err = max(err, float(np.abs(got[k] - w).max()))
        _, losses = _housing_run(name, state, data, device, FALL_STEPS)
        if not losses[-1] < losses[0]:
            raise AssertionError(f"{name}: the loss did not fall over "
                                 f"{FALL_STEPS} steps: {losses}")
        out[name] = {"max_abs_err": err, "losses": [losses[0], losses[-1]]}
    return out


def _u(rng, *shape):
    return rng.rand(*shape).astype(np.float32)


def _n(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def _pm(rng, *shape):
    return np.where(rng.rand(*shape) < 0.5, -1.0, 1.0).astype(np.float32)


def _ctc_inputs(rng, T=200, B=32, C=30, L=40):
    z = rng.randn(T, B, C).astype(np.float32)
    lp = z - np.log(np.exp(z).sum(-1, keepdims=True))
    labels = rng.randint(1, C, (B, L)).astype(np.int64)
    ilen = rng.randint(T // 2, T + 1, B).astype(np.int64)
    llen = rng.randint(L // 2, L + 1, B).astype(np.int64)
    return [lp.astype(np.float32), labels, ilen, llen]


# name -> (function of (F, *inputs), function of a RandomState -> inputs);
# the batch is 64 and the class axis 10, ctc_loss at T 200, B 32, C 30,
# label length 40
B, C = 64, 10
LOSS_SWEEP = {
    "cross_entropy_weighted_smoothed": (
        lambda F, x, y, w: F.cross_entropy(x, y, weight=w, reduction="sum",
                                           label_smoothing=0.1),
        lambda r: [_n(r, B, C), r.randint(0, C, B), _u(r, C) + 0.5]),
    "cross_entropy_soft": (
        lambda F, x, y: F.cross_entropy(x, F.softmax(y), soft_label=True),
        lambda r: [_n(r, B, C), _n(r, B, C)]),
    "binary_cross_entropy": (
        lambda F, p, t: F.binary_cross_entropy(F.sigmoid(p), t),
        lambda r: [_n(r, B, C), _u(r, B, C)]),
    "binary_cross_entropy_with_logits": (
        lambda F, z, t, pw: F.binary_cross_entropy_with_logits(
            z, t, pos_weight=pw),
        lambda r: [_n(r, B, C), _u(r, B, C), _u(r, C) + 0.5]),
    "mse_loss": (lambda F, a, b: F.mse_loss(a, b),
                 lambda r: [_n(r, B, C), _n(r, B, C)]),
    "l1_loss": (lambda F, a, b: F.l1_loss(a, b),
                lambda r: [_n(r, B, C), _n(r, B, C)]),
    "square_error_cost": (lambda F, a, b: F.square_error_cost(a, b).sum(),
                          lambda r: [_n(r, B, C), _n(r, B, C)]),
    "nll_loss": (
        lambda F, x, y, w: F.nll_loss(F.log_softmax(x), y, weight=w,
                                      ignore_index=3),
        lambda r: [_n(r, B, C), r.randint(0, C, B), _u(r, C) + 0.5]),
    "smooth_l1_loss": (lambda F, a, b: F.smooth_l1_loss(a, b, delta=0.5),
                       lambda r: [_n(r, B, C), _n(r, B, C)]),
    "huber_loss": (lambda F, a, b: F.huber_loss(a, b, delta=0.7),
                   lambda r: [_n(r, B, C), _n(r, B, C)]),
    "kl_div": (
        lambda F, x, t: F.kl_div(F.log_softmax(x), F.softmax(t),
                                 reduction="batchmean"),
        lambda r: [_n(r, B, C), _n(r, B, C)]),
    "margin_ranking_loss": (
        lambda F, a, b, y: F.margin_ranking_loss(a, b, y, margin=0.2),
        lambda r: [_n(r, B), _n(r, B), _pm(r, B)]),
    "hinge_embedding_loss": (
        lambda F, a, y: F.hinge_embedding_loss(a, y),
        lambda r: [_n(r, B, C), _pm(r, B, C)]),
    "soft_margin_loss": (lambda F, a, y: F.soft_margin_loss(a, y),
                         lambda r: [_n(r, B, C), _pm(r, B, C)]),
    "multi_label_soft_margin_loss": (
        lambda F, a, y: F.multi_label_soft_margin_loss(a, y),
        lambda r: [_n(r, B, C), (_u(r, B, C) < 0.5).astype(np.float32)]),
    "poisson_nll_loss": (
        lambda F, a, t: F.poisson_nll_loss(a, t, full=True),
        lambda r: [_n(r, B, C), 3 * _u(r, B, C)]),
    "gaussian_nll_loss": (
        lambda F, a, t, v: F.gaussian_nll_loss(a, t, v, full=True),
        lambda r: [_n(r, B, C), _n(r, B, C), _u(r, B, C) + 0.1]),
    "multi_margin_loss": (
        lambda F, x, y: F.multi_margin_loss(x, y, p=2),
        lambda r: [_n(r, B, C), r.randint(0, C, B)]),
    "triplet_margin_with_distance_loss": (
        lambda F, a, p, n: F.triplet_margin_with_distance_loss(
            a, p, n, swap=True),
        lambda r: [_n(r, B, C), _n(r, B, C), _n(r, B, C)]),
    "triplet_margin_loss": (
        lambda F, a, p, n: F.triplet_margin_loss(a, p, n, p=1.0),
        lambda r: [_n(r, B, C), _n(r, B, C), _n(r, B, C)]),
    "cosine_embedding_loss": (
        lambda F, a, b, y: F.cosine_embedding_loss(a, b, y, margin=0.1),
        lambda r: [_n(r, B, C), _n(r, B, C), _pm(r, B)]),
    "pairwise_distance": (
        lambda F, a, b: F.pairwise_distance(a, b).sum(),
        lambda r: [_n(r, B, C), _n(r, B, C)]),
    "npair_loss": (
        lambda F, a, p, y: F.npair_loss(a, p, y),
        lambda r: [_n(r, B, C), _n(r, B, C), r.randint(0, 8, B)]),
    "dice_loss": (
        lambda F, x, y: F.dice_loss(F.softmax(x), y),
        lambda r: [_n(r, B, 4, C), r.randint(0, C, (B, 4, 1))]),
    "log_loss": (lambda F, p, y: F.log_loss(F.sigmoid(p), y).sum(),
                 lambda r: [_n(r, B, 1), (_u(r, B, 1) < 0.5).astype(
                     np.float32)]),
    "sigmoid_focal_loss": (
        lambda F, z, t: F.sigmoid_focal_loss(z, t),
        lambda r: [_n(r, B, C), (_u(r, B, C) < 0.3).astype(np.float32)]),
    "adaptive_log_softmax_with_loss": (
        lambda F, x, y, hw, p0, c0, p1, c1: F.adaptive_log_softmax_with_loss(
            x, y, hw, [[p0, c0], [p1, c1]], [8, 20, 40])[1],
        lambda r: [_n(r, B, 16), r.randint(0, 40, B), _n(r, 16, 10),
                   _n(r, 16, 8), _n(r, 8, 12), _n(r, 16, 4), _n(r, 4, 20)]),
    "ctc_loss": (
        lambda F, lp, lab, il, ll: F.ctc_loss(lp, lab, il, ll),
        _ctc_inputs),
}


def _loss_grads(fn, arrays, device):
    xs = [torch.from_numpy(a).to(device) for a in arrays]
    leaves = [x.requires_grad_() for x in xs if x.is_floating_point()]
    loss = fn(F, *xs)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return [loss.detach().cpu().numpy()] + [
        (torch.zeros_like(x) if g is None else g).cpu().numpy()
        for x, g in zip(leaves, grads)]


def loss_parity(device, names=None):
    """Each of ``LOSS_SWEEP`` (or ``names``) forward and backward on
    ``device`` and on the CPU on the same seeded inputs: the loss and every
    float input's gradient within ``TOL``. Returns ``{name:
    largest |error|}``; raises on a mismatch."""
    out = {}
    for i, name in enumerate(names or LOSS_SWEEP):
        fn, make = LOSS_SWEEP[name]
        arrays = [np.asarray(a) for a in make(np.random.RandomState(SEED + i))]
        got = _loss_grads(fn, arrays, device)
        want = _loss_grads(fn, arrays, "cpu")
        err = 0.0
        for j, (g, w) in enumerate(zip(got, want)):
            np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL,
                                       err_msg=f"{name} output {j}")
            err = max(err, float(np.abs(g - w).max()))
        out[name] = err
    return out
