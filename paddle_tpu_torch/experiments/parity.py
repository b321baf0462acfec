"""The checks that hold the port's optimizers, losses and detection
operators on a device against the CPU (``chip_smoke.py`` phases 6e(c),
6e(d) and 6f(b), and the card tests of ``tests/test_torch_cuda.py``).

- ``OPTIMIZERS`` and ``optimizer_parity``: each optimizer that steps
  parameters one by one, ``STEPS`` full-batch steps on ``UCIHousing`` from
  the same weights on a device and on the CPU, and the device's losses
  over ``FALL_STEPS`` steps.
- ``LOSS_SWEEP`` and ``loss_parity``: every loss of ``nn.functional``
  forward and backward on a device and on the CPU on the same inputs.
- ``DETECTION_WIDTHS`` and ``detection_parity``: each ``vision.ops``
  operator at the widths of PaddleDetection's public configs (Faster
  R-CNN C4 and FPN, Fast R-CNN VGG16, R-FCN, YOLOv3, SSD300, DCNv2), or
  at ``DETECTION_SMALL``, on a device and on the CPU.

All hold the device within ``TOL`` (absolute and relative) of the CPU,
from inputs and weights made under ``SEED``; kept indices and anchors
exactly.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import nn, optimizer
from ..device import set_device
from ..nn import functional as F
from ..nn.initializer import seed as seed_all
from ..text import UCIHousing
from ..text.recipes import housing_mlp
from ..vision import ops

__all__ = ["OPTIMIZERS", "optimizer_parity", "LOSS_SWEEP", "loss_parity",
           "DETECTION_WIDTHS", "DETECTION_SMALL", "detection_parity"]

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


# ---------------------------------------------------------------------------
# the detection operators (vision.ops)
# ---------------------------------------------------------------------------

# the widths of PaddleDetection's public configs
DETECTION_WIDTHS = {
    # Faster R-CNN C4 RPN at 800 x 1333: stride 16, 5 sizes x 3 ratios
    "rpn": dict(batch=2, anchors=15, fmap=(50, 84), image=(800, 1333),
                stride=16, sizes=(32, 64, 128, 256, 512),
                pre_nms_top_n=6000, post_nms_top_n=1000, nms_thresh=0.7),
    "nms": dict(boxes=6000, thresh=0.7, cat_boxes=1000, classes=80,
                cat_thresh=0.5, top_k=100),
    # FPN levels 2-5 of a ResNet at 800 x 1333, RoIAlign 7 x 7
    "fpn": dict(channels=256, fmaps=((200, 336), (100, 168), (50, 84),
                                     (25, 42)), output=7, compare_rois=32),
    # Fast R-CNN VGG16 conv5 at 600 x 1000
    "roi_pool": dict(fmap=(2, 512, 38, 63), rois=128, output=7,
                     scale=1 / 16, image=(600, 1000)),
    # R-FCN on COCO: 81 classes x 7 x 7 position-sensitive maps
    "psroi_pool": dict(fmap=(1, 81 * 49, 38, 63), rois=300, output=7,
                       scale=1 / 16, image=(600, 1000)),
    # YOLOv3 at 608 x 608, batch 8, 80 classes
    "yolo": dict(batch=8, image=608, classes=80, conf_thresh=0.005,
                 heads=(((19, 19), 32, (116, 90, 156, 198, 373, 326)),
                        ((38, 38), 16, (30, 61, 62, 45, 59, 119)),
                        ((76, 76), 8, (10, 13, 16, 30, 33, 23)))),
    "box_coder": dict(proposals=1000, classes=81),
    # SSD300's six maps
    "ssd": dict(image=300, fmaps=(38, 19, 10, 5, 3, 1),
                min_sizes=(30, 60, 111, 162, 213, 264),
                max_sizes=(60, 111, 162, 213, 264, 315),
                ratios=((2,), (2, 3), (2, 3), (2, 3), (2,), (2,)),
                steps=(8, 16, 32, 64, 100, 300)),
    # DCNv2 3 x 3 at 800 x 1333: a C5 conv and a C3 conv of ResNet-50
    "dcn": (dict(shape=(2, 512, 25, 42)), dict(shape=(2, 128, 100, 168))),
}
# the same operators at a few pixels and channels (the card tests)
DETECTION_SMALL = {
    "rpn": dict(batch=2, anchors=15, fmap=(6, 9), image=(96, 144),
                stride=16, sizes=(16, 24, 32, 48, 64), pre_nms_top_n=300,
                post_nms_top_n=60, nms_thresh=0.7),
    "nms": dict(boxes=400, thresh=0.7, cat_boxes=200, classes=8,
                cat_thresh=0.5, top_k=30),
    "fpn": dict(channels=8, fmaps=((24, 36), (12, 18), (6, 9), (3, 5)),
                output=7, compare_rois=8),
    "roi_pool": dict(fmap=(2, 16, 12, 14), rois=16, output=7, scale=1 / 16,
                     image=(192, 224)),
    "psroi_pool": dict(fmap=(1, 5 * 9, 12, 14), rois=20, output=3,
                       scale=1 / 16, image=(192, 224)),
    "yolo": dict(batch=2, image=128, classes=6, conf_thresh=0.005,
                 heads=(((4, 4), 32, (116, 90, 156, 198, 373, 326)),
                        ((8, 8), 16, (30, 61, 62, 45, 59, 119)))),
    "box_coder": dict(proposals=50, classes=7),
    "ssd": dict(image=300, fmaps=(38, 19, 10, 5, 3, 1),
                min_sizes=(30, 60, 111, 162, 213, 264),
                max_sizes=(60, 111, 162, 213, 264, 315),
                ratios=((2,), (2, 3), (2, 3), (2, 3), (2,), (2,)),
                steps=(8, 16, 32, 64, 100, 300)),
    "dcn": (dict(shape=(2, 8, 7, 9)),),
}
DETECTION_REPS = 3


def _boxes_in(rng, n, h, w, smin, smax):
    """``n`` xyxy boxes inside an ``h`` x ``w`` image, sides in [smin,
    smax]."""
    wh = smin + rng.rand(n, 2) * (smax - smin)
    x0 = rng.rand(n) * np.maximum(w - wh[:, 0], 1)
    y0 = rng.rand(n) * np.maximum(h - wh[:, 1], 1)
    return np.stack([x0, y0, x0 + wh[:, 0], y0 + wh[:, 1]], 1).astype(
        np.float32)


def _rpn_anchors(fh, fw, stride, sizes, ratios=(0.5, 1.0, 2.0)):
    """Faster R-CNN's anchors ``[fh, fw, A, 4]``: each size at each ratio
    (h / w), centred on each cell."""
    base = []
    for s in sizes:
        for r in ratios:
            w, h = s / np.sqrt(r), s * np.sqrt(r)
            base.append((-w / 2, -h / 2, w / 2, h / 2))
    base = np.asarray(base, np.float32)
    cy = (np.arange(fh, dtype=np.float32) + 0.5) * stride
    cx = (np.arange(fw, dtype=np.float32) + 0.5) * stride
    ctr = np.stack([cx[None, :].repeat(fh, 0), cy[:, None].repeat(fw, 1)],
                   -1)
    return (np.tile(ctr, 2)[:, :, None, :] + base[None, None]).astype(
        np.float32)


def _elapsed(device, fn):
    """``fn()``'s result and its ms: CUDA events around it on the card, the
    host clock elsewhere."""
    import time

    if device.type == "cuda":
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        out = fn()
        b.record()
        b.synchronize()
        return out, a.elapsed_time(b)
    t0 = time.perf_counter()
    out = fn()
    return out, 1e3 * (time.perf_counter() - t0)


def _timed(device, run, reps=DETECTION_REPS):
    """``run()`` ``reps`` times after a warm call: its last outputs and the
    least ms."""
    run()
    best, out = float("inf"), None
    for _ in range(reps):
        out, ms = _elapsed(device, run)
        best = min(best, ms)
    return out, best


def _backward_ms(device, run, leaves, ws, reps):
    """The least ms of ``reps`` backward passes of ``sum(out_k * w_k)``
    (after a warm one), the gradients left in ``leaves``."""
    best = float("inf")
    for r in range(reps + 1):
        for t in leaves:
            t.grad = None
        outs = run()
        outs = outs if isinstance(outs, (tuple, list)) else (outs,)
        loss = sum((o * w).sum() for o, w in zip(
            [o for o in outs if o.is_floating_point()], ws))
        _, ms = _elapsed(device, loss.backward)
        if r:
            best = min(best, ms)
    return best


def _case(device, make, grad=True, time_it=True):
    """``make(dev)`` -> (run, leaves): ``run()`` returns the outputs,
    ``leaves`` the tensors whose gradients are compared. On ``device``
    (timed unless ``time_it`` is false) and on the CPU: outputs, and with
    ``grad`` the gradients of ``sum(out_k * w_k)`` (w fixed, from
    ``SEED``), as numpy, with the device's forward and backward ms."""
    res = {}
    for key, dev in (("dev", device), ("cpu", torch.device("cpu"))):
        run, leaves = make(dev)
        timed = time_it and key == "dev"
        outs, ms = _timed(dev, run) if timed else (run(), None)
        outs = outs if isinstance(outs, (tuple, list)) else (outs,)
        grads, ms_b = [], None
        if grad:
            rng = np.random.RandomState(SEED)
            ws = [torch.from_numpy(_n(rng, *o.shape)).to(dev) for o in outs
                  if o.is_floating_point()]
            ms_b = _backward_ms(dev, run, leaves, ws,
                                DETECTION_REPS if timed else 0)
            ms_b = ms_b if timed else None
            grads = [t.grad.detach().cpu().numpy() for t in leaves]
        res[key] = ([o.detach().cpu().numpy() for o in outs], grads, ms,
                    ms_b)
    return res


def _compare(name, res, exact=(), units=None, grad_norm=False):
    """The device's outputs (and gradients) against the CPU's: integer
    outputs and those named by index in ``exact`` equal, the rest within
    ``TOL``, output ``i`` divided first by ``units[i]`` where given (boxes
    in pixels compared in units of the image, the units they are computed
    in before the last scaling). With ``grad_norm`` each gradient is held
    by its relative Frobenius error within ``TOL`` instead (a gradient
    that sums thousands of products: the elementwise error of two fp32
    summation orders reaches 1e-5 of the largest entry). Returns the
    largest errors, in the units compared; raises listing every output or
    gradient out of ``TOL``."""
    (do, dg, ms, ms_b), (co, cg, _, _) = res["dev"], res["cpu"]
    units = units or {}
    out = {"ms": ms, "max_abs_err": 0.0, "max_abs_ref": 0.0}
    if dg:
        out.update(ms_bwd=ms_b, grad_max_abs_err=0.0, grad_max_abs_ref=0.0)
    bad = []

    def check(what, d, c, key):
        if not c.size:
            return
        err = float(np.abs(d - c).max())
        out[f"{key}max_abs_err"] = max(out[f"{key}max_abs_err"], err)
        out[f"{key}max_abs_ref"] = max(out[f"{key}max_abs_ref"],
                                       float(np.abs(c).max()))
        if not np.allclose(d, c, rtol=TOL, atol=TOL):
            excess = np.abs(d - c) - TOL - TOL * np.abs(c)
            bad.append(f"{what}: {int((excess > 0).sum())} of {c.size} "
                       f"past rtol/atol {TOL} (largest |err| {err:.3e}, "
                       f"largest |value| {float(np.abs(c).max()):.3e})")
    for i, (d, c) in enumerate(zip(do, co)):
        if d.shape != c.shape:
            raise AssertionError(f"{name} output {i}: shape {d.shape} on "
                                 f"the device, {c.shape} on the CPU")
        if i in exact or not np.issubdtype(c.dtype, np.floating):
            if not np.array_equal(d, c):
                raise AssertionError(f"{name} output {i}: not equal to the "
                                     f"CPU's")
            continue
        if i in units:
            out[f"output_{i}_units"] = "image"
            check(f"output {i} in units of the image", d / units[i],
                  c / units[i], "")
            continue
        check(f"output {i}", d, c, "")
    for i, (d, c) in enumerate(zip(dg, cg)):
        if not grad_norm:
            check(f"gradient {i}", d, c, "grad_")
            continue
        err = float(np.abs(d - c).max())
        out["grad_max_abs_err"] = max(out["grad_max_abs_err"], err)
        out["grad_max_abs_ref"] = max(out["grad_max_abs_ref"],
                                      float(np.abs(c).max()))
        rel = float(np.linalg.norm((d - c).ravel())
                    / max(np.linalg.norm(c.ravel()), 1e-30))
        out["grad_max_rel_norm_err"] = max(
            out.get("grad_max_rel_norm_err", 0.0), rel)
        if rel > TOL:
            bad.append(f"gradient {i}: relative Frobenius error {rel:.3e}")
    if bad:
        raise AssertionError(f"{name}, device against CPU: {'; '.join(bad)}")
    return out


def _leaf(a, dev, grad=False):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev).requires_grad_(
        grad)


def _rpn_case(device, w):
    """``generate_proposals`` at the RPN width; returns the report and the
    RoIs it kept (numpy) with their per-image counts."""
    rng = np.random.RandomState(SEED)
    N, A = w["batch"], w["anchors"]
    fh, fw = w["fmap"]
    scores = _u(rng, N, A, fh, fw)
    deltas = _n(rng, N, 4 * A, fh, fw) * np.float32(0.1)
    anchors = _rpn_anchors(fh, fw, w["stride"], w["sizes"])
    var = np.ones_like(anchors)
    img = np.asarray([w["image"]] * N, np.float32)
    kw = dict(pre_nms_top_n=w["pre_nms_top_n"],
              post_nms_top_n=w["post_nms_top_n"],
              nms_thresh=w["nms_thresh"], min_size=0.0,
              return_rois_num=True)

    def make(dev):
        args = [_leaf(a, dev) for a in (scores, deltas, img, anchors, var)]
        return (lambda: ops.generate_proposals(*args, **kw)), []
    res = _case(device, make, grad=False)
    rep = _compare("generate_proposals", res, exact=(0, 1, 2))
    rois, _, nums = res["cpu"][0]
    rep.update(rois=int(len(rois)), per_image=[int(n) for n in nums])
    return rep, rois, nums


def _nms_cases(device, w):
    rng = np.random.RandomState(SEED + 1)
    h, wi = DETECTION_WIDTHS["rpn"]["image"]
    boxes = _boxes_in(rng, w["boxes"], h, wi, 16, 400)
    scores = _u(rng, w["boxes"])
    cboxes = _boxes_in(rng, w["cat_boxes"], h, wi, 16, 300)
    cscores = _u(rng, w["cat_boxes"])
    cats = rng.randint(0, w["classes"], w["cat_boxes"]).astype(np.int64)

    def make(dev):
        b, s = _leaf(boxes, dev), _leaf(scores, dev)
        return (lambda: ops.nms(b, w["thresh"], scores=s)), []

    def make_cat(dev):
        b, s, c = (_leaf(a, dev) for a in (cboxes, cscores, cats))
        return (lambda: ops.nms(b, w["cat_thresh"], scores=s,
                                category_idxs=c,
                                categories=list(range(w["classes"])),
                                top_k=w["top_k"])), []
    out = {}
    for key, mk in (("nms", make), ("nms_categories", make_cat)):
        res = _case(device, mk, grad=False)
        out[key] = _compare(key, res)
        out[key]["kept"] = int(len(res["cpu"][0][0]))
    return out


def _fpn_case(device, w, rois, nums):
    """``distribute_fpn_proposals`` over the RPN's RoIs, then ``roi_align``
    at each level (adaptive sampling, aligned) with its gradient: the
    device's ms over every RoI, and the device against the CPU over the
    first ``compare_rois`` RoIs of each image at each level and the
    level's tallest and widest RoI, which set the sampling ratio of the
    timed call (raises if the compared call's ratio differs from it)."""
    rng = np.random.RandomState(SEED + 2)
    feats = [_n(rng, len(nums), w["channels"], fh, fw)
             for fh, fw in w["fmaps"]]

    def make_dist(dev):
        r = _leaf(rois, dev)
        return (lambda: _flatten_dist(ops.distribute_fpn_proposals(
            r, 2, 5, 4, 224))), []
    out = {"distribute_fpn_proposals": _compare(
        "distribute_fpn_proposals", _case(device, make_dist, grad=False))}
    out["levels"] = []
    for L, (feat, (lrois, lnums)) in enumerate(zip(feats, _split_levels(
            rois, nums))):
        entry = {"level": L + 2, "rois": int(len(lrois)),
                 "fmap": list(feat.shape)}
        out["levels"].append(entry)
        if not len(lrois):
            continue

        def make_for(rb, rn, feat=feat, scale=1.0 / 2 ** (L + 2)):
            def make(dev):
                x, b = _leaf(feat, dev, grad=True), _leaf(rb, dev)
                return (lambda: ops.roi_align(
                    x, b, rn, w["output"], spatial_scale=scale,
                    sampling_ratio=0, aligned=True)), [x]
            return make
        ms, ms_bwd = _device_only(device, make_for(lrois, lnums))
        crois, cnums = _compared(lrois, lnums, w["compare_rois"])
        scale = 1.0 / 2 ** (L + 2)
        sr = ops._adaptive_sampling_ratio(lrois, w["output"], scale)
        if ops._adaptive_sampling_ratio(crois, w["output"], scale) != sr:
            raise AssertionError(f"roi_align level {L + 2}: the compared "
                                 f"RoIs sample at another ratio than the "
                                 f"timed call's {sr}")
        rep = _compare(f"roi_align level {L + 2}", _case(
            device, make_for(crois, cnums), time_it=False))
        entry.update({k: v for k, v in rep.items()
                      if k not in ("ms", "ms_bwd")}, ms=ms, ms_bwd=ms_bwd,
                     compared_rois=int(len(crois)), sampling_ratio=sr)
    return out


def _flatten_dist(res):
    outs, restore, nums = res
    return (*outs, restore, *nums)


def _split_levels(rois, nums):
    """The RoIs of each FPN level (as ``distribute_fpn_proposals`` assigns
    them, in their order) with each image's count at that level."""
    outs, restore, _ = ops.distribute_fpn_proposals(
        torch.from_numpy(rois), 2, 5, 4, 224)
    image = np.repeat(np.arange(len(nums)), nums)
    order = np.argsort(restore.numpy())  # concatenated position -> roi
    levels, pos = [], 0
    for o in outs:
        idx = order[pos:pos + len(o)]
        pos += len(o)
        levels.append((o.numpy(), np.bincount(image[idx],
                                              minlength=len(nums))))
    return levels


def _compared(rois, nums, k):
    """The first ``k`` RoIs of each image and the tallest and the widest
    RoI of all, in their order, with each image's count."""
    starts = np.concatenate([[0], np.cumsum(nums)[:-1]])
    sizes = rois[:, 2:] - rois[:, :2]
    largest = np.argmax(sizes, axis=0)
    keep = [np.union1d(np.arange(s, s + min(n, k)),
                       largest[(largest >= s) & (largest < s + n)])
            for s, n in zip(starts, nums)]
    idx = np.concatenate(keep).astype(np.int64)
    return rois[idx], np.asarray([len(i) for i in keep])


def _device_only(device, make):
    """Forward and backward ms of ``make(device)``'s run on the device."""
    run, leaves = make(device)
    out, ms = _timed(device, run)
    w = torch.from_numpy(_n(np.random.RandomState(SEED), *out.shape)).to(
        device)
    return ms, _backward_ms(device, run, leaves, [w], DETECTION_REPS)


def _roi_pool_cases(device, wp, wps):
    out = {}
    for key, w, op in (("roi_pool", wp, ops.roi_pool),
                       ("psroi_pool", wps, ops.psroi_pool)):
        rng = np.random.RandomState(SEED + 3)
        N = w["fmap"][0]
        x = _n(rng, *w["fmap"])
        h, wi = w["image"]
        boxes = _boxes_in(rng, w["rois"] * N, h, wi, 8, 400)
        counts = np.full(N, w["rois"], np.int32)

        def make(dev, x=x, boxes=boxes, counts=counts, w=w, op=op):
            xt, b = _leaf(x, dev, grad=True), _leaf(boxes, dev)
            return (lambda: op(xt, b, counts, w["output"],
                               spatial_scale=w["scale"])), [xt]
        out[key] = _compare(key, _case(device, make))
        out[key]["fmap"] = list(w["fmap"])
    return out


def _yolo_cases(device, w):
    rng = np.random.RandomState(SEED + 4)
    B, C = w["batch"], w["classes"]
    img = np.full((B, 2), w["image"], np.int32)
    out = {}
    heads = list(w["heads"]) + [w["heads"][0] + ("iou_aware",)]
    for i, head in enumerate(heads):
        (fh, fw), ds, anchors = head[:3]
        aware = len(head) > 3
        A = len(anchors) // 2
        x = _n(rng, B, A * (5 + C) + (A if aware else 0), fh, fw) \
            * np.float32(2.0)
        kw = dict(downsample_ratio=ds, iou_aware=aware,
                  iou_aware_factor=0.5)

        def make(dev, x=x, anchors=anchors, kw=kw):
            xt, im = _leaf(x, dev), _leaf(img, dev)
            return (lambda: ops.yolo_box(xt, im, list(anchors), C,
                                         w["conf_thresh"], **kw)), []
        key = f"yolo_box_{fh}x{fw}" + ("_iou_aware" if aware else "")
        out[key] = _compare(key, _case(device, make, grad=False),
                            units={0: np.float32(w["image"])})
    return out


def _ssd_priors(device, w):
    """``prior_box`` over SSD300's six maps: the device's boxes and
    variances equal the CPU's; returns the report and the 8732 priors."""
    def make(dev):
        img = torch.zeros(1, 3, w["image"], w["image"], device=dev)
        feats = [torch.zeros(1, 1, f, f, device=dev) for f in w["fmaps"]]

        def run():
            outs = []
            for f, mn, mx, r, st in zip(feats, w["min_sizes"],
                                        w["max_sizes"], w["ratios"],
                                        w["steps"]):
                b, v = ops.prior_box(f, img, [mn], [mx], list(r),
                                     flip=True, clip=True,
                                     steps=(st, st))
                outs += [b.reshape(-1, 4), v.reshape(-1, 4)]
            return torch.cat(outs[0::2]), torch.cat(outs[1::2])
        return run, []
    res = _case(device, make, grad=False)
    rep = _compare("prior_box", res, exact=(0, 1))
    rep["priors"] = int(len(res["cpu"][0][0]))
    return rep, res["cpu"][0]


def _box_coder_cases(device, w, priors):
    rng = np.random.RandomState(SEED + 5)
    P, C = w["proposals"], w["classes"]
    h, wi = DETECTION_WIDTHS["rpn"]["image"]
    props = _boxes_in(rng, P, h, wi, 16, 400)
    var = np.tile(np.asarray([0.1, 0.1, 0.2, 0.2], np.float32), (P, 1))
    deltas = _n(rng, P, C, 4)
    boxes, pvar = priors
    gt = np.clip(boxes + _n(rng, *boxes.shape) * np.float32(0.02), 0, 1)
    gt = np.concatenate([np.minimum(gt[:, :2], gt[:, 2:] - 1e-3),
                         gt[:, 2:]], 1).astype(np.float32)

    def make_dec(dev):
        p, v, d = (_leaf(a, dev) for a in (props, var, deltas))
        return (lambda: ops.box_coder(p, v, d, "decode_center_size",
                                      box_normalized=False, axis=0)), []

    def make_enc(dev):
        p, v, t = (_leaf(a, dev) for a in (boxes, pvar, gt))
        return (lambda: ops.box_coder(p, v, t, "encode_center_size")), []
    return {"box_coder_decode": _compare(
        "box_coder decode", _case(device, make_dec, False),
        units={0: np.asarray([wi, h, wi, h], np.float32)}),
            "box_coder_encode": _compare("box_coder encode",
                                         _case(device, make_enc, False))}


def _dcn_cases(device, widths):
    """``DeformConv2D`` v2: offsets and mask from a plain 3 x 3 conv of the
    input (the mask through a sigmoid), the gradients of the input, the
    layer's weight and bias and the offset conv's weight."""
    out = {}
    for w in widths:
        N, C, H, W = w["shape"]
        rng = np.random.RandomState(SEED + 6)
        x = _n(rng, N, C, H, W)
        seed_all(SEED)
        prev = set_device("cpu")
        try:
            dcn = ops.DeformConv2D(C, C, 3, padding=1)
            off = nn.Conv2D(C, 27, 3, padding=1)
        finally:
            set_device(prev)
        with torch.no_grad():
            off.weight.mul_(0.1)

        def make(dev, x=x, dcn=dcn, off=off):
            d = ops.DeformConv2D(C, C, 3, padding=1)
            o = nn.Conv2D(C, 27, 3, padding=1)
            for dst, src in ((d, dcn), (o, off)):
                dst.to(dev)
                dst.set_state_dict(src.state_dict())
            xt = _leaf(x, dev, grad=True)

            def run():
                t = o(xt)
                return d(xt, t[:, :18], mask=torch.sigmoid(t[:, 18:]))
            return run, [xt, d.weight, d.bias, o.weight]
        prev = set_device(device)
        try:
            key = f"deform_conv2d_{C}x{H}x{W}"
            out[key] = _compare(key, _case(device, make), grad_norm=True)
        finally:
            set_device(prev)
        out[key]["shape"] = list(w["shape"])
    return out


def detection_parity(device, widths=None):
    """Each ``vision.ops`` operator at ``widths`` (default
    ``DETECTION_WIDTHS``) on ``device`` and on the CPU from the same seeded
    inputs: outputs (and, for ``roi_align``, ``roi_pool``, ``psroi_pool``
    and ``DeformConv2D``, the gradients of ``sum(out * w)``) within
    ``TOL``; kept indices, proposals, level assignments and priors equal.
    Returns ``{op: {"ms", "ms_bwd", "max_abs_err", ...}}`` (ms: the least
    of ``DETECTION_REPS`` calls, CUDA events around the call, host work of
    the operators that read the device included); raises on a mismatch or
    where TF32 would change an fp32 product."""
    device = torch.device(device)
    if device.type == "cuda" and (torch.backends.cuda.matmul.allow_tf32
                                  or torch.backends.cudnn.allow_tf32):
        raise AssertionError("detection_parity holds fp32 at 1e-5: turn "
                             "TF32 off (matmul and cuDNN)")
    w = widths or DETECTION_WIDTHS
    out = {}
    out["generate_proposals"], rois, nums = _rpn_case(device, w["rpn"])
    out.update(_nms_cases(device, w["nms"]))
    out["fpn"] = _fpn_case(device, w["fpn"], rois, nums)
    out.update(_roi_pool_cases(device, w["roi_pool"], w["psroi_pool"]))
    out.update(_yolo_cases(device, w["yolo"]))
    out["prior_box"], priors = _ssd_priors(device, w["ssd"])
    out.update(_box_coder_cases(device, w["box_coder"], priors))
    out.update(_dcn_cases(device, w["dcn"]))
    return out
