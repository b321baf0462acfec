"""The port's losses (``nn.functional``'s and the loss layers) against the
JAX package's, on the CPU.

Every loss runs on both packages on the same seeded numpy inputs in fp32,
in every ``reduction`` it takes; the output and the gradient of
``sum(out * w)`` (w fixed, random) with respect to each float input agree
within 1e-5 (atol and rtol: the packages sum in other orders). The JAX
side runs as one ``jit.to_static`` program a case. ``cross_entropy`` is
held in the four modes the port used to refuse (``weight``,
``soft_label``, ``use_softmax=False``, ``label_smoothing``), with hard
labels and ``"mean"`` ignoring ``weight`` as the reference does, on a
class axis that is not the last, and with ``ignore_index``; ``nll_loss``
with an ``ignore_index`` >= 0 (masked, the weighted mean divided by the
count) and the default -100 (not masked). Each loss layer runs once, and
``AdaptiveLogSoftmaxWithLoss`` carries its parameters across by key.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
import paddle_tpu_torch as port
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch.device import set_device
from paddle_tpu_torch.models.convert import layer_state_from_numpy
from paddle_tpu_torch.nn import functional as TF

TOL = dict(rtol=1e-5, atol=1e-5)
B, C = 6, 5
REDUCTIONS = ["mean", "sum", "none"]


@pytest.fixture(autouse=True)
def cpu():
    prev = set_device("cpu")
    yield
    set_device(prev)


def _np(seed, *shape, scale=1.0):
    return np.asarray(np.random.RandomState(seed).randn(*shape) * scale,
                      np.float32)


def _labels(seed, *shape, high=C):
    return np.random.RandomState(seed).randint(0, high, shape).astype(
        np.int64)


def _sign(seed, *shape):
    return np.where(np.random.RandomState(seed).rand(*shape) < 0.5, -1.0,
                    1.0).astype(np.float32)


def _prob(seed, *shape):
    z = np.exp(_np(seed, *shape))
    return (z / z.sum(-1, keepdims=True)).astype(np.float32)


def _sigmoid(seed, *shape):
    return (1 / (1 + np.exp(-_np(seed, *shape)))).astype(np.float32)


def _outs(out):
    return list(out) if isinstance(out, (tuple, list)) else [out]


def _float(a):
    return np.issubdtype(a.dtype, np.floating)


def _grad(x, a):
    """An input's gradient; zeros for one the loss does not use (a weight
    that ``"mean"`` ignores, labels read by comparison)."""
    return np.zeros_like(a) if x.grad is None else x.grad.numpy()


def _jax(fn, arrays):
    xs = [paddle.to_tensor(a, stop_gradient=not _float(a)) for a in arrays]

    def program(*ts):
        return fn(*ts)  # a layer's parameters ride as the program's inputs
    outs = _outs(paddle.jit.to_static(program)(*xs))
    w = paddle.to_tensor(_np(99, *outs[0].shape))
    (outs[0] * w).sum().backward()
    return ([np.asarray(o.numpy()) for o in outs],
            [_grad(x, a) for x, a in zip(xs, arrays) if _float(a)])


def _port(fn, arrays):
    xs = [torch.from_numpy(a.copy()).requires_grad_(_float(a))
          for a in arrays]
    outs = _outs(fn(*xs))
    w = torch.from_numpy(_np(99, *outs[0].shape))
    (outs[0] * w).sum().backward()
    return ([o.detach().numpy() for o in outs],
            [_grad(x, a) for x, a in zip(xs, arrays) if _float(a)])


def _same(jfn, tfn, arrays, tol=TOL):
    (jo, jg), (to, tg) = _jax(jfn, arrays), _port(tfn, arrays)
    assert len(jo) == len(to)
    for a, b in zip(to + tg, jo + jg):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, **tol)
    return to


def _fn_case(name, arrays, **kw):
    return _same(lambda *xs: getattr(JF, name)(*xs, **kw),
                 lambda *xs: getattr(TF, name)(*xs, **kw), arrays)


# ---------------------------------------------------------------------------
# cross_entropy
# ---------------------------------------------------------------------------

W_C = np.abs(_np(7, C)) + 0.5
CE_CASES = {
    "hard": ([_np(1, B, C), _labels(2, B)], {}),
    "hard_trailing_axis": ([_np(1, B, C), _labels(2, B, 1)], {}),
    "weight": ([_np(1, B, C), _labels(2, B)], dict(weight=W_C)),
    "ignore_index": ([_np(1, B, C), _labels(2, B)], dict(ignore_index=1)),
    "weight_ignore_index": ([_np(1, B, C), _labels(2, B)],
                            dict(weight=W_C, ignore_index=3)),
    "soft_label": ([_np(1, B, C), _prob(3, B, C)], dict(soft_label=True)),
    "soft_label_smoothing": ([_np(1, B, C), _prob(3, B, C)],
                             dict(soft_label=True, label_smoothing=0.1)),
    "use_softmax_false": ([_prob(4, B, C), _labels(2, B)],
                          dict(use_softmax=False)),
    "label_smoothing": ([_np(1, B, C), _labels(2, B)],
                        dict(label_smoothing=0.2)),
    "axis1": ([_np(1, B, C, 3), _labels(2, B, 3)], dict(axis=1)),
}


@pytest.mark.parametrize("reduction", REDUCTIONS)
@pytest.mark.parametrize("case", sorted(CE_CASES))
def test_cross_entropy(case, reduction):
    arrays, kw = CE_CASES[case]
    kw = dict(kw, reduction=reduction)
    if "weight" in kw:
        arrays = arrays + [kw.pop("weight")]
        _same(lambda x, y, w: JF.cross_entropy(x, y, weight=w, **kw),
              lambda x, y, w: TF.cross_entropy(x, y, weight=w, **kw), arrays)
    else:
        _fn_case("cross_entropy", arrays, **kw)


def test_cross_entropy_mean_ignores_weight():
    """Hard labels and ``"mean"``: the weighted loss equals the
    unweighted one on both packages (the reference returns first)."""
    x, y = torch.from_numpy(_np(1, B, C)), torch.from_numpy(_labels(2, B))
    got = TF.cross_entropy(x, y, weight=torch.from_numpy(W_C))
    np.testing.assert_allclose(got.item(), TF.cross_entropy(x, y).item(),
                               rtol=0, atol=0)
    jgot = JF.cross_entropy(paddle.to_tensor(x.numpy()),
                            paddle.to_tensor(y.numpy()),
                            weight=paddle.to_tensor(W_C))
    np.testing.assert_allclose(got.item(), float(jgot.numpy()), **TOL)


@pytest.mark.parametrize("return_softmax", [False, True])
def test_softmax_with_cross_entropy(return_softmax):
    _fn_case("softmax_with_cross_entropy", [_np(1, B, C), _labels(2, B, 1)],
             return_softmax=return_softmax)


def test_amp_lists_key_on_the_reference_names():
    """Under O2 a black-listed loss (``cross_entropy``, ``nll_loss``,
    ``bce_logits``) takes bf16 inputs up to fp32; ``mse_loss`` is on no
    list, so its fp32 inputs go down to bf16."""
    x = torch.from_numpy(_np(1, B, C)).bfloat16()
    y = torch.from_numpy(_labels(2, B))
    with tamp.auto_cast(level="O2"):
        assert TF.cross_entropy(x, y).dtype == torch.float32
        assert TF.nll_loss(x, y).dtype == torch.float32
        assert TF.binary_cross_entropy_with_logits(
            x, x.sigmoid()).dtype == torch.float32
        assert TF.mse_loss(x.float(), x.float()).dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# every other functional loss, in every reduction it takes
# ---------------------------------------------------------------------------

V = _np(11, B, C)
LOSSES = {
    "binary_cross_entropy": ([_sigmoid(1, B, C), _sigmoid(2, B, C)], {}),
    "binary_cross_entropy_weight": (
        [_sigmoid(1, B, C), _sigmoid(2, B, C), np.abs(_np(3, C))], {}),
    "binary_cross_entropy_with_logits": ([V, _sigmoid(2, B, C)], {}),
    "binary_cross_entropy_with_logits_weights": (
        [V, _sigmoid(2, B, C), np.abs(_np(3, C)), np.abs(_np(4, C)) + 0.5],
        {}),
    "mse_loss": ([V, _np(2, B, C)], {}),
    "l1_loss": ([V, _np(2, B, C)], {}),
    "smooth_l1_loss": ([V, _np(2, B, C)], dict(delta=0.5)),
    "huber_loss": ([V, _np(2, B, C)], dict(delta=0.7)),
    "nll_loss": ([np.log(_prob(1, B, C)), _labels(2, B)], {}),
    "nll_loss_weight": ([np.log(_prob(1, B, C)), _labels(2, B), W_C], {}),
    "nll_loss_ignore_index": ([np.log(_prob(1, B, C)), _labels(2, B)],
                              dict(ignore_index=1)),
    "nll_loss_weight_ignore_index": (
        [np.log(_prob(1, B, C)), _labels(2, B), W_C], dict(ignore_index=3)),
    "kl_div": ([np.log(_prob(1, B, C)), _prob(2, B, C)], {}),
    "margin_ranking_loss": ([_np(1, B), _np(2, B), _sign(3, B)],
                            dict(margin=0.3)),
    "hinge_embedding_loss": ([V, _sign(3, B, C)], dict(margin=0.5)),
    "soft_margin_loss": ([V, _sign(3, B, C)], {}),
    "multi_label_soft_margin_loss": (
        [V, (np.random.RandomState(3).rand(B, C) < 0.5).astype(np.float32)],
        {}),
    "multi_label_soft_margin_loss_weight": (
        [V, (np.random.RandomState(3).rand(B, C) < 0.5).astype(np.float32),
         np.abs(_np(4, C))], {}),
    "poisson_nll_loss": ([V, np.abs(_np(2, B, C)) * 3], {}),
    "poisson_nll_loss_full": ([np.abs(V) + 0.1, np.abs(_np(2, B, C)) * 3],
                              dict(log_input=False, full=True)),
    "gaussian_nll_loss": ([V, _np(2, B, C), np.abs(_np(3, B, C))], {}),
    "gaussian_nll_loss_full": ([V, _np(2, B, C), np.abs(_np(3, B, C))],
                               dict(full=True)),
    "multi_margin_loss": ([V, _labels(2, B)], {}),
    "multi_margin_loss_p2_weight": ([V, _labels(2, B), W_C],
                                    dict(p=2, margin=0.7)),
    "triplet_margin_with_distance_loss": (
        [V, _np(2, B, C), _np(3, B, C)], {}),
    "triplet_margin_with_distance_loss_swap": (
        [V, _np(2, B, C), _np(3, B, C)], dict(swap=True, margin=0.5)),
    "triplet_margin_loss": ([V, _np(2, B, C), _np(3, B, C)], {}),
    "triplet_margin_loss_p1_swap": ([V, _np(2, B, C), _np(3, B, C)],
                                    dict(p=1.0, swap=True)),
    "cosine_embedding_loss": ([V, _np(2, B, C), _sign(3, B)],
                              dict(margin=0.2)),
    "sigmoid_focal_loss": ([V, (np.random.RandomState(3).rand(B, C) < 0.3
                                ).astype(np.float32)], {}),
}
_WEIGHT_LAST = {"binary_cross_entropy_weight", "nll_loss_weight",
                "nll_loss_weight_ignore_index",
                "multi_label_soft_margin_loss_weight",
                "multi_margin_loss_p2_weight"}


def _base(case):
    for name in ("binary_cross_entropy_with_logits", "binary_cross_entropy",
                 "multi_label_soft_margin_loss", "nll_loss",
                 "poisson_nll_loss", "gaussian_nll_loss", "multi_margin_loss",
                 "triplet_margin_with_distance_loss", "triplet_margin_loss"):
        if case.startswith(name):
            return name
    return case


@pytest.mark.parametrize("reduction", REDUCTIONS)
@pytest.mark.parametrize("case", sorted(LOSSES))
def test_loss(case, reduction):
    arrays, kw = LOSSES[case]
    kw = dict(kw, reduction=reduction)
    name = _base(case)
    if case in _WEIGHT_LAST:
        def call(F):
            return lambda *xs: getattr(F, name)(*xs[:-1], weight=xs[-1], **kw)
        _same(call(JF), call(TF), arrays)
    elif case == "binary_cross_entropy_with_logits_weights":
        def call(F):
            return lambda z, t, w, pw: F.binary_cross_entropy_with_logits(
                z, t, weight=w, pos_weight=pw, **kw)
        _same(call(JF), call(TF), arrays)
    elif case == "sigmoid_focal_loss":
        def call(F, pkg):
            return lambda z, t: F.sigmoid_focal_loss(
                z, t, normalizer=pkg(np.float32(3.0)), **kw)
        _same(call(JF, paddle.to_tensor), call(TF, torch.tensor), arrays)
    else:
        _fn_case(name, arrays, **kw)


def test_kl_div_batchmean():
    _fn_case("kl_div", [np.log(_prob(1, B, C)), _prob(2, B, C)],
             reduction="batchmean")


def test_triplet_with_custom_distance():
    def call(F):
        return lambda a, p, n: F.triplet_margin_with_distance_loss(
            a, p, n, distance_function=lambda u, v: F.pairwise_distance(
                u, v, p=1.0))
    _same(call(JF), call(TF), [V, _np(2, B, C), _np(3, B, C)])


@pytest.mark.parametrize("name,arrays,kw", [
    ("square_error_cost", [V, _np(2, B, C)], {}),
    ("npair_loss", [_np(1, B, C), _np(2, B, C), _labels(3, B, high=3)],
     dict(l2_reg=0.01)),
    ("dice_loss", [_prob(1, B, 4, C), _labels(2, B, 4, 1)], {}),
    ("log_loss", [_sigmoid(1, B, 1), (np.random.RandomState(2).rand(B, 1)
                                      < 0.5).astype(np.float32)], {}),
    ("pairwise_distance", [V, _np(2, B, C)], {}),
    ("pairwise_distance", [V, _np(2, B, C)], dict(p=float("inf"),
                                                  keepdim=True)),
    ("pairwise_distance", [V, _np(2, B, C)], dict(p=3.0, epsilon=1e-3)),
    ("label_smooth", [_prob(1, B, C)], dict(epsilon=0.2)),
], ids=["square_error_cost", "npair", "dice", "log_loss", "pairwise_p2",
        "pairwise_inf", "pairwise_p3", "label_smooth"])
def test_unreduced_ops(name, arrays, kw):
    _fn_case(name, arrays, **kw)


def test_label_smooth_prior_and_one_hot():
    prior = _prob(5, 1, C)
    _same(lambda y, p: JF.label_smooth(y, prior_dist=p, epsilon=0.3),
          lambda y, p: TF.label_smooth(y, prior_dist=p, epsilon=0.3),
          [_prob(1, B, C), prior])
    y = np.array([0, 4, -100, 7, 2])
    got = TF.one_hot(torch.from_numpy(y), C)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(JF.one_hot(paddle.to_tensor(y), C).numpy()))


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
@pytest.mark.parametrize("norm_by_times", [False, True])
def test_ctc_loss(reduction, norm_by_times):
    T, N, K, L = 12, 4, 6, 4
    lp = np.log(_prob(1, T, N, K))
    labels = np.random.RandomState(2).randint(1, K, (N, L)).astype(np.int64)
    labels[1, 1] = labels[1, 0]          # a repeat: no skip over it
    ilen = np.array([12, 9, 12, 7], np.int64)
    llen = np.array([4, 3, 1, 2], np.int64)
    kw = dict(reduction=reduction, norm_by_times=norm_by_times, blank=0)
    _same(lambda a, b, c, d: JF.ctc_loss(a, b, c, d, **kw),
          lambda a, b, c, d: TF.ctc_loss(a, b, c, d, **kw),
          [lp, labels, ilen, llen])


@pytest.mark.parametrize("head_bias", [False, True])
def test_adaptive_log_softmax(head_bias):
    """The layer's parameters carried across by key (order and names the
    reference's), then ``forward`` (per-sample log-prob and loss), the
    gradients of every parameter, ``log_prob`` and ``predict``."""
    paddle.seed(3)
    kw = dict(in_features=8, n_classes=20, cutoffs=[5, 12], div_value=2.0,
              head_bias=head_bias)
    jl = paddle.nn.AdaptiveLogSoftmaxWithLoss(**kw)
    tl = port.nn.AdaptiveLogSoftmaxWithLoss(**kw)
    assert list(tl.state_dict()) == list(jl.state_dict())
    layer_state_from_numpy(tl, {k: np.asarray(v.numpy()) for k, v in
                                jl.state_dict().items()}, device="cpu")
    x = _np(1, 10, 8)
    y = _labels(2, 10, high=20)
    _same(jl, tl, [x, y])
    jo, jlp = jl(paddle.to_tensor(x), paddle.to_tensor(y))
    jlp.backward()
    to, tlp = tl(torch.from_numpy(x), torch.from_numpy(y))
    tlp.backward()
    for (k, jp), tp in zip(jl.state_dict().items(), tl.parameters()):
        np.testing.assert_allclose(tp.grad.numpy(), jp.grad.numpy(),
                                   err_msg=k, **TOL)
    with torch.no_grad():
        tprob = tl.log_prob(torch.from_numpy(x)).numpy()
        tpred = tl.predict(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(
        tprob, jl.log_prob(paddle.to_tensor(x)).numpy(), **TOL)
    np.testing.assert_array_equal(
        tpred, np.asarray(jl.predict(paddle.to_tensor(x)).numpy()))
    with pytest.raises(ValueError, match="label values must be in"):
        tl(torch.from_numpy(x), torch.full((10,), 20))


# ---------------------------------------------------------------------------
# the loss layers
# ---------------------------------------------------------------------------

LAYERS = [
    ("CrossEntropyLoss", dict(label_smoothing=0.1),
     [_np(1, B, C), _labels(2, B)]),
    ("MSELoss", {}, [V, _np(2, B, C)]),
    ("L1Loss", dict(reduction="sum"), [V, _np(2, B, C)]),
    ("NLLLoss", dict(ignore_index=2), [np.log(_prob(1, B, C)),
                                       _labels(2, B)]),
    ("BCELoss", {}, [_sigmoid(1, B, C), _sigmoid(2, B, C)]),
    ("BCEWithLogitsLoss", {}, [V, _sigmoid(2, B, C)]),
    ("SmoothL1Loss", dict(delta=0.4), [V, _np(2, B, C)]),
    ("KLDivLoss", dict(reduction="batchmean"),
     [np.log(_prob(1, B, C)), _prob(2, B, C)]),
    ("MarginRankingLoss", dict(margin=0.1), [_np(1, B), _np(2, B),
                                             _sign(3, B)]),
    ("HingeEmbeddingLoss", {}, [V, _sign(3, B, C)]),
    ("SoftMarginLoss", {}, [V, _sign(3, B, C)]),
    ("MultiLabelSoftMarginLoss", {},
     [V, (np.random.RandomState(3).rand(B, C) < 0.5).astype(np.float32)]),
    ("PoissonNLLLoss", dict(full=True), [V, np.abs(_np(2, B, C)) * 3]),
    ("GaussianNLLLoss", {}, [V, _np(2, B, C), np.abs(_np(3, B, C))]),
    ("MultiMarginLoss", dict(p=2), [V, _labels(2, B)]),
    ("TripletMarginWithDistanceLoss", dict(swap=True),
     [V, _np(2, B, C), _np(3, B, C)]),
    ("HuberLoss", dict(delta=0.6), [V, _np(2, B, C)]),
    ("TripletMarginLoss", dict(p=1.0), [V, _np(2, B, C), _np(3, B, C)]),
    ("PairwiseDistance", dict(keepdim=True), [V, _np(2, B, C)]),
    ("CosineEmbeddingLoss", dict(margin=0.1), [V, _np(2, B, C),
                                               _sign(3, B)]),
]


@pytest.mark.parametrize("name,kw,arrays", LAYERS,
                         ids=[c[0] for c in LAYERS])
def test_loss_layer(name, kw, arrays):
    _same(getattr(paddle.nn, name)(**kw), getattr(port.nn, name)(**kw),
          arrays)


def test_ctc_layer():
    T, N, K = 10, 3, 5
    arrays = [np.log(_prob(1, T, N, K)),
              np.random.RandomState(2).randint(1, K, (N, 3)).astype(
                  np.int64), np.array([10, 8, 6], np.int64),
              np.array([3, 2, 3], np.int64)]
    _same(paddle.nn.CTCLoss(reduction="sum"),
          port.nn.CTCLoss(reduction="sum"), arrays)
