"""The port's high-level API against the JAX package's, on the CPU:
BASELINE config 0 (``Model.fit`` of LeNet on synthetic MNIST) and what it
reaches.

The JAX LeNet is built under ``paddle.seed(0)`` and carried into the port
as numpy (``layer_state_from_numpy``); both packages then run the same
recipe as ``benchmarks/mnist_fit.py`` at a small size: ``MNIST(
synthetic_size=512)``, batch 64, 2 epochs, ``Adam(1e-3)``,
``CrossEntropyLoss``, ``Accuracy``; unshuffled, and shuffled under one
``np.random.seed`` (both samplers draw ``np.random.permutation``).
Tolerances: each batch's loss within rtol 1e-3 (measured 4e-6: the two
packages' fp32 convolution gradients sum in another order, and Adam's
sign-like early steps carry that into the weights), the ``History`` and
evaluation losses likewise, every accuracy equal; the predicted logits
within atol 1e-3 and their argmax equal.

Then ``accumulate_grad_batches=2`` (the eager path), ``num_iters`` with
``eval_data``, the callbacks' decisions (``EarlyStopping``,
``ReduceLROnPlateau``, ``LRScheduler`` by step and by epoch inside a fit,
``ModelCheckpoint``'s files), checkpoints written by either package and
read by the other (``Model.save`` / ``load``, optimizer moments and the
scheduler included: exact), ``summary`` / ``flops`` counts, the names
ROADMAP Queue A item 4.4 lists, one device read per batch and the train
step's telemetry.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu.vision.datasets import MNIST as JMNIST
from paddle_tpu.vision.models import LeNet as JLeNet
import paddle_tpu_torch as pt
from paddle_tpu_torch import amp as tamp
from paddle_tpu_torch.device import set_device
from paddle_tpu_torch.hapi import model as tmodel
from paddle_tpu_torch.models.convert import layer_state_from_numpy
from paddle_tpu_torch.observability import metrics as tobs
from paddle_tpu_torch.optimizer import lr as tlr
from paddle_tpu_torch.profiler import _hooks
from paddle_tpu_torch.vision.datasets import MNIST as TMNIST
from paddle_tpu_torch.vision.models import LeNet as TLeNet

N_TRAIN, N_TEST, BATCH, EPOCHS = 512, 200, 64, 2
LOSS_RTOL = 1e-3


@pytest.fixture(autouse=True)
def cpu():
    prev = set_device("cpu")
    yield
    set_device(prev)


@pytest.fixture(scope="module")
def state0():
    """The JAX LeNet's initial weights as numpy, by state-dict key."""
    paddle.seed(0)
    return {k: np.asarray(v._value) for k, v in JLeNet().state_dict().items()}


def _nets(state):
    jnet = JLeNet()
    for k, v in jnet.state_dict().items():
        v._inplace_set(jnp.asarray(state[k]))
    prev = set_device("cpu")
    try:
        tnet = TLeNet()
    finally:
        set_device(prev)
    layer_state_from_numpy(tnet, state, device="cpu")
    return jnet, tnet


def _models(state, lr=1e-3, **opt_kw):
    """The recipe's two models, prepared alike; ``lr`` a number, or a
    function of the package's ``optimizer.lr`` module."""
    jnet, tnet = _nets(state)
    jm, tm = paddle.Model(jnet), pt.Model(tnet)
    jm.prepare(paddle.optimizer.Adam(
        learning_rate=lr(jlr) if callable(lr) else lr,
        parameters=jnet.parameters(), **opt_kw.get("jax", {})),
        paddle.nn.CrossEntropyLoss(), paddle.metric.Accuracy())
    tm.prepare(pt.optimizer.Adam(
        learning_rate=lr(tlr) if callable(lr) else lr,
        parameters=tnet.parameters(), **opt_kw.get("port", {})),
        pt.nn.CrossEntropyLoss(), pt.metric.Accuracy())
    return jm, tm


def _recorder(pkg_callbacks):
    """A callback of either package recording each train batch's loss and
    the optimizer's learning rate at each batch's start."""

    class Recorder(pkg_callbacks.Callback):
        def on_train_begin(self, logs=None):
            self.losses, self.lrs, self.evals = [], [], []

        def on_train_batch_begin(self, step, logs=None):
            self.lrs.append(self.model._optimizer.get_lr())

        def on_train_batch_end(self, step, logs=None):
            self.losses.append(logs["loss"])

        def on_eval_end(self, logs=None):
            self.evals.append(dict(logs))
    return Recorder()


def _fit_both(jm, tm, seed=0, callbacks=None, n=N_TRAIN, **kw):
    out = []
    for m, pkg in ((jm, paddle.callbacks), (tm, pt.callbacks)):
        rec = _recorder(pkg)
        extra = callbacks(pkg) if callbacks else []
        np.random.seed(seed)
        hist = m.fit((JMNIST if m is jm else TMNIST)(mode="train",
                                                     synthetic_size=n),
                     batch_size=BATCH, verbose=0, callbacks=[rec, *extra],
                     **kw)
        out.append((hist, rec))
    return out


def _assert_logs_equal(t, j):
    assert sorted(t) == sorted(j)
    for k in j:
        if k == "loss":
            np.testing.assert_allclose(t[k], j[k], rtol=LOSS_RTOL)
        else:
            assert t[k] == j[k], k


def test_lenet_forward_matches_reference(state0):
    jnet, tnet = _nets(state0)
    assert list(tnet.state_dict()) == list(jnet.state_dict())
    assert len(tnet.parameters()) == 10
    assert sum(p.numel() for p in tnet.parameters()) == 61610
    x = np.random.RandomState(0).rand(8, 1, 28, 28).astype(np.float32)
    with torch.no_grad():
        got = tnet(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jnet(paddle.to_tensor(x))
                                               ._value),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("shuffle", [False, True], ids=["ordered",
                                                        "shuffled"])
def test_fit_evaluate_predict_match_reference(state0, shuffle):
    jm, tm = _models(state0)
    (jh, jr), (th, tr) = _fit_both(jm, tm, seed=7, epochs=EPOCHS,
                                   shuffle=shuffle)
    assert len(tr.losses) == len(jr.losses) == EPOCHS * N_TRAIN // BATCH
    np.testing.assert_allclose(tr.losses, jr.losses, rtol=LOSS_RTOL)
    assert th["acc"] == jh["acc"]
    np.testing.assert_allclose(th["loss"], jh["loss"], rtol=LOSS_RTOL)
    _assert_logs_equal(
        tm.evaluate(TMNIST(mode="test", synthetic_size=N_TEST),
                    batch_size=BATCH, verbose=0),
        jm.evaluate(JMNIST(mode="test", synthetic_size=N_TEST),
                    batch_size=BATCH, verbose=0))
    test = TMNIST(mode="test", synthetic_size=N_TEST)
    images = test.images[:, None]
    (tp,) = tm.predict(pt.io.TensorDataset([images]), batch_size=BATCH,
                       stack_outputs=True)
    (jp,) = jm.predict(paddle.io.TensorDataset([paddle.to_tensor(images)]),
                       batch_size=BATCH, stack_outputs=True)
    assert tp.shape == jp.shape == (N_TEST, 10) and tp.dtype == np.float32
    np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-3)
    np.testing.assert_array_equal(tp.argmax(-1), jp.argmax(-1))
    batches = tm.predict(pt.io.TensorDataset([images]), batch_size=BATCH)
    assert [b[0].shape[0] for b in batches] == [64, 64, 64, 8]


def test_accumulate_grad_batches(state0):
    """Every second batch updates (the eager path, gradients summed over
    two batches), as in the reference."""
    jm, tm = _models(state0)
    (jh, jr), (th, tr) = _fit_both(jm, tm, n=256, epochs=1, shuffle=False,
                                   accumulate_grad_batches=2)
    np.testing.assert_allclose(tr.losses, jr.losses, rtol=LOSS_RTOL)
    assert th["acc"] == jh["acc"]
    for a, b in zip(tm.network.parameters(), jm.network.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b._value),
                                   rtol=1e-3, atol=1e-5)
    assert tm._optimizer._step_count == jm._optimizer._step_count == 2


def test_num_iters_with_eval_data(state0):
    jm, tm = _models(state0)
    evals = [(JMNIST if m is jm else TMNIST)(mode="test", synthetic_size=64)
             for m in (jm, tm)]
    out = []
    for m, pkg, ev in ((jm, paddle.callbacks, evals[0]),
                       (tm, pt.callbacks, evals[1])):
        rec = _recorder(pkg)
        hist = m.fit((JMNIST if m is jm else TMNIST)(
            mode="train", synthetic_size=N_TRAIN), eval_data=ev,
            batch_size=BATCH, epochs=3, verbose=0, shuffle=False,
            num_iters=11, callbacks=[rec])
        out.append((hist, rec))
    (jh, jr), (th, tr) = out
    assert len(tr.losses) == len(jr.losses) == 11
    assert len(tr.evals) == len(jr.evals) == 2
    for t, j in zip(tr.evals, jr.evals):
        _assert_logs_equal(t, j)


def _cosine(pkg):
    return pkg.CosineAnnealingDecay(2e-3, T_max=6)


@pytest.mark.parametrize("by", ["step", "epoch"])
def test_lr_scheduler_callback_in_fit(state0, by):
    """The ``LRScheduler`` callback steps the optimizer's scheduler by
    step (the default one ``config_callbacks`` adds) or by epoch: the
    learning rate of every batch equals the reference's, and the fit's
    losses follow."""
    jm, tm = _models(state0, lr=_cosine)
    cb = (None if by == "step" else
          (lambda pkg: [pkg.LRScheduler(by_step=False, by_epoch=True)]))
    (jh, jr), (th, tr) = _fit_both(jm, tm, n=256, epochs=2, shuffle=False,
                                   callbacks=cb)
    assert tr.lrs == jr.lrs
    assert len(set(tr.lrs)) == (8 if by == "step" else 2)
    np.testing.assert_allclose(tr.losses, jr.losses, rtol=LOSS_RTOL)


def _feed(pkg_callbacks, make, model, logs_seq):
    """Run a callback over evaluation logs; returns what it decided after
    each (``stop_training`` and the optimizer's rate)."""
    cb = make(pkg_callbacks)
    cb.set_model(model)
    cb.on_train_begin()
    out = []
    for logs in logs_seq:
        cb.on_eval_end(logs)
        out.append((model.stop_training, model._optimizer.get_lr(),
                    cb.wait, cb.best))
    return out


LOG_SEQ = [{"loss": v, "acc": a} for v, a in (
    (1.0, 0.5), (0.8, 0.6), (0.81, 0.62), (0.79, 0.61), (0.9, 0.6),
    (0.95, 0.59), (0.5, 0.7), (0.51, 0.71), (0.52, 0.69), (0.53, 0.7))]


@pytest.mark.parametrize("name,make", [
    ("early_loss", lambda p: p.EarlyStopping(monitor="loss", patience=2,
                                             min_delta=0.005)),
    ("early_acc", lambda p: p.EarlyStopping(monitor="acc", patience=1)),
    ("early_baseline", lambda p: p.EarlyStopping(monitor="loss",
                                                 patience=3, baseline=0.6)),
    ("plateau_loss", lambda p: p.ReduceLROnPlateau(
        monitor="loss", factor=0.5, patience=1, cooldown=1, verbose=0)),
    ("plateau_acc", lambda p: p.ReduceLROnPlateau(
        monitor="acc", factor=0.1, patience=2, min_lr=1e-4, verbose=0)),
])
def test_callback_decisions_match_reference(state0, name, make):
    jm, tm = _models(state0, lr=0.01)
    for m in (jm, tm):
        m.stop_training = False
    assert (_feed(pt.callbacks, make, tm, LOG_SEQ)
            == _feed(paddle.callbacks, make, jm, LOG_SEQ))


def test_early_stopping_ends_the_fit(state0):
    """Evaluations whose loss never beats the baseline stop both fits
    after the same epoch."""
    jm, tm = _models(state0)
    out = []
    for m, pkg in ((jm, paddle.callbacks), (tm, pt.callbacks)):
        ev = (JMNIST if m is jm else TMNIST)(mode="test", synthetic_size=64)
        hist = m.fit((JMNIST if m is jm else TMNIST)(
            mode="train", synthetic_size=128), eval_data=ev,
            batch_size=BATCH, epochs=5, verbose=0, shuffle=False,
            callbacks=[pkg.EarlyStopping(monitor="loss", patience=1,
                                         baseline=0.0)])
        out.append(hist)
    assert len(out[1]["loss"]) == len(out[0]["loss"]) == 1


def test_model_checkpoint_files_and_cross_loading(state0, tmp_path):
    """``ModelCheckpoint`` writes the reference's files; the port's final
    checkpoint loads into the JAX model and evaluates as the JAX model's
    own final state does, and the other way round."""
    jm, tm = _models(state0, lr=_cosine)
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    for m, d in ((jm, jdir), (tm, tdir)):
        np.random.seed(0)
        m.fit((JMNIST if m is jm else TMNIST)(mode="train",
                                              synthetic_size=256),
              batch_size=BATCH, epochs=2, verbose=0, shuffle=False,
              save_dir=str(d), save_freq=1)
    assert sorted(p.name for p in tdir.iterdir()) == sorted(
        p.name for p in jdir.iterdir())
    assert {"final.pdparams", "final.pdopt", "0.pdparams"} <= {
        p.name for p in tdir.iterdir()}
    ev = dict(batch_size=BATCH, verbose=0)
    want_j = jm.evaluate(JMNIST(mode="test", synthetic_size=N_TEST), **ev)
    want_t = tm.evaluate(TMNIST(mode="test", synthetic_size=N_TEST), **ev)
    # the JAX model reads the port's checkpoint, the port the JAX one's
    j2, t2 = _models(state0, lr=_cosine)
    j2.load(str(tdir / "final"))
    t2.load(str(jdir / "final"))
    _assert_logs_equal(j2.evaluate(JMNIST(mode="test",
                                          synthetic_size=N_TEST), **ev),
                       want_t)
    _assert_logs_equal(t2.evaluate(TMNIST(mode="test",
                                          synthetic_size=N_TEST), **ev),
                       want_j)
    # the optimizer state crossed too: moments, step and scheduler
    tsd, jsd = t2._optimizer.state_dict(), jm._optimizer.state_dict()
    assert tsd["@step"] == jsd["@step"] == 8
    assert tsd["LR_Scheduler"] == jsd["LR_Scheduler"]
    jvals = [np.asarray(v._value) for k, v in jsd.items()
             if k not in ("LR_Scheduler", "master_weights", "@step")]
    tvals = [v.numpy() for k, v in tsd.items()
             if k not in ("LR_Scheduler", "master_weights", "@step")]
    assert len(tvals) == len(jvals) == 20
    for a, b in zip(tvals, jvals):
        np.testing.assert_array_equal(a, b)


def test_save_load_round_trip_both_ways(state0, tmp_path):
    """``save`` / ``load`` on nests of tensors: the port reads the JAX
    package's file bit for bit (on the current device) and the JAX package
    reads the port's, bf16 included."""
    rng = np.random.RandomState(0)
    obj = {"w": rng.randn(3, 4).astype(np.float32),
           "nested": {"i": np.arange(5, dtype=np.int32),
                      "h": rng.randn(4).astype(np.float32)},
           "list": [rng.randn(2).astype(np.float32)], "step": 7}
    paddle.save({"w": paddle.to_tensor(obj["w"]),
                 "nested": {"i": paddle.to_tensor(obj["nested"]["i"]),
                            "h": paddle.to_tensor(obj["nested"]["h"])},
                 "list": [paddle.to_tensor(obj["list"][0])], "step": 7},
                str(tmp_path / "j.pd"))
    got = pt.load(str(tmp_path / "j.pd"))
    assert got["step"] == 7 and got["w"].device.type == "cpu"
    np.testing.assert_array_equal(got["w"].numpy(), obj["w"])
    np.testing.assert_array_equal(got["nested"]["i"].numpy(),
                                  obj["nested"]["i"])
    np.testing.assert_array_equal(got["list"][0].numpy(), obj["list"][0])
    bf = torch.from_numpy(obj["nested"]["h"]).to(torch.bfloat16)
    pt.save({"w": torch.from_numpy(obj["w"]), "bf": bf, "step": 7},
            str(tmp_path / "t.pd"))
    back = paddle.load(str(tmp_path / "t.pd"))
    np.testing.assert_array_equal(back["w"].numpy(), obj["w"])
    assert str(back["bf"].dtype).endswith("bfloat16")
    np.testing.assert_array_equal(np.asarray(back["bf"]._value, np.float32),
                                  bf.float().numpy())
    again = pt.load(str(tmp_path / "t.pd"))
    assert again["bf"].dtype == torch.bfloat16 and torch.equal(
        again["bf"], bf)
    raw = pt.load(str(tmp_path / "t.pd"), return_numpy=True)
    np.testing.assert_array_equal(raw["w"], obj["w"])


def test_summary_and_flops_match_reference(state0, capsys):
    jnet, tnet = _nets(state0)
    assert pt.summary(tnet, (1, 1, 28, 28)) == paddle.summary(
        jnet, (1, 1, 28, 28))
    out = capsys.readouterr().out
    assert "Conv2D-1" in out and "Total params: 61,610" in out
    for size in ([1, 1, 28, 28], [4, 1, 28, 28]):
        assert pt.flops(tnet, size) == paddle.flops(jnet, size)
    assert pt.flops(tnet, [1, 1, 28, 28]) == 682512
    jm, tm = _models(state0)
    assert tm.summary() == jm.summary()


def _mlps(seed=0):
    """``Sequential(Linear(12, 16), ReLU, Linear(16, 10))`` of both
    packages with the same numpy weights (eager JAX on LeNet costs seconds
    a step)."""
    rng = np.random.RandomState(seed)
    jnet = paddle.nn.Sequential(paddle.nn.Linear(12, 16), paddle.nn.ReLU(),
                                paddle.nn.Linear(16, 10))
    state = {k: (rng.randn(*v.shape) * 0.3).astype(np.float32)
             for k, v in jnet.state_dict().items()}
    for k, v in jnet.state_dict().items():
        v._inplace_set(jnp.asarray(state[k]))
    tnet = pt.nn.Sequential(pt.nn.Linear(12, 16), pt.nn.ReLU(),
                            pt.nn.Linear(16, 10))
    layer_state_from_numpy(tnet, state, device="cpu")
    return jnet, tnet


def test_roadmap_api_names():
    """Optimizer.minimize / clear_gradients, GradScaler's minimize,
    is_enable, get_loss_scaling, state_dict and load_state_dict,
    amp.autocast, Layer.load_dict and clear_gradients, on both
    packages."""
    jnet, tnet = _mlps()
    x = np.random.RandomState(1).rand(4, 12).astype(np.float32)
    y = np.random.RandomState(2).randint(0, 10, (4, 1)).astype(np.int64)
    jo = paddle.optimizer.SGD(learning_rate=0.1,
                              parameters=jnet.parameters())
    to = pt.optimizer.SGD(learning_rate=0.1, parameters=tnet.parameters())
    jo.minimize(paddle.nn.CrossEntropyLoss()(jnet(paddle.to_tensor(x)),
                                             paddle.to_tensor(y)))
    to.minimize(pt.nn.CrossEntropyLoss()(tnet(torch.from_numpy(x)),
                                         torch.from_numpy(y)))
    assert all(p.grad is not None for p in tnet.parameters())
    to.clear_gradients()
    jo.clear_gradients()
    assert all(p.grad is None for p in tnet.parameters())
    for a, b in zip(tnet.parameters(), jnet.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b._value),
                                   rtol=1e-5, atol=1e-6)
    # the scaler's minimize: backward, step (unscaled) and update
    js = paddle.amp.GradScaler(init_loss_scaling=1024.0,
                               incr_every_n_steps=1)
    ts = tamp.GradScaler(init_loss_scaling=1024.0, incr_every_n_steps=1)
    assert ts.is_enable() and js.is_enable()
    with tamp.autocast(enable=False):
        tl = pt.nn.CrossEntropyLoss()(tnet(torch.from_numpy(x)),
                                      torch.from_numpy(y))
    with paddle.amp.autocast(enable=False):
        jl = paddle.nn.CrossEntropyLoss()(jnet(paddle.to_tensor(x)),
                                          paddle.to_tensor(y))
    js.minimize(jo, js.scale(jl))
    ts.minimize(to, ts.scale(tl))
    assert ts.state_dict() == js.state_dict() == {
        "scale": 2048.0, "good_steps": 0, "bad_steps": 0}
    assert float(ts.get_loss_scaling()) == float(js.get_loss_scaling())
    assert ts.get_loss_scaling().device.type == "cpu"
    for a, b in zip(tnet.parameters(), jnet.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b._value),
                                   rtol=1e-5, atol=1e-6)
    fresh = tamp.GradScaler()
    fresh.load_state_dict(ts.state_dict())
    assert fresh.state_dict() == ts.state_dict()
    # Layer.load_dict and clear_gradients
    tnet(torch.from_numpy(x)).sum().backward()
    tnet.clear_gradients()
    assert all(p.grad is None for p in tnet.parameters())
    other = _mlps(seed=1)[1]
    missing, unexpected = other.load_dict(tnet.state_dict())
    assert missing == [] and unexpected == []
    for a, b in zip(other.parameters(), tnet.parameters()):
        assert torch.equal(a, b)


def test_one_device_read_per_batch_and_telemetry(state0):
    """Each train and eval batch makes one ``_fetch`` (one host copy of
    the loss with the accuracy matrix); each update records its step in
    ``observability.metrics`` and a ``hapi.train_batch`` span."""
    _, tm = _models(state0)
    fetched = []
    orig = tmodel._fetch

    def spy(tensors):
        fetched.append([tuple(t.shape) for t in tensors])
        return orig(tensors)

    class Spans:
        def __init__(self):
            self.names = []

        def _host_event(self, name, t0, t1, kind):
            self.names.append((name, kind))

    spans = Spans()
    steps0 = tobs.counter("train.steps").value
    tmodel._fetch = spy
    _hooks.COLLECTORS.append(spans)
    try:
        tm.fit(TMNIST(mode="train", synthetic_size=256), batch_size=BATCH,
               epochs=1, verbose=0, shuffle=False)
        tm.evaluate(TMNIST(mode="test", synthetic_size=100),
                    batch_size=BATCH, verbose=0)
    finally:
        tmodel._fetch = orig
        _hooks.COLLECTORS.remove(spans)
    assert fetched == [[(), (64, 1)]] * 4 + [[(), (64, 1)], [(), (36, 1)]]
    assert spans.names == [("hapi.train_batch", "train")] * 4
    assert tobs.counter("train.steps").value - steps0 == 4
    assert tobs.gauge("train.samples_per_s").value > 0


def test_a_failing_loss_propagates(state0):
    """No batch runs a second way: an exception in the loss reaches the
    caller and the optimizer has not stepped."""
    _, tm = _models(state0)

    def bad_loss(logits, label):
        raise RuntimeError("loss failed")

    tm.prepare(tm._optimizer, bad_loss, pt.metric.Accuracy())
    x = np.zeros((4, 1, 28, 28), np.float32)
    y = np.zeros((4, 1), np.int64)
    with pytest.raises(RuntimeError, match="loss failed"):
        tm.train_batch([x], [y])
    with pytest.raises(RuntimeError, match="loss failed"):
        tm.eval_batch([x], [y])
    assert tm._optimizer._step_count == 0
