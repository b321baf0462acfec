"""The port's recurrent layers, ``text`` and the slice's ``Model.fit``
against the JAX package's, on the CPU.

``SimpleRNN``, ``LSTM`` and ``GRU`` (1 and 2 layers, forward and
``"bidirect"``, ``time_major`` both ways) and the three cells run at T 8,
H 16 with the JAX layer's ``state_dict()`` carried across by
``layer_state_from_numpy`` (the keys must be equal): outputs and final
states within 1e-5, every parameter's gradient of ``sum(y * w1) + sum(h *
w2)`` within 1e-4 (a gradient sums over the eight steps' products, in
another order on each side). The JAX side runs as one ``jit.to_static``
program a case. ``nn.RNN`` and ``BiRNN`` run with ``sequence_length``
(masked in the reverse direction too), with their state-dict keys.
``text``'s datasets are equal array for array and ``viterbi_decode``'s
paths equal. Last, a narrow twin of ``chip_smoke.py``'s BiLSTM on Imdb
(emb 16, H 8, two bidirectional layers, ``Imdb(synthetic_size=128,
seq_len=16)``, batch 32, one epoch of ``Adam``) goes through
``Model.fit`` on both packages from the same weights: each batch's loss
within rtol 1e-3, as ``test_torch_hapi.py`` holds LeNet, and the
accuracies equal.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu_torch as port
from paddle_tpu_torch.device import set_device
from paddle_tpu_torch.models.convert import layer_state_from_numpy
from paddle_tpu_torch.text import recipes

T, N, IN, H = 8, 3, 6, 16
OUT_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def cpu():
    prev = set_device("cpu")
    yield
    set_device(prev)


def _np(seed, *shape):
    return np.asarray(np.random.RandomState(seed).randn(*shape), np.float32)


def _flat(out):
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _flat(o)]
    return [out]


def _carry(jlayer, tlayer):
    assert list(tlayer.state_dict()) == list(jlayer.state_dict())
    state = {k: np.asarray(v.numpy()) for k, v in jlayer.state_dict().items()}
    return layer_state_from_numpy(tlayer, state, device="cpu")


def _run_jax(layer, arrays, call):
    xs = [paddle.to_tensor(a, stop_gradient=False) for a in arrays]

    def program(*ts):
        _ = layer  # in the closure: its parameters ride as inputs
        return call(layer, *ts)
    outs = _flat(paddle.jit.to_static(program)(*xs))
    loss = None
    for i, o in enumerate(outs):
        term = (o * paddle.to_tensor(_np(50 + i, *o.shape))).sum()
        loss = term if loss is None else loss + term
    loss.backward()
    return ([o.numpy() for o in outs],
            {k: p.grad.numpy() for k, p in layer.state_dict().items()},
            [x.grad.numpy() for x in xs])


def _run_port(layer, arrays, call):
    xs = [torch.from_numpy(a.copy()).requires_grad_() for a in arrays]
    outs = _flat(call(layer, *xs))
    loss = sum((o * torch.from_numpy(_np(50 + i, *o.shape))).sum()
               for i, o in enumerate(outs))
    loss.backward()
    return ([o.detach().numpy() for o in outs],
            {k: p.grad.numpy() for k, p in layer.named_parameters()},
            [x.grad.numpy() for x in xs])


def _same(jlayer, tlayer, arrays, call=lambda l, *xs: l(*xs)):
    _carry(jlayer, tlayer)
    jo, jg, jx = _run_jax(jlayer, arrays, call)
    to, tg, tx = _run_port(tlayer, arrays, call)
    assert [o.shape for o in to] == [o.shape for o in jo]
    for a, b in zip(to, jo):
        np.testing.assert_allclose(a, b, **OUT_TOL)
    assert set(tg) == set(jg)
    for k in jg:
        np.testing.assert_allclose(tg[k], jg[k], err_msg=k, **GRAD_TOL)
    for a, b in zip(tx, jx):
        np.testing.assert_allclose(a, b, **GRAD_TOL)


@pytest.mark.parametrize("time_major", [False, True],
                         ids=["batch_major", "time_major"])
@pytest.mark.parametrize("direction", ["forward", "bidirect"])
@pytest.mark.parametrize("num_layers", [1, 2])
@pytest.mark.parametrize("mode", ["SimpleRNN", "LSTM", "GRU"])
def test_rnn_layer(mode, num_layers, direction, time_major):
    paddle.seed(1)
    kw = dict(num_layers=num_layers, direction=direction,
              time_major=time_major)
    x = _np(1, T, N, IN) if time_major else _np(1, N, T, IN)
    _same(getattr(paddle.nn, mode)(IN, H, **kw),
          getattr(port.nn, mode)(IN, H, **kw), [x])


def test_simple_rnn_relu_and_ignored_initial_states():
    """``activation="relu"``; and ``initial_states`` and ``dropout`` change
    nothing, as in the reference."""
    paddle.seed(2)
    jl = paddle.nn.SimpleRNN(IN, H, activation="relu", dropout=0.5)
    tl = port.nn.SimpleRNN(IN, H, activation="relu", dropout=0.5)
    _same(jl, tl, [_np(1, N, T, IN)])
    x = torch.from_numpy(_np(1, N, T, IN))
    y0, h0 = tl(x)
    y1, h1 = tl(x, torch.from_numpy(_np(3, 1, N, H)))
    assert torch.equal(y0, y1) and torch.equal(h0, h1)


CELLS = [("SimpleRNNCell", dict(activation="tanh"), 1),
         ("SimpleRNNCell", dict(activation="relu"), 1),
         ("LSTMCell", {}, 2), ("GRUCell", {}, 1)]


@pytest.mark.parametrize("given_states", [False, True])
@pytest.mark.parametrize("name,kw,n_states", CELLS,
                         ids=["rnn_tanh", "rnn_relu", "lstm", "gru"])
def test_cell(name, kw, n_states, given_states):
    paddle.seed(3)
    arrays = [_np(1, N, IN)]
    if given_states:
        arrays += [_np(2 + i, N, H) for i in range(n_states)]

    def call(layer, x, *states):
        if not states:
            return layer(x)
        return layer(x, states if len(states) > 1 else states[0])
    _same(getattr(paddle.nn, name)(IN, H, **kw),
          getattr(port.nn, name)(IN, H, **kw), arrays, call)


SEQ_LEN = np.array([8, 5, 2], np.int64)


@pytest.mark.parametrize("time_major", [False, True],
                         ids=["batch_major", "time_major"])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("cell", ["LSTMCell", "GRUCell"])
def test_rnn_wrapper_sequence_length(cell, reverse, time_major):
    paddle.seed(4)
    jl = paddle.nn.RNN(getattr(paddle.nn, cell)(IN, H), is_reverse=reverse,
                       time_major=time_major)
    tl = port.nn.RNN(getattr(port.nn, cell)(IN, H), is_reverse=reverse,
                     time_major=time_major)
    x = _np(1, T, N, IN) if time_major else _np(1, N, T, IN)
    _same(jl, tl, [x], lambda l, x: l(
        x, sequence_length=(paddle.to_tensor(SEQ_LEN)
                            if isinstance(x, paddle.Tensor)
                            else torch.from_numpy(SEQ_LEN))))


@pytest.mark.parametrize("cell", ["SimpleRNNCell", "LSTMCell", "GRUCell"])
def test_birnn(cell):
    """``BiRNN`` with ``sequence_length``: its state-dict keys are the
    reference's (each cell once, under ``cell_fw`` / ``cell_bw``)."""
    paddle.seed(5)
    jl = paddle.nn.BiRNN(getattr(paddle.nn, cell)(IN, H),
                         getattr(paddle.nn, cell)(IN, H))
    tl = port.nn.BiRNN(getattr(port.nn, cell)(IN, H),
                       getattr(port.nn, cell)(IN, H))
    assert list(tl.state_dict()) == [
        f"cell_{d}.{k}" for d in ("fw", "bw")
        for k in ("weight_ih", "weight_hh", "bias_ih", "bias_hh")]
    _same(jl, tl, [_np(1, N, T, IN)], lambda l, x: l(
        x, sequence_length=(paddle.to_tensor(SEQ_LEN)
                            if isinstance(x, paddle.Tensor)
                            else torch.from_numpy(SEQ_LEN))))


# ---------------------------------------------------------------------------
# text
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["train", "test"])
def test_text_datasets_equal(mode):
    for name, kw in (("Imdb", dict(synthetic_size=64, seq_len=12)),
                     ("Imikolov", dict(synthetic_size=64)),
                     ("UCIHousing", {})):
        j = getattr(paddle.text, name)(mode=mode, **kw)
        t = getattr(port.text, name)(mode=mode, **kw)
        assert len(t) == len(j)
        for i in (0, len(j) // 2, len(j) - 1):
            for a, b in zip(t[i], j[i]):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
                assert np.asarray(a).dtype == np.asarray(b).dtype
    imdb_j, imdb_t = paddle.text.Imdb(mode=mode), port.text.Imdb(mode=mode)
    np.testing.assert_array_equal(imdb_t.docs, imdb_j.docs)
    np.testing.assert_array_equal(imdb_t.labels, imdb_j.labels)
    assert imdb_t.word_idx == imdb_j.word_idx


@pytest.mark.parametrize("lengths", [None, [7, 4, 1, 7]],
                         ids=["full", "ragged"])
def test_viterbi_decode(lengths):
    e = _np(1, 4, 7, 5)
    tr = _np(2, 5, 5)
    lj = None if lengths is None else paddle.to_tensor(np.array(lengths))
    lt = None if lengths is None else torch.tensor(lengths)
    js, jp = paddle.text.viterbi_decode(paddle.to_tensor(e),
                                        paddle.to_tensor(tr), lj)
    ts, tp = port.text.ViterbiDecoder(torch.from_numpy(tr))(
        torch.from_numpy(e), lt)
    assert tp.dtype == torch.int32
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp.numpy()))
    np.testing.assert_allclose(ts.numpy(), js.numpy(), **OUT_TOL)


# ---------------------------------------------------------------------------
# the slice end to end: a narrow BiLSTM on Imdb through Model.fit
# ---------------------------------------------------------------------------

class _JaxSentimentBiLSTM(paddle.nn.Layer):
    """``recipes.SentimentBiLSTM`` on the JAX package (the same keys)."""

    def __init__(self, vocab_size, emb_dim, hidden_size, fc_size):
        super().__init__()
        self.embedding = paddle.nn.Embedding(vocab_size, emb_dim)
        self.lstm = paddle.nn.LSTM(emb_dim, hidden_size, num_layers=2,
                                   direction="bidirect")
        self.fc1 = paddle.nn.Linear(2 * hidden_size, fc_size)
        self.act = paddle.nn.Tanh()
        self.fc2 = paddle.nn.Linear(fc_size, 2)

    def forward(self, ids):
        y, _ = self.lstm(self.embedding(ids))
        return self.fc2(self.act(self.fc1(y[:, -1])))


def _recorder(pkg_callbacks):
    class Recorder(pkg_callbacks.Callback):
        def on_train_begin(self, logs=None):
            self.losses, self.accs = [], []

        def on_train_batch_end(self, step, logs=None):
            self.losses.append(logs["loss"])
            self.accs.append(logs["acc"])
    return Recorder()


def test_imdb_bilstm_fit_matches_reference():
    narrow = dict(vocab_size=5000, emb_dim=16, hidden_size=8, fc_size=12)
    paddle.seed(0)
    jnet = _JaxSentimentBiLSTM(**narrow)
    tnet = recipes.SentimentBiLSTM(**narrow)
    _carry(jnet, tnet)
    assert len(tnet.parameters()) == 21
    runs = []
    for pkg, net in ((paddle, jnet), (port, tnet)):
        model = pkg.Model(net)
        model.prepare(pkg.optimizer.Adam(learning_rate=1e-3,
                                         parameters=net.parameters()),
                      pkg.nn.CrossEntropyLoss(), pkg.metric.Accuracy())
        rec = _recorder(pkg.callbacks)
        model.fit(pkg.text.Imdb(synthetic_size=128, seq_len=16),
                  batch_size=32, epochs=1, shuffle=False, verbose=0,
                  callbacks=[rec])
        ev = model.evaluate(pkg.text.Imdb(mode="test", synthetic_size=64,
                                          seq_len=16),
                            batch_size=32, verbose=0)
        runs.append((rec, ev))
    (jrec, jev), (trec, tev) = runs
    assert len(trec.losses) == 4
    np.testing.assert_allclose(trec.losses, jrec.losses, rtol=1e-3)
    assert trec.accs == jrec.accs
    np.testing.assert_allclose(tev["loss"], jev["loss"], rtol=1e-3)
    assert tev["acc"] == jev["acc"]
