"""The text models the classic Paddle tutorials train.

- ``SentimentBiLSTM``: ``Embedding`` -> a bidirectional ``LSTM`` -> the
  last step's features -> ``Linear`` -> ``Tanh`` -> ``Linear`` (Imdb
  sentiment; at its defaults 5000 x 128, two layers of 198 a direction,
  396 -> 96 -> 2: 21 parameters).
- ``NGramGRU`` and ``NGramLoss``: the context words -> ``Embedding`` ->
  ``GRU`` -> the last step -> ``Linear`` -> ``log_softmax``, scored by
  ``NLLLoss`` on the next word (Imikolov).
- ``housing_mlp``: five ``Linear`` layers with ReLU between (13 -> 64 ->
  64 -> 64 -> 64 -> 1, 10 parameters) for ``UCIHousing``.
"""

from __future__ import annotations

import torch

from .. import nn
from ..nn import functional as F

__all__ = ["SentimentBiLSTM", "NGramGRU", "NGramLoss", "housing_mlp"]

# Imikolov's vocabulary, NGramGRU's embedding and hidden widths
NGRAM_VOCAB, NGRAM_EMB, NGRAM_HIDDEN = 2000, 128, 256
# housing_mlp's hidden width
HOUSING_WIDTH = 64


class SentimentBiLSTM(nn.Layer):
    def __init__(self, vocab_size=5000, emb_dim=128, hidden_size=198,
                 num_layers=2, fc_size=96, num_classes=2):
        super().__init__()
        self.embedding = nn.Embedding(vocab_size, emb_dim)
        self.lstm = nn.LSTM(emb_dim, hidden_size, num_layers=num_layers,
                            direction="bidirect")
        self.fc1 = nn.Linear(2 * hidden_size, fc_size)
        self.act = nn.Tanh()
        self.fc2 = nn.Linear(fc_size, num_classes)

    def forward(self, ids):
        y, _ = self.lstm(self.embedding(ids))
        return self.fc2(self.act(self.fc1(y[:, -1])))


class NGramGRU(nn.Layer):
    def __init__(self):
        super().__init__()
        self.embedding = nn.Embedding(NGRAM_VOCAB, NGRAM_EMB)
        self.gru = nn.GRU(NGRAM_EMB, NGRAM_HIDDEN)
        self.fc = nn.Linear(NGRAM_HIDDEN, NGRAM_VOCAB)

    def forward(self, *words):
        y, _ = self.gru(self.embedding(torch.stack(words, dim=1)))
        return F.log_softmax(self.fc(y[:, -1]), axis=-1)


class NGramLoss(nn.Layer):
    """``NLLLoss`` on Imikolov's ``[B, 1]`` next-word labels."""

    def __init__(self):
        super().__init__()
        self.nll = nn.NLLLoss()

    def forward(self, logp, label):
        return self.nll(logp, label.reshape(-1))


def housing_mlp():
    width = HOUSING_WIDTH
    return nn.Sequential(
        nn.Linear(13, width), nn.ReLU(), nn.Linear(width, width), nn.ReLU(),
        nn.Linear(width, width), nn.ReLU(), nn.Linear(width, width),
        nn.ReLU(), nn.Linear(width, 1))
