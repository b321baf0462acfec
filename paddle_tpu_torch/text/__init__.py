"""``text``: the NLP datasets and CRF decoding (counterpart of
``paddle_tpu/text/__init__.py``).

The reference's corpora need a download, which this project never makes:
``Imdb``, ``Imikolov`` and ``UCIHousing`` are the JAX package's seeded
synthetic stand-ins, array for array (the same ``np.random.RandomState``
draws in the same order), with the same ``Dataset`` API. ``Imdb``'s
tokens are drawn from the label's half of the vocabulary 30 % of the time,
so a classifier can learn the label.

``viterbi_decode`` returns (the best path's score ``[B]``, the path
``[B, T]`` as int32); ``include_bos_eos_tag`` is taken and ignored, and a
row shorter than ``T`` carries its last real step's scores through the
padding with identity back-pointers, as in the reference. It runs on the
tensors' device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..io import Dataset

__all__ = ["Imdb", "Imikolov", "UCIHousing", "viterbi_decode",
           "ViterbiDecoder"]


class Imdb(Dataset):
    """Binary sentiment: (token ids ``[seq_len]`` int64, label int64)."""

    def __init__(self, data_file=None, mode="train", cutoff=150,
                 synthetic_size=None, vocab_size=5000, seq_len=64):
        n = synthetic_size or (2000 if mode == "train" else 400)
        rng = np.random.RandomState(11 if mode == "train" else 12)
        self.word_idx = {f"w{i}": i for i in range(vocab_size)}
        self.labels = rng.randint(0, 2, n).astype("int64")
        self.docs = np.where(
            rng.rand(n, seq_len) < 0.3,
            (self.labels[:, None] * (vocab_size // 2)
             + rng.randint(0, vocab_size // 2, (n, seq_len))),
            rng.randint(0, vocab_size, (n, seq_len)),
        ).astype("int64")

    def __getitem__(self, idx):
        return self.docs[idx], self.labels[idx]

    def __len__(self):
        return len(self.docs)


class Imikolov(Dataset):
    """N-gram language modelling: ``window_size - 1`` context words, then
    the next word as ``[1]``."""

    def __init__(self, data_file=None, data_type="NGRAM", window_size=5,
                 mode="train", min_word_freq=50, synthetic_size=None,
                 vocab_size=2000):
        n = synthetic_size or (5000 if mode == "train" else 500)
        rng = np.random.RandomState(13 if mode == "train" else 14)
        seq = rng.randint(0, vocab_size, n + window_size).astype("int64")
        self.window_size = window_size
        self.grams = np.stack([seq[i:i + window_size] for i in range(n)])

    def __getitem__(self, idx):
        g = self.grams[idx]
        return tuple(g[:-1]) + (g[-1:],)

    def __len__(self):
        return len(self.grams)


class UCIHousing(Dataset):
    """Regression: (13 features fp32, price ``[1]`` fp32)."""

    def __init__(self, data_file=None, mode="train", synthetic_size=None):
        n = synthetic_size or (404 if mode == "train" else 102)
        rng = np.random.RandomState(15 if mode == "train" else 16)
        self.x = rng.randn(n, 13).astype("float32")
        w = np.linspace(-1, 1, 13).astype("float32")
        self.y = (self.x @ w + 0.1 * rng.randn(n)).astype("float32")[:, None]

    def __getitem__(self, idx):
        return self.x[idx], self.y[idx]

    def __len__(self):
        return len(self.x)


def viterbi_decode(potentials, transition_params, lengths=None,
                   include_bos_eos_tag=True):
    """CRF Viterbi decoding of emissions ``[B, T, N]`` under transitions
    ``[N, N]`` (``alpha[i] + trans[i, j]``, the first best on ties):
    returns (scores ``[B]``, paths ``[B, T]`` int32)."""
    e = torch.as_tensor(potentials)
    t = torch.as_tensor(transition_params, device=e.device)
    B, T, N = e.shape
    lens = (torch.full((B,), T, device=e.device) if lengths is None
            else torch.as_tensor(lengths, device=e.device).long())
    ident = torch.arange(N, device=e.device).expand(B, N)
    alpha, backs = e[:, 0], []
    for step in range(1, T):
        scores = alpha[:, :, None] + t                 # [B, N, N]
        best, back = scores.max(dim=1)
        valid = (step < lens)[:, None]
        alpha = torch.where(valid, best + e[:, step], alpha)
        backs.append(torch.where(valid, back, ident))
    score, last = alpha.max(dim=-1)
    path = [last]
    for back in reversed(backs):
        last = back.gather(1, last[:, None])[:, 0]
        path.append(last)
    return score, torch.stack(path[::-1], dim=1).int()


class ViterbiDecoder:
    def __init__(self, transitions, include_bos_eos_tag=True, name=None):
        self.transitions = transitions
        self.include_bos_eos_tag = include_bos_eos_tag

    def __call__(self, potentials, lengths=None):
        return viterbi_decode(potentials, self.transitions, lengths,
                              self.include_bos_eos_tag)
