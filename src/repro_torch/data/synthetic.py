"""Synthetic dataset generators, numpy only.

* ``SynthCIFAR`` — 32×32×3, 10 classes. Each class has a random smooth
  prototype (low-frequency structure) plus class-correlated color statistics;
  samples are prototype + per-sample noise. A small CNN/ResNet separates
  classes with a real accuracy gradient (not trivially, not impossibly),
  which is what the paper's EMD-ladder experiments need.
* ``SynthShakespeare`` — char-level text; each client is a "speaker" with
  its own first-order Markov transition matrix (mixture of a shared base
  chain and a client-specific chain) → naturally non-IID, like LEAF's
  Shakespeare split.

Copies of the JAX package's generators: they make the same ``rng`` calls
in the same order, so the same seeds give arrays equal element for
element and both packages train on the same data.
"""

from __future__ import annotations

import dataclasses

import numpy as np

IMG_SHAPE = (32, 32, 3)
NUM_CLASSES = 10
VOCAB = 80  # printable chars subset, LEAF-Shakespeare-like


def _smooth_noise(rng, shape, cutoff=6):
    """Low-frequency random field via truncated 2-D Fourier basis."""
    h, w = shape[:2]
    spec = np.zeros((h, w), np.complex128)
    spec[:cutoff, :cutoff] = rng.normal(size=(cutoff, cutoff)) + 1j * rng.normal(
        size=(cutoff, cutoff)
    )
    field = np.fft.ifft2(spec).real
    field /= np.abs(field).max() + 1e-9
    return field


@dataclasses.dataclass
class SynthCIFAR:
    """Class-conditional synthetic image dataset."""

    num_train: int = 20_000
    num_test: int = 2_000
    seed: int = 0
    noise: float = 0.55  # sample noise vs prototype signal

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        protos = []
        for _ in range(NUM_CLASSES):
            chans = [_smooth_noise(rng, IMG_SHAPE[:2]) for _ in range(3)]
            protos.append(np.stack(chans, -1))
        self.prototypes = np.stack(protos).astype(np.float32)  # (10, 32, 32, 3)
        self.x_train, self.y_train = self._make(rng, self.num_train)
        self.x_test, self.y_test = self._make(rng, self.num_test)

    def _make(self, rng, n):
        y = rng.integers(0, NUM_CLASSES, size=n)
        noise = rng.normal(scale=self.noise, size=(n,) + IMG_SHAPE).astype(np.float32)
        x = self.prototypes[y] + noise
        return x.astype(np.float32), y.astype(np.int32)


@dataclasses.dataclass
class SynthShakespeare:
    """Per-client Markov char streams (naturally non-IID).

    The generator is a Python loop of one draw per character, as in the
    JAX package (400,000 at 100 clients of 4,000 chars): a vectorised draw
    would consume the stream differently. The JAX package draws with
    ``rng.choice(VOCAB, p=trans[s])``, which is one ``rng.random()``
    searched in the row's cdf, rebuilt on every call; the cdf of every row
    is built once here, and the draws are the same bits."""

    num_clients: int = 100
    chars_per_client: int = 4_000
    seq_len: int = 80
    seed: int = 0
    client_mix: float = 0.35  # weight of the client-specific chain

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        base = rng.dirichlet(np.ones(VOCAB) * 0.3, size=VOCAB)
        self.client_tokens = []
        self.client_char_hist = np.zeros((self.num_clients, VOCAB))
        for k in range(self.num_clients):
            own = rng.dirichlet(np.ones(VOCAB) * 0.15, size=VOCAB)
            trans = (1 - self.client_mix) * base + self.client_mix * own
            trans /= trans.sum(axis=1, keepdims=True)
            cdf = trans.cumsum(axis=1)
            cdf /= cdf[:, -1:]
            toks = np.empty(self.chars_per_client, np.int32)
            s = int(rng.integers(VOCAB))
            for i in range(self.chars_per_client):
                s = int(cdf[s].searchsorted(rng.random(), side="right"))
                toks[i] = s
            self.client_tokens.append(toks)
            hist = np.bincount(toks, minlength=VOCAB)
            self.client_char_hist[k] = hist / hist.sum()

    def client_sequences(self, k):
        """Returns (inputs (N, L), targets (N, L)) next-char pairs."""
        toks = self.client_tokens[k]
        n = (len(toks) - 1) // self.seq_len
        x = toks[: n * self.seq_len].reshape(n, self.seq_len)
        y = toks[1 : n * self.seq_len + 1].reshape(n, self.seq_len)
        return x, y

    def emd(self) -> float:
        """Mean client-vs-global label-distribution EMD (L1; Zhao et al.)."""
        global_hist = self.client_char_hist.mean(axis=0)
        return float(np.mean(np.abs(self.client_char_hist - global_hist).sum(axis=1)))
