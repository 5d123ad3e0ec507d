"""Wiring of the paper's two tasks onto the simulator: models, losses, data
partitions, batch providers. Task 1 is image classification (SynthCIFAR,
ResNet), Task 2 next-char prediction (SynthShakespeare, the char-LSTM)."""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.data import partition, synthetic
from repro_torch.models import lstm, resnet
from repro_torch.utils import resolve_device, to_device


def softmax_xent(logits, labels):
    logp = F.log_softmax(logits, dim=-1)
    return -torch.mean(torch.gather(logp, -1, labels[..., None]))


class CifarTask:
    """SynthCIFAR + ResNet. The data lives on ``device`` (default ``cuda``;
    ``device="cpu"`` must be asked for). Samples, partitions and the batch
    provider's ``rng.choice`` calls are the JAX package's, in the same
    order, so both packages draw the same batches from the same rng."""

    def __init__(
        self,
        *,
        num_clients: int = 20,
        target_emd: float = 0.0,
        depth: int = 56,
        data: synthetic.SynthCIFAR | None = None,
        seed: int = 0,
        device="cuda",
    ):
        self.device = resolve_device(device)
        self.depth = depth
        self.data = data or synthetic.SynthCIFAR(seed=seed)
        dists = partition.client_label_distributions(num_clients, 10, target_emd)
        self.parts = partition.partition_by_distribution(self.data.y_train, dists, seed)
        self.measured_emd = partition.measured_emd(self.data.y_train, self.parts)
        to_dev = lambda a, dtype: torch.as_tensor(a, dtype=dtype, device=self.device)
        self.x = to_dev(self.data.x_train, torch.float32)
        self.y = to_dev(self.data.y_train, torch.int64)
        self.x_test = to_dev(self.data.x_test, torch.float32)
        self.y_test = to_dev(self.data.y_test, torch.int64)

    def init_fn(self, generator: torch.Generator):
        return resnet.init_resnet(generator, depth=self.depth, device=self.device)

    def loss_fn(self, params, batch):
        x, y = batch
        logits = resnet.resnet_forward(params, x, depth=self.depth)
        return softmax_xent(logits, y)

    @functools.cached_property
    def _eval(self):
        @torch.no_grad()
        def acc(params, x, y):
            logits = resnet.resnet_forward(params, x, depth=self.depth)
            return torch.mean((torch.argmax(logits, -1) == y).float())

        return acc

    def eval_fn(self, params, max_samples: int = 1000):
        return float(self._eval(params, self.x_test[:max_samples], self.y_test[:max_samples]))

    def batch_provider(self, batch_size):
        def provide(round_idx, client_ids, rng):
            takes = []
            for k in client_ids:
                idx = self.parts[k]
                takes.append(rng.choice(idx, size=min(batch_size, len(idx)),
                                        replace=len(idx) < batch_size))
            take = to_device(np.stack(takes), self.device)
            return (self.x[take], self.y[take])

        return provide


class ShakespeareTask:
    """SynthShakespeare + the char-LSTM. Every client's next-char pairs live
    on ``device`` (default ``cuda``; ``device="cpu"`` must be asked for) as
    int64, one ``[sum_k n_k, seq_len]`` tensor each for inputs and targets
    with client k's sequences from row ``start[k]``; the held-out batch is
    the last sequence of every client. The batch provider makes the JAX
    package's ``rng.choice`` calls, one per client in order, and gathers
    the round's batch with one device index."""

    def __init__(self, *, num_clients: int = 100, seed: int = 0,
                 data: synthetic.SynthShakespeare | None = None, device="cuda"):
        self.device = resolve_device(device)
        self.data = data or synthetic.SynthShakespeare(num_clients=num_clients, seed=seed)
        self.measured_emd = self.data.emd()
        seqs = [self.data.client_sequences(k) for k in range(num_clients)]
        self.counts = np.array([len(x) for x, _ in seqs], np.int64)
        self.start = np.concatenate([[0], np.cumsum(self.counts)[:-1]]).astype(np.int64)
        to_dev = lambda a: torch.as_tensor(a, dtype=torch.int64, device=self.device)
        self.x = to_dev(np.concatenate([x for x, _ in seqs]))
        self.y = to_dev(np.concatenate([y for _, y in seqs]))
        last = to_dev(self.start + self.counts - 1)
        self.x_test, self.y_test = self.x[last], self.y[last]

    def init_fn(self, generator: torch.Generator):
        return lstm.init_lstm(generator, vocab=synthetic.VOCAB, device=self.device)

    def loss_fn(self, params, batch):
        x, y = batch
        return softmax_xent(lstm.lstm_forward(params, x), y)

    def eval_fn(self, params):
        with torch.no_grad():
            logits = lstm.lstm_forward(params, self.x_test)
            return float(torch.mean((torch.argmax(logits, -1) == self.y_test).float()))

    def batch_provider(self, batch_size):
        def provide(round_idx, client_ids, rng):
            takes = []
            for k in client_ids:
                n = int(self.counts[k])
                takes.append(self.start[k] + rng.choice(n, size=min(batch_size, n),
                                                        replace=n < batch_size))
            take = to_device(np.stack(takes), self.device)
            return (self.x[take], self.y[take])

        return provide
