"""Wiring of the paper's two tasks onto the simulator: models, losses, data
partitions, batch providers. Task 1 is image classification (SynthCIFAR,
ResNet), Task 2 next-char prediction (SynthShakespeare, the char-LSTM);
``LMTask`` is LM pretraining of any of the ten architectures through the
same engines."""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.data import partition, synthetic
from repro_torch.data.pipeline import SyntheticLMStream, to_tensors
from repro_torch.models import lstm, resnet, transformer
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


class LMTask:
    """LM pretraining through the FL engines: one ``SyntheticLMStream``
    shard per client (seeded 1000 + i) over a ``models.transformer``
    architecture, plus a fixed held-out batch (seed 7) for loss/accuracy
    gates: the reference's ``LMTask``, whose batches it draws bit for bit.

    ``loss_fn`` is the reference's as written (ROADMAP R12): log-softmax in
    the logits' dtype, the mean over every position (the VLM's ``-1``
    label pad gathers vocab id V − 1, as ``jnp.take_along_axis`` wraps it;
    ``torch.gather`` would raise, so the labels are wrapped explicitly),
    the MoE aux loss added unscaled, and a bare ``forward`` (the hybrid
    attends unwindowed, R10). Batches and the held-out batch live on
    ``device`` (default ``cuda``); ``init_fn`` draws the params there from
    the simulator's seed."""

    def __init__(self, cfg, *, num_clients: int, batch_size: int, seq_len: int,
                 device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        kw = dict(vocab_size=cfg.vocab_size, seq_len=seq_len, batch_size=batch_size,
                  num_codebooks=cfg.num_codebooks, num_patches=cfg.num_patches,
                  d_model=cfg.d_model)
        self.streams = [SyntheticLMStream(seed=1000 + i, **kw) for i in range(num_clients)]
        self.held_out = to_tensors(next(SyntheticLMStream(seed=7, **kw)), self.device)

    def init_fn(self, generator: torch.Generator):
        if generator.device != self.device:
            generator = torch.Generator(device=self.device).manual_seed(
                generator.initial_seed())
        return transformer.init_params(self.cfg, generator)

    def loss_fn(self, params, batch):
        logits, aux, _ = transformer.forward(self.cfg, params, batch)
        logp = F.log_softmax(logits, dim=-1)
        labels = torch.remainder(batch["labels"], logits.shape[-1])  # -1 -> V - 1
        nll = -torch.gather(logp, -1, labels[..., None])
        return torch.mean(nll) + aux

    def held_out_loss(self, params) -> float:
        with torch.no_grad():
            return float(self.loss_fn(params, self.held_out))

    def eval_fn(self, params) -> float:
        with torch.no_grad():
            logits, _, _ = transformer.forward(self.cfg, params, self.held_out)
            hits = torch.argmax(logits, -1) == self.held_out["labels"]
            return float(torch.mean(hits.float()))

    def batch_provider(self, t, ids, rng):
        per_client = [next(self.streams[int(i)]) for i in ids]
        return to_tensors({k: np.stack([b[k] for b in per_client]) for k in per_client[0]},
                          self.device)
