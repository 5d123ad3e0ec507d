"""Token/batch pipelines for the production trainer: the port's own copy of
the reference's ``data/pipeline.py`` (it draws only from numpy, so both
packages make the same batches from the same seed, bit for bit).

``SyntheticLMStream`` — deterministic synthetic token stream with Zipfian
unigram statistics and local n-gram structure (so a language model has
something learnable); used by ``launch/train.py`` and ``fl.tasks.LMTask``.
Swapping in a real tokenised corpus is a loader change (same iterator
contract).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class SyntheticLMStream:
    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0
    num_codebooks: int = 0      # audio family: emit (B, K, T)
    num_patches: int = 0        # vlm family: emit patch embeddings too
    d_model: int = 0

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)
        v = self.vocab_size
        # Zipfian unigram + a sparse bigram "grammar" for learnable structure
        ranks = np.arange(1, v + 1)
        self._unigram = (1.0 / ranks) / np.sum(1.0 / ranks)
        self._jump = self._rng.integers(0, v, size=v)  # bigram successor table
        # the reference's unigram draw, rng.choice(v, p=unigram), is one
        # rng.random() searched in the cdf that choice rebuilds on every
        # call (O(v)); built once here, the draws stay the same bits
        self._cdf = self._unigram.cumsum()
        self._cdf /= self._cdf[-1]

    def _tokens(self, shape):
        flat = int(np.prod(shape))
        toks = np.empty(flat, np.int32)
        toks[0] = 0
        rng = self._rng
        for i in range(1, flat):
            if rng.random() < 0.5:
                toks[i] = self._jump[toks[i - 1]]
            else:
                toks[i] = self._cdf.searchsorted(rng.random(), side="right")
        return toks.reshape(shape)

    def __iter__(self):
        return self

    def __next__(self):
        b, t = self.batch_size, self.seq_len
        if self.num_codebooks:
            toks = self._tokens((b, self.num_codebooks, t + 1))
            return {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
        toks = self._tokens((b, t + 1))
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if self.num_patches:
            batch["patch_embeds"] = self._rng.normal(
                size=(b, self.num_patches, self.d_model)
            ).astype(np.float32)
            pad = np.full((b, self.num_patches), -1, np.int32)
            batch["labels"] = np.concatenate([pad, batch["labels"]], axis=1)
        return batch


def to_tensors(batch: dict, device) -> dict:
    """A numpy batch of the stream -> tensors on ``device``: token ids and
    labels as int64 (torch indexes with them), patch embeddings as they
    are."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        out[k] = (t.long() if k in ("tokens", "labels") else t).to(device)
    return out
