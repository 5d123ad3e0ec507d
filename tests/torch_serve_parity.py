"""Shared setup of the serving tier's parity tests
(``test_torch_serve_cache.py``, ``test_torch_serve_paged.py``,
``test_torch_serve_engine.py``): the reference test's small config
(``tests/test_serve.py:31-37``: 2 layers, d_model 64, 4 heads, 2 KV heads)
in both packages, and the port's fixed-batch greedy reference.
"""

import numpy as np
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro_torch.configs.base import ModelConfig
from repro_torch.dist import step as tstep

SMALL = dict(name="serve-test", family="dense", num_layers=2, d_model=64, num_heads=4,
             num_kv_heads=2, d_ff=128, vocab_size=128)


def small_configs(**overrides):
    """(JAX config, port config) of the small dense model, equal field for field."""
    return JModelConfig(**SMALL, **overrides), ModelConfig(**SMALL, **overrides)


def prompts(cfg, b, t, seed):
    """(B, T) int32 token ids from a numpy generator."""
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, t)).astype(np.int32)


def fixed_reference(cfg, params, prompts, gen, cache_len):
    """The port's fixed-batch greedy decode on the CPU: (tokens (B, gen),
    the per-step float32 logits, the prefill's first)."""
    prefill = tstep.make_prefill_step(cfg, cache_len=cache_len)
    serve = tstep.make_serve_step(cfg)
    last, cache = prefill(params, {"tokens": torch.from_numpy(prompts).long()})
    tok = torch.argmax(last, dim=-1)
    toks, logits = [tok], [last]
    plen = prompts.shape[1]
    for i in range(gen - 1):
        tok, lg, cache = serve(params, cache, tok, torch.tensor(plen + i))
        toks.append(tok)
        logits.append(lg)
    return torch.stack(toks, dim=-1).numpy(), logits
