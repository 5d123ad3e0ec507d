"""REP001 seeded violations (torch form): draws keys and seeds reused."""

import torch

from repro_torch.utils import draws


def two_consumers_same_keys(layout):
    keys = draws.leaf_keys(layout, 17, 0)
    mask = draws.uniform(draws.element_hashes(layout, keys))
    signs = draws.rademacher(draws.element_hashes(layout, keys))  # expect: REP001
    return mask, signs


def reuse_after_user_function(layout, consume):
    key = draws.key(29, 3)
    first = consume(key)
    second = draws.fold(key, 1) + consume(key)  # expect: REP001
    return first, second


def prompts_and_init_from_one_seed(init_fn, seed):
    params = init_fn(torch.Generator().manual_seed(seed))
    prompts = torch.randint(0, 64, (4, 16),
                            generator=torch.Generator().manual_seed(seed))  # expect: REP001
    return params, prompts
