"""REP001 clean twin: every consumer gets its own key or seed."""

import torch

from repro_torch.utils import draws


def two_consumers_two_keys(layout):
    mask = draws.uniform(draws.element_hashes(layout, draws.leaf_keys(layout, 17, 0)))
    signs = draws.rademacher(draws.element_hashes(layout, draws.leaf_keys(layout, 17, 1)))
    return mask, signs


def fold_between_uses(layout, consume):
    key = draws.key(29, 3)
    first = consume(key)
    second = consume(draws.fold(key, 1))
    return first, second


def rebinding_resets_the_key(layout, consume):
    keys = draws.leaf_keys(layout, 5)
    a = consume(keys)
    keys = draws.fold(keys, 1)
    b = consume(keys)
    return a, b


def distinct_seeds(init_fn, seed):
    params = init_fn(torch.Generator().manual_seed(2 * seed))
    prompts = torch.randint(0, 64, (4, 16), generator=torch.Generator().manual_seed(2 * seed + 1))
    return params, prompts


def branches_are_exclusive(flag, seed):
    if flag:
        gen = torch.Generator().manual_seed(seed)
    else:
        gen = torch.Generator(device="cuda").manual_seed(seed)
    return gen
