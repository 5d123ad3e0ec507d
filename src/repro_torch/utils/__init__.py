from repro_torch.utils.device import resolve_device, scalar, to_device, weak
from repro_torch.utils.tree import (
    flatten_dotted,
    global_norm,
    tree_any_nan,
    tree_bytes,
    tree_l2_norm,
    tree_leaves,
    tree_map,
    tree_multimap,
    tree_nnz,
    tree_size,
    tree_size_scalar,
    tree_unflatten,
    tree_zeros_like,
)
from repro_torch.utils.quant import (
    dequantize_q8,
    quantize_q8,
    roundtrip_q8_blocks,
)

__all__ = [
    "dequantize_q8",
    "flatten_dotted",
    "global_norm",
    "quantize_q8",
    "resolve_device",
    "roundtrip_q8_blocks",
    "scalar",
    "to_device",
    "tree_any_nan",
    "tree_bytes",
    "tree_l2_norm",
    "tree_leaves",
    "tree_map",
    "tree_multimap",
    "tree_nnz",
    "tree_size",
    "tree_size_scalar",
    "tree_unflatten",
    "tree_zeros_like",
    "weak",
]
