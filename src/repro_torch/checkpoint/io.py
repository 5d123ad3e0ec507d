"""Checkpointing: a tree of tensors to disk and back, in the reference's
format, so that a checkpoint either package writes restores under the
other.

Format: one ``.npz`` per checkpoint with the leaves under their
``"/"``-joined paths (dict keys, sequence indices, NamedTuple field names)
plus a ``.meta`` sidecar: the msgpack encoding of ``{"step": int, "meta":
dict, "keys": [str, ...]}``. The port does not import msgpack; it encodes
and decodes by hand exactly the subset that sidecar holds, byte for byte
what ``msgpack.packb`` writes: maps, str, int, float (as float64), bool,
None and lists of those. Anything else raises.

bfloat16 leaves are stored as the reference stores them, 2-byte void
(``|V2``) arrays of their bits, and come back bit for bit into a bfloat16
template leaf.
"""

from __future__ import annotations

import os
import struct

import numpy as np
import torch

from repro_torch.utils import tree_leaves, tree_unflatten


def _paths(tree, prefix=()):
    """(path, leaf) pairs in ``tree_leaves`` order."""
    if isinstance(tree, torch.Tensor):
        return [(prefix, tree)]
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k], prefix + (k,))]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [p for name, x in zip(tree._fields, tree, strict=True)
                for p in _paths(x, prefix + (name,))]
    if isinstance(tree, (tuple, list)):
        return [p for i, x in enumerate(tree) for p in _paths(x, prefix + (i,))]
    raise TypeError(f"a checkpoint holds trees of tensors, got a {type(tree).__name__} leaf")


def _key(path) -> str:
    return "/".join(str(k) for k in path)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def _flatten(tree) -> dict:
    return {_key(p): _to_numpy(x) for p, x in _paths(tree)}


def save(path: str, tree, *, step: int = 0, meta: dict | None = None):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays = _flatten(tree)
    np.savez(path + ".npz", **arrays)
    with open(path + ".meta", "wb") as f:
        f.write(packb({"step": step, "meta": meta or {}, "keys": sorted(arrays)}))


def restore(path: str, like, *, shardings=None):
    """Restore into the structure of ``like`` (a template tree of the whole
    leaves), each leaf in the template leaf's dtype, on its device. With
    ``shardings`` (a tree of ``dist.sharding.NamedSharding`` mirroring
    ``like``) each leaf comes back as this rank's local piece under its
    placements, the counterpart of the reference's ``jax.device_put(tree,
    shardings)``."""
    data = np.load(path + ".npz")
    leaves = []
    for p, leaf in _paths(like):
        key = _key(p)
        arr = data[key]
        if arr.shape != tuple(leaf.shape):
            raise ValueError(f"shape mismatch for {key}: {arr.shape} vs {tuple(leaf.shape)}")
        if arr.dtype.kind == "V":  # bfloat16 bits
            if leaf.dtype != torch.bfloat16 or arr.dtype.itemsize != 2:
                raise ValueError(f"{key}: {arr.dtype} bits cannot fill a {leaf.dtype} leaf")
            t = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(np.ascontiguousarray(arr)).to(leaf.dtype)
        leaves.append(t.to(leaf.device))
    tree = tree_unflatten(like, leaves)
    if shardings is not None:
        from repro_torch.dist.sharding import local_tree

        tree = local_tree(tree, shardings)
    return tree


def load_meta(path: str) -> dict:
    with open(path + ".meta", "rb") as f:
        return unpackb(f.read())


# ---------------------------------------------------------------------------
# The msgpack subset of the sidecar
# ---------------------------------------------------------------------------


def _pack(x, out: bytearray) -> None:
    if x is None:
        out.append(0xC0)
    elif isinstance(x, bool):
        out.append(0xC3 if x else 0xC2)
    elif isinstance(x, int):
        _pack_int(x, out)
    elif isinstance(x, float):
        out += b"\xcb" + struct.pack(">d", x)
    elif isinstance(x, str):
        b = x.encode("utf-8")
        n = len(b)
        if n <= 31:
            out.append(0xA0 | n)
        elif n <= 0xFF:
            out += b"\xd9" + struct.pack(">B", n)
        elif n <= 0xFFFF:
            out += b"\xda" + struct.pack(">H", n)
        else:
            out += b"\xdb" + struct.pack(">I", n)
        out += b
    elif isinstance(x, (list, tuple)):
        _pack_len(len(x), 0x90, b"\xdc", b"\xdd", out)
        for y in x:
            _pack(y, out)
    elif isinstance(x, dict):
        _pack_len(len(x), 0x80, b"\xde", b"\xdf", out)
        for k, v in x.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"the checkpoint sidecar holds str, int, float, bool, None, lists and "
                        f"maps of them, not {type(x).__name__}")


def _pack_len(n: int, fix: int, c16: bytes, c32: bytes, out: bytearray) -> None:
    if n <= 15:
        out.append(fix | n)
    elif n <= 0xFFFF:
        out += c16 + struct.pack(">H", n)
    else:
        out += c32 + struct.pack(">I", n)


def _pack_int(x: int, out: bytearray) -> None:
    if 0 <= x <= 0x7F:
        out.append(x)
    elif x >= 0:
        for code, fmt, top in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                               (0xCE, ">I", 0xFFFFFFFF), (0xCF, ">Q", 2**64 - 1)):
            if x <= top:
                out += bytes([code]) + struct.pack(fmt, x)
                return
        raise OverflowError(f"{x} does not fit msgpack's uint64")
    elif x >= -32:
        out += struct.pack(">b", x)
    else:
        for code, fmt, bits in ((0xD0, ">b", 7), (0xD1, ">h", 15), (0xD2, ">i", 31),
                                (0xD3, ">q", 63)):
            if x >= -(2**bits):
                out += bytes([code]) + struct.pack(fmt, x)
                return
        raise OverflowError(f"{x} does not fit msgpack's int64")


def packb(obj) -> bytes:
    """``msgpack.packb(obj)`` for the sidecar's subset."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def unpackb(data: bytes):
    """``msgpack.unpackb(data)`` for the sidecar's subset."""
    obj, end = _unpack(data, 0)
    if end != len(data):
        raise ValueError(f"{len(data) - end} bytes after the sidecar's object")
    return obj


_FIXED = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
          0xD2: ">i", 0xD3: ">q", 0xCA: ">f", 0xCB: ">d"}


def _unpack(b: bytes, i: int):
    c = b[i]
    i += 1
    if c <= 0x7F:
        return c, i
    if c >= 0xE0:
        return c - 0x100, i
    if 0xA0 <= c <= 0xBF:
        return _str(b, i, c & 0x1F)
    if 0x90 <= c <= 0x9F:
        return _array(b, i, c & 0x0F)
    if 0x80 <= c <= 0x8F:
        return _map(b, i, c & 0x0F)
    if c == 0xC0:
        return None, i
    if c in (0xC2, 0xC3):
        return c == 0xC3, i
    if c in _FIXED:
        fmt = _FIXED[c]
        return struct.unpack_from(fmt, b, i)[0], i + struct.calcsize(fmt)
    lengths = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I", 0xDC: ">H", 0xDD: ">I", 0xDE: ">H",
               0xDF: ">I"}
    if c in lengths:
        fmt = lengths[c]
        n = struct.unpack_from(fmt, b, i)[0]
        i += struct.calcsize(fmt)
        if c <= 0xDB:
            return _str(b, i, n)
        return (_array if c <= 0xDD else _map)(b, i, n)
    raise ValueError(f"msgpack type byte 0x{c:02x} is outside the sidecar's subset")


def _str(b, i, n):
    return b[i:i + n].decode("utf-8"), i + n


def _array(b, i, n):
    out = []
    for _ in range(n):
        x, i = _unpack(b, i)
        out.append(x)
    return out, i


def _map(b, i, n):
    out = {}
    for _ in range(n):
        k, i = _unpack(b, i)
        v, i = _unpack(b, i)
        out[k] = v
    return out, i


__all__ = ["load_meta", "packb", "restore", "save", "unpackb"]
