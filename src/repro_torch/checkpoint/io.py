"""Checkpoints in the JAX package's format (`repro/checkpoint/io.py`):
msgpack-serialized trees whose arrays are ExtType 1 payloads of
``(dtype str, shape, raw bytes)``; bfloat16 arrays are stored as float32
under the tag ``"bfloat16"``. Dict keys are written in sorted order, as
JAX's tree map leaves them, so either package reads the other's files.

`save_pytree` writes atomically (a temporary file in the target directory,
then `os.replace`) and streams: each array is copied to the host when the
writer reaches it, and an array of 64 KiB or more goes to the file straight
from that copy, behind the ext header `msgpack.packb` would give it (the
same bytes, without packb's three copies), so a multi-GB run state never
sits in host memory twice. `load_pytree` streams the file the same way and
returns plain nested dicts/lists with numpy leaves (bfloat16 leaves come
back as the float32 they were stored as, exact); `restore_like` grafts them
onto a live tree of tensors.
"""
from __future__ import annotations

import os
import tempfile
from typing import Any

import numpy as np
import torch

_EXT_ND = 1
_READ_SIZE = 64 << 20               # file reads of the streaming unpacker
# largest object read back: msgpack's ext length is 32 bits
_MAX_OBJECT = (1 << 32) + (1 << 20)


def _host_array(obj):
    """(dtype tag, contiguous host numpy array) of a tensor or array leaf,
    or None for any other object."""
    if isinstance(obj, torch.Tensor):
        t = obj.detach()
        if t.dtype == torch.bfloat16:
            return "bfloat16", t.to(torch.float32).cpu().contiguous().numpy()
        arr = t.cpu().contiguous().numpy()
        return arr.dtype.str, arr
    if isinstance(obj, (np.ndarray, np.generic)):
        arr = np.asarray(obj)          # 0-d stays 0-d (ascontiguousarray
        if not arr.flags.c_contiguous:  # would make it 1-d)
            arr = np.ascontiguousarray(arr)
        return arr.dtype.str, arr
    return None


def _encode(obj):
    import msgpack
    leaf = _host_array(obj)
    if leaf is None:
        raise TypeError(f"cannot serialize {type(obj)}")
    tag, arr = leaf
    return msgpack.ExtType(_EXT_ND, msgpack.packb(
        (tag, arr.shape, arr.tobytes())))


def _write_array(f, packer, tag, arr) -> bool:
    """Write a large array as ext 32 (the header msgpack gives payloads of
    more than 0xffff bytes) straight from its buffer; False if the array is
    small, for the packer to take."""
    raw = memoryview(arr.reshape(-1)).cast("B")
    head = (packer.pack_array_header(3) + packer.pack(tag)
            + packer.pack(arr.shape) + _bin_header(raw.nbytes))
    n = len(head) + raw.nbytes
    if n <= 0xffff:
        return False
    f.write(b"\xc9" + n.to_bytes(4, "big") + bytes([_EXT_ND]) + head)
    f.write(raw)
    return True


def _bin_header(n: int) -> bytes:
    if n < 1 << 8:
        return b"\xc4" + n.to_bytes(1, "big")
    if n < 1 << 16:
        return b"\xc5" + n.to_bytes(2, "big")
    return b"\xc6" + n.to_bytes(4, "big")


def _decode(code, data):
    """ExtType 1 -> a writable numpy array: the (dtype, shape) head is
    unpacked from the payload's first bytes, the array copied once out of
    the payload (unpacking the bin would copy it twice)."""
    import msgpack
    if code != _EXT_ND:
        return msgpack.ExtType(code, data)
    head = msgpack.Unpacker()
    head.feed(data[:1024])
    if head.read_array_header() != 3:
        raise ValueError("malformed array payload")
    dtype, shape = head.unpack(), head.unpack()
    off = head.tell()
    width = {0xc4: 1, 0xc5: 2, 0xc6: 4}[data[off]]
    n = int.from_bytes(data[off + 1:off + 1 + width], "big")
    if dtype == "bfloat16":
        dtype = "<f4"                         # stored widened to float32
    dt = np.dtype(dtype)
    return np.frombuffer(data, dt, count=n // dt.itemsize,
                         offset=off + 1 + width).reshape(shape).copy()


def _write(f, packer, obj) -> None:
    """Pack `obj` into `f` container by container (the bytes `packb` would
    give for the whole tree)."""
    if isinstance(obj, dict):
        f.write(packer.pack_map_header(len(obj)))
        keys = (sorted(obj) if all(isinstance(k, str) for k in obj)
                else list(obj))
        for k in keys:
            f.write(packer.pack(k))
            _write(f, packer, obj[k])
    elif isinstance(obj, (list, tuple)):
        f.write(packer.pack_array_header(len(obj)))
        for v in obj:
            _write(f, packer, v)
    else:
        leaf = _host_array(obj)
        if leaf is None or not _write_array(f, packer, *leaf):
            f.write(packer.pack(obj))


def save_pytree(path: str, tree: Any) -> None:
    """Atomic msgpack dump of a tree of tensors/arrays/scalars/dicts/lists
    (tuples and NamedTuples are written as lists)."""
    import msgpack
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d)
    try:
        with os.fdopen(fd, "wb") as f:
            _write(f, msgpack.Packer(default=_encode), tree)
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise


def load_pytree(path: str) -> Any:
    import msgpack
    with open(path, "rb") as f:
        return msgpack.Unpacker(f, read_size=_READ_SIZE, ext_hook=_decode,
                                strict_map_key=False,
                                max_buffer_size=_MAX_OBJECT).unpack()


def _leaves(tree) -> list:
    """Leaves in JAX's flatten order: sorted dict keys, sequences in order,
    None an empty subtree."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [] if tree is None else [tree]


def _graft(ref, it):
    if isinstance(ref, dict):
        out = {k: _graft(ref[k], it) for k in sorted(ref)}
        return {k: out[k] for k in ref}
    if isinstance(ref, (list, tuple)):
        vals = [_graft(v, it) for v in ref]
        if hasattr(ref, "_fields"):                  # NamedTuple
            return type(ref)(*vals)
        return type(ref)(vals)
    if ref is None:
        return None
    leaf = next(it)
    if isinstance(ref, torch.Tensor):
        t = torch.as_tensor(np.asarray(leaf))
        if tuple(t.shape) != tuple(ref.shape):
            raise ValueError(f"checkpoint leaf shape mismatch: "
                             f"{tuple(t.shape)} vs {tuple(ref.shape)}")
        return t.to(device=ref.device, dtype=ref.dtype)
    return type(ref)(leaf)


def restore_like(ref: Any, loaded: Any) -> Any:
    """Re-type a `load_pytree` result onto the structure of `ref`, a live
    tree of tensors (or scalars): leaves pair up in JAX's flatten order, as
    the JAX package's `restore_like` pairs them, and each takes its
    reference leaf's dtype, device and (checked) shape, so bf16 leaves
    saved as f32 come back as bf16. None subtrees count no leaves on either
    side."""
    ref_n, leaves = len(_leaves(ref)), _leaves(loaded)
    if ref_n != len(leaves):
        raise ValueError(
            f"checkpoint structure mismatch: reference has {ref_n} leaves, "
            f"checkpoint has {len(leaves)}")
    return _graft(ref, iter(leaves))
