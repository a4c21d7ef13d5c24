"""Reader of the JAX package's checkpoints (`repro/checkpoint/io.py`):
msgpack-serialized pytrees whose arrays are ExtType 1 payloads of
``(dtype str, shape, raw bytes)``; bfloat16 arrays are stored as float32.

Returns plain nested dicts/lists with numpy leaves (bfloat16 leaves come back
as the float32 they were stored as, exact). The port reads this format; it
does not write it yet.
"""
from __future__ import annotations

from typing import Any

import numpy as np

_EXT_ND = 1


def _decode(code, data):
    import msgpack
    if code == _EXT_ND:
        dtype, shape, buf = msgpack.unpackb(data)
        if dtype == "bfloat16":
            dtype = "<f4"                     # stored widened to float32
        return np.frombuffer(buf, np.dtype(dtype)).reshape(shape).copy()
    return msgpack.ExtType(code, data)


def load_pytree(path: str) -> Any:
    import msgpack                # only checkpoint reading needs it
    with open(path, "rb") as f:
        return msgpack.unpackb(f.read(), ext_hook=_decode,
                               strict_map_key=False)
