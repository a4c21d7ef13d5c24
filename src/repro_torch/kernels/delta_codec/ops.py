"""Public wrappers of the delta wire codec (per-block absmax int8/int4).

Array level:
  encode_array(x)          -> (packed int8, scales f32)   quantize + pack
  decode_array(packed, ..) -> x_hat                       unpack + dequantize
  codec_roundtrip_array(x) -> x_hat                       what the receiver sees

Tree level (the engine's per-leaf path):
  codec_roundtrip(tree)    — a round trip per leaf; None leaves pass through

Each array is read flat and cut into `block`-element blocks, the last one
zero-padded (zeros never change a block's absmax), so the plain version on
the padded layout and the kernel, which reads the missing elements as 0,
agree bitwise.

`impl`: "auto" = the kernels for CUDA tensors, the plain version for CPU
tensors; "ref" = the plain version on either. Unlike the JAX package's
"auto", there is no fallback on block alignment: the kernels take every
even block from 2 to 65536. The kernels have no backward: "auto" raises if
an input needs a gradient.

`wire_bytes` is the one place the compressed payload size is computed;
`ProtocolEngine._wire_bytes` calls it, so transfer times, link pricing and
the Eq. 9 cadence all see the real payload.
"""
from __future__ import annotations

import torch

from repro_torch.core.tree import tree_map
from repro_torch.kernels import check_no_grad
from repro_torch.kernels.delta_codec import ref as ref_lib
from repro_torch.kernels.delta_codec.delta_codec import (
    dequantize_unpack_cuda, quantize_pack_cuda)

CODEC_BITS = {"int8": 8, "int4": 4}


def wire_bytes(n_elems: int, *, codec: str, block: int) -> int:
    """Bytes on the wire for an `n_elems`-element payload: `bits`-bit codes
    plus one f32 scale per `block` elements."""
    bits = CODEC_BITS[codec]
    payload = (n_elems * bits + 7) // 8
    scales = -(-n_elems // block) * 4
    return payload + scales


def _use_ref(name: str, impl: str, *tensors) -> bool:
    if impl not in ("auto", "ref"):
        raise ValueError(f"unknown impl {impl!r}; options: auto|ref")
    if impl == "ref":
        return True
    check_no_grad(name, *tensors)
    return tensors[0].device.type == "cpu"


def _blocked(x, block: int):
    """Flat f32 copy of `x` zero-padded to (nblocks, block)."""
    flat = x.reshape(-1).to(torch.float32)
    pad = -flat.numel() % block
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(-1, block)


def encode_array(x, *, codec: str, block: int, impl: str = "auto"):
    """Quantize + pack one array. Returns (packed int8 (nblocks,
    block * bits // 8), scales f32 (nblocks,)) over the zero-padded
    blocks."""
    bits = CODEC_BITS[codec]
    if _use_ref("quantize_pack", impl, x):
        return ref_lib.encode_ref(_blocked(x, block), bits=bits)
    return quantize_pack_cuda(x.to(torch.float32).contiguous(), block=block,
                              bits=bits)


def decode_array(packed, scales, shape, dtype, *, codec: str, block: int,
                 impl: str = "auto"):
    """Unpack + dequantize back to `shape`/`dtype` (drops the block
    padding)."""
    bits = CODEC_BITS[codec]
    if packed.shape[1] * 8 // bits != block:
        raise ValueError(f"packed rows of {packed.shape[1]} bytes are not "
                         f"{codec} blocks of {block}")
    if _use_ref("dequantize_unpack", impl, scales):
        x2d = ref_lib.decode_ref(packed, scales, bits=bits)
    else:
        x2d = dequantize_unpack_cuda(packed, scales, bits=bits)
    n = 1
    for s in shape:
        n *= int(s)
    return x2d.reshape(-1)[:n].reshape(shape).to(dtype)


def codec_roundtrip_array(x, *, codec: str, block: int, impl: str = "auto"):
    """decode(encode(x)): the payload the receiver reconstructs."""
    packed, scales = encode_array(x, codec=codec, block=block, impl=impl)
    return decode_array(packed, scales, x.shape, x.dtype, codec=codec,
                        block=block, impl=impl)


def codec_roundtrip(tree, *, codec: str, block: int, impl: str = "auto"):
    """Tree-level round trip, one encode and one decode per present leaf;
    None leaves (absent from a fragment) stay None."""
    return tree_map(lambda leaf: codec_roundtrip_array(
        leaf, codec=codec, block=block, impl=impl), tree)
