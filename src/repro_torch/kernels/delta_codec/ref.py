"""Plain PyTorch version of the delta wire codec, the JAX package's oracle
(`repro/kernels/delta_codec/ref.py`) in the same order of operations, so
the two agree bitwise on the same inputs.

Wire format (per flat array, zero-padded to whole `block`-element blocks;
one row below = one block):

    scale   = absmax(block) * f32(1/levels)      levels = 127 (int8) | 7 (int4)
    codes   = clip(round_half_even(x / scale), -levels, levels)   — int8
    int8 payload: the codes verbatim, 1 byte an element
    int4 payload: halves-packed — element i of the block's FIRST half in the
        low nibble of byte i, element i of the SECOND half in the high nibble

An all-zero block has scale 0 and codes 0 and decodes to exact zeros. Scales
ship as one f32 a block (`ops.wire_bytes`).
"""
from __future__ import annotations

import numpy as np
import torch

LEVELS = {8: 127, 4: 7}


def quantize_ref(x2d, *, bits: int):
    """(nblocks, block) f32 -> (codes int8 (nblocks, block), scales
    (nblocks,))."""
    levels = LEVELS[bits]
    x = x2d.to(torch.float32)
    absmax = x.abs().amax(dim=1)
    # a multiply by the f32 rounding of 1/levels, as the JAX oracle spells it
    scale = absmax * torch.tensor(np.float32(1.0 / levels), device=x.device)
    safe = torch.where(scale > 0.0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(x / safe[:, None]), -levels, levels)
    return q.to(torch.int8), scale


def pack_ref(codes, *, bits: int):
    """int8 codes -> wire bytes; int4 packs the block halves into nibbles."""
    if bits == 8:
        return codes
    half = codes.shape[1] // 2
    lo = codes[:, :half].to(torch.int32)
    hi = codes[:, half:].to(torch.int32)
    return ((lo & 0xF) | ((hi & 0xF) << 4)).to(torch.int8)


def _sext4(nibble):
    """Sign-extend a 4-bit two's-complement value held in an int32."""
    return ((nibble & 0xF) ^ 8) - 8


def unpack_ref(packed, *, bits: int):
    if bits == 8:
        return packed
    b = packed.to(torch.int32)
    return torch.cat([_sext4(b), _sext4(b >> 4)], dim=1).to(torch.int8)


def dequantize_ref(codes, scales):
    return codes.to(torch.float32) * scales[:, None]


def encode_ref(x2d, *, bits: int):
    """Quantize + pack: (nblocks, block) f32 -> (packed int8, scales f32)."""
    codes, scales = quantize_ref(x2d, bits=bits)
    return pack_ref(codes, bits=bits), scales


def decode_ref(packed, scales, *, bits: int):
    """Unpack + dequantize: the inverse of `encode_ref` (up to
    quantization)."""
    return dequantize_ref(unpack_ref(packed, bits=bits), scales)


def roundtrip_ref(x2d, *, bits: int):
    """What the receiver reconstructs: decode(encode(x))."""
    packed, scales = encode_ref(x2d, bits=bits)
    return decode_ref(packed, scales, bits=bits)
