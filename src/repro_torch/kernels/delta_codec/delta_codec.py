"""Launchers of the CUDA C++ kernels ``csrc/delta_codec.cu``: per-block
absmax quantize + pack and unpack + dequantize of the wire codec. Replace the
TPU kernels `quantize_pack_2d` and `dequantize_unpack_2d` of the JAX package
(`repro/kernels/delta_codec/delta_codec.py`); the source says what bounds
them on the card and how the design answers that.

The encoder takes the flat array as it lies (any length: the last block's
missing elements read as 0, so no padded copy is made); both take any even
block from 2 to 65536, the range the spec admits."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import count_launch, load_library


def _fns():
    lib = load_library("delta_codec")
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    enc = lib.quantize_pack_launch
    enc.argtypes = [vp, i64, i32, i32, vp, vp, vp]
    enc.restype = ctypes.c_int
    dec = lib.dequantize_unpack_launch
    dec.argtypes = [vp, vp, i64, i32, i32, vp, vp]
    dec.restype = ctypes.c_int
    return enc, dec


def check_codec_args(block: int, bits: int) -> None:
    """The blocks and widths the kernels take (any device)."""
    if bits not in (8, 4):
        raise ValueError(f"the codec packs 8 or 4 bits, got {bits}")
    if not (2 <= block <= 65536) or block % 2:
        raise ValueError(f"codec block must be even, in [2, 65536], got "
                         f"{block}")


def quantize_pack_cuda(x, *, block: int, bits: int):
    """x: contiguous f32 on CUDA, any shape (read flat). Returns (packed
    int8 (nblocks, block * bits // 8), scales f32 (nblocks,)) over
    ceil(x.numel() / block) blocks."""
    check_codec_args(block, bits)
    if x.device.type != "cuda":
        raise ValueError("quantize_pack takes a CUDA tensor")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError("quantize_pack takes a contiguous float32 tensor")
    n = x.numel()
    nblocks = -(-n // block)
    packed = torch.empty((nblocks, block * bits // 8), dtype=torch.int8,
                         device=x.device)
    scales = torch.empty((nblocks,), dtype=torch.float32, device=x.device)
    if n == 0:
        return packed, scales
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _fns()[0](x.data_ptr(), n, block, bits, packed.data_ptr(),
                        scales.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"quantize_pack launch failed: CUDA error {err}")
    count_launch("quantize_pack")
    return packed, scales


def dequantize_unpack_cuda(packed, scales, *, bits: int):
    """packed: (nblocks, block * bits // 8) int8, scales: (nblocks,) f32,
    both contiguous on one CUDA device. Returns (nblocks, block) f32."""
    nblocks, pb = packed.shape
    block = pb * 8 // bits
    check_codec_args(block, bits)
    if packed.device.type != "cuda" or scales.device != packed.device:
        raise ValueError("dequantize_unpack tensors must lie on one CUDA "
                         "device")
    if packed.dtype != torch.int8 or scales.dtype != torch.float32:
        raise ValueError("dequantize_unpack takes int8 codes and float32 "
                         "scales")
    if tuple(scales.shape) != (nblocks,):
        raise ValueError(f"scales must be ({nblocks},), got "
                         f"{tuple(scales.shape)}")
    if not (packed.is_contiguous() and scales.is_contiguous()):
        raise ValueError("dequantize_unpack takes contiguous tensors")
    out = torch.empty((nblocks, block), dtype=torch.float32,
                      device=packed.device)
    if nblocks == 0:
        return out
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream(packed.device).cuda_stream
        err = _fns()[1](packed.data_ptr(), scales.data_ptr(), nblocks, block,
                        bits, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"dequantize_unpack launch failed: CUDA error "
                           f"{err}")
    count_launch("dequantize_unpack")
    return out
