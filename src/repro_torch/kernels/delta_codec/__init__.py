from repro_torch.kernels.delta_codec.ops import (codec_roundtrip,  # noqa: F401
                                                 codec_roundtrip_array,
                                                 decode_array, encode_array,
                                                 wire_bytes)
