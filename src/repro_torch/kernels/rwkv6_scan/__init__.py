from repro_torch.kernels.rwkv6_scan.ops import wkv_scan  # noqa: F401
