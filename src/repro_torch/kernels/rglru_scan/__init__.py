from repro_torch.kernels.rglru_scan.ops import lru_scan  # noqa: F401
