from repro_torch.kernels.rms_norm.ops import rms_norm  # noqa: F401
