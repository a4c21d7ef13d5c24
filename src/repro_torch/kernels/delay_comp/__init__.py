from repro_torch.kernels.delay_comp.ops import delay_comp  # noqa: F401
