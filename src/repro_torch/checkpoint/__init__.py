from repro_torch.checkpoint.io import load_pytree  # noqa: F401
