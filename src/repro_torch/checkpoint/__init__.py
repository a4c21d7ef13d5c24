from repro_torch.checkpoint.io import load_pytree, restore_like, save_pytree  # noqa: F401
