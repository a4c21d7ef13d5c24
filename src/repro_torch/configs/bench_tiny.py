"""Tiny dense LM (copy of the JAX package's `bench_tiny`): the CPU-tractable
arch the port's tests serve. ~4 layers x 96 dims."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(name="bench_tiny", family="dense", n_layers=4, d_model=96,
                     n_heads=4, n_kv_heads=2, d_ff=256, vocab=512,
                     compute_dtype="float32",
                     source="synthetic benchmark model (no external card)")
