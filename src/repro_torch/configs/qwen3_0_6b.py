"""qwen3-0.6b — dense, qk-norm, GQA. [hf:Qwen/Qwen3-8B family card]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-0.6b",
    family="dense",
    n_layers=28,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=3072,
    vocab=151936,
    head_dim=128,              # qwen3 uses head_dim 128 (> d_model/n_heads)
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    long_decode_window=4096,   # long_500k sliding-window variant (DESIGN.md)
    source="hf:Qwen/Qwen3-8B",
)
