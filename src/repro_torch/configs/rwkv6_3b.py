"""rwkv6-3b — RWKV-6 "Finch", attention-free, data-dependent decay. [arXiv:2404.05892]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=40,                # 2560 / head_dim 64
    n_kv_heads=40,
    d_ff=8960,
    vocab=65536,
    rwkv_head_dim=64,
    source="arXiv:2404.05892",
)
