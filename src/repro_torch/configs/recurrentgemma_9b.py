"""recurrentgemma-9b — Griffin-style hybrid: RG-LRU + local attention 1:2 (attn:lru).
[arXiv:2402.19427]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,              # MQA in the local-attention blocks
    d_ff=12288,
    vocab=256000,
    head_dim=256,
    attn_window=2048,          # local attention window
    block_pattern=("rglru", "rglru", "attn"),
    source="arXiv:2402.19427",
)
