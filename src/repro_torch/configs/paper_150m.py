"""The paper's own experimental model: ~150M-param LLaMA-style decoder, 12 layers
(paper §IV-A), C4 LM task, seq 1024, global batch 256."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="paper-150m",
    family="dense",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=2048,
    vocab=32000,
    source="CoCoDC paper §IV-A (LLaMA-style, ~150M)",
)
