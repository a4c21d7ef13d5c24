"""PyTorch/CUDA port of the CoCoDC system (`src/repro/` is the JAX reference).

The layout mirrors `src/repro/`. The port imports torch, numpy and msgpack,
never JAX and nothing of `repro.*`; its hand-written Hopper kernels live in
`repro_torch.kernels`. Entry points run on CUDA unless given ``device="cpu"``.
"""
