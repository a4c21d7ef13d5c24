from repro_torch.kernels.outer_update.ops import (fused_deliver,  # noqa: F401
                                                  outer_nesterov)
