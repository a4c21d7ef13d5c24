"""Continuous-batching serving of the port (counterpart of `repro/serve/`).

  cache   — slotted KV-cache state + host-side slot allocator
  engine  — ServeEngine: continuous batching vs lock-step baseline

The region router and the traffic generator are not ported yet: the router
needs the WAN simulator (`core/network.py`).
"""
from repro_torch.serve.cache import SlotManager, init_slot_state, reset_slot
from repro_torch.serve.engine import (CostModel, Request, RequestRecord,
                                      ServeEngine)

__all__ = [
    "SlotManager", "init_slot_state", "reset_slot",
    "CostModel", "Request", "RequestRecord", "ServeEngine",
]
