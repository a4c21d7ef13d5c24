"""Slotted KV-cache management for the continuous-batching serving engine
(counterpart of `repro/serve/cache.py`).

The device side is a fixed pool of `n_slots` decode lanes over the models'
``(L, B, C, KV, hd)`` cache layout (`transformer.init_slot_cache`): every slot
carries its own ring-buffer position map (``kv_pos`` row, -1 = empty) and
decode position, plus the per-slot request registers the engine works with
(prompt buffer, generation counters). Shapes are fixed at construction;
admission and recycling rewrite one slot's registers in place.

The host side (`SlotManager`) is plain bookkeeping: which slots are free,
which request occupies which slot, and occupancy accounting.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import api


def init_slot_state(cfg: ModelConfig, n_slots: int, cache_len: int,
                    max_prompt: int, prefill_chunk: int, device=None) -> Dict:
    """Full device state of the slot plane: the slotted KV cache plus per-slot
    request registers. The prompt buffer is over-allocated by one chunk so a
    chunk window starting anywhere in [0, max_prompt] is in bounds."""
    st = api.init_slot_cache(cfg, n_slots, cache_len, device)

    def zeros(*shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device=device)

    st.update({
        "prompt": zeros(n_slots, max_prompt + prefill_chunk),
        "prompt_len": zeros(n_slots),
        "prefilled": zeros(n_slots),
        "active": zeros(n_slots, dtype=torch.bool),
        "last_tok": zeros(n_slots),
        "gen_count": zeros(n_slots),
        "gen_limit": zeros(n_slots),
    })
    return st


def reset_slot(state: Dict, slot: int, prompt, prompt_len: int,
               gen_limit: int) -> None:
    """Slot admission, in place. Clears the slot's ring-buffer map (stale K/V
    values stay: they are masked by kv_pos = -1 and overwritten as the new
    request fills the ring) and loads the request registers. `prompt`: the
    zero-padded (max_prompt + prefill_chunk,) prompt buffer."""
    state["kv_pos"][slot] = -1
    state["pos"][slot] = 0
    state["prompt"][slot] = torch.as_tensor(np.asarray(prompt, np.int32))
    state["prompt_len"][slot] = prompt_len
    state["prefilled"][slot] = 0
    state["active"][slot] = False
    state["last_tok"][slot] = 0
    state["gen_count"][slot] = 0
    state["gen_limit"][slot] = gen_limit


@dataclasses.dataclass
class SlotManager:
    """Host-side slot allocator: free-list + slot -> request-id map + occupancy
    tallies. Slots are recycled lowest-index-first so runs are deterministic."""
    n_slots: int
    free: List[int] = dataclasses.field(default_factory=list)
    owner: Dict[int, int] = dataclasses.field(default_factory=dict)
    # occupancy accounting: sum of occupied-slot counts over decode ticks
    occupied_ticks: int = 0
    decode_ticks: int = 0

    def __post_init__(self):
        if self.n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {self.n_slots}")
        if not self.free and not self.owner:
            self.free = list(range(self.n_slots))

    @property
    def n_free(self) -> int:
        return len(self.free)

    @property
    def occupied(self) -> List[int]:
        return sorted(self.owner)

    def acquire(self, rid: int) -> Optional[int]:
        """Claim the lowest free slot for request `rid`; None when full."""
        if not self.free:
            return None
        self.free.sort()
        slot = self.free.pop(0)
        self.owner[slot] = rid
        return slot

    def release(self, slot: int) -> int:
        """Return a slot to the pool; returns the evicted request id."""
        if slot not in self.owner:
            raise KeyError(f"slot {slot} is not occupied")
        rid = self.owner.pop(slot)
        self.free.append(slot)
        return rid

    def note_decode_tick(self, n_active: Optional[int] = None) -> None:
        """Record one decode dispatch; `n_active` is how many slots were
        generating (defaults to the occupied count)."""
        self.occupied_ticks += len(self.owner) if n_active is None else n_active
        self.decode_ticks += 1

    @property
    def mean_occupancy(self) -> float:
        """Mean generating fraction of the slot plane over decode ticks — the
        lever continuous batching pulls (every tick pays for all n_slots)."""
        if self.decode_ticks == 0:
            return 0.0
        return self.occupied_ticks / (self.decode_ticks * self.n_slots)
