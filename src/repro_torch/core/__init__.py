"""CoCoDC core of the port (the paper's contribution; mirrors
`repro/core/`):

  tree         — parameter trees walked in JAX's pytree order
  fragments    — depth-wise model fragmentation
  flatplane    — the flat (rows, 1024) fragment plane
  outer_opt    — Nesterov outer optimizer on pseudo-gradients
  delay_comp   — Algorithm 1 (delay compensation) and Eq. 3 blending
  adaptive     — Algorithm 2 + Eqs. 9-12 (adaptive transmission scheduling)
  methods      — the sync-method registry
  network      — static WAN cost models (NetworkModel, Topology, scenarios)
  engine_state — device state + the initiate/deliver/diloco transitions
  protocol     — host wrapper: simulated wall-clock, channel queueing,
                 schedule, per-link stats
  trainer      — worker-stacked inner AdamW + the protocol engine
"""
