"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero before the last line:
  1. the card's name and power limit (nvidia-smi);
  2. build of every kernel from the repo's sources (nvcc, Triton);
  3. each kernel against its plain PyTorch version on the card, at the
     serving path's shapes, with the tolerances stated in `max_err`;
  4. times (median of CUDA-event timings, L2 flushed before each launch):
     kernel, plain version, the bound (the larger of bytes over 3.35 TB/s
     and operations over the peak rate for their type) and one PyTorch
     library call as a yardstick only (the port never calls it);
  5. end to end: `repro_torch.launch.serve` at qwen3-0.6b full width, random
     weights from a seeded generator, bf16 compute, with every kernel launch
     counted;
  6. a torch.profiler trace of a short run: device busy share and the
     kernels that take the device's time;
  7. parity of the kernel path and the plain path at full width (f32:
     identical greedy tokens; bf16: agreement share and logit difference);
  8. the outer-update kernels (`nesterov_2d`, `deliver_2d` blend and
     compensate with one worker offline) and `delay_comp` (with and without
     the broadcast global leaf) against their plain versions at paper_150m's
     fragment shapes (M=4) and a small ragged one, with times; compensate
     and `delay_comp` also on operands where Algorithm 1's Taylor term
     exceeds the tolerance by over 1e3 (checked), so the comparison sees it;
  9. training at full width: `repro_torch.launch.train` on paper_150m
     (cocodc, streaming and diloco, all `--fused-updates`), step time,
     tokens/s, peak memory, eval NLL, stats, and exact launch counts;
 10. the per-leaf engine with dc_impl="kernel" against dc_impl="ref" on
     the paper_150m params stack, with its exact `delay_comp` launch count,
     and the host time of a delivering step in both layouts;
 11. a torch.profiler trace of full-width training steps;
 12. the wire-codec kernels (`quantize_pack`, `dequantize_unpack`, int8 and
     int4) against their plain versions, bitwise (`torch.equal` on codes,
     scales and decoded values), on paper_150m's fragment-0 plane at block
     256 and 130, an odd-row slice of it, ragged leaves, exact ties and a
     zero block, with times at block 256;
 13. compressed training at full width: paper_150m cocodc
     `--fused-updates --wire-codec int8`, paused at step 26 with `--ckpt`
     (the checkpoint written to a temporary directory: its size, write
     and read seconds, peak host memory), continued to 48; a fresh trainer
     resumed from the file to 48 must give identical stats and history and
     bitwise-equal params and engine planes; then streaming per-leaf
     `--wire-codec int4` for 24 steps; codec launches equal to the
     initiations (fused: one of each per initiation; per-leaf: one per
     leaf of each initiated fragment);
 14. serving from that fused checkpoint: `repro_torch.launch.serve --arch
     paper_150m --ckpt ...` at temperature 0.8, its params equal to the
     trainer's theta_g at step 26, and the host cost of the sampler's
     threefry Gumbel draw per token;
 15. parity of a full-width f32 training run with the int8 codec through
     the kernels with the same run through their plain versions (identical
     stats, NLL within 1e-4 relative);
 16. the scan kernels (`wkv_scan`, `lru_scan`) against their plain versions
     (rtol 1e-4, atol 1e-5 in f32, one bf16 ulp in bf16; `wkv_scan`'s final
     state and `lru_scan` at T = 1 bitwise) at rwkv6-3b's and
     recurrentgemma-9b's decode shapes (8 x 40 heads of 64 with a state;
     4 x 4096 with h0) and forward shapes (T = 512 and a ragged 300), with
     times at both;
 17. lock-step serving at full width: `repro_torch.launch.serve --arch
     rwkv6-3b --slots 8 --prompt-len 128 --gen-len 64`, random weights, bf16,
     prefill and decode tok/s, peak memory, exact `wkv_scan` and `rms_norm`
     launch counts, and a torch.profiler trace of a short run;
 18. the same for recurrentgemma-9b (`--slots 4 --gen-len 32`, exact
     `lru_scan` counts), after the earlier phases' memory is freed;
 19. parity at full width in f32 for both families: identical greedy
     tokens of the kernel path and the plain path (P=32, G=16), and
     `forward` with the scan kernels against the plain scans on a (4, 512)
     batch, within 1e-3 of the largest |h| (~35 chained scans and matmuls
     that sum in another order).
Then one JSON line with every kernel's numbers, and last
{"ok": true, "device": {...}}.

Needs CUDA and the repo's `src/`; it imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import resource
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12            # H100 SXM data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
BF16_ULP = 2.0 ** -7
DEVICE = "cuda"
QWEN3_ARGS = ["--arch", "qwen3-0.6b", "--mode", "continuous", "--slots", "8",
              "--requests", "16", "--prompt-len", "256", "--gen-len", "64",
              "--prefill-chunk", "64", "--cache-len", "512",
              "--temperature", "0", "--seed", "0", "--device", "cuda"]


def log(msg):
    print(msg, flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def max_err(got, want, dtype, rtol=1e-5):
    """Max |got - want|, after checking the stated tolerance: f32 at
    atol = 1e-5 and `rtol` (1e-5 for reduction order; the scans take the
    JAX package's 1e-4 for them); bf16 at one bf16 ulp of each element plus
    1e-5 of the tensor's magnitude."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    if dtype == torch.float32:
        tol = 1e-5 + rtol * want.abs()
    else:
        tol = BF16_ULP * want.abs() + 1e-5 * want.abs().max()
    check(bool((err <= tol).all()),
          f"kernel disagrees with plain version: max err {err.max().item()}")
    return err.max().item()


class Timer:
    """Median CUDA-event time of one call, L2 (50 MB) flushed before each."""

    def __init__(self, dev):
        self.flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)

    def __call__(self, fn, iters=30, warmup=3):
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(iters):
            self.flush.zero_()
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        return statistics.median(times)


def bound_ms(nbytes, flops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# rms_norm
# ---------------------------------------------------------------------------


RMS_SHAPES = {                      # qwen3-0.6b serving path, 8 slots
    "decode ln (8,1024)": (8, 1024),
    "decode q-norm (8*16,128)": (128, 128),
    "decode k-norm (8*8,128)": (64, 128),
    "prefill ln (64,1024)": (64, 1024),
}


def rms_norm_phase(dev, timer):
    import torch.nn.functional as F
    from repro_torch.kernels.rms_norm.ops import rms_norm
    from repro_torch.kernels.rms_norm.ref import rms_norm_ref
    gen = torch.Generator(dev).manual_seed(0)
    err, rows = 0.0, {}
    for dtype in (torch.bfloat16, torch.float32):
        for name, (R, D) in RMS_SHAPES.items():
            x = torch.randn(R, D, generator=gen, device=dev).to(dtype)
            w = (torch.rand(D, generator=gen, device=dev) + 0.5).to(dtype)
            got = rms_norm(x, w, 1e-6)
            torch.cuda.synchronize()
            err = max(err, max_err(got, rms_norm_ref(x, w, 1e-6), dtype))
            if dtype != torch.bfloat16:
                continue              # the path runs bf16; time that
            nbytes = 2 * x.numel() * x.element_size() + w.numel() * w.element_size()
            b, by = bound_ms(nbytes, 4 * R * D, torch.float32)
            rows[name] = {
                "ms": timer(lambda: rms_norm(x, w, 1e-6)),
                "plain_ms": timer(lambda: rms_norm_ref(x, w, 1e-6)),
                "library_ms": timer(lambda: F.rms_norm(x, (D,), w, 1e-6)),
                "bound_ms": b, "bound_by": by}
    log(f"rms_norm: kernel == plain at {list(RMS_SHAPES.values())} in bf16 "
        f"and f32, max abs err {err:.3g}")
    for name, r in rows.items():
        log(f"  time bf16 {name}: " + json.dumps(r))
    return err, rows["decode ln (8,1024)"]


# ---------------------------------------------------------------------------
# flash_decode
# ---------------------------------------------------------------------------


def ragged_positions(B, C, gen, dev, empty_row=True):
    """Per-slot ring maps like the slot plane's: each slot at its own depth,
    holes from recycling, one wrapped ring, and (optionally) an empty slot."""
    pos = torch.full((B, C), -1, dtype=torch.int32)
    qpos = torch.zeros(B, dtype=torch.int32)
    for b in range(B - 1 if empty_row else B):
        n = int(torch.randint(C // 4, C + C // 2, (1,), generator=gen))
        p = torch.arange(max(0, n - C), n, dtype=torch.int32)
        keep = torch.rand(p.shape, generator=gen) > 0.05       # holes
        pos[b, (p[keep] % C).long()] = p[keep]
        qpos[b] = n - 1
    return pos.to(dev), qpos.to(dev)


def valid_keys(pos, qpos, window):
    v = (pos >= 0) & (pos <= qpos[:, None])
    if window is not None:
        v &= (qpos[:, None] - pos) < window
    return int(v.sum())


def flash_decode_phase(dev, timer):
    import torch.nn.functional as F
    from repro_torch.kernels.flash_decode.ops import flash_decode
    from repro_torch.kernels.flash_decode.ref import flash_decode_ref
    gen = torch.Generator().manual_seed(1)
    err, rows = 0.0, {}
    cases = [  # (name, B, KV, G, hd, C, window, timed)
        ("qwen3 C=1024", 8, 8, 2, 128, 1024, None, False),
        ("qwen3 C=1024 window=256", 8, 8, 2, 128, 1024, 256, False),
        ("paper_150m C=1024", 8, 12, 1, 64, 1024, None, False),
        ("qwen3 serving C=512", 8, 8, 2, 128, 512, None, True),
    ]
    for name, B, KV, G, hd, C, window, timed in cases:
        for dtype in (torch.bfloat16, torch.float32):
            q = torch.randn(B, KV * G, hd, generator=gen).to(dev, dtype)
            # a layer of the (L, B, C, KV, hd) cache, read through strides
            k = torch.randn(2, B, C, KV, hd, generator=gen).to(dev, dtype)[1]
            v = torch.randn(2, B, C, KV, hd, generator=gen).to(dev, dtype)[1]
            pos, qpos = ragged_positions(B, C, gen, dev, empty_row=not timed)
            got = flash_decode(q, k, v, pos, qpos, window=window)
            torch.cuda.synchronize()
            err = max(err, max_err(got, flash_decode_ref(
                q, k, v, pos, qpos, window=window), dtype))
            if not timed:
                check(not got[-1].any(), "empty slot must give 0")
            if not timed or dtype != torch.bfloat16:
                continue
            nv = valid_keys(pos, qpos, window)
            es = q.element_size()
            nbytes = (2 * q.numel() * es + 2 * nv * KV * hd * es
                      + pos.numel() * 4 + qpos.numel() * 4)
            b, by = bound_ms(nbytes, 4 * nv * KV * G * hd, dtype)
            # yardstick: SDPA over head-major copies (made outside the timing)
            qs = q[:, :, None, :]
            ks, vs = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
            mask = ((pos >= 0) & (pos <= qpos[:, None]))[:, None, None, :]
            rows[name] = {
                "ms": timer(lambda: flash_decode(q, k, v, pos, qpos)),
                "plain_ms": timer(lambda: flash_decode_ref(q, k, v, pos, qpos)),
                "library_ms": timer(lambda: F.scaled_dot_product_attention(
                    qs, ks, vs, attn_mask=mask, enable_gqa=True)),
                "bound_ms": b, "bound_by": by, "valid_keys": nv}
    log(f"flash_decode: kernel == plain at {[c[0] for c in cases]} in bf16 "
        f"and f32 (ragged positions, holes, empty row), max abs err "
        f"{err:.3g}")
    for name, r in rows.items():
        log(f"  time bf16 {name}: " + json.dumps(r))
    return err, rows["qwen3 serving C=512"]


# ---------------------------------------------------------------------------
# end to end and parity
# ---------------------------------------------------------------------------


def serve_phase():
    from repro_torch import kernels
    from repro_torch.launch import serve
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    eng = serve.run(QWEN3_ARGS)
    launches = kernels.launch_counts()
    s = eng.stats()
    cfg = eng.cfg
    log(f"serve qwen3-0.6b: completed {s['completed']}/16, "
        f"{s['total_tokens']} tokens in {s['wall_s']:.3f} s wall = "
        f"{s['total_tokens'] / s['wall_s']:.1f} tok/s; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log("  virtual-clock stats: " + json.dumps(s))
    log(f"  launches: {launches}")
    check(s["completed"] == 16, "not every request completed")
    for rec in eng.completed:
        check(len(rec.tokens) == rec.max_new, f"req {rec.rid} short")
        check(all(0 <= t < cfg.vocab for t in rec.tokens), "token id range")
    per_pass = 4 * cfg.n_layers + 1           # ln1, q-norm, k-norm, ln2; final
    check(launches["flash_decode"] == s["decode_dispatches"] * cfg.n_layers,
          "flash_decode launches != decode dispatches x layers")
    check(launches["rms_norm"] == per_pass * (s["decode_dispatches"]
                                              + s["prefill_dispatches"]),
          "rms_norm launches != (decode + prefill dispatches) x (4L + 1)")
    return launches


def profile_phase():
    """Where the serving time goes: a torch.profiler trace of a short qwen3
    run (8 requests, 16 new tokens); device busy share = summed kernel time
    over the wall time, and the kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.serve import ServeEngine
    args = serve.parse_args(QWEN3_ARGS + ["--requests", "8",
                                          "--gen-len", "16"])
    cfg = get_config("qwen3-0.6b")
    eng = ServeEngine(cfg, serve.load_params(cfg, None, DEVICE), n_slots=8,
                      cache_len=512, max_prompt=256, prefill_chunk=64,
                      device=DEVICE)
    reqs = serve.make_requests(cfg, args)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.run_trace(reqs)
        wall = time.perf_counter() - t0
    # kernel events only: an op's self device time repeats its kernels'
    ev = [e for e in prof.key_averages()
          if str(e.device_type).endswith("CUDA")
          and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in ev)
    top = sorted(ev, key=lambda e: -e.self_device_time_total)[:8]
    s = eng.stats()
    log(f"profile qwen3 8 req x <=16 tok: wall {wall:.3f} s, "
        f"{s['decode_dispatches']} decode + {s['prefill_dispatches']} "
        f"prefill dispatches; device busy {busy_us / 1e6:.3f} s = "
        f"{busy_us / 1e6 / wall:.1%} of wall")
    for e in top:
        log(f"  {e.self_device_time_total / 1e3:9.2f} ms  {e.count:6d}x  "
            f"{e.key[:90]}")


def parity_phase():
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import api
    from repro_torch.serve import ServeEngine
    args = serve.parse_args(QWEN3_ARGS + ["--requests", "4"])
    kw = dict(n_slots=8, cache_len=512, max_prompt=256, prefill_chunk=64,
              device=DEVICE)

    def tokens(cfg, params, impl):
        eng = ServeEngine(cfg, params, impl=impl, **kw)
        reqs = serve.make_requests(cfg, args)
        return [r.tokens for r in sorted(eng.run_trace(reqs),
                                         key=lambda r: r.rid)]

    base = get_config("qwen3-0.6b")
    f32 = dataclasses.replace(base, compute_dtype="float32")
    params = serve.load_params(f32, None, DEVICE, seed=1)
    a, b = tokens(f32, params, "auto"), tokens(f32, params, "ref")
    check(a == b, "f32 greedy tokens: kernel path != plain path")
    log(f"parity f32 full width: kernel path == plain path on "
        f"{sum(map(len, a))} greedy tokens of 4 requests")

    a, b = tokens(base, params, "auto"), tokens(base, params, "ref")
    same = sum(x == y for ra, rb in zip(a, b) for x, y in zip(ra, rb))
    # logits of a decode step once every request has its first token, both
    # paths on one state
    eng = ServeEngine(base, params, **kw)
    for r in serve.make_requests(base, args):
        eng.submit(r)
    while not all(rec.first_tok_s is not None
                  for rec in eng.records.values()):
        eng.tick()
    st = eng.state
    out = {}
    for impl in ("auto", "ref"):
        kv = {k: st[k].clone() for k in ("k", "v", "kv_pos", "pos")}
        out[impl], _ = api.decode_step_slotted(
            base, eng.params, kv, st["last_tok"], active=st["active"],
            impl=impl)
    rows = st["active"]
    diff = (out["auto"][rows] - out["ref"][rows]).abs().max().item()
    log(f"parity bf16 full width: {same}/{sum(map(len, a))} greedy tokens "
        f"agree; decode step (every request past its first token) max |logit diff| {diff:.4g} "
        f"(max |logit| {out['ref'][rows].abs().max().item():.4g})")
    check(torch.isfinite(out["auto"][rows]).all().item(), "non-finite logits")


# ---------------------------------------------------------------------------
# training slice: outer-update and delay-comp kernels
# ---------------------------------------------------------------------------


PAPER_TRAIN_ARGS = ["--arch", "paper_150m", "--workers", "4", "--fragments",
                    "4", "--H", "24", "--tau", "8", "--local-batch", "8",
                    "--seq-len", "256", "--device", "cuda"]
F32 = 4


def plane_err(got, want):
    """Max |got - want| after checking the stated tolerance of the
    outer-update kernels: allclose at rtol 1e-5, atol 1e-6 (the kernels
    round every operation in the plain version's order; the slack covers
    the card's and the CPU's elementwise libraries)."""
    err = (got.float() - want.float()).abs()
    check(bool((err <= 1e-6 + 1e-5 * want.float().abs()).all()),
          f"kernel disagrees with plain version: max err {err.max().item()}")
    return err.max().item()


# Algorithm 1's scalars at which, with operands O(1) apart, the Taylor term
# tau * lam * gr^2 * (g - s) / H is O(0.1-1) and dominates the tolerance;
# at parameter-like magnitudes it is ~1e-11 and no comparison can see it
COMP_KW = dict(lam=2.0, H=3.0, sign=-1.0)      # with tau = 2 on the device


def term_ratio(full, without):
    """Median over elements of Algorithm 1's Taylor term (`full` less the
    same call at lam=0) over the outer-update tolerance; checked above 1e3,
    so a kernel that drops or mis-scales the term fails `plane_err`."""
    full, without = full.float(), without.float()
    ratio = ((full - without).abs()
             / (1e-6 + 1e-5 * full.abs())).median().item()
    check(ratio > 1e3, f"compensation term too small to check: {ratio}")
    return ratio


def paper_fragment_rows():
    """paper_150m's K=4 strided fragment row counts (shapes only)."""
    from repro_torch.configs import get_config
    from repro_torch.core.fragments import make_fragmenter
    from repro_torch.models import api
    cfg = get_config("paper_150m")
    frag = make_fragmenter(cfg, api.param_specs(cfg), 4)
    return frag, [frag.flat.rows(p) for p in range(4)]


def outer_update_phase(dev, timer):
    from repro_torch.kernels.delay_comp.ops import delay_comp_array
    from repro_torch.kernels.delay_comp.ref import delay_comp_ref
    from repro_torch.kernels.outer_update.ops import (fused_deliver,
                                                      outer_nesterov)
    from repro_torch.kernels.outer_update.ref import deliver_ref, nesterov_ref
    frag, rows = paper_fragment_rows()
    gen = torch.Generator(dev).manual_seed(2)
    M = 4
    lr, mu = 0.7, 0.9
    kw = dict(tau=torch.tensor(8.0, device=dev), lam=0.5, H=24.0, sign=1.0)
    errs = {"nesterov_2d": 0.0, "deliver_2d": 0.0, "delay_comp": 0.0}
    times = {}

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    cases = [("fragment 0", rows[0], True), ("fragment 2", rows[2], False),
             ("ragged 37 rows", 37, False)]
    for name, R, timed in cases:
        theta = rnd(R, 1024, scale=0.02)
        mom, delta = rnd(R, 1024, scale=1e-3), rnd(R, 1024, scale=1e-3)
        got = outer_nesterov(theta, mom, delta, lr=lr, mu=mu)
        torch.cuda.synchronize()
        want = nesterov_ref(theta, mom, delta, lr=lr, mu=mu)
        errs["nesterov_2d"] = max(errs["nesterov_2d"], plane_err(got[0], want[0]),
                                  plane_err(got[1], want[1]))
        g = theta + rnd(R, 1024, scale=1e-3)
        local = theta[None] + rnd(M, R, 1024, scale=1e-3)
        snap = theta[None] + rnd(M, R, 1024, scale=1e-3)
        if not timed:
            # the engine's snapshot is a row slice of the full-model plane:
            # its worker axis is strided
            full = torch.zeros(M, R + 9, 1024, device=dev)
            full[:, 5:5 + R] = snap
            snap = full[:, 5:5 + R]
        avail = torch.tensor([True, False, True, True], device=dev)
        for mode, extra in (("blend", {"alpha": 0.5}), ("compensate", kw)):
            s = snap if mode == "compensate" else None
            got = fused_deliver(local, s, g, avail, mode=mode, **extra)
            torch.cuda.synchronize()
            want = deliver_ref(local, s, g, avail, mode=mode, **extra)
            errs["deliver_2d"] = max(errs["deliver_2d"], plane_err(got, want))
            check(torch.equal(got[1], local[1]), "offline worker changed")
        if not timed:
            continue
        plane = R * 1024 * F32
        b, by = bound_ms(5 * plane, 6 * R * 1024, torch.float32)
        times["nesterov_2d"] = {
            "ms": timer(lambda: outer_nesterov(theta, mom, delta, lr=lr,
                                               mu=mu)),
            "plain_ms": timer(lambda: nesterov_ref(theta, mom, delta, lr=lr,
                                                   mu=mu)),
            "bound_ms": b, "bound_by": by, "library_ms": None}
        b, by = bound_ms((3 * M + 1) * plane, 11 * M * R * 1024,
                         torch.float32)
        times["deliver_2d"] = {
            "ms": timer(lambda: fused_deliver(local, snap, g, avail,
                                              mode="compensate", **kw)),
            "plain_ms": timer(lambda: deliver_ref(local, snap, g, avail,
                                                  mode="compensate", **kw)),
            "bound_ms": b, "bound_by": by, "library_ms": None}
        b, by = bound_ms((2 * M + 1) * plane, 3 * M * R * 1024,
                         torch.float32)
        times["deliver_2d blend"] = {
            "ms": timer(lambda: fused_deliver(local, None, g, avail,
                                              mode="blend", alpha=0.5)),
            "plain_ms": timer(lambda: deliver_ref(local, None, g, avail,
                                                  mode="blend", alpha=0.5)),
            "library_ms": timer(lambda: torch.lerp(local, g[None], 0.5)),
            "bound_ms": b, "bound_by": by}
    # compensate where the Taylor term dominates: operands O(1) apart
    ckw = dict(tau=torch.tensor(2.0, device=dev), **COMP_KW)
    ratios = []
    for R in (rows[2], 37):
        theta = rnd(R, 1024, scale=0.02)
        g = theta + rnd(R, 1024)
        local, snap = theta[None] + rnd(M, R, 1024), theta[None] + rnd(M, R,
                                                                      1024)
        avail = torch.tensor([True, True, False, True], device=dev)
        got = fused_deliver(local, snap, g, avail, mode="compensate", **ckw)
        torch.cuda.synchronize()
        want = deliver_ref(local, snap, g, avail, mode="compensate", **ckw)
        errs["deliver_2d"] = max(errs["deliver_2d"], plane_err(got, want))
        ratios.append(term_ratio(want[avail], deliver_ref(
            local, snap, g, avail, mode="compensate",
            **{**ckw, "lam": 0.0})[avail]))
        check(torch.equal(got[2], local[2]), "offline worker changed")
        del theta, g, local, snap, got, want
    # delay_comp at the per-leaf engine's shapes: fragment 0's largest leaf
    # (global leaf broadcast from (1, ...)), a norm leaf, a ragged leaf;
    # at parameter-like magnitudes (`dkw`) and where the term dominates
    biggest = max(frag.flat.chunks(0), key=lambda c: c.size)
    leaf_cases = [(f"fragment 0 {biggest.path} broadcast",
                   (M,) + biggest.shape, True, True),
                  (f"fragment 0 {biggest.path}", (M,) + biggest.shape, False,
                   False),
                  ("ln rows (3, 768) broadcast", (M, 3, 768), True, False),
                  ("ragged (5, 36) broadcast", (M, 5, 36), True, False),
                  ("ragged (5, 33)", (M, 5, 33), False, False)]
    dkw = dict(tau=torch.tensor(8.0, device=dev), lam=0.5, H=24.0, sign=1.0)
    for name, shape, bcast, timed in leaf_cases:
        gshape = (1,) + shape[1:] if bcast else shape
        tp = rnd(*shape, scale=0.02)
        base = tp[:1] if bcast else tp
        for kw_, spread in ((dkw, 1e-3), (ckw, 1.0)):
            tl = tp + rnd(*shape, scale=spread)
            tg = base + rnd(*gshape, scale=spread)
            got = delay_comp_array(tl, tp, tg, **kw_)
            torch.cuda.synchronize()
            want = delay_comp_ref(tl, tp, tg, **kw_)
            errs["delay_comp"] = max(errs["delay_comp"], plane_err(got, want))
        ratios.append(term_ratio(want, delay_comp_ref(
            tl, tp, tg, **{**ckw, "lam": 0.0})))
        del got, want
        if not timed:
            continue
        n, ng = tl.numel(), tg.numel()
        b, by = bound_ms((3 * n + ng) * F32, 11 * n, torch.float32)
        times["delay_comp"] = {
            "ms": timer(lambda: delay_comp_array(tl, tp, tg, **dkw)),
            "plain_ms": timer(lambda: delay_comp_ref(tl, tp, tg, **dkw)),
            "bound_ms": b, "bound_by": by, "library_ms": None,
            "shape": list(shape)}
    try:
        odd = rnd(M, 3, 97)
        delay_comp_array(odd, odd, odd[:1], **dkw)
        check(False, "delay_comp took a leaf of 3 * 97 elements")
    except ValueError:
        pass
    log(f"outer_update / delay_comp: kernel == plain at paper_150m fragment "
        f"rows {rows[0]} and {rows[2]} (M=4, one worker offline; strided "
        f"snapshot at fragment 2 and 37 rows), 37 rows, "
        f"and leaves {[c[0] for c in leaf_cases]}; compensate and delay_comp "
        f"again with operands O(1) apart, {COMP_KW} tau 2: Taylor term over "
        f"tolerance, median {min(ratios):.3g}x at least; "
        f"max abs err {errs}")
    for name, r in times.items():
        log(f"  time f32 {name}: " + json.dumps(r))
    return errs, times


def train_phase(method, steps, eval_every):
    """One full-width training run through the CLI entry point, with its
    launch counts. Returns (trainer, launches)."""
    from repro_torch import kernels
    from repro_torch.launch import train
    argv = PAPER_TRAIN_ARGS + ["--method", method, "--fused-updates",
                               "--steps", str(steps), "--eval-every",
                               str(eval_every)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    tr = train.run(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    s = tr.engine.stats()
    M, B, S = (tr.ccfg.num_workers, tr.tcfg.local_batch, tr.tcfg.seq_len)
    toks = steps * M * B * S
    nlls = [r["nll"] for r in tr.history]
    train_s = tr.run_seconds - tr.eval_seconds
    log(f"train paper_150m {method} --fused-updates: {steps} steps in "
        f"{wall:.3f} s wall ({wall - tr.run_seconds:.3f} s building, "
        f"{tr.eval_seconds:.3f} s evals): "
        f"{train_s / steps * 1e3:.1f} ms/step, {toks / train_s:.0f} "
        f"tokens/s (synchronised, build and evals excluded); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; eval NLL "
        f"{nlls}")
    log("  stats: " + json.dumps(s))
    log(f"  launches: {launches}")
    check(all(np.isfinite(nlls)), "non-finite eval NLL")
    deliveries = int(s["n_syncs"]) - len(tr.engine.pending)
    check(deliveries > 0, "no delivery in the run")
    check(launches["nesterov_2d"] == deliveries == launches["deliver_2d"],
          f"nesterov_2d {launches['nesterov_2d']} / deliver_2d "
          f"{launches['deliver_2d']} launches != deliveries {deliveries}")
    check(launches["rms_norm"] == 0 and launches["flash_decode"] == 0,
          "a kernel without a backward ran on the training path")
    return tr, launches


def training_phases():
    """cocodc (compensate), streaming (blend) and diloco (nesterov + blend
    at alpha=1 per round), each read with the counts reset just before."""
    tr, launches = train_phase("cocodc", 48, 24)
    nlls = [r["nll"] for r in tr.history]
    # random init: logits ~ N(0, 1), NLL ~ ln 32000 + 1/2
    uniform = math.log(32000)
    check(abs(nlls[0] - uniform) < 1.5 and nlls[-1] < nlls[0],
          f"eval NLL did not fall from ~ln 32000 = {uniform:.2f}: {nlls}")
    total = dict(launches)
    del tr
    for method in ("streaming", "diloco"):
        tr, launches = train_phase(method, 24, 12)
        for k in total:
            total[k] += launches[k]
        del tr
    torch.cuda.empty_cache()
    return total


def per_leaf_phase(dev, arch="paper_150m"):
    """The per-leaf engine with dc_impl="kernel" (the delay_comp kernel per
    leaf) against dc_impl="ref": `ProtocolEngine`s on the same paper_150m
    params stack (M=4, calibrated paper network), driven step by step
    through their cocodc schedule on identically perturbed params, with the
    fused engine beside them to time one delivery in each layout."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.configs.base import CoCoDCConfig
    from repro_torch.core.fragments import make_fragmenter
    from repro_torch.core.network import paper_network
    from repro_torch.core.protocol import ProtocolEngine
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.models import api
    cfg = get_config(arch)
    M, K = 4, 4
    ccfg = CoCoDCConfig(num_workers=M, local_steps=24, num_fragments=K,
                        overlap_depth=8)
    gen = torch.Generator(dev).manual_seed(3)
    params = api.init_params(cfg, gen, dev)
    frag = make_fragmenter(cfg, api.param_specs(cfg), K)
    net = paper_network(M, fragment_bytes=frag.total_bytes // K, tau=8)
    stacks, engines = {}, {}
    for name, dc, fused in (("kernel", "kernel", False), ("ref", "ref", False),
                            ("fused", "ref", True)):
        stacks[name] = tree_map(
            lambda a: a[None].repeat((M,) + (1,) * a.dim()), params)
        engines[name] = ProtocolEngine(
            "cocodc", dataclasses.replace(ccfg, fused_updates=fused), frag,
            net, stacks[name], dc_impl=dc)
    del params
    expected, launched, delivered = 0, 0, []
    deliver_ms = {name: [] for name in engines}
    for t in range(30):
        noise = [torch.randn(leaf.shape, generator=gen, device=dev) * 1e-3
                 for leaf in tree_leaves(stacks["ref"])]
        for name in stacks:
            for leaf, n in zip(tree_leaves(stacks[name]), noise):
                leaf.add_(n)
        due = [ev.frag for ev in engines["kernel"].pending
               if ev.deliver_at <= t]
        delivered += [(t, p) for p in due]
        expected += sum(len(frag.leaves_in(p)) for p in due)
        for name in stacks:
            if name == "kernel":
                kernels.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            stacks[name] = engines[name].on_step_end(t, stacks[name])
            torch.cuda.synchronize()
            if due:
                deliver_ms[name].append((time.perf_counter() - t0) * 1e3)
            if name == "kernel":
                n = kernels.launch_counts()["delay_comp"]
                check(n == sum(len(frag.leaves_in(p)) for p in due),
                      f"delay_comp launches {n} at step {t}")
                launched += n
    stats = {name: e.stats() for name, e in engines.items()}
    check(stats["kernel"] == stats["ref"] == stats["fused"],
          "the engines' schedules differ")
    err = max(plane_err(a, b) for a, b in zip(tree_leaves(stacks["kernel"]),
                                               tree_leaves(stacks["ref"])))
    log(f"per-leaf engine dc_impl=kernel vs ref, paper_150m M=4, 30 steps, "
        f"(step, fragment) delivered {delivered}: params max abs err "
        f"{err:.3g}; delay_comp launches {launched} (= leaves of the "
        f"delivered fragments, {expected})")
    log("  host ms of each delivering step (synchronised), per-leaf kernel, "
        "per-leaf plain, fused kernels: " + json.dumps(
            {name: [round(x, 3) for x in v]
             for name, v in deliver_ms.items()}))
    check(delivered, "no delivery in the per-leaf phase")
    del stacks, engines
    torch.cuda.empty_cache()
    return {"delay_comp": launched}, err


def train_profile_phase():
    """Where the full-width training time goes: a torch.profiler trace of 6
    cocodc fused steps (after 6 warm-up steps) spanning a protocol event."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.api import build_experiment
    from repro_torch.launch import train
    args = train.make_parser().parse_args(
        PAPER_TRAIN_ARGS + ["--method", "cocodc", "--fused-updates",
                            "--steps", "48", "--eval-every", "1000"])
    tr = build_experiment(train.spec_from_args(args).validate(),
                          device=DEVICE)
    tr.run(steps=6, eval_every=1000)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr.run(steps=12, eval_every=1000)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ev = [e for e in prof.key_averages()
          if str(e.device_type).endswith("CUDA")
          and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in ev)
    top = sorted(ev, key=lambda e: -e.self_device_time_total)[:10]
    log(f"profile paper_150m cocodc fused, steps 6-11: wall {wall:.3f} s "
        f"({wall / 6 * 1e3:.1f} ms/step under the profiler); device busy "
        f"{busy_us / 1e6:.3f} s ({busy_us / 6e3:.1f} ms/step) = "
        f"{busy_us / 1e6 / wall:.1%} of wall")
    for e in top:
        log(f"  {e.self_device_time_total / 1e3:9.2f} ms  {e.count:6d}x  "
            f"{e.key[:90]}")
    del tr
    torch.cuda.empty_cache()


def train_parity_phase():
    """A full-width f32 cocodc fused run with the int8 wire codec through
    the kernels against the same run through their plain versions
    (make_engine_fns(..., kernel_impl="ref")): identical
    stats, NLL within 1e-4 relative."""
    from repro_torch.api import build_experiment
    from repro_torch.launch import train
    args = train.make_parser().parse_args(
        PAPER_TRAIN_ARGS + ["--method", "cocodc", "--fused-updates",
                            "--wire-codec", "int8", "--steps", "24",
                            "--eval-every", "12"])
    spec = train.spec_from_args(args).validate()
    spec = dataclasses.replace(spec, model=dataclasses.replace(
        spec.model, compute_dtype="float32"))
    hist = {}
    for impl in ("auto", "ref"):
        tr = build_experiment(spec, device=DEVICE, kernel_impl=impl)
        hist[impl] = tr.run(eval_every=12)
        del tr
        torch.cuda.empty_cache()
    worst = 0.0
    for a, b in zip(hist["auto"], hist["ref"]):
        sa = {k: v for k, v in a.items()
              if k not in ("train_loss", "nll", "ppl")}
        sb = {k: v for k, v in b.items()
              if k not in ("train_loss", "nll", "ppl")}
        check(sa == sb, f"stats differ at step {a['step']}: {sa} vs {sb}")
        worst = max(worst, abs(a["nll"] - b["nll"]) / abs(b["nll"]))
    log(f"parity f32 full-width training (cocodc fused, int8 codec, 24 "
        f"steps): kernel "
        f"path stats == plain path stats; eval NLL "
        f"{[r['nll'] for r in hist['auto']]} vs "
        f"{[r['nll'] for r in hist['ref']]}, max rel diff {worst:.3g}")
    check(worst <= 1e-4, f"f32 NLL differs by {worst} relative")


# ---------------------------------------------------------------------------
# wire codec: kernels, compressed training, checkpoint/resume, serving
# ---------------------------------------------------------------------------


CODEC_BITS = {"int8": 8, "int4": 4}
INT8_ARGS = PAPER_TRAIN_ARGS + ["--method", "cocodc", "--fused-updates",
                                "--wire-codec", "int8", "--steps", "48",
                                "--eval-every", "24"]
# int8 payloads cross the calibrated network in 3 steps (raw ones in ~8), so
# at step 24 no transfer is in flight; at 26 the step-24 initiation is
KILL = 26


def tie_blocks(block, levels, dev):
    """Blocks whose elements sit exactly on half-integer codes: absmax =
    levels * 2^-6 makes the scale 2^-6 exactly (f32(levels) *
    f32(1/levels) == 1), so x / scale = k + 0.5 with no rounding."""
    e = 2.0 ** -6
    k = torch.arange(block, dtype=torch.float64) % (2 * levels) - levels
    t = ((k + 0.5) * e).float()
    t[0] = levels * e
    return torch.stack([t, -t, torch.zeros(block), t * 4]).to(dev)


def codec_phase(dev, timer):
    """Both codec kernels against their plain versions, bitwise, at the
    main path's shapes and the edge cases; times at block 256 on paper_150m
    fragment 0's plane (the fused engine's operand). Returns the largest
    |kernel - plain| of each kernel over all cases (codes as integers,
    scales, decoded values) and the times."""
    from repro_torch.kernels.delta_codec.ops import decode_array, encode_array
    _, rows = paper_fragment_rows()
    gen = torch.Generator(dev).manual_seed(4)
    plane = torch.randn(rows[0], 1024, generator=gen, device=dev) * 1e-3
    plane[7, 256:512] = 0.0                     # block 29: all zero
    leaf = torch.randn(3, 1000, 77, generator=gen, device=dev) * 1e-2
    times = {}
    err = {"quantize_pack": 0.0, "dequantize_unpack": 0.0}

    def gap(a, b):
        return (a.to(torch.float64) - b.to(torch.float64)).abs().max().item()

    for codec, bits in CODEC_BITS.items():
        levels = 127 if bits == 8 else 7
        cases = [("fragment 0 plane", plane, 256),
                 ("fragment 0 plane, block 130", plane, 130),
                 ("odd-row slice [5:3006]", plane[5:3006], 256),
                 ("ragged leaf (3, 1000, 77)", leaf, 256),
                 ("ragged leaf (5, 33), block 130", leaf[0, :5, :33], 130),
                 ("ties", tie_blocks(256, levels, dev), 256),
                 ("ties, block 130", tie_blocks(130, levels, dev), 130)]
        for name, x, block in cases:
            kw = dict(codec=codec, block=block)
            p, s = encode_array(x, **kw)
            torch.cuda.synchronize()
            pr, sr = encode_array(x, impl="ref", **kw)
            err["quantize_pack"] = max(err["quantize_pack"], gap(p, pr),
                                       gap(s, sr))
            check(torch.equal(p, pr) and torch.equal(s, sr),
                  f"{codec} encode != plain on {name}")
            d = decode_array(p, s, x.shape, x.dtype, **kw)
            torch.cuda.synchronize()
            dr = decode_array(pr, sr, x.shape, x.dtype, impl="ref", **kw)
            err["dequantize_unpack"] = max(err["dequantize_unpack"],
                                           gap(d, dr))
            check(torch.equal(d, dr), f"{codec} decode != plain on {name}")
            if name == "fragment 0 plane":
                check(s[29].item() == 0 and not d[7, 256:512].any(),
                      "the zero block must give scale 0 and zeros")
        n = plane.numel()
        nblocks = n // 256
        nbytes = 4 * n + n * bits // 8 + 4 * nblocks
        p, s = encode_array(plane, codec=codec, block=256)
        kw = dict(codec=codec, block=256)
        enc_b, enc_by = bound_ms(nbytes, 5 * n, torch.float32)
        dec_b, dec_by = bound_ms(nbytes, 2 * n, torch.float32)
        times[codec] = {
            "quantize_pack": {
                "ms": timer(lambda: encode_array(plane, **kw)),
                "plain_ms": timer(lambda: encode_array(plane, impl="ref",
                                                       **kw)),
                "bound_ms": enc_b, "bound_by": enc_by, "library_ms": None},
            "dequantize_unpack": {
                "ms": timer(lambda: decode_array(p, s, plane.shape,
                                                 plane.dtype, **kw)),
                "plain_ms": timer(lambda: decode_array(
                    p, s, plane.shape, plane.dtype, impl="ref", **kw)),
                "bound_ms": dec_b, "bound_by": dec_by, "library_ms": None}}
    log(f"delta_codec: quantize_pack and dequantize_unpack == plain "
        f"bitwise (codes, scales, decoded) in int8 and int4 on paper_150m "
        f"fragment 0 ({rows[0]} x 1024) at blocks 256 and 130, an odd-row "
        f"slice, ragged leaves, exact ties and a zero block")
    for codec, t in times.items():
        for name, r in t.items():
            log(f"  time {codec} block 256 fragment 0 {name}: "
                + json.dumps(r))
    return err, times


@contextlib.contextmanager
def initiated_fragments():
    """The fragment of every initiation the engines make inside the block
    (the per-leaf codec launches one encode and one decode per leaf of the
    initiated fragment)."""
    from repro_torch.core.protocol import ProtocolEngine
    seen, orig = [], ProtocolEngine._initiate

    def spy(self, t, params_stack, p):
        seen.append(p)
        return orig(self, t, params_stack, p)

    ProtocolEngine._initiate = spy
    try:
        yield seen
    finally:
        ProtocolEngine._initiate = orig


def peak_host_gib():
    """Peak resident host memory of this process so far (GiB)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2 ** 20


def engines_equal(a, b):
    from repro_torch.core.engine_state import EngineState
    for f in dataclasses.fields(EngineState):
        x, y = getattr(a, f.name), getattr(b, f.name)
        check((x is None) == (y is None), f"engine field {f.name}")
        if isinstance(x, torch.Tensor):
            check(torch.equal(x, y), f"engine plane {f.name} differs")


def trees_equal(a, b, what):
    from repro_torch.core.tree import leaves_with_path
    la, lb = leaves_with_path(a), leaves_with_path(b)
    check([p for p, _ in la] == [p for p, _ in lb], f"{what}: leaves")
    for (p, x), (_, y) in zip(la, lb):
        check(torch.equal(x, y), f"{what}: {p} differs")


def compressed_training_phase(ckpt_dir):
    """paper_150m cocodc fused with the int8 codec through the CLI, paused
    at step KILL with --ckpt (one save), continued to 48; a fresh trainer
    resumed from the file to 48; then streaming per-leaf with int4. Returns
    (codec launches of the two compressed runs, checkpoint path, theta_g at
    step KILL)."""
    from repro_torch import kernels
    from repro_torch.api import build_experiment
    from repro_torch.launch import train
    ck = os.path.join(ckpt_dir, "paper_150m_int8.msgpack")
    free = shutil.disk_usage(ckpt_dir).free
    check(free > 16e9, f"{ckpt_dir} has {free / 1e9:.1f} GB free; the "
          f"full-width checkpoint takes ~10.7 GB")
    host0 = peak_host_gib()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    tr = train.run(INT8_ARGS + ["--stop-at", str(KILL), "--ckpt", ck])
    check(tr.step == KILL and tr.engine.pending,
          f"the run must pause at step {KILL} with a transfer in flight")
    theta_kill = tr.engine.theta_g
    write_s, size = tr.ckpt_seconds, os.path.getsize(ck)
    host_write = peak_host_gib()
    tr.run(eval_every=24)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    s = tr.engine.stats()
    steps, M, B, S = 48, 4, 8, 256
    train_s = tr.run_seconds - tr.eval_seconds
    nlls = [r["nll"] for r in tr.history]
    log(f"train paper_150m cocodc --fused-updates --wire-codec int8: 48 "
        f"steps in {wall:.3f} s wall ({tr.eval_seconds:.3f} s evals, "
        f"{write_s:.3f} s checkpoint write): "
        f"{train_s / steps * 1e3:.1f} ms/step, "
        f"{steps * M * B * S / train_s:.0f} tokens/s (synchronised, build, "
        f"evals and the checkpoint excluded); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; eval NLL "
        f"{nlls}; bytes_sent {s['bytes_sent']:.0f}, wire_bytes_raw "
        f"{s['wire_bytes_raw']:.0f}, compression ratio "
        f"{s['compression_ratio']:.4f}")
    log("  stats: " + json.dumps(s))
    log(f"  launches: {launches}")
    n_init = int(s["n_syncs"])
    deliveries = n_init - len(tr.engine.pending)
    check(launches["quantize_pack"] == launches["dequantize_unpack"]
          == n_init > 0,
          f"codec launches {launches['quantize_pack']}/"
          f"{launches['dequantize_unpack']} != initiations {n_init}")
    check(launches["nesterov_2d"] == launches["deliver_2d"] == deliveries,
          "outer-update launches != deliveries")
    check(abs(s["compression_ratio"] - 3.938) < 1e-3,
          f"int8 compression ratio {s['compression_ratio']}")
    check(all(np.isfinite(nlls)), "non-finite eval NLL")
    codec_launches = {k: launches[k] for k in ("quantize_pack",
                                               "dequantize_unpack")}

    # a fresh trainer resumes from the file (the CLI's --resume path)
    args = train.make_parser().parse_args(INT8_ARGS)
    tr2 = build_experiment(train.spec_from_args(args).validate(),
                           device=DEVICE)
    t0 = time.perf_counter()
    train.resume(tr2, ck)
    torch.cuda.synchronize()
    read_s = time.perf_counter() - t0
    host_read = peak_host_gib()
    check(tr2.step == KILL and len(tr2.engine.pending) > 0,
          f"resumed trainer must stand at step {KILL} with a transfer in "
          f"flight")
    tr2.run(eval_every=24)
    check(tr2.history == tr.history, "resumed history differs")
    check(tr2.engine.stats() == s, "resumed stats differ")
    engines_equal(tr2.engine.state, tr.engine.state)
    trees_equal(tr2.params_stack, tr.params_stack, "params stack")
    trees_equal(tr2.opt_state.mu, tr.opt_state.mu, "AdamW mu")
    log(f"checkpoint/resume paper_150m int8 at step {KILL}: file "
        f"{size / 1e9:.3f} GB, write {write_s:.2f} s, read + restore "
        f"{read_s:.2f} s; peak host memory {host0:.2f} GiB before, "
        f"{host_write:.2f} after the write, {host_read:.2f} after the read; "
        f"resumed to 48: history, stats, params, moments and engine planes "
        f"identical (eval NLL {[r['nll'] for r in tr2.history]})")
    del tr, tr2
    torch.cuda.empty_cache()

    kernels.reset_launch_counts()
    with initiated_fragments() as seen:
        tr = train.run(PAPER_TRAIN_ARGS + ["--method", "streaming",
                                           "--wire-codec", "int4", "--steps",
                                           "24", "--eval-every", "12"])
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    s = tr.engine.stats()
    want = sum(len(tr.fragmenter.leaves_in(p)) for p in seen)
    train_s = tr.run_seconds - tr.eval_seconds
    log(f"train paper_150m streaming per-leaf --wire-codec int4: 24 steps, "
        f"{train_s / 24 * 1e3:.1f} ms/step; compression ratio "
        f"{s['compression_ratio']:.4f}; initiated fragments {seen}; codec "
        f"launches {launches['quantize_pack']}/"
        f"{launches['dequantize_unpack']} (= leaves of the initiated "
        f"fragments, {want})")
    check(len(seen) == int(s["n_syncs"]) > 0, "initiations != n_syncs")
    check(launches["quantize_pack"] == launches["dequantize_unpack"] == want,
          "per-leaf codec launches != leaves of the initiated fragments")
    check(abs(s["compression_ratio"] - 7.758) < 2e-3,
          f"int4 compression ratio {s['compression_ratio']}")
    for k in codec_launches:
        codec_launches[k] += launches[k]
    del tr
    torch.cuda.empty_cache()
    return codec_launches, ck, theta_kill


def serve_checkpoint_phase(ck, theta_kill):
    """`repro_torch.launch.serve` on the fused training checkpoint, sampled
    at temperature 0.8; its params are the trainer's theta_g at step KILL.
    A functional check of the checkpoint load, with no serving speed (the
    serving speeds are the qwen3 phases'). Also the host cost of the
    sampler's Gumbel draw per token, at the real vocabulary sizes."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.core.tree import leaves_with_path
    from repro_torch.data import prng
    from repro_torch.launch import serve
    from repro_torch.models import api
    kernels.reset_launch_counts()
    eng = serve.run(["--arch", "paper_150m", "--ckpt", ck, "--requests", "6",
                     "--slots", "4", "--prompt-len", "64", "--gen-len", "16",
                     "--prefill-chunk", "32", "--cache-len", "128",
                     "--temperature", "0.8", "--seed", "0",
                     "--device", DEVICE])
    s = eng.stats()
    cfg = get_config("paper_150m")
    want = api.prepare_params(cfg, theta_kill)
    got = dict(leaves_with_path(eng.params))
    for path, w in leaves_with_path(want):
        check(torch.equal(got[path], w), f"served param {path} != theta_g")
    check(s["completed"] == 6, "not every request completed")
    for rec in eng.completed:
        check(all(0 <= t < cfg.vocab for t in rec.tokens), "token id range")
    gumbel_ms = {}
    for vocab in (cfg.vocab, 151936):
        keys = np.stack([prng.fold_in(prng.prng_key(0), i) for i in range(8)])
        prng.gumbel(keys[:1], (vocab,))
        t1 = time.perf_counter()
        for i in range(8):
            prng.gumbel(keys[i:i + 1], (vocab,))
        gumbel_ms[vocab] = (time.perf_counter() - t1) / 8 * 1e3
    log(f"serve paper_150m from the fused int8 checkpoint, temperature 0.8 "
        f"(functional check, no speed): {s['completed']}/6 requests, "
        f"{s['total_tokens']} tokens; params == trainer theta_g at step "
        f"{KILL}; launches {eng.kernel_launches()}")
    log(f"  sampler host cost (threefry Gumbel draw in numpy, one token): "
        + ", ".join(f"vocab {v}: {ms:.2f} ms" for v, ms in gumbel_ms.items()))
    return gumbel_ms


# ---------------------------------------------------------------------------
# lock-step serving of the recurrent families: scan kernels, serving, parity
# ---------------------------------------------------------------------------


RWKV_ARGS = ["--arch", "rwkv6-3b", "--slots", "8", "--prompt-len", "128",
             "--gen-len", "64", "--temperature", "0", "--seed", "0",
             "--device", "cuda"]
RG_ARGS = ["--arch", "recurrentgemma-9b", "--slots", "4", "--prompt-len",
           "128", "--gen-len", "32", "--temperature", "0", "--seed", "0",
           "--device", "cuda"]


def n_scan_layers(cfg):
    """Scan launches a decode step or forward makes: one per RWKV-6 layer,
    one per RG-LRU block of the hybrid."""
    if cfg.family == "ssm":
        return cfg.n_layers
    return sum(k == "rglru"
               for k in (cfg.block_pattern * cfg.n_layers)[:cfg.n_layers])


def scan_phase(dev, timer):
    """Both scan kernels against their plain versions at the serving path's
    decode shapes and the forward's, in bf16 (the path's) and f32 for
    `wkv_scan` (`lru_scan` takes f32 only); times, bounds and plain times at
    the decode shape (the main path's) and at T = 512."""
    from repro_torch.kernels.rglru_scan.ops import lru_scan
    from repro_torch.kernels.rglru_scan.ref import lru_scan_ref
    from repro_torch.kernels.rwkv6_scan.ops import wkv_scan
    from repro_torch.kernels.rwkv6_scan.ref import wkv_scan_ref
    gen = torch.Generator(dev).manual_seed(5)

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    err = {"wkv_scan": 0.0, "lru_scan": 0.0}
    times = {"wkv_scan": {}, "lru_scan": {}}
    H, hd = 40, 64
    wkv_cases = [("decode B=8 T=1", 8, 1, True), ("forward B=4 T=512", 4,
                                                   512, False),
                 ("ragged B=2 T=300", 2, 300, True)]
    for name, B, T, with_s0 in wkv_cases:
        for dtype in (torch.bfloat16, torch.float32):
            r, k, v = (rnd(B, T, H, hd, scale=0.5).to(dtype)
                       for _ in range(3))
            w = torch.sigmoid(rnd(B, T, H, hd)).to(dtype)
            u = rnd(H, hd, scale=0.1)
            s0 = rnd(B, H, hd, hd) if with_s0 else None
            o, sT = wkv_scan(r, k, v, w, u, s0)
            torch.cuda.synchronize()
            o_ref, s_ref = wkv_scan_ref(r, k, v, w, u, s0)
            err["wkv_scan"] = max(err["wkv_scan"],
                                  max_err(o, o_ref, dtype, rtol=1e-4),
                                  max_err(sT, s_ref, torch.float32))
            check(torch.equal(sT, s_ref), f"wkv_scan state not bitwise at "
                  f"{name} {dtype}")
            if dtype != torch.bfloat16 or name.startswith("ragged"):
                continue
            es = r.element_size()
            n = B * T * H * hd
            nbytes = 5 * n * es + u.numel() * 4 + B * H * hd * hd * 4 * (
                2 if with_s0 else 1)
            b, by = bound_ms(nbytes, 7 * n * hd, torch.float32)
            times["wkv_scan"][name] = {
                "ms": timer(lambda: wkv_scan(r, k, v, w, u, s0)),
                "plain_ms": timer(lambda: wkv_scan_ref(r, k, v, w, u, s0),
                                  iters=5 if T > 1 else 30),
                "bound_ms": b, "bound_by": by, "library_ms": None}
    D = 4096
    lru_cases = [("decode B=4 T=1", 4, 1, True), ("forward B=4 T=512", 4,
                                                   512, False),
                 ("ragged B=4 T=300 h0", 4, 300, True),
                 ("ragged D=130", 2, 300, False)]
    for name, B, T, with_h0 in lru_cases:
        Dn = 130 if name.endswith("D=130") else D
        a = torch.sigmoid(rnd(B, T, Dn))
        bb = rnd(B, T, Dn)
        h0 = rnd(B, Dn) if with_h0 else None
        got = lru_scan(a, bb, h0)
        torch.cuda.synchronize()
        want = lru_scan_ref(a, bb, h0)
        err["lru_scan"] = max(err["lru_scan"],
                              max_err(got, want, torch.float32, rtol=1e-4))
        if T == 1:
            check(torch.equal(got, want), "lru_scan at T=1 not bitwise")
        if name.startswith("ragged"):
            continue
        n = B * T * Dn
        b, by = bound_ms((3 * n + (B * Dn if with_h0 else 0)) * F32, 2 * n,
                         torch.float32)
        times["lru_scan"][name] = {
            "ms": timer(lambda: lru_scan(a, bb, h0)),
            "plain_ms": timer(lambda: lru_scan_ref(a, bb, h0)),
            "bound_ms": b, "bound_by": by, "library_ms": None}
    log(f"scans: wkv_scan == plain at H=40 hd=64 {[c[0] for c in wkv_cases]}"
        f" in bf16 and f32 (final state bitwise), lru_scan == plain at "
        f"D=4096 {[c[0] for c in lru_cases]} (T=1 bitwise); max abs err "
        f"{err}")
    for kname, rows in times.items():
        for name, r in rows.items():
            log(f"  time {kname} {name}: " + json.dumps(r))
    return err, times


def lockstep_profile(argv, scan_name):
    """Device busy share of a short lock-step run (P=4, G=4; the full run
    before it warmed every kernel up) under torch.profiler: summed kernel
    time over the wall time, and the scan kernel's device time a launch."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import api
    short = argv + ["--prompt-len", "4", "--gen-len", "4"]
    args = serve.parse_args(short)
    cfg = get_config(args.arch)
    params = api.prepare_params(cfg, serve.load_params(cfg, None, DEVICE),
                                release=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        serve._serve_lockstep(cfg, params, args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ev = [e for e in prof.key_averages()
          if str(e.device_type).endswith("CUDA")
          and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in ev)
    top = sorted(ev, key=lambda e: -e.self_device_time_total)[:6]
    scan = [e for e in ev if f"{scan_name}_kernel" in e.key]
    scan_us = (sum(e.self_device_time_total for e in scan)
               / max(1, sum(e.count for e in scan)))
    steps = args.prompt_len + args.gen_len - 1
    log(f"profile {cfg.name} lock-step {args.slots} x ({args.prompt_len} + "
        f"{args.gen_len}): wall {wall:.3f} s ({wall / steps * 1e3:.1f} ms a "
        f"step under the profiler); device busy {busy_us / 1e6:.3f} s "
        f"({busy_us / steps / 1e3:.2f} ms a step) = {busy_us / 1e6 / wall:.1%}"
        f" of wall; {scan_name} {scan_us:.2f} us of device time a launch")
    for e in top:
        log(f"  {e.self_device_time_total / 1e3:9.2f} ms  {e.count:6d}x  "
            f"{e.key[:90]}")
    check(scan, f"no {scan_name} kernel in the trace")
    del params
    torch.cuda.empty_cache()
    return busy_us / 1e6 / wall, scan_us / 1e3


def lockstep_phase(argv, scan_name):
    """One full-width lock-step run through the CLI entry point, with its
    exact launch counts, then a profiled short run. Returns (launches,
    summary)."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    run = serve.run(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    args = serve.parse_args(argv)
    cfg = get_config(args.arch)
    B, P, G = args.slots, args.prompt_len, args.gen_len
    steps = P + G - 1
    n_scan, n_norm = n_scan_layers(cfg), 2 * cfg.n_layers + 1
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    summary = {"prefill_tok_s": B * P / run.prefill_s,
               "decode_tok_s": B * G / run.decode_s,
               "prefill_ms_per_step": run.prefill_s / P * 1e3,
               "decode_ms_per_step": run.decode_s / (G - 1) * 1e3,
               "wall_s": wall, "peak_gib": peak}
    log(f"serve {cfg.name} lock-step {B} x ({P} + {G}), bf16: prefill "
        f"{summary['prefill_tok_s']:.1f} tok/s "
        f"({summary['prefill_ms_per_step']:.2f} ms a step), decode "
        f"{summary['decode_tok_s']:.1f} tok/s "
        f"({summary['decode_ms_per_step']:.2f} ms a step); {wall:.2f} s wall "
        f"with the weights' init; peak memory {peak:.2f} GiB")
    log(f"  launches: {launches}")
    check(run.tokens.shape == (B, G), f"tokens {run.tokens.shape}")
    check(bool(((run.tokens >= 0) & (run.tokens < cfg.vocab)).all()),
          "token id range")
    check(launches[scan_name] == n_scan * steps,
          f"{scan_name} launches {launches[scan_name]} != {n_scan} x {steps}")
    check(launches["rms_norm"] == n_norm * steps,
          f"rms_norm launches {launches['rms_norm']} != {n_norm} x {steps}")
    others = {k: v for k, v in launches.items()
              if k not in (scan_name, "rms_norm") and v}
    check(not others, f"other kernels launched on the path: {others}")
    del run
    summary["busy_share"], summary["scan_device_ms"] = lockstep_profile(
        argv, scan_name)
    return launches, summary


def recurrent_parity_phase():
    """Full width, f32 compute: the kernel path's greedy tokens equal the
    plain path's (P=32, G=16), and `forward` through the scan kernels agrees
    with the plain scans on a (4, 512) batch within 1e-3 of max |h|."""
    import argparse
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.data import prng
    from repro_torch.launch import serve
    from repro_torch.models import api
    out = {}
    for arch, B, flag, scan_name in (("rwkv6-3b", 8, "wkv_impl", "wkv_scan"),
                                     ("recurrentgemma-9b", 4, "lru_impl",
                                      "lru_scan")):
        torch.cuda.empty_cache()
        cfg = dataclasses.replace(get_config(arch),
                                  compute_dtype="float32")
        params = serve.load_params(cfg, None, DEVICE, seed=1)
        cp = api.prepare_params(cfg, params)     # f32: shares the masters
        args = argparse.Namespace(slots=B, prompt_len=32, gen_len=16,
                                  temperature=0.0, seed=1, device=DEVICE)
        toks = {impl: serve._serve_lockstep(cfg, cp, args, impl=impl).tokens
                for impl in ("auto", "ref")}
        check(np.array_equal(toks["auto"], toks["ref"]),
              f"{arch} f32 greedy tokens: kernel path != plain path")
        del cp
        batch = {"tokens": torch.from_numpy(prng.randint(
            prng.prng_key(2), (4, 512), 0, cfg.vocab)).to(DEVICE)}
        h = {}
        with torch.no_grad():
            for impl in ("kernel", "ref"):
                kernels.reset_launch_counts()
                h[impl] = api.forward(cfg, params, batch, **{flag: impl})
                torch.cuda.synchronize()
                if impl == "kernel":
                    n = kernels.launch_counts()[scan_name]
        n_scan = n_scan_layers(cfg)
        check(n == n_scan, f"{scan_name} launches {n} in the forward != "
              f"{n_scan}")
        scale = h["ref"].abs().max().item()
        diff = (h["kernel"] - h["ref"]).abs().max().item()
        check(bool(torch.isfinite(h["kernel"]).all()), "non-finite forward")
        check(diff <= 1e-3 * scale, f"{arch} forward kernel vs plain: "
              f"{diff} > 1e-3 x {scale}")
        log(f"parity f32 full width {arch}: kernel path == plain path on "
            f"{toks['auto'].size} greedy tokens ({B} x (32 + 16)); forward "
            f"(4, 512) with {n} {scan_name} launches: max |h diff| "
            f"{diff:.3g} (max |h| {scale:.3g})")
        out[arch] = diff / scale
        del params, h
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                    "src"))
    from repro_torch import kernels
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    card = smi.strip().splitlines()[0]
    log(f"card: {card}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    libs = kernels.build()
    for name in libs:
        kernels.load_library(name)
    log(f"build: nvcc {sorted(libs)} in {time.perf_counter() - t0:.2f} s")

    timer = Timer(dev)
    t0 = time.perf_counter()
    rms_err, rms_t = rms_norm_phase(dev, timer)
    fd_err, fd_t = flash_decode_phase(dev, timer)
    log(f"kernel checks and timings in {time.perf_counter() - t0:.1f} s "
        f"(includes Triton's first compile)")

    launches = serve_phase()
    profile_phase()
    parity_phase()

    t0 = time.perf_counter()
    ou_err, ou_t = outer_update_phase(dev, timer)
    log(f"outer-update kernel checks and timings in "
        f"{time.perf_counter() - t0:.1f} s")
    train_launches = training_phases()
    leaf_launches, _ = per_leaf_phase(dev)
    train_profile_phase()

    t0 = time.perf_counter()
    codec_err, codec_t = codec_phase(dev, timer)
    log(f"codec kernel checks and timings in {time.perf_counter() - t0:.1f} s")
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        codec_launches, ck, theta_kill = compressed_training_phase(ckpt_dir)
        serve_checkpoint_phase(ck, theta_kill)
        del theta_kill
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    train_parity_phase()

    t0 = time.perf_counter()
    scan_err_, scan_t = scan_phase(dev, timer)
    log(f"scan kernel checks and timings in {time.perf_counter() - t0:.1f} s")
    wkv_launches, wkv_sum = lockstep_phase(RWKV_ARGS, "wkv_scan")
    lru_launches, lru_sum = lockstep_phase(RG_ARGS, "lru_scan")
    recurrent_parity_phase()

    entries = [
        dict(name="flash_decode", route="cuda",
             source="src/repro_torch/kernels/csrc/flash_decode.cu",
             replaces="src/repro/kernels/flash_decode/flash_decode.py:66",
             launches=launches["flash_decode"], max_abs_err=fd_err,
             **{k: fd_t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                     "library_ms")}),
        dict(name="rms_norm", route="triton",
             source="src/repro_torch/kernels/rms_norm/rms_norm.py",
             replaces="src/repro/kernels/rms_norm/rms_norm.py:28",
             launches=launches["rms_norm"], max_abs_err=rms_err,
             **{k: rms_t[k] for k in ("ms", "plain_ms", "bound_ms",
                                      "bound_by", "library_ms")}),
        dict(name="nesterov_2d", route="cuda",
             source="src/repro_torch/kernels/csrc/outer_update.cu",
             replaces="src/repro/kernels/outer_update/outer_update.py:48",
             launches=train_launches["nesterov_2d"],
             max_abs_err=ou_err["nesterov_2d"], **ou_t["nesterov_2d"]),
        dict(name="deliver_2d", route="cuda",
             source="src/repro_torch/kernels/csrc/outer_update.cu",
             replaces="src/repro/kernels/outer_update/outer_update.py:90",
             launches=train_launches["deliver_2d"],
             max_abs_err=ou_err["deliver_2d"], **ou_t["deliver_2d"],
             blend={k: ou_t["deliver_2d blend"][k] for k in
                    ("ms", "plain_ms", "bound_ms", "library_ms")}),
        dict(name="delay_comp", route="cuda",
             source="src/repro_torch/kernels/csrc/delay_comp.cu",
             replaces="src/repro/kernels/delay_comp/delay_comp.py:39",
             launches=leaf_launches["delay_comp"],
             max_abs_err=ou_err["delay_comp"],
             **{k: v for k, v in ou_t["delay_comp"].items()
                if k != "shape"}),
    ]
    for name, line in (("quantize_pack", 70), ("dequantize_unpack", 93)):
        entries.append(dict(
            name=name, route="cuda",
            source="src/repro_torch/kernels/csrc/delta_codec.cu",
            replaces=f"src/repro/kernels/delta_codec/delta_codec.py:{line}",
            launches=codec_launches[name], max_abs_err=codec_err[name],
            **codec_t["int8"][name],
            int4={k: codec_t["int4"][name][k] for k in
                  ("ms", "plain_ms", "bound_ms", "library_ms")}))
    for name, launched, path_sum, file_line in (
            ("wkv_scan", wkv_launches, wkv_sum,
             "src/repro/kernels/rwkv6_scan/rwkv6_scan.py:55"),
            ("lru_scan", lru_launches, lru_sum,
             "src/repro/kernels/rglru_scan/rglru_scan.py:49")):
        rows = scan_t[name]
        decode = next(v for k, v in rows.items() if k.startswith("decode"))
        entries.append(dict(
            name=name, route="cuda",
            source=f"src/repro_torch/kernels/csrc/"
                   f"{'rwkv6' if name == 'wkv_scan' else 'rglru'}_scan.cu",
            replaces=file_line, launches=launched[name],
            max_abs_err=scan_err_[name], **decode,
            device_ms_on_path=path_sum["scan_device_ms"],
            forward=next(v for k, v in rows.items()
                         if k.startswith("forward"))))
    for e in entries:
        check(e["launches"] > 0, f"{e['name']} never launched on the path")
    log(f"card: {card}")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
