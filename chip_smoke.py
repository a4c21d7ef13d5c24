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
     identical greedy tokens; bf16: agreement share and logit difference).
Then one JSON line with every kernel's numbers, and last
{"ok": true, "device": {...}}.

Needs CUDA and the repo's `src/`; it imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

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


def max_err(got, want, dtype):
    """Max |got - want|, after checking the stated tolerance: f32 at
    rtol = atol = 1e-5 (reduction order); bf16 at one bf16 ulp of each
    element plus 1e-5 of the tensor's magnitude."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    if dtype == torch.float32:
        tol = 1e-5 + 1e-5 * want.abs()
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
    ]
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
