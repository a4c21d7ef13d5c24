"""Serving entry point of the port (counterpart of `repro/launch/serve.py`,
same flags plus ``--device``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \
        --mode continuous --slots 8 --requests 16 --prompt-len 256 \
        --gen-len 64 --prefill-chunk 64 --cache-len 512
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b \
        --slots 8 --prompt-len 128 --gen-len 64

Runs on CUDA unless ``--device cpu`` is given. The dense family runs on the
continuous-batching engine (`ServeEngine`); the SSM and hybrid families
(rwkv6-3b, recurrentgemma-9b) on the lock-step path, token by token through
`decode_step`, as the JAX package serves them; MoE raises until ported
(ROADMAP.md, Queue A). Loads params from --ckpt (theta_g of a training run
of either package, or a bare param pytree) or random-inits them from a
seeded torch.Generator. A fused-mode checkpoint (`--fused-updates`) stores
theta_g as one flat fragment plane: `load_params` rebuilds the run's
fragmenter from the checkpoint's meta and unpacks the plane into the
per-leaf params.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np
import torch

from repro_torch.checkpoint import load_pytree
from repro_torch.configs import get_config
from repro_torch.core.flatplane import LANES
from repro_torch.core.fragments import make_fragmenter
from repro_torch.core.tree import tree_map
from repro_torch.data import prng
from repro_torch.kernels import resolve_device
from repro_torch.models import api
from repro_torch.serve import Request, ServeEngine
from repro_torch.weights import params_from_jax


def unflatten_theta(cfg, theta, meta):
    """theta_g of a fused-mode checkpoint, a ``(total_rows, LANES)`` f32
    plane, as the per-leaf param tree (numpy f32 leaves): the run's
    fragmenter rebuilt from the checkpoint's meta, the plane unpacked by
    `FlatView.unpack_full`."""
    theta = np.asarray(theta)
    if theta.ndim != 2 or theta.shape[-1] != LANES:
        raise ValueError(f"fused checkpoint theta_g has shape {theta.shape}, "
                         f"expected a (total_rows, {LANES}) flat fragment "
                         f"plane")
    specs = api.param_specs(cfg)
    frag = make_fragmenter(cfg, specs, int(meta.get("num_fragments", 1)),
                           strategy=meta.get("fragment_strategy", "strided"))
    if frag.flat.total_rows != theta.shape[0]:
        raise ValueError(
            f"flat theta_g has {theta.shape[0]} rows but arch {cfg.name!r} "
            f"with num_fragments={meta.get('num_fragments')} strategy="
            f"{meta.get('fragment_strategy')!r} needs {frag.flat.total_rows}"
            f": checkpoint/arch mismatch")
    template = tree_map(lambda s: torch.zeros(s.shape, dtype=torch.float32),
                        specs)
    frag.flat.unpack_full(template, torch.from_numpy(theta))
    return tree_map(lambda t: t.numpy(), template)


def load_params(cfg, ckpt, device=None, seed: int = 0):
    """Master params of `cfg` on `device`: from a JAX-package checkpoint, or
    random from a torch.Generator seeded with `seed`."""
    device = resolve_device(device)
    if not ckpt:
        gen = torch.Generator(device).manual_seed(seed)
        return api.init_params(cfg, gen, device)
    state = load_pytree(ckpt)
    if isinstance(state, dict) and state.get("format") == "trainer_state_v1":
        # full-run checkpoint (launch/train --ckpt): the consensus model
        # lives in the serialized EngineState
        meta = state.get("meta", {})
        arch = meta.get("arch")
        if arch and arch != cfg.name:
            raise ValueError(f"checkpoint was trained on arch {arch!r}, "
                             f"serving requested {cfg.name!r}")
        params = state["trainer_state"]["engine"]["theta_g"]
        if meta.get("fused_updates") and not isinstance(params, dict):
            params = unflatten_theta(cfg, params, meta)
    else:
        params = state["theta_g"] if "theta_g" in state else state
    return params_from_jax(cfg, params, device)


def make_requests(cfg, args):
    """The seeded request trace `repro.launch.serve` draws for these flags."""
    rng = np.random.default_rng(args.seed)
    reqs = []
    t = 0.0
    for i in range(args.requests):
        t += float(rng.exponential(1.0 / max(args.rps, 1e-9)))
        P = int(rng.integers(max(2, args.prompt_len // 2), args.prompt_len + 1))
        reqs.append(Request(
            rid=i, prompt=rng.integers(0, cfg.vocab, size=P).astype(np.int32),
            max_new_tokens=int(rng.integers(max(1, args.gen_len // 2),
                                            args.gen_len + 1)),
            arrival_s=t))
    return reqs


def _serve_engine(cfg, params, args) -> ServeEngine:
    """Transformer serving on the slot-plane engine (continuous or static)."""
    reqs = make_requests(cfg, args)
    cache_len = max(args.cache_len,
                    api.decode_cache_len(cfg, args.prompt_len + args.gen_len))
    eng = ServeEngine(cfg, params, n_slots=args.slots, cache_len=cache_len,
                      max_prompt=args.prompt_len,
                      prefill_chunk=args.prefill_chunk, mode=args.mode,
                      temperature=args.temperature, seed=args.seed,
                      device=args.device)
    recs = eng.run_trace(reqs)
    s = eng.stats()
    print(f"mode={args.mode} slots={args.slots} completed={s['completed']}"
          f"/{len(reqs)} device={eng.device}")
    print(f"  virtual: {s['tok_per_s']:.1f} tok/s  occupancy "
          f"{s['occupancy']:.2f}  ttft p50/p99 {s['ttft_p50_s']*1e3:.0f}/"
          f"{s['ttft_p99_s']*1e3:.0f} ms  tok-latency p99 "
          f"{s['tok_latency_p99_s']*1e3:.1f} ms")
    launches = ", ".join(f"{k} {v}" for k, v in eng.kernel_launches().items())
    print(f"  dispatches: {s['decode_dispatches']} decode, "
          f"{s['prefill_dispatches']} prefill; kernel launches: {launches}; "
          f"wall {s['wall_s']:.2f}s ({s['total_tokens'] / s['wall_s']:.1f} "
          f"tok/s)")
    for rec in recs[:4]:
        head = rec.tokens[:16]
        print(f"  req{rec.rid}: {head}{'...' if len(rec.tokens) > 16 else ''}")
    return eng


@dataclasses.dataclass
class LockstepRun:
    """What `_serve_lockstep` served: the prompts, the generated tokens and
    the synchronised host times of the two phases."""
    prompts: np.ndarray          # (B, P) int32
    tokens: np.ndarray           # (B, G) int32
    prefill_s: float
    decode_s: float


def _serve_lockstep(cfg, params, args, impl: str = "auto") -> LockstepRun:
    """Lock-step path of the SSM and hybrid families (`repro/launch/serve.py`
    `_serve_lockstep`): a batch of identical-length prompts, drawn as JAX's
    `randint` draws them, token by token through `decode_step` (P prefill
    steps, then G - 1 generating ones); greedy at temperature 0, else
    categorical draws from the threefry stream fold_in(key, 0x5A17). params:
    from `api.prepare_params`."""
    B, P, G = args.slots, args.prompt_len, args.gen_len
    dev = torch.device(args.device)
    key = prng.prng_key(args.seed)
    prompts = prng.randint(key, (B, P), 0, cfg.vocab)
    prompts_dev = torch.from_numpy(prompts).to(dev)
    cache_len = api.decode_cache_len(cfg, P + G)

    def decode(cache, toks):
        return api.decode_step(cfg, params, cache, toks, impl=impl)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    sync()
    t0 = time.perf_counter()
    cache = api.init_cache(cfg, B, max(cache_len, P + G), dev)
    for t in range(P):
        logits, cache = decode(cache, prompts_dev[:, t])
    sync()
    t_prefill = time.perf_counter() - t0
    print(f"prefill {B}x{P} tokens in {t_prefill:.2f}s "
          f"({B*P/max(t_prefill,1e-9):.0f} tok/s)")

    # a dedicated sampling stream, never the key that generated the prompts
    sample_key = prng.fold_in(key, 0x5A17)

    def sample(logits, i):
        if args.temperature <= 0:
            return logits.argmax(-1).to(torch.int32)
        g = prng.gumbel(prng.fold_in(sample_key, i), tuple(logits.shape))
        return (torch.from_numpy(g).to(dev) + logits / args.temperature
                ).argmax(-1).to(torch.int32)

    toks = sample(logits, 0)
    outs = [toks]
    t0 = time.perf_counter()
    for i in range(1, G):
        logits, cache = decode(cache, toks)
        toks = sample(logits, i)
        outs.append(toks)
    gen = torch.stack(outs, dim=1).cpu().numpy()
    dt = time.perf_counter() - t0
    print(f"decode {B}x{G} tokens in {dt:.2f}s ({B*G/max(dt,1e-9):.1f} "
          f"tok/s)")
    for b in range(min(B, 4)):
        print(f"  seq{b}: {list(map(int, gen[b][:16]))}"
              f"{'...' if G > 16 else ''}")
    return LockstepRun(prompts=prompts, tokens=gen, prefill_s=t_prefill,
                       decode_s=dt)


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--mode", default="continuous",
                    choices=["continuous", "static"])
    ap.add_argument("--slots", type=int, default=8,
                    help="decode slots (batch lanes)")
    ap.add_argument("--cache-len", type=int, default=0)
    ap.add_argument("--prefill-chunk", type=int, default=16)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--rps", type=float, default=4.0,
                    help="mean request arrival rate on the virtual clock")
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; never falls back)")
    return ap.parse_args(argv)


def run(argv=None):
    """Parse flags, load params and serve: the dense family's trace on the
    engine (returns the `ServeEngine`), the other families lock-step
    (returns the `LockstepRun`)."""
    args = parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    api.family_module(cfg)          # raises for families not ported yet
    args.device = str(resolve_device(args.device))
    params = load_params(cfg, args.ckpt, args.device)
    if cfg.family == "dense":
        return _serve_engine(cfg, params, args)
    # serving needs only the compute-dtype copy: give the masters up as it
    # is made
    params = api.prepare_params(cfg, params, release=True)
    return _serve_lockstep(cfg, params, args)


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
