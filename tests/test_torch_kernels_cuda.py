"""The port's hand-written kernels held against their plain PyTorch versions
on the card (`cuda`-marked: they skip without an NVIDIA GPU). This file
imports no JAX, so it also runs where only PyTorch is installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Tolerances (`assert_close`, shared with test_torch_kernels.py): f32 at
rtol = atol = 1e-5 (reduction order). bf16 at one bf16 ulp of each element
(|a - b| <= 2^-7 |ref|: a last-bit rounding flip), plus 1e-5 of the tensor's
magnitude for f32 reduction-order slack before the rounding. The
outer-update and delay-compensation kernels (elementwise, no reduction) at
rtol 1e-5, atol 1e-6, like the JAX package's kernel-vs-oracle pin. The scan
kernels (`wkv_scan`, `lru_scan`) at the JAX package's tolerance for them,
rtol 1e-4, atol 1e-5 in f32 (o's sum over the head dimension and the
scan's composition run in another order); `wkv_scan`'s final state and
`lru_scan` at T = 1 bitwise (explicitly rounded operations in the plain
version's order).
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_decode.ops import flash_decode  # noqa: E402
from repro_torch.kernels.flash_decode.ref import flash_decode_ref  # noqa: E402
from repro_torch.kernels.rms_norm.ops import rms_norm  # noqa: E402
from repro_torch.kernels.rms_norm.ref import rms_norm_ref  # noqa: E402
from repro_torch.kernels.delay_comp.ops import delay_comp_array  # noqa: E402
from repro_torch.kernels.delay_comp.ref import delay_comp_ref  # noqa: E402
from repro_torch.kernels.outer_update.ops import (fused_deliver,  # noqa: E402
                                                  outer_nesterov)
from repro_torch.kernels.outer_update.ref import (deliver_ref,  # noqa: E402
                                                  nesterov_ref)
from repro_torch.kernels.delta_codec import ops as codec_ops  # noqa: E402
from repro_torch.kernels.rglru_scan.ops import lru_scan  # noqa: E402
from repro_torch.kernels.rglru_scan.ref import lru_scan_ref  # noqa: E402
from repro_torch.kernels.rwkv6_scan.ops import wkv_scan  # noqa: E402
from repro_torch.kernels.rwkv6_scan.ref import wkv_scan_ref  # noqa: E402

BF16_ULP = 2.0 ** -7
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _f32(a) -> np.ndarray:
    """torch tensor (any device) or array-like -> float32 numpy."""
    if isinstance(a, torch.Tensor):
        return a.detach().float().cpu().numpy()
    return np.asarray(a).astype(np.float32)


def assert_close(got, want, dtype):
    got, want = _f32(got), _f32(want)
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        tol = BF16_ULP * np.abs(want) + 1e-5 * np.abs(want).max()
        assert np.all(np.abs(got - want) <= tol), \
            f"max excess {np.max(np.abs(got - want) - tol)}"


def decode_case(B, H, KV, hd, C, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, C, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, C, KV, hd)).astype(np.float32)
    return q, k, v


def ragged_positions(B, C):
    """Every lane at its own depth: fresh, holes mid-cache, a wrapped ring,
    and an empty slot (lane 3)."""
    ar = np.arange(C)
    rows = [np.where(ar <= 5, ar, -1),
            np.where((ar <= C - 10) & (ar % 7 != 3), ar, -1),
            np.where(ar >= 20, ar + 30, np.where(ar < 10, ar + C + 30, -1)),
            np.full(C, -1)]
    qpos = [5, C - 10, C + 39, 0]
    return np.stack(rows[:B]).astype(np.int32), np.array(qpos[:B], np.int32)


def outer_case(rows, m, seed, spread=1e-3):
    """Flat-plane operands: theta ~ 0.02, momentum/delta ~ 1e-3, the global
    plane and the worker planes within `spread` of theta. The default is
    parameter-like; `spread=1` makes Algorithm 1's Taylor term dominate
    (`COMP_KW`)."""
    rng = np.random.default_rng(seed)

    def r(*shape, s):
        return (rng.standard_normal(shape) * s).astype(np.float32)
    theta = r(rows, 1024, s=0.02)
    return {"theta": theta, "mom": r(rows, 1024, s=1e-3),
            "delta": r(rows, 1024, s=1e-3),
            "g": theta + r(rows, 1024, s=spread),
            "local": theta[None] + r(m, rows, 1024, s=spread),
            "snap": theta[None] + r(m, rows, 1024, s=spread)}


def assert_plane_close(got, want):
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-5, atol=1e-6)


# Algorithm 1's scalars at which, with operands O(1) apart (`spread=1`),
# the Taylor term tau * lam * gr^2 * (g - s) / H is O(0.1-1): a short
# overlap, a large lam, a small H, and sign -1. At parameter-like
# magnitudes it is ~1e-11, far below any tolerance.
COMP_KW = dict(tau=2.0, lam=2.0, H=3.0, sign=-1.0)


def assert_term_dominates(full, without):
    """The Taylor term (`full` less the same call at lam=0) exceeds the
    kernel-vs-plain tolerance (atol 1e-6 + rtol 1e-5) by over three orders
    of magnitude at the median element, so a kernel or plain version that
    drops or mis-scales it fails the comparison."""
    full, without = _f32(full), _f32(without)
    ratio = np.abs(full - without) / (1e-6 + 1e-5 * np.abs(full))
    assert np.median(ratio) > 1e3, np.median(ratio)


def codec_case(case, block, bits, seed):
    """A flat f32 array of whole `block`-element blocks, each at its own
    scale (1e-4 to 10): "ragged" adds a partial last block; "zero" zeroes
    block 1; "ties" makes block 0 (and block 2, negated) hit every
    half-integer code, x = (k + 0.5) * scale exactly (absmax = levels *
    2^-6 makes the scale 2^-6 exactly: f32(levels) * f32(1/levels) == 1)."""
    rng = np.random.default_rng(seed)
    levels = {8: 127, 4: 7}[bits]
    n = 5 * block + (max(1, block // 2 - 1) if case == "ragged" else 0)
    mag = np.repeat(10.0 ** rng.uniform(-4, 1, size=-(-n // block)), block)
    x = (rng.standard_normal(n) * mag[:n]).astype(np.float32)
    if case == "zero":
        x[block:2 * block] = 0.0
    elif case == "ties":
        e = 2.0 ** -6
        k = np.arange(block) % (2 * levels) - levels
        t = ((k + 0.5) * e).astype(np.float32)
        t[0] = levels * e
        x[:block], x[2 * block:3 * block] = t, -t
    return x


def wkv_case(B, T, H, hd, seed):
    """r, k, v (B, T, H, hd) at scale 0.5, decays w = sigmoid(N(0, 1)), u
    (H, hd) at 0.1 and a state s0 (B, H, hd, hd), as the JAX package's
    kernel tests draw them; float32 numpy."""
    rng = np.random.default_rng(seed)

    def n(*shape, s=1.0):
        return (rng.standard_normal(shape) * s).astype(np.float32)
    r, k, v = (n(B, T, H, hd, s=0.5) for _ in range(3))
    w = (1 / (1 + np.exp(-n(B, T, H, hd)))).astype(np.float32)
    return r, k, v, w, n(H, hd, s=0.1), n(B, H, hd, hd)


def lru_case(B, T, D, seed):
    """a = sigmoid(N(0, 1)), b ~ N(0, 1) (B, T, D) and h0 (B, D); float32
    numpy."""
    rng = np.random.default_rng(seed)
    a = (1 / (1 + np.exp(-rng.standard_normal((B, T, D))))).astype(np.float32)
    return (a, rng.standard_normal((B, T, D)).astype(np.float32),
            rng.standard_normal((B, D)).astype(np.float32))


def assert_scan_close(got, want):
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def one_torch_thread():
    """One intra-op thread for a module's CPU work: the test workers share
    the cores, and PyTorch's OpenMP threads spin-wait, so several
    many-threaded workers slow each other down several times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(8, 1024), (128, 128), (64, 1024), (5, 200)])
def test_rms_norm_kernel_matches_plain_on_card(cuda, shape, dtype):
    gen = torch.Generator(cuda).manual_seed(0)
    x = torch.randn(shape, generator=gen, device=cuda).to(TORCH_DT[dtype])
    w = torch.rand(shape[-1], generator=gen, device=cuda).to(TORCH_DT[dtype])
    got = rms_norm(x, w)
    torch.cuda.synchronize()
    assert_close(got, rms_norm_ref(x, w), dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 16])
@pytest.mark.parametrize("G,hd,C", [(2, 128, 1024), (1, 64, 40), (16, 256, 70)])
def test_flash_decode_kernel_matches_plain_on_card(cuda, G, hd, C, window,
                                                   dtype):
    B, KV = 4, 2
    q, k, v = (torch.from_numpy(a).to(cuda, TORCH_DT[dtype])
               for a in decode_case(B, KV * G, KV, hd, C, seed=1))
    pos, qpos = (torch.from_numpy(a).to(cuda) for a in ragged_positions(B, C))
    got = flash_decode(q, k, v, pos, qpos, window=window)
    torch.cuda.synchronize()
    assert_close(got, flash_decode_ref(q, k, v, pos, qpos, window=window),
                 dtype)
    assert not got[3].any()                    # the empty slot gives 0


# paper_150m's K=4 strided fragment rows (0 and 2) at M=4, and ragged ones
PLANE_ROWS = [44741, 20742, 37, 1]


@pytest.mark.cuda
@pytest.mark.parametrize("rows", PLANE_ROWS)
def test_nesterov_kernel_matches_plain_on_card(cuda, rows):
    c = {k: torch.from_numpy(v).to(cuda)
         for k, v in outer_case(rows, 1, seed=rows).items()}
    got = outer_nesterov(c["theta"], c["mom"], c["delta"], lr=0.7, mu=0.9)
    torch.cuda.synchronize()
    want = nesterov_ref(c["theta"], c["mom"], c["delta"], lr=0.7, mu=0.9)
    assert_plane_close(got[0], want[0])
    assert_plane_close(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["blend", "compensate"])
@pytest.mark.parametrize("rows", PLANE_ROWS)
def test_deliver_kernel_matches_plain_on_card(cuda, rows, mode):
    c = {k: torch.from_numpy(v).to(cuda)
         for k, v in outer_case(rows, 4, seed=rows + 1).items()}
    avail = torch.tensor([True, False, True, True], device=cuda)
    kw = ({"alpha": 0.5} if mode == "blend" else
          {"tau": torch.tensor(8.0, device=cuda), "lam": 0.5, "H": 24.0,
           "sign": 1.0})
    snap = c["snap"] if mode == "compensate" else None
    if snap is not None and rows % 2:
        # a row slice of a full-model plane, as the engine hands it
        full = torch.zeros(4, rows + 9, 1024, device=cuda)
        full[:, 5:5 + rows] = snap
        snap = full[:, 5:5 + rows]
    got = fused_deliver(c["local"], snap, c["g"], avail, mode=mode, **kw)
    torch.cuda.synchronize()
    assert_plane_close(got, deliver_ref(c["local"], snap, c["g"], avail,
                                        mode=mode, **kw))
    assert torch.equal(got[1], c["local"][1])       # the offline worker


@pytest.mark.cuda
@pytest.mark.parametrize("shape,bcast", [((4, 3, 768, 2048), True),
                                         ((4, 3, 768), True),
                                         ((4, 5, 36), True),
                                         ((4, 5, 33), False),
                                         ((4, 768), False)])
def test_delay_comp_kernel_matches_plain_on_card(cuda, shape, bcast):
    gen = torch.Generator(cuda).manual_seed(len(shape))
    tp = torch.randn(shape, generator=gen, device=cuda) * 0.02
    tl = tp + torch.randn(shape, generator=gen, device=cuda) * 1e-3
    base = tp[:1] if bcast else tp
    tg = base + torch.randn(base.shape, generator=gen, device=cuda) * 1e-3
    kw = dict(tau=torch.tensor(5.0, device=cuda), lam=0.5, H=24.0, sign=1.0)
    got = delay_comp_array(tl, tp, tg, **kw)
    torch.cuda.synchronize()
    assert_plane_close(got, delay_comp_ref(tl, tp, tg, **kw))


@pytest.mark.cuda
@pytest.mark.parametrize("rows", PLANE_ROWS)
def test_deliver_compensation_term_kernel_matches_plain_on_card(cuda, rows):
    c = {k: torch.from_numpy(v).to(cuda)
         for k, v in outer_case(rows, 4, seed=rows + 2, spread=1.0).items()}
    avail = torch.tensor([True, True, False, True], device=cuda)
    kw = {**COMP_KW, "tau": torch.tensor(COMP_KW["tau"], device=cuda)}
    args = (c["local"], c["snap"], c["g"], avail)
    got = fused_deliver(*args, mode="compensate", **kw)
    torch.cuda.synchronize()
    want = deliver_ref(*args, mode="compensate", **kw)
    assert_plane_close(got, want)
    assert_term_dominates(want[avail], deliver_ref(
        *args, mode="compensate", **{**kw, "lam": 0.0})[avail])
    assert torch.equal(got[2], c["local"][2])       # the offline worker


@pytest.mark.cuda
@pytest.mark.parametrize("shape,bcast", [((4, 3, 768, 2048), True),
                                         ((4, 5, 36), True),
                                         ((4, 5, 33), False)])
def test_delay_comp_compensation_term_kernel_matches_plain_on_card(
        cuda, shape, bcast):
    gen = torch.Generator(cuda).manual_seed(len(shape) + 1)
    tp = torch.randn(shape, generator=gen, device=cuda) * 0.02
    tl = tp + torch.randn(shape, generator=gen, device=cuda)
    base = tp[:1] if bcast else tp
    tg = base + torch.randn(base.shape, generator=gen, device=cuda)
    kw = {**COMP_KW, "tau": torch.tensor(COMP_KW["tau"], device=cuda)}
    got = delay_comp_array(tl, tp, tg, **kw)
    torch.cuda.synchronize()
    want = delay_comp_ref(tl, tp, tg, **kw)
    assert_plane_close(got, want)
    assert_term_dominates(want, delay_comp_ref(tl, tp, tg,
                                               **{**kw, "lam": 0.0}))


@pytest.mark.cuda
def test_delay_comp_refuses_leaves_off_float4(cuda):
    """The kernel loads float4; a leaf of 3 * 97 elements is refused, and a
    contiguous view at an odd offset is copied, not misread."""
    x = torch.zeros(4, 3, 97, device=cuda)
    with pytest.raises(ValueError, match="multiple of 4"):
        delay_comp_array(x, x, x[:1], tau=1.0, lam=0.5, H=1.0)
    flat = torch.randn(4 * 8 + 1, device=cuda)
    tl = flat[1:].reshape(4, 8)                 # 4 bytes past an aligned start
    tp, tg = torch.randn(4, 8, device=cuda), torch.randn(1, 8, device=cuda)
    kw = dict(tau=2.0, lam=2.0, H=3.0)
    assert_plane_close(delay_comp_array(tl, tp, tg, **kw),
                       delay_comp_ref(tl, tp, tg, **kw))


@pytest.mark.cuda
def test_kernels_refuse_gradients_on_card(cuda):
    """No kernel has a backward: on CUDA tensors that need a gradient the
    wrappers raise instead of silently detaching."""
    x = torch.randn(4, 64, device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        rms_norm(x, torch.ones(64, device=cuda))
    p = torch.zeros(2, 1024, device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        outer_nesterov(p, p.detach(), p.detach(), lr=1.0, mu=0.5)
    with pytest.raises(RuntimeError, match="no backward"):
        delay_comp_array(p, p.detach(), p.detach(), tau=1.0, lam=0.5, H=1.0)
    # the plain version keeps the graph
    y = rms_norm(x, torch.ones(64, device=cuda), impl="ref")
    assert y.grad_fn is not None


# the codec's cases on the card: paper_150m-like fragment planes at block
# 256, an unaligned block, a ragged leaf, ties, a zero block, and a row
# slice of a plane starting at an odd row
CODEC_CASES = ["plane", "ragged", "ties", "zero", "odd_rows"]


def _codec_input(case, block, bits, device):
    if case == "plane":
        gen = torch.Generator(device).manual_seed(block)
        return torch.randn(37, 1024, generator=gen, device=device) * 1e-3
    if case == "odd_rows":
        gen = torch.Generator(device).manual_seed(block + 1)
        return (torch.randn(40, 1024, generator=gen, device=device))[5:38]
    x = torch.from_numpy(codec_case(case, block, bits, seed=block)).to(device)
    return x.reshape(-1, 7) if case == "ragged" and x.numel() % 7 == 0 else x


@pytest.mark.cuda
@pytest.mark.parametrize("case", CODEC_CASES)
@pytest.mark.parametrize("codec", ["int8", "int4"])
@pytest.mark.parametrize("block", [256, 130, 2])
def test_codec_kernels_match_plain_bitwise_on_card(cuda, block, codec, case):
    x = _codec_input(case, block, 8 if codec == "int8" else 4, cuda)
    kw = dict(codec=codec, block=block)
    packed, scales = codec_ops.encode_array(x, **kw)
    want_p, want_s = codec_ops.encode_array(x, impl="ref", **kw)
    torch.cuda.synchronize()
    assert torch.equal(packed, want_p) and torch.equal(scales, want_s)
    got = codec_ops.decode_array(packed, scales, x.shape, x.dtype, **kw)
    want = codec_ops.decode_array(want_p, want_s, x.shape, x.dtype,
                                  impl="ref", **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    if case == "zero":
        assert not scales[1].item() and not got.reshape(-1)[
            block:2 * block].any()


@pytest.mark.cuda
@pytest.mark.parametrize("fused", [True, False])
def test_codec_launches_per_initiation_on_card(cuda, fused):
    """One `quantize_pack` and one `dequantize_unpack` launch per fused
    initiation, one of each per leaf of the initiated fragment per leaf."""
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.configs.base import CoCoDCConfig
    from repro_torch.core import engine_state as es
    from repro_torch.core.fragments import make_fragmenter
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.models import api
    cfg = get_config("bench_tiny")
    ccfg = CoCoDCConfig(num_workers=2, local_steps=8, num_fragments=4,
                        overlap_depth=2, fused_updates=fused,
                        wire_codec="int8")
    params = api.init_params(cfg, torch.Generator(cuda).manual_seed(0), cuda)
    stack = tree_map(lambda a: a[None].repeat((2,) + (1,) * a.dim()), params)
    frag = make_fragmenter(cfg, api.param_specs(cfg), 4)
    st = es.init_state("cocodc", ccfg, stack, frag=frag)
    fn = es.make_engine_fns("cocodc", ccfg, frag)
    for leaf in tree_leaves(stack):
        leaf.add_(torch.randn(leaf.shape, device=cuda) * 1e-3)
    kernels.reset_launch_counts()
    fn.initiate(st, 0, stack, 1)
    torch.cuda.synchronize()
    n = 1 if fused else len(frag.leaves_in(1))
    counts = kernels.launch_counts()
    assert counts["quantize_pack"] == counts["dequantize_unpack"] == n
    assert st.wire_residual is not None


@pytest.mark.cuda
def test_codec_kernels_refuse_gradients_on_card(cuda):
    x = torch.randn(4, 256, device=cuda, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        codec_ops.encode_array(x, codec="int8", block=256)
    with pytest.raises(RuntimeError, match="no backward"):
        codec_ops.codec_roundtrip_array(x, codec="int4", block=256)
    with pytest.raises(ValueError, match="even"):
        codec_ops.encode_array(x.detach(), codec="int4", block=131)


# (B, T, H, hd, with s0): rwkv6-3b decode (8 slots, 40 heads of 64), a
# ragged and a long forward, the reduced and the widest head dims
WKV_CASES = [(8, 1, 40, 64, True), (2, 300, 4, 64, True),
             (2, 37, 3, 32, False), (1, 17, 2, 16, True),
             (2, 20, 2, 128, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,T,H,hd,with_s0", WKV_CASES)
def test_wkv_scan_kernel_matches_plain_on_card(cuda, B, T, H, hd, with_s0,
                                               dtype):
    r, k, v, w, u, s0 = (torch.from_numpy(a).to(cuda)
                         for a in wkv_case(B, T, H, hd, seed=T))
    r, k, v, w = (a.to(TORCH_DT[dtype]) for a in (r, k, v, w))
    s0 = s0 if with_s0 else None
    o, sT = wkv_scan(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    o_ref, s_ref = wkv_scan_ref(r, k, v, w, u, s0)
    assert o.dtype == r.dtype
    if dtype == "float32":
        assert_scan_close(o, o_ref)
    else:
        assert_close(o, o_ref, dtype)
    assert torch.equal(sT, s_ref)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,D,with_h0", [(4, 1, 4096, True),
                                           (3, 1, 130, False),
                                           (4, 512, 4096, True),
                                           (2, 300, 130, False),
                                           (2, 300, 130, True)])
def test_lru_scan_kernel_matches_plain_on_card(cuda, B, T, D, with_h0):
    a, b, h0 = (torch.from_numpy(x).to(cuda) for x in lru_case(B, T, D, T))
    h0 = h0 if with_h0 else None
    got = lru_scan(a, b, h0)
    torch.cuda.synchronize()
    want = lru_scan_ref(a, b, h0)
    if T == 1:
        assert torch.equal(got, want)
    else:
        assert_scan_close(got, want)


@pytest.mark.cuda
def test_scan_kernels_refuse_gradients_on_card(cuda):
    r, k, v, w, u, s0 = (torch.from_numpy(a).to(cuda)
                         for a in wkv_case(1, 2, 2, 16, seed=0))
    r.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        wkv_scan(r, k, v, w, u, s0)
    a, b, h0 = (torch.from_numpy(x).to(cuda) for x in lru_case(1, 2, 8, 0))
    b.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        lru_scan(a, b, h0)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,n_layers", [("rwkv6_3b", None),
                                           ("recurrentgemma_9b", 5)])
def test_lockstep_decode_launches_scans_on_card(cuda, arch, n_layers):
    """One scan launch per recurrent layer per decode step, and the kernel
    path's logits equal the plain path's at f32 within the scans'
    tolerance."""
    import dataclasses
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.models import api
    cfg = get_config(arch).reduced()
    cfg = dataclasses.replace(cfg, compute_dtype="float32",
                              n_layers=n_layers or cfg.n_layers)
    params = api.prepare_params(cfg, api.init_params(
        cfg, torch.Generator(cuda).manual_seed(0), cuda))
    caches = {impl: api.init_cache(cfg, 3, 16, cuda)
              for impl in ("auto", "ref")}
    n_scan = (cfg.n_layers if cfg.family == "ssm" else
              sum(kind == "rglru" for kind in
                  (cfg.block_pattern * cfg.n_layers)[:cfg.n_layers]))
    name = "wkv_scan" if cfg.family == "ssm" else "lru_scan"
    tokens = torch.tensor([1, 7, 300], device=cuda)
    for step in range(4):
        kernels.reset_launch_counts()
        got, _ = api.decode_step(cfg, params, caches["auto"], tokens)
        assert kernels.launch_counts()[name] == n_scan
        want, _ = api.decode_step(cfg, params, caches["ref"], tokens,
                                  impl="ref")
        torch.cuda.synchronize()
        assert_scan_close(got, want)
        tokens = want.argmax(-1)
