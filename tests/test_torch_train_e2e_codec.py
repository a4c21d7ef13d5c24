"""The training slice end to end with the wire codec (int8 and int4, block
256, error feedback on) against the JAX package: `static4_paper` cut to 48
steps through both packages' `build_experiment` from the same params, for
cocodc and streaming in both engine layouts and for diloco.

Required: every `stats()` value identical (`bytes_sent`, `wire_bytes_raw`,
the compression ratio, the sync schedule, `n_syncs`, `wall_clock_s`,
...) and losses within `DISCRETE_PAYLOAD_RTOL` (1e-3): the codec rounds
each element to a code, so an ulp-level f32 difference can move an element
to the neighbouring code and compound (see test_torch_train_e2e.py).
"""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

from test_torch_kernels_cuda import one_torch_thread  # noqa: E402,F401
from test_torch_train_e2e import (DISCRETE_PAYLOAD_RTOL, check_pair,  # noqa: E402
                                  run_pair)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

RATIO = {"int8": 3.938, "int4": 7.757}


@pytest.mark.parametrize("codec", ["int8", "int4"])
@pytest.mark.parametrize("method,fused", [
    ("cocodc", True), ("cocodc", False), ("streaming", True),
    ("streaming", False), ("diloco", True)])
def test_static4_paper_with_codec_matches_jax(method, fused, codec):
    jh, th = run_pair(method, fused, extensions={"wire_codec": codec})
    check_pair(jh, th, rtol=DISCRETE_PAYLOAD_RTOL)
    s = th[-1]
    assert s["n_syncs"] > 0
    assert s["compression_ratio"] == pytest.approx(RATIO[codec], abs=2e-3)
    assert s["wire_bytes_raw"] / s["bytes_sent"] == s["compression_ratio"]
