"""`static4_paper` end to end against the JAX package for the methods
without fragments in flight (diloco's blocking rounds, local's none), in
both engine layouts; see test_torch_train_e2e.py for the contract."""
from __future__ import annotations

import pytest

pytest.importorskip("torch")

from test_torch_train_e2e import check_pair, run_pair  # noqa: E402
from test_torch_kernels_cuda import one_torch_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("method", ["diloco", "local"])
def test_static4_paper_matches_jax_blocking(method, fused):
    jh, th = run_pair(method, fused)
    check_pair(jh, th)
    assert (th[-1]["n_syncs"] > 0) == (method == "diloco")

