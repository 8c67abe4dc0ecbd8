"""Port parity: the histogram functions and their tiling.

On the CPU the port's wrappers run their plain PyTorch versions; these are
held against the JAX package's ``flat`` lowering and against its Pallas
kernels in interpret mode. The CUDA kernels themselves are compared with
the plain versions by the ``cuda``-marked tests (skipped without a GPU) and
by ``chip_smoke.py``.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from sagemaker_xgboost_container_tpu.ops import histogram as jax_hist
from sagemaker_xgboost_container_tpu_torch.ops import histogram as hist


@pytest.fixture
def problem():
    rng = np.random.RandomState(7)
    n, d, num_bins = 3000, 9, 33  # num_bins includes the missing slot
    bins = rng.randint(0, num_bins, size=(n, d)).astype(np.uint8)
    grad = rng.randn(n).astype(np.float32)
    hess = (rng.rand(n) + 0.1).astype(np.float32)
    return bins, grad, hess, num_bins


def _node_local(n, W, seed=8):
    # dead rows (-1) mixed in, like a level after some nodes leafed
    return np.random.RandomState(seed).randint(-1, W, size=n).astype(np.int32)


def _pallas_knobs():
    return jax_hist.resolve_hist_knobs()._replace(
        impl="pallas", totals_impl="pallas", pallas_block=256
    )


def _port_hist(bins, grad, hess, node, W, B, bin_dtype=None):
    b = torch.as_tensor(bins if bin_dtype is None else bins.astype(bin_dtype))
    G, H = hist.level_histogram(
        b, torch.as_tensor(grad), torch.as_tensor(hess), torch.as_tensor(node), W, B
    )
    return G.numpy(), H.numpy()


@pytest.mark.parametrize("W", [1, 4, 16])
@pytest.mark.parametrize("bin_dtype", [np.uint8, np.uint16, np.int32])
def test_level_histogram_matches_jax_flat(problem, W, bin_dtype):
    bins, grad, hess, B = problem
    node = _node_local(len(grad), W)
    G, H = _port_hist(bins, grad, hess, node, W, B, bin_dtype)
    rG, rH = jax_hist._hist_flat(
        jnp.asarray(bins.astype(np.int32)), jnp.asarray(grad), jnp.asarray(hess),
        jnp.asarray(node), W, B,
    )
    np.testing.assert_allclose(G, np.asarray(rG), atol=1e-4)
    np.testing.assert_allclose(H, np.asarray(rH), atol=1e-4)


@pytest.mark.parametrize("W", [1, 8])
def test_level_histogram_matches_jax_pallas_interpret(problem, W):
    bins, grad, hess, B = problem
    node = _node_local(len(grad), W)
    G, H = _port_hist(bins, grad, hess, node, W, B)
    rG, rH = jax_hist.level_histogram(
        jnp.asarray(bins), jnp.asarray(grad), jnp.asarray(hess), jnp.asarray(node),
        W, B, knobs=_pallas_knobs(),
    )
    # the Pallas kernel multiplies bf16x2 operands: ~16 mantissa bits
    np.testing.assert_allclose(G, np.asarray(rG), atol=5e-4)
    np.testing.assert_allclose(H, np.asarray(rH), atol=5e-4)


# W >= 8 keeps each total below ~250, where 1e-4 is a few f32 ulps (one
# node holding all 3000 rows sums to ~900, whose ulp is already 6e-5)
@pytest.mark.parametrize("W", [8, 64, 256])
def test_node_totals_matches_jax_pallas_interpret(problem, W):
    _, grad, hess, _ = problem
    node = _node_local(len(grad), W, seed=9)
    g, h = hist.node_totals(
        torch.as_tensor(grad), torch.as_tensor(hess), torch.as_tensor(node), W
    )
    rg, rh = jax_hist.node_totals(
        jnp.asarray(grad), jnp.asarray(hess), jnp.asarray(node), W,
        knobs=_pallas_knobs(),
    )
    np.testing.assert_allclose(g.numpy(), np.asarray(rg), atol=1e-4)
    np.testing.assert_allclose(h.numpy(), np.asarray(rh), atol=1e-4)


def test_empty_rows_give_zero_histograms():
    bins = torch.zeros((0, 4), dtype=torch.uint16)
    empty = torch.zeros(0)
    node = torch.zeros(0, dtype=torch.int32)
    G, H = hist.level_histogram(bins, empty, empty, node, 2, 9)
    assert G.shape == (2, 4, 9) and not G.any() and not H.any()
    g, h = hist.node_totals(empty, empty, node, 3)
    assert g.shape == (3,) and not g.any() and not h.any()


@pytest.mark.parametrize(
    "n,d,W,B",
    [
        (1_000_000, 28, 1, 257),
        (1_000_000, 28, 64, 257),
        (1_000_000, 28, 128, 257),
        (1_000_003, 28, 128, 256),
        (0, 28, 4, 257),
        (12_345, 5, 3, 33),
        (100, 1, 1, 2),
    ],
)
def test_hist_plan_covers_the_grid(n, d, W, B):
    p = hist.hist_plan(n, d, W, B, num_sms=132)
    assert p.smem_bytes == p.node_range * p.feature_tile * 2 * B * 4
    assert p.smem_bytes <= hist.HIST_SMEM_BUDGET
    assert p.rows_per_chunk * p.row_chunks >= n
    assert (p.row_chunks - 1) * p.rows_per_chunk < max(n, 1)
    assert p.feature_tile * p.feature_tiles >= d
    assert (p.feature_tiles - 1) * p.feature_tile < d
    assert p.node_range * p.node_ranges >= W
    assert (p.node_ranges - 1) * p.node_range < W
    assert p.rows_per_chunk * p.feature_tile < 2**31


def test_hist_plan_rejects_bins_beyond_shared_memory():
    with pytest.raises(ValueError):
        hist.hist_plan(10, 1, 1, 20_000, num_sms=132)


def test_wrappers_refuse_other_devices():
    meta = torch.empty((4, 2), dtype=torch.uint8, device="meta")
    v = torch.empty(4, device="meta")
    node = torch.empty(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        hist.level_histogram(meta, v, v, node, 1, 9)
    with pytest.raises(ValueError):
        hist.node_totals(v, v, node, 1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU; chip_smoke.py runs these checks on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("W,dtype", [(1, np.uint16), (8, np.uint8), (130, np.uint16)])
def test_hist_kernel_matches_plain(problem, cuda_device, W, dtype):
    bins, grad, hess, B = problem
    node = _node_local(len(grad), W)
    args = [torch.as_tensor(a, device=cuda_device)
            for a in (bins.astype(dtype), grad, hess, node)]
    hist.reset_launch_counts()
    G, H = hist.level_histogram(*args, W, B)
    assert hist.LAUNCHES["hist_kernel"] == 1
    Gp, Hp = hist._hist_plain(*args, W, B)
    torch.testing.assert_close(G, Gp, atol=1e-4, rtol=0)
    torch.testing.assert_close(H, Hp, atol=1e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("W", [1, 256])
def test_totals_kernel_matches_plain(problem, cuda_device, W):
    _, grad, hess, _ = problem
    node = _node_local(len(grad), W)
    args = [torch.as_tensor(a, device=cuda_device) for a in (grad, hess, node)]
    hist.reset_launch_counts()
    g, h = hist.node_totals(*args, W)
    assert hist.LAUNCHES["totals_kernel"] == 1
    gp, hp = hist._totals_plain(*args, W)
    torch.testing.assert_close(g, gp, atol=1e-4, rtol=0)
    torch.testing.assert_close(h, hp, atol=1e-4, rtol=0)
