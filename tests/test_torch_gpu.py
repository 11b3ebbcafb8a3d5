"""The port on the card: each CUDA kernel against its plain PyTorch
version on the same card inputs, the ``ops`` wrappers and the sharded
serving path on ``"cuda"`` against ``"cpu"``.  Every test is marked
``gpu`` and skips when CUDA is absent; on a card run them with
``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py``
(this file imports no JAX, so it runs where only the port is
installed)."""

from torch_parity import kernel_inputs, registry_arrays

import numpy as np
import pytest
import torch

from repro_torch.kernels import factorize, gcd, launch_counts, ops, ref
from repro_torch.serving.engine import ServingEngine


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("n,p", [(1, 1), (37, 300), (1000, 517),
                                 (4099, 1030)])
def test_cuda_kernels_match_plain(cuda_device, dtype, n, p):
    comps, primes = kernel_inputs(n, p, dtype, seed=n + p)
    c = torch.from_numpy(comps).to(cuda_device)
    q = torch.from_numpy(primes).to(cuda_device)
    assert torch.equal(factorize.divisibility_mask(c, q),
                       ref.divisibility_mask_ref(c, q))
    for x, y in zip(factorize.factorize_squarefree(c, q),
                    ref.factorize_squarefree_ref(c, q)):
        assert torch.equal(x, y)
    b = torch.roll(c, 1)
    assert torch.equal(gcd.gcd(c, b), ref.gcd_ref(c, b))
    assert torch.equal(gcd.gcd(c, b), torch.gcd(c, b))
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_cuda_wrappers_count_launches_and_check_inputs(cuda_device):
    before = launch_counts()
    ops.gcd_batch([12, 18], [8, 27], device="cuda")
    ops.divisibility_scan([6, 10], [2, 5], device="cuda")
    ops.factorize_batch([6, 10], [2, 5], device="cuda")
    after = launch_counts()
    assert all(after[k] == before[k] + 1 for k in before)
    empty = torch.empty(0, dtype=torch.int64, device=cuda_device)
    assert gcd.gcd(empty, empty).numel() == 0
    assert launch_counts() == after
    with pytest.raises(TypeError):
        gcd.gcd(torch.ones(4, device=cuda_device),
                torch.ones(4, device=cuda_device))
    with pytest.raises(ValueError):
        gcd.gcd(torch.arange(4, device=cuda_device),
                torch.arange(4))


@pytest.mark.gpu
@pytest.mark.parametrize("n,q", [(5, 3), (300, 40), (2000, 700)])
def test_cuda_ops_match_cpu(cuda_device, n, q):
    comps, primes = kernel_inputs(n, q, np.int64, seed=n)
    b = np.resize(primes * 3, n)
    for fn, args in ((ops.divisibility_scan, (comps, primes)),
                     (ops.factorize_batch, (comps, primes)),
                     (ops.gcd_batch, (comps, b))):
        got, want = fn(*args, device="cuda"), fn(*args, device="cpu")
        assert repr(got) == repr(want), fn.__name__


@pytest.mark.gpu
def test_cuda_sharded_serving_matches_cpu(cuda_device):
    def run(device):
        rng = np.random.default_rng(0)
        eng = ServingEngine(None, None, max_batch=16, page_size=16,
                            hbm_pages=24, kv="sharded", prefetch_budget=4,
                            reread_window=2, shards=2, device=device)
        groups = [list(rng.integers(0, 30_000, size=64)) for _ in range(6)]
        for r in range(48):
            tail = list(rng.integers(0, 30_000,
                                     size=int(rng.integers(48, 129))))
            eng.submit(groups[r % len(groups)] + tail, max_new_tokens=8)
        eng.run_until_idle()
        return eng

    before = launch_counts()
    card = run("cuda")
    launched = {k: v - before[k] for k, v in launch_counts().items()}
    host = run("cpu")
    assert min(launched.values()) > 0, launched
    assert card.pages.stats.parity_tuple() == host.pages.stats.parity_tuple()
    assert card.pages.prefetch_log == host.pages.prefetch_log
    assert card.pages.successor_rows() == host.pages.successor_rows()
    assert card.pages.last_scan == host.pages.last_scan
    assert card.pages.last_scan.cross_composites > 0
    ra, rb = registry_arrays(card.pages), registry_arrays(host.pages)
    assert ra["members"] == rb["members"]
    np.testing.assert_array_equal(ra["composites"], rb["composites"])
