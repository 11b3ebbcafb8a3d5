"""The port's kernels against the reference: plain PyTorch versions vs
``repro.kernels.ref`` and vs the Pallas kernels in interpret mode, the
``ops`` wrappers vs ``repro.kernels.ops``.  Integer kernels: every
comparison is exact.  The CUDA kernels are held against the same plain
versions on the card by ``tests/test_torch_gpu.py``."""

from torch_parity import kernel_inputs

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import enable_x64

from hypothesis_compat import given, settings, st
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.factorize import (divisibility_mask_pallas,
                                     factorize_squarefree_pallas)
from repro.kernels.gcd import gcd_pallas
from repro_torch.kernels import factorize as tfac
from repro_torch.kernels import gcd as tgcd
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

PRIMES_SMALL = np.array(
    [2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37, 41, 43, 47, 53, 59, 61,
     67, 71, 73, 79, 83, 89, 97, 101, 103, 107, 109, 113], dtype=np.int64)

DTYPES = {np.int32: torch.int32, np.int64: torch.int64}


class _null:
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


def _x64(dtype):
    return enable_x64(True) if dtype == np.int64 else _null()


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# --------------------------------------------------------------------------- #
# plain versions vs repro.kernels.ref                                          #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("n,p", [(1, 1), (37, 5), (130, 33), (300, 70)])
@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_plain_mask_and_factorize_match_ref(n, p, dtype):
    comps, primes = kernel_inputs(n, p, dtype, seed=n * 7 + p)
    with _x64(dtype):
        mref = np.asarray(jref.divisibility_mask_ref(jnp.asarray(comps),
                                                     jnp.asarray(primes)))
        fmref, rref = jref.factorize_squarefree_ref(jnp.asarray(comps),
                                                    jnp.asarray(primes))
    mask = tref.divisibility_mask_ref(_t(comps), _t(primes)).numpy()
    fmask, res = tref.factorize_squarefree_ref(_t(comps), _t(primes))
    np.testing.assert_array_equal(mask, mref)
    np.testing.assert_array_equal(fmask.numpy(), np.asarray(fmref))
    np.testing.assert_array_equal(res.numpy(), np.asarray(rref))
    assert res.dtype == DTYPES[dtype]


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_plain_gcd_matches_ref(dtype):
    rng = np.random.default_rng(3)
    hi = 2**28 if dtype == np.int32 else 2**40
    a = rng.integers(0, hi, size=1000).astype(dtype)
    b = rng.integers(0, hi, size=1000).astype(dtype)
    a[:4], b[:4] = [0, 5, 0, 12], [7, 0, 0, 18]
    with _x64(dtype):
        g_ref = np.asarray(jref.gcd_ref(jnp.asarray(a), jnp.asarray(b)))
    g = tref.gcd_ref(_t(a), _t(b)).numpy()
    np.testing.assert_array_equal(g, g_ref)
    np.testing.assert_array_equal(g, np.gcd(a, b))


@given(comps=st.lists(st.integers(0, 2**40), min_size=1, max_size=40),
       primes=st.lists(st.integers(0, 5000), min_size=1, max_size=40))
@settings(max_examples=40, deadline=None)
def test_plain_versions_property(comps, primes):
    """Any non-negative int64 inputs: mask and gcd equal the reference;
    the residual too wherever the product of dividing pool values cannot
    overflow (true primes, as the registry pools are)."""
    c = np.asarray(comps, dtype=np.int64)
    p = np.asarray(primes, dtype=np.int64)
    with enable_x64(True):
        mref = np.asarray(jref.divisibility_mask_ref(jnp.asarray(c),
                                                     jnp.asarray(p)))
        g_ref = np.asarray(jref.gcd_ref(jnp.asarray(c),
                                        jnp.asarray(np.resize(p, c.size))))
    np.testing.assert_array_equal(
        tref.divisibility_mask_ref(_t(c), _t(p)).numpy(), mref)
    np.testing.assert_array_equal(
        tref.gcd_ref(_t(c), _t(np.resize(p, c.size))).numpy(), g_ref)
    prime_pool = np.asarray([q for q in set(primes) if q in set(
        int(x) for x in PRIMES_SMALL)] or [2], dtype=np.int64)
    with enable_x64(True):
        _, rref = jref.factorize_squarefree_ref(jnp.asarray(c),
                                                jnp.asarray(prime_pool))
    _, res = tref.factorize_squarefree_ref(_t(c), _t(prime_pool))
    np.testing.assert_array_equal(res.numpy(), np.asarray(rref))


# --------------------------------------------------------------------------- #
# plain versions (through the wrappers, CPU tensors) vs Pallas interpret      #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_wrappers_match_pallas_interpret(dtype):
    comps, primes = kernel_inputs(64, 256, dtype, seed=11)
    a, b = kernel_inputs(256, 256, dtype, seed=12)[0], np.resize(comps, 256)
    with _x64(dtype):
        mask_p = divisibility_mask_pallas(
            jnp.asarray(comps), jnp.asarray(primes), block_n=32,
            block_p=128, interpret=True)
        fmask_p, res_p = factorize_squarefree_pallas(
            jnp.asarray(comps), jnp.asarray(primes), block_n=32,
            block_p=128, interpret=True)
        g_p = gcd_pallas(jnp.asarray(a), jnp.asarray(b), block_n=128,
                         interpret=True)
    np.testing.assert_array_equal(
        tfac.divisibility_mask(_t(comps), _t(primes)).numpy(),
        np.asarray(mask_p))
    fmask, res = tfac.factorize_squarefree(_t(comps), _t(primes))
    np.testing.assert_array_equal(fmask.numpy(), np.asarray(fmask_p))
    np.testing.assert_array_equal(res.numpy(), np.asarray(res_p))
    np.testing.assert_array_equal(tgcd.gcd(_t(a), _t(b)).numpy(),
                                  np.asarray(g_p))


# --------------------------------------------------------------------------- #
# ops wrappers: padding, dtype pick, compaction — port vs reference           #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("n,q,big", [(5, 3, False), (300, 40, False),
                                     (70, 9, True)])
def test_ops_match_reference(n, q, big):
    """Ragged sizes through both packages' ops (padding with 1 / 0, the
    int32/int64 pick at 2**31 - 1, host compaction)."""
    dtype = np.int64 if big else np.int32
    comps, primes = kernel_inputs(n, q, dtype, seed=n + q)
    comps, primes = comps.astype(np.int64), primes.astype(np.int64)
    scan = tops.divisibility_scan(comps, primes, device="cpu")
    scan_ref = jops.divisibility_scan(comps, primes)
    assert [list(x) for x in scan] == [list(x) for x in scan_ref]
    facs, res = tops.factorize_batch(comps, primes, device="cpu")
    facs_ref, res_ref = jops.factorize_batch(comps, primes)
    assert facs == facs_ref
    np.testing.assert_array_equal(res, res_ref)
    assert res.dtype == np.int64
    b = np.resize(primes * 3, n)
    g = tops.gcd_batch(comps, b, device="cpu")
    np.testing.assert_array_equal(g, jops.gcd_batch(comps, b))
    assert tops.factorize_batch_exact(comps, primes, device="cpu") == \
        jops.factorize_batch_exact(comps, primes)
    assert tops.gcd_batch_exact(comps, b, primes, device="cpu") == \
        jops.gcd_batch_exact(comps, b, primes)


@pytest.mark.parametrize("case", ["ragged", "int64", "compaction", "empty"])
def test_ops_reference_sweeps(case):
    """The reference's own wrapper sweeps (tests/test_kernels.py), run
    through the port on the CPU."""
    if case == "ragged":
        facs, resid = tops.factorize_batch([6, 35, 143, 101],
                                           [2, 3, 5, 7, 11, 13], device="cpu")
        assert facs == [[2, 3], [5, 7], [11, 13], []]
        assert list(resid) == [1, 1, 1, 101]
    elif case == "int64":
        big = 1_000_003 * 1_000_033
        facs, resid = tops.factorize_batch([big], [1_000_003, 1_000_033],
                                           device="cpu")
        assert facs[0] == [1_000_003, 1_000_033] and resid[0] == 1
    elif case == "compaction":
        idx = tops.divisibility_scan([6, 10, 15, 21], [2, 3, 5, 7],
                                     device="cpu")
        assert [list(i) for i in idx] == [[0, 1], [0, 2, 3], [1, 2], [3]]
    else:
        out = tops.divisibility_scan([], [3], device="cpu")
        assert len(out) == 1 and len(out[0]) == 0
        assert tops.gcd_batch([], [], device="cpu").size == 0
        assert tops.factorize_batch([], [2], device="cpu")[0] == []


@given(comps=st.lists(st.integers(0, 2**45), min_size=1, max_size=30),
       idx=st.lists(st.integers(0, len(PRIMES_SMALL) - 1), min_size=1,
                    max_size=12))
@settings(max_examples=12, deadline=None)
def test_ops_property_vs_reference(comps, idx):
    primes = [int(PRIMES_SMALL[i]) for i in idx] + [0, 1]
    assert [list(x) for x in tops.divisibility_scan(comps, primes,
                                                    device="cpu")] == \
        [list(x) for x in jops.divisibility_scan(comps, primes)]
    facs, res = tops.factorize_batch(comps, primes, device="cpu")
    facs_ref, res_ref = jops.factorize_batch(comps, primes)
    assert facs == facs_ref
    np.testing.assert_array_equal(res, res_ref)


# --------------------------------------------------------------------------- #
# input checks                                                                 #
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("bad,exc", [
    (lambda: tops.divisibility_scan([6, -1], [2], device="cpu"), ValueError),
    (lambda: tops.gcd_batch([4], [-2], device="cpu"), ValueError),
    (lambda: tops.factorize_batch_limbs(np.array([[-1, 1]]), [2],
                                        device="cpu"), ValueError),
    (lambda: tfac.divisibility_mask(torch.ones(3), torch.ones(3)), TypeError),
    (lambda: tfac.divisibility_mask(torch.ones(3, dtype=torch.int32),
                                    torch.ones(3, dtype=torch.int64)),
     ValueError),
    (lambda: tgcd.gcd(torch.arange(8)[::2], torch.arange(4)), ValueError),
])
def test_wrappers_reject_bad_input(bad, exc):
    with pytest.raises(exc):
        bad()


def test_cpu_tensors_do_not_count_launches():
    """A CPU tensor takes the plain version: no kernel, no launch."""
    from repro_torch.kernels import launch_counts
    before = launch_counts()
    tops.gcd_batch([12, 18], [8, 27], device="cpu")
    tops.divisibility_scan([6], [2], device="cpu")
    assert launch_counts() == before


# --------------------------------------------------------------------------- #
# the build (with a stand-in for nvcc: the real one runs on the card's host)  #
# --------------------------------------------------------------------------- #

_FAKE_NVCC = """#!/bin/sh
# stand-in for nvcc: keeps a temporary file in $TMPDIR while it "compiles"
# (longer for some sources), then checks it is still there
for last; do :; done
out=""; prev=""
for a in "$@"; do [ "$prev" = "-o" ] && out="$a"; prev="$a"; done
echo "ptxas info    : Used 8 registers" 
echo partial > "$TMPDIR/$$.s" || exit 3
case "$last" in *divmask*) ;; *) sleep 0.5 ;; esac
[ -f "$TMPDIR/$$.s" ] || { echo "can't open $TMPDIR/$$.s"; exit 1; }
echo lib > "$out"
"""


def test_build_all_runs_the_builds_side_by_side(tmp_path, monkeypatch):
    """One nvcc per source, started together, each with its own temporary
    directory (one build finishing early must not pull another's files
    away); each library lands under its hashed name with its log."""
    from repro_torch.kernels import KERNELS, build_all, cuda

    bindir = tmp_path / "bin"
    bindir.mkdir()
    nvcc = bindir / "nvcc"
    nvcc.write_text(_FAKE_NVCC)
    nvcc.chmod(0o755)
    monkeypatch.setenv("PATH", f"{bindir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setattr(cuda, "build_dir", lambda: tmp_path / "build")
    (tmp_path / "build").mkdir()
    assert cuda.nvcc_path() == str(nvcc)
    build_all()
    for k in KERNELS.values():
        assert k.library_path().read_text() == "lib\n"
        assert "Used 8 registers" in k.build_log()
    assert sorted(p.name for p in (tmp_path / "build").iterdir()
                  if p.is_dir()) == []


def test_nvcc_lookup_names_every_place_tried(monkeypatch):
    from torch.utils import cpp_extension

    from repro_torch.kernels import cuda

    monkeypatch.setenv("PATH", "")
    monkeypatch.setenv("CUDA_HOME", "/nonexistent/cuda-home")
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(cpp_extension, "CUDA_HOME", None)
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("this host has a CUDA toolkit")
    with pytest.raises(RuntimeError) as err:
        cuda.nvcc_path()
    msg = str(err.value)
    for place in ("PATH", "/nonexistent/cuda-home/bin/nvcc",
                  "CUDA_PATH (unset)", "cpp_extension.CUDA_HOME (unset)",
                  "/usr/local/cuda/bin/nvcc"):
        assert place in msg, place


def test_build_dir_names_itself_when_it_cannot_be_made(tmp_path,
                                                       monkeypatch):
    """One build directory: when it cannot be created the error names it
    (no second place is tried)."""
    from repro_torch.kernels import cuda

    blocker = tmp_path / "not-a-dir"
    blocker.write_text("")
    monkeypatch.setattr(cuda, "BUILD_DIR", blocker / "build")
    with pytest.raises(RuntimeError) as err:
        cuda.build_dir()
    assert str(blocker / "build") in str(err.value)
    assert "cannot be created" in str(err.value)
    monkeypatch.setattr(cuda, "BUILD_DIR", tmp_path / "build")
    assert cuda.build_dir() == tmp_path / "build"
    assert (tmp_path / "build").is_dir()
