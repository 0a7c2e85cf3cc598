"""Port ↔ reference: the baseline GEMM rungs (`kernels.gemm`: K9
`naive_gemm`, and `gemm` / `gemm_masked` = K1 with FT off) and
`core.ft_verdict_dot`. The port's plain versions against the reference's
Pallas kernels in interpret mode and its jnp ABFT path, on the same
numpy-seeded inputs.

Tolerances: f32 outputs rtol 1e-5 / atol 1e-4 (two summation orders);
bf16 one bf16 ulp at the top of the output's range; a corrected SEU to
the fault-free product within the reference's own tolerances
(tests/test_core_abft.py).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core import ft_verdict_dot as r_verdict_dot  # noqa: E402
from repro.core.policy import (FT_OFF, InjectionSpec, NONFUSED_BASELINE,  # noqa: E402
                               OFFLINE_DETECT, ONLINE_BLOCK)
from repro.kernels import autotune, gemm as rgemm  # noqa: E402

from repro_torch import core as tcore  # noqa: E402
from repro_torch.core import policy as tpol  # noqa: E402
from repro_torch.kernels import ft_gemm as tft_gemm  # noqa: E402
from repro_torch.kernels import gemm as tgemm  # noqa: E402

POLICIES = {"online": (ONLINE_BLOCK, tpol.ONLINE_BLOCK),
            "nonfused": (NONFUSED_BASELINE, tpol.NONFUSED_BASELINE),
            "detect": (OFFLINE_DETECT, tpol.OFFLINE_DETECT),
            "off": (FT_OFF, tpol.FT_OFF)}


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _ab(m, k, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(m, k)).astype(np.float32),
            rng.normal(size=(k, n)).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(256, 512, 384), (64, 256, 128)])
def test_naive_gemm_matches_reference(shape, dtype):
    m, k, n = shape
    a, b = _ab(m, k, n, m + n)
    want = np.asarray(rgemm.naive_gemm(jnp.asarray(a, dtype),
                                       jnp.asarray(b, dtype), interpret=True)
                      .astype(jnp.float32))
    tdt = getattr(torch, dtype)
    got = tgemm.naive_gemm_plain(_t(a).to(tdt), _t(b).to(tdt))
    assert got.dtype == tdt and got.shape == (m, n)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)
    else:
        tol = 2.0 ** -7 * np.abs(want).max()
        assert np.abs(got.float().numpy() - want).max() <= tol
    # the front takes a CPU tensor to the plain version
    assert torch.equal(tgemm.naive_gemm(_t(a).to(tdt), _t(b).to(tdt)), got)


@pytest.mark.parametrize("fn", ["naive_gemm", "naive_gemm_plain"])
def test_naive_gemm_contract(fn):
    """M and N each at most 128 or a multiple of it: the reference's grid
    leaves the tail of an M of 200 uncomputed; the port raises."""
    call = getattr(tgemm, fn)
    with pytest.raises(ValueError):
        call(torch.ones(200, 64), torch.ones(64, 128))
    with pytest.raises(ValueError):
        call(torch.ones(128, 64), torch.ones(64, 300))
    with pytest.raises(NotImplementedError):
        call(torch.ones(128, 64), torch.ones(64, 256),
             out_dtype=torch.bfloat16)
    assert call(torch.ones(100, 64), torch.ones(64, 384)).shape == (100, 384)


@pytest.mark.parametrize("tiles", tft_gemm.TILES)
def test_gemm_rungs_match_reference(tiles):
    """`gemm` (tile-divisible) and `gemm_masked` (ragged) at each compiled
    tile against the reference's plain and masked kernels."""
    a, b = _ab(256, 384, 256, 3)
    want = rgemm.gemm(jnp.asarray(a), jnp.asarray(b),
                      params=autotune.KernelParams(128, 128, 128),
                      interpret=True)
    got = tgemm.gemm(_t(a), _t(b), tiles=tiles)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)
    m, k, n = 100, 300, 77
    a, b = _ab(m, k, n, 4)
    p = autotune.KernelParams(104, 128, 384)
    ap = np.pad(a, ((0, 4), (0, 84)))
    bp = np.pad(b, ((0, 84), (0, 51)))
    want = rgemm.gemm_masked(jnp.asarray(ap), jnp.asarray(bp),
                             jnp.array([m, n, k], jnp.int32), params=p,
                             interpret=True)[:m, :n]
    got = tgemm.gemm_masked(_t(a), _t(b), tiles=tiles)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("policy", ["online", "nonfused"])
def test_verdict_dot_corrects_like_reference(policy):
    """tests/test_core_abft.py:35: an SEU detected, located, corrected."""
    a, w = _ab(64, 32, 48, 0)
    spec = InjectionSpec(row=10, col=20, magnitude=100.0)
    rft, tft = POLICIES[policy]
    rout, rv = r_verdict_dot(jnp.asarray(a), jnp.asarray(w), rft, spec=spec)
    tout, tv = tcore.ft_verdict_dot(_t(a), _t(w), tft,
                                    spec=tpol.InjectionSpec(10, 20, 100.0))
    assert bool(tv.detected) and bool(rv.detected)
    assert (int(tv.row), int(tv.col)) == (int(rv.row), int(rv.col)) == (10, 20)
    np.testing.assert_allclose(float(tv.magnitude), float(rv.magnitude),
                               rtol=1e-4)
    np.testing.assert_allclose(tout.numpy(), np.asarray(rout), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(tout.numpy(), a @ w, rtol=1e-5, atol=1e-4)


def test_verdict_dot_detect_only_leaves_error():
    """tests/test_core_abft.py:44."""
    a, w = _ab(64, 32, 48, 0)
    tout, tv = tcore.ft_verdict_dot(_t(a), _t(w), tpol.OFFLINE_DETECT,
                                    spec=tpol.InjectionSpec(10, 20, 100.0))
    rout, rv = r_verdict_dot(jnp.asarray(a), jnp.asarray(w), OFFLINE_DETECT,
                             spec=InjectionSpec(row=10, col=20,
                                                magnitude=100.0))
    assert bool(tv.detected) and bool(rv.detected)
    assert abs(float(tout[10, 20]) - (a @ w)[10, 20] - 100.0) < 1e-3
    np.testing.assert_allclose(tout.numpy(), np.asarray(rout), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize("case", range(6))
def test_verdict_dot_single_error_always_located(case):
    """tests/test_core_abft.py:140 as a seeded sweep: any single SEU above
    the threshold is detected, located exactly and corrected, fused and
    non-fused, as the reference does."""
    rng = np.random.default_rng(100 + case)
    m, k, n = (int(x) for x in rng.integers(4, 33, 3))
    row, col = int(rng.integers(0, m)), int(rng.integers(0, n))
    mag = float(rng.uniform(1.0, 1e5)) * (1.0 if case % 2 else -1.0)
    a, b = _ab(m, k, n, case)
    for policy in ("online", "nonfused"):
        rft, tft = POLICIES[policy]
        tout, tv = tcore.ft_verdict_dot(_t(a), _t(b), tft,
                                        spec=tpol.InjectionSpec(row, col,
                                                                mag))
        _, rv = r_verdict_dot(jnp.asarray(a), jnp.asarray(b), rft,
                              spec=InjectionSpec(row=row, col=col,
                                                 magnitude=mag))
        assert bool(tv.detected) and bool(rv.detected)
        assert (int(tv.row), int(tv.col)) == (int(rv.row), int(rv.col)) == \
            (row, col)
        np.testing.assert_allclose(tout.numpy(), a @ b, rtol=1e-4,
                                   atol=max(1e-3, 4e-7 * abs(mag)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_verdict_dot_no_false_positive(seed, dtype):
    """tests/test_core_abft.py:153 as a seeded sweep."""
    a, b = _ab(48, 64, 32, seed)
    _, tv = tcore.ft_verdict_dot(_t(a).to(getattr(torch, dtype)),
                                 _t(b).to(getattr(torch, dtype)),
                                 tpol.ONLINE_BLOCK)
    _, rv = r_verdict_dot(jnp.asarray(a, dtype), jnp.asarray(b, dtype),
                          ONLINE_BLOCK)
    assert not bool(tv.detected) and not bool(rv.detected)


def test_verdict_dot_flattens_a_batch_and_resolves_a_policy():
    a, w = _ab(12, 16, 8, 5)
    policy = tpol.FTPolicy(rules=(("w_*", tpol.NONFUSED_BASELINE),),
                           default=tpol.FT_OFF)
    out, v = tcore.ft_verdict_dot(_t(a).reshape(3, 4, 16), _t(w), policy,
                                  spec=tpol.InjectionSpec(5, 3, 50.0),
                                  site="w_up")
    assert out.shape == (12, 8) and bool(v.detected)
    assert (int(v.row), int(v.col)) == (5, 3)
    np.testing.assert_allclose(out.numpy(), a @ w, rtol=1e-5, atol=1e-4)
