"""Port ↔ reference: the ABFT flash-attention forward K2. The port's plain
version (what the CUDA kernel computes, on the kernel's block grid) against
the reference's Pallas kernel in interpret mode, at the reference's pinned
(bq, bkv), on the same numpy-seeded inputs.

Tolerances: outputs to 1e-5. Reports: det/corr/row/col/k equal, tau and
mag to 1e-5 relative; a clean block's max_residual is f32 rounding noise in
two summation orders, so there both sides only have to stay below tau.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core.policy import InjectionSpec, ONLINE_BLOCK  # noqa: E402
from repro.kernels import flashft as rflash, ops as rops  # noqa: E402
from repro.kernels import ref as rref  # noqa: E402

from repro_torch.core.policy import ONLINE_BLOCK as T_ONLINE  # noqa: E402
from repro_torch.core.policy import InjectionSpec as TSpec  # noqa: E402
from repro_torch.kernels import flashft as tflash, ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402


def _qkv(seed, bh, n_rep, sq, skv, dh):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(bh, sq, dh)).astype(np.float32)
    k = rng.normal(size=(bh // n_rep, skv, dh)).astype(np.float32)
    v = rng.normal(size=(bh // n_rep, skv, dh)).astype(np.float32)
    return q, k, v


def _check_report(got, want):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[..., [0, 1, 2, 3, 7]],
                                  want[..., [0, 1, 2, 3, 7]])
    np.testing.assert_allclose(got[..., [4, 6]], want[..., [4, 6]],
                               rtol=1e-5, atol=0)
    det = want[..., 0] > 0
    np.testing.assert_allclose(got[..., 5][det], want[..., 5][det], rtol=1e-5)
    assert np.all(got[..., 5][~det] < got[..., 6][~det])
    assert np.all(want[..., 5][~det] < want[..., 6][~det])


@pytest.mark.parametrize("geom", [
    (4, 1, 40, 40, True),      # MHA, causal
    (4, 2, 40, 40, True),      # GQA n_rep 2
    (7, 7, 24, 150, True),     # GQA n_rep 7 (qwen2-7b's), ragged Sq != Skv
    (2, 1, 50, 130, False),    # non-causal, ragged
])
def test_flash_matches_reference(geom):
    bh, n_rep, sq, skv, causal = geom
    q, k, v = _qkv(bh * sq, bh, n_rep, sq, skv, 16)
    bq = rops._flash_fit(sq, 16, 8)
    bkv = rops._flash_fit(skv, 128, 128)
    ro, rr = rops.flash_ft(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           ft=ONLINE_BLOCK, causal=causal, n_rep=n_rep,
                           bq=16, bkv=128, interpret=True)
    to, tr = tops.flash_ft(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), ft=T_ONLINE, causal=causal,
                           n_rep=n_rep, bq=bq, bkv=bkv)
    np.testing.assert_allclose(to.numpy(), np.asarray(ro), rtol=1e-5,
                               atol=1e-5)
    _check_report(tr, rr)
    assert float(tr[..., 0].sum()) == 0.0
    if n_rep == 1:   # the plain oracles of both packages agree too
        want = rref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), causal=causal)
        got = tref.flash_attention_ref(torch.from_numpy(q),
                                       torch.from_numpy(k),
                                       torch.from_numpy(v), causal=causal)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(to.numpy(), got.numpy(), rtol=1e-4,
                                   atol=1e-4)


def test_flash_seu_in_delta_corrected_and_located():
    """A deterministic SEU in Δ = PV of (head 6, q block 1, kv step 1),
    element (3, 5): corrected before the rescale, reported at the injected
    block with row q_start + 3 and column 5, like the reference."""
    bh, n_rep, sq, skv = 7, 7, 24, 150
    q, k, v = _qkv(3, bh, n_rep, sq, skv, 16)
    spec = InjectionSpec(row=3, col=5, magnitude=100.0, k_step=1)
    kw = dict(causal=True, n_rep=n_rep, inj_bh=6, inj_q_block=1)
    ro, rr = rops.flash_ft(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           ft=ONLINE_BLOCK, spec=spec, bq=8, bkv=128,
                           interpret=True, **kw)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    to, tr = tops.flash_ft(tq, tk, tv, ft=T_ONLINE, spec=TSpec(3, 5, 100.0, 1),
                           bq=8, bkv=128, **kw)
    clean, _ = tops.flash_ft(tq, tk, tv, ft=T_ONLINE, bq=8, bkv=128,
                             causal=True, n_rep=n_rep)
    np.testing.assert_allclose(to.numpy(), np.asarray(ro), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(to.numpy(), clean.numpy(), rtol=1e-5,
                               atol=1e-5)
    _check_report(tr, rr)
    assert float(tr[..., 0].sum()) == 1.0
    cell = tr[6, 1]
    assert (cell[0], cell[2], cell[3]) == (1.0, 8 + 3, 5)
    assert abs(float(cell[4]) - 100.0) < 1e-3


def test_flash_injection_outside_the_grid_raises():
    q, k, v = (torch.zeros(2, 8, 16), torch.zeros(2, 8, 16),
               torch.zeros(2, 8, 16))
    with pytest.raises(ValueError, match="never"):
        tops.flash_ft(q, k, v, spec=TSpec(0, 0, 1.0, 0), inj_q_block=1)


@pytest.mark.parametrize("case", ["ragged_sq_edge", "causal_empty_kv_span"])
def test_degenerate_rows_are_exact_zeros(case):
    """Rows with no live key flush exact zeros, in both implementations:
    dead rows past the true Sq (checked on the padded kernel-level call of
    the reference) and causal rows whose bottom-right-aligned kv span is
    empty (true Skv < Sq)."""
    rng = np.random.default_rng(6)
    dh = 128
    if case == "ragged_sq_edge":
        sq, skv, causal, true_sq = 128, 128, False, 100
    else:
        sq, skv, causal, true_sq = 128, 64, True, 128
    q = rng.normal(size=(1, sq, dh)).astype(np.float32)
    k = rng.normal(size=(1, 128, dh)).astype(np.float32)
    v = rng.normal(size=(1, 128, dh)).astype(np.float32)
    inj, mag = rflash.encode_injection(None)
    ro_full, rr = rflash.flash_ft_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), inj, mag,
        jnp.array([true_sq, skv], jnp.int32), bq=128, bkv=128, causal=causal,
        ft=ONLINE_BLOCK, interpret=True)
    ro_full = np.asarray(ro_full)
    to, tr = tflash.flash_ft_plain(
        torch.from_numpy(q[:, :true_sq]), torch.from_numpy(k[:, :skv]),
        torch.from_numpy(v[:, :skv]), ft=T_ONLINE, scale=dh ** -0.5,
        tau_dh=dh, causal=causal, bq=128, bkv=128)
    np.testing.assert_allclose(to.numpy(), ro_full[:, :true_sq], rtol=1e-5,
                               atol=1e-5)
    assert np.all(np.isfinite(to.numpy()))
    assert float(tr[..., 0].sum()) == 0.0 == float(np.asarray(rr)[..., 0].sum())
    if case == "ragged_sq_edge":
        assert np.all(ro_full[0, true_sq:] == 0.0)
    else:
        empty = sq - skv
        assert np.all(to.numpy()[0, :empty] == 0.0)
        assert np.all(ro_full[0, :empty] == 0.0)
