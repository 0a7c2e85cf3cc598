"""Port ↔ reference: the flash forward's saved statistics (K2 with
``save_stats``) and the flash backward, dQ (K3) and dK/dV (K4). The port's
plain versions (what the CUDA kernels compute, on their block grids)
against the reference's Pallas kernels in interpret mode at the same pinned
(bq, bkv), on the same numpy-seeded inputs, through `ops.flash_ft` and
`ops.flash_ft_bwd` of both packages.

Tolerances: out, m, l, dq, dk, dv to 1e-5. Reports: det/corr/row/col/k
equal, tau to 1e-5 relative.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core.policy import InjectionSpec, ONLINE_BLOCK  # noqa: E402
from repro.kernels import flashft as rflash, ops as rops  # noqa: E402

from repro_torch.core.policy import ONLINE_BLOCK as T_ONLINE  # noqa: E402
from repro_torch.core.policy import InjectionSpec as TSpec  # noqa: E402
from repro_torch.kernels import flashft as tflash, ops as tops  # noqa: E402

BQ, BKV = 16, 128        # the reference's pinned tiles, fitted per shape


def _inputs(seed, bh, n_rep, sq, skv, dh=16):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(bh, sq, dh)).astype(np.float32)
    k = rng.normal(size=(bh // n_rep, skv, dh)).astype(np.float32)
    v = rng.normal(size=(bh // n_rep, skv, dh)).astype(np.float32)
    g = rng.normal(size=(bh, sq, dh)).astype(np.float32)
    return q, k, v, g


def _tiles(sq, skv):
    return rops._flash_fit(sq, BQ, 8), rops._flash_fit(skv, BKV, 128)


def _check_report(got, want):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[..., [0, 1, 2, 3, 7]],
                                  want[..., [0, 1, 2, 3, 7]])
    np.testing.assert_allclose(got[..., 6], want[..., 6], rtol=1e-5, atol=0)
    det = want[..., 0] > 0
    np.testing.assert_allclose(got[..., 4][det], want[..., 4][det],
                               rtol=1e-5)


def _forward(q, k, v, n_rep, causal):
    bq, bkv = _tiles(q.shape[1], k.shape[1])
    ref = rops.flash_ft(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        ft=ONLINE_BLOCK, causal=causal, n_rep=n_rep, bq=BQ,
                        bkv=BKV, interpret=True, save_stats=True)
    port = tops.flash_ft(torch.from_numpy(q), torch.from_numpy(k),
                         torch.from_numpy(v), ft=T_ONLINE, causal=causal,
                         n_rep=n_rep, bq=bq, bkv=bkv, save_stats=True)
    return ref, port


def _backward(q, k, v, g, o, m, l, n_rep, causal, inject=None, **inj):
    bq, bkv = _tiles(q.shape[1], k.shape[1])
    ref = rops.flash_ft_bwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(o),
        jnp.asarray(m), jnp.asarray(l), jnp.asarray(g), ft=ONLINE_BLOCK,
        causal=causal, n_rep=n_rep, bq=BQ, bkv=BKV, interpret=True,
        inject=inject, **inj)
    tinj = None if inject is None else TSpec(inject.row, inject.col,
                                             inject.magnitude, inject.k_step)
    port = tops.flash_ft_bwd(
        *(torch.from_numpy(np.array(x)) for x in (q, k, v, o, m, l, g)),
        ft=T_ONLINE, causal=causal, n_rep=n_rep, bq=bq, bkv=bkv,
        inject=tinj, **inj)
    return ref, port


GEOMS = [
    (4, 1, 40, 40, True),      # MHA, causal, ragged q edge
    (6, 3, 40, 40, True),      # GQA n_rep 3 (phi4-mini's)
    (7, 7, 24, 150, True),     # GQA n_rep 7 (qwen2-7b's), Sq != Skv
    (6, 3, 50, 130, False),    # non-causal, ragged both ways
]


@pytest.mark.parametrize("geom", GEOMS)
def test_stats_and_backward_match_reference(geom):
    bh, n_rep, sq, skv, causal = geom
    q, k, v, g = _inputs(bh * sq + skv, bh, n_rep, sq, skv)
    (ro, rm, rl, rrep), (to, tm, tl, trep) = _forward(q, k, v, n_rep, causal)
    for got, want in ((to, ro), (tm, rm), (tl, rl)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    _check_report(trep, rrep)
    ref, port = _backward(q, k, v, g, ro, rm, rl, n_rep, causal)
    for got, want in zip(port[:3], ref[:3]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    assert port[1].shape == (bh // n_rep, skv, 16)   # per kv head
    for got, want in zip(port[3:], ref[3:]):
        _check_report(got, want)
        assert float(got[..., 0].sum()) == 0.0


@pytest.mark.parametrize("target,blk,step,row,col", [
    ("dp_q", 1, 0, 3, 5),      # dP inside the dQ kernel
    ("dq", 2, 0, 7, 11),       # the dQ delta
    ("dp_kv", 0, 1, 2, 30),    # dP inside the dK/dV kernel
    ("dv", 0, 2, 33, 4),       # the dV delta (row = kv row of the block)
    ("dk", 0, 1, 39, 15),      # the dK delta
])
def test_backward_seu_corrected_and_located(target, blk, step, row, col):
    """A deterministic SEU in each backward GEMM: both packages correct it
    (gradients equal the clean run's to 1e-5; the magnitude is kept small
    so that the rounding it leaves in the corrected element, one ulp of the
    magnitude, stays below that) and report it at the same block, row and
    column."""
    bh, n_rep, sq, skv, causal = 6, 3, 40, 40, True
    q, k, v, g = _inputs(5, bh, n_rep, sq, skv)
    (ro, rm, rl, _), _ = _forward(q, k, v, n_rep, causal)
    spec = InjectionSpec(row=row, col=col, magnitude=20.0, k_step=step)
    inj = dict(inj_target=target, inj_bh=4, inj_blk=blk)
    ref, port = _backward(q, k, v, g, ro, rm, rl, n_rep, causal,
                          inject=spec, **inj)
    _, clean = _backward(q, k, v, g, ro, rm, rl, n_rep, causal)
    for got, want, base in zip(port[:3], ref[:3], clean[:3]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(got.numpy(), base.numpy(), rtol=1e-5,
                                   atol=1e-5)
    for got, want in zip(port[3:], ref[3:]):
        _check_report(got, want)
    in_dq = target in tflash.DQ_TARGETS
    rep = port[3] if in_dq else port[4]
    assert float(port[3][..., 0].sum() + port[4][..., 0].sum()) == 1.0
    cell = rep[4, blk] if in_dq else rep[4 // n_rep, blk]
    assert float(cell[0]) == 1.0 and abs(float(cell[4]) - 20.0) < 1e-4
    bq, bkv = _tiles(sq, skv)
    want_row, want_col = {
        "dp_q": (blk * bq + row, step * bkv + col),
        "dq": (blk * bq + row, col),
        "dp_kv": (step * bq + row, blk * bkv + col),
        "dv": (blk * bkv + row, col),
        "dk": (blk * bkv + row, col)}[target]
    assert (int(cell[2]), int(cell[3])) == (want_row, want_col)


def test_degenerate_rows_give_exact_zero_grads():
    """Rows whose saved statistics are degenerate (m = NEG_INF, l = 0) get
    p ≡ 0: exact zero dq rows and no contribution to dk / dv, in both
    packages."""
    bh, n_rep, sq, skv, causal = 4, 2, 40, 40, False
    q, k, v, g = _inputs(9, bh, n_rep, sq, skv)
    (ro, rm, rl, _), _ = _forward(q, k, v, n_rep, causal)
    m, l = np.array(rm), np.array(rl)
    m[:, 5:9] = rflash.NEG_INF
    l[:, 5:9] = 0.0
    ref, port = _backward(q, k, v, g, ro, m, l, n_rep, causal)
    for got, want in zip(port[:3], ref[:3]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
        assert np.all(np.isfinite(got.numpy()))
    assert np.all(port[0].numpy()[:, 5:9] == 0.0)


def test_backward_injection_outside_the_grid_raises():
    q = torch.zeros(2, 8, 16)
    m, l = torch.zeros(2, 8), torch.ones(2, 8)
    with pytest.raises(ValueError, match="never"):
        tops.flash_ft_bwd(q, q, q, q, m, l, q, inject=TSpec(0, 0, 1.0, 0),
                          inj_target="dk", inj_blk=1)
    with pytest.raises(ValueError, match="target"):
        tops.flash_ft_bwd(q, q, q, q, m, l, q, inject=TSpec(0, 0, 1.0, 0),
                          inj_target="dz")
