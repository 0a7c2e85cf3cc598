"""The flash backward's tensor-core instance (`csrc/flash_bwd_sm90.cu`)
from the CPU side: `flashft.plan_bwd`'s rule, K4's ranged walk and its
report merge, and the hi / lo operands.

The ranged plain version (what the dK/dV kernel computes when its walk is
cut into ranges) is held against the unsplit walk over the geometries of
`tests/test_torch_flash_bwd.py` plus n_rep 16 (dk and dv within 1e-6 of
the output's max |x|: the ranges sum their partials in another order;
reports equal field for field but max_residual, which equals too), and
against the reference's Pallas `flash_ft_bwd` in interpret mode at the
pinned tiles (1e-5, det/corr/row/col/k equal, tau to 1e-5 relative).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core.policy import ONLINE_BLOCK  # noqa: E402
from repro.kernels import ops as rops  # noqa: E402

from repro_torch.core.abft import F32EPS  # noqa: E402
from repro_torch.core.policy import (OFFLINE_DETECT,  # noqa: E402
                                     ONLINE_BLOCK as T_ONLINE)
from repro_torch.kernels import flashft as tflash  # noqa: E402

from test_torch_flash_bwd import GEOMS, _check_report, _tiles  # noqa: E402

RANGE_GEOMS = GEOMS + [(32, 16, 130, 130, True)]   # n_rep 16 (qwen3-moe's)


def _inputs(seed, bh, n_rep, sq, skv, dh=16):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.normal(size=s).astype(np.float32))
                 for s in ((bh, sq, dh), (bh // n_rep, skv, dh),
                           (bh // n_rep, skv, dh), (bh, sq, dh)))


def _stats(q, k, v, g, kw):
    o, m, l, _ = tflash.flash_ft_plain(q, k, v, save_stats=True, **kw)
    return m, l, (g * o).sum(-1)


# ---------------------------------------------------------------------------
# plan_bwd
# ---------------------------------------------------------------------------

def _ops(bh, gk, s, dh, dtype=torch.bfloat16):
    return (torch.zeros(bh, s, dh, dtype=dtype),
            torch.zeros(gk, s, dh, dtype=dtype))


@pytest.mark.parametrize("case,instance,reason", [
    ("bf16 dh 128", "sm90", ""),
    ("f32", "simt", "dtype"),
    ("dh 64", "simt", "head dim"),
    ("non-contiguous", "simt", "non-contiguous"),
    ("pinned blocks", "simt", "pinned"),
    ("misaligned", "simt", "aligned"),
])
def test_plan_bwd_rule(case, instance, reason):
    q, k = _ops(6, 2, 100, 128)
    kw = dict(n_rep=3, causal=True)
    if case == "f32":
        q, k = _ops(6, 2, 100, 128, torch.float32)
    elif case == "dh 64":
        q, k = _ops(6, 2, 100, 64)
    elif case == "non-contiguous":
        k = torch.zeros(100, 2, 128, dtype=torch.bfloat16).transpose(0, 1)
    elif case == "pinned blocks":
        kw.update(bq=64, bkv=64)
    elif case == "misaligned":
        q = torch.zeros(6 * 100 * 128 + 1, dtype=torch.bfloat16)[1:].view(
            6, 100, 128)
    p = tflash.plan_bwd(q, k, **kw)
    assert p.instance == instance
    assert reason in p.reason and (reason == "") == (p.reason == "")
    if instance == "simt":
        assert p.ranges == 1


@pytest.mark.parametrize("bh,gk,n_rep,ranges", [
    (48, 16, 3, 3),     # phi4-mini, batch 2: 128 (kv head, kv block) CTAs
    (128, 8, 16, 5),    # qwen3-moe-235b-a22b, batch 2: 64
    (264, 264, 1, 1),   # two waves of kv blocks already: one range
])
def test_plan_bwd_ranges_at_the_training_shapes(bh, gk, n_rep, ranges):
    q, k = _ops(bh, gk, 512, 128)
    p = tflash.plan_bwd(q, k, n_rep=n_rep, causal=True)
    assert (p.instance, p.ranges) == ("sm90", ranges)
    assert gk * 8 * ranges >= tflash.SPLIT_TARGET or ranges == 1


def test_dkv_ranges_capped_by_the_walk():
    assert tflash.dkv_ranges(4, 3) == 3
    assert tflash.dkv_ranges(4, 100) == 66
    assert tflash.dkv_ranges(1000, 100) == 1


# ---------------------------------------------------------------------------
# K4's ranged walk
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("geom", RANGE_GEOMS)
@pytest.mark.parametrize("ranges", [2, 3, 7])
def test_ranged_dkv_plain_matches_unsplit_walk(geom, ranges):
    bh, n_rep, sq, skv, causal = geom
    q, k, v, g = _inputs(bh + sq + ranges, bh, n_rep, sq, skv)
    kw = dict(ft=T_ONLINE, scale=16 ** -0.5, tau_dh=128, n_rep=n_rep,
              causal=causal)
    m, l, di = _stats(q, k, v, g, kw)
    dk, dv, rep = tflash.flash_dkv_plain(q, k, v, g, m, l, di, **kw)
    dk_r, dv_r, rep_r = tflash.flash_dkv_plain(q, k, v, g, m, l, di,
                                               ranges=ranges, **kw)
    for got, want in ((dk_r, dk), (dv_r, dv)):
        assert float((got - want).abs().max()) <= 1e-6 * float(
            want.abs().max())
    assert torch.equal(rep_r, rep)
    assert float(rep[..., 0].sum()) == 0.0


def test_merge_ranges_rule():
    """det and corr add, row/col/mag from the last detection, max residual
    the max, tau and k from the last range that ran a verification: an
    empty last range (zero report) leaves them to the ranges before it."""
    r0 = torch.tensor([1.0, 1.0, 5.0, 6.0, 7.0, 3.0, 0.1, 64.0])
    r1 = torch.tensor([0.0, 0.0, 0.0, 0.0, 0.0, 9.0, 0.2, 40.0])
    r2 = torch.tensor([2.0, 2.0, 8.0, 9.0, 1.5, 2.0, 0.3, 1.0])
    empty = torch.zeros(8)
    got = tflash.merge_ranges([r0, r1, r2, empty])
    assert got.tolist() == pytest.approx(
        [3.0, 3.0, 8.0, 9.0, 1.5, 9.0, 0.3, 1.0])
    got = tflash.merge_ranges([r0, r1, empty])
    assert got.tolist() == pytest.approx(
        [1.0, 1.0, 5.0, 6.0, 7.0, 9.0, 0.2, 40.0])
    assert torch.equal(tflash.merge_ranges([empty, empty]), empty)


def test_empty_ranges_leave_tau_and_k_to_the_ranges_before():
    """The causal last kv block walks n_rep steps; cut into more ranges
    than that, some of its ranges run nothing, and the merged report
    still has the last verification's tau and k (the unsplit walk's)."""
    bh, n_rep, sq, skv = 6, 3, 130, 130
    q, k, v, g = _inputs(3, bh, n_rep, sq, skv)
    kw = dict(ft=T_ONLINE, scale=0.25, tau_dh=128, n_rep=n_rep, causal=True)
    m, l, di = _stats(q, k, v, g, kw)
    lo, live = tflash.dkv_walk(sq, skv, 2 * 64, causal=True)
    assert (lo, live) == (2, 1)            # 3 steps at the last kv block
    _, _, rep = tflash.flash_dkv_plain(q, k, v, g, m, l, di, **kw)
    _, _, rep_r = tflash.flash_dkv_plain(q, k, v, g, m, l, di, ranges=8,
                                         **kw)
    assert torch.equal(rep_r, rep)
    assert bool((rep_r[:, 2, 7] > 0).all())
    assert float(rep_r[0, 2, 7]) == float(min(sq - 2 * 64, 64))


@pytest.mark.parametrize("geom", GEOMS[1:3])
def test_ranged_dkv_plain_matches_reference(geom):
    """The ranged walk against the reference's Pallas K4 in interpret mode
    at the pinned tiles the reference fits per shape."""
    bh, n_rep, sq, skv, causal = geom
    q, k, v, g = _inputs(bh * sq + skv, bh, n_rep, sq, skv)
    bq, bkv = _tiles(sq, skv)
    ref = rops.flash_ft(*(jnp.asarray(x.numpy()) for x in (q, k, v)),
                        ft=ONLINE_BLOCK, causal=causal, n_rep=n_rep, bq=16,
                        bkv=128, interpret=True, save_stats=True)
    o, m, l = (torch.from_numpy(np.array(x)) for x in ref[:3])
    ref_b = rops.flash_ft_bwd(
        *(jnp.asarray(x) for x in (q.numpy(), k.numpy(), v.numpy(),
                                   o.numpy(), m.numpy(), l.numpy(),
                                   g.numpy())),
        ft=ONLINE_BLOCK, causal=causal, n_rep=n_rep, bq=16, bkv=128,
        interpret=True)
    di = (g * o).sum(-1)
    dk, dv, rep = tflash.flash_dkv_plain(
        q, k, v, g, m, l, di, ft=T_ONLINE, scale=16 ** -0.5, tau_dh=128,
        n_rep=n_rep, causal=causal, bq=bq, bkv=bkv, ranges=3)
    for got, want in ((dk, ref_b[1]), (dv, ref_b[2])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    _check_report(rep, ref_b[4])


def _exact_operands(bh, n_rep, s, dh=16):
    """Operands on which every backward product is exact in f32: K = 0
    (S = 0), m = 0 and l = 1 (P = 1 on the live cells), integer g, V, Q and
    di, scale 1/8 (dS = (dP - di) / 8)."""
    rng = np.random.default_rng(11)

    def ints(*shape):
        return torch.from_numpy(rng.integers(-3, 4, size=shape)
                                .astype(np.float32))

    q, v, g = ints(bh, s, dh), ints(bh // n_rep, s, dh), ints(bh, s, dh)
    k = torch.zeros(bh // n_rep, s, dh)
    m, l, di = torch.zeros(bh, s), torch.ones(bh, s), ints(bh, s)
    return q, k, v, g, m, l, di


@pytest.mark.parametrize("target", ["dp_kv", "dv", "dk"])
def test_seu_in_a_range_before_the_last(target):
    """A K4 SEU in a step of range 0 of 3: corrected bit for bit on exact
    operands, reported at its block, row and column; a detect-only policy
    counts it once in the merged report and leaves it."""
    bh, n_rep, s = 6, 3, 130
    q, k, v, g, m, l, di = _exact_operands(bh, n_rep, s)
    kw = dict(scale=0.125, tau_dh=128, n_rep=n_rep, causal=True, ranges=3)
    head, kvb, qb, row, col = 3, 0, 1, 17, 40 if target == "dp_kv" else 10
    lo, live = tflash.dkv_walk(s, s, kvb * 64, causal=True)
    step = (head % n_rep) * live + qb - lo
    assert tflash.dkv_range_of(step, n_rep * live, 3) == 0
    dk, dv, rep = tflash.flash_dkv_plain(q, k, v, g, m, l, di, ft=T_ONLINE,
                                         **kw)
    inj = (1, tflash.BWD_TARGETS[target], head, kvb, qb, row, col)
    ik, iv, irep = tflash.flash_dkv_plain(q, k, v, g, m, l, di, ft=T_ONLINE,
                                          inj=inj, inj_mag=64.0, **kw)
    assert torch.equal(ik, dk) and torch.equal(iv, dv)
    cell = irep[head // n_rep, kvb]
    assert float(irep[..., 0].sum()) == 1.0 and float(cell[1]) == 1.0
    want = ((qb * 64 + row, kvb * 64 + col) if target == "dp_kv"
            else (kvb * 64 + row, col))
    assert (int(cell[2]), int(cell[3])) == want
    assert float(cell[4]) == 64.0
    lk, lv, lrep = tflash.flash_dkv_plain(
        q, k, v, g, m, l, di, ft=OFFLINE_DETECT.replace(backend="pallas"),
        inj=inj, inj_mag=64.0, **kw)
    assert float(lrep[..., 0].sum()) == 1.0
    assert float(lrep[..., 1].sum()) == 0.0
    assert not (torch.equal(lk, dk) and torch.equal(lv, dv))


# ---------------------------------------------------------------------------
# hi / lo operands
# ---------------------------------------------------------------------------

def _hilo(x):
    hi = x.bfloat16().float()
    return hi, (x - hi).bfloat16().float()


def test_hi_lo_split_keeps_16_bits():
    rng = np.random.default_rng(4)
    x = torch.from_numpy((rng.normal(size=(64, 64))
                          * np.exp(rng.normal(size=(64, 64)) * 4))
                         .astype(np.float32))
    hi, lo = _hilo(x)
    assert torch.equal(hi + lo - lo, hi)            # hi + lo exact in f32
    rel = ((hi + lo - x).abs() / x.abs()).max()
    assert float(rel) <= 2.0 ** -16


def test_hi_lo_product_checksums_stay_below_tau():
    """dS·K as the kernel runs it (hi·K + lo·K into one f32 accumulator)
    against checksums taken from hi + lo: the residual is rounding, below
    tau = rel_tau·eps32·k·max|dS|·max|K|. A single bf16 dS checked against
    the f32 values' checksums is far above tau: the false detection the
    split avoids."""
    rng = np.random.default_rng(5)
    ds = torch.from_numpy(rng.normal(size=(64, 64)).astype(np.float32)) / 7
    kt = torch.from_numpy(rng.normal(size=(64, 128)).astype(np.float32)
                          ).bfloat16().double()
    hi, lo = _hilo(ds)
    prod = (hi.double() @ kt + lo.double() @ kt).float().double()
    both = (hi + lo).double()
    tau = (T_ONLINE.rel_tau * F32EPS * 64 * float(ds.abs().max())
           * float(kt.abs().max()))
    d_col = prod.sum(0) - both.sum(0) @ kt
    d_row = prod.sum(1) - both @ kt.sum(1)
    assert max(float(d_col.abs().max()), float(d_row.abs().max())) < tau
    single = hi.double() @ kt
    d_single = single.sum(0) - ds.double().sum(0) @ kt
    assert float(d_single.abs().max()) > 10 * tau


def test_backward_wrappers_take_no_other_device():
    """A CPU tensor runs the plain version; any other device that is not
    CUDA raises before a plan is made."""
    q = torch.ones(2, 8, 128, device="meta", dtype=torch.bfloat16)
    st = torch.ones(2, 8, device="meta")
    kw = dict(ft=T_ONLINE, scale=1.0, tau_dh=128)
    with pytest.raises(ValueError, match="device"):
        tflash.flash_ft_dq(q, q, q, q, st, st, st, **kw)
    with pytest.raises(ValueError, match="device"):
        tflash.flash_ft_dkv(q, q, q, q, st, st, st, **kw)
