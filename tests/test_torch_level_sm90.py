"""The tile (warp) and inner (thread) FT levels on the tensor-core plans of
K1 (`csrc/ft_gemm_level_sm90.cu`), K7 and K8 (`csrc/grouped_sm90.cu`):
the plans that route bf16 calls there, the 16-row band of the wgmma
fragment, and the plain versions under those plans (K1: 128- or 64-row
blocks of 16-row bands, 256-deep k-steps, split-K ranges; K7: 64-row
chunks of 16-row bands, each band recording into its own layout tile's
row; K8: 128 x 128 dw blocks of 16-row bands, the reduction in 64-row
stages, each a Δ at "inner") against the reference's Pallas kernels in
interpret mode, on the same numpy inputs.

At the reference's own tiles (its 128-row band) the plain versions give
its reports field for field. At the port's tiles the blocks, bands and
k-steps differ, so what must agree is the function: outputs, detection
and correction totals of corrected SEUs and at "inner" of detect-only
ones (counted once), and the global (row, col) each SEU is located at.

Integer-valued f32 operands keep both sides exact: outputs equal, reports
det / corr / row / col / mag / k equal, max_residual and tau within 1e-5
relative.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core.policy import FTConfig as RFT  # noqa: E402
from repro.core.policy import InjectionSpec as RInj  # noqa: E402
from repro.kernels import autotune, ops as rops  # noqa: E402
from repro.kernels import grouped as rgrouped  # noqa: E402
from repro.kernels.grouped import layout as rlay  # noqa: E402
from repro.kernels.templates import BatchedKernelSpec as RSpec  # noqa: E402

from repro_torch.core.policy import FTConfig as TFT  # noqa: E402
from repro_torch.kernels import ft_gemm as tg  # noqa: E402
from repro_torch.kernels import grouped_gemm as kgg  # noqa: E402
from repro_torch.kernels.grouped import layout as tlay  # noqa: E402
from repro_torch.kernels.templates import spec as tspec  # noqa: E402

LEVELS = ["tile", "inner"]
BF16 = torch.bfloat16
BIG, SMALL = tg.SM90_TILES
K7_TILES, K8_TILES, CHUNK = (kgg.SM90_GROUPED_TILES, kgg.SM90_TGMM_TILES,
                              kgg.SM90_CHUNK)
REF_TILES = (128, 128, 128)
TRIPLE = (1, 123456789, 987654321)


def _ints(rng, *shape):
    return rng.integers(-3, 4, shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _located(rep):
    rep = np.asarray(rep).reshape(-1, 8)
    return sorted((int(r[2]), int(r[3])) for r in rep[rep[:, 0] > 0])


def _totals(rep):
    rep = np.asarray(rep)
    return float(rep[..., 0].sum()), float(rep[..., 1].sum())


def _same_reports(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[..., [0, 1, 2, 3, 4, 7]],
                                  want[..., [0, 1, 2, 3, 4, 7]])
    np.testing.assert_allclose(got[..., [5, 6]], want[..., [5, 6]],
                               rtol=1e-5, atol=0)


def _k1_plan(m, n, k, level, **kw):
    args = dict(dtype=BF16, level=level, a_strides=(k, 1), b_strides=(n, 1))
    args.update(kw)
    return tg.plan(m, n, k, **args)


# ---------------------------------------------------------------------------
# plans and bands
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tiles,kernel", [(BIG, "gemm"), (SMALL, "gemm"),
                                          (K7_TILES, "grouped"),
                                          (K8_TILES, "tgmm")])
def test_band_of_the_tensor_core_tiles_is_16(tiles, kernel):
    """The band is the 16 rows one warp owns in the wgmma fragment: 8
    bands at BM 128, 4 at BM 64, one layout tile of K7's chunk, 16 dw rows
    of K8's 128-row block."""
    assert tspec.band_of(tiles, kernel) == tspec.SM90_BAND == 16
    tspec.validate(tspec.KernelSpec(ft_level="tile"), tiles, kernel)
    assert tg._check_ft(TFT(level="tile"), tiles, kernel)[2] == 16
    assert tg._check_ft(TFT(level="inner"), tiles, kernel)[2] == tiles[0]


@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("chain,act_grad,strides", [
    ((), False, {}), (("silu",), True, {}), (("bias", "silu"), True, {}),
    (("bias",), False, {}), ((), False, dict(b_strides=(1, 3072))),
    ((), False, dict(a_strides=(1, 3072)))],
    ids=["plain", "silu act_grad", "bias silu act_grad", "bias", "dx walk",
         "dw walk"])
def test_k1_plan_takes_every_block_call_at_the_level(level, chain, act_grad,
                                                     strides):
    """Every bf16 call the tensor cores take at block they take at the
    level, with the same tiles and split count: the chains, act_grad and
    the three walks, at a training and a decode shape."""
    for m, n, k in ((1024, 8192, 3072), (4, 18944, 3584)):
        kw = dict(chain=chain, act_grad=act_grad, **strides)
        if "a_strides" in strides:
            kw["a_strides"] = (1, m)
        if "b_strides" in strides:
            kw["b_strides"] = (1, k)
        at_block = _k1_plan(m, n, k, "block", **kw)
        p = _k1_plan(m, n, k, level, **kw)
        assert p == at_block
        # (x.T at 4 rows has a k stride TMA cannot take, at block too)
        assert p.instance == ("simt" if m == 4 and "a_strides" in strides
                              else "sm90")


@pytest.mark.parametrize("level", LEVELS)
def test_k7_plan_takes_the_moe_shapes_at_the_level(level):
    """K7's decode gate and the dbuf product's wᵀ walk at the level: the
    tensor-core instance, 64-row chunks; f32 and pinned SIMT tiles stay on
    the SIMT instance."""
    f, d = 1536, 4096
    for w_strides, wt in (((d * f, f, 1), False), ((d * f, 1, d), True)):
        p = kgg.plan_k7(f, d, BF16, 16, level=level, buf_strides=(d, 1),
                        w_strides=w_strides)
        assert (p.instance, p.tiles, p.chunk, p.w_kmajor) == \
            ("sm90", K7_TILES, CHUNK, wt)
    for dtype, tiles in ((torch.float32, None), (BF16, (16, 128, 32))):
        p = kgg.plan_k7(f, d, dtype, 16, level=level, buf_strides=(d, 1),
                        w_strides=(d * f, f, 1), tiles=tiles)
        assert (p.instance, p.tiles, p.chunk) == ("simt", (16, 128, 32), 16)


@pytest.mark.parametrize("level", LEVELS)
def test_k8_plan_takes_the_moe_dw_at_the_level(level):
    """K8's dw of the gate (x: d 4 096 wide, g: d_ff 1 536) and of the down
    projection (the other way round) at the level: the tensor-core
    instance, (16, 128, 128), 64-row stages; f32 and pinned SIMT tiles stay
    on the SIMT instance."""
    f, d = 1536, 4096
    for k, n in ((d, f), (f, d)):
        p = kgg.plan_k8(k, n, BF16, 16, level=level, x_strides=(k, 1),
                        g_strides=(n, 1))
        assert (p.instance, p.tiles, p.chunk, p.reason) == \
            ("sm90", K8_TILES, CHUNK, "")
    for dtype, bm, tiles in ((torch.float32, 16, None),
                             (torch.float32, 8, None),
                             (BF16, 16, (16, 64, 64))):
        p = kgg.plan_k8(d, f, dtype, bm, level=level, x_strides=(d, 1),
                        g_strides=(f, 1), tiles=tiles)
        assert (p.instance, p.tiles, p.chunk) == ("simt", (bm, 64, 64), bm)
        assert p.reason


# ---------------------------------------------------------------------------
# K1: the plain version under the tensor-core plan against the reference
# ---------------------------------------------------------------------------

def _k1_ref(a, b, level, action, spec):
    return rops.ft_matmul_report(
        jnp.asarray(a), jnp.asarray(b), ft=RFT(level=level, action=action),
        spec=spec, params=autotune.KernelParams(*REF_TILES), interpret=True)


@pytest.mark.parametrize("level", LEVELS)
def test_k1_plain_at_reference_tiles_matches_reference(level):
    """At the reference's (128, 128, 128) tiles (its 128-row band) the
    plain version that walks the tensor-core plans gives the reference's
    report field for field, clean and with a corrected SEU."""
    rng = np.random.default_rng(7)
    a, b = _ints(rng, 256, 512), _ints(rng, 512, 256)
    for spec in (None, RInj(row=200, col=77, magnitude=64.0, k_step=2)):
        ro, rr = _k1_ref(a, b, level, "correct", spec)
        inj = None if spec is None else (1, -1, spec.row, spec.col,
                                         spec.k_step)
        to, tr = tg.ft_gemm_plain(_t(a), _t(b), tiles=REF_TILES,
                                  ft=TFT(level=level), inj=inj, inj_mag=64.0)
        np.testing.assert_array_equal(to.numpy(), np.asarray(ro))
        np.testing.assert_array_equal(to.numpy(), a @ b)
        _same_reports(tr, rr)


@pytest.mark.parametrize("tiles", [BIG, SMALL], ids=["bm128", "bm64"])
@pytest.mark.parametrize("level", LEVELS)
def test_k1_port_tiles_match_reference(level, tiles):
    """At the tensor-core tiles, under the split count the plan gives a
    bf16 call of this shape: an SEU in the first, a middle and the last
    16-row band of a block, each corrected once and located at the same
    global (row, col) as the reference at its tiles; detect-only leaves it
    (at inner counted once on both sides)."""
    bm = tiles[0]
    m, n, k = (bm if bm == 64 else 256), 256, 768
    splits = _k1_plan(m, n, k, level).splits
    assert _k1_plan(m, n, k, level).tiles == tiles and splits > 1
    rng = np.random.default_rng(bm + len(level))
    a, b = _ints(rng, m, k), _ints(rng, k, n)
    row0 = m - bm
    for band, s in ((0, 0), (bm // 32, 1), (bm // 16 - 1, 2)):
        row, col = row0 + band * 16 + 9, 130 + band
        spec = RInj(row=row, col=col, magnitude=48.0, k_step=2 * s)
        for action in ("correct", "detect"):
            ro, rr = _k1_ref(a, b, level, action, spec)
            to, tr = tg.ft_gemm_plain(
                _t(a), _t(b), tiles=tiles, splits=splits,
                ft=TFT(level=level, action=action),
                inj=(1, -1, row, col, s), inj_mag=48.0)
            np.testing.assert_array_equal(to.numpy(), np.asarray(ro))
            assert set(_located(tr)) == set(_located(rr)) == {(row, col)}
            if action == "correct" or level == "inner":
                assert _totals(tr) == _totals(rr)
            else:
                assert _totals(tr)[1] == 0.0 and _totals(tr)[0] >= 1


@pytest.mark.parametrize("level", LEVELS)
def test_k1_split_walk_equals_the_unsplit_walk(level):
    """Split-K at the level (tile: every band's column checksum in each
    range's record, the sum verified band by band at k = K; inner: each
    range's steps verified alone, no final verification) gives the unsplit
    walk's det / corr / row / col, clean and with an SEU in each range."""
    rng = np.random.default_rng(11)
    m, n, k = 100, 128, 1280
    a, b = _ints(rng, m, k), _ints(rng, k, n)
    ft = TFT(level=level)
    for splits in (2, 3):
        ranges = tg.split_ranges(k, 256, splits)
        for inj in [None] + [(1, -1, 3 + 40 * z, 100 - z, lo)
                             for z, (lo, _) in enumerate(ranges)] + [
                (1, -1, m - 1, 0, ranges[0][1] - 1)]:
            one, r1 = tg.ft_gemm_plain(_t(a), _t(b), tiles=BIG, ft=ft,
                                       inj=inj, inj_mag=32.0)
            cut, rs = tg.ft_gemm_plain(_t(a), _t(b), tiles=BIG, ft=ft,
                                       splits=splits, inj=inj, inj_mag=32.0)
            assert torch.equal(one, cut)
            assert torch.equal(r1[..., :4], rs[..., :4]), (splits, inj)
            if inj is not None:
                assert torch.equal(one, _t(a @ b))


@pytest.mark.parametrize("tiles", [BIG, SMALL], ids=["bm128", "bm64"])
def test_k1_two_seus_in_two_bands_corrected_at_tile(tiles):
    """A campaign at rate 1.0 (one SEU every block) and a deterministic SEU
    in another 16-row band of one block at the drawn k-step: both corrected
    in that interval, the block's report counting two; detect-only leaves
    both; unsplit and split."""
    bm, bn, bk = tiles
    m = 2 * bm if bm == 128 else bm
    rng = np.random.default_rng(5)
    a, b = _t(_ints(rng, m, 1024)), _t(_ints(rng, 1024, 256))
    ft = TFT(level="tile", inject_rate=1.0)
    gm, gn, gk = tg.cdiv(m, bm), 2, 4
    hit, step, row, col = tg.seu_draws(TRIPLE, ft, 1, gm, gn, gk, tiles,
                                       False)
    i, j = gm - 1, 1
    r = int(row[0, i, j])
    r2 = i * bm + ((r // 16 + 1) % (bm // 16)) * 16 + r % 16
    inj = (1, -1, r2, j * bn + (int(col[0, i, j]) + 1) % bn,
           int(step[0, i, j]))
    clean = a @ b
    for splits in (1, 2):
        for f in (ft, ft.replace(action="detect")):
            out, rep = tg.ft_gemm_plain(a, b, tiles=tiles, ft=f, rng=TRIPLE,
                                        inj=inj, inj_mag=64.0, splits=splits)
            if f.corrects:
                assert torch.equal(out, clean)
                assert float(rep[i, j, 0]) == float(rep[i, j, 1]) == 2.0
                assert _totals(rep)[0] == float(hit.sum()) + 1
            else:
                assert int((out != clean)[i * bm:(i + 1) * bm,
                                          j * bn:].sum()) == 2


@pytest.mark.parametrize("splits", [1, 3])
def test_k1_detect_only_counted_once_at_inner(splits):
    """An SEU left in place by detect-only cancels out of the next step's
    Δ: one detection, none corrected, the output off by the magnitude."""
    rng = np.random.default_rng(9)
    a, b = _ints(rng, 64, 1536), _ints(rng, 1536, 200)
    ft = TFT(level="inner", action="detect")
    for s in (0, 2, 5):
        out, rep = tg.ft_gemm_plain(_t(a), _t(b), tiles=SMALL, ft=ft,
                                    splits=splits, inj=(1, -1, 30, 150, s),
                                    inj_mag=50.0)
        assert _totals(rep) == (1.0, 0.0)
        assert _located(rep) == [(30, 150)]
        diff = out.numpy() - a @ b
        assert diff[30, 150] == 50.0 and np.count_nonzero(diff) == 1


# ---------------------------------------------------------------------------
# K7: 64-row chunks of 16-row bands against the reference
# ---------------------------------------------------------------------------

#: ragged groups, an empty one, a 100-row group (two chunks, the second
#: past its row_end), the buffer's dead tail
SIZES = [40, 0, 100, 9]
K, N = 768, 200


def _layouts(bm):
    gids = np.random.default_rng(0).permutation(
        np.repeat(np.arange(len(SIZES)), SIZES)).astype(np.int32)
    return (rlay.make_layout(jnp.asarray(gids), len(SIZES), bm),
            tlay.make_layout(torch.from_numpy(gids), len(SIZES), bm), gids)


def _k7_port(tl, tbuf, w, ft, inj=None, rng=None, mag=64.0):
    return kgg.ft_gemm_grouped_plain(tbuf, w, tl.gid, tl.row_end,
                                     tiles=K7_TILES, chunk=CHUNK, ft=ft,
                                     inj=inj, inj_mag=mag, rng=rng)


@pytest.mark.parametrize("level", LEVELS)
def test_k7_port_chunks_match_reference(level):
    """K7's plain version on the tensor-core plan (64-row chunks, 16-row
    bands) against the reference's grouped kernel at its tiles: the same
    outputs, and an SEU in each non-empty group (the first, a middle and
    the last band of a chunk, the second chunk past row_end) corrected once
    and located at the same global (row, col); detect-only leaves it (at
    inner counted once on both sides). Each band's record sits in its own
    layout tile's row."""
    rng = np.random.default_rng(1)
    x = _ints(rng, sum(SIZES), K)
    w = _ints(rng, len(SIZES), K, N)
    rl, _, gids = _layouts(128)
    _, tl, _ = _layouts(16)
    rbuf = rlay.scatter_rows(jnp.asarray(x), rl)
    tbuf = tlay.scatter_rows(torch.from_numpy(x), tl)
    want_y = np.einsum("tk,tkn->tn", x, w[np.asarray(gids)])
    # (group, row within the group, col, k-step)
    seus = [(0, 0, 150, 1), (0, 39, 3, 2), (2, 70, 199, 0), (3, 8, 77, 1)]
    for g, r, c, s in seus:
        rrow = int(np.asarray(rl.base)[g]) + r
        trow = int(tl.base[g]) + r
        for action in ("correct", "detect"):
            want, rrep = rgrouped.grouped_buffer_call(
                RSpec(ft_level=level, grouped=True), rbuf, jnp.asarray(w),
                rl, params=autotune.KernelParams(128, 128, 256),
                ft=RFT(level=level, action=action),
                inject=RInj(row=rrow, col=c, magnitude=64.0, k_step=s),
                interpret=True)
            got, trep = _k7_port(tl, tbuf, torch.from_numpy(w),
                                 TFT(level=level, action=action),
                                 inj=(1, trow, c, s))
            got = tlay.gather_rows(got, tl).numpy()
            np.testing.assert_array_equal(
                got, np.asarray(rlay.gather_rows(want, rl)))
            assert _located(trep) == [(trow, c)]
            assert _located(rrep) == [(rrow, c)]
            if action == "correct":
                np.testing.assert_array_equal(got, want_y)
                assert _totals(trep) == _totals(rrep) == (1.0, 1.0)
                cell = np.asarray(trep)[trow // 16, c // 128]
                assert cell[0] == 1.0     # the SEU's own tile row
            elif level == "inner":
                assert _totals(trep) == _totals(rrep) == (1.0, 0.0)
            else:
                assert _totals(trep)[1] == 0.0 and _totals(trep)[0] >= 1


@pytest.mark.parametrize("level", LEVELS)
def test_k7_two_seus_in_two_bands_of_one_chunk(level):
    """A campaign at rate 1.0 (one SEU every layout tile) and a
    deterministic SEU in another band of the same chunk at the drawn
    k-step, in a band whose own SEU falls in another step: both corrected,
    each in its own tile's row; detect-only leaves both."""
    rng = np.random.default_rng(3)
    _, tl, _ = _layouts(16)
    buf = tlay.scatter_rows(torch.from_numpy(_ints(rng, sum(SIZES), K)), tl)
    w = torch.from_numpy(_ints(rng, len(SIZES), K, N))
    ft = TFT(level=level, inject_rate=1.0)
    clean, _ = _k7_port(tl, buf, w, TFT(level=level))
    hit, step, row, col = kgg.seu_tile_draws(TRIPLE, ft, tl.num_tiles, 2, 3,
                                             K7_TILES)
    i = int(tl.base[2]) // 16                   # group 2's first chunk
    t = next(q for q in (i + 1, i + 2, i + 3)
             if int(step[q, 1]) != int(step[i, 1]))
    inj = (1, t * 16 + int(row[i, 1]), 128 + (int(col[i, 1]) + 1) % 72,
           int(step[i, 1]))
    for f in (ft, ft.replace(action="detect")):
        out, rep = _k7_port(tl, buf, w, f, inj=inj, rng=TRIPLE)
        if f.corrects:
            assert torch.equal(out, clean)
            assert float(rep[i, 1, 1]) == 1.0 and float(rep[t, 1, 1]) == 2.0
        else:
            assert int((out != clean)[t * 16:(t + 1) * 16, 128:].sum()) == 2


# ---------------------------------------------------------------------------
# K8: 128 x 128 dw blocks of 16-row bands, 64-row stages, against the reference
# ---------------------------------------------------------------------------

#: a 70-row group (two 64-row stages, the second past its row_end), empty
#: groups, and a last group whose dead tail holds a stage with no live row
K8_SIZES = [70, 0, 0, 40, 0, 0, 9]
KX, NX = 256, 200        # dw (256, 200): two 128-row blocks, a ragged column


def _k8_layouts():
    gids = np.random.default_rng(4).permutation(
        np.repeat(np.arange(len(K8_SIZES)), K8_SIZES)).astype(np.int32)
    return (rlay.make_layout(jnp.asarray(gids), len(K8_SIZES), 16),
            tlay.make_layout(torch.from_numpy(gids), len(K8_SIZES), 16), gids)


def _k8_port(tl, tx, tg, ft, inj=None, rng=None, mag=48.0):
    return kgg.tgmm_plain(tx, tg, tl.row_end, tiles=K8_TILES, chunk=CHUNK,
                          ft=ft, inj=inj, inj_mag=mag, rng=rng)


@pytest.mark.parametrize("level", LEVELS)
def test_k8_port_blocks_match_reference(level):
    """K8's plain version on the tensor-core plan (128 x 128 dw blocks,
    16-row bands, 64-row stages) against the reference's tgmm kernel at
    its (16, 128, 256) tiles (two 128-row bands): the same dw, and an SEU
    in the first, a middle and the last 16-row band of a port block (a
    group's second stage, a group's first, the last group's dead tail)
    corrected once and located at the same global (row, col); detect-only
    leaves it (at inner counted once on both sides)."""
    rng = np.random.default_rng(2)
    x = _ints(rng, sum(K8_SIZES), KX)
    g = _ints(rng, sum(K8_SIZES), NX)
    rl, tl, gids = _k8_layouts()
    assert rl.t_buf == tl.t_buf
    np.testing.assert_array_equal(np.asarray(rl.base), tl.base.numpy())
    rx, rg = (rlay.scatter_rows(jnp.asarray(v), rl) for v in (x, g))
    tx, tg_ = (tlay.scatter_rows(torch.from_numpy(v), tl) for v in (x, g))
    want_dw = np.stack([x[gids == e].T @ g[gids == e]
                        for e in range(len(K8_SIZES))])
    base, last = tl.base.tolist(), len(K8_SIZES) - 1
    dead = tl.num_tiles - 1                       # the buffer's last tile
    assert dead * 16 - base[last] >= CHUNK        # in a stage with no live row
    # (dw row, dw col, layout tile): band 0 of block 1 in group 0's second
    # stage, band 3 of block 0 in group 3, band 7 of block 1 in the dead tail
    seus = [(128 + 5, 130, base[0] // 16 + 4), (3 * 16 + 2, 7, base[3] // 16 + 1),
            (KX - 1, NX - 1, dead)]
    for r, c, t in seus:
        for action in ("correct", "detect"):
            want, rrep = rgrouped.tgmm_buffer_call(
                RSpec(ft_level=level, tgmm=True), rx, rg, rl,
                params=autotune.KernelParams(16, 128, 256),
                ft=RFT(level=level, action=action),
                inject=RInj(row=r, col=c, magnitude=48.0, k_step=t),
                interpret=True)
            got, trep = _k8_port(tl, tx, tg_, TFT(level=level, action=action),
                                 inj=(1, r, c, t))
            what = (r, c, t, action)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
            assert _located(trep) == _located(rrep) == [(r, c)], what
            if action == "correct":
                np.testing.assert_array_equal(got.numpy(), want_dw)
                assert _totals(trep) == _totals(rrep) == (1.0, 1.0), what
            elif level == "inner":
                assert _totals(trep) == _totals(rrep) == (1.0, 0.0), what
            else:
                assert _totals(trep)[1] == 0.0 and _totals(trep)[0] >= 1


def test_k8_two_seus_in_two_bands_corrected_at_tile():
    """A campaign at rate 1.0 (one SEU every dw block, in the stage of its
    drawn tile) and a deterministic SEU in the next 16-row band of one
    block, aimed at the same tile: both corrected in that stage, the
    block's report counting two; detect-only leaves both."""
    rng = np.random.default_rng(3)
    _, tl, _ = _k8_layouts()
    x = tlay.scatter_rows(torch.from_numpy(_ints(rng, sum(K8_SIZES), KX)), tl)
    g = tlay.scatter_rows(torch.from_numpy(_ints(rng, sum(K8_SIZES), NX)), tl)
    ft = TFT(level="tile", inject_rate=1.0)
    clean, _ = _k8_port(tl, x, g, TFT(level="tile"))
    first, _, re = kgg._group_span(tl.row_end, 16, tl.num_tiles)
    hit, step, row, col = kgg.seu_dw_draws(
        TRIPLE, ft, (re - first * 16).clamp_min(0), 2, 2, K8_TILES)
    e, ki, nj = 0, 1, 0
    r = int(row[e, ki, nj])
    r2 = ki * 128 + ((r // 16 + 1) % 8) * 16 + r % 16
    inj = (1, r2, (int(col[e, ki, nj]) + 1) % 128,
           int(first[e]) + int(step[e, ki, nj]))
    for f in (ft, ft.replace(action="detect")):
        dw, rep = _k8_port(tl, x, g, f, inj=inj, rng=TRIPLE)
        if f.corrects:
            assert torch.equal(dw, clean)
            assert float(rep[e, ki, nj, 0]) == float(rep[e, ki, nj, 1]) == 2.0
            assert _totals(rep) == (float(hit.sum()) + 1,) * 2
        else:
            assert int((dw != clean)[e, 128:, :128].sum()) == 2
