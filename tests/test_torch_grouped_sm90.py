"""K7 and K8 on the tensor cores (`csrc/grouped_sm90.cu`): the plan that
routes a call there, and the plain versions under that plan (K7: 64-row
chunks of a group, 256-deep k-steps; K8: 64-row verification intervals,
128 x 128 dw blocks) against the reference's Pallas kernels in interpret
mode, fed the same numpy inputs.

The blocks differ from the reference's (whose row tile is the layout's 16
rows), so the comparisons are of outputs, detection totals and the located
global row and column, as ROADMAP's conformance rule 2 asks at the port's
own tiles. Detect-only counts follow the stated rule: an uncorrected SEU
is counted once at each later verification of its block (K7: each
256-deep k-step's end but the last, and the final one; K8: each later
interval of its group with verify="step", once with "final").

Tolerances: f32 outputs and dw within 1e-5; K7's bf16 outputs within one
bf16 ulp at the top of their range (both sides round f32 sums taken in
other orders). The element an SEU hit on random operands: each side
subtracts a checksum residual rounded in f32 over its own block (64 rows
here, 16 in the reference), so it agrees to 1e-3 in f32 (the checksums
sum K x 64 products of order 1) and to a bf16 ulp of the SEU's magnitude
in bf16. Integer operands keep both sides exact and an SEU's correction
bit for bit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402
from ml_dtypes import bfloat16  # noqa: E402

from repro.core.policy import FTConfig as RFT  # noqa: E402
from repro.core.policy import InjectionSpec as RInj  # noqa: E402
from repro.kernels import grouped as rgrouped  # noqa: E402
from repro.kernels.autotune import KernelParams  # noqa: E402
from repro.kernels.grouped import layout as rlay  # noqa: E402
from repro.kernels.templates import BatchedKernelSpec as RSpec  # noqa: E402

from repro_torch.core.policy import FTConfig as TFT  # noqa: E402
from repro_torch.core.policy import InjectionSpec as TInj  # noqa: E402
from repro_torch.kernels import grouped as tgrouped  # noqa: E402
from repro_torch.kernels import grouped_gemm as kgg  # noqa: E402
from repro_torch.kernels.grouped import layout as tlay  # noqa: E402
from repro_torch.kernels.templates import BatchedKernelSpec as TSpec  # noqa: E402

BF16 = torch.bfloat16
K7_TILES, K8_TILES, CHUNK = (kgg.SM90_GROUPED_TILES, kgg.SM90_TGMM_TILES,
                             kgg.SM90_CHUNK)
BM = K7_TILES[0]
#: A group of 100 rows (two chunks, the second past its row_end into the
#: next group's rows), empty groups, a ragged last group, and a buffer tail
#: that holds a fully dead 64-row chunk.
SIZES = [13, 0, 100, 7, 70, 0, 0, 5]
K, N = 512, 200          # two 256-deep k-steps; a ragged 128-column block


def _gids(sizes, seed=0):
    gids = np.concatenate([np.full(n, g, np.int32)
                           for g, n in enumerate(sizes)])
    return np.random.default_rng(seed).permutation(gids)


def _t(x):
    arr = np.asarray(x)
    if arr.dtype == bfloat16:
        return torch.from_numpy(arr.view(np.uint16).copy()).view(BF16)
    return torch.from_numpy(np.array(arr))


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      np.asarray(x, np.float32), np.float32)


def _layouts(sizes=SIZES):
    gids = _gids(sizes)
    ng = len(sizes)
    return (rlay.make_layout(jnp.asarray(gids), ng, BM),
            tlay.make_layout(torch.from_numpy(gids), ng, BM), gids)


def _close(got, want, inj, what):
    """got and want within 1e-5 (bf16 outputs: one bf16 ulp at the top of
    the range, both sides rounding f32 sums taken in other orders), the
    SEU's element (index ``inj``) within 1e-3."""
    bf16_out = got.dtype == BF16
    got, want = _f32(got).copy(), np.asarray(want, np.float32).copy()
    if inj is not None:
        np.testing.assert_allclose(got[inj], want[inj],
                                   atol=2.0 ** -7 * 8 if bf16_out else 1e-3,
                                   err_msg=what)
        got[inj] = want[inj]
    atol = 2.0 ** -7 * float(np.abs(want).max()) if bf16_out else 1e-5
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol, err_msg=what)


def _located(rep):
    """(det total, sorted list of the located (row, col) of detecting
    blocks) of a report."""
    rep = _f32(rep).reshape(-1, 8)
    hit = rep[rep[:, 0] > 0]
    return (float(rep[:, 0].sum()),
            sorted((int(r[2]), int(r[3])) for r in hit))


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

D, F, E = 4096, 1536, 128      # qwen3-moe-235b-a22b's expert GEMMs


def _k7(n, k, dtype=BF16, bm=16, wt=False, **kw):
    w_strides = (k * n, 1, k) if wt else (k * n, n, 1)
    return kgg.plan_k7(n, k, dtype, bm, buf_strides=(k, 1),
                       w_strides=w_strides, **kw)


def _k8(k, n, dtype=BF16, bm=16, **kw):
    return kgg.plan_k8(k, n, dtype, bm, x_strides=(k, 1), g_strides=(n, 1),
                       **kw)


@pytest.mark.parametrize("label,plan,w_kmajor", [
    ("decode gate", lambda: _k7(F, D), False),
    ("decode down", lambda: _k7(D, F), False),
    ("prefill gate", lambda: _k7(F, D), False),
    ("train dbuf (w^T view)", lambda: _k7(D, F, wt=True), True),
])
def test_plan_takes_the_moe_k7_shapes_to_the_tensor_cores(label, plan,
                                                           w_kmajor):
    p = plan()
    assert (p.instance, p.tiles, p.chunk, p.w_kmajor, p.reason) == \
        ("sm90", K7_TILES, CHUNK, w_kmajor, ""), label


def test_plan_takes_the_moe_k8_shape_to_the_tensor_cores():
    p = _k8(D, F)
    assert (p.instance, p.tiles, p.chunk, p.reason) == \
        ("sm90", K8_TILES, CHUNK, "")


@pytest.mark.parametrize("case,instance,tiles,chunk", [
    (lambda: _k7(F, D, torch.float32, 8), "simt", (8, 128, 32), 8),
    (lambda: _k7(F, D, torch.float32, 16), "simt", (16, 128, 32), 16),
    (lambda: _k7(F, D, tiles=(16, 128, 32)), "simt", (16, 128, 32), 16),
    (lambda: _k7(F, D, tiles=(16, 128, 128)), "plain", (16, 128, 128), 16),
    (lambda: _k7(F, D, aligned=False), "simt", (16, 128, 32), 16),
    (lambda: kgg.plan_k7(F, 300, BF16, 16, buf_strides=(300, 1),
                         w_strides=(300 * F, F, 1)), "simt", (16, 128, 32),
     16),
    (lambda: kgg.plan_k7(F, D, BF16, 16, buf_strides=(D, 1),
                         w_strides=(D * F, 1, D + 1)), "simt",
     (16, 128, 32), 16),
    (lambda: _k8(D, F, torch.float32, 8), "simt", (8, 64, 64), 8),
    (lambda: _k8(D, F, tiles=(16, 64, 64)), "simt", (16, 64, 64), 16),
    (lambda: _k8(D, F, tiles=(16, 128, 128)), "plain", (16, 128, 128), 16),
    (lambda: kgg.plan_k8(D, F, BF16, 16, x_strides=(1, D),
                         g_strides=(F, 1)), "simt", (16, 64, 64), 16),
], ids=["k7 f32 bm8", "k7 f32 bm16", "k7 pinned simt", "k7 pinned ref",
        "k7 unaligned", "k7 buffer stride", "k7 w stride", "k8 f32",
        "k8 pinned simt", "k8 pinned ref", "k8 x stride"])
def test_plan_keeps_f32_pinned_tiles_and_odd_strides_off_the_tensor_cores(
        case, instance, tiles, chunk):
    p = case()
    assert (p.instance, p.tiles, p.chunk) == (instance, tiles, chunk)
    assert p.reason


def test_cpu_wrappers_follow_the_plan():
    """On the CPU the wrappers run the plain version under the plan: bf16
    takes the tensor-core grid at every level, pinned SIMT tiles the SIMT
    grid."""
    rl, tl, gids = _layouts()
    rng = np.random.default_rng(1)
    x = _t(rng.integers(-2, 3, (len(gids), 256)).astype(bfloat16))
    w = _t(rng.integers(-2, 3, (len(SIZES), 256, 128)).astype(bfloat16))
    buf = tlay.scatter_rows(x, tl)
    ft = TFT(level="block")
    for tiles, chunk in ((None, CHUNK), ((16, 128, 32), 16)):
        want = kgg.ft_gemm_grouped_plain(
            buf, w, tl.gid, tl.row_end, tiles=tiles or K7_TILES, chunk=chunk,
            ft=ft)
        got = kgg.ft_gemm_grouped(buf, w, tl.gid, tl.row_end, ft=ft,
                                  tiles=tiles)
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    # tile and inner run on the tensor-core instance by the plan's rule
    for level in ("tile", "inner"):
        ft = TFT(level=level)
        p = kgg.plan_k7_call(buf, w, tl.gid, ft=ft)
        assert (p.instance, p.tiles, p.chunk) == ("sm90", K7_TILES, CHUNK)
        want = kgg.ft_gemm_grouped_plain(buf, w, tl.gid, tl.row_end,
                                         tiles=p.tiles, chunk=p.chunk, ft=ft)
        got = kgg.ft_gemm_grouped(buf, w, tl.gid, tl.row_end, ft=ft)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


# ---------------------------------------------------------------------------
# K7 under the tensor-core plan against the reference's grouped kernel
# ---------------------------------------------------------------------------

def _k7_ref(rl, rbuf, rw, action, inj):
    return rgrouped.grouped_buffer_call(
        RSpec(ft_level="block", grouped=True), rbuf, rw, rl,
        params=KernelParams(BM, 128, 256), ft=RFT(level="block",
                                                  action=action),
        inject=inj, interpret=True)


def _k7_port(tl, tbuf, tw, action, inj, verify="step"):
    tinj = None if inj is None else (1, inj.row, inj.col, inj.k_step)
    return kgg.ft_gemm_grouped_plain(
        tbuf, tw, tl.gid, tl.row_end, tiles=K7_TILES, chunk=CHUNK,
        ft=TFT(level="block", action=action, verify=verify), inj=tinj,
        inj_mag=0.0 if inj is None else inj.magnitude)


@pytest.mark.parametrize("walk", ["w", "wT"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k7_plain_under_the_plan_matches_reference(dtype, walk):
    rl, tl, gids = _layouts()
    rng = np.random.default_rng(2)
    npdt = np.float32 if dtype == "float32" else bfloat16
    x = rng.standard_normal((len(gids), K)).astype(npdt)
    w = rng.standard_normal((len(SIZES), K, N)).astype(npdt)
    rbuf, tbuf = rlay.scatter_rows(jnp.asarray(x), rl), tlay.scatter_rows(
        _t(x), tl)
    rw, tw = jnp.asarray(w), _t(w)
    if walk == "wT":             # the dbuf product reads wᵀ as a view
        rw = jnp.swapaxes(jnp.asarray(np.swapaxes(w, 1, 2).copy()), 1, 2)
        tw = _t(np.swapaxes(w, 1, 2).copy()).transpose(-1, -2)
    re = np.asarray(rl.row_end)
    cases = [("correct", None),
             ("correct", RInj(row=int(re[2]) - 1, col=N - 1, magnitude=77.0,
                              k_step=1)),
             ("correct", RInj(row=int(re[0]) - 1, col=3, magnitude=-50.0,
                              k_step=0))]
    for action, inj in cases:
        want, rrep = _k7_ref(rl, rbuf, rw, action, inj)
        got, trep = _k7_port(tl, tbuf, tw, action, inj)
        what = f"{action} {inj}"
        _close(got, want, None if inj is None else (inj.row, inj.col), what)
        assert _located(trep) == _located(rrep), what
        assert trep.shape == (tl.num_tiles, 2, 8)


@pytest.mark.parametrize("verify", ["step", "final"])
def test_k7_seu_past_row_end_corrected_and_detect_only_counted(verify):
    """Integer operands: an SEU in the second chunk of the 100-row group
    (whose staged tile runs past row_end into the next group) is corrected
    bit for bit and located; detect-only leaves it, counted at each later
    verification of its chunk (step) or once (final); an SEU in the fully
    dead chunk of the buffer's tail likewise."""
    rl, tl, gids = _layouts()
    rng = np.random.default_rng(3)
    x = rng.integers(-3, 4, (len(gids), K)).astype(np.float32)
    w = rng.integers(-3, 4, (len(SIZES), K, N)).astype(np.float32)
    tbuf, tw = tlay.scatter_rows(_t(x), tl), _t(w)
    clean, rep0 = _k7_port(tl, tbuf, tw, "correct", None, verify)
    assert _located(rep0) == (0.0, [])
    re = tl.row_end.tolist()
    gk = K // K7_TILES[2]
    for row in (re[2] - 1, tl.t_buf - 1):
        for step in range(gk):
            inj = RInj(row=row, col=N - 1, magnitude=64.0, k_step=step)
            fixed, rep = _k7_port(tl, tbuf, tw, "correct", inj, verify)
            assert torch.equal(fixed, clean)
            assert _located(rep) == (1.0, [(row, N - 1)])
            left, rep_d = _k7_port(tl, tbuf, tw, "detect", inj, verify)
            moved = (left - clean).nonzero().tolist()
            assert moved == [[row, N - 1]]
            assert float(left[row, N - 1] - clean[row, N - 1]) == 64.0
            want = gk - step if verify == "step" else 1
            assert _located(rep_d) == (float(want), [(row, N - 1)])
            assert float(_f32(rep_d)[..., 1].sum()) == 0.0


def test_k7_report_rows_of_a_chunk():
    """The chunk's record sits in its first row tile's report row; the
    other row tiles of the chunk hold the clean record (tau 1e-30, k = K)."""
    rl, tl, gids = _layouts()
    rng = np.random.default_rng(4)
    tbuf = tlay.scatter_rows(_t(rng.standard_normal((len(gids), K)).astype(
        np.float32)), tl)
    tw = _t(rng.standard_normal((len(SIZES), K, N)).astype(np.float32))
    _, rep = _k7_port(tl, tbuf, tw, "correct", None)
    base = tl.base.tolist()
    first = base[2] // BM                 # the 100-row group's first chunk
    assert float(rep[first, :, 6].min()) > 1e-20     # verified: a real tau
    for q in range(1, CHUNK // BM):
        assert rep[first + q, :, :6].abs().sum() == 0
        assert torch.all(rep[first + q, :, 6] == 1e-30)
        assert torch.all(rep[first + q, :, 7] == K)


def test_k7_garbage_in_dead_rows_changes_nothing():
    """Rows between a group's row_end and the next group's base hold
    garbage, not zeros: the result equals the zero-filled run's."""
    rl, tl, gids = _layouts()
    rng = np.random.default_rng(5)
    x = _t(rng.standard_normal((len(gids), K)).astype(bfloat16))
    w = _t(rng.standard_normal((len(SIZES), K, N)).astype(bfloat16))
    buf = tlay.scatter_rows(x, tl)
    dead = torch.ones(tl.t_buf, dtype=torch.bool)
    dead[tl.positions.long()] = False
    assert int(dead.sum()) > CHUNK
    dirty = buf.clone()
    dirty[dead] = torch.from_numpy(
        rng.standard_normal((int(dead.sum()), K)).astype(np.float32) * 1e3
    ).to(BF16)
    ft = TFT(level="block")
    want = kgg.ft_gemm_grouped(buf, w, tl.gid, tl.row_end, ft=ft)
    got = kgg.ft_gemm_grouped(dirty, w, tl.gid, tl.row_end, ft=ft)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert not got[0][dead].any()


# ---------------------------------------------------------------------------
# K8 under the tensor-core plan against the reference's tgmm kernel
# ---------------------------------------------------------------------------

KX, NG = 200, 136        # dw (200, 136): ragged 128-row and 128-col blocks


def _k8_ref(rl, rx, rg, action, inj):
    return rgrouped.tgmm_buffer_call(
        RSpec(ft_level="block", tgmm=True), rx, rg, rl,
        params=KernelParams(BM, 128, 128),
        ft=RFT(level="block", action=action), inject=inj, interpret=True)


def _k8_port(tl, tx, tg, action, inj, verify="step"):
    tinj = None if inj is None else TInj(row=inj.row, col=inj.col,
                                         magnitude=inj.magnitude,
                                         k_step=inj.k_step)
    return tgrouped.tgmm_buffer_call(
        TSpec(ft_level="block", tgmm=True), tx, tg, tl, tiles=None,
        ft=TFT(level="block", action=action, verify=verify), inject=tinj)


def _k8_ops(dtype, seed, ints=False):
    rl, tl, gids = _layouts()
    rng = np.random.default_rng(seed)
    npdt = np.float32 if dtype == "float32" else bfloat16

    def draw(shape):
        v = (rng.integers(-3, 4, shape) if ints
             else rng.standard_normal(shape))
        return v.astype(npdt)

    x, g = draw((len(gids), KX)), draw((len(gids), NG))
    return (rl, tl, [rlay.scatter_rows(jnp.asarray(v), rl) for v in (x, g)],
            [tlay.scatter_rows(_t(v), tl) for v in (x, g)])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k8_plain_under_the_plan_matches_reference(dtype):
    """dw and detection totals / located (row, col) equal; empty groups
    zero in dw and report, as the kernels write them (no pass after)."""
    rl, tl, (rx, rg), (tx, tg) = _k8_ops(dtype, 6)
    base, re = tl.base.tolist(), tl.row_end.tolist()
    cases = [("correct", None),
             ("correct", RInj(row=KX - 1, col=70, magnitude=33.0,
                              k_step=(base[2] + 70) // BM)),
             ("correct", RInj(row=5, col=NG - 1, magnitude=-21.0,
                              k_step=(re[-1] - 1) // BM))]
    for action, inj in cases:
        want, rrep = _k8_ref(rl, rx, rg, action, inj)
        if dtype == "bfloat16":
            got, trep = _k8_port(tl, tx, tg, action, inj)
            assert kgg.plan_k8_call(tx, tg, BM).instance == "sm90"
        else:   # f32 data on the tensor-core grid: the plain version itself
            tinj = None if inj is None else (1, inj.row, inj.col, inj.k_step)
            got, trep = kgg.tgmm_plain(
                tx, tg, tl.row_end, tiles=K8_TILES, chunk=CHUNK,
                ft=TFT(level="block", action=action), inj=tinj,
                inj_mag=0.0 if inj is None else inj.magnitude)
        what = f"{action} {inj}"
        assert got.dtype == torch.float32
        _close(got, want, None if inj is None else (-1 if inj.k_step * BM
                                                     >= base[-1] else 2,
                                                     inj.row, inj.col), what)
        assert _located(trep) == _located(rrep), what
        assert trep.shape == (len(SIZES), 2, 2, 8)
        for e in range(len(SIZES)):
            if SIZES[e] == 0:
                assert not got[e].any() and not trep[e].any()


@pytest.mark.parametrize("verify", ["step", "final"])
def test_k8_seu_in_the_last_ragged_tile_corrected_and_detect_only_counted(
        verify):
    """Integer operands: an SEU in the last group's ragged tile is
    corrected bit for bit and located; detect-only leaves it and counts it
    at its interval and each later one (the buffer's dead tail, step) or
    once (final)."""
    rl, tl, _, (tx, tg) = _k8_ops("bfloat16", 7, ints=True)
    clean, rep0 = _k8_port(tl, tx, tg, "correct", None, verify)
    assert _located(rep0) == (0.0, [])
    base, re = tl.base.tolist(), tl.row_end.tolist()
    tile = (re[-1] - 1) // BM
    n_int = -(-(tl.t_buf - base[-1]) // CHUNK)        # the last group's
    s_inj = (tile * BM - base[-1]) // CHUNK
    assert n_int - s_inj > 1
    inj = RInj(row=KX - 1, col=NG - 1, magnitude=40.0, k_step=tile)
    fixed, rep = _k8_port(tl, tx, tg, "correct", inj, verify)
    assert torch.equal(fixed, clean)
    assert _located(rep) == (1.0, [(KX - 1, NG - 1)])
    left, rep_d = _k8_port(tl, tx, tg, "detect", inj, verify)
    assert (left - clean).nonzero().tolist() == [[len(SIZES) - 1, KX - 1,
                                                  NG - 1]]
    assert float(left[-1, KX - 1, NG - 1] - clean[-1, KX - 1, NG - 1]) == 40.0
    want = n_int - s_inj if verify == "step" else 1
    assert _located(rep_d) == (float(want), [(KX - 1, NG - 1)])


def test_k8_garbage_in_dead_rows_and_empty_groups():
    """Garbage in the dead rows of both buffers changes nothing; empty
    groups come back as a zero dw and a zero report under both plans (the
    tensor-core grid and the SIMT tiles), the front door adding no pass."""
    rl, tl, _, (tx, tg) = _k8_ops("bfloat16", 8)
    dead = torch.ones(tl.t_buf, dtype=torch.bool)
    dead[tl.positions.long()] = False
    dx, dg = tx.clone(), tg.clone()
    dx[dead], dg[dead] = 9.0, -7.0
    want = _k8_port(tl, tx, tg, "correct", None)
    got = _k8_port(tl, dx, dg, "correct", None)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    for tiles in (None, (16, 64, 64)):
        dw, rep = tgrouped.tgmm_buffer_call(
            TSpec(ft_level="block", tgmm=True), dx, dg, tl, tiles=tiles,
            ft=TFT(level="block"))
        for e in range(len(SIZES)):
            if SIZES[e] == 0:
                assert not dw[e].any() and not rep[e].any()
