"""Port ↔ reference: the grouped GEMMs of the MoE layer.

  * `make_layout` gives the reference's counts, base, row_end, gid and
    positions (empty groups, every row in one group, a ragged last group),
    and `scatter_rows` / `gather_rows` its buffers;
  * K7's plain version (`kernels.grouped_gemm.ft_gemm_grouped_plain`)
    against the reference's grouped kernel (`grouped_buffer_call`, Pallas
    in interpret mode) at the reference's tiles pinned to the port's row
    tile: outputs and whole reports, clean, with one SEU in each group in
    turn (corrected), detect-only, in a dead tile, and against a transposed
    w (the dbuf product);
  * K8's plain version (`tgmm_plain`, through the front door that zeroes
    empty groups) against the reference's `tgmm_buffer_call` the same way,
    the last group's dead tiles included;
  * the dispatch fronts, the row-tile plan, `ops.grouped_gemm_call`'s
    grouped and tgmm branches;
  * `core.ft_grouped_matmul` forward and grads on the kernel backend and the
    torch-op backend against `jax.grad` of the reference's, with a
    `bwd_inject` SEU in dbuf and in dw corrected (and left by detect-only).

Tolerances: outputs and dw within 1e-5 (f32; bf16 operands accumulate in
f32 on both sides); the report's integer fields (detected, corrected, row,
col, k) exactly; magnitude, max residual and tau to f32 rounding of sums
taken in another order (rtol 1e-5, with an absolute 1e-4 for the max
residual, a difference of rounded sums). Grads on integer operands are
exact.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from ml_dtypes import bfloat16  # noqa: E402

from repro.core import ft_gemm as rcore  # noqa: E402
from repro.core.policy import FTConfig as RFT  # noqa: E402
from repro.core.policy import InjectionSpec as RInj  # noqa: E402
from repro.kernels import grouped as rgrouped  # noqa: E402
from repro.kernels.autotune import KernelParams  # noqa: E402
from repro.kernels.grouped import dispatch as rdispatch  # noqa: E402
from repro.kernels.grouped import layout as rlay  # noqa: E402
from repro.kernels.templates import BatchedKernelSpec as RSpec  # noqa: E402

from repro_torch.core import ft_gemm as tcore  # noqa: E402
from repro_torch.core import telemetry as ttel  # noqa: E402
from repro_torch.core.policy import FTConfig as TFT  # noqa: E402
from repro_torch.core.policy import InjectionSpec as TInj  # noqa: E402
from repro_torch.kernels import grouped as tgrouped  # noqa: E402
from repro_torch.kernels import grouped_gemm as kgg  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels.grouped import layout as tlay  # noqa: E402
from repro_torch.kernels.templates import BatchedKernelSpec as TSpec  # noqa: E402
from repro_torch.kernels.templates import KernelSpec as TKSpec  # noqa: E402

#: (group sizes, n_groups): empty groups, a ragged last group, every row in
#: one group, an empty last group (the dead tiles then belong to it).
GROUPINGS = [([13, 0, 20, 9], 4), ([0, 0, 37, 0], 4), ([5, 11, 0, 0], 4),
             ([40], 1)]


def _gids(sizes, seed=0):
    gids = np.concatenate([np.full(n, g, np.int32)
                           for g, n in enumerate(sizes)])
    return np.random.default_rng(seed).permutation(gids)


def _t(x):
    arr = np.asarray(x)
    if arr.dtype == bfloat16:
        return torch.from_numpy(arr.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      np.asarray(x, np.float32), np.float32)


def _layouts(sizes, ng, bm):
    gids = _gids(sizes)
    return (rlay.make_layout(jnp.asarray(gids), ng, bm),
            tlay.make_layout(torch.from_numpy(gids), ng, bm), gids)


def _check_report(got, want, what):
    got, want = _f32(got), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    for f in (0, 1, 2, 3, 7):
        np.testing.assert_array_equal(got[..., f], want[..., f],
                                      err_msg=f"{what} field {f}")
    np.testing.assert_allclose(got[..., 4], want[..., 4], rtol=1e-5,
                               atol=1e-4, err_msg=f"{what} magnitude")
    np.testing.assert_allclose(got[..., 5], want[..., 5], rtol=1e-5,
                               atol=1e-4, err_msg=f"{what} max residual")
    np.testing.assert_allclose(got[..., 6], want[..., 6], rtol=1e-5,
                               atol=0, err_msg=f"{what} tau")


# ---------------------------------------------------------------------------
# layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bm", [8, 16])
@pytest.mark.parametrize("grouping", GROUPINGS, ids=str)
def test_make_layout_matches_reference(grouping, bm):
    sizes, ng = grouping
    rl, tl, gids = _layouts(sizes, ng, bm)
    assert (tl.n_groups, tl.bm, tl.t_buf, tl.n_rows) == \
        (rl.n_groups, rl.bm, rl.t_buf, rl.n_rows)
    for f in ("counts", "base", "row_end", "gid", "positions"):
        got = getattr(tl, f)
        assert got.dtype == torch.int32, f
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(rl, f)),
                                      err_msg=f)
    x = np.random.default_rng(1).standard_normal((len(gids), 5), np.float32)
    rbuf = rlay.scatter_rows(jnp.asarray(x), rl)
    tbuf = tlay.scatter_rows(torch.from_numpy(x), tl)
    np.testing.assert_array_equal(tbuf.numpy(), np.asarray(rbuf))
    np.testing.assert_array_equal(tlay.gather_rows(tbuf, tl).numpy(), x)
    assert tlay.buffer_rows(len(gids), ng, bm) == \
        rlay.buffer_rows(len(gids), ng, bm)
    np.testing.assert_array_equal(
        tgrouped.group_counts_from_metadata(tl.row_end, bm).numpy(),
        np.asarray(rdispatch.group_counts_from_metadata(rl.row_end, bm)))


# ---------------------------------------------------------------------------
# K7 plain version vs the reference's grouped kernel
# ---------------------------------------------------------------------------

K, N = 256, 200           # two k-steps and two n-blocks at (bm, 128, 128)


def _k7_seus(rl, ng, bm):
    """One SEU per non-empty group (its first live row, k-step 1), and one
    in a dead tile past every group."""
    base, counts = np.asarray(rl.base), np.asarray(rl.counts)
    seus = [RInj(row=int(base[g]) + int(counts[g]) - 1, col=150 - 7 * g,
                 magnitude=77.0 + g, k_step=1)
            for g in range(ng) if counts[g] > 0]
    seus.append(RInj(row=rl.t_buf - 1, col=3, magnitude=9.0, k_step=0))
    return seus


def _k7_pair(rl, tl, rbuf, tbuf, rw, tw, bm, action, inj):
    ft_r, ft_t = RFT(level="block", action=action), TFT(level="block",
                                                       action=action)
    want, rrep = rgrouped.grouped_buffer_call(
        RSpec(ft_level="block", grouped=True), rbuf, rw, rl,
        params=KernelParams(bm, 128, 128), ft=ft_r, inject=inj,
        interpret=True)
    tinj = None if inj is None else (1, inj.row, inj.col, inj.k_step)
    got, trep = kgg.ft_gemm_grouped_plain(
        tbuf, tw, tl.gid, tl.row_end, tiles=(bm, 128, 128), ft=ft_t,
        inj=tinj, inj_mag=0.0 if inj is None else inj.magnitude)
    return want, rrep, got, trep


@pytest.mark.parametrize("dtype,bm", [("float32", 8), ("float32", 16),
                                      ("bfloat16", 16)])
@pytest.mark.parametrize("grouping", GROUPINGS[:3], ids=str)
def test_k7_plain_matches_reference_kernel(grouping, dtype, bm):
    sizes, ng = grouping
    rl, tl, gids = _layouts(sizes, ng, bm)
    rng = np.random.default_rng(2)
    npdt = np.float32 if dtype == "float32" else bfloat16
    x = rng.standard_normal((len(gids), K)).astype(npdt)
    w = rng.standard_normal((ng, K, N)).astype(npdt)
    rbuf = rlay.scatter_rows(jnp.asarray(x), rl)
    tbuf = tlay.scatter_rows(_t(x), tl)
    rw, tw = jnp.asarray(w), _t(w)
    cases = [("correct", None)] + [("correct", s)
                                   for s in _k7_seus(rl, ng, bm)]
    cases.append(("detect", cases[1][1]))
    for action, inj in cases:
        want, rrep, got, trep = _k7_pair(rl, tl, rbuf, tbuf, rw, tw, bm,
                                         action, inj)
        what = f"{action} {inj}"
        np.testing.assert_allclose(_f32(got), np.asarray(want, np.float32),
                                   rtol=1e-5, atol=1e-5, err_msg=what)
        _check_report(trep, rrep, what)
        n_det = float(np.asarray(rrep)[..., 0].sum())
        if inj is None:
            assert n_det == 0.0, what
        else:
            assert n_det == 1.0 if action == "correct" else n_det >= 1, what


def test_k7_plain_transposed_w_matches_reference():
    """The dbuf product reads wᵀ as a view (G, N, K) → y (t_buf, K)."""
    sizes, ng, bm = [13, 0, 20, 9], 4, 8
    rl, tl, gids = _layouts(sizes, ng, bm)
    rng = np.random.default_rng(3)
    g = rng.standard_normal((len(gids), N)).astype(np.float32)
    w = rng.standard_normal((ng, K, N)).astype(np.float32)
    rbuf = rlay.scatter_rows(jnp.asarray(g), rl)
    tbuf = tlay.scatter_rows(torch.from_numpy(g), tl)
    tw = torch.from_numpy(w).transpose(-1, -2)
    assert not tw.is_contiguous()
    inj = RInj(row=int(np.asarray(rl.base)[2]) + 4, col=70, magnitude=50.0,
               k_step=1)
    for case in (None, inj):
        want, rrep, got, trep = _k7_pair(rl, tl, rbuf, tbuf,
                                         jnp.swapaxes(jnp.asarray(w), -1, -2),
                                         tw, bm, "correct", case)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
        _check_report(trep, rrep, f"transposed {case}")


# ---------------------------------------------------------------------------
# K8 plain version vs the reference's tgmm kernel
# ---------------------------------------------------------------------------

def _k8_pair(rl, tl, rx, rg, tx, tg, bm, ng, action, inj):
    want, rrep = rgrouped.tgmm_buffer_call(
        RSpec(ft_level="block", tgmm=True), rx, rg, rl,
        params=KernelParams(bm, 128, 128),
        ft=RFT(level="block", action=action), inject=inj, interpret=True)
    tinj = None if inj is None else TInj(row=inj.row, col=inj.col,
                                         magnitude=inj.magnitude,
                                         k_step=inj.k_step)
    got, trep = tgrouped.tgmm_buffer_call(
        TSpec(ft_level="block", tgmm=True), tx, tg, tl, tiles=(bm, 128, 128),
        ft=TFT(level="block", action=action), inject=tinj)
    return want, rrep, got, trep


@pytest.mark.parametrize("dtype,bm", [("float32", 8), ("float32", 16),
                                      ("bfloat16", 16)])
@pytest.mark.parametrize("grouping", GROUPINGS[:3], ids=str)
def test_k8_plain_matches_reference_kernel(grouping, dtype, bm):
    sizes, ng = grouping
    rl, tl, gids = _layouts(sizes, ng, bm)
    rng = np.random.default_rng(4)
    npdt = np.float32 if dtype == "float32" else bfloat16
    x = rng.standard_normal((len(gids), K)).astype(npdt)
    g = rng.standard_normal((len(gids), N)).astype(npdt)
    rx, rg = (rlay.scatter_rows(jnp.asarray(v), rl) for v in (x, g))
    tx, tg = (tlay.scatter_rows(_t(v), tl) for v in (x, g))
    base, counts = np.asarray(rl.base), np.asarray(rl.counts)
    live = [gr for gr in range(ng) if counts[gr] > 0]
    # One SEU per non-empty group, on its last live tile (k_step is the
    # buffer's row tile, which selects the group).
    seus = [RInj(row=5 + 60 * i, col=130 - 40 * i, magnitude=33.0 + i,
                 k_step=(int(base[gr]) + int(counts[gr]) - 1) // bm)
            for i, gr in enumerate(live)]
    cases = [("correct", None)] + [("correct", s) for s in seus]
    cases.append(("detect", seus[-1]))
    for action, inj in cases:
        want, rrep, got, trep = _k8_pair(rl, tl, rx, rg, tx, tg, bm, ng,
                                         action, inj)
        what = f"{action} {inj}"
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5, err_msg=what)
        _check_report(trep, rrep, what)
        for gr in range(ng):
            if counts[gr] == 0:
                assert not got[gr].any() and not trep[gr].any()
        if inj is not None:
            assert float(trep[..., 0].sum()) >= 1.0, what


# ---------------------------------------------------------------------------
# dispatch fronts and plans
# ---------------------------------------------------------------------------

def test_plan_row_tiles():
    """The reference's row-tile formula with the autotuner's tile replaced
    by the largest compiled one, rounded up to a compiled tile: 16 in bf16
    and 8 / 16 in f32 at qwen3-moe's decode (8 slots x top-8), prefill and
    training row counts over 128 experts."""
    plan = tgrouped.plan_grouped
    for rows, want32 in ((64, 8), (4096, 8), (8192, 16)):
        assert plan(rows, 1536, 4096, torch.bfloat16,
                    n_groups=128)[0] == 16
        assert plan(rows, 1536, 4096, torch.float32,
                    n_groups=128)[0] == want32
    for dt in (torch.float32, torch.bfloat16):
        for rows, ng in ((40, 1), (7, 3), (5000, 2)):
            bm = plan(rows, 64, 64, dt, n_groups=ng)[0]
            assert bm in kgg.row_tiles(dt)
            tiles = tgrouped.plan_tgmm(rows, 64, 64, dt, n_groups=ng)
            assert tiles[0] == bm and tiles in kgg.TGMM_TILES[dt]
    assert tgrouped.plan_tgmm(64, 8, 8, torch.float32, n_groups=4,
                              bm=16) == (16, 64, 64)
    with pytest.raises(ValueError):
        tgrouped.plan_tgmm(64, 8, 8, torch.bfloat16, n_groups=4, bm=8)


def test_rows_fronts_and_ops_branches():
    """`grouped_matmul_rows` / `tgmm_matmul_rows` and the rank-2 branches
    of `ops.grouped_gemm_call` against a per-expert loop."""
    rng = np.random.default_rng(5)
    t, ng, k, n = 37, 5, 24, 20
    gids = torch.from_numpy(_gids([9, 0, 15, 13, 0], seed=3))
    x = torch.from_numpy(rng.standard_normal((t, k)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((ng, k, n)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((t, n)).astype(np.float32))
    want_y = torch.stack([x[r] @ w[gids[r]] for r in range(t)])
    want_dw = torch.stack([x[gids == e].T @ g[gids == e] for e in range(ng)])
    ft = TFT(level="block")
    y, rep = tops.grouped_gemm_call(TKSpec(ft_level="block"), x, w,
                                    group_ids=gids, ft=ft)
    np.testing.assert_allclose(y.numpy(), want_y.numpy(), rtol=1e-5,
                               atol=1e-5)
    assert float(rep[..., 0].sum()) == 0.0
    dw, rep = tops.grouped_gemm_call(TKSpec(ft_level="block"), x, g,
                                     group_ids=gids, n_groups=ng, ft=ft)
    np.testing.assert_allclose(dw.numpy(), want_dw.numpy(), rtol=1e-5,
                               atol=1e-5)
    assert rep.shape == (ng, 1, 1, 8) and float(rep[..., 0].sum()) == 0.0
    y0, rep0 = tgrouped.grouped_matmul_rows(TSpec(grouped=True), x, w, gids)
    np.testing.assert_allclose(y0.numpy(), want_y.numpy(), rtol=1e-5,
                               atol=1e-5)
    assert rep0 is None
    with pytest.raises(ValueError):
        tops.grouped_gemm_call(TKSpec(), x, g, group_ids=gids)
    with pytest.raises(ValueError):
        TSpec(grouped=True, tgmm=True)
    with pytest.raises(ValueError):
        TSpec(tgmm=True, epilogue=("silu",))
    with pytest.raises(ValueError):
        TSpec(grouped=True, epilogue=("bias", "silu"))


# ---------------------------------------------------------------------------
# ft_grouped_matmul: forward and grads against jax.grad
# ---------------------------------------------------------------------------

GT, GG, GK, GN = 26, 4, 32, 24
GSIZES = [7, 0, 12, 7]


@pytest.fixture(scope="module")
def grouped_problem():
    """Integer operands (every product exact in f32) and the reference's
    output and grads of sum(y * r) on its op-level path."""
    rng = np.random.default_rng(6)
    gids = _gids(GSIZES, seed=4)
    x = rng.integers(-2, 3, (GT, GK)).astype(np.float32)
    w = rng.integers(-2, 3, (GG, GK, GN)).astype(np.float32)
    r = rng.integers(-2, 3, (GT, GN)).astype(np.float32)

    def loss(x_, w_):
        y = rcore.ft_grouped_matmul(x_, w_, jnp.asarray(gids),
                                    ft=RFT(backend="xla"))
        return jnp.sum(y * r), y

    (_, y), (dx, dw) = jax.value_and_grad(loss, argnums=(0, 1),
                                          has_aux=True)(jnp.asarray(x),
                                                        jnp.asarray(w))
    return dict(gids=gids, x=x, w=w, r=r, y=np.asarray(y), dx=np.asarray(dx),
                dw=np.asarray(dw))


def _port_grads(p, ft, bwd_inject=None, spec=None):
    x = torch.from_numpy(p["x"]).requires_grad_(True)
    w = torch.from_numpy(p["w"]).requires_grad_(True)
    with ttel.ft_scope() as scope:
        y = tcore.ft_grouped_matmul(x, w, torch.from_numpy(p["gids"]), ft=ft,
                                    spec=spec, bwd_inject=bwd_inject,
                                    site="moe_gate")
        (y * torch.from_numpy(p["r"])).sum().backward()
        sites = scope.site_totals()
    return y.detach().numpy(), x.grad.numpy(), w.grad.numpy(), sites


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_ft_grouped_matmul_grads_match_jax_grad(grouped_problem, backend):
    p = grouped_problem
    ft = TFT(backend=backend)
    y, dx, dw, sites = _port_grads(p, ft)
    np.testing.assert_array_equal(y, p["y"])
    np.testing.assert_array_equal(dx, p["dx"])
    np.testing.assert_array_equal(dw, p["dw"])
    assert sites["moe_gate"]["detected"] == 0.0
    # A forward SEU is corrected and counted under the call's site.
    y, _, _, sites = _port_grads(p, ft, spec=TInj(row=3, col=5,
                                                  magnitude=64.0))
    np.testing.assert_array_equal(y, p["y"])
    assert sites["moe_gate"]["detected"] == 1.0
    assert sites["moe_gate"]["corrected"] == 1.0


@pytest.mark.parametrize("target", ["dbuf", "dw"])
@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_bwd_inject_corrected_and_detect_only_leaves_it(grouped_problem,
                                                        backend, target):
    """An SEU in the named backward product: corrected to the clean grads
    exactly (integer operands); with a detect-only policy the grad moved by
    the SEU's magnitude. The dbuf SEU lands at k-step 0 (its K is one
    step); the kernel's dw SEU lands in the group that owns buffer tile 1,
    the torch-op dw SEU in every group's slice, as the reference's does."""
    p = grouped_problem
    inj = TInj(row=2, col=3, magnitude=40.0,
               k_step=0 if target == "dbuf" else 1)
    ft = TFT(backend=backend)
    _, dx, dw, _ = _port_grads(p, ft, bwd_inject=(target, inj))
    np.testing.assert_array_equal(dx, p["dx"])
    np.testing.assert_array_equal(dw, p["dw"])
    _, dx, dw, _ = _port_grads(p, ft.replace(action="detect"),
                               bwd_inject=(target, inj))
    moved = (np.abs(dx - p["dx"]).max() if target == "dbuf"
             else np.abs(dw - p["dw"]).max())
    assert moved == 40.0
    np.testing.assert_array_equal(dw if target == "dbuf" else dx,
                                  p["dw"] if target == "dbuf" else p["dx"])


def test_bwd_inject_needs_ft_and_ft_off_matches():
    p = dict(x=np.ones((4, 8), np.float32), w=np.ones((2, 8, 3), np.float32))
    gids = torch.tensor([0, 1, 1, 0])
    with pytest.raises(ValueError, match="bwd_inject"):
        tcore.ft_grouped_matmul(torch.from_numpy(p["x"]),
                                torch.from_numpy(p["w"]), gids,
                                bwd_inject=("dw", TInj(0, 0, 1.0)))
    y = tcore.ft_grouped_matmul(torch.from_numpy(p["x"]),
                                torch.from_numpy(p["w"]), gids)
    assert torch.equal(y, torch.full((4, 3), 8.0))
    assert tcore.grouped_row_tile(64, 8, 8, torch.bfloat16, 4,
                                  TFT(backend="xla")) == 16
    assert tcore.grouped_row_tile(64, 8, 8, torch.bfloat16, 4,
                                  TFT(backend="pallas")) == 16
    assert dataclasses.is_dataclass(tlay.GroupLayout)
