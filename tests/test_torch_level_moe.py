"""Port ↔ reference: the tile (warp) and inner (thread) FT levels in the MoE
layer — the grouped kernels K7 and K8 at the port's own tiles against the
reference's at its tiles, two SEUs in two bands of one block, and the
qwen3-moe-235b-a22b SMOKE model's loss, gradients and engine at each level.

Where the grouped layouts differ. At "tile" the reference aligns the
grouped row tile to its 128-row MXU band; the port keeps its compiled row
tile (16 in bf16, 8 or 16 in f32) with the band the rows one warp owns (2
or 1), and K8's band is the 8 dw rows one warp owns, not 128. So at the
port's tiles the per-block reports cannot be the reference's; what must
agree is the function: outputs, the detection and correction totals, and
the global (row, col) each SEU is located at. (At the reference's tiles the
plain versions give its reports field for field: `tests/test_torch_ft_gemm.py`.)

The reference runs its Pallas kernels in interpret mode; the port its plain
kernel versions. Tolerances: outputs and dw exactly on integer operands;
the loss to 1e-4 relative, every gradient leaf to 2e-5 relative (Frobenius
norm), FT counters equal; the engine's tokens exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as rreg  # noqa: E402
from repro.configs.base import RunConfig as RRun  # noqa: E402
from repro.core.policy import FTConfig as RFT  # noqa: E402
from repro.core.policy import InjectionSpec as RInj  # noqa: E402
from repro.kernels import grouped as rgrouped  # noqa: E402
from repro.kernels.autotune import KernelParams  # noqa: E402
from repro.kernels.grouped import layout as rlay  # noqa: E402
from repro.kernels.templates import BatchedKernelSpec as RSpec  # noqa: E402
from repro.models import blocks as rblocks  # noqa: E402
from repro.models import transformer as rtr  # noqa: E402
from repro.train import engine as reng  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.configs.base import RunConfig as TRun  # noqa: E402
from repro_torch.core import telemetry as ttel  # noqa: E402
from repro_torch.core.policy import FTConfig as TFT  # noqa: E402
from repro_torch.kernels import grouped_gemm as kgg  # noqa: E402
from repro_torch.kernels.grouped import layout as tlay  # noqa: E402
from repro_torch.kernels.templates.spec import band_of  # noqa: E402
from repro_torch.models import blocks as tblocks  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.train import engine as teng  # noqa: E402

LEVELS = ["tile", "inner"]
ARCH = "qwen3-moe-235b-a22b"
TRIPLE = (1, 123456789, 987654321)
CHUNK = 16
#: ragged groups, an empty one, a 40-row group spanning several port tiles
SIZES = [40, 0, 23, 9]
K, N = 256, 200


def _layouts(bm):
    gids = np.random.default_rng(0).permutation(
        np.repeat(np.arange(len(SIZES)), SIZES)).astype(np.int32)
    return (rlay.make_layout(jnp.asarray(gids), len(SIZES), bm),
            tlay.make_layout(torch.from_numpy(gids), len(SIZES), bm), gids)


def _ints(rng, *shape):
    return rng.integers(-3, 4, shape).astype(np.float32)


def _located(rep):
    rep = np.asarray(rep)
    hit = rep[rep[..., 0] > 0]
    return sorted((int(r[2]), int(r[3])) for r in hit)


# ---------------------------------------------------------------------------
# K7 and K8 at the port's tiles against the reference at its tiles
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("level", LEVELS)
def test_k7_port_tiles_match_reference(level):
    """K7's plain version at its compiled SIMT tile (8, 128, 32) (1-row
    bands at "tile") against the reference's grouped kernel at its tiles
    (128-row row tiles at "tile", its band): the same outputs, and an SEU in
    each non-empty group (in the first, a middle and the last row of a
    group's rows) detected and corrected once and located at the same
    global (row, col) on both sides; detect-only leaves it."""
    rng = np.random.default_rng(1)
    x = _ints(rng, sum(SIZES), K)
    w = _ints(rng, len(SIZES), K, N)
    rl, _, gids = _layouts(128)
    _, tl, _ = _layouts(8)
    rbuf = rlay.scatter_rows(jnp.asarray(x), rl)
    tbuf = tlay.scatter_rows(torch.from_numpy(x), tl)
    # (group, row within the group, col, k-step) of each SEU
    seus = [(0, 0, 150, 1), (0, 21, 3, 0), (2, 22, 199, 1), (3, 8, 77, 0)]
    want_y = np.einsum("tk,tkn->tn", x, w[np.asarray(gids)])
    for action in ("correct", "detect"):
        for g, r, c, s in seus:
            rrow = int(np.asarray(rl.base)[g]) + r
            trow = int(tl.base[g]) + r
            want, rrep = rgrouped.grouped_buffer_call(
                RSpec(ft_level=level, grouped=True), rbuf, jnp.asarray(w),
                rl, params=KernelParams(128, 128, 128),
                ft=RFT(level=level, action=action),
                inject=RInj(row=rrow, col=c, magnitude=64.0, k_step=s),
                interpret=True)
            got, trep = kgg.ft_gemm_grouped_plain(
                tbuf, torch.from_numpy(w), tl.gid, tl.row_end,
                tiles=(8, 128, 32), ft=TFT(level=level, action=action),
                inj=(1, trow, c, s), inj_mag=64.0)
            got = tlay.gather_rows(got, tl).numpy()
            want = np.asarray(rlay.gather_rows(want, rl))
            if action == "correct":
                np.testing.assert_array_equal(got, want_y)
                np.testing.assert_array_equal(want, want_y)
                for rep in (trep, np.asarray(rrep)):
                    assert float(rep[..., 0].sum()) == 1.0
                    assert float(rep[..., 1].sum()) == 1.0
                assert _located(trep) == [(trow, c)]
                assert _located(rrep) == [(rrow, c)]
            else:
                np.testing.assert_array_equal(got, want)
                assert float(trep[..., 1].sum()) == 0.0
                assert float(trep[..., 0].sum()) >= 1.0


@pytest.mark.parametrize("level", LEVELS)
def test_k8_port_tiles_match_reference(level):
    """K8's plain version at its compiled SIMT tile (8, 64, 64) (8-row
    bands of dw at "tile") against the reference's tgmm kernel at (8, 128,
    256) (two 128-row bands): the same dw, and an SEU in each non-empty
    group's dw (in the first, a middle and the last band of a port block)
    corrected once and located at the same global (row, col)."""
    rng = np.random.default_rng(2)
    x = _ints(rng, sum(SIZES), K)
    g = _ints(rng, sum(SIZES), N)
    rl, tl, gids = _layouts(8)
    rx, rg = (rlay.scatter_rows(jnp.asarray(v), rl) for v in (x, g))
    tx, tg = (tlay.scatter_rows(torch.from_numpy(v), tl) for v in (x, g))
    base = np.asarray(rl.base)
    want_dw = np.stack([x[gids == e].T @ g[gids == e]
                        for e in range(len(SIZES))])
    # (group, dw row, dw col, the group's tile): bands 0, 3 and 7 of the
    # port's 64-row dw blocks
    seus = [(0, 64, 5, 0), (0, 64 + 3 * 8 + 2, 130, 4), (2, 127, 199, 2),
            (3, 255, 0, 1)]
    for e, r, c, t in seus:
        k_step = int(base[e]) // 8 + t
        want, rrep = rgrouped.tgmm_buffer_call(
            RSpec(ft_level=level, tgmm=True), rx, rg, rl,
            params=KernelParams(8, 128, 256), ft=RFT(level=level),
            inject=RInj(row=r, col=c, magnitude=48.0, k_step=k_step),
            interpret=True)
        got, trep = kgg.tgmm_plain(tx, tg, tl.row_end, tiles=(8, 64, 64),
                                   ft=TFT(level=level),
                                   inj=(1, r, c, k_step), inj_mag=48.0)
        np.testing.assert_array_equal(got.numpy(), want_dw)
        np.testing.assert_array_equal(np.asarray(want), want_dw)
        for rep in (trep, np.asarray(rrep)):
            assert float(rep[..., 0].sum()) == float(rep[..., 1].sum()) == 1
        assert _located(trep) == _located(rrep) == [(r, c)]


def test_k7_k8_two_seus_in_two_bands_of_one_block():
    """At the tile level each band keeps its own column checksum: a
    campaign at rate 1.0 (every block draws one SEU) and a deterministic
    SEU in the next band of one block in the same interval are both
    corrected, K7 (2-row bands of its bf16 16-row tile) and K8 (8-row bands
    of dw); detect-only leaves both."""
    rng = np.random.default_rng(3)
    _, tl, _ = _layouts(16)
    xb = torch.from_numpy(_ints(rng, sum(SIZES), K)).bfloat16()
    gb = torch.from_numpy(_ints(rng, sum(SIZES), N)).bfloat16()
    w = torch.from_numpy(_ints(rng, len(SIZES), K, N)).bfloat16()
    buf, gbuf = tlay.scatter_rows(xb, tl), tlay.scatter_rows(gb, tl)
    ft = TFT(level="tile", inject_rate=1.0)
    tiles = (16, 128, 32)
    clean, _ = kgg.ft_gemm_grouped_plain(buf, w, tl.gid, tl.row_end,
                                         tiles=tiles, ft=ft)
    hit, step, row, col = kgg.seu_tile_draws(TRIPLE, ft, tl.num_tiles, 2, 8,
                                             tiles)
    i = 1                                      # group 0's second tile
    r = int(row[i, 1])
    band = band_of(tiles, "grouped")
    r2 = i * 16 + ((r // band + 1) % (16 // band)) * band + r % band
    inj = (1, r2, 128 + (int(col[i, 1]) + 1) % 72, int(step[i, 1]))
    for f in (ft, ft.replace(action="detect")):
        out, rep = kgg.ft_gemm_grouped_plain(
            buf, w, tl.gid, tl.row_end, tiles=tiles, ft=f, rng=TRIPLE,
            inj=inj, inj_mag=64.0)
        if f.corrects:
            assert torch.equal(out, clean)
            assert float(rep[i, 1, 0]) == float(rep[i, 1, 1]) == 2.0
        else:
            assert int((out != clean)[i * 16:(i + 1) * 16, 128:].sum()) == 2
    tiles = (16, 64, 64)
    dw0, _ = kgg.tgmm_plain(buf, gbuf, tl.row_end, tiles=tiles, ft=ft)
    first, _, re = kgg._group_span(tl.row_end, 16, tl.num_tiles)
    hit, step, row, col = kgg.seu_dw_draws(
        TRIPLE, ft, (re - first * 16).clamp_min(0), 4, 4, tiles)
    r = int(row[0, 2, 1])
    r2 = 128 + ((r // 8 + 1) % 8) * 8 + r % 8
    inj = (1, r2, 64 + (int(col[0, 2, 1]) + 1) % 64,
           int(first[0]) + int(step[0, 2, 1]))
    for f in (ft, ft.replace(action="detect")):
        dw, rep = kgg.tgmm_plain(buf, gbuf, tl.row_end, tiles=tiles, ft=f,
                                 rng=TRIPLE, inj=inj, inj_mag=48.0)
        if f.corrects:
            assert torch.equal(dw, dw0)
            assert float(rep[0, 2, 1, 0]) == float(rep[0, 2, 1, 1]) == 2.0
        else:
            assert int((dw != dw0)[0, 128:192, 64:128].sum()) == 2


# ---------------------------------------------------------------------------
# the qwen3-moe SMOKE model at the level
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def model():
    rcfg, tcfg = rreg.get_smoke(ARCH), treg.get_smoke(ARCH)
    params = rtr.init(rcfg, jax.random.PRNGKey(0), jnp.float32)
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, params),
                                        device="cpu")
    return rcfg, tcfg, params, tparams


def _batch(vocab, seed=7, b=2, s=16):
    tok = np.random.default_rng(seed).integers(0, vocab, (b, s + 1))
    return {"tokens": tok[:, :-1].astype(np.int32),
            "labels": tok[:, 1:].astype(np.int32)}


@pytest.mark.parametrize("level", LEVELS)
def test_moe_loss_and_grads_match_reference(model, level):
    """`loss_fn` and its backward at the level on the kernel backend: K7
    for the expert GEMMs and the dbuf products, K8 for the expert dw, K1
    for the attention and head GEMMs, all at the level, against the
    reference's kernels at the level."""
    rcfg, tcfg, params, tparams = model
    batch = _batch(rcfg.vocab_size)
    rctx = rblocks.Ctx(ft=RFT(level=level, backend="pallas"),
                       dtype=jnp.float32, attn_shard="none")
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (rl, rmet), rgrads = jax.value_and_grad(
        lambda p: rtr.loss_fn(p, jb, rcfg, rctx, remat=False, chunk=CHUNK),
        has_aux=True)(params)
    tctx = tblocks.Ctx(ft=TFT(level=level, backend="pallas"),
                       dtype=torch.float32)
    tb = {k: torch.as_tensor(v).long() for k, v in batch.items()}
    tparams.requires_grad_(True)
    try:
        tl, tmet = ttr.loss_fn(tparams, tb, tcfg, tctx, remat="full",
                               chunk=CHUNK)
        tl.backward()
        np.testing.assert_allclose(float(tl.detach()), float(rl), rtol=1e-4)
        for name in ("detected", "corrected"):
            assert float(getattr(tmet["ft"], name)) == float(
                getattr(rmet["ft"], name)) == 0.0
        named = dict(tparams.named_parameters())
        flat = jax.tree_util.tree_flatten_with_path(rgrads)[0]
        assert len(flat) == len(named)
        for path, want in flat:
            got = named[".".join(p.key for p in path)].grad.numpy()
            want = np.asarray(want)
            rel = np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                   1e-30)
            assert rel <= 2e-5, (path, rel)
    finally:
        for p in tparams.parameters():
            p.grad = None
        tparams.requires_grad_(False)


@pytest.mark.parametrize("level", LEVELS)
def test_engine_decode_at_level_matches_reference(model, level):
    """`ServeEngine` at the level on the kernel backend (K7 for the expert
    GEMMs of the prefill and of each decode step), 2 requests on 2 slots,
    against the reference engine at the level: the same greedy tokens, no
    detection."""
    rcfg, tcfg, params, tparams = model
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, rcfg.vocab_size, (n,)) for n in (5, 11)]
    budgets = [3, 2]
    ec = dict(max_len=32, n_slots=2, page_size=8)
    r = reng.ServeEngine(params, rcfg,
                         RRun(model=rcfg, ft=RFT(level=level,
                                                 backend="pallas"),
                              dtype="float32"), reng.EngineConfig(**ec))
    t = teng.ServeEngine(tparams, tcfg,
                         TRun(model=tcfg, ft=TFT(level=level,
                                                 backend="pallas"),
                              dtype="float32"),
                         teng.EngineConfig(**ec), device="cpu")
    for p_, m in zip(prompts, budgets):
        r.submit(p_, max_new_tokens=m)
        t.submit(p_, max_new_tokens=m)
    want = r.run()
    with ttel.ft_scope() as scope:
        got = t.run()
        sites = scope.site_totals()
    assert [g.tokens for g in got] == [w.tokens for w in want]
    assert [len(g.tokens) for g in got] == budgets
    assert {"moe_gate", "moe_up", "moe_down"} <= set(sites)
    assert all(v["detected"] == 0.0 for v in sites.values())


@pytest.mark.parametrize("level", LEVELS)
def test_level_wrappers_run_on_the_card_or_the_cpu_only(level):
    """At tile and inner the K1, K7 and K8 wrappers take a CPU tensor to
    the plain version under the plan and a tensor on any other device to
    its kernel or an error: no silent fallback (a meta tensor stands for a
    device without the kernels)."""
    from repro_torch.kernels import ft_gemm as kgemm
    ft = TFT(level=level)
    a, b = torch.ones(4, 8, device="meta"), torch.ones(8, 4, device="meta")
    with pytest.raises(ValueError, match="device"):
        kgemm.ft_gemm(a, b, chain=("silu",), ft=ft, save_act_grad=True)
    with pytest.raises(ValueError, match="device"):
        kgemm.ft_gemm(a.T, b.T, ft=ft)
    buf, w = torch.ones(16, 8, device="meta"), torch.ones(2, 8, 4,
                                                          device="meta")
    gid = torch.zeros(1, dtype=torch.int32, device="meta")
    row_end = torch.ones(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="device"):
        kgg.ft_gemm_grouped(buf, w, gid, row_end, ft=ft)
    with pytest.raises(ValueError, match="device"):
        kgg.tgmm(buf, torch.ones(16, 4, device="meta"), row_end, bm=16,
                 ft=ft)
    out, rep = kgemm.ft_gemm(torch.ones(4, 8), torch.ones(8, 4),
                             chain=("silu",), ft=ft, save_act_grad=True)
    assert out[0].shape == out[1].shape == (4, 4)
    assert float(rep[..., 0].sum()) == 0.0
