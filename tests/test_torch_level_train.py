"""Port ↔ reference: the tile (warp) and inner (thread) FT levels in
training — the backward injection matrix of the reference's
`tests/test_backward_ft.py` at its ("pallas", "tile") and ("pallas",
"inner") rows, K1 with act_grad and on the dw walk (x.T, LAYOUT 2), and
`loss_fn` with its gradients on the phi4-mini-3.8b SMOKE config.

The reference runs its Pallas kernels in interpret mode; the port runs its
plain kernel versions (what the CUDA kernels compute, on their grids). The
same numpy-seeded inputs go to both; weights come from the reference's init
through `convert.py`.

Tolerances: on integer-valued operands checksum arithmetic is exact, so a
corrected SEU leaves outputs and grads equal to the clean run's bit for bit
and the grads equal to the reference's exactly; the loss to 1e-4 relative
and every grad leaf to 1e-4 relative (Frobenius norm) through the whole
model (f32 sums in other orders); FT counters equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as rreg  # noqa: E402
from repro.core import ft_dot as r_ft_dot  # noqa: E402
from repro.core import ft_dot_fused as r_ft_dot_fused  # noqa: E402
from repro.core import ft_grouped_matmul as r_ft_grouped  # noqa: E402
from repro.core.policy import FTConfig, InjectionSpec  # noqa: E402
from repro.kernels import autotune, ops as rops  # noqa: E402
from repro.models import transformer as rtr  # noqa: E402
from repro.models.blocks import Ctx as RCtx  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.core import ft_gemm as tcore  # noqa: E402
from repro_torch.core import policy as tpol  # noqa: E402
from repro_torch.core import telemetry as ttel  # noqa: E402
from repro_torch.kernels import ft_gemm as kgemm  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.models.blocks import Ctx as TCtx  # noqa: E402

LEVELS = ["tile", "inner"]
#: A campaign triple: at rate 1.0 every block draws one SEU.
TRIPLE = (1, 123456789, 987654321)
CHUNK = 16


def _ints(shape, seed, lo=-3, hi=4):
    rng = np.random.default_rng(seed)
    return rng.integers(lo, hi, size=shape).astype(np.float32)


def _skewed_gids(t, g, seed):
    """The reference test's routing: skewed, an empty group in the middle,
    a ragged last group."""
    rng = np.random.default_rng(seed)
    probs = 1.0 / np.arange(1, g + 1)
    if g > 2:
        probs[g // 2] = 0.0
    probs /= probs.sum()
    return np.sort(rng.choice(g, size=t, p=probs)).astype(np.int32)


def _fts(level, action="correct"):
    return (FTConfig(level=level, backend="pallas", action=action),
            tpol.FTConfig(level=level, backend="pallas", action=action))


def _tinj(bwd):
    if bwd is None:
        return None
    target, s = bwd
    return target, tpol.InjectionSpec(s.row, s.col, s.magnitude, s.k_step)


def _port_grads(fn, arrays, bwd=None):
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    fn(*ts, _tinj(bwd)).sum().backward()
    return [t.grad.numpy() for t in ts]


def _ref_grads(fn, arrays, bwd=None):
    return [np.asarray(g) for g in jax.grad(
        lambda *xs: jnp.sum(fn(*xs, bwd)),
        argnums=tuple(range(len(arrays))))(*map(jnp.asarray, arrays))]


# ---------------------------------------------------------------------------
# the reference's backward injection matrix at its tile and inner rows
# ---------------------------------------------------------------------------

def _dense(level):
    rft, tft = _fts(level)
    return (lambda x, w, bi: r_ft_dot(x, w, ft=rft, bwd_inject=bi),
            lambda x, w, bi: tcore.ft_dot(x, w, ft=tft, bwd_inject=bi))


@pytest.mark.parametrize("target", ["dx", "dw"])
@pytest.mark.parametrize("level", LEVELS)
def test_dense_bwd_injection_roundtrip(level, target):
    """An SEU in the dense dx (LAYOUT 1) or dw (LAYOUT 2) GEMM at the level:
    the grads equal the clean run's and the reference's bit for bit."""
    x, w = _ints((32, 64), 1), _ints((64, 48), 2)
    inj = (target, InjectionSpec(row=2, col=3, magnitude=384.0, k_step=0))
    rfn, tfn = _dense(level)
    want = _ref_grads(rfn, (x, w), inj)
    clean = _port_grads(tfn, (x, w))
    hurt = _port_grads(tfn, (x, w), inj)
    for c, h, r in zip(clean, hurt, want):
        np.testing.assert_array_equal(h, c)
        np.testing.assert_array_equal(h, r)


@pytest.mark.parametrize("level", LEVELS)
def test_dense_bwd_detect_only_leaves_error(level):
    """A detect-only policy leaves the dx SEU in the gradient, as the
    reference's does: the injection lands inside the backward GEMM."""
    x, w = _ints((32, 64), 3), _ints((64, 48), 4)
    rft, tft = _fts(level, action="detect")
    inj = ("dx", InjectionSpec(row=2, col=3, magnitude=384.0, k_step=0))
    ts = torch.tensor(x, requires_grad=True)
    tcore.ft_dot(ts, torch.tensor(w), ft=tft).sum().backward()
    clean = ts.grad.numpy().copy()
    ts.grad = None
    tcore.ft_dot(ts, torch.tensor(w), ft=tft,
                 bwd_inject=_tinj(inj)).sum().backward()
    err = ts.grad.numpy() - clean
    want = np.asarray(jax.grad(lambda x_: jnp.sum(r_ft_dot(
        x_, jnp.asarray(w), ft=rft, bwd_inject=inj)))(jnp.asarray(x)))
    np.testing.assert_array_equal(ts.grad.numpy(), want)
    assert abs(err[2, 3] - 384.0) < 1e-3
    err[2, 3] = 0.0
    np.testing.assert_allclose(err, 0.0, atol=1e-5)


@pytest.mark.parametrize("target", ["dbuf", "dw"])
@pytest.mark.parametrize("level", LEVELS)
def test_grouped_bwd_injection_roundtrip(level, target):
    """The grouped backward at the level: an SEU in dbuf (K7 on the wᵀ
    view) or in dw (K8), with an empty group and a ragged last one, is
    corrected to the clean grads; the grads equal the reference's (its
    128-row tile-level layout against the port's own row tile)."""
    t, g, k, n = 61, 4, 96, 40
    gids = _skewed_gids(t, g, seed=5)
    x = _ints((t, k), 6)
    w = _ints((g, k, n), 7, lo=-2, hi=3)
    inj = (target, InjectionSpec(row=1, col=2, magnitude=512.0, k_step=0))
    rft, tft = _fts(level)
    want = _ref_grads(lambda x_, w_, bi: r_ft_grouped(
        x_, w_, jnp.asarray(gids), ft=rft, bwd_inject=bi), (x, w))
    tg = torch.from_numpy(gids)

    def tfn(x_, w_, bi):
        return tcore.ft_grouped_matmul(x_, w_, tg, ft=tft, bwd_inject=bi)

    clean = _port_grads(tfn, (x, w))
    hurt = _port_grads(tfn, (x, w), inj)
    for c, h, r in zip(clean, hurt, want):
        np.testing.assert_array_equal(h, c)
        np.testing.assert_array_equal(c, r)


@pytest.mark.parametrize("level", LEVELS)
def test_grouped_bwd_detect_only_leaves_error(level):
    """Detect-only leaves a K8 dw SEU in the expert's gradient."""
    t, g, k, n = 61, 4, 96, 40
    gids = torch.from_numpy(_skewed_gids(t, g, seed=5))
    x, w = torch.tensor(_ints((t, k), 6)), torch.tensor(
        _ints((g, k, n), 7, lo=-2, hi=3))
    _, tft = _fts(level, action="detect")
    inj = ("dw", tpol.InjectionSpec(row=1, col=2, magnitude=512.0, k_step=0))
    grads = []
    for bi in (None, inj):
        wt = w.clone().requires_grad_(True)
        tcore.ft_grouped_matmul(x, wt, gids, ft=tft,
                                bwd_inject=bi).sum().backward()
        grads.append(wt.grad)
    err = (grads[1] - grads[0]).abs()
    assert float(err.max()) == 512.0 and int((err > 0).sum()) == 1


@pytest.mark.parametrize("target", ["dx", "dw"])
@pytest.mark.parametrize("level", LEVELS)
def test_fused_bwd_injection_roundtrip(level, target):
    """The fused-epilogue backward at the level: dpre = g ∘ act' from the
    act_grad residual the forward kernel saved; relu keeps dpre integer,
    so the corrected grads equal the clean ones and the reference's bit
    for bit."""
    x, w = _ints((32, 64), 8), _ints((64, 48), 9)
    bias = _ints((48,), 10, lo=-2, hi=3)
    inj = (target, InjectionSpec(row=2, col=3, magnitude=384.0, k_step=0))
    rft, tft = _fts(level)
    want = _ref_grads(lambda x_, w_, bi: r_ft_dot_fused(
        x_, w_, bias=jnp.asarray(bias), act="relu", ft=rft, bwd_inject=bi),
        (x, w), inj)

    def tfn(x_, w_, bi):
        return tcore.ft_dot_fused(x_, w_, bias=torch.tensor(bias),
                                  act="relu", ft=tft, bwd_inject=bi)

    clean = _port_grads(tfn, (x, w))
    hurt = _port_grads(tfn, (x, w), inj)
    for c, h, r in zip(clean, hurt, want):
        np.testing.assert_array_equal(h, c)
        np.testing.assert_array_equal(h, r)


@pytest.mark.parametrize("level", LEVELS)
def test_fused_residual_path_fwd_injection(level):
    """A forward SEU in the act_grad kernel is corrected before act' is
    written: the output and the grads (which consume the saved residual)
    equal the clean run's bit for bit."""
    x, w = _ints((32, 64), 11), _ints((64, 48), 12)
    bias = torch.tensor(_ints((48,), 13, lo=-2, hi=3))
    _, tft = _fts(level)
    spec = tpol.InjectionSpec(row=4, col=5, magnitude=640.0, k_step=0)
    runs = []
    for sp in (None, spec):
        xt, wt = torch.tensor(x, requires_grad=True), torch.tensor(
            w, requires_grad=True)
        with ttel.ft_scope() as scope:
            y = tcore.ft_dot_fused(xt, wt, bias=bias, act="relu", ft=tft,
                                   spec=sp, site="w_gate")
            y.sum().backward()
            tot = scope.totals()
        runs.append((y.detach(), xt.grad, wt.grad, tot))
    for a, b in zip(runs[0][:3], runs[1][:3]):
        assert torch.equal(a, b)
    assert runs[0][3]["detected"] == 0.0
    assert runs[1][3]["detected"] == runs[1][3]["corrected"] == 1.0


# ---------------------------------------------------------------------------
# K1 with act_grad at the level against the reference's multi-output kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("level", LEVELS)
def test_act_grad_at_level_matches_reference(level, with_bias):
    """w_gate + silu with the act_grad output at the level, at the
    reference's tiles: C, act'(pre-activation) (from the corrected block)
    and the report against the reference kernel's multi-output variant,
    an SEU corrected before act_grad is written."""
    m, n, k = 40, 200, 300
    rng = np.random.default_rng(16)
    a = rng.normal(size=(m, k)).astype(np.float32)
    b = (rng.normal(size=(k, n)) * 0.1).astype(np.float32)
    bias = rng.normal(size=(n,)).astype(np.float32) if with_bias else None
    spec = InjectionSpec(row=5, col=130, magnitude=50.0, k_step=1)
    rft, tft = _fts(level)
    params = autotune.KernelParams(128, 128, 128)
    (rc, rg), rrep = rops.fused_matmul(
        jnp.asarray(a), jnp.asarray(b),
        bias=None if bias is None else jnp.asarray(bias), act="silu",
        ft=rft, inject=spec, params=params, interpret=True,
        save_act_grad=True)
    (tc, tg), trep = tops.fused_matmul(
        torch.tensor(a), torch.tensor(b),
        bias=None if bias is None else torch.tensor(bias), act="silu",
        ft=tft, inject=tpol.InjectionSpec(spec.row, spec.col, spec.magnitude,
                                          spec.k_step),
        tiles=(128, 128, 128), save_act_grad=True)
    np.testing.assert_allclose(tc.numpy(), np.asarray(rc), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tg.numpy(), np.asarray(rg), rtol=1e-5,
                               atol=1e-5)
    trep, rrep = trep.numpy(), np.asarray(rrep)
    np.testing.assert_array_equal(trep[..., [0, 1, 2, 3, 7]],
                                  rrep[..., [0, 1, 2, 3, 7]])
    assert trep[..., 0].sum() == trep[..., 1].sum() == 1.0
    clean, _ = tops.fused_matmul(
        torch.tensor(a), torch.tensor(b),
        bias=None if bias is None else torch.tensor(bias), act="silu",
        ft=tft, tiles=(128, 128, 128), save_act_grad=True)
    # corrected to the clean call's up to the f32 rounding of the located
    # magnitude (Gaussian operands)
    for c, h in zip(clean, (tc, tg)):
        np.testing.assert_allclose(h.numpy(), c.numpy(), rtol=1e-5,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# K1 on the dw walk (LAYOUT 2) at the kernel's tiles: SEUs by band
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("level", LEVELS)
def test_dw_walk_bands_match_reference(level):
    """dw = Xᵀ·g with A the x.T view (unit stride along m: the kernel's
    LAYOUT 2) at the kernel's 64 x 64 tiles (8-row bands) against the
    reference at its tiles: SEUs in the first, a middle and the last band
    of a block, and in the ragged last block, each corrected bit for bit;
    totals and the located global (row, col) as the reference's."""
    t, kd, n = 150, 130, 200
    x, g = _ints((t, kd), 20), _ints((t, n), 21)
    rft, tft = _fts(level)
    a = torch.tensor(x).T
    assert a.stride() == (1, kd)
    tiles = kgemm.TILES[0]
    band = kgemm.band_of(tiles)
    assert (tiles[0], band) == (64, 8)
    clean, rep = kgemm.ft_gemm_plain(a, torch.tensor(g), tiles=tiles, ft=tft)
    np.testing.assert_array_equal(clean.numpy(), x.T @ g)
    assert float(rep[..., 0].sum()) == 0.0
    for row in (64, 64 + 3 * band + 5, 127, 129):
        # k-step 1 exists in both walks (bk 32 here, 128 in the reference)
        spec = InjectionSpec(row=row, col=77, magnitude=99.0, k_step=1)
        _, rrep = rops.ft_matmul_report(
            jnp.asarray(x).T, jnp.asarray(g), ft=rft, spec=spec,
            params=autotune.KernelParams(128, 128, 128), interpret=True)
        out, trep = kgemm.ft_gemm_plain(a, torch.tensor(g), tiles=tiles,
                                        ft=tft, inj=(1, -1, row, 77, 1),
                                        inj_mag=99.0)
        assert torch.equal(out, clean)
        rrep = np.asarray(rrep)
        assert float(trep[..., 0].sum()) == float(rrep[..., 0].sum()) == 1
        assert float(trep[..., 1].sum()) == float(rrep[..., 1].sum()) == 1
        hit = trep[trep[..., 0] > 0]
        rhit = rrep[rrep[..., 0] > 0]
        assert (int(hit[0, 2]), int(hit[0, 3])) == (row, 77) == \
            (int(rhit[0, 2]), int(rhit[0, 3]))


def test_two_seus_in_two_bands_of_one_block():
    """At the tile level each band keeps its own column checksum, so two
    SEUs in two bands of one block in one k-step are both corrected at
    that verification: a campaign at rate 1.0 (every
    block draws one) and a deterministic SEU in the next band of block
    (1, 1) at the campaign SEU's k-step, on the dw walk."""
    t, kd, n = 150, 130, 200
    a = torch.tensor(_ints((t, kd), 22)).T
    g = torch.tensor(_ints((t, n), 23))
    tiles = kgemm.TILES[0]
    bm, bn, bk = tiles
    ft = tpol.FTConfig(level="tile", backend="pallas", inject_rate=1.0)
    clean, _ = kgemm.ft_gemm_plain(a, g, tiles=tiles, ft=ft)
    hit, step, row, col = kgemm.seu_draws(TRIPLE, ft, 1, 3, 4, 5, tiles,
                                          False)
    r = int(row[0, 1, 1])
    r2 = bm + ((r // 8 + 1) % 8) * 8 + r % 8
    inj = (1, -1, r2, bn + (int(col[0, 1, 1]) + 1) % bn, int(step[0, 1, 1]))
    out, rep = kgemm.ft_gemm_plain(a, g, tiles=tiles, ft=ft, rng=TRIPLE,
                                   inj=inj, inj_mag=99.0)
    assert torch.equal(out, clean)
    assert float(rep[1, 1, 0]) == float(rep[1, 1, 1]) == 2.0
    assert float(rep[..., 0].sum()) == float(hit.sum()) + 1


# ---------------------------------------------------------------------------
# loss and grads of a model at the level
# ---------------------------------------------------------------------------

def _batch(vocab, seed=1, b=2, s=16):
    tok = np.random.default_rng(seed).integers(0, vocab, (b, s + 1))
    return {"tokens": tok[:, :-1].astype(np.int32),
            "labels": tok[:, 1:].astype(np.int32)}


@pytest.fixture(scope="module")
def phi4():
    rcfg, tcfg = rreg.get_smoke("phi4-mini-3.8b"), treg.get_smoke(
        "phi4-mini-3.8b")
    params = rtr.init(rcfg, jax.random.PRNGKey(0), jnp.float32)
    return rcfg, tcfg, params


@pytest.mark.parametrize("level", LEVELS)
def test_loss_and_grads_match_reference(phi4, level):
    """phi4-mini SMOKE's `loss_fn` and backward at the level on the kernel
    backend (remat "full"): every K1 call (w_gate with act_grad, the dx and
    dw walks) at the level, against the reference's at the level."""
    rcfg, tcfg, params = phi4
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, params),
                                        device="cpu")
    tparams.requires_grad_(True)
    batch = _batch(rcfg.vocab_size)
    rft, tft = _fts(level)
    rctx = RCtx(ft=rft, dtype=jnp.float32)
    (rloss, rmet), rgrads = jax.value_and_grad(
        lambda p: rtr.loss_fn(p, {k: jnp.asarray(v) for k, v in
                                  batch.items()}, rcfg, rctx, remat=True,
                              chunk=CHUNK), has_aux=True)(params)
    tctx = TCtx(ft=tft, dtype=torch.float32)
    tloss, tmet = ttr.loss_fn(
        tparams, {k: torch.as_tensor(v).long() for k, v in batch.items()},
        tcfg, tctx, remat="full", chunk=CHUNK)
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(rloss),
                               rtol=1e-4)
    for name in ("detected", "corrected"):
        assert float(getattr(tmet["ft"], name)) == float(
            getattr(rmet["ft"], name)) == 0.0
    flat = jax.tree_util.tree_flatten_with_path(rgrads)[0]
    named = dict(tparams.named_parameters())
    assert len(flat) == len(named)
    for path, want in flat:
        got = named[".".join(p.key for p in path)].grad.numpy()
        want = np.asarray(want)
        rel = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
        assert rel <= 1e-4, (path, rel)
