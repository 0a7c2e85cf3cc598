"""Port ↔ reference: the "tile" (warp-level) and "inner" (thread-level) FT
levels of the ABFT GEMM kernels K1 (2-D) and K5 (uniform batched). The
port's plain versions on the kernel's tile grid against the reference's
Pallas kernels in interpret mode, at the reference's pinned tiles and its
128-row band, on the same numpy-seeded inputs; `generate` at each level
against the reference's.

Tolerances: outputs rtol 1e-5 / atol 1e-4 in f32. Reports: fields 0-4
(det, corr, row, col, mag) equal and 5-7 (max residual, tau, k) within
1e-4 relative on integer-valued operands (exact arithmetic on both sides);
with Gaussian operands the located fields agree exactly, the magnitude to
1e-2 and the residuals are f32 rounding noise in two summation orders.
bf16: one bf16 ulp at the top of the output's range.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as rreg  # noqa: E402
from repro.configs.base import RunConfig as RRun  # noqa: E402
from repro.core.policy import FTConfig, InjectionSpec  # noqa: E402
from repro.kernels import autotune, ops as rops  # noqa: E402
from repro.kernels.templates import BatchedKernelSpec  # noqa: E402
from repro.models import transformer as rtr  # noqa: E402
from repro.train import serve as rserve  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.configs.base import RunConfig as TRun  # noqa: E402
from repro_torch.core import policy as tpol  # noqa: E402
from repro_torch.kernels import ft_gemm as tgemm  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels.templates import KernelSpec as TKernelSpec  # noqa: E402
from repro_torch.train import serve as tserve  # noqa: E402

LEVELS = ["tile", "inner"]
TILES = [(128, 128, 128), (256, 128, 128)]
SEU = InjectionSpec(row=130, col=200, magnitude=77.0, k_step=1)


def _t(x):
    return None if x is None else torch.from_numpy(np.asarray(x))


def _tspec(spec):
    return None if spec is None else tpol.InjectionSpec(
        spec.row, spec.col, spec.magnitude, spec.k_step)


def _ints(rng, *shape):
    return rng.integers(-3, 4, shape).astype(np.float32)


def _fts(level, action="correct", verify="step"):
    return (FTConfig(level=level, action=action, verify=verify),
            tpol.FTConfig(level=level, action=action, verify=verify))


def _masked_tiles(m, n, k, params, level, dtype=jnp.float32):
    """The tile grid the reference's dispatcher runs at ``params``."""
    info = rops.dispatch_info(m, n, k, params, dtype=dtype, ft_level=level)
    q = info["masked_params"] if info["path"] == "masked" else info["params"]
    return (q.bm, q.bn, q.bk)


def _assert_reports(got, want, exact):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape
    if exact:
        np.testing.assert_array_equal(got[..., :5], want[..., :5])
        np.testing.assert_allclose(got[..., 5:], want[..., 5:], rtol=1e-4,
                                   atol=0)
    else:
        np.testing.assert_array_equal(got[..., :4], want[..., :4])
        np.testing.assert_allclose(got[..., 4], want[..., 4], rtol=0,
                                   atol=1e-2)
        np.testing.assert_allclose(got[..., 6:], want[..., 6:], rtol=1e-4,
                                   atol=0)
        assert np.all(got[..., 5][got[..., 0] == 0]
                      < got[..., 6][got[..., 0] == 0])


@pytest.mark.parametrize("verify", ["step", "final"])
@pytest.mark.parametrize("tiles", TILES)
@pytest.mark.parametrize("level", LEVELS)
def test_ft_matmul_report_levels_match_reference(level, tiles, verify):
    """(256, 512) x (512, 384) f32 at two pinned tiles (two 128-row bands
    in the 256-row one): a clean Gaussian run; the SEU (row 130, col 200,
    k-step 1, 77) corrected and located; the same SEU under a detect-only
    policy counted as often as the reference counts it."""
    params = autotune.KernelParams(*tiles)
    rng = np.random.default_rng(sum(tiles) + len(verify))
    a = rng.normal(size=(256, 512)).astype(np.float32)
    b = rng.normal(size=(512, 384)).astype(np.float32)
    rft, tft = _fts(level, verify=verify)
    ro, rr = rops.ft_matmul_report(jnp.asarray(a), jnp.asarray(b), ft=rft,
                                   params=params, interpret=True)
    to, tr = tops.ft_matmul_report(_t(a), _t(b), ft=tft, tiles=tiles)
    np.testing.assert_allclose(to.numpy(), np.asarray(ro), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(to.numpy(), a @ b, rtol=1e-5, atol=1e-3)
    assert float(tr[..., 0].sum()) == float(np.asarray(rr)[..., 0].sum()) == 0
    _assert_reports(tr, rr, exact=False)

    a, b = _ints(rng, 256, 512), _ints(rng, 512, 384)
    for action in ("correct", "detect"):
        rft, tft = _fts(level, action, verify)
        ro, rr = rops.ft_matmul_report(jnp.asarray(a), jnp.asarray(b),
                                       ft=rft, spec=SEU, params=params,
                                       interpret=True)
        to, tr = tops.ft_matmul_report(_t(a), _t(b), ft=tft,
                                       spec=_tspec(SEU), tiles=tiles)
        np.testing.assert_allclose(to.numpy(), np.asarray(ro), rtol=1e-5,
                                   atol=1e-4)
        _assert_reports(tr, rr, exact=True)
        hit = tr[tr[..., 0] > 0]
        assert (int(hit[0, 2]), int(hit[0, 3])) == (SEU.row, SEU.col)
        assert abs(float(hit[0, 4]) - SEU.magnitude) < 1e-2
        if action == "correct":
            np.testing.assert_array_equal(to.numpy(), a @ b)
            assert float(tr[..., 0].sum()) == float(tr[..., 1].sum()) == 1
        else:
            assert to.numpy()[SEU.row, SEU.col] == (a @ b)[SEU.row, SEU.col] \
                + SEU.magnitude
            assert float(tr[..., 1].sum()) == 0.0


@pytest.mark.parametrize("level", LEVELS)
def test_ragged_levels_correct_injection_like_reference(level):
    """The reference's ragged SEU case (tests/test_kernels.py:199): 100 x 77
    x 300 at pinned params on the masked tile grid, one SEU at k-step 0."""
    m, n, k = 100, 77, 300
    params = autotune.KernelParams(128, 128, 128)
    tiles = _masked_tiles(m, n, k, params, level)
    rng = np.random.default_rng(21)
    a = rng.normal(size=(m, k)).astype(np.float32)
    b = rng.normal(size=(k, n)).astype(np.float32)
    spec = InjectionSpec(row=63, col=50, magnitude=44.0, k_step=0)
    rft, tft = _fts(level)
    ro, rr = rops.ft_matmul_report(jnp.asarray(a), jnp.asarray(b), ft=rft,
                                   spec=spec, params=params, interpret=True)
    to, tr = tops.ft_matmul_report(_t(a), _t(b), ft=tft, spec=_tspec(spec),
                                   tiles=tiles)
    np.testing.assert_allclose(to.numpy(), np.asarray(ro), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(to.numpy(), a @ b, rtol=1e-5, atol=1e-3)
    _assert_reports(tr, rr, exact=False)
    assert float(tr[..., 0].sum()) == 1.0
    blk = tr.reshape(-1, 8)[tr.reshape(-1, 8)[:, 0] > 0][0]
    assert (int(blk[2]), int(blk[3])) == (63, 50)
    assert abs(float(blk[4]) - 44.0) < 1e-2


@pytest.mark.parametrize("level", LEVELS)
def test_bf16_levels_match_reference(level):
    m, n, k = 128, 256, 384
    params = autotune.KernelParams(128, 128, 128)
    rng = np.random.default_rng(31)
    a = rng.normal(size=(m, k)).astype(np.float32)
    b = (rng.normal(size=(k, n)) * 0.1).astype(np.float32)
    rft, tft = _fts(level)
    ro, rr = rops.ft_matmul_report(jnp.asarray(a, jnp.bfloat16),
                                   jnp.asarray(b, jnp.bfloat16), ft=rft,
                                   params=params, interpret=True)
    to, tr = tops.ft_matmul_report(_t(a).bfloat16(), _t(b).bfloat16(),
                                   ft=tft, tiles=(128, 128, 128))
    assert to.dtype == torch.bfloat16
    want = np.asarray(ro.astype(jnp.float32))
    tol = 2.0 ** -7 * np.abs(want).max()
    assert np.abs(to.float().numpy() - want).max() <= tol
    assert float(tr[..., 0].sum()) == float(np.asarray(rr)[..., 0].sum()) == 0


def test_tile_bias_silu_verifies_before_the_chain():
    """bias + silu at the tile level: the raw accumulator is verified and
    corrected (no fold of the bias), then the whole chain runs."""
    m, n, k = 256, 256, 384
    params = autotune.KernelParams(256, 128, 128)
    rng = np.random.default_rng(41)
    a, b, bias = _ints(rng, m, k), _ints(rng, k, n), _ints(rng, n)
    spec = InjectionSpec(row=200, col=130, magnitude=500.0, k_step=2)
    for action in ("correct", "detect"):
        rft, tft = _fts("tile", action)
        ro, rr = rops.fused_matmul(jnp.asarray(a), jnp.asarray(b),
                                   bias=jnp.asarray(bias), act="silu",
                                   ft=rft, inject=spec, params=params,
                                   interpret=True)
        to, tr = tops.fused_matmul(_t(a), _t(b), bias=_t(bias), act="silu",
                                   ft=tft, inject=_tspec(spec),
                                   tiles=(256, 128, 128))
        np.testing.assert_allclose(to.numpy(), np.asarray(ro), rtol=1e-5,
                                   atol=1e-4)
        _assert_reports(tr, rr, exact=True)
        hit = tr[tr[..., 0] > 0]
        # the raw accumulator's residual: the SEU, not SEU + a bias fold
        assert (int(hit[0, 2]), int(hit[0, 3]), float(hit[0, 4])) == \
            (200, 130, 500.0)
    clean, _ = tops.fused_matmul(_t(a), _t(b), bias=_t(bias), act="silu",
                                 ft=_fts("tile")[1], tiles=(256, 128, 128),
                                 )
    corrected, _ = tops.fused_matmul(_t(a), _t(b), bias=_t(bias), act="silu",
                                     ft=_fts("tile")[1], inject=_tspec(spec),
                                     tiles=(256, 128, 128))
    assert torch.equal(corrected, clean)


@pytest.mark.parametrize("inj_batch", [-1, 1])
@pytest.mark.parametrize("level", LEVELS)
def test_batched_levels_match_reference(level, inj_batch):
    """K5 at each level against the reference's uniform-batched front, a
    5-wide injection broadcast into every slice or into one."""
    nb, m, n, k = 3, 128, 200, 256
    params = autotune.KernelParams(128, 128, 128)
    rng = np.random.default_rng(51)
    a, b = _ints(rng, nb, m, k), _ints(rng, nb, k, n)
    spec = InjectionSpec(row=127, col=199, magnitude=61.0, k_step=1)
    rft, tft = _fts(level)
    ro, rr = rops.grouped_gemm_call(
        BatchedKernelSpec(ft_level=level), jnp.asarray(a), jnp.asarray(b),
        ft=rft, inject=spec, inj_batch=inj_batch, params=params,
        interpret=True)
    to, tr = tops.grouped_gemm_call(
        TKernelSpec(ft_level=level), _t(a), _t(b), ft=tft,
        inject=_tspec(spec), inj_batch=inj_batch,
        tiles=_masked_tiles(m, n, k, params, level))
    np.testing.assert_allclose(to.numpy(), np.asarray(ro), rtol=1e-5,
                               atol=1e-4)
    _assert_reports(tr, rr, exact=True)
    assert float(tr[..., 0].sum()) == (nb if inj_batch < 0 else 1)
    np.testing.assert_array_equal(to.numpy(), a @ b)


@pytest.mark.parametrize("level", LEVELS)
def test_kernel_band_and_grouped_kernels(level):
    """At the kernel's own tiles the plain version takes the kernel's band
    (BANDS); the totals and the located global (row, col) agree with the
    reference's at its tiles. The grouped fronts (K7, K8) run the level on
    the instances their plans pick: the tensor-core ones for bf16."""
    m, n, k = 100, 300, 200
    rng = np.random.default_rng(61)
    a, b = _ints(rng, m, k), _ints(rng, k, n)
    spec = InjectionSpec(row=99, col=290, magnitude=40.0, k_step=1)
    rft, tft = _fts(level)
    ro, rr = rops.ft_matmul_report(
        jnp.asarray(a), jnp.asarray(b), ft=rft, spec=spec,
        params=autotune.KernelParams(128, 128, 128), interpret=True)
    for tiles in tgemm.TILES:
        to, tr = tops.ft_matmul_report(_t(a), _t(b), ft=tft,
                                       spec=_tspec(spec), tiles=tiles)
        np.testing.assert_array_equal(to.numpy(), np.asarray(ro))
        hit = tr[tr[..., 0] > 0]
        assert float(tr[..., 0].sum()) == float(np.asarray(rr)[..., 0].sum())
        assert (int(hit[0, 2]), int(hit[0, 3])) == (99, 290)
    assert tgemm.band_of((128, 128, 128)) == 128       # the reference's
    with pytest.raises(ValueError):                     # bm % 128 != 0
        tgemm.ft_gemm_plain(_t(a), _t(b), ft=tpol.FTConfig(level="tile"),
                            tiles=(96, 128, 128))
    from repro_torch.kernels import grouped_gemm as kgg
    gids = torch.tensor([0] * 8 + [1] * 8)
    y, rep = tops.grouped_gemm_call(TKernelSpec(ft_level=level),   # K7
                                    torch.ones(16, 8), torch.ones(2, 8, 4),
                                    group_ids=gids, ft=tft)
    assert torch.equal(y, torch.full((16, 4), 8.0))
    assert float(rep[..., 0].sum()) == 0.0 and float(rep[..., 6].min()) > 0
    dw, rep = tops.grouped_gemm_call(TKernelSpec(ft_level=level),  # K8
                                     torch.ones(16, 8), torch.ones(16, 4),
                                     group_ids=gids, n_groups=2, ft=tft)
    assert torch.equal(dw, torch.full((2, 8, 4), 8.0))
    assert float(rep[..., 0].sum()) == 0.0 and float(rep[..., 6].min()) > 0
    bf = torch.bfloat16
    p7 = kgg.plan_k7(128, 256, bf, 16, level=level, buf_strides=(256, 1),
                     w_strides=(256 * 128, 128, 1))
    p8 = kgg.plan_k8(256, 128, bf, 16, level=level, x_strides=(256, 1),
                     g_strides=(128, 1))
    assert (p7.instance, p7.tiles, p7.chunk) == ("sm90", (16, 128, 256), 64)
    assert (p8.instance, p8.tiles, p8.chunk) == ("sm90", (16, 128, 128), 64)
    assert not p7.reason and not p8.reason


@pytest.fixture(scope="module")
def smoke_model():
    rcfg, tcfg = rreg.get_smoke("qwen2-7b"), treg.get_smoke("qwen2-7b")
    params = rtr.init(rcfg, jax.random.PRNGKey(0), jnp.float32)
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, params),
                                        device="cpu")
    prompts = np.random.default_rng(1).integers(
        0, rcfg.vocab_size, (2, 8)).astype(np.int32)
    return rcfg, tcfg, params, tparams, prompts


@pytest.mark.parametrize("level", LEVELS)
def test_generate_at_level_matches_reference(smoke_model, level):
    """qwen2-7b SMOKE served at the level on the kernel backend, the
    reference's parameters through the converter: the reference's greedy
    tokens exactly."""
    rcfg, tcfg, params, tparams, prompts = smoke_model
    rft = FTConfig(level=level, backend="pallas")
    tft = tpol.FTConfig(level=level, backend="pallas")
    want = rserve.generate(params, prompts, rcfg,
                           RRun(model=rcfg, ft=rft, dtype="float32",
                                attn_chunk=16),
                           rserve.ServeConfig(max_len=32), max_new_tokens=6)
    got = tserve.generate(tparams, prompts, tcfg,
                          TRun(model=tcfg, ft=tft, dtype="float32",
                               attn_chunk=16),
                          tserve.ServeConfig(max_len=32), max_new_tokens=6,
                          device="cpu")
    np.testing.assert_array_equal(got, np.asarray(want))


@pytest.mark.parametrize("front", ["ft_dot", "ft_dot_fused", "ft_batched_dot"])
def test_level_reaches_the_kernel_from_the_fronts(front):
    """The level resolved at a model call site reaches K1 / K5: a
    detect-only SEU at k-step 0 is counted at every later verification at
    the block level, and once at the inner level (each Δ alone)."""
    from repro_torch.core import ft_gemm as tcore
    from repro_torch.core import telemetry as ttel
    rng = np.random.default_rng(71)
    x, w = _t(_ints(rng, 2, 8, 200)), _t(_ints(rng, 200, 24))
    counts = {}
    for level in ("block", "tile", "inner"):
        ft = tpol.FTConfig(level=level, action="detect", backend="pallas")
        spec = tpol.InjectionSpec(row=3, col=5, magnitude=64.0, k_step=0)
        with ttel.ft_scope() as scope:
            if front == "ft_dot":
                tcore.ft_dot(x, w, ft=ft, spec=spec, site="w")
            elif front == "ft_dot_fused":
                tcore.ft_dot_fused(x, w, act="silu", ft=ft, spec=spec,
                                   site="w")
            else:
                tcore.ft_batched_dot(x, w, ft=ft, spec=spec, site="w")
        counts[level] = scope.totals()["detected"]
    k_steps = -(-200 // tgemm.pick_tiles(8)[2])
    slices = 2 if front == "ft_batched_dot" else 1     # the SEU in each
    assert counts["block"] == counts["tile"] == slices * k_steps
    assert counts["inner"] == slices
