"""Port ↔ reference: the ABFT GEMM kernels K1 (2-D) and K5 (uniform
batched). The port's plain versions (what the CUDA kernel computes, on the
kernel's tile grid) against the reference's Pallas kernels in interpret
mode, at the reference's pinned tiles, on the same numpy-seeded inputs.

Tolerances: outputs to 1e-5. Reports: det/corr/row/col/k equal, mag and tau
to 1e-5 relative; max_residual to 1e-5 relative on integer-valued operands
(exact arithmetic, so the residuals are exact on both sides) — with
Gaussian operands it is f32 rounding noise in two summation orders, so
there both sides only have to stay below tau.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core.policy import FTConfig, InjectionSpec  # noqa: E402
from repro.core import ft_gemm as rcore  # noqa: E402
from repro.core import telemetry as rtel  # noqa: E402
from repro.kernels import autotune, ops as rops, ref as rref  # noqa: E402
from repro.kernels.templates import BatchedKernelSpec, KernelSpec  # noqa: E402

from repro_torch.core import ft_gemm as tcore  # noqa: E402
from repro_torch.core import policy as tpol  # noqa: E402
from repro_torch.core import telemetry as ttel  # noqa: E402
from repro_torch.kernels import ops as tops, ref as tref  # noqa: E402
from repro_torch.kernels.templates import KernelSpec as TKernelSpec  # noqa: E402

P = autotune.KernelParams(8, 128, 128)
CHAINS = [(), ("bias",), ("silu",), ("bias", "silu"), ("gelu",), ("relu",),
          ("residual",)]


def _tiles(m, n, k):
    """The tile grid the reference's dispatcher runs for params P."""
    info = rops.dispatch_info(m, n, k, P, dtype=jnp.float32,
                              ft_level="block")
    q = info["masked_params"] if info["path"] == "masked" else info["params"]
    return (q.bm, q.bn, q.bk)


def _ints(rng, *shape):
    return rng.integers(-3, 4, shape).astype(np.float32)


def _ft(action="correct", verify="step"):
    return (FTConfig(level="block", action=action, verify=verify),
            tpol.FTConfig(level="block", action=action, verify=verify))


def _t(x):
    return None if x is None else torch.from_numpy(np.asarray(x))


def _tspec(spec):
    return None if spec is None else tpol.InjectionSpec(
        spec.row, spec.col, spec.magnitude, spec.k_step)


def _assert_reports(got, want, *, exact_residual):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[..., [0, 1, 2, 3, 7]],
                                  want[..., [0, 1, 2, 3, 7]])
    np.testing.assert_allclose(got[..., [4, 6]], want[..., [4, 6]],
                               rtol=1e-5, atol=0)
    if exact_residual:
        np.testing.assert_allclose(got[..., 5], want[..., 5], rtol=1e-5,
                                   atol=0)
    else:
        assert np.all(got[..., 5] < got[..., 6])
        assert np.all(want[..., 5] < want[..., 6])


@pytest.mark.parametrize("mode", [("correct", "step"), ("correct", "final"),
                                  ("detect", "step")])
@pytest.mark.parametrize("shape", [(7, 130, 200), (1, 77, 300),
                                   (36, 256, 384)])
def test_ft_matmul_report_matches_reference(shape, mode):
    """Ragged (M, N, K) incl. M = 7 and one row; a deterministic SEU at the
    bottom-right edge on a non-final k step, and a clean run."""
    m, n, k = shape
    rng = np.random.default_rng(m * 1000 + n)
    a, b = _ints(rng, m, k), _ints(rng, k, n)
    rft, tft = _ft(*mode)
    for spec in (None, InjectionSpec(row=m - 1, col=n - 1, magnitude=50.0,
                                     k_step=1)):
        ro, rr = rops.ft_matmul_report(jnp.asarray(a), jnp.asarray(b), ft=rft,
                                       spec=spec, params=P, interpret=True)
        to, tr = tops.ft_matmul_report(_t(a), _t(b), ft=tft,
                                       spec=_tspec(spec),
                                       tiles=_tiles(m, n, k))
        np.testing.assert_allclose(to.numpy(), np.asarray(ro), rtol=1e-5,
                                   atol=1e-5)
        _assert_reports(tr, rr, exact_residual=True)
        # detect-only leaves the SEU in place: later verifications see it too
        assert (float(tr[..., 0].sum()) >= 1) == (spec is not None)


@pytest.mark.parametrize("chain", CHAINS)
def test_fused_chains_match_reference(chain):
    """Every epilogue chain the CUDA kernel is instantiated for: Gaussian
    operands (clean) and an edge SEU on integer operands, which the linear
    fold lets the final verification correct post-epilogue — bit for bit
    equal to the clean output."""
    m, n, k = 20, 130, 160
    tiles = _tiles(m, n, k)
    rng = np.random.default_rng(len(chain) + 7)
    rft, tft = _ft()
    for ints in (False, True):
        mk = (lambda *s: _ints(rng, *s)) if ints else (
            lambda *s: rng.normal(size=s).astype(np.float32))
        a, b = mk(m, k), mk(k, n)
        bias = mk(n) if "bias" in chain else None
        res = mk(m, n) if "residual" in chain else None
        spec = (InjectionSpec(row=m - 1, col=n - 1, magnitude=300.0,
                              k_step=1) if ints else None)
        ro, rr = rops.gemm_call(
            KernelSpec(ft_level="block", epilogue=chain), jnp.asarray(a),
            jnp.asarray(b), bias=None if bias is None else jnp.asarray(bias),
            residual=None if res is None else jnp.asarray(res), ft=rft,
            inject=spec, params=P, interpret=True)
        kw = dict(bias=_t(bias), residual=_t(res), ft=tft, tiles=tiles)
        tspec = TKernelSpec(ft_level="block", epilogue=chain)
        to, tr = tops.gemm_call(tspec, _t(a), _t(b), inject=_tspec(spec),
                                **kw)
        np.testing.assert_allclose(to.numpy(), np.asarray(ro), rtol=1e-5,
                                   atol=1e-5)
        _assert_reports(tr, rr, exact_residual=ints)
        if ints:
            clean, _ = tops.gemm_call(tspec, _t(a), _t(b), **kw)
            assert torch.equal(to, clean)
            assert float(tr[..., 0].sum()) == 1.0
            want = tref.fused_matmul_ref(_t(a), _t(b), bias=_t(bias),
                                         residual=_t(res), chain=chain)
            np.testing.assert_allclose(to.numpy(), want.numpy(), rtol=1e-5,
                                       atol=1e-5)


@pytest.mark.parametrize("shared_b", [False, True])
@pytest.mark.parametrize("inj_batch", [-1, 1])
def test_batched_matches_reference(shared_b, inj_batch):
    """K5: (B, 7, K) × (B, K, N) or a shared (K, N), per-slice reports; the
    SEU broadcast into every slice (batch -1) or one slice."""
    nb, m, n, k = 3, 7, 130, 200
    rng = np.random.default_rng(11)
    a = _ints(rng, nb, m, k)
    b = _ints(rng, k, n) if shared_b else _ints(rng, nb, k, n)
    rft, tft = _ft()
    spec = InjectionSpec(row=6, col=129, magnitude=77.0, k_step=0)
    ro, rr = rops.grouped_gemm_call(BatchedKernelSpec(ft_level="block"),
                                    jnp.asarray(a), jnp.asarray(b), ft=rft,
                                    inject=spec, inj_batch=inj_batch,
                                    params=P, interpret=True)
    to, tr = tops.grouped_gemm_call(TKernelSpec(ft_level="block"), _t(a),
                                    _t(b), ft=tft, inject=_tspec(spec),
                                    inj_batch=inj_batch,
                                    tiles=_tiles(m, n, k))
    np.testing.assert_allclose(to.numpy(), np.asarray(ro), rtol=1e-5,
                               atol=1e-5)
    _assert_reports(tr, rr, exact_residual=True)
    assert float(tr[..., 0].sum()) == (nb if inj_batch < 0 else 1)
    clean, _ = tops.grouped_gemm_call(TKernelSpec(ft_level="block"), _t(a),
                                      _t(b), ft=tft, tiles=_tiles(m, n, k))
    assert torch.equal(to, clean)


@pytest.mark.parametrize("product", ["qk", "pv"])
def test_batched_cache_views_match_reference(product):
    """K5 on decode attention's operands: two batch dims (B, KVH) and B a
    permuted view of the (B, S, KVH, dh) cache, passed without a copy; the
    reference runs the flattened contiguous (B·KVH, …) problem."""
    nb, kvh, rep_n, s, dh = 2, 2, 7, 40, 16
    rng = np.random.default_rng(12)
    cache = _t(_ints(rng, nb, s, kvh, dh))
    if product == "qk":
        a, b = _t(_ints(rng, nb, kvh, rep_n, dh)), cache.permute(0, 2, 3, 1)
    else:
        a, b = _t(_ints(rng, nb, kvh, rep_n, s)), cache.transpose(1, 2)
    m, k, n = a.shape[-2], a.shape[-1], b.shape[-1]
    rft, tft = _ft()
    spec = InjectionSpec(row=rep_n - 1, col=n - 1, magnitude=31.0, k_step=0)
    ro, rr = rops.grouped_gemm_call(
        BatchedKernelSpec(ft_level="block"),
        jnp.asarray(a.reshape(-1, m, k).numpy()),
        jnp.asarray(b.reshape(-1, k, n).numpy()), ft=rft, inject=spec,
        inj_batch=-1, params=P, interpret=True)
    to, tr = tops.grouped_gemm_call(TKernelSpec(ft_level="block"), a, b,
                                    ft=tft, inject=_tspec(spec), inj_batch=-1,
                                    tiles=_tiles(m, n, k))
    assert to.shape == (nb, kvh, m, n) and tr.shape[:2] == (nb, kvh)
    np.testing.assert_allclose(to.reshape(-1, m, n).numpy(), np.asarray(ro),
                               rtol=1e-5, atol=1e-5)
    _assert_reports(tr.reshape(rr.shape), rr, exact_residual=True)
    assert float(tr[..., 0].sum()) == nb * kvh


def test_ft_off_matches_matmul_ref():
    rng = np.random.default_rng(3)
    a = rng.normal(size=(7, 200)).astype(np.float32)
    b = rng.normal(size=(200, 130)).astype(np.float32)
    got = tops.matmul(_t(a), _t(b), tiles=(8, 128, 128))
    want = rref.matmul_ref(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    _, rep = tops.gemm_call(TKernelSpec(), _t(a), _t(b))
    assert rep is None


def test_ft_matmul_ref_matches_reference():
    rng = np.random.default_rng(4)
    a, b = _ints(rng, 9, 30), _ints(rng, 30, 11)
    spec = InjectionSpec(row=8, col=10, magnitude=25.0)
    want = rref.ft_matmul_ref(jnp.asarray(a), jnp.asarray(b), FTConfig(),
                              spec=spec)
    got = tref.ft_matmul_ref(_t(a), _t(b), tpol.FTConfig(), spec=_tspec(spec))
    np.testing.assert_allclose(got.out.numpy(), np.asarray(want.out))
    assert bool(got.detected) and bool(want.detected)
    assert (int(got.row), int(got.col)) == (int(want.row), int(want.col))
    np.testing.assert_allclose(float(got.magnitude), float(want.magnitude),
                               rtol=1e-5)


def _grouped_report_equal(got, want):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[..., [0, 1, 2, 3, 7]],
                                  want[..., [0, 1, 2, 3, 7]])
    np.testing.assert_allclose(got[..., [4, 5, 6]], want[..., [4, 5, 6]],
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("level", ["tile", "inner"])
def test_grouped_levels_match_reference(level):
    """K1 and K5 run every FT level, and so do the grouped kernels K7 and
    K8: their plain versions at the tile (warp) and inner (thread) levels
    against the reference's grouped and tgmm kernels in interpret mode at
    the reference's tiles (K7 128-row tiles; K8 256-row dw blocks, two
    128-row bands), on integer operands with an empty group and a ragged
    last one: outputs exactly, reports field for field, clean and with one
    SEU corrected; the single-block K1 call runs clean."""
    from repro.kernels import grouped as rgrouped
    from repro.kernels.grouped import layout as rlay
    from repro_torch.kernels import grouped_gemm as kgg
    from repro_torch.kernels.grouped import layout as tlay
    rng = np.random.default_rng(17)
    sizes, bm, k, n = [150, 0, 90], 128, 256, 128
    gids = rng.permutation(np.repeat(np.arange(3), sizes)).astype(np.int32)
    rl = rlay.make_layout(jnp.asarray(gids), 3, bm)
    tl = tlay.make_layout(torch.from_numpy(gids), 3, bm)
    x, g = _ints(rng, len(gids), k), _ints(rng, len(gids), n)
    w = _ints(rng, 3, k, n)
    rx, rg = (rlay.scatter_rows(jnp.asarray(v), rl) for v in (x, g))
    tx, tg = (tlay.scatter_rows(_t(v), tl) for v in (x, g))
    rft, tft = FTConfig(level=level), tpol.FTConfig(level=level)
    last = int(np.asarray(rl.row_end)[2]) - 1
    for inj in (None, InjectionSpec(row=last, col=100, magnitude=64.0,
                                    k_step=1)):
        want, rrep = rgrouped.grouped_buffer_call(
            BatchedKernelSpec(ft_level=level, grouped=True), rx,
            jnp.asarray(w), rl, params=autotune.KernelParams(bm, 128, 128),
            ft=rft, inject=inj, interpret=True)
        got, trep = kgg.ft_gemm_grouped_plain(
            tx, _t(w), tl.gid, tl.row_end, tiles=(bm, 128, 128), ft=tft,
            inj=None if inj is None else (1, inj.row, inj.col, inj.k_step),
            inj_mag=0.0 if inj is None else inj.magnitude)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        _grouped_report_equal(trep, rrep)
        assert float(trep[..., 0].sum()) == (inj is not None)
    for inj in (None, InjectionSpec(row=200, col=5, magnitude=32.0,
                                    k_step=int(np.asarray(rl.base)[2]) // bm)):
        want, rrep = rgrouped.tgmm_buffer_call(
            BatchedKernelSpec(ft_level=level, tgmm=True), rx, rg, rl,
            params=autotune.KernelParams(bm, 128, 256), ft=rft, inject=inj,
            interpret=True)
        got, trep = kgg.tgmm_plain(
            tx, tg, tl.row_end, tiles=(bm, 128, 256), ft=tft,
            inj=None if inj is None else (1, inj.row, inj.col, inj.k_step),
            inj_mag=0.0 if inj is None else inj.magnitude)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        _grouped_report_equal(trep, rrep)
        assert float(trep[..., 0].sum()) == (inj is not None)
    out, rep = tops.ft_matmul_report(torch.ones(8, 16), torch.ones(16, 8),
                                     ft=tft)
    assert float(rep[..., 0].sum()) == 0.0


@pytest.mark.parametrize("fused", [True, False])
def test_xla_backend_ft_dot_matches_reference(fused):
    """The torch-op ABFT path (backend "xla") against the reference's jnp
    path: same output, same detection count in the telemetry scope."""
    rng = np.random.default_rng(5)
    x = _ints(rng, 2, 5, 40)
    w = _ints(rng, 40, 24)
    spec = InjectionSpec(row=3, col=7, magnitude=64.0)
    rft = FTConfig(fused=fused)
    tft = tpol.FTConfig(fused=fused)
    with rtel.ft_scope() as rs:
        want = rcore.ft_dot(jnp.asarray(x), jnp.asarray(w), ft=rft, spec=spec,
                            site="w")
        rdet = float(rs.report().detected)
    with ttel.ft_scope() as ts:
        got = tcore.ft_dot(_t(x), _t(w), ft=tft, spec=_tspec(spec), site="w")
        tdet = ts.totals()["detected"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    assert rdet == tdet == 1.0
