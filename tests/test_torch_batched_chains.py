"""The last parts of the TPU kernels: activation chains on K5 (the uniform
batched GEMM) and K7 (the grouped GEMM), chains of several activations on
K1, and K8 dropping a chain, each held against the reference's Pallas
kernel in interpret mode through both packages' front doors
(`ops.grouped_gemm_call`, `ops.gemm_call`) at the reference's tiles; the
plans that route each chain to an instance; the cap of the runtime op list
(`ft_gemm.CHAIN_CAP`); and an `ssd_cb`-shaped SEU counted alike by both
packages' batched kernels.

Tolerances (those of `tests/test_torch_chains.py`): integer-valued f32
operands keep the accumulator exact on both sides, so reports agree in det
/ corr / row / col / magnitude exactly and in max residual, tau and k to
1e-4 relative, and a corrected SEU gives the clean output bit for bit; the
activations (tanh, exp) are evaluated by two libraries, so outputs agree to
1e-5. The SEU-counting case runs Gaussian bf16 operands, where the second
detection's magnitude is the f32 rounding left by the first correction: it
agrees to within one f32 ulp of the SEU, and a clean block's max residual
(the rounding of two summation orders) to within a hundredth of its tau
(rule 3, residuals to rounding).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core.policy import (FTConfig, InjectionSpec,  # noqa: E402
                               ONLINE_BLOCK)
from repro.kernels import autotune, ops as rops  # noqa: E402
from repro.kernels.templates import KernelSpec  # noqa: E402

from repro_torch.core import policy as tpol  # noqa: E402
from repro_torch.kernels import ft_gemm as tg  # noqa: E402
from repro_torch.kernels import grouped_gemm as kgg, ops as tops  # noqa: E402
from repro_torch.kernels.grouped import layout as tlay  # noqa: E402
from repro_torch.kernels.templates import KernelSpec as TKernelSpec  # noqa: E402
from repro_torch.kernels.templates import epilogues  # noqa: E402

BF16 = torch.bfloat16
LEVELS = ("block", "tile", "inner")
K5_CHAINS = [("relu",), ("gelu", "relu"), ("silu", "gelu", "relu")]
K7_CHAINS = [("relu",), ("gelu", "relu")]
K1_CHAINS = [("gelu", "relu"), ("bias", "silu", "relu", "residual")]
#: A chain of CHAIN_CAP ops (a bias, a residual and 8 activations) and one
#: more activation.
CAPPED = ("bias",) + ("silu", "gelu", "relu", "gelu") * 2 + ("residual",)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _ints(rng, *shape):
    return rng.integers(-3, 4, shape).astype(np.float32)


def _same_report(got, want):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[..., :5], want[..., :5])
    np.testing.assert_allclose(got[..., 5:], want[..., 5:], rtol=1e-4)


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("chain", K5_CHAINS, ids="+".join)
def test_k5_chain_matches_reference(chain, level):
    """K5 through both front doors, 3 slices of (128 x 64)·(64 x 128) at the
    reference's (128, 128, 32) tiles: one SEU of 64 in slice 1 (row 5, col
    7, k-step 1) corrected and located alike, the chain applied after the
    verification (relu's zeros in the output), the corrected output the
    clean one."""
    rng = np.random.default_rng(len(chain) * 3 + len(level))
    a, b = _ints(rng, 3, 128, 64), _ints(rng, 3, 64, 128)
    seu = dict(row=5, col=7, magnitude=64.0, k_step=1)
    ro, rr = rops.grouped_gemm_call(
        KernelSpec(ft_level=level, epilogue=chain), jnp.asarray(a),
        jnp.asarray(b), ft=FTConfig(level=level),
        inject=InjectionSpec(**seu), inj_batch=1,
        params=autotune.KernelParams(128, 128, 32), interpret=True)

    def port(inject=True):
        return tops.grouped_gemm_call(
            TKernelSpec(ft_level=level, epilogue=chain), _t(a), _t(b),
            ft=tpol.FTConfig(level=level),
            inject=tpol.InjectionSpec(**seu) if inject else None,
            inj_batch=1, tiles=(128, 128, 32))

    to, tr = port()
    _close(to, ro)
    _same_report(tr, rr)
    hit = tr[tr[..., 0] > 0]
    assert len(hit) == 1 and float(tr[1, ..., 1].sum()) == 1.0
    assert (int(hit[0, 2]), int(hit[0, 3]), float(hit[0, 4])) == (5, 7, 64.0)
    assert float(to.min()) == 0.0
    clean, _ = port(inject=False)
    assert torch.equal(to, clean)


def _k7_problem(seed):
    """4 ragged groups over a 256-deep K, integer operands, and the buffer
    row of group 1's last live row in the 128-row layout."""
    rng = np.random.default_rng(seed)
    sizes = [70, 150, 37, 99]
    gids = rng.permutation(np.repeat(np.arange(4), sizes)).astype(np.int32)
    x, w = _ints(rng, len(gids), 256), _ints(rng, 4, 256, 128)
    lay = tlay.make_layout(_t(gids), 4, 128)
    return gids, x, w, int(lay.row_end[1]) - 1


@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("chain", K7_CHAINS, ids="+".join)
def test_k7_chain_matches_reference(chain, level):
    """K7 through both front doors (rows gathered back) at 128-row tiles,
    (128, 128, 128): one SEU of 64 in group 1's last live row at k-step 1
    corrected and located alike, the chain applied to every row."""
    gids, x, w, row = _k7_problem(len(chain) + len(level))
    seu = dict(row=row, col=100, magnitude=64.0, k_step=1)
    ro, rr = rops.grouped_gemm_call(
        KernelSpec(ft_level=level, epilogue=chain), jnp.asarray(x),
        jnp.asarray(w), group_ids=jnp.asarray(gids),
        ft=FTConfig(level=level), inject=InjectionSpec(**seu),
        params=autotune.KernelParams(128, 128, 128), interpret=True)

    def port(inject=True):
        return tops.grouped_gemm_call(
            TKernelSpec(ft_level=level, epilogue=chain), _t(x), _t(w),
            group_ids=_t(gids), ft=tpol.FTConfig(level=level),
            inject=tpol.InjectionSpec(**seu) if inject else None,
            tiles=(128, 128, 128))

    to, tr = port()
    _close(to, ro)
    _same_report(tr, rr)
    hit = tr[tr[..., 0] > 0]
    assert len(hit) == 1 and float(tr[..., 1].sum()) == 1.0
    assert (int(hit[0, 2]), int(hit[0, 3]), float(hit[0, 4])) == \
        (row, 100, 64.0)
    assert float(to.min()) == 0.0
    assert torch.equal(to, port(inject=False)[0])


def test_k8_drops_the_chain_as_the_reference_does():
    """K8 given ("relu",): both front doors drop the chain (a gradient),
    so the port's dw is the reference's and the chain-free call's, with
    negative entries."""
    gids, x, _, _ = _k7_problem(9)
    g = _ints(np.random.default_rng(10), len(gids), 128)
    ro, rr = rops.grouped_gemm_call(
        KernelSpec(ft_level="block", epilogue=("relu",)), jnp.asarray(x),
        jnp.asarray(g), group_ids=jnp.asarray(gids), n_groups=4,
        ft=ONLINE_BLOCK, params=autotune.KernelParams(128, 128, 256),
        interpret=True)

    def port(chain):
        return tops.grouped_gemm_call(
            TKernelSpec(ft_level="block", epilogue=chain), _t(x), _t(g),
            group_ids=_t(gids), n_groups=4, ft=tpol.ONLINE_BLOCK,
            tiles=(128, 128, 256))

    to, tr = port(("relu",))
    np.testing.assert_array_equal(to.numpy(), np.asarray(ro))
    _same_report(tr, rr)
    assert torch.equal(to, port(())[0]) and float(to.min()) < 0.0


@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("chain", K1_CHAINS, ids="+".join)
def test_k1_chain_of_several_activations_matches_reference(chain, level):
    """K1 through `gemm_call` at (128, 128, 128): one SEU of 64 (row 130,
    col 150, k-step 1) corrected and located alike, the corrected output
    the clean one."""
    rng = np.random.default_rng(len(chain) * 5 + len(level))
    a, b = _ints(rng, 256, 256), _ints(rng, 256, 256)
    aux = {x: _ints(rng, *shape) for x, shape in
           (("bias", (256,)), ("residual", (256, 256))) if x in chain}
    seu = dict(row=130, col=150, magnitude=64.0, k_step=1)
    ro, rr = rops.gemm_call(
        KernelSpec(ft_level=level, epilogue=chain), jnp.asarray(a),
        jnp.asarray(b), ft=FTConfig(level=level),
        inject=InjectionSpec(**seu), params=autotune.KernelParams(128, 128,
                                                                  128),
        interpret=True, **{x: jnp.asarray(y) for x, y in aux.items()})

    def port(inject=True):
        return tops.gemm_call(
            TKernelSpec(ft_level=level, epilogue=chain), _t(a), _t(b),
            ft=tpol.FTConfig(level=level),
            inject=tpol.InjectionSpec(**seu) if inject else None,
            tiles=(128, 128, 128), **{x: _t(y) for x, y in aux.items()})

    to, tr = port()
    _close(to, ro)
    _same_report(tr, rr)
    hit = tr[tr[..., 0] > 0]
    assert len(hit) == 1 and float(tr[..., 1].sum()) == 1.0
    assert (int(hit[0, 2]), int(hit[0, 3]), float(hit[0, 4])) == \
        (130, 150, 64.0)
    assert torch.equal(to, port(inject=False)[0])


def test_chain_cap_of_the_runtime_op_list():
    """A chain of CHAIN_CAP (10) ops runs on K1, K5 and K7 (K1's plain
    version, at the chain instance's tiles, equal to the unfused chain);
    one more op raises NotImplementedError naming the cap in each plan and
    through the front doors, where the reference takes it."""
    assert len(CAPPED) == tg.CHAIN_CAP
    rng = np.random.default_rng(4)
    a, b = _t(_ints(rng, 70, 90)), _t(_ints(rng, 90, 60)) * 0.1
    bias, res = _t(_ints(rng, 60)), _t(_ints(rng, 70, 60))
    ft = tpol.FTConfig(level="block")
    p = tg.plan_call(a, b, chain=CAPPED, ft=ft)
    assert p.instance == "simt_chain"
    out, rep = tops.gemm_call(TKernelSpec(ft_level="block", epilogue=CAPPED),
                              a, b, bias=bias, residual=res, ft=ft)
    want = epilogues.reference_apply(CAPPED, a @ b, bias=bias, residual=res)
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=0, atol=1e-5)
    assert float(rep[..., 0].sum()) == 0.0
    acts = CAPPED[1:-1]
    y, _ = tops.grouped_gemm_call(TKernelSpec(epilogue=acts), a[None], b)
    np.testing.assert_allclose(y[0].numpy(), epilogues.reference_apply(
        acts, a @ b).numpy(), rtol=0, atol=1e-5)
    longer = CAPPED + ("relu",)
    KernelSpec(epilogue=longer)                 # the reference takes it
    spec = TKernelSpec(ft_level="block", epilogue=longer)
    with pytest.raises(NotImplementedError, match="at most 10 ops"):
        tops.gemm_call(spec, a, b, bias=bias, residual=res, ft=ft)
    many = ("relu",) * (tg.CHAIN_CAP + 1)
    with pytest.raises(NotImplementedError, match="at most 10 ops"):
        tops.grouped_gemm_call(TKernelSpec(epilogue=many), a[None], b)
    gids = torch.zeros(70, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="at most 10 ops"):
        tops.grouped_gemm_call(TKernelSpec(epilogue=many), a, b[None],
                               group_ids=gids)
    with pytest.raises(NotImplementedError, match="at most 10 ops"):
        tg.plan(7, 256, 128, dtype=BF16, level="block", chain=many,
                a_strides=(128, 1), b_strides=(256, 1))


def test_act_grad_needs_one_activation_in_both_packages():
    for spec in (KernelSpec, TKernelSpec):
        with pytest.raises(ValueError, match="exactly one nonlinear"):
            spec(ft_level="block", epilogue=("gelu", "relu"),
                 extra_outputs=("act_grad",))
        spec(ft_level="block", epilogue=("bias", "gelu", "residual"),
             extra_outputs=("act_grad",))


@pytest.mark.parametrize("level", ["off"] + list(LEVELS))
def test_plans_route_every_chain(level):
    """The instance each chain takes, at each dtype, row count and level:
    K1's chains of two or more activations on the chain instance (the
    reason names them), bias? + gelu / relu on the tensor cores; K5's
    chains on the tensor cores at up to 16 bf16 rows, else on the chain
    instance (pinned SIMT tiles too); K7's chains on the tensor cores in
    bf16 on the 16-row layout, else on its SIMT chain instance, the reason
    naming the chain."""
    for dtype in (BF16, torch.float32):
        for m in (4, 512):
            p = tg.plan(m, 3584, 3584, dtype=dtype, level=level,
                        chain=("gelu", "relu"), a_strides=(3584, 1),
                        b_strides=(3584, 1))
            assert p.instance == "simt_chain"
            assert p.tiles == tg.pick_tiles(m)
            assert ("two or more activations" in p.reason) == (dtype == BF16)
    assert tg.plan(512, 3584, 3584, dtype=BF16, level=level,
                   chain=("bias", "gelu"), a_strides=(3584, 1),
                   b_strides=(3584, 1)).instance == "sm90"
    k5 = dict(a_strides=(0, 7 * 128, 128, 1), b_strides=(0, 0, 256, 1))
    for chain in ((), ("relu",), ("gelu", "relu")):
        for m, dtype, tiles, inst, why in (
                (7, BF16, None, "sm90", ""),
                (16, BF16, None, "sm90", ""),
                (17, BF16, None, "simt", "rows"),
                (7, torch.float32, None, "simt", "dtype"),
                (7, BF16, tg.TILES[1], "simt", "pinned")):
            p = tg.plan_k5(m, 256, 128, dtype=dtype, chain=chain,
                           tiles=tiles, **k5)
            want = inst + ("_chain" if chain and inst == "simt" else "")
            assert p.instance == want and why in p.reason, (chain, m, dtype)
    for chain in ((), ("silu",), ("gelu", "relu")):
        for dtype, bm, tiles in ((BF16, 16, None), (torch.float32, 8, None),
                                 (torch.float32, 16, None),
                                 (BF16, 16, (16, 128, 32))):
            p = kgg.plan_k7(1536, 4096, dtype, bm, level=level,
                            buf_strides=(4096, 1),
                            w_strides=(4096 * 1536, 1536, 1), chain=chain,
                            tiles=tiles)
            if dtype == BF16 and tiles is None:
                assert (p.instance, p.reason) == ("sm90", "")
            else:
                assert p.instance == ("simt_chain" if chain else "simt")
                assert p.tiles == (bm, 128, 32)
                assert (str(chain) in p.reason) == bool(chain)


@pytest.mark.parametrize("scale, counts", [(0.01, 2), (0.03, 1)])
def test_ssd_cb_seu_is_counted_alike_by_both_packages(scale, counts):
    """mamba2's `ssd_cb` shape, one bf16 slice of (256 x 128)·(128 x 256)
    of Gaussian operands times ``scale``, an SEU of 64 at k-step 0, the
    SIMT K5's bk of 32 at (128, 128, 32) on both sides, verify="step": the
    correction leaves the f32 rounding of 64 in the block, and where the
    next step's tau falls below it (the small scale) both packages flag and
    correct it again, 2 detections and 2 corrections in one block; at the
    larger scale once. The reports agree field for field (rule 3)."""
    rng = np.random.default_rng(0)
    a = _t(rng.standard_normal((1, 256, 128)).astype(np.float32) * scale
           ).to(BF16)
    b = _t(rng.standard_normal((1, 128, 256)).astype(np.float32) * scale
           ).to(BF16)
    seu = dict(row=5, col=7, magnitude=64.0, k_step=0)
    _, rr = rops.grouped_gemm_call(
        KernelSpec(ft_level="block"),
        jnp.asarray(a.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(b.float().numpy()).astype(jnp.bfloat16), ft=ONLINE_BLOCK,
        inject=InjectionSpec(**seu),
        params=autotune.KernelParams(128, 128, 32), interpret=True)
    _, tr = tops.grouped_gemm_call(
        TKernelSpec(ft_level="block"), a, b, ft=tpol.ONLINE_BLOCK,
        inject=tpol.InjectionSpec(**seu), tiles=(128, 128, 32))
    rr, t = np.asarray(rr), tr.numpy()
    assert t.shape == rr.shape == (1, 2, 2, 8)
    for rep in (rr, t):
        assert rep[..., 0].sum() == rep[..., 1].sum() == counts
        assert rep[0, 0, 0, :4].tolist() == [counts, counts, 5, 7]
    np.testing.assert_array_equal(t[..., :4], rr[..., :4])
    np.testing.assert_allclose(t[..., 4], rr[..., 4], rtol=0,
                               atol=64.0 * 2.0 ** -23)
    np.testing.assert_allclose(t[..., 6:], rr[..., 6:], rtol=1e-4)
    # a clean block's max residual is the rounding of two summation
    # orders: within a hundredth of its tau
    assert (np.abs(t[..., 5] - rr[..., 5]) <= 0.01 * rr[..., 6]).all()
