"""K1's tensor-core instance (`csrc/ft_gemm_sm90.cu`): the plan that routes a
call to it, its plain version at the reference's (128, 128, 256) tiles
against the reference's Pallas kernel in interpret mode report for report,
and the split-K walk (ranges, report merge, SEUs in a later split).

Tolerances: outputs to 1e-5 against the reference (integer-valued f32
operands keep both sides exact); reports det/corr/row/col/k equal, mag, tau
and max_residual to 1e-5 relative. Split-K against one split: f32 outputs
to 1e-5 relative of the output's range (the partial sums add in another
order), totals and the located global row and col equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core.policy import FTConfig, InjectionSpec  # noqa: E402
from repro.kernels import autotune, ops as rops  # noqa: E402

from repro_torch.core import policy as tpol  # noqa: E402
from repro_torch.kernels import ft_gemm as tg, ops as tops  # noqa: E402

BF16 = torch.bfloat16
BIG, SMALL = tg.SM90_TILES
SIMT_SQ, SIMT_WIDE = tg.TILES
REF_TILES = (128, 128, 256)

# (label, M, N, K, plan kwargs, instance, tiles, splits): the main-path K1
# shapes of PERF.md (qwen2-7b serving, phi4-mini training), the training
# walks, and what stays on the SIMT kernel.
PLAN_CASES = [
    ("prefill w_down", 512, 3584, 18944, {}, "sm90", BIG, 1),
    ("prefill w_gate+silu", 512, 18944, 3584, dict(chain=("silu",)), "sm90",
     BIG, 1),
    ("decode w_down", 4, 3584, 18944, {}, "sm90", SMALL, 4),
    ("decode w_gate+silu", 4, 18944, 3584, dict(chain=("silu",)), "sm90",
     SMALL, 2),
    ("decode lm_head", 4, 152064, 3584, {}, "sm90", SMALL, 1),
    ("decode wk+bias", 4, 512, 3584, dict(chain=("bias",)), "sm90", SMALL,
     14),
    ("decode w_down FT off", 4, 3584, 18944, dict(level="off"), "sm90",
     SMALL, 4),
    ("decode wq+bias", 4, 3584, 3584, dict(chain=("bias",)), "sm90", SMALL,
     4),
    ("train fwd w_gate act_grad", 1024, 8192, 3072,
     dict(chain=("silu",), act_grad=True), "sm90", BIG, 1),
    ("train dx w_down (LAYOUT 1)", 1024, 8192, 3072,
     dict(b_strides=(1, 3072)), "sm90", BIG, 1),
    ("train dw lm_head (LAYOUT 2)", 3072, 200192, 1024,
     dict(a_strides=(1, 3072)), "sm90", BIG, 1),
    ("f32", 512, 3584, 3584, dict(dtype=torch.float32), "simt", SIMT_SQ, 1),
    ("tile level", 4, 3584, 3584, dict(level="tile"), "sm90", SMALL, 4),
    ("inner level", 512, 3584, 3584, dict(level="inner"), "sm90", BIG, 1),
    ("tile level f32", 4, 3584, 3584,
     dict(level="tile", dtype=torch.float32), "simt", SIMT_WIDE, 1),
    ("residual chain", 512, 3584, 3584, dict(chain=("residual",)), "simt",
     SIMT_SQ, 1),
    ("gelu chain", 512, 3584, 3584, dict(chain=("gelu",)), "sm90", BIG, 1),
    ("row stride not a multiple of 8", 4, 512, 300, dict(a_strides=(300, 1)),
     "simt", SIMT_WIDE, 1),
    ("both operands transposed", 64, 512, 256,
     dict(a_strides=(1, 64), b_strides=(1, 256)), "simt", SIMT_SQ, 1),
    ("unaligned base", 64, 512, 256, dict(aligned=False), "simt", SIMT_SQ,
     1),
    ("batched (K5)", 4, 256, 128, dict(batched=True), "simt", SIMT_WIDE, 1),
]


def _plan(m, n, k, **kw):
    args = dict(dtype=BF16, level="block", chain=(), a_strides=(k, 1),
                b_strides=(n, 1))
    args.update(kw)
    return tg.plan(m, n, k, **args)


@pytest.mark.parametrize("case", PLAN_CASES, ids=[c[0] for c in PLAN_CASES])
def test_plan_picks_instance_tiles_and_splits(case):
    _, m, n, k, kw, instance, tiles, splits = case
    p = _plan(m, n, k, **kw)
    assert (p.instance, p.tiles, p.splits) == (instance, tiles, splits)
    assert bool(p.reason) == (instance != "sm90")
    if instance == "sm90":
        assert p.a_kmajor == (kw.get("a_strides", (k, 1))[1] == 1)
        assert p.b_kmajor == (kw.get("b_strides", (n, 1))[0] == 1)
        # each split gets at least one k-step; split-K only below about two
        # waves of CTAs
        blocks = tg.cdiv(m, tiles[0]) * tg.cdiv(n, tiles[1])
        assert splits <= tg.cdiv(k, tiles[2])
        assert splits == 1 or blocks < tg.SPLIT_TARGET
    else:
        with pytest.raises(ValueError):
            _plan(m, n, k, tiles=SMALL, **kw)


def test_pinned_tiles_pin_the_instance():
    assert _plan(4, 512, 512, tiles=BIG).tiles == BIG
    assert _plan(512, 512, 512, tiles=SIMT_SQ).instance == "simt"
    assert _plan(512, 512, 512, tiles=REF_TILES[:2] + (128,)).instance \
        == "plain"


@pytest.mark.parametrize("level", ["tile", "inner"])
def test_pinned_simt_tiles_keep_the_level_on_the_simt_instance(level):
    """The tensor-core rule at "tile" and "inner" leaves pinned SIMT tiles
    (and the reference's, plain only) where they are."""
    for m, tiles in ((512, SIMT_SQ), (4, SIMT_WIDE)):
        p = _plan(m, 3584, 3584, level=level, tiles=tiles)
        assert (p.instance, p.tiles, p.splits) == ("simt", tiles, 1)
    assert _plan(512, 512, 512, level=level,
                 tiles=REF_TILES[:2] + (128,)).instance == "plain"


def test_split_ranges_are_contiguous_and_balanced():
    for k, s in ((3584, 10), (18944, 3), (2560, 7), (256, 1)):
        r = tg.split_ranges(k, 256, s)
        assert r[0][0] == 0 and r[-1][1] == tg.cdiv(k, 256)
        assert all(a[1] == b[0] for a, b in zip(r, r[1:]))
        sizes = [hi - lo for lo, hi in r]
        assert max(sizes) - min(sizes) <= 1 and min(sizes) >= 1


def test_merge_reports_rule():
    """det and corr add, row / col / mag from the last detection,
    max_residual the max."""
    r0 = torch.tensor([1., 1., 3., 4., 5., 0.5, 9., 9.])
    r1 = torch.tensor([0., 0., 0., 0., 0., 0.7, 9., 9.])
    r2 = torch.tensor([2., 0., 6., 7., -8., 0.2, 9., 9.])
    got = tg.merge_reports([r0, r1, r2])
    assert got[:6].tolist() == pytest.approx([3., 1., 6., 7., -8., 0.7])
    got = tg.merge_reports([r2, r1, r0])
    assert got[2:5].tolist() == [3., 4., 5.]


def _ints(rng, *shape):
    return rng.integers(-3, 4, shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("mode", [("correct", "step"), ("correct", "final"),
                                  ("detect", "step")])
@pytest.mark.parametrize("chain", [(), ("bias",), ("silu",)])
def test_plain_at_reference_tiles_matches_reference(chain, mode):
    """One split at (128, 128, 256): the reference's report, block for
    block, with an SEU in the second k-step and on a clean run."""
    m, n, k = 256, 256, 768
    rng = np.random.default_rng(len(chain) * 10 + len(mode[0]))
    a, b, bias = _ints(rng, m, k), _ints(rng, k, n), _ints(rng, n)
    action, verify = mode
    rft = FTConfig(level="block", action=action, verify=verify)
    tft = tpol.FTConfig(level="block", action=action, verify=verify)
    act = chain[0] if chain and chain[0] != "bias" else None
    params = autotune.KernelParams(*REF_TILES)
    for spec in (None, InjectionSpec(row=200, col=77, magnitude=64.0,
                                     k_step=1)):
        ro, rr = rops.fused_matmul(
            jnp.asarray(a), jnp.asarray(b),
            bias=jnp.asarray(bias) if "bias" in chain else None, act=act,
            ft=rft, inject=spec, params=params, interpret=True)
        inj = None if spec is None else (1, -1, spec.row, spec.col,
                                         spec.k_step)
        to, tr = tg.ft_gemm_plain(
            _t(a), _t(b), tiles=REF_TILES, splits=1, chain=chain,
            bias=_t(bias) if "bias" in chain else None, ft=tft, inj=inj,
            inj_mag=64.0)
        np.testing.assert_allclose(to.numpy(), np.asarray(ro), rtol=1e-5,
                                   atol=1e-5)
        got, want = tr.numpy(), np.asarray(rr)
        assert got.shape == want.shape == (2, 2, 8)
        np.testing.assert_array_equal(got[..., [0, 1, 2, 3, 7]],
                                      want[..., [0, 1, 2, 3, 7]])
        np.testing.assert_allclose(got[..., [4, 5, 6]], want[..., [4, 5, 6]],
                                   rtol=1e-5, atol=0)
        assert (got[..., 0].sum() >= 1) == (spec is not None)


@pytest.mark.parametrize("splits", [2, 3, 5])
@pytest.mark.parametrize("chain", [(), ("bias", "silu")])
def test_split_k_matches_one_split(chain, splits):
    """Gaussian f32 operands: outputs within f32 rounding of one split, no
    detection on a clean run; with an SEU, the same totals and the same
    located global row and col."""
    m, n, k = 70, 200, 1280
    rng = np.random.default_rng(splits * 7 + len(chain))
    a = _t(rng.normal(size=(m, k)).astype(np.float32))
    b = _t((rng.normal(size=(k, n)) * 0.1).astype(np.float32))
    bias = _t(rng.normal(size=(n,)).astype(np.float32))
    kw = dict(tiles=SMALL, chain=chain,
              bias=bias if chain else None, ft=tpol.ONLINE_BLOCK)
    for inj in (None, (1, -1, 66, 150, 3)):
        one, r1 = tg.ft_gemm_plain(a, b, splits=1, inj=inj, inj_mag=40.0,
                                   **kw)
        many, rs = tg.ft_gemm_plain(a, b, splits=splits, inj=inj,
                                    inj_mag=40.0, **kw)
        scale = float(one.abs().max())
        assert float((one - many).abs().max()) <= 1e-5 * scale
        assert float(rs[..., 0].sum()) == float(r1[..., 0].sum()) == \
            (inj is not None)
        assert torch.equal(rs[..., 7], r1[..., 7])
        if inj is not None:
            for r in (r1, rs):
                cell = r[r[..., 0] > 0][0]
                assert (int(cell[2]), int(cell[3])) == (66, 150)


@pytest.mark.parametrize("verify", ["step", "final"])
@pytest.mark.parametrize("step", [0, 3, 5, 9])
def test_split_seu_corrected_and_counted(step, verify):
    """Integer bf16 operands, 4 splits of 10 k-steps: an SEU in any split is
    corrected bit for bit; detect-only leaves it and counts it once at each
    later verification of its split (verify="step") and at the final one."""
    m, n, k, splits = 16, 256, 2560, 4
    rng = np.random.default_rng(step)
    a = _t(_ints(rng, m, k)).to(BF16)
    b = _t(_ints(rng, k, n)).to(BF16)
    ranges = tg.split_ranges(k, 256, splits)
    z = next(i for i, (lo, hi) in enumerate(ranges) if lo <= step < hi)
    kw = dict(tiles=SMALL, splits=splits)
    inj = (1, -1, 9, 200, step)
    clean, _ = tg.ft_gemm_plain(a, b, ft=tpol.ONLINE_BLOCK, **kw)
    ft = tpol.ONLINE_BLOCK.replace(verify=verify)
    out, rep = tg.ft_gemm_plain(a, b, ft=ft, inj=inj, inj_mag=32.0, **kw)
    assert torch.equal(out, clean)
    assert float(rep[..., 0].sum()) == float(rep[..., 1].sum()) == 1.0
    cell = rep[rep[..., 0] > 0][0]
    assert (int(cell[2]), int(cell[3]), float(cell[4])) == (9, 200, 32.0)
    assert float(cell[6]) > 0 and float(cell[7]) == k
    det = tpol.OFFLINE_DETECT.replace(verify=verify)
    out_d, rep_d = tg.ft_gemm_plain(a, b, ft=det, inj=inj, inj_mag=32.0, **kw)
    diff = (out_d.float() - clean.float()).nonzero()
    assert diff.tolist() == [[9, 200]]
    later = max(0, ranges[z][1] - 1 - step) if verify == "step" else 0
    assert float(rep_d[..., 0].sum()) == later + 1
    assert float(rep_d[..., 1].sum()) == 0.0


@pytest.mark.parametrize("shape", [(8, 384, 2560), (130, 256, 512)])
def test_cpu_wrapper_follows_the_plan(shape):
    """On a CPU tensor `ft_gemm` (and the ops front) runs the plain version
    at the plan's tiles and split count, as the kernel would on the card."""
    m, n, k = shape
    rng = np.random.default_rng(m)
    a = _t(rng.normal(size=(m, k)).astype(np.float32)).to(BF16)
    b = _t((rng.normal(size=(k, n)) * 0.1).astype(np.float32)).to(BF16)
    p = tg.plan_call(a, b, ft=tpol.ONLINE_BLOCK)
    assert p.instance == "sm90" and p.tiles == (SMALL if m <= 64 else BIG)
    out, rep = tg.ft_gemm(a, b, ft=tpol.ONLINE_BLOCK)
    want, rep_w = tg.ft_gemm_plain(a, b, tiles=p.tiles, splits=p.splits,
                                   ft=tpol.ONLINE_BLOCK)
    assert torch.equal(out, want) and torch.equal(rep, rep_w)
    assert rep.shape == (tg.cdiv(m, p.tiles[0]), tg.cdiv(n, 128), 8)
    o2, r2 = tops.ft_matmul_report(a, b, ft=tpol.ONLINE_BLOCK)
    assert torch.equal(o2, out) and torch.equal(r2, rep)
    o3, _ = tg.planned_plain(a, b, ft=tpol.ONLINE_BLOCK)
    assert torch.equal(o3, out)
