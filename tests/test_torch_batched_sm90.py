"""K5's tensor-core instance (`csrc/batched_sm90.cu`): the plan that routes a
batched call to it (`ft_gemm.plan_k5`), the band of its tiles, and its
plain version at those tiles (16 rows, 32 columns, 256-deep k-steps)
against the reference's uniform-batched front in interpret mode, at the
block, tile and inner levels, on decode attention's views of the KV cache.

The port runs bf16 views of a (B, S, KVH, dh) cache with two batch dims,
the reference the same integer-valued data flattened to contiguous f32
(B·KVH, ·, ·) slices at its own tiles, with bk 256 so that both walk the
same k-steps (the injection's k_step counts them). The tiles differ in
their columns, so per the conformance rule the comparison is of outputs
(the port's bf16 against the reference's f32 rounded to bf16: integer
sums are exact on both sides), of the det and corr totals of each slice,
and of the located global row and col, exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core.policy import FTConfig, InjectionSpec  # noqa: E402
from repro.kernels import autotune, ops as rops  # noqa: E402
from repro.kernels.templates import BatchedKernelSpec  # noqa: E402

from repro_torch.core import policy as tpol  # noqa: E402
from repro_torch.kernels import ft_gemm as tg, ops as tops  # noqa: E402
from repro_torch.kernels.templates import KernelSpec as TKernelSpec  # noqa: E402
from repro_torch.kernels.templates import spec as tspec_mod  # noqa: E402

BF16 = torch.bfloat16
NARROW, = tg.BATCHED_SM90_TILES
SIMT_WIDE = tg.TILES[1]

# qwen2-7b serving: 4 requests, 4 kv heads of 7 query heads, dh 128, a
# 256-position cache; the strides of decode attention's operands.
B_, KVH, REP, S, DH = 4, 4, 7, 256, 128
Q_STRIDES = (KVH * REP * DH, REP * DH, DH, 1)          # q.reshape, (B,KVH,7,dh)
P_STRIDES = (KVH * REP * S, REP * S, S, 1)             # softmax, (B,KVH,7,S)
KT_STRIDES = (S * KVH * DH, DH, 1, KVH * DH)           # K cache permuted
V_STRIDES = (S * KVH * DH, DH, KVH * DH, 1)            # V cache transposed

# (label, M, N, K, plan_k5 kwargs, instance, tiles, b_kmajor, reason word)
PLAN_CASES = [
    ("dec_qk", REP, S, DH, dict(a_strides=Q_STRIDES, b_strides=KT_STRIDES),
     "sm90", NARROW, True, ""),
    ("dec_pv", REP, DH, S, dict(a_strides=P_STRIDES, b_strides=V_STRIDES),
     "sm90", NARROW, False, ""),
    ("M 3 (phi4-mini)", 3, S, DH, dict(a_strides=(0, 0, DH, 1),
                                       b_strides=KT_STRIDES),
     "sm90", NARROW, True, ""),
    ("M 16 (qwen3-moe)", 16, S, DH, dict(a_strides=(0, 0, DH, 1),
                                         b_strides=KT_STRIDES),
     "sm90", NARROW, True, ""),
    ("shared B", REP, DH, S, dict(a_strides=(0, REP * S, S, 1),
                                  b_strides=(0, 0, DH, 1)),
     "sm90", NARROW, False, ""),
    ("contiguous B", REP, DH, S, dict(a_strides=(0, REP * S, S, 1),
                                      b_strides=(0, S * DH, DH, 1)),
     "sm90", NARROW, False, ""),
    ("a long cache", REP, 4096, DH,
     dict(a_strides=Q_STRIDES, b_strides=(0, 0, 1, 4 * DH)),
     "sm90", NARROW, True, ""),
    # one column or one k: the other stride of B is never stepped
    ("N 1, contiguous k-major B", REP, 1, S,
     dict(a_strides=(0, REP * S, S, 1), b_strides=(0, S, 1, 1)),
     "sm90", NARROW, True, ""),
    ("N 1, n-major B", REP, 1, S,
     dict(a_strides=(0, REP * S, S, 1), b_strides=(0, 8 * S, 8, 1)),
     "sm90", NARROW, False, ""),
    ("K 1, shared n-major B", REP, 20, 1,
     dict(a_strides=(0, REP * 8, 8, 1), b_strides=(0, 0, 20, 1)),
     "sm90", NARROW, False, ""),
    ("K 1, k-major B", REP, 20, 1,
     dict(a_strides=(0, REP * 8, 8, 1), b_strides=(0, 8 * 20, 1, 8)),
     "sm90", NARROW, True, ""),
    ("f32", REP, S, DH, dict(dtype=torch.float32, a_strides=Q_STRIDES,
                             b_strides=KT_STRIDES),
     "simt", SIMT_WIDE, None, "dtype"),
    ("M 17", 17, S, DH, dict(a_strides=(0, 0, DH, 1), b_strides=KT_STRIDES),
     "simt", tg.TILES[0], None, "rows"),
    ("row stride not a multiple of 8", REP, DH, 300,
     dict(a_strides=(0, REP * 300, 300, 1), b_strides=(0, 0, DH, 1)),
     "simt", SIMT_WIDE, None, "strides"),
    ("B along neither dim", REP, DH, S,
     dict(a_strides=P_STRIDES, b_strides=(0, 0, 2 * DH, 2)),
     "simt", SIMT_WIDE, None, "strides"),
    ("unaligned base", REP, S, DH, dict(aligned=False, a_strides=Q_STRIDES,
                                        b_strides=KT_STRIDES),
     "simt", SIMT_WIDE, None, "aligned"),
    ("pinned SIMT tiles", REP, S, DH, dict(tiles=SIMT_WIDE,
                                           a_strides=Q_STRIDES,
                                           b_strides=KT_STRIDES),
     "simt", SIMT_WIDE, None, "pinned"),
    ("an epilogue chain", REP, S, DH, dict(chain=("silu",),
                                           a_strides=Q_STRIDES,
                                           b_strides=KT_STRIDES),
     "sm90", NARROW, True, ""),
]


def _plan(m, n, k, **kw):
    args = dict(dtype=BF16)
    args.update(kw)
    return tg.plan_k5(m, n, k, **args)


@pytest.mark.parametrize("case", PLAN_CASES, ids=[c[0] for c in PLAN_CASES])
def test_plan_k5_picks_the_instance(case):
    _, m, n, k, kw, instance, tiles, b_kmajor, word = case
    p = _plan(m, n, k, **kw)
    assert (p.instance, p.tiles) == (instance, tiles)
    assert word in p.reason and bool(p.reason) == (instance != "sm90")
    if instance == "sm90":
        assert p.b_kmajor == b_kmajor and p.splits == 1
    elif word == "pinned":      # the same call unpinned takes the new one
        kw = {x: y for x, y in kw.items() if x != "tiles"}
        assert _plan(m, n, k, tiles=NARROW, **kw).instance == "sm90"
    else:
        with pytest.raises(ValueError):
            _plan(m, n, k, tiles=NARROW, **kw)


@pytest.mark.parametrize("level", ["off", "block", "tile", "inner"])
def test_plan_call_on_the_cache_views(level):
    """The front door plans decode attention's operands as they reach it,
    at every FT level: the K cache permuted (k-major) and the V cache
    transposed (n-major) with two batch dims, in bf16; the same call in
    f32 stays on SIMT; a 2-D call keeps K1's plan (the tensor cores at
    every level), and K1's plan keeps refusing a batched one."""
    cache = torch.zeros(B_, S, KVH, DH, dtype=BF16)
    q = torch.zeros(B_, KVH, REP, DH, dtype=BF16)
    p = torch.zeros(B_, KVH, REP, S, dtype=BF16)
    ft = None if level == "off" else tpol.FTConfig(level=level)
    qk = tg.plan_call(q, cache.permute(0, 2, 3, 1), ft=ft)
    pv = tg.plan_call(p, cache.transpose(1, 2), ft=ft)
    assert (qk.instance, qk.tiles, qk.b_kmajor) == ("sm90", NARROW, True)
    assert (pv.instance, pv.tiles, pv.b_kmajor) == ("sm90", NARROW, False)
    f32 = tg.plan_call(q.float(), cache.float().permute(0, 2, 3, 1), ft=ft)
    assert f32.instance == "simt" and "dtype" in f32.reason
    k1 = tg.plan_call(q[0, 0], cache[0, :, 0].t(), ft=ft)
    assert k1.instance == "sm90"
    assert "K5" in tg.plan(7, 256, 128, dtype=BF16, level="block",
                           a_strides=(128, 1), b_strides=(1, 512),
                           batched=True).reason


def test_band_of_the_new_tiles_is_16():
    """The tiles have the 16-row band; at that band the tile level's one
    band per block verifies what block verifies, so the plain version's
    reports at the two levels agree field for field."""
    for tiles in tg.BATCHED_SM90_TILES:
        assert tspec_mod.band_of(tiles) == tspec_mod.BATCHED_SM90_BAND == 16
        tspec_mod.validate(tspec_mod.KernelSpec(ft_level="tile"), tiles)
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.integers(-3, 4, (3, 7, 600))).to(BF16)
    b = torch.from_numpy(rng.integers(-3, 4, (3, 600, 100))).to(BF16)
    inj = (1, 1, 6, 70, 1)
    for action in ("correct", "detect"):
        reps = [tg.ft_gemm_plain(a, b, tiles=NARROW, inj=inj, inj_mag=50.0,
                                 ft=tpol.FTConfig(level=lv, action=action))[1]
                for lv in ("block", "tile")]
        assert torch.equal(reps[0], reps[1])
        assert float(reps[0][..., 0].sum()) == (1.0 if action == "correct"
                                                else 2.0)


def _ints(rng, *shape):
    return rng.integers(-3, 4, shape).astype(np.float32)


def _views(product, rng, nb=2, kvh=2, rep=7, s=512, dh=64):
    """Decode attention's operands on a numpy-seeded integer cache: the
    port's bf16 views and the reference's flattened f32 slices."""
    cache = _ints(rng, nb, s, kvh, dh)
    tc = torch.from_numpy(cache).to(BF16)
    if product == "qk":
        a = _ints(rng, nb, kvh, rep, dh)
        tb = tc.permute(0, 2, 3, 1)
    else:
        a = _ints(rng, nb, kvh, rep, s)
        tb = tc.transpose(1, 2)
    ta = torch.from_numpy(a).to(BF16)
    m, k, n = ta.shape[-2], ta.shape[-1], tb.shape[-1]
    ra = jnp.asarray(a.reshape(-1, m, k))
    rb = jnp.asarray(tb.float().reshape(-1, k, n).numpy())
    return ta, tb, ra, rb


def _slices(rep, n_slices):
    return rep.reshape(n_slices, -1, 8)


def _located(rep):
    """Per slice: (det total, corr total, the (row, col) of each detecting
    block, sorted)."""
    out = []
    for sl in rep:
        hit = sl[sl[:, 0] > 0]
        out.append((float(sl[:, 0].sum()), float(sl[:, 1].sum()),
                    sorted((int(r), int(c)) for r, c in hit[:, 2:4])))
    return out


@pytest.mark.parametrize("inj_batch", [-1, 2])
@pytest.mark.parametrize("product", ["qk", "pv"])
@pytest.mark.parametrize("level", ["block", "tile", "inner"])
def test_plain_at_new_tiles_matches_reference(level, product, inj_batch):
    """The plain version under `plan_k5` (the front door, on the CPU)
    against the reference's batched kernel in interpret mode: clean, an SEU
    in one slice or in every slice (corrected, the output equal to the
    clean one), and a detect-only control (the SEU left in place and
    counted alike)."""
    rng = np.random.default_rng(21 + len(level))
    ta, tb, ra, rb = _views(product, rng)
    n_slices = ra.shape[0]
    m, k, n = ta.shape[-2], ta.shape[-1], tb.shape[-1]
    assert tg.plan_call(ta, tb, ft=tpol.FTConfig(level=level)).tiles == NARROW
    steps = tg.cdiv(k, 256)
    spec = InjectionSpec(row=m - 1, col=n - 3, magnitude=77.0,
                         k_step=steps - 1)
    params = autotune.KernelParams(128 if level == "tile" else 8, 128, 256)
    clean = None
    for action, inject in (("correct", None), ("correct", spec),
                           ("detect", spec)):
        rft = FTConfig(level=level, action=action)
        tft = tpol.FTConfig(level=level, action=action)
        ro, rr = rops.grouped_gemm_call(
            BatchedKernelSpec(ft_level=level), ra, rb, ft=rft, inject=inject,
            inj_batch=inj_batch, params=params, interpret=True)
        tspec = None if inject is None else tpol.InjectionSpec(
            inject.row, inject.col, inject.magnitude, inject.k_step)
        to, tr = tops.grouped_gemm_call(
            TKernelSpec(ft_level=level), ta, tb, ft=tft, inject=tspec,
            inj_batch=inj_batch)
        assert to.dtype == BF16 and tr.shape[:2] == ta.shape[:2]
        want = torch.from_numpy(np.array(ro)).to(BF16).reshape(to.shape)
        assert torch.equal(to, want)
        got_loc = _located(_slices(tr, n_slices))
        want_loc = _located(_slices(torch.from_numpy(np.array(rr)),
                                    n_slices))
        assert got_loc == want_loc
        hit = [z for z in range(n_slices) if inj_batch in (-1, z)]
        for z, (det, corr, cells) in enumerate(got_loc):
            if inject is None or z not in hit:
                assert (det, corr, cells) == (0.0, 0.0, [])
            else:
                assert det >= 1 and corr == (det if action == "correct"
                                             else 0.0)
                assert set(cells) == {(m - 1, n - 3)}
        if inject is None:
            clean = to
        elif action == "correct":
            assert torch.equal(to, clean)
        else:
            moved = (to != clean).reshape(n_slices, -1).sum(-1)
            assert moved.tolist() == [int(z in hit) for z in range(n_slices)]
