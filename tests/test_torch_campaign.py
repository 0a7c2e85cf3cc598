"""Port ↔ reference: stochastic SEU campaigns on the GEMM family.

  * (a) `kernels/templates/seu.py` against the reference's
    `emit.stochastic_seu` and `apply_seu`: the same (hit, step, row, col)
    for every uid of a grid of salts, live-step counts (0 and 1 included),
    rates and triples from the reference's `flashft.encode_rng`, and the
    same magnitude;
  * (b) each plain version against the reference's kernel in interpret
    mode, under the triple the reference encodes from its key, at pinned
    tiles: K1 at "block" (plain, act_grad, a transposed A), "tile" and
    "inner"; the split-K walk at (128, 128, 256); K5 at (16, 128, 32) and
    (16, 32, 256); K7 per 16-row tile and on the tensor-core instance's
    64-row chunked walk; K8 per tile (and its chunked walk under
    correction), each under correction and detect-only, the reports field
    for field (det, corr, row, col);
  * (c) the torch-op `Injector`: its hit rate within a binomial band, the
    same draws for the same key;
  * (d) the campaign keys: `named_subkey`, `Ctx.fold` and `inject_sites`
    give distinct triples per site and layer and consume no generator
    state; `check_inject_sites` raises on an unknown label;
  * (e) rate 0 with a key is bit-identical to no key;
  * (f) a smoke phi4-mini `train` with ``inject_every=1`` detects and
    corrects every SEU with the clean run's loss, on chunked and on flash
    attention.

Tolerances: integer-valued operands keep both sides exact where reports
are compared (outputs to 1e-5, magnitudes and residuals to 1e-5 relative);
Gaussian K1 outputs to 1e-4 (f32 sums in other orders).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.policy import FTConfig as RFT  # noqa: E402
from repro.kernels import flashft as rflash  # noqa: E402
from repro.kernels import grouped as rgrouped  # noqa: E402
from repro.kernels import ops as rops  # noqa: E402
from repro.kernels.autotune import KernelParams  # noqa: E402
from repro.kernels.grouped import dispatch as rdispatch  # noqa: E402
from repro.kernels.grouped import layout as rlay  # noqa: E402
from repro.kernels.templates import registry as rregistry  # noqa: E402
from repro.kernels.templates import BatchedKernelSpec as RBSpec  # noqa: E402
from repro.kernels.templates import emit as temit  # noqa: E402

from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.base import RunConfig, ShapeConfig  # noqa: E402
from repro_torch.core import fault_injection as tfi  # noqa: E402
from repro_torch.core import telemetry  # noqa: E402
from repro_torch.core.policy import FTConfig as TFT  # noqa: E402
from repro_torch.core.policy import ONLINE_BLOCK  # noqa: E402
from repro_torch.kernels import flashft as tflash  # noqa: E402
from repro_torch.kernels import ft_gemm as kg  # noqa: E402
from repro_torch.kernels import grouped_gemm as kgg  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels.grouped import layout as tlay  # noqa: E402
from repro_torch.kernels.templates import seu  # noqa: E402
from repro_torch.models import blocks  # noqa: E402
from repro_torch.train import train_loop  # noqa: E402

KEYS = [3, 11]


def _triple(key_seed, rft):
    return tuple(int(x) for x in np.asarray(
        rflash.encode_rng(jax.random.PRNGKey(key_seed), rft)))


def _ints(rng, *shape):
    return rng.integers(-3, 4, shape).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _check(got, want, exact=True):
    """Reports field for field: det, corr, row, col, k exactly; magnitude,
    max residual and tau to f32 rounding."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    nf = got.shape[-1]
    for f in (0, 1, 2, 3, 7)[:4 + (nf > 7)]:
        np.testing.assert_array_equal(got[..., f], want[..., f],
                                      err_msg=f"field {f}")
    tol = 1e-6 if exact else 1e-5
    for f in (4, 5, 6)[:nf - 4]:
        np.testing.assert_allclose(got[..., f], want[..., f], rtol=tol,
                                   atol=1e-4, err_msg=f"field {f}")


def _fts(action="correct", level="block", rate=1.0, verify="step"):
    return (RFT(level=level, action=action, backend="pallas",
                inject_rate=rate, verify=verify),
            TFT(level=level, action=action, backend="pallas",
                inject_rate=rate, verify=verify))


# ---------------------------------------------------------------------------
# (a) the hash and the magnitude model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rate", [0.0, 2.0 ** -24, 0.37, 1.0])
@pytest.mark.parametrize("n_steps", [0, 1, 7])
@pytest.mark.parametrize("salt", [seu.SALT_GEMM2D, seu.SALT_BATCHED,
                                  seu.SALT_TGMM])
def test_draw_matches_reference(salt, n_steps, rate):
    uids = np.arange(0, 4096, 3, dtype=np.int32)
    for key_seed in KEYS:
        rft = RFT(inject_rate=max(rate, 1e-3))
        rng_ref = rflash.encode_rng(jax.random.PRNGKey(key_seed), rft)
        want = temit.stochastic_seu(rng_ref, salt, jnp.asarray(uids),
                                    n_steps, 16, 128, rate)
        got = seu.draw(_triple(key_seed, rft), salt, torch.from_numpy(uids),
                       n_steps, 16, 128, rate)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(np.asarray(w), g.numpy())
    # enable = 0 never hits
    off = seu.draw((0, 5, 7), salt, torch.from_numpy(uids), n_steps, 16,
                   128, 1.0)
    assert not off[0].any()


def test_magnitude_matches_reference():
    vals = np.array([0.0, 1e-9, -3e-9, 1e-8, 5.0, -2.5, 3e-3, 1e30],
                    np.float32)
    for shift in (0, 8, 20):
        for v in vals:
            delta = jnp.full((4, 8), v, jnp.float32)
            want = np.asarray(temit.apply_seu(delta, 2, 5, True, shift))
            x = torch.tensor([v])
            got = float((x + seu.magnitude(x, shift))[0])
            assert got == float(want[2, 5]), (v, shift)
            assert float(want[0, 0]) == v          # only the hit element


def test_rates_the_hook_cannot_draw_raise():
    for rate in (-0.1, 1e-9, 1.5, float("nan")):
        with pytest.raises(ValueError):
            tflash.encode_rng(torch.Generator().manual_seed(0),
                              TFT(inject_rate=rate))
    with pytest.raises(ValueError):
        seu.check(0.5, 200)


# ---------------------------------------------------------------------------
# (b) the plain versions against the reference's kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("action", ["correct", "detect"])
@pytest.mark.parametrize("variant", ["plain", "act_grad", "x.T"])
def test_k1_block_matches_reference(variant, action):
    rng = np.random.default_rng(1)
    a = rng.normal(size=(256, 512)).astype(np.float32)
    b = rng.normal(size=(512, 384)).astype(np.float32)
    rft, tft = _fts(action)
    key = jax.random.PRNGKey(KEYS[0])
    trip = _triple(KEYS[0], rft)
    params = KernelParams(128, 128, 128)
    if variant == "act_grad":
        (ro, rag), rr = rops.fused_matmul(
            jnp.asarray(a), jnp.asarray(b), act="silu", ft=rft,
            params=params, interpret=True, save_act_grad=True, key=key)
        (to, tag), tr = kg.ft_gemm(_t(a), _t(b), chain=("silu",), ft=tft,
                                   tiles=(128, 128, 128), save_act_grad=True,
                                   rng=trip)
        np.testing.assert_allclose(tag.numpy(), np.asarray(rag), rtol=1e-4,
                                   atol=1e-4)
    else:
        ta = _t(a.T.copy()).T if variant == "x.T" else _t(a)
        ro, rr = rops.gemm_call(temit_spec(), jnp.asarray(a), jnp.asarray(b),
                                ft=rft, params=params, interpret=True,
                                key=key)
        to, tr = kg.ft_gemm(ta, _t(b), ft=tft, tiles=(128, 128, 128),
                            rng=trip)
    np.testing.assert_allclose(to.numpy(), np.asarray(ro), rtol=1e-4,
                               atol=1e-4)
    _check(tr, rr, exact=False)
    assert float(np.asarray(rr)[..., 0].sum()) > 0


def temit_spec():
    from repro.kernels.templates import KernelSpec
    return KernelSpec(ft_level="block")


@pytest.mark.parametrize("action", ["correct", "detect"])
@pytest.mark.parametrize("level", ["tile", "inner"])
def test_k1_levels_match_reference(level, action):
    rng = np.random.default_rng(2)
    a, b = _ints(rng, 256, 512), _ints(rng, 512, 384)
    rft, tft = _fts(action, level)
    ro, rr = rops.ft_matmul_report(jnp.asarray(a), jnp.asarray(b), ft=rft,
                                   params=KernelParams(256, 128, 128),
                                   interpret=True,
                                   key=jax.random.PRNGKey(KEYS[1]))
    to, tr = kg.ft_gemm(_t(a), _t(b), ft=tft, tiles=(256, 128, 128),
                        rng=_triple(KEYS[1], rft))
    np.testing.assert_allclose(to.numpy(), np.asarray(ro), rtol=1e-5,
                               atol=1e-5)
    _check(tr, rr)
    assert float(np.asarray(rr)[..., 0].sum()) > 0


def _located(rep):
    rep = np.asarray(rep, np.float32).reshape(-1, 8)
    hit = rep[rep[:, 0] > 0]
    return float(rep[:, 0].sum()), sorted((int(r[2]), int(r[3]))
                                          for r in hit)


def test_k1_split_k_matches_reference_totals():
    """The split-K walk (three ranges of four 256-deep steps) under
    correction: the reference's totals and located positions, the clean
    result."""
    rng = np.random.default_rng(3)
    a, b = _ints(rng, 256, 1024), _ints(rng, 1024, 384)
    rft, tft = _fts()
    ro, rr = rops.ft_matmul_report(jnp.asarray(a), jnp.asarray(b), ft=rft,
                                   params=KernelParams(128, 128, 256),
                                   interpret=True,
                                   key=jax.random.PRNGKey(KEYS[0]))
    to, tr = kg.ft_gemm_plain(_t(a), _t(b), ft=tft, tiles=(128, 128, 256),
                              splits=3, rng=_triple(KEYS[0], rft))
    np.testing.assert_array_equal(to.numpy(), a @ b)
    np.testing.assert_array_equal(np.asarray(ro), a @ b)
    assert _located(tr) == _located(rr)
    assert _located(tr)[0] == 6.0          # one SEU in each of 2 x 3 blocks


@pytest.mark.parametrize("action", ["correct", "detect"])
@pytest.mark.parametrize("tiles", [(16, 128, 32), (16, 32, 256)])
def test_k5_matches_reference(tiles, action):
    rng = np.random.default_rng(4)
    a, b = _ints(rng, 3, 16, 512), _ints(rng, 3, 512, 256)
    rft, tft = _fts(action)
    # The reference's batched body at exactly these tiles: its launch with
    # the masked spec (the front door refits tiles to 128-multiples).
    inj_idx, inj_mag = rdispatch.encode_batched_injection(None, 0)
    ro, rr = rregistry.batched_kernel_call(
        jnp.asarray(a), jnp.asarray(b), inj_idx, inj_mag,
        rflash.encode_rng(jax.random.PRNGKey(KEYS[1]), rft),
        jnp.array([16, 256, 512], jnp.int32),
        spec=RBSpec(ft_level="block", masked=True),
        params=KernelParams(*tiles), ft=rft, interpret=True)
    to, tr = kg.ft_gemm_plain(_t(a), _t(b), ft=tft, tiles=tiles,
                              rng=_triple(KEYS[1], rft))
    np.testing.assert_allclose(to.numpy(), np.asarray(ro), atol=1e-5)
    _check(tr, rr)
    assert float(np.asarray(rr)[..., 0].sum()) > 0


#: Empty groups, a ragged last group, a group spanning two 64-row chunks.
SIZES = [13, 0, 100, 9]


def _grouped(seed):
    gids = np.random.default_rng(seed).permutation(np.concatenate(
        [np.full(n, g, np.int32) for g, n in enumerate(SIZES)]))
    ng = len(SIZES)
    return (rlay.make_layout(jnp.asarray(gids), ng, 16),
            tlay.make_layout(torch.from_numpy(gids), ng, 16), gids)


@pytest.mark.parametrize("action", ["correct", "detect"])
def test_k7_matches_reference(action):
    rl, tl, gids = _grouped(5)
    rng = np.random.default_rng(5)
    buf = _ints(rng, rl.t_buf, 256)
    w = _ints(rng, len(SIZES), 256, 300)
    rft, tft = _fts(action)
    ro, rr = rgrouped.grouped_buffer_call(
        RBSpec(ft_level="block", grouped=True), jnp.asarray(buf),
        jnp.asarray(w), rl, params=KernelParams(16, 128, 128), ft=rft,
        key=jax.random.PRNGKey(KEYS[0]), interpret=True)
    trip = _triple(KEYS[0], rft)
    for chunk in (16, kgg.SM90_CHUNK):
        to, tr = kgg.ft_gemm_grouped_plain(
            _t(buf), _t(w), tl.gid, tl.row_end, tiles=(16, 128, 128),
            chunk=chunk, ft=tft, rng=trip)
        np.testing.assert_allclose(to.numpy(), np.asarray(ro), atol=1e-5)
        if chunk == 16:
            _check(tr, rr)
        else:
            # every tile's band its own record; tau is the chunk's (its
            # max|A| over the chunk's rows), so only that field may differ
            _check(tr[..., :6], np.asarray(rr)[..., :6])
    assert float(np.asarray(rr)[..., 0].sum()) > 2


@pytest.mark.parametrize("action", ["correct", "detect"])
def test_k8_matches_reference(action):
    rl, tl, gids = _grouped(6)
    rng = np.random.default_rng(6)
    x, g = _ints(rng, rl.t_buf, 200), _ints(rng, rl.t_buf, 300)
    rft, tft = _fts(action)
    ro, rr = rgrouped.tgmm_buffer_call(
        RBSpec(ft_level="block", tgmm=True), jnp.asarray(x), jnp.asarray(g),
        rl, params=KernelParams(16, 128, 128), ft=rft,
        key=jax.random.PRNGKey(KEYS[1]), interpret=True)
    trip = _triple(KEYS[1], rft)
    to, tr = kgg.tgmm_plain(_t(x), _t(g), tl.row_end, tiles=(16, 128, 128),
                            ft=tft, rng=trip)
    np.testing.assert_allclose(to.numpy(), np.asarray(ro), atol=1e-5)
    _check(tr, rr)
    assert float(np.asarray(rr)[..., 0].sum()) > 2
    if action == "correct":
        # the chunked walk lands each tile's SEU at the end of its interval
        to, tc = kgg.tgmm_plain(_t(x), _t(g), tl.row_end,
                                tiles=(16, 128, 128), chunk=kgg.SM90_CHUNK,
                                ft=tft, rng=trip)
        np.testing.assert_allclose(to.numpy(), np.asarray(ro), atol=1e-5)
        assert _located(tc) == _located(rr)


# ---------------------------------------------------------------------------
# (c) the torch-op Injector
# ---------------------------------------------------------------------------

def test_injector_rate_and_determinism():
    inj = tfi.Injector(rate=0.3, bit_shift=8)
    c = torch.ones(3, 5, 7)
    n, hits = 2000, 0
    for i in range(n):
        out = inj(torch.Generator().manual_seed(i), c)
        moved = (out != c)
        if moved.any():
            hits += 1
            # every slice at the same (row, col), scaled by 2^8
            assert int(moved.sum()) == 3
            assert torch.all(out[moved] == 256.0)
    sd = (n * 0.3 * 0.7) ** 0.5
    assert abs(hits - 0.3 * n) < 5 * sd
    x = torch.randn(6, 6, generator=torch.Generator().manual_seed(0))
    key = torch.Generator().manual_seed(42)
    state = key.get_state()
    first = inj(key, x)
    assert torch.equal(key.get_state(), state)       # no state consumed
    assert torch.equal(inj(torch.Generator().manual_seed(42), x), first)
    draws = {inj.draw(torch.Generator().manual_seed(i), 6, 6)
             for i in range(50)}
    assert len(draws) > 10                           # keys differ


def test_torch_op_path_campaign_detects_and_corrects():
    rng = np.random.default_rng(7)
    x, w = _t(_ints(rng, 64, 96)), _t(_ints(rng, 96, 80))
    ft = TFT(inject_rate=1.0)
    clean = x @ w
    with telemetry.ft_scope() as sc:
        from repro_torch.core import ft_gemm as tcore
        y = tcore.ft_dot(x, w, ft=ft, key=torch.Generator().manual_seed(1),
                         site="wq")
    tot = sc.totals()
    assert tot["detected"] == tot["corrected"] == 1.0
    assert torch.equal(y, clean)


# ---------------------------------------------------------------------------
# (d) keys
# ---------------------------------------------------------------------------

def test_keys_are_distinct_per_site_and_layer_and_consume_nothing():
    key = torch.Generator().manual_seed(5)
    state = key.get_state()
    ft = TFT(inject_rate=0.5)
    ctx = blocks.Ctx(ft=ft, key=key)
    sites = ["wq", "wk", "w_gate", "attn_qk", "attn_pv", "moe_down"]
    triples = {(s, i): tflash.encode_rng(ctx.fold(i).subkey(s), ft)
               for s in sites for i in range(4)}
    assert len(set(triples.values())) == len(triples)
    assert torch.equal(key.get_state(), state)
    # the same derivation again (a remat recompute) gives the same keys
    assert tflash.encode_rng(ctx.fold(2).subkey("wq"), ft) == \
        triples[("wq", 2)]
    assert blocks.named_subkey(None, "wq") is None
    assert blocks.Ctx(ft=ft).fold(3).key is None
    only = dataclasses.replace(ctx, inject_sites=("w_gate",))
    assert only.subkey("wq") is None and only.subkey("w_gate") is not None


def test_check_inject_sites_raises_on_an_unknown_label():
    ctx = blocks.Ctx(ft=TFT(inject_rate=0.5), inject_sites=("nope",))
    with telemetry.ft_scope() as sc:
        telemetry.record_summary(torch.zeros((), dtype=torch.int32),
                                 torch.zeros(()), True, site="wq")
    with pytest.raises(ValueError, match="nope"):
        ctx.check_inject_sites(sc)
    dataclasses.replace(ctx, inject_sites=("wq",)).check_inject_sites(sc)


# ---------------------------------------------------------------------------
# (e) rate 0 with a key
# ---------------------------------------------------------------------------

def test_rate_zero_with_a_key_is_bit_identical():
    rng = np.random.default_rng(8)
    a, b = _t(rng.normal(size=(70, 130)).astype(np.float32)), \
        _t(rng.normal(size=(130, 90)).astype(np.float32))
    key = torch.Generator().manual_seed(9)
    ft0 = ONLINE_BLOCK.replace(backend="pallas")
    want = tops.ft_matmul_report(a, b, ft=ft0)
    got = tops.ft_matmul_report(a, b, ft=ft0, key=key)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert tflash.encode_rng(key, ft0) == (0, 0, 0)
    _, _, gids = _grouped(9)
    lay = tlay.make_layout(torch.from_numpy(gids), len(SIZES), 16)
    buf = _t(rng.normal(size=(lay.t_buf, 64)).astype(np.float32))
    w = _t(rng.normal(size=(len(SIZES), 64, 48)).astype(np.float32))
    for rng_ in (None, (0, 0, 0), (1, 4, 5)):
        out = kgg.ft_gemm_grouped(buf, w, lay.gid, lay.row_end, ft=ft0,
                                  rng=rng_)
        ref = kgg.ft_gemm_grouped(buf, w, lay.gid, lay.row_end, ft=ft0)
        assert all(torch.equal(x, y) for x, y in zip(out, ref))


# ---------------------------------------------------------------------------
# (f) training
# ---------------------------------------------------------------------------

def _train(ft, inject_every, steps=2, attn_impl="chunked"):
    """The loss and FT counters of each step and the parameters after
    ``steps`` steps (step 0 runs at lr 0) of a smoke phi4-mini on the CPU,
    under ``ft`` with a campaign every ``inject_every`` steps."""
    from repro_torch.data import pipeline
    from repro_torch.models import transformer
    from repro_torch.optim import adamw
    cfg = registry.get_smoke("phi4-mini-3.8b")
    run = RunConfig(model=cfg, ft=ft, dtype="float32", attn_chunk=16,
                    attn_impl=attn_impl)
    tc = train_loop.TrainConfig(total_steps=4, warmup_steps=1,
                                inject_every=inject_every)
    opt_cfg = adamw.AdamWConfig(lr=run.learning_rate,
                                weight_decay=run.weight_decay,
                                grad_clip=run.grad_clip)
    params = transformer.init(cfg, seed=run.seed, dtype=torch.float32,
                              device="cpu")
    params.requires_grad_(True)
    opt = train_loop.init_opt_state(params, opt_cfg, tc)
    step_fn = train_loop.make_train_step(cfg, run, opt_cfg, tc)
    it = pipeline.for_model(cfg, ShapeConfig("t", 16, 2, "train"),
                            seed=run.seed).iter_from(0)
    hist = []
    for s in range(steps):
        batch = {k: torch.as_tensor(v, dtype=torch.long)
                 for k, v in next(it).items()}
        params, opt, m = step_fn(params, opt, batch, s,
                                 train_loop.inject_key(tc, s))
        hist.append((float(m["loss"]), float(m["ft"].detected),
                     float(m["ft"].corrected)))
    return hist, {n: p.detach() for n, p in params.named_parameters()}


def test_smoke_train_campaign_detects_corrects_and_keeps_the_loss():
    """Every step of the campaign detects and corrects SEUs; its losses and
    its parameters after step 1 are within 1e-3 relative (Frobenius, per
    parameter) of the clean run's, and a detect-only campaign's losses are
    at least 100x further off."""
    ft = ONLINE_BLOCK.replace(backend="pallas")
    clean, p0 = _train(ft, 0)
    hot, p1 = _train(ft.replace(inject_rate=0.5), 1)
    left, _ = _train(ft.replace(inject_rate=0.5, action="detect"), 1)

    def off(run):
        return max(abs(r[0] - c[0]) / abs(c[0]) for r, c in zip(run, clean))

    for (_, d0, _), (_, d1, c1), (_, d2, c2) in zip(clean, hot, left):
        assert d0 == 0 and d1 == c1 > 0 and d2 > 0 and c2 == 0
    assert off(hot) <= 1e-3 and off(left) >= 100 * off(hot) and off(left) > 0
    worst = max(float((p1[n] - p0[n]).norm() / p0[n].norm()) for n in p0)
    assert worst <= 1e-3


def test_launcher_runs_a_campaign():
    from repro_torch.launch import train as launch
    out = launch.main(["--arch", "phi4-mini-3.8b-smoke", "--device", "cpu",
                       "--dtype", "float32", "--steps", "1", "--batch", "2",
                       "--seq", "16", "--inject-every", "1",
                       "--inject-rate", "0.5"])
    h = out["history"][0]
    assert h["detected"] == h["corrected"] > 0


def test_flash_path_campaign_detects_and_corrects():
    """A campaign step on flash attention detects and corrects SEUs with
    the clean step's loss (the flash kernels' draws:
    `test_torch_flash_campaign.py`)."""
    ft = ONLINE_BLOCK.replace(backend="pallas")
    (clean,), _ = _train(ft, 0, steps=1, attn_impl="flash")
    (hot,), _ = _train(ft.replace(inject_rate=0.5), 1, steps=1,
                       attn_impl="flash")
    assert clean[1] == 0 and hot[1] == hot[2] > 0
    assert abs(hot[0] - clean[0]) <= 1e-3 * abs(clean[0])
