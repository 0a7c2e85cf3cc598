"""Port ↔ reference: stochastic SEU campaigns on the flash family (K2, K3,
K4, K6).

  * (a) the draw enumerators `flashft.seu_fwd_draws`, `seu_dq_draws`,
    `seu_dkv_draws` and `seu_decode_draws` against the reference's
    `emit.stochastic_seu` for every uid of the grid, with the reference's
    live-step counts;
  * (b) each plain version against the reference's kernel in interpret
    mode, under the triple the reference encodes from its key, at the
    pinned bq = bkv = 64, with corrects and detect-only: K2 causal at Sq =
    Skv = 130 (ragged) and non-causal at Sq < Skv; K3 and K4 (at 1 and 3
    ranges of K4's walk) at the same shapes with n_rep 2; K6 over ragged
    lengths (0 among them) at 1 and 9 ranges of its page walk;
  * (c) the fronts at head dim 16 under a campaign: they pad dh to 128 (the
    reference's width), so the drawn columns and the reports are the
    reference's;
  * (d) rate 0 with a key is bit-identical to no key at every flash front;
    K6's hook through `paged_decode_step` under a keyed Ctx;
  * (e) a smoke phi4-mini `train` with ``inject_every=1`` on
    ``attn_impl="flash"``: each step detects exactly the SEUs its forward's
    GEMM and flash blocks draw, corrects them, and keeps the clean run's
    loss.

Tolerances: outputs and gradients to 1e-4 (f32 sums in other orders);
reports det / corr / row / col / k equal, tau to 1e-5 relative, magnitude
and max residual of a detecting block to 1e-5 relative (the SEU's
residual) and every max residual within 1e-4 (rounding), except under K6's
ranges (there the SEU's δ is taken against the range's running max).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.policy import FTConfig as RFT  # noqa: E402
from repro.kernels import flashft as rflash  # noqa: E402
from repro.kernels.templates import emit as temit  # noqa: E402

from repro_torch.configs import registry  # noqa: E402
from repro_torch.configs.base import RunConfig, ShapeConfig  # noqa: E402
from repro_torch.core.policy import FTConfig as TFT  # noqa: E402
from repro_torch.core.policy import ONLINE_BLOCK  # noqa: E402
from repro_torch.core import telemetry  # noqa: E402
from repro_torch.kernels import flashft as tflash  # noqa: E402
from repro_torch.kernels import ft_gemm as kg  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels.templates import seu  # noqa: E402
from repro_torch.train import train_loop  # noqa: E402

B = 64                      # the pinned bq = bkv
KEY = 5
#: (Sq, Skv, causal): ragged causal, and non-causal with Sq < Skv.
GEOMS = [(130, 130, True), (70, 150, False)]
BH, NREP = 4, 2


def _fts(action="correct", rate=1.0):
    return (RFT(action=action, backend="pallas", inject_rate=rate),
            TFT(action=action, backend="pallas", inject_rate=rate))


def _triple(rft, key=KEY):
    return tuple(int(x) for x in np.asarray(
        rflash.encode_rng(jax.random.PRNGKey(key), rft)))


def _pad(x, rows, cols=128, value=0.0):
    return np.pad(x, ((0, 0), (0, rows - x.shape[1]),
                      (0, cols - x.shape[2])), constant_values=value)


def _up(n):
    return -(-n // B) * B


def _check(got, want, magnitudes=True):
    """Reports field for field. ``magnitudes`` False (K6's ranged walk,
    whose P is taken against a range's running max, so the SEU's δ and
    with it the magnitude move) leaves out the magnitude and max
    residual."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[..., [0, 1, 2, 3, 7]],
                                  want[..., [0, 1, 2, 3, 7]])
    np.testing.assert_allclose(got[..., 6], want[..., 6], rtol=1e-5)
    if not magnitudes:
        return
    det = want[..., 0] > 0
    for f in (4, 5):
        np.testing.assert_allclose(got[..., f][det], want[..., f][det],
                                   rtol=1e-5)
    np.testing.assert_allclose(got[..., 5], want[..., 5], rtol=1e-5,
                               atol=1e-4)


def _inputs(seed, sq, skv, dh=128):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(BH, sq, dh)).astype(np.float32)
    k = rng.normal(size=(BH // NREP, skv, dh)).astype(np.float32)
    v = rng.normal(size=(BH // NREP, skv, dh)).astype(np.float32)
    g = rng.normal(size=(BH, sq, dh)).astype(np.float32)
    return q, k, v, g


def _ref_forward(q, k, v, causal, rft, trip, save_stats=True):
    """The reference's K2 at the pinned blocks on 128-padded operands."""
    sq, skv, dh = q.shape[1], k.shape[1], q.shape[2]
    inj, mag = rflash.encode_injection(None)
    res = rflash.flash_ft_attention(
        *(jnp.asarray(_pad(x, _up(x.shape[1]))) for x in (q, k, v)), inj, mag,
        jnp.array([sq, skv], jnp.int32), jnp.asarray(trip, jnp.int32), bq=B,
        bkv=B, causal=causal, ft=rft, interpret=True, scale=dh ** -0.5,
        n_rep=NREP, save_stats=save_stats)
    return [np.array(x) for x in res]


# ---------------------------------------------------------------------------
# (a) the draws
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sq,skv,causal", GEOMS)
def test_draws_match_reference(sq, skv, causal):
    rft, tft = _fts(rate=0.37)
    trip = _triple(rft)
    rng_ref = jnp.asarray(trip, jnp.int32)
    nqb, nkvb, c_off = -(-sq // B), -(-skv // B), skv - sq
    # K2 and K3: uid h·nqb + qi over the live kv steps of each q block
    for fn, salt in ((tflash.seu_fwd_draws, seu.SALT_FWD),
                     (tflash.seu_dq_draws, seu.SALT_DQ)):
        got = fn(trip, tft, BH, sq, skv, 128, causal=causal)
        for h in range(BH):
            for qi in range(nqb):
                n_live = rflash._live_kv_steps(skv, qi * B, B, B, c_off,
                                               causal)
                want = temit.stochastic_seu(rng_ref, salt,
                                            jnp.int32(h * nqb + qi), n_live,
                                            B, 128, 0.37)
                assert [int(x[h, qi]) for x in got] == \
                    [int(x) for x in want]
    # K4: uid b·nkvb + kvi over n_rep × the live q blocks of its walk
    got = tflash.seu_dkv_draws(trip, tft, BH // NREP, NREP, sq, skv, 128,
                               causal=causal)
    for b in range(BH // NREP):
        for kvi in range(nkvb):
            qi_lo = max((kvi * B - c_off) // B, 0) if causal else 0
            span = max(nqb - qi_lo, 0)
            want = temit.stochastic_seu(rng_ref, seu.SALT_DKV,
                                        jnp.int32(b * nkvb + kvi),
                                        NREP * span, B, 128, 0.37)
            assert [int(x[b, kvi]) for x in got] == [int(x) for x in want]
    # K6: uid slot·KVH + head over ceil(length / page)
    lengths = torch.tensor([0, 1, 17, 64, 130], dtype=torch.int32)
    got = tflash.seu_decode_draws(trip, tft, lengths, 2, 16, 9, 8, 128)
    for gi in range(10):
        n_live = -(-int(lengths[gi // 2]) // 16)
        want = temit.stochastic_seu(rng_ref, seu.SALT_DECODE, jnp.int32(gi),
                                    n_live, 8, 128, 0.37)
        assert [int(x[gi]) for x in got] == [int(x) for x in want]
    assert tflash.seu_fwd_draws(None, tft, BH, sq, skv, 128) is None
    assert tflash.seu_fwd_draws(trip, tft.replace(inject_rate=0.0), BH, sq,
                                skv, 128) is None


# ---------------------------------------------------------------------------
# (b) the plain versions against the reference's kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("action", ["correct", "detect"])
@pytest.mark.parametrize("sq,skv,causal", GEOMS)
def test_k2_matches_reference(sq, skv, causal, action):
    q, k, v, _ = _inputs(1, sq, skv)
    rft, tft = _fts(action)
    trip = _triple(rft)
    ro, rm, rl, rr = _ref_forward(q, k, v, causal, rft, trip)
    to, tm, tl, tr = tflash.flash_ft_plain(
        *(torch.from_numpy(x) for x in (q, k, v)), ft=tft, scale=128 ** -0.5,
        tau_dh=128, n_rep=NREP, causal=causal, bq=B, bkv=B, save_stats=True,
        rng=trip)
    np.testing.assert_allclose(to.numpy(), ro[:, :sq], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tm.numpy(), rm[:, :sq, 0], rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(tl.numpy(), rl[:, :sq, 0], rtol=1e-4,
                               atol=1e-4)
    _check(tr, rr)
    hits = tflash.seu_fwd_draws(trip, tft, BH, sq, skv, 128, causal=causal)
    assert float(tr[..., 0].sum()) == float(hits[0].sum()) > 0
    if action == "correct":
        clean = tflash.flash_ft_plain(
            *(torch.from_numpy(x) for x in (q, k, v)), ft=tft,
            scale=128 ** -0.5, tau_dh=128, n_rep=NREP, causal=causal, bq=B,
            bkv=B)[0]
        np.testing.assert_allclose(to.numpy(), clean.numpy(), rtol=1e-4,
                                   atol=1e-4)


def _bwd_operands(q, k, v, g, causal):
    """m, l and di from the clean reference forward: the same saved
    statistics for both backward kernels."""
    rft, _ = _fts(rate=0.0)
    ro, rm, rl, _ = _ref_forward(q, k, v, causal, rft, (0, 0, 0))
    sq = q.shape[1]
    di = (g * ro[:, :sq, :g.shape[2]]).sum(-1)
    return rm[:, :sq, 0], rl[:, :sq, 0], di.astype(np.float32)


@pytest.mark.parametrize("action", ["correct", "detect"])
@pytest.mark.parametrize("sq,skv,causal", GEOMS)
def test_k3_k4_match_reference(sq, skv, causal, action):
    """K3 and K4 (K4's walk at 1 and 3 ranges) against the reference's
    kernels under one triple: both draw from it on their own salts."""
    q, k, v, g = _inputs(2, sq, skv)
    m, l, di = _bwd_operands(q, k, v, g, causal)
    rft, tft = _fts(action)
    trip = _triple(rft, KEY + 1)
    sq_p, skv_p = _up(sq), _up(skv)
    ops_ref = [jnp.asarray(_pad(x, sq_p)) for x in (q,)] + [
        jnp.asarray(_pad(x, skv_p)) for x in (k, v)] + [
        jnp.asarray(_pad(g, sq_p)),
        jnp.asarray(_pad(m[..., None], sq_p, 1, value=rflash.NEG_INF)),
        jnp.asarray(_pad(l[..., None], sq_p, 1)),
        jnp.asarray(_pad(di[..., None], sq_p, 1))]
    inj, mag = jnp.zeros((7,), jnp.int32), jnp.zeros((1,), jnp.float32)
    kw = dict(bq=B, bkv=B, causal=causal, ft=rft, interpret=True,
              scale=128 ** -0.5, n_rep=NREP)
    dims, rr_ = jnp.array([sq, skv], jnp.int32), jnp.asarray(trip, jnp.int32)
    rdq, rrq = (np.asarray(x) for x in rflash.flash_ft_dq(
        *ops_ref, inj, mag, dims, rr_, **kw))
    rdk, rdv, rrk = (np.asarray(x) for x in rflash.flash_ft_dkv(
        *ops_ref, inj, mag, dims, rr_, **kw))
    targs = [torch.from_numpy(x) for x in (q, k, v, g, m, l, di)]
    tkw = dict(ft=tft, scale=128 ** -0.5, tau_dh=128, n_rep=NREP,
               causal=causal, bq=B, bkv=B, rng=trip)
    tdq, trq = tflash.flash_dq_plain(*targs, **tkw)
    np.testing.assert_allclose(tdq.numpy(), rdq[:, :sq], rtol=1e-4,
                               atol=1e-4)
    _check(trq, rrq)
    n_dq = tflash.seu_dq_draws(trip, tft, BH, sq, skv, 128, causal=causal)
    assert float(trq[..., 0].sum()) == float(n_dq[0].sum()) > 0
    n_dkv = tflash.seu_dkv_draws(trip, tft, BH // NREP, NREP, sq, skv, 128,
                                 causal=causal)
    for ranges in (1, 3):
        tdk, tdv, trk = tflash.flash_dkv_plain(*targs, ranges=ranges, **tkw)
        np.testing.assert_allclose(tdk.numpy(), rdk[:, :skv], rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(tdv.numpy(), rdv[:, :skv], rtol=1e-4,
                                   atol=1e-4)
        _check(trk, rrk)
        assert float(trk[..., 0].sum()) == float(n_dkv[0].sum()) > 0


def _pools(seed, lengths, kvh, page, max_pages, dh=128):
    rng = np.random.default_rng(seed)
    b = len(lengths)
    n_pages = 1 + b * max_pages
    kp, vp = (rng.normal(size=(n_pages, kvh, page, dh)).astype(np.float32)
              for _ in range(2))
    table = (rng.permutation(b * max_pages).reshape(b, max_pages) + 1
             ).astype(np.int32)
    return kp, vp, table, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("action", ["correct", "detect"])
def test_k6_matches_reference(action):
    """Ragged rows (length 0 among them) of 2 kv heads x 3 query rows,
    padded to the f32 sublane of 8, over pages of 16 in a table 9 wide: the
    unsplit walk and 9 ranges against the reference's kernel."""
    kvh, page, mp, bq = 2, 16, 9, 8
    lengths = [0, 1, 17, 64, 144]
    kp, vp, table, lens = _pools(3, lengths, kvh, page, mp)
    rng = np.random.default_rng(4)
    q = np.zeros((len(lengths) * kvh, bq, 128), np.float32)
    q[:, :3] = rng.normal(size=(len(lengths) * kvh, 3, 128))
    rft, tft = _fts(action)
    trip = _triple(rft, KEY + 2)
    inj, mag = rflash.encode_injection(None)
    ro, rr = (np.asarray(x) for x in rflash.flash_ft_decode_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), inj, mag,
        jnp.asarray(lens), jnp.asarray(table), jnp.asarray(trip, jnp.int32),
        kvh=kvh, ft=rft, interpret=True, scale=128 ** -0.5))
    hits = tflash.seu_decode_draws(trip, tft, torch.from_numpy(lens), kvh,
                                   page, mp, bq, 128)
    for ranges in (1, 9):
        to, tr = tflash.flash_decode_plain(
            *(torch.from_numpy(x) for x in (q, kp, vp, lens, table)), ft=tft,
            scale=128 ** -0.5, tau_dh=128, ranges=ranges, rng=trip)
        np.testing.assert_allclose(to.numpy(), ro, rtol=1e-4, atol=1e-4)
        _check(tr, rr, magnitudes=ranges == 1)
        assert float(tr[..., 0].sum()) == float(hits[0].sum()) > 0
    assert not hits[0][:kvh].any()                   # length 0 never draws


# ---------------------------------------------------------------------------
# (c) the fronts pad dh to 128 under a campaign
# ---------------------------------------------------------------------------

def test_fronts_pad_dh_to_128_under_a_campaign(monkeypatch):
    """At dh 16 a clean call pads to 64 and a campaign to 128: the
    campaign's forward and backward reports are the reference's on
    128-padded operands (the columns the hook draws run to 127)."""
    sq = skv = 130
    q, k, v, g = _inputs(6, sq, skv, dh=16)
    rft, tft = _fts()
    trip = _triple(rft)
    monkeypatch.setattr(tflash, "encode_rng",
                        lambda key, ft: (0, 0, 0) if key is None else trip)
    widths = []
    real = tflash.flash_ft_fwd

    def spy(q3, *a, **kw):
        widths.append(q3.shape[-1])
        return real(q3, *a, **kw)

    monkeypatch.setattr(tflash, "flash_ft_fwd", spy)
    key = torch.Generator().manual_seed(0)
    tq, tk, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))
    to, tm, tl, tr = tops.flash_ft(tq, tk, tv, ft=tft, n_rep=NREP, bq=B,
                                   bkv=B, key=key, save_stats=True)
    tops.flash_ft(tq, tk, tv, ft=tft, n_rep=NREP, bq=B, bkv=B,
                  save_stats=True)
    assert widths == [128, 64]
    ro, rm, rl, rr = _ref_forward(q, k, v, True, rft, trip)
    np.testing.assert_allclose(to.numpy(), ro[:, :sq, :16], rtol=1e-4,
                               atol=1e-4)
    _check(tr, rr)
    assert int(np.asarray(rr)[..., 3].max()) >= 16   # drawn past dh
    dq, dk, dv, trq, trk = tops.flash_ft_bwd(tq, tk, tv, to, tm, tl, tg,
                                             ft=tft, n_rep=NREP, bq=B, bkv=B,
                                             key=key)
    di = (g * to.numpy()).sum(-1).astype(np.float32)
    m, l = tm.numpy(), tl.numpy()
    ops_ref = [jnp.asarray(_pad(q, _up(sq))), jnp.asarray(_pad(k, _up(skv))),
               jnp.asarray(_pad(v, _up(skv))), jnp.asarray(_pad(g, _up(sq))),
               jnp.asarray(_pad(m[..., None], _up(sq), 1,
                                value=rflash.NEG_INF)),
               jnp.asarray(_pad(l[..., None], _up(sq), 1)),
               jnp.asarray(_pad(di[..., None], _up(sq), 1))]
    inj, mag = jnp.zeros((7,), jnp.int32), jnp.zeros((1,), jnp.float32)
    kw = dict(bq=B, bkv=B, causal=True, ft=rft, interpret=True,
              scale=16 ** -0.5, n_rep=NREP)
    dims, rr_ = jnp.array([sq, skv], jnp.int32), jnp.asarray(trip, jnp.int32)
    rdq, rrq = (np.asarray(x) for x in rflash.flash_ft_dq(
        *ops_ref, inj, mag, dims, rr_, **kw))
    rdk, rdv, rrk = (np.asarray(x) for x in rflash.flash_ft_dkv(
        *ops_ref, inj, mag, dims, rr_, **kw))
    for got, want in ((dq, rdq[:, :sq, :16]), (dk, rdk[:, :skv, :16]),
                      (dv, rdv[:, :skv, :16])):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    _check(trq, rrq)
    _check(trk, rrk)


# ---------------------------------------------------------------------------
# (d) rate 0 with a key
# ---------------------------------------------------------------------------

def test_rate_zero_with_a_key_is_bit_identical():
    q, k, v, g = _inputs(7, 70, 100, dh=48)
    tq, tk, tv, tg = (torch.from_numpy(x) for x in (q, k, v, g))
    ft0 = ONLINE_BLOCK.replace(backend="pallas")
    key = torch.Generator().manual_seed(3)
    want = tops.flash_ft(tq, tk, tv, ft=ft0, n_rep=NREP, save_stats=True)
    got = tops.flash_ft(tq, tk, tv, ft=ft0, n_rep=NREP, save_stats=True,
                        key=key)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    o, m, l = want[:3]
    want = tops.flash_ft_bwd(tq, tk, tv, o, m, l, tg, ft=ft0, n_rep=NREP)
    got = tops.flash_ft_bwd(tq, tk, tv, o, m, l, tg, ft=ft0, n_rep=NREP,
                            key=key)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    kp, vp, table, lens = _pools(8, [0, 20, 50], 2, 16, 4)
    qd = torch.from_numpy(np.random.default_rng(9).normal(
        size=(3, 6, 128)).astype(np.float32))
    args = (qd, *(torch.from_numpy(x) for x in (kp, vp, lens, table)))
    want = tops.flash_ft_decode(*args, ft=ft0)
    got = tops.flash_ft_decode(*args, ft=ft0, key=key)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    # a triple with rate 0 in the policy arms nothing in the plain versions
    out = tflash.flash_ft_plain(tq, tk, tv, ft=ft0, scale=1.0, tau_dh=128,
                                n_rep=NREP, rng=(1, 4, 5))
    ref = tflash.flash_ft_plain(tq, tk, tv, ft=ft0, scale=1.0, tau_dh=128,
                                n_rep=NREP)
    assert all(torch.equal(x, y) for x, y in zip(out, ref))


def test_paged_decode_step_with_a_keyed_ctx():
    """K6's hook through the model: `paged_decode_step` under a Ctx whose
    key drives a campaign limited to "dec_flash" detects and corrects, per
    layer, the SEUs K6 draws under that layer's key, with the clean step's
    logits."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.models import blocks, transformer
    cfg = ModelConfig(arch_id="tiny", family="dense", n_layers=2, d_model=64,
                      n_heads=6, n_kv_heads=2, d_ff=128, vocab_size=256,
                      head_dim=128)
    params = transformer.init(cfg, seed=0, dtype=torch.float32, device="cpu")
    lengths, page, mp = [9, 40, 0, 17], 8, 6
    rng = np.random.default_rng(11)
    n_pages = 1 + len(lengths) * mp
    pools = [torch.from_numpy(rng.normal(size=(
        cfg.n_layers, n_pages, cfg.n_kv_heads, page, 128)).astype(
            np.float32)) for _ in range(2)]
    table = torch.from_numpy((rng.permutation(len(lengths) * mp) + 1)
                             .reshape(len(lengths), mp).astype(np.int32))
    tok = torch.from_numpy(rng.integers(1, 200, (len(lengths), 1)))
    ft = ONLINE_BLOCK.replace(backend="pallas", inject_rate=0.5)

    def step(key):
        cache = {"k_pages": pools[0].clone(), "v_pages": pools[1].clone(),
                 "page_table": table.clone(),
                 "length": torch.tensor(lengths, dtype=torch.int32)}
        ctx = blocks.Ctx(ft=ft, key=key, dtype=torch.float32,
                         inject_sites=("dec_flash",))
        with torch.inference_mode(), telemetry.ft_scope() as scope:
            logits, _ = transformer.paged_decode_step(params, tok, cache,
                                                      cfg, ctx)
            return logits, scope.site_totals(), ctx

    clean, sites0, _ = step(None)
    key = torch.Generator().manual_seed(4)
    hot, sites, ctx = step(key)
    drawn = 0
    for i in range(cfg.n_layers):
        trip = tflash.encode_rng(ctx.fold(i).subkey("dec_flash"), ft)
        drawn += int(tflash.seu_decode_draws(
            trip, ft, torch.tensor(lengths) + 1, cfg.n_kv_heads, page, mp, 8,
            128)[0].sum())
    assert sites0["dec_flash"]["detected"] == 0
    assert sites["dec_flash"]["detected"] == sites["dec_flash"][
        "corrected"] == drawn > 0
    assert all(t["detected"] == 0 for s, t in sites.items()
               if s != "dec_flash")
    np.testing.assert_allclose(hot.numpy(), clean.numpy(), rtol=1e-4,
                               atol=1e-4)


# ---------------------------------------------------------------------------
# (e) training on flash attention
# ---------------------------------------------------------------------------

class _ForwardDraws:
    """Counts the SEUs the forward's protected K1 / K5 and K2 launches draw
    (those inside a telemetry scope: not the backward's, not a remat
    recompute's), from each launch's shapes, while patched in."""

    def __init__(self, monkeypatch):
        self.hits = 0
        real_gemm, real_fwd = kg.ft_gemm, tflash.flash_ft_fwd

        def gemm(a, b, **kw):
            ft, rng = kw.get("ft"), kw.get("rng")
            if (kg.seu_armed(rng, ft)
                    and telemetry.current_scope() is not None):
                p = kg.plan_call(a, b, chain=tuple(kw.get("chain", ())),
                                 ft=ft,
                                 save_act_grad=kw.get("save_act_grad",
                                                      False),
                                 tiles=kw.get("tiles"))
                m, k = a.shape[-2:]
                bm, bn, bk = p.tiles
                self.hits += int(kg.seu_draws(
                    rng, ft, a[..., 0, 0].numel(), kg.cdiv(m, bm),
                    kg.cdiv(b.shape[-1], bn), kg.cdiv(k, bk), p.tiles,
                    a.dim() > 2)[0].sum())
            return real_gemm(a, b, **kw)

        def fwd(q, k, v, **kw):
            ft, rng = kw.get("ft"), kw.get("rng")
            if (kg.seu_armed(rng, ft)
                    and telemetry.current_scope() is not None):
                self.hits += int(tflash.seu_fwd_draws(
                    rng, ft, q.shape[0], q.shape[1], k.shape[1], q.shape[2],
                    causal=kw.get("causal", True),
                    bq=kw.get("bq") or B, bkv=kw.get("bkv") or B)[0].sum())
            return real_fwd(q, k, v, **kw)

        monkeypatch.setattr(kg, "ft_gemm", gemm)
        monkeypatch.setattr(tflash, "flash_ft_fwd", fwd)


def _train(ft, inject_every, monkeypatch, steps=2):
    """Per step: (loss, detected, corrected, SEUs the forward drew) of a
    smoke phi4-mini on the CPU with flash attention, and the parameters
    after the run."""
    from repro_torch.data import pipeline
    from repro_torch.models import transformer
    from repro_torch.optim import adamw
    cfg = registry.get_smoke("phi4-mini-3.8b")
    run = RunConfig(model=cfg, ft=ft, dtype="float32", attn_impl="flash")
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
    with monkeypatch.context() as mp:
        draws = _ForwardDraws(mp)
        for s in range(steps):
            batch = {k: torch.as_tensor(v, dtype=torch.long)
                     for k, v in next(it).items()}
            before = draws.hits
            params, opt, m = step_fn(params, opt, batch, s,
                                     train_loop.inject_key(tc, s))
            hist.append((float(m["loss"]), float(m["ft"].detected),
                         float(m["ft"].corrected), draws.hits - before))
    return hist, {n: p.detach() for n, p in params.named_parameters()}


def test_smoke_train_campaign_on_flash_attention(monkeypatch):
    """Every campaign step detects and corrects exactly the SEUs its
    forward draws (GEMM and flash blocks), with the clean run's losses and
    parameters within 1e-3 relative."""
    ft = ONLINE_BLOCK.replace(backend="pallas")
    clean, p0 = _train(ft, 0, monkeypatch)
    hot, p1 = _train(ft.replace(inject_rate=0.5), 1, monkeypatch)
    for (l0, d0, _, _), (l1, d1, c1, n1) in zip(clean, hot):
        assert d0 == 0 and d1 == c1 == n1 > 0
        assert abs(l1 - l0) <= 1e-3 * abs(l0)
    worst = max(float((p1[n] - p0[n]).norm() / p0[n].norm()) for n in p0)
    assert worst <= 1e-3
