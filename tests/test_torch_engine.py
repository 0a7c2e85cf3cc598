"""Port ↔ reference: the paged serving path on a tiny dense model (2
layers, d 64, 4 / 2 heads, dh 128, so the paged decode kernel's plain
version serves the decode attention), reference weights converted with
`convert.params_from_numpy`, f32 on the CPU.

  * `transformer.paged_decode_step` against the reference's on the same
    paged cache (ragged lengths with a fresh slot and a page-edge length):
    logits to 2e-4, the caches after the step to 1e-5; and against the
    port's own dense `decode_step`;
  * the fallback (FT on the xla backend) gathers the pages and runs the
    dense decode attention under the "dec_page_qk" / "dec_page_pv" labels,
    with the reference's output;
  * `ServeEngine`: four requests on two slots give the reference engine's
    tokens and each request's solo-engine tokens, every page comes back,
    "dec_flash" reaches the caller's telemetry scope with no detection,
    and the reference's errors are raised.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import ModelConfig as RModel  # noqa: E402
from repro.configs.base import RunConfig as RRun  # noqa: E402
from repro.core.policy import FTConfig as RFT  # noqa: E402
from repro.models import blocks as rblocks  # noqa: E402
from repro.models import transformer as rtr  # noqa: E402
from repro.train import engine as reng  # noqa: E402
from repro.train import kv_cache as rkv  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs.base import ModelConfig as TModel  # noqa: E402
from repro_torch.configs.base import MoEConfig as TMoE  # noqa: E402
from repro_torch.configs.base import RunConfig as TRun  # noqa: E402
from repro_torch.core import telemetry as ttel  # noqa: E402
from repro_torch.core.policy import FTConfig as TFT  # noqa: E402
from repro_torch.models import blocks as tblocks  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.train import engine as teng  # noqa: E402
from repro_torch.train import kv_cache as tkv  # noqa: E402

TINY = dict(arch_id="tiny", family="dense", n_layers=2, d_model=64,
            n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256, head_dim=128)
R_TINY, T_TINY = RModel(**TINY), TModel(**TINY)
PALLAS = dict(action="correct", level="block", backend="pallas")
PROMPT_LENS, MAX_NEW = [5, 13, 9, 21], [6, 3, 8, 4]


@pytest.fixture(scope="module")
def tiny():
    params = rtr.init(R_TINY, jax.random.PRNGKey(0), jnp.float32)
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, params),
                                        device="cpu")
    return params, tparams


def _to_torch(cache):
    return {k: torch.from_numpy(np.array(v)) for k, v in cache.items()}


@pytest.fixture(scope="module")
def paged_step(tiny):
    """The reference test's setup: lengths [9, 24, 0] (24 = 3 full pages,
    0 a fresh slot) in a paged cache filled from each slot's prefill, the
    engine's protocol (ensure length + 1, the device sees length), then one
    step of each package on the same cache and tokens."""
    params, tparams = tiny
    b, page, mp = 3, 8, 4
    lengths = [9, 24, 0]
    rctx = rblocks.Ctx(ft=RFT(**PALLAS), dtype=jnp.float32,
                       attn_shard="none")
    rng = np.random.default_rng(0)
    n_pages = 1 + b * mp
    alloc = rkv.PageAllocator(n_pages, b, mp, page)
    paged = rkv.init_paged_cache(R_TINY.n_layers, n_pages, b, mp,
                                 R_TINY.n_kv_heads, page, R_TINY.head_dim,
                                 jnp.float32)
    for length in lengths:
        s, _ = alloc.alloc_slot(length)
        if length == 0:
            continue
        toks = jnp.asarray(rng.integers(1, 200, (1, length)), jnp.int32)
        _, c1 = rtr.prefill(params, toks,
                            rtr.init_cache(R_TINY, 1, length, jnp.float32),
                            R_TINY, rctx)
        paged = rkv.write_prefill(paged, s, jnp.asarray(alloc.page_table[s]),
                                  c1["k"][:, 0], c1["v"][:, 0], length)
    for slot in range(b):
        alloc.ensure(slot, lengths[slot] + 1)
    paged["page_table"] = jnp.asarray(alloc.page_table)
    paged["length"] = jnp.asarray(lengths, jnp.int32)
    tok = rng.integers(1, 200, (b, 1)).astype(np.int32)
    tcache = _to_torch(paged)
    before = {k: v.clone() for k, v in tcache.items()}
    rl, rc = rtr.paged_decode_step(params, jnp.asarray(tok), paged, R_TINY,
                                   rctx)
    tctx = tblocks.Ctx(ft=TFT(**PALLAS), dtype=torch.float32)
    with torch.inference_mode(), ttel.ft_scope() as scope:
        tl, tc = ttr.paged_decode_step(tparams, torch.from_numpy(tok).long(),
                                       tcache, T_TINY, tctx)
        sites = scope.site_totals()
    return dict(rl=np.asarray(rl), rc=rc, tl=tl, tc=tc, tok=tok,
                before=before, lengths=lengths, sites=sites)


def test_paged_decode_step_matches_reference(paged_step):
    d = paged_step
    assert np.abs(d["tl"].numpy() - d["rl"]).max() < 2e-4
    for got, want in zip(tkv.gather_dense(d["tc"]), rkv.gather_dense(d["rc"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_array_equal(d["tc"]["length"].numpy(),
                                  np.asarray(d["rc"]["length"]))
    assert d["sites"]["dec_flash"]["detected"] == 0.0


def test_paged_decode_step_matches_dense_decode_step(paged_step, tiny):
    """The port's paged step and its dense step give the same logits and
    the same cached keys and values over each slot's live span."""
    _, tparams = tiny
    d = paged_step
    kd, vd = tkv.gather_dense(d["before"])
    dense = {"k": kd.clone(), "v": vd.clone(),
             "length": d["before"]["length"].clone()}
    ctx = tblocks.Ctx(ft=TFT(**PALLAS), dtype=torch.float32)
    with torch.inference_mode():
        dl, dc = ttr.decode_step(tparams, torch.from_numpy(d["tok"]).long(),
                                 dense, T_TINY, ctx)
    assert (dl - d["tl"]).abs().max().item() < 2e-4
    pk, pv = tkv.gather_dense(d["tc"])
    for slot, length in enumerate(d["lengths"]):
        live = slice(0, length + 1)
        torch.testing.assert_close(pk[:, slot, live], dc["k"][:, slot, live],
                                   atol=1e-5, rtol=0)
        torch.testing.assert_close(pv[:, slot, live], dc["v"][:, slot, live],
                                   atol=1e-5, rtol=0)


def test_fallback_gathers_pages_under_dec_page_labels():
    """FT on the xla backend: the pages are gathered and the dense decode
    attention runs, recording "dec_page_qk" / "dec_page_pv"; the output is
    the reference's."""
    rng = np.random.default_rng(4)
    b, h, kvh, dh, page, mp = 2, 4, 2, 16, 8, 3
    n_pages = 1 + b * mp
    q = rng.standard_normal((b, 1, h, dh)).astype(np.float32)
    kp, vp = (rng.standard_normal((n_pages, kvh, page, dh)).astype(np.float32)
              for _ in range(2))
    table = np.array([[1, 2, 0], [3, 0, 0]], np.int32)
    lengths = np.array([11, 5], np.int32)
    xla = dict(action="correct", level="block", backend="xla")
    want = rblocks.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(lengths), jnp.asarray(table),
        rblocks.Ctx(ft=RFT(**xla), dtype=jnp.float32, attn_shard="none"))
    with ttel.ft_scope() as scope:
        got = tblocks.paged_decode_attention(
            *(torch.from_numpy(x) for x in (q, kp, vp, lengths, table)),
            tblocks.Ctx(ft=TFT(**xla), dtype=torch.float32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    sites = scope.site_totals()
    assert set(sites) == {"dec_page_qk", "dec_page_pv"}
    assert all(t["detected"] == 0.0 for t in sites.values())


@pytest.fixture(scope="module")
def engines(tiny):
    """Four requests on two slots (queueing and slot reuse) through the
    reference engine and the port's, the port's inside a telemetry scope,
    and one single-slot port engine per request."""
    params, tparams = tiny
    rng = np.random.default_rng(1)
    prompts = [rng.integers(1, 200, (n,)) for n in PROMPT_LENS]
    ec = dict(max_len=64, n_slots=2, page_size=8, max_new_tokens=8)
    reng_ = reng.ServeEngine(params, R_TINY,
                             RRun(model=R_TINY, ft=RFT(**PALLAS),
                                  dtype="float32"),
                             reng.EngineConfig(**ec))
    trun = TRun(model=T_TINY, ft=TFT(**PALLAS), dtype="float32")
    teng_ = teng.ServeEngine(tparams, T_TINY, trun, teng.EngineConfig(**ec),
                             device="cpu")
    for p, m in zip(prompts, MAX_NEW):
        reng_.submit(p, max_new_tokens=m)
        teng_.submit(p, max_new_tokens=m)
    want = reng_.run()
    with ttel.ft_scope() as scope:
        got = teng_.run()
        sites = scope.site_totals()
        n_dec = sum(1 for it in scope._items if it[0] == "dec_flash")
    solo = []
    for p, m in zip(prompts, MAX_NEW):
        one = teng.ServeEngine(tparams, T_TINY, trun,
                               teng.EngineConfig(max_len=64, n_slots=1,
                                                 page_size=8), device="cpu")
        one.submit(p, max_new_tokens=m)
        solo.append(one.run()[0])
    return dict(want=want, got=got, eng=teng_, sites=sites, n_dec=n_dec,
                solo=solo)


def test_engine_tokens_match_reference_engine(engines):
    want, got = engines["want"], engines["got"]
    assert [r.rid for r in got] == [0, 1, 2, 3]
    for r, w in zip(got, want):
        assert (r.rid, r.prompt_len) == (w.rid, w.prompt_len)
        assert r.tokens == w.tokens, (r.rid, r.tokens, w.tokens)
        assert len(r.tokens) == MAX_NEW[r.rid] and r.ttft_s >= 0.0


def test_engine_conserves_solo_greedy_tokens(engines):
    for r, s in zip(engines["got"], engines["solo"]):
        assert r.tokens == s.tokens, (r.rid, r.tokens, s.tokens)


def test_engine_returns_all_pages(engines):
    eng = engines["eng"]
    assert eng.alloc.n_free == eng.plan.n_pages - 1
    eng.alloc.check_invariants()
    assert not eng.alloc.live.any()


def test_engine_telemetry_reaches_the_callers_scope(engines):
    """Every decode step records "dec_flash" once per layer; prefill's
    sites are there too; nothing is detected on clean data."""
    sites = engines["sites"]
    assert "dec_flash" in sites and "attn_flash" in sites
    assert all(t["detected"] == 0.0 for t in sites.values())
    assert engines["n_dec"] % T_TINY.n_layers == 0 and engines["n_dec"] > 0


def test_engine_rejects_bad_requests(tiny):
    _, tparams = tiny
    run = TRun(model=T_TINY, ft=TFT(**PALLAS), dtype="float32")
    eng = teng.ServeEngine(tparams, T_TINY, run,
                           teng.EngineConfig(max_len=32, n_slots=1,
                                             page_size=8), device="cpu")
    with pytest.raises(ValueError):
        eng.submit(np.arange(1, 40), max_new_tokens=4)   # > max_len
    with pytest.raises(ValueError):
        eng.submit(np.asarray([], np.int64))             # empty prompt
    with pytest.raises(ValueError):
        eng.submit(np.asarray([1, 2]), max_new_tokens=0)


@pytest.mark.parametrize("page", [48, 128])
def test_engine_rejects_a_page_k6_cannot_run(tiny, page):
    """On a CUDA device with the decode steps on K6 (FT on the kernel
    backend, dh 128), a page K6 does not compile raises in the
    constructor, before any prefill; the device is only checked after
    that, so the check runs here without a card. With the xla backend
    (no K6) the same page is not refused for K6's sake."""
    _, tparams = tiny
    ec = teng.EngineConfig(max_len=1024, n_slots=2, page_size=page)
    run = TRun(model=T_TINY, ft=TFT(**PALLAS), dtype="bfloat16")
    with pytest.raises(ValueError, match="K6"):
        teng.ServeEngine(tparams, T_TINY, run, ec, device="cuda")
    xla = TRun(model=T_TINY, ft=TFT(action="correct", level="block",
                                    backend="xla"), dtype="bfloat16")
    if torch.cuda.is_available():
        teng.ServeEngine(tparams, T_TINY, xla, ec, device="cuda")
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            teng.ServeEngine(tparams, T_TINY, xla, ec, device="cuda")


def test_engine_clock_drives_ttft(tiny):
    """A caller's clock stamps each submission and first token: with a
    fake clock that advances 1.0 per reading, a request submitted at t = 0
    and admitted at once reads t = 1 at its first token."""
    _, tparams = tiny
    ticks = iter(range(1000))
    clock = lambda: float(next(ticks))     # noqa: E731
    run = TRun(model=T_TINY, ft=TFT(**PALLAS), dtype="float32")
    eng = teng.ServeEngine(tparams, T_TINY, run,
                           teng.EngineConfig(max_len=32, n_slots=1,
                                             page_size=8),
                           device="cpu", clock=clock)
    eng.submit(np.arange(1, 6), max_new_tokens=2)
    eng.submit(np.arange(1, 4), max_new_tokens=1)
    assert [r.t_submit for r in eng.queue] == [0.0, 1.0]
    res = eng.run()
    assert [r.ttft_s for r in res] == [2.0 - 0.0, 3.0 - 1.0]


def test_idle_engine_that_cannot_admit_raises(tiny):
    """A pool smaller than one request (slack 0.25): the idle engine raises
    instead of spinning, in both packages."""
    params, tparams = tiny
    prompt = np.arange(1, 29)
    ec = dict(max_len=32, n_slots=1, page_size=8, slack=0.25)
    reng_ = reng.ServeEngine(params, R_TINY,
                             RRun(model=R_TINY, ft=RFT(**PALLAS),
                                  dtype="float32"),
                             reng.EngineConfig(**ec))
    teng_ = teng.ServeEngine(tparams, T_TINY,
                             TRun(model=T_TINY, ft=TFT(**PALLAS),
                                  dtype="float32"),
                             teng.EngineConfig(**ec), device="cpu")
    for eng in (reng_, teng_):
        eng.submit(prompt, max_new_tokens=4)
        with pytest.raises(RuntimeError, match="idle engine"):
            eng.step()


@pytest.mark.parametrize("family", ["ssm", "moe"])
def test_engine_unsupported_family_raises(tiny, family):
    """Families without the transformer KV layout raise, as in the
    reference; the MoE family has that layout and is admitted."""
    _, tparams = tiny
    moe = TMoE(n_experts=4, top_k=2, expert_d_ff=32) if family == "moe" \
        else None
    cfg = dataclasses.replace(T_TINY, family=family, moe=moe)
    run = TRun(model=cfg, ft=TFT(**PALLAS), dtype="float32")
    if family == "moe":
        eng = teng.ServeEngine(tparams, cfg, run, teng.EngineConfig(),
                               device="cpu")
        assert eng.plan.page_size in tkv.DECODE_PAGES
        return
    with pytest.raises(NotImplementedError):
        teng.ServeEngine(tparams, cfg, run, teng.EngineConfig(),
                         device="cpu")
