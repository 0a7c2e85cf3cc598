"""Port ↔ reference: mamba2 (the SSM family) on its SMOKE config (2 layers,
d 64, 8 SSD heads of 16, state 16, chunk 32) in f32, reference parameters
through the port's converter, the same numpy-seeded prompts.

  * `ssd_chunked` alone on the kernel backend at `block`, at 64 tokens
    (two chunks) and at 40 (not a multiple of the chunk: one chunk of 40
    rows): y and the last state within 1e-5 of the reference's largest
    value (the two sum in different orders in f32);
  * `forward` at block, tile and inner with one exactly representable SEU
    (64.0 at row 5, col 7, k-step 0 of slice 3) in layer 0's ``ssd_cb``:
    logits within 1e-4 of max |logit|, FT totals equal (1 detected, 1
    corrected), the located slice, row and col equal and the magnitude
    within 1e-2 (the port's K5 tiles differ from the reference's, so the
    reports are compared by their located cell, conformance rule 2);
  * `loss_fn`'s loss within 1e-5 relative;
  * the four SSD products stay protected with ``protect_attention=False``;
  * the serving functions at block: prefill and two decode steps fed the
    reference's greedy tokens, logits within 1e-4 of max |logit|, the SSM
    state within 1e-5 of its largest value and the bf16 conv window
    within one bf16 ulp; `generate`'s tokens equal to the reference's
    greedy tokens.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as rreg  # noqa: E402
from repro.configs.base import RunConfig as RRun  # noqa: E402
from repro.core.policy import FT_OFF as R_OFF  # noqa: E402
from repro.core.policy import ONLINE_BLOCK as R_ONLINE  # noqa: E402
from repro.core.policy import InjectionSpec as RSpec  # noqa: E402
from repro.kernels import ops as rops  # noqa: E402
from repro.models import mamba2 as rm2  # noqa: E402
from repro.models.blocks import Ctx as RCtx  # noqa: E402
from repro.train import serve as rserve  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.configs.base import RunConfig as TRun  # noqa: E402
from repro_torch.core import telemetry as ttel  # noqa: E402
from repro_torch.core.policy import FT_OFF as T_OFF  # noqa: E402
from repro_torch.core.policy import ONLINE_BLOCK as T_ONLINE  # noqa: E402
from repro_torch.core.policy import InjectionSpec as TSpec  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models import mamba2 as tm2  # noqa: E402
from repro_torch.models import model_zoo  # noqa: E402
from repro_torch.models.blocks import Ctx as TCtx  # noqa: E402
from repro_torch.train import serve as tserve  # noqa: E402

ARCH = "mamba2-780m"
BATCH, PROMPT, MAX_LEN = 2, 64, 96
SEU = dict(row=5, col=7, magnitude=64.0, k_step=0)
SEU_SLICE = 3
SSD_SITES = ("ssd_cb", "ssd_lx", "ssd_state", "ssd_ch")


@pytest.fixture(scope="module")
def model():
    rcfg, tcfg = rreg.get_smoke(ARCH), treg.get_smoke(ARCH)
    params = rm2.init(rcfg, jax.random.PRNGKey(0), jnp.float32)
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, params),
                                        device="cpu")
    tokens = np.random.default_rng(1).integers(
        0, rcfg.vocab_size, (BATCH, PROMPT)).astype(np.int32)
    return rcfg, tcfg, params, tparams, tokens


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _kernel_ft(level="block", **kw):
    return (R_ONLINE.replace(backend="pallas", level=level, **kw),
            T_ONLINE.replace(backend="pallas", level=level, **kw))


def test_config_params_and_dispatch(model):
    rcfg, tcfg, params, tparams, _ = model
    for get_r, get_t in ((rreg.get_config, treg.get_config),
                         (rreg.get_smoke, treg.get_smoke)):
        assert dataclasses.asdict(get_t(ARCH)) == \
            dataclasses.asdict(get_r(ARCH))
    assert model_zoo.module_for(tcfg) is tm2
    assert set(model_zoo.input_specs(tcfg, BATCH, PROMPT, "prefill")) == \
        {"tokens"}
    ref = _flat(params)
    got = {k: v.numpy() for k, v in tparams.state_dict().items()}
    assert sorted(got) == sorted(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k])
    # the port's own init has the reference's layout and dtypes
    own = tm2.init(tcfg, seed=0, dtype=torch.float32, device="cpu")
    assert {k: (tuple(v.shape), str(v.numpy().dtype))
            for k, v in own.state_dict().items()} == \
        {k: (v.shape, str(v.dtype)) for k, v in ref.items()}


@pytest.mark.parametrize("length", [64, 40])
def test_ssd_chunked_matches_reference(model, length):
    """At 40 tokens the chunk rule makes the whole prompt one chunk, so K5
    takes 40 rows."""
    rcfg = model[0]
    sc = rcfg.ssm
    d_inner, h, n, g = rm2.dims(rcfg)
    rng = np.random.default_rng(length)
    x = rng.normal(size=(BATCH, length, h, sc.head_dim)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(BATCH, length, h)))).astype(
        np.float32)
    a = -np.exp(np.log(np.linspace(1.0, 16.0, h))).astype(np.float32)
    bm = rng.normal(size=(BATCH, length, g, n)).astype(np.float32)
    cm = rng.normal(size=(BATCH, length, g, n)).astype(np.float32)
    d_skip = rng.normal(size=(h,)).astype(np.float32)
    rft, tft = _kernel_ft()
    y_r, h_r = rm2.ssd_chunked(*map(jnp.asarray, (x, dt, a, bm, cm, d_skip)),
                               sc, RCtx(ft=rft, dtype=jnp.float32))
    with ttel.ft_scope() as scope:
        y_t, h_t = tm2.ssd_chunked(*map(torch.as_tensor,
                                        (x, dt, a, bm, cm, d_skip)),
                                   sc, TCtx(ft=tft, dtype=torch.float32))
    for got, want in ((y_t, y_r), (h_t, h_r)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
    assert scope.sites() == set(SSD_SITES)
    assert scope.totals()["detected"] == 0.0


def _layer0_cb_seu_reference(monkeypatch, reps):
    """Patch the reference so that layer 0's first batched product (its
    ``ssd_cb``) takes the SEU in slice SEU_SLICE: the layer scan is traced
    once, so the magnitude is 64.0 where the folded layer index is 0 and 0
    elsewhere (which lands nothing)."""
    tags, state = [], {"calls": 0}
    orig_fold, orig_call = RCtx.fold, rops.grouped_gemm_call

    def fold(self, tag):
        tags.append(tag)
        state["calls"] = 0
        return orig_fold(self, tag)

    def call(spec, a, b, **kw):
        state["calls"] += 1
        if state["calls"] > 1 or not tags:
            return orig_call(spec, a, b, **kw)
        mag = jnp.where(tags[-1] == 0, SEU["magnitude"], 0.0)
        out, rep = orig_call(spec, a, b, **dict(
            kw, inject=RSpec(**dict(SEU, magnitude=mag)),
            inj_batch=SEU_SLICE))
        jax.debug.callback(lambda r: reps.append(np.asarray(r)), rep)
        return out, rep

    monkeypatch.setattr(RCtx, "fold", fold)
    monkeypatch.setattr(rops, "grouped_gemm_call", call)


def _first_cb_seu_port(monkeypatch, reps):
    """Patch the port so that its first batched product (layer 0's
    ``ssd_cb``) takes the SEU in slice SEU_SLICE."""
    orig = tops.grouped_gemm_call

    def call(spec, a, b, **kw):
        if reps:
            return orig(spec, a, b, **kw)
        out, rep = orig(spec, a, b, **dict(kw, inject=TSpec(**SEU),
                                           inj_batch=SEU_SLICE))
        reps.append(rep.numpy())
        return out, rep

    monkeypatch.setattr(tops, "grouped_gemm_call", call)


def _located(rep):
    hit = np.argwhere(rep[..., 0] > 0)
    assert len(hit) == 1
    cell = rep[tuple(hit[0])]
    return int(hit[0][0]), int(cell[2]), int(cell[3]), float(cell[4])


@pytest.mark.parametrize("level", ["block", "tile", "inner"])
def test_forward_with_ssd_cb_seu_matches_reference(model, level,
                                                   monkeypatch):
    rcfg, tcfg, params, tparams, tokens = model
    rft, tft = _kernel_ft(level)
    tctx = TCtx(ft=tft, dtype=torch.float32)
    tok_t = torch.as_tensor(tokens).long()
    with torch.no_grad():
        clean, _ = tm2.forward(tparams, tok_t, tcfg, tctx)
    r_reps, t_reps = [], []
    _layer0_cb_seu_reference(monkeypatch, r_reps)
    _first_cb_seu_port(monkeypatch, t_reps)
    want, aux = rm2.forward(params, jnp.asarray(tokens), rcfg,
                            RCtx(ft=rft, dtype=jnp.float32))
    with ttel.ft_scope() as scope, torch.no_grad():
        got, _ = tm2.forward(tparams, tok_t, tcfg, tctx)
    want = np.asarray(want)
    scale = np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * scale)
    np.testing.assert_allclose(got.numpy(), clean.numpy(), rtol=0,
                               atol=1e-5 * scale)
    tot = scope.totals()
    assert (tot["detected"], tot["corrected"]) == \
        (float(aux.ft.detected), float(aux.ft.corrected)) == (1.0, 1.0)
    assert scope.site_totals()["ssd_cb"]["detected"] == 1.0
    # the reference's scan ran the patched product once per layer
    assert len(r_reps) == rcfg.n_layers and len(t_reps) == 1
    assert not r_reps[1][..., 0].any()
    (s0, r0, c0, m0), (s1, r1, c1, m1) = _located(r_reps[0]), \
        _located(t_reps[0])
    assert (s1, r1, c1) == (s0, r0, c0) == (SEU_SLICE, SEU["row"],
                                            SEU["col"])
    assert abs(m1 - m0) < 1e-2 and abs(m1 - SEU["magnitude"]) < 1e-2


def test_loss_matches_reference(model):
    rcfg, tcfg, params, tparams, tokens = model
    labels = np.roll(tokens, -1, axis=1)
    want, _ = rm2.loss_fn(params, {"tokens": jnp.asarray(tokens),
                                   "labels": jnp.asarray(labels)}, rcfg,
                          RCtx(ft=R_OFF, dtype=jnp.float32))
    with torch.no_grad():
        got, metrics = tm2.loss_fn(
            tparams, {"tokens": torch.as_tensor(tokens).long(),
                      "labels": torch.as_tensor(labels).long()}, tcfg,
            TCtx(ft=T_OFF, dtype=torch.float32))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    assert float(metrics["ce"]) == float(got) and float(metrics["aux"]) == 0


def test_ssd_products_protected_without_protect_attention(model,
                                                          monkeypatch):
    """The SSD products take the context's FT whatever
    ``protect_attention`` says (not `Ctx.bdot`'s rule): with it off, each
    of the four records its summary and the ssd_cb SEU is corrected, the
    logits those of the run with it on."""
    _, tcfg, _, tparams, tokens = model
    tok_t = torch.as_tensor(tokens).long()
    logits = []
    for protect in (True, False):
        reps = []
        with monkeypatch.context() as m:
            _first_cb_seu_port(m, reps)
            ctx = TCtx(ft=_kernel_ft(protect_attention=protect)[1],
                       dtype=torch.float32)
            with ttel.ft_scope() as scope, torch.no_grad():
                logits.append(tm2.forward(tparams, tok_t, tcfg, ctx)[0])
        assert set(SSD_SITES) <= scope.sites()
        tot = scope.totals()
        assert (tot["detected"], tot["corrected"]) == (1.0, 1.0)
    assert torch.equal(logits[0], logits[1])


def test_serving_matches_reference(model):
    rcfg, tcfg, params, tparams, tokens = model
    rrun = RRun(model=rcfg, ft=_kernel_ft()[0], dtype="float32")
    trun = TRun(model=tcfg, ft=_kernel_ft()[1], dtype="float32")
    r_pre, r_dec = rserve.make_serve_fns(rcfg, rrun)
    t_pre, t_dec = tserve.make_serve_fns(tcfg, trun)
    r_cache = rm2.init_cache(rcfg, BATCH, MAX_LEN, jnp.float32)
    t_cache = tm2.init_cache(tcfg, BATCH, MAX_LEN, torch.float32, "cpu")
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in t_cache.items()} == \
        {k: (v.shape, str(v.dtype)) for k, v in r_cache.items()}
    r_lg, r_cache = r_pre(params, jnp.asarray(tokens), r_cache)
    t_lg, t_cache = t_pre(tparams, torch.as_tensor(tokens).long(), t_cache)
    greedy = []
    for step in range(3):
        want = np.asarray(r_lg).reshape(BATCH, -1)
        np.testing.assert_allclose(t_lg.reshape(BATCH, -1).numpy(), want,
                                   rtol=0, atol=1e-4 * np.abs(want).max(),
                                   err_msg=f"step {step}")
        ssm = np.asarray(r_cache["ssm"])
        np.testing.assert_allclose(t_cache["ssm"].numpy(), ssm, rtol=0,
                                   atol=1e-5 * np.abs(ssm).max())
        conv = np.asarray(r_cache["conv"]).astype(np.float32)
        np.testing.assert_allclose(t_cache["conv"].float().numpy(), conv,
                                   rtol=2.0 ** -8, atol=1e-6)
        assert np.array_equal(t_cache["length"].numpy(),
                              np.asarray(r_cache["length"]))
        tok = np.argmax(want, -1).astype(np.int32)[:, None]
        greedy.append(tok)
        if step == 2:
            break
        r_lg, r_cache = r_dec(params, jnp.asarray(tok), r_cache)
        t_lg, t_cache = t_dec(tparams, torch.as_tensor(tok).long(), t_cache)
    out = tserve.generate(tparams, tokens, tcfg, trun,
                          tserve.ServeConfig(max_len=MAX_LEN),
                          max_new_tokens=3, device="cpu")
    np.testing.assert_array_equal(out, np.concatenate(greedy, axis=1))
