"""Port ↔ reference: the MoE layer and the MoE family, on the SMOKE configs of
qwen3-moe-235b-a22b (8 experts, top-4) and arctic-480b (8 experts, top-2,
plus the parallel dense MLP) in f32, reference parameters through the
port's converter.

  * `apply_moe`, grouped (the default) and padded (the capacity baseline
    on the batched kernel): routing indices first (the top-k margin is
    printed: where two f32 router probabilities differ by rounding, top-k
    may flip), then y and the aux loss;
  * forward logits and `loss_fn` (loss, ce, aux) with every gradient leaf;
  * two train steps (the second with lr > 0): loss, grad norm, lr, FT
    counters, the updated parameters and AdamW moments;
  * greedy `generate` tokens, and a `ServeEngine` run on qwen3-moe (4
    requests on 2 slots) token for token against the reference engine.

The port runs its kernel backend (the plain versions of K1, K2, K5, K7 and
K8 on the CPU) and its torch-op backend; the reference runs its op-level
("xla") backend, which computes the same function. Tolerance: 1e-5
relative and absolute on values, losses and parameters (f32 sums taken in
another order); 2e-5 on gradients, whose sums run over more terms; tokens
and routing indices exactly.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as rreg  # noqa: E402
from repro.configs.base import RunConfig as RRun  # noqa: E402
from repro.core.policy import FTConfig as RFT  # noqa: E402
from repro.models import blocks as rblocks  # noqa: E402
from repro.models import moe as rmoe  # noqa: E402
from repro.models import transformer as rtr  # noqa: E402
from repro.optim import adamw as radamw  # noqa: E402
from repro.train import engine as reng  # noqa: E402
from repro.train import serve as rserve  # noqa: E402
from repro.train import train_loop as rtl  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.configs.base import RunConfig as TRun  # noqa: E402
from repro_torch.core import telemetry as ttel  # noqa: E402
from repro_torch.core.policy import FTConfig as TFT  # noqa: E402
from repro_torch.models import blocks as tblocks  # noqa: E402
from repro_torch.models import model_zoo  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.train import engine as teng  # noqa: E402
from repro_torch.train import serve as tserve  # noqa: E402
from repro_torch.train import train_loop as ttl  # noqa: E402

ARCHS = ["qwen3-moe-235b-a22b", "arctic-480b"]
BACKENDS = ["pallas", "xla"]
CHUNK = 16
R_FT = RFT(backend="xla")


def _close(got, want, what, tol=1e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol,
                               err_msg=what)


def _flat(tree):
    return {".".join(p.key for p in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    arch = request.param
    rcfg, tcfg = rreg.get_smoke(arch), treg.get_smoke(arch)
    params = rtr.init(rcfg, jax.random.PRNGKey(0), jnp.float32)
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, params),
                                        device="cpu")
    return rcfg, tcfg, params, tparams


# ---------------------------------------------------------------------------
# the MoE layer
# ---------------------------------------------------------------------------

def _layer(model, dispatch):
    rcfg, tcfg, params, tparams = model
    rmc = dataclasses.replace(rcfg.moe, dispatch=dispatch)
    tmc = dataclasses.replace(tcfg.moe, dispatch=dispatch)
    rp = jax.tree.map(lambda a: a[0], params["layers"]["moe"])
    tp = {k: v[0] for k, v in tparams.layers.moe.named_parameters()}
    x = np.random.default_rng(2).standard_normal(
        (2, 12, rcfg.d_model)).astype(np.float32)
    return rmc, tmc, rp, tp, x


@pytest.mark.parametrize("dispatch", ["grouped", "padded"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_apply_moe_matches_reference(model, backend, dispatch):
    rmc, tmc, rp, tp, x = _layer(model, dispatch)
    xt = x.reshape(-1, x.shape[-1])
    # Routing first: the same experts, with the top-k margin printed.
    _, ridx, raux = rmoe._routing(jnp.asarray(xt), rp["router"], rmc)
    gv, tidx, taux = tmoe._routing(torch.from_numpy(xt), tp["router"], tmc)
    probs = torch.softmax(torch.from_numpy(xt) @ tp["router"], -1)
    top = torch.topk(probs, tmc.top_k + 1, -1).values
    print(f"top-k margin (k-th minus (k+1)-th probability): min "
          f"{float((top[:, -2] - top[:, -1]).min()):.3g}")
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(ridx))
    _close(taux, raux, "routing aux")
    rctx = rblocks.Ctx(ft=R_FT, dtype=jnp.float32, attn_shard="none")
    tctx = tblocks.Ctx(ft=TFT(backend=backend), dtype=torch.float32)
    want, waux = rmoe.apply_moe(rp, jnp.asarray(x), rmc, rctx)
    with ttel.ft_scope() as scope:
        got, gaux = tmoe.apply_moe(tp, torch.from_numpy(x), tmc, tctx)
        sites = scope.site_totals()
    _close(got, want, f"{dispatch} y")
    _close(gaux, waux, f"{dispatch} aux")
    assert {"moe_gate", "moe_up", "moe_down"} <= set(sites)
    assert all(t["detected"] == 0.0 for t in sites.values())


def test_apply_moe_bad_dispatch_raises(model):
    rmc, tmc, rp, tp, x = _layer(model, "grouped")
    with pytest.raises(ValueError, match="dispatch"):
        tmoe.apply_moe(tp, torch.from_numpy(x),
                       dataclasses.replace(tmc, dispatch="dense"),
                       tblocks.Ctx(dtype=torch.float32))
    assert tmoe.capacity(64, tmc) == rmoe.capacity(64, rmc)
    for b, s in ((2, 12), (4, 1), (1, 64), (3, 7)):
        assert tmoe._group_geometry(b, s, tmc) == \
            rmoe._group_geometry(b, s, rmc)


# ---------------------------------------------------------------------------
# the model: forward, loss and grads
# ---------------------------------------------------------------------------

def _batch(vocab, seed=7, b=2, s=16):
    tok = np.random.default_rng(seed).integers(0, vocab, (b, s + 1))
    return {"tokens": tok[:, :-1].astype(np.int32),
            "labels": tok[:, 1:].astype(np.int32)}


@pytest.fixture(scope="module")
def reference_loss(model):
    """The reference's logits, aux, loss, metrics and grads on one batch
    (computed once for both port backends)."""
    rcfg, _, params, _ = model
    batch = _batch(rcfg.vocab_size)
    rctx = rblocks.Ctx(ft=R_FT, dtype=jnp.float32, attn_shard="none")
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def rloss(p):
        return rtr.loss_fn(p, jb, rcfg, rctx, remat=False, chunk=CHUNK)

    (rl, rmet), rgrads = jax.jit(jax.value_and_grad(rloss, has_aux=True))(
        params)
    rlogits, raux = jax.jit(lambda p: rtr.forward(
        p, jb["tokens"], rcfg, rctx, remat=False, chunk=CHUNK))(params)
    return dict(batch=batch, loss=rl, met=rmet, grads=_flat(rgrads),
                logits=rlogits, aux=raux.balance)


@pytest.mark.parametrize("backend", BACKENDS)
def test_forward_loss_and_grads_match_reference(model, reference_loss,
                                                backend):
    _, tcfg, _, tparams = model
    ref = reference_loss
    tctx = tblocks.Ctx(ft=TFT(backend=backend), dtype=torch.float32)
    tb = {k: torch.as_tensor(v).long() for k, v in ref["batch"].items()}
    with torch.no_grad():
        tlogits, taux = ttr.forward(tparams, tb["tokens"], tcfg, tctx,
                                    remat=False, chunk=CHUNK)
    _close(tlogits, ref["logits"], "logits")
    _close(taux, ref["aux"], "aux")
    tparams.requires_grad_(True)
    try:
        tl, tmet = ttr.loss_fn(tparams, tb, tcfg, tctx, remat="full",
                               chunk=CHUNK)
        tl.backward()
        _close(tl, ref["loss"], "loss")
        _close(tmet["ce"], ref["met"]["ce"], "ce")
        _close(tmet["aux"], ref["met"]["aux"], "aux metric")
        assert float(tmet["aux"]) > 0.0
        assert float(tmet["ft"].detected) == 0.0
        named = dict(tparams.named_parameters())
        for key, leaf in ref["grads"].items():
            _close(named[key].grad, leaf, f"grad {key}", tol=2e-5)
    finally:
        for p in tparams.parameters():
            p.grad = None
        tparams.requires_grad_(False)


def test_two_train_steps_match_reference(model):
    rcfg, tcfg, params, _ = model
    tc = dict(total_steps=3, warmup_steps=1)
    rrun = RRun(model=rcfg, ft=R_FT, dtype="float32", attn_chunk=CHUNK)
    trun = TRun(model=tcfg, ft=TFT(backend="pallas"), dtype="float32",
                attn_chunk=CHUNK)
    ropt, topt = radamw.AdamWConfig(), tadamw.AdamWConfig()
    rtc, ttc = rtl.TrainConfig(**tc), ttl.TrainConfig(**tc)
    rstate = rtl.init_opt_state(params, ropt, rtc)
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, params),
                                        device="cpu")
    tparams.requires_grad_(True)
    tstate = convert.opt_state_from_numpy(jax.tree.map(np.asarray, rstate),
                                          device="cpu")
    rstep = jax.jit(rtl.make_train_step(rcfg, rrun, ropt, rtc))
    tstep = ttl.make_train_step(tcfg, trun, topt, ttc)
    for step in range(2):
        batch = _batch(rcfg.vocab_size, seed=11 + step)
        params, rstate, rmet = rstep(
            params, rstate, {k: jnp.asarray(v) for k, v in batch.items()},
            jnp.asarray(step))
        tparams, tstate, tmet = tstep(
            tparams, tstate, {k: torch.as_tensor(v).long()
                              for k, v in batch.items()}, step)
        for name in ("loss", "grad_norm", "lr", "aux"):
            _close(tmet[name], rmet[name], f"step {step} {name}")
        for name in ("detected", "corrected"):
            assert float(getattr(tmet["ft"], name)) == float(
                getattr(rmet["ft"], name)) == 0.0
    assert float(tmet["lr"]) > 0.0
    named = dict(tparams.named_parameters())
    rm, rv = _flat(rstate["adam"]["m"]), _flat(rstate["adam"]["v"])
    for key, leaf in _flat(params).items():
        _close(named[key], leaf, f"param {key}")
        _close(tstate["adam"]["m"][key], rm[key], f"m {key}")
        _close(tstate["adam"]["v"][key], rv[key], f"v {key}")


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference_tokens(model):
    rcfg, _, params, _ = model
    prompts = np.random.default_rng(1).integers(
        0, rcfg.vocab_size, (2, 8)).astype(np.int32)
    want = rserve.generate(params, prompts, rcfg,
                           RRun(model=rcfg, ft=R_FT, dtype="float32",
                                attn_chunk=CHUNK),
                           rserve.ServeConfig(max_len=32), max_new_tokens=6)
    return prompts, np.asarray(want)


@pytest.mark.parametrize("backend", BACKENDS)
def test_generate_matches_reference_tokens(model, reference_tokens, backend):
    _, tcfg, _, tparams = model
    prompts, want = reference_tokens
    got = tserve.generate(tparams, prompts, tcfg,
                          TRun(model=tcfg, ft=TFT(backend=backend),
                               dtype="float32", attn_chunk=CHUNK),
                          tserve.ServeConfig(max_len=32), max_new_tokens=6,
                          device="cpu")
    np.testing.assert_array_equal(got, want)


def test_engine_matches_reference_engine():
    """qwen3-moe SMOKE: 4 requests on 2 slots (queueing, slot reuse), pages
    of 8, against the reference engine; every page comes back and the MoE
    sites are in the telemetry scope with no detection."""
    rcfg = rreg.get_smoke("qwen3-moe-235b-a22b")
    tcfg = treg.get_smoke("qwen3-moe-235b-a22b")
    params = rtr.init(rcfg, jax.random.PRNGKey(3), jnp.float32)
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, params),
                                        device="cpu")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(1, rcfg.vocab_size, (n,)) for n in (5, 13, 9, 3)]
    budgets = [5, 3, 6, 4]
    ec = dict(max_len=32, n_slots=2, page_size=8)
    r = reng.ServeEngine(params, rcfg, RRun(model=rcfg, ft=R_FT,
                                            dtype="float32"),
                         reng.EngineConfig(**ec))
    t = teng.ServeEngine(tparams, tcfg,
                         TRun(model=tcfg, ft=TFT(backend="pallas"),
                              dtype="float32"),
                         teng.EngineConfig(**ec), device="cpu")
    for p_, m in zip(prompts, budgets):
        r.submit(p_, max_new_tokens=m)
        t.submit(p_, max_new_tokens=m)
    want = r.run()
    with ttel.ft_scope() as scope:
        got = t.run()
        sites = scope.site_totals()
    assert [g.tokens for g in got] == [w.tokens for w in want]
    assert [len(g.tokens) for g in got] == budgets
    assert t.alloc.n_free == t.plan.n_pages - 1
    assert {"moe_gate", "moe_up", "moe_down", "dec_page_qk"} <= set(sites)
    assert all(v["detected"] == 0.0 for v in sites.values())


def test_moe_family_is_served_by_the_transformer():
    for arch in ARCHS:
        cfg = treg.get_config(arch)
        assert model_zoo.module_for(cfg) is ttr
        assert cfg == dataclasses.replace(treg.get_config(arch))
        assert dataclasses.asdict(cfg) == dataclasses.asdict(
            rreg.get_config(arch))
        assert dataclasses.asdict(treg.get_smoke(arch)) == \
            dataclasses.asdict(rreg.get_smoke(arch))
    with pytest.raises(NotImplementedError):
        ttr.init(dataclasses.replace(treg.get_smoke(ARCHS[0]), moe=None),
                 dtype=torch.float32, device="cpu")


def test_launchers_take_the_moe_arch_ids(capsys):
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch import train as train_cli
    out = train_cli.main(["--arch", "qwen3-moe-235b-a22b-smoke", "--device",
                          "cpu", "--dtype", "float32", "--steps", "2",
                          "--batch", "2", "--seq", "8"])
    assert out["final_step"] == 2
    assert all(np.isfinite(h["loss"]) and h["aux"] > 0.0
               and h["detected"] == 0.0 for h in out["history"])
    import sys
    argv = sys.argv
    sys.argv = ["serve", "--arch", "arctic-480b-smoke", "--device", "cpu",
                "--dtype", "float32", "--batch", "2", "--prompt-len", "4",
                "--new-tokens", "2", "--max-len", "8"]
    try:
        serve_cli.main()
    finally:
        sys.argv = argv
    assert "generated (2, 2) tokens" in capsys.readouterr().out
