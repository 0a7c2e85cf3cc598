"""Port ↔ reference: whisper (the encoder-decoder family) on its SMOKE
config (2 + 2 layers, d 64, 32 frames) in f32, reference parameters through
the port's converter, the same numpy-seeded prompts and frame embeddings.

  * `forward` at block, tile and inner with the same exactly representable
    SEU (64.0 at row 5, col 7, k-step 0) in every encoder layer's ``w1``
    (the gelu chain): logits within 1e-4 of the reference's (max |logit|
    about 0.6; the two sum in different orders in f32) and within 1e-5 of
    the port's clean run; FT totals equal (2 detected, 2 corrected); the
    located global row and col equal and the magnitude within 1e-2;
  * the serving functions at block: prefill and two decode steps fed the
    reference's greedy tokens, logits within 1e-4; `generate`'s tokens
    equal to the reference's greedy tokens.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as rreg  # noqa: E402
from repro.configs.base import RunConfig as RRun  # noqa: E402
from repro.core.policy import ONLINE_BLOCK as R_ONLINE  # noqa: E402
from repro.core.policy import InjectionSpec as RSpec  # noqa: E402
from repro.kernels import ops as rops  # noqa: E402
from repro.models import whisper as rwh  # noqa: E402
from repro.models.blocks import Ctx as RCtx  # noqa: E402
from repro.train import serve as rserve  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.configs.base import RunConfig as TRun  # noqa: E402
from repro_torch.core import telemetry as ttel  # noqa: E402
from repro_torch.core.policy import ONLINE_BLOCK as T_ONLINE  # noqa: E402
from repro_torch.core.policy import InjectionSpec as TSpec  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.models import model_zoo  # noqa: E402
from repro_torch.models import whisper as twh  # noqa: E402
from repro_torch.models.blocks import Ctx as TCtx  # noqa: E402
from repro_torch.train import serve as tserve  # noqa: E402

ARCH = "whisper-medium"
BATCH, PROMPT, CHUNK, MAX_LEN = 2, 8, 16, 32
SEU = dict(row=5, col=7, magnitude=64.0, k_step=0)
ATOL = 1e-4


@pytest.fixture(scope="module")
def model():
    rcfg, tcfg = rreg.get_smoke(ARCH), treg.get_smoke(ARCH)
    params = rwh.init(rcfg, jax.random.PRNGKey(0), jnp.float32)
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, params),
                                        device="cpu")
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, rcfg.vocab_size, (BATCH, PROMPT)).astype(
        np.int32)
    frames = rng.normal(size=(BATCH, rcfg.n_audio_frames,
                              rcfg.d_model)).astype(np.float32)
    return rcfg, tcfg, params, tparams, tokens, frames


def test_config_params_and_dispatch(model):
    rcfg, tcfg, params, tparams, _, _ = model
    assert model_zoo.module_for(tcfg) is twh
    ref = _flat(params)
    got = {k: v.numpy() for k, v in tparams.state_dict().items()}
    assert sorted(got) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k])
    spec = model_zoo.input_specs(tcfg, BATCH, PROMPT, "prefill")
    assert spec["frames"][0] == (BATCH, rcfg.n_audio_frames, rcfg.d_model)
    # the port's own init has the reference's layout
    own = twh.init(tcfg, seed=0, dtype=torch.float32, device="cpu")
    assert {k: tuple(v.shape) for k, v in own.state_dict().items()} == \
        {k: v.shape for k, v in ref.items()}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _enc_w1(kw, a, rows):
    """Whether a fused call is an encoder layer's w1: the gelu chain over
    the B x T_a frame rows."""
    return kw.get("act") == "gelu" and a.shape[0] == rows


@pytest.mark.parametrize("level", ["block", "tile", "inner"])
def test_forward_with_w1_seu_matches_reference(model, level, monkeypatch):
    rcfg, tcfg, params, tparams, tokens, frames = model
    rows = BATCH * rcfg.n_audio_frames
    r_reps, t_reps = [], []
    r_orig, t_orig = rops.fused_matmul, tops.fused_matmul

    def r_patched(a, b, **kw):
        if not _enc_w1(kw, a, rows):
            return r_orig(a, b, **kw)
        out, rep = r_orig(a, b, **dict(kw, inject=RSpec(**SEU)))
        jax.debug.callback(lambda r: r_reps.append(np.asarray(r)), rep)
        return out, rep

    def t_patched(a, b, **kw):
        if not _enc_w1(kw, a, rows):
            return t_orig(a, b, **kw)
        out, rep = t_orig(a, b, **dict(kw, inject=TSpec(**SEU)))
        t_reps.append(rep.numpy())
        return out, rep

    rft = R_ONLINE.replace(backend="pallas", level=level)
    tft = T_ONLINE.replace(backend="pallas", level=level)
    tctx = TCtx(ft=tft, dtype=torch.float32)
    tok_t = torch.as_tensor(tokens).long()
    frames_t = torch.as_tensor(frames)
    with torch.no_grad():
        clean, _ = twh.forward(tparams, tok_t, tcfg, tctx, frames=frames_t,
                               chunk=CHUNK)
    monkeypatch.setattr(rops, "fused_matmul", r_patched)
    monkeypatch.setattr(tops, "fused_matmul", t_patched)
    want, aux = rwh.forward(params, jnp.asarray(tokens), rcfg,
                            RCtx(ft=rft, dtype=jnp.float32),
                            frames=jnp.asarray(frames), chunk=CHUNK)
    with ttel.ft_scope() as scope, torch.no_grad():
        got, _ = twh.forward(tparams, tok_t, tcfg, tctx, frames=frames_t,
                             chunk=CHUNK)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(got.numpy(), clean.numpy(), rtol=0, atol=1e-5)
    tot = scope.totals()
    assert (tot["detected"], tot["corrected"]) == \
        (float(aux.ft.detected), float(aux.ft.corrected)) == \
        (rcfg.enc_layers, rcfg.enc_layers)
    assert scope.site_totals()["w1"]["detected"] == rcfg.enc_layers
    assert len(r_reps) == len(t_reps) == rcfg.enc_layers

    def located(rep):
        hit = rep[rep[..., 0] > 0]
        assert len(hit) == 1
        return int(hit[0, 2]), int(hit[0, 3]), float(hit[0, 4])

    for rr, tr in zip(r_reps, t_reps):
        (r0, c0, m0), (r1, c1, m1) = located(rr), located(tr)
        assert (r1, c1) == (r0, c0) == (SEU["row"], SEU["col"])
        assert abs(m1 - m0) < 1e-2 and abs(m1 - SEU["magnitude"]) < 1e-2


def test_serving_matches_reference(model):
    rcfg, tcfg, params, tparams, tokens, frames = model
    rrun = RRun(model=rcfg, ft=R_ONLINE.replace(backend="pallas"),
                dtype="float32", attn_chunk=CHUNK)
    trun = TRun(model=tcfg, ft=T_ONLINE.replace(backend="pallas"),
                dtype="float32", attn_chunk=CHUNK)
    r_pre, r_dec = rserve.make_serve_fns(rcfg, rrun)
    t_pre, t_dec = tserve.make_serve_fns(tcfg, trun)
    r_cache = rwh.init_cache(rcfg, BATCH, MAX_LEN, jnp.float32)
    t_cache = twh.init_cache(tcfg, BATCH, MAX_LEN, torch.float32, "cpu")
    r_lg, r_cache = r_pre(params, jnp.asarray(tokens), r_cache,
                          jnp.asarray(frames))
    t_lg, t_cache = t_pre(tparams, torch.as_tensor(tokens).long(), t_cache,
                          torch.as_tensor(frames))
    greedy = []
    for step in range(4):
        np.testing.assert_allclose(t_lg.reshape(BATCH, -1).numpy(),
                                   np.asarray(r_lg).reshape(BATCH, -1),
                                   rtol=0, atol=ATOL, err_msg=f"step {step}")
        tok = np.asarray(jnp.argmax(r_lg.reshape(BATCH, -1), -1)).astype(
            np.int32)[:, None]
        greedy.append(tok)
        if step == 3:
            break
        r_lg, r_cache = r_dec(params, jnp.asarray(tok), r_cache)
        t_lg, t_cache = t_dec(tparams, torch.as_tensor(tok).long(), t_cache)
    assert int(t_cache["length"][0]) == PROMPT + 3
    out = tserve.generate(tparams, tokens, tcfg, trun,
                          tserve.ServeConfig(max_len=MAX_LEN),
                          max_new_tokens=4, extra=frames, device="cpu")
    np.testing.assert_array_equal(out, np.concatenate(greedy, axis=1))
