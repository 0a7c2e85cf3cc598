"""Port ↔ reference: the serving slice end to end on the qwen2-7b and
phi4-mini-3.8b SMOKE configs in f32. Reference parameters from
`repro.models.transformer.init` go through the port's converter, then:

  * prefill and one decode step agree with the reference — logits and the
    KV cache to 1e-4 — on the kernel ("pallas") backend, with zero FT
    detections on both sides;
  * `generate` gives the reference's greedy tokens exactly
    (tests/test_torch_generate.py).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as rreg  # noqa: E402
from repro.configs.base import RunConfig as RRun  # noqa: E402
from repro.core import telemetry as rtel  # noqa: E402
from repro.core.policy import ONLINE_BLOCK as R_ONLINE  # noqa: E402
from repro.models import transformer as rtr  # noqa: E402
from repro.models.blocks import Ctx as RCtx  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.configs.base import RunConfig as TRun  # noqa: E402
from repro_torch.core import telemetry as ttel  # noqa: E402
from repro_torch.core.policy import ONLINE_BLOCK as T_ONLINE  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.models.blocks import Ctx as TCtx  # noqa: E402

ARCHS = ["qwen2-7b", "phi4-mini-3.8b"]
MAX_LEN, CHUNK = 32, 16


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    arch = request.param
    rcfg, tcfg = rreg.get_smoke(arch), treg.get_smoke(arch)
    params = rtr.init(rcfg, jax.random.PRNGKey(0), jnp.float32)
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, params),
                                        device="cpu")
    prompts = np.random.default_rng(1).integers(
        0, rcfg.vocab_size, (2, 8)).astype(np.int32)
    return rcfg, tcfg, params, tparams, prompts


def _runs(rcfg, tcfg, backend):
    return (RRun(model=rcfg, ft=R_ONLINE.replace(backend=backend),
                 dtype="float32", attn_chunk=CHUNK),
            TRun(model=tcfg, ft=T_ONLINE.replace(backend=backend),
                 dtype="float32", attn_chunk=CHUNK))


def test_converter_is_a_rename(model):
    _, _, params, tparams, _ = model
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    want = {".".join(k.key for k in path): np.asarray(x) for path, x in flat}
    got = tparams.state_dict()
    assert set(got) == set(want)
    for name, x in want.items():
        assert tuple(got[name].shape) == x.shape
        np.testing.assert_array_equal(got[name].numpy(), x)


def test_prefill_and_decode_match_reference(model):
    rcfg, tcfg, params, tparams, prompts = model
    rrun, trun = _runs(rcfg, tcfg, "pallas")
    rctx = RCtx(ft=rrun.ft, dtype=jnp.float32)
    tctx = TCtx(ft=trun.ft, dtype=torch.float32)
    with rtel.ft_scope() as rs:
        cache = rtr.init_cache(rcfg, 2, MAX_LEN, jnp.float32)
        rl, cache = rtr.prefill(params, jnp.asarray(prompts), cache, rcfg,
                                rctx, chunk=CHUNK, remat=False)
        tok = jnp.argmax(rl, -1)[:, None].astype(jnp.int32)
        rl2, cache = rtr.decode_step(params, tok, cache, rcfg, rctx)
        r_det = float(rs.report().detected)
    with torch.inference_mode(), ttel.ft_scope() as ts:
        tcache = ttr.init_cache(tcfg, 2, MAX_LEN, torch.float32, "cpu")
        tl, tcache = ttr.prefill(tparams, torch.from_numpy(prompts).long(),
                                 tcache, tcfg, tctx, chunk=CHUNK)
        ttok = torch.from_numpy(np.array(tok)).long()
        tl2, tcache = ttr.decode_step(tparams, ttok, tcache, tcfg, tctx)
        totals = ts.totals()
    for got, want in ((tl, rl), (tl2, rl2), (tcache["k"], cache["k"]),
                      (tcache["v"], cache["v"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-4)
    np.testing.assert_array_equal(tcache["length"].numpy(),
                                  np.asarray(cache["length"]))
    assert r_det == 0.0 and totals["detected"] == 0.0
    assert len(ts) > 0          # every protected call recorded a summary


