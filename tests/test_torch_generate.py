"""Port ↔ reference: `generate` on the qwen2-7b and phi4-mini-3.8b SMOKE
configs in f32, reference parameters through the port's converter, gives
the reference's greedy tokens exactly (2 prompts × 8 new tokens) on the
kernel ("pallas") backend and on the xla backend; temperature sampling is
seeded by a `torch.Generator`.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as rreg  # noqa: E402
from repro.configs.base import RunConfig as RRun  # noqa: E402
from repro.core.policy import ONLINE_BLOCK as R_ONLINE  # noqa: E402
from repro.models import transformer as rtr  # noqa: E402
from repro.train import serve as rserve  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.configs.base import RunConfig as TRun  # noqa: E402
from repro_torch.core.policy import ONLINE_BLOCK as T_ONLINE  # noqa: E402
from repro_torch.train import serve as tserve  # noqa: E402

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


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_generate_matches_reference_tokens(model, backend):
    rcfg, tcfg, params, tparams, prompts = model
    rrun, trun = _runs(rcfg, tcfg, backend)
    want = rserve.generate(params, prompts, rcfg, rrun,
                           rserve.ServeConfig(max_len=MAX_LEN),
                           max_new_tokens=8)
    got = tserve.generate(tparams, prompts, tcfg, trun,
                          tserve.ServeConfig(max_len=MAX_LEN),
                          max_new_tokens=8, device="cpu")
    np.testing.assert_array_equal(got, np.asarray(want))


def test_temperature_sampling_is_seeded(model):
    _, tcfg, _, tparams, prompts = model
    _, trun = _runs(tcfg, tcfg, "pallas")
    sc = tserve.ServeConfig(max_len=MAX_LEN, temperature=0.8)
    a, b = (tserve.generate(tparams, prompts, tcfg, trun, sc,
                            max_new_tokens=4, seed=7, device="cpu")
            for _ in range(2))
    np.testing.assert_array_equal(a, b)
    assert a.shape == (2, 4) and a.min() >= 0 and a.max() < tcfg.vocab_size
