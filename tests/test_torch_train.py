"""Port ↔ reference: `loss_fn` and its gradients on the qwen2-7b SMOKE
config (qkv bias) and the phi4-mini-3.8b SMOKE config, f32, kernel
("pallas") backend, ``remat="full"``. Reference parameters from
`repro.models.transformer.init` go through the port's converter; the same
numpy tokens feed both sides. The reference runs its Pallas kernels in
interpret mode; the port runs its plain kernel versions (K1 with act_grad,
K2 with the saved statistics, K3, K4).

Tolerances: the loss and every gradient leaf to 1e-4 relative (Frobenius
norm of the difference over the leaf's norm): f32 sums in other orders
through the whole model. The FT counters are equal (zero detections), and
the port records each protected call once although the checkpoint
recomputes every layer in the backward.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as rreg  # noqa: E402
from repro.core.policy import ONLINE_BLOCK as R_ONLINE  # noqa: E402
from repro.models import transformer as rtr  # noqa: E402
from repro.models.blocks import Ctx as RCtx  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.core import telemetry as ttel  # noqa: E402
from repro_torch.core.policy import ONLINE_BLOCK as T_ONLINE  # noqa: E402
from repro_torch.kernels import flashft, ft_gemm  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.models.blocks import Ctx as TCtx  # noqa: E402

CHUNK = 16


def _batch(vocab, seed=1, b=2, s=16):
    tok = np.random.default_rng(seed).integers(0, vocab, (b, s + 1))
    return {"tokens": tok[:, :-1].astype(np.int32),
            "labels": tok[:, 1:].astype(np.int32)}


@pytest.mark.parametrize("arch", ["qwen2-7b", "phi4-mini-3.8b"])
def test_loss_and_grads_match_reference(arch):
    rcfg, tcfg = rreg.get_smoke(arch), treg.get_smoke(arch)
    params = rtr.init(rcfg, jax.random.PRNGKey(0), jnp.float32)
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, params),
                                        device="cpu")
    tparams.requires_grad_(True)
    batch = _batch(rcfg.vocab_size)
    rctx = RCtx(ft=R_ONLINE.replace(backend="pallas"), dtype=jnp.float32)
    (rloss, rmet), rgrads = jax.value_and_grad(
        lambda p: rtr.loss_fn(p, {k: jnp.asarray(v) for k, v in
                                  batch.items()}, rcfg, rctx, remat=True,
                              chunk=CHUNK), has_aux=True)(params)

    tctx = TCtx(ft=T_ONLINE.replace(backend="pallas"), dtype=torch.float32)
    with ttel.ft_scope() as scope:
        tloss, tmet = ttr.loss_fn(
            tparams, {k: torch.as_tensor(v).long() for k, v in batch.items()},
            tcfg, tctx, remat="full", chunk=CHUNK)
        n_fwd = len(scope)
        tloss.backward()
    # one record per protected call of the forward: 7 projections and the
    # flash core per layer, and lm_head; the recompute adds none.
    assert n_fwd == len(scope) == tcfg.n_layers * 8 + 1
    np.testing.assert_allclose(float(tloss.detach()), float(rloss),
                               rtol=1e-4)
    for name in ("detected", "corrected"):
        assert float(getattr(tmet["ft"], name)) == float(
            getattr(rmet["ft"], name)) == 0.0
    flat = jax.tree_util.tree_flatten_with_path(rgrads)[0]
    named = dict(tparams.named_parameters())
    assert len(flat) == len(named)
    for path, want in flat:
        got = named[".".join(p.key for p in path)].grad.numpy()
        want = np.asarray(want)
        rel = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)
        assert rel <= 1e-4, (path, rel)


def test_train_path_runs_every_kernel_once_per_site():
    """A loss + backward on the kernel backend calls, per layer, the GEMM
    wrapper (K1) for 7 forward GEMMs, 7 recomputed and 14 backward ones,
    the flash forward (K2) twice (forward, recompute) and the dQ (K3) and
    dK/dV (K4) wrappers once; lm_head adds 3 GEMMs. On the CPU the wrappers
    run their plain versions and their launch counters stay at 0, so the
    wrappers are hooked to count the calls."""
    cfg = treg.get_smoke("phi4-mini-3.8b")
    params = ttr.init(cfg, seed=0, dtype=torch.float32, device="cpu")
    params.requires_grad_(True)
    calls = {"gemm": 0, "fwd": 0, "dq": 0, "dkv": 0}
    saved = (ft_gemm.ft_gemm, flashft.flash_ft_fwd, flashft.flash_ft_dq,
             flashft.flash_ft_dkv)

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    ft_gemm.ft_gemm = count("gemm", saved[0])
    flashft.flash_ft_fwd = count("fwd", saved[1])
    flashft.flash_ft_dq = count("dq", saved[2])
    flashft.flash_ft_dkv = count("dkv", saved[3])
    try:
        batch = {k: torch.as_tensor(v).long()
                 for k, v in _batch(cfg.vocab_size).items()}
        ctx = TCtx(ft=T_ONLINE.replace(backend="pallas"), dtype=torch.float32)
        loss, _ = ttr.loss_fn(params, batch, cfg, ctx, remat="full",
                              chunk=CHUNK)
        loss.backward()
    finally:
        (ft_gemm.ft_gemm, flashft.flash_ft_fwd, flashft.flash_ft_dq,
         flashft.flash_ft_dkv) = saved
    n = cfg.n_layers
    assert calls == {"gemm": 28 * n + 3, "fwd": 2 * n, "dq": n, "dkv": n}
