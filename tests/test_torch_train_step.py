"""Port ↔ reference: the train step and the training loop.

`make_train_step` on the qwen2-7b and phi4-mini-3.8b SMOKE configs in f32:
both sides start from the same parameters and AdamW state (the port's
through `convert.params_from_numpy` / `convert.opt_state_from_numpy`) and
take the same numpy batches; after 1 and 3 steps the parameters, the AdamW
moments and count, and the metrics (loss, grad_norm, lr, FT counters) agree
to 1e-5. The port runs its kernel backend (the plain kernel versions on the
CPU); the reference runs its op-level ("xla") backend under `jax.jit`,
which computes the same function (`tests/test_torch_train.py` holds the
two kernel backends' loss and gradients against each other).

Also: microbatching sums the FT counters over microbatches and averages the
gradients; `train` runs through `launch/train.py` on the CPU; the parts of
the loop that are not ported raise `NotImplementedError`.
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
from repro.optim import adamw as radamw  # noqa: E402
from repro.optim import schedule as rschedule  # noqa: E402
from repro.train import train_loop as rtl  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.configs.base import RunConfig as TRun  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.core import telemetry as ttel  # noqa: E402
from repro_torch.core.policy import FTConfig as TFT  # noqa: E402
from repro_torch.core.policy import ONLINE_BLOCK as T_ONLINE  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.optim import schedule as tschedule  # noqa: E402
from repro_torch.train import train_loop as ttl  # noqa: E402

CHUNK = 16
TC = dict(total_steps=3, warmup_steps=1)


def _batches(vocab, n, b=2, s=16):
    rng = np.random.default_rng(7)
    out = []
    for _ in range(n):
        tok = rng.integers(0, vocab, (b, s + 1)).astype(np.int32)
        out.append({"tokens": tok[:, :-1], "labels": tok[:, 1:]})
    return out


def _close(got: torch.Tensor, want, what):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5, err_msg=what)


@pytest.mark.parametrize("arch", ["qwen2-7b", "phi4-mini-3.8b"])
def test_train_steps_match_reference(arch):
    rcfg, tcfg = rreg.get_smoke(arch), treg.get_smoke(arch)
    rrun = RRun(model=rcfg, ft=R_ONLINE, dtype="float32", attn_chunk=CHUNK)
    trun = TRun(model=tcfg, ft=T_ONLINE.replace(backend="pallas"),
                dtype="float32", attn_chunk=CHUNK)
    ropt, topt = radamw.AdamWConfig(), tadamw.AdamWConfig()
    rtc, ttc = rtl.TrainConfig(**TC), ttl.TrainConfig(**TC)
    params = rtr.init(rcfg, jax.random.PRNGKey(0), jnp.float32)
    rstate = rtl.init_opt_state(params, ropt, rtc)
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, params),
                                        device="cpu")
    tparams.requires_grad_(True)
    tstate = convert.opt_state_from_numpy(jax.tree.map(np.asarray, rstate),
                                          device="cpu")
    rstep = jax.jit(rtl.make_train_step(rcfg, rrun, ropt, rtc))
    tstep = ttl.make_train_step(tcfg, trun, topt, ttc)
    for step, batch in enumerate(_batches(rcfg.vocab_size, 3)):
        params, rstate, rmet = rstep(
            params, rstate, {k: jnp.asarray(v) for k, v in batch.items()},
            jnp.asarray(step))
        tparams, tstate, tmet = tstep(
            tparams, tstate, {k: torch.as_tensor(v).long()
                              for k, v in batch.items()}, step)
        for name in ("loss", "grad_norm", "lr"):
            _close(tmet[name], rmet[name], f"step {step} {name}")
        for name in ("detected", "corrected"):
            assert float(getattr(tmet["ft"], name)) == float(
                getattr(rmet["ft"], name)) == 0.0
        if step in (0, 2):           # after 1 and after 3 steps
            named = dict(tparams.named_parameters())
            adam = tstate["adam"]
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                    params)[0]:
                key = ".".join(p.key for p in path)
                _close(named[key], leaf, f"step {step} param {key}")
                m = rstate["adam"]["m"]
                v = rstate["adam"]["v"]
                for p in path:
                    m, v = m[p.key], v[p.key]
                _close(adam["m"][key], m, f"step {step} m {key}")
                _close(adam["v"][key], v, f"step {step} v {key}")
            assert int(adam["count"]) == int(rstate["adam"]["count"]) == \
                step + 1
    # step 0 has lr 0: the first step leaves the parameters unchanged
    assert float(tschedule.warmup_cosine(0, warmup=1, total=3)) == 0.0


def test_schedule_and_adamw_state_layout_match_reference():
    for step in (0, 1, 5, 50, 99, 100, 250, 1000):
        want = rschedule.warmup_cosine(step, warmup=100, total=1000)
        got = tschedule.warmup_cosine(step, warmup=100, total=1000)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    with pytest.raises(NotImplementedError):
        tadamw.init(torch.nn.Linear(2, 2), tadamw.AdamWConfig(q8=True))


def test_microbatch_sums_ft_counters_and_averages_grads():
    """microbatch=2: the FT counters of the step are the SUM of the two
    microbatches' (a detect-only policy with a tiny static threshold makes
    every protected GEMM report detections), and the update equals the
    full-batch step's (equal halves, mean loss)."""
    cfg = treg.get_smoke("phi4-mini-3.8b")
    ft = TFT(action="detect", static_tau=1e-12, backend="xla")
    batch = {k: torch.as_tensor(v).long()
             for k, v in _batches(cfg.vocab_size, 1, b=4)[0].items()}
    opt = tadamw.AdamWConfig()
    tc = ttl.TrainConfig(**TC)
    outs = {}
    for micro in (0, 2):
        run = TRun(model=cfg, ft=ft, dtype="float32", attn_chunk=CHUNK,
                   microbatch=micro)
        params = ttr.init(cfg, seed=3, dtype=torch.float32, device="cpu")
        params.requires_grad_(True)
        state = ttl.init_opt_state(params, opt, tc)
        step = ttl.make_train_step(cfg, run, opt, tc)
        outs[micro] = step(params, state, batch, 1)
    halves = []
    params = ttr.init(cfg, seed=3, dtype=torch.float32, device="cpu")
    ctx = ttr.Ctx(ft=ft, dtype=torch.float32)
    for half in (slice(0, 2), slice(2, 4)):
        with torch.no_grad():
            _, met = ttr.loss_fn(params, {k: v[half] for k, v in
                                          batch.items()}, cfg, ctx,
                                 chunk=CHUNK)
        halves.append(met["ft"])
    det = float(outs[2][2]["ft"].detected)
    assert det > 0
    assert det == sum(float(h.detected) for h in halves)
    assert float(outs[2][2]["ft"].corrected) == 0.0
    _close(outs[2][2]["loss"], outs[0][2]["loss"].numpy(), "loss")
    full = dict(outs[0][0].named_parameters())
    for name, p in outs[2][0].named_parameters():
        _close(p, full[name].detach().numpy(), name)
    want = rtel.reduce_microbatch(rtel.FTReport(
        detected=jnp.asarray([1.0, 2.0]), corrected=jnp.asarray([1.0, 0.0]),
        max_residual=jnp.asarray([0.5, 0.25]),
        site_detected=jnp.zeros((2, 1, 1)),
        site_corrected=jnp.zeros((2, 1, 1)),
        site_max_residual=jnp.zeros((2, 1, 1))))
    got = ttel.reduce_microbatch([
        ttel.FTReport(torch.tensor(1.0), torch.tensor(1.0), torch.tensor(.5)),
        ttel.FTReport(torch.tensor(2.0), torch.tensor(0.0), torch.tensor(.25))])
    assert (float(got.detected), float(got.corrected),
            float(got.max_residual)) == (float(want.detected),
                                         float(want.corrected),
                                         float(want.max_residual))


def test_train_cli_runs_on_the_cpu(capsys):
    from repro_torch.launch import train as cli
    out = cli.main(["--arch", "phi4-mini-3.8b-smoke", "--device", "cpu",
                    "--dtype", "float32", "--steps", "3", "--batch", "2",
                    "--seq", "16"])
    assert out["final_step"] == 3
    assert [h["step"] for h in out["history"]] == [0, 2]
    assert all(np.isfinite(h["loss"]) and h["detected"] == 0.0
               for h in out["history"])
    assert out["history"][0]["lr"] == 0.0
    assert len(out["step_times"]) == 3
    assert "finished at step 3" in capsys.readouterr().out


@pytest.mark.parametrize("what", ["ckpt_dir", "resume", "compress_grads",
                                  "sink", "inject_every", "q8"])
def test_unported_parts_of_the_loop_raise(what, monkeypatch):
    """What the loop does not port raises. ``inject_every``: a campaign
    through flash attention kernels built without the stochastic hook
    (`flashft.SUPPORTS_STOCHASTIC_INJECTION` False; the port's carry it:
    `test_torch_flash_campaign.py`)."""
    if what == "inject_every":
        from repro_torch.kernels import flashft as tflash
        monkeypatch.setattr(tflash, "SUPPORTS_STOCHASTIC_INJECTION", False)
    cfg = treg.get_smoke("phi4-mini-3.8b")
    rate = 0.5 if what == "inject_every" else 0.0
    run = TRun(model=cfg, ft=T_ONLINE.replace(backend="pallas",
                                              inject_rate=rate),
               dtype="float32", opt_state="q8" if what == "q8" else "f32")
    tc = ttl.TrainConfig(total_steps=1,
                         compress_grads=what == "compress_grads",
                         inject_every=1 if what == "inject_every" else 0)
    kw = {"ckpt_dir": {"ckpt_dir": "ckpt"}, "resume": {"resume": True},
          "sink": {"sink": object()}}.get(what, {})
    with pytest.raises(NotImplementedError):
        ttl.train(cfg, run, ShapeConfig("t", 8, 2, "train"), tc,
                  device="cpu", **kw)
