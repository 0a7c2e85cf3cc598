"""The port as a package: its config dataclasses translate one to one from
the reference's, it imports neither JAX nor the reference, its entry points
refuse to fall back to the CPU, and a stochastic injection campaign on the
kernel backend raises instead of running clean."""
import dataclasses
import pathlib
import re

import pytest

torch = pytest.importorskip("torch")

from repro.configs import base as rbase  # noqa: E402
from repro.core import policy as rpolicy  # noqa: E402
from repro.train import engine as rengine  # noqa: E402
from repro.train import kv_cache as rkv  # noqa: E402
from repro.train import serve as rserve  # noqa: E402

from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.core import ft_gemm as tcore  # noqa: E402
from repro_torch.core import policy as tpolicy  # noqa: E402
from repro_torch.kernels import ft_gemm as tkgemm, ops as tops  # noqa: E402
from repro_torch.models import blocks as tblocks  # noqa: E402
from repro_torch.models import transformer as ttr  # noqa: E402
from repro_torch.kernels import flashft as tkflash  # noqa: E402
from repro_torch.train import engine as tengine  # noqa: E402
from repro_torch.train import kv_cache as tkv  # noqa: E402
from repro_torch.train import serve as tserve  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
PAIRS = [(rpolicy.FTConfig, tpolicy.FTConfig),
         (rpolicy.InjectionSpec, tpolicy.InjectionSpec),
         (rbase.ModelConfig, tbase.ModelConfig),
         (rbase.MoEConfig, tbase.MoEConfig),
         (rbase.SSMConfig, tbase.SSMConfig),
         (rbase.RunConfig, tbase.RunConfig),
         (rserve.ServeConfig, tserve.ServeConfig),
         (rengine.EngineConfig, tengine.EngineConfig),
         (rkv.PagePlan, tkv.PagePlan)]


def _fields(cls):
    out = []
    for f in dataclasses.fields(cls):
        d = f.default
        if dataclasses.is_dataclass(d):
            d = dataclasses.asdict(d)
        out.append((f.name, d, f.default_factory))
    return out


@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: p[0].__name__)
def test_config_fields_and_defaults_match_reference(pair):
    ref, port = pair
    assert _fields(port) == _fields(ref)


def test_presets_match_reference():
    for name in ("ONLINE_BLOCK", "OFFLINE_DETECT", "NONFUSED_BASELINE",
                 "FT_OFF"):
        assert (dataclasses.asdict(getattr(tpolicy, name))
                == dataclasses.asdict(getattr(rpolicy, name)))
    from repro.configs import registry as rreg
    for arch in treg.ARCH_IDS:
        assert (dataclasses.asdict(treg.get_config(arch))
                == dataclasses.asdict(rreg.get_config(arch)))


def test_policy_resolution_and_promote_match_reference():
    def pol(mod):
        return mod.FTPolicy(
            rules=(("w_*", mod.OFFLINE_DETECT.replace(verify="final")),
                   ("dec_?k", mod.FT_OFF)),
            default=mod.ONLINE_BLOCK).override(("w_up", mod.FT_OFF))
    rp, tp = pol(rpolicy), pol(tpolicy)
    for site in ("w_gate", "w_up", "dec_qk", "dec_pv", "lm_head", None):
        r, t = rpolicy.resolve_ft(rp, site), tpolicy.resolve_ft(tp, site)
        assert dataclasses.asdict(t) == dataclasses.asdict(r)
        assert (dataclasses.asdict(tpolicy.promote(t))
                == dataclasses.asdict(rpolicy.promote(r)))


def test_serve_cli_runs_on_the_cpu(capsys):
    from repro_torch.launch import serve as cli
    import sys
    argv = sys.argv
    sys.argv = ["serve", "--arch", "qwen2-7b-smoke", "--device", "cpu",
                "--dtype", "float32", "--batch", "2", "--prompt-len", "4",
                "--new-tokens", "2", "--max-len", "8"]
    try:
        cli.main()
    finally:
        sys.argv = argv
    out = capsys.readouterr().out
    assert "generated (2, 2) tokens" in out and "'detected': 0.0" in out


def test_port_sources_import_neither_jax_nor_reference():
    pat = re.compile(r"^\s*(?:import|from)\s+(?:jax|repro)(?:\.|\s|$)",
                     re.M)
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for new in ("optim/adamw.py", "train/train_loop.py", "launch/train.py",
                "data/pipeline.py", "train/kv_cache.py", "train/engine.py",
                "models/moe.py", "kernels/grouped_gemm.py",
                "kernels/grouped/layout.py", "kernels/grouped/dispatch.py",
                "configs/qwen3_moe_235b.py", "configs/arctic_480b.py"):
        assert ROOT / "src" / "repro_torch" / new in files
    offenders = [str(f.relative_to(ROOT)) for f in files
                 if pat.search(f.read_text())]
    assert not offenders, offenders


def test_entry_points_without_device_need_a_gpu():
    """Entry points default to device="cuda" and never fall back to the CPU
    on their own."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA GPU is present")
    cfg = treg.get_smoke("qwen2-7b")
    run = tbase.RunConfig(model=cfg, ft=tpolicy.ONLINE_BLOCK.replace(
        backend="pallas"), dtype="float32")
    params = ttr.init(cfg, dtype=torch.float32, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.generate(params, torch.zeros(1, 4, dtype=torch.long).numpy(),
                        cfg, run, tserve.ServeConfig(max_len=8),
                        max_new_tokens=1)
    with pytest.raises((RuntimeError, AssertionError)):
        ttr.init(cfg, dtype=torch.float32)
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.train import train_loop
    with pytest.raises(RuntimeError, match="CUDA"):
        train_loop.train(cfg, run, ShapeConfig("t", 8, 2, "train"),
                         train_loop.TrainConfig(total_steps=1))
    with pytest.raises(RuntimeError, match="CUDA"):
        tengine.ServeEngine(params, cfg, run, tengine.EngineConfig(max_len=8))


def test_kernel_wrappers_take_no_other_device():
    """A wrapper runs its plain version only for CPU tensors; any other
    device launches the kernel (CUDA) or raises."""
    a, b = torch.ones(4, 8, device="meta"), torch.ones(8, 4, device="meta")
    with pytest.raises(ValueError, match="device"):
        tkgemm.ft_gemm(a, b, ft=tpolicy.ONLINE_BLOCK)
    q, pool = torch.ones(2, 8, 128, device="meta"), \
        torch.ones(3, 2, 16, 128, device="meta")
    lengths = torch.ones(1, dtype=torch.int32, device="meta")
    table = torch.ones(1, 2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="device"):
        tkflash.flash_ft_decode(q, pool, pool, lengths, table,
                                ft=tpolicy.ONLINE_BLOCK, scale=1.0,
                                tau_dh=128)
    from repro_torch.kernels import grouped_gemm as tkgg
    buf, w = torch.ones(16, 8, device="meta"), torch.ones(2, 8, 4,
                                                          device="meta")
    gid = torch.zeros(1, dtype=torch.int32, device="meta")
    row_end = torch.ones(2, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="device"):
        tkgg.ft_gemm_grouped(buf, w, gid, row_end, ft=tpolicy.ONLINE_BLOCK)
    with pytest.raises(ValueError, match="device"):
        tkgg.tgmm(buf, torch.ones(16, 4, device="meta"), row_end, bm=16,
                  ft=tpolicy.ONLINE_BLOCK)


def test_stochastic_campaign_on_kernel_backend_raises(monkeypatch):
    """The GEMM and flash kernels run a campaign (every SEU corrected); a
    flash build without the stochastic hook
    (`flashft.SUPPORTS_STOCHASTIC_INJECTION` False) raises on one, and so
    does a forward whose attention takes it."""
    ft = tpolicy.ONLINE_BLOCK.replace(backend="pallas", inject_rate=1.0)
    key = torch.Generator().manual_seed(0)
    a, b = torch.ones(4, 8), torch.ones(8, 4)
    out, rep = tops.ft_matmul_report(a, b, ft=ft, key=key)
    assert torch.equal(out, a @ b)
    assert float(rep[..., 0].sum()) == float(rep[..., 1].sum()) == 1.0
    assert torch.equal(tcore.ft_dot(a, b, ft=ft, key=key), a @ b)
    q = torch.ones(2, 8, 16)
    out, rep = tops.flash_ft(q, q, q, ft=ft, key=key)
    assert torch.allclose(out, q)
    assert float(rep[..., 0].sum()) == float(rep[..., 1].sum()) == 2.0
    from repro_torch.kernels import flashft as tflash
    monkeypatch.setattr(tflash, "SUPPORTS_STOCHASTIC_INJECTION", False)
    with pytest.raises(NotImplementedError):
        tops.flash_ft(q, q, q, ft=ft, key=key)
    cfg = treg.get_smoke("qwen2-7b")
    params = ttr.init(cfg, dtype=torch.float32, device="cpu")
    ctx = tblocks.Ctx(ft=ft, key=key, dtype=torch.float32)
    with pytest.raises(NotImplementedError), torch.inference_mode():
        ttr.forward(params, torch.zeros(1, 4, dtype=torch.long), cfg, ctx)
    # without a key the same policy runs (no campaign was asked for)
    out = tcore.ft_dot(a, b, ft=ft)
    assert torch.equal(out, a @ b)
