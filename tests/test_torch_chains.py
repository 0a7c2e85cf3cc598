"""K1's epilogue chains: the plan that routes each chain to an instance
(bias? + gelu / relu on the tensor cores at every level, every other chain
of at most one bias, one residual and one activation on the SIMT kernels:
`csrc/ft_gemm.cu` where it compiles the chain, else the chain instance
`csrc/ft_gemm_chain.cu`), and each new chain's plain version against the
reference's Pallas kernel in interpret mode at the reference's (128, 128,
128) tiles, at block, tile and inner, with act_grad where the chain has an
activation.

Tolerances: integer-valued f32 operands keep the accumulator exact on both
sides, so reports agree in det / corr / row / col / magnitude exactly and
in max residual, tau and k to 1e-4 relative, and the corrected output is
the clean one bit for bit; the activations (tanh, exp) are evaluated by two
libraries, so outputs and act_grad agree to 1e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core.policy import FTConfig, InjectionSpec  # noqa: E402
from repro.kernels import autotune, ops as rops  # noqa: E402
from repro.kernels.templates import KernelSpec  # noqa: E402

from repro_torch.core import policy as tpol  # noqa: E402
from repro_torch.kernels import ft_gemm as tg, ops as tops  # noqa: E402
from repro_torch.kernels.templates import KernelSpec as TKernelSpec  # noqa: E402

BF16 = torch.bfloat16
BIG, SMALL = tg.SM90_TILES
SIMT_SQ, SIMT_WIDE = tg.TILES
ACTS = ("silu", "gelu", "relu")
TILES = (128, 128, 128)
SEU = dict(row=130, col=150, magnitude=64.0, k_step=1)
#: New chains (none compiled at every level before): bias + activation,
#: activations and the residual at tile / inner, the residual after an
#: activation, the bias after one, the three-op chains in several orders.
CHAINS = [("bias", "relu"), ("bias", "gelu"), ("residual",),
          ("gelu", "residual"), ("bias", "residual"),
          ("residual", "bias", "silu"), ("bias", "gelu", "residual"),
          ("relu", "bias")]


def _plan(m, n, k, **kw):
    args = dict(dtype=BF16, level="block", chain=(), a_strides=(k, 1),
                b_strides=(n, 1))
    args.update(kw)
    return tg.plan(m, n, k, **args)


@pytest.mark.parametrize("level", ["off", "block", "tile", "inner"])
def test_tensor_cores_take_bias_gelu_and_relu_at_every_level(level):
    """whisper's w1 (6 000 x 1 024 -> 4 096, gelu) and every bias? + gelu /
    relu chain, with and without act_grad, plan onto the tensor cores."""
    for act in ("gelu", "relu"):
        for chain in ((act,), ("bias", act)):
            for ag in (False, True):
                p = _plan(6000, 4096, 1024, chain=chain, act_grad=ag,
                          level=level)
                assert (p.instance, p.tiles, p.reason) == ("sm90", BIG, "")
    assert tg.sm90_chain(("bias", "gelu")) == (True, tg.SM90_ACTS["gelu"])
    assert tg.sm90_chain(("relu",)) == (False, tg.SM90_ACTS["relu"])


@pytest.mark.parametrize("level", ["off", "block", "tile", "inner"])
def test_simt_instances_by_the_written_rule(level):
    """Residual chains and other orders go to the SIMT kernels, with the
    reason in the plan: csrc/ft_gemm.cu for what it compiles, the chain
    instance for the rest; f32 likewise."""
    lv = level in ("tile", "inner")
    cases = [
        (("residual",), False, BF16, "simt_chain" if lv else "simt"),
        (("gelu", "residual"), False, BF16, "simt_chain"),
        (("bias", "residual", "relu"), False, BF16, "simt_chain"),
        (("silu", "bias"), False, BF16, "simt_chain"),
        (("gelu",), False, torch.float32, "simt_chain" if lv else "simt"),
        (("bias", "gelu"), True, torch.float32, "simt_chain"),
        (("bias", "silu"), True, torch.float32, "simt"),
        ((), False, torch.float32, "simt"),
    ]
    for chain, ag, dtype, instance in cases:
        for m, tiles in ((512, SIMT_SQ), (4, SIMT_WIDE)):
            p = _plan(m, 3584, 3584, chain=chain, act_grad=ag, dtype=dtype,
                      level=level)
            assert (p.instance, p.tiles) == (instance, tiles), (chain, ag)
            assert p.reason
            assert tg.simt_compiled(chain, level, ag) == (instance == "simt")
    why = _plan(512, 3584, 3584, chain=("bias", "residual"),
                level=level).reason
    assert "residual" in why and "SIMT" in why


def _operands(rng, chain, m=256, n=256, k=256):
    ints = lambda *s: rng.integers(-3, 4, s).astype(np.float32)
    a, b = ints(m, k), ints(k, n)
    aux = {}
    if "bias" in chain:
        aux["bias"] = ints(n)
    if "residual" in chain:
        aux["residual"] = ints(m, n)
    return a, b, aux


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("level", ["block", "tile", "inner"])
@pytest.mark.parametrize("chain", CHAINS, ids="+".join)
def test_chain_plain_matches_reference(chain, level):
    """One SEU (64 at row 130, col 150, k-step 1) corrected and located
    alike; act_grad equal where the chain has an activation; the corrected
    output the clean one; a detect-only control leaves it and corrects
    nothing."""
    rng = np.random.default_rng(len(chain) * 7 + len(level))
    a, b, aux = _operands(rng, chain)
    ag = ("act_grad",) if any(x in ACTS for x in chain) else ()
    rspec = KernelSpec(ft_level=level, epilogue=chain, extra_outputs=ag)
    tspec = TKernelSpec(ft_level=level, epilogue=chain, extra_outputs=ag)
    ro, rr = rops.gemm_call(
        rspec, jnp.asarray(a), jnp.asarray(b), ft=FTConfig(level=level),
        inject=InjectionSpec(**SEU), params=autotune.KernelParams(*TILES),
        interpret=True, **{x: jnp.asarray(y) for x, y in aux.items()})
    taux = {x: _t(y) for x, y in aux.items()}

    def port(action="correct", inject=True):
        return tops.gemm_call(
            tspec, _t(a), _t(b), ft=tpol.FTConfig(level=level, action=action),
            inject=tpol.InjectionSpec(**SEU) if inject else None, tiles=TILES,
            **taux)

    to, tr = port()
    outs_r = ro if ag else (ro,)
    outs_t = to if ag else (to,)
    for got, want in zip(outs_t, outs_r):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5)
    rr = np.asarray(rr)
    assert tr.shape == rr.shape
    np.testing.assert_array_equal(tr.numpy()[..., :5], rr[..., :5])
    np.testing.assert_allclose(tr.numpy()[..., 5:], rr[..., 5:], rtol=1e-4)
    hit = tr[tr[..., 0] > 0]
    assert len(hit) == 1 and float(tr[..., 1].sum()) == 1.0
    assert (int(hit[0, 2]), int(hit[0, 3]), float(hit[0, 4])) == \
        (SEU["row"], SEU["col"], SEU["magnitude"])
    clean, crep = port(inject=False)
    for got, want in zip(outs_t, clean if ag else (clean,)):
        assert torch.equal(got, want)
    assert float(crep[..., 0].sum()) == 0.0
    left, lrep = port(action="detect")
    left = left[0] if ag else left
    clean = clean[0] if ag else clean
    assert float(lrep[..., 1].sum()) == 0.0 and float(lrep[..., 0].sum()) >= 1
    # the SEU's cell alone (relu may clip both values to 0)
    diff = (left != clean).nonzero().tolist()
    assert diff in ([], [[SEU["row"], SEU["col"]]])
    assert diff or "relu" in chain


def test_chain_plain_on_the_kernels_tiles_matches_one_pass():
    """At the kernels' own tiles (the SIMT instance's, and two split-K
    ranges on the tensor cores' grid) each chain's plain version is the
    unfused chain of `epilogues.reference_apply` on A·B, act_grad its
    activation's derivative at the pre-activation."""
    from repro_torch.kernels.templates import epilogues
    rng = np.random.default_rng(5)
    for chain in CHAINS + [("gelu",), ("relu",), ("bias", "silu", "residual")]:
        a, b, aux = _operands(rng, chain, m=70, n=90, k=300)
        taux = {x: _t(y) for x, y in aux.items()}
        want = epilogues.reference_apply(chain, _t(a) @ _t(b), **taux)
        act = [x for x in chain if x in ACTS]
        for level, tiles, splits in (("block", SIMT_SQ, 1),
                                     ("tile", SIMT_WIDE, 1),
                                     ("inner", BIG, 2), ("tile", BIG, 2)):
            res, rep = tg.ft_gemm_plain(_t(a), _t(b), chain=chain,
                                        ft=tpol.FTConfig(level=level),
                                        tiles=tiles, splits=splits,
                                        save_act_grad=bool(act), **taux)
            out = res[0] if act else res
            np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=0,
                                       atol=1e-5)
            assert float(rep[..., 0].sum()) == 0.0
            if act:
                pre = epilogues.reference_apply(
                    chain[:chain.index(act[0])], _t(a) @ _t(b), **taux)
                np.testing.assert_allclose(
                    res[1].numpy(), epilogues.get(act[0]).grad(pre).numpy(),
                    rtol=0, atol=1e-6)
