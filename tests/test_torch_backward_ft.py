"""Port ↔ reference: the backward of the FT GEMM fronts (`ft_dot`,
`ft_dot_fused`, `ft_batched_dot` as `torch.autograd.Function`s), the K1
act_grad output, and the FT-off injection semantics of the fronts.

The same numpy-seeded inputs go through `jax.grad` of the reference and
`torch.autograd` of the port, on both backends ("pallas": the reference's
kernels in interpret mode, the port's plain kernel versions; "xla": the
op-level ABFT paths). Tolerances: grads to 2e-5 (f32 sums in other
orders); injected-and-corrected grads equal the clean ones bit for bit on
integer-valued operands (exact checksum arithmetic).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import ft_gemm as rcore  # noqa: E402
from repro.core import telemetry as rtel  # noqa: E402
from repro.core.policy import FTConfig, FT_OFF, InjectionSpec  # noqa: E402
from repro.kernels import autotune, ops as rops  # noqa: E402
from repro.kernels.templates import epilogues as repi  # noqa: E402

from repro_torch.core import ft_gemm as tcore  # noqa: E402
from repro_torch.core import policy as tpol  # noqa: E402
from repro_torch.core import telemetry as ttel  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels.templates import KernelSpec as TKernelSpec  # noqa: E402

FUSED_CHAINS = [(True, None), (False, "relu"), (False, "gelu"),
                (False, "silu"), (True, "relu"), (True, "gelu"),
                (True, "silu")]


def _ints(shape, seed, lo=-3, hi=4):
    rng = np.random.default_rng(seed)
    return rng.integers(lo, hi, size=shape).astype(np.float32)


def _normal(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _t(x, grad=False):
    return None if x is None else torch.tensor(x, requires_grad=grad)


def _tspec(spec):
    return tpol.InjectionSpec(spec.row, spec.col, spec.magnitude,
                              spec.k_step)


def _port_grads(fn, *arrays):
    """∂ sum(sin(fn(*tensors))) / ∂ each input, as numpy."""
    ts = [_t(a, grad=True) for a in arrays]
    torch.sin(fn(*ts)).sum().backward()
    return [t.grad.numpy() for t in ts]


def _ref_grads(fn, *arrays):
    return [np.asarray(g) for g in jax.grad(
        lambda *xs: jnp.sum(jnp.sin(fn(*xs))),
        argnums=tuple(range(len(arrays))))(*map(jnp.asarray, arrays))]


# ---------------------------------------------------------------------------
# FT off with an injection: the reference's semantics
# ---------------------------------------------------------------------------

def test_ft_off_batched_dot_with_spec_matches_reference():
    """FT off with a spec runs the op-level ABFT path: the SEU lands and is
    left in the output (FT off does not correct), and the detection
    summary is recorded with corrected=False."""
    a, b = _ints((2, 8, 16), 0), _ints((2, 16, 8), 1)
    spec = InjectionSpec(row=1, col=2, magnitude=100.0)
    with rtel.ft_scope() as rs:
        want = rcore.ft_batched_dot(jnp.asarray(a), jnp.asarray(b),
                                    ft=FT_OFF, spec=spec)
        rrep = rs.report()
    with ttel.ft_scope() as ts:
        got = tcore.ft_batched_dot(_t(a), _t(b), ft=tpol.FT_OFF,
                                   spec=_tspec(spec))
        tot = ts.totals()
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert float(np.max(np.abs(got.numpy() - a @ b))) == 100.0
    assert tot["detected"] == float(rrep.detected) == 2.0
    assert tot["corrected"] == float(rrep.corrected) == 0.0
    assert tot["max_residual"] == float(rrep.max_residual) == 100.0


@pytest.mark.parametrize("front", ["dot", "fused"])
def test_ft_off_dot_with_spec_records_zero_summary(front):
    """`ft_dot` / `ft_dot_fused` with FT off and a spec compute the clean
    product and record the zero summary, as the reference does."""
    x, w = _ints((6, 16), 2), _ints((16, 8), 3)
    spec = InjectionSpec(row=1, col=2, magnitude=100.0)
    kw = {} if front == "dot" else {"act": "relu"}
    rfn = rcore.ft_dot if front == "dot" else rcore.ft_dot_fused
    tfn = tcore.ft_dot if front == "dot" else tcore.ft_dot_fused
    with rtel.ft_scope() as rs:
        want = rfn(jnp.asarray(x), jnp.asarray(w), ft=FT_OFF, spec=spec,
                   **kw)
        rrep = rs.report()
    with ttel.ft_scope() as ts:
        got = tfn(_t(x), _t(w), ft=tpol.FT_OFF, spec=_tspec(spec), **kw)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert len(ts) == 1
    assert ts.totals() == {"detected": float(rrep.detected),
                           "corrected": float(rrep.corrected),
                           "max_residual": float(rrep.max_residual)}


# ---------------------------------------------------------------------------
# gradients against jax.grad of the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_dot_grads_match_reference(backend):
    x, w = _normal((24, 64), 4), _normal((64, 40), 5)
    rft = FTConfig(level="block", backend=backend)
    tft = tpol.FTConfig(level="block", backend=backend)
    want = _ref_grads(lambda x, w: rcore.ft_dot(x, w, ft=rft), x, w)
    got = _port_grads(lambda x, w: tcore.ft_dot(x, w, ft=tft), x, w)
    for g, r in zip(got, want):
        np.testing.assert_allclose(g, r, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("with_bias,act", FUSED_CHAINS)
def test_fused_grads_every_chain_match_reference(backend, with_bias, act):
    x, w = _normal((24, 64), 6), _normal((64, 40), 7)
    bias = _normal((40,), 8) if with_bias else None
    rft = FTConfig(level="block", backend=backend)
    tft = tpol.FTConfig(level="block", backend=backend)
    arrays = (x, w) + ((bias,) if with_bias else ())
    want = _ref_grads(lambda x, w, *b: rcore.ft_dot_fused(
        x, w, bias=b[0] if b else None, act=act, ft=rft), *arrays)
    got = _port_grads(lambda x, w, *b: tcore.ft_dot_fused(
        x, w, bias=b[0] if b else None, act=act, ft=tft), *arrays)
    for g, r in zip(got, want):
        np.testing.assert_allclose(g, r, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_batched_dot_grads_match_reference(backend):
    a, b = _normal((3, 20, 32), 9), _normal((3, 32, 24), 10)
    rft = FTConfig(level="block", backend=backend)
    tft = tpol.FTConfig(level="block", backend=backend)
    want = _ref_grads(lambda a, b: rcore.ft_batched_dot(a, b, ft=rft), a, b)
    got = _port_grads(lambda a, b: tcore.ft_batched_dot(a, b, ft=tft), a, b)
    for g, r in zip(got, want):
        np.testing.assert_allclose(g, r, rtol=2e-5, atol=2e-5)


# ---------------------------------------------------------------------------
# backward injection: corrected bit for bit, detect-only leaves the error
# ---------------------------------------------------------------------------

def _inj_grads(front, ft, bwd_inject, x, w, bias):
    xt, wt = _t(x, grad=True), _t(w, grad=True)
    if front == "dot":
        y = tcore.ft_dot(xt, wt, ft=ft, bwd_inject=bwd_inject)
    else:
        y = tcore.ft_dot_fused(xt, wt, bias=_t(bias), act="relu", ft=ft,
                               bwd_inject=bwd_inject)
    y.sum().backward()
    return xt.grad, wt.grad


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("front", ["dot", "fused"])
@pytest.mark.parametrize("target", ["dx", "dw"])
def test_bwd_injection_corrected_bit_for_bit(backend, front, target):
    """An SEU inside the named backward GEMM is corrected: the grads equal
    the clean run's exactly (relu keeps dpre integer-valued)."""
    x, w = _ints((32, 64), 11), _ints((64, 48), 12)
    bias = _ints((48,), 13, lo=-2, hi=3)
    ft = tpol.FTConfig(level="block", backend=backend)
    inj = (target, tpol.InjectionSpec(row=2, col=3, magnitude=384.0))
    clean = _inj_grads(front, ft, None, x, w, bias)
    hurt = _inj_grads(front, ft, inj, x, w, bias)
    for c, h in zip(clean, hurt):
        assert torch.equal(c, h)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_bwd_detect_only_leaves_the_error(backend):
    """action="detect" leaves the backward SEU in the gradient: proof that
    the injection lands inside the backward GEMM."""
    x, w = _ints((32, 64), 14), _ints((64, 48), 15)
    ft = tpol.FTConfig(level="block", backend=backend, action="detect")
    inj = ("dx", tpol.InjectionSpec(row=2, col=3, magnitude=384.0))
    clean, _ = _inj_grads("dot", ft, None, x, w, None)
    hurt, _ = _inj_grads("dot", ft, inj, x, w, None)
    err = (hurt - clean).numpy()
    assert abs(err[2, 3] - 384.0) < 1e-3
    err[2, 3] = 0.0
    np.testing.assert_allclose(err, 0.0, atol=1e-5)


def test_bwd_inject_needs_enabled_ft():
    x, w = torch.ones(4, 8), torch.ones(8, 4)
    inj = ("dx", tpol.InjectionSpec(0, 0, 1.0))
    with pytest.raises(ValueError, match="bwd_inject"):
        tcore.ft_dot(x, w, ft=tpol.FT_OFF, bwd_inject=inj)


# ---------------------------------------------------------------------------
# K1 act_grad output
# ---------------------------------------------------------------------------

P = autotune.KernelParams(8, 128, 128)


def _tiles(m, n, k):
    info = rops.dispatch_info(m, n, k, P, dtype=jnp.float32,
                              ft_level="block")
    q = info["masked_params"] if info["path"] == "masked" else info["params"]
    return (q.bm, q.bn, q.bk)


@pytest.mark.parametrize("with_bias,act", [(False, "silu"), (True, "silu"),
                                           (False, "gelu"), (True, "relu")])
def test_save_act_grad_matches_reference(with_bias, act):
    """K1's plain version with the act_grad output against the reference
    kernel's multi-output variant: C, act'(pre-activation) and the report,
    with an SEU corrected before act_grad is written."""
    m, n, k = 40, 200, 300
    a, b = _normal((m, k), 16), _normal((k, n), 17) * 0.1
    bias = _normal((n,), 18) if with_bias else None
    spec = InjectionSpec(row=5, col=130, magnitude=50.0, k_step=1)
    ft = FTConfig(level="block")
    (rc, rg), rrep = rops.fused_matmul(
        jnp.asarray(a), jnp.asarray(b),
        bias=None if bias is None else jnp.asarray(bias), act=act, ft=ft,
        inject=spec, params=P, interpret=True, save_act_grad=True)
    (tc, tg), trep = tops.fused_matmul(
        _t(a), _t(b), bias=_t(bias), act=act,
        ft=tpol.FTConfig(level="block"), inject=_tspec(spec),
        tiles=_tiles(m, n, k), save_act_grad=True)
    np.testing.assert_allclose(tc.numpy(), np.asarray(rc), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tg.numpy(), np.asarray(rg), rtol=1e-5,
                               atol=1e-5)
    trep, rrep = trep.numpy(), np.asarray(rrep)
    np.testing.assert_array_equal(trep[..., [0, 1, 2, 3, 7]],
                                  rrep[..., [0, 1, 2, 3, 7]])
    assert trep[..., 0].sum() == 1.0
    pre = a @ b + (0.0 if bias is None else bias)
    np.testing.assert_allclose(tg.numpy(), repi.activation_grad(act)(pre),
                               rtol=1e-4, atol=1e-4)


def test_act_grad_needs_exactly_one_nonlinear_op():
    with pytest.raises(ValueError, match="act_grad"):
        TKernelSpec(epilogue=("bias",), extra_outputs=("act_grad",))
    with pytest.raises(ValueError, match="extra output"):
        TKernelSpec(epilogue=("silu",), extra_outputs=("dpre",))
    with pytest.raises(ValueError, match="act_grad"):
        tops.fused_matmul(torch.ones(4, 8), torch.ones(8, 4),
                          bias=torch.ones(4), save_act_grad=True)
