"""The CUDA kernels against their plain PyTorch versions, on the GPU.

Marked ``gpu``: each test asks the `cuda` fixture for the card and skips
with "no CUDA" without one. Run on the card with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

f32 cases: outputs to 1e-5 and reports equal in det/corr/row/col/k, tau and
mag to 1e-5 relative (integer-valued operands keep both sides exact). bf16
cases: one bf16 ulp at the top of the output's range (both sides sum in f32
in different orders, then round).
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.policy import (FTConfig, InjectionSpec,  # noqa: E402
                                     ONLINE_BLOCK)
from repro_torch.kernels import flashft, ft_gemm  # noqa: E402

pytestmark = pytest.mark.gpu
FT = ONLINE_BLOCK.replace(backend="pallas")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _ints(gen, *shape, dtype=torch.float32):
    return torch.randint(-3, 4, shape, generator=gen, device="cuda").to(dtype)


def _check_reports(got, want):
    assert got.shape == want.shape
    idx = [0, 1, 2, 3, 7]
    assert torch.equal(got[..., idx], want[..., idx])
    rel = ((got[..., [4, 5, 6]] - want[..., [4, 5, 6]]).abs()
           / want[..., [4, 5, 6]].abs().clamp_min(1e-30))
    assert float(rel.max()) <= 1e-5


@pytest.mark.parametrize("chain", list(ft_gemm.EPILOGUES))
@pytest.mark.parametrize("shape", [(1, 77, 300), (7, 130, 200),
                                   (100, 200, 97)])
def test_gemm_2d_matches_plain_f32(cuda, shape, chain):
    m, n, k = shape
    gen = torch.Generator(device="cuda").manual_seed(m + n + len(chain))
    a, b = _ints(gen, m, k), _ints(gen, k, n)
    bias = _ints(gen, n) if "bias" in chain else None
    res = _ints(gen, m, n) if "residual" in chain else None
    for verify, inj in (("step", (1, -1, m - 1, n - 1, 2)),
                        ("final", (1, -1, 0, 5, 0)), ("step", None)):
        kw = dict(chain=chain, bias=bias, residual=res,
                  ft=FT.replace(verify=verify), inj=inj, inj_mag=99.0)
        before = ft_gemm.FT_GEMM_2D.launches
        out, rep = ft_gemm.ft_gemm(a, b, **kw)
        assert ft_gemm.FT_GEMM_2D.launches == before + 1
        out_p, rep_p = ft_gemm.ft_gemm_plain(
            a, b, tiles=ft_gemm.pick_tiles(m), **kw)
        torch.testing.assert_close(out, out_p, rtol=1e-5, atol=1e-5)
        _check_reports(rep, rep_p)
        assert float(rep[..., 0].sum()) == (inj is not None)
    off, none = ft_gemm.ft_gemm(a, b, chain=chain, bias=bias, residual=res)
    assert none is None
    torch.testing.assert_close(off, out_p, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shared_b", [False, True])
def test_gemm_batched_matches_plain_f32(cuda, shared_b):
    gen = torch.Generator(device="cuda").manual_seed(3)
    nb, m, n, k = 5, 7, 256, 128
    a = _ints(gen, nb, m, k)
    b = _ints(gen, k, n) if shared_b else _ints(gen, nb, k, n)
    for inj in ((1, -1, 6, 255, 3), (1, 2, 0, 0, 0)):
        kw = dict(ft=FT, inj=inj, inj_mag=-40.0)
        before = ft_gemm.FT_GEMM_BATCHED.launches
        out, rep = ft_gemm.ft_gemm(a, b, **kw)
        assert ft_gemm.FT_GEMM_BATCHED.launches == before + 1
        out_p, rep_p = ft_gemm.ft_gemm_plain(a, b, tiles=ft_gemm.pick_tiles(m),
                                             **kw)
        torch.testing.assert_close(out, out_p, rtol=1e-5, atol=1e-5)
        _check_reports(rep, rep_p)
        assert float(rep[..., 0].sum()) == (nb if inj[1] < 0 else 1)
        clean, _ = ft_gemm.ft_gemm(a, b, ft=FT)
        assert torch.equal(out, clean)


@pytest.mark.parametrize("product", ["qk", "pv", "tied_head"])
def test_gemm_strided_views_match_plain_f32(cuda, product):
    """Operands read through their strides: decode attention's permuted
    views of the (B, S, KVH, dh) cache with two batch dims, and a transposed
    2-D weight (a tied lm_head)."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    nb, kvh, rep_n, s, dh = 3, 4, 7, 200, 128
    cache = _ints(gen, nb, s, kvh, dh)
    if product == "qk":
        a, b = _ints(gen, nb, kvh, rep_n, dh), cache.permute(0, 2, 3, 1)
    elif product == "pv":
        a, b = _ints(gen, nb, kvh, rep_n, s), cache.transpose(1, 2)
    else:
        a, b = _ints(gen, 5, dh), _ints(gen, 300, dh).t()
    assert not b.is_contiguous()
    n = b.shape[-1]
    kw = dict(ft=FT, inj=(1, -1, a.shape[-2] - 1, n - 1, 1), inj_mag=60.0)
    out, rep = ft_gemm.ft_gemm(a, b, **kw)
    out_p, rep_p = ft_gemm.ft_gemm_plain(
        a, b, tiles=ft_gemm.pick_tiles(a.shape[-2]), **kw)
    torch.testing.assert_close(out, out_p, rtol=1e-5, atol=1e-5)
    _check_reports(rep, rep_p)
    assert float(rep[..., 0].sum()) == a[..., 0, 0].numel()
    dense, _ = ft_gemm.ft_gemm(a, b.contiguous(), ft=FT)
    assert torch.equal(out, dense)


@pytest.mark.parametrize("geom", [(4, 1, 64, 64, 64, True),
                                  (14, 7, 100, 100, 128, True),
                                  (7, 7, 30, 150, 128, True),
                                  (2, 1, 50, 130, 64, False)])
def test_flash_matches_plain_f32(cuda, geom):
    bh, n_rep, sq, skv, dh, causal = geom
    gen = torch.Generator(device="cuda").manual_seed(bh + sq)
    q = torch.randn(bh, sq, dh, generator=gen, device="cuda")
    k = torch.randn(bh // n_rep, skv, dh, generator=gen, device="cuda")
    v = torch.randn(bh // n_rep, skv, dh, generator=gen, device="cuda")
    kw = dict(ft=FT, scale=dh ** -0.5, tau_dh=128, n_rep=n_rep,
              causal=causal)
    for inj in (None, (1, bh - 1, (sq - 1) // 64, 0, 0, dh - 1)):
        out, rep = flashft.flash_ft_fwd(q, k, v, inj=inj, inj_mag=50.0, **kw)
        out_p, rep_p = flashft.flash_ft_plain(q, k, v, inj=inj, inj_mag=50.0,
                                              **kw)
        torch.testing.assert_close(out, out_p, rtol=1e-5, atol=1e-5)
        assert torch.equal(rep[..., [0, 1, 7]], rep_p[..., [0, 1, 7]])
        det = rep_p[..., 0] > 0
        assert torch.equal(rep[..., 2:4][det], rep_p[..., 2:4][det])
        torch.testing.assert_close(rep[..., 6], rep_p[..., 6], rtol=1e-5,
                                   atol=0)
        assert float(rep[..., 0].sum()) == (inj is not None)


def test_bf16_kernels_match_plain(cuda):
    gen = torch.Generator(device="cuda").manual_seed(9)
    a = torch.randn(37, 300, generator=gen, device="cuda").bfloat16()
    b = torch.randn(300, 260, generator=gen, device="cuda").bfloat16()
    bias = torch.randn(260, generator=gen, device="cuda").bfloat16()
    kw = dict(chain=("bias", "silu"), bias=bias, ft=FT)
    out, _ = ft_gemm.ft_gemm(a, b, **kw)
    out_p, _ = ft_gemm.ft_gemm_plain(a, b, tiles=ft_gemm.pick_tiles(37), **kw)
    assert out.dtype == torch.bfloat16
    tol = 2.0 ** -7 * float(out_p.float().abs().max())
    assert float((out.float() - out_p.float()).abs().max()) <= tol
    q = torch.randn(8, 70, 128, generator=gen, device="cuda").bfloat16()
    kv = torch.randn(2, 70, 128, generator=gen, device="cuda").bfloat16()
    fkw = dict(ft=FT, scale=128 ** -0.5, tau_dh=128, n_rep=4, causal=True)
    out, _ = flashft.flash_ft_fwd(q, kv, kv, **fkw)
    out_p, _ = flashft.flash_ft_plain(q, kv, kv, **fkw)
    tol = 2.0 ** -7 * float(out_p.float().abs().max())
    assert float((out.float() - out_p.float()).abs().max()) <= tol


def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    a = torch.ones(8, 16, device="cuda")
    b = torch.ones(16, 8, device="cuda")
    with pytest.raises(ValueError):
        ft_gemm.ft_gemm(a[None, None, None], b, ft=FT)        # 3 batch dims
    with pytest.raises(ValueError):
        ft_gemm.ft_gemm(a, b, ft=FT, tiles=(32, 32, 32))
    with pytest.raises(NotImplementedError):    # 11 ops: past the cap
        ft_gemm.ft_gemm(a, b, ft=FT, chain=("gelu", "relu") * 5 + ("silu",))
    from repro_torch.kernels import grouped_gemm    # K7 at tile: its SIMT
    before = grouped_gemm.FT_GEMM_GROUPED_SIMT.launches  # instance, planned
    out, rep = grouped_gemm.ft_gemm_grouped(
        torch.ones(16, 16, device="cuda"),
        torch.ones(2, 16, 8, device="cuda"),
        torch.tensor([0, 1], device="cuda", dtype=torch.int32),
        torch.tensor([8, 16], device="cuda", dtype=torch.int32),
        ft=FTConfig(level="tile"))
    assert grouped_gemm.FT_GEMM_GROUPED_SIMT.launches == before + 1
    assert torch.equal(out, torch.full((16, 8), 16.0, device="cuda"))
    assert float(rep[..., 0].sum()) == 0.0
    with pytest.raises(NotImplementedError):       # past the cap at tile
        ft_gemm.ft_gemm(a, b, ft=FT.replace(level="tile"),
                        chain=("gelu", "residual") + ("silu",) * 9,
                        residual=torch.ones(8, 8, device="cuda"))
    with pytest.raises(TypeError):
        ft_gemm.ft_gemm(a.half(), b.half(), ft=FT)
    q = torch.ones(2, 8, 96, device="cuda")
    with pytest.raises(ValueError):
        flashft.flash_ft_fwd(q, q, q, ft=FT, scale=1.0, tau_dh=128)


# ---------------------------------------------------------------------------
# K1 / K5 at the tile and inner FT levels, and K9
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("level", ["tile", "inner"])
@pytest.mark.parametrize("chain", list(ft_gemm.LEVEL_EPILOGUES))
@pytest.mark.parametrize("shape", [(1, 77, 300), (7, 130, 200),
                                   (100, 200, 97)])
def test_gemm_levels_match_plain_f32(cuda, shape, chain, level):
    """Every compiled tile/inner instance against the plain version at the
    kernel's tiles and band: reports equal, an SEU corrected bit for bit
    (located in its band), the same SEU left by a detect-only policy."""
    m, n, k = shape
    gen = torch.Generator(device="cuda").manual_seed(m + n + len(chain))
    a, b = _ints(gen, m, k), _ints(gen, k, n)
    bias = _ints(gen, n) if "bias" in chain else None
    ft = FT.replace(level=level)
    clean, rep = ft_gemm.ft_gemm(a, b, chain=chain, bias=bias, ft=ft)
    assert float(rep[..., 0].sum()) == 0.0
    for pol, inj in ((ft, (1, -1, m - 1, n - 1, 2)),
                     (ft.replace(verify="final"), (1, -1, 0, 5, 0)),
                     (ft.replace(action="detect"), (1, -1, m // 2, n // 3,
                                                    1)),
                     (ft, None)):
        kw = dict(chain=chain, bias=bias, ft=pol, inj=inj, inj_mag=99.0)
        before = ft_gemm.FT_GEMM_2D.launches
        out, rep = ft_gemm.ft_gemm(a, b, **kw)
        assert ft_gemm.FT_GEMM_2D.launches == before + 1
        out_p, rep_p = ft_gemm.ft_gemm_plain(
            a, b, tiles=ft_gemm.pick_tiles(m), **kw)
        torch.testing.assert_close(out, out_p, rtol=1e-5, atol=1e-5)
        _check_reports(rep, rep_p)
        if inj is not None and pol.corrects:
            assert torch.equal(out, clean)
            hit = rep[..., 0] > 0
            assert float(rep[..., 0].sum()) == float(rep[..., 1].sum()) == 1
            assert (int(rep[hit][0, 2]), int(rep[hit][0, 3])) == inj[2:4]
        elif inj is not None:
            assert not torch.equal(out, clean)
            assert float(rep[..., 1].sum()) == 0.0
    off, _ = ft_gemm.ft_gemm(a, b, chain=chain, bias=bias)
    torch.testing.assert_close(off, clean, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("level", ["tile", "inner"])
@pytest.mark.parametrize("product", ["qk", "pv"])
def test_gemm_batched_levels_match_plain_f32(cuda, level, product):
    """K5 at tile / inner on decode attention's views of the cache (the
    transposed K cache takes LAYOUT 1), with a 5-wide injection broadcast
    into every slice and one into a single slice."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    nb, kvh, rep_n, s, dh = 3, 4, 7, 200, 128
    cache = _ints(gen, nb, s, kvh, dh)
    if product == "qk":
        a, b = _ints(gen, nb, kvh, rep_n, dh), cache.permute(0, 2, 3, 1)
    else:
        a, b = _ints(gen, nb, kvh, rep_n, s), cache.transpose(1, 2)
    n = b.shape[-1]
    ft = FT.replace(level=level)
    clean, _ = ft_gemm.ft_gemm(a, b, ft=ft)
    for inj in ((1, -1, rep_n - 1, n - 1, 1), (1, 5, 0, 3, 0)):
        kw = dict(ft=ft, inj=inj, inj_mag=60.0)
        before = ft_gemm.FT_GEMM_BATCHED.launches
        out, rep = ft_gemm.ft_gemm(a, b, **kw)
        assert ft_gemm.FT_GEMM_BATCHED.launches == before + 1
        out_p, rep_p = ft_gemm.ft_gemm_plain(
            a, b, tiles=ft_gemm.pick_tiles(rep_n), **kw)
        torch.testing.assert_close(out, out_p, rtol=1e-5, atol=1e-5)
        _check_reports(rep, rep_p)
        assert float(rep[..., 0].sum()) == (nb * kvh if inj[1] < 0 else 1)
        assert torch.equal(out, clean)


def test_gemm_levels_bf16_match_plain(cuda):
    gen = torch.Generator(device="cuda").manual_seed(6)
    a = torch.randn(37, 300, generator=gen, device="cuda").bfloat16()
    b = (torch.randn(300, 200, generator=gen, device="cuda") * 0.1).bfloat16()
    bias = torch.randn(200, generator=gen, device="cuda").bfloat16()
    for level in ("tile", "inner"):
        kw = dict(chain=("bias", "silu"), bias=bias, ft=FT.replace(level=level))
        out, rep = ft_gemm.ft_gemm(a, b, **kw)
        out_p, rep_p = ft_gemm.ft_gemm_plain(a, b, tiles=ft_gemm.pick_tiles(37),
                                             **kw)
        tol = 2.0 ** -7 * float(out_p.float().abs().max())
        assert float((out.float() - out_p.float()).abs().max()) <= tol
        assert float(rep[..., 0].sum()) == float(rep_p[..., 0].sum()) == 0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(256, 384, 512), (64, 128, 256),
                                   (128, 1024, 100)])
def test_naive_gemm_matches_plain(cuda, dtype, shape):
    from repro_torch.kernels import gemm
    m, n, k = shape
    gen = torch.Generator(device="cuda").manual_seed(m + k)
    a, b = _ints(gen, m, k, dtype=dtype), _ints(gen, k, n, dtype=dtype)
    before = gemm.NAIVE_GEMM.launches
    out = gemm.naive_gemm(a, b)
    assert gemm.NAIVE_GEMM.launches == before + 1
    assert out.dtype == dtype
    assert torch.equal(out, gemm.naive_gemm_plain(a, b))
    with pytest.raises(ValueError):
        gemm.naive_gemm(_ints(gen, 200, k, dtype=dtype), b)


# ---------------------------------------------------------------------------
# training: K1 act_grad and transposed operands, K2 stats, K3, K4
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chain", [("silu",), ("bias", "silu"), ("gelu",),
                                   ("relu",)])
def test_gemm_act_grad_matches_plain_f32(cuda, chain):
    gen = torch.Generator(device="cuda").manual_seed(11 + len(chain))
    m, n, k = 100, 200, 97
    a = torch.randn(m, k, generator=gen, device="cuda")
    b = torch.randn(k, n, generator=gen, device="cuda") * 0.1
    bias = (torch.randn(n, generator=gen, device="cuda")
            if "bias" in chain else None)
    kw = dict(chain=chain, bias=bias, ft=FT, save_act_grad=True,
              inj=(1, -1, 3, 7, 1), inj_mag=25.0)
    (out, ag), rep = ft_gemm.ft_gemm(a, b, **kw)
    (out_p, ag_p), rep_p = ft_gemm.ft_gemm_plain(
        a, b, tiles=ft_gemm.pick_tiles(m), **kw)
    torch.testing.assert_close(out, out_p, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(ag, ag_p, rtol=1e-5, atol=1e-5)
    assert torch.equal(rep[..., [0, 1, 2, 3, 7]], rep_p[..., [0, 1, 2, 3, 7]])
    assert float(rep[..., 0].sum()) == 1.0


@pytest.mark.parametrize("which", ["dx", "dw"])
def test_gemm_transposed_operands_match_plain_f32(cuda, which):
    """The backward GEMMs' operands as views: dx = g·Wᵀ (B = w.T) and
    dw = Xᵀ·g (A = x.T), with an SEU corrected bit for bit."""
    gen = torch.Generator(device="cuda").manual_seed(12)
    t, d_in, d_out = 130, 96, 200
    g = _ints(gen, t, d_out)
    if which == "dx":
        a, b = g, _ints(gen, d_in, d_out).t()
    else:
        a, b = _ints(gen, t, d_in).t(), g
    assert not (a.is_contiguous() and b.is_contiguous())
    kw = dict(ft=FT, inj=(1, -1, a.shape[0] - 1, b.shape[1] - 1, 2),
              inj_mag=70.0)
    out, rep = ft_gemm.ft_gemm(a, b, **kw)
    out_p, rep_p = ft_gemm.ft_gemm_plain(
        a, b, tiles=ft_gemm.pick_tiles(a.shape[0]), **kw)
    torch.testing.assert_close(out, out_p, rtol=1e-5, atol=1e-5)
    _check_reports(rep, rep_p)
    clean, _ = ft_gemm.ft_gemm(a.contiguous(), b.contiguous(), ft=FT)
    assert torch.equal(out, clean)


FLASH_BWD_GEOMS = [(4, 1, 64, 64, 64, True), (6, 3, 100, 100, 128, True),
                   (7, 7, 30, 150, 128, True), (2, 1, 50, 130, 64, False)]


def _flash_bwd_inputs(geom, seed):
    bh, n_rep, sq, skv, dh, causal = geom
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn(bh, sq, dh, generator=gen, device="cuda")
    k = torch.randn(bh // n_rep, skv, dh, generator=gen, device="cuda")
    v = torch.randn(bh // n_rep, skv, dh, generator=gen, device="cuda")
    g = torch.randn(bh, sq, dh, generator=gen, device="cuda")
    kw = dict(ft=FT, scale=dh ** -0.5, tau_dh=128, n_rep=n_rep,
              causal=causal)
    o, m, l, _ = flashft.flash_ft_plain(q, k, v, save_stats=True, **kw)
    di = (g * o).sum(-1)
    return q, k, v, g, o, m, l, di, kw


def _check_flash_reports(rep, rep_p):
    assert torch.equal(rep[..., [0, 1, 7]], rep_p[..., [0, 1, 7]])
    det = rep_p[..., 0] > 0
    assert torch.equal(rep[..., 2:4][det], rep_p[..., 2:4][det])
    torch.testing.assert_close(rep[..., 6], rep_p[..., 6], rtol=1e-5, atol=0)


@pytest.mark.parametrize("geom", FLASH_BWD_GEOMS)
def test_flash_stats_match_plain_f32(cuda, geom):
    q, k, v, _, o_p, m_p, l_p, _, kw = _flash_bwd_inputs(geom, 21)
    o, m, l, rep = flashft.flash_ft_fwd(q, k, v, save_stats=True, **kw)
    torch.testing.assert_close(o, o_p, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(m, m_p, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(l, l_p, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("geom", FLASH_BWD_GEOMS)
def test_flash_dq_dkv_match_plain_f32(cuda, geom):
    bh, n_rep, sq, skv, dh, causal = geom
    q, k, v, g, _, m, l, di, kw = _flash_bwd_inputs(geom, 22)
    for inj_dq, inj_dkv in ((None, None),
                            ((1, 1, bh - 1, (sq - 1) // 64, 0, 5, dh - 1),
                             (1, 3, bh - 1, 0, (sq - 1) // 64, 63, 0)),
                            ((1, 0, 0, 0, 0, 0, 3),
                             (1, 2, n_rep - 1, 0, (sq - 1) // 64, 1, 2))):
        before = flashft.FLASH_DQ.launches, flashft.FLASH_DKV.launches
        dq, rep_q = flashft.flash_ft_dq(q, k, v, g, m, l, di, inj=inj_dq,
                                        inj_mag=40.0, **kw)
        dk, dv, rep_kv = flashft.flash_ft_dkv(q, k, v, g, m, l, di,
                                              inj=inj_dkv, inj_mag=40.0, **kw)
        assert (flashft.FLASH_DQ.launches, flashft.FLASH_DKV.launches) == (
            before[0] + 1, before[1] + 1)
        dq_p, rep_qp = flashft.flash_dq_plain(q, k, v, g, m, l, di,
                                              inj=inj_dq, inj_mag=40.0, **kw)
        dk_p, dv_p, rep_kvp = flashft.flash_dkv_plain(
            q, k, v, g, m, l, di, inj=inj_dkv, inj_mag=40.0, **kw)
        for got, want in ((dq, dq_p), (dk, dk_p), (dv, dv_p)):
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
        _check_flash_reports(rep_q, rep_qp)
        _check_flash_reports(rep_kv, rep_kvp)
        n_inj = 0 if inj_dq is None else 1
        assert float(rep_q[..., 0].sum()) == n_inj
        assert float(rep_kv[..., 0].sum()) == n_inj


def test_bf16_flash_backward_matches_plain(cuda):
    q, k, v, g, _, m, l, di, kw = _flash_bwd_inputs(
        (6, 3, 100, 100, 128, True), 23)
    q, k, v, g = (x.bfloat16() for x in (q, k, v, g))
    dq, _ = flashft.flash_ft_dq(q, k, v, g, m, l, di, **kw)
    dk, dv, _ = flashft.flash_ft_dkv(q, k, v, g, m, l, di, **kw)
    dq_p, _ = flashft.flash_dq_plain(q, k, v, g, m, l, di, **kw)
    dk_p, dv_p, _ = flashft.flash_dkv_plain(q, k, v, g, m, l, di, **kw)
    for got, want in ((dq, dq_p), (dk, dk_p), (dv, dv_p)):
        assert got.dtype == torch.bfloat16
        tol = 2.0 ** -7 * float(want.float().abs().max())
        assert float((got.float() - want.float()).abs().max()) <= tol


# ---------------------------------------------------------------------------
# training: K3 and K4 on the tensor cores (csrc/flash_bwd_sm90.cu)
# ---------------------------------------------------------------------------

SM90_BWD_GEOMS = [  # (bh, n_rep, sq, skv, causal)
    (6, 3, 100, 100, True),      # ragged Sq, n_rep 3 (phi4-mini's)
    (14, 7, 200, 200, True),     # n_rep 7 (qwen2-7b's)
    (32, 16, 256, 256, True),    # n_rep 16 (qwen3-moe-235b-a22b's)
    (6, 3, 70, 300, True),       # Sq != Skv, bottom-right-aligned causal
    (6, 3, 130, 90, False),      # non-causal, Sq > Skv
    (33, 1, 512, 512, True),     # 264 kv blocks: one range, no reduce
]
SM90_COUNTERS = (flashft.FLASH_DQ_SM90, flashft.FLASH_DKV_SM90,
                 flashft.FLASH_DKV_REDUCE, flashft.FLASH_DQ, flashft.FLASH_DKV)


def _sm90_bwd_inputs(geom, seed, ints=False):
    bh, n_rep, sq, skv, causal = geom
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def draw(*shape):
        if ints:
            return _ints(gen, *shape, dtype=torch.bfloat16)
        return torch.randn(*shape, generator=gen, device="cuda").bfloat16()

    q, g = draw(bh, sq, 128), draw(bh, sq, 128)
    k, v = draw(bh // n_rep, skv, 128), draw(bh // n_rep, skv, 128)
    kw = dict(ft=FT, scale=128 ** -0.5, tau_dh=128, n_rep=n_rep,
              causal=causal)
    o, m, l, _ = flashft.flash_ft_plain(q, k, v, save_stats=True, **kw)
    return q, k, v, g, m, l, (g.float() * o.float()).sum(-1), kw


def _sm90_bwd(q, k, v, g, m, l, di, kw, inj_q=None, inj_kv=None, mag=0.0):
    """Both kernels, then both plain versions under the same plan."""
    dq, rq = flashft.flash_ft_dq(q, k, v, g, m, l, di, inj=inj_q,
                                 inj_mag=mag, **kw)
    dk, dv, rkv = flashft.flash_ft_dkv(q, k, v, g, m, l, di, inj=inj_kv,
                                       inj_mag=mag, **kw)
    dq_p, rq_p = flashft.flash_dq_plain(q, k, v, g, m, l, di, inj=inj_q,
                                        inj_mag=mag, **kw)
    dk_p, dv_p, rkv_p = flashft.planned_dkv_plain(q, k, v, g, m, l, di,
                                                  inj=inj_kv, inj_mag=mag,
                                                  **kw)
    return (dq, dk, dv, rq, rkv), (dq_p, dk_p, dv_p, rq_p, rkv_p)


def _check_sm90_bwd(got, want):
    for x, y in zip(got[:3], want[:3]):
        assert x.dtype == torch.bfloat16
        tol = 2.0 ** -7 * float(y.float().abs().max())
        assert float((x.float() - y.float()).abs().max()) <= tol
    for rep, rep_p in zip(got[3:], want[3:]):
        assert torch.equal(rep[..., [0, 1, 2, 3, 7]], rep_p[..., [0, 1, 2, 3, 7]])
        torch.testing.assert_close(rep[..., 6], rep_p[..., 6], rtol=1e-3,
                                   atol=0)


@pytest.mark.parametrize("geom", SM90_BWD_GEOMS)
def test_flash_bwd_sm90_matches_plain(cuda, geom):
    q, k, v, g, m, l, di, kw = _sm90_bwd_inputs(geom, 31)
    p = flashft.plan_bwd(q, k, v, g, n_rep=kw["n_rep"], causal=kw["causal"])
    assert p.instance == "sm90"
    before = [c.launches for c in SM90_COUNTERS]
    got, want = _sm90_bwd(q, k, v, g, m, l, di, kw)
    assert [c.launches - b for c, b in zip(SM90_COUNTERS, before)] == [
        1, 1, int(p.ranges > 1), 0, 0]
    _check_sm90_bwd(got, want)
    assert float(got[3][..., 0].sum() + got[4][..., 0].sum()) == 0.0


@pytest.mark.parametrize("target,blk,step,row,col", [
    ("dp_q", 1, 0, 10, 33),      # dP in K3: head 5, q block 1, kv step 0
    ("dq", 1, 0, 63, 127),       # the dQ delta
    ("dp_kv", 0, 1, 2, 60),      # dP in K4: kv block 0, q block 1
    ("dv", 0, 1, 33, 4),         # the dV delta, in range 7 of 9
    ("dk", 1, 2, 40, 120),       # the dK delta, in the last range
])
def test_flash_bwd_sm90_seu_per_target(cuda, target, blk, step, row, col):
    """One SEU per backward GEMM on integer operands: kernel and plain
    correct it alike and report it at the same place; under a detect-only
    policy both count it once and leave the same gradients (an SEU in a
    delta moves its output element by the magnitude)."""
    geom = (6, 3, 130, 130, True)
    q, k, v, g, m, l, di, kw = _sm90_bwd_inputs(geom, 32, ints=True)
    head = 5
    vec = (1, flashft.BWD_TARGETS[target], head, blk, step, row, col)
    in_q = target in flashft.DQ_TARGETS
    inj = dict(inj_q=vec) if in_q else dict(inj_kv=vec)
    got, want = _sm90_bwd(q, k, v, g, m, l, di, kw, mag=300.0, **inj)
    _check_sm90_bwd(got, want)
    rep = got[3] if in_q else got[4]
    cell = rep[head, blk] if in_q else rep[head // 3, blk]
    assert float(got[3][..., 0].sum() + got[4][..., 0].sum()) == 1.0
    assert float(cell[0]) == 1.0 and float(cell[1]) == 1.0
    want_at = {"dp_q": (blk * 64 + row, step * 64 + col),
               "dq": (blk * 64 + row, col),
               "dp_kv": (step * 64 + row, blk * 64 + col),
               "dv": (blk * 64 + row, col), "dk": (blk * 64 + row, col)}
    assert (int(cell[2]), int(cell[3])) == want_at[target]
    left, left_p = _sm90_bwd(q, k, v, g, m, l, di,
                             dict(kw, ft=FT.replace(action="detect")),
                             mag=300.0, **inj)
    _check_sm90_bwd(left, left_p)
    assert float(left[3][..., 1].sum() + left[4][..., 1].sum()) == 0.0
    assert float(left[3][..., 0].sum() + left[4][..., 0].sum()) == 1.0
    if target in ("dq", "dv", "dk"):
        out = {"dq": 0, "dk": 1, "dv": 2}[target]
        assert float((left[out].float() - got[out].float()).abs().max()) \
            >= 200.0


def test_flash_bwd_simt_pinned(cuda):
    """Pinned blocks keep a bf16 call on the SIMT kernels."""
    q, k, v, g, m, l, di, kw = _sm90_bwd_inputs((6, 3, 100, 100, True), 33)
    before = [c.launches for c in SM90_COUNTERS]
    flashft.flash_ft_dq(q, k, v, g, m, l, di, bq=64, bkv=64, **kw)
    flashft.flash_ft_dkv(q, k, v, g, m, l, di, bq=64, bkv=64, **kw)
    assert [c.launches - b for c, b in zip(SM90_COUNTERS, before)] == [
        0, 0, 0, 1, 1]


# ---------------------------------------------------------------------------
# serving: the paged decode kernel K6
# ---------------------------------------------------------------------------

def _decode_inputs(dh, page, kvh, n_rep, lengths, dtype, seed):
    """Pools full of stale values, every slot's pages drawn out of order
    from a shuffled pool, q padded to the dtype's sublane multiple as
    `ops.flash_ft_decode` pads it."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    b = len(lengths)
    mp = max(-(-max(lengths) // page), 1) + 1
    n_pages = 1 + b * mp
    k, v = (torch.randn(n_pages, kvh, page, dh, generator=gen, device="cuda"
                        ).to(dtype) for _ in range(2))
    perm = torch.randperm(n_pages - 1, generator=gen, device="cuda") + 1
    table = perm[:b * mp].view(b, mp).to(torch.int32)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    sub = flashft.sublane(dtype)
    bq = -(-n_rep // sub) * sub
    q = torch.zeros(b * kvh, bq, dh, device="cuda", dtype=dtype)
    q[:, :n_rep] = torch.randn(b * kvh, n_rep, dh, generator=gen,
                               device="cuda").to(dtype)
    return q, k, v, lens, table


DECODE_GEOMS = [(128, 16, 2, 2), (128, 64, 4, 7), (256, 32, 1, 4),
                (128, 32, 4, 1)]


@pytest.mark.parametrize("geom", DECODE_GEOMS)
def test_decode_matches_plain_f32(cuda, geom):
    dh, page, kvh, n_rep = geom
    lengths = [0, 1, page - 1, page, page + 1, 3 * page + 5]
    q, k, v, lens, table = _decode_inputs(dh, page, kvh, n_rep, lengths,
                                          torch.float32, 31)
    kw = dict(ft=FT, scale=dh ** -0.5, tau_dh=dh)
    g_last = 5 * kvh + kvh - 1                   # slot 5, last kv head
    for inj in (None, (1, g_last, 0, 3, n_rep - 1, dh - 1),
                (1, kvh, 0, 0, 0, 0)):
        before = flashft.FLASH_DECODE.launches
        out, rep = flashft.flash_ft_decode(q, k, v, lens, table, inj=inj,
                                           inj_mag=40.0, **kw)
        assert flashft.FLASH_DECODE.launches == before + 1
        out_p, rep_p = flashft.flash_decode_plain(q, k, v, lens, table,
                                                  inj=inj, inj_mag=40.0, **kw)
        torch.testing.assert_close(out, out_p, rtol=1e-5, atol=1e-5)
        _check_flash_reports(rep, rep_p)
        assert float(rep[..., 0].sum()) == (inj is not None)
        assert not out[:kvh].any() and not rep[:kvh].any()   # dead slot 0


def test_decode_bf16_matches_plain(cuda):
    lengths = [0, 1, 63, 64, 65, 300, 777, 1024]
    q, k, v, lens, table = _decode_inputs(128, 64, 4, 7, lengths,
                                          torch.bfloat16, 32)
    kw = dict(ft=FT, scale=128 ** -0.5, tau_dh=128)
    out, rep = flashft.flash_ft_decode(q, k, v, lens, table, **kw)
    out_p, rep_p = flashft.planned_decode_plain(q, k, v, lens, table, **kw)
    assert out.dtype == torch.bfloat16
    tol = 2.0 ** -7 * float(out_p.float().abs().max())
    assert float((out.float() - out_p.float()).abs().max()) <= tol
    _check_flash_reports(rep, rep_p)
    assert float(rep[..., 0].sum()) == 0.0


def test_decode_seu_corrected_and_left_by_detect_only(cuda):
    """Integer-valued V and one-hot 64·e_t q and k (the reference's exact
    operands): an SEU in Δ at the slot's last live page is corrected bit
    for bit and located; a detect-only policy leaves it in the output."""
    dh, page, kvh = 256, 16, 2
    lengths = [272, 320]
    b, mp = len(lengths), 512 // page
    n_pages = 1 + b * mp
    gen = torch.Generator(device="cuda").manual_seed(33)
    k = torch.zeros(n_pages, kvh, page, dh, device="cuda")
    v = torch.randint(-2, 3, (n_pages, kvh, page, dh), generator=gen,
                      device="cuda").float()
    table = (torch.arange(b * mp, device="cuda").view(b, mp) + 1).int()
    for s, length in enumerate(lengths):
        for t in range(length):
            k[table[s, t // page], :, t % page, t % dh] = 64.0
    tq = torch.randint(0, dh, (b * kvh, 4), generator=gen, device="cuda")
    q = torch.zeros(b * kvh, 8, dh, device="cuda")
    q[:, :4] = 64.0 * torch.nn.functional.one_hot(tq, dh).float()
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    kw = dict(scale=dh ** -0.5, tau_dh=dh)
    clean, rep0 = flashft.flash_ft_decode(q, k, v, lens, table, ft=FT, **kw)
    assert float(rep0[..., 0].sum()) == 0.0
    inj = (1, kvh, 0, 320 // page - 1, 1, 7)   # slot 1, head 0, last page
    out, rep = flashft.flash_ft_decode(q, k, v, lens, table, ft=FT, inj=inj,
                                       inj_mag=777.0, **kw)
    assert torch.equal(out, clean)
    cell = rep[kvh, 0]
    assert (float(rep[..., 0].sum()), int(cell[2]), int(cell[3])) == (1.0, 1,
                                                                      7)
    assert abs(float(cell[4]) - 777.0) < 1.0
    left, rep_d = flashft.flash_ft_decode(
        q, k, v, lens, table, ft=FT.replace(action="detect"), inj=inj,
        inj_mag=777.0, **kw)
    assert float(rep_d[..., 0].sum()) == 1.0 and float(rep_d[..., 1].sum()) == 0
    assert float((left - clean).abs().max()) > 1.0


def test_decode_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    q, k, v, lens, table = _decode_inputs(128, 16, 2, 2, [5, 20],
                                          torch.float32, 34)
    kw = dict(ft=FT, scale=1.0, tau_dh=128)
    with pytest.raises(ValueError, match="pages"):
        flashft.flash_ft_decode(q, k[..., :8, :].contiguous(),
                                v[..., :8, :].contiguous(), lens, table, **kw)
    with pytest.raises(ValueError, match="head dim"):
        flashft.flash_ft_decode(q[..., :64].contiguous(),
                                k[..., :64].contiguous(),
                                v[..., :64].contiguous(), lens, table, **kw)
    with pytest.raises(ValueError, match="int32"):
        flashft.flash_ft_decode(q, k, v, lens.long(), table, **kw)
    with pytest.raises(ValueError, match="query rows"):
        flashft.flash_ft_decode(torch.zeros(4, 40, 128, device="cuda"), k, v,
                                lens, table, **kw)
    with pytest.raises(TypeError):
        flashft.flash_ft_decode(q.half(), k.half(), v.half(), lens, table,
                                **kw)


# ---------------------------------------------------------------------------
# K2 and K6 on the tensor cores (csrc/flash_fwd_sm90.cu,
# csrc/flash_decode_sm90.cu) and the flash fronts' head-dim padding
# ---------------------------------------------------------------------------

BF16_TOL = 2.0 ** -7
DECODE_LENGTHS = [0, 1, 63, 64, 65, 300, 777, 1024]


def _bf16_close(got, want):
    tol = BF16_TOL * float(want.float().abs().max())
    assert float((got.float() - want.float()).abs().max()) <= tol


def _check_fields(rep, rep_p):
    """det, corr, row, col and k equal; tau within 1e-5."""
    assert torch.equal(rep[..., [0, 1, 2, 3, 7]], rep_p[..., [0, 1, 2, 3, 7]])
    torch.testing.assert_close(rep[..., 6], rep_p[..., 6], rtol=1e-5, atol=0)


def _left_in_place(left, clean):
    """A detect-only run left its SEU in the output: off the clean one by
    more than four bf16 ulps at the top of the output's range."""
    moved = float((left.float() - clean.float()).abs().max())
    assert moved > 4 * BF16_TOL * float(clean.float().abs().max())


def _launched(kernels, fn):
    before = [k.launches for k in kernels]
    out = fn()
    return out, [k.launches - b for k, b in zip(kernels, before)]


FWD_SM90_GEOMS = [(6, 3, 1, 1, True), (14, 7, 63, 63, True),
                  (14, 7, 65, 65, False), (4, 1, 300, 300, True),
                  (6, 3, 300, 317, True), (2, 1, 65, 130, False),
                  (4, 1, 16, 300, False), (3, 1, 200, 200, False),
                  (4, 2, 130, 130, True)]


@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("save_stats", [False, True])
@pytest.mark.parametrize("geom", FWD_SM90_GEOMS)
def test_flash_fwd_sm90_matches_plain(cuda, geom, save_stats, dh):
    """The tensor-core K2 at both head dims: MHA (whose work units are
    neighbouring q blocks of one head, three a CTA at dh 64, so some CTAs
    hold fewer units than warpgroups and, causal, walks shorter than the
    ring's) and GQA (query heads of one group a CTA) against the plain
    version."""
    bh, n_rep, sq, skv, causal = geom
    gen = torch.Generator(device="cuda").manual_seed(bh + sq + skv + dh)
    q = torch.randn(bh, sq, dh, generator=gen, device="cuda").bfloat16()
    k, v = (torch.randn(bh // n_rep, skv, dh, generator=gen,
                        device="cuda").bfloat16() for _ in range(2))
    kw = dict(ft=FT, scale=dh ** -0.5, tau_dh=128, n_rep=n_rep,
              causal=causal, save_stats=save_stats)
    assert flashft.plan_fwd(q, k, v).instance == "sm90"
    res, n = _launched((flashft.FLASH_FT_SM90, flashft.FLASH_FT),
                       lambda: flashft.flash_ft_fwd(q, k, v, **kw))
    assert n == [1, 0]
    res_p = flashft.flash_ft_plain(q, k, v, **kw)
    _bf16_close(res[0], res_p[0])
    _check_fields(res[-1], res_p[-1])
    assert float(res[-1][..., 0].sum()) == 0.0
    if save_stats:
        torch.testing.assert_close(res[1], res_p[1], rtol=1e-4, atol=1e-4)
        torch.testing.assert_close(res[2], res_p[2], rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("dh,n_rep", [(128, 3), (64, 3), (64, 1)])
@pytest.mark.parametrize("target", [flashft.INJ_DELTA, flashft.INJ_S])
def test_flash_fwd_sm90_seu(cuda, target, dh, n_rep):
    """An SEU in Δ or in S of (query head 4, q block 2, kv step 1) on
    integer-valued operands: corrected and located as the plain version
    locates it; a detect-only policy counts it and leaves it."""
    gen = torch.Generator(device="cuda").manual_seed(41)
    bh, s = 6, 200
    q = _ints(gen, bh, s, dh, dtype=torch.bfloat16)
    k, v = (_ints(gen, bh // n_rep, s, dh, dtype=torch.bfloat16)
            for _ in range(2))
    col = dh - 29 if target == flashft.INJ_DELTA else 40
    inj = (target, 4, 2, 1, 17, col)
    kw = dict(scale=dh ** -0.5, tau_dh=128, n_rep=n_rep, causal=True)
    clean, rep0 = flashft.flash_ft_fwd(q, k, v, ft=FT, **kw)
    assert float(rep0[..., 0].sum()) == 0.0
    out, rep = flashft.flash_ft_fwd(q, k, v, ft=FT, inj=inj, inj_mag=300.0,
                                    **kw)
    out_p, rep_p = flashft.flash_ft_plain(q, k, v, ft=FT, inj=inj,
                                          inj_mag=300.0, **kw)
    _check_fields(rep, rep_p)
    cell = rep[4, 2]
    want_col = col if target == flashft.INJ_DELTA else 64 + col
    assert (float(rep[..., 0].sum()), float(rep[..., 1].sum())) == (1.0, 1.0)
    assert (int(cell[2]), int(cell[3])) == (2 * 64 + 17, want_col)
    assert abs(float(cell[4]) - 300.0) < 1.0
    _bf16_close(out, clean)
    left, rep_d = flashft.flash_ft_fwd(q, k, v, ft=FT.replace(action="detect"),
                                       inj=inj, inj_mag=300.0, **kw)
    assert (float(rep_d[..., 0].sum()), float(rep_d[..., 1].sum())) == (1.0,
                                                                        0.0)
    _left_in_place(left, clean)


@pytest.mark.parametrize("page", [32, 64])
@pytest.mark.parametrize("kvh,n_rep", [(4, 7), (2, 3), (4, 16)])
def test_decode_sm90_matches_plain(cuda, page, kvh, n_rep):
    q, k, v, lens, table = _decode_inputs(128, page, kvh, n_rep,
                                          DECODE_LENGTHS, torch.bfloat16,
                                          page + kvh + n_rep)
    kw = dict(ft=FT, scale=128 ** -0.5, tau_dh=128)
    p = flashft.plan_decode(q, k, v, table)
    assert p.instance == "sm90" and p.ranges == flashft.decode_ranges(
        q.shape[0], table.shape[1]) > 1
    (out, rep), n = _launched(
        (flashft.FLASH_DECODE_SM90, flashft.FLASH_DECODE_COMBINE,
         flashft.FLASH_DECODE),
        lambda: flashft.flash_ft_decode(q, k, v, lens, table, **kw))
    assert n == [1, 1, 0]
    out_p, rep_p = flashft.planned_decode_plain(q, k, v, lens, table, **kw)
    _bf16_close(out[:, :n_rep], out_p[:, :n_rep])
    _check_fields(rep, rep_p)
    _, rep_u = flashft.flash_decode_plain(q, k, v, lens, table, **kw)
    assert torch.equal(rep[..., [0, 1, 2, 3, 7]], rep_u[..., [0, 1, 2, 3, 7]])
    assert float(rep[..., 0].sum()) == 0.0
    assert not out[:kvh].any() and not rep[:kvh].any()      # dead slot 0


@pytest.mark.parametrize("target", [flashft.INJ_DELTA, flashft.INJ_S])
def test_decode_sm90_seu(cuda, target):
    """An SEU in Δ or S of slot 6 (777 tokens), kv head 2, page 5 on
    integer-valued operands: corrected and located as the plain version
    under the same plan; a detect-only policy counts it and leaves it."""
    gen = torch.Generator(device="cuda").manual_seed(43)
    kvh, n_rep, page = 4, 7, 64
    q, k, v, lens, table = _decode_inputs(128, page, kvh, n_rep,
                                          DECODE_LENGTHS, torch.bfloat16, 44)
    q = torch.where(q != 0, _ints(gen, *q.shape, dtype=torch.bfloat16), q)
    k, v = (_ints(gen, *k.shape, dtype=torch.bfloat16) for _ in range(2))
    g = 6 * kvh + 2
    col = 100 if target == flashft.INJ_DELTA else 20
    inj = (target, g, 0, 5, 3, col)
    kw = dict(scale=128 ** -0.5, tau_dh=128)
    clean, _ = flashft.flash_ft_decode(q, k, v, lens, table, ft=FT, **kw)
    out, rep = flashft.flash_ft_decode(q, k, v, lens, table, ft=FT, inj=inj,
                                       inj_mag=300.0, **kw)
    _, rep_p = flashft.planned_decode_plain(q, k, v, lens, table, ft=FT,
                                            inj=inj, inj_mag=300.0, **kw)
    _check_fields(rep, rep_p)
    cell = rep[g, 0]
    want_col = col if target == flashft.INJ_DELTA else 5 * page + col
    assert (float(rep[..., 0].sum()), float(rep[..., 1].sum())) == (1.0, 1.0)
    assert (int(cell[2]), int(cell[3])) == (3, want_col)
    assert abs(float(cell[4]) - 300.0) < 1.0
    _bf16_close(out[:, :n_rep], clean[:, :n_rep])
    left, rep_d = flashft.flash_ft_decode(
        q, k, v, lens, table, ft=FT.replace(action="detect"), inj=inj,
        inj_mag=300.0, **kw)
    assert (float(rep_d[..., 0].sum()), float(rep_d[..., 1].sum())) == (1.0,
                                                                        0.0)
    _left_in_place(left, clean)


def test_decode_combine_matches_its_plain_version(cuda):
    q, k, v, lens, table = _decode_inputs(128, 64, 4, 7, DECODE_LENGTHS,
                                          torch.bfloat16, 45)
    kw = dict(ft=FT, scale=128 ** -0.5, tau_dh=128)
    p = flashft.plan_decode(q, k, v, table)
    g = q.shape[0]
    ws = torch.full((p.ranges * g * flashft.DECODE_PARTIAL,), float("nan"),
                    device="cuda")
    inj = (0,) * 6
    flashft.FLASH_DECODE_SM90(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lens.data_ptr(),
        table.data_ptr(), ws.data_ptr(), p.ranges, lens.shape[0], 4, 16, 128,
        64, table.shape[1], k.shape[0], 1, 1, 128 ** -0.5,
        FT.rel_tau * flashft.F32EPS * 128, FT.rel_tau * flashft.F32EPS, *inj, 0.0,
        *ft_gemm.seu_args(None, FT, 0), torch.cuda.current_stream().cuda_stream)
    out = torch.empty_like(q)
    rep = torch.empty(g, 1, 8, device="cuda")
    flashft.FLASH_DECODE_COMBINE(ws.data_ptr(), out.data_ptr(),
                                 rep.data_ptr(), g, p.ranges,
                                 torch.cuda.current_stream().cuda_stream)
    out_p, rep_p = flashft.combine_ws_plain(ws, g, p.ranges)
    _bf16_close(out, out_p)
    assert torch.equal(rep, rep_p)
    whole, rep_w = flashft.flash_ft_decode(q, k, v, lens, table, **kw)
    assert torch.equal(out, whole) and torch.equal(rep, rep_w)


def test_flash_sm90_plans_route_the_rest_to_simt(cuda):
    gen = torch.Generator(device="cuda").manual_seed(46)
    fkw = dict(ft=FT, scale=0.1, tau_dh=128, n_rep=2, causal=True)
    for dtype, dh, pin in ((torch.float32, 128, None),
                           (torch.float32, 64, None),
                           (torch.bfloat16, 64, 64),
                           (torch.bfloat16, 128, 64)):
        q = torch.randn(4, 70, dh, generator=gen, device="cuda").to(dtype)
        kv = torch.randn(2, 70, dh, generator=gen, device="cuda").to(dtype)
        assert flashft.plan_fwd(q, kv, kv, bq=pin, bkv=pin).instance == "simt"
        (out, rep), n = _launched(
            (flashft.FLASH_FT_SM90, flashft.FLASH_FT),
            lambda: flashft.flash_ft_fwd(q, kv, kv, bq=pin, bkv=pin, **fkw))
        assert n == [0, 1]
        out_p, rep_p = flashft.flash_ft_plain(q, kv, kv, **fkw)
        _bf16_close(out, out_p)
        _check_fields(rep, rep_p)
        with pytest.raises(ValueError, match="SIMT"):
            flashft.flash_ft_fwd(q, kv, kv, bq=pin, bkv=pin,
                                 inj=(flashft.INJ_S, 0, 0, 0, 0, 0), **fkw)
    dkw = dict(ft=FT, scale=0.1, tau_dh=128)
    for dh, page, n_rep, dtype, simt in ((128, 64, 7, torch.float32, False),
                                         (256, 64, 7, torch.bfloat16, False),
                                         (128, 16, 7, torch.bfloat16, False),
                                         (128, 64, 20, torch.bfloat16, False),
                                         (128, 64, 7, torch.bfloat16, True)):
        q, k, v, lens, table = _decode_inputs(dh, page, 2, n_rep,
                                              [0, 5, 3 * page + 1], dtype, 47)
        assert flashft.plan_decode(q, k, v, table, simt=simt).instance == \
            "simt"
        (out, rep), n = _launched(
            (flashft.FLASH_DECODE_SM90, flashft.FLASH_DECODE),
            lambda: flashft.flash_ft_decode(q, k, v, lens, table, simt=simt,
                                            **dkw))
        assert n == [0, 1]
        out_p, rep_p = flashft.flash_decode_plain(q, k, v, lens, table, **dkw)
        _bf16_close(out, out_p)
        _check_fields(rep, rep_p)


@pytest.mark.parametrize("dh", [16, 80])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_fronts_pad_the_head_dim(cuda, dh, dtype):
    """ops.flash_ft / flash_ft_bwd at head dims the kernels do not compile:
    padded to 64 or 128, run on the kernels (the forward on the tensor
    cores for bf16 at both), sliced back, and equal to the same fronts on
    the CPU (the plain versions) within one bf16 ulp or 1e-5 (f32)."""
    from repro_torch.kernels import ops
    gen = torch.Generator(device="cuda").manual_seed(dh)
    bh, n_rep, sq = 6, 3, 100
    q, g = (torch.randn(bh, sq, dh, generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    k, v = (torch.randn(bh // n_rep, sq, dh, generator=gen,
                        device="cuda").to(dtype) for _ in range(2))
    kw = dict(ft=FT, causal=True, n_rep=n_rep)
    fwd = (flashft.FLASH_FT_SM90, flashft.FLASH_FT)
    (o, m, l, rep), n = _launched(fwd, lambda: ops.flash_ft(
        q, k, v, save_stats=True, **kw))
    assert n == ([1, 0] if dtype == torch.bfloat16 else [0, 1])
    cpu = [x.cpu() for x in (q, k, v, g)]
    o_p, m_p, l_p, rep_p = ops.flash_ft(*cpu[:3], save_stats=True, **kw)
    grads = ops.flash_ft_bwd(q, k, v, o, m, l, g, **kw)
    grads_p = ops.flash_ft_bwd(*cpu[:3], o.cpu(), m.cpu(), l.cpu(), cpu[3],
                               **kw)
    for got, want in zip((o,) + grads[:3], (o_p,) + grads_p[:3]):
        assert got.shape == want.shape and got.shape[-1] == dh
        if dtype == torch.float32:
            torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
        else:
            _bf16_close(got.cpu(), want)
    for got, want in ((rep, rep_p), (grads[3], grads_p[3]),
                      (grads[4], grads_p[4])):
        _check_fields(got.cpu(), want)


# ---------------------------------------------------------------------------
# K7 / K8: the grouped GEMMs of the MoE layer
# ---------------------------------------------------------------------------

def _grouped_layout(sizes, bm, seed):
    from repro_torch.kernels.grouped import layout as glay
    gids = torch.cat([torch.full((n,), g, dtype=torch.long)
                      for g, n in enumerate(sizes)])
    gen = torch.Generator().manual_seed(seed)
    gids = gids[torch.randperm(len(gids), generator=gen)].cuda()
    return glay.make_layout(gids, len(sizes), bm), glay


#: Ragged groups, empty ones, and a fully dead tail of tiles (the buffer's
#: worst-case capacity is far above the live rows).
GROUP_SIZES = [13, 0, 29, 7, 0, 16]


@pytest.mark.parametrize("dtype,bm", [(torch.float32, 8),
                                      (torch.float32, 16),
                                      (torch.bfloat16, 16)])
def test_grouped_gemm_matches_plain(cuda, dtype, bm):
    from repro_torch.kernels import grouped_gemm as kgg
    lay, glay = _grouped_layout(GROUP_SIZES, bm, 1)
    gen = torch.Generator(device="cuda").manual_seed(bm)
    k, n, ng = 200, 300, len(GROUP_SIZES)
    buf = glay.scatter_rows(_ints(gen, lay.n_rows, k, dtype=dtype), lay)
    w = _ints(gen, ng, k, n, dtype=dtype)
    wt = _ints(gen, ng, n, k, dtype=dtype).transpose(-1, -2)
    base = lay.base.tolist()
    dead_row = lay.t_buf - 1
    assert lay.t_buf - int(lay.row_end[-1]) > bm      # a dead tail of tiles
    for ww in (w, wt):
        for ft, inj in ((FT, None), (FT, (1, base[2] + 28, n - 1, 3)),
                        (FT.replace(action="detect"), (1, base[2] + 28,
                                                       n - 1, 3)),
                        (FT.replace(verify="final"), (1, base[0], 5, 0)),
                        (FT, (1, dead_row, 7, 1)), (None, None)):
            kw = dict(ft=ft, inj=inj, inj_mag=99.0)
            before = kgg.FT_GEMM_GROUPED.launches
            out, rep = kgg.ft_gemm_grouped(buf, ww, lay.gid, lay.row_end,
                                           tiles=(bm, 128, 32), **kw)
            assert kgg.FT_GEMM_GROUPED.launches == before + 1
            out_p, rep_p = kgg.ft_gemm_grouped_plain(
                buf, ww, lay.gid, lay.row_end, tiles=(bm, 128, 32), **kw)
            assert torch.equal(out, out_p)
            if ft is None:
                assert rep is None
                continue
            _check_reports(rep, rep_p)
            n_det, n_corr = float(rep[..., 0].sum()), float(rep[..., 1].sum())
            if inj is None:
                assert n_det == n_corr == 0.0
            elif ft.corrects:
                assert n_det == n_corr == 1.0
            else:      # detect-only: counted again at every later verify
                assert n_det >= 1.0 and n_corr == 0.0
            if inj is not None and ft.corrects:
                clean, _ = kgg.ft_gemm_grouped(buf, ww, lay.gid, lay.row_end,
                                               ft=FT, tiles=(bm, 128, 32))
                assert torch.equal(out, clean)


@pytest.mark.parametrize("dtype,bm", [(torch.float32, 8),
                                      (torch.float32, 16),
                                      (torch.bfloat16, 16)])
def test_tgmm_matches_plain(cuda, dtype, bm):
    from repro_torch.kernels import grouped as kgrouped
    from repro_torch.kernels import grouped_gemm as kgg
    from repro_torch.kernels.templates import BatchedKernelSpec
    lay, glay = _grouped_layout(GROUP_SIZES, bm, 2)
    gen = torch.Generator(device="cuda").manual_seed(10 + bm)
    k, n = 150, 200
    x = glay.scatter_rows(_ints(gen, lay.n_rows, k, dtype=dtype), lay)
    g = glay.scatter_rows(_ints(gen, lay.n_rows, n, dtype=dtype), lay)
    spec = BatchedKernelSpec(ft_level="block", tgmm=True)
    base, counts = lay.base.tolist(), lay.counts.tolist()
    last_tile = (base[-1] + counts[-1] - 1) // bm    # the last group's
    for ft, inj in ((FT, None), (FT, (1, k - 1, 70, base[2] // bm + 1)),
                    (FT.replace(action="detect"), (1, 3, n - 1, last_tile)),
                    (FT.replace(verify="final"), (1, 64, 64, base[0] // bm)),
                    (FT.replace(action="detect"), (1, 5, 5,
                                                   lay.num_tiles - 1))):
        tinj = None if inj is None else InjectionSpec(
            row=inj[1], col=inj[2], magnitude=50.0, k_step=inj[3])
        before = kgg.TGMM.launches
        dw, rep = kgrouped.tgmm_buffer_call(spec, x, g, lay, ft=ft,
                                            inject=tinj, tiles=(bm, 64, 64))
        assert kgg.TGMM.launches == before + 1
        dw_p, rep_p = kgg.tgmm_plain(x, g, lay.row_end, tiles=(bm, 64, 64),
                                     ft=ft, inj=inj, inj_mag=50.0)
        assert dw.dtype == torch.float32
        assert torch.equal(dw, dw_p)
        _check_reports(rep, rep_p)
        for e in range(len(GROUP_SIZES)):
            if counts[e] == 0:
                assert not dw[e].any() and not rep[e].any()
        n_det = float(rep[..., 0].sum())
        assert (n_det == 0) == (inj is None)
        if inj is not None and inj[3] == last_tile and not ft.corrects:
            # the last group re-verifies a detect-only SEU once per dead
            # tile of the buffer, as the reference's walk does
            assert n_det > 1


def test_grouped_autograd_on_card_matches_plain_path(cuda):
    """`ft_grouped_matmul` forward and grads through K7 (forward, dbuf) and
    K8 (dw) on the card against the same call on the CPU (the plain
    versions), integer operands: equal bit for bit, clean and with a
    corrected dw SEU."""
    from repro_torch.core import ft_gemm as core
    gen = torch.Generator().manual_seed(7)
    t, ng, k, n = 90, 6, 96, 160
    gids = torch.randint(0, ng, (t,), generator=gen)
    gids[gids == 4] = 3                                # an empty group
    x = torch.randint(-2, 3, (t, k), generator=gen).float()
    w = torch.randint(-2, 3, (ng, k, n), generator=gen).float()
    r = torch.randint(-2, 3, (t, n), generator=gen).float()

    def run(dev, bwd_inject=None):
        xx = x.to(dev).detach().requires_grad_(True)
        ww = w.to(dev).detach().requires_grad_(True)
        y = core.ft_grouped_matmul(xx, ww, gids.to(dev), ft=FT,
                                   bwd_inject=bwd_inject)
        (y * r.to(dev)).sum().backward()
        return y.detach().cpu(), xx.grad.cpu(), ww.grad.cpu()

    want = run("cpu")
    got = run("cuda")
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    hurt = run("cuda", ("dw", InjectionSpec(row=3, col=5, magnitude=40.0,
                                            k_step=1)))
    for a, b in zip(hurt, want):
        assert torch.equal(a, b)


def test_engine_at_max_len_40_runs_k6(cuda):
    """The default page at max_len 40 is 64 (the clamp alone gave 48, which
    K6 does not compile): a dense engine with dh 128 on the kernel backend
    serves two requests through K6."""
    from repro_torch.configs.base import ModelConfig, RunConfig
    from repro_torch.models import transformer
    from repro_torch.train import engine
    cfg = ModelConfig(arch_id="tiny", family="dense", n_layers=2, d_model=64,
                      n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256,
                      head_dim=128)
    run = RunConfig(model=cfg, ft=FT, dtype="bfloat16")
    params = transformer.init(cfg, seed=0, dtype=torch.bfloat16)
    eng = engine.ServeEngine(params, cfg, run,
                             engine.EngineConfig(max_len=40, n_slots=2))
    assert eng.plan.page_size == 64
    k6 = (flashft.FLASH_DECODE, flashft.FLASH_DECODE_SM90)
    before = sum(x.launches for x in k6)
    eng.submit(list(range(1, 30)), max_new_tokens=8)
    eng.submit(list(range(3, 9)), max_new_tokens=5)
    res = eng.run()
    assert [len(r.tokens) for r in res] == [8, 5]
    assert sum(x.launches for x in k6) > before
    assert eng.alloc.n_free == eng.plan.n_pages - 1


# ---------------------------------------------------------------------------
# K1 on the tensor cores (csrc/ft_gemm_sm90.cu)
# ---------------------------------------------------------------------------

def _walk_operands(gen, m, n, k, walk, make):
    """A (M, K) and B (K, N) of a walk: 0 row-major, 1 B = w.T, 2 A = x.T."""
    a = make(gen, k, m).t() if walk == 2 else make(gen, m, k)
    b = make(gen, n, k).t() if walk == 1 else make(gen, k, n)
    return a, b


def _bf16(gen, *shape):
    return (torch.randn(*shape, generator=gen, device="cuda") * 0.5).bfloat16()


@pytest.mark.parametrize("walk", [0, 1, 2])
@pytest.mark.parametrize("shape", [(8, 512, 3584), (56, 200, 320),
                                   (200, 384, 1024), (256, 256, 512)])
@pytest.mark.parametrize("chain", [(), ("bias",), ("silu",),
                                   ("bias", "silu")])
def test_sm90_matches_plain(cuda, shape, chain, walk):
    """Every operand walk, both row tiles and split-K against the plain
    version under the same plan, FT off, block at either verify, act_grad."""
    m, n, k = shape
    gen = torch.Generator(device="cuda").manual_seed(m + n + walk)
    a, b = _walk_operands(gen, m, n, k, walk, _bf16)
    bias = _bf16(gen, n) if "bias" in chain else None
    for ft in (None, FT, FT.replace(verify="final")):
        for ag in ((False, True) if chain[-1:] == ("silu",) else (False,)):
            kw = dict(chain=chain, bias=bias, ft=ft, save_act_grad=ag)
            p = ft_gemm.plan_call(a, b, chain=chain, ft=ft,
                                  save_act_grad=ag)
            assert p.instance == "sm90"
            before = ft_gemm.FT_GEMM_SM90.launches, ft_gemm.FT_GEMM_2D.launches
            out, rep = ft_gemm.ft_gemm(a, b, **kw)
            assert (ft_gemm.FT_GEMM_SM90.launches,
                    ft_gemm.FT_GEMM_2D.launches) == (before[0] + 1,
                                                     before[1] + 1)
            out_p, rep_p = ft_gemm.planned_plain(a, b, **kw)
            for got, want in zip(out if ag else (out,),
                                 out_p if ag else (out_p,)):
                tol = 2.0 ** -7 * float(want.float().abs().max())
                assert float((got.float() - want.float()).abs().max()) <= tol
            if ft is not None:
                assert torch.equal(rep[..., [0, 1, 2, 3, 7]],
                                   rep_p[..., [0, 1, 2, 3, 7]])
                assert float(rep[..., 0].sum()) == 0.0
                torch.testing.assert_close(rep[..., 6], rep_p[..., 6],
                                           rtol=1e-5, atol=0)


@pytest.mark.parametrize("walk", [0, 1, 2])
def test_sm90_seu_in_every_split(cuda, walk):
    """An SEU at the first, a middle and the last k-step, each in its own
    split: corrected bit for bit and located; detect-only leaves it and
    counts it at each later verification of its split and at the final
    one."""
    gen = torch.Generator(device="cuda").manual_seed(40 + walk)
    m, n, k = 8, 384, 2560
    a, b = _walk_operands(gen, m, n, k, walk, lambda g, *s: _ints(
        g, *s, dtype=torch.bfloat16))
    p = ft_gemm.plan_call(a, b, ft=FT)
    ranges = ft_gemm.split_ranges(k, p.tiles[2], p.splits)
    assert p.splits > 2
    clean, _ = ft_gemm.ft_gemm(a, b, ft=FT)
    for step in (0, ranges[p.splits // 2][0] + 1, ranges[-1][1] - 1):
        z = next(i for i, (lo, hi) in enumerate(ranges) if lo <= step < hi)
        inj = (1, -1, m - 1, n - 5, step)
        out, rep = ft_gemm.ft_gemm(a, b, ft=FT, inj=inj, inj_mag=300.0)
        assert torch.equal(out, clean)
        cell = rep[rep[..., 0] > 0]
        assert float(rep[..., 0].sum()) == 1.0 and cell.shape[0] == 1
        assert (int(cell[0, 2]), int(cell[0, 3])) == (m - 1, n - 5)
        det = FT.replace(action="detect")
        out_d, rep_d = ft_gemm.ft_gemm(a, b, ft=det, inj=inj, inj_mag=300.0)
        _, rep_p = ft_gemm.planned_plain(a, b, ft=det, inj=inj,
                                         inj_mag=300.0)
        diff = (out_d.float() - clean.float()).abs()
        assert (diff > 0).nonzero().tolist() == [[m - 1, n - 5]]
        assert abs(float(diff.max()) - 300.0) <= 2.0   # bf16 rounding
        want = max(0, ranges[z][1] - 1 - step) + 1
        assert float(rep_d[..., 0].sum()) == float(rep_p[..., 0].sum()) == want
        assert torch.equal(rep_d[..., :4], rep_p[..., :4])


def test_sm90_plan_routes_the_rest_to_simt(cuda):
    """A stride TMA cannot take, an unaligned base and f32 (at block and
    at the tile level) run on the SIMT instance; pinned tensor-core tiles
    raise for them."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    a, b = _bf16(gen, 16, 300), _bf16(gen, 300, 256)
    base = _bf16(gen, 16 * 264 + 1)
    cases = [(a, b, FT),                                  # lda 300
             (base[1:].view(16, 264), _bf16(gen, 264, 256), FT),  # unaligned
             (a.float(), b.float(), FT),
             (_bf16(gen, 16, 256).float(), _bf16(gen, 256, 256).float(),
              FT.replace(level="tile"))]
    for x, y, ft in cases:
        p = ft_gemm.plan_call(x, y, ft=ft)
        assert p.instance == "simt" and p.reason
        before = ft_gemm.FT_GEMM_2D_SIMT.launches
        ft_gemm.ft_gemm(x, y, ft=ft)
        assert ft_gemm.FT_GEMM_2D_SIMT.launches == before + 1
        with pytest.raises(ValueError):
            ft_gemm.ft_gemm(x, y, ft=ft, tiles=ft_gemm.SM90_TILES[1])


# ---------------------------------------------------------------------------
# K7 / K8 on the tensor cores (csrc/grouped_sm90.cu)
# ---------------------------------------------------------------------------

#: A group of 100 rows (two 64-row chunks, the second past row_end), empty
#: groups, and a last group of 5 rows whose region runs on through a fully
#: dead 64-row chunk of the buffer's tail.
SM90_SIZES = [13, 0, 100, 7, 70, 0, 0, 5]


def _sm90_layout(seed):
    lay, glay = _grouped_layout(SM90_SIZES, 16, seed)
    assert lay.t_buf - int(lay.row_end[-1]) > 64
    return lay, glay


def _dead_rows(lay):
    """Buffer rows no caller row is scattered to."""
    dead = torch.ones(lay.t_buf, dtype=torch.bool, device="cuda")
    dead[lay.positions.long()] = False
    return dead


def _k7_sm90_case(lay, buf, w, ft, inj):
    from repro_torch.kernels import grouped_gemm as kgg
    kw = dict(ft=ft, inj=inj, inj_mag=99.0)
    assert kgg.plan_k7_call(buf, w, lay.gid).instance == "sm90"
    before = (kgg.FT_GEMM_GROUPED_SM90.launches,
              kgg.FT_GEMM_GROUPED_SIMT.launches)
    out, rep = kgg.ft_gemm_grouped(buf, w, lay.gid, lay.row_end, **kw)
    assert (kgg.FT_GEMM_GROUPED_SM90.launches,
            kgg.FT_GEMM_GROUPED_SIMT.launches) == (before[0] + 1, before[1])
    out_p, rep_p = kgg.planned_grouped_plain(buf, w, lay.gid, lay.row_end,
                                             **kw)
    return out, rep, out_p, rep_p


@pytest.mark.parametrize("walk", ["w", "wT"])
def test_grouped_sm90_matches_plain(cuda, walk):
    """K7 on the tensor cores against its plain version under the same
    plan, integer bf16 operands (exact): FT off, clean, an SEU in a chunk
    that spans past its group's row_end (corrected bit for bit and
    located; left by detect-only), verify="final", an SEU in the fully dead
    chunk; K = 320 (a ragged last k-step), N = 200 (a ragged n-block)."""
    from repro_torch.kernels import grouped_gemm as kgg
    lay, glay = _sm90_layout(5)
    gen = torch.Generator(device="cuda").manual_seed(21)
    k, n, ng = 320, 200, len(SM90_SIZES)
    buf = glay.scatter_rows(_ints(gen, lay.n_rows, k, dtype=torch.bfloat16),
                            lay)
    w = (_ints(gen, ng, k, n, dtype=torch.bfloat16) if walk == "w" else
         _ints(gen, ng, n, k, dtype=torch.bfloat16).transpose(-1, -2))
    assert kgg.plan_k7_call(buf, w, lay.gid).w_kmajor == (walk == "wT")
    base, re = lay.base.tolist(), lay.row_end.tolist()
    past = (1, re[2] - 1, n - 1, 1)      # second chunk of group 2
    clean, _, _, _ = _k7_sm90_case(lay, buf, w, FT, None)
    for ft, inj in ((None, None), (FT, None), (FT, past),
                    (FT.replace(action="detect"), past),
                    (FT.replace(verify="final"), (1, base[0], 5, 0)),
                    (FT, (1, lay.t_buf - 1, 7, 1))):
        out, rep, out_p, rep_p = _k7_sm90_case(lay, buf, w, ft, inj)
        assert torch.equal(out, out_p)
        if ft is None:
            assert rep is None and torch.equal(out, clean)
            continue
        _check_reports(rep, rep_p)
        n_det, n_corr = float(rep[..., 0].sum()), float(rep[..., 1].sum())
        if inj is None:
            assert n_det == n_corr == 0.0
        elif ft.corrects:
            assert n_det == n_corr == 1.0 and torch.equal(out, clean)
            cell = rep[rep[..., 0] > 0][0]
            assert (int(cell[2]), int(cell[3])) == (inj[1], inj[2])
        else:
            assert n_det >= 1.0 and n_corr == 0.0
            moved = (out.float() - clean.float()).abs()
            assert moved.nonzero().tolist() == [[inj[1], inj[2]]]
    # The rows between a group's row_end and the next group's base hold
    # garbage: the masking keeps them out of every result.
    dirty = buf.clone()
    dirty[_dead_rows(lay)] = 7.0
    for ft in (None, FT):
        got, rep_g = kgg.ft_gemm_grouped(dirty, w, lay.gid, lay.row_end, ft=ft)
        want, rep_w = kgg.ft_gemm_grouped(buf, w, lay.gid, lay.row_end, ft=ft)
        assert torch.equal(got, want)
        if ft is not None:
            assert torch.equal(rep_g, rep_w)


def test_grouped_sm90_random_bf16_within_one_ulp(cuda):
    """Random bf16 operands at the MoE decode geometry in miniature: the
    kernel and its plain version round the same f32 sums, taken in other
    orders, to bf16."""
    from repro_torch.kernels import grouped_gemm as kgg
    lay, glay = _sm90_layout(6)
    gen = torch.Generator(device="cuda").manual_seed(22)
    buf = glay.scatter_rows(_bf16(gen, lay.n_rows, 512), lay)
    w = _bf16(gen, len(SM90_SIZES), 512, 384)
    out, rep, out_p, rep_p = _k7_sm90_case(lay, buf, w, FT, None)
    tol = 2.0 ** -7 * float(out_p.float().abs().max())
    assert float((out.float() - out_p.float()).abs().max()) <= tol
    assert torch.equal(rep[..., [0, 1, 2, 3, 7]], rep_p[..., [0, 1, 2, 3, 7]])
    assert float(rep[..., 0].sum()) == 0.0


def test_tgmm_sm90_matches_plain(cuda):
    """K8 on the tensor cores against its plain version under the same plan
    (64-row intervals), integer bf16 operands (exact): FT off, clean, an
    SEU in the second interval of the 100-row group (corrected bit for bit,
    located), one in the last group's ragged tile left by detect-only
    (counted again at each verification of the dead tail), verify="final",
    an SEU aimed at a dead tile; empty groups zero in dw and report with no
    pass after the kernel; K = 200, N = 136 (ragged blocks)."""
    from repro_torch.kernels import grouped as kgrouped
    from repro_torch.kernels import grouped_gemm as kgg
    from repro_torch.kernels.templates import BatchedKernelSpec
    lay, glay = _sm90_layout(7)
    gen = torch.Generator(device="cuda").manual_seed(23)
    k, n = 200, 136
    x = glay.scatter_rows(_ints(gen, lay.n_rows, k, dtype=torch.bfloat16),
                          lay)
    g = glay.scatter_rows(_ints(gen, lay.n_rows, n, dtype=torch.bfloat16),
                          lay)
    spec = BatchedKernelSpec(ft_level="block", tgmm=True)
    base, re = lay.base.tolist(), lay.row_end.tolist()
    assert kgg.plan_k8_call(x, g, 16).instance == "sm90"
    last_tile = (re[-1] - 1) // 16
    clean, _ = kgrouped.tgmm_buffer_call(spec, x, g, lay, ft=FT)
    for ft, inj in ((None, None), (FT, None),
                    (FT, (1, k - 1, 70, (base[2] + 70) // 16)),
                    (FT.replace(action="detect"), (1, 3, n - 1, last_tile)),
                    (FT.replace(verify="final"), (1, 64, 64, base[0] // 16)),
                    (FT.replace(action="detect"), (1, 5, 5,
                                                   lay.num_tiles - 1))):
        tinj = None if inj is None else InjectionSpec(
            row=inj[1], col=inj[2], magnitude=50.0, k_step=inj[3])
        before = (kgg.TGMM_SM90.launches, kgg.TGMM_SIMT.launches)
        dw, rep = kgrouped.tgmm_buffer_call(
            spec if ft is not None else BatchedKernelSpec(tgmm=True), x, g,
            lay, ft=ft, inject=tinj)
        assert (kgg.TGMM_SM90.launches, kgg.TGMM_SIMT.launches) == \
            (before[0] + 1, before[1])
        dw_p, rep_p = kgg.planned_tgmm_plain(x, g, lay.row_end, bm=16, ft=ft,
                                             inj=inj, inj_mag=50.0)
        assert dw.dtype == torch.float32 and torch.equal(dw, dw_p)
        for e in range(len(SM90_SIZES)):
            if SM90_SIZES[e] == 0:
                assert not dw[e].any()
                assert rep is None or not rep[e].any()
        if ft is None:
            assert rep is None
            continue
        _check_reports(rep, rep_p)
        n_det = float(rep[..., 0].sum())
        if inj is None:
            assert n_det == 0.0
        elif ft.corrects:
            assert n_det == 1.0 and torch.equal(dw, clean)
            cell = rep[rep[..., 0] > 0][0]
            assert (int(cell[2]), int(cell[3])) == (inj[1], inj[2])
        else:
            assert float(rep[..., 1].sum()) == 0.0
            assert float(dw[-1, inj[1], inj[2]] - clean[-1, inj[1], inj[2]]) \
                == 50.0
            if inj[3] == last_tile:
                assert n_det > 1
    dirty_x, dirty_g = x.clone(), g.clone()
    dead = _dead_rows(lay)
    dirty_x[dead], dirty_g[dead] = 5.0, -6.0
    got, rep_g = kgrouped.tgmm_buffer_call(spec, dirty_x, dirty_g, lay, ft=FT)
    want, rep_w = kgrouped.tgmm_buffer_call(spec, x, g, lay, ft=FT)
    assert torch.equal(got, want) and torch.equal(rep_g, rep_w)


def test_grouped_sm90_plan_routes_the_rest_to_simt(cuda):
    """f32 and the pinned SIMT tiles stay on the SIMT instances (K7's
    csrc/ft_gemm.cu GROUPED, K8's csrc/tgmm.cu)."""
    from repro_torch.kernels import grouped as kgrouped
    from repro_torch.kernels import grouped_gemm as kgg
    from repro_torch.kernels.templates import BatchedKernelSpec
    lay, glay = _sm90_layout(8)
    gen = torch.Generator(device="cuda").manual_seed(24)
    for dtype, tiles in ((torch.float32, None),
                         (torch.bfloat16, (16, 128, 32))):
        buf = glay.scatter_rows(_ints(gen, lay.n_rows, 64, dtype=dtype), lay)
        w = _ints(gen, len(SM90_SIZES), 64, 128, dtype=dtype)
        p = kgg.plan_k7_call(buf, w, lay.gid, tiles)
        assert p.instance == "simt" and p.reason
        before = kgg.FT_GEMM_GROUPED_SIMT.launches
        kgg.ft_gemm_grouped(buf, w, lay.gid, lay.row_end, ft=FT, tiles=tiles)
        assert kgg.FT_GEMM_GROUPED_SIMT.launches == before + 1
        before = kgg.TGMM_SIMT.launches
        kgrouped.tgmm_buffer_call(
            BatchedKernelSpec(ft_level="block", tgmm=True), buf, buf, lay,
            ft=FT, tiles=None if tiles is None else (16, 64, 64))
        assert kgg.TGMM_SIMT.launches == before + 1


# ---------------------------------------------------------------------------
# K5 on the tensor cores (csrc/batched_sm90.cu)
# ---------------------------------------------------------------------------

K5_LEVELS = ["block", "tile", "inner"]


def _k5_operands(gen, product, nb, kvh, n_rep, s, dh, make):
    """Decode attention's operands with two batch dims: B a permuted view
    of the (B, S, KVH, dh) cache (qk: k-major, pv: n-major), or a
    contiguous (nb, K, N) one, or a shared (K, N) one."""
    if product in ("qk", "pv"):
        cache = make(gen, nb, s, kvh, dh)
        if product == "qk":
            return make(gen, nb, kvh, n_rep, dh), cache.permute(0, 2, 3, 1)
        # softmax rows at a stride of a multiple of 8, ragged S included
        p = make(gen, nb, kvh, n_rep, ft_gemm.cdiv(s, 8) * 8)[..., :s]
        return p, cache.transpose(1, 2)
    if product == "contiguous":
        return make(gen, nb, n_rep, s), make(gen, nb, s, dh)
    return make(gen, nb, n_rep, s), make(gen, s, dh)   # shared B


def _k5_call(a, b, **kw):
    """One K5 call, checked to launch the tensor-core instance once and
    the SIMT one never."""
    p = ft_gemm.plan_call(a, b, ft=kw.get("ft"))
    assert p.instance == "sm90" and p.tiles in ft_gemm.BATCHED_SM90_TILES
    res, n = _launched((ft_gemm.FT_GEMM_BATCHED_SM90, ft_gemm.FT_GEMM_BATCHED,
                        ft_gemm.FT_GEMM_K5),
                       lambda: ft_gemm.ft_gemm(a, b, **kw))
    assert n == [1, 0, 1]
    return res


@pytest.mark.parametrize("level", K5_LEVELS)
@pytest.mark.parametrize("geom", [("qk", 4, 7, 256, 128),
                                  ("pv", 4, 7, 256, 128),
                                  ("qk", 2, 16, 300, 128),
                                  ("pv", 2, 3, 777, 128),
                                  ("qk", 8, 7, 1000, 128),
                                  ("pv", 32, 4, 520, 128),
                                  ("contiguous", 1, 5, 600, 72),
                                  ("shared", 1, 16, 520, 200)])
def test_batched_sm90_matches_plain(cuda, geom, level):
    """The new instance against its plain version under the same plan on
    the cache views (one to four 256-deep steps, ragged K and N, 3 to 16
    rows), contiguous and shared B, at each level and both verify
    settings, and FT off: outputs within one bf16 ulp, reports det / corr
    / row / col / k equal, tau within 1e-5, no detection."""
    product, kvh, n_rep, s, dh = geom
    gen = torch.Generator(device="cuda").manual_seed(s + n_rep)
    a, b = _k5_operands(gen, product, 3, kvh, n_rep, s, dh,
                        lambda g, *sh: _bf16(g, *sh))
    for ft in (FT.replace(level=level),
               FT.replace(level=level, verify="final"), None):
        out, rep = _k5_call(a, b, ft=ft)
        out_p, rep_p = ft_gemm.planned_plain(a, b, ft=ft)
        _bf16_close(out, out_p)
        if ft is None:
            assert rep is None
            continue
        _check_fields(rep, rep_p)
        assert float(rep[..., 0].sum()) == 0.0
        assert bool((rep[..., 5] < rep[..., 6]).all())


@pytest.mark.parametrize("level", K5_LEVELS)
@pytest.mark.parametrize("product", ["qk", "pv"])
def test_batched_sm90_seu(cuda, product, level):
    """A deterministic SEU on integer-valued operands, in every slice and
    in one slice, at a k-step of the 256-deep walk: corrected bit for bit
    and located as the plain version under the same plan; a detect-only
    policy counts it and leaves it."""
    gen = torch.Generator(device="cuda").manual_seed(77)
    s = 600
    a, b = _k5_operands(gen, product, 2, 4, 7, s, 128,
                        lambda g, *sh: _ints(g, *sh, dtype=torch.bfloat16))
    n, steps = b.shape[-1], ft_gemm.cdiv(a.shape[-1], 256)
    ft = FT.replace(level=level)
    clean = _k5_call(a, b, ft=ft)[0]
    for inj in ((1, -1, 6, n - 1, steps - 1), (1, 5, 2, 3, 0)):
        out, rep = _k5_call(a, b, ft=ft, inj=inj, inj_mag=300.0)
        _, rep_p = ft_gemm.planned_plain(a, b, ft=ft, inj=inj, inj_mag=300.0)
        _check_fields(rep, rep_p)
        hits = 8 if inj[1] < 0 else 1
        assert float(rep[..., 0].sum()) == float(rep[..., 1].sum()) == hits
        cells = rep[rep[..., 0] > 0]
        assert bool((cells[:, 2] == inj[2]).all())
        assert bool((cells[:, 3] == inj[3]).all())
        assert bool(((cells[:, 4] - 300.0).abs() < 1e-3).all())
        assert torch.equal(out, clean)
        det = ft.replace(action="detect")
        left, rep_d = _k5_call(a, b, ft=det, inj=inj, inj_mag=300.0)
        _, rep_dp = ft_gemm.planned_plain(a, b, ft=det, inj=inj,
                                          inj_mag=300.0)
        assert torch.equal(rep_d[..., :4], rep_dp[..., :4])
        assert float(rep_d[..., 1].sum()) == 0.0
        assert float(rep_d[..., 0].sum()) >= hits
        assert int((left != clean).sum()) == hits


@pytest.mark.parametrize("case", [("N 1", True), ("N 1", False),
                                  ("K 1", True), ("K 1", False)])
def test_batched_sm90_one_column_or_one_k(cuda, case):
    """B of one column or one k, read along either dim: B's stride along
    its other dim is never stepped, so it may be anything (a contiguous
    (…, K, 1) B reads along k at ldb 1, a shared (1, N) one along n at ldb
    N = 20). Planned on the new instance and launched there, equal to the
    plain version at block and inner and FT off."""
    dim, kmajor = case
    gen = torch.Generator(device="cuda").manual_seed(5)
    if dim == "N 1":
        a = _bf16(gen, 3, 7, 304)
        b = _bf16(gen, 3, 304, 1) if kmajor else _bf16(gen, 3, 304, 8)[..., :1]
    else:
        a = _bf16(gen, 3, 7, 8)[..., :1]
        b = (_bf16(gen, 3, 20, 8)[..., :1].transpose(-1, -2) if kmajor
             else _bf16(gen, 1, 20))
    assert ft_gemm.plan_call(a, b, ft=FT).b_kmajor == kmajor
    for ft in (FT, FT.replace(level="inner"), None):
        out, rep = _k5_call(a, b, ft=ft)
        out_p, rep_p = ft_gemm.planned_plain(a, b, ft=ft)
        _bf16_close(out, out_p)
        if ft is not None:
            _check_fields(rep, rep_p)
            assert float(rep[..., 0].sum()) == 0.0


def test_batched_sm90_plan_routes_the_rest_to_simt(cuda):
    """f32 (the existing f32 K5 tests' rule), 17 rows and pinned SIMT tiles
    stay on the SIMT instance; pinned tensor-core tiles raise for the first
    two."""
    gen = torch.Generator(device="cuda").manual_seed(8)
    a, b = _k5_operands(gen, "qk", 2, 4, 7, 256, 128,
                        lambda g, *sh: _bf16(g, *sh))
    a17 = _bf16(gen, 2, 4, 17, 128)
    for x, y, tiles in ((a.float(), b.float(), None), (a17, b, None),
                        (a, b, ft_gemm.pick_tiles(7))):
        p = ft_gemm.plan_call(x, y, ft=FT, tiles=tiles)
        assert p.instance == "simt" and p.reason
        (out, rep), n = _launched(
            (ft_gemm.FT_GEMM_BATCHED_SM90, ft_gemm.FT_GEMM_BATCHED),
            lambda: ft_gemm.ft_gemm(x, y, ft=FT, tiles=tiles))
        assert n == [0, 1]
        out_p, _ = ft_gemm.ft_gemm_plain(x, y, ft=FT, tiles=p.tiles)
        _bf16_close(out, out_p)
        if tiles is None:
            with pytest.raises(ValueError):
                ft_gemm.ft_gemm(x, y, ft=FT,
                                tiles=ft_gemm.BATCHED_SM90_TILES[0])


# ---------------------------------------------------------------------------
# stochastic SEU campaigns: the in-kernel hook of K1, K5, K7 and K8
# ---------------------------------------------------------------------------
#
# Integer-valued operands keep every step's contribution exact on both sides
# (the kernels take it from the accumulator or the staged tiles, the plain
# versions from their f32 products), so the magnitudes, the located
# positions and the corrected outputs agree bit for bit.

#: A fixed campaign triple (enable, seed0, seed1).
TRIPLE = (1, 123456789, 987654321)
#: Ragged groups, empty ones, a 100-row group (two 64-row chunks on the
#: tensor cores) and a dead tail.
CAMPAIGN_SIZES = [13, 0, 100, 7, 70, 0, 0, 5]


def _campaign_cases():
    """(name, kernels, call(ft, rng) -> (out, rep), plain(ft, rng), hits(ft,
    rng) -> the blocks that draw a hit) for each of the eight instances,
    at shapes with a tail block."""
    from repro_torch.kernels import grouped_gemm as kgg
    gen = torch.Generator(device="cuda").manual_seed(23)
    cases = []

    def gemm(name, kernels, a, b, tiles=None):
        def call(ft, rng):
            return ft_gemm.ft_gemm(a, b, ft=ft, rng=rng, tiles=tiles)

        def plain(ft, rng):
            return ft_gemm.planned_plain(a, b, ft=ft, rng=rng, tiles=tiles)

        def hits(ft, rng):
            p = ft_gemm.plan_call(a, b, ft=ft, tiles=tiles)
            m, k = a.shape[-2:]
            nb = a[..., 0, 0].numel()
            bm, bn, bk = p.tiles
            return ft_gemm.seu_draws(
                rng, ft, nb, ft_gemm.cdiv(m, bm), ft_gemm.cdiv(b.shape[-1], bn),
                ft_gemm.cdiv(k, bk), p.tiles, a.dim() > 2, a.device)[0]
        cases.append((name, kernels, call, plain, hits))

    f32, bf = torch.float32, torch.bfloat16
    gemm("K1 simt", ft_gemm.FT_GEMM_2D_SIMT, _ints(gen, 130, 300),
         _ints(gen, 300, 200), (64, 64, 32))
    gemm("K1 sm90 split-K", ft_gemm.FT_GEMM_SM90,
         _ints(gen, 200, 1024, dtype=bf), _ints(gen, 1024, 296, dtype=bf))
    gemm("K1 sm90", ft_gemm.FT_GEMM_SM90, _ints(gen, 2200, 512, dtype=bf),
         _ints(gen, 512, 2104, dtype=bf))
    gemm("K5 simt", ft_gemm.FT_GEMM_BATCHED, _ints(gen, 2, 3, 40, 77),
         _ints(gen, 2, 3, 77, 50))
    gemm("K5 sm90", ft_gemm.FT_GEMM_BATCHED_SM90,
         _ints(gen, 4, 2, 7, 304, dtype=bf), _ints(gen, 4, 2, 304, 72, dtype=bf))

    for dtype, bm, name in ((f32, 16, "simt"), (bf, 16, "sm90")):
        lay, glay = _grouped_layout(CAMPAIGN_SIZES, bm, 3)
        k, n, ng = 512, 200, len(CAMPAIGN_SIZES)
        buf = glay.scatter_rows(_ints(gen, lay.n_rows, k, dtype=dtype), lay)
        w = _ints(gen, ng, k, n, dtype=dtype)
        tiles = (bm, 128, 32) if name == "simt" else None

        def k7(ft, rng, buf=buf, w=w, lay=lay, tiles=tiles):
            return kgg.ft_gemm_grouped(buf, w, lay.gid, lay.row_end, ft=ft,
                                       rng=rng, tiles=tiles)

        def k7p(ft, rng, buf=buf, w=w, lay=lay, tiles=tiles):
            return kgg.planned_grouped_plain(buf, w, lay.gid, lay.row_end,
                                             ft=ft, rng=rng, tiles=tiles)

        def k7h(ft, rng, buf=buf, w=w, lay=lay, tiles=tiles):
            p = kgg.plan_k7_call(buf, w, lay.gid, tiles)
            return kgg.seu_tile_draws(rng, ft, lay.num_tiles,
                                      ft_gemm.cdiv(w.shape[2], p.tiles[1]),
                                      ft_gemm.cdiv(k, p.tiles[2]), p.tiles,
                                      buf.device)[0]
        cases.append((f"K7 {name}", kgg.FT_GEMM_GROUPED_SIMT if name == "simt"
                      else kgg.FT_GEMM_GROUPED_SM90, k7, k7p, k7h))

        x = glay.scatter_rows(_ints(gen, lay.n_rows, 152, dtype=dtype), lay)
        g = glay.scatter_rows(_ints(gen, lay.n_rows, 200, dtype=dtype), lay)
        t8 = (bm, 64, 64) if name == "simt" else None

        def k8(ft, rng, x=x, g=g, lay=lay, t8=t8):
            return kgg.tgmm(x, g, lay.row_end, bm=lay.bm, ft=ft, rng=rng,
                            tiles=t8)

        def k8p(ft, rng, x=x, g=g, lay=lay, t8=t8):
            return kgg.planned_tgmm_plain(x, g, lay.row_end, bm=lay.bm,
                                          ft=ft, rng=rng, tiles=t8)

        def k8h(ft, rng, x=x, g=g, lay=lay, t8=t8):
            p = kgg.plan_k8_call(x, g, lay.bm, t8)
            live = lay.row_end.long() - lay.base.long()
            return kgg.seu_dw_draws(rng, ft, live,
                                    ft_gemm.cdiv(x.shape[1], p.tiles[2]),
                                    ft_gemm.cdiv(g.shape[1], p.tiles[1]),
                                    p.tiles)[0]
        cases.append((f"K8 {name}", kgg.TGMM_SIMT if name == "simt"
                      else kgg.TGMM_SM90, k8, k8p, k8h))
    return cases


@pytest.mark.parametrize("idx", range(9))
def test_campaign_hook_matches_plain(cuda, idx):
    """Each instance with a fixed triple at rate 1.0 and 0.5: reports equal
    its planned plain version's field for field, every SEU is corrected
    (one detection a hit under "final") and the output equals the clean
    call's; detect-only leaves the SEUs in, as the plain version does; rate
    0 with the triple is bit-identical to no campaign."""
    name, kernels, call, plain, hits = _campaign_cases()[idx]
    clean, rep0 = call(FT, None)
    for rate in (1.0, 0.5):
        for ft in (FT.replace(inject_rate=rate),
                   FT.replace(inject_rate=rate, verify="final"),
                   FT.replace(inject_rate=rate, action="detect")):
            before = kernels.launches
            out, rep = call(ft, TRIPLE)
            assert kernels.launches > before, name
            out_p, rep_p = plain(ft, TRIPLE)
            _check_reports(rep, rep_p)
            assert torch.equal(out, out_p), name
            n_hit = int(hits(ft, TRIPLE).sum())
            assert n_hit > 0, name
            if ft.corrects:
                assert torch.equal(out, clean), name
                if ft.verify == "final":
                    assert float(rep[..., 0].sum()) == n_hit, name
                assert float(rep[..., 1].sum()) == float(rep[..., 0].sum())
            else:
                # SEUs in rows or columns past the output's edge are
                # detected but never stored
                assert int((out != clean).sum()) <= n_hit, name
                assert float(rep[..., 1].sum()) == 0.0
                assert float(rep[..., 0].sum()) >= n_hit, name
    out, rep = call(FT, (0, 0, 0))
    assert torch.equal(out, clean) and torch.equal(rep, rep0), name
    out, rep = call(FT.replace(inject_rate=0.0), TRIPLE)
    assert torch.equal(out, clean) and torch.equal(rep, rep0), name


# ---------------------------------------------------------------------------
# stochastic SEU campaigns: the in-kernel hook of K2, K3, K4 and K6
# ---------------------------------------------------------------------------

def _flash_campaign_cases():
    """(name, kernels, call(ft, rng) -> (outs, rep), plain(ft, rng), hits(ft,
    rng)) for every flash instance: K2, K3 and K4 (ranged) on the tensor
    cores and the SIMT ones in f32, K6 on the tensor cores (ranged) and the
    SIMT one in f32 and in bf16 at pages of 16, and K2 on the tensor cores
    at dh 64."""
    gen = torch.Generator(device="cuda").manual_seed(29)
    cases = []
    f32, bf = torch.float32, torch.bfloat16
    for name, dtype, bh, n_rep, sq, skv, causal in (
            ("sm90", bf, 6, 3, 300, 300, True),
            ("simt", f32, 4, 2, 100, 130, False)):
        q = torch.randn(bh, sq, 128, generator=gen, device="cuda").to(dtype)
        k, v = (torch.randn(bh // n_rep, skv, 128, generator=gen,
                            device="cuda").to(dtype) for _ in range(2))
        g = torch.randn(bh, sq, 128, generator=gen, device="cuda").to(dtype)
        kw = dict(scale=128 ** -0.5, tau_dh=128, n_rep=n_rep, causal=causal)
        o, m, l, _ = flashft.flash_ft_fwd(q, k, v, ft=FT, save_stats=True,
                                          **kw)
        di = (g.float() * o.float()).sum(-1)
        shp = dict(causal=causal, device="cuda")

        def fwd(ft, rng, q=q, k=k, v=v, kw=kw):
            out, rep = flashft.flash_ft_fwd(q, k, v, ft=ft, rng=rng, **kw)
            return (out,), rep

        def fwd_p(ft, rng, q=q, k=k, v=v, kw=kw):
            out, rep = flashft.flash_ft_plain(q, k, v, ft=ft, rng=rng, **kw)
            return (out,), rep

        def fwd_h(ft, rng, a=(bh, sq, skv), shp=shp):
            return flashft.seu_fwd_draws(rng, ft, *a, 128, **shp)[0]

        ops = (q, k, v, g, m, l, di)

        def dq(ft, rng, ops=ops, kw=kw):
            out, rep = flashft.flash_ft_dq(*ops, ft=ft, rng=rng, **kw)
            return (out,), rep

        def dq_p(ft, rng, ops=ops, kw=kw):
            out, rep = flashft.flash_dq_plain(*ops, ft=ft, rng=rng, **kw)
            return (out,), rep

        def dq_h(ft, rng, a=(bh, sq, skv), shp=shp):
            return flashft.seu_dq_draws(rng, ft, *a, 128, **shp)[0]

        def dkv(ft, rng, ops=ops, kw=kw):
            dk, dv, rep = flashft.flash_ft_dkv(*ops, ft=ft, rng=rng, **kw)
            return (dk, dv), rep

        def dkv_p(ft, rng, ops=ops, kw=kw):
            dk, dv, rep = flashft.planned_dkv_plain(*ops, ft=ft, rng=rng,
                                                    **kw)
            return (dk, dv), rep

        def dkv_h(ft, rng, a=(bh // n_rep, n_rep, sq, skv), shp=shp):
            return flashft.seu_dkv_draws(rng, ft, *a, 128, **shp)[0]

        sm = name == "sm90"
        cases += [
            (f"K2 {name}", flashft.FLASH_FT_SM90 if sm else flashft.FLASH_FT,
             fwd, fwd_p, fwd_h),
            (f"K3 {name}", flashft.FLASH_DQ_SM90 if sm else flashft.FLASH_DQ,
             dq, dq_p, dq_h),
            (f"K4 {name}", flashft.FLASH_DKV_SM90 if sm
             else flashft.FLASH_DKV, dkv, dkv_p, dkv_h)]
    for name, dtype, page, simt in (("sm90", bf, 32, False),
                                    ("simt f32", f32, 32, True),
                                    ("simt bf16 pages of 16", bf, 16, True)):
        kvh, n_rep = 4, 7
        q, k, v, lens, table = _decode_inputs(128, page, kvh, n_rep,
                                              DECODE_LENGTHS, dtype, page)
        kw = dict(scale=128 ** -0.5, tau_dh=128)

        def dec(ft, rng, a=(q, k, v, lens, table), kw=kw, simt=simt):
            out, rep = flashft.flash_ft_decode(*a, ft=ft, rng=rng, simt=simt,
                                               **kw)
            return (out,), rep

        def dec_p(ft, rng, a=(q, k, v, lens, table), kw=kw, simt=simt):
            out, rep = flashft.planned_decode_plain(*a, ft=ft, rng=rng,
                                                    simt=simt, **kw)
            return (out,), rep

        def dec_h(ft, rng, lens=lens, page=page, mp=table.shape[1],
                  bq=q.shape[1], kvh=kvh):
            return flashft.seu_decode_draws(rng, ft, lens, kvh, page, mp, bq,
                                            128)[0]
        cases.append((f"K6 {name}", flashft.FLASH_DECODE if simt
                      else flashft.FLASH_DECODE_SM90, dec, dec_p, dec_h))
    # K2's dh-64 instance (MHA, three q blocks of one head a CTA), reached by
    # a direct call: the front pads dh to 128 under a campaign
    q, k, v = (torch.randn(4, 300, 64, generator=gen, device="cuda").to(bf)
               for _ in range(3))
    kw = dict(scale=64 ** -0.5, tau_dh=128, causal=True)

    def fwd64(ft, rng, a=(q, k, v), kw=kw):
        out, rep = flashft.flash_ft_fwd(*a, ft=ft, rng=rng, **kw)
        return (out,), rep

    def fwd64_p(ft, rng, a=(q, k, v), kw=kw):
        out, rep = flashft.flash_ft_plain(*a, ft=ft, rng=rng, **kw)
        return (out,), rep

    cases.append(("K2 sm90 dh 64", flashft.FLASH_FT_SM90, fwd64, fwd64_p,
                  lambda ft, rng: flashft.seu_fwd_draws(
                      rng, ft, 4, 300, 300, 64, causal=True,
                      device="cuda")[0]))
    return cases


@pytest.mark.parametrize("idx", range(10))
def test_flash_campaign_hook_matches_plain(cuda, idx):
    """Each flash instance under a fixed triple at rate 1.0: reports equal
    its planned plain version's in det / corr / row / col / k and tau, one
    detection and one correction a drawn SEU, the outputs within the bf16
    tolerance of the clean call's (f32: 1e-4); detect-only leaves the SEUs
    in; rate 0 with the triple is bit-identical to no campaign."""
    name, kernels, call, plain, hits = _flash_campaign_cases()[idx]
    clean, rep0 = call(FT, None)
    n_hit = int(hits(FT.replace(inject_rate=1.0), TRIPLE).sum())
    assert n_hit > 0, name
    for ft in (FT.replace(inject_rate=1.0),
               FT.replace(inject_rate=1.0, action="detect")):
        before = kernels.launches
        outs, rep = call(ft, TRIPLE)
        assert kernels.launches == before + 1, name
        outs_p, rep_p = plain(ft, TRIPLE)
        _check_fields(rep, rep_p)
        assert float(rep[..., 0].sum()) == n_hit, name
        for got, want, base in zip(outs, outs_p, clean):
            _bf16_close(got, want)
            if ft.corrects:
                _bf16_close(got, base)
        if ft.corrects:
            assert float(rep[..., 1].sum()) == n_hit, name
        else:
            assert float(rep[..., 1].sum()) == 0.0, name
            _left_in_place(torch.cat([x.flatten() for x in outs]),
                           torch.cat([x.flatten() for x in clean]))
    outs, rep = call(FT, (0, 0, 0))
    assert all(torch.equal(x, y) for x, y in zip(outs, clean))
    assert torch.equal(rep, rep0), name
    outs, rep = call(FT.replace(inject_rate=0.0), TRIPLE)
    assert all(torch.equal(x, y) for x, y in zip(outs, clean))
    assert torch.equal(rep, rep0), name


# ---------------------------------------------------------------------------
# tile / inner in training and MoE: K1 with act_grad and on the dw walk
# (LAYOUT 2), K7 on both walks, K8
# ---------------------------------------------------------------------------

#: A campaign triple: at rate 1.0 every block draws one SEU, and a
#: deterministic SEU aimed at another band of a block in the same interval
#: makes two SEUs in two bands of one block.
TRIPLE = (1, 123456789, 987654321)


def _other_band(r, band, rows):
    """A row of the next band (cyclically) of a block of ``rows`` rows."""
    return ((r // band + 1) % (rows // band)) * band + r % band


def _close_as(got, want, dtype):
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        tol = 2.0 ** -7 * float(want.float().abs().max())
        assert float((got.float() - want.float()).abs().max()) <= tol


def _k1_two_bands(a, b, ft, kw, blk, clean):
    """K1 at the tile level: a campaign (every block draws one SEU) and a
    deterministic SEU in another band of block ``blk`` at the campaign
    SEU's k-step: both corrected, reports as the plain version's, and both
    left by detect-only."""
    m, n = a.shape[0], b.shape[1]
    tiles = ft_gemm.pick_tiles(m)
    bm, bn, bk = tiles
    ftc = ft.replace(inject_rate=1.0)
    gm, gn, gk = (ft_gemm.cdiv(m, bm), ft_gemm.cdiv(n, bn),
                  ft_gemm.cdiv(a.shape[1], bk))
    hit, step, row, col = ft_gemm.seu_draws(TRIPLE, ftc, 1, gm, gn, gk,
                                            tiles, False)
    i, j = blk
    assert bool(hit[0, i, j])
    r2 = i * bm + _other_band(int(row[0, i, j]), ft_gemm.band_of(tiles), bm)
    c2 = j * bn + (int(col[0, i, j]) + 1) % bn
    inj = (1, -1, r2, c2, int(step[0, i, j]))
    assert r2 < m and c2 < n
    for pol in (ftc, ftc.replace(action="detect")):
        got = ft_gemm.ft_gemm(a, b, ft=pol, rng=TRIPLE, inj=inj,
                              inj_mag=99.0, **kw)
        want = ft_gemm.ft_gemm_plain(a, b, tiles=tiles, ft=pol, rng=TRIPLE,
                                     inj=inj, inj_mag=99.0, **kw)
        _check_reports(got[1], want[1])
        out = got[0][0] if kw.get("save_act_grad") else got[0]
        if pol.corrects:
            assert torch.equal(out, clean)
            assert float(got[1][i, j, 0]) == float(got[1][i, j, 1]) == 2.0
            assert float(got[1][..., 0].sum()) == float(hit.sum()) + 1
        else:
            assert (out != clean)[i * bm:(i + 1) * bm].sum() >= 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("chain", [("silu",), ("bias", "silu")])
@pytest.mark.parametrize("level", ["tile", "inner"])
def test_act_grad_levels_match_plain(cuda, level, chain, dtype):
    """K1's w_gate + silu with the act_grad output at tile / inner on its
    SIMT instance: C, act'(pre-activation) and the report as the plain
    version's; an SEU corrected before act_grad is written (both outputs
    the clean call's), located, and left by detect-only."""
    m, n, k = 100, 200, 97
    gen = torch.Generator(device="cuda").manual_seed(len(chain) + m)
    a, b = _ints(gen, m, k, dtype=dtype), _ints(gen, k, n, dtype=dtype)
    bias = _ints(gen, n, dtype=dtype) if "bias" in chain else None
    ft = FT.replace(level=level)
    base = dict(chain=chain, bias=bias, save_act_grad=True)
    assert ft_gemm.plan_call(a, b, ft=ft, chain=chain,
                             save_act_grad=True).instance == "simt"
    (clean, ag0), rep = ft_gemm.ft_gemm(a, b, ft=ft, **base)
    assert float(rep[..., 0].sum()) == 0.0
    for pol, inj in ((ft, None), (ft, (1, -1, m - 1, n - 1, 2)),
                     (ft.replace(verify="final"), (1, -1, 0, 5, 0)),
                     (ft.replace(action="detect"), (1, -1, m // 2, n // 3,
                                                    1))):
        kw = dict(base, ft=pol, inj=inj, inj_mag=99.0)
        before = ft_gemm.FT_GEMM_2D_SIMT.launches
        (out, ag), rep = ft_gemm.ft_gemm(a, b, **kw)
        assert ft_gemm.FT_GEMM_2D_SIMT.launches == before + 1
        (out_p, ag_p), rep_p = ft_gemm.ft_gemm_plain(
            a, b, tiles=ft_gemm.pick_tiles(m), **kw)
        _close_as(out, out_p, dtype)
        _close_as(ag, ag_p, dtype)
        _check_reports(rep, rep_p)
        if inj is not None and pol.corrects:
            assert torch.equal(out, clean) and torch.equal(ag, ag0)
            hit = rep[..., 0] > 0
            assert float(rep[..., 0].sum()) == float(rep[..., 1].sum()) == 1
            assert (int(rep[hit][0, 2]), int(rep[hit][0, 3])) == inj[2:4]
        elif inj is not None:
            assert not torch.equal(out, clean)
            assert float(rep[..., 1].sum()) == 0.0
    if level == "tile":
        _k1_two_bands(a, b, ft, base, (0, 2), clean)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("level", ["tile", "inner"])
def test_dw_walk_levels_match_plain(cuda, level, dtype):
    """K1's dw = Xᵀ·g on the transposed-A walk (LAYOUT 2) at tile / inner:
    SEUs in the first, a middle and the last band of a block and in the
    ragged last block, each corrected bit for bit and located, as the plain
    version; a detect-only control."""
    t, kd, n = 150, 130, 200
    gen = torch.Generator(device="cuda").manual_seed(kd + len(level))
    x, g = _ints(gen, t, kd, dtype=dtype), _ints(gen, t, n, dtype=dtype)
    a = x.T
    assert a.stride() == (1, kd)
    ft = FT.replace(level=level)
    tiles = ft_gemm.pick_tiles(kd)
    clean, rep = ft_gemm.ft_gemm(a, g, ft=ft)
    assert float(rep[..., 0].sum()) == 0.0
    _close_as(clean, (x.double().T @ g.double()).to(dtype), dtype)
    band = ft_gemm.band_of(tiles)
    for pol, row in ((ft, 64), (ft, 64 + 3 * band + 5), (ft, 127), (ft, 129),
                     (ft.replace(action="detect"), 64 + band)):
        inj = (1, -1, row, 77, 2)
        before = ft_gemm.FT_GEMM_2D_SIMT.launches
        out, rep = ft_gemm.ft_gemm(a, g, ft=pol, inj=inj, inj_mag=99.0)
        assert ft_gemm.FT_GEMM_2D_SIMT.launches == before + 1
        out_p, rep_p = ft_gemm.ft_gemm_plain(a, g, tiles=tiles, ft=pol,
                                             inj=inj, inj_mag=99.0)
        assert torch.equal(out, out_p)
        _check_reports(rep, rep_p)
        hit = rep[..., 0] > 0
        assert (int(rep[hit][0, 2]), int(rep[hit][0, 3])) == (row, 77)
        if pol.corrects:
            assert torch.equal(out, clean)
        else:
            assert (out != clean).sum() == 1
    if level == "tile":
        _k1_two_bands(a, g, ft, {}, (1, 1), clean)


@pytest.mark.parametrize("dtype,bm", [(torch.float32, 8),
                                      (torch.float32, 16),
                                      (torch.bfloat16, 16)])
@pytest.mark.parametrize("level", ["tile", "inner"])
def test_grouped_levels_match_plain(cuda, level, dtype, bm):
    """K7 at tile / inner on its SIMT instance (the plan's rule for f32,
    the SIMT tiles pinned for bf16, whose wᵀ walk the tensor cores take),
    on the row-major w and the wᵀ view of the dbuf product: reports as the
    plain version's, SEUs in a live tile, in the ragged last group and in
    a dead tile corrected bit for bit, detect-only leaving one; at tile,
    two SEUs in two bands of one block in one k-step."""
    from repro_torch.kernels import grouped_gemm as kgg
    lay, glay = _grouped_layout(GROUP_SIZES, bm, 1)
    gen = torch.Generator(device="cuda").manual_seed(bm + len(level))
    k, n, ng = 200, 300, len(GROUP_SIZES)
    buf = glay.scatter_rows(_ints(gen, lay.n_rows, k, dtype=dtype), lay)
    w = _ints(gen, ng, k, n, dtype=dtype)
    wt = _ints(gen, ng, n, k, dtype=dtype).transpose(-1, -2)
    ft = FT.replace(level=level)
    base = lay.base.tolist()
    tiles = (bm, 128, 32)
    pin = tiles if dtype == torch.bfloat16 else None
    for ww in (w, wt):
        p = kgg.plan_k7_call(buf, ww, lay.gid, ft=ft, tiles=pin)
        assert (p.instance, p.tiles, p.chunk) == ("simt", tiles, bm)
        clean, rep = kgg.ft_gemm_grouped(buf, ww, lay.gid, lay.row_end, ft=ft,
                                         tiles=pin)
        assert float(rep[..., 0].sum()) == 0.0
        for pol, inj in ((ft, (1, base[2] + 28, n - 1, 3)),
                         (ft.replace(action="detect"), (1, base[2] + 28,
                                                        n - 1, 3)),
                         (ft.replace(verify="final"), (1, base[0], 5, 0)),
                         (ft, (1, base[5] + 15, 130, 6)),
                         (ft, (1, lay.t_buf - 1, 7, 1))):
            kw = dict(ft=pol, inj=inj, inj_mag=99.0)
            before = kgg.FT_GEMM_GROUPED_SIMT.launches
            out, rep = kgg.ft_gemm_grouped(buf, ww, lay.gid, lay.row_end,
                                           tiles=pin, **kw)
            assert kgg.FT_GEMM_GROUPED_SIMT.launches == before + 1
            out_p, rep_p = kgg.ft_gemm_grouped_plain(
                buf, ww, lay.gid, lay.row_end, tiles=tiles, **kw)
            assert torch.equal(out, out_p)
            _check_reports(rep, rep_p)
            n_det, n_corr = float(rep[..., 0].sum()), float(rep[..., 1].sum())
            if pol.corrects:
                assert n_det == n_corr == 1.0 and torch.equal(out, clean)
                hit = rep[..., 0] > 0
                assert (int(rep[hit][0, 2]), int(rep[hit][0, 3])) == inj[1:3]
            else:
                assert n_det >= 1.0 and n_corr == 0.0
        if level == "tile":
            ftc = ft.replace(inject_rate=1.0)
            gn, gk = kgg.cdiv(n, 128), kgg.cdiv(k, 32)
            hit, step, row, col = kgg.seu_tile_draws(
                TRIPLE, ftc, lay.num_tiles, gn, gk, tiles, "cuda")
            i = base[2] // bm                # a live tile of group 2
            r2 = i * bm + _other_band(int(row[i, 1]),
                                      ft_gemm.band_of(tiles, "grouped"), bm)
            inj = (1, r2, 128 + (int(col[i, 1]) + 1) % 128, int(step[i, 1]))
            for pol in (ftc, ftc.replace(action="detect")):
                kw = dict(ft=pol, inj=inj, inj_mag=99.0, rng=TRIPLE)
                out, rep = kgg.ft_gemm_grouped(buf, ww, lay.gid,
                                               lay.row_end, tiles=pin, **kw)
                out_p, rep_p = kgg.ft_gemm_grouped_plain(
                    buf, ww, lay.gid, lay.row_end, tiles=tiles, **kw)
                assert torch.equal(out, out_p)
                _check_reports(rep, rep_p)
                if pol.corrects:
                    assert torch.equal(out, clean)
                    assert float(rep[i, 1, 0]) == float(rep[i, 1, 1]) == 2.0
                else:
                    assert (out != clean)[i * bm:(i + 1) * bm].sum() >= 2


@pytest.mark.parametrize("dtype,bm,pin", [(torch.float32, 8, None),
                                          (torch.float32, 16, None),
                                          (torch.bfloat16, 16, None),
                                          (torch.bfloat16, 16, (16, 64, 64))],
                         ids=["f32 bm8", "f32 bm16", "bf16 sm90",
                              "bf16 pinned simt"])
@pytest.mark.parametrize("level", ["tile", "inner"])
def test_tgmm_levels_match_plain(cuda, level, dtype, bm, pin):
    """K8 at tile / inner on the instance the plan's rule picks (bf16 on the
    tensor cores: 128 x 128 dw blocks, 16-row bands, 64-row stages; f32 and
    pinned tiles on the SIMT one): dw and reports as the plain version's
    under the same plan, SEUs in a live tile and in the last group's dead
    tail (a stage with no live row on the tensor cores) corrected,
    detect-only leaving one (at inner counted once), empty groups zero in
    dw and report; at tile, two SEUs in two bands of dw rows of one block in
    one interval."""
    from repro_torch.kernels import grouped_gemm as kgg
    lay, glay = _grouped_layout(GROUP_SIZES, bm, 2)
    gen = torch.Generator(device="cuda").manual_seed(10 + bm + len(level))
    sm90 = dtype == torch.bfloat16 and pin is None
    k, n = (152 if sm90 else 150), 200      # TMA reads rows of 16 bytes
    x = glay.scatter_rows(_ints(gen, lay.n_rows, k, dtype=dtype), lay)
    g = glay.scatter_rows(_ints(gen, lay.n_rows, n, dtype=dtype), lay)
    ft = FT.replace(level=level)
    p = kgg.plan_k8_call(x, g, bm, tiles=pin, ft=ft)
    if sm90:
        assert (p.instance, p.tiles, p.chunk, p.reason) == \
            ("sm90", kgg.SM90_TGMM_TILES, kgg.SM90_CHUNK, "")
        counter = kgg.TGMM_SM90
    else:
        assert (p.instance, p.tiles, p.chunk) == ("simt", (bm, 64, 64), bm)
        counter = kgg.TGMM_SIMT
    tiles = p.tiles
    base, counts = lay.base.tolist(), lay.counts.tolist()
    last_tile = (base[-1] + counts[-1] - 1) // bm
    dead = lay.num_tiles - 1                 # the last group's dead tail
    assert dead * bm - base[-1] >= p.chunk
    clean, rep = kgg.tgmm(x, g, lay.row_end, bm=bm, ft=ft, tiles=pin)
    assert float(rep[..., 0].sum()) == 0.0
    for pol, inj in ((ft, (1, k - 1, 70, base[2] // bm + 1)),
                     (ft, (1, 3, n - 1, last_tile)),
                     (ft.replace(verify="final"), (1, 64, 64, base[0] // bm)),
                     (ft.replace(action="detect"), (1, 9, 17, base[3] // bm)),
                     (ft, (1, 5, 5, dead)),
                     (ft.replace(action="detect"), (1, 130, 150, dead))):
        kw = dict(ft=pol, inj=inj, inj_mag=50.0)
        before = counter.launches
        dw, rep = kgg.tgmm(x, g, lay.row_end, bm=bm, tiles=pin, **kw)
        assert counter.launches == before + 1
        dw_p, rep_p = kgg.tgmm_plain(x, g, lay.row_end, tiles=tiles,
                                     chunk=p.chunk, **kw)
        assert torch.equal(dw, dw_p)
        _check_reports(rep, rep_p)
        for e in range(len(GROUP_SIZES)):
            if counts[e] == 0:
                assert not dw[e].any() and not rep[e].any()
        hit = rep[rep[..., 0] > 0]
        assert (int(hit[-1, 2]), int(hit[-1, 3])) == inj[1:3]
        if pol.corrects:
            assert torch.equal(dw, clean)
            assert float(rep[..., 0].sum()) == float(rep[..., 1].sum()) >= 1
        else:
            assert (dw != clean).sum() == 1
            assert float(rep[..., 1].sum()) == 0.0
            if level == "inner":
                assert float(rep[..., 0].sum()) == 1.0
    if level == "tile":
        ftc = ft.replace(inject_rate=1.0)
        first, _, re = kgg._group_span(lay.row_end, bm, lay.num_tiles)
        live_rows = (re - first * bm).clamp_min(0)
        _, bn, bk = tiles
        gk, gn = kgg.cdiv(k, bk), kgg.cdiv(n, bn)
        hit, step, row, col = kgg.seu_dw_draws(TRIPLE, ftc, live_rows, gk, gn,
                                               tiles)
        e = 2                                   # a group of 29 rows
        r2 = _other_band(int(row[e, 0, 0]), ft_gemm.band_of(tiles, "tgmm"),
                         bk)
        inj = (1, r2, (int(col[e, 0, 0]) + 1) % bn,
               int(first[e]) + int(step[e, 0, 0]))
        for pol in (ftc, ftc.replace(action="detect")):
            kw = dict(ft=pol, inj=inj, inj_mag=50.0, rng=TRIPLE)
            dw, rep = kgg.tgmm(x, g, lay.row_end, bm=bm, tiles=pin, **kw)
            dw_p, rep_p = kgg.tgmm_plain(x, g, lay.row_end, tiles=tiles,
                                         chunk=p.chunk, **kw)
            assert torch.equal(dw, dw_p)
            _check_reports(rep, rep_p)
            if pol.corrects:
                assert torch.equal(dw, clean)
                assert float(rep[e, 0, 0, 0]) == float(rep[e, 0, 0, 1]) == 2
            else:
                assert (dw[e, :bk, :bn] != clean[e, :bk, :bn]).sum() >= 2


def test_levels_plan_the_simt_instances(cuda):
    """`ft_gemm.plan`, `plan_k7` and `plan_k8` send every bf16 tile / inner
    call of training and MoE that they send to the tensor cores at block to
    the tensor-core level instances, by their written rules: bf16 w_gate +
    silu with act_grad, the dw walk, K7 on both walks, K8; each wrapper
    launches the planned one."""
    from repro_torch.kernels import grouped_gemm as kgg
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf = torch.bfloat16
    x, w = _ints(gen, 64, 256, dtype=bf), _ints(gen, 256, 128, dtype=bf)
    g = _ints(gen, 64, 128, dtype=bf)
    lay, glay = _grouped_layout([20, 0, 30, 14], 16, 3)
    buf = glay.scatter_rows(_ints(gen, lay.n_rows, 256, dtype=bf), lay)
    we = _ints(gen, 4, 256, 128, dtype=bf)
    cases = [
        (lambda ft: ft_gemm.plan_call(x, w, chain=("silu",), ft=ft,
                                      save_act_grad=True),
         lambda ft: ft_gemm.ft_gemm(x, w, chain=("silu",), ft=ft,
                                    save_act_grad=True),
         ft_gemm.FT_GEMM_2D_SIMT, ft_gemm.FT_GEMM_SM90),
        (lambda ft: ft_gemm.plan_call(x.T, g, ft=ft),
         lambda ft: ft_gemm.ft_gemm(x.T, g, ft=ft),
         ft_gemm.FT_GEMM_2D_SIMT, ft_gemm.FT_GEMM_SM90),
        (lambda ft: kgg.plan_k7_call(buf, we, lay.gid, ft=ft),
         lambda ft: kgg.ft_gemm_grouped(buf, we, lay.gid, lay.row_end, ft=ft),
         kgg.FT_GEMM_GROUPED_SIMT, kgg.FT_GEMM_GROUPED_SM90),
        (lambda ft: kgg.plan_k7_call(buf[:, :128], we.transpose(-1, -2),
                                     lay.gid, ft=ft),
         lambda ft: kgg.ft_gemm_grouped(buf[:, :128].contiguous(),
                                        we.transpose(-1, -2), lay.gid,
                                        lay.row_end, ft=ft),
         kgg.FT_GEMM_GROUPED_SIMT, kgg.FT_GEMM_GROUPED_SM90),
        (lambda ft: kgg.plan_k8_call(buf, buf[:, :128].contiguous(), 16,
                                     ft=ft),
         lambda ft: kgg.tgmm(buf, buf[:, :128].contiguous(), lay.row_end,
                             bm=16, ft=ft),
         kgg.TGMM_SIMT, kgg.TGMM_SM90),
    ]
    for plan, call, simt, sm90 in cases:
        # K1's tile / inner instances are a library of their own
        tc = (ft_gemm.FT_GEMM_SM90, ft_gemm.FT_GEMM_LEVEL_SM90) \
            if sm90 is ft_gemm.FT_GEMM_SM90 else (sm90, sm90)
        for level in ("block", "tile", "inner"):
            ft = FT.replace(level=level)
            p = plan(ft)
            assert (p.instance, p.reason) == ("sm90", ""), (level, p)
            counter = tc[0] if level == "block" else tc[1]
            before = (simt.launches, counter.launches)
            call(ft)
            torch.cuda.synchronize()
            got = (simt.launches - before[0], counter.launches - before[1])
            assert got == (0, 1)


# ---------------------------------------------------------------------------
# K1 and K7 at "tile" and "inner" on the tensor cores
# (csrc/ft_gemm_level_sm90.cu, csrc/grouped_sm90.cu)
# ---------------------------------------------------------------------------

#: BM 128 without split-K (264 blocks) and with it, BM 64 with split-K, and
#: BM 64 without it (264 n-blocks).
LEVEL_SHAPES = [(512, 8448, 512), (200, 384, 1024), (56, 200, 768),
                (64, 33792, 512)]


def _ints_bf16(gen, *shape):
    return _ints(gen, *shape, dtype=torch.bfloat16)


def _k1_level_call(a, b, kw):
    before = (ft_gemm.FT_GEMM_LEVEL_SM90.launches,
              ft_gemm.FT_GEMM_SM90.launches,
              ft_gemm.FT_GEMM_2D_SIMT.launches)
    got = ft_gemm.ft_gemm(a, b, **kw)
    assert (ft_gemm.FT_GEMM_LEVEL_SM90.launches,
            ft_gemm.FT_GEMM_SM90.launches,
            ft_gemm.FT_GEMM_2D_SIMT.launches) == (before[0] + 1, before[1],
                                                   before[2])
    return got, ft_gemm.planned_plain(a, b, **kw)


@pytest.mark.parametrize("walk", [0, 1, 2])
@pytest.mark.parametrize("shape", LEVEL_SHAPES)
@pytest.mark.parametrize("level", ["tile", "inner"])
def test_level_sm90_matches_plain(cuda, level, shape, walk):
    """K1's tile / inner instances against the plain version under the same
    plan, integer bf16 operands (exact): clean (no detection), an SEU in a
    middle k-step corrected bit for bit and located, detect-only leaving it
    (at inner counted once), verify="final"; the row-major walk with bias +
    silu and act_grad (one bf16 ulp: the two sides' silu)."""
    m, n, k = shape
    gen = torch.Generator(device="cuda").manual_seed(m + n + walk)
    a, b = _walk_operands(gen, m, n, k, walk, _ints_bf16)
    chain = ("bias", "silu") if walk == 0 else ()
    bias = _ints_bf16(gen, n) if chain else None
    ft = FT.replace(level=level)
    base = dict(chain=chain, bias=bias, save_act_grad=bool(chain))
    p = ft_gemm.plan_call(a, b, chain=chain, ft=ft,
                          save_act_grad=bool(chain))
    assert p.instance == "sm90" and p.tiles[0] == (128 if m > 64 else 64)
    (clean, rep0), (want0, rep0_p) = _k1_level_call(a, b, dict(base, ft=ft))
    outs = lambda o: o if chain else (o,)          # noqa: E731
    for got, want in zip(outs(clean), outs(want0)):
        _close_as(got, want, torch.bfloat16)
    _check_reports(rep0, rep0_p)
    assert float(rep0[..., 0].sum()) == 0.0
    step = ft_gemm.cdiv(k, 256) // 2
    inj = (1, -1, m - 1, n - 5, step)
    for pol in (ft, ft.replace(action="detect"), ft.replace(verify="final")):
        kw = dict(base, ft=pol, inj=inj, inj_mag=99.0)
        (out, rep), (out_p, rep_p) = _k1_level_call(a, b, kw)
        for got, want in zip(outs(out), outs(out_p)):
            _close_as(got, want, torch.bfloat16)
        _check_reports(rep, rep_p)
        cell = rep[rep[..., 0] > 0]
        assert (int(cell[-1, 2]), int(cell[-1, 3])) == (m - 1, n - 5)
        if pol.corrects:
            assert all(torch.equal(x, y) for x, y in zip(outs(out),
                                                          outs(clean)))
            assert float(rep[..., 0].sum()) == float(rep[..., 1].sum()) == 1
        else:
            assert float(rep[..., 1].sum()) == 0.0
            if level == "inner":
                assert float(rep[..., 0].sum()) == 1.0
            if not chain:
                moved = (out.float() - clean.float()).abs()
                assert moved.nonzero().tolist() == [[m - 1, n - 5]]


@pytest.mark.parametrize("bm", [128, 64])
@pytest.mark.parametrize("level", ["tile", "inner"])
def test_level_sm90_seu_in_every_band(cuda, level, bm):
    """An SEU in each 16-row band of one block, corrected bit for bit and
    located at its global (row, col), on the unsplit walk and under split-K;
    at tile a campaign at rate 1.0 (one SEU every block) and a deterministic
    SEU in another band of one block at the drawn k-step: both corrected in
    that interval, both left by detect-only."""
    gen = torch.Generator(device="cuda").manual_seed(bm + len(level))
    ft = FT.replace(level=level)
    m = 256 if bm == 128 else 64              # the last row block: its bands
    for n, k in ((264 * 128 * bm // m, 512), (384, 1024)):
        a, b = _ints_bf16(gen, m, k), _ints_bf16(gen, k, n)
        p = ft_gemm.plan_call(a, b, ft=ft)
        assert p.tiles[0] == bm and (p.splits == 1) == (n > 384)
        clean, _ = ft_gemm.ft_gemm(a, b, ft=ft)
        for band in range(bm // 16):
            row = m - bm + band * 16 + (band * 5) % 16
            inj = (1, -1, row, 130 + band, band % ft_gemm.cdiv(k, 256))
            (out, rep), (_, rep_p) = _k1_level_call(
                a, b, dict(ft=ft, inj=inj, inj_mag=77.0))
            assert torch.equal(out, clean)
            _check_reports(rep, rep_p)
            cell = rep[rep[..., 0] > 0]
            assert cell.shape[0] == 1
            assert (int(cell[0, 2]), int(cell[0, 3])) == (row, 130 + band)
        if level == "tile":
            _k1_two_bands_sm90(a, b, ft, p, clean)


def _k1_two_bands_sm90(a, b, ft, p, clean):
    m, n = a.shape[0], b.shape[1]
    bm, bn, bk = p.tiles
    ftc = ft.replace(inject_rate=1.0)
    gm, gn, gk = (ft_gemm.cdiv(m, bm), ft_gemm.cdiv(n, bn),
                  ft_gemm.cdiv(a.shape[1], bk))
    hit, step, row, col = ft_gemm.seu_draws(TRIPLE, ftc, 1, gm, gn, gk,
                                            p.tiles, False)
    i, j = gm - 1, 1
    r2 = i * bm + _other_band(int(row[0, i, j]), 16, bm)
    c2 = j * bn + (int(col[0, i, j]) + 1) % bn
    inj = (1, -1, r2, c2, int(step[0, i, j]))
    for pol in (ftc, ftc.replace(action="detect")):
        (out, rep), (_, rep_p) = _k1_level_call(
            a, b, dict(ft=pol, rng=TRIPLE, inj=inj, inj_mag=99.0))
        _check_reports(rep, rep_p)
        if pol.corrects:
            assert torch.equal(out, clean)
            assert float(rep[i, j, 0]) == float(rep[i, j, 1]) == 2.0
            assert float(rep[..., 0].sum()) == float(hit.sum()) + 1
        else:
            assert (out != clean)[i * bm:(i + 1) * bm].sum() >= 1


@pytest.mark.parametrize("walk", ["w", "wT"])
@pytest.mark.parametrize("level", ["tile", "inner"])
def test_grouped_level_sm90_matches_plain(cuda, level, walk):
    """K7's tile / inner instances against the plain version under the
    same plan (64-row chunks, 16-row bands, each recording into its own
    layout tile's row), integer bf16 operands (exact): clean, an SEU in a
    chunk that spans past its group's row_end and one in the dead chunk
    corrected bit for bit and located, detect-only leaving one (at inner
    counted once), verify="final"; two SEUs in two bands of one chunk in
    one k-step (a campaign at rate 1.0 and a deterministic SEU) both
    corrected."""
    from repro_torch.kernels import grouped_gemm as kgg
    lay, glay = _sm90_layout(9)
    gen = torch.Generator(device="cuda").manual_seed(31 + len(level))
    k, n, ng = 768, 200, len(SM90_SIZES)
    buf = glay.scatter_rows(_ints_bf16(gen, lay.n_rows, k), lay)
    w = (_ints_bf16(gen, ng, k, n) if walk == "w" else
         _ints_bf16(gen, ng, n, k).transpose(-1, -2))
    ft = FT.replace(level=level)
    p = kgg.plan_k7_call(buf, w, lay.gid, ft=ft)
    assert (p.instance, p.chunk, p.w_kmajor) == ("sm90", 64, walk == "wT")
    re = lay.row_end.tolist()
    base = lay.base.tolist()

    def call(pol, inj=None, rng=None):
        kw = dict(ft=pol, inj=inj, inj_mag=99.0, rng=rng)
        before = kgg.FT_GEMM_GROUPED_SM90.launches
        got = kgg.ft_gemm_grouped(buf, w, lay.gid, lay.row_end, **kw)
        assert kgg.FT_GEMM_GROUPED_SM90.launches == before + 1
        return got, kgg.planned_grouped_plain(buf, w, lay.gid, lay.row_end,
                                              **kw)

    (clean, rep0), (clean_p, rep0_p) = call(ft)
    assert torch.equal(clean, clean_p) and float(rep0[..., 0].sum()) == 0.0
    _check_reports(rep0, rep0_p)
    past = (1, re[2] - 1, n - 1, 1)
    for pol, inj in ((ft, past), (ft.replace(action="detect"), past),
                     (ft.replace(verify="final"), (1, base[0], 5, 0)),
                     (ft, (1, lay.t_buf - 1, 7, 2))):
        (out, rep), (out_p, rep_p) = call(pol, inj)
        assert torch.equal(out, out_p)
        _check_reports(rep, rep_p)
        cell = rep[rep[..., 0] > 0]
        assert (int(cell[-1, 2]), int(cell[-1, 3])) == inj[1:3]
        if pol.corrects:
            assert torch.equal(out, clean)
            assert float(rep[..., 0].sum()) == float(rep[..., 1].sum()) == 1
        else:
            assert float(rep[..., 1].sum()) == 0.0
            if level == "inner":
                assert float(rep[..., 0].sum()) == 1.0
    ftc = ft.replace(inject_rate=1.0)
    hit, step, row, col = kgg.seu_tile_draws(TRIPLE, ftc, lay.num_tiles,
                                             kgg.cdiv(n, 128),
                                             kgg.cdiv(k, 256), p.tiles, "cuda")
    i = base[2] // 16                           # group 2's first chunk
    # a band of the chunk whose own SEU falls in another k-step than tile
    # i's, so the step holds one SEU in each of the two bands
    t = next(q for q in (i + 1, i + 2, i + 3)
             if int(step[q, 1]) != int(step[i, 1]))
    r2 = t * 16 + int(row[i, 1])
    inj = (1, r2, 128 + (int(col[i, 1]) + 1) % 72, int(step[i, 1]))
    for pol in (ftc, ftc.replace(action="detect")):
        (out, rep), (out_p, rep_p) = call(pol, inj, TRIPLE)
        assert torch.equal(out, out_p)
        _check_reports(rep, rep_p)
        if pol.corrects:
            assert torch.equal(out, clean)
            assert float(rep[i, 1, 1]) == 1.0 and float(rep[t, 1, 1]) == 2.0
        else:
            assert float(rep[..., 1].sum()) == 0.0


# ---------------------------------------------------------------------------
# K1's last epilogue chains: gelu / relu on the tensor cores, the SIMT
# chain instance (csrc/ft_gemm_chain.cu), whisper on the card
# ---------------------------------------------------------------------------

CHAIN_CASES = [("bias", "relu"), ("bias", "gelu"), ("gelu",), ("relu",),
               ("residual",), ("gelu", "residual"), ("bias", "residual"),
               ("residual", "bias", "silu"), ("bias", "gelu", "residual"),
               ("relu", "bias")]


@pytest.mark.parametrize("level", ["off", "block", "tile", "inner"])
@pytest.mark.parametrize("chain", CHAIN_CASES, ids="+".join)
def test_chain_instance_matches_plain_f32(cuda, chain, level):
    """Every chain `plan` sends to the chain instance, f32 integer operands
    at both SIMT tiles and a ragged shape: outputs (and act_grad) equal to
    the plain version's, reports equal, an SEU corrected (FT on)."""
    act = any(x in ("silu", "gelu", "relu") for x in chain)
    for m, n, k in ((7, 130, 200), (100, 200, 97)):
        gen = torch.Generator(device="cuda").manual_seed(m + len(chain))
        a, b = _ints(gen, m, k), _ints(gen, k, n)
        bias = _ints(gen, n) if "bias" in chain else None
        res = _ints(gen, m, n) if "residual" in chain else None
        ft = None if level == "off" else FT.replace(level=level)
        for ag in ((False, True) if act else (False,)):
            p = ft_gemm.plan_call(a, b, chain=chain, ft=ft, save_act_grad=ag)
            if ft_gemm.simt_compiled(chain, level, ag):
                assert p.instance == "simt"
                continue
            assert p.instance == "simt_chain"
            for inj in ((None,) if ft is None else (None, (1, -1, m - 1, 3,
                                                           1))):
                kw = dict(chain=chain, bias=bias, residual=res, ft=ft,
                          inj=inj, inj_mag=99.0, save_act_grad=ag)
                before = ft_gemm.FT_GEMM_CHAIN.launches
                got, rep = ft_gemm.ft_gemm(a, b, **kw)
                assert ft_gemm.FT_GEMM_CHAIN.launches == before + 1
                want, rep_p = ft_gemm.planned_plain(a, b, **kw)
                for g_, w_ in zip(got if ag else (got,),
                                  want if ag else (want,)):
                    torch.testing.assert_close(g_, w_, rtol=1e-5, atol=1e-5)
                if ft is not None:
                    _check_reports(rep, rep_p)
                    assert float(rep[..., 0].sum()) == \
                        float(rep[..., 1].sum()) == (inj is not None)


def test_chain_instance_bf16_matches_plain(cuda):
    gen = torch.Generator(device="cuda").manual_seed(3)
    m, n, k = 300, 520, 700
    a = (torch.randn(m, k, generator=gen, device="cuda")).bfloat16()
    b = (torch.randn(k, n, generator=gen, device="cuda") * 0.05).bfloat16()
    bias = (torch.randn(n, generator=gen, device="cuda") * 0.1).bfloat16()
    res = torch.randn(m, n, generator=gen, device="cuda").bfloat16()
    for chain in (("gelu", "residual"), ("bias", "residual", "relu"),
                  ("silu", "bias")):
        for level in ("block", "tile", "inner"):
            kw = dict(chain=chain, ft=FT.replace(level=level),
                      bias=bias if "bias" in chain else None,
                      residual=res if "residual" in chain else None)
            assert ft_gemm.plan_call(a, b, chain=chain, ft=kw["ft"]
                                     ).instance == "simt_chain"
            out, rep = ft_gemm.ft_gemm(a, b, **kw)
            want, rep_p = ft_gemm.planned_plain(a, b, **kw)
            tol = 2.0 ** -7 * float(want.float().abs().max())
            assert float((out.float() - want.float()).abs().max()) <= tol
            assert float(rep[..., 0].sum()) == 0.0


@pytest.mark.parametrize("level", ["off", "block", "tile", "inner"])
@pytest.mark.parametrize("act", ["gelu", "relu"])
def test_gelu_relu_on_the_tensor_cores_match_plain(cuda, act, level):
    """bias? + gelu / relu with and without act_grad on K1's tensor-core
    instances (split-K at 4 rows), bf16 against the plain version under
    the same plan; integer operands with an SEU (FT on) corrected bit for
    bit."""
    counter = (ft_gemm.FT_GEMM_LEVEL_SM90 if level in ("tile", "inner")
               else ft_gemm.FT_GEMM_SM90)
    ft = None if level == "off" else FT.replace(level=level)
    for m, n, k in ((4, 1024, 1024), (300, 520, 704)):
        gen = torch.Generator(device="cuda").manual_seed(m + n)
        a = _ints(gen, m, k, dtype=torch.bfloat16)
        b = _ints(gen, k, n, dtype=torch.bfloat16)
        bias = _ints(gen, n, dtype=torch.bfloat16)
        for chain in ((act,), ("bias", act)):
            for ag in (False, True):
                kw = dict(chain=chain, ft=ft, save_act_grad=ag,
                          bias=bias if "bias" in chain else None)
                p = ft_gemm.plan_call(a, b, chain=chain, ft=ft,
                                      save_act_grad=ag)
                assert p.instance == "sm90"
                for inj in ((None,) if ft is None else
                            (None, (1, -1, m - 1, n - 2, 1))):
                    before = counter.launches
                    got, rep = ft_gemm.ft_gemm(a, b, inj=inj, inj_mag=64.0,
                                               **kw)
                    assert counter.launches == before + 1
                    want, rep_p = ft_gemm.planned_plain(a, b, inj=inj,
                                                        inj_mag=64.0, **kw)
                    for g_, w_ in zip(got if ag else (got,),
                                      want if ag else (want,)):
                        tol = 2.0 ** -7 * float(w_.float().abs().max())
                        assert float((g_.float() - w_.float()).abs().max()
                                     ) <= tol
                    if ft is not None:
                        _check_fields(rep, rep_p)
                        assert float(rep[..., 1].sum()) == (inj is not None)


def test_whisper_smoke_generate_on_card_matches_cpu(cuda):
    """whisper SMOKE through `generate` on the card (K1 SIMT and chain
    instances and the SIMT K2 in f32, K5) against the CPU plain run:
    greedy tokens equal in f32; the bf16 prefill logits (tensor-core K1,
    K2 on the tensor cores at the SMOKE head dim padded to 64) within
    2e-2 of the CPU bf16 run's max |logit|."""
    import numpy as np
    from repro_torch.configs import registry
    from repro_torch.configs.base import RunConfig
    from repro_torch.models import whisper
    from repro_torch.train import serve
    cfg = registry.get_smoke("whisper-medium")
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (2, 8))
    frames = rng.normal(size=(2, cfg.n_audio_frames, cfg.d_model)
                        ).astype(np.float32)
    sc = serve.ServeConfig(max_len=32)
    params = whisper.init(cfg, seed=0, dtype=torch.float32, device="cpu")
    run = RunConfig(model=cfg, ft=FT, dtype="float32", attn_chunk=16)
    want = serve.generate(params, prompts, cfg, run, sc, max_new_tokens=4,
                          extra=frames, device="cpu")
    got = serve.generate(params.to("cuda"), prompts, cfg, run, sc,
                         max_new_tokens=4, extra=frames, device="cuda")
    np.testing.assert_array_equal(got, want)
    run16 = RunConfig(model=cfg, ft=FT, dtype="bfloat16", attn_chunk=16)
    p16 = whisper.init(cfg, seed=0, dtype=torch.bfloat16, device="cpu")
    logits = []
    for dev in ("cpu", "cuda"):
        pre, _ = serve.make_serve_fns(cfg, run16)
        cache = whisper.init_cache(cfg, 2, 32, torch.bfloat16, dev)
        lg, _ = pre(p16.to(dev), torch.as_tensor(prompts, device=dev), cache,
                    torch.as_tensor(frames, device=dev))
        logits.append(lg.float().cpu())
    err = float((logits[1] - logits[0]).abs().max())
    assert err <= 2e-2 * float(logits[0].abs().max())


# ---------------------------------------------------------------------------
# mamba2 (the SSM family): K5's SIMT instance at the SSD products, the
# model at full width
# ---------------------------------------------------------------------------

#: (M, N, K) of mamba2-780m's four SSD products (chunk 256, state 128,
#: head dim 64)
SSD_SHAPES = {"ssd_cb": (256, 256, 128), "ssd_lx": (256, 64, 256),
              "ssd_state": (128, 64, 256), "ssd_ch": (256, 64, 128)}


@pytest.mark.parametrize("level", ["off", "block", "tile", "inner"])
@pytest.mark.parametrize("product", list(SSD_SHAPES))
def test_k5_simt_at_ssd_shapes_matches_plain(cuda, product, level):
    """K5 at the four SSD products, cut to 3 slices: the SIMT instance by
    `plan_k5`'s rule, bf16 against the plain version under the same plan
    (one bf16 ulp of the output's range; det / corr / row / col / k equal,
    tau within 1e-5); integer operands with an SEU of 64 in slice 1
    corrected bit for bit and located at its global row and column, and
    left by detect-only."""
    m, n, k = SSD_SHAPES[product]
    gen = torch.Generator(device="cuda").manual_seed(m + n + k)
    ft = None if level == "off" else FT.replace(level=level)
    a = torch.randn(3, m, k, generator=gen, device="cuda").bfloat16()
    b = torch.randn(3, k, n, generator=gen, device="cuda").bfloat16()
    assert ft_gemm.plan_call(a, b, ft=ft).instance == "simt"
    before = ft_gemm.FT_GEMM_BATCHED.launches
    got, rep = ft_gemm.ft_gemm(a, b, ft=ft)
    assert ft_gemm.FT_GEMM_BATCHED.launches == before + 1
    want, rep_p = ft_gemm.planned_plain(a, b, ft=ft)
    tol = 2.0 ** -7 * float(want.float().abs().max())
    assert float((got.float() - want.float()).abs().max()) <= tol
    if ft is None:
        return
    _check_fields(rep, rep_p)
    assert float(rep[..., 0].sum()) == 0.0
    a = _ints(gen, 3, m, k, dtype=torch.bfloat16)
    b = _ints(gen, 3, k, n, dtype=torch.bfloat16)
    row, col = m * 5 // 7, n * 3 // 5
    kw = dict(inj=(1, 1, row, col, 1), inj_mag=64.0)
    clean, _ = ft_gemm.ft_gemm(a, b, ft=ft)
    fixed, rep = ft_gemm.ft_gemm(a, b, ft=ft, **kw)
    _, rep_p = ft_gemm.planned_plain(a, b, ft=ft, **kw)
    _check_fields(rep, rep_p)
    assert torch.equal(fixed, clean)
    hit = (rep[..., 0] > 0).nonzero()
    cell = rep[rep[..., 0] > 0]
    assert hit.shape[0] == 1 and int(hit[0, 0]) == 1
    assert (int(cell[0, 2]), int(cell[0, 3])) == (row, col)
    assert float(rep[..., 1].sum()) == 1.0
    left, rep_d = ft_gemm.ft_gemm(a, b, ft=ft.replace(action="detect"), **kw)
    assert [tuple(x) for x in (left != clean).nonzero().tolist()] == \
        [(1, row, col)]
    assert float(rep_d[..., 1].sum()) == 0.0


def test_k5_simt_takes_more_than_65535_slices(cuda):
    """The SIMT K5 walks (slice, row block, column block) on a 1-D grid, so
    70 000 slices of (17 x 8)·(8 x 8) run in one launch: outputs and every
    report row equal to the plain version's, an SEU in slice 69 999
    corrected and located there."""
    gen = torch.Generator(device="cuda").manual_seed(70)
    a = _ints(gen, 70_000, 17, 8, dtype=torch.bfloat16)
    b = _ints(gen, 70_000, 8, 8, dtype=torch.bfloat16)
    assert ft_gemm.plan_call(a, b, ft=FT).instance == "simt"
    for inj in (None, (1, 69_999, 16, 7, 0)):
        kw = dict(ft=FT, inj=inj, inj_mag=64.0)
        (got, rep), n = _launched((ft_gemm.FT_GEMM_BATCHED,),
                                  lambda: ft_gemm.ft_gemm(a, b, **kw))
        assert n == [1]
        want, rep_p = ft_gemm.planned_plain(a, b, **kw)
        assert torch.equal(got, want) and rep.shape == (70_000, 1, 1, 8)
        _check_fields(rep, rep_p)
        hit = (rep[..., 0] > 0).nonzero().tolist()
        assert hit == ([] if inj is None else [[69_999, 0, 0]])
        if inj is not None:
            assert rep[69_999, 0, 0, :4].tolist() == [1.0, 1.0, 16.0, 7.0]


def test_mamba2_full_width_kernels_match_plain(cuda, monkeypatch):
    """mamba2-780m at full width, 2 layers, bf16: a prefill of 2 x 512
    tokens (two SSD chunks of 256) and a decode step through the kernels
    and through their plain versions (`ft_gemm.planned_plain` in place of
    `ft_gemm.ft_gemm`) at block, tile and inner: logits within 2e-2 of
    max |logit|, no detection, K1 2 a layer and the head per step on the
    tensor cores, K5 4 a layer per prefill on its SIMT instance."""
    import dataclasses
    from repro_torch.configs import mamba2_780m
    from repro_torch.configs.base import RunConfig
    from repro_torch.core import telemetry
    from repro_torch.models import mamba2
    from repro_torch.train import serve
    cfg = dataclasses.replace(mamba2_780m.CONFIG, n_layers=2)
    params = mamba2.init(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size, (2, 512), generator=gen,
                            device="cuda")
    tok = torch.randint(0, cfg.vocab_size, (2, 1), generator=gen,
                        device="cuda")
    kernel = ft_gemm.ft_gemm

    def run(level):
        pre, dec = serve.make_serve_fns(cfg, RunConfig(
            model=cfg, ft=FT.replace(level=level), dtype="bfloat16"))
        with telemetry.ft_scope() as scope:
            cache = mamba2.init_cache(cfg, 2, 1024)
            lg0, cache = pre(params, prompts, cache)
            lg1, cache = dec(params, tok, cache)
        assert scope.totals()["detected"] == 0.0
        return [lg0.float(), lg1.float().reshape(2, -1)]

    for level in ("block", "tile", "inner"):
        k1 = (ft_gemm.FT_GEMM_LEVEL_SM90 if level != "block"
              else ft_gemm.FT_GEMM_SM90)
        counters = (k1, ft_gemm.FT_GEMM_BATCHED, ft_gemm.FT_GEMM_BATCHED_SM90)
        before = [c.launches for c in counters]
        got = run(level)
        assert [c.launches - x for c, x in zip(counters, before)] == \
            [2 * (2 * cfg.n_layers + 1), 4 * cfg.n_layers, 0]
        monkeypatch.setattr(ft_gemm, "ft_gemm",
                            lambda a, b, *, tiles=None, **kw:
                            ft_gemm.planned_plain(a, b, tiles=tiles, **kw))
        want = run(level)
        monkeypatch.setattr(ft_gemm, "ft_gemm", kernel)
        for g_, w_ in zip(got, want):
            err = float((g_ - w_).abs().max())
            assert bool(torch.isfinite(g_).all())
            assert err <= 2e-2 * float(w_.abs().max())


# ---------------------------------------------------------------------------
# The last parts of the TPU kernels: K5's and K7's activation chains on
# both instances of each, K1's chains of several activations on the chain
# instance
# ---------------------------------------------------------------------------

ACT_CHAINS = [("relu",), ("gelu", "relu"), ("silu", "gelu", "relu")]
ALL_LEVELS = ["off", "block", "tile", "inner"]


def _ft_at(level):
    return None if level == "off" else FT.replace(level=level)


def _chain_seus(call, plain, ft, inj, hits):
    """An SEU of 64 under ``ft``: corrected to the clean output bit for bit
    with ``hits`` detections and corrections and the plain version's
    report, then left by detect-only (no correction)."""
    clean, _ = call(ft=ft)
    fixed, rep = call(ft=ft, inj=inj, inj_mag=64.0)
    _, rep_p = plain(ft=ft, inj=inj, inj_mag=64.0)
    _check_fields(rep, rep_p)
    assert torch.equal(fixed, clean)
    assert float(rep[..., 0].sum()) == float(rep[..., 1].sum()) == hits
    _, rep_d = call(ft=ft.replace(action="detect"), inj=inj, inj_mag=64.0)
    assert float(rep_d[..., 1].sum()) == 0.0
    assert float(rep_d[..., 0].sum()) >= hits


@pytest.mark.parametrize("level", ALL_LEVELS)
@pytest.mark.parametrize("chain", ACT_CHAINS, ids="+".join)
def test_k5_sm90_chains_match_plain(cuda, chain, level):
    """K5 with a chain on its tensor-core instance (csrc/batched_sm90.cu),
    on decode attention's K-cache view (two batch dims, a ragged last
    column block) and a shared B: outputs within one bf16 ulp of the plain version under the
    same plan, reports equal, an SEU in every slice corrected bit for bit
    (FT on)."""
    gen = torch.Generator(device="cuda").manual_seed(len(chain) + 5)
    for product in ("qk", "shared"):
        a, b = _k5_operands(gen, product, 3, 2, 7, 520, 128,
                            lambda g, *sh: _ints_bf16(g, *sh))
        ft = _ft_at(level)
        p = ft_gemm.plan_call(a, b, chain=chain, ft=ft)
        assert p.instance == "sm90" and not p.reason

        def call(**kw):
            res, n = _launched((ft_gemm.FT_GEMM_BATCHED_SM90, ft_gemm.FT_GEMM_K5),
                               lambda: ft_gemm.ft_gemm(a, b, chain=chain, **kw))
            assert n == [1, 1]
            return res

        def plain(**kw):
            return ft_gemm.planned_plain(a, b, chain=chain, **kw)

        out, rep = call(ft=ft)
        out_p, rep_p = plain(ft=ft)
        _bf16_close(out, out_p)
        assert float(out.float().min()) >= 0.0
        if ft is None:
            assert rep is None
            continue
        _check_fields(rep, rep_p)
        assert float(rep[..., 0].sum()) == 0.0
        slices = a.shape[:-2].numel()
        _chain_seus(call, plain, ft, (1, -1, 6, 100, 0), slices)


@pytest.mark.parametrize("level", ALL_LEVELS)
@pytest.mark.parametrize("chain", ACT_CHAINS, ids="+".join)
def test_k5_simt_chains_match_plain(cuda, chain, level):
    """K5 with a chain on the SIMT chain instance: f32 (both SIMT tiles)
    and bf16 above 16 rows (mamba2's SSD kind), integer operands: outputs
    and reports equal to the plain version's, an SEU in slice 1 corrected
    and located (FT on)."""
    gen = torch.Generator(device="cuda").manual_seed(len(chain) + 50)
    ft = _ft_at(level)
    for dtype, (nb, m, k, n) in ((torch.float32, (5, 7, 200, 130)),
                                 (torch.float32, (3, 100, 97, 200)),
                                 (torch.bfloat16, (6, 40, 64, 96))):
        a = _ints(gen, nb, m, k, dtype=dtype)
        b = _ints(gen, nb, k, n, dtype=dtype)
        p = ft_gemm.plan_call(a, b, chain=chain, ft=ft)
        assert p.instance == "simt_chain" and p.tiles == ft_gemm.pick_tiles(m)

        def call(**kw):
            res, c = _launched((ft_gemm.FT_GEMM_BATCHED_CHAIN,
                                ft_gemm.FT_GEMM_CHAIN, ft_gemm.FT_GEMM_K5),
                               lambda: ft_gemm.ft_gemm(a, b, chain=chain, **kw))
            assert c == [1, 0, 1]
            return res

        def plain(**kw):
            return ft_gemm.planned_plain(a, b, chain=chain, **kw)

        out, rep = call(ft=ft)
        out_p, rep_p = plain(ft=ft)
        if dtype == torch.float32:
            torch.testing.assert_close(out, out_p, rtol=1e-5, atol=1e-5)
        else:
            _bf16_close(out, out_p)
        if ft is None:
            assert rep is None
            continue
        (_check_reports if dtype == torch.float32 else _check_fields)(
            rep, rep_p)
        assert float(rep[..., 0].sum()) == 0.0
        _chain_seus(call, plain, ft, (1, 1, m - 1, n - 2, 1), 1)


@pytest.mark.parametrize("level", ALL_LEVELS)
@pytest.mark.parametrize("chain", ACT_CHAINS[:2], ids="+".join)
def test_k7_sm90_chains_match_plain(cuda, chain, level):
    """K7 with a chain on its tensor-core instance, both walks of w: a
    group of two 64-row chunks (the second past row_end), empty groups and
    a dead tail (its rows stay 0 = chain(0)); outputs equal to the plain
    version's, reports equal, an SEU past a chunk's start corrected bit
    for bit (FT on)."""
    from repro_torch.kernels import grouped_gemm as kgg
    lay, glay = _sm90_layout(len(chain))
    gen = torch.Generator(device="cuda").manual_seed(31)
    k, n, ng = 320, 200, len(SM90_SIZES)
    buf = glay.scatter_rows(_ints(gen, lay.n_rows, k, dtype=torch.bfloat16),
                            lay)
    ft = _ft_at(level)
    for w in (_ints(gen, ng, k, n, dtype=torch.bfloat16),
              _ints(gen, ng, n, k, dtype=torch.bfloat16).transpose(-1, -2)):
        p = kgg.plan_k7_call(buf, w, lay.gid, ft=ft, chain=chain)
        assert p.instance == "sm90" and not p.reason

        def call(**kw):
            res, c = _launched((kgg.FT_GEMM_GROUPED_SM90, kgg.FT_GEMM_GROUPED),
                               lambda: kgg.ft_gemm_grouped(
                                   buf, w, lay.gid, lay.row_end, chain=chain,
                                   **kw))
            assert c == [1, 1]
            return res

        def plain(**kw):
            return kgg.planned_grouped_plain(buf, w, lay.gid, lay.row_end,
                                             chain=chain, **kw)

        out, rep = call(ft=ft)
        out_p, rep_p = plain(ft=ft)
        _bf16_close(out, out_p)
        assert float(out.float().min()) >= 0.0
        assert not bool(out[_dead_rows(lay)].any())
        if ft is None:
            continue
        _check_fields(rep, rep_p)
        assert float(rep[..., 0].sum()) == 0.0
        re = lay.row_end.tolist()
        _chain_seus(call, plain, ft, (1, re[2] - 1, n - 1, 1), 1)


@pytest.mark.parametrize("level", ALL_LEVELS)
@pytest.mark.parametrize("chain", ACT_CHAINS[:2], ids="+".join)
def test_k7_simt_chains_match_plain(cuda, chain, level):
    """K7 with a chain on its SIMT chain instance (csrc/ft_gemm_chain.cu):
    f32 at row tiles 8 and 16 (the plan) and bf16 at pinned SIMT tiles, on
    both walks of w; integer operands, outputs and reports equal to the
    plain version's, an SEU in a ragged group corrected and located (FT
    on)."""
    from repro_torch.kernels import grouped_gemm as kgg
    ft = _ft_at(level)
    k, n, ng = 200, 300, len(GROUP_SIZES)
    for dtype, bm, tiles in ((torch.float32, 8, None),
                             (torch.float32, 16, None),
                             (torch.bfloat16, 16, (16, 128, 32))):
        lay, glay = _grouped_layout(GROUP_SIZES, bm, 2)
        gen = torch.Generator(device="cuda").manual_seed(bm + len(chain))
        buf = glay.scatter_rows(_ints(gen, lay.n_rows, k, dtype=dtype), lay)
        for w in (_ints(gen, ng, k, n, dtype=dtype),
                  _ints(gen, ng, n, k, dtype=dtype).transpose(-1, -2)):
            p = kgg.plan_k7_call(buf, w, lay.gid, tiles, ft, chain)
            assert p.instance == "simt_chain" and str(chain) in p.reason

            def call(**kw):
                res, c = _launched(
                    (kgg.FT_GEMM_GROUPED_CHAIN, kgg.FT_GEMM_GROUPED_SIMT,
                     kgg.FT_GEMM_GROUPED),
                    lambda: kgg.ft_gemm_grouped(buf, w, lay.gid, lay.row_end,
                                                chain=chain, tiles=tiles,
                                                **kw))
                assert c == [1, 0, 1]
                return res

            def plain(**kw):
                return kgg.planned_grouped_plain(
                    buf, w, lay.gid, lay.row_end, chain=chain, tiles=tiles,
                    **kw)

            out, rep = call(ft=ft)
            out_p, rep_p = plain(ft=ft)
            if dtype == torch.float32:
                torch.testing.assert_close(out, out_p, rtol=1e-5, atol=1e-5)
            else:
                _bf16_close(out, out_p)
            if ft is None:
                continue
            _check_fields(rep, rep_p)
            assert float(rep[..., 0].sum()) == 0.0
            row = int(lay.row_end[2]) - 1
            _chain_seus(call, plain, ft, (1, row, n - 3, 2), 1)


K1_ACT_CHAINS = [("gelu", "relu"), ("bias", "silu", "relu", "residual"),
                 ("relu", "gelu", "silu"),
                 ("bias",) + ("silu", "gelu", "relu", "gelu") * 2
                 + ("residual",)]


@pytest.mark.parametrize("level", ALL_LEVELS)
@pytest.mark.parametrize("chain", K1_ACT_CHAINS,
                         ids=lambda c: f"{len(c)}ops-{c[0]}-{c[-1]}")
def test_k1_chains_of_several_activations_match_plain(cuda, chain, level):
    """K1's chains of two or more activations (up to the cap, 10 ops) on the
    chain instance: f32 integer operands at both SIMT tiles and bf16 at
    whisper's kind of shape, against the plain version under the same plan;
    an SEU corrected bit for bit (FT on)."""
    ft = _ft_at(level)
    for dtype, (m, n, k) in ((torch.float32, (7, 130, 200)),
                             (torch.float32, (100, 200, 97)),
                             (torch.bfloat16, (300, 520, 704))):
        gen = torch.Generator(device="cuda").manual_seed(m + len(chain))
        a, b = _ints(gen, m, k, dtype=dtype), _ints(gen, k, n, dtype=dtype)
        bias = _ints(gen, n, dtype=dtype) if "bias" in chain else None
        res = _ints(gen, m, n, dtype=dtype) if "residual" in chain else None
        kw0 = dict(chain=chain, bias=bias, residual=res)
        p = ft_gemm.plan_call(a, b, chain=chain, ft=ft)
        assert p.instance == "simt_chain"
        assert dtype != torch.bfloat16 or "two or more" in p.reason

        def call(**kw):
            res_, c = _launched((ft_gemm.FT_GEMM_CHAIN, ft_gemm.FT_GEMM_2D),
                                lambda: ft_gemm.ft_gemm(a, b, **kw0, **kw))
            assert c == [1, 1]
            return res_

        def plain(**kw):
            return ft_gemm.planned_plain(a, b, **kw0, **kw)

        out, rep = call(ft=ft)
        out_p, rep_p = plain(ft=ft)
        if dtype == torch.float32:
            torch.testing.assert_close(out, out_p, rtol=1e-5, atol=1e-5)
        else:
            _bf16_close(out, out_p)
        if ft is None:
            continue
        (_check_reports if dtype == torch.float32 else _check_fields)(
            rep, rep_p)
        assert float(rep[..., 0].sum()) == 0.0
        _chain_seus(call, plain, ft, (1, -1, m - 1, 3, 1), 1)
