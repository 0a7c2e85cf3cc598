"""The tensor-core instances of the flash forward (`csrc/flash_fwd_sm90.cu`)
and of the paged decode (`csrc/flash_decode_sm90.cu`) from the CPU side:
`flashft.plan_fwd`'s and `plan_decode`'s rules, the decode's ranges and
their combine, and the flash fronts' head-dim padding.

The ranged decode walk (what the decode kernel and its combine compute
when a row's pages are cut into ranges) is held against the unsplit walk
and against the reference's Pallas `flash_ft_decode_attention` in
interpret mode (via its `ops.flash_ft_decode`): outputs to 2e-5 (the
ranges merge their online softmaxes in another order), reports det / corr
/ row / col / k / tau equal to the unsplit walk's, and det / corr / row /
col / k equal and tau to 1e-5 relative against the reference. The padded
fronts are held against the reference fronts at the same head dim and
pinned tiles: outputs to 1e-5, reports det / corr / row / col / k equal,
tau to 1e-5 relative.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.core.policy import InjectionSpec, ONLINE_BLOCK  # noqa: E402
from repro.kernels import ops as rops  # noqa: E402
from repro.train import kv_cache as rkv  # noqa: E402

from repro_torch.core.policy import ONLINE_BLOCK as T_ONLINE  # noqa: E402
from repro_torch.kernels import flashft as tflash  # noqa: E402
from repro_torch.train import kv_cache as tkv  # noqa: E402

from test_torch_flash_bwd import (_backward, _check_report,  # noqa: E402
                                  _forward, _inputs)

LENGTHS = (0, 1, 17, 64, 130)
KVH, NREP, PAGE, DH = 2, 3, 16, 128
FIELDS = [0, 1, 2, 3, 6, 7]


# ---------------------------------------------------------------------------
# plan_fwd / plan_decode
# ---------------------------------------------------------------------------

def _fwd_ops(dh=128, dtype=torch.bfloat16):
    return (torch.zeros(6, 100, dh, dtype=dtype),
            torch.zeros(2, 100, dh, dtype=dtype),
            torch.zeros(2, 100, dh, dtype=dtype))


@pytest.mark.parametrize("case,instance,reason", [
    ("bf16 dh 128", "sm90", ""),
    ("f32", "simt", "dtype"),
    ("dh 64", "sm90", ""),
    ("f32 dh 64", "simt", "dtype"),
    ("dh 96", "simt", "head dim"),
    ("non-contiguous", "simt", "non-contiguous"),
    ("non-contiguous dh 64", "simt", "non-contiguous"),
    ("pinned blocks", "simt", "pinned"),
    ("pinned blocks dh 64", "simt", "pinned"),
    ("misaligned", "simt", "aligned"),
    ("misaligned dh 64", "simt", "aligned"),
])
def test_plan_fwd_rule(case, instance, reason):
    """bf16 at head dim 64 or 128 with the default blocks and operands TMA
    reads takes the tensor cores; each other call keeps its SIMT reason
    at either head dim."""
    dh = 64 if case.endswith("dh 64") else 96 if case == "dh 96" else 128
    q, k, v = _fwd_ops(dh=dh)
    kw = {}
    if case.startswith("f32"):
        q, k, v = _fwd_ops(dh=dh, dtype=torch.float32)
    elif case.startswith("non-contiguous"):
        v = torch.zeros(100, 2, dh, dtype=torch.bfloat16).transpose(0, 1)
    elif case.startswith("pinned blocks"):
        kw = dict(bq=64, bkv=64)
    elif case.startswith("misaligned"):
        q = torch.zeros(6 * 100 * dh + 1, dtype=torch.bfloat16)[1:].view(
            6, 100, dh)
    p = tflash.plan_fwd(q, k, v, **kw)
    assert p.instance == instance
    assert reason in p.reason and (reason == "") == (p.reason == "")


def _dec_ops(bq=16, dh=128, page=64, dtype=torch.bfloat16, slots=8, kvh=4,
             mp=16):
    return (torch.zeros(slots * kvh, bq, dh, dtype=dtype),
            torch.zeros(1 + slots * mp, kvh, page, dh, dtype=dtype),
            torch.zeros(1 + slots * mp, kvh, page, dh, dtype=dtype),
            torch.zeros(slots, mp, dtype=torch.int32))


@pytest.mark.parametrize("case,instance,reason", [
    ("bf16 page 64", "sm90", ""),
    ("bf16 page 32", "sm90", ""),
    ("f32", "simt", "dtype"),
    ("dh 256", "simt", "head dim"),
    ("page 16", "simt", "pages of 16"),
    ("32 query rows", "simt", "query rows"),
    ("pinned", "simt", "pinned"),
    ("misaligned", "simt", "aligned"),
])
def test_plan_decode_rule(case, instance, reason):
    ops = {"f32": dict(dtype=torch.float32), "dh 256": dict(dh=256),
           "page 16": dict(page=16), "bf16 page 32": dict(page=32),
           "32 query rows": dict(bq=32)}.get(case, {})
    q, k, v, table = _dec_ops(**ops)
    if case == "misaligned":
        q = torch.zeros(q.numel() + 1, dtype=q.dtype)[1:].view(q.shape)
    p = tflash.plan_decode(q, k, v, table, simt=case == "pinned")
    assert p.instance == instance
    assert reason in p.reason and (reason == "") == (p.reason == "")
    if instance == "sm90":   # the engines' 8 slots x 4 kv heads: 32 rows
        assert p.ranges == tflash.decode_ranges(32, 16) == 9
    else:
        assert p.ranges == 1


def test_decode_ranges_rule():
    assert tflash.decode_ranges(32, 16) == 9      # 288 CTAs, capped by 264
    assert tflash.decode_ranges(32, 4) == 4       # capped by the table
    assert tflash.decode_ranges(12, 4) == 4
    assert tflash.decode_ranges(264, 16) == 1     # two waves already
    assert tflash.decode_ranges(1000, 512) == 1
    assert tflash.decode_ranges(1, 1) == 1


@pytest.mark.parametrize("live", [1, 2, 5, 9, 16])
@pytest.mark.parametrize("ranges", [1, 3, 9])
def test_decode_range_shares(live, ranges):
    """Range z holds pages [z·live // ranges, (z + 1)·live // ranges): the
    ranges are contiguous, balanced (sizes differ by at most one), cover
    every page once, and `dkv_range_of` names each page's range."""
    bounds = [z * live // ranges for z in range(ranges + 1)]
    sizes = [hi - lo for lo, hi in zip(bounds, bounds[1:])]
    assert sum(sizes) == live and max(sizes) - min(sizes) <= 1
    for s in range(live):
        z = int(tflash.dkv_range_of(torch.tensor(s), torch.tensor(live),
                                    ranges))
        assert bounds[z] <= s < bounds[z + 1]


# ---------------------------------------------------------------------------
# the ranged decode walk
# ---------------------------------------------------------------------------

def _paged(seed, lengths=LENGTHS, kvh=KVH, nrep=NREP, page=PAGE, dh=DH):
    """Each slot's KV scattered into its pages through both packages'
    allocators and `write_prefill` (a length-0 slot keeps a NULL row), and
    numpy-seeded queries."""
    rng = np.random.default_rng(seed)
    b = len(lengths)
    mp = -(-max(lengths) // page) + 1
    n_pages = 1 + b * mp
    rc = rkv.init_paged_cache(1, n_pages, b, mp, kvh, page, dh, jnp.float32)
    tc = tkv.init_paged_cache(1, n_pages, b, mp, kvh, page, dh,
                              torch.float32, "cpu")
    alloc = rkv.PageAllocator(n_pages, b, mp, page)
    for length in lengths:
        s, _ = alloc.alloc_slot(length)
        if length == 0:
            continue
        ks, vs = (rng.standard_normal((1, length, kvh, dh)
                                      ).astype(np.float32) for _ in range(2))
        row = alloc.page_table[s]
        rc = rkv.write_prefill(rc, s, jnp.asarray(row), jnp.asarray(ks),
                               jnp.asarray(vs), length)
        tkv.write_prefill(tc, s, torch.as_tensor(row), torch.from_numpy(ks),
                          torch.from_numpy(vs), length)
    q = rng.standard_normal((b, kvh * nrep, dh)).astype(np.float32)
    return q, rc, tc, alloc


def _port_args(q, tc, alloc):
    """The wrapper-level operands `ops.flash_ft_decode` builds: q grouped
    by kv head and padded to the f32 sublane of 8 rows."""
    b, h, dh = q.shape
    qg = torch.nn.functional.pad(
        torch.from_numpy(q).reshape(b * KVH, h // KVH, dh),
        (0, 0, 0, 8 - h // KVH))
    return (qg, tc["k_pages"][0], tc["v_pages"][0],
            torch.as_tensor(alloc.lengths).int(),
            torch.as_tensor(alloc.page_table).int())


KW = dict(ft=T_ONLINE, scale=DH ** -0.5, tau_dh=DH)


@pytest.mark.parametrize("ranges", [2, 3, 9])
def test_ranged_decode_matches_unsplit_and_reference(ranges):
    q, rc, tc, alloc = _paged(ranges)
    args = _port_args(q, tc, alloc)
    out_u, rep_u = tflash.flash_decode_plain(*args, **KW)
    out_r, rep_r = tflash.flash_decode_plain(*args, ranges=ranges, **KW)
    np.testing.assert_allclose(out_r.numpy(), out_u.numpy(), rtol=2e-5,
                               atol=2e-5)
    assert torch.equal(rep_r[..., FIELDS], rep_u[..., FIELDS])
    assert float(rep_r[..., 0].sum()) == 0.0
    assert not out_r[:KVH].any() and not rep_r[:KVH].any()   # length 0
    ro, rr = rops.flash_ft_decode(
        jnp.asarray(q), rc["k_pages"][0], rc["v_pages"][0],
        jnp.asarray(alloc.lengths), jnp.asarray(alloc.page_table),
        ft=ONLINE_BLOCK, interpret=True)
    b, h = q.shape[:2]
    got = out_r[:, :NREP].reshape(b, h, DH).numpy()
    np.testing.assert_allclose(got, np.asarray(ro), rtol=2e-5, atol=2e-5)
    rr = np.asarray(rr)
    np.testing.assert_array_equal(rep_r.numpy()[..., [0, 1, 2, 3, 7]],
                                  rr[..., [0, 1, 2, 3, 7]])
    np.testing.assert_allclose(rep_r.numpy()[..., 6], rr[..., 6], rtol=1e-5,
                               atol=0)


def test_planned_decode_plain_walks_the_plans_ranges():
    """A bf16 call the tensor-core instance takes (16 query rows, pages of
    32) runs its plan's ranges; pinned to the SIMT kernel, the unsplit
    walk."""
    rng = np.random.default_rng(5)
    b, kvh, page, mp = 3, 2, 32, 6
    lengths = torch.tensor([0, 40, 190], dtype=torch.int32)
    qg = torch.from_numpy(rng.standard_normal((b * kvh, 16, DH))).bfloat16()
    pools = [torch.from_numpy(rng.standard_normal(
        (1 + b * mp, kvh, page, DH))).bfloat16() for _ in range(2)]
    table = torch.from_numpy(
        rng.permutation(b * mp).reshape(b, mp) + 1).int()
    p = tflash.plan_decode(qg, *pools, table)
    assert p.instance == "sm90" and p.ranges == 6
    out, rep = tflash.planned_decode_plain(qg, *pools, lengths, table, **KW)
    want = tflash.flash_decode_plain(qg, *pools, lengths, table,
                                     ranges=p.ranges, **KW)
    assert torch.equal(out, want[0]) and torch.equal(rep, want[1])
    out_s, rep_s = tflash.planned_decode_plain(qg, *pools, lengths, table,
                                               simt=True, **KW)
    want = tflash.flash_decode_plain(qg, *pools, lengths, table, **KW)
    assert torch.equal(out_s, want[0]) and torch.equal(rep_s, want[1])
    # the CPU wrapper runs the plan's version
    got = tflash.flash_ft_decode(qg, *pools, lengths, table, **KW)
    assert torch.equal(got[0], out) and torch.equal(got[1], rep)


def test_combine_merges_two_seus_in_range_order():
    """Slot 4 (130 tokens, 9 pages) in 3 ranges, an SEU in Δ at page 1
    (range 0) and another in S at page 7 (range 2), taken from two walks
    of the same data: the combine counts both, corrected, and takes row,
    col and mag from the later; the output equals the clean walk's. The
    workspace layout the kernels write gives the same through
    `combine_ws_plain`."""
    q, _, tc, alloc = _paged(11)
    args = _port_args(q, tc, alloc)
    g = 4 * KVH + 1
    ranges = 3
    walk = dict(ranges=ranges, **KW)
    first = (tflash.INJ_DELTA, g, 0, 1, 2, 70)
    later = (tflash.INJ_S, g, 0, 7, 5, 9)
    a = tflash._decode_ranges_plain(*args, inj=first, inj_mag=50.0, **walk)
    b = tflash._decode_ranges_plain(*args, inj=later, inj_mag=30.0, **walk)
    parts = [torch.cat([x[:1], y[1:]]) for x, y in zip(a, b)]
    out, rep = tflash.combine_plain(*parts)
    clean, rep_c = tflash.flash_decode_plain(*args, **walk)
    np.testing.assert_allclose(out.numpy(), clean.numpy(), rtol=1e-5,
                               atol=1e-5)
    cell = rep[g, 0]
    assert float(rep[..., 0].sum()) == 2.0 and float(rep[..., 1].sum()) == 2.0
    assert (float(cell[0]), float(cell[1])) == (2.0, 2.0)
    assert (int(cell[2]), int(cell[3])) == (5, 7 * PAGE + 9)
    assert abs(float(cell[4]) - 30.0) < 1e-3
    assert torch.equal(rep[..., 6:8], rep_c[..., 6:8])
    # the same partials through the workspace layout (rows outer): acc, m,
    # l and the report of each (row, range); the acc of an empty range is
    # garbage the combine must not read
    acc, m, l, reps = (x.transpose(0, 1) for x in parts)
    n_g, bq = acc.shape[0], acc.shape[2]
    acc = torch.nn.functional.pad(acc, (0, 0, 0, 16 - bq))
    m = torch.nn.functional.pad(m, (0, 16 - bq), value=tflash.NEG_INF)
    l = torch.nn.functional.pad(l, (0, 16 - bq))
    acc = torch.where((m > 0.5 * tflash.NEG_INF)[..., None], acc,
                      torch.full_like(acc, float("nan")))
    ws = torch.cat([acc.reshape(n_g, ranges, -1), m, l, reps], -1).reshape(-1)
    out_w, rep_w = tflash.combine_ws_plain(ws, n_g, ranges)
    torch.testing.assert_close(out_w[:, :bq].float(), out, rtol=2 ** -7,
                               atol=2 ** -7 * float(out.abs().max()))
    assert torch.equal(rep_w, rep)


# ---------------------------------------------------------------------------
# the plain K2 at head dim 64 (the tensor-core instance's function there)
# ---------------------------------------------------------------------------

#: whisper's three K2 geometries cut to size, MHA (n_rep 1): the encoder's
#: self-attention (Sq = Skv, a ragged last kv block of 36), the prefill's
#: cross-attention (16 queries) and the decoder's causal self-attention;
#: each with the (q block, kv step, row, S column, Δ column) of its SEUs.
DH64_GEOMS = {"encoder": (100, 100, False, (1, 1, 20, 30, 50)),
              "cross": (16, 100, False, (0, 1, 5, 10, 63)),
              "causal 16": (16, 16, True, (0, 0, 10, 3, 7))}


def _ref_k2(q, k, v, causal, spec=None, head=0, blk=0):
    """The reference's K2 (`repro/kernels/flashft.py:flash_ft_attention`,
    interpret mode) at the 64 x 64 block grid on operands zero-padded to
    its 128-lane head dim, as its front pads them (the front would refit
    the blocks to the ragged lengths). Returns out, m, l at the true sizes
    and the report."""
    from repro.kernels import flashft as rflash
    bh, sq, dh = q.shape
    skv = k.shape[1]

    def pad(x, rows):
        return jnp.asarray(np.pad(x, ((0, 0), (0, rows - x.shape[1]),
                                      (0, 128 - dh))))

    inj, mag = rflash.encode_injection(spec, head, blk)
    out, m, l, rep = rflash.flash_ft_attention(
        pad(q, -(-sq // 64) * 64), pad(k, -(-skv // 64) * 64),
        pad(v, -(-skv // 64) * 64), inj, mag,
        jnp.array([sq, skv], jnp.int32), jnp.zeros((3,), jnp.int32), bq=64,
        bkv=64, causal=causal, ft=ONLINE_BLOCK, interpret=True,
        scale=dh ** -0.5, n_rep=1, save_stats=True)
    return (np.asarray(out)[:, :sq, :dh], np.asarray(m)[:, :sq, 0],
            np.asarray(l)[:, :sq, 0], np.asarray(rep))


@pytest.mark.parametrize("seu", [None, "delta", "s"])
@pytest.mark.parametrize("geom", list(DH64_GEOMS))
def test_plain_k2_at_dh64_matches_reference(geom, seu):
    """`flash_ft_plain` at head dim 64 (tau over the 128-padded width, the
    64 x 64 grid) against the reference's K2 at whisper's geometries:
    outputs, m and l to 1e-5 (f32 sums in another order), reports det /
    corr / row / col / k equal and tau to 1e-5 relative. An SEU in Δ lands
    in both (same report); one in S, which the reference cannot inject,
    is corrected to the reference's clean output and located at (q row,
    kv column) with its magnitude, every other report cell the
    reference's. Magnitude 20: a corrected element keeps one ulp of it,
    under 1e-5."""
    sq, skv, causal, (blk, step, row, scol, dcol) = DH64_GEOMS[geom]
    bh, dh = 2, 64
    rng = np.random.default_rng(sq * skv + causal)
    q, k, v = (rng.normal(size=(bh, n, dh)).astype(np.float32)
               for n in (sq, skv, skv))
    spec = None if seu != "delta" else InjectionSpec(
        row=row, col=dcol, magnitude=20.0, k_step=step)
    ro, rm, rl, rrep = _ref_k2(q, k, v, causal, spec, bh - 1, blk)
    inj = None
    if seu is not None:
        inj = (tflash.INJ_DELTA if seu == "delta" else tflash.INJ_S, bh - 1,
               blk, step, row, dcol if seu == "delta" else scol)
    to, tm, tl, trep = tflash.flash_ft_plain(
        *(torch.from_numpy(x) for x in (q, k, v)), ft=T_ONLINE,
        scale=dh ** -0.5, tau_dh=128, causal=causal, inj=inj, inj_mag=20.0,
        save_stats=True)
    for got, want in ((to, ro), (tm, rm), (tl, rl)):
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    assert to.shape == (bh, sq, dh)
    if seu == "s":
        cell = trep[bh - 1, blk].clone()
        assert (float(trep[..., 0].sum()), float(trep[..., 1].sum())) == \
            (1.0, 1.0)
        assert (int(cell[2]), int(cell[3])) == (blk * 64 + row,
                                                step * 64 + scol)
        assert abs(float(cell[4]) - 20.0) < 1e-4
        trep[bh - 1, blk] = torch.tensor(rrep[bh - 1, blk])
    else:
        assert float(trep[..., 1].sum()) == (seu == "delta")
    _check_report(trep, rrep)


# ---------------------------------------------------------------------------
# the flash fronts' head-dim padding
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dh,padded", [(16, 64), (80, 128)])
def test_flash_fronts_pad_the_head_dim(monkeypatch, dh, padded):
    """ops.flash_ft and ops.flash_ft_bwd hand the kernel wrappers q, k, v
    (and g) zero-padded to the next compiled head dim and return out, dq,
    dk, dv at the true dh, as the reference's fronts at the same dh."""
    seen = []

    def recording(fn):
        def run(q, *args, **kw):
            seen.append((fn.__name__, q.shape[-1], kw["scale"],
                         kw["tau_dh"]))
            return fn(q, *args, **kw)
        return run

    for name in ("flash_ft_fwd", "flash_ft_dq", "flash_ft_dkv"):
        monkeypatch.setattr(tflash, name, recording(getattr(tflash, name)))
    bh, n_rep, sq = 6, 3, 70
    q, k, v, g = _inputs(dh, bh, n_rep, sq, sq, dh=dh)
    (ro, rm, rl, rrep), (to, tm, tl, trep) = _forward(q, k, v, n_rep, True)
    ref, port = _backward(q, k, v, g, ro, rm, rl, n_rep, True)
    assert [s[0] for s in seen] == ["flash_ft_fwd", "flash_ft_dq",
                                    "flash_ft_dkv"]
    assert all(s[1:] == (padded, dh ** -0.5, 128) for s in seen)
    for got, want in ((to, ro), (tm, rm), (tl, rl)) + tuple(
            zip(port[:3], ref[:3])):
        assert got.shape == tuple(np.asarray(want).shape)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    assert to.shape[-1] == dh and port[1].shape == (bh // n_rep, sq, dh)
    for got, want in ((trep, rrep),) + tuple(zip(port[3:], ref[3:])):
        _check_report(got, want)
        assert float(got[..., 0].sum()) == 0.0
