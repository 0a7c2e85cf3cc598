"""Port ↔ reference: the paged KV cache (`train/kv_cache.py`) and the plain
version of the paged decode kernel K6 (`kernels/flashft.py:
flash_decode_plain`, reached through `kernels/ops.py:flash_ft_decode`).

The same numpy inputs go to both packages:
  * allocator: the same operation traces, made from seeds, leave the same
    page tables, lengths, page counts, live flags and free lists;
  * pool writes: `write_prefill`, `append_layer` (a dead slot into the
    trash page), `append_token` and `gather_dense` give the same arrays;
    `plan_pages` with an explicit page size gives the same `PagePlan`
    (full-size geometry is arithmetic only: nothing is allocated);
  * K6's plain version against the reference kernel in interpret mode on
    the reference test's cases (tests/test_serve_engine.py): outputs to
    2e-5; reports det/corr/row/col/k equal, tau and mag to 1e-5 relative,
    the max residual to 1e-5 where a block detected (a clean block's is
    f32 rounding noise in two summation orders, so there both sides only
    have to stay below the largest tau its verifications could have); an
    SEU corrected bit for bit on exactly
    representable operands, and left in place by a detect-only policy.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as rreg  # noqa: E402
from repro.core.policy import FTConfig as RFT  # noqa: E402
from repro.core.policy import InjectionSpec as RSpec  # noqa: E402
from repro.core.policy import ONLINE_BLOCK as R_ONLINE  # noqa: E402
from repro.kernels import ops as rops  # noqa: E402
from repro.train import kv_cache as rkv  # noqa: E402

from repro_torch.core.policy import FTConfig as TFT  # noqa: E402
from repro_torch.core.policy import InjectionSpec as TSpec  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.train import kv_cache as tkv  # noqa: E402

CORRECT = dict(level="block", action="correct")
DETECT = dict(level="block", action="detect")


def _state(alloc):
    return (alloc.page_table.tolist(), alloc.lengths.tolist(),
            alloc.n_alloc.tolist(), alloc.live.tolist(), list(alloc._free))


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5, 6, 7])
def test_allocator_traces_match_reference(seed):
    """Random alloc / grow / free traces: both allocators end every
    operation in the same state, raise on the same operations, and keep
    their invariants."""
    rng = np.random.default_rng(seed)
    n_slots = int(rng.integers(1, 5))
    max_pages = int(rng.integers(1, 7))
    page = int(rng.choice([4, 8, 16]))
    n_pages = int(rng.integers(2, 2 + n_slots * max_pages))
    ra = rkv.PageAllocator(n_pages, n_slots, max_pages, page)
    ta = tkv.PageAllocator(n_pages, n_slots, max_pages, page)
    for _ in range(80):
        op = int(rng.integers(0, 3))
        live = [int(s) for s in np.flatnonzero(ra.live)]
        if op == 0:
            length = int(rng.integers(0, max_pages * page + 2))
            assert ta.can_admit(length) == ra.can_admit(length)
            calls = [(a.alloc_slot, (length,)) for a in (ra, ta)]
        elif live:
            slot = int(rng.choice(live))
            if op == 1:
                new_len = int(ra.lengths[slot]) + int(rng.integers(1, 2 * page))
                calls = [(a.ensure, (slot, new_len)) for a in (ra, ta)]
            else:
                calls = [(a.free_slot, (slot,)) for a in (ra, ta)]
        else:
            continue
        outs = []
        for fn, args in calls:
            try:
                outs.append(("ok", fn(*args)))
            except (RuntimeError, ValueError) as e:
                outs.append((type(e).__name__, None))
        assert outs[0] == outs[1]
        assert _state(ta) == _state(ra)
        assert ta.n_free == ra.n_free
        assert ta.free_slots() == ra.free_slots()
        assert ta.live_pages() == ra.live_pages()
        ta.check_invariants()
    table, lengths = ta.snapshot("cpu")
    assert table.dtype == torch.int32 and lengths.dtype == torch.int32
    np.testing.assert_array_equal(table.numpy(), ra.page_table)
    np.testing.assert_array_equal(lengths.numpy(), ra.lengths)


def test_allocator_rejects_what_the_reference_rejects():
    for mod in (rkv, tkv):
        with pytest.raises(ValueError):
            mod.PageAllocator(1, 2, 4, 8)
        a = mod.PageAllocator(4, 1, 2, 8)
        with pytest.raises(ValueError):
            a.alloc_slot(17)                  # 3 pages > max_pages
        a.alloc_slot(8)
        with pytest.raises(RuntimeError):
            a.alloc_slot(1)                   # no free slot
        a.free_slot(0)
        with pytest.raises(RuntimeError):
            a.ensure(0, 1)                    # the slot is not live
        with pytest.raises(RuntimeError):
            a.free_slot(0)
        a = mod.PageAllocator(3, 2, 2, 8)
        a.alloc_slot(16)
        with pytest.raises(RuntimeError):
            a.alloc_slot(1)                   # the pool is exhausted


@pytest.mark.parametrize("case", [
    dict(max_len=64, n_slots=2, page_size=8, dtype="float32", slack=1.0),
    dict(max_len=100, n_slots=3, page_size=16, dtype="bfloat16", slack=1.0),
    dict(max_len=30, n_slots=4, page_size=64, dtype="float32", slack=0.5),
    dict(max_len=1024, n_slots=8, page_size=64, dtype="bfloat16", slack=1.0),
    dict(max_len=7, n_slots=1, page_size=4, dtype="bfloat16", slack=2.0),
])
def test_plan_pages_matches_reference(case):
    """An explicit page size gives the reference's plan (its clamp to the
    sublane and to max_len included); the byte figures agree at qwen2-7b's
    full size without allocating anything."""
    case = dict(case)
    dt = case.pop("dtype")
    rcfg = rreg.get_config("qwen2-7b")
    want = rkv.plan_pages(rcfg, R_ONLINE, dtype=getattr(jnp, dt), **case)
    got = tkv.plan_pages(dtype=getattr(torch, dt), **case)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.hbm_bytes_per_slot(rcfg) == want.hbm_bytes_per_slot(rcfg)
    assert (got.dense_hbm_bytes_per_slot(rcfg)
            == want.dense_hbm_bytes_per_slot(rcfg))


def test_default_page_is_the_decode_kernels_page():
    """Without a page size the port takes K6's compiled page of 64 (the
    reference asks its TPU autotuner), clamped as the reference clamps and
    rounded up to the next page K6 compiles where the clamp gives another
    (the clamp alone gave 40 and 48 here, which K6 cannot run)."""
    plan = tkv.plan_pages(n_slots=8, max_len=1024)
    assert (plan.page_size, plan.max_pages, plan.n_pages) == (64, 16, 129)
    assert tkv.plan_pages(n_slots=2, max_len=40,
                          dtype=torch.float32).page_size == 64
    assert tkv.plan_pages(n_slots=2, max_len=40).page_size == 64
    assert tkv.plan_pages(n_slots=2, max_len=20).page_size == 32


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_default_page_is_always_compiled(dt):
    """Over max_len 1-1 024 the default page is one K6 compiles, and the
    plan equals the reference's (with the port's default page passed to
    it) wherever the reference's clamp already gives a compiled page."""
    rcfg = rreg.get_config("qwen2-7b")
    same = 0
    for max_len in range(1, 1025):
        got = tkv.plan_pages(n_slots=2, max_len=max_len,
                             dtype=getattr(torch, dt))
        assert got.page_size in tkv.DECODE_PAGES, (max_len, got)
        assert got.max_pages * got.page_size >= max_len
        want = rkv.plan_pages(rcfg, R_ONLINE, n_slots=2, max_len=max_len,
                              dtype=getattr(jnp, dt),
                              page_size=tkv.DEFAULT_PAGE)
        if want.page_size in tkv.DECODE_PAGES:
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
            same += 1
    # The clamp alone gave an uncompiled page for max_len 1-8, 17-24 and
    # 33-56 in f32 (40 values) and 33-48 in bf16 (16 values).
    assert same == 1024 - {"float32": 40, "bfloat16": 16}[dt]


def test_check_decode_page():
    for page in tkv.DECODE_PAGES:
        tkv.check_decode_page(page)
    for page in (8, 48, 128):
        with pytest.raises(ValueError, match="K6"):
            tkv.check_decode_page(page)


def _pools(rng, n_l, n_pages, kvh, page, dh):
    return [rng.standard_normal((n_l, n_pages, kvh, page, dh)
                                ).astype(np.float32) for _ in range(2)]


def test_pool_writes_and_gather_match_reference():
    """write_prefill (NULL-padded rows write zeros into the trash page),
    append_layer with a dead slot, append_token and gather_dense give the
    reference's arrays; the port updates its pools in place."""
    rng = np.random.default_rng(3)
    n_l, kvh, page, dh, mp, b = 2, 2, 4, 8, 3, 3
    n_pages = 1 + b * mp
    alloc = rkv.PageAllocator(n_pages, b, mp, page)
    rc = rkv.init_paged_cache(n_l, n_pages, b, mp, kvh, page, dh,
                              jnp.float32)
    tc = tkv.init_paged_cache(n_l, n_pages, b, mp, kvh, page, dh,
                              torch.float32, "cpu")
    # stale contents: pages hold a previous owner's values
    kp, vp = _pools(rng, n_l, n_pages, kvh, page, dh)
    rc["k_pages"], rc["v_pages"] = jnp.asarray(kp), jnp.asarray(vp)
    tc["k_pages"].copy_(torch.from_numpy(kp))
    tc["v_pages"].copy_(torch.from_numpy(vp))
    k_pool = tc["k_pages"]
    for length in (5, 9, 0):
        s, _ = alloc.alloc_slot(length)
        ks, vs = (rng.standard_normal((n_l, length, kvh, dh)
                                      ).astype(np.float32) for _ in range(2))
        row = alloc.page_table[s]
        rc = rkv.write_prefill(rc, s, jnp.asarray(row), jnp.asarray(ks),
                               jnp.asarray(vs), length)
        tc = tkv.write_prefill(tc, s, torch.as_tensor(row),
                               torch.from_numpy(ks), torch.from_numpy(vs),
                               length)
    alloc.free_slot(2)                        # slot 2 dead: all-NULL row
    rc["page_table"] = jnp.asarray(alloc.page_table)
    tc["page_table"] = torch.as_tensor(alloc.page_table)
    for name in ("k_pages", "v_pages", "page_table", "length"):
        np.testing.assert_array_equal(tc[name].numpy(), np.asarray(rc[name]))
    assert tc["k_pages"] is k_pool
    # one layer's append, the dead slot scattering into the trash page
    new = rng.standard_normal((b, kvh, dh)).astype(np.float32)
    pos = np.array([5, 8, 0], np.int32)
    want = rkv.append_layer(rc["k_pages"][1], jnp.asarray(new),
                            rc["page_table"], jnp.asarray(pos))
    got = tkv.append_layer(tc["k_pages"][1], torch.from_numpy(new),
                           tc["page_table"], torch.from_numpy(pos))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(got[rkv.NULL_PAGE, :, 0].numpy(), new[2])
    rc["k_pages"] = rc["k_pages"].at[1].set(want)
    # a token for every slot and layer, then the dense views
    kn, vn = (rng.standard_normal((n_l, b, kvh, dh)).astype(np.float32)
              for _ in range(2))
    rc["length"] = jnp.asarray(pos)
    tc["length"] = torch.from_numpy(pos)
    rc = rkv.append_token(rc, jnp.asarray(kn), jnp.asarray(vn))
    tc = tkv.append_token(tc, torch.from_numpy(kn), torch.from_numpy(vn))
    for name in ("k_pages", "v_pages", "length"):
        np.testing.assert_array_equal(tc[name].numpy(), np.asarray(rc[name]))
    for got_, want_ in zip(tkv.gather_dense(tc), rkv.gather_dense(rc)):
        np.testing.assert_array_equal(got_.numpy(), np.asarray(want_))


# ---------------------------------------------------------------------------
# K6's plain version against the reference kernel (interpret mode)
# ---------------------------------------------------------------------------

def _paged_kv(lengths, kvh, dh, page, mp, seed):
    """The reference test's fixture, built in both packages: each slot's
    prefill KV scattered into its pages (a length-0 slot keeps an all-NULL
    row)."""
    rng = np.random.default_rng(seed)
    b = len(lengths)
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
    return rc, tc, alloc, rng


def _check_report(got, want, q, pool):
    """Reports agree; where a row detected nothing, its max residual (the
    largest of both verifications of every step, while field 6 holds only
    the last PV tau) stays below the largest tau any of its verifications
    could have had, on both sides."""
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got[..., [0, 1, 2, 3, 7]],
                                  want[..., [0, 1, 2, 3, 7]])
    np.testing.assert_allclose(got[..., [4, 6]], want[..., [4, 6]],
                               rtol=1e-5, atol=0)
    det = want[..., 0] > 0
    np.testing.assert_allclose(got[..., 5][det], want[..., 5][det], rtol=1e-5)
    dh, page = q.shape[-1], pool.shape[-2]
    eps = float(np.finfo(np.float32).eps)
    bound = 64.0 * eps * max(dh * np.abs(q).max() * np.abs(pool).max(),
                             page * np.abs(pool).max())
    assert np.all(got[..., 5][~det] <= bound)
    assert np.all(want[..., 5][~det] <= bound)


def _both(q, rc, tc, alloc, rft, tft, **inj):
    rspec, tspec = inj.pop("spec", (None, None))
    ro, rr = rops.flash_ft_decode(
        jnp.asarray(q), rc["k_pages"][0], rc["v_pages"][0],
        jnp.asarray(alloc.lengths), jnp.asarray(alloc.page_table), ft=rft,
        spec=rspec, interpret=True, **inj)
    to, tr = tops.flash_ft_decode(
        torch.from_numpy(q), tc["k_pages"][0], tc["v_pages"][0],
        torch.as_tensor(alloc.lengths), torch.as_tensor(alloc.page_table),
        ft=tft, spec=tspec, **inj)
    return np.asarray(ro), rr, to.numpy(), tr


@pytest.mark.parametrize("kvh,nrep", [(2, 2), (1, 4), (4, 1)])
@pytest.mark.parametrize("lengths", [[17, 64, 0], [16, 1, 33]])
def test_paged_decode_plain_matches_reference(kvh, nrep, lengths):
    """Ragged lengths (a dead slot, one token, a page edge, full capacity)
    across GQA group sizes: outputs and reports as the reference kernel's;
    dead slots give exact zeros and a zero report row."""
    dh, page, mp = 128, 16, 4
    rc, tc, alloc, rng = _paged_kv(lengths, kvh, dh, page, mp,
                                   seed=kvh * 10 + nrep)
    q = rng.standard_normal((len(lengths), kvh * nrep, dh)).astype(np.float32)
    ro, rr, to, tr = _both(q, rc, tc, alloc, RFT(**CORRECT), TFT(**CORRECT))
    np.testing.assert_allclose(to, ro, atol=2e-5, rtol=2e-5)
    _check_report(tr, rr, q, np.asarray(rc["k_pages"]))
    assert float(tr[..., 0].sum()) == 0.0
    for slot, length in enumerate(lengths):
        if length == 0:
            assert not to[slot].any()
            assert not tr[slot * kvh:(slot + 1) * kvh].any()


def _exact_paged_kv(lengths, kvh, dh, page, seed=0):
    """The reference test's exactly representable operands: one-hot 64·e_t
    queries and keys (matched score 256, softmax weights in {1, 1/2}
    exactly at dh 256), small-integer V: the output is exact in f32."""
    rng = np.random.default_rng(seed)
    b = len(lengths)
    mp = 512 // page
    n_pages = 1 + b * mp
    rc = rkv.init_paged_cache(1, n_pages, b, mp, kvh, page, dh, jnp.float32)
    tc = tkv.init_paged_cache(1, n_pages, b, mp, kvh, page, dh,
                              torch.float32, "cpu")
    alloc = rkv.PageAllocator(n_pages, b, mp, page)
    for length in lengths:
        s, _ = alloc.alloc_slot(length)
        karr = 64.0 * np.eye(dh, dtype=np.float32)[np.arange(length) % dh]
        ks = np.broadcast_to(karr[None, :, None], (1, length, kvh, dh)).copy()
        vs = rng.integers(-2, 3, (1, length, kvh, dh)).astype(np.float32)
        row = alloc.page_table[s]
        rc = rkv.write_prefill(rc, s, jnp.asarray(row), jnp.asarray(ks),
                               jnp.asarray(vs), length)
        tkv.write_prefill(tc, s, torch.as_tensor(row), torch.from_numpy(ks),
                          torch.from_numpy(vs), length)
    tq = rng.integers(0, dh, (b, kvh * 2))
    q = 64.0 * np.eye(dh, dtype=np.float32)[tq]
    return q, rc, tc, alloc


@pytest.mark.parametrize("step", [1, 19])
def test_paged_decode_seu_corrected_bit_for_bit(step):
    """A deterministic SEU in Δ of (slot 1, kv head 0) at a middle and at
    the last live kv step: corrected bit for bit, located at its row and
    column, as in the reference; detect-only (the same SEU) leaves it."""
    kvh, dh, page = 2, 256, 16
    q, rc, tc, alloc = _exact_paged_kv([272, 320], kvh, dh, page)
    g = 1 * kvh + 0
    spec = dict(row=1, col=7, k_step=step, magnitude=777.0)
    clean_r, _, clean_t, rep0 = _both(q, rc, tc, alloc, RFT(**CORRECT),
                                      TFT(**CORRECT))
    assert float(rep0[..., 0].sum()) == 0.0
    ro, rr, to, tr = _both(q, rc, tc, alloc, RFT(**CORRECT), TFT(**CORRECT),
                           spec=(RSpec(**spec), TSpec(**spec)), inj_g=g)
    np.testing.assert_array_equal(to, clean_t)
    np.testing.assert_array_equal(ro, clean_r)
    pool = np.asarray(rc["k_pages"])
    _check_report(tr, rr, q, pool)
    cell = tr[g, 0]
    assert (float(cell[0]), float(cell[1]), int(cell[2]), int(cell[3])) == \
        (1.0, 1.0, 1, 7)
    assert abs(float(cell[4]) - 777.0) < 1.0
    assert float(tr[..., 0].sum()) == 1.0
    do_r, dr_, do_t, dtr = _both(q, rc, tc, alloc, RFT(**DETECT),
                                 TFT(**DETECT),
                                 spec=(RSpec(**spec), TSpec(**spec)),
                                 inj_g=g)
    _check_report(dtr, dr_, q, pool)
    assert float(dtr[g, 0, 0]) >= 1.0 and float(dtr[g, 0, 1]) == 0.0
    np.testing.assert_allclose(do_t, do_r, atol=1e-5, rtol=1e-5)
    if step == 19:      # the last step: no later rescale shrinks the SEU
        assert np.abs(do_t - clean_t).max() > 1.0


def test_paged_decode_seu_past_the_live_pages_never_lands():
    """A kv step inside the table but past a slot's live pages never runs:
    no detection and the clean output, in both packages, and no error."""
    kvh, dh, page = 2, 256, 16
    q, rc, tc, alloc = _exact_paged_kv([40, 320], kvh, dh, page)
    spec = dict(row=0, col=3, k_step=5, magnitude=50.0)
    clean_r, _, clean_t, _ = _both(q, rc, tc, alloc, RFT(**CORRECT),
                                   TFT(**CORRECT))
    ro, rr, to, tr = _both(q, rc, tc, alloc, RFT(**CORRECT), TFT(**CORRECT),
                           spec=(RSpec(**spec), TSpec(**spec)), inj_g=1)
    assert float(np.asarray(rr)[..., 0].sum()) == 0.0
    assert float(tr[..., 0].sum()) == 0.0
    np.testing.assert_array_equal(to, clean_t)


def test_flash_ft_decode_rejects_what_the_reference_rejects():
    q = torch.zeros(1, 2, 64)
    pool = torch.zeros(2, 1, 16, 64)
    lengths, table = torch.zeros(1, dtype=torch.int32), \
        torch.zeros(1, 1, dtype=torch.int32)
    with pytest.raises(ValueError, match="128"):
        tops.flash_ft_decode(q, pool, pool, lengths, table)
    q = torch.zeros(2, 4, 128)
    pool = torch.zeros(3, 2, 16, 128)
    lengths, table = torch.zeros(2, dtype=torch.int32), \
        torch.zeros(2, 2, dtype=torch.int32)
    for g, step in ((4, 0), (0, 2), (-1, 0)):
        with pytest.raises(ValueError, match="never land"):
            tops.flash_ft_decode(q, pool, pool, lengths, table,
                                 spec=TSpec(0, 0, 1.0, step), inj_g=g)
