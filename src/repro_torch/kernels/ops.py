"""Public fronts of the kernels (counterpart of `repro.kernels.ops`).

`gemm_call` is the front door of the GEMM kernel: it resolves a
`templates.KernelSpec` (FT level × epilogue chain) against the problem,
encodes the deterministic injection and calls `kernels.ft_gemm.ft_gemm` —
the CUDA kernel on a CUDA tensor, its plain version on a CPU tensor. The
kernel reads A and B through their strides, so a transposed `lm_head` view
or a permuted KV cache is not copied. `matmul`, `fused_matmul`, `ft_matmul`
and `ft_matmul_report` specialise it; `grouped_gemm_call` is the batched
and grouped front (uniform batched, grouped and grouped transpose);
`flash_ft` and `flash_ft_bwd` are the flash-attention fronts, forward
(with the saved softmax statistics) and backward;
`flash_ft_decode` is the paged decode front of the serving engine.

Tiles: the reference autotunes its TPU tiles; here each kernel has its own
compiled tile configurations (`ft_gemm.TILES`, `flashft.BLOCK`), chosen
from the shape unless the caller pins them (the CPU tests pin the
reference's tiles so per-block reports compare like with like). The FT
level of the GEMM fronts is ``ft.level`` ("block", "tile" or "inner"), with
the "tile" level's band of rows taken from the tiles (`ft_gemm.band_of`).

A stochastic injection campaign (``ft.inject_rate > 0`` with a key, a
`torch.Generator`): every front encodes the key into the kernels' triple
(`flashft.encode_rng`) and every block of the launch draws its own SEU in
kernel (`templates/seu.py`), the GEMM fronts' and the flash fronts' alike
(`core.fault_injection.check_campaign` raises only for a flash build
without the hook), so a campaign never runs clean in silence.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from ..core.fault_injection import check_campaign
from ..core.policy import FTConfig, FT_OFF, InjectionSpec, ONLINE_BLOCK
from . import flashft as kflash
from . import ft_gemm as kgemm
from .templates import BatchedKernelSpec, KernelSpec
from .templates import spec as spec_mod

Tiles = Optional[Sequence[int]]


def encode_injection(spec: Optional[InjectionSpec]
                     ) -> Tuple[Tuple[int, int, int, int], float]:
    """InjectionSpec → the 2-D kernel's ([enable, row, col, k_step], mag)."""
    if spec is None:
        return (0, 0, 0, 0), 0.0
    return (1, spec.row, spec.col, spec.k_step), float(spec.magnitude)


def encode_batched_injection(spec: Optional[InjectionSpec], batch: int = 0
                             ) -> Tuple[Tuple[int, ...], float]:
    """InjectionSpec → the batched kernel's ([enable, batch, row, col,
    k_step], mag); ``batch < 0`` lands the SEU in every slice."""
    if spec is None:
        return (0, 0, 0, 0, 0), 0.0
    return ((1, batch, spec.row, spec.col, spec.k_step),
            float(spec.magnitude))


def encode_flash_injection(spec: Optional[InjectionSpec], bh: int = 0,
                           q_block: int = 0
                           ) -> Tuple[Tuple[int, ...], float]:
    """InjectionSpec → the flash kernel's ([enable, bh, q_block, kv_step,
    row, col], mag)."""
    if spec is None:
        return (0, 0, 0, 0, 0, 0), 0.0
    return ((1, bh, q_block, spec.k_step, spec.row, spec.col),
            float(spec.magnitude))


def _resolve(spec: KernelSpec, ft: Optional[FTConfig]) -> FTConfig:
    if ft is None:
        ft = FTConfig(level=spec.ft_level) if spec.ft else FT_OFF
    if spec.ft != ft.enabled or (spec.ft and ft.level != spec.ft_level):
        raise ValueError(f"FTConfig(level={ft.level!r}, action={ft.action!r})"
                         f" disagrees with spec.ft_level={spec.ft_level!r}")
    return ft


def _check_out_dtype(a: torch.Tensor, out_dtype) -> None:
    if out_dtype is not None and out_dtype != a.dtype:
        raise NotImplementedError("the GEMM kernel writes C in the operand "
                                  "dtype")


def gemm_call(spec: KernelSpec, a: torch.Tensor, b: torch.Tensor, *,
              bias: Optional[torch.Tensor] = None,
              residual: Optional[torch.Tensor] = None,
              ft: Optional[FTConfig] = None,
              inject: Optional[InjectionSpec] = None,
              tiles: Tiles = None, out_dtype=None, key=None
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Run the GEMM kernel variant ``spec`` on (M, K) × (K, N). Returns
    (C, report) — report (gm, gn, 8) = [detected, corrected, row, col,
    magnitude, max_residual, tau, k_elapsed] per block, None with FT off."""
    ft = _resolve(spec, ft)
    rng = kflash.encode_rng(key, ft) if spec.ft else None
    _check_out_dtype(a, out_dtype)
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"gemm_call: bad shapes {tuple(a.shape)} x "
                         f"{tuple(b.shape)}")
    if bias is not None:
        bias = bias.reshape(-1).contiguous()
    if residual is not None:
        residual = residual.contiguous()
    (en, row, col, k_step), mag = encode_injection(inject)
    # The 2-D kernel is the batched one with batch 1: batch -1 = every slice.
    return kgemm.ft_gemm(a, b, chain=spec.epilogue,
                         bias=bias, residual=residual,
                         ft=ft if spec.ft else None,
                         inj=(en, -1, row, col, k_step), inj_mag=mag,
                         tiles=tiles,
                         save_act_grad="act_grad" in spec.extra_outputs,
                         rng=rng)


def matmul(a: torch.Tensor, b: torch.Tensor, *, tiles: Tiles = None,
           out_dtype=None) -> torch.Tensor:
    """Non-FT GEMM through the kernel: C = A @ B."""
    out, _ = gemm_call(KernelSpec(), a, b, tiles=tiles, out_dtype=out_dtype)
    return out


def fused_matmul(a: torch.Tensor, b: torch.Tensor, *,
                 bias: Optional[torch.Tensor] = None,
                 act: Optional[str] = None,
                 residual: Optional[torch.Tensor] = None,
                 ft: FTConfig = FT_OFF,
                 inject: Optional[InjectionSpec] = None,
                 tiles: Tiles = None, out_dtype=None, key=None,
                 save_act_grad: bool = False
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """C = act(A·B + bias) + residual in one kernel; with an enabled ``ft``
    at the block level the linear prefix is folded into the checksum
    comparison, so ABFT verifies and corrects post-epilogue ("tile" and
    "inner" verify the raw accumulator and apply the whole chain after).
    Returns (C, report|None).

    ``save_act_grad`` (needs ``act``) also writes act'(A·B + bias), taken
    from the verified, corrected accumulator, and returns
    ((C, act_grad), report|None): the residual the backward of
    `core.ft_dot_fused` consumes instead of recomputing the GEMM."""
    spec = spec_mod.fused(bias=bias is not None, act=act,
                          residual=residual is not None,
                          ft_level=ft.level if ft.enabled else "off")
    if save_act_grad:
        spec = dataclasses.replace(spec, extra_outputs=("act_grad",))
    return gemm_call(spec, a, b, bias=bias, residual=residual, ft=ft,
                     inject=inject, tiles=tiles, out_dtype=out_dtype,
                     key=key)


def grouped_gemm_call(spec: KernelSpec, a: torch.Tensor, b: torch.Tensor, *,
                      group_ids: Optional[torch.Tensor] = None,
                      n_groups: Optional[int] = None,
                      ft: Optional[FTConfig] = None,
                      inject: Optional[InjectionSpec] = None,
                      inj_batch: int = 0, tiles: Tiles = None,
                      out_dtype=None, key=None
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The batched and grouped front door, dispatching on operand ranks:

      * a (B, M, K) × b (B, K, N) or shared (K, N) → (B, M, N): the uniform
        batched GEMM (K5) in one launch, report (B, gm, gn, 8). A second
        leading batch dim, a (B0, B1, M, K), is taken as it is, so strided
        views (the KV cache of decode attention) reach the kernel without a
        copy; every FT level;
      * a (T, K), b (G, K, N) with ``group_ids`` (T,): the ragged grouped
        GEMM (K7), y[t] = a[t] @ b[group_ids[t]] over a group-sorted
        buffer, detection and correction per group;
      * a (T, K), b (T, N) with ``group_ids`` and ``n_groups``: the grouped
        transpose GEMM (K8), dw[g] = Σ_{t: group_ids[t]=g} a[t] ⊗ b[t],
        (G, K, N) f32 — the MoE backward dw.

    K5 and K7 apply ``spec.epilogue``, an aux-free chain (silu, gelu and
    relu in any order, at most `ft_gemm.CHAIN_CAP` ops), after the final
    verification (after the last step's at "inner"); K8 drops it, as the
    reference's front does (it produces a gradient). All three run every
    FT level; the "tile" level's band is `templates.spec.band_of` of their
    tiles (K5's and K7's rows, K8's dw rows).

    Returns (C, report|None)."""
    if a.dim() == 2:
        from . import grouped as kgrouped
        if group_ids is None:
            raise ValueError("grouped_gemm_call: a rank-2 a needs group_ids")
        gspec = BatchedKernelSpec(ft_level=spec.ft_level,
                                  epilogue=spec.epilogue)
        if b.dim() == 2:
            if n_groups is None:
                raise ValueError("grouped_gemm_call: the tgmm branch needs "
                                 "n_groups")
            return kgrouped.tgmm_matmul_rows(
                dataclasses.replace(gspec, epilogue=(), tgmm=True), a, b,
                group_ids,
                n_groups=n_groups, ft=ft, inject=inject, tiles=tiles,
                out_dtype=out_dtype, key=key)
        return kgrouped.grouped_matmul_rows(
            dataclasses.replace(gspec, grouped=True), a, b, group_ids, ft=ft,
            inject=inject, tiles=tiles, out_dtype=out_dtype, key=key)
    if a.dim() not in (3, 4) or group_ids is not None:
        raise ValueError(f"grouped_gemm_call: a {tuple(a.shape)} with "
                         f"group_ids={group_ids is not None}")
    bspec = BatchedKernelSpec(ft_level=spec.ft_level, epilogue=spec.epilogue)
    ft = _resolve(bspec, ft)
    rng = kflash.encode_rng(key, ft) if bspec.ft else None
    _check_out_dtype(a, out_dtype)
    if b.dim() not in (2, a.dim()) or b.shape[-2] != a.shape[-1] or (
            b.dim() > 2 and b.shape[:-2] != a.shape[:-2]):
        raise ValueError(f"grouped_gemm_call: bad shapes {tuple(a.shape)} x "
                         f"{tuple(b.shape)}")
    inj, mag = encode_batched_injection(inject, inj_batch)
    return kgemm.ft_gemm(a, b, chain=bspec.epilogue,
                         ft=ft if bspec.ft else None, inj=inj, inj_mag=mag,
                         tiles=tiles, rng=rng)


def ft_matmul(a: torch.Tensor, b: torch.Tensor, *,
              ft: FTConfig = ONLINE_BLOCK,
              spec: Optional[InjectionSpec] = None,
              tiles: Tiles = None, out_dtype=None, key=None) -> torch.Tensor:
    """Fused fault-tolerant GEMM at ``ft.level``. Returns the corrected C."""
    out, _ = ft_matmul_report(a, b, ft=ft, spec=spec, tiles=tiles,
                              out_dtype=out_dtype, key=key)
    return out


def ft_matmul_report(a: torch.Tensor, b: torch.Tensor, *,
                     ft: FTConfig = ONLINE_BLOCK,
                     spec: Optional[InjectionSpec] = None,
                     tiles: Tiles = None, out_dtype=None, key=None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """FT GEMM at ``ft.level`` returning (C, report (gm, gn, 8)): per block
    [detected, corrected, row, col, magnitude, max_residual, tau,
    k_elapsed], summed over the bands and steps of "tile" and "inner"
    (`ft_gemm.locate_bands`)."""
    return gemm_call(KernelSpec(ft_level=ft.level), a, b, ft=ft,
                     inject=spec, tiles=tiles, out_dtype=out_dtype, key=key)


def _check_flash_injection(spec: InjectionSpec, head: int, blk: int, *,
                           bh: int, sq: int, skv: int, bq: int, bkv: int,
                           causal: bool, kv_stationary: bool = False,
                           kernel: str = "flash_ft") -> None:
    """A deterministic flash injection addresses one grid cell: (q block
    ``blk``, kv step ``spec.k_step``), or with ``kv_stationary`` (the dK/dV
    kernel) (kv block ``blk``, q step ``spec.k_step``). A cell the grid
    never executes (out of range, past the true lengths, or skipped by the
    causal mask) would let the SEU silently never land, so raise."""
    qb, kvb = (spec.k_step, blk) if kv_stationary else (blk, spec.k_step)
    q0, q1, kv0 = qb * bq, (qb + 1) * bq, kvb * bkv
    ok = (0 <= head < bh and 0 <= qb < -(-sq // bq)
          and 0 <= kvb < -(-skv // bkv) and q0 < sq and kv0 < skv
          and (not causal or kv0 <= q1 - 1 + (skv - sq)))
    if not ok:
        raise ValueError(
            f"{kernel}: deterministic injection targets head {head}, block "
            f"{blk}, step {spec.k_step} — a cell the ({bq}, {bkv}) grid over "
            f"(Sq={sq}, Skv={skv}) never executes; the SEU would silently "
            f"never land")


def _pad_dh(dh: int) -> int:
    """The head dim the flash kernels are handed for a true ``dh``: the
    smallest compiled one at or above it (`flashft.HEAD_DIMS`), or ``dh``
    itself above them (the kernel wrappers raise there)."""
    return next((d for d in kflash.HEAD_DIMS if d >= dh), dh)


def _zero_pad(x: torch.Tensor, to: int) -> torch.Tensor:
    """x (…, dh) zero-padded along dh to ``to``, contiguous."""
    if x.shape[-1] == to:
        return x.contiguous()
    return torch.nn.functional.pad(x, (0, to - x.shape[-1])).contiguous()


def flash_ft(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
             ft: FTConfig = ONLINE_BLOCK, causal: bool = True,
             spec: Optional[InjectionSpec] = None,
             inj_bh: int = 0, inj_q_block: int = 0,
             bq: Optional[int] = None, bkv: Optional[int] = None,
             n_rep: int = 1, key=None, save_stats: bool = False):
    """Flash attention with in-kernel ABFT. q: (BH, Sq, dh); k, v:
    (BH / n_rep, Skv, dh) — query head h reads kv head h // n_rep, KV is
    never repeated. Causal masking is bottom-right aligned on the true
    lengths (needs Skv ≥ Sq). The score scale uses the true dh; the QK
    threshold uses dh rounded up to 128, as the reference's lane-padded
    kernel does. As the reference's front, q, k and v are zero-padded along
    dh, here to the smallest compiled head dim at or above it (64 or 128),
    and the output sliced back: zero columns add nothing to any product or
    checksum, so a located column is always below dh. ``key`` arms the
    stochastic hook when ``ft.inject_rate > 0``: one Bernoulli(rate) SEU
    per (head, q block) lands in Δ = PV at a hash-drawn (live step, row,
    col); dh is then padded to round_up(dh, 128), the reference's width, so
    that every column the hook draws exists. Returns (out,
    report (BH, ceil(Sq / bq), 8)), or with ``save_stats`` (out, m, l,
    report): the per-row softmax statistics (BH, Sq) f32 the backward
    consumes, degenerate rows (NEG_INF, 0)."""
    check_campaign(ft, key)
    bh, sq, dh = q.shape
    skv = k.shape[1]
    if bh != k.shape[0] * n_rep:
        raise ValueError(f"flash_ft: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} disagree with n_rep={n_rep}")
    if causal and skv < sq:
        raise ValueError(f"causal flash_ft is bottom-right aligned: needs "
                         f"Skv >= Sq (got Sq={sq}, Skv={skv})")
    if spec is not None:
        _check_flash_injection(spec, inj_bh, inj_q_block, bh=bh, sq=sq,
                               skv=skv, bq=bq or kflash.BLOCK,
                               bkv=bkv or kflash.BLOCK, causal=causal)
    inj, mag = encode_flash_injection(spec, inj_bh, inj_q_block)
    rng = kflash.encode_rng(key, ft)
    tau_dh = -(-dh // 128) * 128
    dp = tau_dh if kgemm.seu_armed(rng, ft) else _pad_dh(dh)
    res = kflash.flash_ft_fwd(
        _zero_pad(q, dp), _zero_pad(k, dp), _zero_pad(v, dp), ft=ft,
        scale=dh ** -0.5, tau_dh=tau_dh, n_rep=n_rep,
        causal=causal, inj=inj, inj_mag=mag, bq=bq, bkv=bkv,
        save_stats=save_stats, rng=rng)
    if dp == dh:
        return res
    return (res[0][..., :dh].contiguous(),) + tuple(res[1:])


def flash_ft_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 o: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                 g: torch.Tensor, *, ft: FTConfig = ONLINE_BLOCK,
                 causal: bool = True, n_rep: int = 1, key=None,
                 inject: Optional[InjectionSpec] = None,
                 inj_target: str = "dq", inj_bh: int = 0, inj_blk: int = 0,
                 bq: Optional[int] = None, bkv: Optional[int] = None):
    """The flash backward: dQ (K3) and dK/dV (K4), two launches over the
    saved (m, l) of ``flash_ft(..., save_stats=True)``. q, o, g (BH, Sq,
    dh); k, v (BH / n_rep, Skv, dh); m, l (BH, Sq) f32. di = rowsum(g ∘ o)
    is the one elementwise preprocess. Every backward GEMM (dP, dV, dQ, dK)
    and the S recompute are verified and corrected in-kernel; dk and dv
    come back per kv head. q, k, v and g are zero-padded along dh as
    `flash_ft` pads them (di comes from the unpadded g and o), and dq, dk,
    dv sliced back. ``inject`` / ``inj_target`` land a deterministic
    SEU in one named backward GEMM ("dp_q" | "dq" | "dp_kv" | "dv" | "dk",
    see `flashft.encode_bwd_injection`); ``key`` arms the stochastic hook
    as in `flash_ft` (K3 in the dQ delta, K4 in the dV delta, each on its
    own salt; dh padded to round_up(dh, 128)). Returns
    (dq, dk, dv, report_dq (BH, nqb, 8), report_dkv (BH / n_rep, nkvb, 8))."""
    check_campaign(ft, key)
    bh, sq, dh = q.shape
    skv = k.shape[1]
    if bh != k.shape[0] * n_rep:
        raise ValueError(f"flash_ft_bwd: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} disagree with n_rep={n_rep}")
    if tuple(o.shape) != tuple(q.shape) or tuple(g.shape) != tuple(q.shape):
        raise ValueError(f"flash_ft_bwd: o {tuple(o.shape)} and g "
                         f"{tuple(g.shape)} must have q's shape")
    if tuple(m.shape) != (bh, sq) or tuple(l.shape) != (bh, sq):
        raise ValueError(f"flash_ft_bwd: m {tuple(m.shape)}, l "
                         f"{tuple(l.shape)}, expected {(bh, sq)}")
    if causal and skv < sq:
        raise ValueError(f"causal flash_ft_bwd is bottom-right aligned: "
                         f"needs Skv >= Sq (got Sq={sq}, Skv={skv})")
    bq_, bkv_ = bq or kflash.BLOCK, bkv or kflash.BLOCK
    if inject is not None:
        if inj_target not in kflash.BWD_TARGETS:
            raise ValueError(f"unknown backward injection target "
                             f"{inj_target!r}; one of "
                             f"{tuple(kflash.BWD_TARGETS)}")
        _check_flash_injection(
            inject, inj_bh, inj_blk, bh=bh, sq=sq, skv=skv, bq=bq_, bkv=bkv_,
            causal=causal, kv_stationary=inj_target in kflash.DKV_TARGETS,
            kernel=f"flash_ft_bwd[{inj_target}]")
    inj_dq, inj_dkv, mag = kflash.encode_bwd_injection(inject, inj_target,
                                                       inj_bh, inj_blk)
    di = (g.float() * o.float()).sum(-1)
    rng = kflash.encode_rng(key, ft)
    tau_dh = -(-dh // 128) * 128
    dp = tau_dh if kgemm.seu_armed(rng, ft) else _pad_dh(dh)
    q, k, v, g = (_zero_pad(x, dp) for x in (q, k, v, g))
    m, l = m.float().contiguous(), l.float().contiguous()
    kw = dict(ft=ft, scale=dh ** -0.5, tau_dh=tau_dh, n_rep=n_rep,
              causal=causal, inj_mag=mag, bq=bq, bkv=bkv, rng=rng)
    dq, rep_dq = kflash.flash_ft_dq(q, k, v, g, m, l, di, inj=inj_dq, **kw)
    dk, dv, rep_dkv = kflash.flash_ft_dkv(q, k, v, g, m, l, di, inj=inj_dkv,
                                          **kw)
    if dp != dh:
        dq, dk, dv = (x[..., :dh].contiguous() for x in (dq, dk, dv))
    return dq, dk, dv, rep_dq, rep_dkv


def flash_ft_decode(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, lengths: torch.Tensor,
                    page_table: torch.Tensor, *,
                    ft: FTConfig = ONLINE_BLOCK,
                    spec: Optional[InjectionSpec] = None, inj_g: int = 0,
                    key=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Paged single-position flash decode with per-slot ragged lengths, the
    serving engine's attention (kernel K6).

    q (B, H, dh): one query position per serving slot; k_pages, v_pages
    (n_pages, KVH, page, dh): ONE layer of the shared page pool
    (`train.kv_cache`); lengths int (B,): each slot's true kv length (0 = a
    dead slot, which returns exact zeros); page_table int (B, max_pages):
    the slot's pool pages, NULL-padded. dh must be a multiple of 128. The
    n_rep = H // KVH query rows of each kv head are zero-padded to the
    dtype's sublane multiple (8 rows in f32, 16 in bf16), as in the
    reference, and sliced off again. ``spec`` / ``inj_g`` land a
    deterministic SEU in Δ = PV of grid row ``inj_g`` (= slot·KVH + head) at
    kv step ``spec.k_step``; it lands only if that step runs. ``key`` arms
    the stochastic hook: one Bernoulli(rate) SEU per (slot, kv head) row
    in Δ of one of its live pages. Returns (out (B, H, dh), report (B·KVH,
    1, 8))."""
    check_campaign(ft, key)
    b, h, dh = q.shape
    n_pages, kvh, page, dh_k = k_pages.shape
    if tuple(v_pages.shape) != tuple(k_pages.shape) or dh_k != dh or \
            h % kvh != 0:
        raise ValueError(f"flash_ft_decode: q {tuple(q.shape)} and pools "
                         f"{tuple(k_pages.shape)}, {tuple(v_pages.shape)} "
                         f"disagree")
    if dh % 128 != 0:
        raise ValueError(f"flash_ft_decode needs a head dim that is a "
                         f"multiple of 128, got {dh}; the dense "
                         f"decode_attention path takes the others")
    if page_table.dim() != 2 or page_table.shape[0] != b or \
            tuple(lengths.shape) != (b,):
        raise ValueError(f"flash_ft_decode: page table "
                         f"{tuple(page_table.shape)} and lengths "
                         f"{tuple(lengths.shape)} for {b} slots")
    max_pages = page_table.shape[1]
    if spec is not None and not (0 <= inj_g < b * kvh
                                 and 0 <= spec.k_step < max_pages):
        raise ValueError(
            f"flash_ft_decode: deterministic injection targets grid row "
            f"{inj_g} of {b * kvh}, kv step {spec.k_step} of {max_pages} — "
            f"outside the decode grid, the SEU would silently never land")
    inj, mag = encode_flash_injection(spec, inj_g, 0)
    n_rep = h // kvh
    sub = kflash.sublane(q.dtype)
    bq = -(-n_rep // sub) * sub
    qg = torch.nn.functional.pad(q.reshape(b * kvh, n_rep, dh),
                                 (0, 0, 0, bq - n_rep))
    out, rep = kflash.flash_ft_decode(
        qg, k_pages, v_pages, lengths.to(torch.int32).contiguous(),
        page_table.to(torch.int32).contiguous(), ft=ft, scale=dh ** -0.5,
        tau_dh=dh, inj=inj, inj_mag=mag, rng=kflash.encode_rng(key, ft))
    return out[:, :n_rep].reshape(b, h, dh), rep
