"""`ft_dot` / `ft_dot_fused` / `ft_batched_dot` / `ft_grouped_matmul` — the
fault-tolerant GEMM fronts every projection of the model routes through
(counterpart of `repro.core.ft_gemm`).

Paths, selected by the resolved `FTConfig`:

  * FT off with no injection — the plain-matmul fast path;
  * ``backend="pallas"`` — the hand-written CUDA kernels through
    `kernels.ops` (the ABFT GEMM, 2-D or batched); on a CPU tensor their
    plain versions;
  * ``backend="xla"`` — the torch-op ABFT path mirroring
    `repro.core.ft_gemm._fused_ft_matmul_2d`: checksums from the operands,
    `core.abft` verify / locate / correct (``fused=False``: the non-fused
    baseline with materialised augmented operands).

A campaign key (a `torch.Generator`, with ``ft.inject_rate > 0``) injects
stochastic SEUs: in kernel on the pallas backend (every block draws its
own, `kernels/templates/seu.py`), per matmul on the torch-op path
(`fault_injection.Injector`). The backward GEMMs take keys derived from the
forward's (`fault_injection.fold_in`, the reference's tags: dx 1, dw 2,
batched da 3, db 4, grouped dbuf 6, dw 7), so a campaign reaches them too.

Each protected call records its (detections, max residual) summary into the
ambient `telemetry.ft_scope` under its ``site`` label, once per forward
call, outside the autograd Function (as the reference records outside its
custom_vjp): backward corrections are applied but not counted.

Differentiation: each front is a `torch.autograd.Function` whose backward
GEMMs are protected with the same policy — dx = g·Wᵀ and dw = Xᵀ·g, through
the same backends, with the transposed operands passed as views (the CUDA
kernel reads them through their strides). ``bwd_inject`` = ("dx" | "dw",
InjectionSpec) lands a deterministic SEU in the named backward GEMM.

The grouped front (`ft_grouped_matmul`, `ft_grouped_matmul_buffer`) runs
the MoE expert GEMMs over a group-sorted buffer (`kernels.grouped`): the
grouped kernel K7 on the pallas backend, per-group segment checksums on the
torch-op path. Its backward runs dbuf through the same grouped product
against wᵀ (a view) and dw through the grouped transpose kernel K8 (the
segment path elsewhere); ``bwd_inject`` = ("dbuf" | "dw", InjectionSpec).
`ft_dot_fused` saves act'(pre-activation) from its forward kernel (the
act_grad output) instead of recomputing the pre-activation GEMM, and its
bias gradient is the f32 column sum of dpre. When no gradient is needed
(serving, `torch.inference_mode`) the forward runs without the Function.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import abft, telemetry
from .fault_injection import fold_in, inject
from .policy import FTConfig, FTLike, FT_OFF, InjectionSpec, resolve_ft


def _matmul_f32acc(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a.float(), b.float())


def _tau(ft: FTConfig, a, b) -> torch.Tensor:
    if ft.static_tau is not None:
        return torch.full(a.shape[:-2], ft.static_tau, dtype=torch.float32,
                          device=a.device)
    return abft.threshold(a, b, ft.rel_tau)


def _fused_ft_matmul(ft: FTConfig, spec, a, b, key=None):
    """Fused online ABFT: checksums from the operands, verify, correct."""
    acc = _matmul_f32acc(a, b)
    ck = abft.product_checksums(a, b)
    acc = inject(ft, spec, key, acc)
    out, v = abft.detect_and_correct(acc, ck, _tau(ft, a, b),
                                     corrects=ft.corrects)
    return out.to(a.dtype), v


def _nonfused_ft_matmul_2d(ft: FTConfig, spec, a, b, key=None):
    """Ding-2011-style non-fused ABFT: materialised augmented operands and
    a separate verification pass."""
    m, n = a.shape[0], b.shape[1]
    a_aug = torch.cat([a.float(), abft.encode_col(a)], dim=0)   # (M+1, K)
    b_aug = torch.cat([b.float(), abft.encode_row(b)], dim=1)   # (K, N+1)
    c_f = torch.matmul(a_aug, b_aug)                            # (M+1, N+1)
    acc = inject(ft, spec, key, c_f[:m, :n])
    ck = abft.Checksums(col=c_f[m:m + 1, :n], row=c_f[:m, n:n + 1])
    out, v = abft.detect_and_correct(acc, ck, _tau(ft, a, b),
                                     corrects=ft.corrects)
    return out.to(a.dtype), v


def ft_verdict_dot(a: torch.Tensor, b: torch.Tensor, ft: FTLike,
                   spec: Optional[InjectionSpec] = None, key=None,
                   site: Optional[str] = None
                   ) -> Tuple[torch.Tensor, abft.Verdict]:
    """2-D FT matmul that also returns the `abft.Verdict`, on the torch-op
    path (fused, or the non-fused baseline with ``ft.fused`` False): the
    reference's `ft_verdict_dot`, used by the offline-ABFT recompute loop
    and by tests of detection. A leading batch of a is flattened."""
    ft = resolve_ft(ft, site)
    a2 = a.reshape(-1, a.shape[-1]) if a.dim() != 2 else a
    fn = _fused_ft_matmul if ft.fused else _nonfused_ft_matmul_2d
    return fn(ft, spec, a2, b, key)


def _bwd_injection(bwd_inject, target: str) -> Optional[InjectionSpec]:
    """The SEU of ``bwd_inject`` = ("dx" | "dw", InjectionSpec) if it
    targets the backward GEMM ``target``."""
    if bwd_inject is not None and bwd_inject[0] == target:
        return bwd_inject[1]
    return None


def _check_bwd_inject(ft: FTConfig, bwd_inject) -> None:
    """A backward injection lives inside the FT machinery; with FT off it
    would silently never land, so raise."""
    if bwd_inject is not None and not ft.enabled:
        raise ValueError(
            "bwd_inject requires an enabled FTConfig: the SEU is emulated "
            "inside the protected backward GEMM, which FT_OFF never runs")


def _wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def _summary(v: abft.Verdict) -> Tuple[torch.Tensor, torch.Tensor]:
    return (v.detected.sum().to(torch.int32),
            torch.abs(v.magnitude).max().float())


def _report_summary(rep: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return rep[..., 0].sum().to(torch.int32), rep[..., 5].max()


def _ft_matmul_2d(ft: FTConfig, spec, a, b, key):
    """(out, det_count, max_residual) of one protected (M, K) × (K, N)."""
    if not ft.enabled:
        zero = torch.zeros((), device=a.device)
        return _matmul_f32acc(a, b).to(a.dtype), zero.int(), zero
    if ft.backend == "pallas":
        from ..kernels import ops as kops
        out, rep = kops.ft_matmul_report(a, b, ft=ft, spec=spec, key=key)
        return (out, *_report_summary(rep))
    fn = _fused_ft_matmul if ft.fused else _nonfused_ft_matmul_2d
    out, v = fn(ft, spec, a, b, key)
    return (out, *_summary(v))


def _record(det, maxres, corrects: bool, site: Optional[str]) -> None:
    telemetry.record_summary(det, maxres, corrects, site=site)


class _FTDot(torch.autograd.Function):
    """(…, K) @ (K, N) with the forward and both backward GEMMs protected.
    Returns (y, det, maxres); the summary outputs carry no gradient."""

    @staticmethod
    def forward(ctx, x, w, ft, spec, bwd_inject, key):
        y2, det, maxres = _ft_matmul_2d(ft, spec, x.reshape(-1, x.shape[-1]),
                                        w, key)
        ctx.save_for_backward(x, w)
        ctx.ft, ctx.bwd_inject, ctx.key = ft, bwd_inject, key
        ctx.mark_non_differentiable(det, maxres)
        return y2.reshape(*x.shape[:-1], w.shape[-1]), det, maxres

    @staticmethod
    def backward(ctx, g, _det, _maxres):
        x, w = ctx.saved_tensors
        dx, dw = _linear_grads(ctx, x, w, g.reshape(-1, g.shape[-1])
                               .to(x.dtype))
        return dx, dw, None, None, None, None


def _linear_grads(ctx, x, w, dpre):
    """dx = dpre·Wᵀ and dw = Xᵀ·dpre, each a protected GEMM (only the
    gradients autograd asks for), under the keys folded from the forward's
    (dx 1, dw 2)."""
    x2 = x.reshape(-1, x.shape[-1])
    dx = dw = None
    if ctx.needs_input_grad[0]:
        dx2, _, _ = _ft_matmul_2d(ctx.ft, _bwd_injection(ctx.bwd_inject, "dx"),
                                  dpre, w.T, fold_in(ctx.key, 1))
        dx = dx2.reshape(x.shape)
    if ctx.needs_input_grad[1]:
        dw, _, _ = _ft_matmul_2d(ctx.ft, _bwd_injection(ctx.bwd_inject, "dw"),
                                 x2.T, dpre, fold_in(ctx.key, 2))
        dw = dw.to(w.dtype)
    return dx, dw


def ft_dot(x: torch.Tensor, w: torch.Tensor, ft: FTLike = FT_OFF,
           key=None, spec: Optional[InjectionSpec] = None,
           bwd_inject=None, site: Optional[str] = None) -> torch.Tensor:
    """Fault-tolerant dense projection: (…, K) @ (K, N) → (…, N).

    ft   — FTConfig, or FTPolicy resolved against ``site`` here;
    key  — stochastic-campaign key (a `torch.Generator`; armed when
           ``ft.inject_rate`` > 0);
    spec — optional deterministic single-SEU injection (forward GEMM);
    bwd_inject — optional ("dx" | "dw", InjectionSpec): an SEU inside the
           named backward GEMM;
    site — telemetry label of the call site (e.g. "w_gate")."""
    ft = resolve_ft(ft, site)
    _check_bwd_inject(ft, bwd_inject)
    if not ft.enabled and key is None and spec is None:
        return torch.matmul(x, w)                     # fast path
    if _wants_grad(x, w):
        y, det, maxres = _FTDot.apply(x, w, ft, spec, bwd_inject, key)
    else:
        y2, det, maxres = _ft_matmul_2d(ft, spec, x.reshape(-1, x.shape[-1]),
                                        w, key)
        y = y2.reshape(*x.shape[:-1], w.shape[-1])
    _record(det, maxres, ft.corrects, site)
    return y


def _epilogue_fn(act: Optional[str]):
    from ..kernels.templates import epilogues
    return epilogues.activation(act) if act is not None else (lambda y: y)


def _fused_epilogue(ft: FTConfig, spec, act, x2, w, bias, key,
                    want_grad: bool):
    """y = act(x2 @ w + bias) with policy ``ft``: (out, det, maxres,
    act_grad|None). With ``want_grad`` the kernel backend runs the
    act_grad variant (act'(pre-activation) from the verified, corrected
    accumulator) and the torch-op paths evaluate the same derivative on
    the f32 accumulator."""
    if ft.enabled and ft.backend == "pallas":
        from ..kernels import ops as kops
        res, rep = kops.fused_matmul(x2, w, bias=bias, act=act, ft=ft,
                                     inject=spec, save_act_grad=want_grad,
                                     key=key)
        out, actp = res if want_grad else (res, None)
        return (out, *_report_summary(rep), actp)
    if not ft.enabled:
        # As `_ft_matmul_2d` with FT off: no injection, the zero summary.
        acc = _matmul_f32acc(x2, w)
        det = torch.zeros((), dtype=torch.int32, device=x2.device)
        maxres = torch.zeros((), device=x2.device)
    else:
        fn = _fused_ft_matmul if ft.fused else _nonfused_ft_matmul_2d
        out, v = fn(ft, spec, x2, w, key)
        acc = out.float()
        det, maxres = _summary(v)
    if bias is not None:
        acc = acc + bias.float()
    actp = None
    if want_grad:
        from ..kernels.templates import epilogues
        actp = epilogues.activation_grad(act)(acc).to(x2.dtype)
    return _epilogue_fn(act)(acc).to(x2.dtype), det, maxres, actp


class _FTDotFused(torch.autograd.Function):
    """act((…, K) @ (K, N) + bias) with the act_grad residual saved from the
    forward; backward: dpre = g ∘ act', dbias = Σ dpre, dx and dw as two
    protected GEMMs."""

    @staticmethod
    def forward(ctx, x, w, bias, act, ft, spec, bwd_inject, key):
        x2 = x.reshape(-1, x.shape[-1])
        y2, det, maxres, actp = _fused_epilogue(ft, spec, act, x2, w, bias,
                                                key, want_grad=act is not None)
        ctx.save_for_backward(x, w, bias, actp)
        ctx.ft, ctx.bwd_inject, ctx.key = ft, bwd_inject, key
        ctx.mark_non_differentiable(det, maxres)
        return y2.reshape(*x.shape[:-1], w.shape[-1]), det, maxres

    @staticmethod
    def backward(ctx, g, _det, _maxres):
        x, w, bias, actp = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1])
        if actp is not None:
            dpre = (g2.float() * actp.float()).to(x.dtype)
        else:
            dpre = g2.to(x.dtype)
        dbias = None
        if bias is not None and ctx.needs_input_grad[2]:
            dbias = dpre.float().sum(0).to(bias.dtype).reshape(bias.shape)
        dx, dw = _linear_grads(ctx, x, w, dpre)
        return dx, dw, dbias, None, None, None, None, None


def ft_dot_fused(x: torch.Tensor, w: torch.Tensor,
                 bias: Optional[torch.Tensor] = None,
                 act: Optional[str] = None, ft: FTLike = FT_OFF,
                 key=None, spec: Optional[InjectionSpec] = None,
                 bwd_inject=None, site: Optional[str] = None
                 ) -> torch.Tensor:
    """Fault-tolerant fused-epilogue projection:
    (…, K) @ (K, N) → act((…, N) + bias), one kernel on the pallas backend
    (the linear prefix folded into the checksums). Differentiated, the
    forward also writes act'(pre-activation) and the backward is two
    protected GEMMs and one elementwise product."""
    ft = resolve_ft(ft, site)
    _check_bwd_inject(ft, bwd_inject)
    if bias is None and act is None:
        return ft_dot(x, w, ft=ft, key=key, spec=spec, bwd_inject=bwd_inject,
                      site=site)
    if not ft.enabled and key is None and spec is None:
        y = _matmul_f32acc(x, w)                      # fast path
        if bias is not None:
            y = y + bias.float()
        return _epilogue_fn(act)(y).to(x.dtype)
    if _wants_grad(x, w, bias):
        y, det, maxres = _FTDotFused.apply(x, w, bias, act, ft, spec,
                                           bwd_inject, key)
    else:
        y2, det, maxres, _ = _fused_epilogue(
            ft, spec, act, x.reshape(-1, x.shape[-1]), w, bias, key,
            want_grad=False)
        y = y2.reshape(*x.shape[:-1], w.shape[-1])
    _record(det, maxres, ft.corrects, site)
    return y


def _ft_bmm_backend(ft: FTConfig, spec, a, b, key):
    """(out, det, maxres) of one protected batched matmul: one batched
    kernel launch on the pallas backend with FT on, the torch-op path
    otherwise (FT off with an injection lands the SEU and leaves it, as the
    reference's `_fused_ft_bmm` does)."""
    if ft.enabled and ft.backend == "pallas":
        from ..kernels import ops as kops
        from ..kernels.templates import BatchedKernelSpec
        lead = a.shape[:-2]
        if a.dim() not in (3, 4):
            # The kernel takes one or two batch dims through their strides
            # (no copy of a permuted KV cache); flatten any other count.
            a = a.reshape((-1,) + tuple(a.shape[-2:]))
            b = b.reshape((-1,) + tuple(b.shape[-2:]))
        # inj_batch=-1: the SEU lands in every slice, like inject_spec.
        out, rep = kops.grouped_gemm_call(
            BatchedKernelSpec(ft_level=ft.level), a, b, ft=ft, inject=spec,
            inj_batch=-1, key=key)
        return (out.reshape(lead + tuple(out.shape[-2:])),
                *_report_summary(rep))
    out, v = _fused_ft_matmul(ft, spec, a, b, key)
    return (out, *_summary(v))


class _FTBmm(torch.autograd.Function):
    """Batched (…, M, K) @ (…, K, N) with both backward products protected
    (a campaign reaches them under keys folded from the forward's: da 3,
    db 4)."""

    @staticmethod
    def forward(ctx, a, b, ft, spec, key):
        y, det, maxres = _ft_bmm_backend(ft, spec, a, b, key)
        ctx.save_for_backward(a, b)
        ctx.ft, ctx.key = ft, key
        ctx.mark_non_differentiable(det, maxres)
        return y, det, maxres

    @staticmethod
    def backward(ctx, g, _det, _maxres):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        da = db = None
        if ctx.needs_input_grad[0]:
            da, _, _ = _ft_bmm_backend(ctx.ft, None, g, b.transpose(-1, -2),
                                       fold_in(ctx.key, 3))
        if ctx.needs_input_grad[1]:
            db, _, _ = _ft_bmm_backend(ctx.ft, None, a.transpose(-1, -2), g,
                                       fold_in(ctx.key, 4))
            db = db.to(b.dtype)
        return da, db, None, None, None


def ft_batched_dot(a: torch.Tensor, b: torch.Tensor, ft: FTLike = FT_OFF,
                   key=None, spec: Optional[InjectionSpec] = None,
                   site: Optional[str] = None) -> torch.Tensor:
    """Fault-tolerant batched matmul: (…, M, K) @ (…, K, N) → (…, M, N);
    leading dims must match. One batched kernel on the pallas backend. FT
    off with a spec or key takes the torch-op ABFT path with the SEU
    injected and not corrected, and records its summary."""
    ft = resolve_ft(ft, site)
    if not ft.enabled and key is None and spec is None:
        return torch.matmul(a, b)
    if _wants_grad(a, b):
        y, det, maxres = _FTBmm.apply(a, b, ft, spec, key)
    else:
        y, det, maxres = _ft_bmm_backend(ft, spec, a, b, key)
    _record(det, maxres, ft.corrects, site)
    return y


# ---------------------------------------------------------------------------
# grouped variant — the MoE expert FFNs over ragged routing
# ---------------------------------------------------------------------------
#
# y[t] = x[t] @ w[group_ids[t]] with dynamic group sizes. The rows are
# scattered into a group-sorted buffer whose groups start on row-tile
# boundaries (kernels.grouped.layout); the pallas backend runs the grouped
# kernel K7 (per-group B, checksums, detection and correction per row-tile
# block), and the torch-op path mirrors the same algebra with segment
# reductions, so an SEU in one expert's rows never reaches a neighbour.

#: Tiles of gathered expert weights per chunk of the torch-op products:
#: at most this many f32 elements of w[gid] at once.
_GATHER_ELEMS = 1 << 26


def _row_gids(gid: torch.Tensor, t_buf: int) -> torch.Tensor:
    return gid.long().repeat_interleave(t_buf // gid.shape[0])


def _grouped_dot(buf: torch.Tensor, w: torch.Tensor, gid: torch.Tensor
                 ) -> torch.Tensor:
    """f32 grouped product over the aligned buffer: each row tile against
    its group's w, a bounded number of tiles at a time."""
    t_buf, k = buf.shape
    nt, n = gid.shape[0], w.shape[-1]
    b3 = buf.reshape(nt, t_buf // nt, k)
    step = max(1, _GATHER_ELEMS // max(k * n, 1))
    parts = [torch.bmm(b3[i:i + step].float(),
                       w[gid[i:i + step].long()].float())
             for i in range(0, nt, step)]
    return torch.cat(parts).reshape(t_buf, n)


def _fused_ft_grouped(ft: FTConfig, spec, buf, w, gid, key=None):
    """Online ABFT for the grouped product on the torch-op path: per-group
    checksums by segment reductions, per-group rounding-aware thresholds,
    one located and corrected SEU per group."""
    t_buf, k = buf.shape
    g, _, n = w.shape
    dev = buf.device
    rg = _row_gids(gid, t_buf)
    bf = buf.float()
    wf = w.float()
    acc = _grouped_dot(buf, w, gid)                          # (t_buf, n)
    # Checksums from the operands: (e^T X_g) W_g per group, x_t·(W_g e).
    xsum = torch.zeros(g, k, device=dev).index_add_(0, rg, bf)
    colck = torch.einsum("gk,gkn->gn", xsum, wf)
    rowck = (bf * wf.sum(-1)[rg]).sum(-1)
    acc = inject(ft, spec, key, acc)
    d_col = torch.zeros(g, n, device=dev).index_add_(0, rg, acc) - colck
    d_row = acc.sum(-1) - rowck
    if ft.static_tau is not None:
        tau = torch.full((g,), ft.static_tau, device=dev)
    else:
        amax = torch.zeros(g, device=dev).scatter_reduce(
            0, rg, bf.abs().amax(-1), "amax")
        bmax = wf.abs().amax((-2, -1))
        tau = torch.clamp_min(ft.rel_tau * abft.F32EPS * k * amax * bmax,
                              1e-30)
    colmax = d_col.abs().amax(-1)                            # (G,)
    rowmax = torch.zeros(g, device=dev).scatter_reduce(
        0, rg, d_row.abs(), "amax")
    det_g = torch.maximum(colmax, rowmax) > tau
    col_g = torch.argmax(d_col.abs(), -1)
    mag_g = torch.gather(d_col, -1, col_g[:, None])[:, 0]
    # Located row per group: the first peak of |d_row| inside the group.
    is_peak = d_row.abs() >= rowmax[rg]
    idx = torch.arange(t_buf, device=dev)
    row_g = torch.full((g,), t_buf, device=dev, dtype=torch.long
                       ).scatter_reduce(0, rg, torch.where(is_peak, idx,
                                                           t_buf), "amin")
    if ft.corrects:
        delta = torch.where(det_g, mag_g, torch.zeros_like(mag_g))
        acc = acc.index_put((row_g.clamp(0, t_buf - 1), col_g), -delta,
                            accumulate=True)
    det = det_g.sum().to(torch.int32)
    maxres = torch.maximum(colmax.max(), rowmax.max())
    return acc.to(buf.dtype), det, maxres


def _ft_grouped_2d(ft: FTConfig, spec, buf, w, gid, row_end, key):
    """(y_buf, det, maxres) of one grouped product."""
    if not ft.enabled:
        zero = torch.zeros((), device=buf.device)
        return _grouped_dot(buf, w, gid).to(buf.dtype), zero.int(), zero
    if ft.backend == "pallas":
        from ..kernels import grouped as kgrouped
        from ..kernels.templates import BatchedKernelSpec
        out, rep = kgrouped.grouped_buffer_call(
            BatchedKernelSpec(ft_level=ft.level, grouped=True), buf, w,
            gid=gid, row_end=row_end, ft=ft, inject=spec, key=key)
        return (out, *_report_summary(rep))
    return _fused_ft_grouped(ft, spec, buf, w, gid, key)


def _grouped_dw(ft: FTConfig, inj, buf, g_buf, gid, row_end, key=None):
    """The grouped backward dw: dw[g] = X_gᵀ·G_g, (G, K, N) f32. The
    pallas backend runs the grouped transpose kernel K8 (per-group checksums
    flushed per group, detection and correction in the kernel, a campaign
    ``key`` drawn in kernel); otherwise
    the per-tile outer products are summed per group and verified with
    per-group checksums, col (X_g e_K)ᵀG_g and row X_gᵀ(G_g e_N)."""
    t_buf, k = buf.shape
    ng = row_end.shape[0]
    nt = gid.shape[0]
    bm = t_buf // nt
    n = g_buf.shape[-1]
    if ft.enabled and ft.backend == "pallas":
        from ..kernels import grouped as kgrouped
        from ..kernels.templates import BatchedKernelSpec
        dw, _ = kgrouped.tgmm_buffer_call(
            BatchedKernelSpec(ft_level=ft.level, tgmm=True), buf, g_buf,
            gid=gid, row_end=row_end, ft=ft, inject=inj, key=key)
        return dw                  # backward corrections are not counted
    dev = buf.device
    b3 = buf.reshape(nt, bm, k).float()
    g3 = g_buf.reshape(nt, bm, n).float()
    gl = gid.long()
    dw = torch.zeros(ng, k, n, device=dev)
    step = max(1, _GATHER_ELEMS // max(k * n, 1))
    for i in range(0, nt, step):
        dw.index_add_(0, gl[i:i + step],
                      torch.bmm(b3[i:i + step].transpose(1, 2),
                                g3[i:i + step]))
    if ft.enabled:
        dw = inject(ft, inj, None, dw)
        u, v = b3.sum(-1), g3.sum(-1)                        # (tiles, bm)
        colck = torch.zeros(ng, n, device=dev).index_add_(
            0, gl, torch.einsum("tb,tbn->tn", u, g3))
        rowck = torch.zeros(ng, k, device=dev).index_add_(
            0, gl, torch.einsum("tbk,tb->tk", b3, v))
        ck = abft.Checksums(col=colck[:, None, :], row=rowck[:, :, None])
        if ft.static_tau is not None:
            tau = torch.full((ng,), ft.static_tau, device=dev)
        else:
            zeros = torch.zeros(ng, device=dev)
            amax = zeros.scatter_reduce(0, gl, b3.abs().amax((1, 2)), "amax")
            gmax = zeros.scatter_reduce(0, gl, g3.abs().amax((1, 2)), "amax")
            rows = zeros.index_add(0, gl, torch.ones(nt, device=dev)) * bm
            tau = torch.clamp_min(ft.rel_tau * abft.F32EPS * rows * amax
                                  * gmax, 1e-30)
        dw, _ = abft.detect_and_correct(dw, ck, tau, corrects=ft.corrects)
    return dw


class _FTGrouped(torch.autograd.Function):
    """The grouped product over a buffer with the forward and both backward
    products protected: dbuf = g_buf·w[g]ᵀ through the same grouped path
    (wᵀ passed as a view), dw through `_grouped_dw`. The summaries carry no
    gradient; backward corrections are applied but not counted."""

    @staticmethod
    def forward(ctx, buf, w, gid, row_end, ft, spec, bwd_inject, key):
        y, det, maxres = _ft_grouped_2d(ft, spec, buf, w, gid, row_end, key)
        ctx.save_for_backward(buf, w, gid, row_end)
        ctx.ft, ctx.bwd_inject, ctx.key = ft, bwd_inject, key
        ctx.mark_non_differentiable(det, maxres)
        return y, det, maxres

    @staticmethod
    def backward(ctx, g_buf, _det, _maxres):
        buf, w, gid, row_end = ctx.saved_tensors
        g_buf = g_buf.to(buf.dtype)
        dbuf = dw = None
        if ctx.needs_input_grad[0]:
            dbuf, _, _ = _ft_grouped_2d(
                ctx.ft, _bwd_injection(ctx.bwd_inject, "dbuf"), g_buf,
                w.transpose(-1, -2), gid, row_end, fold_in(ctx.key, 6))
        if ctx.needs_input_grad[1]:
            dw = _grouped_dw(ctx.ft, _bwd_injection(ctx.bwd_inject, "dw"),
                             buf, g_buf, gid, row_end,
                             fold_in(ctx.key, 7)).to(w.dtype)
        return dbuf, dw, None, None, None, None, None, None


def grouped_row_tile(t: int, n: int, k: int, dtype, n_groups: int,
                     ft: FTLike, site: Optional[str] = None) -> int:
    """The row tile (group alignment) `ft_grouped_matmul` takes for this
    problem, so that a chain of grouped GEMMs (the MoE FFN) can share one
    layout. Under an `FTPolicy`, pass the site of the chain's first GEMM."""
    ft = resolve_ft(ft, site)
    if ft.enabled and ft.backend == "pallas":
        from ..kernels import grouped as kgrouped
        return kgrouped.plan_grouped(t, n, k, dtype, n_groups=n_groups)[0]
    return {4: 8, 2: 16, 1: 32}.get(torch.empty((), dtype=dtype)
                                    .element_size(), 8)


def ft_grouped_matmul_buffer(buf: torch.Tensor, w: torch.Tensor,
                             gid: torch.Tensor, row_end: torch.Tensor,
                             ft: FTLike = FT_OFF, key=None,
                             spec: Optional[InjectionSpec] = None,
                             bwd_inject=None, site: Optional[str] = None
                             ) -> torch.Tensor:
    """Buffer-space `ft_grouped_matmul`: a group-sorted (t_buf, K) buffer
    in, the (t_buf, N) result in buffer space out, so a chain of grouped
    GEMMs over one routing decision (the expert FFN's gate, up and down)
    scatters once and gathers once. ``bwd_inject`` = ("dbuf" | "dw",
    InjectionSpec) lands an SEU in the named backward product."""
    ft = resolve_ft(ft, site)
    _check_bwd_inject(ft, bwd_inject)
    if not ft.enabled and key is None and spec is None:
        return _grouped_dot(buf, w, gid).to(buf.dtype)       # fast path
    if _wants_grad(buf, w):
        y, det, maxres = _FTGrouped.apply(buf, w, gid, row_end, ft, spec,
                                          bwd_inject, key)
    else:
        y, det, maxres = _ft_grouped_2d(ft, spec, buf, w, gid, row_end, key)
    _record(det, maxres, ft.corrects, site)
    return y


def ft_grouped_matmul(x: torch.Tensor, w: torch.Tensor,
                      group_ids: torch.Tensor, ft: FTLike = FT_OFF, key=None,
                      spec: Optional[InjectionSpec] = None, bwd_inject=None,
                      site: Optional[str] = None) -> torch.Tensor:
    """Fault-tolerant ragged grouped matmul: y[t] = x[t] @ w[group_ids[t]].

    x (T, K) in caller order; w (G, K, N); group_ids int (T,). Any group
    sizes: no capacity, no dropped rows, at most G·(bm-1) alignment rows.
    Both directions are protected (see `ft_grouped_matmul_buffer`)."""
    from ..kernels.grouped import layout as glayout
    ft = resolve_ft(ft, site)
    t, k = x.shape
    ng = w.shape[0]
    bm = grouped_row_tile(t, w.shape[-1], k, x.dtype, ng, ft)
    lay = glayout.make_layout(group_ids, ng, bm)
    y_buf = ft_grouped_matmul_buffer(glayout.scatter_rows(x, lay), w,
                                     lay.gid, lay.row_end, ft=ft, key=key,
                                     spec=spec, bwd_inject=bwd_inject,
                                     site=site)
    return glayout.gather_rows(y_buf, lay)
