"""`ft_dot` / `ft_dot_fused` / `ft_batched_dot` — the fault-tolerant GEMM
fronts every projection of the model routes through (counterpart of
`repro.core.ft_gemm`, forward only).

Paths, selected by the resolved `FTConfig`:

  * FT off with no injection — the plain-matmul fast path;
  * ``backend="pallas"`` — the hand-written CUDA kernels through
    `kernels.ops` (the ABFT GEMM, 2-D or batched); on a CPU tensor their
    plain versions;
  * ``backend="xla"`` — the torch-op ABFT path mirroring
    `repro.core.ft_gemm._fused_ft_matmul_2d`: checksums from the operands,
    `core.abft` verify / locate / correct (``fused=False``: the non-fused
    baseline with materialised augmented operands).

Each protected call records its (detections, max residual) summary into the
ambient `telemetry.ft_scope` under its ``site`` label.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import abft, telemetry
from .fault_injection import check_campaign, inject_spec
from .policy import FTConfig, FTLike, FT_OFF, InjectionSpec, resolve_ft


def _matmul_f32acc(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a.float(), b.float())


def _tau(ft: FTConfig, a, b) -> torch.Tensor:
    if ft.static_tau is not None:
        return torch.full(a.shape[:-2], ft.static_tau, dtype=torch.float32,
                          device=a.device)
    return abft.threshold(a, b, ft.rel_tau)


def _fused_ft_matmul(ft: FTConfig, spec, a, b):
    """Fused online ABFT: checksums from the operands, verify, correct."""
    acc = _matmul_f32acc(a, b)
    ck = abft.product_checksums(a, b)
    acc = inject_spec(acc, spec)
    out, v = abft.detect_and_correct(acc, ck, _tau(ft, a, b),
                                     corrects=ft.corrects)
    return out.to(a.dtype), v


def _nonfused_ft_matmul_2d(ft: FTConfig, spec, a, b):
    """Ding-2011-style non-fused ABFT: materialised augmented operands and
    a separate verification pass."""
    m, n = a.shape[0], b.shape[1]
    a_aug = torch.cat([a.float(), abft.encode_col(a)], dim=0)   # (M+1, K)
    b_aug = torch.cat([b.float(), abft.encode_row(b)], dim=1)   # (K, N+1)
    c_f = torch.matmul(a_aug, b_aug)                            # (M+1, N+1)
    acc = inject_spec(c_f[:m, :n], spec)
    ck = abft.Checksums(col=c_f[m:m + 1, :n], row=c_f[:m, n:n + 1])
    out, v = abft.detect_and_correct(acc, ck, _tau(ft, a, b),
                                     corrects=ft.corrects)
    return out.to(a.dtype), v


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
    check_campaign(ft, key)
    if ft.backend == "pallas":
        from ..kernels import ops as kops
        out, rep = kops.ft_matmul_report(a, b, ft=ft, spec=spec)
        return (out, *_report_summary(rep))
    fn = _fused_ft_matmul if ft.fused else _nonfused_ft_matmul_2d
    out, v = fn(ft, spec, a, b)
    return (out, *_summary(v))


def _record(det, maxres, corrects: bool, site: Optional[str]) -> None:
    telemetry.record_summary(det, maxres, corrects, site=site)


def ft_dot(x: torch.Tensor, w: torch.Tensor, ft: FTLike = FT_OFF,
           key=None, spec: Optional[InjectionSpec] = None,
           site: Optional[str] = None) -> torch.Tensor:
    """Fault-tolerant dense projection: (…, K) @ (K, N) → (…, N).

    ft   — FTConfig, or FTPolicy resolved against ``site`` here;
    key  — stochastic-campaign key (a request for a campaign raises);
    spec — optional deterministic single-SEU injection;
    site — telemetry label of the call site (e.g. "w_gate")."""
    ft = resolve_ft(ft, site)
    if not ft.enabled and key is None and spec is None:
        return torch.matmul(x, w)                     # fast path
    lead = x.shape[:-1]
    y2, det, maxres = _ft_matmul_2d(ft, spec, x.reshape(-1, x.shape[-1]), w,
                                    key)
    if ft.enabled:
        _record(det, maxres, ft.corrects, site)
    return y2.reshape(*lead, w.shape[-1])


def _epilogue_fn(act: Optional[str]):
    from ..kernels.templates import epilogues
    return epilogues.activation(act) if act is not None else (lambda y: y)


def ft_dot_fused(x: torch.Tensor, w: torch.Tensor,
                 bias: Optional[torch.Tensor] = None,
                 act: Optional[str] = None, ft: FTLike = FT_OFF,
                 key=None, spec: Optional[InjectionSpec] = None,
                 site: Optional[str] = None) -> torch.Tensor:
    """Fault-tolerant fused-epilogue projection:
    (…, K) @ (K, N) → act((…, N) + bias), one kernel on the pallas backend
    (the linear prefix folded into the checksums)."""
    ft = resolve_ft(ft, site)
    if bias is None and act is None:
        return ft_dot(x, w, ft=ft, key=key, spec=spec, site=site)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if ft.enabled and ft.backend == "pallas":
        check_campaign(ft, key)
        from ..kernels import ops as kops
        out, rep = kops.fused_matmul(x2, w, bias=bias, act=act, ft=ft,
                                     inject=spec)
        det, maxres = _report_summary(rep)
    else:
        if not ft.enabled:
            acc = _matmul_f32acc(x2, w)
        else:
            check_campaign(ft, key)
            fn = _fused_ft_matmul if ft.fused else _nonfused_ft_matmul_2d
            out, v = fn(ft, spec, x2, w)
            acc = out.float()
            det, maxres = _summary(v)
        if bias is not None:
            acc = acc + bias.float()
        out = _epilogue_fn(act)(acc).to(x.dtype)
    if ft.enabled:
        _record(det, maxres, ft.corrects, site)
    return out.reshape(*lead, w.shape[-1])


def _ft_bmm_backend(ft: FTConfig, spec, a, b, key):
    """(out, det, maxres) of one protected batched matmul: one batched
    kernel launch on the pallas backend, the torch-op path otherwise."""
    check_campaign(ft, key)
    if ft.backend == "pallas":
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
            inj_batch=-1)
        return (out.reshape(lead + tuple(out.shape[-2:])),
                *_report_summary(rep))
    out, v = _fused_ft_matmul(ft, spec, a, b)
    return (out, *_summary(v))


def ft_batched_dot(a: torch.Tensor, b: torch.Tensor, ft: FTLike = FT_OFF,
                   key=None, spec: Optional[InjectionSpec] = None,
                   site: Optional[str] = None) -> torch.Tensor:
    """Fault-tolerant batched matmul: (…, M, K) @ (…, K, N) → (…, M, N);
    leading dims must match. One batched kernel on the pallas backend."""
    ft = resolve_ft(ft, site)
    if not ft.enabled and key is None and spec is None:
        return torch.matmul(a, b)
    if not ft.enabled:
        return _matmul_f32acc(a, b).to(a.dtype)
    y, det, maxres = _ft_bmm_backend(ft, spec, a, b, key)
    _record(det, maxres, ft.corrects, site)
    return y
