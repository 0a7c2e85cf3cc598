"""Fault-tolerance policy configuration (counterpart of `repro.core.policy`).

`FTConfig` and `InjectionSpec` keep the reference's field names and
defaults, so a reference config translates one to one. The design space:

  * level   — where checksums are maintained ("inner"/"tile"/"block"). The
              GEMM kernels K1, K5, K7 and K8 implement all three; the
              flash kernels have no level, as in the reference.
  * action  — "correct" (online ABFT: detect and correct on the fly),
              "detect" (offline ABFT, detect only) or "off".
  * fused   — True: checksums fused with the GEMM; False: the Ding-2011
              non-fused baseline (separate encode / multiply / verify).
  * verify  — "step": verify every k-step; "final": once per output tile.
  * backend — "pallas" selects the hand-written CUDA kernels, "xla" the
              torch-op ABFT path (see the `repro_torch` package docstring).

`FTPolicy` resolves per-site overrides; the planner and the escalation
controller of the reference are not part of this package.
"""
from __future__ import annotations

import dataclasses
import fnmatch
from typing import Optional, Tuple, Union


@dataclasses.dataclass(frozen=True)
class FTConfig:
    action: str = "correct"          # "off" | "detect" | "correct"
    level: str = "block"             # "inner" | "tile" | "block"
    fused: bool = True               # False = Ding-2011 non-fused baseline
    verify: str = "step"             # "step" | "final"
    # Relative checksum tolerance multiplier. The absolute threshold is
    #   tau = rel_tau * eps(f32) * K * max|A| * max|B|
    rel_tau: float = 64.0
    # Checksums accumulate in f32 even for bf16 GEMMs.
    checksum_dtype: str = "float32"
    # Protect batched attention GEMMs (QK^T, PV) too.
    protect_attention: bool = True
    # "xla" (torch-op ABFT path) or "pallas" (hand-written CUDA kernels).
    backend: str = "xla"
    # Optional static detection threshold; None = rounding-aware dynamic tau.
    static_tau: Optional[float] = None
    # Stochastic SEU injection rate (campaigns; 0.0 = off): per matmul on
    # the torch-op path, per output block in the GEMM kernels; the flash
    # kernels take no campaign yet (a request there raises).
    inject_rate: float = 0.0
    inject_bit_shift: int = 8

    @property
    def enabled(self) -> bool:
        return self.action != "off"

    @property
    def corrects(self) -> bool:
        return self.action == "correct"

    def replace(self, **kw) -> "FTConfig":
        return dataclasses.replace(self, **kw)


#: Fused threadblock-level online ABFT (the paper's flagship).
ONLINE_BLOCK = FTConfig(action="correct", level="block", fused=True)
#: Offline (detect-only) ABFT.
OFFLINE_DETECT = FTConfig(action="detect", level="block", fused=True)
#: Ding et al. 2011: non-fused online ABFT.
NONFUSED_BASELINE = FTConfig(action="correct", level="block", fused=False)
#: Fault tolerance disabled.
FT_OFF = FTConfig(action="off")


@dataclasses.dataclass(frozen=True)
class InjectionSpec:
    """A single emulated SEU: add ``magnitude`` to the accumulator at
    (row, col) at k-step ``k_step``."""
    row: int
    col: int
    magnitude: float
    k_step: int = 0


@dataclasses.dataclass(frozen=True)
class FTPolicy:
    """Ordered site-pattern → `FTConfig` override rules (fnmatch globs over
    site labels such as ``"w_gate"`` or ``"dec_*"``); the first matching
    rule wins, otherwise ``default``."""
    rules: Tuple[Tuple[str, FTConfig], ...] = ()
    default: FTConfig = ONLINE_BLOCK

    def __post_init__(self):
        object.__setattr__(self, "rules", tuple(
            (str(p), c) for p, c in self.rules))
        for pat, cfg in self.rules:
            if not isinstance(cfg, FTConfig):
                raise TypeError(f"rule {pat!r} maps to {type(cfg).__name__}, "
                                f"expected FTConfig")
        if not isinstance(self.default, FTConfig):
            raise TypeError("FTPolicy.default must be an FTConfig, got "
                            f"{type(self.default).__name__}")

    @staticmethod
    def uniform(ft: FTConfig) -> "FTPolicy":
        return FTPolicy(rules=(), default=ft)

    def resolve(self, site: Optional[str]) -> FTConfig:
        if site is not None:
            for pat, cfg in self.rules:
                if fnmatch.fnmatchcase(site, pat):
                    return cfg
        return self.default

    def override(self, *rules: Tuple[str, FTConfig]) -> "FTPolicy":
        """A new policy with ``rules`` prepended (they win)."""
        return FTPolicy(rules=tuple(rules) + self.rules, default=self.default)


FTLike = Union[FTConfig, FTPolicy]


def resolve_ft(ft: FTLike, site: Optional[str]) -> FTConfig:
    """FTConfig-or-FTPolicy → the FTConfig of ``site``."""
    if isinstance(ft, FTPolicy):
        return ft.resolve(site)
    return ft


def promote(ft: FTConfig) -> FTConfig:
    """Storm promotion: detect→correct and final→step; "off" stays off."""
    if not ft.enabled:
        return ft
    return ft.replace(action="correct", verify="step")
