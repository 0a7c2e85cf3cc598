"""ABFT GEMM — wrapper of the CUDA kernels `csrc/ft_gemm.cu` and
`csrc/ft_gemm_chain.cu` (SIMT), `csrc/ft_gemm_sm90.cu`,
`csrc/ft_gemm_level_sm90.cu` and `csrc/batched_sm90.cu` (tensor cores), and
their plain PyTorch version.

Replaces the TPU kernels K1 (2-D) and K5 (uniform batched) of the JAX
package: `repro/kernels/templates/emit.py:render`, launched by
`templates/registry.py:kernel_call` and `:batched_kernel_call`. `plan`
decides which instance runs a call, at which tiles and with how many
split-K ranges: a bf16 2-D call at any FT level, whose chain is an
optional bias then at most one activation (silu, gelu or relu) and whose
operands TMA can read (a unit-stride dim, the other stride a multiple of 8
elements, 16-byte aligned bases), runs on the tensor cores at `SM90_TILES`
(`csrc/ft_gemm_sm90.cu` at FT off and "block",
`csrc/ft_gemm_level_sm90.cu` at "tile" and "inner"); every other call on
the SIMT kernel at `TILES`, whose 2-D kernel is its batched kernel with
batch 1: `csrc/ft_gemm.cu` where it compiles the call's (chain, level,
act_grad) (`simt_compiled`), else the chain instance `csrc/ft_gemm_chain.cu`,
which takes any chain of at most one bias, one residual and any number of
activations in any order, at most `CHAIN_CAP` ops, as a runtime op list
(`chain_code`; a longer chain raises NotImplementedError in every plan).
`plan_k5` does the same for a batched call: a bf16 call of at most 16 rows
a slice, whose operands the 16-byte copies can read, runs at any FT level
with any aux-free chain on the tensor cores at `BATCHED_SM90_TILES` (16
rows, 256-deep k-steps); every other one on the SIMT kernel, a chained one
on the chain instance. Each instance has its own launch counter
(`FT_GEMM_SM90`, `FT_GEMM_LEVEL_SM90`, `FT_GEMM_2D_SIMT`, `FT_GEMM_CHAIN`,
`FT_GEMM_BATCHED_SM90`, `FT_GEMM_BATCHED`, `FT_GEMM_BATCHED_CHAIN`);
`FT_GEMM_2D` is K1's 2-D total, `FT_GEMM_K5` K5's.

Three FT levels, the paper's threadblock / warp / thread granularities
(`repro/kernels/ftgemm.py:9-21`):

  * "block" — one running (column, row) checksum pair per output block,
    verified per k-step (verify="step") and once at the end, where the
    linear epilogue prefix is folded into the comparison;
  * "tile" — one running column checksum per band of rows and one row
    checksum per row; each band is verified, located and corrected on its
    own (one SEU per band per interval). The final verification runs on
    the raw accumulator, before the whole epilogue chain. The band comes
    from the tiles (`band_of`): at the kernel's compiled tiles the rows one
    warp owns (`spec.BANDS`; 16 at `SM90_TILES`, a warp's rows of the
    wgmma fragment), at any other the reference's 128-row MXU edge;
  * "inner" — every k-step's Δ = A_s·B_s is verified alone against its own
    checksums, located and corrected in Δ, then accumulated: no running
    checksums and no final verification, so ``verify`` changes nothing.

`ft_gemm` takes a CPU tensor to `ft_gemm_plain` under the same plan and a
CUDA tensor to the kernel; on a CUDA tensor it launches the kernel or
raises. With
``save_act_grad`` both also write the act_grad output, act'(pre-activation)
of the chain's activation from the verified, corrected accumulator (after
the final verification at "block" and "tile", after the last step's at
"inner": the residual the training backward consumes), and return
((C, act_grad), report). The plain version walks the same (bm, bn, bk) tile
grid as the kernel — a Python loop over k-steps, vectorised over output
blocks — and writes the same (…, gm, gn, 8) report, so the two can be held
against each other on the card and the plain version against the reference
on the CPU. With ``splits`` > 1 the plain version walks the tensor-core
instance's split-K grid: each block's k-steps in that many contiguous,
balanced ranges, each verified as its own accumulator, then summed and
(at "block" and "tile") verified at k = K, the reports merged by the
rule of `merge_reports`.

What bounds the kernels on the H100 and what their designs do about it is
in the headers of `csrc/ft_gemm.cu`, `csrc/ft_gemm_sm90.cuh` and
`csrc/batched_sm90.cu`.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..core.abft import F32EPS
from ..core.policy import FTConfig
from . import build
from .templates import epilogues, seu
from .templates.spec import (BATCHED_SM90_TILES, SM90_TILES, TILES,
                             KernelSpec, band_of, validate)

#: FT level → the SIMT kernels' LEVEL code.
LEVELS = {"block": 0, "tile": 1, "inner": 2}
#: FT level → the tensor-core kernels' level code (kLv* in
#: csrc/sm90_mainloop.cuh).
SM90_LEVELS = {"off": 0, "block": 1, "tile": 2, "inner": 3}
#: Epilogue chains compiled at the "tile" and "inner" levels (the serving
#: projections'), row-major walk; the plain chain also on the transposed
#: walks (LAYOUT 1 and 2), silu and bias+silu also with act_grad.
LEVEL_EPILOGUES = ((), ("bias",), ("silu",), ("bias", "silu"))

#: Epilogue chains the kernel is instantiated for → its `Epilogue` code.
EPILOGUES = {(): 0, ("bias",): 1, ("silu",): 2, ("bias", "silu"): 3,
             ("gelu",): 4, ("relu",): 5, ("residual",): 6}
#: The chains csrc/ft_gemm.cu compiles with the act_grad output, at FT off
#: and "block" and at "tile" and "inner".
AG_EPILOGUES = {"block": (("silu",), ("bias", "silu"), ("gelu",), ("relu",)),
                "level": (("silu",), ("bias", "silu"))}
#: The chain instances' op codes (ChainOp in csrc/ft_gemm_simt.cuh; the
#: tensor-core K5 and K7 take the same codes, activations only:
#: `activate_chain` in csrc/sm90_mainloop.cuh).
CHAIN_OPS = {"bias": 1, "residual": 2, "silu": 3, "gelu": 4, "relu": 5}
#: The most ops a runtime chain holds: 3 bits an op in an int32, a bias, a
#: residual and 8 activations. The reference takes any number of
#: activations; a longer chain raises NotImplementedError.
CHAIN_CAP = 10

REPORT_WIDTH = 8

_BATCH_STRIDES = [ctypes.c_longlong] * 2
#: The stochastic hook's launch arguments (`seu_args`): on, seed, rate,
#: bit shift.
SEU_ARGTYPES = [ctypes.c_int, ctypes.c_uint, ctypes.c_float, ctypes.c_int]
_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
             + _BATCH_STRIDES + [ctypes.c_int] * 2
             + _BATCH_STRIDES + [ctypes.c_int] * 10 + [ctypes.c_float]
             + [ctypes.c_int] * 5 + [ctypes.c_float] + SEU_ARGTYPES
             + [ctypes.c_void_p])
FT_GEMM_2D_SIMT = build.Kernel("ft_gemm", "ft_gemm_launch", _ARGTYPES)
FT_GEMM_BATCHED = build.Kernel("ft_gemm", "ft_gemm_launch", _ARGTYPES)
#: The SIMT chain instance (csrc/ft_gemm_chain.cu): ft_gemm_launch's
#: arguments with (chain_ops, chain_len, chain_fold) for (epi, tiles,
#: layout) → (chain_ops, chain_len, chain_fold, tiles).
_CHAIN_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                   + _BATCH_STRIDES + [ctypes.c_int] * 2
                   + _BATCH_STRIDES + [ctypes.c_int] * 11 + [ctypes.c_float]
                   + [ctypes.c_int] * 5 + [ctypes.c_float] + SEU_ARGTYPES
                   + [ctypes.c_void_p])
FT_GEMM_CHAIN = build.Kernel("ft_gemm_chain", "ft_gemm_chain_launch",
                             _CHAIN_ARGTYPES)
#: The same entry for a batched call (K5 with a chain on the SIMT kernel).
FT_GEMM_BATCHED_CHAIN = build.Kernel("ft_gemm_chain", "ft_gemm_chain_launch",
                                     _CHAIN_ARGTYPES)
_SM90_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 3
                  + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 8
                  + [ctypes.c_float] + [ctypes.c_int] * 4
                  + [ctypes.c_float] + SEU_ARGTYPES + [ctypes.c_void_p])
FT_GEMM_SM90 = build.Kernel("ft_gemm_sm90", "ft_gemm_sm90_launch",
                            _SM90_ARGTYPES)
#: The tensor-core instances at "tile" and "inner" (the same arguments;
#: each entry takes the `SM90_LEVELS` codes of its own levels).
FT_GEMM_LEVEL_SM90 = build.Kernel("ft_gemm_level_sm90",
                                  "ft_gemm_level_sm90_launch",
                                  _SM90_ARGTYPES)
#: Every 2-D K1 launch, on any instance.
FT_GEMM_2D = build.LaunchTotal(FT_GEMM_2D_SIMT, FT_GEMM_CHAIN, FT_GEMM_SM90,
                               FT_GEMM_LEVEL_SM90)
_B_SM90_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                    + [ctypes.c_longlong] * 2 + [ctypes.c_int]
                    + [ctypes.c_longlong] * 2 + [ctypes.c_int] * 8
                    + [ctypes.c_float] + [ctypes.c_int] * 5
                    + [ctypes.c_float] + SEU_ARGTYPES + [ctypes.c_void_p])
FT_GEMM_BATCHED_SM90 = build.Kernel("batched_sm90", "batched_sm90_launch",
                                    _B_SM90_ARGTYPES)
#: Every K5 launch, on any instance.
FT_GEMM_K5 = build.LaunchTotal(FT_GEMM_BATCHED, FT_GEMM_BATCHED_SM90,
                               FT_GEMM_BATCHED_CHAIN)

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# The tensor-core instance's (bm, bn, bk) tiles are `spec.SM90_TILES`: 128
# rows (two consumer warpgroups) for M > 64, else 64; bk is the 256-deep
# k-step, the verification interval, the reference's small-class bk
# (`repro/kernels/autotune.py:66`).

#: The activations the tensor-core instance applies after an optional bias
#: → its `act` code (`activate` in csrc/sm90_mainloop.cuh).
SM90_ACTS = {None: 0, "silu": 1, "gelu": 2, "relu": 3}
#: The H100's SMs; split-K cuts a call whose output blocks number fewer
#: than about two waves of CTAs.
SMS = 132
SPLIT_TARGET = 2 * SMS
#: f32 words of one split's record in the split-K workspace: the column
#: checksums (one 128-wide row per band at "tile", at most 8), the row
#: checksums (128), max|A|, max|B|, the split's report (8), padding
#: (kRec in csrc/ft_gemm_sm90.cuh).
SPLIT_RECORD = 1168


@dataclasses.dataclass(frozen=True)
class Plan:
    """How one call runs. ``instance``: "sm90" (csrc/ft_gemm_sm90.cu, at
    "tile" / "inner" csrc/ft_gemm_level_sm90.cu, for a
    2-D call, csrc/batched_sm90.cu for a batched one), "simt"
    (csrc/ft_gemm.cu), "simt_chain" (csrc/ft_gemm_chain.cu: a 2-D call
    whose (chain, level, act_grad) ft_gemm.cu does not compile, a batched
    call with a chain) or "plain"
    (tiles no kernel compiles: the plain version only, on the CPU).
    ``a_kmajor`` / ``b_kmajor``: the unit-stride dim of each operand on the
    tensor-core walk; ``reason``: why the tensor-core instance does not
    take the call ("" when it does)."""
    instance: str
    tiles: Tuple[int, int, int]
    splits: int = 1
    a_kmajor: bool = True
    b_kmajor: bool = False
    reason: str = ""


def chain_code(chain: Tuple[str, ...]) -> int:
    """A chain as the kernels' runtime op list: op i's `CHAIN_OPS` code in
    bits 3i..3i+2."""
    return sum(CHAIN_OPS[x] << (3 * i) for i, x in enumerate(chain))


def _check_chain_cap(chain: Tuple[str, ...]) -> None:
    if len(chain) > CHAIN_CAP:
        raise NotImplementedError(
            f"ft_gemm: the kernels take a chain of at most {CHAIN_CAP} ops "
            f"(3 bits an op in an int32), got {len(chain)}: {chain}")


def sm90_chain(chain: Tuple[str, ...]) -> Optional[Tuple[bool, int]]:
    """(bias, act code) of a chain the tensor-core instance applies — an
    optional bias, then at most one activation of `SM90_ACTS` — or None:
    a chain with a residual, or with the bias after the activation, runs on
    the SIMT kernels (their epilogue reads the (M, N) residual tile; the
    tensor-core one stages only a bias row)."""
    rest = tuple(chain)
    bias = rest[:1] == ("bias",)
    rest = rest[1:] if bias else rest
    if len(rest) > 1 or (rest and rest[0] not in SM90_ACTS):
        return None
    return bias, SM90_ACTS[rest[0] if rest else None]


def simt_compiled(chain: Tuple[str, ...], level: str,
                  act_grad: bool) -> bool:
    """Whether csrc/ft_gemm.cu compiles (chain, level, act_grad) on its
    row-major walk: `EPILOGUES` at FT off and "block" (`AG_EPILOGUES`
    with act_grad), `LEVEL_EPILOGUES` at "tile" and "inner" (with act_grad
    silu and bias+silu). Every other chain runs on the chain instance."""
    chain = tuple(chain)
    lv = "level" if level in ("tile", "inner") else "block"
    if act_grad:
        return chain in AG_EPILOGUES[lv]
    return chain in (LEVEL_EPILOGUES if lv == "level" else EPILOGUES)


def split_ranges(k: int, bk: int, splits: int):
    """The [s_lo, s_hi) k-step range of each split, in split order:
    contiguous and balanced."""
    gk = cdiv(k, bk)
    return [(z * gk // splits, (z + 1) * gk // splits)
            for z in range(splits)]


def split_count(m: int, n: int, k: int, tiles: Sequence[int]) -> int:
    """Split-K ranges per output block: 1 when the gm x gn blocks reach
    `SPLIT_TARGET` CTAs; else the count that minimises the time in CTA
    k-steps, one CTA an SM: each wave of CTAs costs its longest range plus
    one k-step (the ring's fill and the epilogue), and the f32 partials of
    the live rows, written and read again, cost their bytes over the SMs in
    units of one k-step's B tile. Ties go to fewer ranges."""
    bm, bn, bk = tiles
    blocks = cdiv(m, bm) * cdiv(n, bn)
    ks = cdiv(k, bk)
    if blocks >= SPLIT_TARGET:
        return 1
    part = min(m, bm) * bn * 8 / (SMS * bk * bn * 2)

    def cost(s):
        return (cdiv(blocks * s, SMS) * (cdiv(ks, s) + 1)
                + (blocks * s * part if s > 1 else 0.0))

    return min(range(1, ks + 1), key=lambda s: (cost(s), s))


def _tma_walk(rows: int, cols: int, s_rows: int, s_cols: int
              ) -> Optional[bool]:
    """True if the (rows, cols) operand has unit-stride cols (rows s_rows
    elements apart), False for unit-stride rows (cols s_cols apart), None if
    TMA cannot read it: the other stride must be a multiple of 8 elements
    (16 bytes) and span the unit-stride dim."""
    if s_cols == 1 and s_rows % 8 == 0 and s_rows >= cols:
        return True
    if s_rows == 1 and s_cols % 8 == 0 and s_cols >= rows:
        return False
    return None


@functools.lru_cache(maxsize=4096)
def plan(m: int, n: int, k: int, *, dtype, level: str,
         chain: Tuple[str, ...] = (), act_grad: bool = False,
         a_strides: Sequence[int], b_strides: Sequence[int],
         aligned: bool = True, batched: bool = False,
         tiles: Optional[Sequence[int]] = None) -> Plan:
    """The instance, tiles and split count of an (M, K) x (K, N) call.

    ``level`` is the FT level, "off" with FT disabled; ``a_strides`` /
    ``b_strides`` the (row, column) element strides of A and B; ``aligned``
    whether both base pointers are 16-byte aligned. The tensor-core
    instance takes a bf16 2-D call at any level whose chain
    `sm90_chain` accepts, with A read along k or m and B along n or k (not
    both transposed) as `_tma_walk` allows; it runs at `SM90_TILES` (128
    rows for M > 64) with `split_count` ranges. Every other call runs on
    the SIMT kernel at `pick_tiles(M)`: `csrc/ft_gemm.cu` when
    `simt_compiled` (chain, level, act_grad) or the call is batched, else
    the chain instance ("simt_chain"). Explicit ``tiles`` pin the
    instance: tensor-core tiles raise ValueError for a call that instance
    cannot take. A pure function of its arguments, cached (a decode step
    plans the same few shapes hundreds of times). A chain longer than
    `CHAIN_CAP` raises NotImplementedError."""
    _check_chain_cap(chain)
    why = ""
    a_k = _tma_walk(m, k, *a_strides)
    b_n = _tma_walk(k, n, *b_strides)
    b_k = None if b_n is None else not b_n
    if batched:
        why = "a batched call (K5)"
    elif dtype != torch.bfloat16:
        why = f"dtype {dtype}"
    elif sm90_chain(chain) is None:
        why = (f"the epilogue chain {chain} (the tensor cores take an "
               f"optional bias then at most one activation; a residual, "
               f"another order or two or more activations run on the SIMT "
               f"kernels)")
    elif a_k is None or b_k is None or (a_k is False and b_k is True):
        why = (f"strides A {tuple(a_strides)}, B {tuple(b_strides)} (TMA "
               f"needs a unit-stride dim, the other stride a multiple of 8, "
               f"and not both operands transposed)")
    elif not aligned:
        why = "a base pointer not 16-byte aligned"
    if tiles is None:
        tiles = (SM90_TILES[0] if m > 64 else SM90_TILES[1]) if not why \
            else pick_tiles(m)
    tiles = tuple(tiles)
    if tiles in SM90_TILES:
        if why:
            raise ValueError(f"ft_gemm: the tensor-core tiles {tiles} do not "
                             f"take {why}")
        return Plan("sm90", tiles, split_count(m, n, k, tiles), a_k, b_k)
    if tiles not in TILES:
        return Plan("plain", tiles, reason=why)
    simt = batched or simt_compiled(chain, level, act_grad)
    return Plan("simt" if simt else "simt_chain", tiles, reason=why)


def _k5_walk(k: int, n: int, s_k: int, s_n: int) -> Optional[bool]:
    """True if K5's (K, N) operand B has unit-stride k (staged as [n][k]
    rows), False for unit-stride n, None if the 16-byte copies cannot read
    it: the other stride must be a multiple of 8 elements, unless that
    other dim is 1 (only its index 0 is read)."""
    if s_k == 1 and (s_n % 8 == 0 or n == 1):
        return True
    if s_n == 1 and (s_k % 8 == 0 or k == 1):
        return False
    return None


@functools.lru_cache(maxsize=4096)
def plan_k5(m: int, n: int, k: int, *, dtype,
            chain: Tuple[str, ...] = (), a_strides: Sequence[int],
            b_strides: Sequence[int], aligned: bool = True,
            tiles: Optional[Sequence[int]] = None) -> Plan:
    """The instance and tiles of a batched (…, M, K) x (…, K, N) call.

    ``a_strides`` / ``b_strides`` are the four element strides (two batch
    dims, then row and column; zeros for absent batch dims and for a
    shared B). The tensor-core instance takes a bf16 call of at most 16
    rows with any aux-free chain (`BatchedKernelSpec`) at any FT level
    ("off" included), A read along k and B along k or n (`_k5_walk`), every
    other stride a multiple of 8 elements and both bases 16-byte aligned;
    it runs at `BATCHED_SM90_TILES`. Every other call, and any call whose
    ``tiles`` pin the SIMT instance, runs on the SIMT kernel at
    `pick_tiles(M)`: `csrc/ft_gemm.cu` without a chain, the chain instance
    ("simt_chain") with one; tensor-core tiles raise ValueError for a call
    that instance cannot take. A chain longer than `CHAIN_CAP` raises
    NotImplementedError. Cached like `plan`."""
    _check_chain_cap(chain)
    why = ""
    sa0, sa1, sam, sak = a_strides
    sb0, sb1, sbk, sbn = b_strides
    b_k = _k5_walk(k, n, sbk, sbn)
    if dtype != torch.bfloat16:
        why = f"dtype {dtype}"
    elif m > BATCHED_SM90_TILES[0][0]:
        why = f"M = {m} rows (the instance takes at most 16)"
    elif (sak != 1 or (sam % 8 and m > 1) or b_k is None
          or any(x % 8 for x in (sa0, sa1, sb0, sb1))):
        why = (f"strides A {tuple(a_strides)}, B {tuple(b_strides)} (the "
               f"16-byte copies need A along k, B along k or n, and every "
               f"other stride a multiple of 8)")
    elif not aligned:
        why = "a base pointer not 16-byte aligned"
    elif tiles is not None and tuple(tiles) not in BATCHED_SM90_TILES:
        why = f"the pinned tiles {tuple(tiles)}"
    if tiles is None:
        tiles = pick_tiles(m) if why else BATCHED_SM90_TILES[0]
    tiles = tuple(tiles)
    if tiles in BATCHED_SM90_TILES:
        if why:
            raise ValueError(f"ft_gemm: the tensor-core tiles {tiles} do not "
                             f"take {why}")
        return Plan("sm90", tiles, b_kmajor=b_k)
    if tiles not in TILES:
        return Plan("plain", tiles, reason=why)
    return Plan("simt_chain" if chain else "simt", tiles, reason=why)


def plan_call(a: torch.Tensor, b: torch.Tensor, *, chain=(), ft=None,
              save_act_grad: bool = False, tiles=None) -> Plan:
    """`plan` of a call of `ft_gemm` on these operands, or `plan_k5` of a
    batched one."""
    level = ft_level(ft)
    if a.dim() > 2:
        sb = ((0, 0) + tuple(b.stride()))[-4:] if b.dim() > 2 \
            else (0, 0) + tuple(b.stride())
        return plan_k5(a.shape[-2], b.shape[-1], a.shape[-1],
                       dtype=a.dtype,
                       chain=tuple(chain),
                       a_strides=((0, 0) + tuple(a.stride()))[-4:],
                       b_strides=sb,
                       aligned=a.data_ptr() % 16 == 0
                       and b.data_ptr() % 16 == 0,
                       tiles=None if tiles is None else tuple(tiles))
    return plan(a.shape[-2], b.shape[-1], a.shape[-1], dtype=a.dtype,
                level=level, chain=tuple(chain), act_grad=save_act_grad,
                a_strides=tuple(a.stride()[-2:]),
                b_strides=tuple(b.stride()[-2:]),
                aligned=a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0,
                batched=a.dim() > 2,
                tiles=None if tiles is None else tuple(tiles))


def pick_tiles(m: int) -> Tuple[int, int, int]:
    """The tile configuration for an M-row problem: decode-shaped problems
    (M ≤ 16) take the short-wide tile, everything else the square one."""
    return TILES[1] if m <= 16 else TILES[0]


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _check_act_grad(chain: Tuple[str, ...], save_act_grad: bool) -> None:
    if save_act_grad and sum(not epilogues.get(n).linear
                             for n in chain) != 1:
        raise ValueError(f"act_grad needs exactly one nonlinear op in the "
                         f"chain, got {chain}")


def ft_level(ft: Optional[FTConfig]) -> str:
    """The FT level of a call: "off" with FT disabled."""
    return ft.level if (ft is not None and ft.enabled) else "off"


def _check_ft(ft: Optional[FTConfig], tiles: Sequence[int],
              kernel: str = "gemm") -> Tuple[bool, str, int]:
    """(checksums on, level, rows per checksum band) of a call of
    ``kernel`` (`spec.band_of`'s "gemm", "grouped" or "tgmm") at
    ``tiles``."""
    level = ft_level(ft)
    if level == "off":
        return False, "off", 0
    if level not in LEVELS:
        raise ValueError(f"unknown FT level {level!r}")
    validate(KernelSpec(ft_level=level), tiles, kernel)
    return True, level, (band_of(tiles, kernel) if level == "tile"
                         else tiles[0])


# ---------------------------------------------------------------------------
# shared locate / record step of the plain versions
# ---------------------------------------------------------------------------

def locate_record(d_col: torch.Tensor, d_row: torch.Tensor,
                  tau: torch.Tensor, k_el: torch.Tensor, corrects: bool,
                  rep: torch.Tensor, row_off, col_off, live=None):
    """Per-block verdicts from residuals d_col (…, C) and d_row (…, R):
    first argmax of each, detection (max residual > tau), the signed column
    residual at the located column as the magnitude, and the report update
    of the reference's `_record` (in place on rep (…, 8)). ``live`` (bool
    (…)) limits the update to blocks that ran this step. Returns
    (det, row, col, mag)."""
    acol, arow = torch.abs(d_col), torch.abs(d_row)
    col = torch.argmax(acol, dim=-1)
    row = torch.argmax(arow, dim=-1)
    resid = torch.maximum(acol.amax(-1), arow.amax(-1))
    det = resid > tau
    if live is not None:
        det = det & live
    mag = torch.where(det, torch.gather(d_col, -1, col[..., None])[..., 0],
                      torch.zeros_like(resid))
    upd = torch.ones_like(det) if live is None else live
    detf = det.float()
    rep[..., 0] += detf
    if corrects:
        rep[..., 1] += detf
    rep[..., 2] = torch.where(det, (row + row_off).float(), rep[..., 2])
    rep[..., 3] = torch.where(det, (col + col_off).float(), rep[..., 3])
    rep[..., 4] = torch.where(det, mag, rep[..., 4])
    rep[..., 5] = torch.where(upd, torch.maximum(rep[..., 5], resid),
                              rep[..., 5])
    rep[..., 6] = torch.where(upd, tau.expand_as(resid), rep[..., 6])
    rep[..., 7] = torch.where(upd, k_el.expand_as(resid), rep[..., 7])
    return det, row, col, mag


def locate_bands(d_col: torch.Tensor, d_row: torch.Tensor,
                 tau: torch.Tensor, k_el: torch.Tensor, corrects: bool,
                 rep: torch.Tensor, row_off, col_off, band: int, live=None):
    """`locate_record` over a band axis: residuals d_col (…, nb, C) and
    d_row (…, nb, band) of nb bands of one block give per-band verdicts,
    folded into rep (…, 8) as the reference's per-band `_record` calls in
    band order: det and corr add over the bands, row / col / mag are the
    last detecting band's, max_residual the max, tau and k overwritten.
    ``live`` (bool (…)) limits the update to blocks that ran this step.
    Returns (det, row, col, mag), each (…, nb), row local to its band."""
    nbands = d_col.shape[-2]
    acol, arow = torch.abs(d_col), torch.abs(d_row)
    col = torch.argmax(acol, dim=-1)
    row = torch.argmax(arow, dim=-1)
    resid = torch.maximum(acol.amax(-1), arow.amax(-1))
    det = resid > tau[..., None]
    if live is not None:
        det = det & live[..., None]
    mag = torch.where(det, torch.gather(d_col, -1, col[..., None])[..., 0],
                      torch.zeros_like(resid))
    ndet = det.float().sum(-1)
    rep[..., 0] += ndet
    if corrects:
        rep[..., 1] += ndet
    hit = det.any(-1)
    last = (nbands - 1) - torch.argmax(det.flip(-1).to(torch.int8), dim=-1)

    def pick(x):
        return torch.gather(x, -1, last[..., None])[..., 0]

    band_row = row + band * torch.arange(nbands, device=row.device)
    rep[..., 2] = torch.where(hit, (pick(band_row) + row_off).float(),
                              rep[..., 2])
    rep[..., 3] = torch.where(hit, (pick(col) + col_off).float(), rep[..., 3])
    rep[..., 4] = torch.where(hit, pick(mag), rep[..., 4])
    upd = torch.ones_like(hit) if live is None else live
    rep[..., 5] = torch.where(upd, torch.maximum(rep[..., 5],
                                                 resid.amax(-1)), rep[..., 5])
    rep[..., 6] = torch.where(upd, tau, rep[..., 6])
    rep[..., 7] = torch.where(upd, k_el.expand_as(tau), rep[..., 7])
    return det, row, col, mag


def merge_reports(reps: Sequence[torch.Tensor]) -> torch.Tensor:
    """The split-K report rule: the splits' reports (…, 8) merged in split
    order — det and corr add, row / col / mag from the last detection,
    max_residual the max, tau and k from the last split that verified (k
    above 0; the final verification that follows at "block" and "tile"
    overwrites them)."""
    out = torch.zeros_like(reps[0])
    for r in reps:
        hit = r[..., :1] > 0
        out[..., :2] += r[..., :2]
        out[..., 2:5] = torch.where(hit, r[..., 2:5], out[..., 2:5])
        out[..., 5] = torch.maximum(out[..., 5], r[..., 5])
        out[..., 6:] = torch.where(r[..., 7:] > 0, r[..., 6:], out[..., 6:])
    return out


def seu_draws(rng: Optional[Sequence[int]], ft: Optional[FTConfig], nb: int,
              gm: int, gn: int, gk: int, tiles: Sequence[int], batched: bool,
              device="cpu"):
    """The SEU every output block of a K1 (2-D) or K5 (``batched``) launch
    draws under the campaign triple ``rng``: (hit, step, row, col), each
    (nb, gm, gn), row and col local to the block, step a k-step of
    ``tiles``; None when no campaign is armed (no triple, enable 0, rate
    0, FT off). The uid is (slice·gm + i)·gn + j, the salt
    `seu.SALT_BATCHED` for a batched launch, else `seu.SALT_GEMM2D`."""
    if not seu_armed(rng, ft):
        return None
    bm, bn, _ = tiles
    uid = ((torch.arange(nb, device=device)[:, None, None] * gm
            + torch.arange(gm, device=device)[None, :, None]) * gn
           + torch.arange(gn, device=device)[None, None, :])
    salt = seu.SALT_BATCHED if batched else seu.SALT_GEMM2D
    return seu.draw(rng, salt, uid, gk, bm, bn, ft.inject_rate)


def seu_armed(rng, ft) -> bool:
    """Whether a launch under ``ft`` with the triple ``rng`` runs the
    stochastic hook: FT on, a triple with enable 1, a rate above 0."""
    return (ft is not None and ft.enabled and rng is not None
            and int(rng[0]) == 1 and ft.inject_rate > 0.0)


def seu_args(rng: Optional[Sequence[int]], ft: Optional[FTConfig],
             salt: int) -> Tuple[int, int, float, int]:
    """The hook's launch arguments (on, seed, rate, bit shift): the
    triple and the salt reduced on the host to the kernel's stream seed
    (`seu.block_seed`), so the kernel hashes only its block uid. All zero
    when no campaign is armed."""
    if not seu_armed(rng, ft):
        return (0, 0, 0.0, 0)
    seu.check(ft.inject_rate, ft.inject_bit_shift)
    return (1, seu.block_seed(rng, salt), float(ft.inject_rate),
            int(ft.inject_bit_shift))


# ---------------------------------------------------------------------------
# plain version
# ---------------------------------------------------------------------------

def ft_gemm_plain(a: torch.Tensor, b: torch.Tensor, *,
                  tiles: Sequence[int], chain: Tuple[str, ...] = (),
                  bias: Optional[torch.Tensor] = None,
                  residual: Optional[torch.Tensor] = None,
                  ft: Optional[FTConfig] = None,
                  inj: Optional[Sequence[int]] = None,
                  inj_mag: float = 0.0, save_act_grad: bool = False,
                  splits: int = 1, rng: Optional[Sequence[int]] = None
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The kernel's function in plain PyTorch, on the kernel's tile grid.

    a (M, K), or (*lead, M, K) with one or two leading batch dims; b (K, N),
    or (*lead, K, N) with a batched a. Returns (C, report) with C in a's
    dtype and report (gm, gn, 8) — (*lead, gm, gn, 8) when batched — or
    None with FT off. ``inj`` is the batched kernels' injection vector
    [enable, batch, row, col, k_step]: with enable = 1, ``inj_mag`` is added
    to the accumulator at global (row, col) on k-step k_step, in batch slice
    ``batch`` of the flattened leading dims (< 0: every slice). ``ft.level``
    picks the FT level, the "tile" level's band height is `band_of(tiles)`.
    With ``save_act_grad`` C is the pair (C, act_grad). ``splits``: the
    split-K ranges of each block's k-steps, verified alone (with the
    split's own elapsed k and maxima in tau) after each of their steps but
    the last ("inner": every step's Δ), then summed in split order, their
    reports merged (`merge_reports`) and, at "block" and "tile", the sum
    verified at k = K ("tile": each band against the sum of the splits'
    band checksums). ``rng`` is a
    campaign's triple (`flashft.encode_rng`): each block draws its SEU
    (`seu_draws`) and the hit lands on its step's Δ before the checksums,
    in every split and at every level."""
    ft_on, level, bh = _check_ft(ft, tiles)
    _check_act_grad(chain, save_act_grad)
    lead = tuple(a.shape[:-2])
    a3 = a.reshape((-1,) + tuple(a.shape[-2:]))
    b3 = b.reshape((-1,) + tuple(b.shape[-2:]))
    nb, m, k = a3.shape
    n = b3.shape[-1]
    bm, bn, bk = tiles
    gm, gn, gk = cdiv(m, bm), cdiv(n, bn), cdiv(k, bk)
    mp, np_, kp = gm * bm, gn * bn, gk * bk
    dev = a.device
    af = F.pad(a3.float(), (0, kp - k, 0, mp - m))
    bf = F.pad(b3.float(), (0, np_ - n, 0, kp - k))
    nbb = bf.shape[0]
    rep = colck = rowck = amax = bmax = None
    if ft_on:
        # Block and inner keep one band of bm rows; tile bm / band bands.
        nbands = bm // bh
        coef = torch.tensor(ft.rel_tau * F32EPS, dtype=torch.float32,
                            device=dev)
        bi = torch.arange(nb, device=dev)[:, None, None, None]
        ii = torch.arange(gm, device=dev)[None, :, None, None]
        jj = torch.arange(gn, device=dev)[None, None, :, None]
        tt = torch.arange(nbands, device=dev)

    def tau_at(k_el):
        return torch.clamp_min(coef * k_el * amax[:, :, None]
                               * bmax[:, None, :], 1e-30)

    def verify(x, col_ck, row_ck, k_el):
        """Verify, locate and (if the policy corrects) correct x (nb, mp,
        np) in place against its checksums, band by band."""
        blocks = x.view(nb, gm, nbands, bh, gn, bn)
        d_col = blocks.sum(3).permute(0, 1, 3, 2, 4) - col_ck
        d_row = (blocks.sum(5).permute(0, 1, 4, 2, 3)
                 - row_ck.reshape(nb, gm, gn, nbands, bh))
        det, row, col, mag = locate_bands(
            d_col, d_row, tau_at(k_el), k_el, ft.corrects, rep,
            ii[..., 0] * bm, jj[..., 0] * bn, bh)
        if ft.corrects:
            blocks.index_put_((bi, ii, tt, row, jj, col), -mag,
                              accumulate=True)

    hook = seu_draws(rng, ft, nb, gm, gn, gk, tiles, a.dim() > 2, dev) \
        if ft_on else None
    if hook is not None:
        h_hit, h_step, h_row, h_col = hook
        h_row = h_row + torch.arange(gm, device=dev)[None, :, None] * bm
        h_col = h_col + torch.arange(gn, device=dev)[None, None, :] * bn
    parts = []
    for s_lo, s_hi in split_ranges(k, bk, splits):
        # one split: k-steps [s_lo, s_hi) into its own accumulator,
        # checksums, maxima and report (one split: the whole k loop).
        acc = torch.zeros(nb, mp, np_, dtype=torch.float32, device=dev)
        if ft_on:
            colck = torch.zeros(nb, gm, gn, nbands, bn, device=dev)
            rowck = torch.zeros(nb, gm, gn, bm, device=dev)
            amax = torch.zeros(nb, gm, device=dev)
            bmax = torch.zeros(nbb, gn, device=dev)
            rep = torch.zeros(nb, gm, gn, REPORT_WIDTH, device=dev)
        for s in range(s_lo, s_hi):
            a_s = af[:, :, s * bk:(s + 1) * bk]          # (nb, mp, bk)
            b_s = bf[:, s * bk:(s + 1) * bk, :]          # (nbb, bk, np)
            delta = torch.matmul(a_s, b_s)
            if not ft_on:
                acc += delta
                continue
            if inj is not None and inj[0] == 1 and s == inj[4]:
                _, ib, ir, ic, _ = inj
                if 0 <= ir < mp and 0 <= ic < np_:
                    sl = slice(None) if ib < 0 else slice(ib, ib + 1)
                    delta[sl, ir, ic] += inj_mag
            if hook is not None:
                seu.land(delta, h_hit & (h_step == s), h_row, h_col,
                         ft.inject_bit_shift)
            asum = a_s.reshape(nb, gm * nbands, bh, bk).sum(2)  # e^T A / band
            ck_col = (torch.matmul(asum, b_s).view(nb, gm, nbands, gn, bn)
                      .permute(0, 1, 3, 2, 4))
            bsum = b_s.reshape(nbb, bk, gn, bn).sum(3)          # (nbb, bk, gn)
            ck_row = (torch.matmul(a_s, bsum).view(nb, gm, bm, gn)
                      .permute(0, 1, 3, 2))
            amax = torch.maximum(amax, a_s.abs().reshape(nb, gm, bm * bk)
                                 .amax(-1))
            bmax = torch.maximum(bmax, b_s.abs().reshape(nbb, bk, gn, bn)
                                 .amax((1, 3)))
            # k elapsed in this split
            k_el = torch.tensor(float(min((s + 1) * bk, k) - s_lo * bk),
                                device=dev)
            if level == "inner":
                # Δ alone against its own checksums; τ still takes the
                # elapsed k and the running max|A|, max|B| (emit.py:369-378).
                verify(delta, ck_col, ck_row, k_el)
                acc += delta
                continue
            acc += delta
            colck += ck_col
            rowck += ck_row
            if ft.verify == "step" and s != s_hi - 1:
                verify(acc, colck, rowck, k_el)
        parts.append((acc, colck, rowck, amax, bmax, rep))
    acc = parts[0][0]
    for p in parts[1:]:
        acc = acc + p[0]
    if ft_on and splits > 1:
        colck, rowck = parts[0][1], parts[0][2]
        for p in parts[1:]:
            colck, rowck = colck + p[1], rowck + p[2]
        amax = torch.stack([p[3] for p in parts]).amax(0)
        bmax = torch.stack([p[4] for p in parts]).amax(0)
        rep = merge_reports([p[5] for p in parts])

    # epilogue. block: the linear prefix folded into the checksums, final
    # verify, then the nonlinear suffix; tile: the final verify on the raw
    # accumulator, then the whole chain; inner: the whole chain.
    bias_p = res_p = None
    if bias is not None:
        bias_p = F.pad(bias.float().reshape(1, n), (0, np_ - n))  # (1, np)
    if residual is not None:
        res_p = F.pad(residual.float().reshape(1, m, n),
                      (0, np_ - n, 0, mp - m))                    # (1, mp, np)
    split = epilogues.fold_split(chain) if level == "block" else 0
    for name in chain[:split]:
        if name == "bias":
            acc = acc + bias_p
            colck = colck + float(bm) * bias_p.view(1, 1, gn, 1, bn)
            rowck = rowck + bias_p.view(gn, bn).sum(-1)[None, None, :, None]
        else:  # residual
            acc = acc + res_p
            blocks = res_p.view(1, gm, bm, gn, bn)
            colck = colck + blocks.sum(2)[..., None, :]
            rowck = rowck + blocks.sum(4).permute(0, 1, 3, 2)
    if level in ("block", "tile"):
        verify(acc, colck, rowck, torch.tensor(float(k), device=dev))
    aux = {"vector": bias_p, "tile": res_p}
    act_grad = None
    for name in chain[split:]:
        op = epilogues.get(name)
        if save_act_grad and not op.linear:
            act_grad = op.grad(acc)[:, :m, :n].to(a.dtype).reshape(
                lead + (m, n))
        acc = op.apply(acc, aux[op.aux] if op.aux else None)
    out = acc[:, :m, :n].to(a.dtype).reshape(lead + (m, n))
    if rep is not None:
        rep = rep.reshape(lead + (gm, gn, REPORT_WIDTH))
    return ((out, act_grad) if save_act_grad else out), rep


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------

def ft_gemm(a: torch.Tensor, b: torch.Tensor, *,
            chain: Tuple[str, ...] = (),
            bias: Optional[torch.Tensor] = None,
            residual: Optional[torch.Tensor] = None,
            ft: Optional[FTConfig] = None,
            inj: Optional[Sequence[int]] = None,
            inj_mag: float = 0.0,
            tiles: Optional[Sequence[int]] = None,
            save_act_grad: bool = False,
            rng: Optional[Sequence[int]] = None
            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """C = chain(A·B) with online ABFT at ``ft.level`` when ``ft`` is
    enabled; ``rng``, a campaign's triple, arms the stochastic SEU hook at
    ``ft.inject_rate`` (`seu_draws`).

    a (M, K) runs K1 (2-D); a (*lead, M, K) with one or two leading batch
    dims runs K5 (batched) with b (*lead, K, N) or a shared b (K, N). The
    kernel reads A and B through their strides, so permuted views are not
    copied. `plan_call` picks the instance, the tiles (``tiles`` pins them)
    and the split count. A CPU tensor runs `ft_gemm_plain` under that plan;
    a CUDA tensor launches the kernel or raises. Returns (C, report|None)
    as `ft_gemm_plain` does."""
    chain = tuple(chain)
    p = plan_call(a, b, chain=chain, ft=ft, save_act_grad=save_act_grad,
                  tiles=tiles)
    kw = dict(chain=chain, bias=bias, residual=residual, ft=ft, inj=inj,
              inj_mag=inj_mag, save_act_grad=save_act_grad, rng=rng)
    if a.device.type == "cpu":
        return ft_gemm_plain(a, b, tiles=p.tiles, splits=p.splits, **kw)
    if a.device.type != "cuda":
        raise ValueError(f"ft_gemm: unsupported device {a.device}")
    if p.instance == "sm90":
        return (_launch_batched_sm90 if a.dim() > 2 else _launch_sm90)(
            a, b, p, **kw)
    return _launch(a, b, tiles=p.tiles,
                   chain_instance=p.instance == "simt_chain", **kw)


def planned_plain(a: torch.Tensor, b: torch.Tensor, *,
                  tiles: Optional[Sequence[int]] = None, **kw
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """`ft_gemm_plain` under the plan `ft_gemm` follows for these operands
    (its tiles and split count), on any device: the comparison side of the
    kernel on the card."""
    p = plan_call(a, b, chain=kw.get("chain", ()), ft=kw.get("ft"),
                  save_act_grad=kw.get("save_act_grad", False), tiles=tiles)
    return ft_gemm_plain(a, b, tiles=p.tiles, splits=p.splits, **kw)


def _launch_sm90(a, b, p: Plan, *, chain, bias, residual, ft, inj, inj_mag,
                 save_act_grad, rng):
    ft_on, level, _ = _check_ft(ft, p.tiles)
    _check_act_grad(chain, save_act_grad)
    build.check_device(a)
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"ft_gemm: bad ranks {tuple(a.shape)} x "
                         f"{tuple(b.shape)}")
    m, k = a.shape
    n = b.shape[1]
    if b.shape[0] != k or b.device != a.device or b.dtype != a.dtype:
        raise ValueError(f"ft_gemm: operands {tuple(a.shape)} "
                         f"{a.dtype} x {tuple(b.shape)} {b.dtype} do not "
                         f"match")
    has_bias, act = sm90_chain(chain)
    if has_bias != (bias is not None) or residual is not None:
        raise ValueError(f"ft_gemm: chain {chain} and aux operands disagree")
    if bias is not None and (bias.numel() != n or not bias.is_contiguous()
                             or bias.dtype != a.dtype
                             or bias.device != a.device):
        raise ValueError(f"ft_gemm: bias must be a contiguous ({n},) "
                         f"{a.dtype} tensor beside the operands")
    bm, bn, _ = p.tiles
    gm, gn = cdiv(m, bm), cdiv(n, bn)
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    act_grad = torch.empty_like(out) if save_act_grad else None
    rep = (torch.empty((gm, gn, REPORT_WIDTH), dtype=torch.float32,
                       device=a.device) if ft_on else None)
    ws = (torch.empty(p.splits * (gm * bm * gn * bn + gm * gn * SPLIT_RECORD),
                      dtype=torch.float32, device=a.device)
          if p.splits > 1 else None)
    # A 2-D call is batch slice 0: batch -1 (every slice) or 0 lands.
    on = ft_on and inj is not None and inj[0] == 1 and inj[1] in (-1, 0)
    _, _, row, col, k_step = inj if on else (0, 0, 0, 0, 0)
    # FT off and "block": ft_gemm_sm90.cu; "tile" and "inner":
    # ft_gemm_level_sm90.cu
    code = SM90_LEVELS[level if ft_on else "off"]
    kernel = FT_GEMM_LEVEL_SM90 if code >= SM90_LEVELS["tile"] else FT_GEMM_SM90
    kernel(a.data_ptr(), b.data_ptr(),
           None if bias is None else bias.data_ptr(), out.data_ptr(),
           None if act_grad is None else act_grad.data_ptr(),
           None if rep is None else rep.data_ptr(),
           None if ws is None else ws.data_ptr(),
           m, n, k, a.stride(0) if p.a_kmajor else a.stride(1),
           b.stride(1) if p.b_kmajor else b.stride(0),
           int(p.a_kmajor), int(p.b_kmajor), bm, p.splits,
           code,
           act, int(ft_on and ft.verify == "step"),
           int(ft_on and ft.corrects),
           ft.rel_tau * F32EPS if ft_on else 0.0,
           int(on), row, col, k_step, float(inj_mag) if on else 0.0,
           *seu_args(rng, ft, seu.SALT_GEMM2D),
           torch.cuda.current_stream(a.device).cuda_stream)
    return ((out, act_grad) if save_act_grad else out), rep


def _launch_batched_sm90(a, b, p: Plan, *, chain, bias, residual, ft, inj,
                         inj_mag, save_act_grad, rng):
    ft_on, level, _ = _check_ft(ft, p.tiles)
    build.check_device(a)
    shared = b.dim() == 2
    if a.dim() not in (3, 4) or not (shared or b.dim() == a.dim()):
        raise ValueError(f"ft_gemm: bad ranks {tuple(a.shape)} x "
                         f"{tuple(b.shape)}")
    lead = tuple(a.shape[:-2])
    m, k = a.shape[-2:]
    n = b.shape[-1]
    if (b.shape[-2] != k or (not shared and tuple(b.shape[:-2]) != lead)
            or b.device != a.device or b.dtype != a.dtype):
        raise ValueError(f"ft_gemm: operands {tuple(a.shape)} {a.dtype} x "
                         f"{tuple(b.shape)} {b.dtype} do not match")
    if (bias is not None or residual is not None or save_act_grad
            or any(x not in SM90_ACTS for x in chain)):
        raise ValueError(f"ft_gemm: the batched tensor-core instance takes "
                         f"an aux-free chain of activations, got {chain}")
    nb0, nb1 = ((1, 1) + lead)[-2:]
    sa = ((0, 0) + a.stride())[-4:]
    sb = (0, 0) + b.stride() if shared else ((0, 0) + b.stride())[-4:]
    out = torch.empty(lead + (m, n), dtype=a.dtype, device=a.device)
    rep = (torch.empty(lead + (1, cdiv(n, p.tiles[1]), REPORT_WIDTH),
                       dtype=torch.float32, device=a.device)
           if ft_on else None)
    inj = tuple(inj) if (ft_on and inj is not None) else (0, 0, 0, 0, 0)
    FT_GEMM_BATCHED_SM90(
        a.data_ptr(), b.data_ptr(), out.data_ptr(),
        None if rep is None else rep.data_ptr(), nb0, nb1, m, n, k,
        sa[0], sa[1], sa[2], sb[0], sb[1], sb[3] if p.b_kmajor else sb[2],
        int(p.b_kmajor), int(ft_on), LEVELS.get(level, 0), chain_code(chain),
        len(chain), int(ft_on and ft.verify == "step"),
        int(ft_on and ft.corrects),
        ft.rel_tau * F32EPS if ft_on else 0.0, *inj, float(inj_mag),
        *seu_args(rng, ft, seu.SALT_BATCHED),
        torch.cuda.current_stream(a.device).cuda_stream)
    return out, rep


def _launch(a, b, *, chain, bias, residual, ft, inj, inj_mag, tiles,
            save_act_grad, rng, chain_instance=False):
    if tiles not in TILES:
        raise ValueError(f"ft_gemm: tiles {tiles} are not compiled; "
                         f"choose one of {TILES}")
    ft_on, level, _ = _check_ft(ft, tiles)
    _check_act_grad(chain, save_act_grad)
    build.check_device(a)
    batched = a.dim() > 2
    shared = b.dim() == 2
    if a.dim() not in (2, 3, 4) or not (shared or b.dim() == a.dim()):
        raise ValueError(f"ft_gemm: bad ranks {tuple(a.shape)} x "
                         f"{tuple(b.shape)}")
    lead = tuple(a.shape[:-2])
    m, k = a.shape[-2:]
    n = b.shape[-1]
    if b.shape[-2] != k or (not shared and tuple(b.shape[:-2]) != lead):
        raise ValueError(f"ft_gemm: shapes {tuple(a.shape)} x "
                         f"{tuple(b.shape)} do not match")
    if a.dtype not in DTYPE_CODES or b.dtype != a.dtype:
        raise TypeError(f"ft_gemm: the kernel takes float32 or bfloat16 "
                        f"operands of one dtype, got {a.dtype}, {b.dtype}")
    if not chain_instance and not simt_compiled(chain, level, save_act_grad):
        raise NotImplementedError(f"ft_gemm: the kernel has no instance for "
                                  f"the epilogue chain {chain} at FT level "
                                  f"{level!r}")
    aux = [x for x in (bias, residual) if x is not None]
    if batched and aux:
        raise ValueError("ft_gemm: bias/residual are 2-D features")
    if ("bias" in chain) != (bias is not None) or (
            ("residual" in chain) != (residual is not None)):
        raise ValueError(f"ft_gemm: chain {chain} and aux operands disagree")
    if bias is not None and bias.numel() != n:
        raise ValueError(f"ft_gemm: bias has {bias.numel()} elements, "
                         f"expected {n}")
    if residual is not None and tuple(residual.shape) != (m, n):
        raise ValueError(f"ft_gemm: residual {tuple(residual.shape)}, "
                         f"expected {(m, n)}")
    for x in (a, b, *aux):
        if x.device != a.device or x.dtype != a.dtype:
            raise ValueError("ft_gemm: operands must share device and dtype")
    for x in aux:
        if not x.is_contiguous():
            raise ValueError("ft_gemm: bias and residual must be contiguous")
    bm, bn, _ = tiles
    gm, gn = cdiv(m, bm), cdiv(n, bn)
    # Two batch dims (b0, b1) with their strides; absent ones have extent 1.
    nb0, nb1 = ((1, 1) + lead)[-2:]
    sa = ((0, 0) + a.stride())[-4:]
    sb = (0, 0) + b.stride() if shared else ((0, 0) + b.stride())[-4:]
    # Offsets within one slice are 64-bit; the strides themselves are int32.
    if max(sa[2:] + sb[2:]) >= 2 ** 31:
        raise ValueError(f"ft_gemm: row / column strides {sa[2:]}, {sb[2:]} "
                         f"exceed int32")
    # The walk of the tile loads (LAYOUT in csrc/ft_gemm.cu): along the unit-
    # stride k dim of a transposed B (w.T, the K cache of decode attention)
    # or m dim of a transposed A (x.T), compiled for the plain chain at
    # every level; row-major otherwise.
    layout = 0
    if not chain:
        if sb[2] == 1 and sb[3] != 1:
            layout = 1
        elif sa[2] == 1 and sa[3] != 1:
            layout = 2
    out = torch.empty(lead + (m, n), dtype=a.dtype, device=a.device)
    act_grad = torch.empty_like(out) if save_act_grad else None
    rep = (torch.empty(lead + (gm, gn, REPORT_WIDTH), dtype=torch.float32,
                       device=a.device) if ft_on else None)
    inj = tuple(inj) if (ft_on and inj is not None) else (0, 0, 0, 0, 0)
    if chain_instance:
        # the runtime op list and its linear prefix (the reference's fold)
        kernel = FT_GEMM_BATCHED_CHAIN if batched else FT_GEMM_CHAIN
        codes = (chain_code(chain), len(chain), epilogues.fold_split(chain),
                 TILES.index(tiles))
    else:
        kernel = FT_GEMM_BATCHED if batched else FT_GEMM_2D_SIMT
        codes = (EPILOGUES[chain], TILES.index(tiles), layout)
    kernel(a.data_ptr(), b.data_ptr(),
           None if bias is None else bias.data_ptr(),
           None if residual is None else residual.data_ptr(),
           out.data_ptr(), None if rep is None else rep.data_ptr(),
           None if act_grad is None else act_grad.data_ptr(),
           nb0, nb1, m, n, k, *sa, *sb,
           DTYPE_CODES[a.dtype], int(ft_on), LEVELS.get(level, 0), *codes,
           int(ft_on and ft.verify == "step"), int(ft_on and ft.corrects),
           ft.rel_tau * F32EPS if ft_on else 0.0,
           *inj, inj_mag,
           *seu_args(rng, ft, seu.SALT_BATCHED if batched else seu.SALT_GEMM2D),
           torch.cuda.current_stream(a.device).cuda_stream)
    return ((out, act_grad) if save_act_grad else out), rep
