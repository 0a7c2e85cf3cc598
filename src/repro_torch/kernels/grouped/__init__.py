"""The grouped FT-GEMM subsystem of the MoE layer (counterpart of
`repro.kernels.grouped`): the group-sorted buffer layout and the dispatch
of the grouped GEMM (K7) and the grouped transpose GEMM (K8)."""
from .dispatch import (grouped_buffer_call, grouped_matmul_rows,
                       group_counts_from_metadata, plan_grouped, plan_tgmm,
                       tgmm_buffer_call, tgmm_matmul_rows)
from .layout import (GroupLayout, buffer_rows, gather_rows, make_layout,
                     scatter_rows)

__all__ = ["GroupLayout", "buffer_rows", "make_layout", "scatter_rows",
           "gather_rows", "plan_grouped", "grouped_buffer_call",
           "grouped_matmul_rows", "group_counts_from_metadata",
           "tgmm_buffer_call", "plan_tgmm", "tgmm_matmul_rows"]
