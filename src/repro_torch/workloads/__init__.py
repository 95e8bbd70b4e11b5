"""Paper workloads: minidb (PostgreSQL stand-in), synthetic datasets,
tool operators, the W1–W6 / W+ workflow library (Table 3), and the
data-scale binding enumerators (DESIGN.md §12.1).

A copy of the JAX package's module of the same name, with the import prefix
``repro.`` read as ``repro_torch.``; ``tests/test_torch_copies.py`` holds
the two equal.
"""
from repro_torch.workloads.enumerators import (build_enumerated_workload,
                                               enumerate_csv, enumerate_sql,
                                               enumerate_table)
from repro_torch.workloads.library import (MIXED_PARTS, WORKFLOWS, build_graph,
                                           build_mixed_workload, build_workload)
from repro_torch.workloads.minidb import MiniDB
from repro_torch.workloads.tools import ToolRuntime

__all__ = ["MIXED_PARTS", "WORKFLOWS", "build_graph",
           "build_mixed_workload", "build_workload",
           "build_enumerated_workload", "enumerate_csv", "enumerate_sql",
           "enumerate_table", "MiniDB", "ToolRuntime"]
