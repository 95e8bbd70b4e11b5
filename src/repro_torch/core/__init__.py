"""Halo core — the paper's contribution (parser → optimizer → processor).

Public API:

    from repro_torch.core import (
        parse_workflow, consolidate, CostModel, EpochDPSolver,
        SolverConfig, SystemState, ExecutionPlan,
    )

    graph = parse_workflow(workflow_dict)          # §3 Parser
    batch = consolidate(graph, bindings)           # cross-query consolidation
    mega  = consolidate_multi([(graph_a, binds_a),  # cross-TEMPLATE mega-DAG
                               (graph_b, binds_b)])  # (DESIGN.md §8.1)
    cm    = CostModel(graph, HARDWARE["h200"], models, ...)
    plan  = EpochDPSolver(graph.llm_dag(), cm,
                          SolverConfig(num_workers=3)).solve()   # §4
    # runtime execution: repro_torch.runtime.Processor                  # §5

A copy of the JAX package's module of the same name, with the import prefix
``repro.`` read as ``repro_torch.``; ``tests/test_torch_copies.py`` holds
the two equal.
"""
from repro_torch.core.coalesce import CoalesceTable, canonical_signature
from repro_torch.core.consolidate import (
    ConsolidatedGraph, MultiConsolidatedGraph, consolidate, consolidate_multi,
)
from repro_torch.core.cost_model import (
    A100, H100, H200, HARDWARE, PAPER_MODELS, TPU_V5E, CostModel,
    EpochWeights, HardwareCalibration, HardwareProfile, LLMProfile,
    OperatorProfiler, profile_from_config,
)
from repro_torch.core.graphspec import GraphSpec, LLMDag, NodeSpec, NodeType
from repro_torch.core.optimality import optimality_score
from repro_torch.core.oracle import BranchAndBoundOracle
from repro_torch.core.parser import parse_workflow, render, static_signature
from repro_torch.core.plan import Epoch, ExecutionPlan
from repro_torch.core.schedulers import (
    SCHEDULERS, heft_plan, opwise_plan, random_plan, round_robin_plan,
)
from repro_torch.core.solver import EpochDPSolver, SolverConfig
from repro_torch.core.state import SystemState, WorkerContext

__all__ = [
    "CoalesceTable", "canonical_signature", "ConsolidatedGraph",
    "MultiConsolidatedGraph", "consolidate", "consolidate_multi",
    "CostModel", "EpochWeights", "HardwareCalibration",
    "HardwareProfile",
    "LLMProfile", "OperatorProfiler", "profile_from_config", "HARDWARE",
    "PAPER_MODELS", "H200", "H100", "A100", "TPU_V5E", "GraphSpec",
    "LLMDag", "NodeSpec", "NodeType", "optimality_score",
    "BranchAndBoundOracle", "parse_workflow", "render", "static_signature",
    "Epoch", "ExecutionPlan", "SCHEDULERS", "heft_plan", "opwise_plan",
    "random_plan", "round_robin_plan", "EpochDPSolver", "SolverConfig",
    "SystemState", "WorkerContext",
]
