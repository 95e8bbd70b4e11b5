"""Halo Processor (paper §5) on the port's engines: event-driven
execution over heterogeneous CPU/GPU workers, with the discrete-event
simulated backend (``SimulatedProcessor``, ``OnlineSimulator``,
``OpWiseSimulator``: paper-scale numbers from the cost model, no card)
and the real backend (PyTorch models on the card behind
continuous-batching engines, and minidb).  ``ProcessorSession``
(DESIGN.md §10) is the streaming entry point: queries submitted mid-run
graft into the running mega-DAG.

A copy of the JAX package's ``repro.runtime`` package module, with the
import prefix ``repro.`` read as ``repro_torch.``.
"""
from repro_torch.runtime.events import RunReport, TaskRecord
from repro_torch.runtime.faults import (FaultInjector, FaultPlan,
                                        TransientToolError)
from repro_torch.runtime.jobstore import CheckpointError, JobStore
from repro_torch.runtime.opwise import OpWiseSimulator
from repro_torch.runtime.simulator import SimulatedProcessor, OnlineSimulator
from repro_torch.runtime.session import (ProcessorConfig, ProcessorSession,
                                         QueryHandle)
from repro_torch.runtime.processor import RealProcessor
from repro_torch.runtime.replan import OnlineOptimizer
from repro_torch.runtime.migrate import KVMigrator

__all__ = ["RunReport", "TaskRecord", "SimulatedProcessor",
           "OnlineSimulator", "RealProcessor", "OpWiseSimulator",
           "OnlineOptimizer", "KVMigrator", "ProcessorConfig",
           "ProcessorSession", "QueryHandle", "JobStore",
           "CheckpointError", "FaultPlan", "FaultInjector",
           "TransientToolError"]
