"""Request-level serving of the torch port: page pool, prefix index,
admission scheduler, adaptive chunk policy, fault injector, the CUDA
graphs of the decode chunk and the admission prefill and the
continuous-batching engine.
``pages``, ``scheduler``, ``slo`` and ``faults`` are numpy/stdlib copies
of the reference's modules."""
from .engine import ServingEngine
from .faults import (Fault, FaultInjector, InjectedFault, alloc_failure,
                     chunk_exception, index_corruption, nan_logit)
from .graphs import GraphFailure, PackedGraphs
from .pages import NULL_PAGE, PagePool, PrefixIndex
from .scheduler import Request, RequestStatus, Scheduler, TERMINAL_STATUSES
from .slo import DEFAULT_LEVELS, AdaptiveChunkPolicy, ChunkSignals, percentiles

__all__ = ["ServingEngine", "PagePool", "PrefixIndex", "NULL_PAGE",
           "Request", "RequestStatus", "Scheduler", "TERMINAL_STATUSES",
           "Fault", "FaultInjector", "InjectedFault", "nan_logit",
           "alloc_failure", "index_corruption", "chunk_exception",
           "AdaptiveChunkPolicy", "ChunkSignals", "DEFAULT_LEVELS",
           "percentiles", "PackedGraphs", "GraphFailure"]
