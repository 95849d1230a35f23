"""Analysis-as-a-service (a copy of ``repro.service``): a disk-backed
result store, an :class:`AnalysisService` front with single-flight
request coalescing and batch APIs, and a sharded sweep worker pool.

    from repro_torch.service import AnalysisService

    svc = AnalysisService(cache_dir="build/cache")
    res = svc.analyze("stencil_3d7pt.c", "H100", constants={"M": 130,
                                                            "N": 100})
    grid = svc.sweep("stencil_3d7pt.c", "H100", "N", range(100, 1100),
                     constants={"M": 300}, workers=4)

Results are pure functions of (kernel structure, machine contents,
model, predictor, in-core model, sim params); the store keys on exactly
that, so any process pointed at the same cache root — CLI runs, service
replicas, sweep workers — shares one warm cache.
"""
from .service import (AnalysisRequest, AnalysisServer, AnalysisService,
                      ServiceStats)
from .store import SCHEMA_VERSION, ResultStore, StoreStats
from .workers import sweep_sharded

__all__ = [
    "AnalysisRequest", "AnalysisServer", "AnalysisService", "ServiceStats",
    "SCHEMA_VERSION", "ResultStore", "StoreStats", "sweep_sharded",
]
