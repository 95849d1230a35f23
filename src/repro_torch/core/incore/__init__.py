"""In-core execution modeling — the replaceable IACA analog (paper §2.5).

The port carries the registry and the ``"simple"`` machine-file heuristic;
every model returns the same :class:`InCoreResult`.
"""
from .registry import (INCORE_REGISTRY, InCoreModel, analyze,  # noqa: F401
                       register_incore, resolve_incore)
from .result import InCoreResult  # noqa: F401
from .simple import (SimpleInCoreModel, analyze_x86,  # noqa: F401
                     applicable_peak, peak_performance)
