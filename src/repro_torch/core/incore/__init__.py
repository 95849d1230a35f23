"""In-core execution modeling — the replaceable IACA analog (paper §2.5).

A copy of ``repro.core.incore`` without the TPU variant of ``"simple"``:

* :mod:`~repro_torch.core.incore.ir` — the ISA-neutral **op-stream IR**
  the loop frontends lower into (op kind, operand width, dependence
  edges, loop-carried distances);
* :mod:`~repro_torch.core.incore.ports` — the ``"ports"`` model: a
  vectorized **port scheduler** driven by the machine file's ``ports:``
  table, reporting per-port occupation, the throughput bound and the
  dependence-chain latency bound;
* :mod:`~repro_torch.core.incore.simple` — the ``"simple"`` model: the
  machine-file heuristic, the default;
* :mod:`~repro_torch.core.incore.registry` — the :class:`InCoreModel` ABC
  and :data:`INCORE_REGISTRY`, through which ECM, Roofline, sessions and
  compiled sweep plans resolve models by name.

Every model returns the same :class:`InCoreResult`; results are
structure-only (bound constants never enter).
"""
from .ir import (KIND_CODE, KINDS, CarriedDep, OpStream,  # noqa: F401
                 lower_kernel, synthetic_stream)
from .ports import (PortSchedulerModel, naive_schedule,  # noqa: F401
                    schedule)
from .registry import (INCORE_REGISTRY, InCoreModel, analyze,  # noqa: F401
                       register_incore, resolve_incore)
from .result import InCoreResult  # noqa: F401
from .simple import (SimpleInCoreModel, analyze_x86,  # noqa: F401
                     applicable_peak, peak_performance)
