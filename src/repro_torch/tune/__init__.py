"""Predict → measure → calibrate on the card: the model-driven autotuner
(counterpart of ``repro.tune``; the flash-attention family) and the
stencil case study's per-shape prediction, timing and tile sweep."""
from .calibrate import (apply_calibration, derive_calibration,
                        machine_yaml_path, prediction_error)
from .measure import (TimedRun, measure_candidate, robust_median,
                      time_closure, time_cuda)
from .report import CandidateOutcome, TuneReport
from .space import (SPACE_REGISTRY, Candidate, CandidateSpace, Prediction,
                    register_space, resolve_space)
from .tuner import tune

__all__ = [
    "Candidate", "CandidateOutcome", "CandidateSpace", "Prediction",
    "SPACE_REGISTRY", "TimedRun", "TuneReport", "apply_calibration",
    "derive_calibration", "machine_yaml_path", "measure_candidate",
    "prediction_error", "register_space", "resolve_space",
    "robust_median", "time_closure", "time_cuda", "tune",
]
