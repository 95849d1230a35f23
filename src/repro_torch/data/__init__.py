"""The port's input pipeline (counterpart of ``repro.data``)."""
from .pipeline import SyntheticLM, Prefetcher  # noqa: F401
