"""The port's checkpoint store (counterpart of ``repro.ckpt``)."""
from .store import AsyncSaver, latest_step, restore, save  # noqa: F401
