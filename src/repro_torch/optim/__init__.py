"""The port's optimizer: AdamW with fp32 masters and optional int8 state,
and the LR schedule (counterpart of ``repro.optim``)."""
from .adamw import OptConfig, adamw_init, adamw_update, global_norm  # noqa: F401
from .schedule import cosine_schedule  # noqa: F401
