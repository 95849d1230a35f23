"""``python -m repro_torch`` — see :mod:`repro_torch.cli`."""
from .cli import main

if __name__ == "__main__":
    raise SystemExit(main())
