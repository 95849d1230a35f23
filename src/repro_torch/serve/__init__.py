from .engine import BatchedServer, Engine, Request, make_caches  # noqa: F401
