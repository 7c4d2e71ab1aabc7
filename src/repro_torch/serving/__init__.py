"""Request-level serving of the torch port: page pool, prefix index,
admission scheduler and the continuous-batching engine.  ``pages`` and
``scheduler`` are numpy/stdlib copies of the reference's modules."""
from .engine import ServingEngine
from .pages import NULL_PAGE, PagePool, PrefixIndex
from .scheduler import Request, RequestStatus, Scheduler, TERMINAL_STATUSES

__all__ = ["ServingEngine", "PagePool", "PrefixIndex", "NULL_PAGE",
           "Request", "RequestStatus", "Scheduler", "TERMINAL_STATUSES"]
