"""Collective schedules of the port (counterpart of ``repro.core``'s
``scheduler`` and ``overlap``).  The simulator and its cost model are not
copied: a :class:`CollectivePlan` comes in as JSON or as fields."""
from .scheduler import CollectivePlan

__all__ = ["CollectivePlan"]
