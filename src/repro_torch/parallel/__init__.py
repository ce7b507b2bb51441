"""Sharding of the port: the reference's logical rules (``sharding``) and
FSDP over a ``launch.mesh.Mesh`` with explicit collectives (``fsdp``)."""
from .sharding import (WorkloadKind, batch_pspec, cache_pspecs, fit_pspec,
                       fit_tree, param_pspecs, placements, rules_for)

__all__ = ["WorkloadKind", "batch_pspec", "cache_pspecs", "fit_pspec",
           "fit_tree", "param_pspecs", "placements", "rules_for"]
