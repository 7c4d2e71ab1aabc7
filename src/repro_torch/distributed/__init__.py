"""Multi-device substrate of the torch port: logical-axis rules, the
device mesh, per-param axis specs and their DTensor placements
(``sharding``), the per-rank cost counter (``cost``) and a rank launcher
(``spawn``)."""
from .sharding import (
    axis_rules,
    current_mesh,
    current_rules,
    distribute_tree,
    gather_tree,
    logical_constraint,
    make_decode_rules,
    make_mesh,
    make_train_rules,
    named_sharding_tree,
    param_pspecs,
    placements_for,
    use_mesh,
)
from .spawn import run_ranks

__all__ = [
    "axis_rules", "current_mesh", "current_rules", "make_decode_rules",
    "make_mesh", "make_train_rules", "param_pspecs", "use_mesh", "run_ranks",
    "distribute_tree", "gather_tree", "logical_constraint",
    "named_sharding_tree", "placements_for",
]
