"""Multi-device substrate of the torch port: logical-axis rules, the
device mesh, per-param axis specs (``sharding``) and a rank launcher
(``spawn``)."""
from .sharding import (
    axis_rules,
    current_mesh,
    current_rules,
    make_decode_rules,
    make_mesh,
    make_train_rules,
    param_pspecs,
    use_mesh,
)
from .spawn import run_ranks

__all__ = [
    "axis_rules", "current_mesh", "current_rules", "make_decode_rules",
    "make_mesh", "make_train_rules", "param_pspecs", "use_mesh", "run_ranks",
]
