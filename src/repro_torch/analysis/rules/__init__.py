"""Pluggable lint rules of the port's analyzer.

Each module defines one `Rule` subclass and registers it with
`@register`.  To add a rule: subclass `repro_torch.analysis.lint.Rule`,
set a unique kebab-case `name` and one-line `doc`, implement
`check(index) -> Iterable[Finding]`, decorate with `@register`, and
import the module here.  Fixture-based tests live in
`tests/test_torch_analysis.py` — every rule must come with at least one
snippet it fires on and one it stays silent on.
"""
from __future__ import annotations

from typing import Dict, List, Type

from ..lint import Rule

_REGISTRY: Dict[str, Type[Rule]] = {}


def register(cls: Type[Rule]) -> Type[Rule]:
    assert cls.name and cls.name not in _REGISTRY, f"bad rule registration: {cls}"
    _REGISTRY[cls.name] = cls
    return cls


def all_rules() -> List[Rule]:
    # Imports deferred so `register` decorators run exactly once.
    from . import host_sync, kernels, prng, recompile  # noqa: F401

    return [cls() for _, cls in sorted(_REGISTRY.items())]


def rule_names() -> List[str]:
    from . import host_sync, kernels, prng, recompile  # noqa: F401

    return sorted(_REGISTRY)
