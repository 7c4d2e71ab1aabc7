"""recompile-hazard rule: call patterns that capture or load again.

In the port a "recompile" is a new CUDA-graph capture (one per engine per
decode-chunk ``(ticks, sampled)`` and per admission-prefill ``(L, start,
guard)`` variant, ``serving/graphs.py``) or a kernel library
(re)load (``kernels/_build.library``).  Four ways code silently pays one
per call:

* a ``torch.cuda.CUDAGraph()``, ``torch.cuda.graph(...)`` or
  ``PackedGraphs(...)`` built inside a loop, or a ``PackedGraphs(...)``
  invoked at once (``PackedGraphs(fn, n, dev)(x, 4, False)``) — fresh
  graphs, and a fresh capture, each time;
* an unhashable literal (list/dict/set) or a fresh ``lambda`` passed as a
  variant key (``ticks``, ``sampled``) or a static keyword of a captured
  function — a cache miss (or a TypeError) per call;
* a static keyword bound to a name that is reassigned inside the
  enclosing loop — one capture per distinct value, which is a deliberate
  bucketing strategy at best (baseline it with a note) and a capture
  storm at worst;
* ``_build.library(...)`` or ``ctypes.CDLL(...)`` called in a loop with
  a name that changes each iteration.

Static positions are resolved from the project-wide registry of captured
functions (``ProjectIndex.jits_by_name``).
"""
from __future__ import annotations

import ast
from typing import Iterable, List, Set, Tuple

from ..lint import (
    Finding,
    FunctionInfo,
    JitInfo,
    ProjectIndex,
    Rule,
    call_base_name,
    dotted_name,
    is_graph_builder,
    is_graph_context,
)
from . import register

_UNHASHABLE = (ast.List, ast.Dict, ast.Set, ast.ListComp, ast.DictComp, ast.SetComp, ast.GeneratorExp)
_GRAPH_OBJECTS = ("torch.cuda.CUDAGraph", "cuda.CUDAGraph", "CUDAGraph")
_LIB_LOADERS = ("library", "CDLL")


def _static_args_at_call(call: ast.Call, ji: JitInfo) -> List[Tuple[str, ast.AST]]:
    """(static-param-label, value-expr) pairs bound at this call site."""
    out: List[Tuple[str, ast.AST]] = []
    static_names = set(ji.static_argnames)
    for i in ji.static_argnums:
        if i < len(ji.params):
            static_names.add(ji.params[i])
    for i, arg in enumerate(call.args):
        label = ji.params[i] if i < len(ji.params) else f"arg{i}"
        if i in ji.static_argnums or label in static_names:
            out.append((label, arg))
    for kw in call.keywords:
        if kw.arg is not None and kw.arg in static_names:
            out.append((kw.arg, kw.value))
    return out


def _loop_assigned_names(loop: ast.AST) -> Set[str]:
    names: Set[str] = set()

    def mark(t: ast.AST) -> None:
        if isinstance(t, ast.Name):
            names.add(t.id)
        elif isinstance(t, (ast.Tuple, ast.List)):
            for e in t.elts:
                mark(e)
        elif isinstance(t, ast.Starred):
            mark(t.value)

    for node in ast.walk(loop):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                mark(t)
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            mark(node.target)
        elif isinstance(node, (ast.For, ast.AsyncFor)):
            mark(node.target)
    return names


def _builds_graph(node: ast.Call) -> bool:
    return (is_graph_builder(node) or is_graph_context(node)
            or dotted_name(node.func) in _GRAPH_OBJECTS)


def _loads_library(node: ast.Call) -> bool:
    name = dotted_name(node.func)
    return call_base_name(node) in _LIB_LOADERS and name in (
        "library", "_build.library", "CDLL", "ctypes.CDLL")


@register
class RecompileHazardRule(Rule):
    name = "recompile-hazard"
    doc = (
        "CUDA graphs built in a loop or PackedGraphs invoked at once, "
        "unhashable or fresh-lambda variant keys and static keywords, "
        "static keywords reassigned per loop iteration, and kernel "
        "libraries loaded in a loop under a changing name."
    )

    def check(self, index: ProjectIndex) -> Iterable[Finding]:
        for mod in index.modules:
            for fi in mod.functions:
                yield from self._check_fn(index, mod, fi)

    def _check_fn(self, index: ProjectIndex, mod, fi: FunctionInfo) -> Iterable[Finding]:
        loops = [n for n in ast.walk(fi.node) if isinstance(n, (ast.For, ast.While))]
        loop_nodes = {loop: set(ast.walk(loop)) for loop in loops}
        loop_assigned = {loop: _loop_assigned_names(loop) for loop in loops}

        def in_loop(node: ast.AST) -> List[ast.AST]:
            return [loop for loop, members in loop_nodes.items() if node in members]

        def finding(node: ast.AST, message: str) -> Finding:
            return Finding(rule=self.name, path=mod.path, line=node.lineno,
                           col=node.col_offset, symbol=fi.qualname, message=message)

        for node in ast.walk(fi.node):
            if not isinstance(node, ast.Call):
                continue
            # PackedGraphs(...)(x): fresh graphs per call -> capture per call
            if is_graph_builder(node.func):
                yield finding(node, "`PackedGraphs(...)` invoked immediately — fresh "
                              "graphs (and a capture) per call; bind it once instead")
                continue
            # a graph (or a capture) constructed inside a loop
            if _builds_graph(node):
                if in_loop(node):
                    what = dotted_name(node.func) or "PackedGraphs"
                    yield finding(node, f"`{what}(...)` constructed inside a loop — "
                                  "a new graph and capture every iteration")
                continue
            # a kernel library loaded in a loop under a changing name
            if _loads_library(node):
                arg = node.args[0] if node.args else None
                for loop in in_loop(node):
                    if arg is not None and any(
                            isinstance(n, ast.Name) and n.id in loop_assigned[loop]
                            for n in ast.walk(arg)):
                        yield finding(node, f"`{dotted_name(node.func)}(...)` called in a "
                                      "loop with a name that changes — one library "
                                      "load per distinct value")
                        break
                continue
            # static-arg hazards at call sites of captured functions
            base = call_base_name(node)
            ji = index.jits_by_name.get(base) if base else None
            if ji is None:
                continue
            for label, value in _static_args_at_call(node, ji):
                if isinstance(value, _UNHASHABLE):
                    yield finding(value, f"unhashable literal passed to static arg `{label}` "
                                  f"of captured `{base}` — TypeError or cache miss per call")
                elif isinstance(value, ast.Lambda):
                    yield finding(value, f"fresh lambda passed to static arg `{label}` of "
                                  f"captured `{base}` — new identity per call forces a "
                                  f"recapture")
                elif isinstance(value, ast.Name):
                    for loop in in_loop(node):
                        if value.id in loop_assigned[loop]:
                            yield finding(value, f"static arg `{label}` of captured `{base}` "
                                          f"is bound to `{value.id}`, reassigned inside the "
                                          f"enclosing loop — one capture per distinct value")
                            break
