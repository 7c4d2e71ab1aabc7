"""kernel-constraints rule: structural checks on the ctypes launch sites
of the hand-written kernels — the counterpart of the reference's
``pallas-constraints``.

Three checks per module of a ``kernels/`` package:

* **arity** — the counterpart of the index-map arity check.  A launcher
  function declares a C entry point's ``argtypes`` (e.g.
  ``[ctypes.c_int] + [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints
  + [ctypes.c_void_p]``, its multipliers bound where the launcher is
  called: ``_launcher("bsr_matmul", 8, 11)(...)``).  The arguments at
  each launch must number exactly as the argtypes, and the argtypes must
  match, position by position (int, pointer, float), the
  ``extern "C" int <symbol>(...)`` signature in the sibling ``csrc/*.cu``.
  ctypes cannot see a mismatch with the C side: it shows up only as
  wrong memory on the card.
* **plain path** — the counterpart of the interpret path: every public
  ``*_cuda`` wrapper has a ``*_plain`` twin in the same module, and the
  package's ``ops.py`` dispatches to both.
* **checked and counted** — each launch's return code goes to
  ``_build.check(name, err)``, followed by
  ``_build.launch_counts[name] += 1``, both under the kernel's library
  name (``chip_smoke.py``'s launch-count gates depend on it).
"""
from __future__ import annotations

import ast
import re
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence

from ..lint import Finding, FunctionInfo, ProjectIndex, Rule, call_base_name, dotted_name
from . import register

_CTYPE_KINDS = {
    "c_int": "int", "c_int32": "int", "c_uint": "int", "c_uint32": "int",
    "c_long": "int64", "c_longlong": "int64", "c_int64": "int64",
    "c_size_t": "int64", "c_float": "float", "c_double": "double",
    "c_void_p": "ptr", "c_char_p": "ptr",
}
_EXTERN_RE = re.compile(r'extern\s+"C"\s+[\w\s\*]+?\b(\w+)\s*\(([^)]*)\)\s*\{', re.S)


def _c_kind(param: str) -> str:
    if "*" in param:
        return "ptr"
    words = param.replace("const", " ").split()[:-1]   # drop the name
    if "float" in words:
        return "float"
    if "double" in words:
        return "double"
    if words.count("long") == 2 or any(w in ("int64_t", "size_t") for w in words):
        return "int64"
    return "int"


def c_signatures(csrc: Path) -> Dict[str, List[str]]:
    """symbol -> parameter kinds of every `extern "C"` function defined
    in the `.cu` sources of `csrc`."""
    out: Dict[str, List[str]] = {}
    if not csrc.is_dir():
        return out
    for cu in sorted(csrc.glob("*.cu")):
        text = re.sub(r"//[^\n]*", "", cu.read_text(encoding="utf-8", errors="replace"))
        for m in _EXTERN_RE.finditer(text):
            params = [p.strip() for p in m.group(2).split(",") if p.strip()]
            if params == ["void"]:
                params = []
            out[m.group(1)] = [_c_kind(p) for p in params]
    return out


def _consts(fn: ast.AST) -> Dict[str, ast.AST]:
    """name -> value of names bound exactly once in `fn`."""
    seen: Dict[str, List[ast.AST]] = {}
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    seen.setdefault(t.id, []).append(node.value)
    return {k: v[0] for k, v in seen.items() if len(v) == 1}


def _eval(node: Optional[ast.AST], env: Dict[str, object]):
    """A str/int value of a constant, a bound name or an f-string of them
    (None when unknown)."""
    if node is None:
        return None
    if isinstance(node, ast.Constant) and isinstance(node.value, (str, int)):
        return node.value
    if isinstance(node, ast.Name):
        return env.get(node.id)
    if isinstance(node, ast.JoinedStr):
        parts = []
        for v in node.values:
            val = _eval(v.value if isinstance(v, ast.FormattedValue) else v, env)
            if val is None:
                return None
            parts.append(str(val))
        return "".join(parts)
    return None


class _Launcher:
    """A function that binds a C entry point and declares its argtypes."""

    def __init__(self, fi: FunctionInfo, argtypes: ast.AST) -> None:
        self.fi = fi
        self.params = [a.arg for a in fi.node.args.args]
        self.argtypes = argtypes
        self.lib: Optional[ast.AST] = None
        self.symbol: Optional[ast.AST] = None
        for node in ast.walk(fi.node):
            if isinstance(node, ast.Call) and call_base_name(node) == "library":
                self.lib = node.args[0] if node.args else None
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                    and node.func.id == "getattr" and len(node.args) == 2
                    and isinstance(node.args[0], ast.Call)
                    and call_base_name(node.args[0]) == "library"):
                self.symbol = node.args[1]
            if (isinstance(node, ast.Attribute) and isinstance(node.value, ast.Call)
                    and call_base_name(node.value) == "library"):
                self.symbol = ast.Constant(value=node.attr)

    def bind(self, call: ast.Call, env: Dict[str, object]) -> Dict[str, object]:
        out = {}
        for p, a in zip(self.params, call.args):
            out[p] = _eval(a, env)
        return out

    def kinds(self, env: Dict[str, object]) -> Optional[List[str]]:
        """The argtypes as a list of kinds, or None if not resolvable."""
        return _expand(self.argtypes, env)


def _expand(node: ast.AST, env: Dict[str, object]) -> Optional[List[str]]:
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        left, right = _expand(node.left, env), _expand(node.right, env)
        return None if left is None or right is None else left + right
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Mult):
        seq, times = node.left, node.right
        if not isinstance(seq, (ast.List, ast.Tuple)):
            seq, times = times, seq
        items, n = _expand(seq, env), _eval(times, env)
        return None if items is None or not isinstance(n, int) else items * n
    if isinstance(node, (ast.List, ast.Tuple)):
        out = []
        for e in node.elts:
            kind = _CTYPE_KINDS.get((dotted_name(e) or "").split(".")[-1])
            if kind is None:
                return None
            out.append(kind)
        return out
    return None


def _argtypes_of(fi: FunctionInfo) -> Optional[ast.AST]:
    for node in ast.walk(fi.node):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Attribute) and t.attr == "argtypes":
                    return node.value
    return None


def _in_kernels_package(path: str) -> bool:
    return "kernels" in Path(path).parts[:-1]


@register
class KernelConstraintsRule(Rule):
    name = "kernel-constraints"
    doc = (
        "ctypes launches whose arguments do not match the argtypes or the "
        "C signature, *_cuda wrappers without a *_plain twin dispatched "
        "from ops.py, and launches not followed by check and count."
    )

    def check(self, index: ProjectIndex) -> Iterable[Finding]:
        ops = {str(Path(m.path).parent): m for m in index.modules
               if Path(m.path).name == "ops.py"}
        sigs_by_dir: Dict[str, Dict[str, List[str]]] = {}
        for mod in index.modules:
            if not _in_kernels_package(mod.path):
                continue
            pkg = str(Path(mod.path).parent)
            if pkg not in sigs_by_dir:
                sigs_by_dir[pkg] = c_signatures(
                    (index.root / mod.path).parent.parent / "csrc")
            yield from self._plain_paths(mod, ops.get(pkg))
            launchers = {}
            for fi in mod.functions:
                at = _argtypes_of(fi)
                if at is not None:
                    launchers[fi.name] = _Launcher(fi, at)
            for fi in mod.functions:
                yield from self._launch_sites(mod, fi, launchers, sigs_by_dir[pkg])

    # -- plain twins -------------------------------------------------------
    def _plain_paths(self, mod, ops_mod) -> Iterable[Finding]:
        defs = {fi.name: fi for fi in mod.functions if "." not in fi.qualname}
        ops_names = set()
        if ops_mod is not None:          # used, not merely imported
            for node in ast.walk(ops_mod.tree):
                if isinstance(node, ast.Name):
                    ops_names.add(node.id)
                elif isinstance(node, ast.Attribute):
                    ops_names.add(node.attr)
        for name, fi in defs.items():
            if not name.endswith("_cuda") or name.startswith("_"):
                continue
            plain = name[: -len("_cuda")] + "_plain"
            where = dict(rule=self.name, path=mod.path, line=fi.node.lineno,
                         col=fi.node.col_offset, symbol=fi.qualname)
            if plain not in defs:
                yield Finding(**where, message=f"`{name}` has no `{plain}` twin in its "
                              f"module — the kernel has no CPU path and no oracle")
                continue
            missing = [n for n in (name, plain) if n not in ops_names]
            if missing:
                yield Finding(**where, message=f"the package's ops.py does not dispatch to "
                              f"{', '.join(f'`{n}`' for n in missing)}")

    # -- launch sites ------------------------------------------------------
    def _launch_sites(self, mod, fi: FunctionInfo, launchers: Dict[str, _Launcher],
                      sigs: Dict[str, List[str]]) -> Iterable[Finding]:
        env = {k: _eval(v, {}) for k, v in _consts(fi.node).items()}
        env = {k: v for k, v in env.items() if v is not None}
        assigned: Dict[int, str] = {}      # id(call) -> name its result binds
        for node in ast.walk(fi.node):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                assigned[id(node.value)] = node.targets[0].id
        for node in ast.walk(fi.node):
            if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Call)):
                continue
            launcher = launchers.get(call_base_name(node.func) or "")
            if launcher is None:
                continue

            def finding(message: str) -> Finding:
                return Finding(rule=self.name, path=mod.path, line=node.lineno,
                               col=node.col_offset, symbol=fi.qualname, message=message)

            bound = launcher.bind(node.func, env)
            lib = _eval(launcher.lib, bound)
            symbol = _eval(launcher.symbol, bound)
            kinds = launcher.kinds(bound)
            label = symbol or launcher.fi.name
            if kinds is None:
                yield finding(f"argtypes of `{label}` cannot be resolved at this launch")
            elif any(isinstance(a, ast.Starred) for a in node.args) or node.keywords:
                yield finding(f"launch of `{label}` passes starred or keyword arguments "
                              "— its arity cannot be checked")
            elif len(node.args) != len(kinds):
                yield finding(f"launch of `{label}` passes {len(node.args)} arguments but "
                              f"its argtypes declare {len(kinds)}")
            if kinds is not None:
                if symbol is None:
                    yield finding(f"the C symbol launched through `{launcher.fi.name}` "
                                  "cannot be resolved")
                elif symbol not in sigs:
                    yield finding(f"no `extern \"C\"` definition of `{symbol}` in the "
                                  "kernels' csrc/*.cu")
                else:
                    want = sigs[symbol]
                    if len(want) != len(kinds):
                        yield finding(f"argtypes of `{symbol}` declare {len(kinds)} "
                                      f"parameters but its C signature has {len(want)}")
                    else:
                        bad = [i for i, (a, b) in enumerate(zip(kinds, want)) if a != b]
                        if bad:
                            i = bad[0]
                            yield finding(f"argtypes of `{symbol}` declare a {kinds[i]} at "
                                          f"position {i} where its C signature has a "
                                          f"{want[i]}")
            yield from self._checked_and_counted(fi, node, assigned.get(id(node)), lib,
                                                 env, finding, label)

    def _checked_and_counted(self, fi, launch: ast.Call, err: Optional[str], lib,
                             env, finding, label) -> Iterable[Finding]:
        if err is None:
            yield finding(f"the return code of `{label}` is not kept for `_build.check`")
            return
        checked = counted = None
        for node in ast.walk(fi.node):
            if (isinstance(node, ast.Call) and call_base_name(node) == "check"
                    and len(node.args) == 2 and isinstance(node.args[1], ast.Name)
                    and node.args[1].id == err and node.lineno >= launch.lineno):
                if checked is None or node.lineno < checked[0]:
                    checked = (node.lineno, _eval(node.args[0], env))
            if (isinstance(node, ast.AugAssign) and isinstance(node.op, ast.Add)
                    and isinstance(node.target, ast.Subscript)
                    and (dotted_name(node.target.value) or "").endswith("launch_counts")
                    and isinstance(node.value, ast.Constant) and node.value.value == 1
                    and node.lineno >= launch.lineno):
                if counted is None or node.lineno < counted[0]:
                    counted = (node.lineno, _eval(node.target.slice, env))
        if checked is None:
            yield finding(f"launch of `{label}` is not followed by `_build.check(name, {err})`")
        elif lib is not None and checked[1] != lib:
            yield finding(f"launch of `{label}` is checked under `{checked[1]}`, not its "
                          f"library `{lib}`")
        if counted is None:
            yield finding(f"launch of `{label}` is not counted in `_build.launch_counts`")
        elif checked is not None and counted[0] < checked[0]:
            yield finding(f"launch of `{label}` is counted before it is checked")
        elif lib is not None and counted[1] != lib:
            yield finding(f"launch of `{label}` is counted under `{counted[1]}`, not its "
                          f"library `{lib}`")


def launch_symbols(index: ProjectIndex) -> List[str]:
    """The C symbol of every ctypes launch site the rule checks (None
    where it cannot be resolved), in scan order."""
    out: List[str] = []
    for mod in index.modules:
        if not _in_kernels_package(mod.path):
            continue
        launchers = {fi.name: _Launcher(fi, at) for fi in mod.functions
                     if (at := _argtypes_of(fi)) is not None}
        for fi in mod.functions:
            env = {k: v for k, v in ((k, _eval(v, {})) for k, v in _consts(fi.node).items())
                   if v is not None}
            for node in ast.walk(fi.node):
                if isinstance(node, ast.Call) and isinstance(node.func, ast.Call):
                    launcher = launchers.get(call_base_name(node.func) or "")
                    if launcher is not None:
                        out.append(_eval(launcher.symbol, launcher.bind(node.func, env)))
    return out


__all__: Sequence[str] = ("KernelConstraintsRule", "c_signatures", "launch_symbols")
