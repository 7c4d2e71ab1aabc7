"""AST-based lint framework for the port's torch and CUDA hazards — the
counterpart of ``src/repro/analysis/lint.py``, kept as a copy of its own
(the port imports nothing of the JAX package).

The serving stack's efficiency killers are invisible to Python tooling:
a stray ``.item()`` or ``.cpu()`` that blocks on the card inside the
decode path, a CUDA graph captured again per call, a reused PRNG key, a
ctypes launch whose argument list no longer matches its C signature.
This module is the tooling that finds them mechanically.

Architecture
------------
``ProjectIndex`` parses every ``.py`` file under the scanned roots into
``ModuleInfo``/``FunctionInfo`` records, builds a base-name call graph,
and computes the set of functions reachable from the serving hot roots
(``HOT_ROOTS``) and from the captured train bodies
(``TRAIN_CAPTURE_ROOTS``).  Its "jit registry" is the set of functions
the port captures or runs as one device program: the function passed to
a ``PackedGraphs(...)``, module functions called inside a
``torch.cuda.graph`` body, the train bodies and the hot roots; each
records its static names (keyword-only parameters, parameters with a
constant default, and the graph variant keys ``ticks``/``sampled``), as
the reference records ``static_argnames``.
Rules (see ``repro_torch.analysis.rules``) receive the index and yield
``Finding``s.  The framework applies inline suppression comments
(``# lint: ignore[rule-name]``), compares against a checked-in baseline
(``src/repro_torch/analysis/baseline.json``) keyed by *stable* finding
keys (no line numbers, so unrelated churn never invalidates the
baseline), and reports new / fixed / baselined counts.

Everything here is stdlib-only (``ast``, ``json``) by design — the
analyzer must run in any environment the repo runs in.
"""
from __future__ import annotations

import ast
import hashlib
import json
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

# Functions whose bodies execute inside (or drive) the serving hot paths:
# the reference's five (``_paged_prefill_step`` is the packed admission
# prefill the port's CUDA graphs capture) plus the packed chunk they
# capture.  The host-sync rule treats everything reachable from these as
# hot.
HOT_ROOTS: Tuple[str, ...] = (
    "_decode_chunk",
    "_paged_prefill_step",
    "lm_prefill",
    "lm_decode",
    "lm_generate",
    "_decode_chunk_packed",
)

# The bodies the train graphs capture: `make_train_body`'s `train_body`
# (the LM step, `train.graphs.GraphedTrainStep`) and `classifier_step_`
# (`paper.fpga_repro.train_classifier` on the card), the counterparts of
# the reference's jitted train steps.  Their constructors take a built body,
# not a named function, so they are registered by name; everything
# reachable from them is held to the host-sync rule as the serving hot
# path is.
TRAIN_CAPTURE_ROOTS: Tuple[str, ...] = (
    "train_body",
    "classifier_step_",
)

# `name = PackedGraphs(fn, ...)` binds a callable `name(packed_in, ticks,
# sampled)` whose `(ticks, sampled)` pick a captured variant (the decode
# chunk's; the admission prefill's `(L, start, guard)` go through
# `name.run`); `fn` runs under the capture with the same variant keys.
GRAPH_BUILDERS: Tuple[str, ...] = ("PackedGraphs",)
GRAPH_CALL_PARAMS: Tuple[str, ...] = ("packed_in", "ticks", "sampled")
VARIANT_KEYS: Tuple[str, ...] = ("ticks", "sampled")
GRAPH_CONTEXTS: Tuple[str, ...] = ("torch.cuda.graph", "cuda.graph")
REPLAY_NAMES: Tuple[str, ...] = ("replay",)

BASELINE_NAME = "src/repro_torch/analysis/baseline.json"

# `# lint: ignore` suppresses every rule on that line;
# `# lint: ignore[rule-a, rule-b]` suppresses just those rules.
_SUPPRESS_RE = re.compile(r"#\s*lint:\s*ignore(?:\[([a-z0-9_,\-\s]+)\])?")


@dataclass(frozen=True)
class Finding:
    """One rule violation at a concrete source location."""

    rule: str
    path: str  # repo-relative posix path
    line: int
    col: int
    symbol: str  # enclosing function qualname ("<module>" at top level)
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule}: {self.message} [{self.symbol}]"

    def key(self) -> str:
        """Stable identity: path + symbol + rule + message digest.

        Deliberately excludes line/col so that unrelated edits (moving a
        function, adding imports) do not invalidate baseline entries.
        """
        digest = hashlib.sha1(self.message.encode("utf-8")).hexdigest()[:10]
        return f"{self.path}::{self.symbol}::{self.rule}::{digest}"


@dataclass
class FunctionInfo:
    """A def (or async def) with its callees and enclosing module."""

    qualname: str  # e.g. "ServingEngine._admit"
    name: str  # base name, e.g. "_admit"
    node: ast.AST
    module: "ModuleInfo"
    calls: Set[str] = field(default_factory=set)  # base names of callees
    name_calls: Set[str] = field(default_factory=set)  # bare-name calls `f()`
    # (alias, name) of `alias.name(...)` calls on an imported module
    module_calls: Set[Tuple[str, str]] = field(default_factory=set)
    nested: bool = False  # defined inside another function

    @property
    def location(self) -> str:
        return f"{self.module.path}::{self.qualname}"


@dataclass
class JitInfo:
    """A callable the port captures or runs as one device program."""

    name: str  # bound name the call sites use
    static_argnums: Tuple[int, ...]
    static_argnames: Tuple[str, ...]
    params: Tuple[str, ...]  # positional params of the wrapped fn ((), if unknown)
    module: Optional["ModuleInfo"]
    lineno: int


@dataclass
class ModuleInfo:
    path: str  # repo-relative posix path
    tree: ast.Module
    source_lines: List[str]
    # line -> set of suppressed rule names ("*" = all rules)
    suppressions: Dict[int, Set[str]] = field(default_factory=dict)
    functions: List[FunctionInfo] = field(default_factory=list)
    jits: List[JitInfo] = field(default_factory=list)
    # (base name, line): functions handed to a PackedGraphs(...)
    graph_fns: List[Tuple[str, int]] = field(default_factory=list)
    # (base name, line): calls inside `with torch.cuda.graph(...)` bodies
    graph_body_calls: List[Tuple[str, int]] = field(default_factory=list)
    # alias -> candidate module paths (posix suffixes), and whether the
    # alias is surely a module (`import x as alias`)
    imports: Dict[str, Tuple[Tuple[str, ...], bool]] = field(default_factory=dict)

    def suppressed(self, line: int, rule: str) -> bool:
        rules = self.suppressions.get(line)
        return bool(rules) and ("*" in rules or rule in rules)


def call_base_name(node: ast.Call) -> Optional[str]:
    """Base name of a call target: f() -> 'f', a.b.f() -> 'f'."""
    fn = node.func
    if isinstance(fn, ast.Name):
        return fn.id
    if isinstance(fn, ast.Attribute):
        return fn.attr
    return None


def dotted_root(node: ast.AST) -> Optional[str]:
    """Leftmost name of a dotted expression: torch.ones(...) -> 'torch'."""
    while isinstance(node, ast.Attribute):
        node = node.value
    if isinstance(node, ast.Name):
        return node.id
    return None


def dotted_name(node: ast.AST) -> Optional[str]:
    """Full dotted path of an expression if it is a plain Name/Attribute chain."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def bound_name(node: ast.AST) -> Optional[str]:
    """The name an assignment target binds: x -> 'x', self.x -> 'x'."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return None


def is_graph_builder(node: ast.AST) -> bool:
    """True for a `PackedGraphs(...)` call."""
    return isinstance(node, ast.Call) and call_base_name(node) in GRAPH_BUILDERS


def is_graph_context(node: ast.AST) -> bool:
    """True for a `torch.cuda.graph(...)` call."""
    return isinstance(node, ast.Call) and dotted_name(node.func) in GRAPH_CONTEXTS


def fn_params(node: ast.AST) -> Tuple[str, ...]:
    """Positional parameters, without a leading `self`/`cls`."""
    if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
        names = tuple(a.arg for a in list(node.args.posonlyargs) + list(node.args.args))
        if names and names[0] in ("self", "cls"):
            names = names[1:]
        return names
    return ()


_STATIC_ANNOTATIONS = ("int", "bool", "float", "str")


def static_params(node: ast.AST) -> Tuple[str, ...]:
    """A function's static names, the Python values a capture bakes in:
    keyword-only parameters, parameters with a constant default or an
    int/bool/float/str annotation, and the graph variant keys."""
    if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
        return ()
    args = node.args
    out = [a.arg for a in args.kwonlyargs]
    pos = list(args.posonlyargs) + list(args.args)
    for a, d in zip(pos[len(pos) - len(args.defaults):], args.defaults):
        if isinstance(d, ast.Constant):
            out.append(a.arg)
    out += [a.arg for a in pos if a.arg in VARIANT_KEYS or (
        isinstance(a.annotation, ast.Name) and a.annotation.id in _STATIC_ANNOTATIONS)]
    return tuple(dict.fromkeys(out))


def _module_candidates(dotted: str) -> Tuple[str, ...]:
    base = dotted.replace(".", "/")
    return (f"{base}.py", f"{base}/__init__.py")


class _ModuleScanner(ast.NodeVisitor):
    """Collects functions, their callees, imports and capture bindings for
    one module."""

    def __init__(self, mod: ModuleInfo) -> None:
        self.mod = mod
        self._stack: List[Tuple[str, bool]] = []   # (name, is a function)
        self._collect_imports(mod.tree)

    def _collect_imports(self, tree: ast.Module) -> None:
        pkg = Path(self.mod.path).parent
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    if a.asname:
                        self.mod.imports[a.asname] = (_module_candidates(a.name), True)
            elif isinstance(node, ast.ImportFrom):
                if node.level:
                    base = pkg
                    for _ in range(node.level - 1):
                        base = base.parent
                    prefix = base.as_posix() + "/" + (node.module or "").replace(".", "/")
                    prefix = prefix.rstrip("/").lstrip("./")
                else:
                    prefix = (node.module or "").replace(".", "/")
                for a in node.names:
                    dotted = f"{prefix}/{a.name}".lstrip("/")
                    self.mod.imports[a.asname or a.name] = (
                        (f"{dotted}.py", f"{dotted}/__init__.py"), False)

    # -- functions -------------------------------------------------------
    def _visit_def(self, node) -> None:
        nested = any(is_fn for _, is_fn in self._stack)
        self._stack.append((node.name, True))
        qualname = ".".join(n for n, _ in self._stack)
        info = FunctionInfo(qualname=qualname, name=node.name, node=node,
                            module=self.mod, nested=nested)
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                fn = sub.func
                if (isinstance(fn, ast.Attribute) and isinstance(fn.value, ast.Name)
                        and fn.value.id in self.mod.imports):
                    info.module_calls.add((fn.value.id, fn.attr))
                    continue
                base = call_base_name(sub)
                if base:
                    info.calls.add(base)
                if isinstance(fn, ast.Name):
                    info.name_calls.add(fn.id)
        self.mod.functions.append(info)
        self.generic_visit(node)
        self._stack.pop()

    visit_FunctionDef = _visit_def
    visit_AsyncFunctionDef = _visit_def

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._stack.append((node.name, False))
        self.generic_visit(node)
        self._stack.pop()

    # -- capture bindings ------------------------------------------------
    def _graph_builders(self, value: ast.AST) -> List[ast.Call]:
        """PackedGraphs(...) calls bound by an assignment, including the
        arms of `PackedGraphs(...) if cond else None`."""
        if isinstance(value, ast.IfExp):
            return self._graph_builders(value.body) + self._graph_builders(value.orelse)
        return [value] if is_graph_builder(value) else []

    def visit_Assign(self, node: ast.Assign) -> None:
        for call in self._graph_builders(node.value):
            if call.args:
                wrapped = dotted_name(call.args[0])
                if wrapped:
                    self.mod.graph_fns.append((wrapped.split(".")[-1], node.lineno))
            for tgt in node.targets:
                name = bound_name(tgt)
                if name:
                    self.mod.jits.append(JitInfo(
                        name, (1, 2), VARIANT_KEYS, GRAPH_CALL_PARAMS,
                        self.mod, node.lineno))
        self.generic_visit(node)

    def visit_With(self, node: ast.With) -> None:
        if any(is_graph_context(item.context_expr) for item in node.items):
            for stmt in node.body:
                for sub in ast.walk(stmt):
                    if isinstance(sub, ast.Call):
                        base = call_base_name(sub)
                        if base:
                            self.mod.graph_body_calls.append((base, sub.lineno))
        self.generic_visit(node)


class ProjectIndex:
    """Parsed modules + call graph + hot-path reachability for the scan roots."""

    def __init__(self, root: Path, modules: List[ModuleInfo]) -> None:
        self.root = root
        self.modules = modules
        self.defs_by_name: Dict[str, List[FunctionInfo]] = {}
        self.jits_by_name: Dict[str, JitInfo] = {}
        for mod in modules:
            for fi in mod.functions:
                self.defs_by_name.setdefault(fi.name, []).append(fi)
        captured: List[str] = []
        for mod in modules:
            for ji in mod.jits:
                self.jits_by_name[ji.name] = ji
            local = {fi.name for fi in mod.functions}
            for name, line in mod.graph_fns + [
                    c for c in mod.graph_body_calls
                    if c[0] in local]:     # module functions only, not self.fn
                self._register(name, mod, line)
                captured.append(name)
        for name in HOT_ROOTS + TRAIN_CAPTURE_ROOTS:
            if name in self.defs_by_name:
                self._register(name, None, 0)
        self._by_path = {m.path: m for m in modules}
        self._alias_cache: Dict[Tuple[str, str], Optional[ModuleInfo]] = {}
        self._hot_defs: Set[int] = set()
        self.hot_functions: Set[str] = self._reach(HOT_ROOTS, self._hot_defs)
        self._train_defs: Set[int] = set()
        # everything a CUDA graph capture runs
        self.captured_functions: Set[str] = (
            self._reach(captured) | self._reach(TRAIN_CAPTURE_ROOTS, self._train_defs))

    def _register(self, name: str, mod: Optional[ModuleInfo], line: int) -> None:
        """Record a captured function with the params and static names of
        its (first) definition."""
        if name in self.jits_by_name:
            return
        defs = self.defs_by_name.get(name, [])
        node = defs[0].node if defs else None
        params = fn_params(node) if node is not None else ()
        statics = static_params(node) if node is not None else VARIANT_KEYS
        nums = tuple(i for i, p in enumerate(params) if p in statics)
        self.jits_by_name[name] = JitInfo(name, nums, statics, params, mod, line)

    def _module_of(self, fi: FunctionInfo, alias: str) -> Optional[ModuleInfo]:
        """The scanned module an import alias names, if any."""
        key = (fi.module.path, alias)
        if key not in self._alias_cache:
            cands, _ = fi.module.imports[alias]
            self._alias_cache[key] = next(
                (mod for path, mod in self._by_path.items()
                 if any(path == c or path.endswith("/" + c) for c in cands)), None)
        return self._alias_cache[key]

    def _callees(self, fi: FunctionInfo) -> List[FunctionInfo]:
        """Defs a function may call: every def sharing a called base
        name (a nested def only through a bare-name call), and for
        `mod.f()` on an imported module only that module's `f` (none for
        a module outside the scan)."""
        out: List[FunctionInfo] = []
        for name in fi.calls:
            out += self.defs_by_name.get(name, [])
        for alias, name in fi.module_calls:
            target = self._module_of(fi, alias)
            if target is not None:
                out += [d for d in target.functions if d.name == name and not d.nested]
            elif not fi.module.imports[alias][1]:
                out += self.defs_by_name.get(name, [])   # maybe not a module
        return out

    def _reach(self, roots: Sequence[str], defs: Optional[Set[int]] = None) -> Set[str]:
        """Call-graph closure from `roots` (callee direction); returns the
        reached names and adds the reached defs' ids to `defs`.

        Conservative over-approximation: two unrelated functions sharing
        a base name are merged, as in the reference (an attribute call on
        an imported module is the one call resolved by its module).  Good
        enough at repo scale, and errs toward flagging (a suppression is
        one comment away).
        """
        seen: Set[str] = set(roots)
        reached: Set[int] = set() if defs is None else defs
        frontier: List[FunctionInfo] = [fi for r in roots for fi in self.defs_by_name.get(r, [])]
        while frontier:
            fi = frontier.pop()
            if id(fi) in reached:
                continue
            reached.add(id(fi))
            seen.add(fi.name)
            for callee in self._callees(fi):
                if callee.nested and callee.name not in fi.name_calls:
                    continue
                frontier.append(callee)
        return seen

    def is_hot(self, fi: FunctionInfo) -> bool:
        return id(fi) in self._hot_defs

    def is_train_captured(self, fi: FunctionInfo) -> bool:
        """Reachable from a captured train body (``TRAIN_CAPTURE_ROOTS``)."""
        return id(fi) in self._train_defs

    def jit_names(self) -> Set[str]:
        """Names of captured callables, the hot roots and graph replays."""
        return set(self.jits_by_name) | set(HOT_ROOTS) | set(REPLAY_NAMES)


def _parse_suppressions(lines: List[str]) -> Dict[int, Set[str]]:
    out: Dict[int, Set[str]] = {}
    for i, line in enumerate(lines, start=1):
        m = _SUPPRESS_RE.search(line)
        if not m:
            continue
        if m.group(1):
            out[i] = {r.strip() for r in m.group(1).split(",") if r.strip()}
        else:
            out[i] = {"*"}
    return out


def load_module(path: Path, root: Path) -> Optional[ModuleInfo]:
    try:
        source = path.read_text(encoding="utf-8")
        tree = ast.parse(source, filename=str(path))
    except (SyntaxError, UnicodeDecodeError, OSError):
        return None
    rel = path.relative_to(root).as_posix() if root in path.parents or path == root else path.as_posix()
    mod = ModuleInfo(path=rel, tree=tree, source_lines=source.splitlines())
    mod.suppressions = _parse_suppressions(mod.source_lines)
    _ModuleScanner(mod).visit(tree)
    return mod


def build_index(root: Path, paths: Sequence[Path]) -> ProjectIndex:
    modules: List[ModuleInfo] = []
    seen: Set[Path] = set()
    for p in paths:
        files = sorted(p.rglob("*.py")) if p.is_dir() else [p]
        for f in files:
            f = f.resolve()
            if f in seen:
                continue
            seen.add(f)
            mod = load_module(f, root)
            if mod is not None:
                modules.append(mod)
    return ProjectIndex(root, modules)


# ---------------------------------------------------------------------------
# Rule protocol + runner
# ---------------------------------------------------------------------------

class Rule:
    """Base class: subclasses set `name`/`doc` and implement `check`."""

    name: str = ""
    doc: str = ""

    def check(self, index: ProjectIndex) -> Iterable[Finding]:  # pragma: no cover
        raise NotImplementedError


def run_rules(
    index: ProjectIndex,
    rules: Sequence[Rule],
    enabled: Optional[Set[str]] = None,
) -> Tuple[List[Finding], int]:
    """Run rules over the index; returns (findings, n_inline_suppressed)."""
    by_path = {m.path: m for m in index.modules}
    findings: List[Finding] = []
    suppressed = 0
    for rule in rules:
        if enabled is not None and rule.name not in enabled:
            continue
        for f in rule.check(index):
            mod = by_path.get(f.path)
            if mod is not None and mod.suppressed(f.line, f.rule):
                suppressed += 1
                continue
            findings.append(f)
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings, suppressed


# ---------------------------------------------------------------------------
# Baseline
# ---------------------------------------------------------------------------

def unique_keys(findings: Sequence[Finding]) -> List[str]:
    """Finding keys with '#n' suffixes for same-key repeats (stable order)."""
    counts: Dict[str, int] = {}
    keys: List[str] = []
    for f in findings:
        k = f.key()
        n = counts.get(k, 0)
        counts[k] = n + 1
        keys.append(k if n == 0 else f"{k}#{n}")
    return keys


def load_baseline(path: Path) -> Dict[str, Dict[str, str]]:
    if not path.exists():
        return {}
    data = json.loads(path.read_text(encoding="utf-8"))
    return dict(data.get("entries", {}))


def write_baseline(path: Path, findings: Sequence[Finding], notes: Optional[Dict[str, str]] = None) -> None:
    notes = notes or {}
    entries = {}
    for f, k in zip(findings, unique_keys(findings)):
        entries[k] = {
            "rule": f.rule,
            "note": notes.get(k, "TODO: justify or fix"),
        }
    payload = {
        "version": 1,
        "comment": "Baseline for `python -m repro_torch.analysis`. "
        "Keys are path::symbol::rule::message-digest — line-number free, so "
        "unrelated churn never invalidates an entry. Every entry carries a "
        "one-line justification; fix the code instead of adding entries "
        "whenever possible.",
        "entries": entries,
    }
    path.write_text(json.dumps(payload, indent=2, sort_keys=False) + "\n", encoding="utf-8")


@dataclass
class BaselineDiff:
    new: List[Finding]
    known: List[Finding]
    stale: List[str]  # baseline keys with no matching finding


def diff_baseline(findings: Sequence[Finding], baseline: Dict[str, Dict[str, str]]) -> BaselineDiff:
    new: List[Finding] = []
    known: List[Finding] = []
    seen_keys: Set[str] = set()
    for f, k in zip(findings, unique_keys(findings)):
        seen_keys.add(k)
        (known if k in baseline else new).append(f)
    stale = sorted(set(baseline) - seen_keys)
    return BaselineDiff(new=new, known=known, stale=stale)


# ---------------------------------------------------------------------------
# Project entry point (used by the CLI, the tests and chip_smoke.py)
# ---------------------------------------------------------------------------

DEFAULT_SCAN_PATHS = ("src/repro_torch", "chip_smoke.py")


def find_root(start: Path) -> Path:
    """Walk up from `start` to the repo root (the dir holding src/repro_torch)."""
    for cand in [start, *start.parents]:
        if (cand / "src" / "repro_torch").is_dir():
            return cand
    return start


def default_rules() -> List[Rule]:
    from .rules import all_rules

    return all_rules()


@dataclass
class ProjectReport:
    findings: List[Finding]
    diff: BaselineDiff
    inline_suppressed: int
    files_scanned: int

    def by_rule(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for f in self.findings:
            out[f.rule] = out.get(f.rule, 0) + 1
        return dict(sorted(out.items()))


def run_project(
    root: Path,
    paths: Optional[Sequence[str]] = None,
    baseline_path: Optional[Path] = None,
    enabled: Optional[Set[str]] = None,
) -> ProjectReport:
    root = Path(root).resolve()
    scan = [root / p for p in (paths or DEFAULT_SCAN_PATHS)]
    scan = [p for p in scan if p.exists()]
    index = build_index(root, scan)
    findings, suppressed = run_rules(index, default_rules(), enabled=enabled)
    baseline = load_baseline(baseline_path or (root / BASELINE_NAME))
    diff = diff_baseline(findings, baseline)
    return ProjectReport(
        findings=findings,
        diff=diff,
        inline_suppressed=suppressed,
        files_scanned=len(index.modules),
    )
