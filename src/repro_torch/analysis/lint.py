"""AST policy linter for the port (the port of ``repro.analysis.lint``):
repo invariants ruff's rule set cannot express.

Three rules:

- **guarded-placement-extrema** -- in ``repro_torch/core/schedule.py``,
  ``max()`` / ``min()`` over a placements-derived iterable must either
  pass ``default=`` or sit in a scope that first guards the empty case
  (``if not ...: raise/return``): an empty schedule must not surface as a
  bare ``ValueError: max() arg is an empty sequence`` three layers from
  the actual bug.  The JAX linter's rule, as written.
- **core-lazy-torch** -- no module-top ``torch`` import under
  ``repro_torch/core/``: the planning layer (partitioner, scheduler,
  cost models, tuner) is plain Python and numpy, importable by schedulers
  and CI tools without a multi-second torch import.  Function-local
  imports are the sanctioned lazy pattern (``core/profiler.py`` imports
  torch inside the functions that time blocks); ``if TYPE_CHECKING:``
  blocks are exempt.
- **port-boundary** -- no ``jax``, ``jaxlib`` or ``repro`` (the JAX
  package) import anywhere, function-local ones included, in
  ``repro_torch/``, ``chip_smoke.py`` or ``tests/test_torch_gpu.py``: the
  port stands alone, and the last two files run on the card's machine,
  which has no JAX.  The static twin of the test that imports every port
  module and finds neither in ``sys.modules``.

CLI: ``python -m repro_torch.analysis.lint [paths...]`` (default:
``src/repro_torch``, ``chip_smoke.py`` and ``tests/test_torch_gpu.py``
under the repo root).  Exit 0 when clean.
"""
from __future__ import annotations

import ast
import dataclasses
import pathlib
import sys

RULES = ("guarded-placement-extrema", "core-lazy-torch", "port-boundary")
#: the JAX package's import roots, which the port never imports
FOREIGN_ROOTS = ("jax", "jaxlib", "repro")
#: files outside ``repro_torch/`` that the boundary covers, by name
BOUNDARY_FILES = ("chip_smoke.py", "test_torch_gpu.py")
DEFAULT_PATHS = ("src/repro_torch", "chip_smoke.py", "tests/test_torch_gpu.py")


@dataclasses.dataclass(frozen=True)
class LintFinding:
    rule: str
    path: str
    line: int
    detail: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.detail}"


def _port_relpath(path: pathlib.Path) -> str | None:
    """Path relative to the ``repro_torch`` package root, or None outside
    it."""
    parts = path.as_posix().split("/")
    if "repro_torch" in parts:
        return "/".join(parts[parts.index("repro_torch") + 1:])
    return None


def _imported_modules(node: ast.AST):
    if isinstance(node, ast.Import):
        for alias in node.names:
            yield alias.name
    elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
        yield node.module


class _FileLinter(ast.NodeVisitor):
    def __init__(self, path: pathlib.Path, rel: str | None):
        self.path, self.rel = path, rel
        self.boundary = rel is not None or path.name in BOUNDARY_FILES
        self.findings: list[LintFinding] = []
        self._func_depth = 0
        self._type_checking = 0

    def flag(self, rule: str, node: ast.AST, detail: str):
        self.findings.append(
            LintFinding(rule, str(self.path), node.lineno, detail))

    # ---- scope tracking ------------------------------------------------
    def visit_FunctionDef(self, node):
        self._func_depth += 1
        self.generic_visit(node)
        self._func_depth -= 1

    visit_AsyncFunctionDef = visit_FunctionDef
    visit_Lambda = visit_FunctionDef

    def visit_If(self, node):
        is_tc = isinstance(node.test, ast.Name) and \
            node.test.id == "TYPE_CHECKING"
        self._type_checking += is_tc
        self.generic_visit(node)
        self._type_checking -= is_tc

    # ---- rules 2 and 3: import policy ----------------------------------
    def _check_import(self, node):
        in_core = self.rel is not None and self.rel.startswith("core/")
        for mod in _imported_modules(node):
            root = mod.split(".")[0]
            if self.boundary and root in FOREIGN_ROOTS:
                self.flag(
                    "port-boundary", node,
                    f"import of {mod!r}: the port imports neither JAX nor "
                    "the JAX package (repro), not even inside a function")
            if in_core and root == "torch" and self._func_depth == 0 \
                    and not self._type_checking:
                self.flag(
                    "core-lazy-torch", node,
                    "module-top torch import under core/ -- the planning "
                    "layer must import without torch; move it inside the "
                    "function that needs it")
        self.generic_visit(node)

    visit_Import = _check_import
    visit_ImportFrom = _check_import


def _mentions_placements(node: ast.AST) -> bool:
    return any((isinstance(n, ast.Name) and "placement" in n.id)
               or (isinstance(n, ast.Attribute) and "placement" in n.attr)
               for n in ast.walk(node))


def _scope_nodes(scope: ast.AST):
    """Walk a scope's own statements, not those of nested functions
    (each nested def is analyzed as its own scope)."""
    stack = list(ast.iter_child_nodes(scope))
    while stack:
        n = stack.pop()
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef,
                          ast.Lambda)):
            continue
        yield n
        stack.extend(ast.iter_child_nodes(n))


def _has_empty_guard(scope: ast.AST) -> bool:
    """An ``if`` mentioning placements whose body raises or returns --
    the sanctioned empty-schedule guard pattern."""
    for n in _scope_nodes(scope):
        if isinstance(n, ast.If) and _mentions_placements(n.test) and any(
                isinstance(s, (ast.Raise, ast.Return))
                for b in n.body for s in ast.walk(b)):
            return True
    return False


def _check_extrema(tree: ast.AST, path: pathlib.Path) -> list[LintFinding]:
    findings = []
    scopes = [tree] + [n for n in ast.walk(tree)
                       if isinstance(n, (ast.FunctionDef,
                                         ast.AsyncFunctionDef))]
    for scope in scopes:
        guarded = _has_empty_guard(scope)
        for n in _scope_nodes(scope):
            if not (isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
                    and n.func.id in ("max", "min")):
                continue
            if len(n.args) != 1 or any(k.arg == "default"
                                       for k in n.keywords):
                continue        # max(a, b) / max(..., default=...) are fine
            if not _mentions_placements(n.args[0]) or guarded:
                continue
            findings.append(LintFinding(
                "guarded-placement-extrema", str(path), n.lineno,
                f"bare {n.func.id}() over a placements-derived iterable "
                "with no default= and no empty-schedule guard in scope "
                "(empty schedules raise a bare ValueError here)"))
    return findings


def lint_file(path: pathlib.Path) -> list[LintFinding]:
    path = pathlib.Path(path)
    rel = _port_relpath(path)
    try:
        tree = ast.parse(path.read_text(), filename=str(path))
    except SyntaxError as e:
        return [LintFinding("parse", str(path), e.lineno or 0, str(e))]
    linter = _FileLinter(path, rel)
    linter.visit(tree)
    findings = linter.findings
    if rel == "core/schedule.py":
        findings += _check_extrema(tree, path)
    return findings


def lint_paths(paths) -> list[LintFinding]:
    findings: list[LintFinding] = []
    for p in paths:
        p = pathlib.Path(p)
        files = sorted(p.rglob("*.py")) if p.is_dir() else [p]
        for f in files:
            findings.extend(lint_file(f))
    return findings


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        root = pathlib.Path(__file__).resolve().parents[3]
        argv = [str(root / p) for p in DEFAULT_PATHS]
    missing = [p for p in argv if not pathlib.Path(p).exists()]
    if missing:
        print(f"policy lint: no such path: {', '.join(missing)}")
        return 2
    findings = lint_paths(argv)
    for f in findings:
        print(f)
    print(f"policy lint: {len(findings)} finding(s) in {len(argv)} path(s)")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
