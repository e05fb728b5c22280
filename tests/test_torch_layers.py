"""The port's imports point one way, read from the source alone (AST, no
import): every module of ``eks_tpu_torch`` imports the package's modules only
at its top, and only from its own box of the layering below or from boxes to
its right. ``parallel/`` is the public façade: nothing else in the package
imports it."""

import ast
from pathlib import Path

import pytest

PACKAGE = Path(__file__).resolve().parent.parent / "eks_tpu_torch"

#: the boxes from left to right; a module belongs to the box of its longest
#: listed dotted prefix ("__init__" is the package's own __init__.py)
BOXES = (
    ("the façade", ("parallel",)),
    ("entry points", ("__init__", "cli")),
    ("families", ("models",)),
    ("family helpers", ("geometry", "stats", "convert")),
    ("core", ("core",)),
    ("filters and losses", ("ops.filters",)),
    ("time shards", ("ops.shards",)),
    ("kernel wrappers", ("ops.fused_filter", "ops.fused_nll", "ops.adam_step", "ops.cuda_build")),
    ("plane algebra", ("ops.pkalman",)),
    ("dense algebra", ("ops.kalman", "ops.linalg")),
    ("base", ("ops", "tracing", "utils", "marker_array", "native")),
)


def _dotted(path: Path) -> str:
    parts = path.relative_to(PACKAGE).with_suffix("").parts
    if parts[-1] == "__init__" and len(parts) > 1:
        parts = parts[:-1]
    return ".".join(parts)


MODULES = sorted(_dotted(p) for p in PACKAGE.rglob("*.py") if "_build" not in p.parts)


def _box(module: str) -> int:
    best, best_len = None, -1
    for i, (_, members) in enumerate(BOXES):
        for m in members:
            if (module == m or module.startswith(m + ".")) and len(m) > best_len:
                best, best_len = i, len(m)
    assert best is not None, f"{module} belongs to no box of the layering: add it to BOXES"
    return best


def _is_module(dotted: str) -> bool:
    path = PACKAGE.joinpath(*dotted.split("."))
    return path.with_suffix(".py").is_file() or (path / "__init__.py").is_file()


def _is_package(module: str) -> bool:
    return module == "__init__" or (PACKAGE.joinpath(*module.split(".")) / "__init__.py").is_file()


def _targets(node, module: str) -> list:
    """The package modules an import statement names, as dotted names."""
    if isinstance(node, ast.Import):
        names = [a.name for a in node.names]
        return ["__init__" if n == "eks_tpu_torch" else n[len("eks_tpu_torch."):]
                for n in names if n == "eks_tpu_torch" or n.startswith("eks_tpu_torch.")]
    if node.level:  # relative: resolve against the importing module's package
        base = module.split(".") if _is_package(module) else module.split(".")[:-1]
        base = base[:len(base) - (node.level - 1)]
        prefix = ".".join(base + ([node.module] if node.module else []))
    elif node.module == "eks_tpu_torch" or (node.module or "").startswith("eks_tpu_torch."):
        prefix = node.module[len("eks_tpu_torch."):] if node.module != "eks_tpu_torch" else ""
    else:
        return []
    out = []
    for a in node.names:
        sub = f"{prefix}.{a.name}" if prefix else a.name
        out.append(sub if _is_module(sub) else (prefix or "__init__"))
    return out


def _source(module: str) -> ast.Module:
    path = PACKAGE / "__init__.py" if module == "__init__" else PACKAGE.joinpath(*module.split("."))
    path = path / "__init__.py" if path.is_dir() else path.with_suffix(".py")
    return ast.parse(path.read_text(), filename=str(path))


def _imports(tree: ast.Module, module: str):
    """(line, target module, inside a function) of every package import."""
    found = []

    def walk(node, in_function):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.Import, ast.ImportFrom)):
                found.extend((child.lineno, t, in_function) for t in _targets(child, module))
            walk(child, in_function or isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)))

    walk(tree, False)
    return found


@pytest.mark.parametrize("module", MODULES)
def test_imports_point_one_way(module):
    """No package import sits inside a function, and each names a module of
    the importer's own box or of a box to its right."""
    own = _box(module)
    imports = _imports(_source(module), module)
    local = [f"line {ln}: {t}" for ln, t, in_fn in imports if in_fn]
    assert not local, f"{module} imports package modules inside functions: {local}"
    left = [f"line {ln}: {t} ({BOXES[_box(t)][0]})" for ln, t, _ in imports
            if t != module and _box(t) < own]
    assert not left, f"{module} ({BOXES[own][0]}) imports from boxes to its left: {left}"


def test_every_box_names_modules_that_exist():
    """The layering names no module the package does not have, and the
    façade is imported by no module outside it."""
    for _, members in BOXES:
        for m in members:
            assert m == "__init__" or _is_module(m), m
    importers = {m for m in MODULES for _, t, _ in _imports(_source(m), m)
                 if t.split(".")[0] == "parallel" and m.split(".")[0] != "parallel"}
    assert not importers, importers
