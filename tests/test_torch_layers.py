"""The package's layers on the CPU: no module of flipviscosity3d_torch but
the on-card checker (smoke.py) imports it, and _build's launch counts cover
exactly the kernels of the checker's records table."""

import ast
from pathlib import Path

from flipviscosity3d_torch import _build, smoke

PACKAGE = Path(smoke.__file__).resolve().parent


def _imports_smoke(source: str) -> bool:
    """Whether `source` imports a module named smoke, in any form."""
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names = [getattr(node, "module", None) or ""]
            names += [a.name for a in node.names]
            if any("smoke" in n.split(".") for n in names):
                return True
    return False


def test_no_module_but_the_checker_imports_it():
    assert all(map(_imports_smoke, (
        "from .. import smoke", "from ..smoke import DT",
        "import flipviscosity3d_torch.smoke as s",
        "def f():\n    from . import smoke\n")))
    assert not _imports_smoke("import chip_smoke\nfrom . import bench")
    files = sorted(PACKAGE.rglob("*.py"))
    assert len(files) > 40
    assert [str(p.relative_to(PACKAGE)) for p in files
            if p != PACKAGE / "smoke.py" and _imports_smoke(p.read_text())
            ] == []


def test_launch_counts_cover_the_records_table_and_reset():
    wrappers = [fn for fn, _, _ in smoke.KERNELS]
    names = [fn.__name__ for fn in wrappers]
    assert sorted(_build.launch_counts()) == sorted(names)
    try:
        for i, fn in enumerate(wrappers):
            for _ in range(i + 1):
                _build.count(fn)
        counts = _build.launch_counts()
        assert [counts[k] for k in names] == list(range(1, len(names) + 1))
        assert [fn.launches for fn in wrappers] == [counts[k] for k in names]
    finally:
        _build.reset_launch_counts()
    assert set(_build.launch_counts().values()) == {0}
    assert all(fn.launches == 0 for fn in wrappers)
