"""The port stands alone: no module of ``repro_torch``, and not
``chip_smoke.py``, imports ``jax`` or the JAX package ``repro``; and the
host-plane modules the port copies instead of importing are verbatim
copies of their originals with ``repro.`` renamed ``repro_torch.`` (so the
two cannot drift apart unnoticed)."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
PORT = SRC / "repro_torch"

VERBATIM = (["config.py", "core/__init__.py", "serving/pagedkv.py"]
            + [f"configs/{p.name}"
               for p in sorted((SRC / "repro" / "configs").glob("*.py"))]
            + [f"core/genesys/{n}.py" for n in (
                "area completion heap arena memory_pool syscalls trace "
                "executor uring sched tenant fuse metrics admit table"
            ).split()])
FORBIDDEN = {"jax", "jaxlib", "repro"}


def _imported_roots(path: Path) -> set[str]:
    """Top-level package of every import in ``path``, including string
    arguments of ``import_module``/``__import__`` calls."""
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and node.args and getattr(
                node.func, "attr", getattr(node.func, "id", None)) in (
                    "import_module", "__import__"):
            arg = node.args[0]
            if isinstance(arg, ast.JoinedStr):
                arg = arg.values[0]
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                roots.add(arg.value.split(".")[0])
    return roots


PORT_FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_jax_package(path):
    assert path.exists()
    assert not (_imported_roots(path) & FORBIDDEN)


def test_scan_sees_the_forbidden_imports():
    """The scan itself would catch a violation."""
    assert {"jax", "repro"} <= _imported_roots(
        SRC / "repro" / "core" / "genesys" / "invoke.py")
    assert "repro" in _imported_roots(SRC / "repro" / "configs" /
                                      "__init__.py")


@pytest.mark.parametrize("rel", VERBATIM)
def test_host_plane_copy_is_verbatim(rel):
    original = (SRC / "repro" / rel).read_text()
    assert (PORT / rel).read_text() == original.replace("repro.",
                                                        "repro_torch.")


@pytest.mark.parametrize("rel", ["core/genesys/invoke.py",
                                 "core/genesys/__init__.py"])
def test_edited_host_plane_modules_have_no_jax(rel):
    text = (PORT / rel).read_text()
    assert not (_imported_roots(PORT / rel) & FORBIDDEN)
    assert "io_callback" not in text and "jnp." not in text
