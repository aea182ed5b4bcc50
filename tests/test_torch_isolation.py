"""The port stands alone: no module of ``repro_torch``, not
``chip_smoke.py``, no ``experiments/torch_*.py`` script and no
``examples/torch_*.py`` example imports ``jax`` or the JAX package
``repro``; and the
host-plane modules the port copies instead of importing are verbatim
copies of their originals with ``repro.`` renamed ``repro_torch.``, but
for the departures ``EXTENDED`` and ``EDITED`` list (so the two cannot
drift apart unnoticed)."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
PORT = SRC / "repro_torch"

VERBATIM = (["config.py", "core/__init__.py", "serving/pagedkv.py",
             "data/pipeline.py"]
            + [f"configs/{p.name}"
               for p in sorted((SRC / "repro" / "configs").glob("*.py"))]
            + [f"core/genesys/{n}.py" for n in (
                "area completion heap arena memory_pool syscalls trace "
                "executor uring sched tenant fuse metrics admit table"
            ).split()])
FORBIDDEN = {"jax", "jaxlib", "repro"}
# where a copy departs from its original on purpose: the port's trace.py
# adds the training loop's named spans and the profiler's clock (each line
# of the original kept, in order); its data/pipeline.py drops the loader's
# byte count, which nothing read (each edit as an (original, port) pair)
EXTENDED = {"core/genesys/trace.py"}
EDITED = {"data/pipeline.py": (
    ('"straggler_reissues": 0, "bytes": 0}', '"straggler_reissues": 0}'),
    ('        self.stats["bytes"] += p.nbytes\n', ""))}


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


PORT_FILES = (sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
              + sorted((ROOT / "experiments").glob("torch_*.py"))
              + sorted((ROOT / "examples").glob("torch_*.py")))


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


def _keeps_in_order(lines, within) -> bool:
    """Whether ``lines`` appear in ``within`` in their order."""
    rest = iter(within)
    return all(any(line == w for w in rest) for line in lines)


@pytest.mark.parametrize("rel", VERBATIM)
def test_host_plane_copy_is_verbatim(rel):
    original = (SRC / "repro" / rel).read_text().replace("repro.",
                                                         "repro_torch.")
    port = (PORT / rel).read_text()
    for old, new in EDITED.get(rel, ()):
        assert original.count(old) == 1
        original = original.replace(old, new)
    if rel in EXTENDED:
        assert _keeps_in_order(original.splitlines(), port.splitlines())
    else:
        assert port == original


def test_the_order_check_sees_a_changed_line():
    lines = ["a", "b", "c"]
    assert _keeps_in_order(lines, ["a", "x", "b", "c", "y"])
    assert not _keeps_in_order(lines, ["a", "c", "b"])
    assert not _keeps_in_order(lines, ["a", "b2", "c"])


@pytest.mark.parametrize("rel", ["core/genesys/invoke.py",
                                 "core/genesys/__init__.py"])
def test_edited_host_plane_modules_have_no_jax(rel):
    text = (PORT / rel).read_text()
    assert not (_imported_roots(PORT / rel) & FORBIDDEN)
    assert "io_callback" not in text and "jnp." not in text
