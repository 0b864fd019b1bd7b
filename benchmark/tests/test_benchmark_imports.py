"""No module of the benchmark imports JAX, Flax or the JAX package, and the
plain reference imports nothing of the port: top-level names compared
whole (the port's name begins with the JAX package's)."""

import ast
import pathlib
import subprocess
import sys

import pytest

HERE = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "basis_universal_tpu"}


def imported_tops(path: pathlib.Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_in_the_benchmark(path):
    assert not imported_tops(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_port(path):
    tops = imported_tops(path)
    assert "basis_universal_tpu_torch" not in tops
    assert tops <= {"binascii", "functools", "struct", "numpy", "torch",
                    "zstandard"}, tops
    # its relative imports stay inside the reference
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.level:
            assert node.level == 1


def test_whole_names_are_compared():
    from benchmark.harness import forbidden_modules

    assert "basis_universal_tpu_torch".split(".")[0] not in FORBIDDEN
    before = set(sys.modules)
    sys.modules["basis_universal_tpu_torch_probe"] = object()
    try:
        assert "basis_universal_tpu" not in forbidden_modules()
    finally:
        for k in set(sys.modules) - before:
            del sys.modules[k]


def test_a_run_loads_no_jax():
    """The harness, the reference and the port in one fresh process leave
    no forbidden module in sys.modules."""
    code = ("import sys; sys.path.insert(0, '.');"
            "from benchmark import harness, check, trace;"
            "from benchmark.reference import verify;"
            "import basis_universal_tpu_torch.compressor;"
            "print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=HERE.parent,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
