"""Nothing the benchmark runs imports JAX or the JAX package (``repro``;
top-level names compared whole, since the port's ``repro_torch`` starts
with it), and the reference imports nothing of the port."""
import ast
import subprocess
import sys

from benchcore import spec

BENCH = spec.ROOT / "bench"


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module.split(".")[0]


def test_no_jax_under_bench():
    for path in BENCH.rglob("*.py"):
        tops = set(_imports(path))
        assert not tops & {"jax", "jaxlib", "flax", "repro"}, path


def test_reference_imports_nothing_of_the_port():
    for path in (BENCH / "reference").rglob("*.py"):
        assert "repro_torch" not in set(_imports(path)), path


def test_run_process_loads_no_jax(tmp_path):
    """A CPU run of a cell in a fresh process leaves no JAX module loaded."""
    code = (
        "import sys\n"
        f"sys.path[:0] = [{str(BENCH / 'tests')!r}, {str(BENCH)!r}, "
        f"{str(spec.ROOT / 'src')!r}]\n"
        "from conftest import cpu_context\n"
        "import run\n"
        "out, _ = run.run_cell(cpu_context('yi-6b.chat', seconds=0.5))\n"
        "from benchcore.program import forbidden_modules\n"
        "print('FORBIDDEN', forbidden_modules(), out['correct'])\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path)
    assert "FORBIDDEN [] True" in res.stdout, res.stdout + res.stderr
