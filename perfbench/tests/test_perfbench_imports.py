"""What the measured process and the reference load: never JAX or the JAX
package (top-level names compared whole: the port is ``repro_torch``),
and the reference nothing of the program."""
import ast
import subprocess
import sys

from perfbench_cells import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def _loaded_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(sorted({m.split('.')[0]"
         " for m in sys.modules}))"],
        capture_output=True, text=True, check=True,
        env={"PYTHONPATH": f"{ROOT}:{ROOT / 'src'}", "PATH": "/usr/bin:/bin"})
    return set(ast.literal_eval(out.stdout.strip().splitlines()[-1]))


def test_run_and_its_drivers_load_no_jax_and_no_reference_package():
    loaded = _loaded_after(
        "from pathlib import Path\n"
        "from perfbench import harness\n"
        f"root = Path({str(ROOT)!r})\n"
        "for w in harness.load_spec(root)['workloads']:\n"
        "    cell = harness.resolve(harness.load_spec(root), root, w['name'])\n"
        "    harness.driver_for(root, cell)\n"
        "    [harness.reader_for(root, m['name']) for m in cell.per_layer]\n"
        # what the drivers import when they run
        "import repro_torch.serving.engine, repro_torch.models.config\n"
        "import perfbench.tools.readings, perfbench.tools.sweep\n")
    assert "repro_torch" in loaded
    assert not loaded & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    loaded = _loaded_after("import perfbench.reference.mixtral\n")
    assert not loaded & (FORBIDDEN | {"repro_torch"})


def test_no_source_of_the_reference_imports_the_program():
    for path in (ROOT / "perfbench" / "reference").rglob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] not in FORBIDDEN | {"repro_torch"}, (
                path, name)


def test_no_benchmark_source_imports_jax_or_the_reference_package():
    for path in (ROOT / "perfbench").rglob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] not in FORBIDDEN, (path, name)
