"""Nothing the benchmark loads is JAX or the JAX package: the check compares
top-level module names whole (the port's name begins with the JAX
package's), a run's process holds none of them, and no architecture's
reference imports anything of the program."""

from __future__ import annotations

import ast
import subprocess
import sys
import textwrap

from portbench import core

CHILD = textwrap.dedent("""
    import sys
    sys.modules["jax"] = None          # any `import jax` now fails
    sys.modules["nemotron_tpu"] = None  # and so does the JAX package
    import portbench.run, portbench.core, portbench.judge, portbench.calibrate
    import portbench.streams, portbench.trace, portbench.readers
    import nemotron_tpu_torch.api, nemotron_tpu_torch.streaming.engine
    suite = portbench.core.Suite()
    for conf in suite.bench["configs"]:
        suite.arch(suite.config(conf["name"])["arch"])
    for kind in ("live", "backlog", "offline"):
        suite.kind(kind)
    for m in suite.bench["end_to_end"] + suite.bench["per_layer"]:
        suite.reader(m["name"])
    loaded = [m for m, v in sys.modules.items() if v is not None]
    print(portbench.core.forbidden_modules(loaded))
""")


def test_names_compare_whole():
    assert core.forbidden_modules(["nemotron_tpu_torch",
                                   "nemotron_tpu_torch.api",
                                   "jaxtyping", "flaxen"]) == []
    assert core.forbidden_modules(["nemotron_tpu", "nemotron_tpu.api",
                                   "jax", "jax.numpy", "jaxlib", "flax"]) \
        == ["flax", "jax", "jax.numpy", "jaxlib", "nemotron_tpu",
            "nemotron_tpu.api"]


def test_the_harness_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", CHILD], capture_output=True,
                         text=True, cwd=core.BENCH.parent, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_reference_imports_nothing_of_the_program():
    """Every architecture's reference.py, those of portbench/archs and the
    one the tests add (portbench/tests/tiny_ctc)."""
    paths = sorted(core.ROOT.glob("archs/*/reference.py")) \
        + sorted(core.ROOT.glob("tests/*/reference.py"))
    assert len(paths) >= 2
    for path in paths:
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
                assert node.level == 0 or not any(
                    a.name.startswith("nemotron") for a in node.names)
            for n in names:
                assert n.split(".")[0] in ("__future__", "math", "numpy",
                                           "torch"), (path, n)
