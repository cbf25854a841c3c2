"""Nothing the benchmark runs loads the JAX side of the repo (``jax``,
``jaxlib``, ``flax``, ``optax``, ``ruart_tpu``), compared by whole
top-level module name (``ruart_tpu_torch`` is the port and allowed), and
the reference loads nothing of the port."""

import ast
import os
import subprocess
import sys

from portbench import harness

HERE = harness.HERE


def sources(folder):
    for base, _dirs, files in os.walk(folder):
        if os.sep + "tests" in base + os.sep and folder == HERE:
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(base, f)


def top_imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".", 1)[0]


def test_no_source_imports_the_jax_side():
    for path in sources(HERE):
        bad = set(top_imports(path)) & set(harness.FORBIDDEN)
        assert not bad, (path, bad)


def test_reference_sources_import_nothing_of_the_port():
    for path in sources(os.path.join(HERE, "reference")):
        tops = set(top_imports(path))
        assert "ruart_tpu_torch" not in tops and "ruart_tpu" not in tops, path


def run_python(code):
    env = dict(os.environ, PYTHONPATH=harness.ROOT)
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=harness.ROOT, timeout=600)


def test_a_run_loads_nothing_of_the_jax_side():
    code = (
        "import json, sys\n"
        "from portbench import harness\n"
        "from portbench.tests import tiny\n"
        "harness.local('stvqa-fp32.train-b16', 11, 0.2, "
        "config=tiny.config('stvqa-fp32'), "
        "traffic=tiny.traffic('train-b16', **tiny.TRAIN))\n"
        "import portbench.drivers.offline\n"
        "import portbench.control, portbench.readers\n"
        "print(json.dumps(harness.forbidden_modules()))\n"
    )
    out = run_python(code)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_reference_loads_nothing_of_the_port():
    code = (
        "import sys\n"
        "import portbench.reference.model, portbench.reference.collate\n"
        "import portbench.reference.preprocess, portbench.reference.dataset\n"
        "import portbench.reference.decoder, portbench.reference.optim\n"
        "import portbench.reference.loss, portbench.check\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & "
        "{'ruart_tpu_torch', 'ruart_tpu', 'jax', 'flax'}))\n"
    )
    out = run_python(code)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_compare_whole(monkeypatch):
    import types

    before = harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "ruart_tpu_torch.fake", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jaxfake", types.ModuleType("x"))
    assert harness.forbidden_modules() == before
    monkeypatch.setitem(sys.modules, "ruart_tpu.core", types.ModuleType("x"))
    assert "ruart_tpu" in harness.forbidden_modules()
