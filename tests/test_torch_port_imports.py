"""The port stands alone: no module under ruart_tpu_torch/, and not
chip_smoke.py, imports jax, flax, optax or the JAX package ruart_tpu."""

import ast
import pathlib

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ruart_tpu")
SOURCES = sorted((REPO / "ruart_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"
]


def _imported_roots(path: pathlib.Path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


def test_scan_sees_the_package():
    names = {p.relative_to(REPO).as_posix() for p in SOURCES}
    for name in ("ruart_tpu_torch/serve.py", "ruart_tpu_torch/ops/attention.py",
                 "ruart_tpu_torch/cli/serve_main.py", "ruart_tpu_torch/ops/quant.py",
                 "ruart_tpu_torch/utils/gctune.py", "chip_smoke.py",
                 "ruart_tpu_torch/data/image_features.py",
                 "ruart_tpu_torch/models/fusion/convert.py",
                 "ruart_tpu_torch/models/bert/convert.py",
                 "ruart_tpu_torch/parallel/distributed.py",
                 "ruart_tpu_torch/parallel/mesh.py",
                 "ruart_tpu_torch/parallel/layers.py",
                 "ruart_tpu_torch/parallel/launch.py",
                 "ruart_tpu_torch/eval/sharded.py"):
        assert name in names


@pytest.mark.parametrize(
    "path", SOURCES, ids=[p.relative_to(REPO).as_posix() for p in SOURCES]
)
def test_no_reference_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"
