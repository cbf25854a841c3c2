"""The port stands alone: no module under ruart_tpu_torch/, and not
chip_smoke.py, imports jax, flax, optax or the JAX package ruart_tpu; its
native sources (C++ and CUDA) are its own copies and name nothing under
ruart_tpu/ (a build step or include that reached the JAX package's tree
would show as such a name)."""

import ast
import pathlib
import re

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ruart_tpu")
TOOLS = [REPO / "tools" / name for name in (
    "torch_kernel_sanitize.py", "torch_train_graph_crash.py",
    "native_stack.py")]
SOURCES = sorted((REPO / "ruart_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"
] + TOOLS
NATIVE = sorted(p for ext in ("*.cc", "*.cu")
                for p in (REPO / "ruart_tpu_torch").rglob(ext))
JAX_PACKAGE = re.compile(r"\bruart_tpu\b(?!_torch)")


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
                 "ruart_tpu_torch/eval/sharded.py",
                 "ruart_tpu_torch/text/phoc.py", "ruart_tpu_torch/ops/phoc.py",
                 "ruart_tpu_torch/native/build.py",
                 "ruart_tpu_torch/data/debug.py",
                 "ruart_tpu_torch/models/fusion/introspect.py",
                 "ruart_tpu_torch/models/fusion/conv.py",
                 "ruart_tpu_torch/train/schedules.py",
                 "ruart_tpu_torch/eval/coqa.py",
                 "ruart_tpu_torch/utils/timing.py",
                 "ruart_tpu_torch/utils/graphs.py"):
        assert name in names
    native = {p.relative_to(REPO).as_posix() for p in NATIVE}
    assert native == {"ruart_tpu_torch/csrc/attention.cu",
                      "ruart_tpu_torch/csrc/attention_bf16.cu",
                      "ruart_tpu_torch/csrc/gemm_tf32x3.cu",
                      "ruart_tpu_torch/csrc/moe_bf16.cu",
                      "ruart_tpu_torch/native/phoc.cc",
                      "ruart_tpu_torch/native/fastcollate.cc"}


@pytest.mark.parametrize(
    "path", SOURCES, ids=[p.relative_to(REPO).as_posix() for p in SOURCES]
)
def test_no_reference_imports(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


@pytest.mark.parametrize(
    "path", NATIVE, ids=[p.relative_to(REPO).as_posix() for p in NATIVE]
)
def test_native_sources_are_the_ports_own(path):
    """The copies under native/ name nothing of the JAX package at all;
    the CUDA port may cite the TPU kernels it replaces in comments, but
    no include, string or symbol names the JAX package."""
    text = path.read_text()
    if path.parent.name != "native":
        text = re.sub(r"//[^\n]*|/\*.*?\*/", "", text, flags=re.S)
    bad = sorted({m.group(0) for m in JAX_PACKAGE.finditer(text)})
    assert not bad, f"{path.relative_to(REPO)} names the JAX package: {bad}"
    # the CPython extension's module name differs from the JAX package's
    assert "_ruart_fastcollate" not in text.replace("_ruart_torch_fastcollate", "")

