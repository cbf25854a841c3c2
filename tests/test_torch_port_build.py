"""What a build of the port needs: the wheel carries every native source
(pyproject.toml's package data), and the attention library is rebuilt when
any of its CUDA sources is newer than it (``ops.attention.build_kernel``;
nvcc is replaced here by a stand-in that writes its output files)."""

import fnmatch
import os
import pathlib
import tomllib

import pytest

from ruart_tpu_torch.ops import attention as att

REPO = pathlib.Path(__file__).resolve().parent.parent
PACKAGE = REPO / "ruart_tpu_torch"
NATIVE = sorted(p for ext in ("*.cc", "*.cu") for p in PACKAGE.rglob(ext))


def _package_data():
    with open(REPO / "pyproject.toml", "rb") as f:
        return tomllib.load(f)["tool"]["setuptools"]["package-data"]


def test_scan_sees_every_native_source():
    names = {p.relative_to(REPO).as_posix() for p in NATIVE}
    assert {"ruart_tpu_torch/csrc/attention.cu",
            "ruart_tpu_torch/csrc/attention_bf16.cu",
            "ruart_tpu_torch/native/phoc.cc",
            "ruart_tpu_torch/native/fastcollate.cc"} <= names
    assert {p.resolve() for p in att.SOURCES} <= {p.resolve() for p in NATIVE}


@pytest.mark.parametrize(
    "path", NATIVE, ids=[p.relative_to(REPO).as_posix() for p in NATIVE])
def test_native_source_is_package_data(path):
    """Each source matches a glob of the package that holds it (setuptools
    reads a package's globs relative to the package's directory)."""
    rel = path.relative_to(REPO)
    for package, globs in _package_data().items():
        root = pathlib.Path(*package.split("."))
        if root in rel.parents and any(
                fnmatch.fnmatch(rel.relative_to(root).as_posix(), g)
                for g in globs):
            return
    pytest.fail(f"{rel} is in no [tool.setuptools.package-data] glob")


@pytest.fixture
def fake_build(tmp_path, monkeypatch):
    """The build's paths under ``tmp_path`` and nvcc replaced by a stand-in
    that records each command and writes its ``-o`` file. Returns the list
    of recorded commands."""
    sources = []
    for src in att.SOURCES:
        copy = tmp_path / "csrc" / src.name
        copy.parent.mkdir(exist_ok=True)
        copy.write_text("// stand-in\n")
        sources.append(copy)
    build_dir = tmp_path / "_build"
    monkeypatch.setattr(att, "SOURCES", tuple(sources))
    monkeypatch.setattr(att, "BUILD_DIR", build_dir)
    monkeypatch.setattr(att, "LIBRARY", build_dir / att.LIBRARY.name)
    calls = []

    def run(cmds):
        calls.extend(cmds)
        for cmd in cmds:
            out = cmd[cmd.index("-o") + 1]
            pathlib.Path(out).write_text("built\n")
        return [(0, f"ptxas info for {cmd[-1]}\n") for cmd in cmds]

    monkeypatch.setattr(att, "_run", run)
    return calls


def _age(path, seconds):
    t = path.stat().st_mtime - seconds
    os.utime(path, (t, t))


def test_build_compiles_each_source_and_links_one_library(fake_build):
    report = att.build_kernel()
    compiles = [c for c in fake_build if "-c" in c]
    assert [c[-1] for c in compiles] == [str(s) for s in att.SOURCES]
    [link] = [c for c in fake_build if "-shared" in c]
    assert att.LIBRARY.read_text() == "built\n"
    assert all(str(s) in report for s in att.SOURCES)
    # only the library is left in the build folder: objects and the
    # temporary library are gone
    assert os.listdir(att.BUILD_DIR) == [att.LIBRARY.name]
    assert not att.stale() and "-gencode" in link


@pytest.mark.parametrize("touched", [0, 1], ids=["attention.cu",
                                                 "attention_bf16.cu"])
def test_touching_either_source_rebuilds(fake_build, touched):
    att.build_kernel()
    for src in att.SOURCES:
        _age(src, 10)
    del fake_build[:]
    assert att.build_kernel() == "" and fake_build == []  # up to date
    os.utime(att.SOURCES[touched])  # now: newer than the library
    assert att.stale()
    assert att.build_kernel() != "" and len(fake_build) == 3


def test_failed_compile_raises_naming_the_source(fake_build, monkeypatch):
    def fail(cmds):
        return [(1 if "attention_bf16" in cmd[-1] else 0, "error: nope\n")
                for cmd in cmds]

    monkeypatch.setattr(att, "_run", fail)
    with pytest.raises(RuntimeError, match="attention_bf16.cu"):
        att.build_kernel()
    assert not att.LIBRARY.exists() and os.listdir(att.BUILD_DIR) == []


def _project():
    with open(REPO / "pyproject.toml", "rb") as f:
        return tomllib.load(f)["project"]


@pytest.mark.parametrize("script", ["ruart-torch-train", "ruart-torch-predict"])
def test_port_script_target_imports_and_is_callable(script):
    """The port's install entry points name a callable of the port, beside
    the JAX package's two scripts."""
    import importlib

    scripts = _project()["scripts"]
    module, attr = scripts[script].split(":")
    assert module.startswith("ruart_tpu_torch.cli.")
    assert callable(getattr(importlib.import_module(module), attr))
    assert scripts["ruart-train"] == "ruart_tpu.cli.main:main"
    assert scripts["ruart-predict"] == "ruart_tpu.cli.main_test:main"


def test_torch_extra_names_torch():
    assert "torch" in _project()["optional-dependencies"]["torch"]
