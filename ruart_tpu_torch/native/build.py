"""Build the port's two native host libraries with g++ at first use.

* ``phoc.cc`` -> ``_build/libruart_torch_phoc.so``: the PHOC encoder, a
  plain C interface loaded with ctypes (``text/phoc.py``).
* ``fastcollate.cc`` -> ``_build/_ruart_torch_fastcollate<EXT_SUFFIX>``:
  the collator's fill loops, a CPython C API extension
  (``data/collate.py``). The file name carries the interpreter's
  ``EXT_SUFFIX``, so a build for another Python is never loaded; the
  module name differs from the JAX package's ``_ruart_fastcollate``, so
  a process may load both.

Copies of ``ruart_tpu/native/{phoc,fastcollate}.cc`` (``g++ -O3 -shared
-fPIC -std=c++17``, as there). A build is kept while it is newer than its
source. Each build compiles into a temporary file in ``_build/`` and
renames it into place, so processes that build at once (test workers, a
second script) never load a half-written library.
"""

from __future__ import annotations

import importlib.util
import os
import pathlib
import subprocess
import sysconfig
import tempfile
from types import ModuleType

_HERE = pathlib.Path(__file__).resolve().parent
BUILD_DIR = _HERE.parent / "_build"
PHOC_SOURCE = _HERE / "phoc.cc"
PHOC_LIBRARY = BUILD_DIR / "libruart_torch_phoc.so"
FASTCOLLATE_MODULE = "_ruart_torch_fastcollate"
FASTCOLLATE_SOURCE = _HERE / "fastcollate.cc"
FASTCOLLATE_LIBRARY = BUILD_DIR / (
    FASTCOLLATE_MODULE + sysconfig.get_config_var("EXT_SUFFIX")
)


def _build(source: pathlib.Path, library: pathlib.Path, extra: list,
           force: bool) -> pathlib.Path:
    """Compile ``source`` into ``library`` unless an up-to-date build
    exists. Raises RuntimeError with the compiler's output when g++
    fails."""
    if (not force and library.exists()
            and library.stat().st_mtime >= source.stat().st_mtime):
        return library
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", *extra,
           "-o", tmp, str(source)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:  # no g++ on the PATH
        os.unlink(tmp)
        raise RuntimeError(f"{' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed ({proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, library)
    return library


def ensure_built(force: bool = False) -> str:
    """Build the PHOC library if it is missing or stale; its path."""
    return str(_build(PHOC_SOURCE, PHOC_LIBRARY, [], force))


def load_fastcollate(force: bool = False) -> ModuleType:
    """Build the fastcollate extension if it is missing or stale, and
    import it. Raises RuntimeError (build) or ImportError (load)."""
    path = _build(FASTCOLLATE_SOURCE, FASTCOLLATE_LIBRARY,
                  ["-I" + sysconfig.get_paths()["include"]], force)
    spec = importlib.util.spec_from_file_location(FASTCOLLATE_MODULE, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
