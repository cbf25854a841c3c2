"""The native stack of a crash: build ``tools/native_stack.cc`` with g++
(as ``ruart_tpu_torch/native/build.py`` builds the port's host code, into
its ignored ``_build/``) and install its fatal-signal handler.

    from tools import native_stack   # or with tools/ on sys.path
    faulthandler.enable(all_threads=True)
    native_stack.install("run.stack")  # before torch is imported

On SIGSEGV, SIGABRT, SIGBUS, SIGILL or SIGFPE the handler prints the
faulting instruction and each frame of ``backtrace()`` (library, offset
into it, symbol mangled and demangled) to stderr and to the given file,
then hands the signal to the handler it replaced: faulthandler, when that
was enabled first, prints the Python stacks of all threads after it.
"""

from __future__ import annotations

import ctypes
import importlib.util
import pathlib

REPO = pathlib.Path(__file__).resolve().parent.parent
SOURCE = REPO / "tools" / "native_stack.cc"

_loaded = []  # the library stays loaded while its handler is installed


def build(force: bool = False) -> pathlib.Path:
    """Compile the handler into ``ruart_tpu_torch/_build/`` unless an
    up-to-date build exists; its path. Raises RuntimeError when g++
    fails or is missing. ``native/build.py`` is loaded from its file, not
    as part of the package: a process that runs another checkout's port
    (``torch_train_graph_crash.py --root``) imports that one's."""
    path = REPO / "ruart_tpu_torch" / "native" / "build.py"
    spec = importlib.util.spec_from_file_location("_ruart_native_build", path)
    native_build = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(native_build)
    library = native_build.BUILD_DIR / "libruart_native_stack.so"
    return native_build._build(SOURCE, library, [], force)


def install(path: str = "") -> ctypes.CDLL:
    """Build, load and install the handler (frames also written to
    ``path`` when given). Returns the library; ``active()`` on it says
    whether the handler is still the one installed."""
    lib = ctypes.CDLL(str(build()))
    lib.ruart_native_stack_install.argtypes = [ctypes.c_char_p]
    lib.ruart_native_stack_install.restype = ctypes.c_int
    lib.ruart_native_stack_active.argtypes = []
    lib.ruart_native_stack_active.restype = ctypes.c_int
    if lib.ruart_native_stack_install(path.encode()) != 0:
        raise OSError("sigaction failed installing the native-stack handler")
    _loaded.append(lib)
    return lib


def active() -> bool:
    """True while the installed handler still receives every fatal signal
    of its set."""
    return bool(_loaded) and bool(_loaded[-1].ruart_native_stack_active())
