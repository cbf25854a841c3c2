"""The crash tool (``tools/torch_train_graph_crash.py``) and its native-stack
helper (``tools/native_stack.py``) on the CPU:

* the tool's options parse (``--form smoke``, ``--gc``, ``--skip``) and
  refuse a phase that the smoke forms cannot leave out, or phase 9
  without phase 11 (which reads what 9 writes);
* its lifetime log records a captured graph, the profiler sessions, and
  the graph's destruction with the generation of the collection that
  freed it; its ``--gc`` hook collects just before, or inside, 13 (c)'s
  first profiled graph replay of each timing run, and nowhere else;
* where g++ is present, the helper builds, and a child Python that
  segfaults prints the native stack (each frame's library and offset)
  to stderr and to its file, then faulthandler's Python stack, and dies
  of SIGSEGV;
* ``maybe_initialize_distributed`` joins a world on CUDA when ``device``
  is None and raises without a card; the CPU only when named.
"""

import gc
import json
import pathlib
import shutil
import signal
import subprocess
import sys
import types

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))
sys.path.insert(0, str(REPO))

import native_stack  # noqa: E402
import torch_train_graph_crash as tool  # noqa: E402
from ruart_tpu_torch.parallel import distributed  # noqa: E402
from ruart_tpu_torch.utils.graphs import Graph, SignatureGraphs  # noqa: E402


def test_options_parse():
    args = tool.parser().parse_args(
        ["--form", "smoke", "--gc", "inside", "--skip", "1,8,12",
         "--reps", "12", "--runs", "3", "--logs", "x"])
    assert (args.form, args.gc, args.skip, args.reps, args.runs) == (
        "smoke", "inside", {1, 8, 12}, 12, 3)
    assert "form smoke, gc inside" in tool.options(args)
    defaults = tool.parser().parse_args([])
    assert (defaults.form, defaults.gc, defaults.skip) == ("after", "none",
                                                           frozenset())
    for bad in (["--skip", "6"], ["--skip", "9"], ["--gc", "sometimes"],
                ["--form", "x"]):
        with pytest.raises(SystemExit):
            tool.parser().parse_args(bad)


class _Profile:
    def start(self):
        pass

    def stop(self):
        pass


class _Graph:
    pass


class _Graphs(SignatureGraphs):
    """Captures a plain object as the graph."""

    def _capture(self, key, args):
        return Graph(_Graph(), (), None, (), 0.0), None


def test_lifetime_log_and_collector_hook(tmp_path, monkeypatch):
    fake_torch = types.SimpleNamespace(
        autograd=types.SimpleNamespace(_profiler_enabled=lambda: True),
        profiler=types.SimpleNamespace(profile=_Profile))
    monkeypatch.setattr(_Profile, "start", _Profile.start)
    monkeypatch.setattr(_Profile, "stop", _Profile.stop)
    lifetimes = tool.Lifetimes(str(tmp_path / "log.jsonl"))
    gc.disable()   # the one collection is the hook's
    try:
        lifetimes.hook(fake_torch, _Graphs)
        graphs = _Graphs(lambda x: x, "cpu")
        graphs(torch.zeros(2))
        prof = _Profile()
        prof.start()
        prof.stop()
        loop = [graphs]
        loop.append(loop)   # freed by the collector only
        del graphs, loop

        for mode in ("inside", "before"):
            def timing(arms, setup):
                for _ in range(6):
                    cs.profile_counts(lambda: lifetimes.write("replay"))

            cs = types.SimpleNamespace(train_graph_timing=timing,
                                       profile_counts=lambda fn: fn())
            tool.Collector(mode, cs, lifetimes)
            cs.train_graph_timing(None, None)
            cs.profile_counts(lambda: None)   # outside a timing run: no hook
    finally:
        gc.enable()
        gc.callbacks.remove(lifetimes._collector)
    events = [json.loads(line) for line in (tmp_path / "log.jsonl").open()]
    names = [e["event"] for e in events]
    assert names[:3] == ["captured", "session start", "session stop"]
    destroyed = [e for e in events if e["event"] == "destroyed"]
    assert len(destroyed) == 1 and destroyed[0]["graph"] == 1
    assert destroyed[0]["gc"] == 2 and destroyed[0]["profiler"] is True
    inside = names.index("gc.collect inside the session")
    assert names[inside - 1:inside + 4] == [
        "replay", "gc.collect inside the session", "destroyed",
        "gc.collect inside the session: done", "replay"]
    before = names.index("gc.collect before the session")
    assert names[before - 1] == "replay" and names[before + 2] == "replay"
    assert names.count("replay") == 12


@pytest.fixture(scope="module")
def helper():
    if shutil.which("g++") is None:
        pytest.skip("no g++ on the PATH")
    return native_stack.build()


def test_native_stack_of_a_segfault(helper, tmp_path):
    stack = tmp_path / "run.stack"
    child = (
        "import ctypes, faulthandler, sys\n"
        f"sys.path.insert(0, {str(REPO / 'tools')!r})\n"
        "import native_stack\n"
        "faulthandler.enable(all_threads=True)\n"
        f"native_stack.install({str(stack)!r})\n"
        "assert native_stack.active()\n"
        "def deep():\n"
        "    ctypes.string_at(0)\n"
        "deep()\n")
    proc = subprocess.run([sys.executable, "-c", child], capture_output=True,
                          text=True, timeout=60)
    assert proc.returncode == -signal.SIGSEGV
    err = proc.stderr
    assert "native stack: signal 11" in err and "native stack: end" in err
    assert err.index("native stack: end") < err.index(
        "Fatal Python error: Segmentation fault")
    assert "in deep" in err                      # faulthandler's frame
    frames = [line for line in stack.read_text().splitlines()
              if line.startswith("#")]
    assert any("libc.so" in f and "+0x" in f for f in frames)


def test_distributed_needs_a_card_unless_the_cpu_is_named(monkeypatch):
    opt = {"coordinator_address": "localhost:9", "num_processes": 1,
           "process_id": 0}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(distributed, "is_initialized", lambda: False)
    joined = []
    monkeypatch.setattr(distributed.dist, "init_process_group",
                        lambda backend, **kw: joined.append(backend))
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError, match="no CUDA card"):
            distributed.maybe_initialize_distributed(dict(opt), device)
    assert joined == []
    assert distributed.maybe_initialize_distributed(dict(opt), "cpu")
    assert joined == ["gloo"]
    assert distributed.maybe_initialize_distributed({}, None) is False
