"""The crash tool (``tools/torch_train_graph_crash.py``) and its native-stack
helper (``tools/native_stack.py``) on the CPU:

* the tool's options parse (``--form smoke``, ``--gc``, ``--skip``) and
  refuse a phase that the smoke forms cannot leave out, or phase 9
  without phase 11 (which reads what 9 writes), or 10 without 12;
* ``--form release``, on a ``chip_smoke`` whose device parts are fakes
  that log each call and whether a profiler session is open: the kept
  train step and engine capture first, then per rep the owners capture,
  a session replays the kept train graph and the eval graphs, outside any
  session the engines are quantized and closed and a train step gets a
  new state (its capture), and a second session replays the same; phase
  13 (g) of the smoke releases its one train step between its two
  sessions;
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


def test_release_form_options():
    args = tool.parser().parse_args(
        ["--form", "release", "--skip", "1,4,5,7,8,9,11", "--reps", "3"])
    assert (args.form, args.skip, args.reps) == (
        "release", {1, 4, 5, 7, 8, 9, 11}, 3)
    assert "form release" in tool.options(args)
    with pytest.raises(SystemExit):   # 12 (f) reads the files 10 writes
        tool.parser().parse_args(["--form", "release", "--skip", "10"])


class _Ref:
    """A weak-referenceable stand-in for a CUDA graph."""


class _FakeGraphs:
    """A ``SignatureGraphs`` stand-in holding ``n`` graphs."""

    def __init__(self, n):
        self.graphs = {i: Graph(_Ref(), (), None, (), 0.0) for i in range(n)}

    def __len__(self):
        return len(self.graphs)


class _Owners:
    """Fake train steps and engines that log each call with whether a
    profiler session is open; releases drop their graphs as the port's
    API does."""

    def __init__(self):
        self.events, self.session = [], False

    def log(self, event):
        self.events.append((event, self.session))

    def profile_counts(self, fn):
        self.log("session start")
        self.session = True
        fn()
        self.session = False
        self.log("session stop")
        return 0.0, 0.0, 0, 0, 4

    def step(self, name):
        owners = self

        class Step:
            graphs = None

            def __call__(self, state, *batch):
                if self.graphs is None or state is not self.state:
                    self.state, self.graphs = state, _FakeGraphs(2)
                    owners.log(f"capture {name}")
                else:
                    owners.log(f"replay {name}")
                return state, 0.0

            def release(self):
                self.graphs = _FakeGraphs(0)
                owners.log(f"release {name}")

        return Step()

    def engine(self, name):
        owners = self

        class Engine:
            batch_size = 16
            eval_step = _FakeGraphs(0)

            @property
            def graph_count(self):
                return len(self.eval_step)

            def predict(self, reqs):
                verb = "replay" if self.graph_count else "capture"
                self.eval_step = self.eval_step or _FakeGraphs(3)
                owners.log(f"{verb} {name}")

            def quantize(self):
                self.eval_step = _FakeGraphs(0)
                owners.log(f"quantize {name}")

            def close(self):
                self.eval_step = _FakeGraphs(0)
                owners.log(f"close {name}")

        return Engine()


@pytest.fixture
def fake_smoke(monkeypatch):
    """``chip_smoke`` with its device parts replaced by :class:`_Owners`."""
    import chip_smoke as cs

    owners = _Owners()
    made = iter(range(100))

    def train_arm(setup, opt, graphs, device="cuda"):
        name = ("kept" if "LOCK_BERT" in opt else "lock_off") + str(next(made))
        return owners.step(name), object(), [(0,)] * 10

    monkeypatch.setattr(cs, "profile_counts", owners.profile_counts)
    monkeypatch.setattr(cs, "log", lambda *a: None)
    monkeypatch.setattr(cs, "requests", lambda: [{}] * 40)
    monkeypatch.setattr(cs, "train_arm", train_arm)
    monkeypatch.setattr(cs, "run_arm", lambda step, state, batches: [
        step(state, *b) for b in batches])
    monkeypatch.setattr(cs, "build_engine", lambda impl, params=None, device=None:
                        (owners.engine(f"engine{next(made)}"), params))
    setup = {"opt": {"LOCK_BERT": 1}, "params": {}, "batches": [(0,)] * 5}

    def drive(label, fn, n, bf16=False, exact=False):
        return fn()

    monkeypatch.setattr(cs, "run", lambda phase13, skip: phase13(setup, drive))
    return cs, owners, setup, drive


def _outside(events):
    """The events between each session's stop and the next one's start."""
    spans, current = [], None
    for event, in_session in events:
        if event == "session stop":
            current = []
        elif event == "session start":
            if current is not None:
                spans.append(current)
            current = None
        elif current is not None:
            assert not in_session
            current.append(event)
    return spans


def test_release_form_frees_owners_between_two_sessions(fake_smoke, tmp_path,
                                                        capsys):
    cs, owners, _, _ = fake_smoke
    lifetimes = tool.Lifetimes(str(tmp_path / "log.jsonl"))
    args = tool.parser().parse_args(["--form", "release", "--reps", "2"])
    try:
        tool.release_form(cs, args, lifetimes)
    finally:
        gc.enable()
        gc.callbacks.remove(lifetimes._collector)
    events = [e for e, _ in owners.events]
    sessions = [owners.events[i + 1:j] for i, j in zip(
        *[[k for k, (e, _) in enumerate(owners.events) if e == name]
          for name in ("session start", "session stop")])]
    assert len(sessions) == 4
    for inside in sessions:   # the kept train graph, then the eval graphs
        assert [e for e, _ in inside] == ["replay kept0", "replay engine1"]
        assert all(s for _, s in inside)
    between = _outside(owners.events)
    assert len(between) == 3
    for rep in (0, 2):        # each rep's releases, outside any session
        assert [e.split()[0] for e in between[rep]] == [
            "quantize", "close", "capture"]
    assert events.index("capture kept0") < events.index("capture engine1") \
        < events.index("session start")
    assert events.count("capture engine1") == 1   # no new capture
    out = capsys.readouterr().out
    assert out.count("10 of 10 graphs destroyed between two profiler "
                     "sessions, graph launches [4, 4]") == 2


def test_smoke_phase_13g_releases_one_owner_between_sessions(fake_smoke):
    cs, owners, setup, drive = fake_smoke
    kept = cs.train_arm(setup, setup["opt"], True)
    cs.run_arm(*kept)
    cs.released_graphs({"graph": kept[:2]}, setup, drive)
    between = _outside(owners.events)
    assert between == [["release lock_off2"]]
    assert [e for e, _ in owners.events].count("session start") == 2
