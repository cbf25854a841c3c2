"""One CUDA graph per batch signature: the port's counterpart of ``jax.jit``.

The JAX package runs each batch as one dispatch of the XLA executable
compiled for its signature (``make_eval_step`` is ``jax.jit(eval_step)``).
PyTorch runs eagerly, one launch per op (~730 for a serving forward), so
the host's launch time sets the pace. :class:`SignatureGraphs` wraps a step
function and keeps one captured ``torch.cuda.CUDAGraph`` per input
signature, replayed as one launch.

* **The signature** (:func:`signature`) is the key of the jit cache: the
  tree of the arguments (dict keys, a None argument such as absent
  targets) and each tensor's shape and dtype.
* **The first call of a signature** copies its arguments into static
  input tensors (every dict key its own copy, also where one tensor stands
  under several keys, so a later call may alias its keys differently)
  and runs the step on them eagerly on a side stream: that run is the
  call, and its results are returned. It also does the lazy set-up a
  capture must not see (the kernel's build and its shared-memory
  attribute, cuDNN's plans, cuBLAS's workspace). Then the step is
  captured on that stream for the signature's later calls; a capture
  executes nothing, so a step that updates state (a train step) takes
  exactly one update per call. Later calls copy their arguments into the
  static inputs and replay.
* **Random numbers:** each generator in ``generators`` is registered with
  every graph (``CUDAGraph.register_generator_state``): a replay reads
  the generator's state at its launch and advances it as the eager step
  would, so it draws what the eager step would draw. A generator used in
  a capture without being registered makes the capture fail.
* **Outputs** of a replay are the graph's static outputs, which the next
  replay of the same graph, or of another graph of the same pool,
  overwrites: the caller copies them out (or enqueues the copy,
  ``data.pipeline.fetch_async``) before that replay, on the same stream.
  Copies and replays run on the caller's current stream.
* **Memory:** the graphs of one :class:`SignatureGraphs` share one memory
  pool of their own. The graphs never run concurrently (one stream), so
  one graph's intermediates may reuse another's; whatever must outlive a
  replay (parameters, optimizer state, the generator's state, static
  inputs) is allocated outside the pool.
* **Threads:** the capture runs with ``capture_error_mode="thread_local"``:
  another thread's CUDA calls (a serving front end's host-to-device copies
  and pinned allocations) do not invalidate it. One thread calls the step
  at a time.
* **Launch counts:** a kernel wrapper counts a launch when Python calls it,
  which a replay does not do. Each graph records how far the counters of
  ``ops.attention`` moved during its capture, takes that back (a capture
  launches nothing) and adds it at each replay, so every call counts what
  an eager call would.
* **Failures raise.** A capture or a replay that fails raises RuntimeError
  naming the signature; nothing falls back to eager. ``eager_when`` names
  the one call-time condition under which the caller wants the step run
  eagerly (``record_intermediates``, whose lists a replay cannot fill).
* **Lifetime:** an owner that stops using its graphs calls
  :meth:`SignatureGraphs.release`, which frees them there and then:
  after a synchronize, each graph is reset, and the static tensors, the
  pool and the side stream are dropped. A later call captures its
  signature anew. Nothing here refers back to its owner, so an owner
  dropped without ``release`` frees its graphs when its last reference
  goes, never at a later run of Python's cyclic collector, which starts
  at an arbitrary allocation: train graphs freed by a collection between
  two profiler sessions made the next profiled replay of another graph
  segfault inside CUPTI's callback on ``cuGraphLaunch`` (PERF.md,
  section 6).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ruart_tpu_torch.ops.attention import add_launches, launch_counts


def signature(args) -> Tuple:
    """The jit-cache key of a call's arguments: their tree (dicts by sorted
    key, None kept) with (shape, dtype) at each tensor."""
    def leaf(x):
        if x is None:
            return None
        if isinstance(x, dict):
            return tuple((k, leaf(v)) for k, v in sorted(x.items()))
        return tuple(x.shape), x.dtype

    return tuple(leaf(a) for a in args)


def static_inputs(args, device: torch.device):
    """Fresh tensors on ``device`` holding ``args``' values: one per dict
    key, aliased keys included."""
    def copy(x):
        if x is None:
            return None
        if isinstance(x, dict):
            return {k: copy(v) for k, v in x.items()}
        return torch.empty(x.shape, dtype=x.dtype, device=device).copy_(x)

    return tuple(copy(a) for a in args)


def copy_into(static, args) -> None:
    """Copy ``args`` into the static tensors of the same signature."""
    for s, a in zip(static, args):
        if isinstance(s, dict):
            for k, t in s.items():
                t.copy_(a[k], non_blocking=True)
        elif s is not None:
            s.copy_(a, non_blocking=True)


def release(step) -> None:
    """``step.release()`` for a :class:`SignatureGraphs`; an eager step
    holds no graphs."""
    if isinstance(step, SignatureGraphs):
        step.release()


@dataclasses.dataclass
class Graph:
    """One captured signature: its graph, static inputs and outputs, the
    kernel launches one replay makes, and the seconds of the signature's
    first call (its eager run and the capture)."""

    graph: Any
    inputs: Tuple
    outputs: Any
    launches: Tuple[int, ...]
    seconds: float


class SignatureGraphs:
    """``fn(*args)`` replayed from one CUDA graph per :func:`signature` of
    ``args`` (see the module doc); ``fn`` returns a tensor or a tuple of
    tensors and reads only its arguments, the generators in
    ``generators`` and state whose storage stays in place (parameters and
    moments updated in place)."""

    def __init__(self, fn: Callable, device: torch.device,
                 eager_when: Optional[Callable[[], bool]] = None,
                 generators: Tuple[torch.Generator, ...] = ()):
        self.fn = fn
        self.device = torch.device(device)
        self.eager_when = eager_when
        self.generators = tuple(generators)
        self.graphs: Dict[Tuple, Graph] = {}
        self.pool = None     # made at the first capture
        self._stream = None

    def __len__(self) -> int:
        return len(self.graphs)

    def release(self) -> None:
        """Free every graph now: wait for the device, reset each graph,
        drop the static inputs and outputs, the pool and the side stream.
        A later call captures its signature anew."""
        if self.graphs:
            torch.cuda.synchronize(self.device)
            for entry in self.graphs.values():
                entry.graph.reset()
        self.graphs = {}
        self.pool = self._stream = None

    def __call__(self, *args):
        if self.eager_when is not None and self.eager_when():
            return self.fn(*args)
        key = signature(args)
        entry = self.graphs.get(key)
        if entry is None:
            self.graphs[key], result = self._capture(key, args)
            return result
        copy_into(entry.inputs, args)
        try:
            entry.graph.replay()
        except RuntimeError as e:
            raise RuntimeError(f"CUDA graph replay failed for signature "
                               f"{key}: {e}") from e
        add_launches(entry.launches)
        return entry.outputs

    def _capture(self, key, args) -> Tuple[Graph, Any]:
        """The signature's first call, run eagerly on the side stream, then
        its capture. Returns the graph and the call's results."""
        t0 = time.perf_counter()
        try:
            if self.pool is None:
                self.pool = torch.cuda.graph_pool_handle()
                self._stream = torch.cuda.Stream(self.device)
            inputs = static_inputs(args, self.device)
            caller = torch.cuda.current_stream(self.device)
            self._stream.wait_stream(caller)
            with torch.cuda.stream(self._stream):
                result = self.fn(*inputs)  # this call, and the lazy set-up
            graph = torch.cuda.CUDAGraph()
            for generator in self.generators:
                graph.register_generator_state(generator)
            before = launch_counts()
            with torch.cuda.graph(graph, pool=self.pool, stream=self._stream,
                                  capture_error_mode="thread_local"):
                outputs = self.fn(*inputs)
            launches = tuple(a - b for a, b in zip(launch_counts(), before))
            add_launches(tuple(-n for n in launches))
            caller.wait_stream(self._stream)
        except RuntimeError as e:
            raise RuntimeError(f"CUDA graph capture failed for signature "
                               f"{key}: {e}") from e
        return Graph(graph, inputs, outputs, launches,
                     time.perf_counter() - t0), result
