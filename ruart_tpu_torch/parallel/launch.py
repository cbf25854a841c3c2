"""Start the ranks of a ``torch.distributed`` world as child processes.

    spawn("package.module:function", nprocs, args=(...))

starts ``nprocs`` fresh Python processes, each running
``python -m ruart_tpu_torch.parallel.launch <json>``, which imports
``package.module`` and calls ``function(rank, world_size, address, *args)``
with a ``host:port`` rendezvous address on localhost that every rank shares
(the ``coordinator_address`` conf key). Each child imports only what it
names, so a parent that holds other libraries (a test process, a CLI)
passes none of them on. ``args`` must be JSON-serializable.

The CLI uses it to run one rank per visible card (``cli/main.py``); the
tests run gloo ranks on the CPU with it. :func:`spawn` waits for every rank
and raises if one fails or the time limit passes (the others are then
stopped), so a rank that dies cannot leave the rest waiting in a
collective.
"""

from __future__ import annotations

import importlib
import json
import os
import pathlib
import subprocess
import sys
import time
from typing import Dict, Optional, Sequence

from ruart_tpu_torch.parallel.distributed import free_port

_ROOT = str(pathlib.Path(__file__).resolve().parent.parent.parent)


def spawn(target: str, nprocs: int, args: Sequence = (),
          env: Optional[Dict[str, str]] = None, threads: Optional[int] = None,
          timeout: Optional[float] = None) -> None:
    """Run ``target`` (``module:function``) on ranks 0..nprocs-1 and wait.
    ``env`` adds to the children's environment; ``threads`` sets each
    child's ``torch.set_num_threads``. Raises RuntimeError naming the first
    rank that failed, or TimeoutError after ``timeout`` seconds."""
    address = f"localhost:{free_port()}"
    child_env = dict(os.environ, **(env or {}))
    child_env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_ROOT, child_env.get("PYTHONPATH")) if p)
    procs = []
    for rank in range(nprocs):
        payload = json.dumps({"target": target, "rank": rank,
                              "world": nprocs, "address": address,
                              "args": list(args), "threads": threads})
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "ruart_tpu_torch.parallel.launch", payload],
            env=child_env))
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        while True:
            codes = [p.poll() for p in procs]
            failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if failed:
                raise RuntimeError(f"rank {failed[0]} of {target} exited "
                                   f"with code {codes[failed[0]]}")
            if all(c == 0 for c in codes):
                return
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"{target} on {nprocs} ranks did not end "
                                   f"within {timeout} s")
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()


def _main(payload: str) -> None:
    job = json.loads(payload)
    if job["threads"]:
        import torch

        torch.set_num_threads(int(job["threads"]))
    module, name = job["target"].split(":")
    fn = getattr(importlib.import_module(module), name)
    fn(job["rank"], job["world"], job["address"], *job["args"])


if __name__ == "__main__":
    _main(sys.argv[1])
