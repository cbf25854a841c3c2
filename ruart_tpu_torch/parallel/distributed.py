"""Multi-process execution plumbing — port of
``ruart_tpu/parallel/distributed.py``.

A JAX *device* on a mesh is a torch *rank* here, and each rank drives one
card (or, on the CPU, one process). The JAX multi-host recipe carries over:

* every rank runs the SAME program; ``torch.distributed`` connects them
  through a ``tcp://`` rendezvous (NCCL on CUDA, gloo on the CPU);
* one global (dp, tp) rank grid spans all hosts — ``tp`` stays inside a
  host, so its per-layer reduces never leave it, while ``dp`` crosses
  hosts (the gradient reduce is once per step);
* every rank collates the full global batch and keeps its
  ``process_batch_slice`` of the per-sample rows (``make_global_batch``).

Single-process behavior is unchanged: every entry point degrades to a
no-op or the identity when there is one rank.

Conf keys (all optional; ``coordinator_address`` triggers initialization):

    coordinator_address   host:port of rank 0 (the tcp rendezvous)
    num_processes         world size (default 1)
    process_id            this process's rank (default 0)
    local_device_ids      the CUDA card of this rank (one id: a rank drives
                          one card; default process_id % visible cards)
"""

from __future__ import annotations

import logging
import socket
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

log = logging.getLogger(__name__)


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def world_rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago (for a local
    rendezvous)."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def local_device_id(opt: Dict[str, Any]) -> Optional[int]:
    """The CUDA card of this rank: ``local_device_ids`` (one id), else
    ``process_id`` modulo the visible cards; None without a card."""
    if "local_device_ids" in opt:
        ids = [int(t) for t in str(opt["local_device_ids"]).split(",") if t]
        if len(ids) != 1:
            raise ValueError(
                f"local_device_ids {opt['local_device_ids']!r}: a rank drives "
                "one card; start one process per card"
            )
        return ids[0]
    if not torch.cuda.is_available():
        return None
    return int(opt.get("process_id", 0)) % torch.cuda.device_count()


def maybe_initialize_distributed(opt: Dict[str, Any], device=None,
                                 backend: Optional[str] = None) -> bool:
    """``torch.distributed.init_process_group`` when the conf asks for it.

    ``device`` is the rank's torch device type or device: CUDA when None,
    which raises RuntimeError when no card is visible; the CPU only when
    the caller names it. The backend is NCCL for CUDA and gloo for the
    CPU unless ``backend`` names one (gloo also takes CUDA tensors, which
    lets several ranks share one card, as NCCL does not). On CUDA the
    rank's card (:func:`local_device_id`) becomes the current device.
    Returns True when a process group exists. Safe to call unconditionally
    and more than once."""
    if is_initialized():
        return True
    if "coordinator_address" not in opt:
        return False
    kind = torch.device("cuda" if device is None else device).type
    if kind == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "maybe_initialize_distributed: no CUDA card is visible; name "
            "device='cpu' to join the world on the CPU")
    if backend is None:
        backend = "nccl" if kind == "cuda" else "gloo"
    world = int(opt.get("num_processes", 1))
    rank = int(opt.get("process_id", 0))
    if kind == "cuda":
        torch.cuda.set_device(local_device_id(opt))
    address = str(opt["coordinator_address"])
    if "://" not in address:
        address = "tcp://" + address
    dist.init_process_group(backend, init_method=address, world_size=world,
                            rank=rank)
    log.info("torch.distributed initialized (%s): rank %d/%d", backend,
             rank, world)
    return True


def hybrid_mesh_shape(
    n_devices: int,
    n_hosts: int,
    tp: int = 1,
) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """((ici_dp, tp), (dcn_dp, 1)) factorization of a global rank count.

    ``tp`` must fit inside one host's ranks (tp collectives are per-layer
    and must stay on the host's links); the data-parallel axis factors into
    dcn_dp = n_hosts (outer, across hosts) x ici_dp (inner, on the host).
    """
    assert n_devices % n_hosts == 0, (n_devices, n_hosts)
    per_host = n_devices // n_hosts
    if tp > per_host or per_host % tp:
        raise ValueError(
            f"tensor_parallel={tp} must divide the per-host device count "
            f"{per_host} (tp collectives must stay on ICI)"
        )
    return (per_host // tp, tp), (n_hosts, 1)


def make_hybrid_mesh(tp: int = 1):
    """Global (dp, tp) mesh over every rank, host-major: the hosts are
    found by name, ranks of one host must be consecutive, and tp stays
    inside a host (:func:`hybrid_mesh_shape` raises otherwise). With one
    host this is ``mesh.auto_mesh(tp)``."""
    from ruart_tpu_torch.parallel.mesh import auto_mesh, make_mesh

    world = world_size()
    if world == 1:
        return auto_mesh(tp=tp)
    hosts = [None] * world
    dist.all_gather_object(hosts, socket.gethostname())
    order = list(dict.fromkeys(hosts))
    if [order.index(h) for h in hosts] != sorted(order.index(h) for h in hosts):
        raise ValueError(f"ranks are not host-major: {hosts}")
    hybrid_mesh_shape(world, len(order), tp)
    return make_mesh(range(world), tp=tp)


_FETCH_FALLBACKS = 0


def fetch_fallback_count() -> int:
    """How many :func:`fetch_local_first` calls had to gather over tp."""
    return _FETCH_FALLBACKS


def fetch_local_first(x: torch.Tensor, mesh=None, dim: Optional[int] = None,
                      materialize: bool = True) -> Optional[np.ndarray]:
    """Host copy of a parameter (or optimizer slot) for a save.

    A leaf replicated over the mesh (``dim`` None) is copied from this
    rank, with no traffic. A leaf sharded over tp on ``dim`` is gathered
    from the ranks of this rank's tp group (``all_gather``; every rank of
    the mesh must call, in the same order) and counted in
    :func:`fetch_fallback_count`. Only a rank with ``materialize`` builds
    the array; the others return None (rank 0 is the only writer)."""
    global _FETCH_FALLBACKS
    if dim is None or mesh is None or mesh.tp == 1:
        return x.detach().cpu().numpy() if materialize else None
    _FETCH_FALLBACKS += 1
    parts = [torch.empty_like(x) for _ in range(mesh.tp)]
    dist.all_gather(parts, x.detach().contiguous(), group=mesh.tp_group)
    if not materialize:
        return None
    return torch.cat(parts, dim=dim).cpu().numpy()


def process_batch_slice(
    n: int, process_index: Optional[int] = None,
    process_count: Optional[int] = None,
) -> slice:
    """A contiguous slice of a global batch of ``n`` samples: rows
    [index*n/count, (index+1)*n/count). ``process_index`` and
    ``process_count`` default to this rank and the world size; the mesh
    passes its dp index and dp size (every rank of a tp group holds the
    same rows)."""
    p = process_count if process_count is not None else world_size()
    r = process_index if process_index is not None else world_rank()
    assert n % p == 0, f"global batch {n} not divisible by {p} processes"
    per = n // p
    return slice(r * per, (r + 1) * per)


def make_global_batch(
    local_tree: Any,
    mesh,
    device,
    n_global: Optional[int] = None,
    replicated_keys: Sequence[str] = (),
):
    """This rank's device tensors from its slice of the global batch.

    ``local_tree`` holds host tensors whose dim 0 is this rank's
    ``process_batch_slice`` of the global batch (dicts of them, a tensor,
    or None), except the dict keys in ``replicated_keys``: batch-global
    tables (dedup/pack tables, ``cand_sel``), which every rank collated
    identically and passes whole. On a rank the local rows ARE its shard of
    the global batch, so this moves them to ``device`` (non-blocking from
    pinned memory; a tensor under several keys moves once) after checking
    that ``n_global`` (default: local rows x dp) is what the mesh divides.
    """
    rep = frozenset(replicated_keys)
    dp = mesh.dp if mesh is not None else 1
    moved: Dict[int, torch.Tensor] = {}

    def put(key, x):
        if x is None:
            return None
        if key not in rep:
            rows = n_global if n_global is not None else x.shape[0] * dp
            if rows != x.shape[0] * dp:
                raise ValueError(f"batch key {key!r}: {x.shape[0]} local rows "
                                 f"x dp {dp} != {rows} global rows")
        d = moved.get(id(x))
        if d is None:
            d = x.to(device, non_blocking=True)
            moved[id(x)] = d
        return d

    def walk(tree, key=None):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if isinstance(tree, (tuple, list)):
            return type(tree)(walk(v, key) for v in tree)
        return put(key, tree)

    return walk(local_tree)
