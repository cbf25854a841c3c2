"""Arithmetic the per-layer readers (``metrics/<name>.py``) share. Each
reader takes the run's record and returns a number, or None where the run
has nothing to read (another path, no trace, no kernel launched)."""

from __future__ import annotations

from typing import Any, Dict, Optional

from portbench import peaks

K1_KERNELS = ("attention_kernel", "attention_bf16_kernel")


def of_kind(record: Dict[str, Any], kind: str) -> bool:
    return record.get("kind") == kind


def mean_ms(record, kind: str, name: str) -> Optional[float]:
    if not of_kind(record, kind):
        return None
    values = record.get("spans", {}).get(name) or []
    return 1e3 * sum(values) / len(values) if values else None


def idle_pct(record, kind: str) -> Optional[float]:
    tr = record.get("trace")
    if not of_kind(record, kind) or not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def step_mfu(record, kind: str) -> Optional[float]:
    """The least time the published peaks allow for the window's model
    FLOPs (``counts.model_flops``), over the traced window."""
    tr, flops = record.get("trace"), record.get("flops")
    if not of_kind(record, kind) or not tr or not flops:
        return None
    least = (flops["bert"] / peaks.FLOP_PER_S[record["bert_dtype"]]
             + flops["fp32"] / peaks.FLOP_PER_S["float32"])
    return 100.0 * least / tr["window_s"] if least > 0 else None


def k1_roofline(record, kind: str) -> Optional[float]:
    """Sum over K1's calls in the window of the least time (bytes over
    the HBM rate or operations over the precision's peak, the larger),
    over K1's summed kernel time in the device trace."""
    tr, k1 = record.get("trace"), record.get("k1")
    if not of_kind(record, kind) or not tr or not k1 or not k1["bytes"]:
        return None
    kernel_s = sum(s for n, s in tr["kernel_s"].items()
                   if any(k in n for k in K1_KERNELS))
    if kernel_s <= 0:
        return None
    least = max(k1["bytes"] / peaks.HBM_BYTES_PER_S,
                k1["flops"] / peaks.FLOP_PER_S[k1["dtype"]])
    return 100.0 * least / kernel_s


def captures(record, kind: str) -> Optional[float]:
    if not of_kind(record, kind) or "graph_captures" not in record:
        return None
    return float(record["graph_captures"])

