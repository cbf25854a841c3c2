"""Arithmetic of the Moonlight cell's per-layer readers
(``metrics/<name>.train-llm.py``). Each takes the run's record and returns
a number, or None where the run has nothing to read (another path, no
trace, no such kernel launched)."""

from __future__ import annotations

from typing import Any, Dict, Optional

from portbench import peaks, readers

KIND = "train_llm"
MOE_GEMM = ("moe_gemm_kernel",)
MLA = ("attention_bf16_kernel<192",)
ROUTE = ("moe_route_kernel", "moe_permute_kernel", "moe_combine_kernel")


def kernel_s(record: Dict[str, Any], names) -> float:
    tr = record.get("trace") or {}
    return sum(s for n, s in tr.get("kernel_s", {}).items()
               if any(k in n for k in names))


def roofline(record, work_key: str, names) -> Optional[float]:
    """Least time for the window's calls of a kernel (bytes over the HBM
    rate or operations over the bf16 peak, the larger) over its summed
    kernel time in the device trace, in percent."""
    work = record.get(work_key)
    if not readers.of_kind(record, KIND) or not record.get("trace") or (
            not work or not work.get("bytes")):
        return None
    seconds = kernel_s(record, names)
    if seconds <= 0:
        return None
    least = max(work["bytes"] / peaks.HBM_BYTES_PER_S,
                work["flops"] / peaks.FLOP_PER_S[work["dtype"]])
    return 100.0 * least / seconds


def route_pct(record) -> Optional[float]:
    """The routing, permutation and combine kernels' share of the window's
    device time (the union of its kernels, copies and memsets)."""
    tr = record.get("trace")
    if not readers.of_kind(record, KIND) or not tr or tr["busy_s"] <= 0:
        return None
    seconds = kernel_s(record, ROUTE)
    return 100.0 * seconds / tr["busy_s"] if seconds > 0 else None
