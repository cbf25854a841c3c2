"""The kernel sweep of ``tools/torch_kernel_sanitize.py`` (run on the card
by ``chip_smoke.py`` phase 1 (g)): its cases reach every template instance
of the attention library by the sources' own dispatch, its names match
the profiler's and c++filt's, its guard bands show a write past an
output, the kernel wrappers' ``out=`` (the guarded output) refuses any
tensor the kernel would not fill exactly, and phase 1 (g) reads
compute-sanitizer's summaries and passes a child without a verdict only
on the one failure seen where the sanitizer cannot attach."""

import pathlib
import re
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402
import torch_kernel_sanitize as ks  # noqa: E402
from ruart_tpu_torch.ops.attention import _check_out  # noqa: E402

CSRC = REPO / "ruart_tpu_torch" / "csrc"


def _widths(source, pattern):
    return sorted({int(w) for w in re.findall(pattern, source.read_text())})


def test_dispatch_widths_match_the_sources():
    """kernel_of mirrors the sources' dispatch: the bf16 kernel pads dh to
    16, 32, 48, 64, 96 or 128, the fp32 one to multiples of 32."""
    bf16 = _widths(CSRC / "attention_bf16.cu", r"integral_constant<int, (\d+)>")
    fp32 = _widths(CSRC / "attention.cu", r"launch_dp<T, (\d+)>")
    assert bf16 == [16, 32, 48, 64, 96, 128] and fp32 == [32, 64, 96, 128]
    for dh in range(8, 129, 8):
        for dtype, widths in (("bfloat16", bf16), ("float32", fp32)):
            name = ks.kernel_of(dict(op="rows", dtype=dtype, dh=dh, L=16,
                                     bias_2d=True))
            assert f"<{min(w for w in widths if w >= dh)}," in name.replace(
                "float,", "")


def test_cases_reach_every_kernel_of_the_library():
    """24 bf16 kernels (6 widths x 2 bias forms x one or more key tiles),
    8 fp32 K1/K2 kernels and 4 K3 kernels on bf16 inputs: 36."""
    names = {ks.kernel_of(c) for c in ks.cases()}
    assert len(names) == 36
    assert sum(n.startswith("attention_bf16_kernel<") for n in names) == 24
    assert sum(n.startswith("attention_kernel<float,") for n in names) == 8
    assert sum(n.startswith("attention_kernel<__nv_bfloat16,")
               for n in names) == 4


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cases_hold_the_edges(dtype):
    rows = [c for c in ks.cases() if c["dtype"] == dtype and c["op"] == "rows"]
    assert {c["L"] for c in rows} >= {1, 16, 31, 32, 33, 64, 65, 512}
    assert any(c["B"] * -(-c["L"] // min(64, -(-c["L"] // 16) * 16)) > 65535
               for c in rows)  # rows x query tiles past the grid's y limit
    assert {c["bias_2d"] for c in rows if c["unaligned"]} == {True, False}
    assert {c["L"] > 32 for c in rows if c["unaligned"]} == {True, False}
    flash = [c for c in ks.cases() if c["dtype"] == dtype and c["op"] == "flash"]
    assert any(c["strided"] for c in flash)


def test_race_cases_are_the_race_checks_shapes():
    assert ks.RACE_SHAPES == chip_smoke.RACE_SHAPES
    assert {(c["B"], c["L"], c["H"], c["dh"], c["bias_2d"])
            for c in ks.cases(race=True)} == set(chip_smoke.RACE_SHAPES)


@pytest.mark.parametrize("name", [
    "void (anonymous namespace)::attention_bf16_kernel<64, true, false>("
    "__nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16 const*, "
    "float const*, __nv_bfloat16*, int, int, int, (anonymous namespace)::Plan,"
    " bool, float)",
    "(anonymous namespace)::attention_bf16_kernel<64, true, false>",
    "attention_bf16_kernel<64,true,false>(...)",
])
def test_normalize_agrees_across_demanglers(name):
    assert ks.normalize(name) == "attention_bf16_kernel<64,true,false>"


def test_library_kernels_reads_the_ptxas_report():
    """Entry names of a -Xptxas -v report, demangled by c++filt."""
    mangled = subprocess.run(
        ["c++filt", "--version"], capture_output=True, text=True)
    if mangled.returncode:
        pytest.fail("c++filt is missing")
    report = ("ptxas info    : Compiling entry function "
              "'_ZN12_GLOBAL__N_116attention_kernelIfLi64ELb1EEEvPKT_S3_S3_"
              "PKfPf' for 'sm_90a'\nptxas info    : Used 96 registers\n")
    assert ks.library_kernels(report) == ["attention_kernel<float,64,true>"]


def test_guard_bands_show_a_write_past_the_output():
    out = ks.GuardedOut((3, 5), torch.float32, device="cpu")
    assert torch.isnan(out.tensor).all() and out.guards_intact()
    out.tensor.fill_(1.0)
    assert out.guards_intact()
    out.buf[out.g + 15] = 1.0  # one element past the end
    assert not out.guards_intact()


@pytest.mark.parametrize("shift", [0, 1])
def test_guarded_copy_sits_between_nan_bands(shift):
    x = torch.arange(12, dtype=torch.bfloat16).view(3, 4)
    g = ks.guarded(x, shift)
    assert torch.equal(g, x) and g.is_contiguous()
    assert (g.data_ptr() % 16 == 0) == (shift == 0)
    base = g.storage_offset()
    flat = torch.as_strided(g, (g.untyped_storage().nbytes() // 2,), (1,), 0)
    assert torch.isnan(flat[:base]).all()
    assert torch.isnan(flat[base + x.numel():]).all()


@pytest.mark.parametrize("tool,out,want", [
    ("memcheck", "========= ERROR SUMMARY: 0 errors\n", 0),
    ("memcheck", "========= ERROR SUMMARY: 3 errors\n", 3),
    ("synccheck", "========= ERROR SUMMARY: 1 error\n", 1),
    ("racecheck", "========= RACECHECK SUMMARY: 0 hazards displayed "
                  "(0 errors, 0 warnings)\n", 0),
    ("racecheck", "========= RACECHECK SUMMARY: 1 hazard displayed "
                  "(1 error, 0 warnings)\n", 1),
    ("memcheck", "Traceback (most recent call last):\n", None),
])
def test_sanitizer_summaries_are_read(tool, out, want):
    assert chip_smoke.sanitizer_errors(tool, out) == want


SHAPE = (3, 16, 64)
CPU = torch.device("cpu")


def test_out_none_is_a_new_tensor():
    out = _check_out(None, SHAPE, torch.bfloat16, CPU, "attention_rows_cuda")
    assert out.shape == SHAPE and out.dtype == torch.bfloat16
    assert out.device == CPU and out.is_contiguous()


def test_out_given_is_written_in_place():
    buf = torch.full((2 * 3 * 16 * 64,), float("nan"))
    out = buf[3 * 16 * 64:].view(SHAPE)  # a window of a larger buffer
    assert _check_out(out, SHAPE, torch.float32, CPU, "flash") is out


@pytest.mark.parametrize("bad", [
    lambda: torch.empty(3, 16, 32),                       # shape
    lambda: torch.empty(SHAPE, dtype=torch.bfloat16),     # dtype
    lambda: torch.empty(3, 64, 16).transpose(1, 2),       # not contiguous
    lambda: torch.empty(SHAPE, device="meta"),            # device
], ids=["shape", "dtype", "contiguity", "device"])
def test_out_refuses_what_the_kernel_would_not_fill(bad):
    with pytest.raises(ValueError, match="attention_rows_cuda: out must be"):
        _check_out(bad(), SHAPE, torch.float32, CPU, "attention_rows_cuda")


NOT_ATTACHED = """========= COMPUTE-SANITIZER
========= Error: Device not supported. Please refer to the "Supported \
Devices" section of the sanitizer documentation
Traceback (most recent call last):
torch.AcceleratorError: CUDA error: unknown error
========= Target application returned an error
========= ERROR SUMMARY: 1 error
"""
RESULT = {"mode": "sweep", "launches": 213}


@pytest.mark.parametrize("rc, out, result, want", [
    (1, NOT_ATTACHED, {}, True),
    (0, NOT_ATTACHED, {}, False),             # the child passed: a verdict
    (1, NOT_ATTACHED, RESULT, False),         # the sweep ran: a verdict
    (1, NOT_ATTACHED.replace("CUDA error: unknown error",
                             "CUDA error: out of memory"), {}, False),
    (1, NOT_ATTACHED.replace("Device not supported", "Invalid access"),
     {}, False),
    (1, "========= ERROR SUMMARY: 2 errors\n", RESULT, False),
], ids=["not-attached", "rc0", "launched", "other-cuda-error",
        "other-sanitizer-error", "errors"])
def test_sanitizer_not_attached_only_on_its_signature(rc, out, result, want):
    assert chip_smoke.sanitizer_not_attached(rc, out, result) is want
