"""A cell, a configuration, a traffic mix and a per-layer metric are added
by adding files and entries: in a copy of the benchmark, new files for
each make a new cell run and report the new metric, and no file that was
there changes."""

import hashlib
import json
import os
import shutil
import subprocess
import sys

from portbench import harness
from portbench.tests import tiny


def digest(root):
    out = {}
    for base, _dirs, files in os.walk(root):
        if "__pycache__" in base:
            continue
        for f in files:
            path = os.path.join(base, f)
            out[os.path.relpath(path, root)] = hashlib.sha256(
                open(path, "rb").read()).hexdigest()
    return out


def test_a_cell_from_new_files_only(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(harness.HERE, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), root)
    before = digest(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())

    config = tiny.config("stvqa-fp32")
    config["name"] = "tiny-fp32"
    (root / "portbench/configs/tiny-fp32.json").write_text(json.dumps(config))
    mix = tiny.traffic("offline-b64", **tiny.OFFLINE)
    mix["items"] = 16
    (root / "portbench/traffic/mini-offline.json").write_text(json.dumps(mix))
    (root / "portbench/metrics/collate_calls.offline.py").write_text(
        "def read(record):\n"
        "    spans = record.get('spans', {}).get('collate')\n"
        "    return float(len(spans)) if spans else None\n")
    cell = "tiny-fp32.mini-offline"
    (root / f"portbench/limits/{cell}.json").write_text(json.dumps(
        {"offline.choice": 1e-4, "offline.score": 1e-4}))
    bench["configs"].append({"name": "tiny-fp32", "source": "https://example.org",
                             "file": "portbench/configs/tiny-fp32.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": cell, "config": "tiny-fp32",
                               "traffic": "mini-offline", "chips": 1,
                               "why": "test"})
    for m in bench["end_to_end"]:
        if m["name"] in ("offline_questions_per_s",):
            m["workloads"].append(cell)
    bench["per_layer"].append({
        "name": "collate_calls.offline", "unit": "count", "better": "lower",
        "source": "program_counter", "layer": "host pipeline",
        "moves": "offline_questions_per_s", "workloads": [cell]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    after = digest(root)
    changed = [k for k in before if after.get(k) != before[k]]
    assert changed == ["BENCHMARK.json"]

    code = (
        "import json\n"
        "from portbench import harness\n"
        f"line, out = harness.local({cell!r}, 5, 0.2, trace=True)\n"
        "value = harness.reader('collate_calls.offline')(out.record)\n"
        "print(json.dumps([line['correct'], sorted(line['metrics']), value,"
        " harness.HERE]))\n"
    )
    env = dict(os.environ, PYTHONPATH=f"{root}{os.pathsep}{harness.ROOT}")
    done = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=str(root), timeout=600)
    assert done.returncode == 0, done.stderr[-3000:]
    correct, metrics, value, here = json.loads(done.stdout.strip().splitlines()[-1])
    assert here == str(root / "portbench")
    assert correct
    assert metrics == ["collate_calls.offline"]
    assert value and value >= 2
