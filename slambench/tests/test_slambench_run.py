"""A small run of the harness on the CPU (the look for a card skipped):
sound, it is correct and leaves no JAX name in ``sys.modules``; with the
program's timed path broken underneath, ``correct`` comes out false. And on
the card, the control: the reference in bfloat16 in the program's place
fails the check."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
ROOT = HERE.parents[1]


def tiny(fault: str, seed: int = 4100000001) -> dict:
    out = subprocess.run([sys.executable, str(HERE / "_tiny_run.py"), fault, str(seed)],
                         capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    res = json.loads(lines[-1])
    res["check_line"] = next(json.loads(l)["check"] for l in lines if l.startswith('{"check"'))
    return res


def test_sound_run_is_correct():
    res = tiny("sound")
    assert res["correct"] and res["attempted"] > 0 and res["failed"] == 0
    assert res["check_line"]["steps_checked"] >= 4
    assert set(res["metrics"]) == {"scans_per_s", "scan_ms_p95", "setup_s"}
    assert list(res)[:6] == ["correct", "attempted", "failed", "metrics", "device", "check"]


@pytest.mark.parametrize("fault", ["frozen", "moved", "half_batch"])
def test_a_broken_step_is_not_correct(fault):
    res = tiny(fault)
    assert res["correct"] is False, res["check"]


CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_on_the_card(card, cell):
    out = subprocess.run([sys.executable, str(ROOT / "slambench" / "control.py"),
                          "--workload", cell, "--seeds", "4100000011,4100000012,4100000013",
                          "--seconds", "25"],
                         capture_output=True, text=True, timeout=1500, cwd=ROOT)
    assert out.returncode == 0, (out.stdout[-3000:], out.stderr[-3000:])
    verdicts = json.loads(out.stdout.strip().splitlines()[-1])["verdicts"]
    assert len(verdicts) == 3
    assert all(v["correct"] and not v["control_correct"] for v in verdicts)
