"""Every cell, configuration, traffic mix and metric of BENCHMARK.json is
found by name from a file of its own, and the file keeps to the contract's
shape."""

import json
import re

from conftest import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_every_entry_has_its_file():
    from lib.harness import load_reader
    from traffic.corridor import load_mix

    b = bench()
    for c in b["configs"]:
        conf = json.loads((ROOT / c["file"]).read_text())
        assert conf["name"] == c["name"] and "params" in conf
        assert c["file"].startswith("slambench/configs/")
    for w in b["workloads"]:
        assert (BENCH / "workloads" / f"{w['name']}.json").is_file()
        assert load_mix(w["traffic"])["world"] == "corridor_loop"
        assert w["config"] in {c["name"] for c in b["configs"]}
    for m in b["end_to_end"] + b["per_layer"]:
        assert callable(load_reader(m["name"]))


def test_names_units_and_keys():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in b[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:
            mv = next(x for x in b["end_to_end"] if x["name"] == m["moves"])
            assert "workloads" not in mv or w in mv["workloads"]
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    for w in b["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200


def test_workload_files_hold_the_sampling_and_the_limits():
    for w in bench()["workloads"]:
        wl = json.loads((BENCH / "workloads" / f"{w['name']}.json").read_text())
        assert {"warm_scans", "solver_buckets", "closure_gap_s", "samples", "trace",
                "limits"} <= set(wl)
        assert all(v >= 0 for v in wl["limits"].values())
