"""A run of each cell through its own files at the test sizes on the CPU,
and the command's refusal without a card."""
import json
import math
import sys
import types

import pytest
import torch

from perfbench import harness, run

SEED = 2 ** 31 + 11


def _well_formed(out: dict, workload: str, trace: bool) -> None:
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "check"
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 4
    bench = harness.benchmark()
    want = {m["name"]: m["unit"] for m in bench["per_layer" if trace else "end_to_end"]
            if workload in m.get("workloads", [workload])}
    got = {k: v["unit"] for k, v in out["metrics"].items()}
    # the device's readings need the card's profiler; the rest are read here
    device_only = {"decode_roofline.reason", "device_idle.reason"}
    assert set(want) - set(got) <= device_only and set(got) <= set(want)
    assert all(got[k] == want[k] for k in got)
    assert all(math.isfinite(v["value"]) for v in out["metrics"].values())
    assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert out["check"]["logit_gap"]["value"] <= out["check"]["logit_gap"]["limit"]
    json.loads(json.dumps(out))


@pytest.mark.parametrize("workload,trace", [("stablelm-1.6b.reason", True),
                                            ("mamba2-2.7b.reason", False)])
def test_cell_runs_at_test_sizes(workload, trace):
    out = harness.run_cell(workload, SEED, 1.0, trace, device="cpu", small=harness.TEST_SIZES)
    _well_formed(out, workload, trace)


def test_command_refuses_without_a_card(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "stablelm-1.6b.reason", "--seed", str(SEED),
                   "--seconds", "1", "--trace", "0"])
    captured = capsys.readouterr()
    assert rc != 0 and captured.out == ""
    assert "card" in captured.err


def test_command_refuses_with_jax_loaded(capsys, monkeypatch):
    """Once the window has closed, a process that holds JAX prints no result."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(harness, "run_cell", lambda *a, **k: {"correct": True})
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    rc = run.main(["--workload", "mamba2-2.7b.reason", "--seed", "1", "--seconds", "1"])
    captured = capsys.readouterr()
    assert rc != 0 and captured.out == "" and "jax" in captured.err
