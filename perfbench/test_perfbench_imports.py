"""Nothing the benchmark runs loads JAX or the JAX package: a fresh process
imports the harness, every configuration's reference, every mix and metric
file and the program's serving entry, then lists its modules by top-level
name, compared whole (the program's name begins with the JAX package's)."""
import json
import os
import subprocess
import sys

from perfbench import harness

SCRIPT = """
import json, sys
from perfbench import harness
from perfbench.traffic import load_mix
bench = harness.benchmark()
for c in bench["configs"]:
    conf = json.load(open(harness.ROOT / c["file"]))
    harness.reference_module(conf["reference"])
for w in bench["workloads"]:
    load_mix(harness.BENCH / "mixes" / (w["traffic"] + ".json"))
for m in bench["end_to_end"] + bench["per_layer"]:
    harness.metric_module(m["name"])
import perfbench.run, perfbench.control
import repro_torch.serve, repro_torch.configs
print(json.dumps(sorted({k.split(".")[0] for k in sys.modules})))
"""


def test_no_jax_in_the_benchmark():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(harness.ROOT),
                                                       str(harness.ROOT / "src")]))
    out = subprocess.run([sys.executable, "-c", SCRIPT], capture_output=True, text=True,
                         cwd=harness.ROOT, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "repro_torch" in top and "perfbench" in top
    assert top.isdisjoint(harness.FORBIDDEN), sorted(top & set(harness.FORBIDDEN))
