"""``correct`` comes out false when the timed path is broken underneath, and
the 4-bit control comes out not correct by the same comparison: runs at the
test sizes on the CPU through the harness (the look for a card skipped),
one for each fault a one-card serving cell can have (``faults.py``)."""
import pytest

from perfbench import harness
from perfbench.faults import FAULTS

SEED = 2 ** 31 + 23
CELLS = ("stablelm-1.6b.reason", "mamba2-2.7b.reason")


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", CELLS)
def test_a_broken_timed_path_is_not_correct(workload, fault):
    out = harness.run_cell(workload, SEED, 1.0, False, device="cpu", small=harness.TEST_SIZES,
                           patch=FAULTS[fault])
    assert out["correct"] is False
    assert out["check"]["logit_gap"]["value"] > out["check"]["logit_gap"]["limit"]


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_is_not_correct(workload):
    out = harness.run_cell(workload, SEED, 1.0, False, device="cpu",
                           small=harness.TEST_SIZES, control=True)
    assert out["correct"] is True
    assert out["control_correct"] is False
    ctl = out["check"]["control_gap"]
    assert ctl["value"] > 3 * ctl["limit"]
