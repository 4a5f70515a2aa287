"""The control at a size a test run holds: the reference computed as fp8
training computes, put in the port's place, has to come out not correct,
while the port's sound steps do; and the planted faults read far above
the sound port. The same readings at the cells' own sizes come from
``python3 -m portbench.calibrate`` on the card."""
from portbench import calibrate, check
from portbench.tests import rehearsal

SEEDS = [21, 22, 23]


def test_control_fails_where_the_port_passes():
    cell = rehearsal.tiny_cell("phi3-mini-train-t16k", batch=2, seq=128,
                               vocab=512, d_model=128, d_ff=256)
    rows = calibrate.rank_readings(cell, SEEDS, SEEDS, "cpu")
    s = calibrate.summary(rows)
    limits = rehearsal.TEST_LIMITS
    launches = {"fwd": 1, "bwd": 1, "least": 1}
    for r in rows:
        assert check.verdict(r["port"], limits, launches)[0], r["port"]
        assert not check.verdict(r["control"], limits, launches)[0], \
            r["control"]
        assert not check.verdict(r["half"], limits, launches)[0], r["half"]
    # The control's least reading is three times the port's largest on
    # the gradient norms, the number that separates them.
    assert s["control"]["grad"] >= 3 * s["lower"]["grad"], s
