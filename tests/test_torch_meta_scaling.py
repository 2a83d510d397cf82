"""The scaling policy of the port (``repro_torch.core.scaling``): the
twin of ``tests/test_meta_scaling.py::TestScalingPolicy`` with its
assertions, and ``plan_scaling`` equal to the reference's over a grid of
chip counts, populations, simulation parallelism and preferences."""
import itertools

import pytest

from repro.core import scaling as ref
from repro_torch.core.scaling import (PRESET_HORIZONTAL, PRESET_VERTICAL,
                                      ScalingPlan, plan_scaling)

CHIPS = (1, 3, 8, 64, 256, 3072)
POPS = (1, 10, 512, 4096)
SIM = (1, 2, 100, 2004)
PREFER = ("auto", "horizontal", "vertical")


class TestScalingPolicy:
    def test_presets_match_paper_table3(self):
        assert PRESET_HORIZONTAL.chips == 3072 == PRESET_VERTICAL.chips
        assert PRESET_HORIZONTAL.horizontal == 384
        assert PRESET_VERTICAL.vertical == 128

    def test_auto_plan_respects_sim_parallelism(self):
        plan = plan_scaling(256, pop_total=512, sim_parallelism=1)
        assert plan.vertical == 1 and plan.horizontal == 256
        plan = plan_scaling(256, pop_total=512, sim_parallelism=2004)
        assert plan.vertical > 1
        assert plan.horizontal * plan.vertical <= 256 * 2

    def test_prefer_modes(self):
        assert plan_scaling(64, pop_total=10, prefer="horizontal") \
            == ScalingPlan(64, 1)
        v = plan_scaling(64, pop_total=10, sim_parallelism=100,
                         prefer="vertical")
        assert v.vertical == 64


@pytest.mark.parametrize("prefer", PREFER)
def test_plan_scaling_matches_reference(prefer):
    for chips, pop, sim in itertools.product(CHIPS, POPS, SIM):
        got = plan_scaling(chips, pop_total=pop, sim_parallelism=sim,
                           prefer=prefer)
        want = ref.plan_scaling(chips, pop_total=pop, sim_parallelism=sim,
                                prefer=prefer)
        assert (got.horizontal, got.vertical, got.chips) == \
            (want.horizontal, want.vertical, want.chips), \
            (chips, pop, sim, prefer)


def test_presets_match_reference():
    for mine, theirs in ((PRESET_HORIZONTAL, ref.PRESET_HORIZONTAL),
                         (PRESET_VERTICAL, ref.PRESET_VERTICAL)):
        assert (mine.horizontal, mine.vertical) == \
            (theirs.horizontal, theirs.vertical)
