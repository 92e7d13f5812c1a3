"""Per-frame launch budget of the port: the eager-tail regression guard.

The counterpart of tests/test_dispatch_budget.py. There one frame is a
handful of XLA modules; in the port every PyTorch operator is at least
one kernel, so a frame's launch count is what grows when glue leaks in
without any pixel going wrong. utils/dispatch_count.count_dispatches
counts, on the CPU, the ATen operator calls of one steady-state 64x64
frame of each mode (state warmed over two frames) on
testing.make_test_scene; the card's kernel launches are printed by
chip_smoke.py.

Budgets = the measured count (on this scene: pt 3561, deferred
1678, restir 7998, forward 1353, deferred with the full post chain
10117; the same over every frame measured) plus about 10%. Raising a
budget is a deliberate act with a number attached, not a silent drift.
"""

from __future__ import annotations

import pytest
import torch

from prosper_tpu_torch.entry import entry
from prosper_tpu_torch.utils.dispatch_count import count_dispatches

torch.set_num_threads(2)
MEASURED = {"pt": 3561, "deferred": 1678, "restir": 7998, "forward": 1353,
            "deferred_full": 10117}
BUDGETS = {"pt": 3920, "deferred": 1850, "restir": 8800, "forward": 1490,
           "deferred_full": 11130}
EXTRA_KW = {"deferred_full": dict(use_taa=True, use_bloom=True, use_dof=True,
                                  use_particles=True)}
MODE_OF = {"deferred_full": "deferred"}
W = H = 64


@pytest.mark.parametrize("case", sorted(BUDGETS))
def test_frame_launch_budget(case):
    fn, (scene, cam, _) = entry("cpu", scene="test", width=W, height=H,
                                mode=MODE_OF.get(case, case),
                                **EXTRA_KW.get(case, {}))
    _, state, _ = fn(scene, cam, 0)
    _, state, _ = fn(scene, cam, 1, state)
    counted = {}
    with count_dispatches(counted, "cpu"):
        img, _, _ = fn(scene, cam, 2, state)
    assert img.shape == (H, W, 3)
    assert counted["n"] == sum(counted["by_name"].values())
    assert counted["n"] <= BUDGETS[case], (
        f"{case}: {counted['n']} ATen calls in one frame (budget "
        f"{BUDGETS[case]}, measured {MEASURED[case]}); the most called: "
        f"{counted['by_name'].most_common(8)}")
    assert counted["n"] >= MEASURED[case] // 2  # the count sees the frame
