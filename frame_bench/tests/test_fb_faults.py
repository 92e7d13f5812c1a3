"""The comparison is shown to fail: the bfloat16 control, and a run whose
timed path is broken underneath, come out not correct.

The harness's look for a card is skipped (the runs are on the CPU at
64x64); the rest of a run is driven as on the card. The faults a frame
cell can have: a frame that returns its state unchanged (an accumulating
mode's; a deferred frame's state is the HiZ pyramid, which hides no
cluster of the plate scene, so the same frame comes out); half of the
pixels left out of the frame's sample or image; the frame's sample or
image altered where it is produced; the frame's count altered; and in
the accumulating modes a sample count that stays at 1 or goes up by 2
a frame. (One chip: no exchange between chips.)"""

import json
import time

import pytest
import torch

from frame_bench.harness import bench, program, spec


MODES = ["restir", "pt", "deferred-culled"]


@pytest.mark.parametrize("mode", MODES)
def test_control_fails(tiny_root, mode, capsys):
    """The reference with bfloat16 shading in the program's place fails
    one of the cell's limits (those of the full-size cell) on 3 seeds."""
    from frame_bench import readings

    limits = spec.cell(f"plate2048-1k.{mode}")["check"]["limits"]
    assert readings.main(["--workload", f"tiny.{mode}", "--seeds", "1,2,3",
                          "--frames", "4", "--control", "--device", "cpu",
                          "--root", str(tiny_root)]) == 0
    for line in capsys.readouterr().out.strip().splitlines():
        got = json.loads(line)["control"]
        assert any(got[k] > limits[k] for k in limits), got


def _state_unchanged(fn):
    def f(scene, cam, i, state):
        img, new, stat = fn(scene, cam, i, state)
        return img, (new if state is None else state), stat
    return f


def _sample(acc, cnt, prev):
    """The sample a frame added to its running mean."""
    return acc if prev is None else prev + (acc - prev) * cnt[..., None]


def _half_left_out(fn):
    def f(scene, cam, i, state):
        img, (acc, cnt), stat = fn(scene, cam, i, state)
        h = acc.shape[0] // 2
        prev = torch.zeros_like(acc) if state is None else state[0]
        acc = torch.cat([prev[:h], acc[h:]])  # top half: no sample
        return img, (acc, cnt), stat
    return f


def _sample_altered(fn):
    def f(scene, cam, i, state):
        img, (acc, cnt), stat = fn(scene, cam, i, state)
        prev = torch.zeros_like(acc) if state is None else state[0]
        return img, (prev + (acc - prev) * 1.05, cnt), stat
    return f


def _count_frozen(fn):
    """The count stays at 1: each frame shows its own sample alone."""
    def f(scene, cam, i, state):
        img, (acc, cnt), stat = fn(scene, cam, i, state)
        prev = None if state is None else state[0]
        return img, (_sample(acc, cnt, prev), torch.ones_like(cnt)), stat
    return f


def _count_doubled(fn):
    """The count goes up by 2 a frame, and the mean weighs by it."""
    def f(scene, cam, i, state):
        img, (acc, cnt), stat = fn(scene, cam, i, state)
        if state is None:
            return img, (acc, cnt), stat
        sample = _sample(acc, cnt, state[0])
        n = state[1] + 2.0
        return img, (state[0] + (sample - state[0]) / n[..., None], n), stat
    return f


def _image_half_left_out(fn):
    def f(scene, cam, i, state):
        img, new, stat = fn(scene, cam, i, state)
        h = img.shape[0] // 2
        return torch.cat([torch.zeros_like(img[:h]), img[h:]]), new, stat
    return f


def _image_altered(fn):
    def f(scene, cam, i, state):
        img, new, stat = fn(scene, cam, i, state)
        return img * 0.98, new, stat
    return f


def _count_altered(fn):
    def f(scene, cam, i, state):
        img, new, stat = fn(scene, cam, i, state)
        return img, new, stat + max(1, int(0.05 * int(stat)))
    return f


FAULTS = ([(m, f) for m in ("restir", "pt") for f in (
    _state_unchanged, _half_left_out, _sample_altered, _count_altered,
    _count_frozen, _count_doubled)]
    + [(m, f) for m in ("deferred-culled",) for f in (
        _image_half_left_out, _image_altered, _count_altered)])


@pytest.mark.parametrize("mode,fault", FAULTS,
                         ids=[f"{m}-{f.__name__}" for m, f in FAULTS])
def test_fault_is_not_correct(tiny_root, monkeypatch, mode, fault):
    real = program.frame_call
    monkeypatch.setattr(program, "frame_call",
                        lambda *a, **k: fault(real(*a, **k)))
    out = bench.run(f"tiny.{mode}", 5, 0.3, False, time.perf_counter(),
                    device="cpu", bench_root=tiny_root)
    assert out["result"]["correct"] is False, out["result"]["checks"]


@pytest.mark.parametrize("mode", MODES)
def test_sound_run_is_correct(tiny_root, mode):
    out = bench.run(f"tiny.{mode}", 5, 0.3, False, time.perf_counter(),
                    device="cpu", bench_root=tiny_root)
    assert out["result"]["correct"] is True, out["result"]["checks"]
