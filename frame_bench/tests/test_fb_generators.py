"""The frozen generators give the arrays of prosper_tpu_torch.testing's
make_plate_scene and of scene.camera.Camera at the same seed, while the
copied recipe is the one they were frozen from (commit e89c417)."""

import hashlib
import inspect

import numpy as np
import pytest

from frame_bench.inputs import camera, plate

# sha256 of the copied functions' source at commit e89c417
FROZEN_SOURCES = ("605561904177d9e4ef5f4eee186af8f5"
                  "a93f63085e738890f7e3b674d315cd9e")


def _source_hash():
    from prosper_tpu_torch import testing

    src = "".join(inspect.getsource(f) for f in (
        testing._unit_plate, testing._plate_frames, testing.make_plate_scene))
    return hashlib.sha256(src.encode()).hexdigest()


@pytest.mark.parametrize("seed", [0, 7, 2**33 + 5])
def test_plate_inputs_equal_testing(seed):
    from prosper_tpu_torch import testing

    if _source_hash() != FROZEN_SOURCES:
        pytest.skip("testing.make_plate_scene changed since it was copied")
    inp = plate.make_plate_inputs(32, seed, 1024, light_seed=0)
    st, fr, _, cam_fn = testing.make_plate_scene(32, seed, scatter_lights=1024)
    for mine, theirs in (("p0", "wt_p0"), ("p1", "wt_p1"), ("p2", "wt_p2"),
                         ("aidx", "wt_aidx"), ("a_packed", "a_packed"),
                         ("tri_material", "wt_material"),
                         ("cluster_material", "wc_material")):
        assert np.array_equal(inp[mine], st[theirs]), mine
    lights = fr["lights"]
    n = inp["point_position"].shape[0]
    assert int(lights["point_count"]) == n
    for k in ("point_position", "point_radiance", "point_radius"):
        assert np.array_equal(lights[k][:n], inp[k]), k
    assert np.array_equal(lights["dir_irradiance"], inp["sun_irradiance"])
    assert np.array_equal(lights["dir_direction"], inp["sun_direction"])
    for k, v in st["materials"].items():
        assert np.array_equal(v, inp["materials"][k]), k
    want = cam_fn(1920, 1080)
    got = camera.uniforms(inp["eye"], inp["target"], 1920, 1080)
    assert set(got) == set(want)
    for k in want:
        assert np.array_equal(np.asarray(got[k]), np.asarray(want[k])), k


@pytest.mark.parametrize("seed", [1, 2**32 + 9])
def test_seed_reorders_the_same_scene(seed):
    """A run's seed moves the lights in their array; each light keeps its
    data, and the plates stay as they are."""
    cfg = {"n_clusters": 27, "scatter_lights": 40, "layout_seed": 0}
    base = plate.make_plate_inputs(27, 0, 40, light_seed=0)
    got = plate.make(cfg, seed)
    order = np.random.default_rng(seed).permutation(40)
    for k in ("point_position", "point_radiance", "point_radius"):
        assert np.array_equal(got[k], base[k][order]), k
    for k in ("p0", "p1", "p2", "aidx", "a_packed", "tri_material", "eye"):
        assert np.array_equal(got[k], base[k]), k
