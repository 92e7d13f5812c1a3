"""The port's measurement kernels (X2, X3b-f) against the JAX package:
the Plücker rows and block (prosper_tpu_torch/ops/plucker.py, which
prosper_tpu_torch/experiments/trace_plucker.py re-exports) against
experiments/trace_plucker.py, the Möller block against
trace_pallas._moller_block, and the plain loops of ops/bench_kernels.py
against the Pallas loops of experiments/bench_mxu_isect.py and
scripts/bench_loop_overhead.py run in interpret mode (their outputs, and
the plain loops' last t against the JAX block at the loop's t_upper),
and against a loop over _moller_block for X3b; the checker the card's
tensor-core Plücker loops are held to (tf32_agreement) on a model of
another summation order and on a wrong block.

Tolerances: the Plücker rows within 1e-6 (relative and absolute) of
JAX's; the f32 Plücker block's hits equal, t, u, v within 1e-5 (XLA's
dot sums the six-term side products in another order, and where they
cancel u and v move by a few 1e-6); the TF32 Plücker loop's last t
against JAX's f32 block: every hit equal, t within rtol 1e-2 (the
operands' TF32 rounding, experiments/trace_plucker.py:79-80); the Möller
block, the loops' outputs and the loop probes equal exactly.

experiments/bench_mxu_isect.py:40-42 imports prosper_tpu.ops.trace_plucker,
which lives at experiments/trace_plucker.py: the test loads that file and
puts it into sys.modules under the name the script imports. Both scripts
run their kernels inside jax.jit, so the tests record the outputs of the
jitted calls.
"""

import importlib.util
import os
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from prosper_tpu.ops.trace_pallas import _moller_block
from prosper_tpu.scene import caches
from prosper_tpu_torch.experiments import bench_mxu_isect as bmi
from prosper_tpu_torch.experiments import trace_plucker as tp
from prosper_tpu_torch.ops import bench_kernels as bk
from prosper_tpu_torch.ops import plucker as pl
from prosper_tpu_torch.scripts import bench_loop_overhead as blo
from tests.test_trace_bvh import interpret_mode

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def jax_plucker():
    return _load("prosper_tpu.ops.trace_plucker",
                 os.path.join(REPO, "experiments", "trace_plucker.py"))


def _jax_cols(o, d):
    return ([jnp.asarray(o[:, i:i + 1]) for i in range(3)]
            + [jnp.asarray(d[:, i:i + 1]) for i in range(3)])


def _scene(seed):
    """bench_mxu_isect's scene for seed 0, other seeded scenes else."""
    if seed == 0:
        return tuple(x.numpy() for x in bmi.scene("cpu"))
    rng = np.random.default_rng(seed)
    slab = np.concatenate([rng.uniform(-1, 1, (3, 128)),
                           rng.uniform(-0.6, 0.6, (6, 128))])
    slab = slab.astype(np.float32)
    o = rng.uniform(-3, 3, (256, 3)).astype(np.float32)
    d = rng.normal(size=(256, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return slab, o, d


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plucker_rows_and_block_match_jax(seed):
    """plucker_rows_from_slab and plucker_block_plain (f32) against
    experiments/trace_plucker.py on the CPU."""
    jtp = jax_plucker()
    slab, o, d = _scene(seed)
    rows = tp.plucker_rows_from_slab(torch.as_tensor(slab))
    jrows = np.asarray(jtp.plucker_rows_from_slab(jnp.asarray(slab)))
    assert rows.shape == (tp.PLU_ROWS, 128)
    np.testing.assert_allclose(rows.numpy(), jrows, rtol=1e-6, atol=1e-6)
    got = tp.plucker_block_plain(torch.as_tensor(jrows), torch.as_tensor(o),
                                 torch.as_tensor(d), bk.T_MIN, float("inf"))
    want = jtp._plucker_block(jnp.asarray(jrows), *_jax_cols(o, d), bk.T_MIN,
                              jnp.inf)
    hit = np.asarray(want[0])
    np.testing.assert_array_equal(got[0].numpy(), hit)
    assert hit.sum() > 20
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy()[hit], np.asarray(w)[hit],
                                   rtol=1e-5, atol=1e-5)
    assert np.isinf(got[1].numpy()[~hit]).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_moller_block_matches_pallas_block(seed):
    """moller_block_plain equals trace_pallas._moller_block exactly, at
    t_upper inf and at a per-ray t_upper."""
    slab, o, d = _scene(seed)
    for t_upper in (np.inf, np.linspace(0.5, 4, 256, dtype=np.float32)):
        tu = (t_upper if np.isscalar(t_upper) else
              torch.as_tensor(t_upper)[:, None])
        got = bk.moller_block_plain(torch.as_tensor(slab), torch.as_tensor(o),
                                    torch.as_tensor(d), bk.T_MIN, tu)
        ju = t_upper if np.isscalar(t_upper) else jnp.asarray(t_upper)[:, None]
        want = _moller_block(jnp.asarray(slab), *_jax_cols(o, d), bk.T_MIN, ju)
        hit = np.asarray(want[0])
        np.testing.assert_array_equal(got[0].numpy(), hit)
        np.testing.assert_array_equal(got[1].numpy()[hit],
                                      np.asarray(want[1])[hit])
        for g, w in zip(got[2:], want[2:]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_round_tf32():
    """Round to nearest with 10 mantissa bits, ties away from zero."""
    one = 1.0
    ulp = 2.0 ** -10
    x = torch.tensor([one + ulp / 2, one + ulp / 2 - 2 ** -20,
                      -(one + ulp / 2), one + 3 * ulp / 2, float("inf"), 0.0,
                      3.0], dtype=torch.float32)
    want = [one + ulp, one, -(one + ulp), one + 2 * ulp, float("inf"), 0.0,
            3.0]
    assert tp.round_tf32(x).tolist() == want
    g = torch.Generator().manual_seed(0)
    y = tp.round_tf32(torch.randn(1000, generator=g))
    assert bool(((y.view(torch.int32) & 0x1FFF) == 0).all())


def test_tf32_plucker_agrees_with_moller():
    """bench_mxu_isect.check on the CPU: the TF32 Plücker block's plain
    version against the Möller block, above the script's 99.95%."""
    rec = bmi.check("cpu")
    assert rec["agreement"] > bmi.AGREEMENT and rec["moller_hits"] == 47
    assert rec["t_rel_err"] < 1e-2


def _record_jit():
    """Patch jax.jit so that every jitted call's output is kept."""
    outputs = []
    real = jax.jit

    def jit(fn, *a, **k):
        g = real(fn, *a, **k)

        def call(*args, **kw):
            out = g(*args, **kw)
            outputs.append(np.asarray(out))
            return out
        return call
    return outputs, mock.patch.object(jax, "jit", jit)


def test_x2_loops_equal_the_jax_script():
    """experiments/bench_mxu_isect.py main() in interpret mode (its parity
    check and the three loops at NV = 2000) against the port's plain loops
    on the same scene: the (256, 128) outputs (best, which X2's chain
    keeps at inf) equal; and the plain loops' last t against the JAX block
    at that best: Möller's equal, the TF32 Plücker loops' on the same hits
    and within rtol 1e-2 of the f32 block."""
    outputs, patch_jit = _record_jit()
    shim = {"prosper_tpu.ops.trace_plucker": jax_plucker()}
    script = _load("bench_mxu_isect_script",
                   os.path.join(REPO, "experiments", "bench_mxu_isect.py"))
    with mock.patch.dict(sys.modules, shim), interpret_mode(), patch_jit, \
            mock.patch.object(caches, "enable_compile_cache", lambda *a: None):
        script.main()
    loops = [x for x in outputs if x.shape == (256, 128)]
    assert len(loops) == 12  # 1 + 3 calls of each variant
    slab, o, d = bmi.scene("cpu")
    cols = bk.cols_from_rays(o, d)
    jcols = _jax_cols(o.numpy(), d.numpy())
    jslab = jnp.asarray(slab.numpy())
    for i, variant in enumerate(bmi.VARIANTS):
        best, t = bmi.LOOPS[variant](bmi.loop_input(variant, slab), cols,
                                     bmi.NV, keep_t=True)
        np.testing.assert_array_equal(
            best[:, None].expand(256, 128).numpy(), loops[4 * i])
        t_upper = jnp.asarray(loops[4 * i][:, 0:1])
        if variant == "moller":
            _, want, _, _ = _moller_block(jslab, *jcols, bk.T_MIN, t_upper)
            np.testing.assert_array_equal(t.numpy(), np.asarray(want))
        else:
            jtp = jax_plucker()
            _, want, _, _ = jtp._plucker_block(
                jtp.plucker_rows_from_slab(jslab), *jcols, bk.T_MIN, t_upper)
            agree, rel = bmi.agreement(torch.as_tensor(np.asarray(want)), t)
            assert agree == 1.0 and rel < 1e-2, (agree, rel)
        assert int(torch.isfinite(t).sum()) == 47


def test_x3b_chain_equals_a_loop_over_the_pallas_block():
    """moller_chain_loop's plain version at K = 8 equals a loop over
    _moller_block with best = min(best, tmin + 1e-7), on rays that hit."""
    slab, o, d = _scene(1)
    best = jnp.full((256, 1), jnp.inf, jnp.float32)
    for _ in range(8):
        _, t, _, _ = _moller_block(jnp.asarray(slab), *_jax_cols(o, d),
                                   bk.T_MIN, best)
        best = jnp.minimum(best, jnp.min(t, axis=1, keepdims=True) + 1e-7)
    got, t = bk.moller_chain_loop(torch.as_tensor(slab),
                                  bk.cols_from_rays(torch.as_tensor(o),
                                                    torch.as_tensor(d)),
                                  8, keep_t=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(best)[:, 0])
    assert np.isfinite(got.numpy()).sum() > 10
    assert t.shape == (256, 128)


@pytest.mark.parametrize("iters", [1, 2, 8])
def test_x3b_chain_reaches_its_fixed_point(iters):
    """X3b's best after its first iteration, min(tmin + 1e-7, inf), is a
    fixed point of the chain: the plain loop gives the same best at K =
    1, 2 and 8, each equal to a K-iteration loop over the Pallas
    _moller_block, and its keep_t rows equal that block's t at the last
    iteration's t_upper (the previous best: inf at K = 1, then only hits
    below t + 1e-7 stay, those whose t is small enough to move by 1e-7)."""
    slab, o, d = _scene(1)
    cols = bk.cols_from_rays(torch.as_tensor(o), torch.as_tensor(d))
    best = jnp.full((256, 1), jnp.inf, jnp.float32)
    for _ in range(iters):
        t_upper = best
        _, t, _, _ = _moller_block(jnp.asarray(slab), *_jax_cols(o, d),
                                   bk.T_MIN, t_upper)
        best = jnp.minimum(best, jnp.min(t, axis=1, keepdims=True) + 1e-7)
    got, got_t = bk.moller_chain_loop(torch.as_tensor(slab), cols, iters,
                                      keep_t=True)
    first, _ = bk.moller_chain_loop(torch.as_tensor(slab), cols, 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(best)[:, 0])
    np.testing.assert_array_equal(got.numpy(), first.numpy())
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(t))
    hits = int(np.isfinite(np.asarray(t)).sum())
    assert hits > 20 if iters == 1 else 0 < hits < 20, hits


def test_loop_probes_equal_the_jax_script():
    """scripts/bench_loop_overhead.py main() in interpret mode against the
    port's plain probes at the script's counts: equal exactly."""
    outputs, patch_jit = _record_jit()
    script = _load("bench_loop_overhead_script",
                   os.path.join(REPO, "scripts", "bench_loop_overhead.py"))
    with interpret_mode(), patch_jit, \
            mock.patch.object(caches, "enable_compile_cache", lambda *a: None):
        script.main()
    assert len(outputs) == 24  # 1 + 5 calls of each of four probes
    for i, (fn, x, counts, _) in enumerate(blo.probes("cpu").values()):
        got = fn(x, *counts)
        np.testing.assert_array_equal(got.numpy(), outputs[6 * i])


def test_loop_probes_on_seeded_inputs():
    """The plain probes against plain Python loops on a seeded s and v
    (the card tests hold the kernels to the same plain versions)."""
    rng = np.random.default_rng(3)
    s = rng.integers(-2**31, 2**31 - 1, 128, dtype=np.int64)
    st = torch.as_tensor(s.astype(np.int32))
    n = 1000
    want = sum(int(s[i % 128]) for i in range(n))
    want = (want + 2**31) % 2**32 - 2**31
    assert int(bk.loop_flat(st, n)[3, 5]) == want
    assert int(bk.loop_nested(st, n // 4, 4)[0, 0]) == want
    want = sum(int(s[i % 128]) if i % 4 == 0 else 1 for i in range(n))
    assert int(bk.loop_cond(st, n)[7, 127]) == (want + 2**31) % 2**32 - 2**31
    v = rng.uniform(-1, 1, (8, 128)).astype(np.float32)
    v[2:4] = np.abs(v[2:4]) * 0.5
    v[6:8] = np.abs(v[6:8]) * 0.5
    a = np.float32(0.0)
    for _ in range(50):
        e = np.minimum((v[0:2] - a) * v[2:4], (v[4:6] - a) * v[6:8])
        a = np.float32(a + e.min())
    got = bk.loop_vec(torch.as_tensor(v), 50)
    assert got.shape == (8, 128) and bool((got == float(a)).all())


@pytest.mark.parametrize("n", [0, 1, 15, 16, 17, 63, 64, 65, 127, 128, 129,
                               200_000, 200_001])
def test_loop_flat_plain_equals_its_closed_form(n):
    """X3c's plain version (what loop_flat runs on the CPU) at counts
    around the kernel's 64-iteration runs and the 128-entry window:
    whole turns of s plus the first n mod 128 entries, wrapped to int32."""
    rng = np.random.default_rng(n % 997)
    s = rng.integers(-2**31, 2**31 - 1, 128, dtype=np.int64)
    turns, rest = divmod(n, 128)
    want = turns * int(s.sum()) + int(s[:rest].sum())
    want = (want + 2**31) % 2**32 - 2**31
    bk.loop_flat.launches = 0
    got = bk.loop_flat(torch.as_tensor(s.astype(np.int32)), n)
    assert bk.loop_flat.launches == 0  # CPU: the plain version
    assert got.shape == (8, 128) and bool((got == want).all())


_KT = bk.COND_RUN


@pytest.mark.parametrize("n", sorted({0, 1, 3, 4, 5, 128, _KT - 1, _KT,
                                      _KT + 1, 2 * _KT - 1, 2 * _KT + 1,
                                      200_000}))
def test_loop_cond_plain_equals_its_closed_form(n):
    """X3e's plain version (what loop_cond runs on the CPU) at counts
    around the kernel's COND_RUN-iteration runs: one add of 1 for each i
    with i % 4 != 0, and s[i % 128] for each i % 4 == 0, that is whole
    turns of s[0::4] plus its first entries, wrapped to int32. The
    seeded s is large enough that the sum at 200,000 iterations leaves
    int32."""
    rng = np.random.default_rng(n % 991)
    s = rng.integers(-2**31, 2**31 - 1, 128, dtype=np.int64)
    loads = -(-n // 4)  # i = 0, 4, 8, ... below n
    turns, rest = divmod(loads, 32)
    window = s[0::4]
    total = (n - loads) + turns * int(window.sum()) + int(window[:rest].sum())
    want = (total + 2**31) % 2**32 - 2**31
    if n == 200_000:
        assert want != total  # the wrap is exercised
    bk.loop_cond.launches = 0
    got = bk.loop_cond(torch.as_tensor(s.astype(np.int32)), n)
    assert bk.loop_cond.launches == 0  # CPU: the plain version
    assert got.shape == (8, 128) and bool((got == want).all())


def test_cond_run_is_the_kernels():
    """bk.COND_RUN, the run length the card tests count around, is the
    kernel's, a multiple of 4 that divides the 128-entry window."""
    src = open(os.path.join(REPO, "prosper_tpu_torch", "csrc",
                            "bench_kernels.cu")).read()
    line = next(ln for ln in src.splitlines()
                if ln.startswith("#define COND_RUN "))
    assert int(line.split()[2]) == bk.COND_RUN
    assert bk.COND_RUN % 4 == 0 and 128 % bk.COND_RUN == 0


def test_nested_instance_choice():
    """X3d's kernel instance: the compile-time K_STATIC (the script's K)
    for k == 4, the generic one for any other k or when asked; an
    instance that cannot run k trips is refused."""
    assert bk.K_STATIC == blo.K == 4
    assert [bk.nested_instance(k) for k in (0, 1, 3, 4, 5)] == [0, 0, 0, 4, 0]
    assert bk.nested_instance(4, 0) == 0 and bk.nested_instance(4, 4) == 4
    s = torch.arange(128, dtype=torch.int32)
    for k, kt in ((3, 4), (5, 4), (4, 2)):
        with pytest.raises(ValueError, match="no instance"):
            bk.loop_nested(s, 7, k, kt)


@pytest.mark.parametrize("k", [0, 1, 3, 4, 5])
def test_loop_nested_over_trip_counts(k):
    """The nested probe at k in {0, 1, 3, 4, 5} and m in {0, 1, 7,
    50,000}, either instance (on the CPU the plain version), on the
    script's s and a seeded one: the flat sum over m * k iterations, as
    a Python loop of m entries of k trips gives it (at m = 50,000 the
    same sum by whole turns of s and the rest)."""
    rng = np.random.default_rng(k)
    seeded = rng.integers(-2**31, 2**31 - 1, 128, dtype=np.int64)
    for s in (np.arange(128, dtype=np.int64), seeded):
        st = torch.as_tensor(s.astype(np.int32))
        for m in (0, 1, 7, 50_000):
            if m <= 7:
                want = sum(int(s[j % 128]) for i in range(m)
                           for j in range(i * k, i * k + k))
            else:
                n = m * k
                want = int(s.sum()) * (n // 128) + int(s[: n % 128].sum())
            want = (want + 2**31) % 2**32 - 2**31
            for kt in {0, bk.nested_instance(k)}:
                got = bk.loop_nested(st, m, k, kt)
                assert got.shape == (8, 128) and bool((got == want).all())


def _summed_in(order, rows, o, d):
    """The TF32 Plücker block's t with its products summed in another
    order: "exact" (float64, rounded once) or "reversed" (float32, last
    term first); inf on a miss."""
    def product(a, b):
        a, b = pl.round_tf32(a), pl.round_tf32(b)
        if order == "exact":
            return (a.double() @ b.double()).float()
        out = a[:, -1:] * b[-1]
        for i in range(a.shape[1] - 2, -1, -1):
            out = out + a[:, i:i + 1] * b[i]
        return out
    lhs = pl._ray_lhs(o, d)
    s1, s3 = product(lhs, rows[0:6]), product(lhs, rows[12:18])
    den, o_n = product(d, rows[18:21]), product(o, rows[18:21])
    ok = den.abs() > pl.PLU_DET_EPS
    inv = torch.where(ok, 1.0 / torch.where(ok, den, 1.0), 0.0)
    t, u, v = (rows[21] - o_n) * inv, s3 * inv, s1 * inv
    hit = ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > bk.T_MIN)
    return torch.where(hit, t, float("inf"))


@pytest.mark.parametrize("case", ["exact", "reversed", "plain", "swapped",
                                  "dropped"])
def test_tf32_agreement(case):
    """tf32_agreement on 64 blocks of bench_mxu_isect.block_cols: the
    plain block itself and the block summed in two other orders (a model
    of the tensor cores' sums) pass, no mismatch off the border and t
    within rtol 1e-5 plus the sums' bound; a block whose triangles 8-15
    are swapped with 16-23 (one mis-mapped fragment tile) or whose first
    hit is dropped fails."""
    slab, cols = bmi.block_cols(64, "cpu")
    rows = pl.plucker_rows_from_slab(slab)
    o = cols[:, 0:3].transpose(1, 2).reshape(-1, 3)
    d = cols[:, 3:6].transpose(1, 2).reshape(-1, 3)
    _, t, _, _ = pl.plucker_block_plain(rows, o, d, bk.T_MIN, float("inf"),
                                        tf32=True)
    if case in ("exact", "reversed"):
        t = _summed_in(case, rows, o, d)
    elif case == "swapped":
        t = torch.cat([t[:, 0:8], t[:, 16:24], t[:, 8:16], t[:, 24:]], dim=1)
    elif case == "dropped":
        t = t.clone()
        t.view(-1)[int(torch.isfinite(t).view(-1).nonzero()[0])] = np.inf
    a = pl.tf32_agreement(rows, o, d, bk.T_MIN, float("inf"), t)
    assert a["hits"] > 2000 and a["border"] < 10
    passed = a["mismatches"] == 0 and a["t_err_ratio"] <= 1.0
    assert passed == (case in ("exact", "reversed", "plain")), a
    if passed:
        assert a["t_err_ratio"] < 0.2 and a["t_rel_err"] < 1e-4
