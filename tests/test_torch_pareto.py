"""The port's ``core.pareto`` against ``repro.core.pareto``: the same masks
and the same values, exactly, on seeded random clouds that hold NaN and inf
rows, duplicated rows, ties and single points."""
import numpy as np
import pytest

from repro.core import pareto as J
from repro_torch.core import pareto as T


def _cloud(seed: int, n: int, k: int, *, nan=0, inf=0, dup=0, grid=False):
    """(n, k) float32 points from ``seed``: ``grid`` draws small integers
    (many ties), ``nan``/``inf`` rows get one non-finite entry, and ``dup``
    rows repeat earlier ones."""
    rng = np.random.default_rng(seed)
    pts = (rng.integers(0, 5, (n, k)) if grid
           else rng.random((n, k))).astype(np.float32)
    rows = rng.permutation(n)
    for r in rows[:nan]:
        pts[r, rng.integers(k)] = np.nan
    for r in rows[nan:nan + inf]:
        pts[r, rng.integers(k)] = rng.choice([np.inf, -np.inf])
    for r in rows[nan + inf:nan + inf + dup]:
        pts[r] = pts[rng.integers(n)]
    return pts


CLOUDS = {
    "single": dict(seed=0, n=1, k=2),
    "two-dup": dict(seed=1, n=2, k=2, dup=1),
    "uniform-2d": dict(seed=2, n=60, k=2),
    "uniform-3d": dict(seed=3, n=80, k=3),
    "ties-2d": dict(seed=4, n=50, k=2, grid=True),
    "ties-7d": dict(seed=5, n=40, k=7, grid=True, dup=6),
    "nonfinite-2d": dict(seed=6, n=40, k=2, nan=5, inf=4, dup=3),
    "nonfinite-7d": dict(seed=7, n=30, k=7, nan=3, inf=3),
    "all-nan": dict(seed=8, n=4, k=2, nan=4),
}


@pytest.mark.parametrize("name", CLOUDS)
def test_pareto_front_and_points_match(name):
    pts = _cloud(**CLOUDS[name])
    want = J.pareto_front(pts)
    got = T.pareto_front(pts)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    if pts.shape[0] and np.isfinite(pts).all(axis=1).any():
        want_p, got_p = J.pareto_points(pts), T.pareto_points(pts)
        assert got_p.dtype == want_p.dtype
        assert np.array_equal(got_p, want_p, equal_nan=True)


@pytest.mark.parametrize("name", [n for n in CLOUDS
                                  if CLOUDS[n]["k"] > 1])
def test_metric_correlations_match(name):
    pts = _cloud(**CLOUDS[name])
    want, got = J.metric_correlations(pts), T.metric_correlations(pts)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("shape", [(0, 7), (2, 7), (3, 7), (5, 2)])
def test_metric_correlations_small_and_constant(shape):
    pts = np.ones(shape, np.float32)
    assert np.array_equal(T.metric_correlations(pts),
                          J.metric_correlations(pts))
    if shape[0]:
        pts[:, 0] = np.arange(shape[0])
        assert np.array_equal(T.metric_correlations(pts),
                              J.metric_correlations(pts))


def test_metric_correlations_one_column_raises_as_the_reference():
    pts = np.arange(5, dtype=np.float32)[:, None]
    for mod in (J, T):
        with pytest.raises(ValueError, match="at least 2-d"):
            mod.metric_correlations(pts)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("indices", [(0, 2), (0, 1, 2, 3, 4, 5, 6), (3,)])
def test_sweep_fronts_match(seed, indices):
    metrics = _cloud(seed, 50, 7, nan=3, inf=2, dup=4, grid=seed == 2)
    power = _cloud(seed + 10, 50, 1, inf=1)[:, 0]
    want = J.sweep_fronts(power, metrics, indices)
    got = T.sweep_fronts(power, metrics, indices)
    assert list(got) == list(want)
    for i in want:
        assert got[i].dtype == want[i].dtype
        assert np.array_equal(got[i], want[i])


@pytest.mark.parametrize("name", ["single", "two-dup", "uniform-2d",
                                  "ties-2d", "nonfinite-2d"])
@pytest.mark.parametrize("ref", [(1.0, 1.0), (0.5, 0.7), (5.0, 5.0),
                                 (-1.0, 2.0)])
def test_hypervolume_matches(name, ref):
    pts = _cloud(**CLOUDS[name])
    want = J.hypervolume_2d(pts, ref)
    got = T.hypervolume_2d(pts, ref)
    assert type(got) is type(want) and got == want
