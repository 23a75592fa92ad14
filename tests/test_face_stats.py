"""Equivalence of the two _face_stats segment-reduce implementations.

The one-hot matrix product and the scatter-add form must agree (up to f32
summation order) for any label/valid pattern, including dropped labels,
empty slots, and all-invalid inputs — the pipeline switches between them
by preset V (features/faces.py:_SCATTER_STATS_MIN_V), so a divergence
would make results preset-dependent."""

import numpy as np
import jax.numpy as jnp

from fccf_pcr_tpu.features.faces import _face_stats


def _random_inputs(seed, V, n_components):
    rng = np.random.default_rng(seed)
    valid = rng.random(V) < 0.7
    # component-min-style labels: each valid voxel points at some valid
    # slot index <= its own (plus a few out-of-range strays)
    labels = np.arange(V)
    comp = rng.integers(0, n_components, size=V)
    for c in range(n_components):
        members = np.where((comp == c) & valid)[0]
        if len(members):
            labels[members] = members.min()
    labels[~valid] = 2**30
    stray = rng.random(V) < 0.05
    labels[stray & valid] = V + rng.integers(0, 5)
    count = rng.integers(1, 50, size=V)
    centroid = rng.normal(size=(V, 3)) * 10.0
    normal = rng.normal(size=(V, 3))
    return (
        jnp.asarray(labels, jnp.int32),
        jnp.asarray(valid),
        jnp.asarray(count, jnp.int32),
        jnp.asarray(centroid, jnp.float32),
        jnp.asarray(normal, jnp.float32),
    )


def test_scatter_matches_onehot():
    V = 256
    for seed in range(5):
        labels, valid, count, centroid, normal = _random_inputs(seed, V, 17)
        c1, n1, p1, v1 = _face_stats(
            labels, valid, count, centroid, normal, V, impl="onehot"
        )
        c2, n2, p2, v2 = _face_stats(
            labels, valid, count, centroid, normal, V, impl="scatter"
        )
        np.testing.assert_allclose(c1, c2, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(n1, n2, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(p1, p2, rtol=1e-5)
        np.testing.assert_array_equal(np.asarray(v1), np.asarray(v2))


def test_all_invalid():
    V = 64
    labels = jnp.full((V,), 2**30, jnp.int32)
    valid = jnp.zeros((V,), bool)
    count = jnp.ones((V,), jnp.int32)
    centroid = jnp.ones((V, 3), jnp.float32)
    normal = jnp.ones((V, 3), jnp.float32)
    for impl in ("onehot", "scatter"):
        c, n, p, v = _face_stats(
            labels, valid, count, centroid, normal, V, impl=impl
        )
        assert float(jnp.abs(c).max()) == 0.0
        assert float(jnp.abs(n).max()) == 0.0
        assert float(p.max()) == 0.0
        assert int(v.max()) == 0


def test_label_segment_sum_1d_impls_agree():
    from fccf_pcr_tpu.features.faces import _label_segment_sum

    V = 128
    labels, valid, count, centroid, normal = _random_inputs(9, V, 11)
    vals = jnp.abs(normal[:, 0])
    a = _label_segment_sum(vals, labels, valid, V, impl="onehot")
    b = _label_segment_sum(vals, labels, valid, V, impl="scatter")
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
