"""Pallas (Triton route) label-propagation kernel, run in interpret mode,
against the plain affinity-matrix path it replaces on the GPU."""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from fccf_pcr_tpu.config import FCCFParams
from fccf_pcr_tpu.features import faces
from fccf_pcr_tpu.features.faces import _label_propagate, _pairwise_affinity
from fccf_pcr_tpu.ops.pallas import label_prop
from fccf_pcr_tpu.ops.pallas.label_prop import label_propagate, padded_size


def _clustered(seed, V, n_groups=6, valid=None):
    """Voxel stats in a few planes, so that real components form."""
    rng = np.random.default_rng(seed)
    gn = rng.normal(size=(n_groups, 3))
    gn /= np.linalg.norm(gn, axis=1, keepdims=True)
    gc = rng.uniform(-10, 10, (n_groups, 3))
    which = rng.integers(0, n_groups, V)
    # centroids lie in their group's plane so compare_plane holds in-group
    normal = (gn[which] + rng.normal(0, 0.01, (V, 3))).astype(np.float32)
    offsets = rng.uniform(-4, 4, (V, 3)).astype(np.float32)
    offsets -= (offsets * gn[which]).sum(1, keepdims=True) * gn[which]
    centroid = (gc[which] + offsets).astype(np.float32)
    if valid is None:
        valid = rng.uniform(size=V) > 0.15
    return (
        jnp.asarray(normal), jnp.asarray(centroid), jnp.asarray(valid),
        5.0, 0.5, 5.0,
    )


def _plain(args):
    return np.asarray(_label_propagate(_pairwise_affinity(*args), args[2], 64))


@pytest.mark.parametrize("seed", [0, 1])
def test_kernel_matches_xla_path(seed):
    args = _clustered(seed, 512)
    got = np.asarray(label_propagate(*args, max_iters=64, interpret=True))
    np.testing.assert_array_equal(got, _plain(args))


@pytest.mark.parametrize("prefix", [1, 130, 512])
def test_kernel_bound_prunes_identically(prefix):
    """A runtime occupancy bound covering all valid slots must not change
    the fixpoint (slots past the bound are invalid by contract)."""
    args = _clustered(7, 512, n_groups=5, valid=np.arange(512) < prefix)
    got = np.asarray(
        label_propagate(*args, bound=jnp.int32(prefix), interpret=True)
    )
    np.testing.assert_array_equal(got, _plain(args))


@pytest.mark.parametrize("block", [(16, 64), (32, 256), (64, 128)])
def test_block_size_invariance(block):
    """Labels are an exact integer fixpoint: every block shape reaches the
    same component-min labels."""
    args = _clustered(3, 512)
    want = np.asarray(label_propagate(*args, interpret=True))
    got = np.asarray(label_propagate(*args, block=block, interpret=True))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("V", [600, 1536])
def test_padding_non_block_multiple(V):
    """V is padded with invalid slots up to a multiple of both block sizes,
    and the padding never shows in the labels."""
    block = (32, 256)
    assert padded_size(V, block) % 256 == 0 and padded_size(V, block) >= V
    args = _clustered(11, V)
    got = np.asarray(label_propagate(*args, block=block, interpret=True))
    assert got.shape == (V,)
    np.testing.assert_array_equal(got, _plain(args))


def test_bound_zero_and_all_invalid():
    """bound=0 leaves an all-invalid input untouched; so does no bound."""
    args = _clustered(5, 256, valid=np.zeros(256, bool))
    big = np.full(256, 2**30, np.int32)
    for bound in (jnp.int32(0), None):
        got = np.asarray(label_propagate(*args, bound=bound, interpret=True))
        np.testing.assert_array_equal(got, big)
    np.testing.assert_array_equal(_plain(args), big)


@pytest.mark.parametrize("backend", ["cpu", "gpu"])
def test_kernel_selection(monkeypatch, backend):
    """The GPU backend takes the kernel; every other backend the plain
    path. Both give the same labels."""
    calls = []
    real = label_prop.label_propagate

    def spy(*a, **kw):
        calls.append(kw)
        return real(*a, interpret=True, **kw)

    monkeypatch.setattr(label_prop, "label_propagate", spy)
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    args = _clustered(2, 512)
    params = FCCFParams()
    got = np.asarray(
        faces._label_components(*args, params, bound=jnp.int32(512))
    )
    np.testing.assert_array_equal(got, _plain(args))
    if backend == "gpu":
        assert len(calls) == 1
        assert calls[0]["max_iters"] == params.label_prop_iters
    else:
        assert calls == []


def test_kernel_under_vmap_per_cloud_bound():
    """The pipeline vmaps face growth over pairs: each batch member keeps
    its own bound."""
    a0 = _clustered(0, 256, valid=np.arange(256) < 200)
    a1 = _clustered(1, 256, valid=np.arange(256) < 90)
    stack = [jnp.stack([x, y]) for x, y in zip(a0[:3], a1[:3])]
    fn = jax.vmap(
        functools.partial(label_propagate, angle_thresh_deg=5.0, l=0.5, k=5.0,
                          interpret=True)
    )
    got = np.asarray(fn(*stack, bound=jnp.array([200, 90], jnp.int32)))
    np.testing.assert_array_equal(got[0], _plain(a0))
    np.testing.assert_array_equal(got[1], _plain(a1))


@pytest.mark.gpu
@pytest.mark.parametrize("block", [(16, 64), (32, 128), (64, 256)])
def test_compiled_kernel_matches_plain_on_gpu(gpu, block):
    """The kernel as Triton compiles it for the card, at a non-block V."""
    args = _clustered(0, 1500)
    got = np.asarray(label_propagate(*args, block=block))
    with jax.default_matmul_precision("highest"):
        want = _plain(args)
    np.testing.assert_array_equal(got, want)


def test_pipeline_with_kernel_matches_plain(monkeypatch, params, caps, small_pair):
    """The whole batched register step gives the same result when face
    growth runs the kernel (as on the GPU) as with the plain path."""
    from fccf_pcr_tpu import make_register_fn

    sp, sm, tp, tm, _ = small_pair
    args = [np.stack([x, x]) for x in (sp, sm, tp, tm)]
    want = make_register_fn(params, caps, batched=True)(*args)
    monkeypatch.setattr(
        label_prop, "label_propagate",
        functools.partial(label_prop.label_propagate, interpret=True),
    )
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    got = make_register_fn(params, caps, batched=True)(*args)
    np.testing.assert_array_equal(np.asarray(got.status), np.asarray(want.status))
    np.testing.assert_array_equal(np.asarray(got.n_faces), np.asarray(want.n_faces))
    np.testing.assert_allclose(
        np.asarray(got.transform), np.asarray(want.transform), atol=1e-6
    )
