"""The Pallas-Triton closest-hit kernel (ops.search_triton) against the XLA
search it replaces on the GPU.  Everything here runs the kernel in the
Pallas interpreter on the CPU except the ``gpu`` test, which compiles it for
the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rvpt_tpu.ops import intersect as I
from rvpt_tpu.ops import search_triton as ST


def random_case(n_rays, n_tri, seed):
    r = np.random.default_rng(seed)
    v0 = r.uniform(-3, 3, (n_tri, 3)).astype(np.float32)
    v1 = v0 + r.uniform(-1, 1, (n_tri, 3)).astype(np.float32)
    v2 = v0 + r.uniform(-1, 1, (n_tri, 3)).astype(np.float32)
    o = r.uniform(-4, 4, (n_rays, 3)).astype(np.float32)
    d = r.normal(size=(n_rays, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return map(jnp.asarray, (o, d, v0, v1, v2))


def _assert_same_hits(got, want, rtol=1e-5):
    (t_k, i_k), (t_x, i_x) = got, want
    hit = np.asarray(i_x) >= 0
    np.testing.assert_array_equal(np.asarray(i_k) >= 0, hit)
    np.testing.assert_allclose(np.asarray(t_k)[hit], np.asarray(t_x)[hit],
                               rtol=rtol, atol=1e-5)
    # identical first-min tie-breaking
    np.testing.assert_array_equal(np.asarray(i_k)[hit], np.asarray(i_x)[hit])
    assert not np.isfinite(np.asarray(t_k)[~hit]).any()


@pytest.mark.parametrize("n_rays,n_tri", [(37, 5), (512, 300), (700, 600)])
def test_pallas_matches_xla(n_rays, n_tri):
    o, d, v0, v1, v2 = random_case(n_rays, n_tri, seed=n_rays + n_tri)
    want = I.closest_hit_triangles(o, d, v0, v1, v2, 1e-3, np.inf)
    got = ST.closest_hit_triangles_triton(o, d, v0, v1, v2, 1e-3, np.inf,
                                          interpret=True)
    _assert_same_hits(got, want)


def test_pallas_all_miss_and_empty_pad():
    o = jnp.zeros((8, 3))
    d = jnp.tile(jnp.array([0.0, 1.0, 0.0]), (8, 1))
    v0 = jnp.array([[-1.0, -5.0, 2.0]])
    v1 = jnp.array([[1.0, -5.0, 2.0]])
    v2 = jnp.array([[0.0, -5.0, 4.0]])
    t, idx = ST.closest_hit_triangles_triton(o, d, v0, v1, v2, 0.0, np.inf,
                                             interpret=True)
    assert not np.isfinite(np.asarray(t)).any()
    assert (np.asarray(idx) == -1).all()


@pytest.mark.parametrize("n_rays,n_tri", [(1, 1), (129, 17), (255, 2049)])
def test_triton_non_power_of_two_sizes(n_rays, n_tri):
    """Ray counts and triangle counts off every block and tile boundary
    (2049 triangles also crosses the XLA search's 2048-triangle chunk)."""
    o, d, v0, v1, v2 = random_case(n_rays, n_tri, seed=3 * n_rays + n_tri)
    want = I.closest_hit_triangles(o, d, v0, v1, v2, 1e-3, np.inf)
    got = ST.closest_hit_triangles_triton(o, d, v0, v1, v2, 1e-3, np.inf,
                                          interpret=True)
    _assert_same_hits(got, want)


@pytest.mark.parametrize("block,tile", [(32, 8), (64, 32), (256, 16)])
def test_triton_block_and_tile_shapes(block, tile, monkeypatch):
    """Other (ray block, triangle tile) shapes of the swept range give the
    same hits: the padding and tile loop do not depend on the chosen
    constants."""
    monkeypatch.setattr(ST, "RAY_BLOCK", block)
    monkeypatch.setattr(ST, "TRI_TILE", tile)
    o, d, v0, v1, v2 = random_case(300, 100, seed=block + tile)
    want = I.closest_hit_triangles(o, d, v0, v1, v2, 1e-3, np.inf)
    got = ST.closest_hit_triangles_triton(o, d, v0, v1, v2, 1e-3, np.inf,
                                          interpret=True)
    _assert_same_hits(got, want)


def test_triton_ties_pick_first_triangle():
    """Duplicated triangles in one tile and across tiles: both searches keep
    the lowest index (first minimum)."""
    o, d, v0, v1, v2 = random_case(200, 20, seed=5)
    # copies at 20..39: some share a tile with their original, some do not
    v0, v1, v2 = (jnp.concatenate([v, v]) for v in (v0, v1, v2))
    want = I.closest_hit_triangles(o, d, v0, v1, v2, 1e-3, np.inf)
    got = ST.closest_hit_triangles_triton(o, d, v0, v1, v2, 1e-3, np.inf,
                                          interpret=True)
    _assert_same_hits(got, want)
    assert (np.asarray(got[1]) < 20).all()


def test_triton_respects_mint_maxt():
    """Hits outside (mint, maxt) are rejected exactly as in the XLA search."""
    o, d, v0, v1, v2 = random_case(400, 200, seed=9)
    want = I.closest_hit_triangles(o, d, v0, v1, v2, 0.5, 2.0)
    got = ST.closest_hit_triangles_triton(o, d, v0, v1, v2, 0.5, 2.0,
                                          interpret=True)
    _assert_same_hits(got, want)
    t = np.asarray(got[0])
    assert ((t[np.isfinite(t)] > 0.5) & (t[np.isfinite(t)] < 2.0)).all()


def test_triton_pack_padding():
    """The packed table pads to a tile multiple with all-zero columns, and a
    zero-normal padding column can never be a valid hit."""
    _, _, v0, v1, v2 = random_case(1, 21, seed=1)
    table = ST.pack_triangles(v0, v1, v2, tile=16)
    assert table.shape == (len(ST.FIELDS), 32)
    assert not np.asarray(table[:, 21:]).any()
    np.testing.assert_allclose(
        np.asarray(table[ST.FIELDS.index("inv_det"), :21]),
        np.asarray(I.triangle_precompute(v0, v1, v2)["inv_det"]), rtol=1e-6)


@pytest.mark.gpu
def test_triton_compiled_matches_xla_on_gpu(gpu_device):
    """The kernel compiled by Triton for the card agrees with the XLA search
    at full float32 precision (mesh-scale triangle count)."""
    o, d, v0, v1, v2 = random_case(4096, 3000, seed=11)
    with jax.default_matmul_precision("highest"):
        want = I.closest_hit_triangles(o, d, v0, v1, v2, 1e-3, np.inf)
    got = ST.closest_hit_triangles_triton(o, d, v0, v1, v2, 1e-3, np.inf,
                                          interpret=False)
    # The two compilers may contract different products into fmas, so a ray
    # grazing an edge or a near-tie can flip: allow 0.1% of rays to differ.
    # Where both chose the same triangle, t = (v0.n - o.n) / (d.n) cancels
    # for origins near the triangle's plane (these random rays start among
    # the triangles), so a contraction difference shows as ~1e-5 absolute.
    (t_k, i_k), (t_x, i_x) = ((np.asarray(a), np.asarray(b))
                              for a, b in (got, want))
    assert np.mean(i_k != i_x) <= 1e-3
    same = (i_k == i_x) & (i_x >= 0)
    assert same.sum() > 100
    np.testing.assert_allclose(t_k[same], t_x[same], rtol=1e-4, atol=2e-5)
