"""nerfsos_torch.core vs nerfsos_tpu.core on the same numpy inputs (CPU, fp32)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfsos_torch.core import encoding as tenc
from nerfsos_torch.core import render as trender
from nerfsos_torch.core import sampling as tsamp
from nerfsos_tpu.core import encoding as jenc
from nerfsos_tpu.core import render as jrender
from nerfsos_tpu.core import sampling as jsamp


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _rays(rng, n):
    o = rng.normal(size=(n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return o, d


@pytest.mark.parametrize("n_freqs", [2, 4, 10])
def test_positional_encoding_fused_matches_jax(rng, n_freqs):
    x = rng.normal(size=(7, 5, 3)).astype(np.float32)
    want = np.asarray(jenc.positional_encoding_fused(jnp.asarray(x), n_freqs))
    got = tenc.positional_encoding_fused(_t(x), n_freqs).numpy()
    assert got.shape == want.shape == (7, 5, tenc.pe_dim(3, n_freqs))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_positional_encoding_column_order(rng):
    x = rng.normal(size=(11, 3)).astype(np.float32)
    want = np.asarray(jenc.positional_encoding(jnp.asarray(x), 4))
    np.testing.assert_allclose(tenc.positional_encoding(_t(x), 4).numpy(), want, atol=1e-6)
    np.testing.assert_allclose(tenc.positional_encoding_fused(_t(x), 4).numpy(), want, atol=1e-6)
    M_t, ph_t = tenc._trig_matmul_consts(3, 4, 3.0, True)
    M_j, ph_j = jenc._trig_matmul_consts(3, 4, 3.0, True)
    np.testing.assert_array_equal(M_t, M_j)
    np.testing.assert_array_equal(ph_t, ph_j)


@pytest.mark.parametrize("white_bkgd", [False, True])
def test_volumetric_render_matches_jax(rng, white_bkgd):
    R, S = 9, 12
    raw = rng.normal(size=(R, S, 6)).astype(np.float32)
    z = np.sort(rng.uniform(1, 4, size=(R, S)), 1).astype(np.float32)
    _, d = _rays(rng, R)
    want = jrender.volumetric_render(jnp.asarray(raw), jnp.asarray(z), jnp.asarray(d),
                                     white_bkgd=white_bkgd, use_semantics=True)
    got = trender.volumetric_render(_t(raw), _t(z), _t(d), white_bkgd=white_bkgd,
                                    use_semantics=True)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-5, rtol=1e-5,
                                   err_msg=k)


def test_sigma_to_weights_matches_jax(rng):
    sigma = rng.normal(size=(6, 10)).astype(np.float32) * 3
    z = np.sort(rng.uniform(1, 4, size=(6, 10)), 1).astype(np.float32)
    _, d = _rays(rng, 6)
    want = np.asarray(jrender.sigma_to_weights(jnp.asarray(sigma), jnp.asarray(z), jnp.asarray(d)))
    got = trender.sigma_to_weights(_t(sigma), _t(z), _t(d)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_stratified_sample_matches_jax(rng):
    near = np.full((5, 1), 1.5, np.float32)
    far = rng.uniform(3, 5, size=(5, 1)).astype(np.float32)
    for lindisp in (False, True):
        want = np.asarray(jsamp.stratified_sample(None, jnp.asarray(near), jnp.asarray(far), 16,
                                                  lindisp=lindisp))
        got = tsamp.stratified_sample(_t(near), _t(far), 16, lindisp=lindisp).numpy()
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_stratified_sample_perturb_stays_in_strata():
    near, far = torch.full((4, 1), 1.0), torch.full((4, 1), 3.0)
    g = torch.Generator().manual_seed(0)
    z = tsamp.stratified_sample(near, far, 8, perturb=1.0, generator=g)
    base = tsamp.stratified_sample(near, far, 8)
    mids = 0.5 * (base[:, 1:] + base[:, :-1])
    assert torch.all(z[:, 1:] >= mids - 1e-6) and torch.all(z[:, :-1] <= mids + 1e-6)


@pytest.mark.parametrize("flat", [False, True])
def test_sample_pdf_det_matches_jax(rng, flat):
    R, B = 8, 13
    bins = np.sort(rng.uniform(1, 4, size=(R, B)), 1).astype(np.float32)
    w = rng.uniform(0, 1, size=(R, B - 1)).astype(np.float32)
    if flat:
        w[:] = 0.0  # exercises the +1e-5 floor and the denom guard
    want = np.asarray(jsamp.sample_pdf(None, jnp.asarray(bins), jnp.asarray(w), 10, det=True))
    got = tsamp.sample_pdf(_t(bins), _t(w), 10, det=True).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_importance_sample_det_matches_jax(rng):
    R, S = 6, 9
    z = np.sort(rng.uniform(1, 4, size=(R, S)), 1).astype(np.float32)
    w = rng.uniform(0, 1, size=(R, S)).astype(np.float32)
    za, zs = jsamp.importance_sample(None, jnp.asarray(z), jnp.asarray(w), 7, det=True)
    ta, ts = tsamp.importance_sample(_t(z), _t(w), 7, det=True)
    np.testing.assert_allclose(ta.numpy(), np.asarray(za), atol=1e-6, rtol=0)
    np.testing.assert_allclose(ts.numpy(), np.asarray(zs), atol=1e-6, rtol=0)
    assert torch.all(ta[:, 1:] >= ta[:, :-1])


def test_points_along_rays_matches_jax(rng):
    o, d = _rays(rng, 4)
    z = rng.uniform(1, 4, size=(4, 5)).astype(np.float32)
    want = np.asarray(jsamp.points_along_rays(jnp.asarray(o), jnp.asarray(d), jnp.asarray(z)))
    np.testing.assert_allclose(tsamp.points_along_rays(_t(o), _t(d), _t(z)).numpy(), want,
                               atol=1e-6, rtol=0)
