"""numpy helpers of the port vs the libraries the JAX package uses for them."""
import imageio.v2 as imageio
import numpy as np
import pytest
from sklearn.metrics import adjusted_rand_score as sk_ari

from nerfsos_torch.utils import image
from nerfsos_torch.utils.metrics import adjusted_rand_score
from nerfsos_tpu.utils import vis


def _labels(case, rng):
    n = 500
    if case == "random":
        return rng.integers(0, 3, n), rng.integers(0, 4, n)
    if case == "binary_correlated":
        t = rng.integers(0, 2, n)
        p = np.where(rng.random(n) < 0.8, t, 1 - t)
        return t, p
    if case == "identical_relabelled":
        t = rng.integers(0, 5, n)
        return t, (t + 2) % 5
    if case == "one_cluster":
        return rng.integers(0, 2, n), np.zeros(n, int)
    if case == "all_one":
        return np.ones(n, int), np.zeros(n, int)
    if case == "empty":
        return np.zeros(0, int), np.zeros(0, int)
    if case == "singletons":
        return np.arange(20), np.arange(20)[::-1]
    if case == "image_masks":
        return rng.integers(0, 2, (37, 41, 1)), rng.integers(0, 2, (37, 41, 1)).astype(np.int32)
    raise ValueError(case)


@pytest.mark.parametrize("case", ["random", "binary_correlated", "identical_relabelled",
                                  "one_cluster", "all_one", "empty", "singletons",
                                  "image_masks"])
def test_ari_matches_sklearn(rng, case):
    t, p = _labels(case, rng)
    want = sk_ari(np.asarray(t).reshape(-1), np.asarray(p).reshape(-1))
    assert abs(adjusted_rand_score(t, p) - want) <= 1e-12


@pytest.mark.parametrize("shape", [(7, 9), (7, 9, 1), (5, 6, 3), (4, 3, 4)])
def test_png_round_trips_through_imageio(tmp_path, rng, shape):
    arr = rng.integers(0, 256, shape).astype(np.uint8)
    path = str(tmp_path / "x.png")
    image.write_png(path, arr)
    back = np.asarray(imageio.imread(path))
    np.testing.assert_array_equal(back, arr[..., 0] if shape[-1:] == (1,) else arr)
    np.testing.assert_array_equal(image.read_png(path), back)


def test_png_rejects_float(tmp_path):
    with pytest.raises(ValueError):
        image.write_png(str(tmp_path / "x.png"), np.zeros((3, 3), np.float32))


def test_jet_matches_matplotlib(rng):
    import matplotlib as mpl

    x = np.concatenate([rng.random(2000), [0.0, 1.0, -0.1, 1.2, 0.5]]).astype(np.float32)
    want = mpl.colormaps["jet"](x)[:, :3]
    np.testing.assert_allclose(image.jet(x), want, atol=1e-12)


def test_colorize_matches_colorize_np(rng):
    depth = rng.uniform(2, 6, (9, 11)).astype(np.float32)
    want, _ = vis.colorize_np(depth, cmap_name="jet")
    np.testing.assert_allclose(image.colorize(depth), want, atol=1e-12)


def test_to8b_matches_jax_package(rng):
    x = rng.normal(size=(6, 5, 3)).astype(np.float32)
    np.testing.assert_array_equal(image.to8b(x), vis.to8b(x))
    np.testing.assert_array_equal(image.to8b(np.ones((2, 2))), vis.to8b(np.ones((2, 2))))
