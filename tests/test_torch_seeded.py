"""nerfsos_torch's seeded initial weights vs the JAX entry point's (CPU).

``utils/jax_random`` (threefry keys, the samplers, flax's parameter keys, in
numpy) against ``jax.random`` and flax; ``run_nerf.build_model`` (through
``models/seeded``) against the JAX ``run_nerf.main``'s ``net.init`` at the
same ``--seed``, at small widths.
"""
import importlib.util
import os

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfsos_torch import run_nerf
from nerfsos_torch.engines import checkpoint as tckpt
from nerfsos_torch.models import seeded
from nerfsos_torch.utils import jax_random as jr

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ("--netdepth", "3", "--netwidth", "32", "--netdepth_fine", "2", "--netwidth_fine", "16",
         "--multires", "4", "--multires_views", "2")
# erf and erf_inv in float64, rounded: a draw within a few float32 ulps of XLA's
ULPS = 8 * np.finfo(np.float32).eps


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for torch in this module's tests (restored after):
    the tier-1 run's pytest workers share the machine's cores."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(scope="module")
def jax_run_nerf():
    """The JAX entry point (the repository's ``run_nerf.py``), as the JAX
    twin of the gate imports it."""
    spec = importlib.util.spec_from_file_location(
        "jax_validate_sos_protocol", os.path.join(REPO, "tools", "validate_sos_protocol.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.run_nerf


def _key(seed):
    return np.asarray(jax.random.key_data(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("seed", [0, 7, 123456789])
def test_keys_and_uniform_are_jax_bit_for_bit(seed):
    k = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(jr.prng_key(seed), _key(seed))
    np.testing.assert_array_equal(jr.split(jr.prng_key(seed), 3),
                                  np.asarray(jax.random.key_data(jax.random.split(k, 3))))
    np.testing.assert_array_equal(jr.fold_in(jr.prng_key(seed), 0xDEADBEEF),
                                  np.asarray(jax.random.key_data(jax.random.fold_in(k, 0xDEADBEEF))))
    np.testing.assert_array_equal(jr.uniform(jr.prng_key(seed), (7, 33), -0.5, 2.0),
                                  np.asarray(jax.random.uniform(k, (7, 33), minval=-0.5, maxval=2.0)))


def test_truncated_normal_matches_jax():
    want = np.asarray(jax.random.truncated_normal(jax.random.PRNGKey(11), -2.0, 2.0, (64, 96)))
    got = jr.truncated_normal(jr.prng_key(11), -2.0, 2.0, (64, 96))
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.abs(got).max() < 2.0
    np.testing.assert_allclose(got, want, rtol=ULPS, atol=ULPS)


def test_flax_dense_keys_match_flax():
    """A Dense two modules down draws its kernel from the key flax gives it:
    the path below the init key, then the draw count."""

    class Inner(nn.Module):
        @nn.compact
        def __call__(self, x):
            return nn.Dense(5, name="layer_b")(nn.Dense(6, name="layer_a")(x))

    class Outer(nn.Module):
        @nn.compact
        def __call__(self, x):
            return Inner(name="mlp")(x)

    params = Outer().init(jax.random.PRNGKey(4), jnp.zeros((1, 9)))["params"]["mlp"]
    for name, shape in (("layer_a", (9, 6)), ("layer_b", (6, 5))):
        got = jr.lecun_normal(jr.flax_key(jr.prng_key(4), ("mlp", name, 1)), shape)
        np.testing.assert_allclose(got, np.asarray(params[name]["kernel"]), rtol=ULPS, atol=ULPS)


@pytest.mark.parametrize("flags,seed", [
    (("--use_semantics", "--sem_with_coord"), 0),
    (("--use_semantics", "--sem_with_coord"), 3),
    (("--no_viewdirs",), 1),
    (("--N_importance", "0"), 0),
    (("--mipnerf",), 2),
], ids=["sos-seed0", "sos-seed3", "no-viewdirs", "no-fine", "mip"])
def test_build_model_starts_from_the_jax_entry_points_draws(jax_run_nerf, flags, seed):
    """Every MLP weight of the port's ``build_model`` at ``--seed`` is the
    JAX ``main``'s ``net.init(split(PRNGKey(seed))[1])``, within a few ulps;
    biases zero in both."""
    argv = ["--data_path", "unused", "--data_type", "llff", *SMALL, *flags, "--seed", str(seed)]
    jargs, _ = jax_run_nerf.create_arg_parser().parse_known_args(argv)
    jnet, _ = jax_run_nerf.build_model(jargs)
    _, init_key = jax.random.split(jax.random.PRNGKey(seed))
    want = tckpt.state_dict_from_jax_params(
        jax.tree_util.tree_map(np.asarray, jnet.init(init_key)))
    targs, _ = run_nerf.create_arg_parser().parse_known_args(argv)
    got = run_nerf.build_model(targs, torch.device("cpu"))[0].state_dict()
    assert got.keys() == want.keys()
    for k, v in got.items():
        w = want[k].numpy()
        assert v.shape == w.shape, k
        if k.endswith("bias"):
            assert not v.any() and not w.any(), k
        else:
            np.testing.assert_allclose(v.numpy(), w, rtol=ULPS, atol=ULPS * np.abs(w).max(),
                                       err_msg=k)


def test_flax_layer_names():
    assert [seeded.flax_layer_name(n) for n in (
        "pts_linears.3", "views_linears.0", "semantic_linear.0", "semantic_linear.2",
        "alpha_linear")] == ["pts_linears_3", "views_linears_0", "sem_0", "sem_1", "alpha_linear"]
