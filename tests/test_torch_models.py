"""nerfsos_torch.models vs nerfsos_tpu.models with the same weights (CPU, fp32).

Params are initialised in flax and bridged with ``state_dict_from_jax_params``;
the whole eval slice (``NeRFNet`` at ``coarse_outputs=False``) is held against
the JAX ``NeRFNet`` on its XLA path, which ``tests/test_fused_render.py``
already ties to the Pallas kernels.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfsos_torch.engines import checkpoint as tckpt
from nerfsos_torch.models.mlp import NeRFMLP as TorchMLP
from nerfsos_torch.models.nerf import NeRFConfig as TorchConfig
from nerfsos_torch.models.nerf import NeRFNet as TorchNet
from nerfsos_tpu.engines.checkpoint import torch_nerf_ckpt_to_params
from nerfsos_tpu.models.mlp import NeRFMLP as FlaxMLP
from nerfsos_tpu.models.nerf import NeRFConfig as JaxConfig
from nerfsos_tpu.models.nerf import NeRFNet as JaxNet

# test_fused_render.py's tiny slice: depth 5 puts the skip concat after the
# last trunk layer, so the heads read [emb, h]
TINY = dict(netwidth=16, netdepth=5, netwidth_fine=16, netdepth_fine=5, n_samples=8,
            n_importance=8, multires=4, multires_views=2, use_semantics=True,
            sem_with_coord=True, ray_block=4096)


def _np_params(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _pair(seed=0, **over):
    kw = {**TINY, **over}
    jnet = JaxNet(JaxConfig(**kw))
    params = jnet.init(jax.random.PRNGKey(seed))
    tnet = TorchNet(TorchConfig(**kw, fused_field=True))
    tnet.load_state_dict(tckpt.state_dict_from_jax_params(_np_params(params)))
    return jnet, params, tnet.eval()


def _rays(seed, n):
    return np.random.default_rng(seed).normal(size=(2, n, 3)).astype(np.float32)


def test_bridge_round_trip():
    _, params, tnet = _pair()
    sd = tckpt.state_dict_from_jax_params(_np_params(params))
    back, step = torch_nerf_ckpt_to_params({"global_step": 7, "model": sd, "optimizer": {}})
    assert step == 7
    flat_a = jax.tree_util.tree_leaves_with_path(_np_params(params))
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(flat_b[path], leaf)
    sd2 = tckpt.state_dict_from_jax_params(back)
    assert sd2.keys() == tnet.state_dict().keys()
    for k, v in sd2.items():
        assert torch.equal(v, sd[k]), k


@pytest.mark.parametrize("depth,sem,coord", [(5, True, True), (6, True, False), (4, False, False)])
def test_nerf_mlp_matches_flax(rng, depth, sem, coord):
    fm = FlaxMLP(depth=depth, width=16, use_semantics=sem, sem_with_coord=coord)
    pe = rng.normal(size=(10, 27)).astype(np.float32)
    ve = rng.normal(size=(10, 15)).astype(np.float32)
    params = fm.init(jax.random.PRNGKey(1), jnp.asarray(pe), jnp.asarray(ve))["params"]
    tm = TorchMLP(27, 15, depth=depth, width=16, use_semantics=sem, sem_with_coord=coord)
    sd = tckpt.state_dict_from_jax_params({"coarse": {"mlp": _np_params(params)}})
    tm.load_state_dict({k[len("nerf.mlp."):]: v for k, v in sd.items()})
    want = np.asarray(fm.apply({"params": params}, jnp.asarray(pe), jnp.asarray(ve)))
    with torch.no_grad():
        got = tm(torch.from_numpy(pe), torch.from_numpy(ve)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("over", [{}, {"use_semantics": False}, {"white_bkgd": True},
                                  {"sem_with_coord": False, "netdepth": 6, "netdepth_fine": 6}])
def test_eval_slice_matches_jax(over):
    """coarse_outputs=False: K1 (plain) -> det importance sample -> K2 (plain)
    -> finish_maps, against the JAX XLA render. R=20 is not a chunk multiple."""
    jnet, params, tnet = _pair(**over)
    assert tnet.fused
    rays = _rays(3, 20)
    want = jnet(params, jnp.asarray(rays), (1.0, 4.0), train=False, coarse_outputs=False)
    with torch.no_grad():
        got = tnet(torch.from_numpy(rays), (1.0, 4.0), coarse_outputs=False)
    assert set(got) == set(want)
    for k in want:
        # z_std: an inverse-CDF bin flip moves one sample by a bin
        tol = 5e-3 if k == "z_std" else 2e-5
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=tol,
                                   rtol=1e-2 if k == "z_std" else 1e-5, err_msg=k)


def test_plain_branches_match_jax():
    """fused_field off, coarse_outputs on: the '0'-suffixed coarse maps too;
    also ray chunking with a ragged last chunk (ray_block 7 over 20 rays)."""
    jnet, params, _ = _pair()
    tnet = TorchNet(TorchConfig(**{**TINY, "ray_block": 7}))
    tnet.load_state_dict(tckpt.state_dict_from_jax_params(_np_params(params)))
    assert not tnet.fused
    rays = _rays(4, 20).reshape(2, 4, 5, 3)
    want = jnet(params, jnp.asarray(rays), (1.0, 4.0), train=False)
    with torch.no_grad():
        got = tnet(torch.from_numpy(rays), (1.0, 4.0))
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        # coarse ('0') maps at 2e-5; the fine pass sees coarse weights that
        # differ at ~1e-7, and on one ray of these 20 the det inverse CDF
        # amplifies that into a 6.5e-5 shift of z_std (4.5e-5 in the fine
        # weights), so the fine maps get 1e-4
        tol = 5e-3 if k == "z_std" else (2e-5 if k.endswith("0") else 1e-4)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=tol,
                                   rtol=1e-2 if k == "z_std" else 1e-5, err_msg=k)


def test_shared_fine_field():
    tnet = TorchNet(TorchConfig(**{**TINY, "n_importance": 0}))
    assert tnet.nerf_fine is None and tnet.fine_field is tnet.nerf
    with torch.no_grad():
        out = tnet(torch.from_numpy(_rays(0, 6)), (1.0, 4.0))
    assert out["rgb"].shape == (6, 3) and "z_std" not in out


@pytest.mark.parametrize("over", [{"conv_embed": True}, {"sem_layer": 3},
                                  {"sem_with_geo": True}])
def test_unported_options_raise(over):
    with pytest.raises(NotImplementedError):
        TorchNet(TorchConfig(**{**TINY, **over}))


def test_checkpoint_save_load(tmp_path):
    _, _, tnet = _pair()
    path = str(tmp_path / "00000100.ckpt")
    tckpt.save_checkpoint(path, 100, tnet)
    assert tckpt.find_latest_checkpoint(str(tmp_path)) == path
    state, step, opt_state = tckpt.load_checkpoint(path)
    assert step == 100 and opt_state is None
    fresh = TorchNet(tnet.cfg)
    tckpt.load_model_state(fresh, state)
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, state[k]), k
    # nostrict: a wider semantic head keeps its fresh init, the rest loads
    wide = TorchNet(dataclasses.replace(tnet.cfg, sem_dim=3))
    before = wide.state_dict()["nerf.mlp.semantic_linear.2.weight"].clone()
    with pytest.raises(RuntimeError):
        tckpt.load_model_state(wide, state, strict=True)
    tckpt.load_model_state(wide, state, strict=False)
    assert torch.equal(wide.state_dict()["nerf.mlp.semantic_linear.2.weight"], before)
    assert torch.equal(wide.state_dict()["nerf.mlp.pts_linears.0.weight"],
                       state["nerf.mlp.pts_linears.0.weight"])


@pytest.mark.parametrize("viewdirs", [True, False])
def test_default_init_draws_as_flax_dense(viewdirs):
    """The port's fresh net draws every weight as the JAX package's flax
    ``Dense`` does (``lecun_normal``: a normal truncated at 2 sigma, variance
    1 / fan_in; zero biases), not by torch's ``nn.Linear`` law (uniform, a
    third of that variance, uniform biases): the same law on every leaf of
    the flagship 8 x 256 net with its semantic head, JAX's drawn beside."""
    kw = dict(use_semantics=True, sem_with_coord=True, use_viewdirs=viewdirs)
    jparams = _np_params(JaxNet(JaxConfig(**kw)).init(jax.random.PRNGKey(0)))
    torch.manual_seed(0)
    got = TorchNet(TorchConfig(**kw)).state_dict()
    want = tckpt.state_dict_from_jax_params(jparams)
    assert got.keys() == want.keys()
    for k, v in got.items():
        w = want[k]
        assert v.shape == w.shape, k
        if k.endswith("bias"):
            assert not v.any() and not w.any(), k
            continue
        fan_in, n = v.shape[1], v.numel()
        bound = 2 * math.sqrt(1.0 / fan_in) / 0.87962566103423978
        for x in (v, w):
            assert float(x.abs().max()) <= bound * (1 + 1e-6), k
            # the std of n draws: within 6 of its standard errors of 1/sqrt(fan_in)
            assert abs(float(x.std()) * math.sqrt(fan_in) - 1) < 6 / math.sqrt(n) + 0.02, k
