"""K1/K2 plain versions vs the JAX Pallas kernels (interpret mode, CPU), and
the CPU dispatch of the kernel wrappers.

The CUDA kernels themselves run only on a card (tests/test_torch_cuda.py);
here the wrappers must take the plain path because the tensors lie on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfsos_torch import _build
from nerfsos_torch.engines.checkpoint import state_dict_from_jax_params
from nerfsos_torch.models.nerf import NeRFConfig as TorchConfig
from nerfsos_torch.models.nerf import NeRFNet as TorchNet
from nerfsos_torch.ops import fused_render as tfr
from nerfsos_tpu.models.nerf import NeRFConfig as JaxConfig
from nerfsos_tpu.models.nerf import NeRFNet as JaxNet
from nerfsos_tpu.ops.pallas import fused_field as jff
from nerfsos_tpu.ops.pallas import fused_render as jfr

TINY = dict(netwidth=16, netdepth=5, netwidth_fine=16, netdepth_fine=5, n_samples=8,
            n_importance=8, multires=4, multires_views=2, use_semantics=True,
            sem_with_coord=True)
R = 20  # not a multiple of the 8-ray Pallas block: exercises its padding


@pytest.fixture(autouse=True)
def small_pallas_block(monkeypatch):
    """8 rays per Pallas grid step keeps interpret mode fast (the default
    sizes the block for the TPU: 576 rays at S=8)."""
    monkeypatch.setattr(jfr, "RAY_BLOCK", 8)


def _nets(**over):
    kw = {**TINY, **over}
    jcfg = JaxConfig(**kw, fused_field=True)
    params = JaxNet(jcfg).init(jax.random.PRNGKey(2))
    tnet = TorchNet(TorchConfig(**kw, fused_field=True))
    tnet.load_state_dict(state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, params)))
    return jcfg, params, tnet


def _inputs(seed, s):
    rng = np.random.default_rng(seed)
    odv = rng.normal(size=(R, 9)).astype(np.float32)
    odv[:, 6:9] /= np.linalg.norm(odv[:, 6:9], axis=1, keepdims=True)
    z = np.sort(rng.uniform(1, 4, size=(R, s)), 1).astype(np.float32)
    return odv, z


def test_k1_plain_matches_pallas():
    jcfg, params, tnet = _nets()
    odv, z = _inputs(0, 8)
    want = jfr.fused_coarse_weights_planar(params["coarse"], jnp.asarray(odv[:, :6]),
                                           jnp.asarray(z), jcfg, interpret=True)
    with torch.no_grad():
        got = tfr.coarse_weights_plain(tnet.nerf, torch.from_numpy(odv[:, :6].copy()),
                                       torch.from_numpy(z))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("use_semantics", [True, False])
def test_k2_plain_matches_pallas(use_semantics):
    jcfg, params, tnet = _nets(use_semantics=use_semantics)
    odv, z = _inputs(1, 16)
    maps_j, w_j = jfr.fused_render_planar(params["fine"], jnp.asarray(odv), jnp.asarray(z),
                                          jcfg, interpret=True)
    with torch.no_grad():
        maps_t, w_t = tfr.render_plain(tnet.nerf_fine, torch.from_numpy(odv), torch.from_numpy(z))
    assert maps_t.shape == maps_j.shape == (R, 5 + (2 if use_semantics else 0))
    np.testing.assert_allclose(maps_t.numpy(), np.asarray(maps_j), atol=2e-5, rtol=1e-5)
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), atol=2e-5, rtol=1e-5)


@pytest.mark.parametrize("white_bkgd", [False, True])
def test_finish_maps_matches_jax(white_bkgd):
    rng = np.random.default_rng(3)
    maps = rng.uniform(0, 1, size=(R, 7)).astype(np.float32)
    maps[:3, 4] = 0.0  # vacant rays: depth 1e10
    w = rng.uniform(0, 1, size=(R, 8)).astype(np.float32)
    want = jfr.finish_maps(jnp.asarray(maps), jnp.asarray(w), True, white_bkgd)
    got = tfr.finish_maps(torch.from_numpy(maps), torch.from_numpy(w), True, white_bkgd)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, err_msg=k)


def test_cpu_wrappers_take_the_plain_path():
    _, _, tnet = _nets()
    odv, z = _inputs(4, 8)
    odv_t, z_t = torch.from_numpy(odv), torch.from_numpy(z)
    before = (tfr.fused_coarse_weights.launches, tfr.fused_render.launches)
    with torch.no_grad():
        w = tfr.fused_coarse_weights(tnet.nerf, odv_t[:, :6].contiguous(), z_t)
        maps, w2 = tfr.fused_render(tnet.nerf_fine, odv_t, z_t)
        assert torch.equal(w, tfr.coarse_weights_plain(tnet.nerf, odv_t[:, :6].contiguous(), z_t))
        maps_p, w2_p = tfr.render_plain(tnet.nerf_fine, odv_t, z_t)
    assert torch.equal(maps, maps_p) and torch.equal(w2, w2_p)
    assert (tfr.fused_coarse_weights.launches, tfr.fused_render.launches) == before


def test_pack_field_layout():
    """The packed buffer holds each layer as W^T [in, out], every input
    segment and the output width zero-padded to a multiple of 8, then its TF32
    high and low parts, then its zero-padded bias, at the descriptor's
    offsets, in the kernel's order."""
    _, _, tnet = _nets()
    field = tnet.nerf_fine
    buf, desc = tfr.pack_field(field)
    layers = tfr._field_layers(field)
    assert len(layers) == desc.depth + 6 <= _build.MAX_LAYERS
    assert [segs for _, segs in layers] == [
        [27], [16], [16], [16], [16],      # trunk; the skip concat follows layer 4 (the last)
        [27, 16], [27, 16], [16, 15], [8],  # alpha, feature, views [feature, PE(dirs)], rgb
        [27, 16, 27], [8]]                  # sem_0 [h, emb] with h = [emb, h'], sem_1
    for i, (lin, segs) in enumerate(layers):
        L = desc.layer[i]
        npad = (lin.out_features + 7) // 8 * 8
        assert (L.k, L.n) == (sum((k + 7) // 8 * 8 for k in segs), lin.out_features)
        wt = buf[L.w:L.w + L.k * npad].reshape(L.k, npad)
        rows, r = [], 0
        for k in segs:
            rows.append(wt[r:r + k])
            assert not wt[r + k:r + (k + 7) // 8 * 8].any()
            r += (k + 7) // 8 * 8
        assert torch.equal(torch.cat(rows)[:, :lin.out_features], lin.weight.detach().t())
        assert not wt[:, lin.out_features:].any()
        hi = buf[L.w + wt.numel():L.w + 2 * wt.numel()].reshape(wt.shape)
        lo = buf[L.w + 2 * wt.numel():L.w + 3 * wt.numel()].reshape(wt.shape)
        for part in (hi, lo):  # TF32: the low 13 mantissa bits are zero
            assert not (part.view(torch.int32) & 0x1FFF).any()
        assert float((hi + lo - wt).abs().max()) <= 2.0**-21 * float(wt.abs().max())
        assert L.b == L.w + 3 * wt.numel()
        assert torch.equal(buf[L.b:L.b + L.n], lin.bias.detach())
        assert not buf[L.b + L.n:L.b + npad].any()
    assert (desc.depth, desc.skip, desc.hrows) == (5, 4, 16)
    assert (desc.emb_dim, desc.demb_dim, desc.sem_dim, desc.sem_with_coord) == (27, 15, 2, 1)


def test_packed_cache_follows_weight_updates():
    _, _, tnet = _nets()
    field = tnet.nerf
    buf1, _ = tfr._packed(field, torch.device("cpu"))
    assert tfr._packed(field, torch.device("cpu"))[0] is buf1
    with torch.no_grad():
        field.mlp.pts_linears[0].bias.add_(1.0)
    buf2, desc = tfr._packed(field, torch.device("cpu"))
    assert buf2 is not buf1
    L = desc.layer[0]
    assert torch.equal(buf2[L.b:L.b + L.n], field.mlp.pts_linears[0].bias.detach())


@pytest.mark.parametrize("over", [{}, {"use_semantics": False}, {"use_viewdirs": False},
                                  {"conv_embed": True}, {"sem_layer": 3},
                                  {"sem_with_geo": True}])
def test_supports_fused_matches_jax_gate(over):
    cfg = TorchConfig(**{**TINY, **over})
    assert tfr.supports_fused(cfg) == jff.supports_fused(JaxConfig(**{**TINY, **over}))


def test_supports_fused_kernel_limits():
    assert tfr.supports_fused(TorchConfig())  # the flagship 8 x 256
    assert not tfr.supports_fused(TorchConfig(netwidth=512))
    assert not tfr.supports_fused(TorchConfig(netdepth_fine=11))
    assert not tfr.supports_fused(TorchConfig(use_semantics=True, sem_dim=9))
