"""K1/K2 CUDA kernels vs their plain PyTorch versions on the card.

Marked ``cuda``: every test skips without a CUDA device (the kernels have no
CPU or interpret mode). On a machine with a card:

    python -m pytest tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest
import torch

from nerfsos_torch.models.fields import NeRFField
from nerfsos_torch.ops import fused_render as fr

pytestmark = pytest.mark.cuda

# fp32 on both sides; only summation orders differ (see chip_smoke.TOL)
TOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _field(device, seed, **kw):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        field = NeRFField(**kw)
    return field.to(device).eval()


def _inputs(device, n, s, seed):
    rng = np.random.default_rng(seed)
    odv = rng.normal(size=(n, 9)).astype(np.float32)
    odv[:, 0:3] *= 2.0
    odv[:, 6:9] = odv[:, 3:6] / np.linalg.norm(odv[:, 3:6], axis=1, keepdims=True)
    z = np.sort(rng.uniform(1, 6, size=(n, s)), 1).astype(np.float32)
    return torch.from_numpy(odv).to(device), torch.from_numpy(z).to(device)


SHAPES = [
    dict(net_depth=8, net_width=256, multires=10, multires_views=4),
    dict(net_depth=5, net_width=16, multires=4, multires_views=2),  # skip after the last layer
    dict(net_depth=6, net_width=64, multires=6, multires_views=3),
]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("n,s", [(1000, 64), (37, 8), (3, 130)])
def test_k1_matches_plain(cuda, shape, n, s):
    field = _field(cuda, 0, **shape)
    odv, z = _inputs(cuda, n, s, 1)
    od = odv[:, :6].contiguous()
    before = fr.fused_coarse_weights.launches
    with torch.no_grad():
        got = fr.fused_coarse_weights(field, od, z)
        want = fr.coarse_weights_plain(field, od, z)
    torch.cuda.synchronize()
    assert fr.fused_coarse_weights.launches == before + 1
    assert torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= TOL


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("sem,coord", [(True, True), (True, False), (False, False)])
@pytest.mark.parametrize("n,s", [(1000, 192), (37, 16)])
def test_k2_matches_plain(cuda, shape, sem, coord, n, s):
    field = _field(cuda, 1, use_semantics=sem, sem_with_coord=coord, sem_dim=3, **shape)
    odv, z = _inputs(cuda, n, s, 2)
    before = fr.fused_render.launches
    with torch.no_grad():
        maps, w = fr.fused_render(field, odv, z)
        maps_p, w_p = fr.render_plain(field, odv, z)
    torch.cuda.synchronize()
    assert fr.fused_render.launches == before + 1
    assert maps.shape == maps_p.shape
    assert float((maps - maps_p).abs().max()) <= TOL
    assert float((w - w_p).abs().max()) <= TOL


def test_wrappers_reject_bad_inputs(cuda):
    field = _field(cuda, 0, **SHAPES[1])
    odv, z = _inputs(cuda, 16, 8, 3)
    with pytest.raises(ValueError):
        fr.fused_coarse_weights(field, odv[:, :6], z)  # not contiguous
    with pytest.raises(NotImplementedError):
        fr.fused_render(field, odv.double(), z.double())
    with pytest.raises(ValueError):
        fr.fused_render(field, odv, z[:8])
    with pytest.raises(NotImplementedError):
        fr.fused_render(field.cpu(), odv, z)  # weights on another device


def test_empty_batch(cuda):
    field = _field(cuda, 0, **SHAPES[1])
    odv, z = _inputs(cuda, 0, 8, 4)
    maps, w = fr.fused_render(field, odv, z)
    assert maps.shape == (0, 5) and w.shape == (0, 8)
