"""K1-K7, the mip kernels K9/K10a/K10b and the field kernels (K8a-K8f,
K11) vs their plain PyTorch versions on the card.

Marked ``cuda``: every test skips without a CUDA device (the kernels have no
CPU or interpret mode). On a machine with a card (``--noconftest``: the
repository's conftest imports jax):

    python -m pytest tests/test_torch_cuda.py -q --noconftest

The tolerances and K3's allowance for relu gates that rounding flips are
``chip_smoke.py``'s, where their reasoning is written down; so is the bound
of the bf16 modes of K1, K2, K4 and K5 (``bf16_columns``, ``bf16_stored``:
bf16 rounding flips bounded as a group, at most BF16_FLIP_ROWS of the rows
beyond TOL, each entry within BF16_ENTRY of its column's scale; sem_in
within BF16_STORED_SHARE and BF16_STORED_STEPS; ``k5_bf16_over``: each leaf
within BF16_SHARE of its bf16-vs-fp32 distance or GRAD_TOL; K3's and K6's bf16
leaves within BF16_WITNESS of their plain version's last-bit sensitivity or
GRAD_TOL over several waves, ``bf16_leaves``; on one wave their stored planes
within bf16_stored's bounds of the plain forward and their reverse sweep
within BF16_PLANES_TOL of the plain sweep on those planes, ``bf16_planes``).
The mip kernels' bf16 modes (K9, K10a, K10b, K11) and the classic field
kernels' (K8a-K8f) are held as K1-K6's are (K10b's one wave by
``bf16_planes`` with ``mip``, K8c/K8f's with ``points``). K5 is held to GRAD_TOL on
points whose semantic-head gates are clear of 0 (the others get weight 0); K6
on rays whose trunk, views and semantic-head gates are clear of 0; K10b on
rays whose trunk and views gates are clear of 0; the field backward on
points whose trunk, views and semantic-head gates are clear of 0.
"""
import ctypes
import itertools

import numpy as np
import pytest
import torch

from chip_smoke import (GATE_MARGIN, GRAD_TOL, INPUT_GRAD_MARGIN, K7_TOL, TOL, bf16_columns,
                        bf16_leaves, bf16_planes, bf16_points, bf16_stored, bf16_witness,
                        flip_allowance, k5_bf16_over,
                        plain_k3_with_gates, plain_k6_with_gates, plain_k10b_with_gates)
from nerfsos_torch.core.sampling import points_along_rays
from nerfsos_torch.models import mlp as mlp_lib
from nerfsos_torch.models.fields import MipNeRFField, NeRFField
from nerfsos_torch.ops import fused_field as ff
from nerfsos_torch.ops import fused_render as fr

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _torch_law(ctor, seed, **kw):
    """``ctor(**kw)`` from ``torch.manual_seed(seed)`` with every nn.Linear
    keeping its own draw (torch's law: U(+-1/sqrt(fan_in)) biases), the
    fixtures these tests' bounds were set on, not the port's default MLP
    init (flax's Dense law since models/mlp.flax_dense_init_: zero biases,
    which bf16_witness's bias nudges leave unmoved, so that its bound falls
    to GRAD_TOL; the kernels read the parent's bits, PERF.md §6)."""
    saved, mlp_lib.flax_dense_init_ = mlp_lib.flax_dense_init_, lambda layer: None
    try:
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            return ctor(**kw)
    finally:
        mlp_lib.flax_dense_init_ = saved


def _field(device, seed, **kw):
    return _torch_law(NeRFField, seed, **kw).to(device).eval()


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
        again = fr.fused_coarse_weights(field, od, z)
        want = fr.coarse_weights_plain(field, od, z)
    torch.cuda.synchronize()
    assert fr.fused_coarse_weights.launches == before + 2
    assert torch.isfinite(got).all() and torch.equal(got, again)
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
        again = fr.fused_render(field, odv, z)
        maps_p, w_p = fr.render_plain(field, odv, z)
    torch.cuda.synchronize()
    assert fr.fused_render.launches == before + 2
    assert maps.shape == maps_p.shape
    assert float((maps - maps_p).abs().max()) <= TOL
    assert float((w - w_p).abs().max()) <= TOL
    assert torch.equal(maps, again[0]) and torch.equal(w, again[1])


@pytest.mark.parametrize("sem", [True, False])
def test_k2_is_k4_without_noise(cuda, sem):
    """K2 launches K4's kernel with noise 0 and no sem_in: the same bits as
    train_render's at noise 0, and its own launch count."""
    field = _field(cuda, 2, use_semantics=sem, sem_with_coord=sem, sem_dim=2, **SHAPES[0])
    odv, z = _inputs(cuda, 300, 192, 3)
    counts = (fr.fused_render.launches, fr.train_render.launches)
    with torch.no_grad():
        got = fr.fused_render(field, odv, z)
        want = fr.train_render(field, odv, z, noise_std=0.0, seed=0, save_semin=False)
    torch.cuda.synchronize()
    assert (fr.fused_render.launches, fr.train_render.launches) == (counts[0] + 1, counts[1] + 1)
    assert want[2] is None and torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


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


def _k3_inputs(device, n, s, seed):
    odv, z = _inputs(device, n, s, seed)
    gt = torch.from_numpy(np.random.default_rng(seed).uniform(0, 1, (n, 3)).astype(np.float32))
    return odv, z, gt.to(device)


def _gate_clear_inputs(field, n, s, seed, pool=4096, sem=False, mip=False):
    """``_k3_inputs`` (with ``mip``, ``_mip_inputs`` for a ``MipNeRFField``)
    for ``n`` rays none of whose points has a trunk or views (with ``sem``,
    semantic-head) relu input within 2 x GATE_MARGIN of 0 (of its layer's
    largest |input| over a pool of candidates): a kernel and its plain
    version then take those gates alike, and a leaf keeps a flip allowance
    only for sigma + noise, whose noise depends on the ray's place in the
    batch."""
    mlp = field.mlp
    gates = [*mlp.pts_linears, mlp.views_linears[0]] + ([mlp.semantic_linear[0]] if sem else [])
    device = next(field.parameters()).device
    keep = []
    for k in itertools.count():
        cand = (_mip_inputs if mip else _k3_inputs)(device, pool, s, seed + k)
        slack = torch.full((pool * s,), float("inf"), device=device)

        def hook(mod, inputs, out):
            pre = out.reshape(pool * s, -1).abs()
            torch.minimum(slack, pre.amin(1) / pre.max(), out=slack)

        handles = [m.register_forward_hook(hook) for m in gates]
        with torch.no_grad():
            if mip:
                fr._mip_raw(field, *cand)
            else:
                odv, z = cand[:2]
                field(points_along_rays(odv[:, 0:3], odv[:, 3:6], z), odv[:, 6:9])
        for h in handles:
            h.remove()
        clear = (slack.view(pool, s) > 2 * GATE_MARGIN).all(1)
        keep += [tuple(t[clear] for t in cand)]
        if sum(len(t[0]) for t in keep) >= n:
            return tuple(torch.cat(parts)[:n].contiguous() for parts in zip(*keep))


def _assert_k3_close(got, want, allow=None):
    """Maps and weights to TOL; each gradient leaf to GRAD_TOL of its max
    |plain|, plus that leaf's own ``allow`` (``chip_smoke.flip_allowance``:
    what a relu gate flipped by rounding can move) where given."""
    g, maps, w = got
    gp, maps_p, w_p = want
    assert maps.shape == maps_p.shape and w.shape == w_p.shape
    assert float((maps - maps_p).abs().max()) <= TOL
    assert float((w - w_p).abs().max()) <= TOL
    assert set(g) == set(gp)
    for name, ref in gp.items():
        scale = max(float(ref.abs().max()), 1e-12)
        bound = GRAD_TOL * scale + (0.0 if allow is None else allow[name])
        assert g[name].shape == ref.shape, name
        assert torch.isfinite(g[name]).all(), name
        err = float((g[name] - ref).abs().max())
        assert err <= bound, (name, err / scale, bound / scale)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("s,sem,white", [(64, True, False), (192, True, False),
                                         (192, False, True), (16, True, True)])
@pytest.mark.parametrize("n", [1, 37, 4096])
def test_k3_matches_plain(cuda, shape, s, sem, white, n):
    field = _field(cuda, 2, use_semantics=sem, sem_with_coord=sem, sem_dim=2, **shape)
    odv, z, gt = _gate_clear_inputs(field, n, s, 5)
    kw = dict(white_bkgd=white, noise_std=1.0, seed=987654)
    before = fr.fused_rgb_train_grads.launches
    got = fr.fused_rgb_train_grads(field, odv, z, gt, **kw)
    want, slack, terms = plain_k3_with_gates(field, odv, z, gt, kw)
    torch.cuda.synchronize()
    assert fr.fused_rgb_train_grads.launches == before + 1
    _assert_k3_close(got, want, flip_allowance(slack, terms))
    for name, g in got[0].items():
        if "semantic_linear" in name:
            assert not g.any(), name


def test_k3_is_deterministic(cuda):
    """The partial gradients of the CTAs are summed in a fixed order."""
    field = _field(cuda, 3, use_semantics=True, sem_with_coord=True, **SHAPES[0])
    odv, z, gt = _k3_inputs(cuda, 3000, 64, 6)
    kw = dict(white_bkgd=False, noise_std=1.0, seed=11)
    a = fr.fused_rgb_train_grads(field, odv, z, gt, **kw)
    b = fr.fused_rgb_train_grads(field, odv, z, gt, **kw)
    for k in a[0]:
        assert torch.equal(a[0][k], b[0][k]), k
    assert torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])


def test_k3_noise_matches_the_hash(cuda):
    """With a field whose density is 0 everywhere the kernel's sigma is the
    noise alone, so its weights follow the plain version's hash draws."""
    field = _field(cuda, 4, **SHAPES[1])
    with torch.no_grad():
        field.mlp.alpha_linear.weight.zero_()
        field.mlp.alpha_linear.bias.zero_()
    odv, z, gt = _k3_inputs(cuda, 50, 16, 7)
    kw = dict(white_bkgd=False, noise_std=2.0, seed=2**31 - 300)
    _assert_k3_close(fr.fused_rgb_train_grads(field, odv, z, gt, **kw),
                     fr.rgb_train_grads_plain(field, odv, z, gt, **kw))
    _, _, w0 = fr.fused_rgb_train_grads(field, odv, z, gt, white_bkgd=False, noise_std=0.0,
                                        seed=0)
    assert not w0.any()  # no noise, no density


def test_k3_rejects_bad_inputs(cuda):
    field = _field(cuda, 0, **SHAPES[1])
    odv, z, gt = _k3_inputs(cuda, 16, 8, 3)
    kw = dict(white_bkgd=False, noise_std=0.0, seed=0)
    with pytest.raises(ValueError):
        fr.fused_rgb_train_grads(field, odv[:, :9:1].t().contiguous().t(), z, gt, **kw)
    with pytest.raises(ValueError):
        fr.fused_rgb_train_grads(field, odv, z[:8], gt, **kw)
    with pytest.raises(ValueError):
        fr.fused_rgb_train_grads(field, odv, z, gt[:, :2].contiguous(), **kw)
    with pytest.raises(ValueError):
        fr.fused_rgb_train_grads(field, odv, z, gt.double(), **kw)
    with pytest.raises(NotImplementedError):
        fr.fused_rgb_train_grads(field, odv.double(), z.double(), gt, **kw)
    with pytest.raises(NotImplementedError):
        fr.fused_rgb_train_grads(field.cpu(), odv, z, gt, **kw)  # weights on another device


def test_k3_empty_batch(cuda):
    field = _field(cuda, 0, use_semantics=True, **SHAPES[1])
    odv, z, gt = _k3_inputs(cuda, 0, 8, 4)
    g, maps, w = fr.fused_rgb_train_grads(field, odv, z, gt, white_bkgd=False, noise_std=0.0,
                                          seed=0)
    assert maps.shape == (0, 7) and w.shape == (0, 8)
    assert all(not v.any() for v in g.values())


# ----------------------------------------------------------------- K4, K5


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("coord,noise", [(True, 1.0), (False, 0.0)])
@pytest.mark.parametrize("n,s", [(1, 64), (37, 192), (4096, 64), (4096, 192)])
def test_k4_matches_plain(cuda, shape, coord, noise, n, s):
    """The train forward: maps, weights and sem_in to TOL."""
    field = _field(cuda, 5, use_semantics=True, sem_with_coord=coord, sem_dim=2, **shape)
    odv, z = _inputs(cuda, n, s, 8)
    kw = dict(noise_std=noise, seed=24680, save_semin=True)
    before = fr.train_render.launches
    with torch.no_grad():
        got = fr.train_render(field, odv, z, **kw)
        want = fr.train_render_plain(field, odv, z, **kw)
    torch.cuda.synchronize()
    assert fr.train_render.launches == before + 1
    for a, b in zip(got, want):
        assert a.shape == b.shape and torch.isfinite(a).all()
        assert float((a - b).abs().max()) <= TOL
    maps, w, none = fr.train_render(field, odv, z, noise_std=noise, seed=24680, save_semin=False)
    assert none is None and torch.equal(maps, got[0]) and torch.equal(w, got[1])


@pytest.mark.parametrize("width", [128, 256])
@pytest.mark.parametrize("sem,coord", [(True, True), (True, False), (False, False)])
@pytest.mark.parametrize("noise,semin", [(1.0, True), (0.0, False)])
@pytest.mark.parametrize("n,s", [(41, 37), (300, 64), (77, 192)])
def test_k4_tile_matches_plain(cuda, width, sem, coord, noise, semin, n, s):
    """K4's 128-point tile (csrc/wg_tile.cuh) at widths 128 and 256, with and
    without the semantic head and its coordinates, sem_in stored or not, on
    batches whose last tile is ragged (41 x 37, the last chunk of 300 x 64
    and of 77 x 192): maps, weights and sem_in to TOL, two calls bitwise
    equal."""
    field = _field(cuda, 12, use_semantics=sem, sem_with_coord=coord, sem_dim=2,
                   net_depth=8, net_width=width, multires=10, multires_views=4)
    odv, z = _inputs(cuda, n, s, 13)
    kw = dict(noise_std=noise, seed=97531, save_semin=sem and semin)
    with torch.no_grad():
        got = fr.train_render(field, odv, z, **kw)
        again = fr.train_render(field, odv, z, **kw)
        want = fr.train_render_plain(field, odv, z, **kw)
    torch.cuda.synchronize()
    assert (got[2] is None) == (want[2] is None) == (not kw["save_semin"])
    for a, b, c in zip(got, want, again):
        if b is None:
            continue
        assert a.shape == b.shape and torch.isfinite(a).all()
        assert float((a - b).abs().max()) <= TOL
        assert torch.equal(a, c)


def _gate_clear_weights(field, sem_in, w):
    """``w`` with the points whose semantic-head relu input lies within
    2 x GATE_MARGIN of 0 (of the layer's largest |input|) set to 0: such a
    gate may take the other side in the kernel, and a zero weight gives the
    point no cotangent in either version."""
    lin = field.mlp.semantic_linear[0]
    with torch.no_grad():
        pre = torch.nn.functional.linear(sem_in, lin.weight, lin.bias).abs()
        slack = pre.amin(1) / pre.max()
    return torch.where((slack > 2 * GATE_MARGIN).view_as(w), w, torch.zeros_like(w))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("coord", [True, False])
@pytest.mark.parametrize("n,s", [(1, 64), (37, 192), (4096, 64), (4096, 192)])
def test_k5_matches_plain(cuda, shape, coord, n, s):
    """The semantic head's gradients to GRAD_TOL of each leaf's max, and
    bitwise equal across two calls."""
    field = _field(cuda, 6, use_semantics=True, sem_with_coord=coord, sem_dim=2, **shape)
    odv, z = _inputs(cuda, n, s, 9)
    with torch.no_grad():
        _, w, sem_in = fr.train_render(field, odv, z, noise_std=1.0, seed=7, save_semin=True)
    w = _gate_clear_weights(field, sem_in, w)
    dmaps = torch.from_numpy(np.random.default_rng(10).normal(size=(n, 7)).astype(np.float32))
    dmaps = dmaps.to(cuda)
    before = fr.frozen_sem_grads.launches
    got = fr.frozen_sem_grads(field, sem_in, w, dmaps)
    again = fr.frozen_sem_grads(field, sem_in, w, dmaps)
    want = fr.frozen_sem_grads_plain(field, sem_in, w, dmaps)
    torch.cuda.synchronize()
    assert fr.frozen_sem_grads.launches == before + 2
    assert set(got) == set(want) == set(fr._SEM_NAMES)
    for name, ref in want.items():
        assert torch.equal(got[name], again[name]), name
        assert got[name].shape == ref.shape and torch.isfinite(got[name]).all(), name
        scale = max(float(ref.abs().max()), 1e-12)
        assert float((got[name] - ref).abs().max()) <= GRAD_TOL * scale, name


@pytest.mark.parametrize("n,s", [(37, 64), (512, 192)])
def test_k5_takes_the_384_row_head(cuda, n, s):
    """The head whose sem_in has 382 columns (the skip after the last trunk
    layer, width 256, coordinates): one sem_in stage (its plan), every leaf
    to GRAD_TOL, two calls bitwise equal."""
    field = _field(cuda, 8, use_semantics=True, sem_with_coord=True, sem_dim=2, net_depth=5,
                   net_width=256, multires=10, multires_views=4)
    assert field.mlp.semantic_linear[0].in_features == 382
    odv, z = _inputs(cuda, n, s, 12)
    with torch.no_grad():
        _, w, sem_in = fr.train_render(field, odv, z, noise_std=1.0, seed=5, save_semin=True)
    w = _gate_clear_weights(field, sem_in, w)
    dmaps = torch.from_numpy(np.random.default_rng(13).normal(size=(n, 7)).astype(np.float32))
    dmaps = dmaps.to(cuda)
    got = fr.frozen_sem_grads(field, sem_in, w, dmaps)
    again = fr.frozen_sem_grads(field, sem_in, w, dmaps)
    want = fr.frozen_sem_grads_plain(field, sem_in, w, dmaps)
    torch.cuda.synchronize()
    for name, ref in want.items():
        assert torch.equal(got[name], again[name]), name
        scale = max(float(ref.abs().max()), 1e-12)
        assert float((got[name] - ref).abs().max()) <= GRAD_TOL * scale, name


def test_k4_k5_through_autograd(cuda):
    """fused_train_render with ``frozen``: the K4 forward, the K5 backward,
    semantic-head leaves only."""
    field = _field(cuda, 7, use_semantics=True, sem_with_coord=True, sem_dim=2, **SHAPES[0])
    odv, z = _inputs(cuda, 300, 64, 11)
    counts = (fr.train_render.launches, fr.frozen_sem_grads.launches)
    maps, w = fr.fused_train_render(field, odv, z, noise_std=1.0, seed=3, frozen=True)
    (maps[:, 5:] * torch.arange(1.0, 3.0, device=cuda)).sum().backward()
    torch.cuda.synchronize()
    assert (fr.train_render.launches, fr.frozen_sem_grads.launches) == (counts[0] + 1,
                                                                       counts[1] + 1)
    for name, p in field.named_parameters():
        assert (p.grad is not None) == (name in fr._SEM_NAMES), name


def test_k4_k5_reject_bad_inputs(cuda):
    field = _field(cuda, 0, use_semantics=True, **SHAPES[1])
    odv, z = _inputs(cuda, 16, 8, 3)
    with pytest.raises(ValueError):
        fr.train_render(field, odv, z[:8], noise_std=0.0, seed=0, save_semin=True)
    with pytest.raises(NotImplementedError):
        fr.train_render(field, odv.double(), z.double(), noise_std=0.0, seed=0, save_semin=True)
    _, w, sem_in = fr.train_render(field, odv, z, noise_std=0.0, seed=0, save_semin=True)
    with pytest.raises(ValueError):
        fr.frozen_sem_grads(field, sem_in[:-1], w, torch.zeros(16, 7, device=cuda))
    with pytest.raises(ValueError):
        fr.frozen_sem_grads(field, sem_in, w, torch.zeros(16, 6, device=cuda))
    shifted = torch.empty(sem_in.numel() + 1, device=cuda)[1:].view_as(sem_in)
    shifted.copy_(sem_in)
    with pytest.raises(ValueError):  # its tiles are bulk copies from 16-byte boundaries
        fr.frozen_sem_grads(field, shifted, w, torch.zeros(16, 7, device=cuda))


# ----------------------------------------------------------------- K6


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("s,coord,dweights", [(64, True, True), (192, True, False),
                                              (16, False, True)])
@pytest.mark.parametrize("n", [1, 37, 4096])
def test_k6_matches_plain(cuda, shape, s, coord, dweights, n):
    """The full train-render backward: every leaf to GRAD_TOL of its max
    plus the sigma + noise gates' allowance, on rays clear of every other
    gate; bitwise equal across two calls."""
    field = _field(cuda, 8, use_semantics=True, sem_with_coord=coord, sem_dim=2, **shape)
    odv, z, _ = _gate_clear_inputs(field, n, s, 13, sem=True)
    rng = np.random.default_rng(n + s)
    dmaps = torch.from_numpy(rng.normal(size=(n, 7)).astype(np.float32)).to(cuda)
    dw = (torch.from_numpy(rng.normal(size=(n, s)).astype(np.float32)).to(cuda) if dweights
          else None)
    kw = dict(noise_std=1.0, seed=13579)
    before = fr.train_render_grads.launches
    got = fr.train_render_grads(field, odv, z, dmaps, dw, **kw)
    again = fr.train_render_grads(field, odv, z, dmaps, dw, **kw)
    want, slack, terms = plain_k6_with_gates(field, odv, z, dmaps, dw, kw)
    torch.cuda.synchronize()
    assert fr.train_render_grads.launches == before + 2
    allow = flip_allowance(slack, terms)
    assert set(got) == set(want)
    for name, ref in want.items():
        assert torch.equal(got[name], again[name]), name
        assert got[name].shape == ref.shape and torch.isfinite(got[name]).all(), name
        scale = max(float(ref.abs().max()), 1e-12)
        err = float((got[name] - ref).abs().max())
        assert err <= GRAD_TOL * scale + allow[name], (name, err / scale)


@pytest.mark.parametrize("n,s", [(1100, 64), (701, 192)])
def test_k6_dw_at_the_382_row_head(cuda, n, s):
    """wgrad's widest input, sem_0's X rows [emb; h; emb] (382: the skip
    after the last trunk layer, width 256, coordinates) in six 64-row
    blocks, two rounds of the four warpgroups; n rays leave a ragged last
    chunk and more chunks than CTAs, so each reverse sweep takes several
    forward chunks (``_rev_group``). On gate-clear rays every leaf to
    GRAD_TOL of its max plus the sigma gates' allowance, bitwise equal
    across two calls."""
    field = _field(cuda, 8, use_semantics=True, sem_with_coord=True, sem_dim=2, net_depth=5,
                   net_width=256, multires=10, multires_views=4)
    assert field.mlp.semantic_linear[0].in_features == 382
    odv, z, _ = _gate_clear_inputs(field, n, s, 21, sem=True)
    rng = np.random.default_rng(n)
    dmaps = torch.from_numpy(rng.normal(size=(n, 7)).astype(np.float32)).to(cuda)
    dw = torch.from_numpy(rng.normal(size=(n, s)).astype(np.float32)).to(cuda)
    kw = dict(noise_std=1.0, seed=2468)
    got = fr.train_render_grads(field, odv, z, dmaps, dw, **kw)
    again = fr.train_render_grads(field, odv, z, dmaps, dw, **kw)
    want, slack, terms = plain_k6_with_gates(field, odv, z, dmaps, dw, kw)
    torch.cuda.synchronize()
    allow = flip_allowance(slack, terms)
    assert set(got) == set(want)
    for name, ref in want.items():
        assert torch.equal(got[name], again[name]), name
        assert torch.isfinite(got[name]).all(), name
        scale = max(float(ref.abs().max()), 1e-12)
        err = float((got[name] - ref).abs().max())
        assert err <= GRAD_TOL * scale + allow[name], (name, err / scale)


@pytest.mark.parametrize("depth", [8, 6])
@pytest.mark.parametrize("sem_dim,coord", [(2, True), (2, False), (8, True), (8, False)])
@pytest.mark.parametrize("n,s", [(41, 136), (300, 64), (77, 192)])
def test_k3_k6_tile_forward_match_plain(cuda, depth, sem_dim, coord, n, s):
    """K3's and K6's storing forward on the 128-point tile (csrc/wg_tile.cuh,
    train_forward_wg_kernel): S = 136 gives 3-ray chunks of 408 points, an
    odd 7 subs, so the last tile's second warpgroup stores nothing; 41, 300
    and 77 rays leave a ragged last chunk; sem_dim 8 shrinks the plan's
    chunk (the strip is wider); depth 8 and 6, the semantic head with and
    without coordinates. On gate-clear rays: K3's maps and weights to TOL,
    K3's and K6's leaves to GRAD_TOL plus the sigma gates' allowance, and
    both bitwise equal across two calls."""
    field = _field(cuda, 21, use_semantics=True, sem_with_coord=coord, sem_dim=sem_dim,
                   net_depth=depth, net_width=256, multires=10, multires_views=4)
    odv, z, gt = _gate_clear_inputs(field, n, s, 23, sem=True)
    kw = dict(white_bkgd=False, noise_std=1.0, seed=4242)
    got = fr.fused_rgb_train_grads(field, odv, z, gt, **kw)
    again = fr.fused_rgb_train_grads(field, odv, z, gt, **kw)
    want, slack, terms = plain_k3_with_gates(field, odv, z, gt, kw)
    torch.cuda.synchronize()
    _assert_k3_close(got, want, flip_allowance(slack, terms))
    assert all(torch.equal(got[0][k], again[0][k]) for k in got[0])
    assert torch.equal(got[1], again[1]) and torch.equal(got[2], again[2])
    rng = np.random.default_rng(n + s)
    dmaps = torch.from_numpy(rng.normal(size=(n, 5 + sem_dim)).astype(np.float32)).to(cuda)
    dw = torch.from_numpy(rng.normal(size=(n, s)).astype(np.float32)).to(cuda)
    kw = dict(noise_std=1.0, seed=4243)
    got = fr.train_render_grads(field, odv, z, dmaps, dw, **kw)
    again = fr.train_render_grads(field, odv, z, dmaps, dw, **kw)
    want, slack, terms = plain_k6_with_gates(field, odv, z, dmaps, dw, kw)
    torch.cuda.synchronize()
    allow = flip_allowance(slack, terms)
    assert set(got) == set(want)
    for name, ref in want.items():
        assert torch.equal(got[name], again[name]), name
        assert got[name].shape == ref.shape and torch.isfinite(got[name]).all(), name
        scale = max(float(ref.abs().max()), 1e-12)
        err = float((got[name] - ref).abs().max())
        assert err <= GRAD_TOL * scale + allow[name], (name, err / scale)


def test_k6_without_semantics(cuda):
    """A field without the semantic head: K6 sweeps its layers alone."""
    field = _field(cuda, 9, **SHAPES[0])
    odv, z, _ = _gate_clear_inputs(field, 500, 64, 14)
    dmaps = torch.from_numpy(np.random.default_rng(1).normal(size=(500, 5)).astype(np.float32))
    kw = dict(noise_std=0.0, seed=0)
    got = fr.train_render_grads(field, odv, z, dmaps.to(cuda), None, **kw)
    want, slack, terms = plain_k6_with_gates(field, odv, z, dmaps.to(cuda), None, kw)
    allow = flip_allowance(slack, terms)
    for name, ref in want.items():
        scale = max(float(ref.abs().max()), 1e-12)
        assert float((got[name] - ref).abs().max()) <= GRAD_TOL * scale + allow[name], name


def test_k4_k6_through_autograd(cuda):
    """fused_train_render without ``frozen``: the K4 forward, the K6
    backward, a gradient on every leaf; K5 does not run."""
    field = _field(cuda, 10, use_semantics=True, sem_with_coord=True, sem_dim=2, **SHAPES[0])
    odv, z = _inputs(cuda, 300, 64, 15)
    counts = (fr.train_render.launches, fr.train_render_grads.launches,
              fr.frozen_sem_grads.launches)
    maps, w = fr.fused_train_render(field, odv, z, noise_std=1.0, seed=3, frozen=False)
    (maps * torch.arange(1.0, 8.0, device=cuda)).sum().backward()
    torch.cuda.synchronize()
    assert (fr.train_render.launches, fr.train_render_grads.launches,
            fr.frozen_sem_grads.launches) == (counts[0] + 1, counts[1] + 1, counts[2])
    assert all(p.grad is not None and torch.isfinite(p.grad).all() for p in field.parameters())


def test_k6_rejects_bad_inputs(cuda):
    field = _field(cuda, 0, use_semantics=True, **SHAPES[1])
    odv, z = _inputs(cuda, 16, 8, 3)
    kw = dict(noise_std=0.0, seed=0)
    with pytest.raises(ValueError):
        fr.train_render_grads(field, odv, z, torch.zeros(16, 6, device=cuda), None, **kw)
    with pytest.raises(ValueError):
        fr.train_render_grads(field, odv, z, torch.zeros(16, 7, device=cuda),
                              torch.zeros(16, 9, device=cuda), **kw)
    with pytest.raises(ValueError):
        fr.train_render_grads(field, odv, z, torch.zeros(16, 7, device=cuda).double(), None,
                              **kw)


# ----------------------------------------------------------------- K7


def _geo_inputs(device, B2, N, S, seed):
    """Points of rendered-depth scale and channel-normalised codes, the
    layouts of ops/flash_corr.py (rows [2B, N, C])."""
    rng = np.random.default_rng(seed)
    f1 = rng.normal(size=(B2, N, 3)) * 0.7
    f2 = np.concatenate([f1[B2 // 2:][::-1], f1[B2 // 2:]])  # neg half, self half
    codes = []
    for _ in range(4):
        c = rng.normal(size=(B2, N, S))
        codes.append(c / np.linalg.norm(c, axis=2, keepdims=True))
    return [torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)
            for a in (f1, f2, *codes)]


@pytest.mark.parametrize("B2,N,S", [(2, 256, 2), (4, 1000, 3), (16, 4096, 2), (2, 77, 8),
                                    (2, 4133, 2), (4, 129, 8)])  # past a pair tile's edges
@pytest.mark.parametrize("maxd", [15.0, 1.5])
def test_k7_matches_plain(cuda, B2, N, S, maxd):
    """Row stats, the four means and the four code gradients to K7_TOL;
    the means and the gradients bitwise equal across two calls."""
    from nerfsos_torch.ops import flash_corr as fc

    f1, f2, c1a, c2a, c1b, c2b = _geo_inputs(cuda, B2, N, S, B2 + N)
    args = (0.5, 3.0, maxd)
    before = (fc.geo_row_stats.launches, fc.geo_quad_means.launches, fc.geo_quad_grads.launches)
    rm, gm = fc.geo_row_stats(f1, f2, maxd)
    rm_p, gm_p = fc.geo_row_stats_plain(f1, f2, maxd)
    assert float((rm - rm_p).abs().max()) <= K7_TOL * float(rm_p.abs().max())
    assert float((gm - gm_p).abs().max()) <= K7_TOL * float(gm_p.abs().max())
    out = fc.geo_quad_means(f1, f2, c1a, c2a, c1b, c2b, rm, gm, *args)
    out2 = fc.geo_quad_means(f1, f2, c1a, c2a, c1b, c2b, rm, gm, *args)
    want = fc.geo_quad_means_plain(f1, f2, c1a, c2a, c1b, c2b, rm, gm, *args)
    assert torch.equal(out, out2)
    assert float((out - want).abs().max()) <= K7_TOL * float(want.abs().max())
    coeff = torch.tensor([0.3, -1.0, 2.0, 0.7], device=cuda) / (B2 // 2 * N * N)
    g = fc.geo_quad_grads(f1, f2, c1a, c2a, c1b, c2b, rm, gm, coeff, *args)
    g2 = fc.geo_quad_grads(f1, f2, c1a, c2a, c1b, c2b, rm, gm, coeff, *args)
    g_p = fc.geo_quad_grads_plain(f1, f2, c1a, c2a, c1b, c2b, rm, gm, coeff, *args)
    torch.cuda.synchronize()
    assert (fc.geo_row_stats.launches, fc.geo_quad_means.launches,
            fc.geo_quad_grads.launches) == (before[0] + 1, before[1] + 2, before[2] + 2)
    for a, b, ref in zip(g, g2, g_p):
        assert torch.equal(a, b) and torch.isfinite(a).all()
        assert float((a - ref).abs().max()) <= K7_TOL * float(ref.abs().max())


@pytest.mark.parametrize("B2,N,halves", [(16, 4096, 2), (4, 1000, 2), (2, 77, 1), (3, 4133, 1),
                                         (2, 256, 2)])  # past the tiles' edges
@pytest.mark.parametrize("maxd", [15.0, 1.5])
def test_k7a_matches_plain(cuda, B2, N, halves, maxd):
    """K7a's pair tiles: rowmean and each half's gm to K7_TOL of the plain
    version's, bitwise equal across two calls, one launch counted a call."""
    from nerfsos_torch.ops import flash_corr as fc

    f1, f2 = _geo_inputs(cuda, B2 + B2 % 2, N, 2, B2 * N)[:2]
    f1, f2 = f1[:B2].contiguous(), f2[:B2].contiguous()
    before = fc.geo_row_stats.launches
    rm, gm = fc.geo_row_stats(f1, f2, maxd, halves)
    rm2, gm2 = fc.geo_row_stats(f1, f2, maxd, halves)
    rm_p, gm_p = fc.geo_row_stats_plain(f1, f2, maxd, halves)
    torch.cuda.synchronize()
    assert fc.geo_row_stats.launches == before + 2
    assert torch.equal(rm, rm2) and torch.equal(gm, gm2) and torch.isfinite(rm).all()
    assert rm.shape == (B2, N) and gm.shape == (halves,)
    assert float((rm - rm_p).abs().max()) <= K7_TOL * float(rm_p.abs().max())
    assert float(((gm - gm_p).abs() / gm_p.abs()).max()) <= K7_TOL


def test_k7_fast_reciprocal_is_ieee(cuda):
    """The pair sweeps' reciprocal fast path is IEEE 1 / x in every bit on
    every float of [0.05, 2^95], where their in-range tiles take it."""
    from nerfsos_torch.ops import flash_corr as fc

    assert fc.rcp_mismatches(cuda) == 0


@pytest.mark.parametrize("bad", [float("inf"), 1e35])
def test_k7_tiles_past_the_input_bound_match_plain(cuda, bad):
    """A point past 2^90, or infinite, sends its tiles to IEEE division
    (its fd is 0 or ~1e-35, not what the fast path would give): the means
    and the code gradients stay finite and match the plain versions to
    K7_TOL."""
    from nerfsos_torch.ops import flash_corr as fc

    f1, f2, c1a, c2a, c1b, c2b = _geo_inputs(cuda, 4, 1000, 2, 31)
    f1[1, 300, 0] = bad
    f2[3, 700, 2] = bad
    rm, gm = fc.geo_row_stats(f1, f2, 15.0)
    args = (0.5, 3.0, 15.0)
    out = fc.geo_quad_means(f1, f2, c1a, c2a, c1b, c2b, rm, gm, *args)
    want = fc.geo_quad_means_plain(f1, f2, c1a, c2a, c1b, c2b, rm, gm, *args)
    assert torch.isfinite(out).all()
    assert float((out - want).abs().max()) <= K7_TOL * float(want.abs().max())
    coeff = torch.tensor([0.3, -1.0, 2.0, 0.7], device=cuda) / (2 * 1000 * 1000)
    g = fc.geo_quad_grads(f1, f2, c1a, c2a, c1b, c2b, rm, gm, coeff, *args)
    g_p = fc.geo_quad_grads_plain(f1, f2, c1a, c2a, c1b, c2b, rm, gm, coeff, *args)
    for a, ref in zip(g, g_p):
        assert torch.isfinite(a).all()
        assert float((a - ref).abs().max()) <= K7_TOL * float(ref.abs().max())


def test_k7_through_autograd(cuda):
    """flash_geo_pair_quad: the forward's K7a and K7f, the backward's K7g,
    gradients on the codes only."""
    from nerfsos_torch.ops import flash_corr as fc

    rng = np.random.default_rng(12)
    t = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(cuda)  # noqa: E731
    pts, npts = t(4, 3, 16, 16), t(4, 3, 16, 16)
    codes = [torch.nn.functional.normalize(t(4, 2, 16, 16), dim=1).requires_grad_()
             for _ in range(4)]
    counts = (fc.geo_row_stats.launches, fc.geo_quad_means.launches, fc.geo_quad_grads.launches)
    out = fc.flash_geo_pair_quad(pts, npts, *codes, 3.0, 0.5, 15.0)
    sum(out).backward()
    torch.cuda.synchronize()
    assert (fc.geo_row_stats.launches, fc.geo_quad_means.launches,
            fc.geo_quad_grads.launches) == tuple(c + 1 for c in counts)
    assert all(c.grad is not None and torch.isfinite(c.grad).all() for c in codes)


def _single_inputs(device, B, N, S, seed):
    """Points and channel-normalised codes of one half (rows [B, N, C])."""
    rng = np.random.default_rng(seed)
    f1, f2 = rng.normal(size=(B, N, 3)) * 0.7, rng.normal(size=(B, N, 3)) * 0.7
    codes = []
    for _ in range(4):
        c = rng.normal(size=(B, N, S))
        codes.append(c / np.linalg.norm(c, axis=2, keepdims=True))
    return [torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)
            for a in (f1, f2, *codes)]


@pytest.mark.parametrize("heads", [1, 2])
@pytest.mark.parametrize("B,N,S", [(2, 256, 2), (3, 1000, 3), (8, 4096, 2), (1, 77, 8),
                                   (2, 4133, 2), (4, 129, 8)])  # past a pair tile's edges
@pytest.mark.parametrize("maxd", [15.0, 1.5])
def test_k7_single_and_pair_match_plain(cuda, heads, B, N, S, maxd):
    """One half with one head (K7b/K7c) or two (K7d/K7e): row stats, the
    means and the code gradients to K7_TOL, bitwise equal across calls."""
    from nerfsos_torch.ops import flash_corr as fc

    f1, f2, *codes = _single_inputs(cuda, B, N, S, B + N + heads)
    codes = codes[:2 * heads]
    means, grads = ((fc.geo_single_means, fc.geo_single_grads) if heads == 1
                    else (fc.geo_pair_means, fc.geo_pair_grads))
    means_p, grads_p = ((fc.geo_single_means_plain, fc.geo_single_grads_plain) if heads == 1
                        else (fc.geo_pair_means_plain, fc.geo_pair_grads_plain))
    rm, gm = fc.geo_row_stats(f1, f2, maxd, 1)
    rm_p, gm_p = fc.geo_row_stats_plain(f1, f2, maxd, 1)
    assert gm.shape == (1,)
    assert float((rm - rm_p).abs().max()) <= K7_TOL * float(rm_p.abs().max())
    assert float((gm - gm_p).abs().max()) <= K7_TOL * float(gm_p.abs().max())
    before = (means.launches, grads.launches)
    out = means(f1, f2, *codes, rm, gm, 0.5, maxd)
    out2 = means(f1, f2, *codes, rm, gm, 0.5, maxd)
    want = means_p(f1, f2, *codes, rm, gm, 0.5, maxd)
    assert out.shape == (heads,) and torch.equal(out, out2)
    assert float((out - want).abs().max()) <= K7_TOL * float(want.abs().max())
    coeff = torch.tensor([0.7, -1.2][:heads], device=cuda) / (B * N * N)
    g = grads(f1, f2, *codes, rm, gm, coeff, 0.5, maxd)
    g2 = grads(f1, f2, *codes, rm, gm, coeff, 0.5, maxd)
    g_p = grads_p(f1, f2, *codes, rm, gm, coeff, 0.5, maxd)
    torch.cuda.synchronize()
    assert (means.launches, grads.launches) == (before[0] + 2, before[1] + 2)
    assert len(g) == 2 * heads
    for a, b, ref in zip(g, g2, g_p):
        assert torch.equal(a, b) and torch.isfinite(a).all()
        assert float((a - ref).abs().max()) <= K7_TOL * float(ref.abs().max())


def test_k7_single_and_pair_through_autograd(cuda):
    """geo_helper_mean: K7a + K7b forward, K7c backward; geo_helper_mean_pair:
    K7a + K7d forward, K7e backward; gradients on the codes only."""
    from nerfsos_torch.ops import flash_corr as fc

    rng = np.random.default_rng(16)
    t = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32)).to(cuda)  # noqa: E731
    pts, npts = t(3, 3, 16, 16), t(3, 3, 16, 16)
    codes = [torch.nn.functional.normalize(t(3, 2, 16, 16), dim=1).requires_grad_()
             for _ in range(4)]
    names = ("geo_row_stats", "geo_single_means", "geo_single_grads", "geo_pair_means",
             "geo_pair_grads")
    counts = [getattr(fc, n).launches for n in names]
    single = fc.geo_helper_mean(pts, npts, codes[0], codes[1], 3.0, 15.0)
    pair = fc.geo_helper_mean_pair(pts, npts, *codes, 3.0, 15.0)
    (single + sum(pair)).backward()
    torch.cuda.synchronize()
    assert [getattr(fc, n).launches for n in names] == [c + d for c, d in
                                                        zip(counts, (2, 1, 1, 1, 1))]
    assert all(c.grad is not None and torch.isfinite(c.grad).all() for c in codes)


# ----------------------------------------------------------------- K9, K10a, K10b


MIP_SHAPES = [
    dict(net_depth=8, net_width=256, multires=10, multires_views=4),
    dict(net_depth=5, net_width=16, multires=4, multires_views=2),  # skip after the last layer
]


def _mip_field(device, seed, **kw):
    return _torch_law(MipNeRFField, seed, **kw).to(device).eval()


def _mip_inputs(device, n, s, seed):
    """odvr [n, 10] (origins, directions, unit viewdirs, the base radius of a
    504-pixel-wide view) and sorted fenceposts [n, s + 1] in [1, 6]."""
    rng = np.random.default_rng(seed)
    odvr = rng.normal(size=(n, 10)).astype(np.float32)
    odvr[:, 0:3] *= 2.0
    odvr[:, 6:9] = odvr[:, 3:6] / np.linalg.norm(odvr[:, 3:6], axis=1, keepdims=True)
    odvr[:, 9] = 2.0 / 504 * 2 / np.sqrt(12)
    z = np.sort(rng.uniform(1, 6, size=(n, s + 1)), 1).astype(np.float32)
    return torch.from_numpy(odvr).to(device), torch.from_numpy(z).to(device)


@pytest.mark.parametrize("shape", MIP_SHAPES)
@pytest.mark.parametrize("noise", [0.0, 1.0])
@pytest.mark.parametrize("n,s", [(1, 63), (37, 7), (1000, 63), (300, 190), (301, 190)])
def test_k9_k10a_match_plain(cuda, shape, noise, n, s):
    """K9 (no noise) and K10a (noise 1), K4's kernel in its mip mode: maps
    and weights to TOL, and two calls bitwise equal. 301 rays at S = 190
    leave a last chunk of one ray (190 intervals: a ragged second tile
    whose second warpgroup lies wholly past them)."""
    field = _mip_field(cuda, 20, **shape)
    odvr, z = _mip_inputs(cuda, n, s, 21)
    if noise == 0.0:
        wrapper, plain, kw = fr.fused_mip_render, fr.mip_render_plain, {}
    else:
        wrapper, plain = fr.mip_train_render, fr.mip_train_render_plain
        kw = dict(noise_std=noise, seed=97531)
    before = wrapper.launches
    with torch.no_grad():
        got = wrapper(field, odvr, z, **kw)
        again = wrapper(field, odvr, z, **kw)
        want = plain(field, odvr, z, **kw)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 2
    assert got[0].shape == (n, 5) and got[1].shape == (n, s)
    for a, b, c in zip(got, want, again):
        assert torch.isfinite(a).all()
        assert float((a - b).abs().max()) <= TOL
        assert torch.equal(a, c)


@pytest.mark.parametrize("shape", MIP_SHAPES)
@pytest.mark.parametrize("s,dweights", [(7, True), (63, True), (190, False)])
@pytest.mark.parametrize("n", [1, 37, 1024])
def test_k10b_matches_plain(cuda, shape, s, dweights, n):
    """The mip backward: every leaf to GRAD_TOL of its max plus the sigma +
    noise gates' allowance, on rays clear of every other gate; bitwise equal
    across two calls."""
    field = _mip_field(cuda, 22, **shape)
    odvr, z = _gate_clear_inputs(field, n, s, 23, pool=2048, mip=True)
    rng = np.random.default_rng(n + s)
    dmaps = torch.from_numpy(rng.normal(size=(n, 5)).astype(np.float32)).to(cuda)
    dw = (torch.from_numpy(rng.normal(size=(n, s)).astype(np.float32)).to(cuda) if dweights
          else None)
    kw = dict(noise_std=1.0, seed=86420)
    before = fr.mip_train_render_grads.launches
    got = fr.mip_train_render_grads(field, odvr, z, dmaps, dw, **kw)
    again = fr.mip_train_render_grads(field, odvr, z, dmaps, dw, **kw)
    want, slack, terms = plain_k10b_with_gates(field, odvr, z, dmaps, dw, kw)
    torch.cuda.synchronize()
    assert fr.mip_train_render_grads.launches == before + 2
    allow = flip_allowance(slack, terms)
    assert set(got) == set(want)
    for name, ref in want.items():
        assert torch.equal(got[name], again[name]), name
        assert got[name].shape == ref.shape and torch.isfinite(got[name]).all(), name
        scale = max(float(ref.abs().max()), 1e-12)
        err = float((got[name] - ref).abs().max())
        assert err <= GRAD_TOL * scale + allow[name], (name, err / scale)


def test_k10_noise_matches_the_hash(cuda):
    """With a field whose density is 0 everywhere the mip kernels' sigma is
    the noise alone, so K10a's weights follow the plain version's hash draws
    at point ray * S + interval, and K9's are 0."""
    field = _mip_field(cuda, 24, **MIP_SHAPES[1])
    with torch.no_grad():
        field.mlp.alpha_linear.weight.zero_()
        field.mlp.alpha_linear.bias.zero_()
    odvr, z = _mip_inputs(cuda, 50, 16, 25)
    kw = dict(noise_std=2.0, seed=2**31 - 300)
    with torch.no_grad():
        got = fr.mip_train_render(field, odvr, z, **kw)
        want = fr.mip_train_render_plain(field, odvr, z, **kw)
        assert float((got[1] - want[1]).abs().max()) <= TOL and got[1].any()
        assert not fr.fused_mip_render(field, odvr, z)[1].any()


def test_k10_through_autograd(cuda):
    """fused_mip_train_render: the K10a forward and the K10b backward, once
    each, a gradient on every leaf."""
    field = _mip_field(cuda, 26, **MIP_SHAPES[0])
    odvr, z = _mip_inputs(cuda, 300, 63, 27)
    counts = (fr.mip_train_render.launches, fr.mip_train_render_grads.launches)
    maps, w = fr.fused_mip_train_render(field, odvr, z, noise_std=1.0, seed=3)
    (maps * torch.arange(1.0, 6.0, device=cuda)).sum().backward()
    torch.cuda.synchronize()
    assert (fr.mip_train_render.launches, fr.mip_train_render_grads.launches) == (
        counts[0] + 1, counts[1] + 1)
    assert all(p.grad is not None and torch.isfinite(p.grad).all() for p in field.parameters())


def test_mip_kernels_reject_bad_inputs(cuda):
    field = _mip_field(cuda, 0, **MIP_SHAPES[1])
    odvr, z = _mip_inputs(cuda, 16, 8, 3)
    kw = dict(noise_std=0.0, seed=0)
    with pytest.raises(ValueError):
        fr.fused_mip_render(field, odvr[:, :9].contiguous(), z)
    with pytest.raises(ValueError):
        fr.fused_mip_render(field, odvr, z[:, :1].contiguous())
    with pytest.raises(ValueError):
        fr.mip_train_render(field, odvr, z[:8], **kw)
    with pytest.raises(NotImplementedError):
        fr.fused_mip_render(field, odvr.double(), z.double())
    with pytest.raises(ValueError):
        fr.mip_train_render_grads(field, odvr, z, torch.zeros(16, 7, device=cuda), None, **kw)
    with pytest.raises(ValueError):
        fr.mip_train_render_grads(field, odvr, z, torch.zeros(16, 5, device=cuda),
                                  torch.zeros(16, 9, device=cuda), **kw)


# ----------------------------------------------------------------- K8a-K8f, K11


def _field_points(device, n, seed, scale=2.0):
    """Points ``[n, 3]`` of norm ~``scale`` and unit directions."""
    rng = np.random.default_rng(seed)
    pts = (rng.normal(size=(n, 3)) * scale).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return torch.from_numpy(pts).to(device), torch.from_numpy(d).to(device)


# tile tails: one point, a tile less one, a tile and one, a few tiles
FIELD_NS = [1, 63, 65, 4097]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("sem,coord", [(True, True), (True, False), (False, False)])
@pytest.mark.parametrize("n", FIELD_NS)
def test_field_and_sigma_match_plain(cuda, shape, sem, coord, n):
    """The field forward (K8b/K8d) and the sigma forward (K8a/K8e), K4's
    tile in its point-list modes: raw and sigma to TOL, one launch each,
    and a second call bitwise equal."""
    field = _field(cuda, 30, use_semantics=sem, sem_with_coord=coord, sem_dim=2, **shape)
    pts, dirs = _field_points(cuda, n, 31)
    before = (ff.field_forward.launches, ff.fused_sigma_apply.launches)
    with torch.no_grad():
        raw = ff.field_forward(field, pts, dirs)
        sigma = ff.fused_sigma_apply(field, pts)
        raw_p, sigma_p = ff.field_plain(field, pts, dirs), ff.sigma_plain(field, pts)
    torch.cuda.synchronize()
    assert (ff.field_forward.launches, ff.fused_sigma_apply.launches) == (before[0] + 1,
                                                                          before[1] + 1)
    with torch.no_grad():
        assert torch.equal(raw, ff.field_forward(field, pts, dirs))
        assert torch.equal(sigma, ff.fused_sigma_apply(field, pts))
    assert raw.shape == raw_p.shape == (n, 4 + 2 * sem) and sigma.shape == (n,)
    assert torch.isfinite(raw).all() and torch.isfinite(sigma).all()
    assert float((raw - raw_p).abs().max()) <= TOL
    assert float((sigma - sigma_p).abs().max()) <= TOL


def test_field_at_the_export_grid(cuda):
    """The flagship field at 2^18 + 5 points of the x14 density grid (|x| up
    to 14, PE phases up to 7.2e3 rad) with zero directions: raw to TOL over
    max(1, its max |plain|) a column, sigma likewise (runs of 16 tiles a
    CTA, the last CTA's one tile of 5 points)."""
    field = _field(cuda, 32, use_semantics=True, sem_with_coord=True, sem_dim=2, **SHAPES[0])
    n = (1 << 18) + 5
    pts = (torch.rand(n, 3, generator=torch.Generator().manual_seed(0)) * 28 - 14).to(cuda)
    dirs = torch.zeros_like(pts)
    with torch.no_grad():
        raw, raw_p = ff.field_forward(field, pts, dirs), ff.field_plain(field, pts, dirs)
        sigma, sigma_p = ff.fused_sigma_apply(field, pts), ff.sigma_plain(field, pts)
    scale = raw_p.abs().amax(0).clamp(min=1.0)
    assert float(((raw - raw_p).abs() / scale).max()) <= TOL
    assert float((sigma - sigma_p).abs().max()) <= TOL * max(1.0, float(sigma_p.abs().max()))


@pytest.mark.parametrize("shape", MIP_SHAPES)
@pytest.mark.parametrize("zero_cov", [True, False])
@pytest.mark.parametrize("n", FIELD_NS)
def test_mip_field_matches_plain(cuda, shape, zero_cov, n):
    """K11: K4's tile in its Gaussian point-list mode (the integrated PE),
    raw to TOL, and a second call bitwise equal."""
    field = _mip_field(cuda, 33, **shape)
    mean, dirs = _field_points(cuda, n, 34)
    cov = (torch.zeros_like(mean) if zero_cov
           else torch.rand(n, 3, generator=torch.Generator().manual_seed(1)).to(cuda) * 0.01)
    before = ff.fused_mip_field_apply.launches
    with torch.no_grad():
        got = ff.fused_mip_field_apply(field, mean, cov, dirs)
        want = ff.mip_field_plain(field, mean, cov, dirs)
    torch.cuda.synchronize()
    assert ff.fused_mip_field_apply.launches == before + 1
    assert got.shape == (n, 4) and torch.isfinite(got).all()
    assert float((got - want).abs().max()) <= TOL
    with torch.no_grad():
        assert torch.equal(got, ff.fused_mip_field_apply(field, mean, cov, dirs))


# ----------------------------------------------------------------- the mip kernels at bf16


def _dense_mip_field(device, seed, **kw):
    """``_mip_field`` with its alpha bias raised by 1: the flagship field's
    default init gives a density of about 0 everywhere, so every ray's maps
    and weights would be 0 and bf16_columns' tail fault (a row given its
    predecessor's values) would move nothing."""
    field = _mip_field(device, seed, **kw)
    with torch.no_grad():
        field.mlp.alpha_linear.bias.add_(1.0)
    return field


@pytest.mark.parametrize("shape", MIP_SHAPES)
@pytest.mark.parametrize("noise", [0.0, 1.0])
@pytest.mark.parametrize("n,s", [(2, 63), (37, 7), (1000, 63), (300, 190), (301, 190)])
def test_k9_k10a_bf16_match_plain(cuda, shape, noise, n, s):
    """K9 (no noise) and K10a (noise 1) in their bf16 mode (K4's tile in its
    mip mode at bf16): maps and weights within bf16_columns' bounds of the
    bf16 plain version, two calls bitwise equal, counted in
    ``launches_bf16`` alone."""
    field = _dense_mip_field(cuda, 20, **shape)
    odvr, z = _mip_inputs(cuda, n, s, 21)
    if noise == 0.0:
        wrapper, plain, kw = fr.fused_mip_render, fr.mip_render_plain, {}
    else:
        wrapper, plain = fr.mip_train_render, fr.mip_train_render_plain
        kw = dict(noise_std=noise, seed=97531)
    before = (wrapper.launches, wrapper.launches_bf16)
    with torch.no_grad():
        got = wrapper(field, odvr, z, compute_dtype=BF16, **kw)
        again = wrapper(field, odvr, z, compute_dtype=BF16, **kw)
        want = plain(field, odvr, z, compute_dtype=BF16, **kw)
    torch.cuda.synchronize()
    assert (wrapper.launches, wrapper.launches_bf16) == (before[0], before[1] + 2)
    assert got[0].shape == (n, 5) and got[1].shape == (n, s)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    for i, part in enumerate(("maps", "weights")):
        bf16_columns(f"K9/K10a {part}", got[i], want[i])


def _k10b_bf16(field, odvr, z, dmaps, dw, kw):
    """K10b's bf16 mode on a call of one wave of chunks, its stored planes
    (the integrated PE among them) and reverse sweep held to the plain bf16
    mip forward and sweep (bf16_planes)."""
    got = fr.mip_train_render_grads(field, odvr, z, dmaps, dw, compute_dtype=BF16, **kw)
    flat, launch = fr._mip_grads_launch(field, odvr, z, dmaps, dw, kw["noise_std"], kw["seed"],
                                        True)
    assert all(torch.equal(v, fr.unpack_grads(field, flat)[k]) for k, v in got.items())
    bf16_planes(fr, "K10b", field, got, launch, odvr, z, False, mip=True)
    return got


@pytest.mark.parametrize("shape", MIP_SHAPES)
@pytest.mark.parametrize("n,s", [(37, 63), (256, 190), (37, 7)])
@pytest.mark.parametrize("dweights", [True, False])
def test_k10b_bf16_matches_plain(cuda, shape, n, s, dweights):
    """K10b's bf16 mode (K6's bf16 kernels in the mip cotangent mode), one
    wave of chunks: the stored planes within bf16_stored's bounds of the
    plain bf16 mip forward, the gradients within BF16_PLANES_TOL of the
    plain sweep on them, two calls bitwise equal, counted in
    ``launches_bf16`` alone."""
    field = _dense_mip_field(cuda, 22, **shape)
    odvr, z = _mip_inputs(cuda, n, s, 23)
    rng = np.random.default_rng(n + s)
    dmaps = torch.from_numpy(rng.normal(size=(n, 5)).astype(np.float32)).to(cuda)
    dw = (torch.from_numpy(rng.normal(size=(n, s)).astype(np.float32)).to(cuda) if dweights
          else None)
    kw = dict(noise_std=1.0, seed=13579)
    before = (fr.mip_train_render_grads.launches, fr.mip_train_render_grads.launches_bf16)
    got = _k10b_bf16(field, odvr, z, dmaps, dw, kw)
    again = fr.mip_train_render_grads(field, odvr, z, dmaps, dw, compute_dtype=BF16, **kw)
    torch.cuda.synchronize()
    assert (fr.mip_train_render_grads.launches,
            fr.mip_train_render_grads.launches_bf16) == (before[0], before[1] + 2)
    assert all(torch.equal(got[k], again[k]) and torch.isfinite(got[k]).all() for k in got)


def test_k10b_bf16_over_waves_matches_plain(cuda):
    """K10b's bf16 mode over several waves of grouped chunks (3000 rays x 63
    at the flagship width): every leaf within bf16_leaves' bound of the bf16
    plain version (BF16_WITNESS times its own last-bit sensitivity)."""
    field = _dense_mip_field(cuda, 24, **MIP_SHAPES[0])
    odvr, z = _mip_inputs(cuda, 3000, 63, 25)
    dmaps = torch.from_numpy(np.random.default_rng(26).normal(size=(3000, 5)).astype(np.float32))
    dmaps = dmaps.to(cuda)
    kw = dict(noise_std=1.0, seed=97)
    got = fr.mip_train_render_grads(field, odvr, z, dmaps, None, compute_dtype=BF16, **kw)

    def plain(f):
        return fr.mip_train_render_grads_plain(f, odvr, z, dmaps, None, compute_dtype=BF16, **kw)

    want = plain(field)
    bf16_leaves("K10b", got, want, bf16_witness(plain, field, want))


def test_mip_bf16_through_autograd(cuda):
    """fused_mip_train_render at bf16: K10a's and K10b's bf16 modes (their
    bf16 counters, not the fp32 ones), a gradient on every leaf, bitwise
    K10b's bf16 mode on the same cotangent."""
    field = _dense_mip_field(cuda, 26, **MIP_SHAPES[0])
    odvr, z = _mip_inputs(cuda, 300, 63, 27)
    fns = (fr.mip_train_render, fr.mip_train_render_grads)
    counts = [(f.launches, f.launches_bf16) for f in fns]
    maps, w = fr.fused_mip_train_render(field, odvr, z, noise_std=1.0, seed=3,
                                        compute_dtype=BF16)
    dmaps = torch.arange(1.0, 6.0, device=cuda).expand(300, 5).contiguous()
    (maps * dmaps).sum().backward()
    torch.cuda.synchronize()
    assert [(f.launches, f.launches_bf16) for f in fns] == [(c[0], c[1] + 1) for c in counts]
    want = fr.mip_train_render_grads(field, odvr, z, dmaps, None, noise_std=1.0, seed=3,
                                     compute_dtype=BF16)
    for name, p in field.named_parameters():
        assert torch.equal(p.grad, want[name]), name


@pytest.mark.parametrize("shape", MIP_SHAPES)
@pytest.mark.parametrize("zero_cov", [True, False])
@pytest.mark.parametrize("n", [127, 129, 4097])
def test_mip_field_bf16_matches_plain(cuda, shape, zero_cov, n):
    """K11 in its bf16 mode (K4's tile in its Gaussian point-list mode at
    bf16): raw within bf16_columns' bounds of the bf16 plain version, two
    calls bitwise equal, counted in ``launches_bf16`` alone. Ragged tiles
    and CTAs of at least 100 points: bf16_columns allows a hundredth of the
    rows a rounding flip (one of 65 points flipped at the flagship width)."""
    field = _mip_field(cuda, 33, **shape)
    mean, dirs = _field_points(cuda, n, 34)
    cov = (torch.zeros_like(mean) if zero_cov
           else torch.rand(n, 3, generator=torch.Generator().manual_seed(1)).to(cuda) * 0.01)
    f = ff.fused_mip_field_apply
    before = (f.launches, f.launches_bf16)
    with torch.no_grad():
        got = f(field, mean, cov, dirs, BF16)
        again = f(field, mean, cov, dirs, BF16)
        want = ff.mip_field_plain(field, mean, cov, dirs, BF16)
    torch.cuda.synchronize()
    assert (f.launches, f.launches_bf16) == (before[0], before[1] + 2)
    assert got.shape == (n, 4) and torch.equal(got, again)
    bf16_columns("K11", got, want)


def test_mip_bf16_rings_follow_a_weight_update(cuda):
    """The mip kernels' bf16 rings are packed anew after an in-place weight
    update: K9 and K11 follow their bf16 plain versions and K10b its plain
    sweep on its own planes before and after."""
    field = _dense_mip_field(cuda, 28, **MIP_SHAPES[0])
    odvr, z = _mip_inputs(cuda, 256, 63, 29)
    mean, dirs = _field_points(cuda, 500, 30)
    cov = mean.abs() * 0.001
    dmaps = torch.from_numpy(np.random.default_rng(3).normal(size=(256, 5)).astype(np.float32))
    dmaps = dmaps.to(cuda)

    def check():
        with torch.no_grad():
            got, want = (fr.fused_mip_render(field, odvr, z, BF16),
                         fr.mip_render_plain(field, odvr, z, BF16))
            bf16_columns("K9 maps", got[0], want[0])
            bf16_columns("K11", ff.fused_mip_field_apply(field, mean, cov, dirs, BF16),
                         ff.mip_field_plain(field, mean, cov, dirs, BF16))
        _k10b_bf16(field, odvr, z, dmaps, None, dict(noise_std=1.0, seed=5353))

    check()
    with torch.no_grad():
        field.mlp.rgb_linear.weight.mul_(-0.75)
        field.mlp.pts_linears[3].weight.mul_(0.9)
    check()


def _gate_clear_points(field, n, seed, sem, margin, pool=8192):
    """``_field_points`` for ``n`` points none of which has a trunk or views
    (with ``sem``, semantic-head) relu input within ``margin`` of 0 (of its
    layer's largest |input| over the pool), so the kernel and the plain
    version take every gate alike."""
    mlp = field.mlp
    gates = [*mlp.pts_linears, mlp.views_linears[0]] + ([mlp.semantic_linear[0]] if sem else [])
    device = next(field.parameters()).device
    keep = []
    for k in itertools.count():
        pts, dirs = _field_points(device, pool, seed + k)
        slack = torch.full((pool,), float("inf"), device=device)

        def hook(mod, inputs, out):
            pre = out.reshape(pool, -1).abs()
            torch.minimum(slack, pre.amin(1) / pre.max(), out=slack)

        handles = [m.register_forward_hook(hook) for m in gates]
        with torch.no_grad():
            ff.field_plain(field, pts, dirs)
        for h in handles:
            h.remove()
        clear = slack > margin
        keep.append((pts[clear], dirs[clear]))
        if sum(len(p) for p, _ in keep) >= n:
            return tuple(torch.cat(parts)[:n].contiguous() for parts in zip(*keep))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("sem,coord", [(True, True), (True, False), (False, False)])
@pytest.mark.parametrize("input_grads", [False, True])
@pytest.mark.parametrize("n", [1, 63, 65, 1000])
def test_field_grads_match_plain(cuda, shape, sem, coord, input_grads, n):
    """The field backward in both modes (K8f: weights only; K8c: with dpts
    and ddirs) on gate-clear points: every leaf and dpts/ddirs to GRAD_TOL
    of its max, on points whose gates clear 2 x GATE_MARGIN (INPUT_GRAD_MARGIN
    with the input gradients, which a flipped gate moves by their whole
    size); two calls bitwise equal."""
    field = _field(cuda, 35, use_semantics=sem, sem_with_coord=coord, sem_dim=2, **shape)
    pts, dirs = _gate_clear_points(field, n, 36, sem,
                                   INPUT_GRAD_MARGIN if input_grads else 2 * GATE_MARGIN)
    g = torch.from_numpy(np.random.default_rng(n).normal(size=(n, 4 + 2 * sem))
                         .astype(np.float32)).to(cuda)
    before = (ff.field_grads.launches, ff.field_grads.input_grad_launches)
    got = ff.field_grads(field, pts, dirs, g, input_grads=input_grads)
    again = ff.field_grads(field, pts, dirs, g, input_grads=input_grads)
    want = ff.field_grads_plain(field, pts, dirs, g, input_grads=input_grads)
    torch.cuda.synchronize()
    assert (ff.field_grads.launches, ff.field_grads.input_grad_launches) == (
        before[0] + 2, before[1] + 2 * input_grads)
    leaves = {**got[0], "dpts": got[1], "ddirs": got[2]}
    leaves_again = {**again[0], "dpts": again[1], "ddirs": again[2]}
    refs = {**want[0], "dpts": want[1], "ddirs": want[2]}
    for name, ref in refs.items():
        if ref is None:
            assert leaves[name] is None, name
            continue
        assert torch.equal(leaves[name], leaves_again[name]), name
        assert leaves[name].shape == ref.shape and torch.isfinite(leaves[name]).all(), name
        scale = max(float(ref.abs().max()), 1e-12)
        err = float((leaves[name] - ref).abs().max())
        assert err <= GRAD_TOL * scale, (name, err / scale)


def test_field_through_autograd(cuda):
    """fused_field_apply: the field forward, and as its backward the field
    backward, in its input-gradient mode only when pts or dirs needs a
    gradient; every leaf gets one."""
    field = _field(cuda, 37, use_semantics=True, sem_with_coord=True, sem_dim=2, **SHAPES[0])
    pts, dirs = _field_points(cuda, 300, 38)
    for want_inputs in (False, True):
        p, d = pts.clone().requires_grad_(want_inputs), dirs.clone().requires_grad_(want_inputs)
        before = (ff.field_forward.launches, ff.field_grads.launches,
                  ff.field_grads.input_grad_launches)
        field.zero_grad(set_to_none=True)
        (ff.fused_field_apply(field, p, d) ** 2).sum().backward()
        torch.cuda.synchronize()
        assert (ff.field_forward.launches, ff.field_grads.launches,
                ff.field_grads.input_grad_launches) == (before[0] + 1, before[1] + 1,
                                                         before[2] + want_inputs)
        assert all(q.grad is not None and torch.isfinite(q.grad).all()
                   for q in field.parameters())
        assert (p.grad is not None) == want_inputs and (d.grad is not None) == want_inputs


def test_field_kernels_reject_bad_inputs(cuda):
    field = _field(cuda, 0, use_semantics=True, sem_dim=2, **SHAPES[1])
    pts, dirs = _field_points(cuda, 16, 3)
    with pytest.raises(ValueError):
        ff.field_forward(field, pts, dirs[:8])
    with pytest.raises(ValueError):
        ff.fused_sigma_apply(field, pts.t().contiguous().t())  # not contiguous
    with pytest.raises(NotImplementedError):
        ff.field_forward(field, pts.double(), dirs.double())
    with pytest.raises(NotImplementedError):
        ff.field_forward(field.cpu(), pts, dirs)
    with pytest.raises(ValueError):
        ff.field_grads(field.to(cuda), pts, dirs, torch.zeros(16, 5, device=cuda),
                       input_grads=False)
    with pytest.raises(NotImplementedError):
        ff.fused_mip_field_apply(field, pts, torch.zeros_like(pts), dirs)  # a semantic head


def test_field_kernels_empty_batch(cuda):
    field = _field(cuda, 0, use_semantics=True, sem_dim=2, **SHAPES[1])
    pts = torch.zeros(0, 3, device=cuda)
    assert ff.field_forward(field, pts, pts).shape == (0, 6)
    assert ff.fused_sigma_apply(field, pts).shape == (0,)
    grads, dp, dd = ff.field_grads(field, pts, pts, torch.zeros(0, 6, device=cuda),
                                   input_grads=True)
    assert dp.shape == dd.shape == (0, 3) and all(float(v.abs().max()) == 0 for v in grads.values())


@pytest.mark.parametrize("kernel", ["k3", "k6", "k10b", "k8f"])
def test_reverse_ring_follows_a_weight_update(cuda, kernel):
    """The reverse sweep's input-gradient products read their matrices from
    the backward ring (``pack_bwd_ring``, gathered once per weight state):
    at the flagship width on gate-clear inputs, the gradients match the
    plain version's (GRAD_TOL of each leaf's max plus the sigma gates'
    allowance) and are bitwise equal across two calls; after an in-place
    update of rgb's weight (it moves no relu gate, so the inputs stay
    gate-clear) the cached ring is gathered anew, equals a fresh
    ``pack_bwd_ring``, and the gradients follow the plain version's again."""
    mip = kernel == "k10b"
    if mip:
        field = _mip_field(cuda, 50, **SHAPES[0])
    else:
        field = _field(cuda, 50, use_semantics=kernel != "k3", sem_with_coord=True, sem_dim=2,
                       **SHAPES[0])
    n, s = (300, 190) if mip else (300, 64)
    rng = np.random.default_rng(51)
    if kernel == "k8f":
        pts, dirs = _gate_clear_points(field, 4096, 52, True, 2 * GATE_MARGIN)
        g = torch.from_numpy(rng.normal(size=(4096, 6)).astype(np.float32)).to(cuda)

        def run():
            return ff.field_grads(field, pts, dirs, g, input_grads=False)[0]

        def plain():
            return ff.field_grads_plain(field, pts, dirs, g, input_grads=False)[0], None
    else:
        odv, z = _gate_clear_inputs(field, n, s, 52, pool=2048, sem=kernel == "k6", mip=mip)[:2]
        dmaps = torch.from_numpy(rng.normal(size=(n, 5 if mip else 7)).astype(np.float32))
        dmaps, dw = dmaps.to(cuda), torch.from_numpy(rng.normal(size=(n, s)).astype(
            np.float32)).to(cuda)
        gt = torch.from_numpy(rng.uniform(0, 1, (n, 3)).astype(np.float32)).to(cuda)
        kw = dict(noise_std=1.0, seed=5353)
        if kernel == "k3":
            kw3 = dict(kw, white_bkgd=False)

            def run():
                return fr.fused_rgb_train_grads(field, odv, z, gt, **kw3)[0]

            def plain():
                want, slack, terms = plain_k3_with_gates(field, odv, z, gt, kw3)
                return want[0], flip_allowance(slack, terms)
        else:
            wrapper = fr.mip_train_render_grads if mip else fr.train_render_grads
            with_gates = plain_k10b_with_gates if mip else plain_k6_with_gates

            def run():
                return wrapper(field, odv, z, dmaps, dw, **kw)

            def plain():
                want, slack, terms = with_gates(field, odv, z, dmaps, dw, kw)
                return want, flip_allowance(slack, terms)

    def check():
        got, again = run(), run()
        want, allow = plain()
        torch.cuda.synchronize()
        assert set(got) == set(want)
        for name, ref in want.items():
            assert torch.equal(got[name], again[name]), name
            assert got[name].shape == ref.shape and torch.isfinite(got[name]).all(), name
            scale = max(float(ref.abs().max()), 1e-12)
            err = float((got[name] - ref).abs().max())
            assert err <= GRAD_TOL * scale + (allow[name] if allow else 0.0), (name, err / scale)

    check()
    before = fr._bwd_ring(field, cuda)[0].clone()
    with torch.no_grad():
        field.mlp.rgb_linear.weight.mul_(-0.75)
    check()
    ring = fr._bwd_ring(field, cuda)[0]
    assert not torch.equal(ring, before)
    assert torch.equal(ring, fr.pack_bwd_ring(field)[0])


# ----------------------------------------------------------------- the bf16 modes

BF16 = torch.bfloat16


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("n,s", [(1000, 64), (37, 8), (3, 130)])
def test_k1_bf16_matches_plain(cuda, shape, n, s):
    field = _field(cuda, 0, **shape)
    odv, z = _inputs(cuda, n, s, 1)
    od = odv[:, :6].contiguous()
    before = (fr.fused_coarse_weights.launches, fr.fused_coarse_weights.launches_bf16)
    with torch.no_grad():
        got = fr.fused_coarse_weights(field, od, z, BF16)
        again = fr.fused_coarse_weights(field, od, z, BF16)
        want = fr.coarse_weights_plain(field, od, z, BF16)
    torch.cuda.synchronize()
    assert (fr.fused_coarse_weights.launches,
            fr.fused_coarse_weights.launches_bf16) == (before[0], before[1] + 2)
    assert torch.equal(got, again)
    bf16_columns("K1", got, want)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("sem,coord", [(True, True), (False, False)])
@pytest.mark.parametrize("n,s", [(1000, 192), (37, 16)])
def test_k2_bf16_matches_plain(cuda, shape, sem, coord, n, s):
    field = _field(cuda, 1, use_semantics=sem, sem_with_coord=coord, sem_dim=2, **shape)
    odv, z = _inputs(cuda, n, s, 2)
    with torch.no_grad():
        got = fr.fused_render(field, odv, z, BF16)
        again = fr.fused_render(field, odv, z, BF16)
        want = fr.render_plain(field, odv, z, BF16)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    for i, part in enumerate(("maps", "weights")):
        bf16_columns(f"K2 {part}", got[i], want[i])


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("coord,noise", [(True, 1.0), (False, 0.0)])
@pytest.mark.parametrize("n,s", [(41, 37), (300, 64), (77, 192)])
def test_k4_bf16_matches_plain(cuda, shape, coord, noise, n, s):
    """K4's bf16 mode on ragged tiles: maps and weights within bf16_columns'
    bounds, sem_in (bf16) within bf16_stored's, two calls bitwise equal."""
    field = _field(cuda, 5, use_semantics=True, sem_with_coord=coord, sem_dim=2, **shape)
    odv, z = _inputs(cuda, n, s, 8)
    kw = dict(noise_std=noise, seed=24680, save_semin=True)
    with torch.no_grad():
        got = fr.train_render(field, odv, z, compute_dtype=BF16, **kw)
        again = fr.train_render(field, odv, z, compute_dtype=BF16, **kw)
        want = fr.train_render_plain(field, odv, z, compute_dtype=BF16, **kw)
    torch.cuda.synchronize()
    assert got[2].dtype == BF16 and all(torch.equal(a, b) for a, b in zip(got, again))
    for i, part in enumerate(("maps", "weights")):
        bf16_columns(f"K4 {part}", got[i], want[i])
    bf16_stored("K4 sem_in", got[2], want[2])


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("coord", [True, False])
@pytest.mark.parametrize("n,s", [(37, 192), (4096, 64)])
def test_k5_bf16_matches_plain(cuda, shape, coord, n, s):
    """K5's bf16 mode on K4's bf16 sem_in (points near a semantic-head gate
    given weight 0): each leaf within k5_bf16_over's bound of the bf16 plain
    version (against the fp32 one on the same sem_in), two calls bitwise
    equal."""
    field = _field(cuda, 6, use_semantics=True, sem_with_coord=coord, sem_dim=2, **shape)
    odv, z = _inputs(cuda, n, s, 9)
    with torch.no_grad():
        _, w, sem_in = fr.train_render(field, odv, z, noise_std=1.0, seed=7, save_semin=True,
                                       compute_dtype=BF16)
    w = _gate_clear_weights(field, sem_in.float(), w)
    dmaps = torch.from_numpy(np.random.default_rng(10).normal(size=(n, 7)).astype(np.float32))
    dmaps = dmaps.to(cuda)
    before = fr.frozen_sem_grads.launches_bf16
    got = fr.frozen_sem_grads(field, sem_in, w, dmaps, BF16)
    again = fr.frozen_sem_grads(field, sem_in, w, dmaps, BF16)
    want = fr.frozen_sem_grads_plain(field, sem_in, w, dmaps, BF16)
    want32 = fr.frozen_sem_grads_plain(field, sem_in.float(), w, dmaps)
    torch.cuda.synchronize()
    assert fr.frozen_sem_grads.launches_bf16 == before + 2
    for name, ref in want.items():
        assert torch.equal(got[name], again[name]), name
        assert torch.isfinite(got[name]).all(), name
    assert k5_bf16_over(got, want, want32, {k: 0.0 for k in want})[0] <= 1.0


def test_k4_k5_bf16_through_autograd(cuda):
    """fused_train_render at bf16 with ``frozen``: K4's and K5's bf16 modes
    (their bf16 counters, not the fp32 ones), semantic-head leaves only; K5
    refuses an fp32 sem_in at bf16."""
    field = _field(cuda, 7, use_semantics=True, sem_with_coord=True, sem_dim=2, **SHAPES[0])
    odv, z = _inputs(cuda, 300, 64, 11)
    counts = [(f.launches, f.launches_bf16) for f in (fr.train_render, fr.frozen_sem_grads)]
    maps, w = fr.fused_train_render(field, odv, z, noise_std=1.0, seed=3, frozen=True,
                                    compute_dtype=BF16)
    (maps[:, 5:] * torch.arange(1.0, 3.0, device=cuda)).sum().backward()
    torch.cuda.synchronize()
    assert [(f.launches, f.launches_bf16) for f in (fr.train_render, fr.frozen_sem_grads)] == [
        (c[0], c[1] + 1) for c in counts]
    for name, p in field.named_parameters():
        assert (p.grad is not None) == (name in fr._SEM_NAMES), name
    _, w, sem_in = fr.train_render(field, odv, z, noise_std=0.0, seed=0, save_semin=True)
    with pytest.raises(ValueError):
        fr.frozen_sem_grads(field, sem_in, w, torch.zeros(300, 7, device=cuda), BF16)


def _ring_bytes(field, bf16):
    """The forward ring's and the backward ring's buffers of ``field``."""
    device = next(field.parameters()).device
    return fr._ring(field, device, bf16)[0], fr._bwd_ring(field, device, bf16)[0]


def _k3_bf16(field, odv, z, gt, kw, stored_share=None):
    """K3's bf16 mode on a call of one wave of chunks: its grads, maps and
    weights, its bf16 plain version's, and its stored planes and reverse
    sweep held to the plain forward and sweep (bf16_planes)."""
    got = fr.fused_rgb_train_grads(field, odv, z, gt, compute_dtype=BF16, **kw)
    flat, *_, launch = fr._train_grads_launch(field, odv, z, gt, None, bf16=True, **kw)
    assert all(torch.equal(v, fr.unpack_grads(field, flat)[k]) for k, v in got[0].items())
    bf16_planes(fr, "K3", field, got[0], launch, odv, z, False, stored_share=stored_share)
    return got, fr.rgb_train_grads_plain(field, odv, z, gt, compute_dtype=BF16, **kw)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("s,sem,white", [(64, True, False), (192, True, False), (16, False, True)])
@pytest.mark.parametrize("n", [37, 256])
def test_k3_bf16_matches_plain(cuda, shape, s, sem, white, n):
    """K3's bf16 mode (the storing forward and the reverse sweep on wgmma
    bf16), one wave of chunks: maps and weights within bf16_columns' bounds
    of the bf16 plain version, the stored planes within bf16_stored's of
    the plain forward, the gradients within BF16_PLANES_TOL of the plain
    sweep on those planes (bf16_planes; the semantic head's exactly 0), two
    calls bitwise equal, counted in ``launches_bf16`` alone."""
    field = _field(cuda, 2, use_semantics=sem, sem_with_coord=sem, sem_dim=2, **shape)
    odv, z, gt = _k3_inputs(cuda, n, s, 5)
    kw = dict(white_bkgd=white, noise_std=1.0, seed=987654)
    before = (fr.fused_rgb_train_grads.launches, fr.fused_rgb_train_grads.launches_bf16)
    got, want = _k3_bf16(field, odv, z, gt, kw)
    again = fr.fused_rgb_train_grads(field, odv, z, gt, compute_dtype=BF16, **kw)
    torch.cuda.synchronize()
    assert (fr.fused_rgb_train_grads.launches,
            fr.fused_rgb_train_grads.launches_bf16) == (before[0], before[1] + 2)
    assert all(torch.equal(got[0][k], again[0][k]) for k in got[0])
    assert torch.equal(got[1], again[1]) and torch.equal(got[2], again[2])
    bf16_columns("K3 maps", got[1], want[1])
    bf16_columns("K3 weights", got[2], want[2])
    for name, g in got[0].items():
        if "semantic_linear" in name:
            assert not g.any(), name


def _k6_bf16(field, odv, z, dmaps, dw, kw, stored_share=None):
    """K6's bf16 mode on a call of one wave of chunks, its stored planes and
    reverse sweep held to the plain forward and sweep (bf16_planes)."""
    got = fr.train_render_grads(field, odv, z, dmaps, dw, compute_dtype=BF16, **kw)
    flat, *_, launch = fr._train_grads_launch(field, odv, z, dmaps, dw, bf16=True,
                                              white_bkgd=None, **kw)
    sem = field.mlp.use_semantics
    assert all(torch.equal(v, fr.unpack_grads(field, flat, sem)[k]) for k, v in got.items())
    bf16_planes(fr, "K6", field, got, launch, odv, z, sem, stored_share=stored_share)
    return got


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("s,coord,dweights", [(64, True, True), (192, True, False),
                                              (16, False, True)])
@pytest.mark.parametrize("n", [37, 256])
def test_k6_bf16_matches_plain(cuda, shape, s, coord, dweights, n):
    """K6's bf16 mode with the semantic head, one wave of chunks: the stored
    planes within bf16_stored's bounds of the plain forward, the gradients
    within BF16_PLANES_TOL of the plain sweep on them, two calls bitwise
    equal, counted in ``launches_bf16`` alone."""
    field = _field(cuda, 8, use_semantics=True, sem_with_coord=coord, sem_dim=2, **shape)
    odv, z = _inputs(cuda, n, s, 13)
    rng = np.random.default_rng(n + s)
    dmaps = torch.from_numpy(rng.normal(size=(n, 7)).astype(np.float32)).to(cuda)
    dw = (torch.from_numpy(rng.normal(size=(n, s)).astype(np.float32)).to(cuda) if dweights
          else None)
    kw = dict(noise_std=1.0, seed=13579)
    before = (fr.train_render_grads.launches, fr.train_render_grads.launches_bf16)
    got = _k6_bf16(field, odv, z, dmaps, dw, kw)
    again = fr.train_render_grads(field, odv, z, dmaps, dw, compute_dtype=BF16, **kw)
    torch.cuda.synchronize()
    assert (fr.train_render_grads.launches,
            fr.train_render_grads.launches_bf16) == (before[0], before[1] + 2)
    assert all(torch.equal(got[k], again[k]) for k in got)


def test_k6_bf16_without_semantics(cuda):
    """A field without the semantic head: K6's bf16 sweep of its layers alone."""
    field = _field(cuda, 9, **SHAPES[0])
    odv, z = _inputs(cuda, 500, 64, 14)
    dmaps = torch.from_numpy(np.random.default_rng(1).normal(size=(500, 5)).astype(np.float32))
    _k6_bf16(field, odv, z, dmaps.to(cuda), None, dict(noise_std=0.0, seed=0))


@pytest.mark.parametrize("kernel", ["k3", "k6"])
def test_k3_k6_bf16_over_waves_match_plain(cuda, kernel):
    """K3's and K6's bf16 modes over several waves of grouped chunks (3000
    rays x 64 at the flagship width): every leaf within bf16_leaves' bound
    of the bf16 plain version (BF16_WITNESS times its own last-bit
    sensitivity, bf16_witness), K3's maps and weights within bf16_columns'."""
    field = _field(cuda, 11, use_semantics=True, sem_with_coord=True, sem_dim=2, **SHAPES[0])
    odv, z, gt = _k3_inputs(cuda, 3000, 64, 16)
    if kernel == "k3":
        kw = dict(white_bkgd=False, noise_std=1.0, seed=97)
        got = fr.fused_rgb_train_grads(field, odv, z, gt, compute_dtype=BF16, **kw)

        def plain(f):
            return fr.rgb_train_grads_plain(f, odv, z, gt, compute_dtype=BF16, **kw)

        want = plain(field)
        bf16_columns("K3 maps", got[1], want[1])
        bf16_columns("K3 weights", got[2], want[2])
        bf16_leaves("K3", got[0], want[0], bf16_witness(lambda f: plain(f)[0], field, want[0]))
    else:
        rng = np.random.default_rng(17)
        dmaps = torch.from_numpy(rng.normal(size=(3000, 7)).astype(np.float32)).to(cuda)
        kw = dict(noise_std=1.0, seed=97)
        got = fr.train_render_grads(field, odv, z, dmaps, None, compute_dtype=BF16, **kw)

        def plain(f):
            return fr.train_render_grads_plain(f, odv, z, dmaps, None, compute_dtype=BF16, **kw)

        want = plain(field)
        bf16_leaves("K6", got, want, bf16_witness(plain, field, want))


# K3's and K6's bf16 leaves on a net of the JAX law (flax's Dense: zero
# biases, the port's default and what every seeded run draws). There
# bf16_witness's bias nudges move nothing, so the leaves are held to the
# plain version's own moves when every sample depth steps one float32 ulp
# (chip_smoke.z_ulp_draws, ULP_DRAWS draws): the worst leaf within
# ULP_SPREAD times the largest move (or GRAD_TOL of its max), the fp32
# kernel in the bf16 kernel's place beyond it (tests/bf16_ulp_spread.py
# reads the same on two steps of real runs). The stored planes' share of
# differing entries may reach, per plane, what one such step moves in the
# plain forward's planes, where that is above BF16_STORED_SHARE: on these
# nets the kernel's feat plane differed from the plain forward's in 1.28%
# of its entries (H100), and one ulp step of z moves ~10% of a trunk plane.
ULP_DRAWS, ULP_SPREAD = 16, 2.0


def _jax_law_field(device, seed, **kw):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return NeRFField(**kw).to(device).eval()


@pytest.mark.parametrize("kernel", ["k3", "k6"])
def test_k3_k6_bf16_on_the_jax_law(cuda, kernel):
    """K3's and K6's bf16 modes on a flagship-width net of the JAX law, one
    wave of 1024 rays x 64: the leaves within ULP_SPREAD of the plain
    version's largest move under one-ulp steps of z, the fp32 kernel's
    beyond that bound; the stored planes and the sweep on them as in
    test_k3_bf16_matches_plain (bf16_planes), each plane's share of
    differing entries within what one ulp step of z moves in the plain
    forward's, if that is larger."""
    from chip_smoke import BF16_STORED_SHARE, ulp_step, z_ulp_draws

    field = _jax_law_field(cuda, 21, use_semantics=True, sem_with_coord=True, sem_dim=2,
                           **SHAPES[0])
    assert not any(lin.bias.any() for lin in field.modules() if isinstance(lin, torch.nn.Linear))
    odv, z, gt = _k3_inputs(cuda, 1024, 64, 22)
    with torch.no_grad():
        f0 = fr.bf16_train_forward(field, odv, z)
        f1 = fr.bf16_train_forward(field, odv, ulp_step(z, torch.Generator(cuda).manual_seed(3)))
    names = {"emb": "e", "view PE": "dv", "feat": "feat", "hv": "hv", "s_act": "s_act"}
    pairs = {**{k: (f0[v], f1[v]) for k, v in names.items()},
             **{f"act{i}": ab for i, ab in enumerate(zip(f0["acts"], f1["acts"]))}}
    share = {k: max(BF16_STORED_SHARE, float((a != b).float().mean())) for k, (a, b) in
             pairs.items()}
    if kernel == "k3":
        kw = dict(white_bkgd=True, noise_std=1.0, seed=23)
        got = _k3_bf16(field, odv, z, gt, kw, share)[0][0]
        control = fr.fused_rgb_train_grads(field, odv, z, gt, **kw)[0]

        def plain(zz):
            return fr.rgb_train_grads_plain(field, odv, zz, gt, compute_dtype=BF16, **kw)[0]
    else:
        rng = np.random.default_rng(24)
        dmaps = torch.from_numpy(rng.normal(size=(1024, 7)).astype(np.float32)).to(cuda)
        dw = torch.from_numpy(rng.normal(size=(1024, 64)).astype(np.float32)).to(cuda)
        kw = dict(noise_std=1.0, seed=25)
        got = _k6_bf16(field, odv, z, dmaps, dw, kw, share)
        control = fr.train_render_grads(field, odv, z, dmaps, dw, **kw)

        def plain(zz):
            return fr.train_render_grads_plain(field, odv, zz, dmaps, dw, compute_dtype=BF16,
                                               **kw)
    want = plain(z)
    moves = {k: 0.0 for k in want}
    for g in z_ulp_draws(plain, z, ULP_DRAWS):
        moves = {k: max(m, (g[k] - want[k]).abs().max().item()) for k, m in moves.items()}

    def over(g):
        return max((g[k] - ref).abs().max().item()
                   / max(ULP_SPREAD * moves[k], GRAD_TOL * ref.abs().max().item(), 1e-30)
                   for k, ref in want.items())

    assert over(got) <= 1.0 < over(control), (over(got), over(control))


def test_k4_k6_bf16_through_autograd(cuda):
    """fused_train_render at bf16 without ``frozen``: K4's and K6's bf16
    modes (their bf16 counters, not the fp32 ones), a gradient on every
    leaf, bitwise K6's bf16 mode on the same cotangent; K5 does not run."""
    field = _field(cuda, 10, use_semantics=True, sem_with_coord=True, sem_dim=2, **SHAPES[0])
    odv, z = _inputs(cuda, 300, 64, 15)
    fns = (fr.train_render, fr.train_render_grads, fr.frozen_sem_grads)
    counts = [(f.launches, f.launches_bf16) for f in fns]
    maps, w = fr.fused_train_render(field, odv, z, noise_std=1.0, seed=3, frozen=False,
                                    compute_dtype=BF16)
    dmaps = torch.arange(1.0, 8.0, device=cuda).expand(300, 7).contiguous()
    (maps * dmaps).sum().backward()
    torch.cuda.synchronize()
    assert [(f.launches, f.launches_bf16) for f in fns] == [
        (counts[0][0], counts[0][1] + 1), (counts[1][0], counts[1][1] + 1), counts[2]]
    want = fr.train_render_grads(field, odv, z, dmaps, None, noise_std=1.0, seed=3,
                                 compute_dtype=BF16)
    for name, p in field.named_parameters():
        assert torch.equal(p.grad, want[name]), name


@pytest.mark.parametrize("kernel", ["k3", "k6"])
def test_bf16_rings_follow_a_weight_update(cuda, kernel):
    """K3's and K6's bf16 rings (``pack_ring``'s and ``pack_bwd_ring``'s bf16
    layouts, cached apart from the fp32 ones) are packed anew after an
    in-place weight update, equal fresh packings, and the kernel follows
    the plain forward and sweep on its own planes (bf16_planes)."""
    field = _field(cuda, 50, use_semantics=kernel == "k6", sem_with_coord=True, sem_dim=2,
                   **SHAPES[0])
    odv, z, gt = _k3_inputs(cuda, 300, 64, 52)
    dmaps = torch.from_numpy(np.random.default_rng(3).normal(size=(300, 7)).astype(np.float32))
    dmaps = dmaps.to(cuda)

    def check():
        if kernel == "k3":
            _k3_bf16(field, odv, z, gt, dict(white_bkgd=False, noise_std=1.0, seed=5353))
        else:
            _k6_bf16(field, odv, z, dmaps, None, dict(noise_std=1.0, seed=5353))

    check()
    before = [t.clone() for t in _ring_bytes(field, True)]
    with torch.no_grad():
        field.mlp.rgb_linear.weight.mul_(-0.75)
        field.mlp.pts_linears[3].weight.mul_(0.9)
    check()
    after = _ring_bytes(field, True)
    assert not any(torch.equal(a, b) for a, b in zip(after, before))
    assert torch.equal(after[0], fr.pack_ring(field, True)[0])
    assert torch.equal(after[1], fr.pack_bwd_ring(field, True)[0])


# ----------------------------------------------------------------- the classic field kernels at bf16


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("sem,coord", [(True, True), (True, False), (False, False)])
@pytest.mark.parametrize("n", [127, 129, 4097])
@pytest.mark.parametrize("scale", [2.0, 8.0])
def test_field_forwards_bf16_match_plain(cuda, shape, sem, coord, n, scale):
    """The sigma forward (K8a/K8e) and the field forward under K8b's head
    rule (f32_heads) and K8d's in their bf16 modes (K4's tile in its
    point-list modes at bf16): each within bf16_points' bounds of its bf16
    plain version (the fp32 kernel's output its control), two calls bitwise
    equal, counted in ``launches_bf16`` alone, K8b's rule in
    ``launches_bf16_f32_heads``; sigma is the same in the three (one trunk,
    one alpha head). At norm ~2 the flagship default init's outputs differ
    from point to point by less than TOL, so the tail fault is not required
    to be refused there (bf16_points not ``varied``); at norm ~8 (the
    export grid's reach) it is."""
    field = _field(cuda, 60, use_semantics=sem, sem_with_coord=coord, sem_dim=2, **shape)
    pts, dirs = _field_points(cuda, n, 61, scale=scale)
    varied = scale > 2.0
    fns = (ff.fused_sigma_apply, ff.field_forward)
    before = [(f.launches, f.launches_bf16) for f in fns]
    heads_before = ff.field_forward.launches_bf16_f32_heads
    with torch.no_grad():
        sig, sig2 = (ff.fused_sigma_apply(field, pts, BF16) for _ in range(2))
        raw = {h: [ff.field_forward(field, pts, dirs, BF16, h) for _ in range(2)]
               for h in (True, False)}
        torch.cuda.synchronize()
        counts = [(f.launches, f.launches_bf16) for f in fns]
        heads_count = ff.field_forward.launches_bf16_f32_heads
        bf16_points("K8a", sig, ff.sigma_plain(field, pts, BF16), ff.fused_sigma_apply(field, pts),
                    varied=varied)
        for h, (got, again) in raw.items():
            assert got.shape == (n, 4 + 2 * sem) and torch.equal(got, again)
            bf16_points(f"K8b/K8d f32_heads={h}", got,
                        ff.field_plain(field, pts, dirs, BF16, f32_heads=h),
                        ff.field_forward(field, pts, dirs), varied=varied)
    assert counts == [(before[0][0], before[0][1] + 2), (before[1][0], before[1][1] + 2)]
    assert heads_count == heads_before + 2
    assert torch.equal(sig, sig2) and torch.equal(raw[True][0][:, 3], sig)
    assert torch.equal(raw[False][0][:, 3], sig)


def _field_grads_bf16(field, pts, dirs, g, input_grads):
    """The field backward's bf16 mode on a call of one wave of chunks: the
    wrapper's grads (and dpts, ddirs), equal to those of
    ``_field_grads_launch`` at bf16, whose stored planes and reverse sweep
    (with K8c its input gradients) are held to the plain forward and sweep
    (bf16_planes)."""
    got = ff.field_grads(field, pts, dirs, g, input_grads=input_grads, compute_dtype=BF16)
    flat, dp, dd, launch = ff._field_grads_launch(field, pts, dirs, g, input_grads, True)
    sem = field.mlp.use_semantics
    assert all(torch.equal(v, fr.unpack_grads(field, flat, sem)[k]) for k, v in got[0].items())
    if input_grads:
        assert torch.equal(got[1], dp) and torch.equal(got[2], dd)
    bf16_planes(fr, "K8c" if input_grads else "K8f", field, got[0], launch, None, None, sem,
                points=(pts, dirs), inputs=(dp, dd) if input_grads else None)
    return got


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("sem,coord", [(True, True), (True, False), (False, False)])
@pytest.mark.parametrize("input_grads", [False, True])
@pytest.mark.parametrize("n", [37, 1000])
def test_field_grads_bf16_match_plain(cuda, shape, sem, coord, input_grads, n):
    """The field backward's bf16 mode (K8f; K8c with dpts and ddirs), one
    wave of chunks: the stored planes within bf16_stored's bounds of the
    plain bf16 forward, the gradients (and K8c's input gradients) within
    BF16_PLANES_TOL of the plain sweep on them (bf16_planes), two calls
    bitwise equal, counted in ``launches_bf16`` (and
    ``input_grad_launches_bf16``) alone."""
    field = _field(cuda, 62, use_semantics=sem, sem_with_coord=coord, sem_dim=2, **shape)
    pts, dirs = _field_points(cuda, n, 63)
    g = torch.from_numpy(np.random.default_rng(n).normal(size=(n, 4 + 2 * sem))
                         .astype(np.float32)).to(cuda)
    f = ff.field_grads
    before = (f.launches, f.launches_bf16, f.input_grad_launches, f.input_grad_launches_bf16)
    got = _field_grads_bf16(field, pts, dirs, g, input_grads)
    again = f(field, pts, dirs, g, input_grads=input_grads, compute_dtype=BF16)
    torch.cuda.synchronize()
    assert (f.launches, f.launches_bf16, f.input_grad_launches, f.input_grad_launches_bf16) == (
        before[0], before[1] + 2, before[2], before[3] + 2 * input_grads)
    assert all(torch.equal(got[0][k], again[0][k]) and torch.isfinite(got[0][k]).all()
               for k in got[0])
    if input_grads:
        assert torch.equal(got[1], again[1]) and torch.equal(got[2], again[2])
        assert got[1].shape == got[2].shape == (n, 3)
    else:
        assert got[1] is None and got[2] is None


@pytest.mark.parametrize("input_grads", [False, True])
def test_field_grads_bf16_over_waves_match_plain(cuda, input_grads):
    """The field backward's bf16 mode over several waves of grouped chunks
    (70000 points at the flagship width, the semantic head with
    coordinates): every leaf (and K8c's dpts and ddirs as two leaves more)
    within bf16_leaves' bound of the bf16 plain version (BF16_WITNESS times
    its own last-bit sensitivity)."""
    field = _field(cuda, 64, use_semantics=True, sem_with_coord=True, sem_dim=2, **SHAPES[0])
    pts, dirs = _field_points(cuda, 70000, 65)
    g = torch.from_numpy(np.random.default_rng(66).normal(size=(70000, 6)).astype(np.float32))
    g = g.to(cuda)

    def leaves(res):
        grads, dp, dd = res
        return {**grads, **({"dpts": dp, "ddirs": dd} if input_grads else {})}

    def plain(f):
        return leaves(ff.field_grads_plain(f, pts, dirs, g, input_grads=input_grads,
                                           compute_dtype=BF16))

    got = leaves(ff.field_grads(field, pts, dirs, g, input_grads=input_grads,
                                compute_dtype=BF16))
    want = plain(field)
    bf16_leaves("K8c" if input_grads else "K8f", got, want, bf16_witness(plain, field, want))


def test_field_bf16_through_autograd(cuda):
    """fused_field_apply at bf16: the field forward (K8d's rule) and as its
    backward the field backward in their bf16 modes (their bf16 counters,
    not the fp32 ones), the input-gradient mode only when pts or dirs needs
    a gradient; the parameters' gradients bitwise those of field_grads at
    bf16 on the same cotangent."""
    field = _field(cuda, 67, use_semantics=True, sem_with_coord=True, sem_dim=2, **SHAPES[0])
    pts, dirs = _field_points(cuda, 300, 68)
    f, fwd = ff.field_grads, ff.field_forward
    for want_inputs in (False, True):
        p, d = pts.clone().requires_grad_(want_inputs), dirs.clone().requires_grad_(want_inputs)
        before = (fwd.launches, fwd.launches_bf16, f.launches, f.launches_bf16,
                  f.input_grad_launches_bf16)
        field.zero_grad(set_to_none=True)
        raw = ff.fused_field_apply(field, p, d, BF16)
        assert torch.equal(raw.detach(), ff.field_forward(field, pts, dirs, BF16))
        (raw ** 2).sum().backward()
        torch.cuda.synchronize()
        assert (fwd.launches, fwd.launches_bf16, f.launches, f.launches_bf16,
                f.input_grad_launches_bf16) == (before[0], before[1] + 2, before[2],
                                                before[3] + 1, before[4] + want_inputs)
        want = ff.field_grads(field, pts, dirs, (2 * raw).detach(), input_grads=want_inputs,
                              compute_dtype=BF16)
        for name, q in field.named_parameters():
            assert torch.equal(q.grad, want[0][name]), name
        if want_inputs:
            assert torch.equal(p.grad, want[1]) and torch.equal(d.grad, want[2])
        else:
            assert p.grad is None and d.grad is None


def test_field_bf16_rings_follow_a_weight_update(cuda):
    """The field kernels' bf16 rings (the forward's, the backward's and
    K8c's input-gradient ring, cached apart from the fp32 ones) are packed
    anew after an in-place weight update and equal fresh packings; the
    forwards follow their bf16 plain versions and the backward its plain
    sweep on its own planes before and after."""
    field = _field(cuda, 69, use_semantics=True, sem_with_coord=True, sem_dim=2, **SHAPES[0])
    pts, dirs = _field_points(cuda, 1000, 70, scale=8.0)  # outputs that differ point to point
    g = torch.from_numpy(np.random.default_rng(71).normal(size=(1000, 6)).astype(np.float32))
    g = g.to(cuda)

    def check():
        with torch.no_grad():
            bf16_points("K8d", ff.field_forward(field, pts, dirs, BF16),
                        ff.field_plain(field, pts, dirs, BF16), ff.field_forward(field, pts, dirs))
        _field_grads_bf16(field, pts, dirs, g, True)

    check()
    before = [t.clone() for t in _ring_bytes(field, True)]
    iring = field._field_input_ring_bf16[1].clone()  # _cached's (key, buffer, descriptor)
    with torch.no_grad():
        field.mlp.rgb_linear.weight.mul_(-0.75)
        field.mlp.pts_linears[0].weight.mul_(0.9)
    check()
    after = _ring_bytes(field, True)
    assert not any(torch.equal(a, b) for a, b in zip(after, before))
    assert torch.equal(after[0], fr.pack_ring(field, True)[0])
    assert torch.equal(after[1], fr.pack_bwd_ring(field, True)[0])
    inew = field._field_input_ring_bf16[1]
    assert not torch.equal(inew, iring) and torch.equal(inew, ff.pack_input_ring(field, True)[0])


def test_field_entries_run_the_bf16_mode(cuda):
    """The field kernels' C entries take their bf16 mode from a bf16
    descriptor (with the rings in their bf16 layouts): nerf_field in both
    head rules, nerf_field_sigma and nerf_field_grads return 0 and write
    what the wrappers' bf16 modes return, bit for bit."""
    from nerfsos_torch import _build

    field = _field(cuda, 3, **SHAPES[1])
    n = 64
    pts, dirs = _field_points(cuda, n, 5)
    g = torch.from_numpy(np.random.default_rng(6).normal(size=(n, 4)).astype(np.float32))
    g = g.to(cuda)
    buf, fdesc = fr._packed(field, cuda)
    rbuf, ring = fr._ring(field, cuda, True)
    fd = _build.TrainDesc()
    fd.f = fdesc
    fd.f.bf16 = 1
    rd = ff._field_ring(fdesc, ring, True)
    per = ff._field_plan(fdesc, ring, n, ff._sm_count(cuda), True)[0]
    lib = _build.library()
    for heads in (0, 1):
        raw = torch.zeros(n, 4, device=cuda)
        code = lib.nerf_field(pts.data_ptr(), dirs.data_ptr(), buf.data_ptr(), rbuf.data_ptr(),
                              ctypes.byref(fd), ctypes.byref(rd), raw.data_ptr(), n, per, heads,
                              _build.stream(cuda))
        torch.cuda.synchronize()
        assert code == 0 and torch.equal(raw, ff.field_forward(field, pts, dirs, BF16, heads))
    rs = ff._field_ring(fdesc, ring, False)
    sigma = torch.zeros(n, device=cuda)
    code = lib.nerf_field_sigma(pts.data_ptr(), buf.data_ptr(), rbuf.data_ptr(),
                                ctypes.byref(fd), ctypes.byref(rs), sigma.data_ptr(), n, per,
                                _build.stream(cuda))
    torch.cuda.synchronize()
    assert code == 0 and torch.equal(sigma, ff.fused_sigma_apply(field, pts, BF16))
    desc, grid, group = fr._sweep_launch(field, fdesc, fr._train_bwd(field, cuda)[1], n, 1, cuda,
                                         False)
    desc.f.bf16 = 1
    bring, brd = fr._bwd_ring(field, cuda, True)
    partial = torch.zeros(grid * desc.grad_size, device=cuda)
    work = torch.zeros(grid * desc.ws_size, device=cuda)
    flat = torch.zeros(desc.grad_size, device=cuda)
    code = lib.nerf_field_grads(
        pts.data_ptr(), dirs.data_ptr(), g.data_ptr(), buf.data_ptr(), rbuf.data_ptr(),
        bring.data_ptr(), None, ctypes.byref(desc), ctypes.byref(rd), ctypes.byref(brd),
        ctypes.byref(_build.RingDesc()), partial.data_ptr(), work.data_ptr(), flat.data_ptr(),
        None, None, n, grid, group, _build.stream(cuda))
    torch.cuda.synchronize()
    want = ff.field_grads(field, pts, dirs, g, input_grads=False, compute_dtype=BF16)[0]
    assert code == 0
    assert all(torch.equal(v, want[k]) for k, v in fr.unpack_grads(field, flat).items())
