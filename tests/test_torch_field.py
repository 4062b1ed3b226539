"""The field kernels' plain versions (``nerfsos_torch/ops/fused_field.py``)
and the paths that run them vs nerfsos_tpu, on tiny inputs (CPU).

The JAX side runs its Pallas field kernels in interpret mode, as
``tests/test_pallas.py`` does, with the weights bridged by
``state_dict_from_jax_params``: depth 6 (the skip after layer 4 feeds layer
5), width 32, multires 10/4, sem_dim 2 with and without coordinates, N <=
512. The packed input-gradient matrices of the field backward's
input-gradient mode (K8c) are modelled in torch, as the CUDA kernel uses
them. Then the paths: ``export_density`` (classic and mip) and its writers,
a net with no fine pass (``--N_importance 0``) rendered and trained one
step, and which wrappers a fused net calls.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfsos_torch.engines import checkpoint as tckpt
from nerfsos_torch.engines import eval as teval
from nerfsos_torch.engines import trainer as ttrainer
from nerfsos_torch.models import mip as tmip
from nerfsos_torch.models.nerf import NeRFConfig as TorchConfig
from nerfsos_torch.models.nerf import NeRFNet as TorchNet
from nerfsos_torch.ops import fused_field as tff
from nerfsos_torch.ops import fused_render as tfr
from nerfsos_torch.utils import io as tio
from nerfsos_tpu.engines import eval as jeval
from nerfsos_tpu.engines import trainer as jtrainer
from nerfsos_tpu.models import mip as jmip
from nerfsos_tpu.models.nerf import NeRFConfig as JaxConfig
from nerfsos_tpu.models.nerf import NeRFNet as JaxNet
from nerfsos_tpu.ops.pallas import fused_field as jff
from nerfsos_tpu.utils import io as jio

FIELD = dict(netdepth=6, netwidth=32, netdepth_fine=6, netwidth_fine=32, n_samples=8,
             n_importance=0, multires=10, multires_views=4, sem_dim=2)
# (use_semantics, sem_with_coord)
SEM = [(True, True), (True, False), (False, False)]
TOL = 1e-5


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread for torch in these tests: with the JAX runtime in
    the process, torch's CPU ``sin`` on its worker threads now and then
    takes a path that is off by up to 1.5e-4 at the PE's 2^9 phases
    (~1e3 rad) on a whole chunk of points, while on one thread it stays
    within 4e-8 of float64."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _pair(sem: bool, coord: bool, **over):
    """A JAX NeRFNet (coarse field only) with seeded params, its fused
    config, and the port's twin holding the same weights."""
    kw = {**FIELD, "use_semantics": sem, "sem_with_coord": coord, **over}
    cfg = JaxConfig(**kw, fused_field=True)
    params = JaxNet(cfg).init(jax.random.PRNGKey(7))
    tnet = TorchNet(TorchConfig(**kw, fused_field=True)).eval()
    tnet.load_state_dict(tckpt.state_dict_from_jax_params(
        jax.tree_util.tree_map(np.asarray, params)))
    return cfg, params, tnet


def _points(n: int, seed: int):
    """Points of norm ~1.5 and unit directions ``[n, 3]`` (float32)."""
    rng = np.random.default_rng(seed)
    pts = (rng.normal(size=(n, 3)) * 0.8).astype(np.float32)
    d = rng.normal(size=(n, 3))
    return pts, (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


def _close(got, want, what: str) -> None:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max())
    assert err <= TOL, f"{what}: max abs err {err}"


@pytest.mark.parametrize("sem,coord", SEM)
def test_field_and_sigma_match_pallas(sem, coord):
    """The field forward's and the sigma forward's plain versions (through
    the wrappers, on the CPU) vs K8b/K8d and K8a/K8e, to 1e-5."""
    cfg, params, tnet = _pair(sem, coord)
    pts, dirs = _points(300, 1)
    field = tnet.nerf
    with torch.no_grad():
        got = tff.fused_field_apply(field, torch.from_numpy(pts), torch.from_numpy(dirs))
        sig = tff.fused_sigma_apply(field, torch.from_numpy(pts))
    assert got.shape == (300, 4 + (2 if sem else 0)) and sig.shape == (300,)
    _close(got, jff.fused_field_apply(params["coarse"], jnp.asarray(pts)[:, None],
                                      jnp.asarray(dirs), cfg)[:, 0], "K8b")
    pd = jnp.asarray(np.concatenate([pts.T, dirs.T], 0))
    _close(got.T, jff.fused_field_apply_planar(params["coarse"], pd, cfg), "K8d")
    _close(sig, jff.fused_sigma_apply(params["coarse"], jnp.asarray(pts), cfg)[:, 0], "K8a")
    _close(sig, jff.fused_sigma_apply_planar(params["coarse"], jnp.asarray(pts.T), cfg), "K8e")
    _close(sig, got[:, 3], "sigma vs the field's sigma column")


@pytest.mark.parametrize("zero_cov", [True, False])
def test_mip_field_matches_pallas(zero_cov):
    """K11's plain version vs ``fused_mip_apply_planar`` at zero and
    non-zero covariances, to 1e-5."""
    kw = {**FIELD, "n_importance": 8, "use_semantics": False}
    cfg = JaxConfig(**kw, fused_field=True)
    params = jmip.MipNeRFNet(cfg).init(jax.random.PRNGKey(3))
    tnet = tmip.MipNeRFNet(TorchConfig(**kw, fused_field=True)).eval()
    tnet.load_state_dict(tckpt.state_dict_from_jax_params(
        jax.tree_util.tree_map(np.asarray, params)))
    mean, dirs = _points(200, 2)
    cov = (np.zeros_like(mean) if zero_cov
           else np.random.default_rng(3).uniform(0, 0.01, mean.shape).astype(np.float32))
    with torch.no_grad():
        got = tnet.field_query(*(torch.from_numpy(a) for a in (mean, cov, dirs)))
    pd = jnp.asarray(np.concatenate([mean.T, cov.T, dirs.T], 0))
    assert got.shape == (200, 4)
    _close(got.T, jff.fused_mip_apply_planar(params["mip"], pd, cfg), "K11")


def _jax_grads(sem: bool, dws, dbs) -> dict:
    """The JAX backward's (dW, db) in ``_flatten_mlp_params`` order -> the
    port's parameter names."""
    names = [f"pts_linears_{i}" for i in range(FIELD["netdepth"])]
    names += ["alpha_linear", "feature_linear", "views_linears_0", "rgb_linear"]
    names += ["sem_0", "sem_1"] if sem else []
    tree = {"coarse": {"mlp": {n: {"kernel": np.asarray(w), "bias": np.asarray(b)}
                               for n, w, b in zip(names, dws, dbs)}}}
    return {k[len("nerf."):]: v for k, v in tckpt.state_dict_from_jax_params(tree).items()}


@pytest.mark.parametrize("sem,coord", SEM)
def test_field_backward_matches_pallas(sem, coord):
    """``_FieldFn``'s backward (the field backward's plain version) with
    the points' and directions' gradients vs ``_fused_backward(...,
    input_grads=True)`` (K8c), and without them vs ``_fused_backward_pl``
    (K8f): every leaf and dpts/ddirs to 1e-5 of its max."""
    cfg, params, tnet = _pair(sem, coord)
    N = 200
    pts, dirs = _points(N, 4)
    g = np.random.default_rng(5).normal(size=(N, 4 + (2 if sem else 0))).astype(np.float32)
    ws, bs = jff._flatten_mlp_params(params["coarse"]["mlp"], FIELD["netdepth"], sem)
    args = (FIELD["netdepth"], (4,), FIELD["multires"], FIELD["multires_views"], sem, coord,
            "float32")
    dws, dbs, (jdp, jdd) = jff._fused_backward(tuple(ws), tuple(bs),
                                               (jnp.asarray(pts), jnp.asarray(dirs)),
                                               jnp.asarray(g), *args, block=128, interpret=True)
    pd = jnp.asarray(np.concatenate([pts.T, dirs.T], 0))
    dws_pl, dbs_pl = jff._fused_backward_pl(tuple(ws), tuple(bs), pd, jnp.asarray(g.T), *args,
                                            block=128, interpret=True)
    field = tnet.nerf
    for input_grads, (jw, jb) in ((True, (dws, dbs)), (False, (dws_pl, dbs_pl))):
        p = torch.from_numpy(pts).requires_grad_(input_grads)
        d = torch.from_numpy(dirs).requires_grad_(input_grads)
        field.zero_grad(set_to_none=True)
        torch.sum(tff.fused_field_apply(field, p, d) * torch.from_numpy(g)).backward()
        want = _jax_grads(sem, jw, jb)
        got = {n: q.grad for n, q in field.named_parameters()}
        if input_grads:
            got.update(dpts=p.grad, ddirs=d.grad)
            want.update(dpts=torch.from_numpy(np.array(jdp)),
                        ddirs=torch.from_numpy(np.array(jdd)))
        assert set(got) == set(want)
        for name, ref in want.items():
            scale = float(ref.abs().max()) + 1e-12
            err = float((got[name] - ref).abs().max()) / scale
            assert err <= TOL, f"input_grads={input_grads} {name}: {err} of the leaf's max"


@pytest.mark.parametrize("sem,coord,depth", [(True, True, 6), (True, False, 6), (True, True, 5),
                                             (False, False, 5)])
def test_input_grad_matrices_model_autograd(sem, coord, depth):
    """K8c's input-gradient mode as the CUDA kernel computes it, modelled in
    torch from the packed buffer (``pack_input_bwd``) and the planes of
    ``train_desc(..., input_grads=True)``: the point-PE cotangent gathered
    from each matrix's layer cotangent (depth 5: the skip follows the last
    layer, so feature, alpha and sem_0's h segment read emb too), the
    view-PE cotangent from the views layer's, and the PE's chain rule
    (``pe_grads``), against autograd, to 1e-5 of each max."""
    _, _, tnet = _pair(sem, coord, netdepth=depth)
    field, mlp = tnet.nerf, tnet.nerf.mlp
    pts, dirs = _points(64, 6)
    p = torch.from_numpy(pts).requires_grad_()
    d = torch.from_numpy(dirs).requires_grad_()
    emb = field.embed(p).detach().requires_grad_()
    demb = field.embed_views(d).detach().requires_grad_()
    dys = {}

    def keep(name):
        def hook(mod, inputs, out):
            out.register_hook(lambda grad: dys.__setitem__(name, grad))
        return hook

    layers = {**{i: mlp.pts_linears[i] for i in range(depth)}, "alpha": mlp.alpha_linear,
              "feature": mlp.feature_linear, "views": mlp.views_linears[0]}
    if sem:
        layers["sem_0"] = mlp.semantic_linear[0]
    handles = [m.register_forward_hook(keep(k)) for k, m in layers.items()]
    g = torch.from_numpy(np.random.default_rng(7).normal(size=(64, 4 + 2 * sem))
                         .astype(np.float32))
    torch.sum(mlp(emb, demb) * g).backward()
    for h in handles:
        h.remove()

    buf, descs = tff.pack_input_bwd(field)
    fdesc = tfr.pack_field(field)[1]
    desc = tfr.train_desc(field, fdesc, tfr.pack_train_bwd(field)[1], 1, sem, input_grads=True)
    gemb_plane = tfr._P_ACT0 + depth + 3
    assert (desc.rows[gemb_plane], desc.rows[gemb_plane + 1]) == (64, 32)  # pad8(63), pad8(27)

    def product(i, dy):
        """out = dY M: the packed matrix of layer slot i, unpadded."""
        L = descs[i]
        n8 = (L.n + 7) // 8 * 8
        m = buf[L.w:L.w + L.k * n8].view(L.k, n8)
        return dy @ m[:dy.shape[1], :L.n]

    def pad_rows(t):
        return torch.cat([t, t.new_zeros(t.shape[0], (-t.shape[1]) % 8)], dim=1)

    gemb = product(0, dys[0])
    for i in range(1, depth):
        if i - 1 in mlp.skips:
            gemb = gemb + product(i, dys[i])
    if depth - 1 in mlp.skips:
        gemb = gemb + product(depth, torch.cat([pad_rows(dys["feature"]), dys["alpha"]], 1))
    if sem and descs[depth + 4].k > 0:
        gemb = gemb + product(depth + 4, dys["sem_0"])
    gdemb = product(depth + 2, dys["views"])
    assert float((gemb - emb.grad).abs().max()) <= TOL * float(emb.grad.abs().max())
    assert float((gdemb - demb.grad).abs().max()) <= TOL * float(demb.grad.abs().max())

    def pe_grads(x, gx):
        F = (gx.shape[1] - 3) // 6
        out = gx[:, :3].clone()
        for b in range(F):
            for h in range(2):
                phase = x * 2.0**b + (np.float32(np.pi / 2) if h else 0.0)
                out = out + (gx[:, 3 + 6 * b + 3 * h:6 + 6 * b + 3 * h] * torch.cos(phase)) * 2.0**b
        return out

    # the chain rule of the PE against autograd through it
    torch.sum(field.embed(p) * emb.grad).backward()
    torch.sum(field.embed_views(d) * demb.grad).backward()
    for got, want in ((pe_grads(p.detach(), emb.grad), p.grad),
                      (pe_grads(d.detach(), demb.grad), d.grad)):
        assert float((got - want).abs().max()) <= TOL * float(want.abs().max())


def test_field_wrappers_reject_bad_inputs():
    """The CUDA wrappers' checks run before any launch; a device without a
    kernel raises."""
    _, _, tnet = _pair(True, True)
    pts = torch.zeros(4, 3)
    with pytest.raises(NotImplementedError):
        tff.field_forward(tnet.nerf, pts.to("meta"), pts.to("meta"))
    with pytest.raises(ValueError):
        tff._check_points(tnet.nerf, 4, pts=pts, dirs=torch.zeros(4, 2))
    with pytest.raises(ValueError):
        tff._check_points(tnet.nerf, 4, pts=torch.zeros(3, 4).t())
    with pytest.raises(NotImplementedError):
        tff._check_points(tnet.nerf, 4, pts=pts.double())


# ----------------------------------------------------------------- the paths


@pytest.mark.parametrize("mip", [False, True])
def test_export_density_matches_jax(tmp_path, mip):
    """``export_density`` on the ``--vol_extents 0.2 --vol_size 0.02`` grid
    (10^3 points, x14) against JAX's on the same weights (a net with a fine
    pass: the fine field; mip: its one field at zero covariance): the
    volume to 1e-5 in memory and in ``density.mrc``, ``density.ply``
    byte-equal; the port's last chunk is ragged (chunk 300), JAX's padded."""
    kw = {**FIELD, "netdepth": 2, "netdepth_fine": 3, "n_importance": 4,
          "use_semantics": not mip, "sem_with_coord": not mip}
    cfg = JaxConfig(**kw)
    jnet = jmip.MipNeRFNet(cfg) if mip else JaxNet(cfg)
    params = jnet.init(jax.random.PRNGKey(11))
    tnet = (tmip.MipNeRFNet if mip else TorchNet)(TorchConfig(**kw, fused_field=True)).eval()
    tnet.load_state_dict(tckpt.state_dict_from_jax_params(
        jax.tree_util.tree_map(np.asarray, params)))
    assert tnet.fused
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    want = jeval.export_density(jnet, params, extents=(0.2, 0.2, 0.2), voxel_size=0.02,
                                save_dir=str(jdir), chunk=256)
    got = teval.export_density(tnet, extents=(0.2, 0.2, 0.2), voxel_size=0.02,
                               save_dir=str(tdir), chunk=300)
    assert got.shape == want.shape == (10, 10, 10)
    _close(got, want, "density")
    np.testing.assert_array_equal(tio.read_mrc(str(tdir / "density.mrc")), got)
    _close(jio.read_mrc(str(jdir / "density.mrc")), got, "density.mrc")
    assert (tdir / "density.ply").read_bytes() == (jdir / "density.ply").read_bytes()


def test_writers_are_byte_equal_to_jax(tmp_path):
    """``write_mrc``, ``write_voxel_ply`` and ``write_ply_points`` (with and
    without colors) byte-equal to the JAX package's on a seeded volume, and
    ``read_mrc`` reads it back."""
    rng = np.random.default_rng(8)
    vol = np.maximum(rng.normal(size=(7, 5, 6)), 0).astype(np.float32)
    pts = rng.normal(size=(9, 3)).astype(np.float32)
    cols = rng.integers(0, 256, (9, 3)).astype(np.uint8)
    for mod, d in ((tio, tmp_path / "t"), (jio, tmp_path / "j")):
        os.makedirs(d)
        mod.write_mrc(str(d / "v.mrc"), vol, voxel_size=0.5)
        mod.write_voxel_ply(str(d / "v.ply"), vol)
        mod.write_ply_points(str(d / "p.ply"), pts)
        mod.write_ply_points(str(d / "c.ply"), pts, cols)
    for name in ("v.mrc", "v.ply", "p.ply", "c.ply"):
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes(), name
    np.testing.assert_array_equal(tio.read_mrc(str(tmp_path / "t" / "v.mrc")), vol)


# Whole renders and steps vs JAX: the two packages' stratified samplers
# place z a float32 ulp apart (2.4e-7 at z ~ 3), which the PE's 2^9
# frequency turns into phase differences of ~1e-4 rad; on these inputs the
# maps then differ by up to 2.7e-5 (depth, ~3.7) and 8e-6 (the others) and
# the step's gradients by 4.4e-5 of a leaf's max, with the field kernels'
# plain versions and the plain fields alike. 1e-4 (chip_smoke.TOL) holds
# both while an indexing or routing fault moves them by O(1e-2) or more.
PATH_TOL = 1e-4


def test_noimp_render_matches_jax():
    """A fused net with no fine pass (``n_importance`` 0), perturb 0 and no
    noise: the port's render (the field forward's plain version) against
    JAX's fused net (K8d, interpret mode), each map to PATH_TOL of
    max(1, its max |JAX|)."""
    cfg, params, tnet = _pair(True, True, perturb=0.0, raw_noise_std=0.0)
    rng = np.random.default_rng(9)
    rays = rng.normal(size=(2, 40, 3)).astype(np.float32)
    rays[0] *= 0.3
    want = JaxNet(cfg)(params, jnp.asarray(rays), (1.0, 4.0), train=False)
    with torch.no_grad():
        got = tnet(torch.from_numpy(rays), (1.0, 4.0), train=False)
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k])
        assert got[k].shape == w.shape, k
        assert np.abs(got[k].numpy() - w).max() <= PATH_TOL * max(1.0, np.abs(w).max()), k


def test_noimp_train_step_grads_match_jax():
    """One RGB step's gradients of a fused net with no fine pass (perturb 0,
    no noise): the port's autograd step through ``_FieldFn`` (the field
    backward's plain version) against ``jax.grad`` of JAX's step through
    K8d/K8f (interpret mode), every leaf to PATH_TOL of its max."""
    cfg, params, tnet = _pair(True, True, perturb=0.0, raw_noise_std=0.0)
    rng = np.random.default_rng(10)
    rays = rng.normal(size=(2, 24, 3)).astype(np.float32)
    rays[0] *= 0.3
    batch = {"rays": rays, "target": rng.uniform(0, 1, (24, 3)).astype(np.float32)}
    jnet = JaxNet(cfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss(p):
        return jtrainer.rgb_loss_fn(jnet, p, jbatch, jax.random.PRNGKey(0), 1.0, 4.0)[0]

    jgrads = jax.grad(loss)(params)
    want = tckpt.state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, jgrads))
    assert not ttrainer.supports_fused_rgb_loss(tnet)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    tloss, _ = ttrainer.rgb_loss_fn(tnet, tbatch, 1.0, 4.0)
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(loss(params)), rtol=1e-6)
    for name, p in tnet.named_parameters():
        ref = want[name]
        err = float((p.grad - ref).abs().max()) / (float(ref.abs().max()) + 1e-12)
        assert err <= PATH_TOL, f"{name}: {err} of the leaf's max"


def test_fused_net_routes_every_field_call_through_the_wrappers(monkeypatch):
    """A fused net's passes off K1-K6 (a net with no fine pass in train and
    eval renders and its backward; a density-only coarse pass with noise
    and the fine pass after it) reach their fields only inside the field
    wrappers (on the CPU the wrappers' plain versions query the field); a
    plain net calls no wrapper."""
    calls = {"field_forward": 0, "field_grads": 0, "fused_sigma_apply": 0}
    inside = [0]
    for name in calls:
        def counted(*a, _orig=getattr(tff, name), _name=name, **kw):
            calls[_name] += 1
            inside[0] += 1
            try:
                return _orig(*a, **kw)
            finally:
                inside[0] -= 1

        monkeypatch.setattr(tff, name, counted)

    def guarded(method):
        def call(*a, **kw):
            assert inside[0] > 0, "a fused net queried its field outside the field wrappers"
            return method(*a, **kw)
        return call

    rays = torch.from_numpy(np.random.default_rng(11).normal(size=(2, 10, 3))
                            .astype(np.float32))
    _, _, noimp = _pair(True, True)
    _, _, fine = _pair(True, True, n_importance=4)
    for net in (noimp, fine):
        for field in {net.nerf, net.fine_field}:
            monkeypatch.setattr(field, "forward", guarded(field.forward))
            monkeypatch.setattr(field, "sigma", guarded(field.sigma))
    out = noimp(rays, (1.0, 4.0), train=True, raw_noise_std=1.0,
                generator=torch.Generator().manual_seed(0))
    out["rgb"].sum().backward()
    assert calls == {"field_forward": 1, "field_grads": 1, "fused_sigma_apply": 0}
    with torch.no_grad():
        noimp(rays, (1.0, 4.0), train=False)
        assert calls["field_forward"] == 2
        fine(rays, (1.0, 4.0), train=False, raw_noise_std=1.0, coarse_outputs=False,
             generator=torch.Generator().manual_seed(0))
    assert calls == {"field_forward": 3, "field_grads": 1, "fused_sigma_apply": 1}

    monkeypatch.undo()

    def no_call(*a, **kw):
        raise AssertionError("a plain net called a field wrapper")

    for name in calls:
        monkeypatch.setattr(tff, name, no_call)
    plain = TorchNet(dataclasses.replace(noimp.cfg, fused_field=False))
    assert not plain.fused
    plain(rays, (1.0, 4.0), train=True)["rgb"].sum().backward()


def test_run_nerf_noimp_trains_exports_and_stops_the_sos_losses(tmp_path):
    """``run_nerf.main`` on the CPU with ``--N_importance 0``: three RGB
    steps through the field wrappers write ``last.ckpt`` and the final
    eval; ``--eval_vol`` exports the density of that checkpoint; the SOS
    finetune, whose losses read a coarse pass's outputs, stops up front."""
    from nerfsos_torch import run_nerf
    from nerfsos_torch.data.synthetic import write_sphere_scene

    data, logs = tmp_path / "data", tmp_path / "logs"
    write_sphere_scene(str(data), 8, 8, n_views=1)
    write_sphere_scene(str(data), 8, 8, n_views=2, split="train")
    base = ["--expname", "t", "--basedir", str(logs), "--data_path", str(data),
            "--data_type", "llff", "--N_samples", "4", "--N_importance", "0", "--netdepth", "2",
            "--netwidth", "16", "--multires", "2", "--multires_views", "2", "--ray_chunk", "50",
            "--batch_size", "16", "--i_print", "1", "--i_weights", "100", "--i_testset", "1000"]
    parse = run_nerf.create_arg_parser().parse_known_args
    before = (tff.field_forward.launches, tff.field_grads.launches)
    run_nerf.main(parse(base + ["--max_steps", "3"])[0], device="cpu")
    assert (tff.field_forward.launches, tff.field_grads.launches) == before  # plain on the CPU
    state, step, opt = tckpt.load_checkpoint(str(logs / "t" / "checkpoints" / "last.ckpt"))
    assert step == 3 and opt and not any(k.startswith("nerf_fine") for k in state)
    assert os.path.exists(logs / "t" / "eval" / "log.json")
    run_nerf.main(parse(base + ["--eval_vol", "--vol_extents", "0.2", "0.4", "0.2",
                                "--vol_size", "0.05"])[0], device="cpu")
    vol = tio.read_mrc(str(logs / "t" / "eval" / "density.mrc"))
    assert vol.shape == (8, 4, 4) and np.isfinite(vol).all()  # [x from w, y from h, z]
    with pytest.raises(SystemExit, match="need a fine pass"):
        run_nerf.main(parse(base + ["--patch_tune", "--use_dino", "--use_correlation",
                                    "--max_steps", "4"])[0], device="cpu")
