"""``--mipnerf`` at ``--compute_dtype bfloat16`` on the CPU: the bf16 plain
versions of K9, K10a, K10b and K11 against the JAX Pallas kernels at bf16
(interpret mode, ``RAY_BLOCK`` 8), the eager bf16 ``MipNeRFNet`` against
JAX's eager net at bf16, a fault planted in the bf16 sweep's rounding rules
and refused, the wrappers' CPU route, and ``run_nerf.main --mipnerf`` at
bf16 (train, ``--eval``, ``--eval_vol``; fused and ``--no_fused_field``).

The plain versions and the Pallas kernels round the same operands to bf16
and sum in float32 in other orders (the integrated PE is exact float32 on
both sides before its rounding), so they differ by float32 summation order
(measured <= 2.4e-7 on the maps, 2.4e-7 of a K10b leaf's max here), but
for a ray where a value lay within that rounding of a bf16 rounding
boundary and rounded the other way (a flip: test_torch_bf16.py's
``_assert_bf16_close``, test_torch_bf16_train.py's ``_flipped``). The
float32 plain versions lie 2e-3 to 0.25 (of a leaf's max) from the bf16
kernels here. The CUDA kernels' bf16 modes run on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from nerfsos_torch import run_nerf
from nerfsos_torch.data.synthetic import write_sphere_scene
from nerfsos_torch.engines import checkpoint as tckpt
from nerfsos_torch.models import mip as tmip
from nerfsos_torch.models.fields import MipNeRFField
from nerfsos_torch.models.nerf import NeRFConfig as TorchConfig
from nerfsos_torch.ops import fused_field as tff
from nerfsos_torch.ops import fused_render as tfr
from nerfsos_tpu.models import mip as jmip
from nerfsos_tpu.models.nerf import NeRFConfig as JaxConfig
from nerfsos_tpu.ops.pallas import fused_field as jff
from nerfsos_tpu.ops.pallas import fused_render as jfr
from test_torch_bf16 import FLIP_ROWS, KERNEL_TOL, _assert_bf16_close, _jax_params, _jax_seed, _np
from test_torch_bf16_train import _flipped, _leaf_reading

BF16 = torch.bfloat16
# depth 5: the skip's [emb, h] input follows layer 4, the last one
TINY = dict(netwidth=32, netdepth=5, n_samples=8, n_importance=8, multires=4, multires_views=2,
            use_semantics=False)
R, S = 20, 8  # rays (not a multiple of the 8-ray Pallas block) and intervals
RADII = 0.01


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for torch in this module's tests (the count found
    is restored after): the tier-1 run's pytest workers share the machine's
    cores, and torch's default of a thread a core in each worker
    oversubscribes them many times over."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


@pytest.fixture(autouse=True)
def small_pallas_block(monkeypatch):
    """8 rays a Pallas grid step keeps interpret mode fast."""
    monkeypatch.setattr(jfr, "RAY_BLOCK", 8)


def _nets(fused=True, **over):
    """A JAX MipNeRFNet at bf16 with seeded params and the port's twin
    holding them."""
    kw = {**TINY, **over}
    jnet = jmip.MipNeRFNet(JaxConfig(**kw, fused_field=fused, compute_dtype="bfloat16"))
    params = _jax_params(jnet, 2)
    tnet = tmip.MipNeRFNet(TorchConfig(**kw, fused_field=fused, compute_dtype="bfloat16"))
    tnet.load_state_dict(tckpt.state_dict_from_jax_params(_np(params)))
    return jnet, params, tnet


def _odvr_z(n, s, seed):
    """Rays (origins, directions, unit viewdirs, radii) and sorted fenceposts
    ``[n, s + 1]`` in [1, 4]."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3)) * 0.3
    d = rng.normal(size=(n, 3))
    v = d / np.linalg.norm(d, axis=1, keepdims=True)
    odvr = np.concatenate([o, d, v, np.full((n, 1), RADII)], 1).astype(np.float32)
    z = np.sort(rng.uniform(1.0, 4.0, (n, s + 1)), 1).astype(np.float32)
    return odvr, z


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# ----------------------------------------------------------------- the eager route


def test_eager_mip_net_bf16_matches_jax():
    """--no_fused_field at bf16: the port's MipNeRFNet (the float32 IPE,
    flax's bf16 Dense layers, the float32 composite) against JAX's XLA net at
    compute_dtype bfloat16 at perturb 0. JAX's field runs op by op, as the
    JAX entry point's eval does outside jit (under jit XLA fuses and skips
    bf16 roundings): it is called back from the jitted net. The raw outputs
    of the field are equal but for points where a rounding flipped (at most
    FLIP_ROWS of them, each within four bf16 steps of its scale), and so are
    the net's outputs but for FLIP_ROWS of the rays, each within four bf16
    steps of its output's scale, and z_std within 5e-3 (the fp32 nets' bound,
    test_torch_mip.py); JAX's view PE (encoding.positional_encoding) is
    within ~1e-6 of the port's, which may flip a rounding of it (no output
    here lay beyond KERNEL_TOL). The float32 net lies 2e-3 or more from
    JAX's bf16 one here."""
    from nerfsos_tpu.models.fields import MipNeRFField as FlaxField

    jnet, params, tnet = _nets(fused=False, netdepth=2, ray_block=64)
    assert not tnet.fused and tnet.mip.mlp.compute_dtype == BF16
    rng = np.random.default_rng(4)
    rays = rng.normal(size=(2, R, 3)).astype(np.float32)
    rays[0] *= 0.3
    eager = jnet._apply

    def called_back(p, pts, cov, viewdirs):
        out = jax.ShapeDtypeStruct(pts.shape[:-1] + (4,), jnp.float32)
        return jax.pure_callback(lambda *a: np.asarray(eager(*a)), out, p, pts, cov, viewdirs)

    jnet._apply = called_back
    want = jax.jit(lambda p, r: jnet(p, r, (1.0, 4.0), radii=RADII, train=False))(
        params, jnp.asarray(rays))
    f32 = tmip.MipNeRFNet(TorchConfig(**{**TINY, "netdepth": 2}, ray_block=64))
    f32.load_state_dict(tnet.state_dict())
    with torch.no_grad():
        got = tnet(torch.from_numpy(rays), (1.0, 4.0), radii=RADII, train=False)
        got32 = f32(torch.from_numpy(rays), (1.0, 4.0), radii=RADII, train=False)
    assert set(got) == set(want)
    for k in want:
        g, w = got[k].numpy().reshape(R, -1), np.asarray(want[k]).reshape(R, -1)
        err = np.abs(g - w).max(1)
        if k == "z_std":
            assert err.max() <= 5e-3, k
            continue
        scale = max(float(np.abs(w).max()), 1.0)
        assert (err > KERNEL_TOL).mean() <= FLIP_ROWS and err.max() <= 2.0**-6 * scale, k
        assert np.abs(got32[k].numpy().reshape(R, -1) - w).max() > 100 * KERNEL_TOL, k

    ffield = FlaxField(net_depth=2, net_width=32, multires=4, multires_views=2,
                       compute_dtype=jnp.bfloat16)
    mean = rng.normal(size=(R, S, 3)).astype(np.float32)
    cov = rng.uniform(0, 0.01, (R, S, 3)).astype(np.float32)
    dirs = rays[1] / np.linalg.norm(rays[1], axis=-1, keepdims=True)
    want = np.asarray(ffield.apply({"params": params["mip"]}, *map(jnp.asarray, (mean, cov, dirs))))
    with torch.no_grad():
        raw = tnet.mip(*_t(mean, cov, dirs))
        raw32 = f32.mip(*_t(mean, cov, dirs))
    assert raw.dtype == torch.float32 and raw.shape == want.shape == (R, S, 4)
    err = np.abs(raw.numpy() - want).reshape(R * S, -1).max(1)
    assert (err > 0).mean() <= FLIP_ROWS and err.max() <= 2.0**-6 * float(np.abs(want).max())
    assert float(np.abs(raw32.numpy() - want).max()) > 1e-3


# ----------------------------------------------------------------- K9, K10a, K11


@pytest.mark.parametrize("noise", [0.0, 1.0])
def test_k9_k10a_bf16_plain_match_pallas(noise):
    """K9's bf16 plain version (no noise) against fused_mip_render_planar at
    bf16 and K10a's (noise 1, its key's seed injected) against the forward of
    fused_mip_train_render_planar (_mip_train_fwd_impl) at bf16, at fixed
    fenceposts: maps and weights to KERNEL_TOL but for one flipped row, and
    far from the float32 plain version's."""
    jnet, params, tnet = _nets()
    odvr, z = _odvr_z(R, S, 1)
    key = jax.random.PRNGKey(11)
    args = _t(odvr, z)
    if noise == 0.0:
        want = jfr.fused_mip_render_planar(params["mip"], jnp.asarray(odvr), jnp.asarray(z),
                                           jnet.cfg)
        got = tfr.mip_render_plain(tnet.mip, *args, BF16)
        got32 = tfr.mip_render_plain(tnet.mip, *args)
    else:
        want = jfr.fused_mip_train_render_planar(params["mip"], jnp.asarray(odvr),
                                                 jnp.asarray(z), jnet.cfg, noise_std=noise,
                                                 noise_key=key)
        kw = dict(noise_std=noise, seed=_jax_seed(key))
        got = tfr.mip_train_render_plain(tnet.mip, *args, compute_dtype=BF16, **kw)
        got32 = tfr.mip_train_render_plain(tnet.mip, *args, **kw)
    assert got[0].shape == want[0].shape == (R, 5) and got[1].shape == want[1].shape == (R, S)
    for g, w, g32 in zip(got, want, got32):
        _assert_bf16_close(g, w, g32)


@pytest.mark.parametrize("cov_scale", [0.0, 1e-2])
def test_k11_bf16_plain_matches_pallas(cov_scale):
    """K11's bf16 plain version against fused_mip_apply_planar at bf16 on
    300 Gaussians (zero covariances, as the density export's, and up to
    1e-2): raw to KERNEL_TOL but for one flipped row, far from float32."""
    jnet, params, tnet = _nets()
    rng = np.random.default_rng(5)
    n = 300
    mean = rng.normal(size=(n, 3)).astype(np.float32)
    cov = (rng.uniform(0, 1, (n, 3)) * cov_scale).astype(np.float32)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    want = jff.fused_mip_apply_planar(params["mip"],
                                      jnp.asarray(np.concatenate([mean, cov, dirs], 1).T),
                                      jnet.cfg)
    with torch.no_grad():
        got = tff.mip_field_plain(tnet.mip, *_t(mean, cov, dirs), BF16)
        got32 = tff.mip_field_plain(tnet.mip, *_t(mean, cov, dirs))
    assert got.shape == (n, 4)
    _assert_bf16_close(got, np.asarray(want).T, got32)


# ----------------------------------------------------------------- K10b


@pytest.fixture(scope="module")
def k10b_case():
    """K10b's case: the seeded bf16 nets at depth 5, 20 rays of 8 intervals,
    noise 1 from a JAX key, seeded map and weight cotangents; jax.vjp of
    fused_mip_train_render_planar at bf16 (interpret mode) on the rays
    without a flipped one (a ray whose maps from K10a's bf16 plain version
    lie beyond KERNEL_TOL of JAX's: at most one, _flipped), and the port's
    inputs for those rays."""
    saved = jfr.RAY_BLOCK
    jfr.RAY_BLOCK = 8
    try:
        jnet, params, tnet = _nets()
        odvr, z = _odvr_z(R, S, 2)
        rng = np.random.default_rng(3)
        dmaps = rng.normal(size=(R, 5)).astype(np.float32)
        dw = rng.normal(size=(R, S)).astype(np.float32)
        key = jax.random.PRNGKey(12)
        kw = dict(noise_std=1.0, seed=_jax_seed(key))

        def vjp(rows):
            (maps_j, _), fn = jax.vjp(lambda p: jfr.fused_mip_train_render_planar(
                p, jnp.asarray(odvr[rows]), jnp.asarray(z[rows]), jnet.cfg, noise_std=1.0,
                noise_key=key), params["mip"])
            (g,) = fn((jnp.asarray(dmaps[rows]), jnp.asarray(dw[rows])))
            return maps_j, {k[len("mip."):]: v for k, v in
                            tckpt.state_dict_from_jax_params({"mip": _np(g)}).items()}

        rows = np.arange(R)
        maps_j, want = vjp(rows)
        maps = tfr.mip_train_render_plain(tnet.mip, *_t(odvr, z), compute_dtype=BF16, **kw)[0]
        flipped = _flipped(maps, maps_j)
        if len(flipped):
            rows = np.setdiff1d(rows, flipped)
            want = vjp(rows)[1]
    finally:
        jfr.RAY_BLOCK = saved
    return tnet.mip, _t(odvr[rows], z[rows], dmaps[rows], dw[rows]), kw, want


def test_k10b_bf16_plain_matches_pallas_vjp(k10b_case):
    """K10b's bf16 plain version (K10a's bf16 forward, the float32 mip
    composite's cotangent, bf16_sweep without the semantic head) against
    jax.vjp of fused_mip_train_render_planar at bf16 (_mip_train_bwd_kernel
    in interpret mode): every leaf to LEAF_TOL of its max on the rays
    without a flipped one; the float32 plain version misses the bound."""
    field, args, kw, want = k10b_case
    got = tfr.mip_train_render_grads_plain(field, *args, compute_dtype=BF16, **kw)
    got32 = tfr.mip_train_render_grads_plain(field, *args, **kw)
    assert set(got) == set(want) == {n for n, _ in field.named_parameters()}
    assert all(np.abs(np.asarray(v)).max() > 0 for v in want.values())
    assert _leaf_reading(got, want) <= 1.0
    assert _leaf_reading(got32, want) > 1.0


def test_k10b_comparison_refuses_a_rounding_fault(k10b_case, monkeypatch):
    """The same comparison refuses a bf16 sweep whose relu-gated cotangents
    (dhv and every trunk dpre) are left unrounded: the fault of a reverse
    sweep whose gate epilogue skips its bf16 rounding, which moves the bias
    sums (each product rounds its operands anyway)."""
    field, args, kw, want = k10b_case
    monkeypatch.setattr(tfr, "_bf16_gate",
                        lambda act, d: torch.where(act > 0, d, torch.zeros_like(d)))
    fault = tfr.mip_train_render_grads_plain(field, *args, compute_dtype=BF16, **kw)
    assert _leaf_reading(fault, want) > 1.0


# ----------------------------------------------------------------- the wrappers


def test_mip_bf16_wrappers_on_the_cpu_take_the_plain_path():
    """On CPU tensors K9's, K10a's, K10b's and K11's wrappers at bf16 are
    their bf16 plain versions and count no launch; the autograd function
    (K10a forward, K10b backward) gives every leaf K10b's bf16 plain
    gradient of its cotangent."""
    _, _, tnet = _nets()
    field = tnet.mip
    odvr, z = _t(*_odvr_z(6, S, 7))
    fns = (tfr.fused_mip_render, tfr.mip_train_render, tfr.mip_train_render_grads,
           tff.fused_mip_field_apply)
    counts = [(f.launches, f.launches_bf16) for f in fns]
    kw = dict(noise_std=1.0, seed=99)
    with torch.no_grad():
        for a, b in zip(tfr.fused_mip_render(field, odvr, z, BF16),
                        tfr.mip_render_plain(field, odvr, z, BF16)):
            assert torch.equal(a, b)
        for a, b in zip(tfr.mip_train_render(field, odvr, z, compute_dtype=BF16, **kw),
                        tfr.mip_train_render_plain(field, odvr, z, compute_dtype=BF16, **kw)):
            assert torch.equal(a, b)
        pts = odvr[:, 0:3].contiguous()
        assert torch.equal(tff.fused_mip_field_apply(field, pts, pts * 0.01, odvr[:, 6:9], BF16),
                           tff.mip_field_plain(field, pts, pts * 0.01, odvr[:, 6:9], BF16))
    maps, w = tfr.fused_mip_train_render(field, odvr, z, compute_dtype=BF16, **kw)
    dmaps = torch.arange(1.0, 6.0).expand(6, 5).contiguous()
    (maps * dmaps).sum().backward()
    want = tfr.mip_train_render_grads(field, odvr, z, dmaps, None, compute_dtype=BF16, **kw)
    for name, p in field.named_parameters():
        assert torch.equal(p.grad, want[name]), name
    assert counts == [(f.launches, f.launches_bf16) for f in fns]


# ----------------------------------------------------------------- the entry point


def _mip_argv(data, logs, *extra):
    return ["--expname", "m", "--basedir", str(logs), "--data_path", str(data),
            "--data_type", "llff", "--mipnerf", "--N_samples", "6", "--N_importance", "6",
            "--netdepth", "5", "--netwidth", "16", "--multires", "3", "--multires_views", "2",
            "--N_rand", "24", "--raw_noise_std", "0.5", "--i_print", "1", "--i_weights", "2",
            "--i_testset", "1000", "--ray_chunk", "40", "--compute_dtype", "bfloat16", *extra]


@pytest.mark.parametrize("fused", [True, False])
def test_run_nerf_mipnerf_bf16_trains_evals_and_exports(tmp_path, monkeypatch, fused):
    """``main --mipnerf --compute_dtype bfloat16`` on the CPU: 2 train steps
    (finite losses, every leaf moved), ``--eval`` (finite metrics) and
    ``--eval_vol`` (a finite density) from that checkpoint. Fused: the
    train steps go through K10a and K10b, the renders through K9 and the
    export through K11, every call at bf16 (the wrappers, spied on, run
    their bf16 plain versions here). With --no_fused_field none of them is
    called and the eager field runs flax's bf16 semantics (no ``dense``)."""
    data, logs = tmp_path / "data", tmp_path / "logs"
    write_sphere_scene(str(data), height=6, width=8, n_views=1)
    write_sphere_scene(str(data), height=6, width=8, n_views=2, split="train")
    seen = []
    for mod, name in ((tfr, "fused_mip_render"), (tfr, "mip_train_render"),
                      (tfr, "mip_train_render_grads"), (tff, "fused_mip_field_apply")):
        orig = getattr(mod, name)

        def spy(*a, _orig=orig, _name=name, **kw):
            seen.append((_name, kw.get("compute_dtype", a[-1])))
            return _orig(*a, **kw)
        monkeypatch.setattr(mod, name, spy)
    eager = []
    forward = MipNeRFField.forward
    monkeypatch.setattr(MipNeRFField, "forward", lambda self, *a, dense=None: eager.append(
        (self.mlp.compute_dtype, dense)) or forward(self, *a, dense=dense))
    extra = [] if fused else ["--no_fused_field"]

    def main(*flags):
        args, _ = run_nerf.create_arg_parser().parse_known_args(
            _mip_argv(data, logs, *extra, *flags))
        run_nerf.main(args, device="cpu")

    main("--max_steps", "2", "--vol_extents", "0.2", "--vol_size", "0.05")
    state, step, _ = tckpt.load_checkpoint(str(logs / "m" / "checkpoints" / "last.ckpt"))
    assert step == 2 and all(torch.isfinite(v).all() for v in state.values())
    main("--eval")
    main("--eval_vol", "--vol_extents", "0.2", "--vol_size", "0.05")
    assert (logs / "m" / "eval" / "density.mrc").exists()
    names = {n for n, _ in seen}
    if fused:
        assert names == {"fused_mip_render", "mip_train_render", "mip_train_render_grads",
                         "fused_mip_field_apply"}, names
        assert all(d == BF16 for _, d in seen)
        assert not any(dense is None for _, dense in eager)  # the plain versions' products
    else:
        assert not seen and eager and all(e == (BF16, None) for e in eager)
