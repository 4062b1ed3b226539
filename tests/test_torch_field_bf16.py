"""The classic field kernels at ``--compute_dtype bfloat16`` on the CPU: the
bf16 plain versions of K8a/K8e, K8b, K8d, K8f and K8c
(``nerfsos_torch/ops/fused_field.py``) against the JAX Pallas kernels at
bf16 (interpret mode), a ``--N_importance 0`` render and train step and the
classic ``export_density`` against JAX's at bf16, two planted faults
refused (each field forward's head rule held to the other twin, the
backward with its cotangent unrounded), and ``run_nerf.main`` at bf16 with
``--N_importance 0`` and ``--eval_vol`` through the wrappers.

At bf16 the field forward's twins differ (measured 2e-3 to 4e-3 on the rgb
logits and semantics here): the row-major K8b (``_field_kernel``) keeps the
heads' hidden activations ``s`` and ``hv`` in float32 before sem_1 and rgb,
the planar K8d (``_field_kernel_pl``) rounds them, so the port's field
forward takes the rule as ``f32_heads``. Both backwards round the cotangent
``g`` to bf16 before anything reads it, their bias sums included.

The plain versions and the Pallas kernels round the same operands to bf16
and sum in float32 in other orders, so they differ by float32 summation
order alone (KERNEL_TOL), but for a point where a value lay within that
rounding of a bf16 rounding boundary and rounded the other way (a flip: one
row of a call may lie beyond KERNEL_TOL, within FLIP_TOL, as
test_torch_bf16.py's ``_assert_bf16_close`` allows; the backward is held on
the points without one, as points are independent in every gradient sum).
The CUDA kernels' bf16 modes run on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""
import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfsos_torch import run_nerf
from nerfsos_torch.data.synthetic import write_sphere_scene
from nerfsos_torch.engines import checkpoint as tckpt
from nerfsos_torch.engines import eval as teval
from nerfsos_torch.engines import trainer as ttrainer
from nerfsos_torch.models.nerf import NeRFConfig as TorchConfig
from nerfsos_torch.models.nerf import NeRFNet as TorchNet
from nerfsos_torch.ops import fused_field as tff
from nerfsos_tpu.engines import eval as jeval
from nerfsos_tpu.engines import trainer as jtrainer
from nerfsos_tpu.models.nerf import NeRFConfig as JaxConfig
from nerfsos_tpu.models.nerf import NeRFNet as JaxNet
from nerfsos_tpu.ops.pallas import fused_field as jff
from test_torch_bf16 import FLIP_TOL, KERNEL_TOL, _assert_bf16_close, _jax_params, _np

BF16 = torch.bfloat16
# depth 6 (the skip after layer 4 feeds layer 5), the flagship's multires
FIELD = dict(netdepth=6, netwidth=32, netdepth_fine=6, netwidth_fine=32, n_samples=9,
             n_importance=0, multires=10, multires_views=4, sem_dim=2)
SEM = [(True, True), (False, False)]  # (use_semantics, sem_with_coord)
N = 200  # points of a kernel call


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for torch in this module's tests (the count found
    is restored after): the tier-1 run's pytest workers share the machine's
    cores, and with the JAX runtime loaded torch's CPU ``sin`` on its
    worker threads now and then lands 1.5e-4 off at the PE's 2^9 phases."""
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def _pair(sem=True, coord=True, **over):
    """A JAX NeRFNet at bf16 (fused) with seeded params, and the port's twin
    holding them."""
    kw = {**FIELD, "use_semantics": sem, "sem_with_coord": coord, **over}
    cfg = JaxConfig(**kw, fused_field=True, compute_dtype="bfloat16")
    params = _jax_params(JaxNet(cfg), 3)
    tnet = TorchNet(TorchConfig(**kw, fused_field=True, compute_dtype="bfloat16")).eval()
    tnet.load_state_dict(tckpt.state_dict_from_jax_params(_np(params)))
    return cfg, params, tnet


def _points(n: int, seed: int):
    """Points of norm ~1.4 and unit directions ``[n, 3]`` (float32)."""
    rng = np.random.default_rng(seed)
    pts = (rng.normal(size=(n, 3)) * 0.8).astype(np.float32)
    d = rng.normal(size=(n, 3))
    return pts, (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _planar(params, pts, dirs, cfg):
    """JAX's planar field forward (K8d) at ``cfg``'s dtype -> raw [n, C]."""
    pd = jnp.asarray(np.concatenate([pts.T, dirs.T], 0))
    return np.asarray(jff.fused_field_apply_planar(params["coarse"], pd, cfg)).T


def _flipped_rows(got, want) -> np.ndarray:
    """Rows of got beyond KERNEL_TOL of want: at most one, within FLIP_TOL."""
    err = np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32)).reshape(
        len(want), -1).max(1)
    rows = np.flatnonzero(err > KERNEL_TOL)
    assert len(rows) <= 1 and err.max() <= FLIP_TOL, err
    return rows


def _jax_grads(tree) -> dict:
    """JAX's ``{'mlp': ...}`` gradients -> the port's parameter names of one field."""
    return {k[len("nerf."):]: torch.from_numpy(np.array(v))
            for k, v in tckpt.state_dict_from_jax_params({"coarse": _np(tree)}).items()}


def _worst_leaf(got: dict, want: dict) -> float:
    """The worst leaf's largest |got - want| over its largest |want|."""
    assert set(got) == set(want)
    return max(float((got[k] - w).abs().max()) / (float(w.abs().max()) + 1e-30)
               for k, w in want.items())


# ----------------------------------------------------------------- the kernels


@pytest.mark.parametrize("sem,coord", SEM)
def test_forwards_match_pallas_at_bf16(sem, coord):
    """The bf16 plain versions of the sigma forward (K8a/K8e) and of the
    field forward under K8b's and K8d's head rules vs ``fused_sigma_apply``,
    ``fused_sigma_apply_planar``, ``fused_field_apply`` and
    ``fused_field_apply_planar`` at bf16 (through the wrappers, on the
    CPU), each row to KERNEL_TOL but for a flip, and far from the float32
    versions; sigma is the same in both rules. Negative control: each rule
    held to the other twin misses KERNEL_TOL by orders of magnitude."""
    cfg, params, tnet = _pair(sem, coord)
    pts, dirs = _points(300, 1)
    tp, td = _t(pts, dirs)
    field = tnet.nerf
    with torch.no_grad():
        k8b = tff.field_forward(field, tp, td, BF16, f32_heads=True)
        k8d = tff.field_forward(field, tp, td, BF16)
        sig = tff.fused_sigma_apply(field, tp, BF16)
        raw32, sig32 = tff.field_forward(field, tp, td), tff.fused_sigma_apply(field, tp)
    jb = np.asarray(jff.fused_field_apply(params["coarse"], jnp.asarray(pts)[:, None],
                                          jnp.asarray(dirs), cfg))[:, 0]
    jd = _planar(params, pts, dirs, cfg)
    ja = np.asarray(jff.fused_sigma_apply(params["coarse"], jnp.asarray(pts), cfg))[:, 0]
    je = np.asarray(jff.fused_sigma_apply_planar(params["coarse"], jnp.asarray(pts.T), cfg))
    assert k8b.shape == k8d.shape == (300, 4 + 2 * sem) and sig.shape == (300,)
    _assert_bf16_close(k8b, jb, raw32)
    _assert_bf16_close(k8d, jd, raw32)
    _assert_bf16_close(sig, ja, sig32)
    _assert_bf16_close(sig, je, sig32)
    assert torch.equal(k8b[:, 3], k8d[:, 3]) and torch.equal(k8d[:, 3], sig)
    for got, other in ((k8b, jd), (k8d, jb)):  # the swapped head rule
        assert float(np.abs(got.numpy() - other).max()) > 100 * KERNEL_TOL


@pytest.mark.parametrize("sem,coord", SEM[:1])
def test_backward_matches_pallas_at_bf16(sem, coord, monkeypatch):
    """The field backward's bf16 plain version through ``_FieldFn`` (the
    autograd route): without the inputs' gradients vs ``jax.vjp`` of
    ``fused_field_apply_planar`` at bf16 (K8f), with them vs ``jax.vjp`` of
    ``fused_field_apply`` with ``field_input_grads`` (K8c): every leaf and
    dpts/ddirs to KERNEL_TOL of its max, on the points whose forward row
    did not flip (the forward both backwards recompute is K8d's). Negative
    control: the backward with ``g`` left unrounded misses that bound. With
    the semantic head and its coordinates alone: the sweep without the head
    is K3's, held at bf16 in tests/test_torch_bf16_train.py."""
    cfg, params, tnet = _pair(sem, coord)
    pts, dirs = _points(N, 4)
    g = np.random.default_rng(5).normal(size=(N, 4 + 2 * sem)).astype(np.float32)
    field = tnet.nerf
    with torch.no_grad():
        k8d = tff.field_forward(field, *_t(pts, dirs), BF16)
    keep = np.setdiff1d(np.arange(N), _flipped_rows(k8d, _planar(params, pts, dirs, cfg)))
    pts, dirs, g = pts[keep], dirs[keep], g[keep]

    def port(input_grads: bool):
        p, d, gt = _t(pts, dirs, g)
        p.requires_grad_(input_grads)
        d.requires_grad_(input_grads)
        field.zero_grad(set_to_none=True)
        torch.sum(tff.fused_field_apply(field, p, d, BF16) * gt).backward()
        got = {n: q.grad.clone() for n, q in field.named_parameters()}
        return got, p.grad, d.grad

    pd = jnp.asarray(np.concatenate([pts.T, dirs.T], 0))
    _, vjp = jax.vjp(lambda q: jff.fused_field_apply_planar(q, pd, cfg), params["coarse"])
    want_f = _jax_grads(vjp(jnp.asarray(g.T))[0])
    got_f, _, _ = port(False)
    assert _worst_leaf(got_f, want_f) <= KERNEL_TOL

    cfg_in = dataclasses.replace(cfg, field_input_grads=True)
    _, vjp = jax.vjp(lambda q, x, d: jff.fused_field_apply(q, x[:, None], d, cfg_in)[:, 0],
                     params["coarse"], jnp.asarray(pts), jnp.asarray(dirs))
    jg, jdp, jdd = vjp(jnp.asarray(g))
    got_c, dp, dd = port(True)
    assert _worst_leaf(got_c, _jax_grads(jg)) <= KERNEL_TOL
    for got, want in ((dp, jdp), (dd, jdd)):
        want = torch.from_numpy(np.array(want))
        assert float((got - want).abs().max()) <= KERNEL_TOL * float(want.abs().max())

    monkeypatch.setattr(tff, "round_bf16", lambda x: x)  # the fault: g left unrounded
    assert _worst_leaf(port(False)[0], want_f) > 10 * KERNEL_TOL


# ----------------------------------------------------------------- the paths


def _rays(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    rays = rng.normal(size=(2, n, 3)).astype(np.float32)
    rays[0] *= 0.3
    return rays


# near 1 and far 3 at 9 samples: the stratified z (perturb 0) are dyadic and
# exact on both sides, so both packages query the same points (the z a
# float32 ulp apart elsewhere move the PE's 2^9 phases by ~1e-4 rad, which
# flips bf16 roundings of the PE at many points)
BOUNDS = (1.0, 3.0)


def test_noimp_render_and_step_match_jax_at_bf16():
    """A fused bf16 net with no fine pass (``n_importance`` 0, perturb 0, no
    noise): the port's render (K8d's plain version) against JAX's fused net
    at bf16 (K8d, interpret mode), each map's rows to KERNEL_TOL of max(1,
    |JAX|) but for a flipped ray; then one RGB step's gradients on the rays
    without it (the port's autograd step through ``_FieldFn``, K8f's plain
    version) against ``jax.grad`` of JAX's step (K8d/K8f), every leaf to
    KERNEL_TOL of its max."""
    cfg, params, tnet = _pair(perturb=0.0, raw_noise_std=0.0)
    rays = _rays(24, 9)
    jnet = JaxNet(cfg)
    want = jnet(params, jnp.asarray(rays), BOUNDS, train=False)
    with torch.no_grad():
        got = tnet(torch.from_numpy(rays), BOUNDS, train=False)
    assert set(got) == set(want)
    flipped = set()
    for k in want:
        w = np.asarray(want[k])
        assert got[k].shape == w.shape, k
        flipped |= set(_flipped_rows(got[k].numpy() / max(1.0, np.abs(w).max()),
                                     w / max(1.0, np.abs(w).max())))
    assert len(flipped) <= 1
    keep = np.setdiff1d(np.arange(rays.shape[1]), sorted(flipped))
    batch = {"rays": rays[:, keep],
             "target": np.random.default_rng(10).uniform(0, 1, (len(keep), 3))
             .astype(np.float32)}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss(p):
        return jtrainer.rgb_loss_fn(jnet, p, jbatch, jax.random.PRNGKey(0), *BOUNDS)[0]

    jgrads = tckpt.state_dict_from_jax_params(_np(jax.grad(loss)(params)))
    assert not ttrainer.supports_fused_rgb_loss(tnet)
    tloss, _ = ttrainer.rgb_loss_fn(tnet, {k: torch.from_numpy(v) for k, v in batch.items()},
                                    *BOUNDS)
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(loss(params)), rtol=1e-5)
    got = {n: p.grad for n, p in tnet.named_parameters()}
    assert _worst_leaf(got, {k: torch.from_numpy(np.array(v)) for k, v in jgrads.items()}
                       ) <= KERNEL_TOL


def test_classic_export_density_matches_jax_at_bf16(tmp_path):
    """``export_density`` of a fused bf16 net with a fine pass (the fine
    field through ``field_query``: K8b's rule, as JAX's export takes the
    row-major ``fused_field_apply``) on the ``--vol_extents 0.2 --vol_size
    0.02`` grid (10^3 points, x14) against JAX's at bf16: each voxel to
    KERNEL_TOL of max(1, its max) but for a flipped one, far from the
    float32 export."""
    cfg, params, tnet = _pair(netdepth=2, netdepth_fine=3, n_importance=4)
    jnet = JaxNet(cfg)
    kw = dict(extents=(0.2, 0.2, 0.2), voxel_size=0.02)
    want = jeval.export_density(jnet, params, chunk=256, **kw)
    got = teval.export_density(tnet, chunk=300, **kw)
    tnet32 = TorchNet(dataclasses.replace(tnet.cfg, compute_dtype="float32")).eval()
    tnet32.load_state_dict(tnet.state_dict())
    got32 = teval.export_density(tnet32, chunk=300, **kw)
    assert got.shape == want.shape == (10, 10, 10)
    scale = max(1.0, float(np.abs(want).max()))
    _assert_bf16_close(got.reshape(-1, 1) / scale, np.asarray(want).reshape(-1, 1) / scale,
                       got32.reshape(-1, 1) / scale)


def _argv(data, logs, *extra):
    return ["--expname", "n", "--basedir", str(logs), "--data_path", str(data),
            "--data_type", "llff", "--N_samples", "6", "--N_importance", "0",
            "--netdepth", "5", "--netwidth", "16", "--multires", "3", "--multires_views", "2",
            "--N_rand", "24", "--raw_noise_std", "0.5", "--i_print", "1", "--i_weights", "2",
            "--i_testset", "1000", "--ray_chunk", "40", "--compute_dtype", "bfloat16", *extra]


def _spy(monkeypatch):
    """Every call of the field wrappers as (name, compute_dtype, f32_heads)."""
    seen = []
    for name in ("field_forward", "field_grads", "fused_sigma_apply"):
        orig = getattr(tff, name)

        def spy(*a, _orig=orig, _name=name, **kw):
            bound = inspect.signature(_orig).bind(*a, **kw)
            bound.apply_defaults()
            seen.append((_name, bound.arguments["compute_dtype"],
                         bound.arguments.get("f32_heads", False)))
            return _orig(*a, **kw)
        monkeypatch.setattr(tff, name, spy)
    return seen


def test_run_nerf_noimp_bf16_trains_evals_and_exports(tmp_path, monkeypatch):
    """``main --N_importance 0 --compute_dtype bfloat16`` on the CPU: 2
    train steps through the field forward and backward (K8d, K8f; finite
    checkpoint, every leaf moved), ``--eval`` through the field forward,
    then ``--eval_vol`` with a fine pass (the classic export through K8b's
    rule); every wrapper call at bf16 (the wrappers, spied on, run their
    bf16 plain versions here)."""
    data, logs = tmp_path / "data", tmp_path / "logs"
    write_sphere_scene(str(data), height=6, width=8, n_views=1)
    write_sphere_scene(str(data), height=6, width=8, n_views=2, split="train")
    seen = _spy(monkeypatch)

    def main(*flags):
        args, _ = run_nerf.create_arg_parser().parse_known_args(_argv(data, logs, *flags))
        run_nerf.main(args, device="cpu")

    main("--max_steps", "2")
    state, step, _ = tckpt.load_checkpoint(str(logs / "n" / "checkpoints" / "last.ckpt"))
    assert step == 2 and all(torch.isfinite(v).all() for v in state.values())
    init = TorchNet(run_nerf.model_config(run_nerf.create_arg_parser().parse_known_args(
        _argv(data, logs))[0])).state_dict()
    assert all(not torch.equal(state[k], init[k]) for k in init if "weight" in k)
    assert {n for n, _, _ in seen} == {"field_forward", "field_grads"}
    main("--eval")
    assert (logs / "n" / "eval").exists()
    seen_eval = len(seen)
    main("--eval_vol", "--N_importance", "4", "--expname", "v", "--vol_extents", "0.2",
         "--vol_size", "0.05")
    assert (logs / "v" / "eval" / "density.mrc").exists()
    assert seen[seen_eval:] and all(s == ("field_forward", BF16, True) for s in seen[seen_eval:])
    assert all(cd == BF16 for _, cd, _ in seen)
    assert all(not heads for _, _, heads in seen[:seen_eval])


def test_noisy_density_only_view_runs_the_field_kernels_at_bf16(monkeypatch):
    """A fused bf16 net's noisy density-only view (an eval render with
    ``raw_noise_std`` > 0: the coarse densities through the sigma forward
    K8e, the fine pass through the field forward K8d) calls both wrappers
    at bf16 (their plain versions here) and renders finite maps; the same
    noise draw through a float32 net lands elsewhere."""
    _, _, tnet = _pair(n_importance=4)
    seen = _spy(monkeypatch)
    rays = torch.from_numpy(_rays(16, 3))
    with torch.no_grad():
        out = tnet(rays, BOUNDS, coarse_outputs=False, raw_noise_std=1.0,
                   generator=torch.Generator().manual_seed(0))
        tnet32 = TorchNet(dataclasses.replace(tnet.cfg, compute_dtype="float32")).eval()
        tnet32.load_state_dict(tnet.state_dict())
        out32 = tnet32(rays, BOUNDS, coarse_outputs=False, raw_noise_std=1.0,
                       generator=torch.Generator().manual_seed(0))
    assert [(n, cd) for n, cd, _ in seen[:2]] == [("fused_sigma_apply", BF16),
                                                  ("field_forward", BF16)]
    assert all(torch.isfinite(v).all() for v in out.values())
    assert float((out["rgb"] - out32["rgb"]).abs().max()) > 100 * KERNEL_TOL
