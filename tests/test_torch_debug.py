"""``--debug_nans`` in the port (CPU): the host checks of
``nerfsos_torch/utils/debug.py`` and ``run_nerf.main`` under the flag, which
stops on a nan loss and runs clean without one."""
import numpy as np
import pytest
import torch

from nerfsos_torch import run_nerf
from nerfsos_torch.data.synthetic import write_sphere_scene
from nerfsos_torch.utils import debug

FLAGS = ["--data_type", "llff", "--N_samples", "4", "--N_importance", "4",
         "--netdepth", "2", "--netwidth", "16", "--netdepth_fine", "2",
         "--netwidth_fine", "16", "--multires", "2", "--multires_views", "2",
         "--N_rand", "32", "--raw_noise_std", "0.5", "--i_print", "1",
         "--i_weights", "100", "--ray_chunk", "64", "--fast_mode", "--max_steps", "2"]


def test_assert_finite_names_the_leaf():
    ok = {"a": torch.ones(3), "b": [torch.zeros(2), (torch.tensor(1.0), None)]}
    debug.assert_finite(ok, "ok")
    debug.assert_finite(torch.ones(2, 2))
    bad = {"a": torch.ones(3), "b": [torch.zeros(2), (torch.tensor([1.0, np.inf]),)]}
    with pytest.raises(FloatingPointError, match=r"grads\['b'\]\[1\]\[0\] has nan/inf"):
        debug.assert_finite(bad, "grads")
    with pytest.raises(FloatingPointError, match="loss has nan/inf"):
        debug.assert_finite(torch.tensor(float("nan")), "loss")


def test_checks_print_a_line_per_tensor(capsys):
    debug.check(x=torch.tensor([1.0, float("nan")]), y=torch.ones(2))
    debug.check_zero(z=torch.tensor([0.0, 1.0]))
    debug.check_all_zero(z=torch.zeros(2))
    out = capsys.readouterr().out.splitlines()
    assert out == ["! [Numerical] x: nan/inf=True", "! [Numerical] y: nan/inf=False",
                   "! [Numerical] z: any_zero=True", "! [Numerical] z: all_zero=True"]


def _run(tmp_path, nan: bool, *extra):
    data = tmp_path / "data"
    write_sphere_scene(str(data), 6, 8, n_views=1, split="test")
    write_sphere_scene(str(data), 6, 8, n_views=2, split="train")
    if nan:  # every train pixel's ground truth: the first step's loss is nan
        rgbs = np.load(data / "rgbs_train.npy")
        np.save(data / "rgbs_train.npy", np.full_like(rgbs, np.nan))
    args, _ = run_nerf.create_arg_parser().parse_known_args(
        ["--expname", "dbg", "--basedir", str(tmp_path / "logs"), "--data_path", str(data),
         *FLAGS, *extra])
    run_nerf.main(args, device="cpu")


@pytest.mark.parametrize("extra", [(), ("--no_fused_field",)])
def test_debug_nans_stops_on_a_nan_loss(tmp_path, capsys, extra):
    """The fused step (gradients outside autograd) and the autograd step."""
    with pytest.raises((FloatingPointError, RuntimeError)):
        _run(tmp_path, True, "--debug_nans", *extra)
    assert "anomaly detection" in capsys.readouterr().out
    assert not torch.is_anomaly_enabled()


def test_debug_nans_runs_clean_without_a_nan(tmp_path):
    _run(tmp_path, False, "--debug_nans")
    assert not torch.is_anomaly_enabled()
    assert (tmp_path / "logs" / "dbg" / "checkpoints" / "last.ckpt").exists()


def test_without_the_flag_a_nan_loss_trains_on(tmp_path):
    _run(tmp_path, True)
    assert (tmp_path / "logs" / "dbg" / "checkpoints" / "last.ckpt").exists()
