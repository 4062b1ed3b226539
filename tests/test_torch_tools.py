"""The port's measurement tools on the CPU: the SASS spill scan of
``nerfsos_torch/tools/sass_spills.py`` on a hand-written listing (the tool
itself runs ``cuobjdump`` on the card's machine), and ``tile_probe``'s
source patches applied to a copy of the kernels' sources."""
import os
import shutil

import pytest

from nerfsos_torch import _build
from nerfsos_torch.tools import k7_probe, sass_spills, tile_probe

_SASS = """
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   STL [R1], R0 ;
        /*0020*/                   LDL R3, [R1] ;
        /*0030*/                   HGMMA.64x32x8.F32.TF32 R24, R8, gdesc[UR4], R24 ;
        /*0040*/                   LDL R4, [R1+0x4] ;
        /*0050*/              @!P0 BRA 0x20 ;
        /*0060*/                   STL [R1+0x8], R5 ;
        /*0070*/              @!P1 BRA 0x10 ;
        /*0080*/                   EXIT ;
"""


def test_scan_counts_spills_in_the_innermost_wgmma_loop():
    got = sass_spills.scan(_SASS)
    assert got == {"hgmma": 1, "stl": 2, "ldl": 2, "wgmma_loops": 1,
                   "stl_in_wgmma_loops": 0, "ldl_in_wgmma_loops": 2}


def test_scan_without_wgmma_has_no_loops():
    got = sass_spills.scan(_SASS.replace("HGMMA.64x32x8.F32.TF32", "FFMA"))
    assert got["hgmma"] == 0 and got["wgmma_loops"] == 0 and got["ldl_in_wgmma_loops"] == 0


def test_inner_loop_counts_the_cheapest_innermost_loop_with_a_reciprocal():
    """K7's pair loop: of the innermost loops holding a MUFU, the one with
    the fewest instructions a MUFU (a kernel's fast copy of its loop, not
    the guarded one with its slow-path call), NOPs left out; the loop
    around them is not counted."""
    sass = """
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   MUFU.RCP R2, R3 ;
        /*0020*/                   FFMA R4, R2, R3, R4 ;
        /*0030*/                   NOP ;
        /*0040*/               @P0 BRA 0x10 ;
        /*0050*/                   MUFU.RCP R5, R6 ;
        /*0060*/                   FADD R5, R5, R6 ;
        /*0070*/                   FADD R5, R5, R6 ;
        /*0080*/                   CALL.REL.NOINC 0x100 ;
        /*0090*/               @P1 BRA 0x50 ;
        /*00a0*/               @P2 BRA 0x0 ;
        /*00b0*/                   EXIT ;
"""
    assert sass_spills.inner_loop(sass) == {"insns": 3, "mufu": 1}
    assert sass_spills.inner_loop(sass.replace("MUFU.RCP", "FMUL")) == {"insns": 0, "mufu": 0}


@pytest.mark.parametrize("variant", ["ieeercp", "frcp", "ieeercp+frcp", "sgnmul", "rows4",
                                     "cols32", "cols128"])
def test_k7_probe_patches_apply_to_the_source(variant):
    """Each of ``nerfsos_torch/tools/k7_probe.py``'s variants finds the text
    it patches in this checkout's ``csrc/flash_corr.cu`` (a patch that no
    longer matches raises) and changes it."""
    with open(os.path.join(_build.CSRC_DIR, "flash_corr.cu")) as f:
        src = f.read()
    assert k7_probe.patch(src, variant) != src


@pytest.mark.parametrize("variant", ["fwdonly", "sweepclock", "wgclock", "semclock",
                                     "bwdstages6", "nostore", "nocomposite", "epistore",
                                     "fwdonly+nostore", "sweepclock+revpoints64"])
def test_tile_probe_patches_apply_to_the_sources(tmp_path, variant):
    """Each of ``nerfsos_torch/tools/tile_probe.py``'s variants finds the
    text it patches in this checkout's ``csrc/`` (a patch that no longer
    matches its source raises) and changes it; ``revpoints`` patches no
    source."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc)
    tile_probe._patch(tile_probe._sources(variant), str(csrc))
    changed = [f.name for f in sorted(csrc.iterdir())
               if f.read_text() != open(os.path.join(_build.CSRC_DIR, f.name)).read()]
    assert changed, variant
    if "sweepclock" in variant:
        text = (csrc / "train_sweep.cuh").read_text()
        assert all(f"PROBE_ADD({i}, " in text for i in range(11))


def test_tile_probe_wgclock_counts_the_mip_mode(tmp_path):
    """``wgclock``'s tile-loop counter lands in ``train_render_wg_kernel``,
    one template over its input modes, so ``--kernel k9`` and ``k10a`` (its
    mip mode) are counted as K4 is; its ring-wait and k-loop counters in
    ``wg_tile.cuh``'s one layer function."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc)
    tile_probe._patch("wgclock", str(csrc))
    kern = (csrc / "train_render.cu").read_text()
    body = kern[kern.index("    train_render_wg_kernel("):]
    body = body[:body.index("\n}\n")]
    assert "composite_chunk<kForward, kMip" in body
    assert body.count("PROBE_ADD(0, p_start);") == 1 and "p_start = clock64();" in body
    tile = (csrc / "wg_tile.cuh").read_text()
    assert all(f"PROBE_ADD({i}, " in tile for i in (1, 3, 4, 5))


@pytest.mark.parametrize("variant", ["l1", "l1clock"])
def test_tile_probe_rejects_the_old_tiles_variants(tmp_path, variant):
    """Variants of a retired design (``l1``, ``l1clock``) are not kept for
    sources that no longer have their targets: asking for one raises rather
    than timing an unpatched build."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc)
    with pytest.raises(ValueError, match="unknown variant"):
        tile_probe._patch(variant, str(csrc))


def test_tile_probe_wgclock_counts_the_field_forwards(tmp_path):
    """``wgclock`` also counts the field forwards' tile loop
    (``field_wg_kernel`` in ``csrc/fused_field.cu``, a translation unit of
    its own, read by ``probe_read_field``), the field backward's forward's
    (``field_bwd_forward_kernel``, before the consumers' copy of g), and
    the point-list modes' copy-out in ``wg_tile.cuh``; K10b's forward is
    ``train_forward_wg_kernel``, whose tile loop the K3/K6 counter already
    covers."""
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, csrc)
    tile_probe._patch("wgclock", str(csrc))
    field = (csrc / "fused_field.cu").read_text()
    body = field[field.index("    field_wg_kernel("):]
    body = body[:body.index("\n}\n")]
    assert body.count("PROBE_ADD(0, p_start);") == 1 and "p_start = clock64();" in body
    bwd = field[field.index("    field_bwd_forward_kernel("):]
    bwd = bwd[:bwd.index("\n}\n")]
    assert bwd.count("PROBE_ADD(0, p_start);") == 1 and bwd.index("p_start = clock64();") < \
        bwd.index("PROBE_ADD(0, p_start);") < bwd.index("bar.sync 3")
    assert 'extern "C" int probe_read_field(' in field
    tile = (csrc / "wg_tile.cuh").read_text()
    assert "PROBE_ADD(6, p_o);" in tile and "long long p_o = clock64();" in tile
    kern = (csrc / "train_render.cu").read_text()
    fwd = kern[kern.index("    train_forward_wg_kernel("):]
    fwd = fwd[:fwd.index("\n}\n")]
    assert "PROBE_ADD(0, p_start);" in fwd and "composite_chunk<kMode, kMip" in fwd


@pytest.mark.parametrize("kernel", ["k8b", "k8a", "k11", "k10b", "k9", "k4", "k1", "k8f", "k8c"])
def test_tile_probe_takes_the_tile_kernels(kernel):
    """``--kernel`` takes every kernel that runs K4's tile, the field
    forwards, K10b and the field backward (its forward) among them, with
    the rays, samples and variants."""
    a = tile_probe.parser().parse_args(["--kernel", kernel, "--rays", "4096", "--samples",
                                        "64,32", "--variants", "base,wgclock"])
    assert (a.kernel, a.rays, a.samples, a.variants) == (kernel, 4096, "64,32", "base,wgclock")


@pytest.mark.parametrize("kernel", ["k7", "k8"])
def test_tile_probe_rejects_kernels_off_the_tile(kernel, capsys):
    """Kernels that run no part of K4's tile (K7) and names of no one
    kernel (K8 without its letter) are refused by the argument parser."""
    with pytest.raises(SystemExit):
        tile_probe.parser().parse_args(["--kernel", kernel])
