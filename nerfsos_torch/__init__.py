"""nerfsos_torch — the PyTorch/CUDA port of ``nerfsos_tpu`` (NeRF-SOS).

The layout mirrors ``nerfsos_tpu`` so that every module's counterpart sits at
the same path:

- ``core``    : positional encoding, samplers, volumetric compositing (torch).
- ``models``  : ``NeRFMLP`` / ``NeRFField`` / ``NeRFNet`` as ``nn.Module``s with
                the reference's parameter names (a reference ``.ckpt`` loads by
                ``load_state_dict``).
- ``ops``     : the hand-written Hopper kernels behind the eval render
                (``ops/fused_render.py``, sources in ``csrc/``), k-means, SSIM.
- ``losses``  : photometric MSE / PSNR.
- ``engines`` : config parsing, checkpoints, the eval engine.
- ``data``    : the numpy ray datasets read by the eval engine.
- ``utils``   : ARI, PNG writer, colormap (numpy only).

The package imports torch and numpy only; no JAX, and none of sklearn,
imageio, matplotlib or cv2 on the eval path. CUDA kernels are compiled with
``nvcc`` at first use (``_build.py``), never at import.
"""

__version__ = "0.1.0"
