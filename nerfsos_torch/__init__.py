"""nerfsos_torch — the PyTorch/CUDA port of ``nerfsos_tpu`` (NeRF-SOS).

The layout mirrors ``nerfsos_tpu`` so that every module's counterpart sits at
the same path:

- ``core``    : positional encoding, samplers, volumetric compositing (torch).
- ``models``  : ``NeRFMLP`` / ``NeRFField`` / ``NeRFNet`` as ``nn.Module``s with
                the reference's parameter names (a reference ``.ckpt`` loads by
                ``load_state_dict``), DINO ViT-S/16 and its extractor.
- ``ops``     : the hand-written Hopper kernels (sources in ``csrc/``) behind
                the eval render, the RGB train step, the SOS finetune,
                mip-NeRF and the point-wise field queries
                (``ops/fused_render.py`` K1-K6, K9, K10; ``ops/flash_corr.py``
                K7; ``ops/fused_field.py`` K8a-K8f, K11), grid sampling,
                k-means, SSIM.
- ``losses``  : photometric MSE / PSNR, the appearance and geometry
                correlation losses, the contrastive loss.
- ``engines`` : config parsing, checkpoints, Adam and the LR schedule, the
                RGB and SOS train steps, the eval engine and the density
                export.
- ``data``    : the numpy ray and patch datasets.
- ``utils``   : ARI, PNG, MRC and PLY writers, colormap (numpy only).

The package imports torch and numpy only; no JAX, and none of sklearn,
imageio, matplotlib or cv2 on the eval path. CUDA kernels are compiled with
``nvcc`` at first use (``_build.py``), never at import.
"""

__version__ = "0.1.0"
