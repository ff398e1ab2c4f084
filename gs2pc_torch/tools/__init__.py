"""The port's diagnostics and quality tools, counterparts of the JAX
package's ``tools/*.py``:

  cuda_probe       K3 (the nine ops of tools/pallas_probe.py) vs its twin
  cuda_probe2      K4 (the blend levels of tools/pallas_probe2.py) vs its twin
  validate_psnr    tile renderer vs the dense oracle, per camera
  ablate_psnr      the production knob matrix vs a cached banded oracle
  diff_map         where the tile render differs from the cached oracle
  bench_breakdown  per-stage card times of one camera and of the sweep
  render_preview   preview images and depth maps of each camera, as PNG
  convert_format   .ply <-> .splat (host numpy)
  pixel_forensics  float64 per-pixel blend truth against tile and oracle images

Run each as ``python -m gs2pc_torch.tools.<name> [--device cuda:0]``.
Every tool that renders takes ``--device`` (default ``cuda:0``) and never
moves to the CPU by itself: ``--device cpu`` runs the kernels' twins.
"""
