"""losslessh264_tpu_torch — the H.264 pixel-decode path on PyTorch + CUDA.

A port of the JAX pixel pipeline in `losslessh264_tpu` to PyTorch, for
an NVIDIA H100 (sm_90a). The JAX package stays the reference; this
package mirrors its layout:

  * `ops/`: dequant + inverse transforms, intra predictors, quarter-pel
    MC, deblocking. Plain torch, batched over the frame, with two
    hand-written CUDA kernels under `csrc/` (half-pel planes and the
    deblocking wavefront), built at first use by `_build.py`.
  * `decoder_torch.py`: `TorchDecoder`, a per-frame decode loop that turns
    the native symbol planes into YUV frames on one device.
  * `__main__.py`: `python -m losslessh264_tpu_torch decode in.264 out.yuv`.

The framework-free modules of the JAX package (`native`, `decoder_np`)
are reused by import. This package imports torch and never jax.
"""

__version__ = "0.1.0"
