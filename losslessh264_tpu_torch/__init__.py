"""losslessh264_tpu_torch — the H.264 pixel pipeline on PyTorch + CUDA.

A port of the JAX pixel pipeline in `losslessh264_tpu` to PyTorch, for
an NVIDIA H100 (sm_90a). The JAX package stays the reference; this
package mirrors its layout:

  * `ops/`: forward and inverse transforms with (de)quantization, intra
    predictors, quarter-pel MC, deblocking, and the encoder's motion
    estimation (`ops/me.py`). Plain torch, batched over the frame, with
    six hand-written CUDA kernels under `csrc/`, built at first use by
    `_build.py`: K1 the half-pel planes (`halfpel.cu`), K2 the deblocking
    wavefront (`deblock.cu`), K3 the decoder's intra reconstruction
    (`intra_dec.cu`), K4 the encoder's intra wavefront (`intra_enc.cu`),
    K5 the dense motion search (`me_dense.cu`) and K6 the bucketed
    motion compensation (`mc_bucket.cu`). Each wrapper takes its plain
    torch version for a CPU tensor and launches its kernel for a CUDA
    one.
  * `decoder_torch.py`: `TorchDecoder`, a per-frame decode loop that turns
    the native symbol planes into YUV frames on one device.
  * `encoder_torch.py`: `TorchEncoder`, the IPPP encoder's fused
    analysis path on one device; `processing.py` holds the scene-change
    score it uses, `encoder_native.py` its binding of the native writer.
  * `__main__.py`: `python -m losslessh264_tpu_torch decode|encode ...`.

The package imports torch and never jax, and nothing of
`losslessh264_tpu`: the shared native library (`native/`) is bound by
its own `native.py`, and what it needs from the JAX package's modules it
keeps as pinned copies (`ref_np.py`, `encoder_native.py`, the copied
helpers of `ops/mc.py` and `decoder_torch.py`), each held to its
original by a test.
"""

__version__ = "0.1.0"
