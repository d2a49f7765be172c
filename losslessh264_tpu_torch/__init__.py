"""losslessh264_tpu_torch — the H.264 pixel pipeline on PyTorch + CUDA.

A port of the JAX pixel pipeline in `losslessh264_tpu` to PyTorch, for
an NVIDIA H100 (sm_90a). The JAX package stays the reference; this
package mirrors its layout:

  * `ops/`: forward and inverse transforms with (de)quantization, intra
    predictors, quarter-pel MC, deblocking, and the encoder's motion
    estimation (`ops/me.py`). Plain torch, batched over the frame.
  * `csrc/`: ten hand-written CUDA kernels, built at first use by
    `_build.py` (`_build.lib`): K1 the half-pel planes (`halfpel.cu`),
    K2 the deblocking wavefront (`deblock.cu`), K3 the decoder's intra
    reconstruction (`intra_dec.cu`), K4 the encoder's intra wavefront
    (`intra_enc.cu`), K5 the dense motion search (`me_dense.cu`), K6 the
    bucketed motion compensation (`mc_bucket.cu`), K7 the decoder's
    residual reconstruction (`residual_dec.cu`), K8 the encoder's inter
    residual (`residual_enc.cu`), K9 the deblocking edge parameters
    (`deblock_params.cu`) and K11 the per-cell motion compensation
    (`mc_cells.cu`). K10, the quarter-pel half of the encoder's inter
    analysis, is queued. Each wrapper takes its plain torch version for
    a CPU tensor and launches its kernel for a CUDA one. Beside them, a
    host library in plain C++ (`_build.host_lib`): the decoder's nnz and
    MC plans (`plan_host.cpp`) and its symbol parse-ahead thread
    (`sym_ahead.cpp`), built and run on the CPU as well.
  * `decoder_torch.py`: `TorchDecoder`, a per-frame decode loop that turns
    the native symbol planes into YUV frames on one device (all-intra
    runs as one batch).
  * `encoder_torch.py`: `TorchEncoder`, the IPPP encoder on one device.
    Every frame path runs the same device steps: an IDR `_i_frame`; a P
    frame `_p_analyze`, then `_p_intra_fixup` where MBs fell back to
    intra or else `_p_finish`, its symbol rows from `_p_rows` and the
    host tail `_write_p` (P_Skip, the native writer). The fused path
    deblocks inside the steps; the per-MB QP path (aq, gom_rc, bgd)
    after the write, from the writer's QP chain; `encode_frames` chains
    runs of P frames on the device (`_p_batch`) and writes them on a
    writer thread. `processing.py` holds the analyses it uses,
    `encoder_native.py` its binding of the native writer.
  * `__main__.py`: `python -m losslessh264_tpu_torch decode|encode ...`.

The package imports torch and never jax, and nothing of
`losslessh264_tpu`: the shared native library (`native/`) is bound by
its own `native.py`, and what it needs from the JAX package's modules it
keeps as pinned copies (`ref_np.py`, `encoder_native.py`, the copied
helpers of `ops/mc.py` and `decoder_torch.py`), each held to its
original by a test.
"""

__version__ = "0.1.0"
