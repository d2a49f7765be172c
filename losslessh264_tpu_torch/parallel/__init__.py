"""GOP-level parallelism of the torch port (port of
losslessh264_tpu/parallel/).

GOPs share no decoder, model or arithmetic state: an IDR resets the
DPB, and each shard's compressor absorbs the SPS/PPS as context. So

- the pixel decode runs one TorchDecoder per GOP segment on host
  threads, each on its own CUDA stream (decode.py);
- GOP-sharded compression splits the native engine's shard plan across
  processes by a strided assignment, exchanges the payloads with a
  torch.distributed all-gather, and assembles the container that one
  host's `native.compress_sharded` writes, byte for byte (gop.py).
"""
from .decode import decode_yuv_gop_parallel
from .gop import (assemble, compress_distributed, compress_multihost,
                  shard_assignment)

__all__ = [
    "assemble",
    "compress_distributed",
    "compress_multihost",
    "shard_assignment",
    "decode_yuv_gop_parallel",
]
