"""The torch port's decoder (losslessh264_tpu_torch/decoder_torch.py) is
frame-exact on the CPU stage by stage against the JAX stages
(recon_pre, intra_pass, deblock_pass) fed the SAME numpy frame state
(plane dict and reference rings), on real frames of walk_analog and of a
tiny stream of translating noise (test_torch_decoder.tiny_stream_bytes).

JAX reaches the Pallas half-pel kernel on every P frame, so the module
attribute losslessh264_tpu.ops.mc.halfpel_planes_pallas is swapped for
its plain twin halfpel_planes (the plain_pallas fixture)."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from losslessh264_tpu import decoder_jax
from losslessh264_tpu_torch import decoder_torch as dt
from losslessh264_tpu_torch import native as tnative

from test_torch_decoder import _read, plain_pallas, tiny_stream  # noqa: F401

# the shared native library, built once under the port's lock, and one
# torch thread per worker (see tests/test_torch_decoder.py)
tnative.load()
torch.set_num_threads(1)


def _eq(got, want, what):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                  err_msg=what)


def _stage_parity(data, n_frames):
    """Per frame: the port's stages and the JAX stages on the same numpy
    plane dict and the same numpy reference rings. Returns the set of
    (has_intra, mc_fast, mc_any) the frames covered."""
    dec = dt.TorchDecoder(data, device="cpu")
    covered = set()
    for i, f in enumerate(dec.sym):
        if i == n_frames:
            break
        mb_w, mb_h = f["mb_w"], f["mb_h"]
        dec._prep_refs(mb_w, mb_h)
        planes_np, has_intra = dec._prep_planes(f)
        covered.add((has_intra, bool(planes_np["mc_fast"]),
                     bool(planes_np["mc_any"])))
        ring = [r.numpy().copy() for r in (dec.ref_y, dec.ref_u, dec.ref_v)]
        jp = jax.device_put(planes_np)
        jout = decoder_jax.recon_pre(mb_w, mb_h, jp,
                                     *[jnp.asarray(r) for r in ring])
        p = dt.planes_to_torch(planes_np, "cpu")
        tout = dt._residual_and_inter(
            mb_w, mb_h, p, *[dt.ring_to_torch(r, "cpu") for r in ring])
        for g, w, name in zip(tout, jout, ("Yw", "Uw", "Vw", "res_y",
                                           "res_u", "res_v")):
            _eq(g, w, f"frame {i} residual_and_inter {name}")
        jw, tw = jout[:3], tout[:3]
        if has_intra:
            diags = dt.diagonals(mb_w, mb_h)
            jw = decoder_jax.intra_pass(mb_w, mb_h, *jout, jp,
                                        jnp.asarray(diags))
            tw = dt._intra_scan(mb_w, mb_h, *tout, p, diags)
            for g, w, name in zip(tw, jw, "YUV"):
                _eq(g, w, f"frame {i} intra {name}")
        jyuv = decoder_jax.deblock_pass(mb_w, mb_h, *jw, jp)
        tyuv = dt._deblock_crop(mb_w, mb_h, *tw, p)
        for g, w, name in zip(tyuv, jyuv, "YUV"):
            _eq(g, w, f"frame {i} deblock {name}")
        dec._finish_frame(f, *tyuv, False)
    return covered


def test_stages_tiny_stream(plain_pallas, tiny_stream):
    covered = _stage_parity(tiny_stream, 6)
    assert (True, False, False) in covered      # I frame
    assert any(c[1] for c in covered)            # bucketed MC


def test_stages_walk_analog(plain_pallas):
    covered = _stage_parity(_read("walk_analog.264"), 2)
    assert (True, False, False) in covered
    assert any(c[2] and not c[1] for c in covered)   # per-cell MC
