"""Spatial simulcast on the torch port: N dyadic resolution layers of one
source, each an independent AVC stream with its own SPS/PPS id,
interleaved low-resolution-first inside every access unit.

Port of losslessh264_tpu/simulcast.py (the reference encoder's
SEncParamExt.sSpatialLayers, AVC-compatible mode): `SimulcastEncoder` over
TorchEncoder and `SimulcastDecoder` over TorchDecoder. With
`inter_layer=True` each enhancement layer codes, per MB, either the
residual against the upsampled lower layer's recon (clip(src - up + 128))
or the source pixels, decided by a 4x4 Hadamard SATD cost and by
saturation; the per-MB mode plane travels in an SEI user_data_unregistered
NAL ahead of the layer's access unit (absent = all residual). The pyramid,
the upsampling, the decision and the mixing run on the device in torch;
the SEI byte work is host code, pinned copies of the JAX module's.
"""
from __future__ import annotations

import numpy as np
import torch

from . import processing
from .decoder_torch import TorchDecoder
from .encoder_torch import TorchEncoder
from .ref_np import crop_yuv

_ILP_UUID = b"pip-ilp-mb-mask\x01"  # 16 bytes


def _ebsp_escape(b):
    out = bytearray()
    zeros = 0
    for byte in b:
        if zeros >= 2 and byte <= 3:
            out.append(3)
            zeros = 0
        out.append(byte)
        zeros = zeros + 1 if byte == 0 else 0
    return bytes(out)


def _ebsp_unescape(b):
    out = bytearray()
    zeros = 0
    i = 0
    while i < len(b):
        if zeros >= 2 and b[i] == 3:
            zeros = 0
            i += 1
            continue
        out.append(b[i])
        zeros = zeros + 1 if b[i] == 0 else 0
        i += 1
    return bytes(out)


def _sei_mask_nal(mask_bits, au_idx):
    """SEI user_data_unregistered NAL carrying the packed per-MB mode
    plane (raster order, MSB first per byte) of access unit au_idx; only
    AUs that are not all-residual carry one."""
    idx = bytearray()
    v = int(au_idx)
    while v >= 0x80:
        idx.append(0x80 | (v & 0x7f))
        v >>= 7
    idx.append(v)
    payload = (_ILP_UUID + bytes(idx)
               + np.packbits(mask_bits.astype(np.uint8)).tobytes())
    size = b""
    n = len(payload)
    while n >= 255:
        size += b"\xff"
        n -= 255
    size += bytes([n])
    body = bytes([5]) + size + payload + b"\x80"  # type 5 + rbsp stop
    return b"\x00\x00\x00\x01\x06" + _ebsp_escape(body)


def _split_ilp_seis(stream):
    """(stream without the ILP-mask SEIs, {au_idx: mask_bytes}); AUs
    without an entry are all-residual."""
    masks = {}
    out = bytearray()
    i = 0
    n = len(stream)
    spans = []
    while True:
        j = stream.find(b"\x00\x00\x01", i)
        if j < 0:
            break
        k = stream.find(b"\x00\x00\x01", j + 3)
        # back off the one trailing zero of a 4-byte start code; further
        # zeros may belong to this NAL (cabac_zero_words)
        end = n if k < 0 else k
        if k >= 0 and end > j + 3 and stream[end - 1] == 0:
            end -= 1
        spans.append((j, j + 3, end))
        if k < 0:
            break
        i = j + 3
    pos = 0
    for (sc, ps, pe) in spans:
        nal = stream[ps:pe]
        if len(nal) > 20 and (nal[0] & 0x1f) == 6:
            rbsp = _ebsp_unescape(nal[1:])
            if rbsp[:1] == b"\x05":
                q = 1
                size = 0
                while q < len(rbsp) and rbsp[q] == 0xff:
                    size += 255
                    q += 1
                if q < len(rbsp):
                    size += rbsp[q]
                    q += 1
                if rbsp[q:q + 16] == _ILP_UUID:
                    body = rbsp[q + 16:q + size]
                    au_idx = 0
                    shift = 0
                    b = 0
                    while b < len(body):
                        au_idx |= (body[b] & 0x7f) << shift
                        shift += 7
                        b += 1
                        if not body[b - 1] & 0x80:
                            break
                    masks[au_idx] = body[b:]
                    # drop exactly what _sei_mask_nal wrote: the 4-byte
                    # start code through the last payload byte
                    drop = sc - 1 if sc > 0 and stream[sc - 1] == 0 else sc
                    out += stream[pos:drop]
                    pos = pe
                    continue
        out += stream[pos:pe]
        pos = pe
    out += stream[pos:]
    return bytes(out), masks


# ---------------------------------------------------------------------------
# per-MB pixel work (device)
# ---------------------------------------------------------------------------
def _pad_mb(a, t):
    """Edge-pad a plane up to a whole multiple of t (the MB grid), as the
    encoder pads sizes that are not whole MBs."""
    h, w = a.shape
    ys = torch.arange(-(-h // t) * t, device=a.device).clamp(max=h - 1)
    xs = torch.arange(-(-w // t) * t, device=a.device).clamp(max=w - 1)
    return a[ys[:, None], xs[None, :]]


def _mbgrid(a, t):
    """(H, W) plane, t-aligned -> (mb_h, mb_w, t, t)."""
    h, w = a.shape
    return a.reshape(h // t, t, w // t, t).permute(0, 2, 1, 3)


def _h4(x, dim):
    """The 4-point Hadamard of _H4's rows along `dim` (integer adds)."""
    a, b, c, d = x.unbind(dim)
    return torch.stack([a + b + c + d, a + b - c - d, a - b - c + d,
                        a - b + c - d], dim)


def _satd_mb(plane):
    """Per-MB DC-excluded 4x4 Hadamard SATD of a 16-aligned int32 plane:
    over each MB's 16 4x4 blocks, sum |H b H^T| - |dc| (the reference's
    SampleSatd). Exact in int32 (at most 16 * 16 * 4080 per MB)."""
    mb = _mbgrid(plane, 16)
    mh, mw = mb.shape[:2]
    b = mb.reshape(mh, mw, 4, 4, 4, 4).permute(0, 1, 2, 4, 3, 5)
    t = torch.abs(_h4(_h4(b, -2), -1))
    return (t.sum((2, 3, 4, 5), dtype=torch.int32)
            - t[..., 0, 0].sum((2, 3), dtype=torch.int32))


def _expand(mask, t, h, w):
    return mask.repeat_interleave(t, 0).repeat_interleave(t, 1)[:h, :w]


def _ilp_combine(pred, coded, mask):
    """display = clip(up(base) + coded - 128) on residual-mode MBs, the
    coded pixels on source-mode MBs."""
    out = []
    for i, (pr, rr) in enumerate(zip(pred, coded)):
        t = 16 if i == 0 else 8
        h2, w2 = min(pr.shape[0], rr.shape[0]), min(pr.shape[1],
                                                    rr.shape[1])
        pr, rr = pr[:h2, :w2], rr[:h2, :w2]
        resid = torch.clamp(pr.to(torch.int32) + rr.to(torch.int32) - 128,
                            0, 255)
        out.append(torch.where(_expand(mask, t, h2, w2), resid,
                               rr.to(torch.int32)).to(torch.uint8))
    return tuple(out)


class SimulcastEncoder:
    """Encode N dyadic spatial layers per frame (layer 0 the lowest
    resolution, N-1 the full one), each a TorchEncoder with param_id = its
    index; every TorchEncoder option applies to every layer. With
    inter_layer=True, layers above 0 code the per-MB residual against the
    upsampled recon of the layer below (module docstring); decode with
    SimulcastDecoder."""

    def __init__(self, width, height, spatial_layers=2, qp=28,
                 inter_layer=False, device="cuda", **kw):
        if not 1 <= spatial_layers <= 4:
            raise ValueError("1..4 spatial layers")
        scale = 1 << (spatial_layers - 1)
        if width % (2 * scale) or height % (2 * scale):
            raise ValueError("source dims must divide by 2^layers (dyadic "
                             "4:2:0 pyramid)")
        if width < 16 * scale or height < 16 * scale:
            raise ValueError("lowest layer must be at least one macroblock")
        self.width, self.height = width, height
        self.inter_layer = bool(inter_layer)
        self.device = torch.device(device)
        self._au_idx = 0
        self.dims = []
        self.encs = []
        for i in range(spatial_layers):
            sh = spatial_layers - 1 - i
            w, h = width >> sh, height >> sh
            self.dims.append((w, h))
            self.encs.append(TorchEncoder(w, h, qp=qp, param_id=i,
                                          device=device, **kw))

    def _pyramid(self, Y, U, V):
        """Low-res-first per-layer (Y, U, V) source planes on the device
        (the dyadic bilinear downsampler)."""
        planes = [tuple(p.to(self.device) if isinstance(p, torch.Tensor)
                        else torch.tensor(np.asarray(p), device=self.device)
                        for p in (Y, U, V))]
        for _ in range(len(self.encs) - 1):
            planes.append(tuple(processing.downsample2x(p)
                                for p in planes[-1]))
        planes.reverse()
        return [(Yl[:h, :w], Ul[:h // 2, :w // 2], Vl[:h // 2, :w // 2])
                for (w, h), (Yl, Ul, Vl) in zip(self.dims, planes)]

    def encode_frame_layers(self, Y, U, V):
        """Per-layer bytes of one source frame, low-res first."""
        srcs = self._pyramid(Y, U, V)
        if not self.inter_layer:
            return [enc.encode_frame(*src) for enc, src in zip(self.encs,
                                                               srcs)]
        out = []
        prev_recon = None
        for li, (enc, src) in enumerate(zip(self.encs, srcs)):
            w, h = self.dims[li]
            if li == 0:
                out.append(enc.encode_frame(*src))
            else:
                # per MB: residual mode unless it saturates or costs more
                # than the source; the mode plane rides an SEI
                pred = [processing.upsample2x(p)[:s.shape[0], :s.shape[1]]
                        for p, s in zip(prev_recon, src)]
                mask = self._ilp_decide(src, pred)
                mask_np = mask.cpu().numpy()
                mixed = self._ilp_mix(src, pred, mask)
                sei = (b"" if mask_np.all()
                       else _sei_mask_nal(mask_np.reshape(-1), self._au_idx))
                out.append(sei + enc.encode_frame(*mixed))
            rY, rU, rV = enc.ref
            prev_recon = (rY[:h, :w], rU[:h // 2, :w // 2],
                          rV[:h // 2, :w // 2])
            if li > 0:
                # what a receiver displays feeds the layer above
                prev_recon = _ilp_combine(pred, prev_recon, mask)
        self._au_idx += 1
        return out

    @staticmethod
    def _ilp_decide(src, pred):
        """Per-MB residual-vs-source mode [mb_h, mb_w] bool: residual only
        where no luma or chroma residual leaves [-127, 127] and the luma
        residual's DC-excluded 4x4 Hadamard SATD is at most the source's;
        partial edge MBs are edge-padded for the decision."""
        sy = _pad_mb(src[0], 16).to(torch.int32)
        py = _pad_mb(pred[0], 16).to(torch.int32)
        sat = torch.zeros((sy.shape[0] // 16, sy.shape[1] // 16),
                          dtype=torch.bool, device=sy.device)
        for i, (s, p) in enumerate(zip(src, pred)):
            t = 16 if i == 0 else 8
            r = _mbgrid(_pad_mb(s, t).to(torch.int32)
                        - _pad_mb(p, t).to(torch.int32), t)
            sat |= (torch.abs(r) > 127).flatten(2).any(2)
        return (~sat) & (_satd_mb(sy - py) <= _satd_mb(sy))

    @staticmethod
    def _ilp_mix(src, pred, mask):
        """The enhancement encoder's input: residual + 128 on mask MBs,
        source pixels elsewhere."""
        out = []
        for i, (s, p) in enumerate(zip(src, pred)):
            t = 16 if i == 0 else 8
            resid = torch.clamp(s.to(torch.int32) - p.to(torch.int32) + 128,
                                0, 255)
            out.append(torch.where(_expand(mask, t, *s.shape), resid,
                                   s.to(torch.int32)).to(torch.uint8))
        return out

    def encode_frame(self, Y, U, V):
        """One access unit: all spatial layers' NALs, low-res first."""
        return b"".join(self.encode_frame_layers(Y, U, V))

    def encode_frames(self, frames, batch=8):
        """Per-AU encode of a frame sequence; `batch` is taken and ignored,
        as the JAX SimulcastEncoder ignores it."""
        return [self.encode_frame(*f) for f in frames]

    def force_intra_frame(self):
        for enc in self.encs:
            enc.force_intra_frame()


class SimulcastDecoder:
    """Receiver of inter-layer bundles: N per-layer AVC streams, low-res
    first, each decoded by a TorchDecoder. Layer 0 decodes standalone;
    each higher layer reads its per-MB mode plane from the SEI of the same
    access unit (residual mode: clip(up(lower) + coded - 128); source
    mode: the coded pixels). Yields (Y, U, V) uint8 tensors on the device,
    cropped to the display size."""

    def __init__(self, layer_streams, error_concealment=True, device="cuda"):
        self.decs = []
        self.masks = []   # per layer: {au_idx: packed mask bytes}
        for li, s in enumerate(layer_streams):
            clean, masks = _split_ilp_seis(s) if li > 0 else (s, {})
            self.decs.append(TorchDecoder(
                clean, device=device, error_concealment=error_concealment))
            self.masks.append(masks)

    def frames(self):
        its = [d.frames() for d in self.decs]
        while True:
            try:
                layers = [next(it) for it in its]
            except StopIteration:
                return
            cropped = [crop_yuv(f, d.crop_px)
                       for f, d in zip(layers, self.decs)]
            recon = cropped[0]
            for li, coded in enumerate(cropped[1:], start=1):
                mh = -(-coded[0].shape[0] // 16)
                mw = -(-coded[0].shape[1] // 16)
                # the mask of the layer's own AU index: every decoded AU
                # advances out_idx, yielded or not (freeze-output)
                mb = self.masks[li].get(self.decs[li].out_idx - 1)
                if mb is not None:
                    bits = np.unpackbits(np.frombuffer(mb, np.uint8))
                    mask = bits[:mh * mw].reshape(mh, mw).astype(bool)
                else:
                    mask = np.ones((mh, mw), bool)
                mask = torch.as_tensor(mask, device=coded[0].device)
                pred = [processing.upsample2x(lo) for lo in recon]
                recon = _ilp_combine(pred, coded, mask)
            yield recon
