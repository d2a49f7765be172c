"""Rate control for the encoder: a pinned copy of
losslessh264_tpu/ratectl.py (framework-free; tests/test_torch_processing.py
drives both through the same call sequences and requires equal outputs).

The reference encoder's rate controller (codec/encoder/core/src/ratectl.cpp,
mode enum RC_MODES in codec/api/svc/codec_app_def.h:283-290):

- `RateControl`       — RC_BITRATE_MODE: frame-level linear R-Q model
  (`bits = X * complexity / Qstep`, WelsRcPictureInitGom semantics)
  with a leaky virtual buffer and optional buffer-overflow frame
  skipping (RcVBufferCalculationSkip / WelsRcFrameDelayJudge,
  ratectl.cpp:685-777).
- `TimestampRC`       — RC_TIMESTAMP_MODE: same QP model, but the
  virtual buffer drains by REAL timestamp deltas instead of 1/fps per
  frame, and the skip decision is a pure buffer-threshold test
  (WelsRcFrameDelayJudgeTimeStamp, ratectl.cpp:1273-1307).
- `BufferBasedRC`     — RC_BUFFERBASED_MODE: no bitrate target at all;
  a +2/-1 QP servo on the delivery status with a scene-change-raised
  QP floor (WelRcPictureInitBufferBasedQp, ratectl.cpp:1150-1167).
- `ScreenContentRC`   — the SCC path: QP from a per-frame
  complexity-to-bits linear cost model with scene-change-aware jump
  rules (WelRcPictureInitScc, ratectl.cpp:1168-1228).

Unlike the reference's per-MB sequential feedback loop (RcCalculateMbQp
walks MBs in coding order adjusting QP from bits-spent-so-far), the
per-GOM plane here is decided UP FRONT from per-row complexity
(`gom_dqp`) so the whole frame stays one batched device program — the
serial in-frame feedback chain would force MB-serial host round trips.

All controllers share one protocol so the encoder can hold any of them:
  frame_qp(complexity, is_idr=False, timestamp_ms=None, scene_idc=0)
  tick(timestamp_ms=None)                     (per frame that will NOT
                                               consult should_skip, i.e.
                                               IDRs: drains the buffer /
                                               resets skip-run state)
  should_skip(timestamp_ms=None) -> bool      (before encoding a frame)
  update(bits_used)                           (after encoding)
"""
from __future__ import annotations

import math

# Scene-change classes (reference ESceneChangeIdc, wels_preprocess.h).
SCENE_IDC_NONE = 0
SCENE_IDC_MEDIUM = 1
SCENE_IDC_LARGE = 2


def qstep(qp: int) -> float:
    """H.264 quantizer step size (doubles every 6 QP)."""
    return 0.85 * 2.0 ** ((qp - 12) / 6.0)


def qstep_to_qp(step: float) -> int:
    """Inverse of `qstep` (reference RcConvertQStep2Qp)."""
    return int(round(12 + 6 * math.log2(max(step / 0.85, 1e-6))))


class RateControl:
    """RC_BITRATE_MODE: frame-level linear R-Q with a virtual buffer.

    With `frame_skip=True`, frames are dropped when the virtual buffer
    overshoots `skip_buffer_ratio` of one second's bits — the reference's
    buffer-fullness skip condition (RcVBufferCalculationSkip condition 1
    plus the continual-skip-frames cap of WelsRcFrameDelayJudge).
    """
    MAX_DELTA_QP = 3
    BUFFER_DRAIN = 0.20     # fraction of buffer error corrected per frame

    def __init__(self, bitrate_bps: float, fps: float, qp_init: int = 32,
                 qp_min: int = 16, qp_max: int = 46, idr_weight: float = 2.5,
                 frame_skip: bool = False, skip_buffer_ratio: float = 0.5,
                 max_bitrate_bps: float | None = None):
        self.bitrate = bitrate_bps
        self.fps = fps
        self.bpf = bitrate_bps / fps
        self.qp_min, self.qp_max = qp_min, qp_max
        self.idr_weight = idr_weight
        self.prev_qp = qp_init
        self.buffer = 0.0       # bits over (+) / under (-) budget so far
        self.model_x = None     # R-Q model gain, EMA-updated
        self._last = None       # (qp, complexity, is_idr) of pending frame
        self.frame_skip = frame_skip
        self.skip_threshold = skip_buffer_ratio * bitrate_bps
        self.max_bitrate = max_bitrate_bps
        self.skipped_frames = 0
        self._continual_skips = 0

    def tick(self, timestamp_ms=None) -> None:
        """Per-frame housekeeping for frames that bypass should_skip
        (IDRs): an encoded frame always breaks a continual-skip run.
        Buffer drain itself happens in update() for this mode."""
        self._continual_skips = 0

    def should_skip(self, timestamp_ms=None) -> bool:
        """Skip-before-encode decision. The continual-skip cap mirrors
        iPredSkipFramesTarBr (WelsRcFrameDelayJudge): at most ~half the
        frames the current overshoot is worth may be dropped in a row,
        so the output never freezes outright."""
        if not self.frame_skip or self.buffer <= self.skip_threshold:
            self._continual_skips = 0
            return False
        allowed = (int(round(self.buffer / max(self.bpf, 1.0))) + 1) // 2
        if self._continual_skips > allowed:
            self._continual_skips = 0
            return False
        self._continual_skips += 1
        self.skipped_frames += 1
        self.buffer = max(self.buffer - self.bpf, 0.0)
        return True

    def frame_qp(self, complexity: float, is_idr: bool = False,
                 timestamp_ms=None, scene_idc: int = SCENE_IDC_NONE) -> int:
        """QP to use for the next frame given its (SAD) complexity."""
        target = self.bpf - self.BUFFER_DRAIN * self.buffer
        if is_idr:
            target *= self.idr_weight
        target = max(target, self.bpf * 0.1)
        if self.model_x is None or complexity <= 0:
            qp = self.prev_qp
        else:
            want_qstep = self.model_x * complexity / target
            qp = qstep_to_qp(want_qstep)
            qp = max(self.prev_qp - self.MAX_DELTA_QP,
                     min(self.prev_qp + self.MAX_DELTA_QP, qp))
        qp = max(self.qp_min, min(self.qp_max, qp))
        self._last = (qp, complexity, is_idr)
        return qp

    def gom_dqp(self, row_complexity):
        """Per-MB-row (GOM) delta-QP plane for the coming frame.

        TPU-first equivalent of the reference's per-GOM QP loop
        (ratectl.cpp RcGomTargetBits/RcCalculateGomQp): instead of
        adjusting QP sequentially from bits spent so far inside the
        frame, the whole plane is decided up front from per-GOM
        complexity — rows that would overspend (high SAD vs the frame
        average) take +dqp, flat rows take -dqp, keeping per-GOM bits
        near uniform without a serial in-frame feedback chain."""
        import numpy as np
        c = np.asarray(row_complexity, np.float64)
        if c.size == 0 or c.mean() <= 0:
            return np.zeros(c.size, np.int32)
        ratio = np.maximum(c / c.mean(), 1e-3)
        # bits ~ complexity / Qstep and Qstep doubles per 6 QP: +2 QP
        # per doubling of relative complexity halves the overshoot
        dqp = np.round(2.0 * np.log2(ratio))
        return np.clip(dqp, -self.MAX_DELTA_QP,
                       self.MAX_DELTA_QP).astype(np.int32)

    def update(self, bits_used: float) -> None:
        """Feed back the actual size of the frame just encoded."""
        if self._last is None:
            return
        qp, complexity, is_idr = self._last
        self._last = None
        budget = self.bpf * (self.idr_weight if is_idr else 1.0)
        self.buffer += bits_used - budget
        self.prev_qp = qp
        if complexity > 0:
            x = bits_used * qstep(qp) / complexity
            self.model_x = x if self.model_x is None else (
                0.75 * self.model_x + 0.25 * x)


class TimestampRC(RateControl):
    """RC_TIMESTAMP_MODE: the virtual buffer drains by wall-clock
    timestamp deltas, so irregular capture rates (dropped camera frames,
    variable-fps screen shares) keep the bit budget honest.

    Differences from RC_BITRATE_MODE, matching the reference
    (InitRcModuleTimeStamp / WelsRcFrameDelayJudgeTimeStamp,
    ratectl.cpp:1262-1307):
      - `sent = bitrate * dt` is removed from the buffer per observed
        timestamp delta (not a fixed 1/fps per frame);
      - the buffer is floored at 0 (an idle gap does not bank credit);
      - the skip test is a pure threshold (no continual-skip cap — the
        timestamp itself limits the drop rate).
    """

    def __init__(self, bitrate_bps: float, fps: float, **kw):
        kw.setdefault("frame_skip", True)
        super().__init__(bitrate_bps, fps, **kw)
        self._last_ts = None

    def _drain(self, timestamp_ms) -> None:
        if timestamp_ms is None:
            dt = 1000.0 / self.fps
        elif self._last_ts is None:
            dt = 0.0
        else:
            dt = max(float(timestamp_ms) - self._last_ts, 0.0)
        self.buffer = max(self.buffer - self.bitrate * dt * 1e-3, 0.0)

    def tick(self, timestamp_ms=None) -> None:
        """IDR frames drain by their timestamp delta too — without this
        the buffer gains a permanent one-frame-budget bias per IDR."""
        self._drain(timestamp_ms)
        if timestamp_ms is not None:
            self._last_ts = float(timestamp_ms)

    def should_skip(self, timestamp_ms=None) -> bool:
        self.tick(timestamp_ms)
        if not self.frame_skip or self.buffer < self.skip_threshold:
            return False
        self.skipped_frames += 1
        return True

    def frame_qp(self, complexity: float, is_idr: bool = False,
                 timestamp_ms=None, scene_idc: int = SCENE_IDC_NONE) -> int:
        # headroom clamp: target bits must fit the remaining buffer room
        # (iMaxTh/iMinTh in WelsRcPictureInitGomTimeStamp)
        max_th = self.skip_threshold * 2 - self.buffer
        qp = super().frame_qp(complexity, is_idr,
                              timestamp_ms=timestamp_ms,
                              scene_idc=scene_idc)
        if max_th <= 0:
            qp = min(self.prev_qp + self.MAX_DELTA_QP, self.qp_max)
            if self._last is not None:
                self._last = (qp, self._last[1], self._last[2])
        return qp

    def update(self, bits_used: float) -> None:
        if self._last is None:
            return
        qp, complexity, is_idr = self._last
        super().update(bits_used)
        # super() already charged the per-frame budget; timestamp mode
        # drains in should_skip instead, so re-add the budget and charge
        # the raw frame bits (WelsRcFrameDelayJudgeTimeStamp accumulates
        # iFrameDqBits and subtracts bitrate*dt)
        budget = self.bpf * (self.idr_weight if is_idr else 1.0)
        self.buffer += budget
        self.buffer = max(self.buffer, 0.0)


class BufferBasedRC:
    """RC_BUFFERBASED_MODE: "no bitrate control, only using buffer
    status, adjust the video quality" (codec_app_def.h:286).

    A pure QP servo: when the sink reports on-time delivery the QP
    relaxes by 1 (better quality); when delivery lags it tightens by 2.
    A scene change raises the QP floor by its severity so cuts do not
    blow up the frame size (WelRcPictureInitBufferBasedQp semantics).
    Feed the delivery flag via `report_delivery`; complexity is unused.
    """

    def __init__(self, qp_init: int = 32, qp_min: int = 26,
                 qp_max: int = 46):
        self.qp = qp_init
        self.qp_min, self.qp_max = qp_min, qp_max
        self.delivered = True

    def report_delivery(self, on_time: bool) -> None:
        self.delivered = bool(on_time)

    def tick(self, timestamp_ms=None) -> None:
        pass

    def should_skip(self, timestamp_ms=None) -> bool:
        return False

    def frame_qp(self, complexity: float = 0.0, is_idr: bool = False,
                 timestamp_ms=None, scene_idc: int = SCENE_IDC_NONE) -> int:
        floor = self.qp_min + {SCENE_IDC_NONE: 0, SCENE_IDC_MEDIUM: 1,
                               SCENE_IDC_LARGE: 2}.get(scene_idc, 0)
        self.qp += -1 if self.delivered else 2
        self.qp = max(floor, min(self.qp, self.qp_max))
        return self.qp

    def update(self, bits_used: float) -> None:
        pass


class ScreenContentRC:
    """The reference's screen-content RC path (WelRcPictureInitScc):
    QP straight from a complexity-to-bits linear cost model.

    State is two learned cost densities (bits per unit complexity at
    Qstep 1) — one intra, one inter — and a slow base-QP servo driven by
    buffer fullness. Scene changes and large positive QP deltas jump the
    QP immediately (screen content flips between static and violently
    changing; the smooth ±3 clamp of the camera model is exactly wrong
    there).
    """
    def __init__(self, bitrate_bps: float, fps: float, qp_init: int = 30,
                 qp_min: int = 16, qp_max: int = 46,
                 skip_buffer_ratio: float = 0.5):
        self.bitrate = bitrate_bps
        self.bpf = bitrate_bps / fps
        self.qp_min, self.qp_max = qp_min, qp_max
        self.base_qp = qp_init
        self.buffer = 0.0
        self.cost_intra = 1.0   # iCost2BitsIntra (learned)
        self.cost_inter = 1.0   # iAvgCost2Bits (learned)
        self.skip_threshold = skip_buffer_ratio * bitrate_bps
        self.skipped_frames = 0
        self._last = None

    def tick(self, timestamp_ms=None) -> None:
        """Per-frame buffer drain — called for every frame (IDRs via the
        encoder's tick, others via should_skip) so IDR bits don't bias
        the buffer permanently upward."""
        self.buffer = max(self.buffer - self.bpf, 0.0)

    def should_skip(self, timestamp_ms=None) -> bool:
        self.tick(timestamp_ms)
        if self.buffer < self.skip_threshold:
            return False
        self.skipped_frames += 1
        return True

    def frame_qp(self, complexity: float, is_idr: bool = False,
                 timestamp_ms=None, scene_idc: int = SCENE_IDC_NONE) -> int:
        complexity = max(float(complexity), 1.0)
        if is_idr:
            target = max(self.bitrate * 2 - self.buffer, 1.0)
            qp = qstep_to_qp(complexity * self.cost_intra / target)
            qp = max(self.qp_min, min(qp, self.qp_max))
        else:
            target = max(self.bpf, 1.0)
            want = qstep_to_qp(complexity * self.cost_inter / target)
            delta = want - self.base_qp
            # slow servo on the base QP from buffer pressure
            if self.buffer > self.bitrate and delta > 0:
                self.base_qp += 1
            elif self.buffer <= 0 and delta < 0:
                self.base_qp -= 1
            if delta >= 6:
                self.base_qp += 3
            elif delta <= -6:
                self.base_qp -= 1
            self.base_qp = max(self.qp_min, min(self.base_qp, self.qp_max))
            qp = self.base_qp
            if delta < -6:          # content went static: drop QP fast
                qp = self.base_qp - 6
            elif delta > 5:         # content exploded: jump QP up
                if (scene_idc == SCENE_IDC_LARGE
                        or self.buffer > 2 * self.bitrate or delta > 10):
                    qp = self.base_qp + delta
                elif (scene_idc == SCENE_IDC_MEDIUM
                        or self.buffer > self.bitrate):
                    qp = self.base_qp + 5
            qp = max(self.qp_min, min(qp, self.qp_max))
        self._last = (qp, complexity, is_idr)
        return qp

    def update(self, bits_used: float) -> None:
        if self._last is None:
            return
        qp, complexity, is_idr = self._last
        self._last = None
        self.buffer += bits_used
        density = bits_used * qstep(qp) / complexity
        if is_idr:
            self.cost_intra = 0.5 * self.cost_intra + 0.5 * density
        else:
            self.cost_inter = 0.75 * self.cost_inter + 0.25 * density
