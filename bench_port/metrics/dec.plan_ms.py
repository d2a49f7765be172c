"""dec.plan_ms: host plan and upload: TorchDecoder._prep_refs,
_prep_planes, planes_to_torch, in ms per frame of the spanned window."""
from harness.readers import stage_ms


def read(t):
    return stage_ms(t, ('plan',))
