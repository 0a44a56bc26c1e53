"""Device ms a queued step spends outside the intersection kernels
(shading, sampler, lights, textures, gathers) in one eager block."""

from rgkbench.metrics import _intersect as ix


def read(rec):
    if "queries" not in rec or rec.get("steps", 0) <= 0:
        return None
    return ix.kernel_ms(rec["kernels"], False) / rec["steps"]
