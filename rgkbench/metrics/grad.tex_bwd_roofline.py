"""Share of the texel backward's roofline in the gradient graph: the
least bytes any implementation of it needs (`least_bytes`) at the
card's bandwidth, over the phase stamps' `tex_bwd_ns`; in %.

The texel backward takes, for each textured lookup of the forward
(`tex_fetches`), its colour's gradient (3 float32) and its uv (2
float32), each read once, and writes the texel gradient table (3
float32 a texel of the atlas, `rec["texels"]`) once; whatever scatters
the sums, that much crosses the card's memory."""

from rgkbench.metrics import _intersect as ix
from rgkbench.metrics import _program

LOOKUP_BYTES = 12 + 8   # a lookup's colour gradient and uv, read
TEXEL_BYTES = 12        # a texel's gradient, written


def least_bytes(lookups: int, texels: int, steps: int) -> int:
    """The bytes of `steps` steps' texel backward."""
    return lookups * LOOKUP_BYTES + steps * texels * TEXEL_BYTES


def read(rec):
    st = _program.stats(rec, "tex_bwd_ns", "tex_fetches", "grad_steps")
    if st is None or not rec.get("texels"):
        return None
    nbytes = least_bytes(st["tex_fetches"], rec["texels"], st["grad_steps"])
    return 100.0 * nbytes / ix.PEAK_BYTES_PER_S / (st["tex_bwd_ns"] / 1e9)
