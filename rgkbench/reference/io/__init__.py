"""The port's image, texture and mesh I/O: its own copies of the
reference's numpy-only modules (`rgk_tpu/io/exr.py`, `obj.py`,
`texture_io.py`), so that both packages read and write the same files
bit for bit.  Code of the port and its scripts import them from here.
"""

from .exr import AccumulationImage, read_exr, write_exr
from .obj import load_obj
from .texture_io import gamma_decode, load_texture

__all__ = ["AccumulationImage", "gamma_decode", "load_obj", "load_texture",
           "read_exr", "write_exr"]
