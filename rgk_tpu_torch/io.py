"""The port's image, texture and mesh I/O.

These are numpy-only modules of the reference package (`rgk_tpu/io/`,
which imports no JAX), taken as they are so that both packages read and
write the same files bit for bit.  Code of the port and its scripts
import them from here.
"""

from rgk_tpu.io.exr import AccumulationImage, read_exr, write_exr
from rgk_tpu.io.obj import load_obj
from rgk_tpu.io.texture_io import gamma_decode, load_texture

__all__ = ["AccumulationImage", "gamma_decode", "load_obj", "load_texture",
           "read_exr", "write_exr"]
