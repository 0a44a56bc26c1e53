"""Host seconds of loading the kernel library, its nvcc build included
where the checkout had none: the program's `kernels.load` span."""

from rgkbench.metrics import _program


def read(rec):
    return _program.span_seconds(rec, "kernels.load")
