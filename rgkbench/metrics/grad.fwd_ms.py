"""CUDA-event ms of an eager gradient step's forward (`make_loss_fn`,
every bounce, `differentiable=True`) on the window's last parameters."""


def read(rec):
    return rec.get("fwd_ms")
