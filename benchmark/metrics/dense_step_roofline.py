"""The dense layer's share of its roofline: the least time the chip could
take for one fused frame's work (`work.dense_step_work` at the
configuration's H x W x D and volume type) over `dense_device_ms`."""

from benchmark import work
from benchmark.metrics import dense_device_ms


def read(run):
    ms = dense_device_ms.read(run)
    if not ms:
        return None
    d = run.config["dense"]
    itemsize = 2 if d["dtype"] == "bfloat16" else 4
    bound = work.bound_s(*work.dense_step_work(d["height"], d["width"], d["num_depths"], itemsize))
    return 100.0 * bound * 1e3 / ms
