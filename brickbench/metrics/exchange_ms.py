"""Device milliseconds a step of the exchange's kernels and copies, per
card: the operations launched inside the program's step calls whose
names match :data:`PATTERNS`, in the profiler's window."""

UNIT, BETTER, SOURCE = "ms", "lower", "device_trace"
LAYER, MOVES = "comm.exchange", "gstencil_per_s"
# K2's pool and stage copies, K9/K10's remote copies, and the copies
# between ranks (``Tensor.copy_``: peer to peer across cards)
PATTERNS = ("copy_pool_kernel", "copy_stage_kernel", "remote_copy_kernel",
            "Memcpy")


def matches(name: str) -> bool:
    return any(p in name for p in PATTERNS)


def read(rec):
    t = rec.trace
    if t is None or not t.steps or not t.devices:
        return None
    return t.op_seconds(matches, owner="brickbench.step") / t.steps / len(
        t.devices) * 1e3
