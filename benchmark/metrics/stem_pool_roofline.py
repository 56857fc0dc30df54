"""The stem pool kernel (``csrc/stem_pool.cu`` ``stem_pool_kernel``): one
launch a step over the step's packed stem outputs (MEGA: 2 frames a lane),
its least time over its traced device time, in percent."""

from benchmark.harness import bounds, trace


def read(ctx):
    t = ctx["trace"]
    secs = trace.kernel_s(t, "stem_pool_kernel") / t["steps"]
    if not secs:
        return None
    h, w = ctx["config"]["canvas"]
    return 100.0 * bounds.stem_pool_bound_s(ctx["frames_per_step"], h // 4, w // 4) / secs
