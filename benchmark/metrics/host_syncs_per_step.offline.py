"""Host synchronisations a lockstep step: ``cudaStreamSynchronize``,
``cudaDeviceSynchronize``, ``cudaEventSynchronize`` and synchronous
``cudaMemcpy`` calls in the profiled stretch, over its steps (NMS asks the
host once a round; the detections' copy once a step)."""


def read(ctx):
    return ctx["trace"]["syncs_per_step"]
