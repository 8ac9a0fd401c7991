"""Device ms of the inner steps' ``backward`` spans (``TrainerRound.clock``:
the gradient with each layer's remat recompute, CUDA events) per 1,000
trained tokens; the probe's batch-1 passes are not counted.  Nothing
where the program opens no such span."""


def read(run):
    ms = run.phase_ms("backward")
    return 1000.0 * ms / run.tokens if ms > 0 and run.tokens else None
