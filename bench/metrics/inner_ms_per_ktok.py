"""Device ms of the trainer's ``inner`` span (``TrainerRound.clock``:
the M workers' H inner steps, CUDA events) per 1,000 trained tokens."""


def read(run):
    ms = run.phase_ms("inner")
    return 1000.0 * ms / run.tokens if ms > 0 and run.tokens else None
