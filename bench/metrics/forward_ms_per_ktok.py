"""Device ms of the inner steps' ``forward`` spans (``TrainerRound.clock``:
``models.loss_fn`` with remat, attention and the cross-entropy, CUDA
events) per 1,000 trained tokens; the probe's batch-1 passes are not
counted.  Nothing where the program opens no such span."""


def read(run):
    ms = run.phase_ms("forward")
    return 1000.0 * ms / run.tokens if ms > 0 and run.tokens else None
