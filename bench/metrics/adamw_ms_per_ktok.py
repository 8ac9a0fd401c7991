"""Device ms of the inner steps' ``adamw`` spans (``TrainerRound.clock``:
``optim.adamw``'s update and its application to the parameters, CUDA
events) per 1,000 trained tokens.  Nothing where the program opens no
such span."""


def read(run):
    ms = run.phase_ms("adamw")
    return 1000.0 * ms / run.tokens if ms > 0 and run.tokens else None
