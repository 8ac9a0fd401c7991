"""Device ms of the trainer's ``outer`` span (``TrainerRound.clock``:
the workers' parameters stacked, the Nesterov step) per round."""


def read(run):
    ms = run.phase_ms("outer")
    return ms / len(run.rounds) if ms > 0 and run.rounds else None
