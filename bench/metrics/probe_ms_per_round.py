"""Device ms of the per-sample probe (``TrainerRound.clock``'s
``stats_grads`` and ``stats_reduce`` spans) per round; nothing where no
probe ran."""


def read(run):
    ms = run.phase_ms("stats_grads", "stats_reduce")
    return ms / len(run.rounds) if ms > 0 and run.rounds else None
