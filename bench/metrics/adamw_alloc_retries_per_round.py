"""The CUDA caching allocator's retries inside the inner steps' ``adamw``
spans per round (``TrainerRound.clock``: ``num_alloc_retries`` read at
each span's start and end); a part of ``alloc_retries_per_round``.
Nothing off the card, or where the program's clock counts no
retries."""


def read(run):
    got = [r.phase_ms.alloc_retries.get("adamw", 0) for r in run.rounds
           if r.alloc and hasattr(r.phase_ms, "alloc_retries")]
    return sum(got) / len(got) if got else None
