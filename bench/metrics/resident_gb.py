"""The state held across inner steps: the most
``torch.cuda.memory_allocated()`` read at the start of an inner step in
the window (``TrainerRound.clock``'s ``resident_bytes``), in 1e9 bytes;
the rest of ``train_peak_gb`` is what a step holds for itself.  Nothing
off the card, or where the program's clock reads no such number."""


def read(run):
    got = [getattr(r.phase_ms, "resident_bytes", 0) for r in run.rounds]
    return max(got) / 1e9 if any(got) else None
