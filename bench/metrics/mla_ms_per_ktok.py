"""Device ms of the latent attention's ``mla`` spans (``repro_torch.spans``
inside ``TrainerRound.clock``'s ``forward`` and, for the remat
recompute, ``backward``: the latent projections, rotary, attention and
the o projection, CUDA events) per 1,000 trained tokens.  Nothing where
the program opens no such span."""


def read(run):
    ms = run.phase_ms("mla")
    return 1000.0 * ms / run.tokens if ms > 0 and run.tokens else None
