"""Device ms of the MoE layers' ``moe`` spans (``repro_torch.spans``
inside ``TrainerRound.clock``'s ``forward`` and, for the remat
recompute, ``backward``: routing, dispatch, the held experts' products,
the combine and the shared experts, CUDA events) per 1,000 trained
tokens.  Nothing where the program opens no such span."""


def read(run):
    ms = run.phase_ms("moe")
    return 1000.0 * ms / run.tokens if ms > 0 and run.tokens else None
