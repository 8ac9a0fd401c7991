"""Share of the gradstats kernels' bytes bound in their device time:
the bytes each probe must move (``bench.flops.gradstats_bytes``) at
3.35 TB/s, over the traced time of ``colsum_kernel``, ``moments_kernel``
and ``finish_kernel``, in %.  Nothing where no such kernel ran."""
from bench.flops import PEAK_HBM_BYTES, gradstats_bytes
from bench.trace import GRADSTATS_ALL


def read(run):
    if run.trace is None:
        return None
    t = sum(s for name, (s, _) in run.trace.by_name.items()
            if GRADSTATS_ALL.search(name))
    probes = [p for r in run.rounds for p in r.probes]
    if t <= 0 or not probes:
        return None
    D = run.model.param_count()
    return 100.0 * sum(gradstats_bytes(p, D) for p in probes) \
        / PEAK_HBM_BYTES / t
