"""Model FLOPs of a DeepSeek-V2 window (``bench.moe_flops.train_flops``:
forward and backward of every trained sequence, the routed experts' part
from the kept assignments the program counted, ``layers.moe_counts``)
over 989 TFLOP/s times the window's seconds, in %.  Nothing where the
run holds no such count."""
from bench.flops import PEAK_BF16_FLOPS
from bench.moe_flops import train_flops


def read(run):
    kept = getattr(run, "moe", {}).get("kept")
    seqs = sum(r.samples for r in run.rounds)
    if kept is None or run.window_s <= 0 or not seqs:
        return None
    return 100.0 * train_flops(run.model, run.seq_len, seqs, kept) \
        / (PEAK_BF16_FLOPS * run.window_s)
