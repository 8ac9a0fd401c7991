"""Model FLOPs of the window (forward and backward of every trained
sequence and every probe row, ``bench.flops.train_flops``) over 989
TFLOP/s times the window's seconds, in %."""
from bench.flops import PEAK_BF16_FLOPS, train_flops


def read(run):
    seqs = sum(r.samples for r in run.rounds) + run.probe_rows
    if run.window_s <= 0 or not seqs:
        return None
    return 100.0 * train_flops(run.model, run.seq_len, seqs) \
        / (PEAK_BF16_FLOPS * run.window_s)
