"""Tokens of the inner steps completed in the window (sequences x
sequence length, every worker; the probe's rows are overhead and are not
counted), over the window's elapsed seconds on the host's clock."""


def read(run):
    return run.tokens / run.window_s if run.window_s > 0 else None
