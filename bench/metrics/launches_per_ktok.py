"""Device kernel records in the traced window per 1,000 trained
tokens."""


def read(run):
    if run.trace is None or not run.tokens:
        return None
    return 1000.0 * run.trace.kernels / run.tokens
