"""setup_s: from the start of the process to the first timed request."""


def read(run):
    return run.setup_s
