"""setup_s: from the start of the process to the first timed request, less
the seconds the reference ran in set-up (a model's planted rows)."""


def read(run):
    return run.setup_s
