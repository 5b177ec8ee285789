"""recall_at_10: the share of the f32 answer's top 10 found in the
program's top 10, over every request completed in the window (the f32
answer is the plain reference's, from the rows before they are rounded
or quantized)."""


def read(run):
    return run.recall
