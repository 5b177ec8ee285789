"""encoder.mfu: the matrix products of every bracketed encoder call in the
traced window (the reference model file's ``flops``: real tokens only,
attention over each text's own keys), each at the chip's peak for the
type its configuration computes in (``roofline.ModelWork.peak_s``), over
the traced window's seconds, in %.  None without an encoder call or
without a device trace."""

UNIT = "%"


def read(run):
    tr = run.traced
    if tr is None or tr.busy_s <= 0 or tr.window_s <= 0 or not tr.bracket_peak_s.get("encoder"):
        return None
    return 100.0 * tr.bracket_peak_s["encoder"] / tr.window_s
