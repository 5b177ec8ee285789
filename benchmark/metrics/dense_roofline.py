"""dense_roofline: the least time the chip needs for the dense work of the
traced window's dense calls (``roofline.DenseWork`` from their shapes)
over the device time of every kernel launched inside those calls, in %."""


def read(run):
    tr = run.traced
    if tr is None or not tr.bracket_device_s.get("dense"):
        return None
    return 100.0 * tr.bracket_work_s["dense"] / tr.bracket_device_s["dense"]
