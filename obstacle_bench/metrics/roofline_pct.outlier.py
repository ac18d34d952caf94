"""The outlier stage's bound (``bounds.py``, summed over the traced
requests' scans) over the device time of every device operation launched
inside its span, in percent."""


def read(run):
    return run.stage_roofline_pct("outlier")
