"""The voxel stage's bound (the sort, the gathers, the run reduce;
``bounds.py``, summed over the traced requests' scans) over the device
time of every device operation launched inside its span, in percent."""


def read(run):
    return run.stage_roofline_pct("voxel")
