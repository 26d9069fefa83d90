"""The 95th percentile of the window's calls, each timed from its start to
the host holding its rows and saliencies (nearest rank)."""

UNIT = "ms"


def value(window):
    return window.percentile(95) * 1e3
