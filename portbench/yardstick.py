"""The yardstick: the card's peaks, the least bytes a step needs, and the
arithmetic that turns a traced window into a roofline share.

The roofline here counts bytes only.  An operation count belongs to one
algorithm (the stencil walk's 41 adds a point at eps 8 is not what a kernel
built on running sums performs), so a share against it could pass 100% for
a better algorithm.  The least bytes a step needs are the state read once
and the next state written once.
"""

from __future__ import annotations

#: Published HBM bandwidth of the cards a run may report (NVIDIA's data
#: sheet, SXM part), keyed by a substring of ``torch.cuda.get_device_name()``.
PEAKS = {"H100": 3.35e12}


def peak_bandwidth(device_name: str) -> float:
    """HBM bytes a second of the card named ``device_name``; raises for a
    card the table does not hold, so that no share is taken against a
    guessed peak."""
    for key, bandwidth in PEAKS.items():
        if key in device_name:
            return bandwidth
    raise KeyError(f"no published peak for {device_name!r} in portbench/yardstick.PEAKS")


def least_step_bytes(points: int, itemsize: int) -> int:
    """The bytes one step cannot do without: ``points`` values of
    ``itemsize`` bytes read and as many written."""
    return 2 * points * itemsize


def roofline_pct(steps: int, step_bytes: float, kernel_s: float,
                 bandwidth: float) -> float | None:
    """100 x the least time of ``steps`` steps at ``step_bytes`` each (bytes
    over ``bandwidth``) over ``kernel_s``, the device time of every kernel
    that ran them; None when nothing ran."""
    if steps <= 0 or kernel_s <= 0:
        return None
    return 100.0 * steps * step_bytes / bandwidth / kernel_s
