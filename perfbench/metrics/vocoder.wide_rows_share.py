"""Rows whose 256-channel stage ran on K2's wide kernel, as a share of
the kernel route's rows: the program's counters
``synth.vocoder.wide_rows`` over ``synth.vocoder.kernel_rows``, in %
(100 where every row's wide stage took the kernel).  A program without
the wide counter gives no reading."""

from perfbench.yardstick.program_spans import counter_ratio


def read(m):
    try:
        r = counter_ratio(m, "synth.vocoder.wide_rows",
                          "synth.vocoder.kernel_rows")
    except KeyError:  # the program keeps no wide counter
        return None
    return None if r is None else 100.0 * r
