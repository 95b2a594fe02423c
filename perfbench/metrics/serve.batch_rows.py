"""Texts per batch of the server's batcher: the program's counters
``serve.rows`` over ``serve.batches``, over the run's whole server."""

from perfbench.yardstick.program_spans import counter_ratio


def read(m):
    return counter_ratio(m, "serve.rows", "serve.batches")
