"""A request's wait in the server's batcher, from ``submit`` until its
batch is taken off the queue: the median of the program's
``serve.queue`` spans over every request the run's server batched."""

from perfbench.yardstick.program_spans import median_ms


def read(m):
    return median_ms(m, "serve.queue")
