"""The copy of the PCM (and the mel lengths) to the host, as a share of
a ``tts_batch`` call: the program's ``synth.fetch.copy`` spans over its
``tts_batch`` span, the median over the run's calls."""

from perfbench.yardstick.program_spans import call_share


def read(m):
    return call_share(m, ("synth.fetch.copy",))
