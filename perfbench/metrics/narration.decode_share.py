"""The host's decode of the wire into each text's waveform, as a share
of a ``tts_batch`` call: the program's ``tts_batch.decode`` span over its
``tts_batch`` span, the median over the run's calls."""

from perfbench.yardstick.program_spans import call_share


def read(m):
    return call_share(m, ("tts_batch.decode",))
