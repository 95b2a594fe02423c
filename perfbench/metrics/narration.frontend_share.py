"""The text frontend's share of a ``tts_batch`` call (phonemizing and
segmenting every text): the program's ``tts_batch.frontend`` span over
its ``tts_batch`` span, the median over the run's calls."""

from perfbench.yardstick.program_spans import call_share


def read(m):
    return call_share(m, ("tts_batch.frontend",))
