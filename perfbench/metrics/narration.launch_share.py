"""The host's time issuing the device program, as a share of a
``tts_batch`` call: the program's ``synth.upload``, ``synth.acoustic``,
``synth.vocoder`` (its row loop included) and ``synth.encode`` spans over
its ``tts_batch`` span, the median over the run's calls."""

from perfbench.yardstick.program_spans import call_share


def read(m):
    return call_share(m, ("synth.upload", "synth.acoustic", "synth.vocoder",
                          "synth.encode"))
