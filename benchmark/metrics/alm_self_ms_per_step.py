"""The ALM driver's own time a step: the self time of its `alm.step`
span (staging of forcing, the retry ladder, the audit, escalation and the
CLM unpack), less the Newton, assembly and sync spans inside it."""
import spans


def read(run):
    return spans.self_ms_per_step(run, ("alm.step",))
