"""The batched Newton's own time a step: the self time of its
`newton.step` (the dt ladder), `newton.serial_step` (the serial drop-in's
gather and download) and `newton.snes` spans (convergence tests, masks,
compaction, the BT initial slope's matvec)."""
import spans


def read(run):
    return spans.self_ms_per_step(
        run, ("newton.step", "newton.serial_step", "newton.snes"))
