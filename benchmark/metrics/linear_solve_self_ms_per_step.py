"""The linear solve's own time a step: the self time of the `linsolve`
spans (the host's launches and loop of Thomas, ILU(0) + GMRES(30) or
block Thomas), less the syncs of GMRES's flag reads inside them."""
import spans


def read(run):
    return spans.self_ms_per_step(run, ("linsolve",))
