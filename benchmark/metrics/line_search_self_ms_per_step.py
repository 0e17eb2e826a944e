"""The BT line search's own time a step: the self time of its
`newton.line_search` spans (the cubic / quadratic `where` chains), less
the residual evaluations and syncs inside them."""
import spans


def read(run):
    return spans.self_ms_per_step(run, ("newton.line_search",))
