"""The share of the batched Newton's column-iterations that were still
needed: 100 x the `cols_unconverged` over the `cols_evaluated` of the
`newton.snes` spans; the rest is full-batch work on converged columns
before straggler compaction."""
import spans


def read(run):
    return spans.useful_col_pct(run)
