"""Assembly's own time a step: the self time of the `assembly.residual`,
`assembly.jacobian`, `assembly.resjac` and `assembly.accum` spans (fluxes,
BC staging, scatter-add into bands or CSR), less the constitutive chain
inside them."""
import spans


def read(run):
    return spans.self_ms_per_step(
        run, ("assembly.residual", "assembly.jacobian", "assembly.resjac",
              "assembly.accum"))
