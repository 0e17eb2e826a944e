"""The constitutive chain a step: the time of the `assembly.constitutive`
spans (the cells' saturation, relative permeability, TGDPB01 density,
viscosity and porosity), wherever they run: in the residual, the Jacobian,
the storage of the audit."""
import spans


def read(run):
    return spans.self_ms_per_step(run, ("assembly.constitutive",))
