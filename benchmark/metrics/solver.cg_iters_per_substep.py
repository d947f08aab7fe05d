"""Pressure plus viscosity CG iterations (StepDiagnostics) over the traced
frames' substeps."""


def read(run):
    if not run.substeps:
        return None
    iters = sum(d.pressure_iterations + d.viscosity_iterations
                for d in run.diags)
    return iters / run.substeps
